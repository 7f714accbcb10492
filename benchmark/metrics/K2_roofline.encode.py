"""% of kernel K2's bound (``costs/k2.py``) over its traced time in an
encode window: one log-mel of the batch's waves per batch."""

from benchmark.readers import kernel_share, profiled_batches


def read(run):
    audio = run.config["clap"]["audio_args"]
    B, T = run.info["batch"], audio["sr"] * audio["max_length"]
    n = profiled_batches(run)
    return kernel_share(run, "frames::kernel", n * run.cost("k2").bound(B, T, audio), n)
