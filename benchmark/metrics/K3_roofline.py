"""% of kernel K3's bound (``costs/window.py``, a whole Swin block) over its
traced time in an encode window: the blocks of every stage HTSAT runs
through K3 (all but the last), summed over the stretch's batches."""

from benchmark.readers import kernel_share, profiled_batches


def read(run):
    clap = run.config["clap"]
    blocks = run.cost("htsat_encode").stage_blocks(clap)
    last = len(clap["htsat"]["depths"]) - 1
    k3 = [b for b in blocks if b[0] != last]
    bound = run.cost("window").bound
    B, n = run.info["batch"], profiled_batches(run)
    total = sum(bound(B, H, C, heads, w, 2, True) for _, H, C, heads, w in k3)
    return kernel_share(run, "tc::fused_kernel", n * total, n * len(k3))
