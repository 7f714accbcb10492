"""% of kernel K5's bound (``costs/window.py``, window attention without the
MLP) over its traced time in an encode window: HTSAT's last stage, whose
blocks run K5 as two tensor-core kernels (attention, projection) a call."""

from benchmark.readers import profiled_batches


def read(run):
    if run.trace is None:
        return None
    clap = run.config["clap"]
    blocks = run.cost("htsat_encode").stage_blocks(clap)
    last = len(clap["htsat"]["depths"]) - 1
    k5 = [b for b in blocks if b[0] == last]
    n = profiled_batches(run)
    ks = run.trace.kernels("tc::attn_kernel") + run.trace.kernels("tc::proj_kernel")
    if not ks or len(ks) != 2 * n * len(k5):
        return None
    bound = run.cost("window").bound
    B = run.info["batch"]
    total = n * sum(bound(B, H, C, heads, w, 2, False) for _, H, C, heads, w in k5)
    return 100.0 * total / (sum(k.end - k.start for k in ks) * 1e-9)
