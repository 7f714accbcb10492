"""% of the bf16 tensor-core peak: HTSAT's forward operations from shapes
(``costs/htsat_encode.py``) over the wall of the window's batches that the
profiler did not slow."""

from benchmark.peaks import BF16_FLOPS
from benchmark.readers import mfu


def read(run):
    ops = run.cost("htsat_encode").batch_ops
    return mfu(run, lambda units: ops(run.config["clap"], units), BF16_FLOPS)
