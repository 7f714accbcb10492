"""% of the int8 tensor-core peak (the GEMMs run int8): the model's GEMM and
attention operations from shapes (``costs/<program>.py``) over the wall of
the window's batches that the profiler did not slow."""

from benchmark.peaks import INT8_OPS
from benchmark.readers import mfu


def read(run):
    ops = run.cost(run.config["program"]).batch_ops
    return mfu(run, lambda units: ops(run.config, units, run.info["new_tokens"]), INT8_OPS)
