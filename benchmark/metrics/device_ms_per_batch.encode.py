"""Device busy time of the traced stretch over the encode batches it held."""

from benchmark.readers import profiled_batches


def read(run):
    n = profiled_batches(run)
    if run.trace is None or n == 0 or not run.trace.in_window():
        return None
    return run.trace.busy_s() * 1e3 / n
