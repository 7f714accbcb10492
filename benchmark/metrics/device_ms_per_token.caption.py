"""Device busy time of the traced stretch over the token positions it
decoded (batches x new tokens; the prefill and the mapper are in it)."""

from benchmark.readers import profiled_batches


def read(run):
    n = profiled_batches(run)
    if run.trace is None or n == 0 or not run.trace.in_window():
        return None
    return run.trace.busy_s() * 1e3 / (n * run.info["new_tokens"])
