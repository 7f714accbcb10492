"""Device time of the host-to-device copies (the batch's int16 PCM) in the
traced stretch, over its encode batches."""

from benchmark.readers import profiled_batches


def read(run):
    n = profiled_batches(run)
    copies = run.trace.copies("HtoD") if run.trace is not None else []
    if not copies or n == 0:
        return None
    return sum(c.end - c.start for c in copies) * 1e-6 / n
