"""Kernels, copies and memsets launched under the program's ``decode.step``
spans over the number of those spans (every step of a batch launches the
same work, so this is an exact count)."""

from benchmark.spans import steps


def read(run):
    got = steps(run)
    if got is None:
        return None
    sp, n = got
    return sp.launches("phase:decode.step") / n
