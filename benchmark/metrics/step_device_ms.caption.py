"""Device busy time under the program's ``decode.step`` spans over the
number of those spans: one cached decode step's device time, all of it
(the block-level leaves, ``decode.logits`` and the step's self time)."""

from benchmark.spans import steps


def read(run):
    got = steps(run)
    if got is None:
        return None
    sp, n = got
    return sp.busy_ms("phase:decode.step") / n
