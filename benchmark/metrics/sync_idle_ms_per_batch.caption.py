"""Device-idle time in the gaps that open while the host is inside
``decode.stop_check`` (the every-8-steps read of "every row has
stopped": the queue drains, then refills), per traced batch.

It is read in the profiled stretch, where the profiler slows the host, so
the refill after each check reads longer than in an unprofiled batch;
``idle_share.caption`` stays the unprofiled measure of idle time."""

from benchmark.spans import STOP_CHECK, idle_under_ms


def read(run):
    return idle_under_ms(run, STOP_CHECK)
