"""The 95th percentile of one encode batch's latency (its int16 PCM handed
over -> its embeddings on the host) over every batch of the window, host
clock (``statistics.quantiles``, exclusive method)."""

import statistics


def read(run):
    walls = run.window.walls
    if len(walls) < 20:
        return None
    return statistics.quantiles(walls, n=20)[18] * 1e3
