"""Arithmetic the metric readers share. Each returns ``None`` where the run
has nothing to read (no trace, no matching kernel), never 0 for a share."""

from __future__ import annotations

import statistics
from typing import Optional


def idle_share(run) -> Optional[float]:
    """% of a batch's wall in which no kernel, copy or memset ran: the
    traced device busy time per profiled batch over the median wall of the
    window's unprofiled batches. The profiler slows the host (a GPT-2
    decode batch ~4x with shapes recorded), not the device's work, so its
    own stretch's idle share would count the profiler."""
    n = profiled_batches(run)
    walls = [w for w, p in zip(run.window.walls, run.window.profiled) if not p]
    if run.trace is None or not n or not walls or not run.trace.in_window():
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / n / statistics.median(walls))


def profiled_batches(run) -> int:
    return sum(run.window.profiled)


def kernel_share(run, match: str, bound_s_total: float, calls: int) -> Optional[float]:
    """% of the bound: ``bound_s_total`` over the summed time of the traced
    kernels whose name holds ``match``, when there are exactly ``calls``."""
    if run.trace is None:
        return None
    ks = run.trace.kernels(match)
    if not ks or len(ks) != calls:
        return None
    return 100.0 * bound_s_total / (sum(k.end - k.start for k in ks) * 1e-9)


def mfu(run, batch_ops, peak: float) -> Optional[float]:
    """% of ``peak``: the operations of the batches the profiler did not
    slow over their wall time (``batch_ops(units)`` the operations of a batch
    of that many units)."""
    keep = [i for i, p in enumerate(run.window.profiled) if not p]
    if not keep:
        return None
    ops = sum(batch_ops(run.window.units[i]) for i in keep)
    secs = sum(run.window.walls[i] for i in keep)
    return 100.0 * ops / secs / peak
