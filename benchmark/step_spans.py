"""Device time of named program spans inside the cached decode steps: what
a step spends under spans that ``spans.LEAVES`` does not name (the MoE
layers' ``layer.router``, ``layer.experts`` and ``layer.combine``, which
its split counts under ``step:self``), outside ``decode.logits``."""

from __future__ import annotations

from typing import Optional

from benchmark.spans import STEP, _chain, steps


def per_step_ms(run, *names: str) -> Optional[float]:
    """Busy time of the device work whose innermost program span is one of
    ``names``, under ``decode.step`` and outside ``decode.logits``, over the
    traced steps; ``None`` without steps or without any of the spans."""
    got = steps(run)
    if got is None:
        return None
    sp, n = got
    if not any(sp.spans.get(s) for s in names):
        return None
    memo: dict = {}
    ivs = []
    for e in run.trace.in_window():
        if e.op is None:
            continue
        inner, in_logits, phases = _chain(e.op, memo)
        if inner in names and STEP in phases and not in_logits:
            ivs.append((e.start, e.end))
    lo, hi = run.trace.window
    total, end = 0, lo
    for s, t in sorted(ivs):
        s, t = max(s, end), min(t, hi)
        if t > s:
            total += t - s
            end = t
    return total * 1e-6 / n
