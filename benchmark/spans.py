"""The program's own spans in a traced stretch: device time split by the
span that launched it.

The port opens named spans at its layer boundaries while a profiler records
(``zs_aac_tpu_torch/utils/profiling.py::SPANS``): ``decode.*`` around the
mapper, the prefill, each cached step, each stop check and each step's
logits, ``layer.*`` around the pieces of a block, ``encode.frontend``
around the encode's resample, log-mel and spectrogram reshape. They are
host records of the same trace as the device records, so ``tracing.Trace``
nests them with the ATen operations they enclose (``Op.parent``).

Each kernel, copy and memset of the window is attributed to the innermost
program span above its host operation; one whose host operation is a span
itself (a launch made inside it outside any ATen operation, that the trace
still linked) counts there too. One the trace links to no host operation is
counted as ``unattributed``, never dropped. A group's busy time is the union
of its device intervals, clipped to the window. Inside ``decode.step`` the
block-level leaves take only what lies outside ``decode.logits``, so the
leaves, ``logits`` and the step's self time (the int8 GEMMs, the residual
adds, the embed, the argmax) add up to the step.

Every reader built on this returns ``None`` where the trace holds none of
the spans it reads (a program that opens none).
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Tuple

from benchmark.readers import profiled_batches

PREFIXES = ("decode.", "layer.", "encode.")
STEP, LOGITS, STOP_CHECK = "decode.step", "decode.logits", "decode.stop_check"
# the step's block-level leaves, each the spans it sums
LEAVES = {
    "quant": ("layer.quant", "layer.rescale"),
    "attn": ("layer.attn",),
    "norm_act": ("layer.norm", "layer.act"),
    "lora": ("layer.lora",),
}
_LEAF_OF = {span: leaf for leaf, spans in LEAVES.items() for span in spans}
UNATTRIBUTED, OUTSIDE = "unattributed", "outside"

_SPLITS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def is_program_span(name: str) -> bool:
    return name.startswith(PREFIXES)


class Split:
    """A traced stretch's device intervals grouped by program span.

    ``groups`` maps a key to its [start, end) intervals in ns:

    - each program span's name: what its innermost program span is;
    - ``phase:<name>`` for ``decode.mapper``, ``decode.prefill``,
      ``decode.step`` and ``encode.frontend``: everything under that span,
      at any depth;
    - ``step:<leaf>`` for the leaves of ``LEAVES``, ``step:logits`` and
      ``step:self``: the split of ``phase:decode.step``;
    - ``unattributed``: device work linked to no host operation;
    - ``outside``: device work whose host operation is under no program
      span (the benchmark's own copies in and out of the card).

    ``launches(key)`` counts the records of a group; ``spans[name]`` the
    host spans of that name inside the window."""

    PHASES = ("decode.mapper", "decode.prefill", STEP, "encode.frontend")

    def __init__(self, trace):
        self.window = trace.window
        lo, hi = trace.window
        self.spans: Dict[str, int] = {}
        for op in trace.ops:
            if is_program_span(op.name) and op.start >= lo and op.end <= hi:
                self.spans[op.name] = self.spans.get(op.name, 0) + 1
        self.groups: Dict[str, List[Tuple[int, int]]] = {}
        memo: Dict[int, Tuple[Optional[str], bool, Tuple[str, ...]]] = {}
        for e in trace.in_window():
            if e.op is None:
                self._add(UNATTRIBUTED, e)
                continue
            inner, in_logits, phases = _chain(e.op, memo)
            if inner is None:
                self._add(OUTSIDE, e)
                continue
            self._add(inner, e)
            for name in phases:
                self._add("phase:" + name, e)
            if STEP in phases:
                if in_logits:
                    self._add("step:logits", e)
                elif inner in _LEAF_OF:
                    self._add("step:" + _LEAF_OF[inner], e)
                else:
                    self._add("step:self", e)

    def _add(self, key: str, e):
        self.groups.setdefault(key, []).append((e.start, e.end))

    def launches(self, key: str) -> int:
        return len(self.groups.get(key, ()))

    def busy_ms(self, *keys: str) -> float:
        """The union of the groups' intervals, clipped to the window, in ms."""
        lo, hi = self.window
        ivs = sorted(iv for k in keys for iv in self.groups.get(k, ()))
        total, end = 0, lo
        for s, t in ivs:
            s, t = max(s, end), min(t, hi)
            if t > s:
                total += t - s
                end = t
        return total * 1e-6


def _chain(op, memo):
    """(innermost program span, under ``decode.logits``, the phases above)
    of a host operation, memoized by operation."""
    path = []
    info = None
    while op is not None:
        key = id(op)
        if key in memo:
            info = memo[key]
            break
        path.append(op)
        op = op.parent
    if info is None:
        info = (None, False, ())
    for op in reversed(path):           # outermost first
        inner, in_logits, phases = info
        if is_program_span(op.name):
            inner = op.name
            in_logits = in_logits or op.name == LOGITS
            if op.name in Split.PHASES and op.name not in phases:
                phases = phases + (op.name,)
        info = (inner, in_logits, phases)
        memo[id(op)] = info
    return info


def split(run) -> Optional[Split]:
    """The run's ``Split`` (made once per trace), or ``None`` without a
    trace."""
    trace = run.trace
    if trace is None:
        return None
    if trace not in _SPLITS:
        _SPLITS[trace] = Split(trace)
    return _SPLITS[trace]


def steps(run) -> Optional[Tuple[Split, int]]:
    """(the split, the number of traced ``decode.step`` spans), or ``None``
    where there are none."""
    sp = split(run)
    if sp is None or not sp.spans.get(STEP):
        return None
    return sp, sp.spans[STEP]


def per_step_ms(run, *keys: str) -> Optional[float]:
    """Busy time of the ``step:*`` groups ``keys`` over the traced steps;
    ``None`` without steps or without any of the groups' spans."""
    got = steps(run)
    if got is None:
        return None
    sp, n = got
    spans = [s for k in keys for s in _spans_of(k)]
    if spans and not any(sp.spans.get(s) for s in spans):
        return None
    return sp.busy_ms(*("step:" + k for k in keys)) / n


def _spans_of(key: str):
    if key in LEAVES:
        return LEAVES[key]
    return (LOGITS,) if key == "logits" else ()


def per_batch_ms(run, *phases: str) -> Optional[float]:
    """Busy time under any of the spans ``phases`` over the traced batches."""
    sp = split(run)
    n = profiled_batches(run)
    if sp is None or not n or not any(sp.spans.get(p) for p in phases):
        return None
    return sp.busy_ms(*("phase:" + p for p in phases)) / n


def idle_under_ms(run, span: str) -> Optional[float]:
    """Device-idle time in the window's gaps that open while the host is
    inside ``span``, over the traced batches."""
    trace, n = run.trace, profiled_batches(run)
    if trace is None or not n or not any(op.name == span for op in trace.ops):
        return None
    lo, hi = trace.window
    edges = [lo] + [x for iv in trace.busy_intervals() for x in iv] + [hi]
    total = 0
    for s, t in zip(edges[0::2], edges[1::2]):
        op = trace.host_op_at(s) if t > s else None
        while op is not None and op.name != span:
            op = op.parent
        if op is not None:
            total += t - s
    return total * 1e-6 / n
