"""The traced stretch of a window: ``torch.profiler`` over a few whole
batches or steps, reduced to what the per-layer readers take.

The profiler's own records are read (``kineto_results.events()``), not
``key_averages()``, which over a decode's tens of thousands of kernels takes
tens of seconds. Three kinds of record are kept:

- device activity: kernels, copies and memsets, each with its start, end
  and the id of the host operation that launched it
  (``linked_correlation_id``, the innermost ``aten`` op or annotation);
- host operations (``aten`` ops and ``record_function`` spans), with their
  input shapes where ``record_shapes`` was on;
- the span ``STRETCH``, opened by the harness around the profiled batches,
  whose start and end are the traced window in the profiler's clock.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

STRETCH = "bench.stretch"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Op:
    """A host operation or span: name, [start, end) in ns, thread, input shapes."""
    name: str
    start: int
    end: int
    tid: int
    shapes: list
    parent: Optional["Op"] = None


@dataclasses.dataclass
class DeviceEvent:
    """A kernel, copy or memset on the device: name, [start, end) in ns, the
    host operation that launched it (None where the trace links none)."""
    name: str
    kind: str
    start: int
    end: int
    op: Optional[Op]


class Trace:
    """The device activity and host operations of one traced stretch."""

    def __init__(self, device: List[DeviceEvent], ops: List[Op], window: Tuple[int, int]):
        self.device = sorted(device, key=lambda e: e.start)
        self.ops = ops
        self.window = window
        by_tid: Dict[int, List[Op]] = {}
        for op in sorted(ops, key=lambda o: (o.start, -o.end)):
            by_tid.setdefault(op.tid, []).append(op)
        for seq in by_tid.values():          # nesting: each op's innermost enclosing op
            stack: List[Op] = []
            for op in seq:
                while stack and stack[-1].end <= op.start:
                    stack.pop()
                op.parent = stack[-1] if stack else None
                stack.append(op)
        self._by_tid = by_tid
        self._starts = {t: [o.start for o in seq] for t, seq in by_tid.items()}
        stretch = [o for o in ops if o.name == STRETCH]
        self.host_tid = stretch[0].tid if stretch else None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @classmethod
    def from_events(cls, events) -> "Trace":
        """From ``prof.profiler.kineto_results.events()``: device records by
        their device type (copies and memsets by name), host operations as
        the records that link to no other (the runtime's launch calls link
        to the operation that made them; one made outside any operation,
        as a kernel launched through ``ctypes``, links to none and counts as
        a host operation, but its id is CUPTI's and may equal an
        operation's, so it is not an operation a device record can name)."""
        import torch

        cpu = torch.autograd.DeviceType.CPU
        ops: List[Op] = []
        frontend: Dict[int, Op] = {}   # operations by id; runtime calls keep CUPTI's ids
        device_raw = []
        window = None
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() != cpu:
                name = e.name()
                kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                        "gpu_memset" if name.startswith("Memset") else "kernel")
                device_raw.append((name, kind, start, end, e.linked_correlation_id()))
            elif e.linked_correlation_id() == 0:
                op = Op(e.name(), start, end, e.start_thread_id(), e.shapes())
                ops.append(op)
                if not op.name.startswith("cu"):        # not a CUDA runtime or driver call
                    frontend[e.correlation_id()] = op
                if op.name == STRETCH:
                    window = (op.start, op.end)
        if window is None:
            raise RuntimeError(f"the trace holds no {STRETCH!r} span")
        # a span opened on the host is mirrored on the device's timeline
        # under its own name: that is no device work
        spans = {op.name for op in ops}
        device = [DeviceEvent(n, k, s, t, frontend.get(c)) for n, k, s, t, c in device_raw
                  if n not in spans]
        return cls(device, ops, window)

    # -- device time ----------------------------------------------------------

    def in_window(self, kinds=_DEVICE_KINDS) -> List[DeviceEvent]:
        lo, hi = self.window
        return [e for e in self.device if e.kind in kinds and e.end > lo and e.start < hi]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device activity inside the window, as disjoint intervals."""
        lo, hi = self.window
        merged: List[List[int]] = []
        for e in self.in_window():
            s, t = max(e.start, lo), min(e.end, hi)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) * 1e-9

    def kernels(self, match=None) -> List[DeviceEvent]:
        """Kernels in the window whose name contains ``match`` (all if None)."""
        return [e for e in self.in_window(("kernel",)) if match is None or match in e.name]

    def kernels_under(self, op_name: str) -> List[DeviceEvent]:
        """Kernels in the window launched inside a host op named ``op_name``
        (the launching op itself or one that encloses it)."""
        out = []
        for e in self.in_window(("kernel",)):
            op = e.op
            while op is not None and op.name != op_name:
                op = op.parent
            if op is not None:
                out.append(dataclasses.replace(e, op=op))
        return out

    def copies(self, match: str) -> List[DeviceEvent]:
        return [e for e in self.in_window(("gpu_memcpy",)) if match in e.name]

    # -- the breakdown ----------------------------------------------------------

    def top_device_ops(self, n: int = 10) -> List[list]:
        totals: Dict[str, int] = {}
        for e in self.in_window():
            totals[e.name] = totals.get(e.name, 0) + (e.end - e.start)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(name), ns * 1e-9] for name, ns in top]

    def host_op_at(self, t: int) -> Optional[Op]:
        """The innermost host op of the harness's thread running at ``t``."""
        seq = self._by_tid.get(self.host_tid, [])
        i = bisect.bisect_right(self._starts.get(self.host_tid, []), t) - 1
        op = seq[i] if i >= 0 else None
        while op is not None and op.end <= t:
            op = op.parent
        return op

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device time inside the window, summed by the host op that was
        running when each gap opened; the ``n`` largest."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        totals: Dict[str, int] = {}
        for s, t in zip(edges[0::2], edges[1::2]):
            if t > s:
                op = self.host_op_at(s)
                name = op.name if op is not None else "(no host op)"
                totals[name] = totals.get(name, 0) + (t - s)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(name), ns * 1e-9] for name, ns in top]


def _short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def start_profiler():
    """An entered ``torch.profiler.profile`` over host and CUDA activity, with
    the input shapes of host operations (the GEMM readers take them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, record_shapes=True)
    prof.__enter__()
    return prof
