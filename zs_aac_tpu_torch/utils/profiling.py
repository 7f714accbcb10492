"""Tracing and step timing (the JAX package's ``utils/profiling.py``).

- ``trace(logdir, device)``: a ``torch.profiler.profile`` context that
  writes a Chrome/Perfetto trace (``trace.json``) into ``logdir``, with
  CUDA activity where ``device`` is a card; the profile object is yielded,
  so its ``key_averages()`` and events can be read afterwards.
- ``annotate(name)``: ``torch.profiler.record_function``, a named region on
  the trace's timeline.
- ``StepTimer``: step wall-clock statistics with warm-up skipping and the
  JAX timer's ``summary()`` keys. The JAX timer reads the host clock around
  a step whose results the caller has already fetched; a CUDA step returns
  once its kernels are queued, so on a card the port's ``step()``
  synchronizes the device before reading the clock at both ends: the times
  are of the work, not of the launches.
- ``device_memory_stats(device)``: ``torch.cuda.memory_stats`` on a card,
  ``None`` on the CPU (as the JAX function returns ``None`` where the
  backend keeps no statistics).

Each takes ``device`` (default ``cuda``, which raises without CUDA, as the
port's entry points do; ``cpu`` where the caller asks for it).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["trace", "annotate", "StepTimer", "device_memory_stats"]


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Profile the enclosed region into ``logdir/trace.json``, with CUDA
    activity where ``device`` is a card."""
    from torch.profiler import ProfilerActivity, profile

    cuda = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace (shows up on the timeline)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Step wall-clock stats: ``with timer.step(): ...`` then ``summary()``.
    On a CUDA ``device`` the card is synchronized before the clock is read
    at both ends of a step (see the module doc); on the CPU the host clock
    alone is read, as the JAX timer does."""

    def __init__(self, warmup: int = 1, device="cuda"):
        self.warmup = warmup
        self.device = resolve_device(device)
        self._times: List[float] = []
        self._seen = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def step(self):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "p99_s": float(np.percentile(arr, 99)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }


def device_memory_stats(device="cuda") -> Optional[dict]:
    """The CUDA allocator's statistics of ``device``; ``None`` on the CPU,
    which keeps none."""
    dev = resolve_device(device)
    return torch.cuda.memory_stats(dev) if dev.type == "cuda" else None
