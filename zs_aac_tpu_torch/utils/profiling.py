"""Tracing and step timing (the JAX package's ``utils/profiling.py``).

- ``trace(logdir, device)``: a ``torch.profiler.profile`` context that
  writes a Chrome/Perfetto trace (``trace.json``) into ``logdir``, with
  CUDA activity where ``device`` is a card; the profile object is yielded,
  so its ``key_averages()`` and events can be read afterwards.
- ``annotate(name)``: the port's one span helper. While a profiler records
  it is ``torch.profiler.record_function(name)``, a named region on the
  trace's timeline, nested with the ATen operations it encloses and on the
  same clock as the device records; otherwise it is one shared
  ``contextlib.nullcontext``, so a span costs a flag read with no profiler
  running. The decode and encode paths open the spans listed in ``SPANS``.
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

__all__ = ["SPANS", "trace", "annotate", "StepTimer", "device_memory_stats"]

# The spans the port opens, each named after the layer boundary it marks.
SPANS = (
    "decode.mapper",       # models/caption.py::caption_embeddings, caption_mistral's
    "decode.prefill",      # decoding/greedy.py: cache, prefill, its quantize, first argmax
    "decode.step",         # one cached step: embed, blocks, head, argmax, token updates
    "decode.stop_check",   # the host's read of "every row has stopped"
    "decode.logits",       # the final norm and the LM head of a step
    "layer.norm",          # models/gpt2.py::_ln, models/mistral.py::_rms_norm
    "layer.quant",         # ops/quant.py::quant_act
    "layer.rescale",       # ops/quant.py::int8_rescale (int32 -> float, cast, bias); _mm's bias add
    "layer.attn",          # a decode step's attention over the cache, with its commit
    "layer.router",        # models/deepseek.py: gate GEMM, softmax, top k, counts, offsets, gather
    "layer.experts",       # models/deepseek.py: the two grouped GEMMs and the SwiGLU between
    "layer.combine",       # models/deepseek.py: inverse permutation, weighted sum, shared add
    "layer.act",           # GELU, SwiGLU's silu(g) * u
    "layer.lora",          # models/mistral.py::_lora_delta
    "encode.frontend",     # resample, log-mel, HTSAT's bn0 and spectrogram reshape
)
_NULL = contextlib.nullcontext()


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


def annotate(name: str, launch: bool = False):
    """A named span while a profiler records, else a shared no-op context.

    ``launch=True`` marks a kernel launched from Python (through ``ctypes``)
    rather than a span: ``record_function`` is a user annotation, to which
    the profiler links no kernel, so a launch made inside one and outside
    any ATen operation links to nothing. The launch's record is then an
    operation of the profiler's own kind, which the kernel links to."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NULL
    if launch:
        return torch._C._profiler._RecordFunctionFast(name)
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
