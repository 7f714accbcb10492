"""The port's ``utils/profiling.py`` and ``utils/types.py`` against the JAX
package's: ``StepTimer`` keeps the same warm-up skip and ``summary()`` for
the same step durations; ``trace``/``annotate`` write a Chrome trace on the
CPU; ``device_memory_stats`` is ``None`` there; ``get_device`` raises
without CUDA and clamps the index as the JAX helper clamps to its
devices."""

import json
import time

import pytest
import torch

from zs_aac_tpu.utils import profiling as jprof
from zs_aac_tpu_torch.utils import profiling as tprof
from zs_aac_tpu_torch.utils import types as ttypes


def _clock(durations):
    """A fake ``time.perf_counter`` whose consecutive pairs of reads are
    ``durations`` apart."""
    ticks, t = [], 100.0
    for d in durations:
        ticks += [t, t + d]
        t += d + 0.5
    it = iter(ticks)
    return lambda: next(it)


@pytest.mark.parametrize("warmup, durations", [
    (1, [5.0, 0.1, 0.2, 0.3, 0.25, 0.15]), (0, [0.4]), (3, [1.0, 2.0]),
    (2, [3.0, 2.0, 0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 0.64, 1.28, 2.56])])
def test_step_timer_summary_matches_jax(warmup, durations, monkeypatch):
    out = []
    for timer in (jprof.StepTimer(warmup), tprof.StepTimer(warmup, device="cpu")):
        monkeypatch.setattr(time, "perf_counter", _clock(durations))   # both modules' clock
        for _ in durations:
            with timer.step():
                pass
        out.append(timer.summary())
    assert out[0] == out[1]
    assert out[1]["steps"] == max(len(durations) - warmup, 0)


def test_trace_and_annotate_write_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path / "t"), device="cpu") as prof:
        with tprof.annotate("train_step"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any(e.get("name") == "train_step" for e in trace["traceEvents"])
    assert any(e.key == "train_step" for e in prof.key_averages())


def test_cuda_defaults_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprof.device_memory_stats("cpu") is None
    for call in (lambda: tprof.device_memory_stats(), lambda: tprof.StepTimer(),
                 lambda: tprof.trace(str(tmp_path)).__enter__(), lambda: ttypes.get_device(0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("index, count, want", [(0, 1, 0), (3, 1, 0), (-2, 4, 0), (2, 4, 2),
                                                (9, 4, 3)])
def test_get_device_clamps_the_index(index, count, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert ttypes.get_device(index) == torch.device("cuda", want)


def test_type_aliases():
    from zs_aac_tpu.utils import types as jtypes

    assert ttypes.__all__ == jtypes.__all__
    assert ttypes.T is torch.Tensor and ttypes.D is torch.device
    assert ttypes.is_debugging() == jtypes.is_debugging()
