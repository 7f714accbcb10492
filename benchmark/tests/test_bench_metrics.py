"""The trace reduction and the metric readers on a small synthetic trace
whose answers are known."""

import pytest

from benchmark import harness, tracing
from benchmark.tracing import DeviceEvent, Op, Trace

MAN = harness.manifest()


def _trace():
    """Window [0, 1000) ns. Host: the stretch span, a batch span holding two
    _int_mm ops (the second launches two kernels) and an argmax; then a
    sync. Device: kernels at [100, 200), [250, 300) + [300, 350) (the second
    GEMM), K1 at [400, 500) twice overlapping [450, 550), a copy [600, 700)."""
    stretch = Op(tracing.STRETCH, 0, 1000, 1, [])
    batch = Op("bench.batch", 10, 990, 1, [])
    mm1 = Op("aten::_int_mm", 20, 60, 1, [[1024, 768], [768, 2304]])
    mm2 = Op("aten::_int_mm", 70, 90, 1, [[1024, 3072], [3072, 768]])
    arg = Op("aten::argmax", 95, 120, 1, [])
    sync = Op("cudaStreamSynchronize", 700, 980, 1, [])
    ops = [stretch, batch, mm1, mm2, arg, sync]
    dev = [DeviceEvent("gemm_a", "kernel", 100, 200, mm1),
           DeviceEvent("gemm_b", "kernel", 250, 300, mm2),
           DeviceEvent("gemm_b_reduce", "kernel", 300, 350, mm2),
           DeviceEvent("void decode_attn_q8_kernel<float>", "kernel", 400, 500, None),
           DeviceEvent("void decode_attn_q8_kernel<float>", "kernel", 450, 550, None),
           DeviceEvent("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 600, 700, None)]
    return Trace(dev, ops, (0, 1000))


def test_busy_union_and_idle_gaps_by_host_op():
    tr = _trace()
    assert tr.busy_intervals() == [(100, 200), (250, 350), (400, 550), (600, 700)]
    assert tr.busy_s() == pytest.approx(450e-9)
    gaps = dict(tr.idle_gaps())
    # [0,100): opens in the stretch span; [200,250), [350,400), [550,600): in the
    # batch span; [700,1000): in the sync
    assert gaps["cudaStreamSynchronize"] == pytest.approx(300e-9)
    assert gaps["bench.batch"] == pytest.approx(150e-9)
    assert gaps[tracing.STRETCH] == pytest.approx(100e-9)
    top = tr.top_device_ops()
    assert top[0][0] == "void decode_attn_q8_kernel<float>" and top[0][1] == pytest.approx(200e-9)


def test_kernels_under_an_op_and_the_int8_gemm_reader():
    tr = _trace()
    under = tr.kernels_under("aten::_int_mm")
    assert sorted(k.name for k in under) == ["gemm_a", "gemm_b", "gemm_b_reduce"]
    assert {id(k.op) for k in under} == {id(tr.ops[2]), id(tr.ops[3])}
    assert [k.name for k in tr.kernels_under("bench.batch")] == ["gemm_a", "gemm_b",
                                                                  "gemm_b_reduce"]
    g = harness.load_module("costs", "int8_gemm")
    view = _view(tr)
    want = 100 * (g.bound(1024, 768, 2304) + g.bound(1024, 3072, 768)) / 200e-9
    assert harness.load_module("metrics", "int8_gemm_roofline.caption").read(view) == \
        pytest.approx(want)


def _view(trace, units=(1024, 1024, 1024), profiled=(False, True, False), walls=(1.0, 3.0, 2.0)):
    cfg = harness.load_json("configs", "htsat-gpt2.json")
    win = harness.Window()
    t = 0.0
    for u, p, w in zip(units, profiled, walls):
        win.starts.append(t)
        win.ends.append(t + w)
        win.units.append(u)
        win.profiled.append(p)
        t += w
    cell = {w["name"]: w for w in MAN["workloads"]}["gpt2.caption.q8.b8192"]
    info = {"batch": 1024, "new_tokens": 2}
    return harness.RunView(cell, cfg, {}, win, trace, {}, info, 12.5)


def test_window_readers():
    view = _view(_trace())
    read = lambda name: harness.load_module("metrics", name).read(view)
    assert read("captions_per_s") == pytest.approx(3072 / 6.0)
    assert read("setup_s") == 12.5
    # 450 ns busy in the one traced batch; the unprofiled walls 1.0 and 2.0 s
    assert read("idle_share.caption") == pytest.approx(100 * (1 - 450e-9 / 1.5))
    short = _view(_trace(), walls=(600e-9, 3.0, 900e-9))     # the traced wall is not read
    assert harness.load_module("metrics", "idle_share.caption").read(short) == \
        pytest.approx(100 * (1 - 450 / 750))
    assert read("device_ms_per_token.caption") == pytest.approx(450e-9 * 1e3 / 2)
    cost = harness.load_module("costs", "gpt2_caption")
    ops = 2 * cost.batch_ops(view.config, 1024, 2)
    assert read("mfu.caption") == pytest.approx(100 * ops / 3.0 / 1979e12)


def test_k1_reader_needs_exactly_the_steps_calls():
    view = _view(_trace())
    k1 = harness.load_module("metrics", "K1_roofline")
    assert k1.read(view) is None                # 2 traced launches, 12 layers x 2 steps due
    view.config = dict(view.config, n_layer=1)
    cost = harness.load_module("costs", "k1")
    want = sum(cost.bound(1024, 12, 64, 10 + i, 4)[0] for i in range(2))
    assert k1.read(view) == pytest.approx(100 * want / 200e-9)


def test_readers_return_nothing_without_a_trace():
    view = _view(None)
    for m in harness.metrics_of(MAN, "gpt2.caption.q8.b8192", True):
        if m["source"] == "device_trace":
            assert harness.load_module("metrics", m["name"]).read(view) is None, m["name"]


def test_from_events_reads_kineto_records():
    import torch

    class E:
        def __init__(self, name, dev, start, end, corr, linked, tid=1, shapes=()):
            self.v = (name, dev, start, end, corr, linked, tid, list(shapes))

        def name(self): return self.v[0]
        def device_type(self): return self.v[1]
        def start_ns(self): return self.v[2]
        def duration_ns(self): return self.v[3] - self.v[2]
        def correlation_id(self): return self.v[4]
        def linked_correlation_id(self): return self.v[5]
        def start_thread_id(self): return self.v[6]
        def shapes(self): return self.v[7]

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [E(tracing.STRETCH, cpu, 0, 100, 1, 0),
              E("aten::_int_mm", cpu, 10, 20, 2, 0, shapes=[[32, 8], [8, 16]]),
              E("cudaLaunchKernel", cpu, 12, 14, 77, 2),
              E("gemm", cuda, 30, 40, 77, 2),
              E("Memcpy HtoD (Pageable -> Device)", cuda, 50, 60, 78, 0),
              E(tracing.STRETCH, cuda, 0, 100, 79, 0),
              E("cudaLaunchKernel", cpu, 70, 72, 1, 0)]    # outside any op; CUPTI's id 1
    tr = Trace.from_events(events)
    assert tr.window == (0, 100)
    (k,) = tr.kernels()
    assert k.op.name == "aten::_int_mm" and k.op.shapes == [[32, 8], [8, 16]]
    assert tr.busy_s() == pytest.approx(20e-9)
    assert [c.name for c in tr.copies("HtoD")] == ["Memcpy HtoD (Pageable -> Device)"]
    assert [o.name for o in tr.ops] == [tracing.STRETCH, "aten::_int_mm", "cudaLaunchKernel"]
    assert tr.busy_s() == pytest.approx(20e-9)
