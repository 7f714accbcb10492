"""The DeepSeek cell's own pieces on the CPU: the grouped GEMM's bound, the
MoE readers on a hand-built trace whose answers are known, and the
program adapter's captions held to the plain reference at a tiny size
(``conftest.py`` registers it) in float32."""

import pytest

from benchmark import harness, tracing
from benchmark.tracing import DeviceEvent, Op, Trace

CELL = "dsv2lite.caption.bf16.b2048"
NEW = ("router_ms_per_step.caption", "experts_ms_per_step.caption",
       "grouped_gemm_roofline.caption", "expert_imbalance.caption")


def test_grouped_gemm_bound_is_the_larger_of_ops_and_bytes():
    g = harness.load_module("costs", "grouped_gemm")
    # a decode step's gate/up call: 12,288 rows over 64 experts is below the ridge
    T, K, N, G = 2048 * 6, 2048, 2816, 64
    assert g.bound(T, K, N, G) == pytest.approx(2 * (G * K * N + T * K + T * N) / 3.35e12)
    # the prefill's, 13 positions a row: above it
    T = 2048 * 13 * 6
    assert g.bound(T, K, N, G) == pytest.approx(2 * T * K * N / 989e12)


def _trace():
    """Window [0, 1000) ns, host thread 1. The prefill's MoE layer (router
    [10, 20), a grouped GEMM [20, 60)), then one step: the router [100,
    110), both grouped GEMMs [110, 150) and [160, 180) with the SwiGLU [150,
    160) between, the shared experts' GEMM [180, 200) under no MoE span,
    the combine [200, 215); the logits [215, 300)."""
    ops, dev = [], []

    def host(name, s, t, shapes=()):
        op = Op(name, s, t, 1, list(shapes))
        ops.append(op)
        return op

    def device(name, s, t, op):
        dev.append(DeviceEvent(name, "kernel", s, t, op))

    host(tracing.STRETCH, 0, 1000)
    host("decode.prefill", 1, 9)
    host("layer.router", 2, 3)
    device("topk", 10, 20, host("aten::topk", 2, 3))
    host("layer.experts", 4, 8)
    device("cutlass_grouped", 20, 60,
           host("aten::_grouped_mm", 4, 5, [[26624 * 6, 2048], [64, 2048, 2816], [64]]))
    host("decode.step", 10, 40)
    host("layer.router", 11, 13)
    device("router_mm", 100, 105, host("aten::mm", 11, 12))
    device("sort", 105, 110, host("aten::sort", 12, 13))
    host("layer.experts", 13, 19)
    device("cutlass_grouped", 110, 150,
           host("aten::_grouped_mm", 13, 14, [[12288, 2048], [64, 2048, 2816], [64]]))
    device("silu_mul", 150, 160, host("aten::mul", 14, 15))
    device("cutlass_grouped", 160, 180,
           host("aten::_grouped_mm", 15, 16, [[12288, 1408], [64, 1408, 2048], [64]]))
    device("shared_mm", 180, 200, host("aten::mm", 19, 20))
    host("layer.combine", 20, 24)
    device("gather", 200, 215, host("aten::index_select", 21, 22))
    host("decode.logits", 25, 35)
    device("head", 215, 300, host("aten::mm", 26, 27))
    return Trace(dev, ops, (0, 1000))


def _view(trace, counters=None):
    win = harness.Window()
    for i, w in enumerate((1.0, 3.0, 2.0)):
        win.starts.append(float(i))
        win.ends.append(i + w)
        win.units.append(8)
        win.profiled.append(i == 1)
    cell = {w["name"]: w for w in harness.manifest()["workloads"]}[CELL]
    cfg = harness.load_json("configs", "deepseek-v2-lite.json")
    return harness.RunView(cell, cfg, {}, win, trace, counters or {},
                           {"batch": 8, "new_tokens": 2}, 1.0)


def _read(name, view):
    return harness.load_module("metrics", name).read(view)


def test_the_moe_readers_on_a_known_trace():
    view = _view(_trace(), {"moe.routed_rows": 1200, "moe.expert_rows_max_sum": 30})
    ns = 1e-6                                                # one ns in ms
    assert _read("router_ms_per_step.caption", view) == pytest.approx(25 * ns)   # 10 + 15
    assert _read("experts_ms_per_step.caption", view) == pytest.approx(70 * ns)  # step only
    g = harness.load_module("costs", "grouped_gemm")
    want = (g.bound(26624 * 6, 2048, 2816, 64) + g.bound(12288, 2048, 2816, 64)
            + g.bound(12288, 1408, 2048, 64)) / ((40 + 40 + 20) * 1e-9)
    assert _read("grouped_gemm_roofline.caption", view) == pytest.approx(100 * want)
    assert _read("expert_imbalance.caption", view) == pytest.approx(30 / (1200 / 64))
    # the new spans fall under the existing split's step:self
    assert _read("step_device_ms.caption", view) == pytest.approx(200 * ns)
    assert _read("logits_ms_per_step.caption", view) == pytest.approx(85 * ns)


@pytest.mark.parametrize("name", NEW)
def test_each_moe_reader_returns_none_where_there_is_nothing_to_read(name):
    bare = Trace([DeviceEvent("gemm", "kernel", 10, 20, Op("aten::mm", 1, 2, 1, []))],
                 [Op(tracing.STRETCH, 0, 100, 1, []), Op("decode.step", 1, 50, 1, [])], (0, 100))
    assert _read(name, _view(None)) is None
    assert _read(name, _view(bare)) is None


def test_the_new_metrics_are_declared_for_the_cell_alone():
    man = harness.manifest()
    per_layer = {m["name"]: m for m in man["per_layer"]}
    for name in NEW:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "captions_per_s"
    reported = {m["name"] for m in harness.metrics_of(man, CELL, True)}
    assert set(NEW) <= reported
    assert not {"mfu.caption", "int8_gemm_roofline.caption", "K1_roofline",
                "quant_ms_per_step.caption", "lora_ms_per_step.caption"} & reported


def test_the_program_in_float32_holds_to_the_reference():
    """The adapter's greedy captions in float32 activations, checked as a
    run checks them: their served tokens are the reference's best to
    float32 rounding; the fp8 control's tokens are not."""
    from benchmark import readings
    from benchmark.tests.tiny import tiny_ctx

    ctx = tiny_ctx(CELL, seed=2 ** 31 + 21)
    ctx.config["serving"]["activations"] = "float32"
    out = readings.caption_readings(ctx, 1)
    assert out["gap"] < 1e-5 < out["control_gap"]
