"""The readers of the program's spans (``benchmark/spans.py``) on hand-built
traces whose answers are known."""

import pytest

from benchmark import harness, spans, tracing
from benchmark.tracing import DeviceEvent, Op, Trace

MAN = harness.manifest()
SPAN_METRICS = ["prefill_ms_per_batch.caption", "step_device_ms.caption",
                "launches_per_step.caption", "quant_ms_per_step.caption",
                "attn_ms_per_step.caption", "norm_act_ms_per_step.caption",
                "logits_ms_per_step.caption", "lora_ms_per_step.caption",
                "sync_idle_ms_per_batch.caption", "frontend_ms_per_batch.encode"]
K1 = "void (anonymous namespace)::decode_attn_q8_kernel<float, false>"


def _decode_trace():
    """One traced batch, window [0, 3000) ns, host thread 1.

    Host: the mapper and the prefill (a quantize inside it), step 1 with a
    norm, a quantize, an int8 GEMM, a rescale, K1 launched through its launch
    operation inside ``layer.attn``, an activation, a LoRA delta, the logits
    (norm, quantize, GEMM, rescale) and the argmax; a stop check that waits
    [310, 990); step 2 with K1 linked to the ``layer.attn`` span itself (no
    ATen operation around its launch) and a GEMM; then the copy out.

    Device: the mapper [40, 60), the prefill [60, 110); step 1 [150, 510)
    (norm 10, quant 20, GEMM 100, rescale 10, K1 50, act 10, LoRA 20,
    logits 130, argmax 10); idle [510, 1050), opened inside the stop check;
    step 2 [1050, 1200) (K1 50, GEMM 100); idle [1200, 1450), opened after
    step 2 ended; the copy out [1450, 1500); a kernel linked to no host
    operation [2000, 2010)."""
    ops, dev = [], []

    def host(name, s, t):
        op = Op(name, s, t, 1, [])
        ops.append(op)
        return op

    def device(name, s, t, op, kind="kernel"):
        dev.append(DeviceEvent(name, kind, s, t, op))

    host(tracing.STRETCH, 0, 3000)
    host("decode.mapper", 10, 40)
    device("gemm_mapper", 40, 60, host("aten::addmm", 15, 25))
    host("decode.prefill", 40, 90)
    device("gemm_prefill", 60, 100, host("aten::mm", 50, 60))
    host("layer.quant", 60, 70)
    device("amax_prefill", 100, 110, host("aten::amax", 62, 68))

    host("decode.step", 100, 300)
    host("layer.norm", 105, 115)
    device("norm", 150, 160, host("aten::mul", 106, 110))
    host("layer.quant", 115, 125)
    device("amax", 160, 180, host("aten::amax", 116, 120))
    device("gemm", 180, 280, host("aten::_int_mm", 125, 135))
    host("layer.rescale", 135, 145)
    device("rescale", 280, 290, host("aten::mul", 136, 140))
    host("layer.attn", 145, 165)
    device(K1, 290, 340, host("decode_attn_q8", 150, 160))
    host("layer.act", 165, 175)
    device("tanh", 340, 350, host("aten::tanh", 166, 170))
    host("layer.lora", 175, 185)
    device("lora_mm", 350, 370, host("aten::mm", 176, 180))
    host("decode.logits", 185, 260)
    host("layer.norm", 186, 190)
    device("norm_f", 370, 380, host("aten::mul", 187, 189))
    host("layer.quant", 190, 200)
    device("amax_f", 380, 390, host("aten::amax", 191, 195))
    device("gemm_head", 390, 490, host("aten::_int_mm", 200, 210))
    host("layer.rescale", 210, 220)
    device("rescale_f", 490, 500, host("aten::mul", 211, 215))
    device("argmax", 500, 510, host("aten::argmax", 270, 280))

    host("decode.stop_check", 300, 1000)
    host("aten::_local_scalar_dense", 310, 990)

    host("decode.step", 1000, 1200)
    device(K1, 1050, 1100, host("layer.attn", 1010, 1030))
    device("gemm", 1100, 1200, host("aten::_int_mm", 1040, 1050))

    device("Memcpy DtoH (Device -> Pageable)", 1450, 1500, host("aten::copy_", 1300, 1400),
           "gpu_memcpy")
    device("stray", 2000, 2010, None)
    return Trace(dev, ops, (0, 3000))


def _encode_trace():
    """One traced encode batch, window [0, 1000) ns: the PCM copy [0, 100)
    before any span; the resample's span (two kernels, [100, 150) and
    [150, 170)), the log-mel's span with K2 linked to its autograd
    operation [170, 220), the reshape's span [220, 230); K3 [230, 900)
    under no span."""
    ops, dev = [], []

    def host(name, s, t):
        op = Op(name, s, t, 1, [])
        ops.append(op)
        return op

    host(tracing.STRETCH, 0, 1000)
    dev.append(DeviceEvent("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0, 100,
                           host("aten::copy_", 5, 10)))
    host("encode.frontend", 10, 30)
    dev.append(DeviceEvent("pad", "kernel", 100, 150, host("aten::constant_pad_nd", 12, 15)))
    dev.append(DeviceEvent("resample_mm", "kernel", 150, 170, host("aten::mm", 16, 20)))
    host("encode.frontend", 30, 40)
    dev.append(DeviceEvent("frames::kernel", "kernel", 170, 220, host("_LogMel", 32, 38)))
    host("encode.frontend", 40, 50)
    dev.append(DeviceEvent("reshape", "kernel", 220, 230, host("aten::einsum", 42, 48)))
    dev.append(DeviceEvent("tc::fused_kernel", "kernel", 230, 900,
                           host("aten::empty", 60, 61)))
    return Trace(dev, ops, (0, 1000))


def _view(trace, cell="gpt2.caption.q8.b8192", config="htsat-gpt2.json"):
    """A run of three batches, the middle one traced."""
    win = harness.Window()
    for i, w in enumerate((1.0, 3.0, 2.0)):
        win.starts.append(float(i))
        win.ends.append(i + w)
        win.units.append(8)
        win.profiled.append(i == 1)
    cells = {w["name"]: w for w in MAN["workloads"]}
    cfg = harness.load_json("configs", config)
    return harness.RunView(cells[cell], cfg, {}, win, trace, {},
                           {"batch": 8, "new_tokens": 2}, 1.0)


def _read(name, view):
    return harness.load_module("metrics", name).read(view)


def test_the_step_split_adds_up_to_the_step():
    view = _view(_decode_trace())
    ms = 1e-6                                           # one ns in ms
    step = _read("step_device_ms.caption", view)
    assert step == pytest.approx(510 / 2 * ms)          # [150, 510) + [1050, 1200), 2 steps
    parts = {name: _read(name, view) for name in (
        "quant_ms_per_step.caption", "attn_ms_per_step.caption",
        "norm_act_ms_per_step.caption", "lora_ms_per_step.caption",
        "logits_ms_per_step.caption")}
    assert parts == pytest.approx({"quant_ms_per_step.caption": 15 * ms,
                                   "attn_ms_per_step.caption": 50 * ms,
                                   "norm_act_ms_per_step.caption": 10 * ms,
                                   "lora_ms_per_step.caption": 10 * ms,
                                   "logits_ms_per_step.caption": 65 * ms})
    sp = spans.split(view)
    self_ms = sp.busy_ms("step:self") / 2                # the GEMMs and the argmax
    assert self_ms == pytest.approx(105 * ms)
    assert sum(parts.values()) + self_ms == pytest.approx(step)
    assert _read("launches_per_step.caption", view) == 7.0      # 12 + 2 launches


def test_k1_linked_to_its_span_alone_counts_under_attn():
    sp = spans.split(_view(_decode_trace()))
    k1 = sorted(sp.groups["layer.attn"])
    assert k1 == [(290, 340), (1050, 1100)]            # via its launch op, and via the span


def test_nothing_is_dropped_and_the_prefill_reads_the_mapper_too():
    tr = _decode_trace()
    view = _view(tr)
    sp = spans.split(view)
    assert _read("prefill_ms_per_batch.caption", view) == pytest.approx(70e-6)
    assert sp.busy_ms(spans.UNATTRIBUTED) == pytest.approx(10e-6)
    assert sp.busy_ms(spans.OUTSIDE) == pytest.approx(50e-6)
    steps = 2 * _read("step_device_ms.caption", view)
    prefill = _read("prefill_ms_per_batch.caption", view)
    rest = sp.busy_ms(spans.UNATTRIBUTED, spans.OUTSIDE)
    assert prefill + steps + rest == pytest.approx(tr.busy_s() * 1e3)


def test_sync_idle_takes_only_gaps_that_open_inside_the_stop_check():
    view = _view(_decode_trace())
    # [510, 1050) opens inside the check; [0, 40), [1200, 1450), [1500, 2000)
    # and [2010, 3000) open in the stretch alone
    assert _read("sync_idle_ms_per_batch.caption", view) == pytest.approx(540e-6)
    gaps = dict(view.trace.idle_gaps())
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(540e-9)


def test_the_frontend_reads_its_three_spans_and_not_the_copy():
    view = _view(_encode_trace(), cell="htsat.encode.b256")
    assert _read("frontend_ms_per_batch.encode", view) == pytest.approx(130e-6)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_reader_returns_none_without_its_spans(name):
    bare = Trace([DeviceEvent("gemm", "kernel", 10, 20, Op("aten::mm", 1, 2, 1, []))],
                 [Op(tracing.STRETCH, 0, 100, 1, [])], (0, 100))
    assert _read(name, _view(None)) is None
    assert _read(name, _view(bare)) is None


def test_lora_reads_nothing_in_a_step_without_lora():
    tr = _decode_trace()
    tr.ops = [op for op in tr.ops if op.name != "layer.lora"]
    tr = Trace(tr.device, tr.ops, tr.window)
    assert _read("lora_ms_per_step.caption", _view(tr)) is None
    assert _read("quant_ms_per_step.caption", _view(tr)) == pytest.approx(15e-6)


def test_the_new_metrics_are_declared_with_their_cells():
    per_layer = {m["name"]: m for m in MAN["per_layer"]}
    for name in SPAN_METRICS:
        m = per_layer[name]
        assert m["source"] == "device_trace" and m["workloads"]
        assert m["moves"] == ("clips_per_s" if name.endswith(".encode") else "captions_per_s")
    assert per_layer["lora_ms_per_step.caption"]["workloads"] == ["mistral7b.caption.q8.b2048"]
