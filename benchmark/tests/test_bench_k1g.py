"""K1g's byte bound (``costs/k1g.py``) and its roofline reader
(``metrics/K1g_roofline.py``) on a synthetic trace whose answers are known."""

import pytest

from benchmark import harness, tracing
from benchmark.tracing import DeviceEvent, Op, Trace

MAN = harness.manifest()
KERNEL = "void (anonymous namespace)::decode_attn_gqa_q8_kernel<__nv_bfloat16, 16, 4>"


def test_bound_bytes_at_one_index_by_hand():
    k1g = harness.load_module("costs", "k1g")
    # Mistral-7B's cell at index 71, the whole prefix in the window (72 rows):
    # q and o 2 x 2048 x 32 x 128 bf16, k and v 2 x 2048 x 8 x 128 bf16, cos
    # and sin 2 x 128 bf16, 16,384 (b, kv head) x 72 rows x (2 x 128 + 8)
    want = 2 * 2048 * 32 * 128 * 2 + 2 * 2048 * 8 * 128 * 2 + 2 * 128 * 2 + 16384 * 72 * 264
    seconds, nbytes = k1g.bound(2048, 32, 8, 128, 71, 0, 2)
    assert nbytes == want == 353_370_624
    assert seconds == pytest.approx(want / 3.35e12)      # bytes bound it
    flops = 4.0 * 2048 * 32 * 72 * 128
    assert flops / 67e12 < seconds
    # a sliding window: rows lo..index only
    assert k1g.bound(2, 32, 8, 128, 5000, 905, 2)[1] == \
        2 * (64 + 16) * 128 * 2 + 2 * 128 * 2 + 16 * 4096 * 264


def _view(n_kernels, layers=1, new_tokens=3):
    """A traced Mistral batch of ``new_tokens - 1`` steps at ``layers``
    layers, B = 4, with ``n_kernels`` K1g kernels of 100 ns and one K1
    kernel (which the reader must not count)."""
    cfg = dict(harness.load_json("configs", "mistral7b-lora.json"), num_hidden_layers=layers)
    stretch = Op(tracing.STRETCH, 0, 10_000, 1, [])
    dev = [DeviceEvent(KERNEL, "kernel", 100 + 200 * i, 200 + 200 * i, None)
           for i in range(n_kernels)]
    dev.append(DeviceEvent("void decode_attn_q8_kernel<float, 16, false>", "kernel",
                           9000, 9500, None))
    win = harness.Window()
    for i, (w, p) in enumerate(((1.0, False), (2.0, True))):
        win.starts.append(float(i))
        win.ends.append(i + w)
        win.units.append(4)
        win.profiled.append(p)
    cell = {w["name"]: w for w in MAN["workloads"]}["mistral7b.caption.q8.b2048"]
    info = {"batch": 4, "new_tokens": new_tokens}
    return harness.RunView(cell, cfg, {}, win, Trace(dev, [stretch], (0, 10_000)), {}, info,
                           20.0)


def test_reader_sums_the_bound_of_every_step_over_the_kernels_time():
    reader = harness.load_module("metrics", "K1g_roofline")
    cost = harness.load_module("costs", "k1g")
    # prompt 10 + 3 tag tokens: the two steps run at indices 13 and 14
    want = sum(cost.bound(4, 32, 8, 128, 13 + i, 0, 2)[0] for i in range(2))
    assert reader.read(_view(2)) == pytest.approx(100 * want / 200e-9)
    want = 3 * sum(cost.bound(4, 32, 8, 128, 13 + i, 0, 2)[0] for i in range(4))
    assert reader.read(_view(12, layers=3, new_tokens=5)) == pytest.approx(100 * want / 1200e-9)


@pytest.mark.parametrize("n_kernels", [0, 1, 3])
def test_reader_needs_exactly_one_launch_a_layer_a_step(n_kernels):
    """32 x 59 in the cell; here 1 layer x 2 steps: any other count, and a
    parent without the kernel (0), read nothing."""
    assert harness.load_module("metrics", "K1g_roofline").read(_view(n_kernels)) is None


def test_manifest_entry():
    entry = {m["name"]: m for m in MAN["per_layer"]}["K1g_roofline"]
    assert entry == {"name": "K1g_roofline", "unit": "%", "better": "higher",
                     "source": "device_trace", "layer": "step attention",
                     "moves": "captions_per_s", "workloads": ["mistral7b.caption.q8.b2048"]}
    attn = {m["name"]: m for m in MAN["per_layer"]}["attn_ms_per_step.caption"]
    assert entry["layer"] == attn["layer"]
