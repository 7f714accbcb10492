"""The port's spans (``utils/profiling.py::annotate``) on the CPU.

- With no profiler running ``annotate`` is one shared null context, for a
  span and for a launch alike.
- Under ``torch.profiler`` a tiny w8a8 GPT-2 greedy decode (plain
  attention) and a tiny w8a8 Mistral decode over the int8 cache with LoRA
  record exact span counts: one ``decode.step`` a step run, one
  ``decode.stop_check`` a check made, per step 4 L + 1 ``layer.quant``
  (GPT-2) or 7 L + 1 (Mistral, unfused), and every ``layer.*`` span nests
  inside ``decode.step`` or ``decode.prefill``.
- The encode's frontend (resample, log-mel) records ``encode.frontend``.
- Tokens and lengths are bitwise the same with the profiler on and off.
- On a card (marked ``cuda``, skips without one) every K1 kernel links to
  its launch record inside ``layer.attn``: a ``record_function`` span
  alone carries no kernel link.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zs_aac_tpu_torch.decoding.greedy import (CHECK_EVERY, greedy_decode, greedy_decode_q8,
                                              mistral_greedy_decode)
from zs_aac_tpu_torch.models import caption as tcap
from zs_aac_tpu_torch.models import gpt2 as tg
from zs_aac_tpu_torch.models import mistral as tm
from zs_aac_tpu_torch.models.mapper import make_mapper
from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8_plain
from zs_aac_tpu_torch.ops.logmel import LogMelConfig, log_mel
from zs_aac_tpu_torch.ops.resample import resample_poly_device
from zs_aac_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)

GCFG = tg.GPT2Config(vocab_size=61, n_positions=64, n_embd=32, n_layer=2, n_head=4)
MCFG = tm.MistralConfig(vocab_size=57, hidden_size=32, n_layers=2, n_heads=4, n_kv_heads=2,
                        intermediate_size=64, sliding_window=64, max_positions=64)
NEVER = -1                # a stop id no token takes: every row runs every step


def _spans(prof):
    """The port's spans of a profile: [(name, start, end)] in start order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name() in tprof.SPANS]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _count(spans, name, inside=None):
    """Spans named ``name`` (inside a span named ``inside``, if given)."""
    outer = [s for s in spans if s[0] == inside]
    return sum(1 for s in spans if s[0] == name and (
        inside is None or any(o[1] <= s[1] and s[2] <= o[2] for o in outer)))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _gpt2_setup(B=3, Lp=4, E=16):
    g = torch.Generator().manual_seed(0)
    params = tg.quantize_gpt2_int8(tg.init_gpt2(GCFG, seed=1, device="cpu"), "w8a8")
    mapper = make_mapper("mlp", E, GCFG.n_embd, Lp, device="cpu")
    ccfg = tcap.CaptionConfig(prefix_length=Lp, prefix_size=E, gpt2=GCFG)
    prefix = torch.randn(B, E, generator=g)
    return {"mapper": mapper, "gpt2": params}, ccfg, prefix


def _gpt2_decode(params, ccfg, prefix, steps):
    with torch.no_grad():
        emb = tcap.caption_embeddings(params, ccfg, prefix)
    return greedy_decode_q8(params["gpt2"], GCFG, emb, steps, NEVER, NEVER,
                            attention=decode_attn_q8_plain)


def _mistral_setup(B=3, Lp=5):
    base = tm.init_mistral(MCFG, seed=2, device="cpu")
    params = tm.quantize_mistral_int8(base, "w8a8", fuse=False)
    lora = tm.init_lora(MCFG, r=4, alpha=8, seed=3, device="cpu")
    g = torch.Generator().manual_seed(4)
    lora = {**lora, "layers": [{n: {"a": p["a"], "b": torch.randn(p["b"].shape, generator=g)
                                    * 0.05} for n, p in lp.items()} for lp in lora["layers"]]}
    emb = torch.randn(B, Lp, MCFG.hidden_size, generator=g)
    return params, lora, emb


def test_annotate_is_one_shared_null_context_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = tprof.annotate("decode.step"), tprof.annotate("layer.attn", launch=True)
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tprof.annotate("decode.step"):
            with tprof.annotate("decode_attn_q8", launch=True):
                torch.ones(2) + 1
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("decode.step") == 1 and names.count("decode_attn_q8") == 1
    assert len(set(tprof.SPANS)) == len(tprof.SPANS)
    assert all(s.split(".")[0] in ("decode", "layer", "encode") for s in tprof.SPANS)


@pytest.mark.parametrize("steps", [CHECK_EVERY + 1, 2 * CHECK_EVERY + 3])
def test_gpt2_q8_decode_records_exact_span_counts(steps):
    params, ccfg, prefix = _gpt2_setup()
    _, spans = _profiled(lambda: _gpt2_decode(params, ccfg, prefix, steps))
    L = GCFG.n_layer
    assert _count(spans, "decode.mapper") == 1
    assert _count(spans, "decode.prefill") == 1
    assert _count(spans, "decode.step") == steps
    assert _count(spans, "decode.stop_check") == (steps - 1) // CHECK_EVERY
    per_step = {"layer.quant": 4 * L + 1, "layer.rescale": 4 * L + 1, "layer.attn": L,
                "layer.norm": 2 * L + 1, "layer.act": L, "decode.logits": 1}
    for name, n in per_step.items():
        assert _count(spans, name, inside="decode.step") == steps * n, name
    assert _count(spans, "layer.quant", inside="decode.logits") == steps
    assert _count(spans, "layer.lora") == 0
    _assert_layers_nest(spans)


def test_mistral_q8_lora_decode_records_exact_span_counts():
    params, lora, emb = _mistral_setup()
    new = CHECK_EVERY + 4
    _, spans = _profiled(lambda: mistral_greedy_decode(params, MCFG, emb, lora, new, NEVER,
                                                       q8_cache=True))
    L, steps = MCFG.n_layers, new - 1      # the last position needs no step
    assert _count(spans, "decode.prefill") == 1
    assert _count(spans, "decode.step") == steps
    assert _count(spans, "decode.stop_check") == -(-new // CHECK_EVERY)   # at 0 and 8
    per_step = {"layer.quant": 7 * L + 1, "layer.rescale": 7 * L + 1, "layer.lora": 7 * L + 1,
                "layer.attn": L, "layer.norm": 2 * L + 1, "layer.act": L,
                "decode.logits": 1}
    for name, n in per_step.items():
        assert _count(spans, name, inside="decode.step") == steps * n, name
    for name in ("layer.quant", "layer.lora", "layer.norm"):
        assert _count(spans, name, inside="decode.logits") == steps, name
    _assert_layers_nest(spans)


def _assert_layers_nest(spans):
    outer = [s for s in spans if s[0] in ("decode.step", "decode.prefill")]
    for name, s, t in spans:
        if name.startswith("layer."):
            assert any(o[1] <= s and t <= o[2] for o in outer), (name, s, t)
    # a step's spans and the stop checks never overlap
    flat = sorted((s for s in spans if s[0] in ("decode.step", "decode.stop_check",
                                                "decode.prefill")), key=lambda s: s[1])
    assert all(a[2] <= b[1] for a, b in zip(flat, flat[1:]))


def test_float_greedy_passes_through_the_same_spans():
    params = tg.init_gpt2(GCFG, seed=1, device="cpu")
    emb = torch.randn(2, 3, GCFG.n_embd, generator=torch.Generator().manual_seed(5))
    _, spans = _profiled(lambda: greedy_decode(params, GCFG, emb, 5, NEVER, NEVER))
    assert _count(spans, "decode.step") == 5
    assert _count(spans, "layer.attn", inside="decode.step") == 5 * GCFG.n_layer
    assert _count(spans, "decode.logits", inside="decode.step") == 5
    assert _count(spans, "layer.quant") == 0          # float weights: no int8 GEMM


def test_the_encode_frontend_records_its_spans():
    g = torch.Generator().manual_seed(6)
    pcm = (torch.randn(2, 3200, generator=g) * 3000).to(torch.int16)
    cfg = LogMelConfig(sr=16000, n_fft=256, hop_length=80, n_mels=16, f_max=8000)

    def encode():
        wave = resample_poly_device(pcm, 32000, 16000, 1600)
        return log_mel(wave, cfg)

    off = encode()
    on, spans = _profiled(encode)
    assert _count(spans, "encode.frontend") == 2
    assert torch.equal(off, on)


@pytest.mark.parametrize("which", ["gpt2", "mistral"])
def test_tokens_are_bitwise_the_same_with_the_profiler_on_and_off(which):
    if which == "gpt2":
        params, ccfg, prefix = _gpt2_setup(B=4)
        run = lambda: _gpt2_decode(params, ccfg, prefix, 10)
    else:
        params, lora, emb = _mistral_setup(B=4)
        run = lambda: mistral_greedy_decode(params, MCFG, emb, lora, 10, 7, q8_cache=True)
    toks, lens = run()
    (ptoks, plens), _ = _profiled(run)
    assert torch.equal(toks, ptoks) and torch.equal(lens, plens)
    assert np.unique(toks.numpy()).size > 1          # the decode is not degenerate


@pytest.mark.cuda
def test_k1_kernels_link_to_their_launch_inside_layer_attn_on_the_card():
    """On a card every K1 kernel of a traced decode links to its launch
    record ``decode_attn_q8``, which lies inside a ``layer.attn`` span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K1 has no CPU build")
    params = tg.quantize_gpt2_int8(tg.init_gpt2(GCFG, seed=1, device="cuda"), "w8a8")
    emb = torch.randn(4, 3, GCFG.n_embd, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(7))
    steps = 5
    greedy_decode_q8(params, GCFG, emb, steps, NEVER, NEVER)        # builds and warms K1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        greedy_decode_q8(params, GCFG, emb, steps, NEVER, NEVER)
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    events = list(prof.profiler.kineto_results.events())
    host = {e.correlation_id(): e for e in events
            if e.device_type() == cpu and e.linked_correlation_id() == 0
            and not e.name().startswith("cu")}
    attn = [s for s in _spans(prof) if s[0] == "layer.attn"]
    k1 = [e for e in events if e.device_type() != cpu and "decode_attn_q8_kernel" in e.name()]
    assert len(k1) == steps * GCFG.n_layer
    for e in k1:
        op = host.get(e.linked_correlation_id())
        assert op is not None and op.name() == "decode_attn_q8"
        assert any(s <= op.start_ns() and op.start_ns() + op.duration_ns() <= t
                   for _, s, t in attn)
