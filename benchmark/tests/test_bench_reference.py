"""Each configuration's plain reference against the port's own paths at a
tiny size on the CPU, on the benchmark's seeded weights: the port's int8
serving path in float32 (prefill, then cached steps over the int8 KV cache,
K1's plain version for GPT-2), teacher-forced on the same tokens. The
reference states the same integer arithmetic, so the two agree to float32
rounding; at 4 bits (the checks' control) they do not. This test imports
the port; the references do not."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_config

S, N = 3, 7


def _inputs(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    pre = torch.randn(S, cfg["mapper"]["sizes"][0], generator=g)
    pre = pre / pre.norm(dim=-1, keepdim=True)
    return pre, torch.randint(0, cfg["vocab_size"], (S, N), generator=g)


def _gpt2_port_logits(w, cfg, ref, pre, toks):
    from zs_aac_tpu_torch.models.gpt2 import (GPT2Config, gpt2_embed, gpt2_prefill_q8,
                                              gpt2_step_q8, init_kv_cache_q8, quantize_gpt2_int8)
    from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8_plain

    gcfg = GPT2Config(vocab_size=cfg["vocab_size"], n_positions=cfg["n_positions"],
                      n_embd=cfg["n_embd"], n_layer=cfg["n_layer"], n_head=cfg["n_head"])
    qp = quantize_gpt2_int8({k: w[k] for k in ("wte", "wpe", "h", "ln_f")}, "w8a8")
    emb = ref.mapper_prefix(w, cfg, pre)
    Lp = emb.shape[1]
    cache = init_kv_cache_q8(gcfg, S, Lp + N, "cpu")
    lg, cache = gpt2_prefill_q8(qp, gcfg, emb, cache)
    out = [lg[:, -1].float()]
    for i in range(N - 1):
        lg, cache = gpt2_step_q8(qp, gcfg, gpt2_embed(qp, toks[:, i]), cache, Lp + i,
                                 attention=decode_attn_q8_plain)
        out.append(lg)
    return torch.stack(out, 1)


def _mistral_port_logits(w, cfg, ref, pre, toks, fuse):
    from zs_aac_tpu_torch.models.mistral import (MistralConfig, init_mistral_cache_q8,
                                                 mistral_embed, mistral_prefill, mistral_step,
                                                 quantize_mistral_int8)

    mcfg = MistralConfig(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                         n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
                         n_kv_heads=cfg["num_key_value_heads"],
                         intermediate_size=cfg["intermediate_size"])
    base = {"embed": w["embed"].float(), "norm": w["norm"], "lm_head": w["lm_head"].float(),
            "layers": [{"attn": {k: v.float() for k, v in lp["attn"].items()},
                        "mlp": {k: v.float() for k, v in lp["mlp"].items()},
                        "ln1": lp["ln1"], "ln2": lp["ln2"]} for lp in w["layers"]]}
    q = quantize_mistral_int8(base, "w8a8", fuse=fuse)
    tags = torch.tensor(cfg["serving"]["tag_ids"])[None].expand(S, -1)
    emb = torch.cat([ref.mapper_prefix(w, cfg, pre), base["embed"][tags]], 1)
    Lp = emb.shape[1]
    cache = init_mistral_cache_q8(mcfg, S, Lp + N, "cpu")
    lg, cache = mistral_prefill(q, mcfg, emb, cache, lora=w["lora"])
    out = [lg[:, -1].float()]
    for i in range(N - 1):
        lg, cache = mistral_step(q, mcfg, mistral_embed(q, toks[:, i]), cache, Lp + i,
                                 lora=w["lora"])
        out.append(lg.float())
    return torch.stack(out, 1)


@pytest.mark.parametrize("seed", [3, 4])
def test_gpt2_reference_is_the_ports_int8_path(seed):
    cfg = tiny_config("htsat-gpt2")
    ref = harness.load_module("reference", "htsat-gpt2")
    w = ref.make_caption_weights(cfg, seed, "cpu")
    pre, toks = _inputs(cfg, seed)
    port = _gpt2_port_logits(w, cfg, ref, pre, toks)
    assert (ref.caption_logits(w, cfg, pre, toks) - port).abs().max() < 1e-5
    assert (ref.caption_logits(w, cfg, pre, toks, bits=4) - port).abs().max() > 1e-2


@pytest.mark.parametrize("fuse", [False, True])
def test_mistral_reference_is_the_ports_int8_path(fuse):
    cfg = tiny_config("mistral7b-lora")
    ref = harness.load_module("reference", "mistral7b-lora")
    w = ref.make_caption_weights(cfg, 5, "cpu")
    pre, toks = _inputs(cfg, 5)
    port = _mistral_port_logits(w, cfg, ref, pre, toks, fuse)
    assert (ref.caption_logits(w, cfg, pre, toks) - port).abs().max() < 1e-5
    assert (ref.caption_logits(w, cfg, pre, toks, bits=4) - port).abs().max() > 1e-2
    # the witness in bf16 activations moves the logits, by less than the control
    wit = (ref.caption_logits(w, cfg, pre, toks, act_dtype=torch.bfloat16) - port).abs().max()
    assert 1e-4 < wit < (ref.caption_logits(w, cfg, pre, toks, bits=4) - port).abs().max()


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_witness_readings_on_the_cpu(fuse):
    from benchmark import readings
    from benchmark.tests.tiny import tiny_ctx

    ctx = tiny_ctx("mistral7b.caption.q8.b2048")
    ctx.config["serving"]["fuse_qkv"] = fuse
    out = readings.caption_readings(ctx, 1, "bfloat16")
    assert out["witness_activations"] == "bfloat16"
    assert 0.0 <= out["witness_gap"] < out["control_gap"] and out["gap"] < out["control_gap"]


def test_lora_moves_the_reference():
    cfg = tiny_config("mistral7b-lora")
    ref = harness.load_module("reference", "mistral7b-lora")
    w = ref.make_caption_weights(cfg, 5, "cpu")
    pre, toks = _inputs(cfg, 5)
    full = ref.caption_logits(w, cfg, pre, toks)
    for site in [s for layer in w["lora"]["layers"] for s in layer.values()] + [w["lora"]["lm_head"]]:
        site["b"].zero_()
    assert (ref.caption_logits(w, cfg, pre, toks) - full).abs().max() > 1e-3


def test_weights_repeat_from_the_seed():
    cfg = tiny_config("htsat-gpt2")
    ref = harness.load_module("reference", "htsat-gpt2")
    a, b = (ref.make_caption_weights(cfg, 2 ** 31 + 11, "cpu") for _ in range(2))
    c = ref.make_caption_weights(cfg, 2 ** 31 + 12, "cpu")
    assert torch.equal(a["h"][1]["mlp"]["c_fc"]["w"], b["h"][1]["mlp"]["c_fc"]["w"])
    assert not torch.equal(a["wte"], c["wte"])


def test_htsat_reference_is_the_ports_plain_encode():
    """The port's encode (``build_ase_from_config`` on the CPU: the plain
    window attention and Swin blocks, ``log_mel_plain``) in float32 against
    the reference, from the same int16 PCM and weights; the fp8 control is
    off by far more."""
    from benchmark.tests.tiny import tiny_config

    cfg = tiny_config("htsat-gpt2")
    clap = cfg["clap"]
    ref = harness.load_module("reference", "htsat-gpt2")
    prog = harness.load_module("programs", "htsat_encode")
    w = ref.make_clap_weights(clap, 9, "cpu")
    g = torch.Generator().manual_seed(1)
    T = clap["audio_args"]["sr"] * clap["audio_args"]["max_length"]
    pcm = (torch.randn(3, T, generator=g) * 3000).round().clamp(-32768, 32767).to(torch.int16)
    enc = prog.Encoder(w, clap, "cpu", clap["audio_args"]["sr"])
    got = torch.from_numpy(enc.encode(pcm.numpy()))
    want = ref.clap_audio_embed(w, clap, pcm)
    assert (got - want).norm(dim=-1).max() < 1e-5
    assert (ref.clap_audio_embed(w, clap, pcm, fp8=True) - want).norm(dim=-1).max() > 1e-2
