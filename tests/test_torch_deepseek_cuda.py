"""The DeepSeek-V2 decoder on a card, at DeepSeek-V2-Lite's published
widths (``models/deepseek.py``).

Marked ``cuda``: skips where no CUDA card is present (``torch._grouped_mm``
takes its SM90 bf16 kernel only on a card; the CPU runs a loop). Imports
neither JAX nor the JAX package; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_deepseek_cuda.py

- One dense and one MoE layer (with the full vocabulary's head), B = 256,
  bf16, prefill then cached steps, against the benchmark's float32
  reference on the same weights.
- A prefill and a decode step make no host synchronisation
  (``torch.cuda.set_sync_debug_mode("error")``), and two decodes of one
  batch give the same tokens.
- The steps as CUDA graphs (``StepGraphs``) give the tokens of the eager
  steps a profiled decode runs, and a replay makes no host
  synchronisation.
- The grouped GEMM against per-expert GEMMs of the same bf16 inputs.
"""

import copy
import sys
from pathlib import Path

import pytest
import torch

from zs_aac_tpu_torch.decoding.greedy import deepseek_greedy_decode
from zs_aac_tpu_torch.models import deepseek as ds

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmark import harness  # noqa: E402

B, N = 256, 5


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._grouped_mm's SM90 kernel")


@pytest.fixture(scope="module")
def two_layers():
    """Layer 0 dense, layer 1 MoE, every width and the vocabulary as
    published; the reference's weights, served in bf16."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False       # float32 products in float32
    ref = harness.load_module("reference", "deepseek-v2-lite")
    cfgd = copy.deepcopy(harness.load_json("configs", "deepseek-v2-lite.json"))
    cfgd["num_hidden_layers"] = 2
    cfg = ds.DeepseekV2Config.from_dict(cfgd)
    w = ref.make_caption_weights(cfgd, 2 ** 31 + 7, "cuda")

    def bf16(tree):
        if isinstance(tree, dict):
            return {k: bf16(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [bf16(v) for v in tree]
        return tree.to(torch.bfloat16)

    p = ds.prepare_deepseek_v2(bf16({k: w[k] for k in ("embed", "layers", "norm", "lm_head")}),
                               cfg)
    g = torch.Generator(device="cuda").manual_seed(3)
    pre = torch.randn(B, 1024, generator=g, device="cuda")
    pre = pre / pre.norm(dim=-1, keepdim=True)
    toks = torch.randint(0, cfg.vocab_size, (B, N), generator=g, device="cuda")
    tags = torch.tensor(cfgd["serving"]["tag_ids"], device="cuda")[None].expand(B, -1)
    emb = torch.cat([ref.mapper_prefix(w, cfgd, pre).bfloat16(), p["embed"][tags]], 1)
    return ref, cfgd, cfg, w, p, pre, toks, emb


def _port_logits(cfg, p, emb, toks):
    Lp = emb.shape[1]
    cache = ds.init_deepseek_cache(cfg, B, Lp + N, torch.bfloat16, "cuda")
    lg, cache = ds.deepseek_prefill(p, cfg, emb, cache)
    out = [lg]
    for i in range(N - 1):
        lg, cache = ds.deepseek_step(p, cfg, ds.deepseek_embed(p, toks[:, i]), cache, Lp + i)
        out.append(lg)
    return torch.stack(out, 1).float()


@pytest.mark.cuda
def test_two_layers_at_published_widths_hold_to_the_reference(two_layers):
    """bf16 against float32: the logits' error is a small share of their
    spread, and well under the fp8 control's (the reference with every
    product's inputs in float8 e4m3)."""
    ref, cfgd, cfg, w, p, pre, toks, emb = two_layers
    port = _port_logits(cfg, p, emb, toks)
    want, ctl = [], []
    for s in range(0, B, 32):
        want.append(ref.caption_logits(w, cfgd, pre[s:s + 32], toks[s:s + 32]))
        ctl.append(ref.caption_logits(w, cfgd, pre[s:s + 32], toks[s:s + 32], bits=4))
    want, ctl = torch.cat(want), torch.cat(ctl)
    err = (port - want).abs().max().item()
    ctl_err = (ctl - want).abs().max().item()
    scale = want.std().item()
    print(f"bf16 err {err:.5f}, fp8 control err {ctl_err:.5f}, logit std {scale:.5f}")
    assert err < ctl_err / 3, (err, ctl_err, scale)


@pytest.mark.cuda
def test_prefill_and_step_make_no_host_sync_and_repeat_bitwise(two_layers):
    _, _, cfg, _, p, _, toks, emb = two_layers
    Lp = emb.shape[1]
    cache = ds.init_deepseek_cache(cfg, B, Lp + 2, torch.bfloat16, "cuda")
    ds.deepseek_step(p, cfg, ds.deepseek_embed(p, toks[:, 0]), cache, Lp)   # the RoPE table
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cache = ds.init_deepseek_cache(cfg, B, Lp + 2, torch.bfloat16, "cuda")
        lg, cache = ds.deepseek_prefill(p, cfg, emb, cache)
        lg2, cache = ds.deepseek_step(p, cfg, ds.deepseek_embed(p, lg.argmax(-1)), cache, Lp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert lg2.shape == (B, cfg.vocab_size)
    a = deepseek_greedy_decode(p, cfg, emb, 8)
    b = deepseek_greedy_decode(p, cfg, emb, 8)          # each call captures its own graphs
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_graph_steps_give_the_eager_tokens(two_layers):
    """The steps' CUDA graphs (captured in the first decode, replayed in the
    next) give the tokens of the eager steps a profiled decode runs, and a
    replay makes no host synchronisation."""
    _, _, cfg, _, p, _, _, emb = two_layers
    new = 20
    graphs = ds.StepGraphs(p, cfg, B, emb.shape[1] + new, torch.bfloat16, "cuda")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        eager = deepseek_greedy_decode(p, cfg, emb, new, graphs=graphs)
    assert not graphs.graphs
    first = deepseek_greedy_decode(p, cfg, emb, new, graphs=graphs)     # captures
    assert sorted(graphs.graphs) == [16, 24, 32]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = graphs.step(first[0][:, 0], emb.shape[1])              # a replay
    finally:
        torch.cuda.set_sync_debug_mode(0)
    again = deepseek_greedy_decode(p, cfg, emb, new, graphs=graphs)     # replays
    for got in (first, again):
        assert torch.equal(got[0], eager[0]) and torch.equal(got[1], eager[1])
    assert logits.shape == (B, cfg.vocab_size)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [256 * 6, 256 * 13 * 6])
def test_grouped_gemm_equals_per_expert_gemms(two_layers, rows):
    """Each group's rows through the stacked weight equal their float32
    product rounded to bf16: within half a bf16 step, plus the float32
    sums' error bound (K 2^-24 of the absolute terms' sum, for each of the
    two sums, in another order)."""
    _, _, cfg, _, p, *_ = two_layers
    ex = p["layers"][1]["moe"]["experts"]
    g = torch.Generator(device="cuda").manual_seed(5)
    ids = torch.randint(0, cfg.n_routed_experts, (rows,), generator=g, device="cuda")
    ids[ids == 7] = 8                                         # one expert gets no row
    ids = ids.sort().values
    counts = torch.zeros(cfg.n_routed_experts, dtype=torch.int32, device="cuda").scatter_add_(
        0, ids, torch.ones_like(ids, dtype=torch.int32))
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    for name, K in (("gateup", cfg.hidden_size), ("down", cfg.moe_intermediate_size)):
        x = torch.randn(rows, K, generator=g, device="cuda").bfloat16()
        got = torch._grouped_mm(x, ex[name], offs=offs).float()
        start = 0
        for e, end in enumerate(offs.tolist()):
            xe, we = x[start:end].float(), ex[name][e].float()
            want = xe @ we
            tol = want.abs() * 2 ** -8 + (xe.abs() @ we.abs()) * (2 * K * 2 ** -24)
            assert ((got[start:end] - want).abs() <= tol).all(), (name, e)
            start = end
