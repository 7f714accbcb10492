"""Kernel K1g (``csrc/decode_attn_gqa.cu``) against its plain PyTorch version,
on a card.

Every test here is marked ``cuda`` and skips where no CUDA card is present
(a CUDA kernel has no CPU build). The file imports neither JAX nor the JAX
package; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_attn_gqa_cuda.py

Tolerances, kernel against ``decode_attn_gqa_q8_plain`` on the same inputs:

- the committed int8 rows and scales: bitwise (the same IEEE operations in
  the same order; the committed k row is the quantized rotated k, so it
  holds the kernel's RoPE to the plain one's too);
- o in fp32: 1e-5 of max|o| (the two sum the dot products, the softmax's
  denominator and the output in other orders);
- o in bf16: one bf16 step at the largest |o| (K1's rule: the fp32 sums of
  the two orders round once to bf16, and land a step apart where they
  straddle a rounding boundary).
"""

import math

import pytest
import torch

from zs_aac_tpu_torch.models import mistral as tm
from zs_aac_tpu_torch.ops import decode_attn_gqa as G

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K1g has no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(B, KV, rep, d, T, index, dtype, seed, fused=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    H = KV * rep
    qkv = torch.randn(B, (H + 2 * KV) * d, generator=g, device="cuda")
    qkv[:, H * d:(H + KV) * d] *= 2
    qkv = qkv.to(dtype)
    q, k, v = qkv[:, :H * d], qkv[:, H * d:(H + KV) * d], qkv[:, (H + KV) * d:]
    if not fused:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    tables = tm._rope_tables(d, torch.full((1,), index, device="cuda"), 10000.0, dtype)
    cache = (torch.randint(-127, 128, (B * KV, T, d), generator=g, device="cuda",
                           dtype=torch.int8),
             torch.randint(-127, 128, (B * KV, T, d), generator=g, device="cuda",
                           dtype=torch.int8),
             torch.rand(B * KV, T, generator=g, device="cuda") * 0.05 + 1e-3,
             torch.rand(B * KV, T, generator=g, device="cuda") * 0.05 + 1e-3)
    return q, k, v, tables, cache


def _tol(name, ref):
    m = ref.float().abs().max().item()
    if name == "fp32":
        return 1e-5 * m
    return 2.0 ** -7 * 2.0 ** math.floor(math.log2(m))


# (index, window): windows of 1, 13, 73 and 200 rows (lo > 0 for the first
# and the last; 200 rows take seven rounds of 32 k scales)
WINDOWS = [(40, 1), (12, 4096), (72, 4096), (330, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fp32", "bf16"])
@pytest.mark.parametrize("index,window", WINDOWS)
@pytest.mark.parametrize("B", [1, 5, 300])
def test_kernel_matches_plain_at_mistral_heads(B, index, window, name):
    """d = 128, 8 kv heads, 4 query heads each (Mistral-7B)."""
    _need_cuda()
    dt = DTYPES[name]
    KV, rep, d, T = 8, 4, 128, index + 3
    q, k, v, tables, cache = _inputs(B, KV, rep, d, T, index, dt, seed=B + index)
    lo = max(0, index - window + 1)
    ref_cache = [t.clone() for t in cache]
    before = G.decode_attn_gqa_q8.launches
    with torch.no_grad():
        o = G.decode_attn_gqa_q8(q, k, v, tables, *cache, index, lo)
        ref = G.decode_attn_gqa_q8_plain(q, k, v, tables, *ref_cache, index, lo)
    torch.cuda.synchronize()
    assert G.decode_attn_gqa_q8.launches == before + 1
    assert o.shape == ref.shape and o.dtype == dt
    for a, b in zip(cache, ref_cache):
        assert torch.equal(a, b)
    err = (o.float() - ref.float()).abs().max().item()
    assert err <= _tol(name, ref), (err, _tol(name, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fp32", "bf16"])
@pytest.mark.parametrize("KV,rep,d", [(2, 2, 8), (2, 2, 16), (3, 2, 64), (2, 4, 32)])
def test_kernel_matches_plain_at_other_heads(KV, rep, d, name):
    """The port's tiny configs' heads: d = 8 (a row a lane), 16 and 64 at 2
    query heads a kv head, and d = 32 at 4 (a row of as many lanes as
    heads)."""
    _need_cuda()
    dt = DTYPES[name]
    q, k, v, tables, cache = _inputs(7, KV, rep, d, 40, 33, dt, seed=d + rep)
    ref_cache = [t.clone() for t in cache]
    with torch.no_grad():
        o = G.decode_attn_gqa_q8(q, k, v, tables, *cache, 33, 2)
        ref = G.decode_attn_gqa_q8_plain(q, k, v, tables, *ref_cache, 33, 2)
    for a, b in zip(cache, ref_cache):
        assert torch.equal(a, b)
    err = (o.float() - ref.float()).abs().max().item()
    assert err <= _tol(name, ref), (err, _tol(name, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_kernel_takes_fused_row_strides_and_long_windows(name):
    """q, k, v slices of one fused row; a window of 4,096 rows (Mistral's
    sliding window, three warps a block) with lo > 0."""
    _need_cuda()
    dt = DTYPES[name]
    for B, T, index, window, fused in ((9, 80, 50, 4096, True), (2, 4200, 4150, 4096, False)):
        q, k, v, tables, cache = _inputs(B, 8, 4, 128, T, index, dt, seed=T, fused=fused)
        lo = max(0, index - window + 1)
        ref_cache = [t.clone() for t in cache]
        with torch.no_grad():
            o = G.decode_attn_gqa_q8(q, k, v, tables, *cache, index, lo)
            ref = G.decode_attn_gqa_q8_plain(q, k, v, tables, *ref_cache, index, lo)
        for a, b in zip(cache, ref_cache):
            assert torch.equal(a, b)
        err = (o.float() - ref.float()).abs().max().item()
        assert err <= _tol(name, ref), (B, T, err, _tol(name, ref))


@pytest.mark.cuda
def test_greedy_decode_launches_one_kernel_a_layer_a_step():
    """A small w8a8 Mistral of 32 layers over the int8 cache: the kernel runs
    once a layer a step (32 a step), and not in the prefill."""
    _need_cuda()
    from zs_aac_tpu_torch.decoding.greedy import mistral_greedy_decode

    cfg = tm.MistralConfig(vocab_size=96, hidden_size=64, n_layers=32, n_heads=8,
                           n_kv_heads=2, intermediate_size=128, max_positions=32)
    params = tm.quantize_mistral_int8(tm.init_mistral(cfg, 0, "cuda", torch.bfloat16), "w8a8")
    emb = torch.randn(6, 5, 64, generator=torch.Generator(device="cuda").manual_seed(1),
                      device="cuda").to(torch.bfloat16)
    n = 8
    with torch.no_grad():
        before = G.decode_attn_gqa_q8.launches
        toks, lens = mistral_greedy_decode(params, cfg, emb, None, n, -1, q8_cache=True)
        torch.cuda.synchronize()
        assert G.decode_attn_gqa_q8.launches - before == cfg.n_layers * (n - 1)
        assert int(lens.min()) == n


@pytest.mark.cuda
def test_wrapper_refuses_wrong_dtype_shape_and_device():
    _need_cuda()
    q, k, v, tables, cache = _inputs(2, 2, 4, 128, 20, 10, torch.bfloat16, seed=0)
    cos, sin = tables
    call = lambda *a, **kw: G.decode_attn_gqa_q8(*a, 10, 0, **kw)
    with pytest.raises(TypeError):
        call(q.half(), k.half(), v.half(), (cos.half(), sin.half()), *cache)
    with pytest.raises(ValueError):
        call(q, k.float(), v, tables, *cache)
    with pytest.raises(ValueError):
        call(q, k[:, :128], v, tables, *cache)
    with pytest.raises(ValueError):
        call(q, k, v, tables, cache[0].float(), *cache[1:])
    with pytest.raises(ValueError):
        call(q, k, v, tables, cache[0].cpu(), *cache[1:])
    with pytest.raises(ValueError):
        call(q[:, :256], k, v, tables, *cache)       # one query head a kv head
    with pytest.raises(IndexError):
        G.decode_attn_gqa_q8(q, k, v, tables, *cache, 20, 0)
