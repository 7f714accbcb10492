"""K1g's plain version (``ops/decode_attn_gqa.py``) and its plan, on the CPU.

The plain version is ``mistral_step``'s int8-cache attention: RoPE, the new
row's quantization and commit, the attention over the window ``lo..index``.
It is held here to an independent reference written from the JAX step's
equations (numpy, every cache row scored and the rows outside the window
masked to -1e9 before an fp32 softmax, as ``zs_aac_tpu/models/mistral.py::
mistral_step`` does). Tolerances:

- the committed int8 row and its scales: bitwise (the same IEEE operations);
- o in fp32: 2e-6 of max|o| (the two differ in summation order only, over
  at most 4 x 128 products a score and T rows an output);
- o in bf16: one bf16 step at the largest |o| (both round the weights and o
  to bf16; where the fp32 sums of the two orders straddle a rounding
  boundary the roundings land a step apart).

The card runs the kernel against this plain version
(``tests/test_torch_decode_attn_gqa_cuda.py``).
"""

import math

import numpy as np
import pytest
import torch

from zs_aac_tpu_torch.models import mistral as tm
from zs_aac_tpu_torch.ops import decode_attn_gqa as G
from zs_aac_tpu_torch.ops.quant import quantize_vec

torch.set_num_threads(2)

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _inputs(B, KV, rep, d, T, index, dtype, seed=0, fused=False):
    """Pre-RoPE q, k, v in ``dtype`` (slices of one [B, (H + 2 KV) d] row
    when ``fused``, as ``_qkv_matmul`` returns the fused ``wqkv``'s), the
    step's tables and a random int8 cache."""
    g = torch.Generator().manual_seed(seed)
    H = KV * rep
    qkv = torch.randn(B, (H + 2 * KV) * d, generator=g)
    qkv[:, H * d:(H + KV) * d] *= 2
    qkv = qkv.to(dtype)
    q, k, v = qkv[:, :H * d], qkv[:, H * d:(H + KV) * d], qkv[:, (H + KV) * d:]
    if not fused:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    tables = tm._rope_tables(d, torch.full((1,), index), 10000.0, dtype)
    cache = (torch.randint(-127, 128, (B * KV, T, d), generator=g, dtype=torch.int8),
             torch.randint(-127, 128, (B * KV, T, d), generator=g, dtype=torch.int8),
             torch.rand(B * KV, T, generator=g) * 0.05 + 1e-3,
             torch.rand(B * KV, T, generator=g) * 0.05 + 1e-3)
    return q, k, v, tables, cache


def _reference(q, k, v, tables, cache, index, lo):
    """The JAX step's equations in numpy: (o [B, H d] as float32 in q's
    rounding, the cache after the commit)."""
    dt = q.dtype
    B = q.shape[0]
    ck, cv, sk, sv = (t.numpy().copy() for t in cache)
    BG, T, d = ck.shape
    KV = BG // B
    H = q.shape[1] // d
    rep = H // KV
    cos, sin = (t.float().numpy()[0] for t in tables)

    def rnd(x):   # through the activation dtype
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dt).float().numpy()

    def rope(x):  # x [..., d]: channel j pairs with j +- d/2
        half = d // 2
        rot = np.concatenate([-x[..., half:], x[..., :half]], axis=-1)
        return rnd(rnd(x * cos) + rnd(rot * sin))

    qr = rope(q.float().numpy().reshape(B, H, d))
    kr = rope(k.float().numpy().reshape(B, KV, d)).reshape(BG, d)
    vf = v.float().numpy().reshape(BG, d)
    for c, s, x in ((ck, sk, kr), (cv, sv, vf)):
        scale = np.maximum(np.abs(x).max(-1) / np.float32(127), np.float32(1e-8))
        c[:, index] = np.clip(np.round(x / scale[:, None]), -127, 127).astype(np.int8)
        s[:, index] = scale
    qg = qr.reshape(BG, rep, d)
    att = np.einsum("grd,gtd->grt", qg, ck.astype(np.float32)).astype(np.float32)
    att = att * (sk[:, None, :] / np.float32(math.sqrt(d)))
    t = np.arange(T)
    att = att + np.where((t >= lo) & (t <= index), 0.0, -1e9).astype(np.float32)
    att = np.exp(att - att.max(-1, keepdims=True))
    att = att / att.sum(-1, keepdims=True)
    w = rnd(att * sv[:, None, :])
    o = rnd(np.einsum("grt,gtd->grd", w, cv.astype(np.float32)))
    return o.reshape(B, H * d), (ck, cv, sk, sv)


def _tol(name, ref):
    m = float(np.abs(ref).max())
    if name == "fp32":
        return 2e-6 * m
    return 2.0 ** -7 * 2.0 ** math.floor(math.log2(m))


# (T, index, window): the whole prefix; index 0 (the new row alone); lo > 0
# with index past the sliding window; a window of one row
WINDOWS = [(20, 13, 4096), (16, 0, 4096), (40, 39, 8), (30, 25, 1)]


@pytest.mark.parametrize("name", ["fp32", "bf16"])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("T,index,window", WINDOWS)
def test_plain_matches_the_masked_reference(T, index, window, rep, name):
    dt = DTYPES[name]
    q, k, v, tables, cache = _inputs(2, 2, rep, 16, T, index, dt, seed=T + index + rep)
    lo = max(0, index - window + 1)
    want, want_cache = _reference(q, k, v, tables, cache, index, lo)
    got = G.decode_attn_gqa_q8(q, k, v, tables, *cache, index, lo)
    assert got.shape == (2, 2 * rep * 16) and got.dtype == dt
    err = np.abs(got.float().numpy() - want).max()
    assert err <= _tol(name, want), (err, _tol(name, want))
    for c, w in zip(cache, want_cache):
        assert np.array_equal(c.numpy(), w)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_rows_outside_the_window_are_not_read(name):
    """Rows before ``lo`` and after ``index`` may hold anything (inf, nan
    scales): the output does not change."""
    dt = DTYPES[name]
    q, k, v, tables, cache = _inputs(2, 2, 4, 16, 24, 15, dt, seed=3)
    lo = 9
    ref = G.decode_attn_gqa_q8_plain(q, k, v, tables, *(t.clone() for t in cache), 15, lo)
    ck, cv, sk, sv = cache
    ck[:, :lo], cv[:, 16:] = 127, -127
    sk[:, :lo], sv[:, 16:] = float("inf"), float("nan")
    got = G.decode_attn_gqa_q8_plain(q, k, v, tables, ck, cv, sk, sv, 15, lo)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_fused_row_strides_give_the_same_result(name):
    """q, k, v as slices of one fused ``wqkv`` row (row strides of
    (H + 2 KV) d) give what contiguous copies give, bitwise."""
    dt = DTYPES[name]
    q, k, v, tables, cache = _inputs(3, 2, 4, 16, 20, 12, dt, seed=5, fused=True)
    assert q.stride(0) == k.stride(0) == v.stride(0) == (8 + 4) * 16
    copies = [t.clone() for t in cache]
    got = G.decode_attn_gqa_q8(q, k, v, tables, *cache, 12, 0)
    want = G.decode_attn_gqa_q8(q.contiguous(), k.contiguous(), v.contiguous(), tables,
                                *copies, 12, 0)
    assert torch.equal(got, want)
    for a, b in zip(cache, copies):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_committed_row_is_quantize_vec_of_the_rotated_k_and_v(name):
    dt = DTYPES[name]
    B, KV, rep, d, index = 2, 2, 4, 16, 7
    q, k, v, tables, cache = _inputs(B, KV, rep, d, 12, index, dt, seed=9)
    before = [t.clone() for t in cache]
    G.decode_attn_gqa_q8(q, k, v, tables, *cache, index, 0)
    kr = G.rope_half(k.reshape(B, 1, KV, d).transpose(1, 2), tables)[:, :, 0]
    for (c, s), x, b in zip(((cache[0], cache[2]), (cache[1], cache[3])),
                            (kr, v.reshape(B, KV, d)), (before[0], before[1])):
        xq, xs = quantize_vec(x.float())
        assert torch.equal(c[:, index], xq.reshape(B * KV, d))
        assert torch.equal(s[:, index], xs.reshape(B * KV))
        # every other row as it was
        rest = torch.ones(c.shape[1], dtype=torch.bool)
        rest[index] = False
        assert torch.equal(c[:, rest], b[:, rest])


def _branch_before_the_move(q, k, v, tables, ck, cv, sk, sv, index, lo):
    """``mistral_step``'s int8 branch as it read inline before it moved into
    ``ops/decode_attn_gqa.py`` (its own lines, with q, k, v [B, 1, ...] and
    the step's locals rebuilt)."""
    from zs_aac_tpu_torch.ops.quant import div
    B, d = q.shape[0], ck.shape[-1]
    q, k, v = q[:, None], k[:, None], v[:, None]
    KV = sk.shape[0] // B
    H = q.shape[-1] // d
    rep, bg, hi, sqrt_d, dtype = H // KV, B * KV, index + 1, math.sqrt(d), q.dtype
    q = G.rope_half(q.reshape(B, 1, H, d).transpose(1, 2), tables)     # [B, H, 1, d]
    k = G.rope_half(k.reshape(B, 1, KV, d).transpose(1, 2), tables)    # [B, KV, 1, d]
    qk, s_k = quantize_vec(k[:, :, 0].float())
    qv, s_v = quantize_vec(v.reshape(B, KV, d).float())
    ck[:, index] = qk.reshape(bg, d)
    cv[:, index] = qv.reshape(bg, d)
    sk[:, index] = s_k.reshape(bg)
    sv[:, index] = s_v.reshape(bg)
    qg = q[:, :, 0].reshape(bg, rep, d).float()
    att = torch.bmm(qg, ck[:, lo:hi].float().transpose(1, 2))       # [BG, rep, n]
    att = att * div(sk[:, None, lo:hi], sqrt_d)
    att = torch.softmax(att, dim=-1)
    att = (att * sv[:, None, lo:hi]).to(dtype)
    o = torch.bmm(att.float(), cv[:, lo:hi].float())               # [BG, rep, d]
    return o.to(dtype).reshape(B, H * d)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_mistral_step_int8_branch_is_bitwise_the_inline_chain(fuse, name, monkeypatch):
    """A w8a8 Mistral with LoRA and a sliding window of 4, prefill and 6
    steps over the int8 cache: the logits and the cache through the moved
    branch equal those of the inline chain it replaced, bitwise."""
    dt = DTYPES[name]
    cfg = tm.MistralConfig(vocab_size=67, hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
                           intermediate_size=96, sliding_window=4, max_positions=16)
    params = tm.quantize_mistral_int8(tm.init_mistral(cfg, 0, "cpu", dt), "w8a8", fuse=fuse)
    lora = tm.init_lora(cfg, 4, 8, 1, "cpu")
    g = torch.Generator().manual_seed(2)
    for site in [s for layer in lora["layers"] for s in layer.values()]:
        site["b"].normal_(0.0, 0.05, generator=g)
    emb = torch.randn(3, 5, 64, generator=g).to(dt)
    toks = torch.randint(0, 67, (3, 6), generator=g)

    def run():
        cache = tm.init_mistral_cache_q8(cfg, 3, 12, "cpu")
        out, cache = tm.mistral_prefill(params, cfg, emb, cache, lora)
        outs = [out[:, -1]]
        for i in range(6):
            lg, cache = tm.mistral_step(params, cfg, tm.mistral_embed(params, toks[:, i]), cache,
                                        5 + i, lora)
            outs.append(lg)
        return torch.stack(outs, 1), cache

    with torch.no_grad():
        got, got_cache = run()
        monkeypatch.setattr(tm, "decode_attn_gqa_q8", _branch_before_the_move)
        want, want_cache = run()
    assert torch.equal(got, want)
    for a, b in zip(got_cache, want_cache):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_plan_at_mistral_shapes():
    """A warp a (b, kv head), four a block, whatever the dtype; three where
    four warps' scores would pass a block's shared memory (Mistral's
    4,096-row sliding window at 4 query heads: 64 KiB a warp)."""
    bf, f32 = torch.bfloat16, torch.float32
    assert G.decode_attn_gqa_plan(bf, 128, 4, 73) == 4
    assert G.decode_attn_gqa_plan(bf, 128, 4, 14) == 4
    assert G.decode_attn_gqa_plan(bf, 128, 4, 1) == 4
    assert G.decode_attn_gqa_plan(f32, 128, 4, 73) == 4
    assert G.decode_attn_gqa_plan(f32, 128, 4, 4096) == 3
    assert G.decode_attn_gqa_plan(bf, 128, 4, 4096) == 3
    assert G._strip_bytes(4096, 4) == 65536
    assert G._strip_bytes(73, 4) == 1168
    assert G._strip_bytes(73, 2) == 592     # 146 floats, rounded to 16 bytes
    # the tiny configs' heads: 2 query heads a kv head, d = 8 to 64
    assert G.decode_attn_gqa_plan(f32, 8, 2, 10) == 4
    assert G.decode_attn_gqa_plan(bf, 16, 2, 4096) == 4
    assert G.decode_attn_gqa_plan(bf, 64, 2, 30) == 4


@pytest.mark.parametrize("args,exc", [
    ((torch.float16, 128, 4, 10), TypeError),
    ((torch.bfloat16, 128, 3, 10), ValueError),      # 3 query heads a kv head
    ((torch.bfloat16, 128, 1, 10), ValueError),      # MHA: no config of the port's
    ((torch.bfloat16, 128, 8, 10), ValueError),      # 8 query heads a kv head
    ((torch.bfloat16, 96, 4, 10), ValueError),       # a row not a power of two of lanes
    ((torch.bfloat16, 256, 4, 10), ValueError),      # one row a warp: no second row group
    ((torch.bfloat16, 128, 4, 0), ValueError),
    ((torch.bfloat16, 128, 4, 100000), ValueError),  # one warp's scores past shared memory
])
def test_plan_refuses_what_the_kernel_does_not_take(args, exc):
    with pytest.raises(exc):
        G.decode_attn_gqa_plan(*args)


def test_no_kernel_for_another_device():
    q, k, v, tables, cache = _inputs(1, 1, 1, 8, 4, 2, torch.float32)
    with pytest.raises(RuntimeError, match="no kernel"):
        G.decode_attn_gqa_q8(q.to("meta"), k, v, tables, *cache, 2, 0)
