"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where no CUDA card is present
(a CUDA kernel has no CPU build). The file imports neither JAX nor the JAX
package, so it also runs where those are not installed; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K1's fp32 output within 1e-5 of the plain version's (summation
order), bf16 within 2e-2 (one bf16 rounding step at |o| up to ~4); the
written cache row and scales bitwise equal (identical operations). K2's
log-mel within 2e-3 dB (fp32 FFTs in another summation order, mel power far
above the rounding floor on noise). K3/K5 outputs (~8) within 2e-4 in fp32
(summation order) and, in bf16, two bf16 steps at the largest output,
2**-6 * max|out| (an accumulator's last bit can flip one bf16 rounding).
The train kernels K6-K9 and the K3/K5 gradients: see ``_check`` (fp32 1e-4
of the largest entry; bf16 within twice the plain version's own distance
from its fp32 evaluation).
"""

import pytest
import torch

from zs_aac_tpu_torch.ops import logmel as lm
from zs_aac_tpu_torch.ops import window_attn as wa
from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8, decode_attn_q8_plain


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False


def _k1_inputs(B, H, T, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = dict(generator=g, device="cuda")
    return [torch.randn(B, H, d, **f).to(dtype), (torch.randn(B, H, d, **f) * 2).to(dtype),
            torch.randn(B, H, d, **f).to(dtype),
            torch.randint(-127, 128, (B, H, T, d), dtype=torch.int8, **f),
            torch.randint(-127, 128, (B, H, T, d), dtype=torch.int8, **f),
            torch.rand(B, H, T, **f) * 0.05 + 1e-3, torch.rand(B, H, T, **f) * 0.05 + 1e-3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,T,d,index", [(1, 4, 13, 16, 0), (3, 4, 13, 64, 12),
                                           (8, 2, 13, 24, 5), (256, 12, 77, 64, 40)])
def test_k1_matches_plain(B, H, T, d, index, dtype):
    _need_cuda()
    a = _k1_inputs(B, H, T, d, dtype, seed=B + index)
    b = [x.clone() for x in a]
    before = decode_attn_q8.launches
    o = decode_attn_q8(*a, index)
    o_ref = decode_attn_q8_plain(*b, index)
    torch.cuda.synchronize()
    assert decode_attn_q8.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    for got, want in zip(a[3:], b[3:]):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_k1_rejects_bad_inputs():
    _need_cuda()
    a = _k1_inputs(2, 4, 8, 16, torch.float32, seed=0)
    with pytest.raises(IndexError):
        decode_attn_q8(*a, 8)
    with pytest.raises(ValueError):
        decode_attn_q8(*a[:3], a[3].transpose(2, 3), *a[4:], 0)


@pytest.mark.cuda
def test_q8_step_kernel_path_matches_plain_path():
    """A small random GPT-2 in fp32 over the int8 cache, step-locked: each
    layer's attention through K1 or through the plain version gives logits
    within 1e-3 (summation order; a last-bit difference can move one cache
    value by one int8 step in a later layer)."""
    _need_cuda()
    from zs_aac_tpu_torch.models.gpt2 import (GPT2Config, gpt2_embed, gpt2_prefill_q8,
                                              gpt2_step_q8, init_gpt2, init_kv_cache_q8)

    cfg = GPT2Config(vocab_size=101, n_positions=64, n_embd=128, n_layer=2, n_head=4)
    params = init_gpt2(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    emb = torch.randn(20, 6, 128, generator=g, device="cuda")
    tokens = torch.randint(0, 101, (20, 10), generator=g, device="cuda")
    caches = [init_kv_cache_q8(cfg, 20, 16, device="cuda") for _ in range(2)]
    with torch.no_grad():
        for c in caches:
            gpt2_prefill_q8(params, cfg, emb, c)
        for i in range(10):
            x = gpt2_embed(params, tokens[:, i])
            lk, _ = gpt2_step_q8(params, cfg, x, caches[0], 6 + i)
            lp, _ = gpt2_step_q8(params, cfg, x, caches[1], 6 + i,
                                 attention=decode_attn_q8_plain)
            torch.testing.assert_close(lk, lp, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(1, 1000), (1, 1025), (2, 16001), (8, 320000)])
def test_k2_matches_plain(B, T):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(T)
    w = torch.randn(B, T, generator=g, device="cuda") * 0.1
    cfg = lm.LogMelConfig()
    before = lm.log_mel.launches
    got = lm.log_mel(w, cfg)
    torch.cuda.synchronize()
    assert lm.log_mel.launches == before + 1
    torch.testing.assert_close(got, lm.log_mel_plain(w, cfg), atol=2e-3, rtol=0)
    silence = lm.log_mel(torch.zeros(1, 4000, device="cuda"), cfg)
    assert (silence == -100.0).all()


def _window_inputs(B, H, C, heads, dtype, hidden=None, window=8, seed=0):
    hidden = hidden or 4 * C
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, device="cuda") * 0.05
    nH, N = H // window, window * window
    x = (f(B, H, H, C) * 20).to(dtype)
    w = [f(C) + 1, f(C), f(C, 3 * C), f(3 * C), f(C, C), f(C), f(C) + 1, f(C),
         f(C, hidden), f(hidden), f(hidden, C), f(C)]
    return x, [t.to(dtype) for t in w], torch.randn(nH, nH, heads, N, N, generator=g,
                                                    device="cuda")


WINDOW_CASES = [(2, 64, 96, 4, 8, 0), (2, 64, 96, 4, 8, 4), (2, 32, 192, 8, 8, 4),
                (2, 16, 384, 16, 8, 0), (2, 16, 32, 4, 4, 2), (2, 8, 16, 2, 4, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,C,heads,window,shift", WINDOW_CASES)
def test_k3_k5_match_plain(B, H, C, heads, window, shift, dtype):
    _need_cuda()
    x, w, bias = _window_inputs(B, H, C, heads, dtype, window=window, seed=H + shift)
    n3, n5 = wa.fused_swin_block.launches, wa.fused_window_attention.launches
    k3 = wa.fused_swin_block(x, *w, bias, window, heads, shift, 1e-6)
    k5 = wa.fused_window_attention(x, *w[2:6], bias, window, heads, shift)
    torch.cuda.synchronize()
    assert (wa.fused_swin_block.launches, wa.fused_window_attention.launches) == (n3 + 1, n5 + 1)
    for got, want in ((k3, wa.swin_block_plain(x, *w, bias, window, heads, shift, 1e-6)),
                      (k5, wa.window_attention_plain(x, *w[2:6], bias, window, heads, shift))):
        torch.testing.assert_close(got.float(), want.float(), atol=_tol(want), rtol=0)


def _tol(ref):
    if ref.dtype == torch.float32:
        return 2e-4
    return 2.0 ** -6 * ref.float().abs().max().item()


# bf16 at HTSAT's stage shapes: the tensor-core kernels. An odd batch (an odd
# count of windows for the blocks that take two), shift 4 at stages 2 and 3,
# and the stage-4 shape, whose heads and columns are split over blocks.
TC_WINDOW_CASES = [(3, 64, 96, 4, 0), (3, 64, 96, 4, 4), (3, 32, 192, 8, 4), (1, 32, 192, 8, 0),
                   (3, 16, 384, 16, 4), (3, 8, 768, 32, 0), (1, 8, 96, 4, 0), (1, 8, 192, 8, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,heads,shift", TC_WINDOW_CASES)
def test_k3_k5_tensor_core_kernels_match_plain(B, H, C, heads, shift):
    _need_cuda()
    x, w, bias = _window_inputs(B, H, C, heads, torch.bfloat16, seed=C + B + shift)
    fns = (wa.fused_swin_block, wa.fused_window_attention)
    n = [(fn.launches, fn.tc_launches) for fn in fns]
    k3 = wa.fused_swin_block(x, *w, bias, 8, heads, shift, 1e-6)
    k5 = wa.fused_window_attention(x, *w[2:6], bias, 8, heads, shift)
    torch.cuda.synchronize()
    assert [(fn.launches, fn.tc_launches) for fn in fns] == [(a + 1, b + 1) for a, b in n]
    for got, want in ((k3, wa.swin_block_plain(x, *w, bias, 8, heads, shift, 1e-6)),
                      (k5, wa.window_attention_plain(x, *w[2:6], bias, 8, heads, shift))):
        torch.testing.assert_close(got.float(), want.float(), atol=_tol(want), rtol=0)


@pytest.mark.cuda
def test_only_htsat_bf16_shapes_take_the_tensor_core_kernels():
    """fp32 and the 4x4-window shapes launch the FMA kernel: the launch
    count moves, the tensor-core count does not."""
    _need_cuda()
    for B, H, C, heads, window, dtype in ((2, 64, 96, 4, 8, torch.float32),
                                          (2, 16, 32, 4, 4, torch.bfloat16),
                                          (2, 16, 128, 4, 8, torch.bfloat16)):
        x, w, bias = _window_inputs(B, H, C, heads, dtype, window=window)
        n = (wa.fused_swin_block.launches, wa.fused_swin_block.tc_launches)
        got = wa.fused_swin_block(x, *w, bias, window, heads, 0, 1e-6)
        want = wa.swin_block_plain(x, *w, bias, window, heads, 0, 1e-6)
        assert (wa.fused_swin_block.launches, wa.fused_swin_block.tc_launches) == (n[0] + 1, n[1])
        torch.testing.assert_close(got.float(), want.float(), atol=_tol(want), rtol=0)


@pytest.mark.cuda
def test_k3_covers_the_streamed_block():
    """Stage 4 (8x8x768, 32 heads, hidden 3072) in bf16, and an MLP far wider
    than 4C in fp32: the hidden-dim chunk loop is K4's function."""
    _need_cuda()
    for args, dtype in (((2, 8, 768, 32), torch.bfloat16), ((2, 16, 128, 4), torch.float32)):
        B, H, C, heads = args
        hidden = 3072 if C == 768 else 8192
        shift = 0 if H == 8 else 4
        x, w, bias = _window_inputs(B, H, C, heads, dtype, hidden=hidden)
        got = wa.fused_swin_block(x, *w, bias, 8, heads, shift, 1e-6)
        want = wa.swin_block_plain(x, *w, bias, 8, heads, shift, 1e-6)
        torch.testing.assert_close(got.float(), want.float(), atol=_tol(want), rtol=0)


@pytest.mark.cuda
def test_window_kernels_refuse_what_they_do_not_take():
    _need_cuda()
    x, w, bias = _window_inputs(1, 8, 192, 2, torch.float32)          # head dim 96
    with pytest.raises(ValueError, match="head dim"):
        wa.fused_window_attention(x, *w[2:6], bias, 8, 2, 0)
    x, w, bias = _window_inputs(1, 8, 768, 32, torch.float32)         # fp32 stage 4
    with pytest.raises(ValueError, match="shared memory"):
        wa.fused_swin_block(x, *w, bias, 8, 32, 0, 1e-6)
    x, w, bias = _window_inputs(1, 16, 96, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        wa.fused_window_attention(x.transpose(1, 2), *w[2:6], bias, 8, 4, 0)


@pytest.mark.cuda
def test_htsat_kernel_dispatch_matches_plain():
    """The tiny HTSAT in fp32 on the card: K3 in stage 0 and K5 in stage 1
    (the extract driver's dispatch) against the plain path, 1e-4."""
    _need_cuda()
    torch.backends.cudnn.allow_tf32 = False
    from zs_aac_tpu_torch.models.htsat import HTSAT

    geo = dict(spec_size=64, patch_stride=4, patch_size=4, embed_dim=16, depths=(2, 2),
               num_heads=(2, 4), window_size=4, n_mels=16, drop_path_rate=0.0)
    variables = HTSAT(**geo).init(seed=0, device="cuda")
    spec = torch.randn(2, 100, 16, generator=torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    plain = HTSAT(**geo).apply(variables, spec, return_dict=True)
    fused = HTSAT(**geo, fused_attn=True, fused_block=(0,)).apply(variables, spec,
                                                                  return_dict=True)
    for k in plain:
        torch.testing.assert_close(fused[k], plain[k], atol=1e-4, rtol=1e-4)


# -- the train kernels: K7 (forward), K8, K9 (backward), K6 (K5's backward) --------
#
# Tolerances, per output relative to its largest entry. fp32: summation order
# only, 1e-4 of the largest entry (measured: ~1e-6). bf16: both sides round
# at the same points, but an fp32 accumulator summed in another order can
# flip one bf16 rounding of an intermediate (q/k/v, do, ds, dh1, ...), and at
# C=768 a flipped score moves a softmax row: the kernel is held within twice
# the plain bf16 version's own distance from the plain version evaluated in
# fp32 on the same inputs (the size of bf16 rounding noise for this output,
# measured 1e-3..5e-3 of the largest entry), plus 2**-8 of the largest entry.


def _check(name, got, want, want32=None):
    scale = want.float().abs().max().item()
    tol = 1e-4 * scale + 1e-7
    if want32 is not None:
        tol = 2 * (want.float() - want32.float()).abs().max().item() + 2.0 ** -8 * scale
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0,
                               msg=lambda m: f"{name}: {m}")


def _f32(tensors):
    return [t.float() if t.is_floating_point() else t for t in tensors]


def _train_inputs(B, H, C, heads, dtype, window=8, seed=0):
    x, w, bias = _window_inputs(B, H, C, heads, dtype, window=window, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    gout = (torch.randn(B, H, H, C, generator=g, device="cuda")).to(dtype)
    m1 = torch.tensor([1.25, 0.0] * (B // 2), device="cuda")
    m2 = torch.tensor([0.0, 1.25] * (B // 2), device="cuda")
    return x, w, bias, gout, m1, m2


TRAIN_CASES = [(2, 64, 96, 4, 8, 0), (2, 64, 96, 4, 8, 4), (2, 32, 192, 8, 8, 4),
               (2, 16, 384, 16, 8, 4), (2, 16, 32, 4, 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,C,heads,window,shift", TRAIN_CASES)
def test_k7_k8_k9_match_plain(B, H, C, heads, window, shift, dtype):
    _need_cuda()
    x, w, bias, g, m1, m2 = _train_inputs(B, H, C, heads, dtype, window, seed=H + shift)
    bf16 = dtype == torch.bfloat16
    cfg = (window, heads, shift, 1e-6)
    n = (wa.fused_swin_block_train.launches, wa.mlp_bwd.launches, wa.attn_ln1_bwd.launches)
    out = wa.fused_swin_block_train(x, *w, bias, m1, m2, *cfg)
    out_ref, y_ref = wa.swin_block_train_plain(x, *w, bias, m1, m2, *cfg)
    ln2_fc = (w[6], w[7], w[8], w[9], w[10])
    k8 = wa.mlp_bwd(y_ref, g, m2, *ln2_fc, 1e-6)
    r8 = wa.mlp_bwd_plain(y_ref, g, m2, *ln2_fc, 1e-6)
    dy = r8[0]
    k9 = wa.attn_ln1_bwd(x, dy, m1, *w[:5], bias, *cfg)
    r9 = wa.attn_ln1_bwd_plain(x, dy, m1, *w[:5], bias, *cfg)
    torch.cuda.synchronize()
    assert (wa.fused_swin_block_train.launches, wa.mlp_bwd.launches,
            wa.attn_ln1_bwd.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    refs = [[None] * 20] * 3
    if bf16:
        refs = [[wa.swin_block_train_plain(*_f32([x] + w), bias, m1, m2, *cfg)[0]],
                wa.mlp_bwd_plain(*_f32([y_ref, g]), m2, *_f32(ln2_fc), 1e-6),
                wa.attn_ln1_bwd_plain(*_f32([x, dy]), m1, *_f32(w[:5]), bias, *cfg)]
    _check("out", out, out_ref, refs[0][0])
    for name, got, want, w32 in zip(["dy", "dln2_s", "dln2_b", "dfc1_w", "dfc1_b", "dfc2_w",
                                     "dfc2_b"], k8, r8, refs[1]):
        _check(name, got, want, w32)
    for name, got, want, w32 in zip(["dx", "dln1_s", "dln1_b", "dqkv_w", "dqkv_b", "dproj_w",
                                     "dproj_b", "dbias"], k9, r9, refs[2]):
        _check(name, got, want, w32)
    # dropped rows: dy = g where m2 = 0, and dx = dy where m1 = 0, exactly
    assert torch.equal(k8[0][0], g[0]) and torch.equal(k9[0][1], dy[1])


# K7 in bf16 at HTSAT's stage shapes (the tensor-core kernels): an odd
# batch, shift 4, the stage-4 shape, and keep scales that hold zeros (a
# dropped sample's rows pass x, then y, through unchanged).
TC_TRAIN_CASES = [(3, 64, 96, 4, 4, (1.25, 0.0, 1.0), (0.0, 1.25, 1.0)),
                  (3, 32, 192, 8, 4, (0.0, 0.0, 1.25), (1.25, 0.0, 0.0)),
                  (2, 16, 384, 16, 4, (1.0, 0.0), (0.0, 1.0)),
                  (3, 16, 384, 16, 0, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
                  (3, 8, 768, 32, 0, (1.25, 0.0, 1.0), (0.0, 1.25, 1.25))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,heads,shift,m1,m2", TC_TRAIN_CASES)
def test_k7_tensor_core_kernels_match_plain(B, H, C, heads, shift, m1, m2):
    _need_cuda()
    x, w, bias = _window_inputs(B, H, C, heads, torch.bfloat16, seed=C + shift)
    m1, m2 = torch.tensor(m1, device="cuda"), torch.tensor(m2, device="cuda")
    cfg = (8, heads, shift, 1e-6)
    fn = wa.fused_swin_block_train
    n = (fn.launches, fn.tc_launches)
    out, y = wa._launch(fn, True, x, *w[2:6], bias, 8, heads, shift,
                        ln=(w[0], w[1], w[6], w[7]), mlp_w=tuple(w[8:]), eps=1e-6, keep=(m1, m2))
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches) == (n[0] + 1, n[1] + 1)
    out_ref, y_ref = wa.swin_block_train_plain(x, *w, bias, m1, m2, *cfg)
    o32, y32 = wa.swin_block_train_plain(*_f32([x] + w), bias, m1, m2, *cfg)
    _check("out", out, out_ref, o32)
    _check("y", y, y_ref, y32)
    for i in range(B):
        if m1[i] == 0:
            assert torch.equal(y[i], x[i])
        if m2[i] == 0:
            assert torch.equal(out[i], y[i])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,heads,shift,dtype", [
    (4, 8, 768, 32, 0, torch.bfloat16), (2, 64, 96, 4, 4, torch.bfloat16),
    (2, 64, 96, 4, 4, torch.float32), (2, 16, 384, 16, 0, torch.float32)])
def test_k6_matches_plain(B, H, C, heads, shift, dtype):
    _need_cuda()
    x, w, bias, g, _, _ = _train_inputs(B, H, C, heads, dtype, seed=C + shift)
    n = wa.window_attention_bwd.launches
    got = wa.window_attention_bwd(x, g, *w[2:6], bias, 8, heads, shift)
    want = wa.window_attention_bwd_plain(x, g, *w[2:6], bias, 8, heads, shift)
    refs = [None] * 6
    if dtype == torch.bfloat16:
        refs = wa.window_attention_bwd_plain(*_f32([x, g] + w[2:6]), bias, 8, heads, shift)
    torch.cuda.synchronize()
    assert wa.window_attention_bwd.launches == n + 1
    for name, a, b, r in zip(["dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias"], got,
                             want, refs):
        _check(name, a, b, r)


@pytest.mark.cuda
def test_k3_k5_wrappers_carry_gradients_on_cuda():
    """``requires_grad`` inputs on the card get gradients through K3 (the
    autograd of the plain block) and K5 (K6), equal to the plain versions'."""
    _need_cuda()
    x, w, bias, g, _, _ = _train_inputs(2, 32, 192, 8, torch.float32, seed=3)
    leaves = [t.clone().requires_grad_() for t in [x] + w + [bias]]
    plain = [t.clone().requires_grad_() for t in [x] + w + [bias]]
    cfg = (8, 8, 4)
    out = wa.fused_swin_block(*leaves, *cfg, 1e-6)
    want = torch.autograd.grad(wa.swin_block_plain(*plain, *cfg, 1e-6), plain, g)
    got = torch.autograd.grad(out, leaves, g)
    for a, b in zip(got, want):
        assert a is not None
        _check("grad", a, b)
    attn = [leaves[0]] + leaves[3:7] + [leaves[13]]
    attn_p = [plain[0]] + plain[3:7] + [plain[13]]
    n = wa.window_attention_bwd.launches
    got = torch.autograd.grad(wa.fused_window_attention(*attn, *cfg), attn, g)
    want = torch.autograd.grad(wa.window_attention_plain(*attn_p, *cfg), attn_p, g)
    assert wa.window_attention_bwd.launches == n + 1
    for a, b in zip(got, want):
        _check("grad", a, b)


@pytest.mark.cuda
def test_train_kernels_refuse_what_they_do_not_take():
    _need_cuda()
    x, w, bias, g, m1, m2 = _train_inputs(2, 8, 768, 32, torch.float32)   # fp32 stage 4
    with pytest.raises(ValueError, match="shared memory"):
        wa.window_attention_bwd(x, g, *w[2:6], bias, 8, 32, 0)
    x, w, bias, g, m1, m2 = _train_inputs(2, 16, 96, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        wa.mlp_bwd(x.transpose(1, 2), g, m2, w[6], w[7], w[8], w[9], w[10], 1e-6)


@pytest.mark.cuda
def test_htsat_train_dispatch_matches_plain():
    """The tiny HTSAT in fp32 on the card, train mode with drop path and spec
    augmentation on one generator seed: K7/K8/K9 in stage 0 and K5/K6 in
    stage 1 against the plain path, loss and every gradient within 1e-4."""
    _need_cuda()
    torch.backends.cudnn.allow_tf32 = False
    from zs_aac_tpu_torch.models.htsat import HTSAT
    from zs_aac_tpu_torch.models.convert import tree_map

    geo = dict(spec_size=64, patch_stride=4, patch_size=4, embed_dim=16, depths=(2, 2),
               num_heads=(2, 4), window_size=4, n_mels=16, drop_path_rate=0.2)
    variables = HTSAT(**geo).init(seed=0, device="cuda")
    spec = torch.randn(4, 100, 16, generator=torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    res = []
    for flags in ({}, {"fused_attn": True, "fused_block": (0,)}):
        params = tree_map(lambda t: t.clone().requires_grad_(), variables["params"])
        out, _ = HTSAT(**geo, **flags).apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, spec, train=True,
            generator=torch.Generator(device="cuda").manual_seed(5))
        leaves = [params["layer0_block1"]["attn"]["qkv"]["kernel"],
                  params["layer1_block0"]["attn"]["rpb_table"], params["patch_proj"]["kernel"]]
        res.append([out.detach()] + list(torch.autograd.grad(out.square().sum(), leaves)))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item() + 1e-6, rtol=0)
