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
