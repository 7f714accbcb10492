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
from its fp32 evaluation). K2's gradient (the VJP of the plain version on
the same wave): 1e-6 of the largest entry; on a pure tone, bins 60-90 dB
under the peak within 0.1 dB (fp32 rounding of the window's leakage). The
split-token weight-gradient product alone (fp32 sums of exact bf16
products): 1e-4 of the largest entry.
"""

import math

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


# Index 0 (the new row alone), the last row, and the full decode's T = 77 at
# d = 64 (4 lanes of 16 bytes a row) and d = 24 (3 lanes of 8: 10 rows a pass,
# two lanes idle); d = 16 and 128 are one and 8 lanes a row.
K1_CASES = [(1, 4, 13, 16, 0), (1, 4, 13, 16, 12), (3, 4, 13, 64, 0), (3, 4, 13, 64, 12),
            (8, 2, 13, 24, 0), (8, 2, 13, 24, 5), (8, 2, 13, 24, 12), (256, 12, 77, 64, 0),
            (256, 12, 77, 64, 40), (256, 12, 77, 64, 76), (16, 12, 77, 24, 0),
            (16, 12, 77, 24, 76), (4, 3, 77, 128, 76),
            # the narrower loads: 4, 2 and 1 bytes a lane (d = 12, 6, 5)
            (4, 3, 13, 12, 0), (4, 3, 13, 12, 12), (4, 3, 13, 6, 0), (4, 3, 13, 6, 12),
            (4, 3, 13, 5, 0), (4, 3, 13, 5, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,T,d,index", K1_CASES)
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
@pytest.mark.parametrize("d", [64, 24])
def test_k1_is_deterministic(d):
    """The row groups' partial outputs are summed by shuffles in a fixed
    order: two calls on the same inputs give bitwise the same o and cache."""
    _need_cuda()
    a = _k1_inputs(256, 12, 77, d, torch.bfloat16, seed=d)
    b = [x.clone() for x in a]
    first, second = decode_attn_q8(*a, 60), decode_attn_q8(*b, 60)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for x, y in zip(a[3:], b[3:]):
        assert torch.equal(x, y)


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
def test_q8_beam_through_k1_matches_plain_path():
    """The int8-cache beam search on a small random GPT-2 (fp32) launches K1
    n_layer times a step at B*K rows; step-locked on its own tokens and beam
    sources, each step's logits through K1 and through the plain attention
    agree within 1e-3 (as in the step test above)."""
    _need_cuda()
    from zs_aac_tpu_torch.decoding import beam
    from zs_aac_tpu_torch.decoding.greedy import CHECK_EVERY
    from zs_aac_tpu_torch.models.gpt2 import (GPT2Config, expand_beam_cache, gpt2_embed,
                                              gpt2_prefill_q8, gpt2_step_q8, init_gpt2,
                                              init_kv_cache_q8, reorder_beam_cache)

    cfg = GPT2Config(vocab_size=101, n_positions=64, n_embd=128, n_layer=2, n_head=4)
    params = init_gpt2(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    B, K, Lp, steps = 6, 3, 6, 14
    emb = torch.randn(B, Lp, 128, generator=g, device="cuda")
    picks, select = [], beam._beam_select
    beam._beam_select = lambda *a: picks.append(select(*a)) or picks[-1]
    try:
        before = decode_attn_q8.launches
        toks, lens, scores = beam.beam_search_batched_q8(params, cfg, emb, K, steps, 13)
        launches = decode_attn_q8.launches - before
    finally:
        beam._beam_select = select
    steps_run = min(steps - 1, -(-(int(lens.max()) - 1) // CHECK_EVERY) * CHECK_EVERY)
    assert len(picks) == steps_run and launches == cfg.n_layer * steps_run
    assert bool(torch.isfinite(scores).all()) and int(toks.max()) < cfg.vocab_size
    with torch.no_grad():
        caches = []
        for _ in range(2):
            c = init_kv_cache_q8(cfg, B, Lp + steps, device="cuda")
            logits, c = gpt2_prefill_q8(params, cfg, emb, c)
            caches.append(expand_beam_cache(c, K))
        _, cur = beam._topk_argmax(torch.log_softmax(logits[:, -1].float(), dim=-1), K)
        for i in range(1, steps_run + 1):
            x = gpt2_embed(params, cur.reshape(-1))
            lk, _ = gpt2_step_q8(params, cfg, x, caches[0], Lp + i - 1)
            lp, _ = gpt2_step_q8(params, cfg, x, caches[1], Lp + i - 1,
                                 attention=decode_attn_q8_plain)
            torch.testing.assert_close(lk, lp, atol=1e-3, rtol=0)
            _, src, cur, _ = picks[i - 1]
            for c in caches:
                reorder_beam_cache(c, src, Lp + i)


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


K2_CONFIGS = {"default": {}, "16k": dict(sr=16000, n_fft=512, hop_length=160, n_mels=40,
                                          f_min=0.0, f_max=8000.0),
              "16mels": dict(n_mels=16)}


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,T", [("16k", 2, 16001), ("16k", 64, 320000), ("16k", 1, 513),
                                      ("16mels", 2, 16001), ("16mels", 1, 513),
                                      ("default", 1, 513), ("default", 64, 320000)])
def test_k2_frame_kernel_matches_plain(name, B, T):
    """K2 through the frame-run kernel (``logmel_plan``'s choice at these
    shapes, counted in ``.fast_launches``) within 2e-3 dB of the plain
    version on noise; silence exactly -100 dB."""
    _need_cuda()
    cfg = lm.LogMelConfig(**K2_CONFIGS[name])
    assert lm.logmel_plan(cfg, B, T).kernel == "frames"
    g = torch.Generator(device="cuda").manual_seed(B + T)
    w = torch.randn(B, T, generator=g, device="cuda") * 0.1
    n, fast = lm.log_mel.launches, lm.log_mel.fast_launches
    got = lm.log_mel(w, cfg)
    torch.cuda.synchronize()
    assert (lm.log_mel.launches, lm.log_mel.fast_launches) == (n + 1, fast + 1)
    torch.testing.assert_close(got, lm.log_mel_plain(w, cfg), atol=2e-3, rtol=0)
    assert (lm.log_mel(torch.zeros(2, T, device="cuda"), cfg) == -100.0).all()


@pytest.mark.cuda
def test_k2_frame_kernel_takes_a_view_off_16_bytes():
    """A contiguous wave whose first sample is not 16-byte aligned (a view
    one sample into its storage) still takes the 16-byte loads (the wrapper
    copies it) and matches the plain version."""
    _need_cuda()
    cfg = lm.LogMelConfig()
    base = torch.randn(2 * 32000 + 1, generator=torch.Generator(device="cuda").manual_seed(9),
                       device="cuda") * 0.1
    w = base[1:].view(2, 32000)
    assert w.data_ptr() % 16 and lm.logmel_plan(cfg, 2, 32000).vec == 4
    torch.testing.assert_close(lm.log_mel(w, cfg), lm.log_mel_plain(w, cfg), atol=2e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [128, 4096])
def test_k2_first_kernel_takes_other_n_fft(n_fft):
    """n_fft outside 256..2048 takes the first kernel (not counted in
    ``.fast_launches``), within 2e-3 dB of the plain version."""
    _need_cuda()
    cfg = lm.LogMelConfig(n_fft=n_fft, hop_length=n_fft // 4)
    assert lm.logmel_plan(cfg, 2, 20000).kernel == "radix2"
    w = torch.randn(2, 20000, generator=torch.Generator(device="cuda").manual_seed(n_fft),
                    device="cuda") * 0.1
    n, fast = lm.log_mel.launches, lm.log_mel.fast_launches
    got = lm.log_mel(w, cfg)
    torch.cuda.synchronize()
    assert (lm.log_mel.launches, lm.log_mel.fast_launches) == (n + 1, fast)
    torch.testing.assert_close(got, lm.log_mel_plain(w, cfg), atol=2e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("freq", [440.0, 1000.0, 7919.0])
def test_k2_frame_kernel_pure_tones(freq):
    """A pure tone: bins within 60 dB of the peak within 2e-3 dB of the plain
    version, 60-90 dB down within 0.1 dB (fp32 rounding of the leakage), the
    rest under peak - 80 dB."""
    _need_cuda()
    cfg = lm.LogMelConfig()
    t = torch.arange(64000, device="cuda") / 32000.0
    tone = (0.5 * torch.sin(2 * math.pi * freq * t))[None]
    got, want = lm.log_mel(tone, cfg), lm.log_mel_plain(tone, cfg)
    peak = want.max()
    loud, mid = want > peak - 60.0, (want <= peak - 60.0) & (want > peak - 90.0)
    torch.testing.assert_close(got[loud], want[loud], atol=2e-3, rtol=0)
    torch.testing.assert_close(got[mid], want[mid], atol=0.1, rtol=0)
    assert (got[~(loud | mid)] < peak - 80.0).all()


@pytest.mark.cuda
def test_k2_wrapper_carries_gradient_on_cuda():
    """A wave that requires grad gets d(wave) through K2 on the card: the
    output has a ``grad_fn`` and the gradient is the VJP of ``log_mel_plain``
    on the same wave, one K2 launch and none in the backward. Both sides run
    the same plain ops on the same device: within 1e-6 of the largest entry."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(21)
    w = torch.randn(2, 16001, generator=g, device="cuda") * 0.1
    cfg = lm.LogMelConfig()
    leaf, plain = w.clone().requires_grad_(), w.clone().requires_grad_()
    n = lm.log_mel.launches
    out = lm.log_mel(leaf, cfg)
    assert out.grad_fn is not None and lm.log_mel.launches == n + 1
    cot = torch.randn(out.shape, generator=g, device="cuda")
    got = torch.autograd.grad(out, leaf, cot)[0]
    want = torch.autograd.grad(lm.log_mel_plain(plain, cfg), plain, cot)[0]
    torch.cuda.synchronize()
    assert lm.log_mel.launches == n + 1
    torch.testing.assert_close(got, want, atol=1e-6 * want.abs().max().item(), rtol=0)


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


# K8 in bf16 at HTSAT's stage 1-3 shapes (the tensor-core per-token kernel and
# the tensor-core weight-gradient products): an odd batch whose tokens do not
# fill the last chunks evenly, the train step's batch, and keep scales that
# hold zeros (a dropped sample's rows pass their cotangent through unchanged).
K8_TC_CASES = [(B, H, C, heads) for B in (3, 64)
               for H, C, heads in ((64, 96, 4), (32, 192, 8), (16, 384, 16))]


def _k8_inputs(B, H, C, heads, seed):
    y, w, _ = _window_inputs(B, H, C, heads, torch.bfloat16, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    g = torch.randn(B, H, H, C, generator=gen, device="cuda").bfloat16()
    m2 = torch.tensor([1.25, 0.0, 1.0], device="cuda").repeat(B)[:B].contiguous()
    return y, g, m2, (w[6], w[7], w[8], w[9], w[10])


K8_OUTPUTS = ["dy", "dln2_s", "dln2_b", "dfc1_w", "dfc1_b", "dfc2_w", "dfc2_b"]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,heads", K8_TC_CASES)
def test_k8_tensor_core_kernel_matches_plain(B, H, C, heads):
    _need_cuda()
    y, g, m2, ln2_fc = _k8_inputs(B, H, C, heads, seed=B + C)
    n = (wa.mlp_bwd.launches, wa.mlp_bwd.tc_launches, wa._wgrad.tc_launches)
    got = wa.mlp_bwd(y, g, m2, *ln2_fc, 1e-6)
    torch.cuda.synchronize()
    assert (wa.mlp_bwd.launches, wa.mlp_bwd.tc_launches, wa._wgrad.tc_launches) == (
        n[0] + 1, n[1] + 1, n[2] + 2)
    want = wa.mlp_bwd_plain(y, g, m2, *ln2_fc, 1e-6)
    want32 = wa.mlp_bwd_plain(*_f32([y, g]), m2, *_f32(ln2_fc), 1e-6)
    for name, a, b, r in zip(K8_OUTPUTS, got, want, want32):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _check(name, a, b, r)
    for i in range(B):
        if m2[i] == 0:
            assert torch.equal(got[0][i], g[i])


@pytest.mark.cuda
def test_k8_tensor_core_kernel_through_the_train_block_with_fp32_ln_parameters():
    """``fused_swin_block_train`` with fp32 LN parameters (as the models keep
    them): the backward hands K8 their bf16 roundings, K8 takes the
    tensor-core kernels, and the LN2 gradients come back in fp32."""
    _need_cuda()
    x, w, bias, g, m1, m2 = _train_inputs(2, 32, 192, 8, torch.bfloat16, seed=7)
    w = [t.float() if i in (0, 1, 6, 7) else t for i, t in enumerate(w)]
    leaves = [t.clone().requires_grad_() for t in [x] + w]
    cfg = (8, 8, 4, 1e-6)
    n = (wa.mlp_bwd.launches, wa.mlp_bwd.tc_launches)
    out = wa.fused_swin_block_train(*leaves, bias, m1, m2, *cfg)
    grads = torch.autograd.grad(out, leaves, g)
    assert (wa.mlp_bwd.launches, wa.mlp_bwd.tc_launches) == (n[0] + 1, n[1] + 1)
    # the residual y that the backward saw: K7's, which is deterministic
    _, y = wa._launch(wa.fused_swin_block_train, True, x, *w[2:6], bias,
                      *cfg[:3], ln=tuple(w[i].bfloat16() for i in (0, 1, 6, 7)),
                      mlp_w=tuple(w[8:]), eps=1e-6, keep=(m1, m2))
    ln2_fc = (w[6], w[7], w[8], w[9], w[10])
    want = wa.mlp_bwd_plain(y, g, m2, *ln2_fc, 1e-6)
    want32 = wa.mlp_bwd_plain(*_f32([y, g]), m2, *_f32(ln2_fc), 1e-6)
    # leaves: x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w
    for name, got, b, r in zip(K8_OUTPUTS[1:6], grads[7:12], want[1:6], want32[1:6]):
        _check(name, got, b, r)
    assert grads[7].dtype == grads[8].dtype == torch.float32
    assert grads[9].dtype == grads[11].dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("C", [96, 192, 384, 768])
def test_wgrad_tensor_core_matches_plain(C):
    """The split-token product at every weight gradient of K8 (dWfc1, dWfc2),
    K9 and K6 (dWqkv, dWproj) of one stage, on 8200 tokens: no multiple of the
    32-token step, so the last chunk is ragged. fp32 sums of exact bf16
    products in another order: 1e-4 of the largest entry."""
    _need_cuda()
    n_tok = 8200
    gen = torch.Generator(device="cuda").manual_seed(C)
    for M, Ncol in ((C, 4 * C), (4 * C, C), (C, 3 * C), (C, C)):
        A = torch.randn(n_tok, M, generator=gen, device="cuda").bfloat16()
        B = torch.randn(n_tok, Ncol, generator=gen, device="cuda").bfloat16()
        n = wa._wgrad.tc_launches
        got, tc = wa._wgrad(wa._train_lib(), "test", A, M, B, Ncol, n_tok, M, Ncol)
        again, _ = wa._wgrad(wa._train_lib(), "test", A, M, B, Ncol, n_tok, M, Ncol)
        assert tc and wa._wgrad.tc_launches == n + 2
        _check(f"[{M}, {Ncol}]", got, A.float().t() @ B.float())
        assert torch.equal(got, again)
        # a strided operand: the columns M.. of a wider scratch
        wide = torch.randn(n_tok, M + 96, generator=gen, device="cuda").bfloat16()
        got, _ = wa._wgrad(wa._train_lib(), "test", wide[:, 96:], M + 96, B, Ncol, n_tok, M, Ncol)
        _check(f"strided [{M}, {Ncol}]", got, wide[:, 96:].float().t() @ B.float())
    # the column sums and fp32 stay with the FMA kernel
    n = wa._wgrad.tc_launches
    got, tc = wa._wgrad(wa._train_lib(), "test", None, 0, B, Ncol, n_tok, 1, Ncol)
    assert not tc and wa._wgrad.tc_launches == n
    _check("column sums", got.reshape(-1), B.float().sum(0))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,heads", [(8, 64, 96, 4), (8, 32, 192, 8), (8, 16, 384, 16)])
def test_k8_is_deterministic(B, H, C, heads):
    """No atomics: the partials are summed in a fixed order, so two runs on
    the same inputs give bitwise the same seven outputs."""
    _need_cuda()
    y, g, m2, ln2_fc = _k8_inputs(B, H, C, heads, seed=C)
    first = wa.mlp_bwd(y, g, m2, *ln2_fc, 1e-6)
    second = wa.mlp_bwd(y, g, m2, *ln2_fc, 1e-6)
    torch.cuda.synchronize()
    for name, a, b in zip(K8_OUTPUTS, first, second):
        assert torch.equal(a, b), name


# K9 in bf16 at HTSAT's stage 1-3 shapes (the tensor-core per-window and dx
# kernels, and the tensor-core weight-gradient products): an odd batch (an
# odd count of windows for the two-window blocks of stage 1), the train
# step's batch, shift 0 and 4, and a keep scale m1 that holds a zero (a
# dropped sample's rows pass dy through unchanged).
K9_TC_CASES = [(B, H, C, heads, shift) for B in (3, 64)
               for H, C, heads in ((64, 96, 4), (32, 192, 8), (16, 384, 16)) for shift in (0, 4)]
K9_OUTPUTS = ["dx", "dln1_s", "dln1_b", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias"]


def _k9_inputs(B, H, C, heads, seed):
    x, w, bias = _window_inputs(B, H, C, heads, torch.bfloat16, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(B, H, H, C, generator=gen, device="cuda").bfloat16()
    m1 = torch.tensor([1.25, 0.0, 1.0], device="cuda").repeat(B)[:B].contiguous()
    return x, dy, m1, w, bias


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,heads,shift", K9_TC_CASES)
def test_k9_tensor_core_kernel_matches_plain(B, H, C, heads, shift):
    """The direct call, then (at B = 3) the train block's backward with fp32
    LN parameters, as the models keep them: K9 gets their bf16 roundings,
    takes the tensor-core kernels, and the LN1 gradients come back in fp32."""
    _need_cuda()
    x, dy, m1, w, bias = _k9_inputs(B, H, C, heads, seed=B + C + shift)
    cfg = (8, heads, shift, 1e-6)
    fn = wa.attn_ln1_bwd
    n = (fn.launches, fn.tc_launches, wa._wgrad.tc_launches)
    got = fn(x, dy, m1, *w[:5], bias, *cfg)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches, wa._wgrad.tc_launches) == (n[0] + 1, n[1] + 1, n[2] + 2)
    want = wa.attn_ln1_bwd_plain(x, dy, m1, *w[:5], bias, *cfg)
    want32 = wa.attn_ln1_bwd_plain(*_f32([x, dy]), m1, *_f32(w[:5]), bias, *cfg)
    for name, a, b, r in zip(K9_OUTPUTS, got, want, want32):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _check(name, a, b, r)
    for i in range(B):
        if m1[i] == 0:
            assert torch.equal(got[0][i], dy[i])
    if B != 3:
        return
    w = [t.float() if i in (0, 1, 6, 7) else t for i, t in enumerate(w)]
    m2 = m1.flip(0).contiguous()
    leaves = [t.clone().requires_grad_() for t in [x] + w]
    n = fn.tc_launches
    out = wa.fused_swin_block_train(*leaves, bias, m1, m2, *cfg)
    grads = torch.autograd.grad(out, leaves, dy)
    assert fn.tc_launches == n + 1
    # the dy that K9 saw: K8's on K7's y, both deterministic
    ln = tuple(w[i].bfloat16() for i in (0, 1, 6, 7))
    _, y = wa._launch(wa.fused_swin_block_train, True, x, *w[2:6], bias, *cfg[:3], ln=ln,
                      mlp_w=tuple(w[8:]), eps=1e-6, keep=(m1, m2))
    dy9 = wa.mlp_bwd(y, dy, m2, *ln[2:], w[8], w[9], w[10], 1e-6)[0]
    want = wa.attn_ln1_bwd_plain(x, dy9, m1, *ln[:2], *w[2:5], bias, *cfg)
    want32 = wa.attn_ln1_bwd_plain(*_f32([x, dy9]), m1, *_f32(ln[:2] + tuple(w[2:5])), bias,
                                   *cfg)
    # leaves: x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ...
    for name, a, b, r in zip(K9_OUTPUTS[:7], grads[:7], want[:7], want32[:7]):
        _check(f"block {name}", a, b, r)
    assert grads[1].dtype == grads[2].dtype == torch.float32
    assert grads[3].dtype == grads[5].dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,heads", [(8, 64, 96, 4), (8, 32, 192, 8), (8, 16, 384, 16)])
def test_k9_is_deterministic(B, H, C, heads):
    """No atomics: the dbias, LN1 and bias partials are summed in a fixed
    order, so two runs on the same inputs give bitwise the same outputs."""
    _need_cuda()
    x, dy, m1, w, bias = _k9_inputs(B, H, C, heads, seed=C)
    first = wa.attn_ln1_bwd(x, dy, m1, *w[:5], bias, 8, heads, 4, 1e-6)
    second = wa.attn_ln1_bwd(x, dy, m1, *w[:5], bias, 8, heads, 4, 1e-6)
    torch.cuda.synchronize()
    for name, a, b in zip(K9_OUTPUTS, first, second):
        assert torch.equal(a, b), name


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


# K6 in bf16 at stage 4 (the tensor-core kernels A and B of K9 without LN1
# and m1): an odd batch, the train step's batch, shift 0 and 4, and a 16x16
# input (4 windows a sample) with and without the shift.
K6_TC_CASES = [(3, 8, 0), (3, 8, 4), (64, 8, 0), (64, 8, 4), (3, 16, 0), (3, 16, 4)]
K6_OUTPUTS = ["dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias"]


def _k6_inputs(B, H, seed):
    x, w, bias = _window_inputs(B, H, 768, 32, torch.bfloat16, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    return x, torch.randn(B, H, H, 768, generator=gen, device="cuda").bfloat16(), w[2:6], bias


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,shift", K6_TC_CASES)
def test_k6_tensor_core_kernel_matches_plain(B, H, shift):
    _need_cuda()
    x, g, w, bias = _k6_inputs(B, H, seed=B + H + shift)
    fn = wa.window_attention_bwd
    n = (fn.launches, fn.tc_launches, wa._wgrad.tc_launches)
    got = fn(x, g, *w, bias, 8, 32, shift)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches, wa._wgrad.tc_launches) == (n[0] + 1, n[1] + 1, n[2] + 2)
    want = wa.window_attention_bwd_plain(x, g, *w, bias, 8, 32, shift)
    want32 = wa.window_attention_bwd_plain(*_f32([x, g] + w), bias, 8, 32, shift)
    for name, a, b, r in zip(K6_OUTPUTS, got, want, want32):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _check(name, a, b, r)


@pytest.mark.cuda
@pytest.mark.parametrize("H,shift", [(8, 0), (16, 4)])
def test_k6_is_deterministic(H, shift):
    """No atomics: the dbias and bias partials are summed in a fixed order, so
    two runs on the same inputs give bitwise the same six outputs."""
    _need_cuda()
    x, g, w, bias = _k6_inputs(8, H, seed=H)
    first = wa.window_attention_bwd(x, g, *w, bias, 8, 32, shift)
    second = wa.window_attention_bwd(x, g, *w, bias, 8, 32, shift)
    torch.cuda.synchronize()
    for name, a, b in zip(K6_OUTPUTS, first, second):
        assert torch.equal(a, b), name


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
