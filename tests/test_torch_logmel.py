"""The port's log-mel frontend (K2's plain version and wrapper) and on-device
resample against the JAX package, on the same numpy inputs.

Tolerances: the two log-mels are both fp32 rFFTs (pocketfft through XLA and
through PyTorch) differing in summation order (~1e-6 relative), which is
< 1e-3 dB wherever the mel power is well above fp32 rounding; silence is
exactly -100 dB on both sides. For a pure tone most mel bins hold only the
Hann window's leakage, far below the peak, where the FFTs' fp32 rounding
(~1e-7 of the peak amplitude) is a relative error of ~2e-7 * sqrt(peak /
power) in power: bins within 60 dB of the peak are held to 2e-3 dB, bins
60-90 dB down to 0.1 dB, and the rest, at the rounding floor, must stay
below peak - 80 dB on both sides. The resample is one fp32 matmul on both sides:
1e-6 absolute on a [-1, 1] wave.

K2's frame-run kernel cannot run here, but its tables, index maps and plan
can: a float64 model of its decomposition (Stockham passes over the packed
complex FFT, the split step, the chunked mel sums) on the tables the kernel
is handed is held to ``np.fft.rfft`` at 1e-9 of the largest power (float64
rounding), and its log-mel to ``log_mel_xla`` at the 1e-3 dB above.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zs_aac_tpu.ops import logmel as jl
from zs_aac_tpu.ops.resample import resample_poly_device as jax_resample
from zs_aac_tpu_torch.ops import logmel as tl
from zs_aac_tpu_torch.ops.resample import poly_resample_plan, resample_poly_device

torch.set_num_threads(2)

CONFIGS = [dict(), dict(sr=16000, n_fft=512, hop_length=160, n_mels=40, f_min=0.0,
                        f_max=8000.0), dict(n_mels=16)]


@pytest.mark.parametrize("kw", CONFIGS, ids=["default", "16k", "16mels"])
def test_constants_equal(kw):
    cj, ct = jl.LogMelConfig(**kw), tl.LogMelConfig(**kw)
    assert dataclass_tuple(cj) == dataclass_tuple(ct)
    np.testing.assert_array_equal(
        tl.mel_filterbank(ct.sr, ct.n_fft, ct.n_mels, ct.f_min, ct.f_max),
        jl.mel_filterbank(cj.sr, cj.n_fft, cj.n_mels, cj.f_min, cj.f_max))
    np.testing.assert_array_equal(tl.hann_window(ct.n_fft), jl.hann_window(cj.n_fft))
    for n in (1000, 32000, 320000):
        assert tl.num_frames(n, ct) == jl.num_frames(n, cj)
    args = {"sr": 32000, "n_fft": 1024, "hop_length": 320, "n_mels": 64, "f_min": 50,
            "f_max": 14000}
    assert dataclass_tuple(tl.LogMelConfig.from_dict(args)) == \
        dataclass_tuple(jl.LogMelConfig.from_dict(args))


def dataclass_tuple(c):
    return (c.sr, c.n_fft, c.hop_length, c.n_mels, c.f_min, c.f_max, c.ref, c.amin)


def _jax(wave, kw=None):
    return np.asarray(jl.log_mel_xla(jnp.asarray(wave), jl.LogMelConfig(**(kw or {}))))


def _port(wave, kw=None):
    return tl.log_mel_plain(torch.from_numpy(wave), tl.LogMelConfig(**(kw or {}))).numpy()


@pytest.mark.parametrize("B,T", [(2, 16000), (1, 16001), (3, 7777), (1, 1025), (1, 1000),
                                 (1, 513)])
def test_log_mel_plain_matches_jax(B, T):
    wave = (np.random.default_rng(T).standard_normal((B, T)) * 0.1).astype(np.float32)
    want, got = _jax(wave), _port(wave)
    assert got.shape == want.shape == (B, 1, T // 320 + 1, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kw", CONFIGS[1:], ids=["16k", "16mels"])
def test_log_mel_plain_other_configs(kw):
    wave = (np.random.default_rng(1).standard_normal((2, 8000)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(_port(wave, kw), _jax(wave, kw), rtol=0, atol=1e-3)


def test_log_mel_silence_is_floor():
    wave = np.zeros((2, 9600), np.float32)
    got = _port(wave)
    np.testing.assert_array_equal(got, _jax(wave))
    assert (got == -100.0).all()


@pytest.mark.parametrize("freq", [440.0, 1000.0, 7919.0])
def test_log_mel_pure_tone(freq):
    t = np.arange(16000) / 32000.0
    wave = (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[None]
    want, got = _jax(wave), _port(wave)
    peak = want.max()
    loud, mid = want > peak - 60.0, (want <= peak - 60.0) & (want > peak - 90.0)
    quiet = ~(loud | mid)
    assert loud.any() and quiet.any()
    np.testing.assert_allclose(got[loud], want[loud], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[mid], want[mid], rtol=0, atol=0.1)
    assert (got[quiet] < peak - 80.0).all() and (want[quiet] < peak - 80.0).all()


def test_wrapper_takes_the_plain_version_on_cpu():
    wave = (np.random.default_rng(3).standard_normal((2, 4000)) * 0.1).astype(np.float32)
    cfg = tl.LogMelConfig()
    before = tl.log_mel.launches
    got = tl.log_mel(torch.from_numpy(wave), cfg)
    assert tl.log_mel.launches == before
    torch.testing.assert_close(got, tl.log_mel_plain(torch.from_numpy(wave), cfg), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="no kernel"):
        tl.log_mel(torch.zeros(1, 4000, device="meta"), cfg)


@pytest.mark.parametrize("kw", CONFIGS[:2], ids=["default", "16k"])
def test_log_mel_gradient_matches_jax(kw):
    """d(wave) of the port's ``log_mel`` (the autograd of ``log_mel_plain`` on
    the CPU; on the card K2's wrapper returns the same VJP) against
    ``jax.vjp`` of ``log_mel_xla``, for one seeded cotangent. Both are fp32
    VJPs of an rFFT, a matmul and 10 log10: summation order only, within 1e-5
    of the largest entry (measured: 6e-7)."""
    import jax

    rng = np.random.default_rng(17)
    wave = (rng.standard_normal((2, 6000)) * 0.1).astype(np.float32)
    cfg_j, cfg_t = jl.LogMelConfig(**kw), tl.LogMelConfig(**kw)
    out, vjp = jax.vjp(lambda w: jl.log_mel_xla(w, cfg_j), jnp.asarray(wave))
    g = rng.standard_normal(out.shape).astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(g))[0])
    leaf = torch.from_numpy(wave).requires_grad_()
    got = torch.autograd.grad(tl.log_mel(leaf, cfg_t), leaf, torch.from_numpy(g))[0].numpy()
    assert got.shape == want.shape == wave.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


# -- K2's plan, and the frame-run kernel's decomposition on its own tables ----

PLAN_T = [513, 1000, 1025, 16001, 320000, 960000]   # the last two: 10 s and 30 s at 32 kHz


@pytest.mark.parametrize("T", PLAN_T)
@pytest.mark.parametrize("kw", CONFIGS, ids=["default", "16k", "16mels"])
def test_logmel_plan_takes_the_frame_run_kernel(kw, T):
    cfg = tl.LogMelConfig(**kw)
    plan = tl.logmel_plan(cfg, 64, T)
    assert plan.kernel == "frames" and plan.warps == 8
    assert 1 <= plan.frames <= min(tl._FRAMES, tl.num_frames(T, cfg))
    assert plan.smem == tl._frames_smem(cfg, plan.frames, plan.warps) <= 232448
    assert plan.vec == (4 if T % 4 == 0 else 1)


def test_logmel_plan_other_shapes():
    for n in (2, 4, 8, 16, 32, 64, 128, 4096):
        plan = tl.logmel_plan(tl.LogMelConfig(n_fft=n, hop_length=max(1, n // 4)), 2, 9000)
        assert plan == tl.LogMelPlan("radix2", 1, 8, 8 * n, 1) and plan.smem <= 32768
    for n in (256, 2048):
        assert tl.logmel_plan(tl.LogMelConfig(n_fft=n), 2, 9000).kernel == "frames"
    # 256 mels over 129 bins: 151 chunk sums do not fit beside the power in a warp's tile
    many = tl.LogMelConfig(n_fft=256, n_mels=256)
    assert len(tl._tables(many)["chunks"]) > 128 + 16 - 1
    assert tl.logmel_plan(many, 1, 9000).kernel == "radix2"
    # a long hop: frames per block halved until the span fits the card's limit
    cfg = tl.LogMelConfig(n_fft=2048, hop_length=4000)
    plan = tl.logmel_plan(cfg, 1, 400000)
    assert plan.kernel == "frames" and plan.frames < tl._FRAMES
    assert tl._frames_smem(cfg, plan.frames, 8) <= 232448 < tl._frames_smem(cfg, 2 * plan.frames, 8)
    for bad in (3, 1000, 8192, 1):
        with pytest.raises(ValueError, match="power of two"):
            tl.logmel_plan(tl.LogMelConfig(n_fft=bad), 1, 32000)
    with pytest.raises(ValueError, match="reflect-padded"):
        tl.logmel_plan(tl.LogMelConfig(), 1, 512)
    with pytest.raises(ValueError, match="batch"):
        tl.logmel_plan(tl.LogMelConfig(), 0, 32000)


def test_cpu_waves_launch_no_kernel():
    wave = torch.from_numpy((np.random.default_rng(4).standard_normal((2, 4000)) * 0.1)
                            .astype(np.float32))
    before = tl.log_mel.launches, tl.log_mel.fast_launches
    tl.log_mel(wave, tl.LogMelConfig())
    assert (tl.log_mel.launches, tl.log_mel.fast_launches) == before


@pytest.mark.parametrize("kw", CONFIGS, ids=["default", "16k", "16mels"])
def test_frame_kernel_tables(kw):
    """Each band's chunks tile its non-zero bins in order, with the
    filterbank's weights (zeros past a chunk's length); the chunk sums fit in
    a warp's tile beside the power; the twiddles are the passes' in order."""
    cfg = tl.LogMelConfig(**kw)
    t = tl._tables(cfg)
    m = cfg.n_fft // 2
    lo, ln = t["chunks"] & 0xFFFF, t["chunks"] >> 16
    assert (ln >= 1).all() and (ln <= tl._CHUNK).all()
    assert t["first"][0] == 0 and t["first"][-1] == len(t["chunks"])
    for band in range(cfg.n_mels):
        c = np.arange(t["first"][band], t["first"][band + 1])
        bins = np.concatenate([np.arange(lo[i], lo[i] + ln[i]) for i in c])
        np.testing.assert_array_equal(bins, np.flatnonzero(t["mel_w"][:, band]))
        for i in c:
            np.testing.assert_array_equal(t["melw"][:ln[i], i],
                                          t["mel_w"][lo[i]:lo[i] + ln[i], band])
            assert not t["melw"][ln[i]:, i].any()
    assert len(t["chunks"]) <= m + m // 8 - 1
    rows, ns = 0, tl._radices(cfg.n_fft)[0]
    for r in tl._radices(cfg.n_fft)[1:]:
        q, jm = np.divmod(np.arange((r - 1) * ns), ns)
        want = np.exp(-2j * np.pi * jm * (q + 1) / (ns * r))
        got = t["fft_tw"][rows:rows + (r - 1) * ns]
        np.testing.assert_allclose(got[:, 0] + 1j * got[:, 1], want, rtol=0, atol=1e-15)
        rows, ns = rows + (r - 1) * ns, ns * r
    assert rows < m and not t["fft_tw"][rows:].any()
    k = np.arange(m // 2 + 1)
    np.testing.assert_allclose(t["split_tw"][:, 0] + 1j * t["split_tw"][:, 1],
                               np.exp(-2j * np.pi * k / cfg.n_fft), rtol=0, atol=1e-15)


def _model_spectrum(frames, n_fft, t):
    """The frame-run kernel's power spectrum in float64: the real frames
    [..., n_fft] packed as an M-point complex FFT of (even, odd) samples,
    Stockham passes of ``_radices(n_fft)`` with the tables' twiddles (an
    exact r-point DFT per butterfly), then the split step."""
    m = n_fft // 2
    data, ns, row = frames[..., 0::2] + 1j * frames[..., 1::2], 1, 0
    tw = t["fft_tw"][:, 0] + 1j * t["fft_tw"][:, 1]
    for r in tl._radices(n_fft):
        j, q = np.arange(m // r)[:, None], np.arange(r)[None, :]
        v = data[..., j + q * (m // r)]                   # butterfly j reads x[j + q M/r]
        if ns > 1:
            v[..., 1:] *= tw[row + (q[:, 1:] - 1) * ns + j % ns]
            row += (r - 1) * ns
        out = np.empty_like(data)
        out[..., (j // ns) * ns * r + j % ns + q * ns] = v @ np.exp(-2j * np.pi * q.T * q / r)
        data, ns = out, ns * r
    k = np.arange(m // 2 + 1)
    a, c = data[..., k], np.conj(data[..., (m - k) % m])
    even, odd = (a + c) / 2, (a - c) / 2j
    w = t["split_tw"][:, 0] + 1j * t["split_tw"][:, 1]
    power = np.empty(frames.shape[:-1] + (m + 1,))
    power[..., m - k] = np.abs(even - w * odd) ** 2       # X[M-k] = conj(E - W^k O)
    power[..., k] = np.abs(even + w * odd) ** 2
    return power


def _model_log_mel(wave, cfg):
    """K2's frame-run kernel in float64 on its tables and index maps: each
    block's span of samples (reflected where it crosses an end of the row),
    the frames read from it, the spectrum, the chunk sums and band sums."""
    t, plan = tl._tables(cfg), tl.logmel_plan(cfg, *wave.shape)
    B, T = wave.shape
    n, hop, F = cfg.n_fft, cfg.hop_length, tl.num_frames(T, cfg)
    frames = np.empty((B, F, n))
    for f0 in range(0, F, plan.frames):
        nf = min(plan.frames, F - f0)
        idx = f0 * hop - n // 2 + np.arange((nf - 1) * hop + n)
        idx = np.where(idx < 0, -idx, idx)
        idx = np.where(idx >= T, 2 * (T - 1) - idx, idx)
        span = wave[:, idx].astype(np.float64)
        for fl in range(nf):
            frames[:, f0 + fl] = span[:, fl * hop:fl * hop + n]
    power = _model_spectrum(frames * t["win"], n, t)
    lo, m = t["chunks"] & 0xFFFF, n // 2
    part = sum(power[..., np.minimum(lo + i, m)] * t["melw"][i] for i in range(tl._CHUNK))
    mel = np.stack([part[..., t["first"][b]:t["first"][b + 1]].sum(-1)
                    for b in range(cfg.n_mels)], -1)
    return (10 * np.log10(np.maximum(mel, cfg.amin)) - tl._log_ref(cfg))[:, None]


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048])
def test_frame_kernel_spectrum_matches_rfft(n_fft):
    cfg = tl.LogMelConfig(n_fft=n_fft)
    x = np.random.default_rng(n_fft).standard_normal((3, 5, n_fft))
    want = np.abs(np.fft.rfft(x)) ** 2
    got = _model_spectrum(x, n_fft, tl._tables(cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * want.max())


@pytest.mark.parametrize("B,T", [(2, 16000), (1, 16001), (1, 1025), (1, 513)])
@pytest.mark.parametrize("kw", CONFIGS, ids=["default", "16k", "16mels"])
def test_frame_kernel_model_matches_jax(kw, B, T):
    wave = (np.random.default_rng(T + B).standard_normal((B, T)) * 0.1).astype(np.float32)
    want = _jax(wave, kw)
    got = _model_log_mel(wave, tl.LogMelConfig(**kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    silence = _model_log_mel(np.zeros((1, T), np.float32), tl.LogMelConfig(**kw))
    assert (silence == -100.0).all()


@pytest.mark.parametrize("sr_in,n,target", [(44100, 44100, 32000), (48000, 24000, None),
                                            (22050, 22050, 40000), (16000, 8000, 1000)])
def test_resample_matches_jax(sr_in, n, target):
    rng = np.random.default_rng(sr_in)
    pcm = (rng.standard_normal((2, n)) * 8000).clip(-32768, 32767).astype(np.int16)
    want = np.asarray(jax_resample(jnp.asarray(pcm), sr_in, 32000, target))
    got = resample_poly_device(torch.from_numpy(pcm), sr_in, 32000, target).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # float input goes through the same plan
    wave = pcm.astype(np.float32) / 32768.0
    got_f = resample_poly_device(torch.from_numpy(wave), sr_in, 32000, target).numpy()
    np.testing.assert_allclose(got_f, got, rtol=0, atol=1e-6)


def test_resample_identity_and_plan():
    from zs_aac_tpu.ops.resample import poly_resample_plan as jax_plan

    pcm = (np.random.default_rng(5).standard_normal((1, 1000)) * 1000).astype(np.int16)
    y = resample_poly_device(torch.from_numpy(pcm), 32000, 32000, 1500).numpy()
    assert y.shape == (1, 1500) and not y[0, 1000:].any()
    np.testing.assert_array_equal(y[0, :1000], pcm[0].astype(np.float32) / 32768.0)
    for a, b in zip(poly_resample_plan(44100, 32000, 4410), jax_plan(44100, 32000, 4410)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
