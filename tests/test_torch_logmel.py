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
