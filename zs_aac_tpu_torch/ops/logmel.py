"""Log-mel spectrogram frontend (kernel K2).

The counterpart of the JAX package's ``ops/logmel.py``: a waveform batch
``[B, T]`` becomes ``[B, 1, F, n_mels]`` with ``F = T // hop + 1``
(librosa ``center=True``): reflect padding by ``n_fft // 2``, frames every
``hop`` samples, a periodic Hann window, the power spectrum, a Slaney mel
filterbank and ``10 * log10(max(mel, amin)) - 10 * log10(max(amin, ref))``.

- ``log_mel_plain`` is the counterpart of ``log_mel_xla``: ``torch.fft.rfft``
  over ``unfold``-ed frames and one matmul against the filterbank.
- ``log_mel`` is the wrapper of K2 (``csrc/logmel.cu``), which replaces the
  Pallas TPU kernel ``zs_aac_tpu/ops/logmel.py::_logmel_kernel``. For CPU
  tensors it calls ``log_mel_plain``; for CUDA tensors it launches the
  kernel or raises. ``log_mel.launches`` counts launches. On CUDA its
  gradient is the VJP of ``log_mel_plain`` (``_LogMel``), as the JAX
  ``log_mel_pallas``'s is that of ``log_mel_xla``.

The kernel computes each frame's spectrum with a radix-2 FFT in shared
memory (the TPU kernel's DFT-as-two-matmuls served the MXU; on the card an
FFT does ~100x fewer operations for the same function), so it is held to
``log_mel_plain``'s rFFT, not to the TPU kernel's ~0.2 dB MXU rounding.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from zs_aac_tpu_torch.utils.cuda_build import load_library

__all__ = [
    "LogMelConfig",
    "mel_filterbank",
    "hann_window",
    "num_frames",
    "log_mel",
    "log_mel_plain",
]

_AMIN = 1e-10
_THREADS = 256       # kThreads in csrc/logmel.cu
_MAX_NFFT = 4096     # n_fft * 8 bytes of shared memory: 32 KB


@dataclasses.dataclass(frozen=True)
class LogMelConfig:
    """Audio frontend hyperparameters. Defaults are the reference's
    ``audio_args``: sr=32000, n_fft=1024, hop=320, 64 mels, 50-14000 Hz."""

    sr: int = 32000
    n_fft: int = 1024
    hop_length: int = 320
    n_mels: int = 64
    f_min: float = 50.0
    f_max: float = 14000.0
    ref: float = 1.0
    amin: float = _AMIN

    @classmethod
    def from_dict(cls, audio_args: dict) -> "LogMelConfig":
        return cls(
            sr=audio_args["sr"],
            n_fft=audio_args["n_fft"],
            hop_length=audio_args["hop_length"],
            n_mels=audio_args["n_mels"],
            f_min=audio_args["f_min"],
            f_max=audio_args["f_max"],
        )


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney-scale Hz->mel (librosa ``htk=False`` default)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freq >= min_log_hz
    return np.where(
        log_t,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, f_min: float, f_max: float,
                   dtype=np.float32) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, ``[n_fft//2+1, n_mels]``
    (``librosa.filters.mel(htk=False, norm='slaney')`` transposed)."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])   # Slaney area norm
    weights *= enorm[:, None]
    return weights.T.astype(dtype)  # [n_freqs, n_mels]


def hann_window(n_fft: int, dtype=np.float32) -> np.ndarray:
    """Periodic (fftbins) Hann window, as scipy ``get_window('hann')``."""
    n = np.arange(n_fft, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)).astype(dtype)


def num_frames(n_samples: int, cfg: LogMelConfig) -> int:
    return n_samples // cfg.hop_length + 1


def _log_ref(cfg: LogMelConfig) -> float:
    return 10.0 * math.log10(max(cfg.amin, cfg.ref))


@functools.lru_cache(maxsize=8)
def _constants(cfg: LogMelConfig, device: str):
    """Window, filterbank, each mel's range of non-zero bins and the FFT
    twiddles exp(-2 pi i k / n_fft), k < n_fft/2, on ``device``."""
    mel_w = mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max)
    nz = mel_w != 0
    lo = np.where(nz.any(0), nz.argmax(0), 0).astype(np.int32)
    hi = np.where(nz.any(0), mel_w.shape[0] - nz[::-1].argmax(0), 0).astype(np.int32)
    k = np.arange(cfg.n_fft // 2, dtype=np.float64)
    ang = 2.0 * np.pi * k / cfg.n_fft
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"win": to(hann_window(cfg.n_fft)), "mel_w": to(mel_w), "lo": to(lo),
            "hi": to(hi), "tw": to(tw)}


def log_mel_plain(wave: torch.Tensor, cfg: LogMelConfig) -> torch.Tensor:
    """Plain PyTorch version of K2 (``log_mel_xla``'s function).
    ``wave [B, T] -> [B, 1, F, n_mels]`` float32."""
    wave = wave.float()
    consts = _constants(cfg, str(wave.device))
    pad = cfg.n_fft // 2
    x = F.pad(wave[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)            # [B, F, n_fft]
    spec = torch.fft.rfft(frames * consts["win"], dim=-1)
    power = spec.real.square() + spec.imag.square()              # [B, F, n_freqs]
    mel = power @ consts["mel_w"]                                # [B, F, n_mels]
    out = 10.0 * torch.log10(torch.clamp_min(mel, cfg.amin)) - _log_ref(cfg)
    return out[:, None]


def _kernel():
    fn = load_library("logmel").log_mel
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(wave: torch.Tensor, cfg: LogMelConfig) -> torch.Tensor:
    """K2 on a CUDA ``wave``: checks, launches and counts; raises on what the
    kernel does not take or a failed launch."""
    if wave.dim() != 2:
        raise ValueError(f"log_mel: wave must be [B, T], got {tuple(wave.shape)}")
    n_fft = cfg.n_fft
    if n_fft & (n_fft - 1) or not 2 <= n_fft <= _MAX_NFFT:
        raise ValueError(f"log_mel: n_fft {n_fft} is not a power of two in [2, {_MAX_NFFT}]")
    B, T = wave.shape
    if T <= n_fft // 2:
        raise ValueError(f"log_mel: {T} samples cannot be reflect-padded by {n_fft // 2}")
    wave = wave.float().contiguous()
    consts = _constants(cfg, str(wave.device))
    Fr = num_frames(T, cfg)
    out = torch.empty((B, 1, Fr, cfg.n_mels), dtype=torch.float32, device=wave.device)
    stream = torch.cuda.current_stream(wave.device).cuda_stream
    rc = _kernel()(wave.data_ptr(), consts["win"].data_ptr(), consts["tw"].data_ptr(),
                   consts["mel_w"].data_ptr(), consts["lo"].data_ptr(), consts["hi"].data_ptr(),
                   out.data_ptr(), B, T, Fr, n_fft, cfg.hop_length, cfg.n_mels,
                   float(cfg.amin), float(_log_ref(cfg)), stream)
    if rc != 0:
        raise RuntimeError(f"log_mel: kernel launch failed (cudaError {rc})")
    log_mel.launches += 1
    return out


class _LogMel(torch.autograd.Function):
    """K2 forward; backward the VJP of ``log_mel_plain`` on the saved wave (the
    JAX ``log_mel_pallas`` custom_vjp's backward is that of ``log_mel_xla``)."""

    @staticmethod
    def forward(ctx, wave, cfg):
        ctx.save_for_backward(wave)
        ctx.cfg = cfg
        return _launch(wave, cfg)

    @staticmethod
    def backward(ctx, g):
        (wave,) = ctx.saved_tensors
        leaf = wave.detach().requires_grad_()
        with torch.enable_grad():
            out = log_mel_plain(leaf, ctx.cfg)
        return torch.autograd.grad(out, leaf, g)[0], None


def log_mel(wave: torch.Tensor, cfg: LogMelConfig) -> torch.Tensor:
    """K2: ``log_mel_plain`` for CPU tensors, the CUDA kernel for CUDA
    tensors (same arguments and result, differentiable in ``wave``)."""
    if wave.device.type == "cpu":
        return log_mel_plain(wave, cfg)
    if wave.device.type != "cuda":
        raise RuntimeError(f"log_mel: no kernel for device {wave.device}")
    return _LogMel.apply(wave, cfg)


log_mel.launches = 0
