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
  kernel that ``logmel_plan`` names or raises. ``log_mel.launches`` counts
  launches, ``log_mel.fast_launches`` those of the frame-run kernel. On CUDA
  its gradient is the VJP of ``log_mel_plain`` (``_LogMel``), as the JAX
  ``log_mel_pallas``'s is that of ``log_mel_xla``.

K2 has two instantiations (``logmel_plan``, a rule on shapes):

- the frame-run kernel, for n_fft in 256..2048: a block loads the samples of
  a run of consecutive frames of one batch row once; a warp takes a frame,
  packs it as an n_fft/2-point complex FFT of (even, odd) samples in
  registers (Stockham passes of radix ``_radices(n_fft)``, exchanged through
  a per-warp shared tile), splits it into the real frame's bins 0..n_fft/2,
  and sums the mel bands over chunks of at most ``_CHUNK`` bins shared by the
  lanes;
- the first kernel (one block per frame, a radix-2 FFT in shared memory) for
  every other power of two up to 4096.

Both compute each frame's spectrum with an FFT (the TPU kernel's
DFT-as-two-matmuls served the MXU; on the card an FFT does ~100x fewer
operations for the same function), so K2 is held to ``log_mel_plain``'s
rFFT, not to the TPU kernel's ~0.2 dB MXU rounding. ``_tables`` builds the
kernels' tables in float64; ``_constants`` hands them to the card in fp32.
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
from zs_aac_tpu_torch.utils.profiling import annotate

__all__ = [
    "LogMelConfig",
    "mel_filterbank",
    "hann_window",
    "num_frames",
    "log_mel",
    "log_mel_plain",
    "logmel_plan",
    "LogMelPlan",
]

_AMIN = 1e-10
_MAX_NFFT = 4096     # the first kernel: n_fft * 8 bytes of shared memory, 32 KB
_FAST_NFFT = (256, 512, 1024, 2048)   # the frame-run kernel's instantiations
_FRAMES = 16         # frames per block of the frame-run kernel, at most
_WARPS = 8           # warps per block (kMaxWarps in csrc/logmel.cu)
_CHUNK = 9           # bins of a mel band one lane sums at a time (kChunk)
_SMEM_LIMIT = 232448  # dynamic shared memory a block may take on the H100


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


def _radices(n_fft: int) -> list:
    """The frame-run kernel's Stockham passes over the n_fft/2-point complex
    FFT, each a radix-r butterfly in a lane's registers (``passes<M, RL, NS>``
    in csrc/logmel.cu follows the same rule): r = min(n_fft/64, 16), the last
    pass the remainder. A lane holds n_fft/64 points."""
    m = n_fft // 2
    r = min(m // 32, 16)
    out, ns = [], 1
    while ns < m:
        out.append(min(r, m // ns))
        ns *= out[-1]
    return out


@functools.lru_cache(maxsize=8)
def _tables(cfg: LogMelConfig) -> dict:
    """K2's tables in float64 (the bins and offsets int32), before the cast
    to fp32 for the card:

    - ``win``: the periodic Hann window; ``mel_w``: the filterbank
      [n_fft/2+1, n_mels]; ``lo``, ``hi``: each band's range of non-zero bins;
      ``tw``: exp(-2 pi i k / n_fft), k < n_fft/2, as (re, im) rows (the first
      kernel's radix-2 twiddles);
    - the frame-run kernel's: ``fft_tw``, [M, 2], M = n_fft/2: the Stockham
      passes' twiddles, pass after pass from the second (span ns, radix r),
      exp(-2 pi i jm q / (ns r)) at row (q - 1) ns + jm for q in 1..r-1 and jm
      < ns, zeros after the last; ``split_tw``, exp(-2 pi i k / n_fft), k
      <= M/2, the split step's; ``chunks``, [n_chunks] (lo | len << 16): each
      band's bins [lo, hi) cut into runs of at most ``_CHUNK``, band after
      band; ``melw``, [_CHUNK, n_chunks], the weight of chunk c's bin lo + i
      at [i, c], zeros past its length; ``first``, [n_mels + 1], band m's
      chunks are first[m]..first[m+1]."""
    n = cfg.n_fft
    mel_w = mel_filterbank(cfg.sr, n, cfg.n_mels, cfg.f_min, cfg.f_max, dtype=np.float64)
    nz = mel_w != 0
    lo = np.where(nz.any(0), nz.argmax(0), 0).astype(np.int32)
    hi = np.where(nz.any(0), mel_w.shape[0] - nz[::-1].argmax(0), 0).astype(np.int32)
    cis = lambda k, period: np.stack([np.cos(2 * np.pi * k / period),
                                      -np.sin(2 * np.pi * k / period)], axis=-1)
    m = n // 2
    fft_tw, ns = [], _radices(n)[0]
    for r in _radices(n)[1:]:
        fft_tw.append(cis(np.outer(np.arange(1, r), np.arange(ns)).reshape(-1), ns * r))
        ns *= r
    fft_tw = np.concatenate(fft_tw + [np.zeros((m, 2))])[:m]
    chunks, weights, first = [], [], [0]
    for band in range(cfg.n_mels):
        for start in range(lo[band], hi[band], _CHUNK):
            length = min(_CHUNK, hi[band] - start)
            chunks.append(start | length << 16)
            weights.append(np.pad(mel_w[start:start + length, band], (0, _CHUNK - length)))
        first.append(len(chunks))
    return {"win": hann_window(n, np.float64), "mel_w": mel_w, "lo": lo, "hi": hi,
            "tw": cis(np.arange(n // 2), n),
            "fft_tw": fft_tw, "split_tw": cis(np.arange(m // 2 + 1), n),
            "melw": np.asarray(weights, np.float64).reshape(-1, _CHUNK).T.copy(),
            "chunks": np.asarray(chunks, np.int32),
            "first": np.asarray(first, np.int32)}


@functools.lru_cache(maxsize=8)
def _constants(cfg: LogMelConfig, device: str) -> dict:
    """``_tables`` on ``device``, the floats in fp32."""
    to = lambda a: torch.from_numpy(np.ascontiguousarray(
        a.astype(np.float32) if a.dtype == np.float64 else a)).to(device)
    return {k: to(v) for k, v in _tables(cfg).items()}


@dataclasses.dataclass(frozen=True)
class LogMelPlan:
    """How one K2 launch runs (``logmel_plan``).

    ``kernel``: ``"frames"`` (the frame-run kernel) or ``"radix2"`` (the first
    kernel, one block per frame); ``frames``: frames per block; ``warps``:
    warps per block; ``smem``: bytes of dynamic shared memory; ``vec``: floats
    per load of the wave, 4 (16 bytes, every block's span aligned) or 1."""

    kernel: str
    frames: int
    warps: int
    smem: int
    vec: int


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _frames_smem(cfg: LogMelConfig, frames: int, warps: int) -> int:
    """Shared bytes of a frame-run block (``Layout`` in csrc/logmel.cu lays
    them out the same way and refuses another total): the twiddles, the
    window, the packed filterbank, each warp's FFT tile (M + M/16 complex,
    one pad a 16) and the block's span of samples."""
    t = _tables(cfg)
    n, m = cfg.n_fft, cfg.n_fft // 2
    parts = [8 * m, 8 * (m // 2 + 1), 4 * n, 4 * t["melw"].size, 4 * len(t["chunks"]),
             4 * (cfg.n_mels + 1), warps * 8 * (m + m // 16),
             4 * ((frames - 1) * cfg.hop_length + n)]
    return sum(_align16(p) for p in parts)


@functools.lru_cache(maxsize=64)
def logmel_plan(cfg: LogMelConfig, B: int, T: int) -> LogMelPlan:
    """Which instantiation of ``csrc/logmel.cu`` K2 takes for ``B`` waves of
    ``T`` samples under ``cfg``.

    - n_fft in 256, 512, 1024, 2048 (and a filterbank whose chunk sums fit
      in a warp's tile beside the power): the frame-run kernel, ``_WARPS`` warps
      (one frame each at a time) over runs of up to ``_FRAMES`` frames (fewer
      where a row has fewer, halved while the shared memory would pass the
      card's 232,448 bytes); 16-byte loads of the wave where the row length,
      the hop and the padding are multiples of 4 samples.
    - any other power of two in [2, 4096]: the first kernel, a block of 256
      threads per frame, n_fft complex values of shared memory.

    Raises ``ValueError`` for an n_fft or a wave it does not take. A rule on
    shapes alone: a CUDA tensor launches what it names or raises."""
    n = cfg.n_fft
    if n & (n - 1) or not 2 <= n <= _MAX_NFFT:
        raise ValueError(f"log_mel: n_fft {n} is not a power of two in [2, {_MAX_NFFT}]")
    if T <= n // 2:
        raise ValueError(f"log_mel: {T} samples cannot be reflect-padded by {n // 2}")
    if B < 1 or B > 65535:
        raise ValueError(f"log_mel: batch {B} outside 1..65535")
    m = n // 2
    if n not in _FAST_NFFT or len(_tables(cfg)["chunks"]) > m + m // 8 - 1:
        return LogMelPlan("radix2", 1, 8, 8 * n, 1)
    frames = min(_FRAMES, num_frames(T, cfg))
    while _frames_smem(cfg, frames, _WARPS) > _SMEM_LIMIT and frames > 1:
        frames //= 2
    smem = _frames_smem(cfg, frames, _WARPS)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"log_mel: a hop of {cfg.hop_length} needs {smem} bytes of shared memory")
    vec = 4 if T % 4 == 0 and cfg.hop_length % 4 == 0 and m % 4 == 0 else 1
    return LogMelPlan("frames", frames, _WARPS, smem, vec)


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


def _kernels(lib):
    if lib.log_mel_frames.argtypes is None:
        lib.log_mel_frames.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.log_mel_frames.restype = ctypes.c_int
        lib.log_mel_radix2.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.log_mel_radix2.restype = ctypes.c_int
    return lib


def _launch(wave: torch.Tensor, cfg: LogMelConfig, plan: LogMelPlan = None) -> torch.Tensor:
    """K2 on a CUDA ``wave``: checks, launches ``plan`` (``logmel_plan``'s by
    default) and counts; raises on what the kernel does not take or a failed
    launch."""
    if wave.dim() != 2:
        raise ValueError(f"log_mel: wave must be [B, T], got {tuple(wave.shape)}")
    B, T = wave.shape
    plan = plan or logmel_plan(cfg, B, T)
    wave = wave.float().contiguous()
    if plan.vec == 4 and wave.data_ptr() % 16:   # a view that starts off 16 bytes
        wave = wave.clone()
    c = _constants(cfg, str(wave.device))
    Fr = num_frames(T, cfg)
    out = torch.empty((B, 1, Fr, cfg.n_mels), dtype=torch.float32, device=wave.device)
    stream = torch.cuda.current_stream(wave.device).cuda_stream
    lib = _kernels(load_library("logmel"))
    scalars = (float(cfg.amin), float(_log_ref(cfg)), stream)
    if plan.kernel == "frames":
        rc = lib.log_mel_frames(
            wave.data_ptr(), c["win"].data_ptr(), c["fft_tw"].data_ptr(),
            c["split_tw"].data_ptr(), c["melw"].data_ptr(), c["chunks"].data_ptr(),
            c["first"].data_ptr(), out.data_ptr(), B, T, Fr, cfg.n_fft, cfg.hop_length,
            cfg.n_mels, len(c["chunks"]), plan.frames, plan.warps, plan.vec,
            plan.smem, *scalars)
    else:
        rc = lib.log_mel_radix2(
            wave.data_ptr(), c["win"].data_ptr(), c["tw"].data_ptr(), c["mel_w"].data_ptr(),
            c["lo"].data_ptr(), c["hi"].data_ptr(), out.data_ptr(), B, T, Fr, cfg.n_fft,
            cfg.hop_length, cfg.n_mels, *scalars)
    if rc != 0:
        raise RuntimeError(f"log_mel: kernel launch failed (cudaError {rc})")
    log_mel.launches += 1
    log_mel.fast_launches += plan.kernel == "frames"
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
    tensors (same arguments and result, differentiable in ``wave``). Span
    ``encode.frontend``."""
    if wave.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"log_mel: no kernel for device {wave.device}")
    with annotate("encode.frontend"):
        if wave.device.type == "cpu":
            return log_mel_plain(wave, cfg)
        return _LogMel.apply(wave, cfg)


log_mel.launches = 0
log_mel.fast_launches = 0
