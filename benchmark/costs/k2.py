"""Kernel K2 (``ops/logmel.py``, the log-mel frontend): the least time of
one call. The wave read and the log-mel written once (bytes), against a
real FFT's 2.5 n log2 n operations a frame plus the power and the mel sums
(fp32 outside the tensor cores). The mel filterbank's non-zeros are counted
here, from a Slaney filterbank built in NumPy as librosa builds it."""

import math

import numpy as np

from benchmark.peaks import FP32_FLOPS, roofline_s


def _hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
                    freq / f_sp)


def _mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    f_sp * mels)


def mel_nonzeros(sr: int, n_fft: int, n_mels: int, f_min: float, f_max: float) -> int:
    """Non-zero weights of the Slaney triangular filterbank [n_fft/2+1, n_mels]."""
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return int((w.astype(np.float32) != 0).sum())


def bound(B: int, T: int, audio: dict) -> float:
    """Seconds of one call on B waves of T samples; ``audio`` holds sr,
    n_fft, hop_length, n_mels, f_min, f_max."""
    n, hop, n_mels = audio["n_fft"], audio["hop_length"], audio["n_mels"]
    F = T // hop + 1
    nbytes = 4 * B * T + 4 * B * F * n_mels
    nnz = mel_nonzeros(audio["sr"], n, n_mels, audio["f_min"], audio["f_max"])
    flops = B * F * (2.5 * n * math.log2(n) + 3 * (n // 2 + 1) + 2 * nnz)
    return roofline_s(flops, nbytes, FP32_FLOPS)
