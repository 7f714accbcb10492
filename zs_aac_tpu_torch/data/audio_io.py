"""Audio file loading and resampling (a copy of the JAX package's
``data/audio_io.py``; the reference loads audio with
``librosa.load(sr=32000, mono=True)``, and librosa is not a dependency):

- a pure-Python/numpy WAV reader (PCM 8/16/24/32, float32/64);
- an optional native C++ decoder (``zs_aac_tpu_torch/native/audioio.cpp``,
  built by ``native/build.sh`` at first use and loaded with ctypes) for
  decode + resample on the host. It is host-side WAV decoding, not a device
  kernel; without a C++ compiler the pure-Python path below is used;
- polyphase resampling (``scipy.signal.resample_poly``, the method librosa
  uses for ``res_type='polyphase'``);
- pad/truncate and random-crop helpers with the reference's length logic.
"""

from __future__ import annotations

import math
import os
import wave
from typing import Optional, Tuple

import numpy as np

__all__ = ["load_wav", "resample", "load_audio", "load_audio_raw", "pad_or_truncate", "random_crop"]

_NATIVE = None
_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "native", "libaudioio.so")


def _native_lib():
    """The optional C++ decoder, or None where it cannot be built or loaded."""
    global _NATIVE
    if _NATIVE is None:
        _NATIVE = _load_native(_LIB_PATH) or False
    return _NATIVE or None


def _load_native(path: str):
    """Build the library at ``path`` if it is missing (the .so is
    gitignored; ``native/build.sh`` compiles to a temporary name and renames
    it into place, so a concurrent reader never sees half a file), then load
    it. A failed build or load is reported on stderr and gives None: the
    pure-Python decoder is used instead."""
    import ctypes
    import subprocess
    import sys

    if not os.path.exists(path):
        build = os.path.join(os.path.dirname(path), "build.sh")
        try:
            out = subprocess.run(["sh", build], capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"audio_io: cannot build the native decoder ({e}); "
                  "using the Python decoder", file=sys.stderr)
            return None
        if out.returncode != 0:
            print(f"audio_io: native decoder build failed (exit {out.returncode}); using "
                  f"the Python decoder\n{out.stdout}{out.stderr}", file=sys.stderr)
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        print(f"audio_io: cannot load {path} ({e}); using the Python decoder",
              file=sys.stderr)
        return None
    lib.decode_wav_resample.restype = ctypes.c_long
    lib.decode_wav_resample.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
    ]
    return lib


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # could be PCM32 or float32; wave module exposes PCM only
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / 8388608.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(sr, target_sr)
    return resample_poly(x, target_sr // g, sr // g).astype(np.float32)


def load_audio(path: str, target_sr: int = 32000, mono: bool = True) -> np.ndarray:
    """librosa.load-equivalent entry point. Prefers the native decoder."""
    lib = _native_lib()
    if lib is not None and path.lower().endswith(".wav"):
        import ctypes

        cap = 32 * target_sr * 60  # up to 60 minutes
        buf = np.empty(cap, np.float32)
        n = lib.decode_wav_resample(
            path.encode(), target_sr,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
        )
        if n > 0:
            return buf[:n].copy()
        # fall through to the Python path on decode failure
    x, sr = load_wav(path)
    return resample(x, sr, target_sr)


def pad_or_truncate(x: np.ndarray, n_samples: int) -> np.ndarray:
    """Zero-pad or head-truncate to exactly n_samples
    (the reference's embeddings_generator.py)."""
    if len(x) >= n_samples:
        return x[:n_samples]
    return np.concatenate([x, np.zeros(n_samples - len(x), x.dtype)])


def random_crop(x: np.ndarray, n_samples: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random-crop to n_samples, pad if shorter (the reference's pretrain_dataset.py)."""
    if len(x) <= n_samples:
        return pad_or_truncate(x, n_samples)
    rng = rng or np.random.default_rng()
    start = int(rng.integers(0, len(x) - n_samples + 1))
    return x[start : start + n_samples]


def load_audio_raw(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """Decode a WAV to int16 PCM at its NATIVE rate -> (pcm [n] i16, sr),
    or None when the device-resample fast path shouldn't be used (non-WAV,
    or 24/32-bit where int16 shipping would lose precision).

    The embedding pipeline ships this straight to the device and resamples
    there (``ops/resample.py``): 16-bit mono sources ship losslessly at
    half-to-quarter the bytes of the resampled fp32 wave. Stereo is mixed
    to mono in float then rounded (<=0.5 LSB vs the float path).
    """
    if not path.lower().endswith(".wav"):
        return None
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(n)
    except (wave.Error, OSError, EOFError):
        return None
    if width == 2:
        x = np.frombuffer(raw, "<i2")
        if ch > 1:
            x = np.round(
                x.reshape(-1, ch).mean(axis=1, dtype=np.float64)
            ).astype(np.int16)
        return x, sr
    if width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.int16) - 128) << 8
        if ch > 1:
            x = np.round(
                x.reshape(-1, ch).mean(axis=1, dtype=np.float64)
            ).astype(np.int16)
        return x, sr
    return None  # 24/32-bit: keep the full-precision host path
