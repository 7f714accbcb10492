"""The port's audio loader falls back to the pure-Python decoder when the
native library cannot be built or loaded (a half-written ``.so`` from a
concurrent build, a failing compiler), and says so on stderr."""

import wave

import numpy as np
import pytest

from zs_aac_tpu_torch.data import audio_io


def _write_wav(path, sr=44100, n=4410):
    x = (np.sin(np.arange(n) * 0.05) * 12000).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.tobytes())


@pytest.fixture
def wav(tmp_path):
    path = tmp_path / "tone.wav"
    _write_wav(path)
    return str(path)


def _python_decoder(path):
    x, sr = audio_io.load_wav(path)
    return audio_io.resample(x, sr, 32000)


def test_truncated_library_falls_back_to_the_python_decoder(wav, tmp_path, monkeypatch, capsys):
    lib = tmp_path / "libaudioio.so"
    lib.write_bytes(b"\x7fELF\x02\x01\x01" + bytes(57))      # an ELF header cut short
    monkeypatch.setattr(audio_io, "_LIB_PATH", str(lib))
    monkeypatch.setattr(audio_io, "_NATIVE", None)
    got = audio_io.load_audio(wav)
    np.testing.assert_array_equal(got, _python_decoder(wav))
    assert audio_io._native_lib() is None
    assert "cannot load" in capsys.readouterr().err


def test_failed_build_falls_back_and_is_reported(wav, tmp_path, monkeypatch, capsys):
    (tmp_path / "build.sh").write_text("echo 'audioio.cpp: error' >&2\nexit 3\n")
    monkeypatch.setattr(audio_io, "_LIB_PATH", str(tmp_path / "libaudioio.so"))
    monkeypatch.setattr(audio_io, "_NATIVE", None)
    got = audio_io.load_audio(wav)
    np.testing.assert_array_equal(got, _python_decoder(wav))
    err = capsys.readouterr().err
    assert "build failed (exit 3)" in err and "audioio.cpp: error" in err
    assert not (tmp_path / "libaudioio.so").exists()
