"""Native runtime tests: bit-exact parity with the Python codecs."""

import wave

import numpy as np
import pytest

from aaltoasr_tpu import native
from aaltoasr_tpu.formats.lna import dequantize_lna, quantize_lna


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    return lib


class TestLnaCodec:
    def test_encode_bit_exact(self, lib):
        rng = np.random.default_rng(0)
        lp = -rng.uniform(0, 40, 10000).astype(np.float32)
        lp[::97] = -36.5  # below the floor
        lp[::101] = 0.0
        native_bytes = native.lna_encode_u16(lp)
        python_bytes = quantize_lna(lp, 2)
        assert native_bytes == python_bytes

    def test_decode_bit_exact(self, lib):
        rng = np.random.default_rng(1)
        payload = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        got = native.lna_decode_u16(payload)
        want = dequantize_lna(payload, 1, 2).reshape(-1)
        np.testing.assert_array_equal(got, want)

    def test_round_trip(self, lib):
        lp = np.linspace(-35.9, 0, 1000).astype(np.float32)
        dec = native.lna_decode_u16(native.lna_encode_u16(lp))
        assert np.abs(dec - lp).max() < 1.0 / 1820.0


class TestWav:
    def test_reads_wav_like_python(self, lib, tmp_path):
        rng = np.random.default_rng(2)
        sig = rng.integers(-30000, 30000, 5000).astype("<i2")
        p = tmp_path / "x.wav"
        with wave.open(str(p), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(sig.tobytes())
        samples, rate = native.wav_read(str(p))
        assert rate == 16000
        np.testing.assert_array_equal(samples, sig.astype(np.float32))

    def test_stereo_mixdown(self, lib, tmp_path):
        sig = np.array([[100, 200], [300, -100], [5, 5]], dtype="<i2")
        p = tmp_path / "s.wav"
        with wave.open(str(p), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(sig.tobytes())
        samples, rate = native.wav_read(str(p))
        assert rate == 8000
        np.testing.assert_allclose(samples, [150.0, 100.0, 5.0])


class TestBuild:
    def test_build_lands_by_rename(self, tmp_path, monkeypatch):
        """The library is built into a temporary name and renamed into
        place, so parallel workers never load a partial file."""
        import ctypes
        import shutil
        if shutil.which("g++") is None:
            pytest.skip("no C++ compiler")
        so = tmp_path / "libaaltoasr_native.so"
        monkeypatch.setattr(native, "_SO", str(so))
        assert native._build()
        assert so.exists()
        assert not list(tmp_path.glob("*.tmp"))
        assert ctypes.CDLL(str(so)).lna_encode_u16 is not None
