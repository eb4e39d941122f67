"""The MFCC core (framing, DFT, mel, DCT and the power branch) against
a float64 NumPy oracle built on np.fft, for the magnitude/power and
log/root variants; on the CPU and, at 8 s of audio, on the card."""

import math

import numpy as np
import pytest

from aaltoasr_tpu.formats.feaconf import FeatureConfig
from aaltoasr_tpu.frontend.generator import FeatureGenerator
from aaltoasr_tpu.frontend.modules import mel_weight_matrix


def core_cfg(magnitude: int, root: int, power: bool) -> str:
    mods = [("audio", "audiofile", "", ["sample_rate 16000"]),
            ("fft", "fft", "audio", [f"magnitude {magnitude}"]),
            ("mel", "mel", "fft", [f"root {root}"]),
            ("dct", "dct", "mel", [])]
    if power:
        mods += [("power", "power", "fft", []),
                 ("out", "merge", "dct power", [])]
    text = ""
    for name, typ, src, extra in mods:
        lines = [f"  name {name}", f"  type {typ}"]
        if src:
            lines.append(f"  sources {src}")
        lines += [f"  {e}" for e in extra]
        text += "module\n{\n" + "\n".join(lines) + "\n}\n"
    return text


def oracle_core(samples, magnitude, root, power, W=256, adv=128,
                coef=0.97, n_cep=12):
    """[S] samples -> [T, 12 (+1)] in float64 (FeatureModules.cc:371-983:
    pre-emphasis, Hamming window, rFFT, mel triangles, cosine DCT)."""
    s = np.asarray(samples, np.float64)
    T = int((len(s) - W - 1) / adv) + 1
    idx = np.arange(T)[:, None] * adv + np.arange(W)[None, :]
    frames = s[idx + 1] - coef * s[idx]
    win = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(W) / (W - 1.0))
    spec = np.abs(np.fft.rfft(frames * win, axis=1)) ** 2
    if magnitude:
        spec = np.sqrt(spec)
    n_mel = int(23 * math.log10(1 + 16000 / 1400.0)
                / math.log10(1 + 16000 / 1400.0) - 2)
    mel = spec @ mel_weight_matrix(n_mel, 16000, W // 2 + 1).astype(
        np.float64)
    mel = mel ** 0.1 if root else np.log1p(mel)
    b = np.arange(n_mel)
    dct = np.cos(np.outer(b + 0.5, np.arange(1, n_cep + 1)) * np.pi / n_mel)
    out = mel @ dct
    if power:
        out = np.concatenate(
            [out, np.log(spec.sum(1, keepdims=True) + 1e-10)], axis=1)
    return out


def audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    sig = (3000 * np.sin(2 * np.pi * 440 * t)
           + 1500 * np.sin(2 * np.pi * 1330 * t)
           + 500 * rng.standard_normal(t.size))
    return np.round(sig).astype(np.float32)


def check_core(magnitude, root, power, seconds, seed):
    fg = FeatureGenerator(FeatureConfig.parse(
        core_cfg(magnitude, root, power)))
    x = audio(seconds, seed)
    got = np.asarray(fg.features(x), np.float64)
    want = oracle_core(x, magnitude, root, power)
    assert got.shape == want.shape
    # float32 through three matmuls: relative to each column's scale
    scale = np.abs(want).max(0)
    assert (np.abs(got - want).max(0) <= 1e-4 * scale + 1e-4).all()


@pytest.mark.parametrize("magnitude,root,power", [
    (1, 0, True), (1, 0, False), (0, 0, True), (1, 1, True),
    (0, 1, False)])
def test_mfcc_core_matches_float64_oracle(magnitude, root, power):
    check_core(magnitude, root, power, 0.5, magnitude + 2 * root)


@pytest.mark.gpu
@pytest.mark.parametrize("magnitude,root", [(1, 0), (0, 1)])
def test_mfcc_core_on_card(gpu, magnitude, root):
    """8 s at 16 kHz on the card; HIGHEST-precision matmuls keep the
    columns within 1e-4 of their scale (TF32 would miss by ~1e-3)."""
    check_core(magnitude, root, True, 8.0, 7)
