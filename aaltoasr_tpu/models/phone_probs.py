"""Audio -> features -> GMM state log-probs -> LNA: the scoring pipeline.

Equivalent of the reference's PPToolbox (`aku/PhoneProbsToolbox.{hh,cc}`,
SWIG-exported via `aku/swig/PPToolbox.i`) and the phone_probs CLI driver
(`aku/phone_probs.cc`).  The whole per-utterance compute path — framing,
spectrum, mel, cepstra, deltas, Gaussian pool matmul, mixture logsumexp,
frame normalization, 2-byte quantization — runs as one jitted device
program; the host only reads audio and writes the LNA payload.
"""

from __future__ import annotations

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from aaltoasr_tpu.formats.feaconf import FeatureConfig
from aaltoasr_tpu.formats.lna import write_lna
from aaltoasr_tpu.formats.model_io import HmmModel, read_model
from aaltoasr_tpu.formats.recipe import Recipe
from aaltoasr_tpu.formats.spkc import SpeakerConfig
from aaltoasr_tpu.frontend.audio import read_audio
from aaltoasr_tpu.frontend.generator import FeatureGenerator
from aaltoasr_tpu.ops.gmm import GmmScorer, quantize_lna_u16


class PhoneProbs:
    """Feature + GMM scoring pipeline for LNA generation."""

    def __init__(self, model: HmmModel | str, config: FeatureConfig | str,
                 lna_bytes: int = 2, normalize: bool = True):
        if isinstance(model, str):
            model = read_model(model)
        self.model = model
        self.fg = FeatureGenerator(config)
        self.scorer = GmmScorer.from_model(model)
        if model.dim != self.fg.dim:
            raise ValueError(
                f"Gaussian dimension is {model.dim} but feature dimension "
                f"is {self.fg.dim}.")
        if lna_bytes not in (2, 4):
            raise ValueError("Invalid number of LNA bytes")
        self.lna_bytes = lna_bytes
        self.normalize = normalize
        self.speaker_config: SpeakerConfig | None = None

    # -- speaker adaptation ----------------------------------------------
    def read_clustering(self, path, eval_minc: float = 0.0,
                        eval_ming: float = 0.1) -> None:
        """Gaussian clustering for gated evaluation (phone_probs -C,
        `aku/phone_probs.cc:112-117`)."""
        from aaltoasr_tpu.train.gcluster import read_gcl
        assign, C = read_gcl(path)
        self.scorer = self.scorer.with_clustering(
            self.model, assign, C, eval_minc, eval_ming)
        type(self)._program.cache_clear()   # programs close over scorer

    def read_speaker_config(self, path) -> None:
        self.speaker_config = SpeakerConfig.load(path)

    def set_speaker(self, speaker_id: str) -> None:
        if self.speaker_config is None or not speaker_id:
            return
        params = self.speaker_config.speaker_params(speaker_id)
        self.fg.apply_speaker_config(params)
        self._apply_model_transforms(params)

    def _apply_model_transforms(self, params: dict) -> None:
        """Model-namespace CMLLR blocks: rebuild the scorer with the
        per-class transforms folded into (full-covariance) Gaussians
        (ModelModules ConstrainedMllr; SpeakerConfig model namespace)."""
        import numpy as np
        from aaltoasr_tpu.ops.gmm import GmmScorer
        from aaltoasr_tpu.train.mllr import apply_model_cmllr
        blocks = [cfg for (ns, _name), cfg in params.items()
                  if ns == "model" and cfg.exists("classes")]
        if not blocks:
            return
        cfg = blocks[0]
        C = cfg.get_int("classes")
        D = self.model.dim
        Ws = []
        for c in range(C):
            A = np.asarray(cfg.get_float_vec(f"matrix{c}")
                           ).reshape(D, D)
            b = np.asarray(cfg.get_float_vec(f"bias{c}"))
            Ws.append(np.concatenate([b[:, None], A], axis=1))
        cls = np.asarray(cfg.get_float_vec("gauss_class"),
                         dtype=np.int64)
        adapted = apply_model_cmllr(self.model, Ws, cls)
        self.scorer = GmmScorer.from_model(adapted)
        type(self)._program.cache_clear()

    def set_utterance(self, utterance_id: str) -> None:
        if self.speaker_config is None or not utterance_id:
            return
        self.fg.apply_speaker_config(
            self.speaker_config.utterance_params(utterance_id))

    # -- device program ---------------------------------------------------
    @functools.lru_cache(maxsize=None)
    def _program(self, padded_len: int, quantize: bool):
        feature_fn = self.fg._compiled(padded_len)
        scorer = self.scorer
        normalize = self.normalize

        def fn(samples, n_frames, params):
            feats = feature_fn(samples, n_frames, params)
            if normalize:
                lp = scorer.lna_log_probs(feats)
            else:
                lp = scorer.state_log_likelihoods(feats)[:, :scorer.num_states]
            if quantize:
                return quantize_lna_u16(lp)
            return lp

        return jax.jit(fn)

    @functools.lru_cache(maxsize=None)
    def _raw_program(self, padded_len: int):
        """Unnormalized state log-likelihoods (normalization epilogue
        runs on host, see log_probs)."""
        feature_fn = self.fg._compiled(padded_len)
        scorer = self.scorer

        def fn(samples, n_frames, params):
            feats = feature_fn(samples, n_frames, params)
            return scorer.state_log_likelihoods(feats)[:, :scorer.num_states]

        return jax.jit(fn)

    @staticmethod
    def _reference_normalize(ll: np.ndarray) -> np.ndarray:
        """Bit-faithful reproduction of the reference normalization
        (`aku/phone_probs.cc:30,225-234`, `aku/HmmSet.cc:476-498`,
        `aku/util.hh:132-137`): LINEAR per-state likelihoods floored at
        1e-50 and stored as float32 (so anything below float32
        subnormal range becomes 0.0f), summed in double, then
        safe_log(p/Z) with the same 1e-50 floor.  This only differs
        from plain logsumexp normalization below ~-87 log-prob — far
        under any pruning beam — but it is what the 4-byte LNA artifact
        contains, so the serve-chain byte contract follows it."""
        p32 = np.maximum(np.exp(ll.astype(np.float64)),
                         1e-50).astype(np.float32)
        Z = p32.astype(np.float64).sum(axis=1, keepdims=True)
        Z[Z == 0.0] = 1.0
        ratio = p32.astype(np.float64) / Z
        return np.log(np.maximum(ratio, 1e-50)).astype(np.float32)

    def log_probs(self, samples: np.ndarray) -> np.ndarray:
        """[S] samples -> [T, num_states] LNA-normalized log-probs."""
        samples = jnp.asarray(samples)
        T = self.fg.num_frames(samples.shape[0])
        if self.normalize:
            fn = self._raw_program(int(samples.shape[0]))
            ll = np.asarray(fn(samples, jnp.int32(T), self.fg.params))[:T]
            return self._reference_normalize(ll)
        fn = self._program(int(samples.shape[0]), False)
        return np.asarray(fn(samples, jnp.int32(T), self.fg.params))[:T]

    # -- LNA emission -----------------------------------------------------
    def generate_to_file(self, audio_path: str, out_path: str) -> int:
        """One utterance -> LNA file; returns the frame count."""
        samples, rate = read_audio(audio_path, self.fg.sample_rate)
        samples = jnp.asarray(samples)
        T = self.fg.num_frames(samples.shape[0])
        if self.lna_bytes == 2 and self.normalize:
            fn = self._program(int(samples.shape[0]), True)
            codes = np.asarray(
                fn(samples, jnp.int32(T), self.fg.params))[:T]
            header = (int(self.scorer.num_states).to_bytes(4, "big")
                      + bytes([2]))
            with open(out_path, "wb") as f:
                f.write(header + codes.astype(">u2").tobytes())
        else:
            lp = self.log_probs(samples)
            write_lna(out_path, lp, self.lna_bytes)
        return T

    def generate_recipe(self, recipe: Recipe, out_dir: str = "",
                        use_audio_fname: bool = False,
                        no_overwrite: bool = False,
                        info: int = 0) -> None:
        """Process a recipe shard like the phone_probs main loop
        (`aku/phone_probs.cc:120-200`)."""
        for rinfo in recipe:
            if use_audio_fname or not rinfo.lna_path:
                out_file = os.path.basename(rinfo.audio_path) + ".lna"
            else:
                out_file = rinfo.lna_path
            if out_dir:
                out_file = os.path.join(out_dir, os.path.basename(out_file))
            if no_overwrite and os.path.exists(out_file):
                continue
            self.set_speaker(rinfo.speaker_id)
            self.set_utterance(rinfo.utterance_id)
            if info > 0:
                print(f"Processing file: {rinfo.audio_path}", file=sys.stderr)
            self.generate_to_file(rinfo.audio_path, out_file)
