"""VTLN warp-factor estimation by ML grid search (`aku/vtln.cc`).

For each speaker, evaluate the forced-alignment likelihood of their data
under a grid of warp factors (default radius 0.1, 21 points around the
current warp, vtln.cc:173-221) and keep the argmax.  The device twist: all
grid points evaluate in one batched device call — the warp enters the
feature pipeline as a runtime parameter (a [F, F] interpolation matrix),
so candidate warps become a vmapped parameter axis over the SAME compiled
program, no recompilation per warp.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from aaltoasr_tpu.formats.feaconf import ModuleConfig
from aaltoasr_tpu.models.hmm import build_chain, pad_chain
from aaltoasr_tpu.train import estep


def warp_grid(center: float = 1.0, radius: float = 0.1,
              size: int = 21) -> np.ndarray:
    """center - radius .. center + radius inclusive (vtln.cc:72-73)."""
    if size <= 1:
        return np.asarray([center])
    return center - radius + np.arange(size) * (2 * radius / (size - 1))


class VtlnEstimator:
    """Grid-search warp estimation over a speaker's utterances."""

    def __init__(self, model, table, scorer, fg, vtln_module: str,
                 radius: float = 0.1, size: int = 21):
        self.model = model
        self.table = table
        self.scorer = scorer
        self.fg = fg
        self.vtln_module = vtln_module
        self.radius = radius
        self.size = size
        self._ll_fn_cache = {}

    def _warp_params(self, warps) -> list:
        """One frontend params pytree per candidate warp."""
        out = []
        for w in warps:
            cfg = ModuleConfig()
            cfg.set("warp_factor", float(w))
            params = {k: dict(v) for k, v in self.fg.params.items()}
            params[self.vtln_module] = \
                self.fg.ops[self.vtln_module].set_parameters(cfg)
            out.append(params)
        return out

    def utterance_lls(self, samples, labels, warps) -> np.ndarray:
        """Total data log-likelihood per candidate warp for one utterance."""
        chain = build_chain(self.model, self.table, labels)
        graph = {k: jnp.asarray(v) for k, v in
                 pad_chain(chain, chain.num_positions).items()}
        param_list = self._warp_params(warps)
        stacked = jax.tree.map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
            *param_list)
        samples = jnp.asarray(samples)
        S = int(samples.shape[0])
        T = self.fg.num_frames(S)
        feat_fn = self.fg._compiled(S)
        scorer = self.scorer
        nslots = self.table.num_slots

        key = (S, chain.num_positions)
        if key not in self._ll_fn_cache:
            def one(params, samples, graph):
                feats = feat_fn(samples, jnp.int32(T), params)
                st = estep.chain_stats(scorer, feats, graph,
                                       jnp.int32(T), nslots)
                return st["log_likelihood"]
            self._ll_fn_cache[key] = jax.jit(
                jax.vmap(one, in_axes=(0, None, None)))
        return np.asarray(
            self._ll_fn_cache[key](stacked, samples, graph))

    def utterance_lls_aligned(self, samples, frame_states,
                              warps) -> np.ndarray:
        """Fixed-segmentation likelihood per warp (the reference's -O
        path: PhnReader over an existing alignment as Segmentator,
        `vtln.cc:88-117` compute_vtln_log_likelihoods with per-frame
        probability 1): sum_t max(ln pdf_ll(state_t), ln 1e-50)."""
        param_list = self._warp_params(warps)
        stacked = jax.tree.map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
            *param_list)
        samples = jnp.asarray(samples)
        S = int(samples.shape[0])
        T = min(self.fg.num_frames(S), len(frame_states))
        states = jnp.asarray(
            np.asarray(frame_states[:T], np.int32))
        feat_fn = self.fg._compiled(S)
        scorer = self.scorer
        floor = float(np.log(1e-50))

        key = ("aligned", S, T)
        if key not in self._ll_fn_cache:
            def one(params, samples, states):
                feats = feat_fn(samples, jnp.int32(T), params)
                ll = scorer.state_log_likelihoods(feats)[:T]
                per = jnp.take_along_axis(
                    ll, states[:, None], axis=1)[:, 0]
                return jnp.sum(jnp.maximum(per, floor))
            self._ll_fn_cache[key] = jax.jit(
                jax.vmap(one, in_axes=(0, None, None)))
        return np.asarray(
            self._ll_fn_cache[key](stacked, samples, states))

    def estimate_speaker(self, utterances, center: float = 1.0,
                         aligned: bool = False):
        """utterances: list of (samples, labels) — or, with
        aligned=True, (samples, frame_state_indices) — returns
        (best_warp, per-warp total lls, warps)."""
        warps = warp_grid(center, self.radius, self.size)
        total = np.zeros(len(warps))
        for samples, labels in utterances:
            if aligned:
                total += self.utterance_lls_aligned(samples, labels,
                                                    warps)
            else:
                total += self.utterance_lls(samples, labels, warps)
        best = warps[int(np.argmax(total))]
        return float(best), total, warps


def alignment_frame_states(model, entries, samples_per_frame=128):
    """Expand a state-segmented alignment (.phn with 'label.N' lines
    and sample-number times, the `align` output convention) into a
    per-frame model-state index array (PhnReader frame mapping:
    frame = sample / (sample_rate/frame_rate))."""
    phone_states = {p.label: p.states for p in model.phones}
    end_frame = int(entries[-1].end) // samples_per_frame
    out = np.zeros(end_frame, np.int32)
    for e in entries:
        s = int(e.start) // samples_per_frame
        t = int(e.end) // samples_per_frame
        st = e.state if e.state >= 0 else 0
        out[s:t] = phone_states[e.label][st]
    return out
