"""Host-side E-step driver: recipes -> padded batches -> device stats.

The `stats` worker equivalent (`aku/stats.cc:309-470`): iterates a recipe
shard, builds each utterance's numerator chain, pads into shape buckets,
runs the jitted batch E-step, and reduces into reference-format
accumulators.  Sharding uses the same `-B/-I` recipe split; on-mesh
reduction replaces file-based combine_stats when multiple devices are
visible (see parallel.mesh).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from aaltoasr_tpu.formats.model_io import HmmModel
from aaltoasr_tpu.formats.phn import read_phn
from aaltoasr_tpu.formats.recipe import Recipe
from aaltoasr_tpu.frontend.audio import read_audio
from aaltoasr_tpu.frontend.generator import FeatureGenerator
from aaltoasr_tpu.models.hmm import (
    TransitionTable, build_chain, pad_chain)
from aaltoasr_tpu.ops.gmm import GmmScorer
from aaltoasr_tpu.train import estep
from aaltoasr_tpu.train.accumulators import (
    HmmStats, ML_BUF, PDF_ML_FULL_STATS, PDF_ML_STATS)


def device_stats_to_hmm_stats(model: HmmModel, table: TransitionTable,
                              dstats, mode: int = PDF_ML_STATS,
                              buffer_id: int = ML_BUF,
                              stats: HmmStats | None = None) -> HmmStats:
    """Convert a device E-step pytree into host HmmStats.

    ``buffer_id`` selects the accumulator (ML/MMI/MPE buffers); pass an
    existing ``stats`` to fill a second buffer of the same object."""
    if stats is None:
        stats = HmmStats.zeros(model, table, mode)
    buf = stats.buffers[buffer_id]
    G = model.num_gaussians
    S = model.num_states
    buf.gamma[:] = np.asarray(dstats["gamma"], dtype=np.float64)[:G]
    # aux gamma = sum of |component gamma| (Mixture::accumulate,
    # Distributions.cc:2157); our per-frame gammas are non-negative per
    # buffer, so the sum of absolutes equals the sum
    buf.aux_gamma[:] = np.abs(buf.gamma)
    buf.mean_acc[:] = np.asarray(dstats["mean_acc"], dtype=np.float64)[:G]
    buf.sec_acc[:] = np.asarray(dstats["sec_acc"], dtype=np.float64)[:G]
    buf.feacount[:] = np.asarray(dstats["feacount"], dtype=np.int64)[:G]
    if "sec_acc_full" in dstats:
        buf.ensure_full()
        buf.full_acc[:] = np.asarray(dstats["sec_acc_full"],
                                     dtype=np.float64)[:G]
    mix = np.asarray(dstats["mix_gamma"], dtype=np.float64)[:S]
    K = buf.mix_gamma.shape[1]
    buf.mix_gamma[:, :] = mix[:, :K]
    if "mix_ll" in dstats:
        buf.mix_ll[:] = np.asarray(dstats["mix_ll"],
                                   dtype=np.float64)[:S]
    if buffer_id == ML_BUF:
        stats.trans_acc[:] = np.asarray(dstats["trans_acc"],
                                        dtype=np.float64)
        stats.num_ll = float(dstats["log_likelihood"])
        stats.num_frames = int(dstats["num_frames"])
    else:
        stats.den_ll = float(dstats["log_likelihood"])
    return stats


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class EStepDriver:
    """Recipe -> statistics, with shape bucketing for jit reuse."""

    def __init__(self, model: HmmModel, feature_config,
                 mode: str = "bw", time_bucket: int = 256,
                 pos_bucket: int = 64, full_stats: bool = False):
        self.model = model
        self.table = TransitionTable.from_model(model)
        self.fg = FeatureGenerator(feature_config)
        self.scorer = GmmScorer.from_model(model)
        self.mode = mode
        self._phone_id = {p.label: i
                          for i, p in enumerate(model.phones)}
        self._membership = None
        self._center_class = None
        self._n_center = 0
        self.full_stats = full_stats
        self.time_bucket = time_bucket
        self.pos_bucket = pos_bucket
        self._jit_cache = {}
        self.failed_utterances: list = []

    def _stats_fn(self, T_pad: int, P_pad: int, F: int,
                  arc_feacount: bool = False):
        key = (T_pad, P_pad, F, arc_feacount)
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(
                lambda f, g, n: estep.chain_stats(
                    self.scorer, f, g, n, self.table.num_slots,
                    self.mode, full_stats=self.full_stats,
                    arc_feacount=arc_feacount))
        return self._jit_cache[key]

    def _padded_features(self, samples):
        feats = self.fg.features(samples)
        T = feats.shape[0]
        T_pad = _round_up(T, self.time_bucket)
        if T_pad > T:
            feats = jnp.concatenate(
                [feats, jnp.zeros((T_pad - T, feats.shape[1]),
                                  feats.dtype)], axis=0)
        return feats, T

    def _graph_from_chain(self, labels):
        chain = build_chain(self.model, self.table, labels)
        P_pad = _round_up(chain.num_positions, self.pos_bucket)
        out = {k: jnp.asarray(v) for k, v in estep.shift_compile(
            pad_chain(chain, P_pad, fan=4)).items()}
        phone = np.zeros(P_pad, dtype=np.int32)
        lbl_ids = [self._phone_id.get(l, 0) for l in labels]
        phone[:chain.num_positions] = np.asarray(
            lbl_ids, np.int32)[chain.phone_index]
        out["phone"] = jnp.asarray(phone)
        return out

    def _graph_from_fst(self, fst, with_meta: bool = False):
        from aaltoasr_tpu.models.hmmnet import compile_hmmnet, pad_hmmnet
        g, emit = compile_hmmnet(fst, self.table)
        P = int(g["num_positions"])
        P_pad = _round_up(max(P, 1), self.pos_bucket)
        F = max(g["in_src"].shape[1], 4)
        padded = estep.shift_compile(pad_hmmnet(g, P_pad, fan=F))
        labels = [fst.arcs[ai].label for ai in emit] + [""] * (P_pad - P)
        # model phone index per position (for the mpfe-cps/mpfe modes)
        phone = np.zeros(P_pad, dtype=np.int32)
        for p, lbl in enumerate(labels):
            phone[p] = self._phone_id.get(lbl, 0)
        out = {k: jnp.asarray(v) for k, v in padded.items()}
        out["phone"] = jnp.asarray(phone)
        if with_meta:
            return out, labels
        return out

    def _mpe_stats_for(self, feats, T, num_graph, num_fst, den_fst,
                       errmode: str, max_seg_dur: int):
        """Dispatch the --mpe error mode (stats.cc:676-721): frame modes
        run fully on device; segment modes build the per-utterance
        accuracy table on host from the numerator Viterbi alignment."""
        from aaltoasr_tpu.ops.logsemiring import logsumexp
        from aaltoasr_tpu.train import mpe as mpe_mod
        den_graph = self._graph_from_fst(den_fst)
        if errmode in ("mpfe-pdf", "mpfe-cps", "mpfe"):
            if self._membership is None:
                self._membership = jnp.asarray(
                    mpe_mod.phone_membership(self.model))
            return mpe_mod.mpe_stats(
                self.scorer, feats, num_graph, den_graph, jnp.int32(T),
                self.table.num_slots, mode=errmode,
                membership=self._membership)

        # segment modes: mpe / mwe / snfe
        if errmode == "mwe":
            if (num_fst is None or not num_fst.word_names
                    or not den_fst.word_names):
                raise ValueError(
                    "--errmode mwe needs word-level hmmnets (numerator "
                    "and denominator built from word graphs)")
            names = sorted(set(num_fst.word_names)
                           | set(den_fst.word_names))
            cid = {w: i for i, w in enumerate(names)}
            num_wi = np.asarray(num_graph["word_inst"])
            den_wi = np.asarray(den_graph["word_inst"])
            num_cls = np.asarray(
                [cid[num_fst.word_names[i]] if i >= 0 else 0
                 for i in num_wi], np.int32)
            den_cls = np.asarray(
                [cid[den_fst.word_names[i]] if i >= 0 else 0
                 for i in den_wi], np.int32)
            num_inst = np.where(num_wi >= 0, num_wi,
                                num_wi.shape[0] + np.arange(len(num_wi)))
            den_inst = np.where(den_wi >= 0, den_wi,
                                den_wi.shape[0] + np.arange(len(den_wi)))
            num_graph = dict(num_graph)
            num_graph["inst"] = jnp.asarray(num_inst.astype(np.int32))
            den_graph = dict(den_graph)
            den_graph["inst"] = jnp.asarray(den_inst.astype(np.int32))
            n_classes = len(names)
        else:
            # phone classes: distinct center phones of the model
            if self._center_class is None:
                centers = sorted({mpe_mod.extract_center_phone(p.label)
                                  for p in self.model.phones})
                cidx = {c: i for i, c in enumerate(centers)}
                self._center_class = np.asarray(
                    [cidx[mpe_mod.extract_center_phone(p.label)]
                     for p in self.model.phones], np.int32)
                self._n_center = len(centers)
            num_cls = self._center_class[np.asarray(num_graph["phone"])]
            den_cls = self._center_class[np.asarray(den_graph["phone"])]
            n_classes = self._n_center

        # numerator Viterbi alignment -> reference segments
        gll = self.scorer.gaussian_log_likelihoods(feats)
        sll = logsumexp(gll[:, self.scorer.comp_idx]
                        + self.scorer.comp_logw, axis=-1)
        num_obs = sll[:, num_graph["pdf"]]
        if "obs_const" in num_graph:
            num_obs = num_obs + num_graph["obs_const"][None, :]
        path, _ = estep.masked_viterbi(num_obs, num_graph,
                                       jnp.int32(T))
        ref_segs = mpe_mod.ref_segments_from_path(
            np.asarray(path), np.asarray(num_graph["inst"]), num_cls, T)
        acc = mpe_mod.segment_accuracy_table(
            errmode, ref_segs, T, max_seg_dur, n_classes,
            pad_frames=int(feats.shape[0]))
        return mpe_mod.mpe_stats_seg(
            self.scorer, feats, num_graph, den_graph, jnp.int32(T),
            self.table.num_slots, jnp.asarray(acc),
            jnp.asarray(den_cls), max_seg_dur)

    def _run_graph(self, feats, T, graph, arc_feacount: bool = False):
        F = graph["in_src"].shape[1]
        fn = self._stats_fn(int(feats.shape[0]),
                            int(graph["pdf"].shape[0]), F,
                            arc_feacount=arc_feacount)
        return fn(feats, graph, jnp.int32(T))

    def utterance_stats(self, samples: np.ndarray, labels: list):
        """One utterance's device stats pytree (transcript chain)."""
        feats, T = self._padded_features(samples)
        return self._run_graph(feats, T, self._graph_from_chain(labels))

    def _batched_fn(self, T_pad, P_pad, F, B):
        key = ("batch", T_pad, P_pad, F, B)
        if key not in self._jit_cache:
            per_utt = jax.vmap(
                lambda f, g, n: estep.chain_stats(
                    self.scorer, f, g, n, self.table.num_slots,
                    self.mode))
            self._jit_cache[key] = jax.jit(per_utt)
        return self._jit_cache[key]

    def run_recipe_batched(self, recipe: Recipe, batch_size: int = 8,
                           info: int = 0) -> HmmStats:
        """Batched ML E-step: utterances bucketed by padded shape, each
        bucket vmapped into one device call (the device replacement for
        running `stats` workers in parallel)."""
        total = HmmStats.zeros(self.model, self.table)
        buckets: dict = {}
        for rinfo in recipe:
            if info > 0:
                import sys
                print(f"Loading: {rinfo.audio_path}", file=sys.stderr)
            samples, _ = read_audio(rinfo.audio_path, self.fg.sample_rate)
            feats, T = self._padded_features(samples)
            graph = self._graph_from_chain(
                [e.label for e in read_phn(rinfo.transcript_path)])
            key = (int(feats.shape[0]), int(graph["pdf"].shape[0]),
                   int(graph["in_src"].shape[1]))
            buckets.setdefault(key, []).append(
                (feats, graph, T, rinfo.audio_path))

        import math
        for (T_pad, P_pad, F), items in buckets.items():
            for i in range(0, len(items), batch_size):
                chunk = items[i:i + batch_size]
                B = len(chunk)
                feats = jnp.stack([c[0] for c in chunk])
                graphs = jax.tree.map(
                    lambda *xs: jnp.stack(xs), *[c[1] for c in chunk])
                n = jnp.asarray([c[2] for c in chunk], jnp.int32)
                out = self._batched_fn(T_pad, P_pad, F, B)(
                    feats, graphs, n)
                lls = np.asarray(out["log_likelihood"])
                for b in range(B):
                    if not math.isfinite(lls[b]) or lls[b] <= -1e29:
                        import sys
                        print(f"Warning: no valid path for "
                              f"{chunk[b][3]}; skipping",
                              file=sys.stderr)
                        self.failed_utterances.append(chunk[b][3])
                        continue
                    utt = device_stats_to_hmm_stats(
                        self.model, self.table,
                        jax.tree.map(lambda x: x[b], out))
                    total.add(utt)
        return total

    def run_recipe_aligned(self, recipe: Recipe,
                           info: int = 0) -> HmmStats:
        """stats -O: accumulate along FIXED state-segmented alignment
        phns (the reference's PhnReader-as-Segmentator path,
        `stats.cc:73-177` simple_train + `PhnReader.cc:220-280`):

        * per frame, the aligned state's mixture accumulates with
          gamma 1 (component split by within-mixture posteriors,
          `Distributions.cc:2134-2160`),
        * transitions: the frame that STARTS a segment counts the
          previous state's first out arc; every other frame counts the
          current state's self arc (so each frame counts exactly one),
        * loglikelihood sums ln(state likelihood) + ln(transition
          prob) per frame.
        """
        total = HmmStats.zeros(
            self.model, self.table,
            PDF_ML_STATS | (PDF_ML_FULL_STATS
                            if self.full_stats else 0))
        model = self.model
        shift = int(round(self.fg.sample_rate / self.fg.frame_rate))
        means = np.asarray(model.means, np.float64)
        covars = np.asarray(model.covars, np.float64)
        # reference Gaussians carry no (2*pi)^(-D/2) factor
        # (DiagonalGaussian::set_constant, Distributions.cc:1274-1283)
        logdet = np.sum(np.log(covars), axis=1)
        # first out arc per state (PhnReader picks the first
        # target_offset != 0 transition for state-labeled phns)
        out_slot = {}
        for i, (s, o) in enumerate(zip(self.table.source,
                                       self.table.offset)):
            s, o = int(s), int(o)
            if o != 0 and s not in out_slot:
                out_slot[s] = i
        self_slot = {int(s): i for i, (s, o) in enumerate(
            zip(self.table.source, self.table.offset))
            if int(o) == 0}
        tprob = np.asarray(self.table.prob, np.float64)
        buf = total.buffers[ML_BUF]
        for rinfo in recipe:
            if info > 0:
                import sys
                print(f"Processing file: {rinfo.audio_path}",
                      file=sys.stderr)
            samples, _ = read_audio(rinfo.audio_path,
                                    self.fg.sample_rate)
            feats = np.asarray(self.fg.features(samples), np.float64)
            entries = read_phn(rinfo.alignment_path
                               or rinfo.transcript_path)
            prev_state = None
            for e in entries:
                ph = model.phones[self._phone_id[e.label]]
                st = int(ph.states[max(e.state, 0)])
                comp, w = model.mixtures[st]
                comp = np.asarray(comp)
                w = np.asarray(w, np.float64)
                f0, f1 = e.start // shift, e.end // shift
                for t in range(f0, min(f1, feats.shape[0])):
                    x = feats[t]
                    d = x[None, :] - means[comp]
                    logn = -0.5 * (
                        np.sum(d * d / covars[comp], axis=1)
                        + logdet[comp])
                    like = w * np.exp(logn)
                    tot = float(like.sum())
                    buf.mix_ll[st] += np.log(max(tot, 1e-300))
                    total.num_ll += np.log(max(tot, 1e-300))
                    if tot > 0:
                        g = like / tot
                        buf.gamma[comp] += g
                        buf.mean_acc[comp] += g[:, None] * x[None, :]
                        buf.sec_acc[comp] += g[:, None] * (x * x)[None]
                        buf.aux_gamma[comp] += np.abs(g)
                        buf.feacount[comp] += 1
                        buf.mix_gamma[st, :len(comp)] += g
                        if self.full_stats:
                            buf.ensure_full()
                            buf.full_acc[comp] += (
                                g[:, None, None]
                                * np.outer(x, x)[None])
                    if t == f0 and prev_state is not None:
                        tr = out_slot[prev_state]
                    else:
                        tr = self_slot[st]
                    total.trans_acc[tr] += 1.0
                    total.num_ll += np.log(max(tprob[tr], 1e-300))
                    total.num_frames += 1
                prev_state = st
        return total

    def run_recipe(self, recipe: Recipe, info: int = 0,
                   use_hmmnet: bool = False,
                   mmi: bool = False, mpe: bool = False,
                   errmode: str = "mpe",
                   max_seg_dur: int = 64) -> HmmStats:
        """Accumulate statistics over a recipe shard.

        use_hmmnet: read hmmnet= FSTs instead of transcripts (-H);
        mmi: additionally run the den-hmmnet= network into the MMI
        buffer (stats.cc --mmi path);
        mpe: MPE statistics into the MPE num/den buffers (stats.cc
        --mpe); errmode selects the SegErrorEvaluator mode: mwe / mpe /
        mpfe-pdf / mpfe-cps / mpfe / snfe (stats.cc:346,489-496).
        max_seg_dur bounds the duration-augmented state of the
        segment-level modes.
        """
        from aaltoasr_tpu.formats.fst import read_fst
        from aaltoasr_tpu.train.accumulators import (
            MMI_BUF, MPE_DEN_BUF, MPE_NUM_BUF, PDF_ML_FULL_STATS,
            PDF_MMI_STATS, PDF_MPE_DEN_STATS, PDF_MPE_NUM_STATS)
        mode = (PDF_ML_STATS | (PDF_MMI_STATS if mmi else 0)
                | (PDF_ML_FULL_STATS if self.full_stats else 0)
                | ((PDF_MPE_NUM_STATS | PDF_MPE_DEN_STATS)
                   if mpe else 0))
        total = HmmStats.zeros(self.model, self.table, mode)
        for rinfo in recipe:
            if info > 0:
                import sys
                print(f"Processing file: {rinfo.audio_path}",
                      file=sys.stderr)
            samples, _ = read_audio(rinfo.audio_path, self.fg.sample_rate)
            feats, T = self._padded_features(samples)
            num_fst = None
            if use_hmmnet and rinfo.hmmnet_path:
                num_fst = read_fst(rinfo.hmmnet_path)
                graph = self._graph_from_fst(num_fst)
            else:
                entries = read_phn(rinfo.transcript_path)
                graph = self._graph_from_chain(
                    [e.label for e in entries])
            # the discriminative path accumulates per SEGMENTED ARC
            # (collect_lattice_stats, stats.cc:225-306), so feacount
            # counts live (frame, arc) pairs there; the ML-only path
            # goes through the per-(frame, pdf) Segmentator maps
            dstats = self._run_graph(feats, T, graph,
                                     arc_feacount=mmi or mpe)
            utt = device_stats_to_hmm_stats(
                self.model, self.table, dstats, mode)
            if mmi or mpe:
                # collect_lattice_stats has no transition branch — the
                # reference's discriminative path leaves the .phs
                # counts at zero even with -t (stats.cc:225-306)
                utt.trans_acc[:] = 0.0
            # failure detection (stats.cc:79-100 beam-retry analog): a
            # dense FB has no beams, so a dead utterance means broken
            # inputs — skip it and record, as the batch-retry protocol
            # expects (train.pl:372)
            import math
            if not math.isfinite(utt.num_ll) or utt.num_ll <= -1e29:
                import sys
                print(f"Warning: no valid path for "
                      f"{rinfo.audio_path}; skipping", file=sys.stderr)
                self.failed_utterances.append(rinfo.audio_path)
                continue
            if (mmi or mpe) and not rinfo.den_hmmnet_path:
                raise ValueError(
                    f"--mmi/--mpe requires den-hmmnet= in the recipe "
                    f"(missing for {rinfo.audio_path})")
            if mmi:
                den_graph = self._graph_from_fst(
                    read_fst(rinfo.den_hmmnet_path))
                den = self._run_graph(feats, T, den_graph,
                                      arc_feacount=True)
                device_stats_to_hmm_stats(
                    self.model, self.table, den, mode,
                    buffer_id=MMI_BUF, stats=utt)
            if mpe:
                out = self._mpe_stats_for(
                    feats, T, graph, num_fst,
                    read_fst(rinfo.den_hmmnet_path), errmode,
                    max_seg_dur)
                for buf_id, key in ((MPE_NUM_BUF, "num"),
                                    (MPE_DEN_BUF, "den")):
                    d = dict(out[key])
                    d["trans_acc"] = np.zeros(self.table.num_slots)
                    d["log_likelihood"] = out["log_likelihood"]
                    d["num_frames"] = T
                    device_stats_to_hmm_stats(
                        self.model, self.table, d, mode,
                        buffer_id=buf_id, stats=utt)
                utt.den_ll = float(out["avg_accuracy"])
                utt.mpe_score += float(out["avg_accuracy"])
            total.add(utt)
        return total
