"""Dense-node beam search: the batched fast decode mode.

The exact searcher (`decoder.search`) keeps a sparse token list and pays
for per-frame multi-key sorts.  This mode keeps ONE hypothesis per tree
node in dense arrays over all N nodes — the Viterbi approximation at the
node level — which turns every step into fan-in gathers + small-axis
argmax over the static in-arc tables: no sorts in the hot path, pure
vector work.  Accuracy trade-off: hypotheses with different LM histories
recombine at tree nodes (the reference keeps several per node,
TokenPassSearch.cc:1312); re-entry after word ends carries the top-C
distinct word-end histories per frame to soften the approximation.

Step per frame:
1. in-arc relaxation: score[n] = max_f score[src] + trans + duration
   (dense [N, F] gather/argmax; payload follows the argmax)
2. add observation log-likelihoods (one gather of sll[pdf])
3. word ends (static node list): FSA LM walk + pronunciation +
   insertion penalty; top-E into traceback records, top-C re-entered
   through the root arcs, competing with in-tree arrivals.

Same tables, config, records, and traceback/lattice machinery as the
exact searcher.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from aaltoasr_tpu.decoder.lexicon import (
    PrefixTree, duration_table, node_duration_params)
from aaltoasr_tpu.decoder.ngram import (
    InterNGramFsa, NGramFsa, lm_walk_device, lm_walk_device_multi)
from aaltoasr_tpu.decoder.search import (
    DecodeResult, SearchConfig, expand_word_boundaries,
    multiword_components, walk_components)
from aaltoasr_tpu.ops.logsemiring import LOG_ZERO


def _shift_structure(tree: PrefixTree):
    """Split in-arcs into index-shift classes and irregular leftovers.

    Gathers are the cost of dense relaxation; but the tree builder
    numbers each phone instance's states consecutively, so almost every
    arc has target - source in {0, 1, 2} (self / next / skip) — those
    relax as array SHIFTS (free vector ops).  Only trie branch arcs and
    multi-exit fan-ins are irregular; they are grouped BY TARGET into a
    padded [Mi, F] source table so the relaxation is a static gather +
    small-axis argmax (static gathers with compact outputs instead of
    scatters into [B, N] outputs).
    """
    N, A = tree.arc_tgt.shape
    shifts = {0: np.full(N, LOG_ZERO, np.float32),
              1: np.full(N, LOG_ZERO, np.float32),
              2: np.full(N, LOG_ZERO, np.float32)}
    src = np.repeat(np.arange(N, dtype=np.int64), A)
    tgt = tree.arc_tgt.reshape(-1).astype(np.int64)
    lp = tree.arc_logp.reshape(-1).astype(np.float32)
    valid = lp > LOG_ZERO / 2
    delta = tgt - src
    irregular = valid.copy()
    for d in (0, 1, 2):
        m = valid & (delta == d)
        idx = np.nonzero(m)[0]
        # first arc per (shift, target) wins; duplicates stay irregular
        _, first = np.unique(tgt[idx], return_index=True)
        take = idx[first]
        shifts[d][tgt[take]] = lp[take]
        irregular[take] = False
    by_tgt: dict = {}
    for i in np.nonzero(irregular)[0]:
        by_tgt.setdefault(int(tgt[i]), []).append(
            (int(src[i]), float(lp[i])))
    targets = sorted(by_tgt)
    Mi = max(len(targets), 1)
    F = max((len(v) for v in by_tgt.values()), default=1)
    grp_src = np.zeros((Mi, F), np.int32)
    grp_lp = np.full((Mi, F), LOG_ZERO, np.float32)
    grp_tgt = np.zeros(Mi, np.int32)
    # inverse map: node -> compact row (Mi = "no irregular in-arcs")
    inv = np.full(N, Mi, np.int32)
    for m, t in enumerate(targets):
        grp_tgt[m] = t
        inv[t] = m
        for f, (n, lp) in enumerate(by_tgt[t]):
            grp_src[m, f] = n
            grp_lp[m, f] = lp
    return shifts, grp_tgt, grp_src, grp_lp, inv


def _node_duration_params(tree, model, scale):
    """Gather-free gamma duration params (shared helper in lexicon.py;
    identical values to duration_table)."""
    return {k: jnp.asarray(v) for k, v in
            node_duration_params(tree, model, scale).items()}


class DenseBeamSearch:
    """Compiled dense-mode batched decoder."""

    def __init__(self, tree: PrefixTree, lm: NGramFsa, model,
                 config: SearchConfig = SearchConfig(),
                 reentry_width: int = 4, word_classes=None):
        self.tree = tree
        self.lm = lm
        self.config = config
        self.reentry_width = reentry_width
        if word_classes is not None:
            word_classes.apply_to_tree(tree, lm)
        lm_names = (word_classes.lm_word_names(tree.vocab)
                    if word_classes is not None else tree.vocab)
        shifts, grp_tgt, grp_src, grp_lp, grp_inv = _shift_structure(tree)
        # compact re-entry space: union of all context-pair row targets
        # (the only nodes stage 3 can write); merges happen in [B, M+1]
        # arrays and expand to [B, N] with ONE static gather
        pt = np.asarray(tree.root_pair_tgt)
        plp = np.asarray(tree.root_pair_logp)
        entry_nodes = np.unique(pt[plp > LOG_ZERO / 2])
        if len(entry_nodes) == 0:
            entry_nodes = np.zeros(1, dtype=pt.dtype)
        M_entry = len(entry_nodes)
        node_to_entry = np.full(tree.num_nodes, M_entry, np.int32)
        node_to_entry[entry_nodes] = np.arange(M_entry, dtype=np.int32)
        self._M_entry = M_entry
        # pair membership factored as (left-class mask) x (rcset mask):
        # pair = cls * NR + rc and a variant enters row (cls, rc) iff
        # cls in variant.left AND variant.first_class in rcset (the
        # builder's product predicate, lexicon._build_crossword_tree).
        # Entry log-probs are always 0 (asserted), so the merge needs
        # only the mask — two [C, NC]/[C, NR] one-hot matmuls at decode
        # time instead of a [C*R, M] one-hot (R reaches ~500 and M ~16k
        # on a production cross-word tree; the reference's re-entry is
        # likewise per fan-in variant, TPLexPrefixTree.hh:172-240).
        NP = pt.shape[0]
        NC, NR = tree.num_classes, tree.num_rcsets
        assert NP == NC * NR, (NP, NC, NR)
        valid_rows = plp > LOG_ZERO / 2
        assert not np.any(plp[valid_rows] != 0.0), \
            "dense re-entry assumes zero entry log-probs"
        member = np.zeros((NP, M_entry), bool)
        rows_p, rows_r = np.nonzero(valid_rows)
        member[rows_p, node_to_entry[pt[rows_p, rows_r]]] = True
        m3 = member.reshape(NC, NR, M_entry)
        left_mem = m3.any(axis=1)              # [NC, M]
        first_mem = m3.any(axis=0)             # [NR, M]
        assert np.array_equal(
            left_mem[:, None, :] & first_mem[None, :, :], m3), \
            "pair membership is not a product — tree builder invariant"
        self._NC, self._NR = NC, NR
        # word-end slots as a flat static list (padded to >= num_records
        # so per-frame record buffers have a fixed shape)
        we_n, we_h = np.nonzero(tree.we_exit_logp > LOG_ZERO / 2)
        pad = max(config.num_records, reentry_width) - len(we_n)
        if pad > 0:
            we_n = np.concatenate([we_n, np.zeros(pad, dtype=we_n.dtype)])
            we_h = np.concatenate([we_h, np.zeros(pad, dtype=we_h.dtype)])
            # mark padding rows dead via the exit score below
        self._we_pad = max(pad, 0)
        # static unigram log-prob per slot's LM word: the cheap LM
        # estimate (bo_weight[state] + uni_w) ranks word ends so the
        # exact FSA walk only runs on the top-E candidates (the walk's
        # per-element gathers dominate the step otherwise)
        # multiword-aware ids: lm_ids[w] is -1 when any component is
        # missing (pruned); slot_lmid ranks by the FIRST component
        mw_comp, lm_ids, _, _ = multiword_components(
            lm_names, lm, config.split_multiwords)
        self._mw_cmax = mw_comp.shape[1]
        slot_lmid = lm_ids[np.maximum(tree.we_word[we_n, we_h], 0)]
        # interpolated LMs (InterTreeGram decode): every member walked,
        # scores mixed in the probability domain
        members = lm.members if isinstance(lm, InterNGramFsa) else [lm]
        log_coeffs = (lm.log_coeffs if isinstance(lm, InterNGramFsa)
                      else [0.0])
        self._K = len(members)
        self._lm_tables = [m.device_tables() for m in members]
        self._log_coeffs = log_coeffs
        # interpolated zero-context unigram as the static rank estimate
        uni_mix = np.full((len(we_n),), -np.inf, np.float64)
        for m, lw in zip(members, log_coeffs):
            row = np.full(m.num_words, LOG_ZERO, np.float32)
            lo0, hi0 = int(m.state_first[0]), int(m.state_first[1])
            row[m.trans_word[lo0:hi0]] = m.trans_prob[lo0:hi0]
            uni_mix = np.logaddexp(
                uni_mix, lw + row[np.maximum(slot_lmid, 0)])
        uni_w = np.maximum(uni_mix, LOG_ZERO).astype(np.float32)
        # morph word boundary (SearchConfig.word_boundary): see the
        # exact engine — double-boundary prune + </s> LM reset
        self._wb_tid = (tree.word_index.get(config.word_boundary, -1)
                        if config.word_boundary else -1)
        self._end_tid = tree.word_index.get(config.sentence_end, -1)
        wb_tables = {}
        if self._wb_tid >= 0:
            wbl = members[0].word_index.get(config.word_boundary, -1)
            wb_tables["is_wb_state"] = (
                jnp.asarray(members[0].states_ending_with(wbl))
                if wbl >= 0
                else jnp.zeros(members[0].num_states, bool))
            reset = []
            for m in members:
                st = m.initial_state()
                wb_m = m.word_index.get(config.word_boundary, -1)
                if wb_m >= 0:
                    st, _ = m.walk(st, wb_m)
                reset.append(st)
            wb_tables["wb_reset"] = jnp.asarray(
                np.asarray(reset, np.int32))
        self.tables = {
            "self_logp": jnp.asarray(shifts[0]),
            "prev_logp": jnp.asarray(shifts[1]),
            "skip_logp": jnp.asarray(shifts[2]),
            "grp_tgt": jnp.asarray(grp_tgt),
            "grp_src": jnp.asarray(grp_src),
            "grp_lp": jnp.asarray(grp_lp),
            "grp_inv": jnp.asarray(grp_inv),
            "left_mem": jnp.asarray(left_mem.astype(np.float32)),
            "first_mem": jnp.asarray(first_mem.astype(np.float32)),
            "entry_inv": jnp.asarray(node_to_entry),
            "pdf": jnp.asarray(tree.pdf),
            "dur_state": jnp.asarray(tree.dur_state),
            "we_node": jnp.asarray(we_n.astype(np.int32)),
            "we_word": jnp.asarray(tree.we_word[we_n, we_h]),
            "we_lmid": jnp.asarray(slot_lmid),
            "we_uni": jnp.asarray(uni_w),
            "we_pair": jnp.asarray(tree.we_pair[we_n, we_h]),
            "we_exit": jnp.asarray(np.where(
                np.arange(len(we_n)) < len(we_n) - self._we_pad,
                tree.we_exit_logp[we_n, we_h], LOG_ZERO)),
            "we_pron": jnp.asarray(tree.we_pron_logp[we_n, we_h]),
            "we_skip": jnp.asarray(tree.we_skip_lm[we_n, we_h]),
            # committed-at-final base validity (see search.py)
            "fin_base_ok": jnp.asarray(
                ((tree.arc_tgt != np.arange(tree.num_nodes)[:, None])
                 & (tree.arc_logp > LOG_ZERO / 2)).any(axis=1)
                | ~((tree.we_exit_logp > LOG_ZERO / 2)
                    & (tree.we_word >= 0)
                    & ~tree.we_skip_lm).any(axis=1)
                | ((tree.we_exit_logp > LOG_ZERO / 2)
                   & ((tree.we_word < 0)
                      | tree.we_skip_lm)).any(axis=1)),
            # static per-we-slot duration constants (no dur_state gather)
            "we_dur_valid": None, "we_dur_lncoef": None,
            "we_dur_invb": None, "we_dur_const": None,
            "root_tgt": jnp.asarray(tree.root_tgt),
            "root_logp": jnp.asarray(tree.root_logp),
            "dur_tab": jnp.asarray(duration_table(
                model, config.max_dur, config.duration_scale)),
            # per-node gamma params for gather-free duration bonuses:
            # log p(d) = (a-1) ln d - d/b + const (decoder/src/Hmm.cc)
            **_node_duration_params(tree, model, config.duration_scale),
            "lm_id": jnp.asarray(lm_ids),
            "mw_comp": jnp.asarray(mw_comp),
        }
        self.tables.update(wb_tables)
        self._has_durations = bool(
            np.any(np.asarray(self.tables["dur_tab"]) != 0))
        for key in ("valid", "lncoef", "invb", "const"):
            self.tables[f"we_dur_{key}"] = jnp.asarray(
                np.asarray(self.tables[f"dur_{key}"])[we_n])

        # device tables pass through jit as ARGUMENTS: closed-over
        # arrays would embed as HLO constants and bloat the program
        # with a production LM's tables
        def _split(d):
            dev = {k: v for k, v in d.items()
                   if hasattr(v, "dtype") and getattr(v, "ndim", 0) > 0}
            return dev, {k: v for k, v in d.items() if k not in dev}

        self._dev_t, self._static_t = _split(self.tables)
        pairs = [_split(tab) for tab in self._lm_tables]
        self._dev_lm = [p[0] for p in pairs]
        self._static_lm = [p[1] for p in pairs]

    def _walk(self, states, word, lm_tables):
        """(states [..., K], word [...]) -> (next [..., K], score)."""
        if self._K > 1:
            return lm_walk_device_multi(self, lm_tables, states, word)
        m = self.lm
        nxt, sc = lm_walk_device(lm_tables[0], m.num_words,
                                 m.order, states[..., 0], word)
        return nxt[..., None], sc

    @property
    def members(self):
        return (self.lm.members if isinstance(self.lm, InterNGramFsa)
                else [self.lm])

    @property
    def log_coeffs(self):
        return self._log_coeffs

    def _bo_mix(self, states, lm_tables):
        """max_k(log_coeff_k + min(bo_weight_k[state_k], 0)): the static
        word-end rank estimate.  Carried per node as the `bo` payload so
        the word-end stage never gathers bo_weight by (dynamic) LM state
        — a dynamic gather per step at [B, Nw] size."""
        est = jnp.full(states.shape[:-1], -jnp.inf, jnp.float32)
        for k, tab in enumerate(lm_tables):
            est = jnp.maximum(
                est, self._log_coeffs[k] + jnp.minimum(
                    tab["bo_weight"][states[..., k]], 0.0))
        return est

    def _dur_bonus(self, node, dur, t):
        """Table path (used for gathered word-end nodes)."""
        d = jnp.clip(dur + 1, 1, self.config.max_dur)
        return t["dur_tab"][t["dur_state"][node], d - 1]

    def _dur_bonus_dense(self, dur, t):
        """Gather-free duration bonus for ALL nodes: the gamma formula
        evaluated elementwise with static per-node parameters."""
        d = jnp.clip(dur + 1, 1, self.config.max_dur).astype(jnp.float32)
        return t["dur_valid"] * (
            t["dur_lncoef"] * jnp.log(d) - d * t["dur_invb"]
            + t["dur_const"])

    def _step(self, state, obs_t, step_idx, t, lm_tables):
        # obs_t is ALREADY per-node (gathered from [S] states outside)
        # The carried score payload is TOTAL = am + lm_scale*lms (dead
        # nodes pinned at LOG_ZERO): the relaxation's winning candidate
        # score IS the winner's new total, so no separate am payload is
        # picked/expanded — am is recovered as total - lm_scale*lms at
        # word ends and finalization only.
        cfg = self.config
        total, lms, lm, dur, rec, bo, alive = state
        N = total.shape[0]
        E = cfg.num_records
        C = self.reentry_width

        # ---- 1. in-arc relaxation: shifts + grouped irregular arcs.
        # Node numbering makes nearly all arcs target-source deltas of
        # 0/1/2, so relaxation is elementwise over shifted arrays; the
        # irregular leftovers relax in a compact [Mi, F] by-target table
        # (static gathers + small argmax; no [B, N] scatters).
        ts = cfg.transition_scale_eff
        if self._has_durations:
            durb_all = self._dur_bonus_dense(dur, t)
        else:
            durb_all = jnp.zeros((N,), jnp.float32)
        cross_score = total + durb_all          # leaving the state

        def sh(x, k, fill):
            if not k:
                return x
            pad = jnp.full((k,) + x.shape[1:], fill, x.dtype)
            return jnp.concatenate([pad, x[:-k]])

        cand0 = total + ts * t["self_logp"]
        cand1 = sh(cross_score, 1, LOG_ZERO) + ts * t["prev_logp"]
        cand2 = sh(cross_score, 2, LOG_ZERO) + ts * t["skip_logp"]

        gsrc, glp = t["grp_src"], t["grp_lp"]            # [Mi, F]
        g_sc = cross_score[gsrc] + ts * glp              # [Mi, F]
        fwin = jnp.argmax(g_sc, axis=-1)                 # [Mi]
        g_best = jnp.max(g_sc, axis=-1)                  # [Mi]
        oh_f = (fwin[:, None] ==
                jnp.arange(gsrc.shape[1], dtype=jnp.int32))

        def g_pick(vals):
            """winner-arc payload: vals [Mi, F, ...] -> [Mi, ...]"""
            m = oh_f.reshape(oh_f.shape + (1,) * (vals.ndim - 2))
            return jnp.sum(jnp.where(m, vals, jnp.zeros_like(vals)),
                           axis=1)

        g_lms = g_pick(lms[gsrc])
        # lm member states live as K separate [N] arrays, not one
        # [N, K] array with a tiny minor dimension
        g_lm = tuple(g_pick(l[gsrc]) for l in lm)
        g_rec = g_pick(rec[gsrc])
        g_bo = g_pick(bo[gsrc])

        # expand compact [Mi] results to [N] via the static inverse map
        # (pad slot Mi -> LOG_ZERO), then 2-way select vs the shifts
        def expand(vals, fill):
            pad = jnp.full((1,) + vals.shape[1:], fill, vals.dtype)
            return jnp.concatenate([vals, pad])[t["grp_inv"]]

        stacked = jnp.stack([cand0, cand1, cand2])
        choice = jnp.argmax(stacked, axis=0)
        best3 = jnp.max(stacked, axis=0)
        irr_sc = expand(g_best, LOG_ZERO)
        take_irr = irr_sc > best3
        best = jnp.maximum(best3, irr_sc)

        def pick(v_self, v1, v2, v_irr, fill):
            c = choice.reshape((-1,) + (1,) * (v_self.ndim - 1))
            sel = jnp.where(
                c == 0, v_self, jnp.where(c == 1, v1, v2))
            m = take_irr.reshape((-1,) + (1,) * (v_self.ndim - 1))
            return jnp.where(m, expand(v_irr, fill), sel)

        new_lms = pick(lms, sh(lms, 1, 0.0), sh(lms, 2, 0.0),
                       g_lms, 0.0)
        new_lm = tuple(
            pick(l, sh(l, 1, 0), sh(l, 2, 0), gl, 0)
            for l, gl in zip(lm, g_lm))
        new_rec = pick(rec, sh(rec, 1, -1), sh(rec, 2, -1), g_rec, -1)
        new_bo = pick(bo, sh(bo, 1, 0.0), sh(bo, 2, 0.0), g_bo, 0.0)
        new_dur = jnp.where(take_irr | (choice != 0), 0, dur + 1)
        new_alive = best > LOG_ZERO / 2

        # ---- 2. word ends (from the PREVIOUS frame's state)
        # Two-stage: a cheap static LM estimate (state backoff weight +
        # word unigram) ranks ALL slots; the exact FSA walk runs only on
        # the top-E candidates.  The walk's per-element gathers dominate
        # the step otherwise (the reference likewise only scores LM for
        # surviving word-end tokens, TokenPassSearch.cc:1885).
        wn = t["we_node"]                                  # [Nw]
        Nw = wn.shape[0]
        w_word = t["we_word"]
        w_lmid = t["we_lmid"]
        skip = t["we_skip"] | (w_word < 0)
        tot_wn = total[wn]
        lms_wn = lms[wn]
        lm_wn = [l[wn] for l in lm]
        d_we = jnp.clip(dur[wn] + 1, 1,
                        cfg.max_dur).astype(jnp.float32)
        we_durb = t["we_dur_valid"] * (
            t["we_dur_lncoef"] * jnp.log(d_we)
            - d_we * t["we_dur_invb"] + t["we_dur_const"])
        we_am = (tot_wn - cfg.lm_scale_eff * lms_wn
                 + cfg.transition_scale_eff * t["we_exit"] + we_durb)
        base_lms = lms_wn + t["we_pron"]
        # the rank estimate's backoff term is the CARRIED bo payload
        # (updated whenever a node's LM state changes) — a static [Nw]
        # gather instead of a dynamic one through bo_weight
        appr_lm = jnp.where(
            skip, 0.0, bo[wn] + t["we_uni"] + cfg.insertion_penalty_eff)
        # dead nodes hold total == LOG_ZERO (invariant set post-beam)
        slot_ok = ((tot_wn > LOG_ZERO / 2)
                   & (t["we_exit"] > LOG_ZERO / 2)
                   & (skip | (w_lmid >= 0)))
        rank0 = jnp.where(slot_ok,
                          tot_wn + cfg.transition_scale_eff * t["we_exit"]
                          + we_durb
                          + cfg.lm_scale_eff * (t["we_pron"] + appr_lm),
                          -jnp.inf)

        k = min(E, int(Nw))
        _, cand = jax.lax.top_k(rank0, k)                  # [k]
        if k < E:
            cand = jnp.concatenate(
                [cand, jnp.zeros((E - k,), cand.dtype)])
        # candidate payload extraction via a [E, Nw] one-hot mask:
        # masked reductions instead of [E]-sized dynamic gathers
        oh_e = cand[:, None] == jnp.arange(Nw, dtype=jnp.int32)

        def take_e(vals):
            m = oh_e.reshape(oh_e.shape + (1,) * (vals.ndim - 1))
            return jnp.sum(jnp.where(m, vals[None],
                                     jnp.zeros_like(vals[None])),
                           axis=1)

        c_ok = jnp.any(oh_e & slot_ok[None, :], axis=1)
        if k < E:
            c_ok = c_ok & (jnp.arange(E) < k)
        c_word = take_e(w_word)
        c_skip = jnp.any(oh_e & skip[None, :], axis=1)
        c_state = jnp.stack([take_e(lw) for lw in lm_wn], axis=-1)
        if self._mw_cmax == 1:
            lm_next, lm_score = self._walk(
                c_state, jnp.maximum(take_e(w_lmid), 0), lm_tables)
        else:
            # multiword split: component-sequence walk
            # (split_and_compute_ngram_score,
            # TokenPassSearch.cc:1818-1843)
            comp = t["mw_comp"][jnp.maximum(c_word, 0)]
            lm_next, lm_score = walk_components(
                lambda st, wd: self._walk(st, wd, lm_tables),
                c_state, comp)
        lm_next = jnp.where(c_skip[:, None], c_state, lm_next)
        lm_score = jnp.where(c_skip, 0.0, lm_score)
        c_am = take_e(we_am)
        c_lms = (take_e(base_lms) + lm_score
                 + jnp.where(c_skip, 0.0, cfg.insertion_penalty_eff))
        c_alive = c_ok & (lm_score > LOG_ZERO / 2)
        if self._wb_tid >= 0:
            # morph word boundary: prune two subsequent boundaries and
            # reset the LM through <s> + boundary on a mid-utterance
            # sentence end (TokenPassSearch.cc:869-873, 888-919)
            prev_wb = t["is_wb_state"][c_state[:, 0]]
            c_alive = c_alive & ~((c_word == self._wb_tid) & prev_wb)
            if self._end_tid >= 0:
                lm_next = jnp.where(
                    (c_word == self._end_tid)[:, None],
                    t["wb_reset"][None, :], lm_next)
        c_total = jnp.where(c_alive, c_am + cfg.lm_scale_eff * c_lms,
                            -jnp.inf)

        # records: the E candidates with exact scores
        c_prev = take_e(rec[wn])
        is_word = c_alive & (c_word >= 0)
        rec_word = jnp.where(c_alive, c_word, -1)
        rec_prev = jnp.where(is_word, c_prev, -1)
        rec_am = jnp.where(is_word, c_am, 0.0)
        rec_lms = jnp.where(is_word, c_lms, 0.0)
        slot_ptr = step_idx * E + jnp.arange(E, dtype=jnp.int32)
        e_rec = jnp.where(is_word, slot_ptr, c_prev)

        # ---- 3. re-entry: top-C candidates through their context-pair
        # rows (cross-word fan-in, TPLexPrefixTree.hh:172-240; monophone
        # trees have one row).  All merging happens in the COMPACT entry
        # space [M+1] (small scatters), then expands to [N] with one
        # static gather per payload instead of seven [B, N]-output
        # scatters.
        _, top_c = jax.lax.top_k(c_total, C)
        oh_c2 = top_c[:, None] == jnp.arange(E, dtype=jnp.int32)

        def take_c(vals):
            m = oh_c2.reshape(oh_c2.shape + (1,) * (vals.ndim - 1))
            return jnp.sum(jnp.where(m, vals[None],
                                     jnp.zeros_like(vals[None])),
                           axis=1)

        r_lms = take_c(c_lms)
        r_lm = take_c(lm_next)
        r_rec = take_c(e_rec)
        r_alive = jnp.any(oh_c2 & c_alive[None, :], axis=1)
        r_bo = self._bo_mix(r_lm, lm_tables)
        r_pair = take_c(take_e(t["we_pair"]))
        # pair membership is a product (left-class in variant.left) x
        # (variant.first_class in rcset): two tiny one-hot matmuls give
        # the [C, M] entry mask directly.  Entry log-probs are zero by
        # builder invariant (asserted in __init__), so the merge is a
        # masked max over the C candidates — no [C*R, M] one-hot (R
        # reaches ~500 on production cross-word trees).
        NR = self._NR
        oh_cls = ((r_pair // NR)[:, None] ==
                  jnp.arange(self._NC, dtype=jnp.int32)).astype(
                      jnp.float32)                         # [C, NC]
        oh_rc = ((r_pair % NR)[:, None] ==
                 jnp.arange(NR, dtype=jnp.int32)).astype(
                     jnp.float32)                          # [C, NR]
        maskC = ((oh_cls @ t["left_mem"])
                 * (oh_rc @ t["first_mem"])) > 0.5         # [C, M]
        r_total = jnp.where(r_alive,
                            jnp.maximum(take_c(c_total), LOG_ZERO),
                            LOG_ZERO)
        enter = jnp.where(maskC & r_alive[:, None],
                          r_total[:, None], LOG_ZERO)      # [C, M]
        e_sc = jnp.max(enter, axis=0)                      # [M]
        winner = jnp.argmax(enter, axis=0)                 # [M]
        oh_w = ((jnp.arange(C, dtype=jnp.int32)[:, None] ==
                 winner[None, :])
                & (e_sc > LOG_ZERO / 2)[None, :])          # [C, M]

        def c_pay(vals, fill=0.0):
            """winner payload: vals [C, ...] -> [M, ...] (+ pad row)."""
            m = oh_w.reshape(oh_w.shape + (1,) * (vals.ndim - 1))
            out = jnp.sum(
                jnp.where(m, vals[:, None], jnp.zeros_like(vals)[:, None]),
                axis=0)
            pad = jnp.full((1,) + out.shape[1:], fill, out.dtype)
            return jnp.concatenate([out, pad])

        e_lms = c_pay(r_lms)
        e_lm = c_pay(r_lm)                                 # [M+1, K]
        e_rec2 = c_pay(r_rec)
        e_bo = c_pay(r_bo)
        e_sc1 = jnp.concatenate([e_sc, jnp.full((1,), LOG_ZERO,
                                                e_sc.dtype)])

        inv = t["entry_inv"]
        cur = jnp.where(new_alive, best, LOG_ZERO)
        sc_full = e_sc1[inv]
        take_tgt = sc_full > cur                           # [N]
        new_lms = jnp.where(take_tgt, e_lms[inv], new_lms)
        new_lm = tuple(
            jnp.where(take_tgt, e_lm[:, k][inv], l)
            for k, l in enumerate(new_lm))
        new_dur = jnp.where(take_tgt, 0, new_dur)
        new_rec = jnp.where(take_tgt, e_rec2[inv], new_rec)
        new_bo = jnp.where(take_tgt, e_bo[inv], new_bo)
        new_alive = new_alive | take_tgt

        # ---- 4. observation + beam (the winner's candidate score IS
        # its new total, so total follows the merge with no extra pick)
        new_total = jnp.where(take_tgt, sc_full, cur) + obs_t
        mx = jnp.max(new_total)
        new_alive = new_alive & (new_total >= mx - cfg.beam)
        # dead nodes pinned at LOG_ZERO (the word-end ranking and
        # `_result` read aliveness off total directly)
        new_total = jnp.where(new_alive, new_total, LOG_ZERO)
        # per-frame best snapshot: argmax node's rec and lms fetched
        # with two single-index gathers (a masked-max would re-read the
        # full [N] rec/lms arrays every frame); am recovered as
        # mx - lm_scale*lms
        bestn = jnp.argmax(new_total)
        best_rec = new_rec[bestn]
        best_lms = new_lms[bestn]
        fin = jnp.stack([best_rec.astype(jnp.float32), mx,
                         mx - cfg.lm_scale_eff * best_lms, best_lms])

        return ((new_total, new_lms, new_lm, new_dur, new_rec, new_bo,
                 new_alive),
                (rec_word, rec_prev, rec_am, rec_lms), fin)

    def _decode(self, obs, n_frames, lm_init, t, lm_tables,
                lattice=True):
        cfg = self.config
        N = self.tree.num_nodes
        # utterance-initial entries: the boundary-context pair row
        # (TPLexPrefixTree fan-in; union row for monophone trees)
        init_row = np.asarray(self.tree.root_pair_tgt[self.tree.init_pair])
        init_lp = np.asarray(self.tree.root_pair_logp[self.tree.init_pair])
        r_tgt = jnp.asarray(init_row[init_lp > LOG_ZERO / 2])
        r_lp = jnp.asarray(init_lp[init_lp > LOG_ZERO / 2])

        first = obs[0][t["pdf"][r_tgt]]
        am0 = jnp.full((N,), LOG_ZERO, jnp.float32)
        am0 = am0.at[r_tgt].max(first + r_lp)
        alive0 = jnp.zeros((N,), bool).at[r_tgt].set(True)
        bo0 = self._bo_mix(lm_init[None, :], lm_tables)[0]
        state = (am0, jnp.zeros((N,), jnp.float32),
                 tuple(jnp.full((N,), lm_init[k], jnp.int32)
                       for k in range(self._K)),
                 jnp.zeros((N,), jnp.int32),
                 jnp.full((N,), -1, jnp.int32),
                 jnp.full((N,), bo0, jnp.float32), alive0)

        T = obs.shape[0]
        valid = jnp.arange(1, T) < n_frames
        steps = jnp.arange(T - 1, dtype=jnp.int32)
        # Without a final </s> LM update the per-frame best is a few
        # scalars, so instead of freezing the whole [N] carry with
        # jnp.where(v, new, old) per payload (7 full-array read+writes
        # per step), snapshot the best (rec, total, am, lms) each frame
        # (computed inside _step, fused with the beam pass) and let the
        # state evolve garbage past n_frames.
        snap = not cfg.require_sentence_end

        def fin_of(s):
            tot_, lms_, _lm, _dur, rec_, _bo, alive_ = s
            total = jnp.where(alive_, tot_, -jnp.inf)
            mx = jnp.max(total)
            isb = total == mx
            best_rec = jnp.max(jnp.where(isb, rec_, jnp.int32(-2**31)))
            best_lms = jnp.max(jnp.where(isb, lms_, -jnp.inf))
            return jnp.stack([best_rec.astype(jnp.float32), mx,
                              mx - cfg.lm_scale_eff * best_lms, best_lms])

        def step(carry, xs):
            state, fin = carry
            obs_t, v, i = xs
            # per-step [N] <- [S] static gather: cheaper than a [T, N]
            # precompute (which also capped the batch via its HBM cost)
            new_state, recs, new_fin = self._step(
                state, obs_t[t["pdf"]], i, t, lm_tables)
            if snap:
                fin = jnp.where(v, new_fin, fin)
                out = new_state
            else:
                out = jax.tree.map(lambda n, o: jnp.where(v, n, o),
                                   new_state, state)
            recs = jax.tree.map(
                lambda r: jnp.where(v, r, jnp.full_like(
                    r, -1 if r.dtype == jnp.int32 else 0)), recs)
            return (out, fin), recs

        (state, fin), recs = jax.lax.scan(
            step, (state, fin_of(state)), (obs[1:], valid, steps))

        # finalize ON DEVICE: only scalars + the packed per-frame record
        # stacks go to the host, never the [B, N] state
        if snap:
            # fast serving path: keeps the exit-based convention at the
            # final frame (no </s> update, no committed-at-final pass)
            finals = fin
            rec_best = fin[0].astype(jnp.int32)
            fw_best = jnp.int32(-1)
        else:
            tot, lms, lm, dur, rec, bo, alive = state
            end_id = self.lm.word_index.get(cfg.sentence_end)
            lm_k = jnp.stack(lm, axis=-1)                  # [N, K]
            if end_id is not None:
                _, end_sc = self._walk(
                    lm_k, jnp.full((N,), end_id, jnp.int32), lm_tables)
                base_lms = lms + jnp.where(alive, end_sc, 0.0)
                base_tot = tot + jnp.where(
                    alive, cfg.lm_scale_eff * end_sc, 0.0)
            else:
                base_lms, base_tot = lms, tot
            # committed-at-final alternative per word-end slot (see
            # search.py _final_commit: entry-based word ids in the
            # reference — no exit transition / duration on the commit)
            wn2 = t["we_node"]                             # [Nw]
            w_ok = ((t["we_exit"] > LOG_ZERO / 2) & ~t["we_skip"]
                    & (t["we_word"] >= 0) & (t["we_lmid"] >= 0)
                    & alive[wn2])
            st_w = lm_k[wn2]                               # [Nw, K]
            if self._mw_cmax == 1:
                nxt_w, sc_w = self._walk(
                    st_w, jnp.maximum(t["we_lmid"], 0), lm_tables)
            else:
                comp = t["mw_comp"][jnp.maximum(t["we_word"], 0)]
                nxt_w, sc_w = walk_components(
                    lambda st, wd: self._walk(st, wd, lm_tables),
                    st_w, comp)
            if self._wb_tid >= 0:
                prev_wb = t["is_wb_state"][st_w[:, 0]]
                w_ok = w_ok & ~((t["we_word"] == self._wb_tid)
                                & prev_wb)
                if self._end_tid >= 0:
                    nxt_w = jnp.where(
                        (t["we_word"] == self._end_tid)[:, None],
                        t["wb_reset"][None, :], nxt_w)
            if end_id is not None:
                _, end2 = self._walk(
                    nxt_w, jnp.full(wn2.shape, end_id, jnp.int32),
                    lm_tables)
            else:
                end2 = jnp.zeros(wn2.shape, jnp.float32)
            alt_lms = (lms[wn2] + t["we_pron"]
                       + cfg.insertion_penalty_eff + sc_w + end2)
            alt_tot = jnp.where(
                w_ok & (sc_w > LOG_ZERO / 2),
                tot[wn2] - cfg.lm_scale_eff * lms[wn2]
                + cfg.lm_scale_eff * alt_lms, -jnp.inf)
            base_total = jnp.where(alive & t["fin_base_ok"],
                                   base_tot, -jnp.inf)
            allt = jnp.concatenate([base_total, alt_tot])
            besti = jnp.argmax(allt)
            is_alt = besti >= N
            slot = jnp.maximum(besti - N, 0)
            bestn = jnp.where(is_alt, wn2[slot], besti)
            best_total = allt[besti]
            best_lms = jnp.where(is_alt, alt_lms[slot],
                                 base_lms[bestn])
            fw_best = jnp.where(is_alt, t["we_word"][slot],
                                jnp.int32(-1))
            finals = jnp.stack([
                rec[bestn].astype(jnp.float32), best_total,
                best_total - cfg.lm_scale_eff * best_lms, best_lms,
                fw_best.astype(jnp.float32)])
            rec_best = rec[bestn]
        if not lattice:
            # 1-best traceback ON DEVICE: the full record stacks are
            # tens of MB; the word chain is a few hundred bytes.  Matches the reference's default
            # (word graphs only on request, TokenPassSearch.hh:278-285).
            flat_w = recs[0].reshape(-1)
            flat_p = recs[1].reshape(-1)
            # at most one word commits per frame on the 1-best chain
            Wmax = min(self._traceback_cap, T)

            def cond(c):
                ptr, i, _ = c
                return (ptr >= 0) & (i < Wmax)

            def body(c):
                ptr, i, out = c
                w = flat_w[ptr]
                out = out.at[i].set(w)
                return flat_p[ptr], i + 1, out

            has_fw = fw_best >= 0
            out0 = jnp.full((Wmax,), -1, jnp.int32)
            out0 = out0.at[0].set(jnp.where(has_fw, fw_best, -1))
            _, nw, words = jax.lax.while_loop(
                cond, body,
                (rec_best, has_fw.astype(jnp.int32), out0))
            return finals, words, nw
        rec_ints = jnp.stack([recs[0], recs[1]], axis=-1)   # [T-1, E, 2]
        rec_floats = jnp.stack([recs[2], recs[3]], axis=-1)
        if cfg.records_half:
            rec_floats = rec_floats.astype(jnp.bfloat16)
        return finals, rec_ints, rec_floats

    # -- public API (mirrors BeamSearch) ----------------------------------
    _traceback_cap = 100000     # word-chain safety bound; the per-
                                # utterance cap is min(cap, T) since at
                                # most one word commits per frame

    def decode(self, obs, n_frames=None, sentence_start="<s>",
               lattice=True):
        obs = jnp.asarray(obs, dtype=jnp.float32)
        if n_frames is None:
            n_frames = obs.shape[0]
        lm_init = np.atleast_1d(np.asarray(
            self.lm.initial_state(sentence_start), dtype=np.int32))
        fn = self._get_jit(("single", bool(lattice)), lattice,
                           batched=False)
        out = fn(obs, jnp.int32(n_frames), jnp.asarray(lm_init),
                 self._dev_t, self._dev_lm)
        if lattice:
            return self._result(*jax.device_get(out[:3]))
        a0, a1, a2 = jax.device_get(out[:3])
        return self._result_words(a0, a1, int(a2))

    def _get_jit(self, key, lattice, batched):
        if not hasattr(self, "_jits"):
            self._jits = {}
        if key not in self._jits:
            def fn(o, n, li, dev_t, dev_lm):
                t = {**self._static_t, **dev_t}
                lms_ = [{**st, **dv} for st, dv
                        in zip(self._static_lm, dev_lm)]
                return self._decode(o, n, li, t, lms_,
                                    lattice=lattice)
            if batched:
                fn = jax.vmap(fn, in_axes=(0, 0, None, None, None))
            self._jits[key] = jax.jit(fn)
        return self._jits[key]

    def decode_batch(self, obs, n_frames, sentence_start="<s>",
                     lattice=True):
        lm_init = np.atleast_1d(np.asarray(
            self.lm.initial_state(sentence_start), dtype=np.int32))
        B, T = obs.shape[0], obs.shape[1]
        # per-step obs gathers keep device memory at O(B*T*S + B*N):
        # no [B, T, N] precompute, so no HBM-driven batch chunking
        fn = self._get_jit(("batch", T, bool(lattice)), lattice,
                           batched=True)
        out = fn(jnp.asarray(obs, jnp.float32),
                 jnp.asarray(n_frames, jnp.int32), jnp.asarray(lm_init),
                 self._dev_t, self._dev_lm)
        # ONE batched device->host round trip for all arrays
        # (per-array or per-utterance fetches each pay a transfer)
        if lattice:
            finals, rec_i, rec_f = jax.device_get(out[:3])
            return [self._result(finals[b], rec_i[b], rec_f[b])
                    for b in range(B)]
        finals, words, nws = jax.device_get(out[:3])
        return [self._result_words(finals[b], words[b], int(nws[b]))
                for b in range(B)]

    def _result_words(self, finals, words_arr, n_words):
        ids = [int(w) for w in words_arr[:n_words][::-1] if w >= 0]
        return DecodeResult(
            search=self, final_ptr=int(finals[0]),
            log_prob=float(finals[1]),
            final_am=float(finals[2]), final_lms=float(finals[3]),
            rec_words=None, rec_prevs=None, rec_ams=None, rec_lmss=None,
            words=expand_word_boundaries(
                [self.tree.vocab[i] for i in ids],
                self.config))

    def _result(self, finals, rec_i, rec_f):
        rec_f = np.asarray(rec_f, dtype=np.float32)
        return DecodeResult(
            search=self, final_ptr=int(finals[0]),
            log_prob=float(finals[1]),
            final_am=float(finals[2]), final_lms=float(finals[3]),
            rec_words=rec_i[..., 0], rec_prevs=rec_i[..., 1],
            rec_ams=rec_f[..., 0], rec_lmss=rec_f[..., 1],
            final_word=(int(finals[4]) if len(finals) > 4 else -1))
