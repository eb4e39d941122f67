"""Batched token-passing beam search on device.

The accelerator re-design of `decoder/src/TokenPassSearch.{hh,cc}`: where the
reference propagates heap-allocated tokens through a pointer tree with
ref-counted history lists (`TokenPassSearch.cc:695-1400`), this search
keeps a fixed-width token array per utterance and runs one `lax.scan`
step per frame:

1. in-word expansion over the dense arc table ``[W, A]``;
2. word-end expansion ``[W, H]``: FSA LM walk (gather-based backoff
   lookup), pronunciation + insertion penalty on the LM side
   (`TokenPassSearch.cc:1965-1990` update_lm_log_prob), duration model on
   state exit (`TokenPassSearch.cc` move_token_to_node), then compaction
   into E traceback records and re-entry through the root arcs ``[E, R]``;
3. observation add, global beam against the running best
   (`TokenPassSearch.cc:1409` prune_tokens), and recombination: sort by
   (node, lm-state) with score tiebreak, keep first per key — the
   vectorized analog of find_similar_lm_history
   (`TokenPassSearch.cc:1312`) — then top-W selection.

Scores follow the reference exactly: total = am + lm_scale * lm with
am += transition + duration and lm += ngram + pron + insertion_penalty
(`TokenPassSearch.hh:539-542` get_token_log_prob).

Log bases: the reference inherits noway's mixed bases — LNA acoustics
and the gamma duration model are NATURAL log (`LnaReaderCircular.cc:183`
bytes/-1820, `Hmm.cc:36` logf), but HMM transition probabilities are
LOG10 (`NowayHmmReader.cc:52` log10(prob)) and so are the ARPA/TreeGram
LM scores.  Our tables keep everything in natural log; to make
``lm_scale`` and ``transition_scale`` mean exactly what the reference's
flags mean (rectool.py defaults were tuned under log10 semantics), the
engines multiply by ``cfg.lm_scale_eff = lm_scale / ln10`` and
``transition_scale_eff = transition_scale / ln10``.  Pronunciation
probabilities are the one reference quirk in the other direction: they
enter its log10 LM accumulator as NATURAL logs
(`TPNowayLexReader.cc:113` safe_log), so our builder stores them
pre-multiplied by ln10 (lexicon.py) and the same lm_scale_eff
reproduces the reference contribution.  Insertion penalty likewise
(a log10-domain constant in the reference): ``insertion_penalty_eff =
insertion_penalty * ln10``.

Word traceback uses per-frame record buffers (word id + previous record
pointer) instead of ref-counted LMHistory chains; the host unwinds the
winning chain after the scan.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from aaltoasr_tpu.decoder.lexicon import (
    PrefixTree, duration_table, node_duration_params)
from aaltoasr_tpu.decoder.ngram import (
    InterNGramFsa, NGramFsa, lm_walk_device, lm_walk_device_multi)
from aaltoasr_tpu.ops.logsemiring import LOG_ZERO

INT_MAX = np.iinfo(np.int32).max
LN10 = 2.302585092994046


@dataclass
class SearchConfig:
    num_tokens: int = 1024          # W: token beam width (fixed array)
    num_records: int = 128          # E: word-end records per frame
    beam: float = 280.0             # global beam (recognize-batch.sh:21)
    lm_scale: float = 30.0
    insertion_penalty: float = 0.0
    transition_scale: float = 1.0
    duration_scale: float = 3.0     # rectool.py:547
    max_dur: int = 64
    lm_lookahead: int = 0           # 0 off, 1 unigram table, 2 bigram
                                    # table, 3 context (>= trigram;
                                    # backoff-FSA state keyed — the
                                    # reference's m_lm_lookahead 2,
                                    # TokenPassSearch.cc:2084)
    word_boundary: str = ""         # morph-mode word boundary ('<w>'):
                                    # the short-silence nodes commit it
                                    # as an LM word, two subsequent
                                    # boundaries are pruned, and a
                                    # mid-utterance sentence end resets
                                    # the LM state through <s> <w>
                                    # (TokenPassSearch.cc:869-873,
                                    # 888-919)
    require_sentence_end: bool = False  # add P(</s>|h) to final
                                    # hypotheses (TokenPassSearch.cc:
                                    # 2267 final-token LM update)
    sentence_end: str = "</s>"
    records_half: bool = False      # bf16 record scores (halves the
                                    # device->host record traffic;
                                    # lattice scores lose ~3 digits)
    overflow_tokens: int = 0        # exact-mode candidate compaction:
                                    # >0 expands in-word arcs as a
                                    # dense [W, 3] table plus branch
                                    # arcs for the top-O tokens only
                                    # (the arc table is ~99% padding —
                                    # few nodes have fan > 3).  O >= W
                                    # is fully exact but adds overhead;
                                    # O ~ W/8 prunes branch expansion
                                    # for the weakest tokens (a
                                    # beam-like knob; its speed on the
                                    # H100 is not measured).
    we_prewalk: int = 0             # exact-mode word-end compaction:
                                    # >0 ranks word-end candidates by
                                    # a static unigram LM estimate and
                                    # runs the exact FSA walk only on
                                    # the top-N (the walk is ~1/3 of
                                    # the step at W*H candidates; the
                                    # dense engine's proven pattern).
                                    # 0 = walk everything (exact).
    split_multiwords: bool = False  # score multiwords ("give_me") as
                                    # their component-word sequence in
                                    # the LM (Toolbox.hh:223-232,
                                    # TokenPassSearch.cc:1689-1734 +
                                    # split_and_compute_ngram_score
                                    # :1818-1843)
    reentry_topk: int = 0           # exact-mode re-entry compaction:
                                    # >0 keeps the top-K word-end
                                    # records per ENTRY NODE instead of
                                    # expanding every record through
                                    # the full [E, R] fan-in row (R
                                    # reaches ~500 on cross-word trees
                                    # and the expansion dominates the
                                    # recombination sort).  Entry
                                    # log-probs are zero by builder
                                    # invariant, so scores separate as
                                    # record_total + obs[entry]: the
                                    # per-node record ranking is the
                                    # global ranking masked by pair
                                    # membership, computed in compact
                                    # [E, M] space (the dense engine's
                                    # factored re-entry).  Exact unless
                                    # >K re-entering histories at one
                                    # node would survive the final
                                    # top-W cut.  0 = full expansion.
                                    # The K-round argmax loop trades
                                    # compute for the [E*R] expansion's
                                    # memory; which wins on the H100 is
                                    # not measured.  Default off; use
                                    # for large-records (rich-lattice)
                                    # configs.
    word_end_beam: float = 0.0      # prune word-end candidates vs the
                                    # frame's best word end
                                    # (Toolbox.hh:205 set_word_end_beam,
                                    # TokenPassSearch.cc:1076-1081
                                    # NODE_USE_WORD_END_BEAM).  0 = off
                                    # (reference default 1e10).
    obs_compose: int = -1           # how candidate observations are
                                    # gathered from the frame log-probs:
                                    # 0 = shared-index (materialize
                                    # obs_t[pdf_table] over the WHOLE
                                    # static table, batch in the minor axis,
                                    # then row-gather — wins on small
                                    # trees), 1 = composed (gather the
                                    # static pdf table at the selected
                                    # rows first, then obs singles —
                                    # avoids an [N,3,B] per-frame
                                    # materialization that dominates
                                    # the step on ~300k-node trees:
                                    # 441 MB/frame at N=287k, B=128),
                                    # -1 = auto by tree size.
    reentry_prewalk: int = 0        # cross-word re-entry compaction:
                                    # each re-entering record keeps
                                    # only its top-K entry nodes of
                                    # the [E, R] fan-in row, ranked by
                                    # root arc + entry obs (exact
                                    # within-row ranking — the row
                                    # constant cancels).  The fan-in
                                    # expansion dominates the
                                    # recombination sort space on
                                    # cross-word trees; this bounds it
                                    # the way the reference's word-end
                                    # beam bounds hypotheses
                                    # (TokenPassSearch.cc:1076-1081).
                                    # 0 = keep all (exact).
    reentry_preselect: int = 0      # static re-entry row compaction:
                                    # >0 precomputes each context
                                    # pair's top-P fan-in entries by
                                    # the STATIC part of the re-entry
                                    # rank (root arc logp + unigram
                                    # lookahead when active) at build
                                    # time, so the per-frame re-entry
                                    # obs gather shrinks from [E, R]
                                    # to [E, P] (R=626 at 287k nodes;
                                    # its share of the step on the
                                    # H100 is not measured); obs only
                                    # re-ranks WITHIN the preselected
                                    # set, so divergence needs an
                                    # entry whose obs advantage beats
                                    # the static gap to the P-th
                                    # entry.  0 = full row (exact).
    reentry_records: int = 0        # only the top-K record slots seed
                                    # cross-word re-entry (records are
                                    # compacted best-first, so this is
                                    # a slice): the [E, R~500] fan-in
                                    # expansion is ~90% of the
                                    # recombination sort's candidate
                                    # space at E=64.  The reference's
                                    # word-end beam plays the same
                                    # hypothesis-limiting role; all E
                                    # records are still WRITTEN for the
                                    # lattice.  0 = all E re-enter.
    # ---- pruning extensions (Toolbox.hh:182-221; compile-time
    # #ifdef PRUNING_EXTENSIONS / EQ_*_PRUNING / FAN_*_PRUNING /
    # STATE_PRUNING blocks in TokenPassSearch.cc:1083-1127).  The
    # reference prunes against PREVIOUS-frame bucket maxima (frame-
    # start active-list scan, cc:320-360); a batched step sees the
    # whole candidate set at once, so the maxima here are same-frame —
    # strictly tighter, never looser.  All default off (0), matching
    # the reference's 1e10 defaults.
    eq_depth_beam: float = 0.0      # vs best candidate at the same
                                    # tree depth (depth/2 buckets,
                                    # regular in-word nodes only)
    eq_word_count_beam: float = 0.0  # vs best candidate with the same
                                    # committed-word count (non-fan
                                    # nodes only)
    fan_in_beam: float = 0.0        # vs best fan-in-network candidate
    fan_out_beam: float = 0.0       # vs best fan-out candidate
    tp_state_beam: float = 0.0      # at fan nodes: vs the best
                                    # candidate at the SAME node
                                    # (STATE_PRUNING, cc:1116-1127)

    # ---- effective scales (see the module docstring "Log bases"):
    # the reference multiplies lm_scale/transition_scale into LOG10
    # values (TreeGram ARPA scores, NowayHmmReader.cc:52 transitions);
    # our tables are natural log, so the engines use flag/ln10 to make
    # the flags mean exactly what the reference's flags mean.
    @property
    def lm_scale_eff(self) -> float:
        return self.lm_scale / LN10

    @property
    def transition_scale_eff(self) -> float:
        return self.transition_scale / LN10

    @property
    def insertion_penalty_eff(self) -> float:
        # a log10-domain additive constant inside the reference's lm
        # accumulator; our lm accumulator is natural
        return self.insertion_penalty * LN10


def expand_word_boundaries(words: list, cfg) -> list:
    """Morph mode: a mid-utterance sentence-end commit restarts the
    LM history through <s> + the word boundary
    (TokenPassSearch.cc:903-919); the reference PRINTS those appended
    history entries, so mirror them in the word list."""
    if not cfg.word_boundary:
        return words
    out = []
    for w in words:
        out.append(w)
        if w == cfg.sentence_end:
            out.append("<s>")
            out.append(cfg.word_boundary)
    return out


def multiword_components(lm_names, lm, split: bool):
    """Per tree word: component LM-word ids and names.

    Returns (comp [V, Cmax] int32 padded with -1,
             lm_id [V] int32 — first component id, or -1 when ANY
             component is missing from the LM (such words are pruned,
             `TokenPassSearch.cc:846-862`),
             first_names, last_names — component names for lookahead
             mapping: subtree values use the FIRST component, context
             rows the LAST (TokenPassSearch.cc:1872 multiword
             lookahead)).

    With split=False (or no '_' in a word) every word is its own
    single component, so Cmax == 1 and the walk loop degenerates to
    the plain one-word walk at zero cost.  Words STARTING with '_'
    are silences, never split (TokenPassSearch.cc:1688-1691).
    """
    parts_of = []
    for w in lm_names:
        if split and not w.startswith("_") and "_" in w:
            ps = [p for p in w.split("_") if p]
            parts_of.append(ps if ps else [w])
        else:
            parts_of.append([w])
    cmax = max((len(p) for p in parts_of), default=1)
    V = max(len(lm_names), 1)
    comp = np.full((V, cmax), -1, np.int32)
    lm_id = np.full((V,), -1, np.int32)
    for i, ps in enumerate(parts_of):
        ids = [lm.word_index.get(p, -1) for p in ps]
        comp[i, :len(ids)] = ids
        lm_id[i] = ids[0] if all(x >= 0 for x in ids) else -1
    first = [ps[0] for ps in parts_of] or [""]
    last = [ps[-1] for ps in parts_of] or [""]
    return comp, lm_id, first, last


def tree_dfs_intervals(tree):
    """Preorder DFS intervals over the prefix tree: subtree(n) spans
    positions [lo[n], hi[n]).  Children are explored in ascending node
    id so HMM skip arcs nest (next-state before skip-target); arcs
    that still violate containment (short-silence bridges, cross-word
    fan-in) widen the source interval — an admissible overestimate.
    """
    N = tree.num_nodes
    at = np.asarray(tree.arc_tgt)
    alp = np.asarray(tree.arc_logp)
    live = (alp > LOG_ZERO / 2) & (at != np.arange(N)[:, None])
    children = [sorted(set(int(x) for x in at[n][live[n]]))
                for n in range(N)]
    roots = np.unique(np.asarray(tree.root_pair_tgt)[
        np.asarray(tree.root_pair_logp) > LOG_ZERO / 2])
    lo = np.full(N, -1, np.int32)
    hi = np.zeros(N, np.int32)
    counter = 0
    for r in sorted(int(x) for x in roots):
        if lo[r] >= 0:
            continue
        # iterative preorder DFS with post-visit hi assignment
        stack = [(r, iter(children[r]))]
        lo[r] = counter
        counter += 1
        while stack:
            n, it = stack[-1]
            for m in it:
                if lo[m] < 0:
                    lo[m] = counter
                    counter += 1
                    stack.append((m, iter(children[m])))
                    break
            else:
                hi[n] = counter
                stack.pop()
    # unvisited nodes: empty intervals
    unv = lo < 0
    lo[unv] = 0
    hi[unv] = 0
    # widen to a containment fixpoint: non-nesting arcs (optional
    # short-silence bridges back to the roots, cross-word fan-in
    # sharing) grow the source interval over the target's.  Widening
    # can only ADD words to a subtree claim, which loosens — never
    # tightens — the lookahead bound, so it stays admissible.
    srcs, slots = np.nonzero(live)
    tgts = at[srcs, slots]
    for _ in range(N):
        need = (lo[srcs] > lo[tgts]) | (hi[tgts] > hi[srcs])
        if not need.any():
            break
        np.minimum.at(lo, srcs[need], lo[tgts[need]])
        np.maximum.at(hi, srcs[need], hi[tgts[need]])
    return lo, hi


def context_lookahead_tables(tree, lm, la_ids, budget=32_000_000):
    """Per-LM-state lookahead lists for context (>= trigram) lookahead.

    The token's backoff-FSA state IS its word history, so the
    reference's (w1, w2)-keyed trigram lookahead
    (`TokenPassSearch.cc:2084` get_lm_trigram_lookahead +
    `TreeGram.cc:549` fetch_trigram_list) becomes, per state s and
    node n:

        la(s, n) = max over backoff levels l of
                   bo(s..l) + max{ score of explicit successor w of
                                   state_l : w ends inside subtree(n) }
        floored by bo(s..unigram) + la1[n] (the unigram table).

    Subtree membership is an interval test on DFS positions; each
    state's explicit successors become padded (position, score) rows.
    This upper-bounds the reference's exact per-word backoff max (a
    word with an explicit higher-order arc also appears at lower
    levels), which is admissible for pruning.

    Returns None when the tree is not interval-representable or the
    padded lists exceed the budget.
    """
    iv = tree_dfs_intervals(tree)
    if iv is None:
        return None
    lo, hi = iv
    # word-end DFS positions per tree word
    we_w = np.asarray(tree.we_word)
    valid = np.asarray(tree.we_exit_logp) > LOG_ZERO / 2
    ends: dict = {}
    for n, h in zip(*np.nonzero(valid)):
        w = int(we_w[n, h])
        if w >= 0:
            ends.setdefault(w, []).append(int(lo[n]))
    # LM word id -> tree end positions (via the lookahead word ids)
    by_lm: dict = {}
    for w_t, wid in enumerate(la_ids):
        if wid >= 0:
            by_lm.setdefault(int(wid), []).extend(ends.get(w_t, []))
    S = lm.num_states
    sf = lm.state_first
    rows = []
    amax = 1
    for s in range(S):
        if s == 0:
            rows.append([])      # unigram level rides the la1 table
            continue
        entries = []
        for i in range(int(sf[s]), int(sf[s + 1])):
            for p in by_lm.get(int(lm.trans_word[i]), ()):
                entries.append((p, float(lm.trans_prob[i])))
        rows.append(entries)
        amax = max(amax, len(entries))
    if S * amax > budget:
        return None
    la_pos = np.full((S, amax), -1, np.int32)
    la_sc = np.full((S, amax), LOG_ZERO, np.float32)
    for s, entries in enumerate(rows):
        for j, (p, sc) in enumerate(entries):
            la_pos[s, j] = p
            la_sc[s, j] = sc
    bo = np.asarray(lm.bo_weight, np.float32).copy()
    bo[0] = 0.0                  # stop accumulating at the unigram root
    return {"la_pos": la_pos, "la_sc": la_sc, "la_bo": bo,
            "la_bnext": np.asarray(lm.bo_next, np.int32),
            "la_lo": lo, "la_hi": hi}


def walk_components(walk_fn, states, comp_ids):
    """Compose the LM walk over multiword components: walk_fn is
    (states [..., K], word [...]) -> (next [..., K], score); comp_ids
    is [..., Cmax] with -1 padding (identity)."""
    st = states
    sc = None
    for c in range(comp_ids.shape[-1]):
        wc = comp_ids[..., c]
        ok = wc >= 0
        nst, s = walk_fn(st, jnp.maximum(wc, 0))
        st = jnp.where(ok[..., None], nst, st)
        s = jnp.where(ok, s, 0.0)
        sc = s if sc is None else sc + s
    return st, sc


def unigram_lookahead(tree: PrefixTree, lm: NGramFsa,
                      lm_names: list) -> np.ndarray:
    """[N] per-node lookahead scores: the best unigram LM log-prob
    over the words completing at or below each node.

    The vectorized replacement for the reference's per-node word lists
    + score cache (`decoder/src/TPLexPrefixTree.hh` lookahead word list,
    `TokenPassSearch.cc` get_lm_lookahead_score): a bottom-up max over
    the static tree, so applying lookahead at decode time is one gather.
    Words that bypass the LM (we_skip / silence) contribute 0 — they
    will pay no LM score, making the estimate optimistic (admissible).
    """
    V = lm.num_words
    uni = np.full(V, -np.inf, dtype=np.float64)
    lo, hi = int(lm.state_first[0]), int(lm.state_first[1])
    uni[lm.trans_word[lo:hi]] = lm.trans_prob[lo:hi]
    word_uni = np.array(
        [uni[lm.word_index[w]] if w in lm.word_index else -np.inf
         for w in lm_names] or [-np.inf])

    valid_we = tree.we_exit_logp > LOG_ZERO / 2
    w = np.maximum(tree.we_word, 0)
    contrib = np.where(tree.we_skip_lm, 0.0, word_uni[w])
    contrib = np.where(valid_we & (tree.we_word >= 0), contrib,
                       np.where(valid_we, 0.0, -np.inf))
    la = contrib.max(axis=1)                     # [N] local word ends

    not_self = ((tree.arc_tgt != np.arange(tree.num_nodes)[:, None])
                & (tree.arc_logp > LOG_ZERO / 2))
    tgt = np.maximum(tree.arc_tgt, 0)
    for _ in range(tree.num_nodes):
        child = np.where(not_self, la[tgt], -np.inf).max(axis=1)
        new = np.maximum(la, child)
        if np.array_equal(new, la):
            break
        la = new
    return np.where(np.isfinite(la), la, 0.0).astype(np.float32)


def bigram_lookahead(tree: PrefixTree, lm: NGramFsa,
                     lm_names: list) -> np.ndarray:
    """[V+1, N] bigram lookahead table: row w = best P(v|w) over the
    words v completing at or below each node; the last row is the
    unigram (no-context) fallback used before the first word.

    The reference computes these lazily per (LMHistory, node) with a
    cache (TokenPassSearch.cc get_lm_bigram_lookahead); precomputing
    the dense table turns the decode-time cost into one 2-D gather.
    Intended for a dedicated small lookahead LM (the reference's
    -lookahead-ngram); guarded by a memory budget upstream.
    """
    V = lm.num_words
    NEG = np.float32(-1e30)
    uni = np.full(V, -np.inf)
    lo, hi = int(lm.state_first[0]), int(lm.state_first[1])
    uni[lm.trans_word[lo:hi]] = lm.trans_prob[lo:hi]

    # dense backoff bigram matrix B[w, v] = P(v | w)
    B = np.zeros((V + 1, V))
    bo = np.zeros(V)
    ctx_state = np.full(V, -1, dtype=np.int64)
    for ctx, st in lm.state_of_context.items():
        if len(ctx) == 1:
            ctx_state[ctx[0]] = st
    has_ctx = ctx_state >= 0
    bo[has_ctx] = lm.bo_weight[ctx_state[has_ctx]]
    B[:V] = bo[:, None] + uni[None, :]
    for w in np.nonzero(has_ctx)[0]:
        a, b = (int(lm.state_first[ctx_state[w]]),
                int(lm.state_first[ctx_state[w] + 1]))
        B[w, lm.trans_word[a:b]] = lm.trans_prob[a:b]
    B[V] = uni                              # no-context fallback row

    word_lm = np.array(
        [lm.word_index.get(w, -1) for w in lm_names] or [-1])

    valid_we = tree.we_exit_logp > LOG_ZERO / 2
    N = tree.num_nodes
    la = np.full((V + 1, N), -np.inf)
    for n in range(N):
        for h in np.nonzero(valid_we[n])[0]:
            w = tree.we_word[n, h]
            if tree.we_skip_lm[n, h] or w < 0:
                la[:, n] = np.maximum(la[:, n], 0.0)
            elif word_lm[w] >= 0:
                la[:, n] = np.maximum(la[:, n], B[:, word_lm[w]])

    not_self = ((tree.arc_tgt != np.arange(N)[:, None])
                & (tree.arc_logp > LOG_ZERO / 2))
    tgt = np.maximum(tree.arc_tgt, 0)
    for _ in range(N):
        child = np.where(not_self[None, :, :], la[:, tgt], -np.inf
                         ).max(axis=2)
        new = np.maximum(la, child)
        if np.array_equal(new, la):
            break
        la = new
    return np.where(np.isfinite(la), la, 0.0).astype(np.float32)


class BeamSearch:
    """Compiled batched decoder for one (tree, LM, model) triple."""

    def __init__(self, tree: PrefixTree, lm: NGramFsa, model,
                 config: SearchConfig = SearchConfig(),
                 word_classes=None, lookahead_lm: NGramFsa | None = None):
        self.tree = tree
        self.lm = lm
        self.config = config
        # NOTE: num_tokens may be SMALLER than the root re-entry row
        # width — the utterance-initial expansion then keeps the top-W
        # candidates by entry logp + frame-0 obs (see _seed_tokens),
        # which is exactly the per-frame recombination beam applied at
        # frame 0.  This removes the old structural W >= R floor that
        # capped production-scale trees at W=1024.
        if word_classes is not None:
            word_classes.apply_to_tree(tree, lm)
        lm_names = (word_classes.lm_word_names(tree.vocab)
                    if word_classes is not None else tree.vocab)
        self.tables = {
            "arc_tgt": jnp.asarray(tree.arc_tgt),
            "arc_logp": jnp.asarray(tree.arc_logp),
            "pdf": jnp.asarray(tree.pdf),
            "dur_state": jnp.asarray(tree.dur_state),
            "we_word": jnp.asarray(tree.we_word),
            "we_exit": jnp.asarray(tree.we_exit_logp),
            "we_pron": jnp.asarray(tree.we_pron_logp),
            "we_skip": jnp.asarray(tree.we_skip_lm),
            "root_tgt": jnp.asarray(tree.root_pair_tgt),
            "root_logp": jnp.asarray(tree.root_pair_logp),
            "we_pair": jnp.asarray(tree.we_pair),
            "dur_tab": jnp.asarray(
                duration_table(model, config.max_dur,
                               config.duration_scale)),
        }
        # tree word id -> LM word id (LMHistory::Word::lm_id(); words
        # absent from the LM — or any missing multiword component —
        # are pruned, TokenPassSearch.cc:846-862)
        mw_comp, lm_id_arr, la_first, la_last = multiword_components(
            lm_names, lm, config.split_multiwords)
        self._mw_cmax = mw_comp.shape[1]
        self.tables["lm_id"] = jnp.asarray(lm_id_arr)
        self.tables["mw_comp"] = jnp.asarray(mw_comp)
        # ---- committed-at-final base validity: a token resting on a
        # node whose only role is ending words (non-skip word ends, no
        # continuation arc, no skip/silence end) has no uncommitted
        # interpretation in the reference (word ids live on dedicated
        # word-end nodes there)
        N_ = tree.num_nodes
        # observation gather mode (SearchConfig.obs_compose): auto
        # flips to per-row composition when the whole-table
        # materialization would dominate memory traffic (the [N,3,B]
        # obs gather grows with the tree; not measured on the H100)
        self._obs_compose = (config.obs_compose == 1
                             or (config.obs_compose == -1
                                 and N_ >= 100_000))
        has_arc = ((tree.arc_tgt != np.arange(N_)[:, None])
                   & (tree.arc_logp > LOG_ZERO / 2)).any(axis=1)
        valid_we_ = tree.we_exit_logp > LOG_ZERO / 2
        nonskip_we = (valid_we_ & (tree.we_word >= 0)
                      & ~tree.we_skip_lm).any(axis=1)
        skip_we = (valid_we_
                   & ((tree.we_word < 0)
                      | tree.we_skip_lm)).any(axis=1)
        self.tables["fin_base_ok"] = jnp.asarray(
            has_arc | ~nonskip_we | skip_we)

        # ---- morph word boundary (SearchConfig.word_boundary):
        # tree id for the double-boundary prune + </s> reset targets
        self._wb_tid = (tree.word_index.get(config.word_boundary, -1)
                        if config.word_boundary else -1)
        self._end_tid = tree.word_index.get(config.sentence_end, -1)
        members = lm.members if isinstance(lm, InterNGramFsa) else [lm]
        if self._wb_tid >= 0:
            wbl = members[0].word_index.get(config.word_boundary, -1)
            self.tables["is_wb_state"] = jnp.asarray(
                members[0].states_ending_with(wbl)) \
                if wbl >= 0 else jnp.zeros(members[0].num_states, bool)
            # sentence-end reset: state after <s> then the boundary
            # word, scores discarded (TokenPassSearch.cc:903-919)
            reset = []
            for m in members:
                st = m.initial_state()
                wb_m = m.word_index.get(config.word_boundary, -1)
                if wb_m >= 0:
                    st, _ = m.walk(st, wb_m)
                reset.append(st)
            self.tables["wb_reset"] = jnp.asarray(
                np.asarray(reset, np.int32))
        # static per-word unigram estimate for we_prewalk ranking
        # (the dense engine's uni_w pattern)
        base_lm = lm.members[0] if isinstance(lm, InterNGramFsa) else lm
        uni_row = np.full(base_lm.num_words + 1, -30.0, np.float32)
        lo0, hi0 = (int(base_lm.state_first[0]),
                    int(base_lm.state_first[1]))
        uni_row[base_lm.trans_word[lo0:hi0]] = \
            base_lm.trans_prob[lo0:hi0]
        self._uni_est = np.where(
            lm_id_arr >= 0, uni_row[np.maximum(lm_id_arr, 0)],
            0.0).astype(np.float32)
        self._has_durations = bool(
            np.any(np.asarray(self.tables["dur_tab"]) != 0))
        # interpolated LMs walk every member and mix scores
        # (InterTreeGram decode, decoder/src/InterTreeGram.hh:41)
        if isinstance(lm, InterNGramFsa):
            self._lm_tables = lm.member_tables()
            self._K = len(lm.members)
        else:
            self.tables.update(lm.device_tables())
            self._lm_tables = None
            self._K = 1
        # split arc tables for overflow_tokens mode: first 3 slots
        # (self + 2) per node dense, the rare extra fan-out in compact
        # overflow rows
        at = np.asarray(tree.arc_tgt)
        alp = np.asarray(tree.arc_logp)
        N, A = at.shape
        live = alp > LOG_ZERO / 2
        tgt3 = np.zeros((N, 3), np.int32)
        lp3 = np.full((N, 3), LOG_ZERO, np.float32)
        over_rows = []
        over_map = np.full(N, -1, np.int32)
        max_over = 0
        over_data = []
        for n_ in range(N):
            arcs = [(int(at[n_, a]), float(alp[n_, a]))
                    for a in range(A) if live[n_, a]]
            # self-loop first so dense slot 0 is the duration hold
            arcs.sort(key=lambda x: (x[0] != n_,))
            for j, (tg, lp) in enumerate(arcs[:3]):
                tgt3[n_, j] = tg
                lp3[n_, j] = lp
            if len(arcs) > 3:
                over_map[n_] = len(over_data)
                over_data.append(arcs[3:])
                max_over = max(max_over, len(arcs) - 3)
        Ko = len(over_data)
        Ao = max(max_over, 1)
        o_tgt = np.zeros((Ko + 1, Ao), np.int32)
        o_lp = np.full((Ko + 1, Ao), LOG_ZERO, np.float32)
        for r, arcs in enumerate(over_data):
            for j, (tg, lp) in enumerate(arcs):
                o_tgt[r, j] = tg
                o_lp[r, j] = lp
        over_map[over_map < 0] = Ko
        self._num_over_rows = Ko
        self.tables.update({
            "tgt3": jnp.asarray(tgt3), "lp3": jnp.asarray(lp3),
            "over_map": jnp.asarray(over_map),
            "over_tgt": jnp.asarray(o_tgt),
            "over_lp": jnp.asarray(o_lp),
        })
        # pdf-composed arc-target tables: obs at candidate targets is
        # fetched as obs_t[pdfX] (shared-index gather — the batch rides
        # the minor dimension) followed by a small per-token ROW gather,
        # instead of one per-candidate scalar gather (fewer gather
        # indices; the share of the step on the H100 is not measured)
        pdf_np = np.asarray(tree.pdf, np.int32)
        self.tables.update({
            "pdf3": jnp.asarray(pdf_np[tgt3]),
            "pdf_over": jnp.asarray(pdf_np[o_tgt]),
            "pdf_root": jnp.asarray(
                pdf_np[np.maximum(np.asarray(tree.root_pair_tgt), 0)]),
            "pdf_arc": jnp.asarray(
                pdf_np[np.maximum(np.asarray(tree.arc_tgt), 0)]),
        })
        # ---- deduplicated obs composition tables (a profile of the
        # production step at 287k nodes, benchmarks/profile_step_ops.py,
        # on an earlier accelerator found the per-candidate obs_t[...]
        # scalar gathers index-bound; not measured on the H100).  The
        # pdf triples of tgt3
        # repeat heavily under state tying (U3/N = 23% at 37k nodes,
        # 13.5% at 123k, saturating), so obs at all DISTINCT triples
        # can be fetched once per frame as a shared-index gather
        # [U3, 3] (batch in the minor axis) followed by a [W] ROW gather
        # — index count drops 3x and the shared gather is
        # bandwidth-, not index-bound.  Exact: same elements, same
        # values.  Pays off iff U3 stays well under ~56 tokens' worth
        # of compose-gather indices per token; threshold 48*W is
        # conservative.
        self._tri = False
        tri_id = None
        if self._obs_compose:
            u3, tri_id = np.unique(pdf_np[tgt3], axis=0,
                                   return_inverse=True)
            if u3.shape[0] <= 48 * config.num_tokens:
                self.tables["pdf_tri"] = jnp.asarray(
                    u3.astype(np.int32))
                self._tri = True
        # overflow rows likewise dedup (same two-step trick); shared
        # wins iff Uo < ~78 * O rows (O = overflow slice width)
        self._over_shared = False
        if config.overflow_tokens:
            po_u, o_uid = np.unique(pdf_np[o_tgt], axis=0,
                                    return_inverse=True)
            O_ = min(config.overflow_tokens, config.num_tokens)
            if po_u.shape[0] <= 64 * O_:
                self.tables["pdf_over_u"] = jnp.asarray(
                    po_u.astype(np.int32))
                self.tables["over_uid"] = jnp.asarray(
                    o_uid.astype(np.int32))
                self._over_shared = True
        # LM states must fit exact f32 values for the we_prewalk
        # payload packing (they ride a packed f32 row gather)
        ns = ([m.num_states for m in lm.members]
              if isinstance(lm, InterNGramFsa) else [lm.num_states])
        self._state_f32_ok = max(ns) < 2 ** 24
        # compact re-entry tables (reentry_topk): entry-node union +
        # factored pair membership, exactly the dense engine's re-entry
        # space (search_dense.DenseBeamSearch.__init__)
        self._reentry_topk = 0
        if config.reentry_topk and self._state_f32_ok:
            pt = np.asarray(tree.root_pair_tgt)
            plp = np.asarray(tree.root_pair_logp)
            valid_rows = plp > LOG_ZERO / 2
            ent = np.unique(pt[valid_rows])
            NP = pt.shape[0]
            NC, NR = tree.num_classes, tree.num_rcsets
            usable = (NP == NC * NR and len(ent) > 0
                      and not np.any(plp[valid_rows] != 0.0))
            if usable:
                M = len(ent)
                node_to_entry = np.full(tree.num_nodes, M, np.int32)
                node_to_entry[ent] = np.arange(M, dtype=np.int32)
                member = np.zeros((NP, M), bool)
                rp, rr = np.nonzero(valid_rows)
                member[rp, node_to_entry[pt[rp, rr]]] = True
                m3 = member.reshape(NC, NR, M)
                left = m3.any(axis=1)
                first = m3.any(axis=0)
                usable = np.array_equal(
                    left[:, None, :] & first[None, :, :], m3)
            if usable:
                self._reentry_topk = int(config.reentry_topk)
                self._NCm, self._NRm = NC, NR
                self._ent_nodes_np = ent
                self.tables.update({
                    "ent_node": jnp.asarray(ent.astype(np.int32)),
                    "ent_pdf": jnp.asarray(pdf_np[ent]),
                    "ent_left": jnp.asarray(left.astype(np.float32)),
                    "ent_first": jnp.asarray(first.astype(np.float32)),
                })
            else:
                import sys
                print("BeamSearch: reentry_topk unavailable for this "
                      "tree (non-factored or non-zero entry probs); "
                      "using the full [E, R] expansion",
                      file=sys.stderr)
        # pruning-extension tables (built only when a beam is on)
        self._WCB = 200                 # MAX_WC_COUNT buckets
        if config.eq_depth_beam:
            # node depth = BFS distance (in HMM states) from the word-
            # entry nodes over in-word arcs; depth/2 buckets like the
            # reference's m_depth_llh (TokenPassSearch.cc:1092)
            from collections import deque
            at = np.asarray(tree.arc_tgt)
            alp = np.asarray(tree.arc_logp)
            depth = np.full(tree.num_nodes, -1, np.int64)
            q = deque()
            for n0 in np.unique(np.asarray(tree.root_pair_tgt)[
                    np.asarray(tree.root_pair_logp) > LOG_ZERO / 2]):
                depth[n0] = 0
                q.append(int(n0))
            while q:
                u = q.popleft()
                for a in range(at.shape[1]):
                    v = int(at[u, a])
                    if alp[u, a] > LOG_ZERO / 2 and v != u \
                            and depth[v] < 0:
                        depth[v] = depth[u] + 1
                        q.append(v)
            depth[depth < 0] = 0
            d2 = (depth // 2).astype(np.int32)
            self._DB = int(d2.max()) + 1
            self.tables["depth2"] = jnp.asarray(d2)
        if ((config.fan_in_beam or config.fan_out_beam
             or config.tp_state_beam or config.eq_depth_beam
             or config.eq_word_count_beam)
                and tree.fan_flags is not None):
            self.tables["fanflag"] = jnp.asarray(
                np.asarray(tree.fan_flags, np.int32))
        # fused (node, lm) sort key when the product space fits int32
        S_lm = int(getattr(lm, "num_states", 0) or 0)
        self._fused_sort_key = 0
        if self._K == 1 and S_lm > 0 and \
                tree.num_nodes * S_lm < 2**31 - 1:
            self._fused_sort_key = S_lm
        self._init_pair = int(tree.init_pair)
        self._la_on = bool(config.lm_lookahead)
        self._la_bigram = False
        self._la_ctx = False
        if self._la_on:
            la_lm = lookahead_lm or (
                lm.members[0] if isinstance(lm, InterNGramFsa) else lm)
            V = la_lm.num_words
            if (config.lm_lookahead >= 3 and self._K == 1
                    and (lookahead_lm is None or lookahead_lm is lm)):
                # context (>= trigram) lookahead: the token's FSA state
                # is its word history (get_lm_trigram_lookahead,
                # TokenPassSearch.cc:2084); falls back to the bigram
                # table for non-nesting trees / over-budget lists
                la_ids = [lm.word_index.get(w, -1) for w in la_first]
                ctx = context_lookahead_tables(tree, lm, la_ids)
                if ctx is not None:
                    self._la_ctx = True
                    self._la_levels = max(lm.order - 1, 1)
                    la1 = unigram_lookahead(tree, la_lm, la_first)
                    self.tables["la"] = jnp.asarray(la1)
                    for k in ("la_pos", "la_sc", "la_bo", "la_bnext"):
                        self.tables[k] = jnp.asarray(ctx[k])
                    lo, hi = ctx["la_lo"], ctx["la_hi"]
                    rt = np.maximum(np.asarray(tree.root_pair_tgt), 0)
                    at_c = np.maximum(np.asarray(tree.arc_tgt), 0)
                    self.tables.update({
                        "laov_lo": jnp.asarray(lo[o_tgt]),
                        "laov_hi": jnp.asarray(hi[o_tgt]),
                        "laov_1": jnp.asarray(la1[o_tgt]),
                        "lart_lo": jnp.asarray(lo[rt]),
                        "lart_hi": jnp.asarray(hi[rt]),
                        "lart_1": jnp.asarray(la1[rt]),
                        "laarc_lo": jnp.asarray(lo[at_c]),
                        "laarc_hi": jnp.asarray(hi[at_c]),
                        "laarc_1": jnp.asarray(la1[at_c]),
                    })
                    if self._reentry_topk:
                        ent = self._ent_nodes_np
                        self.tables.update({
                            "laent_lo": jnp.asarray(lo[ent]),
                            "laent_hi": jnp.asarray(hi[ent]),
                            "laent_1": jnp.asarray(la1[ent]),
                        })
                    self._ctx_iv = (lo, hi, la1)
                elif config.lm_lookahead >= 3:
                    import sys
                    print("BeamSearch: context lookahead unavailable "
                          "for this tree/LM; falling back",
                          file=sys.stderr)
            if (not self._la_ctx and config.lm_lookahead >= 2
                    and (V + 1) * tree.num_nodes * 4 <= 512_000_000):
                self._la_bigram = True
                self.tables["la2"] = jnp.asarray(
                    bigram_lookahead(tree, la_lm, la_first))
                # tree word id -> lookahead-LM row (V = no-context
                # row); multiword context = its LAST component
                # (TokenPassSearch.cc:1872)
                self.tables["la_wid"] = jnp.asarray(np.asarray(
                    [la_lm.word_index.get(w, V) for w in la_last]
                    or [V], dtype=np.int32))
                self._la_init_row = la_lm.word_index.get("<s>", V)
            elif not self._la_ctx:
                if config.lm_lookahead >= 2:
                    import sys
                    print("BeamSearch: bigram lookahead table over "
                          "budget; falling back to unigram",
                          file=sys.stderr)
                self.tables["la"] = jnp.asarray(unigram_lookahead(
                    tree, la_lm, la_first))
        # ---- static re-entry preselect (SearchConfig.reentry_preselect)
        self._reentry_pre = 0
        RPre = int(config.reentry_preselect or 0)
        R_full = int(np.asarray(tree.root_pair_tgt).shape[1])
        if RPre and RPre <= R_full and not self._reentry_topk:
            if config.reentry_prewalk:
                RPre = max(RPre, int(config.reentry_prewalk))
            pt = np.asarray(tree.root_pair_tgt)
            plp = np.asarray(tree.root_pair_logp)
            static = plp.astype(np.float64).copy()
            # live entry log-probs are ZERO by builder invariant (see
            # reentry_topk), so the static discriminator is the best
            # unigram LM score reachable through each entry's subtree
            # — the same quantity unigram lookahead ranks with.  When
            # lookahead is off, compute it here for ranking only.
            if self._la_on and not (self._la_bigram or self._la_ctx):
                la_np = np.asarray(self.tables["la"])
            else:
                la_lm0 = (lm.members[0]
                          if isinstance(lm, InterNGramFsa) else lm)
                la_np = np.asarray(
                    unigram_lookahead(tree, la_lm0, la_first))
            static = static + config.lm_scale_eff * la_np[
                np.maximum(pt, 0)]
            static[plp <= LOG_ZERO / 2] = -np.inf
            sel = np.argsort(-static, axis=1, kind="stable")[:, :RPre]
            tk = lambda a: np.take_along_axis(a, sel, axis=1)
            pt_pre = tk(pt)
            self.tables.update({
                "root_tgt_pre": jnp.asarray(pt_pre),
                "root_logp_pre": jnp.asarray(tk(plp)),
                "pdf_root_pre": jnp.asarray(
                    pdf_np[np.maximum(pt_pre, 0)]),
            })
            if self._la_ctx:
                lo, hi, la1 = self._ctx_iv
                rt_pre = np.maximum(pt_pre, 0)
                self.tables.update({
                    "lart_lo_pre": jnp.asarray(lo[rt_pre]),
                    "lart_hi_pre": jnp.asarray(hi[rt_pre]),
                    "lart_1_pre": jnp.asarray(la1[rt_pre]),
                })
            self._reentry_pre = RPre
        # ---- row-packed per-node step table: ONE contiguous row
        # gather per token per step replaces ~6 separate per-token
        # scalar gathers (a gather costs per INDEX more than per byte,
        # so packed row fetches amortize; ints travel as f32 values)
        lm_id_np = np.asarray(self.tables["lm_id"])
        we_word_np = np.asarray(tree.we_word, np.int32)
        we_lmid = np.where(we_word_np >= 0,
                           lm_id_np[np.maximum(we_word_np, 0)], -1)
        _pk_cols: list = []
        self._pk: dict = {}

        def _pk_add(name, arr, bits=False):
            a = np.asarray(arr)
            if bits:
                # int columns ride as exact f32 VALUES (all ids are
                # < 2^24), not bit views: small-int bit patterns are
                # f32 denormals, which float paths may flush to 0
                assert np.abs(a.astype(np.int64)).max() < 2**24, name
            a = a.astype(np.float32)
            if a.ndim == 1:
                a = a[:, None]
            self._pk[name] = (sum(c.shape[1] for c in _pk_cols),
                              a.shape[1])
            _pk_cols.append(a)

        _pk_add("tgt3", tgt3, bits=True)
        _pk_add("lp3", lp3)
        _pk_add("over_map", over_map, bits=True)
        if self._tri:
            # unique-pdf-triple id: rides the pack (row gathers are
            # index-bound, an extra column is ~free)
            _pk_add("tri_id", tri_id.astype(np.int32), bits=True)
        _pk_add("we_pair", tree.we_pair, bits=True)
        if self._has_durations:
            # gather-free gamma duration params (the dense engine's
            # proven trick): the [W]-token dur_tab gather was ~13% of
            # the step (XLA trace); four extra pack columns are ~free
            # (row gathers are INDEX-bound, not width-bound)
            dp = node_duration_params(
                tree, model, config.duration_scale)
            _pk_add("dur_valid", dp["dur_valid"])
            _pk_add("dur_lncoef", dp["dur_lncoef"])
            _pk_add("dur_invb", dp["dur_invb"])
            _pk_add("dur_const", dp["dur_const"])
        _pk_add("we_word", we_word_np, bits=True)
        _pk_add("we_exit", tree.we_exit_logp)
        _pk_add("we_pron", tree.we_pron_logp)
        _pk_add("we_skip", np.asarray(tree.we_skip_lm, np.int32),
                bits=True)
        _pk_add("we_lmid", we_lmid, bits=True)
        _pk_add("we_uni", np.where(
            we_word_np >= 0,
            self._uni_est[np.maximum(we_word_np, 0)], 0.0))
        if self._la_bigram:
            la_wid_np = np.asarray(self.tables["la_wid"])
            V_la = int(self.tables["la2"].shape[0]) - 1
            _pk_add("we_law",
                    np.where(we_word_np >= 0,
                             la_wid_np[np.maximum(we_word_np, 0)],
                             V_la), bits=True)
        if self._la_ctx:
            # DFS intervals + unigram base at the dense arc targets
            lo, hi, la1 = self._ctx_iv
            _pk_add("la_lo3", lo[tgt3], bits=True)
            _pk_add("la_hi3", hi[tgt3], bits=True)
            _pk_add("la1_3", la1[tgt3])
        self._pk_width = sum(c.shape[1] for c in _pk_cols)
        self.tables["step_pack"] = jnp.asarray(
            np.concatenate(_pk_cols, axis=1))
        # device tables pass through jit as ARGUMENTS (closed-over
        # arrays would embed as HLO constants and bloat the program
        # with production-LM tables — same as the dense searcher)
        def _split(d):
            dev = {k: v for k, v in d.items()
                   if hasattr(v, "dtype") and getattr(v, "ndim", 0) > 0}
            return dev, {k: v for k, v in d.items() if k not in dev}

        self._dev_t, self._static_t = _split(self.tables)
        if self._lm_tables is not None:
            pairs = [_split(tab) for tab in self._lm_tables]
            self._dev_lm = [p[0] for p in pairs]
            self._static_lm = [p[1] for p in pairs]
        else:
            self._dev_lm = None
            self._static_lm = None

        def _bound(o, n, li, dev_t, dev_lm, lattice=True):
            t = {**self._static_t, **dev_t}
            lms_ = (None if dev_lm is None else
                    [{**st, **dv} for st, dv
                     in zip(self._static_lm, dev_lm)])
            return self._decode(o, n, li, t, lms_, lattice=lattice)

        self._bound_decode = _bound
        self._decode_jit = jax.jit(_bound, static_argnames=())

    # -- candidate container: dict of parallel arrays ---------------------
    def _walk(self, states, word, t, lm_tables):
        """(states [..., K], word [...]) -> (next [..., K], score)."""
        if lm_tables is not None:
            return lm_walk_device_multi(self.lm, lm_tables,
                                        states, word)
        nxt, sc = lm_walk_device(t, self.lm.num_words,
                                 self.lm.order, states[..., 0], word)
        return nxt[..., None], sc

    def _step(self, tokens, obs_t, step_idx, t, lm_tables):
        # obs_t is the raw [S] frame log-probs: candidate obs comes
        # from pdf-composed shared-index gathers (obs_t[pdf3] etc. —
        # batch in the minor axis) + small per-token ROW gathers
        # instead of a flat per-candidate gather.
        cfg = self.config
        W = cfg.num_tokens
        E = cfg.num_records
        K = self._K
        node, lmst, am, lms, dur, rec, alive, law, wc = tokens

        # ---- 0. packed row gathers per token: ONE static [N, P] row
        # gather for the per-node step tables, plus this frame's obs
        # at the dense arc targets through [N, 3] pdf-composed
        # shared-index gathers.  Fetching obs via a SEPARATE row
        # gather from [B, N, 3] beats concatenating it into the pack:
        # the concat materializes a [B, N, P+3] array every frame
        # and the combined gather then reads from the 340 MB batched
        # source instead of the 2 MB static table.
        pk = t["step_pack"][node]                  # [W, P] static rows

        def pcol(name, ints=False):
            s, w = self._pk[name]
            v = jax.lax.slice_in_dim(pk, s, s + w, axis=1)
            return v.astype(jnp.int32) if ints else v

        if self._tri:
            # large trees: shared-index gather at the DISTINCT pdf
            # triples (bandwidth-bound, U3 << N), then one [W] row
            # gather by packed triple id — 3x fewer gather indices
            # than the per-candidate compose below
            obs_tri = obs_t[t["pdf_tri"]]          # [U3, 3] shared
            obs1 = obs_tri[pcol("tri_id", True)[:, 0]]   # [W, 3] rows
        elif self._obs_compose:
            # large trees: gather the static pdf rows at the tokens,
            # then obs singles — skips the [N, 3, B] materialization
            obs1 = obs_t[t["pdf3"][node]]          # [W, 3] composed
        else:
            obs3 = obs_t[t["pdf3"]]                # [N, 3] shared-index
            obs1 = obs3[node]                      # [W, 3] row gather
        if self._has_durations:
            # gamma bonus from packed per-node params — elementwise
            # work instead of a dur_tab[ds, d-1] gather
            d_ = jnp.clip(dur + 1, 1, cfg.max_dur).astype(jnp.float32)
            durb_tok = pcol("dur_valid")[:, 0] * (
                pcol("dur_lncoef")[:, 0] * jnp.log(d_)
                - d_ * pcol("dur_invb")[:, 0]
                + pcol("dur_const")[:, 0])         # [W], reused below
        else:
            durb_tok = jnp.zeros(node.shape, jnp.float32)

        # context lookahead (mode 3): per-token backoff-level lists,
        # joined with target DFS intervals (see
        # context_lookahead_tables).  Ranking/pruning only: stored
        # am/lms stay pure, and la depends exactly on the (node, lm)
        # recombination key, so within-key order is unchanged.
        la_parts = []
        if self._la_ctx:
            lev_tok = []
            acc = jnp.zeros((W,), jnp.float32)
            cur = lmst[:, 0]
            for _ in range(self._la_levels):
                lev_tok.append((t["la_pos"][cur], t["la_sc"][cur],
                                acc))
                acc = acc + t["la_bo"][cur]
                cur = t["la_bnext"][cur]
            la_acc0 = acc

            def ctx_la(lev, base_acc, lo_x, hi_x, la1_x):
                best = base_acc[:, None] + la1_x
                for pos, sc, a in lev:
                    m = ((pos[:, None, :] >= lo_x[..., None])
                         & (pos[:, None, :] < hi_x[..., None]))
                    v = jnp.max(
                        jnp.where(m, sc[:, None, :], -jnp.inf),
                        axis=-1)
                    best = jnp.maximum(best, a[:, None] + v)
                return best

        # ---- 1. in-word expansion
        def expand(sel_node, sel_tok, a_tgt, a_lp, allow_self, durb_s):
            """candidates from arc tables gathered per selected token:
            payloads broadcast from token index sel_tok."""
            shape = a_tgt.shape
            is_self = allow_self & (a_tgt == sel_node[:, None])
            durb = durb_s[:, None]
            durp = jnp.where(is_self, 0.0, durb)
            c = {
                "node": a_tgt,
                "lm": jnp.broadcast_to(lmst[sel_tok][:, None, :],
                                       shape + (K,)),
                "am": (am[sel_tok][:, None]
                       + cfg.transition_scale_eff * a_lp + durp),
                "lms": jnp.broadcast_to(lms[sel_tok][:, None], shape),
                "dur": jnp.where(is_self, dur[sel_tok][:, None] + 1, 0),
                "rec": jnp.broadcast_to(rec[sel_tok][:, None], shape),
                "alive": (alive[sel_tok][:, None]
                          & (a_lp > LOG_ZERO / 2)),
                "law": jnp.broadcast_to(law[sel_tok][:, None], shape),
                "wc": jnp.broadcast_to(wc[sel_tok][:, None], shape),
            }
            return {k: (v.reshape(-1, K) if k == "lm"
                        else v.reshape(-1)) for k, v in c.items()}

        all_tok = jnp.arange(W, dtype=jnp.int32)
        if cfg.overflow_tokens:
            # dense [W, 3] slots cover every node with fan <= 3; the
            # rare branch fan-out expands only for the top-O tokens
            # sitting at branch nodes (exact when O covers them all)
            c1 = expand(node, all_tok, pcol("tgt3", True),
                        pcol("lp3"), True, durb_tok)
            c1["am"] = c1["am"] + obs1.reshape(-1)
            if self._la_ctx:
                la_parts.append(ctx_la(
                    lev_tok, la_acc0, pcol("la_lo3", True),
                    pcol("la_hi3", True), pcol("la1_3")).reshape(-1))
            O = min(cfg.overflow_tokens, W)
            orow = pcol("over_map", True)[:, 0]         # [W]
            is_branch = alive & (orow < self._num_over_rows)
            rank = jnp.where(is_branch,
                             am + cfg.lm_scale_eff * lms, -jnp.inf)
            _, sel_o = jax.lax.top_k(rank, O)
            o_row = orow[sel_o]
            c1b = expand(node[sel_o], sel_o, t["over_tgt"][o_row],
                         t["over_lp"][o_row], False, durb_tok[sel_o])
            if self._over_shared:
                # shared-index gather at the DISTINCT overflow pdf
                # rows, then [O] row gathers (exact; fewer gather
                # indices than the per-candidate compose)
                obs_ov = obs_t[t["pdf_over_u"]][t["over_uid"][o_row]]
            elif self._obs_compose:
                obs_ov = obs_t[t["pdf_over"][o_row]]
            else:
                obs_ov = obs_t[t["pdf_over"]][o_row]
            c1b["am"] = c1b["am"] + obs_ov.reshape(-1)
            c1b["alive"] = c1b["alive"] & jnp.repeat(
                jnp.take(is_branch, sel_o), t["over_tgt"].shape[1])
            if self._la_ctx:
                lev_o = [(p[sel_o], s[sel_o], a[sel_o])
                         for p, s, a in lev_tok]
                la_parts.append(ctx_la(
                    lev_o, la_acc0[sel_o], t["laov_lo"][o_row],
                    t["laov_hi"][o_row],
                    t["laov_1"][o_row]).reshape(-1))
            c1 = {k: jnp.concatenate([c1[k], c1b[k]]) for k in c1}
        else:
            c1 = expand(node, all_tok, t["arc_tgt"][node],
                        t["arc_logp"][node], True, durb_tok)
            c1["am"] = c1["am"] + (
                obs_t[t["pdf_arc"][node]] if self._obs_compose
                else obs_t[t["pdf_arc"]][node]).reshape(-1)
            if self._la_ctx:
                la_parts.append(ctx_la(
                    lev_tok, la_acc0, t["laarc_lo"][node],
                    t["laarc_hi"][node],
                    t["laarc_1"][node]).reshape(-1))

        # ---- 2. word ends [W, H] -> (prewalk top-E2) -> LM walk ->
        #         records [E] -> root arcs [E, R]
        w_word = pcol("we_word", True)                  # [W, H]
        w_exit = pcol("we_exit")
        w_pron = pcol("we_pron")
        w_skip = pcol("we_skip", True).astype(bool)
        w_alive = alive[:, None] & (w_exit > LOG_ZERO / 2)
        w_lmid = pcol("we_lmid", True)                  # [W, H]
        skip = w_skip | (w_word < 0)
        # words missing from the LM are pruned (lm_id < 0)
        w_alive = w_alive & (skip | (w_lmid >= 0))
        we_am = (am[:, None] + cfg.transition_scale_eff * w_exit
                 + durb_tok[:, None])
        base_lms = (lms[:, None] + w_pron
                    + jnp.where(skip, 0.0, cfg.insertion_penalty_eff))
        if self._la_bigram:
            # row for the next word's lookahead: the just-committed
            # word, or the previous row across silences/OOLs (packed
            # we_law stores la_wid[word], with the V sentinel for
            # silences and words outside the lookahead LM)
            w_law_prev = jnp.broadcast_to(law[:, None], w_word.shape)
            wid = pcol("we_law", True)
            Vla = t["la2"].shape[0] - 1
            w_law = jnp.where(wid < Vla, wid, w_law_prev)
        else:
            w_law = jnp.broadcast_to(law[:, None], w_word.shape)
        H = w_word.shape[1]
        WH = w_word.shape[0] * H
        E2 = min(cfg.we_prewalk, WH) if cfg.we_prewalk else WH
        E2 = max(E2, E)

        def _mw_walk(states, words, lmids):
            if self._mw_cmax == 1:
                return self._walk(states, jnp.maximum(lmids, 0), t,
                                  lm_tables)
            # multiword split: walk each component in sequence
            # (split_and_compute_ngram_score,
            # TokenPassSearch.cc:1818-1843)
            comp = t["mw_comp"][jnp.maximum(words, 0)]
            return walk_components(
                lambda st, wd: self._walk(st, wd, t, lm_tables),
                states, comp)

        if E2 < WH and self._state_f32_ok:
            # rank word ends by a static unigram LM estimate and run
            # the exact FSA walk only on the top-E2 (the walk at W*H
            # is ~1/3 of the step); payload rides ONE packed row
            # gather (exact f32 values, all ids < 2^24)
            pre = we_am + cfg.lm_scale_eff * (
                base_lms + jnp.where(skip, 0.0, pcol("we_uni")))
            flat_pre = jnp.where(w_alive, pre, -jnp.inf).reshape(-1)
            _, ord2 = jax.lax.top_k(flat_pre, E2)
            f32 = lambda x: x.astype(jnp.float32)
            pay = jnp.stack(
                [f32(w_word), we_am, base_lms, f32(skip), f32(w_alive),
                 jnp.broadcast_to(f32(pcol("we_pair", True)),
                                  w_word.shape),
                 f32(w_law),
                 jnp.broadcast_to(f32(rec[:, None]), w_word.shape),
                 f32(w_lmid),
                 jnp.broadcast_to(f32(wc[:, None]), w_word.shape)]
                + [jnp.broadcast_to(f32(lmst[:, None, k]),
                                    w_word.shape) for k in range(K)],
                axis=-1).reshape(WH, -1)
            got2 = pay[ord2]                           # [E2, 10+K]
            i32 = lambda x: x.astype(jnp.int32)
            s_word = i32(got2[:, 0])
            s_am = got2[:, 1]
            s_base = got2[:, 2]
            s_skip = got2[:, 3] > 0.5
            s_alive = got2[:, 4] > 0.5
            s_pair = i32(got2[:, 5])
            s_law = i32(got2[:, 6])
            s_prev = i32(got2[:, 7])
            s_lmid = i32(got2[:, 8])
            s_wc = i32(got2[:, 9])
            s_state = i32(got2[:, 10:10 + K])
        else:
            E2 = WH
            s_word = w_word.reshape(-1)
            s_am = we_am.reshape(-1)
            s_base = base_lms.reshape(-1)
            s_skip = skip.reshape(-1)
            s_alive = w_alive.reshape(-1)
            s_pair = jnp.broadcast_to(pcol("we_pair", True),
                                      w_word.shape).reshape(-1)
            s_law = w_law.reshape(-1)
            s_prev = jnp.broadcast_to(rec[:, None],
                                      w_word.shape).reshape(-1)
            s_lmid = w_lmid.reshape(-1)
            s_wc = jnp.broadcast_to(wc[:, None],
                                    w_word.shape).reshape(-1)
            s_state = jnp.broadcast_to(
                lmst[:, None, :], w_word.shape + (K,)).reshape(-1, K)

        lm_next, lm_score = _mw_walk(s_state, s_word, s_lmid)
        lm_next = jnp.where(s_skip[:, None], s_state, lm_next)
        lm_score = jnp.where(s_skip, 0.0, lm_score)
        we_lms2 = s_base + lm_score
        we_alive2 = s_alive & (lm_score > LOG_ZERO / 2)
        if self._wb_tid >= 0:
            # morph mode: prune two subsequent word boundaries (the
            # previous committed word ends the LM-state context,
            # TokenPassSearch.cc:869-873) ...
            prev_wb = t["is_wb_state"][s_state[:, 0]]
            we_alive2 = we_alive2 & ~((s_word == self._wb_tid)
                                      & prev_wb)
            # ... and a mid-utterance sentence end restarts the LM
            # through <s> + boundary, scores discarded
            # (TokenPassSearch.cc:888-919)
            if self._end_tid >= 0:
                lm_next = jnp.where((s_word == self._end_tid)[:, None],
                                    t["wb_reset"][None, :], lm_next)
        we_total2 = s_am + cfg.lm_scale_eff * we_lms2

        if cfg.word_end_beam:
            # word-end beam: prune vs the frame's best word end
            # (TokenPassSearch.cc:1076-1081 NODE_USE_WORD_END_BEAM)
            we_best = jnp.max(jnp.where(we_alive2, we_total2,
                                        -jnp.inf))
            we_alive2 = we_alive2 & (
                we_total2 >= we_best - cfg.word_end_beam)

        # compact word-end candidates into E record slots (best first);
        # with a candidate pool smaller than E (tiny W), take the whole
        # pool and leave the remaining record slots dead
        flat_total = jnp.where(we_alive2, we_total2, -jnp.inf)
        k = min(E, int(flat_total.shape[0]))
        _, order = jax.lax.top_k(flat_total, k)         # top-E word ends
        e_alive = jnp.take(we_alive2, order)
        if k < E:
            order = jnp.concatenate(
                [order, jnp.zeros(E - k, order.dtype)])
            e_alive = jnp.concatenate(
                [e_alive, jnp.zeros(E - k, bool)])
        e_word = jnp.take(s_word, order)
        e_prev = jnp.take(s_prev, order)
        e_lm = jnp.take(lm_next, order, axis=0)
        e_am = jnp.take(s_am, order)
        e_lms = jnp.take(we_lms2, order)
        e_pair = jnp.take(s_pair, order)
        e_law = jnp.take(s_law, order)
        e_wc = jnp.take(s_wc, order)
        # records: silence (word<0) keeps its previous record pointer;
        # pointers are globally unique: step_idx * E + slot.  Cumulative
        # am/lm scores ride along for lattice (SLF) construction.
        is_word = e_alive & (e_word >= 0)
        rec_word = jnp.where(e_alive, e_word, -1)
        rec_prev = jnp.where(is_word, e_prev, -1)
        rec_am = jnp.where(is_word, e_am, 0.0)
        rec_lms = jnp.where(is_word, e_lms, 0.0)
        slot_ptr = step_idx * E + jnp.arange(E, dtype=jnp.int32)
        new_rec = jnp.where(is_word, slot_ptr, e_prev)

        # re-entry record set: records are compacted best-first, so
        # the reference's word-end hypothesis limit is a slice
        # (reentry_records); all E records above were already written
        Er = (min(cfg.reentry_records, E) if cfg.reentry_records
              else E)
        # committed-word count for re-entering hypotheses (silence and
        # OOL word ends do not increment, TokenPassSearch word_count)
        e_wc2 = e_wc + (e_word >= 0).astype(jnp.int32)
        if Er < E:
            _sl = lambda x: jax.lax.slice_in_dim(x, 0, Er, axis=0)
            e_alive, e_lm, e_am, e_lms, e_pair, e_law, e_wc2 = (
                _sl(e_alive), _sl(e_lm), _sl(e_am), _sl(e_lms),
                _sl(e_pair), _sl(e_law), _sl(e_wc2))
            re_rec = _sl(new_rec)
        else:
            re_rec = new_rec

        if self._la_ctx:
            # re-entry candidates rank in the POST-commit context
            lev_e = []
            acc_e = jnp.zeros((Er,), jnp.float32)
            cur_e = e_lm[:, 0]
            for _ in range(self._la_levels):
                lev_e.append((t["la_pos"][cur_e], t["la_sc"][cur_e],
                              acc_e))
                acc_e = acc_e + t["la_bo"][cur_e]
                cur_e = t["la_bnext"][cur_e]

        if self._reentry_topk:
            # compact re-entry: entry log-probs are zero, so candidate
            # score = record_total + obs[entry node] — per entry node
            # the record ranking is the GLOBAL total ranking masked by
            # pair membership.  Keep the top-K2 records per node,
            # computed in [E, M] space; payloads follow each winner
            # through one packed [M]-row gather (all values exact f32).
            K2 = self._reentry_topk
            Ment = t["ent_node"].shape[0]
            e_total = jnp.where(e_alive,
                                e_am + cfg.lm_scale_eff * e_lms, -jnp.inf)
            NRm = self._NRm
            oh_cls = ((e_pair // NRm)[:, None] ==
                      jnp.arange(self._NCm, dtype=jnp.int32)).astype(
                          jnp.float32)                  # [E, NC]
            oh_rc = ((e_pair % NRm)[:, None] ==
                     jnp.arange(NRm, dtype=jnp.int32)).astype(
                         jnp.float32)                   # [E, NR]
            avail = ((oh_cls @ t["ent_left"])
                     * (oh_rc @ t["ent_first"])) > 0.5  # [E, M]
            obs_m = obs_t[t["ent_pdf"]]                 # [M] shared-idx
            paypk = jnp.stack(
                [e_am, e_lms, re_rec.astype(jnp.float32),
                 e_law.astype(jnp.float32)]
                + [e_lm[:, k].astype(jnp.float32) for k in range(K)]
                + [e_wc2.astype(jnp.float32)],
                axis=-1)                                # [Er, 5+K]
            c2_parts = []
            la2_parts = []
            for _j in range(K2):
                enter = jnp.where(avail, e_total[:, None], -jnp.inf)
                win = jnp.argmax(enter, axis=0)         # [M]
                okm = jnp.max(enter, axis=0) > LOG_ZERO / 2
                avail = avail & (jnp.arange(Er,
                                            dtype=jnp.int32)[:, None]
                                 != win[None, :])
                got = jnp.take(paypk, win, axis=0)      # [M, 5+K]
                c2_parts.append({
                    "node": t["ent_node"],
                    "lm": got[:, 4:4 + K].astype(jnp.int32),
                    "am": got[:, 0] + obs_m,
                    "lms": got[:, 1],
                    "dur": jnp.zeros((Ment,), jnp.int32),
                    "rec": got[:, 2].astype(jnp.int32),
                    "alive": okm,
                    "law": got[:, 3].astype(jnp.int32),
                    "wc": got[:, 4 + K].astype(jnp.int32),
                })
                if self._la_ctx:
                    lev_w = [(jnp.take(p, win, axis=0),
                              jnp.take(s2, win, axis=0),
                              jnp.take(a3, win))
                             for p, s2, a3 in lev_e]
                    la2_parts.append(ctx_la(
                        lev_w, jnp.take(acc_e, win),
                        t["laent_lo"][:, None], t["laent_hi"][:, None],
                        t["laent_1"][:, None]).reshape(-1))
            c2 = {k: jnp.concatenate([p[k] for p in c2_parts],
                                     axis=0)
                  for k in c2_parts[0]}
            if self._la_ctx:
                la_parts.append(jnp.concatenate(la2_parts))
        else:
            # full re-entry through the word end's context row [E, R]
            # (cross-word fan-in: silence/monophone trees have one
            # row); with reentry_preselect the row is the statically
            # preselected top-P slice, so the obs gather — the largest
            # single op at production scale — shrinks R/P-fold
            pre = "_pre" if self._reentry_pre else ""
            r_tgt = t["root_tgt" + pre][e_pair]         # [Er, R|P]
            r_lp = t["root_logp" + pre][e_pair]
            # two-step always: shared-index gather over the full
            # static [Rp, R|P] pdf table (bandwidth-bound), then [Er]
            # ROW gathers.  The two-step form issues fewer gather
            # indices whenever Rp < ~158*Er, i.e. always in practice
            # (its time on the H100 is not measured).
            obs2 = obs_t[t["pdf_root" + pre]][e_pair]
            R = r_tgt.shape[1]
            la_c2 = None
            if self._la_ctx:
                la_c2 = ctx_la(
                    lev_e, acc_e, t["lart_lo" + pre][e_pair],
                    t["lart_hi" + pre][e_pair],
                    t["lart_1" + pre][e_pair]).reshape(-1)
            RK = (min(cfg.reentry_prewalk, R)
                  if cfg.reentry_prewalk else 0)
            if RK and RK < R:
                # cross-word re-entry compaction: the [Er, R] fan-in
                # expansion is ~90% of the recombination sort's
                # candidate space on cross-word trees (R ~ 500).  A
                # re-entry candidate's score is row_total + r_lp +
                # obs2, and the row constant cancels WITHIN a row — so
                # each record's best RK entry nodes are found by a
                # cheap per-row top_k over (r_lp + obs2), ranked
                # exactly.  Same hypothesis-limiting role as the
                # reference's word-end beam
                # (TokenPassSearch.cc:1076-1081), but count-bounded
                # (shape-shrinking).  A flattened global top-K was
                # rejected: its [Er*R] sort costs about what the
                # recombination sorts save (measured on an earlier
                # accelerator; not on the H100).  Payloads stay row-
                # broadcast; only node/arc/obs ride take_along_axis
                # ([Er, RK] indices).
                rank2 = r_lp + obs2                     # [Er, R]
                if self._la_on and not (self._la_bigram
                                        or self._la_ctx):
                    # fold the node lookahead estimate into the
                    # RANKING only (bigram/context la rank without it:
                    # their tables key on (history, node) and the
                    # gather would dwarf the sort savings)
                    rank2 = rank2 + cfg.lm_scale_eff * t["la"][r_tgt]
                rank2 = jnp.where(r_lp > LOG_ZERO / 2, rank2, -jnp.inf)
                if RK <= 16:
                    # RK argmax+mask rounds instead of top_k: XLA
                    # lowers top_k over [Er, R~500] to a full sort
                    # (~5% of the step in the trace); RK passes of
                    # elementwise max over the same array are cheaper
                    # for small RK.  Same indices, same order.
                    colsR = jnp.arange(R, dtype=jnp.int32)
                    curR = rank2
                    idx_rounds = []
                    for _ in range(RK):
                        jbest = jnp.argmax(curR, axis=1)    # [Er]
                        idx_rounds.append(jbest)
                        curR = jnp.where(
                            colsR[None, :] == jbest[:, None],
                            -jnp.inf, curR)
                    idxr = jnp.stack(idx_rounds, axis=1)    # [Er, RK]
                else:
                    _, idxr = jax.lax.top_k(rank2, RK)      # [Er, RK]
                tal = lambda v: jnp.take_along_axis(v, idxr, axis=1)
                r_tgt2 = tal(r_tgt)
                r_lp2 = tal(r_lp)
                obs22 = tal(obs2)
                c2 = {
                    "node": r_tgt2,
                    "lm": jnp.broadcast_to(e_lm[:, None, :],
                                           (Er, RK, K)),
                    "am": e_am[:, None] + r_lp2 + obs22,
                    "lms": jnp.broadcast_to(e_lms[:, None], (Er, RK)),
                    "dur": jnp.zeros((Er, RK), jnp.int32),
                    "rec": jnp.broadcast_to(re_rec[:, None],
                                            (Er, RK)),
                    "alive": (jnp.broadcast_to(e_alive[:, None],
                                               (Er, RK))
                              & (r_lp2 > LOG_ZERO / 2)),
                    "law": jnp.broadcast_to(e_law[:, None], (Er, RK)),
                    "wc": jnp.broadcast_to(e_wc2[:, None], (Er, RK)),
                }
                c2 = {k: (v.reshape(-1, K) if k == "lm"
                          else v.reshape(-1))
                      for k, v in c2.items()}
                if la_c2 is not None:
                    la_parts.append(tal(
                        la_c2.reshape(Er, R)).reshape(-1))
            else:
                c2 = {
                    "node": r_tgt,
                    "lm": jnp.broadcast_to(e_lm[:, None, :],
                                           (Er, R, K)),
                    "am": e_am[:, None] + r_lp + obs2,
                    "lms": jnp.broadcast_to(e_lms[:, None], (Er, R)),
                    "dur": jnp.zeros((Er, R), jnp.int32),
                    "rec": jnp.broadcast_to(re_rec[:, None], (Er, R)),
                    "alive": (jnp.broadcast_to(e_alive[:, None],
                                               (Er, R))
                              & (r_lp > LOG_ZERO / 2)),
                    "law": jnp.broadcast_to(e_law[:, None], (Er, R)),
                    "wc": jnp.broadcast_to(e_wc2[:, None], (Er, R)),
                }
                c2 = {k: (v.reshape(-1, K) if k == "lm"
                          else v.reshape(-1))
                      for k, v in c2.items()}
                if la_c2 is not None:
                    la_parts.append(la_c2)

        cand = {k: jnp.concatenate([c1[k], c2[k]]) for k in c1}

        # ---- 3. beam + recombination + top-W (obs already folded
        # into each candidate group's am above)
        total = cand["am"] + cfg.lm_scale_eff * cand["lms"]
        if self._la_ctx:
            total = total + cfg.lm_scale_eff * jnp.concatenate(la_parts)
        elif self._la_bigram:
            total = total + cfg.lm_scale_eff * t["la2"][cand["law"],
                                                    cand["node"]]
        elif self._la_on:
            # pruning/ranking only: stored am/lms stay pure, and the
            # recombination key (node, lm) shares one la value, so
            # within-key order is unchanged (TokenPassSearch.hh:543
            # get_token_log_prob + lookahead)
            total = total + cfg.lm_scale_eff * t["la"][cand["node"]]
        total = jnp.where(cand["alive"], total, -jnp.inf)
        best = jnp.max(total)
        cand["alive"] = cand["alive"] & (total >= best - cfg.beam)

        # ---- pruning extensions (TokenPassSearch.cc:1083-1127):
        # bucket maxima computed over this frame's candidate set (the
        # reference uses previous-frame active-list maxima, cc:320-360
        # — a sequential-propagation necessity; same-frame maxima are
        # strictly tighter).  All off by default.
        pe_on = (cfg.eq_depth_beam or cfg.eq_word_count_beam
                 or cfg.fan_in_beam or cfg.fan_out_beam
                 or cfg.tp_state_beam)
        if pe_on:
            atot = jnp.where(cand["alive"], total, -jnp.inf)
            ff = (t["fanflag"][cand["node"]] if "fanflag" in t
                  else jnp.zeros_like(cand["node"]))
            is_fan = ff > 0
        if cfg.eq_depth_beam and "depth2" in t:
            db = t["depth2"][cand["node"]]
            dmax = jnp.full((self._DB,), -jnp.inf).at[db].max(atot)
            keep = (total >= dmax[db] - cfg.eq_depth_beam) | is_fan
            cand["alive"] = cand["alive"] & keep
        if cfg.eq_word_count_beam:
            wcb = jnp.clip(cand["wc"], 0, self._WCB - 1)
            wmax = jnp.full((self._WCB,), -jnp.inf).at[wcb].max(atot)
            keep = ((total >= wmax[wcb] - cfg.eq_word_count_beam)
                    | is_fan)
            cand["alive"] = cand["alive"] & keep
        if cfg.fan_in_beam and "fanflag" in t:
            fi = (ff & 1) > 0
            fimax = jnp.max(jnp.where(fi, atot, -jnp.inf))
            cand["alive"] = cand["alive"] & jnp.where(
                fi, total >= fimax - cfg.fan_in_beam, True)
        if cfg.fan_out_beam and "fanflag" in t:
            fo = (ff & 2) > 0
            fomax = jnp.max(jnp.where(fo, atot, -jnp.inf))
            cand["alive"] = cand["alive"] & jnp.where(
                fo, total >= fomax - cfg.fan_out_beam, True)
        if cfg.tp_state_beam and "fanflag" in t:
            # at fan nodes: vs the best candidate at the SAME node
            # (STATE_PRUNING keeps per-node token lists comparable)
            nmax = jnp.full((self.tree.num_nodes,), -jnp.inf).at[
                cand["node"]].max(atot)
            cand["alive"] = cand["alive"] & jnp.where(
                is_fan, total >= nmax[cand["node"]]
                - cfg.tp_state_beam, True)

        # recombine: one sort by (node, lm, -total) carrying only the
        # candidate index as payload; first per key wins.  Then top-W via
        # top_k on the masked scores (cheaper than a second full sort).
        # When (node, lm) fits one int32 the two key columns fuse
        # (fewer sort passes); payloads after top-W come back through
        # ONE row-packed gather (ints bitcast through f32) instead of
        # one take per payload.
        sort_node = jnp.where(cand["alive"], cand["node"], INT_MAX)
        neg_total = jnp.where(cand["alive"], -total, jnp.inf)
        idx0 = jnp.arange(sort_node.shape[0], dtype=jnp.int32)
        if self._fused_sort_key:
            key = jnp.where(
                cand["alive"],
                cand["node"] * jnp.int32(self._fused_sort_key)
                + cand["lm"][:, 0], INT_MAX)
            out = jax.lax.sort((key, neg_total, idx0), num_keys=2)
            s_key, s_negt, s_idx = out
            diff = s_key[1:] != s_key[:-1]
            first = jnp.concatenate([jnp.asarray([True]), diff])
            s_alive = first & (s_key != INT_MAX)
        else:
            lm_cols = tuple(cand["lm"][:, k] for k in range(K))
            out = jax.lax.sort(
                (sort_node,) + lm_cols + (neg_total, idx0),
                num_keys=2 + K)
            s_node = out[0]
            s_lms = out[1:1 + K]
            s_negt, s_idx = out[1 + K], out[2 + K]
            diff = s_node[1:] != s_node[:-1]
            for col in s_lms:
                diff = diff | (col[1:] != col[:-1])
            first = jnp.concatenate([jnp.asarray([True]), diff])
            s_alive = first & (s_node != INT_MAX)

        # top-W winners: ONE sort carrying the candidate index (a
        # top_k + take(s_idx, top) pair costs an extra [B, W]-index
        # gather ~10 ns/index; sorting (score, s_idx) and slicing the
        # first W rows yields both for the price of the sort)
        neg2 = jnp.where(s_alive, s_negt, jnp.inf)
        o2 = jax.lax.sort((neg2, s_idx), num_keys=1)
        vals = -jax.lax.slice_in_dim(o2[0], 0, W)
        sel = jax.lax.slice_in_dim(o2[1], 0, W)   # original cand rows
        as_f = lambda x: jax.lax.bitcast_convert_type(x, jnp.float32)
        as_i = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
        packed = jnp.stack(
            [as_f(cand["node"]), cand["am"], cand["lms"],
             as_f(cand["dur"]), as_f(cand["rec"]), as_f(cand["law"]),
             as_f(cand["wc"])]
            + [as_f(cand["lm"][:, k]) for k in range(K)], axis=-1)
        got = jnp.take(packed, sel, axis=0)           # [W, 7+K]
        new_tokens = (
            as_i(got[:, 0]),
            jnp.stack([as_i(got[:, 7 + k]) for k in range(K)], axis=-1),
            got[:, 1],
            got[:, 2],
            as_i(got[:, 3]),
            as_i(got[:, 4]),
            vals > -jnp.inf,                # alive == selected real key
            as_i(got[:, 5]),
            as_i(got[:, 6]),
        )
        return new_tokens, (rec_word, rec_prev, rec_am, rec_lms)

    def _seed_tokens(self, obs0, t):
        """Utterance-initial token set: expand the initial context row.

        When the row is wider than W, keep the top-W candidates ranked
        by entry logp + frame-0 obs — identical to the per-frame
        recombination beam applied at frame 0 (row entries are distinct
        nodes with one candidate each, so first-per-(node,lm) is the
        candidate itself and the top-W slice IS the recombination
        result).  On cross-word trees every valid entry logp is 0 (the
        reentry_topk build asserts this), so am stays pure obs in both
        branches, matching the eager path exactly."""
        cfg = self.config
        W = cfg.num_tokens
        init_tgt = t["root_tgt"][self._init_pair]
        init_lp = t["root_logp"][self._init_pair]
        R = init_tgt.shape[0]
        if R <= W:
            node0 = jnp.full((W,), 0, jnp.int32).at[:R].set(init_tgt)
            alive0 = jnp.zeros((W,), bool).at[:R].set(
                init_lp > LOG_ZERO / 2)
            am0 = jnp.where(alive0, obs0[t["pdf"][node0]], LOG_ZERO)
        else:
            obs_r = obs0[t["pdf_root"][self._init_pair]]    # [R]
            score = jnp.where(init_lp > LOG_ZERO / 2,
                              init_lp + obs_r, -jnp.inf)
            vals, topi = jax.lax.top_k(score, W)
            node0 = jnp.take(init_tgt, topi)
            alive0 = vals > LOG_ZERO / 2
            am0 = jnp.where(alive0, jnp.take(obs_r, topi), LOG_ZERO)
        return node0, alive0, am0

    def _decode(self, obs, n_frames, lm_init, t, lm_tables,
                lattice=True):
        """obs [T, Sp] state log-likelihoods -> final tokens + records
        (lattice=True) or device-traced 1-best (lattice=False)."""
        cfg = self.config
        W = cfg.num_tokens

        # init: expand the utterance-initial root row at frame 0
        # (top-W pruned when the row is wider than W — _seed_tokens)
        node0, alive0, am0 = self._seed_tokens(obs[0], t)
        law0 = jnp.full((W,), getattr(self, "_la_init_row", 0),
                        jnp.int32)
        tokens = (node0,
                  jnp.broadcast_to(lm_init[None, :],
                                   (W, self._K)).astype(jnp.int32), am0,
                  jnp.zeros((W,), jnp.float32), jnp.zeros((W,), jnp.int32),
                  jnp.full((W,), -1, jnp.int32), alive0, law0,
                  jnp.zeros((W,), jnp.int32))

        T = obs.shape[0]
        valid = jnp.arange(1, T) < n_frames
        steps = jnp.arange(T - 1, dtype=jnp.int32)

        def step(tokens, xs):
            obs_t, v, i = xs
            new_tokens, recs = self._step(tokens, obs_t, i,
                                          t, lm_tables)
            out = tuple(jnp.where(v, n, o)
                        for n, o in zip(new_tokens, tokens))
            recs = jax.tree.map(
                lambda r: jnp.where(v, r, jnp.full_like(
                    r, -1 if r.dtype == jnp.int32 else 0)), recs)
            return out, recs

        tokens, recs = jax.lax.scan(
            step, tokens, (obs[1:], valid, steps))
        if not lattice:
            # finalize + 1-best traceback ON DEVICE (the record stacks
            # never leave the card)
            node, lmst, am, lms, dur, rec, alive, law, _wc = tokens
            W = node.shape[0]
            end_id = (self.lm.word_index.get(cfg.sentence_end)
                      if cfg.require_sentence_end else None)
            if cfg.require_sentence_end and end_id is not None:
                _, end_sc = self._walk(
                    lmst, jnp.full(lmst.shape[:1], end_id,
                                   jnp.int32), t, lm_tables)
                base_lms = lms + jnp.where(alive, end_sc, 0.0)
                # committed-at-final alternative: the reference puts
                # word ids on dedicated word-end nodes, so a token
                # that reached a word's last state by the final frame
                # IS committed there; if the node is also inside a
                # longer word (or has a skip/silence end) the
                # uncommitted interpretation is a real competing token
                # too, otherwise it does not exist (fin_base_ok).  The
                # commit pays pron + LM (+ the required </s> from the
                # post-commit state) but NO exit transition or
                # duration — those belong to the never-taken move out.
                # Gated on require_sentence_end (rectool.py:537 always
                # sets it); without it every engine keeps the legacy
                # exit-based convention at the final frame.
                aw, al, alms = self._final_commit(
                    node, lmst, lms, t, lm_tables, end_id)
                alt_total = jnp.where(
                    alive & (aw >= 0),
                    am + cfg.lm_scale_eff * alms, -jnp.inf)
                base_total = jnp.where(
                    alive & t["fin_base_ok"][node],
                    am + cfg.lm_scale_eff * base_lms, -jnp.inf)
                use_alt = alt_total > base_total
                total = jnp.maximum(base_total, alt_total)
                lms = jnp.where(use_alt, alms, base_lms)
                fin_w = jnp.where(use_alt, aw, -1)
            else:
                total = jnp.where(
                    alive, am + cfg.lm_scale_eff * lms, -jnp.inf)
                fin_w = jnp.full((W,), -1, jnp.int32)
            best = jnp.argmax(total)
            finals = jnp.stack([
                rec[best].astype(jnp.float32), total[best],
                am[best], lms[best]])
            flat_w = recs[0].reshape(-1)
            flat_p = recs[1].reshape(-1)
            # at most one word commits per frame on the 1-best chain
            Wmax = T

            def cond(c):
                ptr, i, _ = c
                return (ptr >= 0) & (i < Wmax)

            def body(c):
                ptr, i, out = c
                out = out.at[i].set(flat_w[ptr])
                return flat_p[ptr], i + 1, out

            has_fw = fin_w[best] >= 0
            out0 = jnp.full((Wmax,), -1, jnp.int32)
            out0 = out0.at[0].set(
                jnp.where(has_fw, fin_w[best], -1))
            _, nw, words = jax.lax.while_loop(
                cond, body, (rec[best], has_fw.astype(jnp.int32),
                             out0))
            return finals, words, nw
        return tokens, recs

    def _final_commit(self, node, lmst, lms, t, lm_tables, end_id):
        """Best committed interpretation per final token: for each
        word end on the token's node, pay pron + insertion + LM walk
        (+ the required sentence end from the post-commit state) with
        NO exit transition or duration bonus.  Returns
        (word [W], state [W, K], lms [W]); word -1 where the node has
        no usable word end."""
        cfg = self.config
        wW = t["we_word"][node]                        # [W, H]
        H = wW.shape[1]
        Wn = node.shape[0]
        ok = ((t["we_exit"][node] > LOG_ZERO / 2)
              & ~t["we_skip"][node] & (wW >= 0))
        lmid = t["lm_id"][jnp.maximum(wW, 0)]
        ok = ok & (lmid >= 0)
        flat_w = wW.reshape(-1)
        flat_states = jnp.broadcast_to(
            lmst[:, None, :], (Wn, H, lmst.shape[1])).reshape(
                Wn * H, -1)
        if self._mw_cmax == 1:
            nxt, sc = self._walk(flat_states,
                                 jnp.maximum(lmid.reshape(-1), 0),
                                 t, lm_tables)
        else:
            comp = t["mw_comp"][jnp.maximum(flat_w, 0)]
            nxt, sc = walk_components(
                lambda st, wd: self._walk(st, wd, t, lm_tables),
                flat_states, comp)
        if self._wb_tid >= 0:
            prev_wb = t["is_wb_state"][flat_states[:, 0]]
            ok = ok & ~((flat_w == self._wb_tid)
                        & prev_wb).reshape(Wn, H)
            if self._end_tid >= 0:
                nxt = jnp.where((flat_w == self._end_tid)[:, None],
                                t["wb_reset"][None, :], nxt)
        if end_id is not None:
            _, end2 = self._walk(
                nxt, jnp.full((Wn * H,), end_id, jnp.int32), t,
                lm_tables)
        else:
            end2 = jnp.zeros((Wn * H,), jnp.float32)
        alt = (lms[:, None] + t["we_pron"][node]
               + cfg.insertion_penalty_eff
               + (sc + end2).reshape(Wn, H))
        alt = jnp.where(ok & (sc.reshape(Wn, H) > LOG_ZERO / 2),
                        alt, -jnp.inf)
        h_best = jnp.argmax(alt, axis=1)
        alt_lms = jnp.take_along_axis(alt, h_best[:, None],
                                      axis=1)[:, 0]
        alt_w = jnp.where(jnp.isfinite(alt_lms),
                          jnp.take_along_axis(wW, h_best[:, None],
                                              axis=1)[:, 0], -1)
        alt_state = jnp.take_along_axis(
            nxt.reshape(Wn, H, -1),
            h_best[:, None, None], axis=1)[:, 0]
        return alt_w, alt_state, alt_lms

    # -- public API -------------------------------------------------------
    def decode(self, obs: np.ndarray, n_frames: int | None = None,
               sentence_start: str = "<s>", lattice: bool = True):
        """Decode one utterance: [T, S] state log-likelihoods -> result.

        Returns a DecodeResult (iterable as (words, log_prob) for
        backwards compatibility).  With lattice=True it carries the
        word-lattice records; lattice=False tracebacks on device and
        fetches only the word ids.
        """
        obs = jnp.asarray(obs, dtype=jnp.float32)
        if n_frames is None:
            n_frames = obs.shape[0]
        lm_init = np.atleast_1d(
            np.asarray(self.lm.initial_state(sentence_start),
                       dtype=np.int32))
        if not lattice:
            fn = self._get_fast_jit(("single",))
            out = fn(obs, jnp.int32(n_frames), jnp.asarray(lm_init),
                     self._dev_t, self._dev_lm)
            a0, a1, a2 = jax.device_get(out[:3])
            return self._result_words(a0, a1, int(a2))
        tokens, recs = self._decode_jit(
            obs, jnp.int32(n_frames), jnp.asarray(lm_init),
            self._dev_t, self._dev_lm)
        tokens, recs = jax.device_get((tokens, recs))
        return self._result(tokens, recs)

    def _get_fast_jit(self, key):
        if not hasattr(self, "_fast_jits"):
            self._fast_jits = {}
        if key not in self._fast_jits:
            fn = functools.partial(self._bound_decode, lattice=False)
            if key[0] == "batch":
                fn = jax.vmap(fn, in_axes=(0, 0, None, None, None))
            self._fast_jits[key] = jax.jit(fn)
        return self._fast_jits[key]

    def _result_words(self, finals, words_arr, n_words):
        ids = [int(w) for w in words_arr[:n_words][::-1] if w >= 0]
        return DecodeResult(
            search=self, final_ptr=int(finals[0]),
            log_prob=float(finals[1]),
            final_am=float(finals[2]), final_lms=float(finals[3]),
            rec_words=None, rec_prevs=None, rec_ams=None,
            rec_lmss=None,
            words=expand_word_boundaries(
                [self.tree.vocab[i] for i in ids], self.config))

    def decode_batch(self, obs: np.ndarray, n_frames: np.ndarray,
                     sentence_start: str = "<s>", lattice: bool = True):
        """[B, T, S] batched decode via vmap; returns list of results."""
        lm_init = np.atleast_1d(
            np.asarray(self.lm.initial_state(sentence_start),
                       dtype=np.int32))
        if not lattice:
            fn = self._get_fast_jit(("batch",))
            out = fn(jnp.asarray(obs, jnp.float32),
                     jnp.asarray(n_frames, jnp.int32),
                     jnp.asarray(lm_init), self._dev_t, self._dev_lm)
            # one batched round trip (per-array np.asarray costs one
            # transfer each)
            finals, words, nws = jax.device_get(out[:3])
            return [self._result_words(finals[b], words[b], int(nws[b]))
                    for b in range(obs.shape[0])]
        if not hasattr(self, "_batch_jit"):
            self._batch_jit = jax.jit(jax.vmap(
                self._bound_decode, in_axes=(0, 0, None, None, None)))
        tokens, recs = self._batch_jit(
            jnp.asarray(obs, jnp.float32),
            jnp.asarray(n_frames, jnp.int32), jnp.asarray(lm_init),
            self._dev_t, self._dev_lm)
        # ONE batched device->host round trip for ALL arrays
        # (per-array or per-utterance fetches each pay a transfer)
        tokens_h, recs_h = jax.device_get((tokens, recs))
        out = []
        for b in range(obs.shape[0]):
            st = tuple(x[b] for x in tokens_h)
            rc = tuple(r[b] for r in recs_h)
            out.append(self._result(st, rc))
        return out

    def _result(self, tokens, recs):
        node, lmst, am, lms, dur, rec, alive = (
            np.asarray(x) for x in tokens[:7])
        lmst2 = lmst if lmst.ndim == 2 else lmst[:, None]

        def walk1(st, wid):
            if self._lm_tables is not None:
                return self.lm.walk(st, wid)
            nx, sc = self.lm.walk(int(st[0]), wid)
            return np.asarray([nx]), sc

        fin_word = -1
        end_id = (self.lm.word_index.get(self.config.sentence_end)
                  if self.config.require_sentence_end else None)
        if end_id is None:
            total = np.where(alive,
                             am + self.config.lm_scale_eff * lms,
                             -np.inf)
            best = int(np.argmax(total))
        else:
            ends = np.asarray(
                [walk1(st, end_id)[1] if a else 0.0
                 for st, a in zip(lmst2, alive)], np.float32)
            base_lms = lms + ends
            # committed-at-final alternative (see the device
            # finalize): pay the node's best word end without exit
            # transition or duration, then the required </s>
            tree = self.tree
            lm_id = np.asarray(self.tables["lm_id"])
            alt_lms = np.full(len(node), -np.inf, np.float32)
            alt_w = np.full(len(node), -1, np.int32)
            wb_reset = (np.asarray(self.tables["wb_reset"])
                        if self._wb_tid >= 0
                        and "wb_reset" in self.tables else None)
            is_wb = (np.asarray(self.tables["is_wb_state"])
                     if self._wb_tid >= 0
                     and "is_wb_state" in self.tables else None)
            for i2 in range(len(node)):
                if not alive[i2]:
                    continue
                n2 = int(node[i2])
                for h in range(tree.we_word.shape[1]):
                    w2 = int(tree.we_word[n2, h])
                    if (w2 < 0 or tree.we_skip_lm[n2, h]
                            or tree.we_exit_logp[n2, h]
                            <= LOG_ZERO / 2
                            or lm_id[w2] < 0):
                        continue
                    if (is_wb is not None
                            and w2 == self._wb_tid
                            and is_wb[int(lmst2[i2][0])]):
                        continue
                    if self._mw_cmax > 1:
                        comp = np.asarray(
                            self.tables["mw_comp"])[w2]
                        st2, sc2 = lmst2[i2], 0.0
                        for c2 in comp:
                            if c2 < 0:
                                break
                            st2, s3 = walk1(st2, int(c2))
                            sc2 += s3
                    else:
                        st2, sc2 = walk1(lmst2[i2],
                                         int(lm_id[w2]))
                    if sc2 <= LOG_ZERO / 2:
                        continue
                    if (wb_reset is not None
                            and w2 == self._end_tid):
                        st2 = wb_reset
                    e2 = walk1(st2, end_id)[1]
                    cand = (lms[i2] + tree.we_pron_logp[n2, h]
                            + self.config.insertion_penalty_eff
                            + sc2 + e2)
                    if cand > alt_lms[i2]:
                        alt_lms[i2] = cand
                        alt_w[i2] = w2
            fin_ok = np.asarray(self.tables["fin_base_ok"])
            base_total = np.where(
                alive & fin_ok[node],
                am + self.config.lm_scale_eff * base_lms,
                -np.inf)
            alt_total = np.where(
                alive & (alt_w >= 0),
                am + self.config.lm_scale_eff * alt_lms, -np.inf)
            use_alt = alt_total > base_total
            total = np.maximum(base_total, alt_total)
            lms = np.where(use_alt, alt_lms, base_lms)
            best = int(np.argmax(total))
            fin_word = int(alt_w[best]) if use_alt[best] else -1
        return DecodeResult(
            search=self, final_ptr=int(rec[best]),
            log_prob=float(total[best]),
            final_am=float(am[best]), final_lms=float(lms[best]),
            rec_words=np.asarray(recs[0]), rec_prevs=np.asarray(recs[1]),
            rec_ams=np.asarray(recs[2]), rec_lmss=np.asarray(recs[3]),
            final_word=fin_word)


class DecodeResult:
    """1-best plus the word-lattice records of one utterance."""

    def __init__(self, search, final_ptr, log_prob, final_am, final_lms,
                 rec_words, rec_prevs, rec_ams, rec_lmss, words=None,
                 final_word=-1):
        self.search = search
        self._words = words
        self.final_word = final_word   # committed at the final frame
        self.final_ptr = final_ptr
        self.log_prob = log_prob
        self.final_am = final_am
        self.final_lms = final_lms
        self.rec_words = rec_words       # [T-1, E]
        self.rec_prevs = rec_prevs
        self.rec_ams = rec_ams
        self.rec_lmss = rec_lmss

    # tuple-compat: (words, log_prob)
    def __iter__(self):
        return iter((self.words, self.log_prob))

    def __getitem__(self, i):
        return (self.words, self.log_prob)[i]

    @property
    def words(self) -> list:
        """1-best word strings (device traceback or record chain)."""
        if self._words is not None:
            return self._words
        words = []
        E = self.rec_words.shape[1]
        ptr = self.final_ptr
        guard = 0
        while ptr >= 0 and guard < 100000:
            f, slot = divmod(ptr, E)
            w = int(self.rec_words[f, slot])
            if w >= 0:
                words.append(self.search.tree.vocab[w])
            ptr = int(self.rec_prevs[f, slot])
            guard += 1
        words.reverse()
        if getattr(self, "final_word", -1) >= 0:
            words.append(self.search.tree.vocab[self.final_word])
        return expand_word_boundaries(words, self.search.config)

    def word_graph(self):
        """Build a WordGraph (lattice) from the records."""
        if self.rec_words is None:
            raise RuntimeError(
                "decoded with lattice=False: records were not fetched")
        from aaltoasr_tpu.decoder.wordgraph import WordGraph
        return WordGraph.from_records(
            self.search.tree.vocab, self.search.config,
            self.rec_words, self.rec_prevs, self.rec_ams, self.rec_lmss,
            self.final_ptr, self.final_am, self.final_lms)


class StreamingDecoder:
    """Frame-by-frame push decoding — the OneFrameAcoustics path.

    Reference: `decoder/src/OneFrameAcoustics.{hh,cc}` +
    `Toolbox::use_one_frame_acoustics/set_one_frame/run`
    (Toolbox.hh:123-145): the caller supplies per-frame state log-probs
    and steps the search.  Here one jitted searcher step runs per pushed
    frame on device; records accumulate host-side.  Latency per frame is
    one tiny device dispatch; for offline batches use BeamSearch.decode.
    """

    def __init__(self, search: BeamSearch, sentence_start: str = "<s>",
                 buffer_frames: int = 256, ring_frames: int = 16384,
                 partial_words: int = 64):
        self.search = search
        # partial-hypothesis support (`Toolbox::run` mid-stream best
        # path, decode-stream.cc prints the hypothesis per block): a
        # device-resident [ring_frames, E] ring of (word, prev) record
        # rows lets partial() traceback ON DEVICE and fetch only a
        # [partial_words] id buffer — no record flush, no host
        # traceback.  The ring is created lazily on the first
        # partial()/flush so pure-final consumers never pay for it.
        self._ring_frames = ring_frames
        self._partial_cap = partial_words
        # flush cadence: each push leaves its record row as a small
        # per-frame device array (the step stays ONE minimal dispatch
        # instead of carrying device ring buffers through the jit
        # boundary); once
        # `buffer_frames` rows are pending they are stacked ON DEVICE
        # (one concatenate dispatch) and moved to host in 4 bulk
        # transfers.  result() flushes the same way, so a pipelined
        # consumer pays 4 bulk transfers per partial, never
        # 4 x frames small ones (each ~fixed-cost on remote links).
        self._buffer_frames = buffer_frames

        def step(tokens, obs_node, i, dev_t, dev_lm):
            t = {**search._static_t, **dev_t}
            lms_ = (None if dev_lm is None else
                    [{**st, **dv} for st, dv
                     in zip(search._static_lm, dev_lm)])
            return search._step(tokens, obs_node, i, t, lms_)

        self._step_jit = jax.jit(step)

        # chunked push: one lax.scan dispatch for a [K, S] block of
        # frames (the decode-stream.cc read loop pushes every frame
        # available per audio block — `decode-stream.cc:1-33`); each
        # dispatch has a fixed cost, so scanning the block amortizes
        # it K-fold.  The
        # block's record rows come out already stacked [K, E] and stay
        # on device in the spill layout.
        def chunk_step(tokens, obs_chunk, i0, dev_t, dev_lm):
            t = {**search._static_t, **dev_t}
            lms_ = (None if dev_lm is None else
                    [{**st, **dv} for st, dv
                     in zip(search._static_lm, dev_lm)])

            def body(carry, obs_t):
                toks, i = carry
                toks, recs = search._step(toks, obs_t, i, t, lms_)
                return (toks, i + jnp.int32(1)), recs

            (tokens, _), recs = jax.lax.scan(
                body, (tokens, i0), obs_chunk)
            ws, ps, ams, ls = recs
            ih = jnp.concatenate([ws.astype(jnp.int32),
                                  ps.astype(jnp.int32)], axis=1)
            fh = jnp.concatenate([ams.astype(jnp.float32),
                                  ls.astype(jnp.float32)], axis=1)
            return tokens, (ih, fh)

        self._chunk_jit = jax.jit(chunk_step)
        self._stack_jit = None

        # device-side packing: every host fetch pays a fixed cost, so
        # result() fetches ONE
        # int32 and ONE float32 matrix instead of 7-9 token arrays
        def pack_tokens(tokens):
            ints, flts = [], []
            for x in tokens:
                x2 = x[:, None] if x.ndim == 1 else x
                if jnp.issubdtype(x2.dtype, jnp.floating):
                    flts.append(x2.astype(jnp.float32))
                else:
                    ints.append(x2.astype(jnp.int32))
            return (jnp.concatenate(ints, axis=1),
                    jnp.concatenate(flts, axis=1))

        self._pack_jit = jax.jit(pack_tokens)

        # ring insert: scatter a [B, 2E] record pack at rows
        # i0..i0+B-1 (mod ring_frames).  Donated so XLA updates the
        # ring in place instead of copying it per partial.
        def ring_upd(ringw, ringp, ih, i0):
            E = ringw.shape[1]
            rows = ((i0 + jnp.arange(ih.shape[0], dtype=jnp.int32))
                    % ringw.shape[0])
            return (ringw.at[rows].set(ih[:, :E]),
                    ringp.at[rows].set(ih[:, E:]))

        self._ring_upd_jit = jax.jit(ring_upd, donate_argnums=(0, 1))

        # device traceback for partial(): best live token -> walk its
        # record chain through the ring -> [partial_words] ids (newest
        # first) + count + current best total.  Chains older than the
        # ring window stop at the staleness guard (rows are
        # overwritten after ring_frames steps).
        def partial_tb(tokens, ringw, ringp, n_rows):
            node, lmst, am, lms, dur, rec, alive, law, wc = tokens
            cfg = search.config
            total = jnp.where(alive, am + cfg.lm_scale_eff * lms,
                              -jnp.inf)
            best = jnp.argmax(total)
            E = ringw.shape[1]
            CAP = ringw.shape[0]
            L = self._partial_cap
            # staleness guard: rows older than the ring window are
            # overwritten; padded stack tails can additionally clobber
            # up to buffer_frames rows early, so back the horizon off
            min_ptr = (n_rows - CAP + buffer_frames) * E

            def cond(c):
                ptr, i, _ = c
                return (ptr >= 0) & (ptr >= min_ptr) & (i < L)

            def body(c):
                ptr, i, out = c
                row = (ptr // E) % CAP
                out = out.at[i].set(ringw[row, ptr % E])
                return ringp[row, ptr % E], i + 1, out

            _, nw, out = jax.lax.while_loop(
                cond, body, (rec[best], jnp.int32(0),
                             jnp.full((L,), -1, jnp.int32)))
            return out, nw, total[best]

        self._partial_jit = jax.jit(partial_tb)
        self._sentence_start = sentence_start
        self.reset()

    def reset(self) -> None:
        s = self.search
        self._frame = 0
        self._pending = [[], [], [], []]  # per-frame [E] device arrays
        # ((int32 [k,2E], f32 [k,2E]), k, i0): i0 = first step index of
        # the pack's record rows (feeds the partial-traceback ring)
        self._pending_packs = []
        self._spill = [[], [], [], []]    # host [n, E] flushed chunks
        self._pack_start = 0              # record rows packed/spilled
        self._ring = None                 # (words, prevs) device ring
        self._ring_upto = 0               # rows already in the ring
        self._host_cache = None           # (n_frames, recs) memo
        lm_init = s.lm.initial_state(self._sentence_start)
        self._pending_init = lm_init
        self._tokens = None

    def push_frame(self, log_probs: np.ndarray) -> None:
        """Feed one frame of state log-probs (set_one_frame + run)."""
        s = self.search
        obs_t = jnp.asarray(log_probs, dtype=jnp.float32)
        if self._tokens is None:
            lm_init = self._pending_init
            node0, alive0, am0 = s._seed_tokens(obs_t, s.tables)
            W = s.config.num_tokens
            lm_init = np.atleast_1d(np.asarray(lm_init,
                                               dtype=np.int32))
            self._tokens = (node0,
                            jnp.broadcast_to(
                                jnp.asarray(lm_init)[None, :],
                                (W, len(lm_init))).astype(jnp.int32),
                            am0, jnp.zeros((W,), jnp.float32),
                            jnp.zeros((W,), jnp.int32),
                            jnp.full((W,), -1, jnp.int32), alive0,
                            jnp.full((W,), getattr(
                                s, "_la_init_row", 0), jnp.int32),
                            jnp.zeros((W,), jnp.int32))
        else:
            self._tokens, recs = self._step_jit(
                self._tokens, obs_t, jnp.int32(self._frame - 1),
                s._dev_t, s._dev_lm)
            for lst, r in zip(self._pending, recs):
                lst.append(r)
            if len(self._pending[0]) >= self._buffer_frames:
                self._flush()
        self._frame += 1

    def push_frames(self, log_probs) -> None:
        """Feed a [K, S] block of state log-probs in ONE device
        dispatch (a lax.scan over the block).  Semantically identical
        to K push_frame calls; the reference's own streaming loop
        pushes every frame available per audio read
        (`decode-stream.cc:1-33`), and on a remote runtime with a
        fixed per-dispatch cost the block form is ~K times cheaper."""
        obs = jnp.asarray(log_probs, dtype=jnp.float32)
        if obs.ndim == 1:
            self.push_frame(obs)
            return
        k = int(obs.shape[0])
        if k == 0:
            return
        if self._tokens is None:
            self.push_frame(obs[0])      # frame 0 seeds the token set
            obs = obs[1:]
            k -= 1
            if k == 0:
                return
        self._pending_to_pack()          # keep record rows in order
        s = self.search
        self._tokens, pack = self._chunk_jit(
            self._tokens, obs, jnp.int32(self._frame - 1),
            s._dev_t, s._dev_lm)
        self._pending_packs.append((pack, k, self._pack_start))
        self._pack_start += k
        self._frame += k
        if self._buffered_rows() >= self._buffer_frames:
            self._flush()

    def _buffered_rows(self) -> int:
        return (len(self._pending[0])
                + sum(n for _, n, _ in self._pending_packs))

    def _pending_to_pack(self) -> None:
        """Stack the per-frame pending rows into a device pack and
        queue it behind any earlier chunk packs (no host fetch)."""
        n = len(self._pending[0])
        if n:
            self._pending_packs.append(
                (self._stack_pending(), n, self._pack_start))
            self._pack_start += n
            self._pending = [[], [], [], []]

    def _ensure_ring(self) -> None:
        """Insert every not-yet-ringed device pack into the record
        ring (one scatter dispatch per pack; padded tail rows land on
        future step indices and are overwritten by their real packs
        before they become reachable)."""
        if self._ring is None:
            E = self.search.config.num_records
            self._ring = (
                jnp.full((self._ring_frames, E), -1, jnp.int32),
                jnp.full((self._ring_frames, E), -1, jnp.int32))
        for pack, n, i0 in self._pending_packs:
            if i0 >= self._ring_upto:
                self._ring = self._ring_upd_jit(
                    self._ring[0], self._ring[1], pack[0],
                    jnp.int32(i0))
                self._ring_upto = i0 + n

    def partial(self):
        """Current best word sequence via DEVICE traceback: a couple
        of small dispatches plus ONE tiny fetch of a
        [partial_words]-id buffer — records are NOT flushed and no
        host traceback runs (contrast result()).  Mid-stream this is
        the hypothesis `Toolbox::run` exposes between frames
        (decode-stream.cc's per-block print); no sentence-end finalize
        is applied.  Words older than `ring_frames` frames are
        truncated (the final result() is always full-fidelity)."""
        if self._tokens is None:
            raise RuntimeError("no frames pushed")
        self._pending_to_pack()
        self._ensure_ring()
        out, nw, best = jax.device_get(self._partial_jit(
            self._tokens, self._ring[0], self._ring[1],
            jnp.int32(self._frame - 1)))
        ids = [int(w) for w in out[:int(nw)][::-1] if w >= 0]
        return expand_word_boundaries(
            [self.search.tree.vocab[i] for i in ids],
            self.search.config)

    def _stack_pending(self):
        """Launch the jitted device-side stack of the pending record
        rows (a single dispatch — eager jnp.stack would cost one
        dispatch per row).  The stack is
        compiled once at a fixed length (`buffer_frames`); short tails
        are padded with their last row and sliced after the fetch.
        Returns the (int32 pack, float32 pack) DEVICE pair, or None."""
        n = len(self._pending[0])
        if n == 0:
            return None
        if self._stack_jit is None:
            # one dispatch: words+prevs packed into one int32 matrix,
            # ams+lmss into one float32 matrix
            self._stack_jit = jax.jit(lambda ws, ps, ams, ls: (
                jnp.concatenate([jnp.stack(ws), jnp.stack(ps)], axis=1),
                jnp.concatenate([jnp.stack(ams), jnp.stack(ls)],
                                axis=1)))
        B = self._buffer_frames
        ws, ps, ams, ls = (lst + [lst[-1]] * (B - n)
                           for lst in self._pending)
        return self._stack_jit(ws, ps, ams, ls)

    def _spill_packed(self, packed, n) -> None:
        """Append a fetched (int32, float32) record pack to the host
        spill lists and drop the pending device rows."""
        ih, fh = packed
        ih = ih[:n]
        fh = fh[:n]
        E = ih.shape[1] // 2
        for sp, chunk in zip(self._spill, (ih[:, :E], ih[:, E:],
                                           fh[:, :E], fh[:, E:])):
            sp.append(np.ascontiguousarray(chunk))
        self._pending = [[], [], [], []]

    def _flush(self) -> None:
        """Move pending record rows to host: one stack dispatch + ONE
        batched transfer (`jax.device_get` fetches a whole pytree in a
        single round trip; per-array np.asarray costs one round trip
        each)."""
        self._pending_to_pack()
        if not self._pending_packs:
            return
        if self._ring is not None:
            # keep the partial ring complete: rows flushed to host are
            # no longer reachable on device otherwise
            self._ensure_ring()
        host = jax.device_get([p for p, _, _ in self._pending_packs])
        for hp, (_, n, _) in zip(host, self._pending_packs):
            self._spill_packed(hp, n)
        self._pending_packs = []

    @property
    def frame(self) -> int:
        return self._frame

    def result(self) -> "DecodeResult":
        """Current best hypothesis (callable any time mid-stream)."""
        if self._tokens is None:
            raise RuntimeError("no frames pushed")
        E = self.search.config.num_records
        n = self._frame - 1          # record rows written so far
        # ONE batched round trip for everything the finalize needs:
        # the packed token state + all pending record packs
        self._pending_to_pack()
        if self._ring is not None:
            self._ensure_ring()
        fetch = {"tok": self._pack_jit(self._tokens)}
        if self._pending_packs:
            fetch["rec"] = [p for p, _, _ in self._pending_packs]
        host = jax.device_get(fetch)
        if self._pending_packs:
            for hp, (_, npend, _) in zip(host["rec"],
                                         self._pending_packs):
                self._spill_packed(hp, npend)
            self._pending_packs = []
        if n > 0:
            if (self._host_cache is not None
                    and self._host_cache[0] == n):
                recs = self._host_cache[1]
            else:
                recs = tuple(
                    sp[0] if len(sp) == 1 else np.concatenate(sp)
                    for sp in self._spill)
                self._spill = [[r] for r in recs]  # keep chunks merged
                self._host_cache = (n, recs)
        else:
            recs = (np.full((1, E), -1, np.int32),
                    np.full((1, E), -1, np.int32),
                    np.zeros((1, E), np.float32),
                    np.zeros((1, E), np.float32))
        tokens = self._unpack_tokens(*host["tok"])
        return self.search._result(tokens, recs)

    def _fetch_tokens(self):
        """Fetch the token arrays as host numpy via the packed
        two-matrix transfer (one batched round trip)."""
        return self._unpack_tokens(
            *jax.device_get(self._pack_jit(self._tokens)))

    def _unpack_tokens(self, ih, fh):
        out, ii, fi = [], 0, 0
        for x in self._tokens:
            cols = 1 if x.ndim == 1 else x.shape[1]
            if jnp.issubdtype(x.dtype, jnp.floating):
                arr = fh[:, fi:fi + cols].astype(np.float32)
                fi += cols
            else:
                arr = ih[:, ii:ii + cols].astype(
                    np.asarray(jnp.zeros((), x.dtype)).dtype)
                ii += cols
            out.append(arr[:, 0] if x.ndim == 1 else arr)
        return tuple(out)
