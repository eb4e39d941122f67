"""N-gram LM compiled to a backoff FSA with gather-based device lookup.

Same representation idea as the reference's fsalm (`decoder/src/fsalm/
LM.{hh,cc}`: n-gram compiled to an FSA whose nodes embed backoff arcs,
walked with `walk(node, symbol, &score)`), rebuilt for the device: transitions
live in one array sorted by packed (state, word) key, looked up by
binary search (a handful of gathers), and backoff hops are unrolled
``order`` times with masking — no data-dependent control flow.

States are the observed n-gram contexts (orders 0..n-1).  A walk from
state ``h`` on word ``w``:

* explicit transition if ``h·w`` is an n-gram: score = ln P(w|h), next
  state = longest suffix of ``h·w`` that is a context;
* otherwise add backoff(h) and retry from suffix(h).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from aaltoasr_tpu.formats.arpa import ArpaLM

NEG_INF = -1.0e30


@dataclass
class NGramFsa:
    order: int
    vocab: list
    word_index: dict
    num_states: int
    context_of_state: list          # state id -> context tuple
    state_of_context: dict          # context tuple -> state id
    trans_word: np.ndarray          # [M] int32, grouped by state, sorted
    trans_prob: np.ndarray          # [M] float32 ln P
    trans_next: np.ndarray          # [M] int32
    state_first: np.ndarray         # [num_states + 1] row offsets into M
    bo_weight: np.ndarray           # [num_states] float32
    bo_next: np.ndarray             # [num_states] int32
    num_words: int

    @classmethod
    def from_arpa(cls, lm: ArpaLM) -> "NGramFsa":
        order = lm.order
        V = len(lm.vocab)
        contexts = {(): 0}
        context_list = [()]

        def intern(ctx):
            if ctx not in contexts:
                contexts[ctx] = len(context_list)
                context_list.append(ctx)
            return contexts[ctx]

        # contexts = all grams of order < n (they can carry history)
        for o in range(1, order):
            for words in lm.ngrams[o]:
                intern(words)

        def next_state(ctx, w):
            """Longest suffix of ctx+(w,) (capped to order-1) that is a
            known context."""
            t = (ctx + (w,))[-(order - 1):] if order > 1 else ()
            while t and t not in contexts:
                t = t[1:]
            return contexts[t]

        keys, probs, nexts = [], [], []
        S = len(context_list)
        for o in range(1, order + 1):
            for words, (logp, _bo) in lm.ngrams[o].items():
                ctx, w = words[:-1], words[-1]
                if ctx not in contexts:
                    continue  # unreachable context (pruned LM)
                s = contexts[ctx]
                keys.append(s * V + w)
                probs.append(logp)
                nexts.append(next_state(ctx, w))

        bo_weight = np.zeros(S, dtype=np.float32)
        bo_next = np.zeros(S, dtype=np.int32)
        for ctx, s in contexts.items():
            if ctx:
                bo_weight[s] = lm.ngrams[len(ctx)].get(ctx, (0.0, 0.0))[1]
                t = ctx[1:]
                while t and t not in contexts:
                    t = t[1:]
                bo_next[s] = contexts[t]
            else:
                bo_weight[s] = NEG_INF  # no backoff from unigram state
                bo_next[s] = 0

        keys = np.asarray(keys, dtype=np.int64)
        srt = np.argsort(keys, kind="stable")
        keys = keys[srt]
        states = (keys // V).astype(np.int64)
        words = (keys % V).astype(np.int32)
        # CSR-style row offsets per state: transitions grouped by state,
        # word-sorted within each group (int32-safe two-level lookup)
        state_first = np.zeros(S + 1, dtype=np.int32)
        np.add.at(state_first, states + 1, 1)
        state_first = np.cumsum(state_first).astype(np.int32)
        return cls(
            order=order, vocab=list(lm.vocab),
            word_index=dict(lm.word_index),
            num_states=S, context_of_state=context_list,
            state_of_context=contexts,
            trans_word=words,
            trans_prob=np.asarray(probs, dtype=np.float32)[srt],
            trans_next=np.asarray(nexts, dtype=np.int32)[srt],
            state_first=state_first,
            bo_weight=bo_weight, bo_next=bo_next, num_words=V)

    def states_ending_with(self, word_id: int) -> np.ndarray:
        """[num_states] bool: the state's context ends with word_id.

        Used for the word-boundary double-commit prune
        (TokenPassSearch.cc:869-873 "Prune two subsequent word
        boundaries"): a hypothesis's last committed word is word_id
        iff its LM state context ends with it (states are identified
        by context, so only a word_id walk reaches such a state; the
        one blind spot is the empty-context state 0, reached when the
        LM has no context carrying word_id — not the case for any LM
        that actually models the boundary word)."""
        out = np.zeros(self.num_states, dtype=bool)
        for s, ctx in enumerate(self.context_of_state):
            if ctx and ctx[-1] == word_id:
                out[s] = True
        return out

    # -- host walk (reference for tests / host decoding) ------------------
    def walk(self, state: int, word: int) -> tuple[int, float]:
        score = 0.0
        for _ in range(self.order + 1):
            lo, hi = self.state_first[state], self.state_first[state + 1]
            i = lo + np.searchsorted(self.trans_word[lo:hi], word)
            if i < hi and self.trans_word[i] == word:
                return int(self.trans_next[i]), score + float(
                    self.trans_prob[i])
            if self.bo_weight[state] <= NEG_INF / 2:
                return 0, NEG_INF
            score += float(self.bo_weight[state])
            state = int(self.bo_next[state])
        return 0, NEG_INF

    def initial_state(self, sentence_start: str = "<s>") -> int:
        ctx = (self.word_index[sentence_start],) if (
            sentence_start in self.word_index and self.order > 1) else ()
        while ctx and ctx not in self.state_of_context:
            ctx = ctx[1:]
        return self.state_of_context[ctx]

    # -- device tables ----------------------------------------------------
    def device_tables(self) -> dict:
        # dense tables for the empty-context state 0: its row holds every
        # unigram, so lookups there are a single gather (and it is the
        # final hop of every backoff chain)
        V = self.num_words
        uni_prob = np.full(V, NEG_INF, dtype=np.float32)
        uni_next = np.zeros(V, dtype=np.int32)
        lo, hi = int(self.state_first[0]), int(self.state_first[1])
        uni_prob[self.trans_word[lo:hi]] = self.trans_prob[lo:hi]
        uni_next[self.trans_word[lo:hi]] = self.trans_next[lo:hi]
        # widest non-root row bounds the 16-ary search depth
        rows = np.diff(self.state_first)
        max_row = int(rows[1:].max()) if len(rows) > 1 else 1
        iters16 = 0
        span = max(max_row, 1)
        while span > 16:
            span = (span + 15) // 16
            iters16 += 1
        tables = {
            "trans_word": jnp.asarray(self.trans_word),
            "trans_prob": jnp.asarray(self.trans_prob),
            "trans_next": jnp.asarray(self.trans_next),
            "state_first": jnp.asarray(self.state_first),
            "bo_weight": jnp.asarray(self.bo_weight),
            "bo_next": jnp.asarray(self.bo_next),
            "uni_prob": jnp.asarray(uni_prob),
            "uni_next": jnp.asarray(uni_next),
            # row-packed (prob, next-bitcast) pairs: one gather each
            "uni_packed": jnp.asarray(np.stack(
                [uni_prob, uni_next.view(np.float32)], axis=1)),
            "bo_packed": jnp.asarray(np.stack(
                [self.bo_weight,
                 self.bo_next.view(np.float32)], axis=1)),
            "lookup_iters16": iters16,
        }
        tables.update(self.hash_tables())
        return tables

    # open-addressed (state, word) -> (next, prob) table: the walk's
    # lookup becomes ~2L gathers instead of a 16-ary search's ~50
    _HASH_MUL_S = np.uint32(2654435761)
    _HASH_MUL_W = np.uint32(40503)

    def hash_tables(self, bucket_slots: int = 8) -> dict:
        """Bucketed hash of the non-root transitions.

        Each lookup in the decoder's inner scan is a dynamic gather, and
        a gather costs per INDEX more than per byte — so the layout buys
        ONE index per lookup: buckets of `bucket_slots` (state, word,
        next, prob) slots flattened into one [S_b, 4*L] row (L=8 -> a
        contiguous 128-byte row, one HBM burst).  Every key must land in
        its home bucket (no cross-bucket probing keeps the lookup a
        single gather); the bucket count doubles until that holds, which
        converges at ~2-4x the key count (Poisson tails: P[bucket > 8]
        ~ 2e-4 at mean 2).  The previous linear-probe layout demanded
        all keys within 2 probes, which blew the table up to the 1024*M
        cap — 2^28 rows (4.3 GB) on a 10k-word trigram, where the three
        per-frame walk gathers were a large share of the production
        decode step (`benchmarks/bench_exact.py --profile`; the share on
        the H100 is not measured).
        int32 columns are BITCAST into f32 columns — gathers are
        bit-preserving copies, and the bits only flow through
        select/bitcast, never arithmetic (-1 is a NaN pattern)."""
        rows = slice(int(self.state_first[1]), len(self.trans_word))
        states = np.repeat(
            np.arange(self.num_states, dtype=np.int64),
            np.diff(self.state_first))[rows].astype(np.uint32)
        words = self.trans_word[rows].astype(np.uint32)
        nexts = self.trans_next[rows]
        probs = self.trans_prob[rows]
        M = len(words)
        L = bucket_slots
        nb = 4
        while nb * L < max(2 * M, 16):
            nb *= 2
        while True:
            bmask = np.uint32(nb - 1)
            h0 = ((states * self._HASH_MUL_S)
                  ^ (words * self._HASH_MUL_W)) & bmask
            # vectorized placement: stable-sort keys by home bucket;
            # slot = rank within the bucket
            order = np.argsort(h0, kind="stable")
            hs = h0[order]
            first = np.zeros(len(hs), np.int64)
            if len(hs):
                new = np.flatnonzero(np.diff(hs.astype(np.int64)) != 0)
                first[new + 1] = new + 1
                first = np.maximum.accumulate(first)
            slot = np.arange(len(hs)) - first
            if len(hs) == 0 or slot.max() < L:
                break
            nb *= 2                       # some bucket overflows: grow
        h_state = np.full(nb * L, -1, np.int32)
        h_word = np.full(nb * L, -1, np.int32)
        h_next = np.zeros(nb * L, np.int32)
        h_prob = np.zeros(nb * L, np.float32)
        idx = hs.astype(np.int64) * L + slot
        h_state[idx] = states[order].astype(np.int32)
        h_word[idx] = words[order].astype(np.int32)
        h_next[idx] = nexts[order]
        h_prob[idx] = probs[order]
        packed = np.stack([
            h_state.view(np.float32), h_word.view(np.float32),
            h_next.view(np.float32), h_prob],
            axis=1).reshape(nb, 4 * L)
        return {
            "hash_packed": jnp.asarray(packed),
            "hash_mask": bmask,
            "hash_slots": L,
        }


def lm_walk_device(tables: dict, num_words: int, order: int, state, word):
    """Vectorized FSA walk: (state [N], word [N]) -> (next [N], score [N]).

    Latency-optimized lookup (the walk sits in the decoder's inner scan,
    so sequential dependent gathers dominate): the empty-context state 0
    resolves with ONE dense gather; other rows use a 16-ary search (two
    rounds for thousands of transitions) followed by one 16-wide
    parallel compare.  Backoff hops unroll ``order`` times with masking.
    """
    tw = tables["trans_word"]
    sf = tables["state_first"]
    iters16 = tables["lookup_iters16"]
    M = tw.shape[0]

    if "hash_packed" in tables:
        # bucketed (state, word) table: the whole home bucket (keys AND
        # values, L slots x 4 cols) comes back in ONE gather of one
        # contiguous [4L]-wide row — one gather INDEX per lookup, one
        # HBM burst at L=8 (int32 columns bitcast through f32,
        # only touched by select/bitcast).  Keys are unique and always
        # placed in their home bucket, so at most one slot hits.
        hp = tables["hash_packed"]
        mask = jnp.uint32(tables["hash_mask"])
        L = tables["hash_slots"]

        def ic(x):
            return jax.lax.bitcast_convert_type(x, jnp.int32)

        def lookup(state, word):
            h = ((state.astype(jnp.uint32) * jnp.uint32(2654435761))
                 ^ (word.astype(jnp.uint32) * jnp.uint32(40503))) & mask
            rows = hp[h.astype(jnp.int32)]           # [..., 4L]
            rows = rows.reshape(rows.shape[:-1] + (L, 4))
            m = ((ic(rows[..., 0]) == state[..., None])
                 & (ic(rows[..., 1]) == word[..., None]))
            hit = jnp.any(m, axis=-1)
            nxt = jnp.sum(jnp.where(m, ic(rows[..., 2]), 0), axis=-1)
            prob = jnp.sum(jnp.where(m, rows[..., 3], 0.0), axis=-1)
            return hit, nxt, prob
    else:
        def lookup(state, word):
            lo = sf[state].astype(jnp.int32)
            hi = sf[state + 1].astype(jnp.int32)
            for _ in range(iters16):
                span = hi - lo
                # 15 interior pivots; bucket = count of pivots <= word
                frac = (jnp.arange(1, 16, dtype=jnp.int32)[None, :]
                        * span[:, None]) // 16
                piv_idx = jnp.minimum(lo[:, None] + frac, M - 1)
                piv = tw[piv_idx]
                cnt = jnp.sum((piv <= word[:, None]) &
                              (frac > 0), axis=1).astype(jnp.int32)
                new_lo = lo + (span * cnt) // 16
                new_hi = lo + jnp.where(cnt < 15,
                                        (span * (cnt + 1)) // 16, span)
                keep = span > 16
                lo = jnp.where(keep, new_lo, lo)
                hi = jnp.where(keep, new_hi, hi)
            # final: 16-wide parallel compare (rows now span <= 16)
            offs = jnp.arange(16, dtype=jnp.int32)[None, :]
            idx16 = jnp.minimum(lo[:, None] + offs, M - 1)
            valid = lo[:, None] + offs < hi[:, None]
            eq = valid & (tw[idx16] == word[:, None])
            hit = jnp.any(eq, axis=1)
            pos = jnp.argmax(eq, axis=1)
            idx = jnp.minimum(lo + pos, M - 1)
            return hit, tables["trans_next"][idx], \
                tables["trans_prob"][idx]

    score = jnp.zeros(state.shape, jnp.float32)
    next_state = jnp.zeros(state.shape, jnp.int32)
    done = jnp.zeros(state.shape, bool)
    # contexts have length <= order-1, so at most `order` hops reach the
    # dense empty-context state (which always resolves)
    packed = "uni_packed" in tables

    def ic(x):
        return jax.lax.bitcast_convert_type(x, jnp.int32)

    # the uni row only depends on `word`: gather it once, not per hop
    if packed:
        uni_rows = tables["uni_packed"][word]              # [..., 2]
        up, un = uni_rows[..., 0], ic(uni_rows[..., 1])
    else:
        up = tables["uni_prob"][word]
        un = tables["uni_next"][word]
    uni_hit0 = up > NEG_INF / 2

    for hop in range(order):
        is_uni = state == 0
        hit, l_next, l_prob = lookup(state, word)
        hit = jnp.where(is_uni, uni_hit0, hit)
        nxt = jnp.where(is_uni, un, l_next)
        sc = jnp.where(is_uni, up, l_prob)
        take = hit & ~done
        next_state = jnp.where(take, nxt, next_state)
        score = jnp.where(take, score + sc, score)
        done = done | hit
        if packed:
            bo_rows = tables["bo_packed"][state]           # [..., 2]
            bo, bnxt = bo_rows[..., 0], ic(bo_rows[..., 1])
        else:
            bo = tables["bo_weight"][state]
            bnxt = tables["bo_next"][state]
        dead = ~done & (bo <= NEG_INF / 2)
        score = jnp.where(dead, NEG_INF, score)
        done = done | dead
        score = jnp.where(done, score, score + bo)
        state = jnp.where(done, state, bnxt)
    return next_state, score


def lm_walk_device_multi(lm, tables_list, states, word):
    """Joint walk of K member FSAs (InterTreeGram decode,
    `decoder/src/InterTreeGram.hh:41`): probability-domain
    interpolation over the member scores.

    states: [..., K]; word: [...].  Returns (next [..., K], score).
    """
    import jax.nn
    nxts, scores = [], []
    for k, tab in enumerate(tables_list):
        m = lm.members[k]
        nxt, sc = lm_walk_device(tab, m.num_words, m.order,
                                 states[..., k], word)
        nxts.append(nxt)
        scores.append(lm.log_coeffs[k] + sc)
    stacked = jnp.stack(scores, axis=0)
    score = jax.nn.logsumexp(jnp.maximum(stacked, NEG_INF), axis=0)
    score = jnp.where(jnp.all(stacked <= NEG_INF / 2, axis=0),
                      NEG_INF, score)
    return jnp.stack(nxts, axis=-1), score


class InterNGramFsa:
    """Linear interpolation of K backoff FSAs over a union vocabulary
    (`decoder/src/InterTreeGram.{hh,cc}`): decoding walks every member
    and mixes in the probability domain.  State = K member states."""

    def __init__(self, members: list, coeffs: list):
        if len(members) != len(coeffs):
            raise ValueError(
                "There must be as many interpolation coeffs as LMs")
        if not 0.99 <= sum(coeffs) <= 1.01:
            raise ValueError("Interpolation coeffs must sum to 1")
        self.members = list(members)
        self.coeffs = [float(c) for c in coeffs]
        self.log_coeffs = [float(np.log(max(c, 1e-30))) for c in coeffs]
        self.order = max(m.order for m in members)
        # members are built over the union vocabulary (from_arpas)
        self.num_words = members[0].num_words
        self.word_index = dict(members[0].word_index)
        self.num_states = sum(m.num_states for m in members)

    @property
    def vocab(self):
        return self.members[0].vocab

    @classmethod
    def from_arpas(cls, arpas: list, coeffs: list) -> "InterNGramFsa":
        """Remap every member onto the union vocabulary, then compile
        each to its FSA."""
        from aaltoasr_tpu.formats.arpa import ArpaLM
        union: list = []
        index: dict = {}
        for lm in arpas:
            for w in lm.vocab:
                if w not in index:
                    index[w] = len(union)
                    union.append(w)
        members = []
        for lm in arpas:
            remap = np.asarray([index[w] for w in lm.vocab],
                               dtype=np.int64)

            def rekey(d):
                return {tuple(int(remap[w]) for w in k): v
                        for k, v in d.items()}

            remapped = ArpaLM(
                order=lm.order, vocab=list(union),
                word_index=dict(index),
                ngrams=[rekey(g) for g in lm.ngrams])
            members.append(NGramFsa.from_arpa(remapped))
        return cls(members, coeffs)

    def initial_state(self, sentence_start: str = "<s>") -> np.ndarray:
        return np.asarray(
            [m.initial_state(sentence_start) for m in self.members],
            dtype=np.int32)

    def member_tables(self) -> list:
        return [m.device_tables() for m in self.members]

    def walk(self, states, word: int):
        """Host walk: (member states, word) -> (next states, score)."""
        nxts, scs = [], []
        for k, m in enumerate(self.members):
            n, sc = m.walk(int(states[k]), word)
            nxts.append(n)
            scs.append(self.log_coeffs[k] + sc)
        best = max(scs)
        if best <= NEG_INF / 2:
            return nxts, NEG_INF
        import math
        total = best + math.log(sum(math.exp(s - best) for s in scs))
        return nxts, total
