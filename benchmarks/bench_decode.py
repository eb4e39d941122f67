"""Batched LVCSR decode benchmark (dense mode).

Synthetic but realistically-shaped task: ~1k-word lexicon over a
25-phone 3-state inventory (~9k tree nodes), bigram backoff FSA,
batch of 10-second utterances.  Prints one JSON line with the
real-time factor per chip.

Usage: python benchmarks/bench_decode.py [--batch 64] [--frames 1000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def synth_task(num_words=1000, num_phones=25, seed=0, order=2,
               triphone=False, durations=False, tied_variants=6):
    """Synthetic decode task shaped like the reference's operating point.

    triphone=True builds a decision-tree-tied cross-word triphone
    inventory (the reference default model family, `train.pl` ties
    context phones via PhonePool): every triphone label ``l-c+r`` the
    lexicon's cross-word expansion can ask for is present, with its 3
    states drawn from a tied-state pool keyed by (center, position,
    left-class, right-class) — the classic tied-state layout, so
    `build_prefix_tree` takes the `_build_crossword_tree` fan-in/out
    path (`decoder/src/TPLexPrefixTree.hh:172-240`).
    durations=True attaches per-state gamma duration params (`.dur`,
    `dur_est.cc`), decoded with duration_scale 3 (`rectool.py:547`).
    """
    from aaltoasr_tpu.decoder.lexicon import build_prefix_tree
    from aaltoasr_tpu.decoder.ngram import NGramFsa
    from aaltoasr_tpu.formats import model_io
    from aaltoasr_tpu.formats.arpa import ArpaLM

    rng = np.random.default_rng(seed)
    phones = [f"p{i}" for i in range(num_phones)] + ["_"]
    D = 39

    # silence entries: the triphone (cross-word) task mirrors the
    # reference's default inventory — a 1-emitting-state '_' (the
    # optional short silence woven into the fan network) plus a
    # 3-state long silence '__'; the monophone task keeps one 3-state
    # '_'
    lex_lines = ["_ _", "__ __"] if triphone else ["_ _"]
    words = []
    prons = []
    for w in range(num_words):
        n = int(rng.integers(3, 9))
        pron = [phones[int(rng.integers(num_phones))] for _ in range(n)]
        prons.append(pron)
        words.append(f"w{w}")
        lex_lines.append(f"w{w} " + " ".join(pron))

    if triphone:
        # tied-state pool: (center, position, left-class, right-class)
        # -> state id; tied_variants classes per side mimic decision-
        # tree leaf counts (~1.5k tied states at the defaults)
        import zlib

        def cls(p, salt):
            return zlib.crc32(f"{p}|{salt}".encode()) % tied_variants

        state_key: dict = {}

        def tied_state(c, pos, l, r):
            k = (c, pos, cls(l, 0), cls(r, 1))
            if k not in state_key:
                state_key[k] = len(state_key)
            return state_key[k]

        labels: dict = {}

        def add_tri(l, c, r):
            lbl = f"{l}-{c}+{r}"
            if lbl not in labels:
                labels[lbl] = [tied_state(c, pos, l, r)
                               for pos in range(3)]

        classes = sorted({p[0] for p in prons}
                         | {p[-1] for p in prons} | {"_"})
        for p in prons:
            for i in range(1, len(p) - 1):
                add_tri(p[i - 1], p[i], p[i + 1])
            for c in classes:              # cross-word fan-in/fan-out
                add_tri(c, p[0], p[1])
                add_tri(p[-2], p[-1], c)
        # silences: 1-state '_' (short, oss) + 3-state '__' (long)
        sil0 = len(state_key)
        S = sil0 + 4
        model_phones = (
            [model_io.HmmPhone(lbl, sts) for lbl, sts in labels.items()]
            + [model_io.HmmPhone("_", [sil0]),
               model_io.HmmPhone("__", [sil0 + 1, sil0 + 2, sil0 + 3])])
        means = rng.normal(0, 2, (S, D))
        model = model_io.HmmModel(
            dim=D, cov_type="diagonal_cov", means=means,
            covars=np.ones((S, D)),
            mixtures=[(np.array([i], np.int32), np.array([1.0]))
                      for i in range(S)],
            phones=model_phones,
            transitions={i: [(0, 0.5), (1, 0.5)] for i in range(S)})
    else:
        S = 3 * len(phones)
        means = rng.normal(0, 2, (S, D))
        model = model_io.HmmModel(
            dim=D, cov_type="diagonal_cov", means=means,
            covars=np.ones((S, D)),
            mixtures=[(np.array([i], np.int32), np.array([1.0]))
                      for i in range(S)],
            phones=[model_io.HmmPhone(p, [3 * i, 3 * i + 1, 3 * i + 2])
                    for i, p in enumerate(phones)],
            transitions={i: [(0, 0.5), (1, 0.5)] for i in range(S)})
    if durations:
        # gamma (a, b) per state, the dur_est.cc model family
        model.durations = np.stack(
            [rng.uniform(1.5, 4.0, S), rng.uniform(1.5, 4.0, S)],
            axis=1)

    vocab = ["<s>", "</s>"] + words
    word_index = {w: i for i, w in enumerate(vocab)}
    uni = {(word_index[v],): (float(np.log(1.0 / len(vocab))), -0.7)
           for v in vocab}
    bi = {}
    for _ in range(num_words * 10):
        a = word_index[words[int(rng.integers(num_words))]]
        b = word_index[words[int(rng.integers(num_words))]]
        bo = -0.5 if order > 2 else 0.0
        bi[(a, b)] = (float(np.log(0.01 + rng.random() * 0.05)), bo)
    grams = [{}, uni, bi]
    if order >= 3:
        tri = {}
        bikeys = list(bi)
        for _ in range(num_words * 20):
            a, b = bikeys[int(rng.integers(len(bikeys)))]
            c = word_index[words[int(rng.integers(num_words))]]
            tri[(a, b, c)] = (
                float(np.log(0.02 + rng.random() * 0.1)), 0.0)
        grams.append(tri)
    lm = ArpaLM(order=order, vocab=vocab, word_index=word_index,
                ngrams=grams)

    from aaltoasr_tpu.decoder.lexicon import read_lexicon
    tree = build_prefix_tree(model, read_lexicon("\n".join(lex_lines)),
                             optional_short_silence=triphone)
    fsa = NGramFsa.from_arpa(lm)
    # bigram successor lists (indices into `words`): synth_obs plants
    # sequences that FOLLOW the LM's own bigrams — with a random LM, a
    # random word sequence pays backoff+unigram at every boundary and
    # alternate segmentations with fewer word ends legitimately win
    follow: dict = {}
    for (a, b) in bi:
        if a >= 2 and b >= 2:
            follow.setdefault(a - 2, []).append(b - 2)
    synth_task.last_info = {"prons": prons, "words": words,
                            "phones": phones, "triphone": triphone,
                            "follow": follow, "lexicon": lex_lines,
                            "lm": lm}
    return model, tree, fsa


def synth_obs(model, info, B, T, seed=1, gain=8.0, noise=2.0):
    """Structured observations: plant a random word sequence per batch
    element (states via the model's own cross-word context resolution,
    2-5 frames per state) and emit log-probs = noise + gain on the true
    state.  Random iid observations make beam decode degenerate (the
    best path loiters on one self-loop and never pays an LM score);
    planted sequences make the bench decode actual words like real
    LNAs do.  Returns (obs_fn(key) -> [B,T,S] device array, true word
    id sequences) — obs are built on device from the [B,T] state plan
    (a [B,T,S] host upload would be ~GBs).
    """
    import jax
    import jax.numpy as jnp
    from aaltoasr_tpu.decoder.lexicon import _resolve_context

    rng = np.random.default_rng(seed)
    phone_map = {p.label: p for p in model.phones}
    prons, words = info["prons"], info["words"]
    follow = info.get("follow", {})
    plan = np.zeros((B, T), np.int32)
    true_words = []
    for b in range(B):
        t = 0
        seq = []
        prev_last = "_"

        def next_word(prev):
            # ride the LM's bigram mass when the previous word has
            # successors (the planted path must be LM-plausible, not
            # just acoustically favored)
            nx = follow.get(prev)
            if nx:
                return int(nx[int(rng.integers(len(nx)))])
            return int(rng.integers(len(words)))

        w = next_word(-1)
        while t < T:
            p = prons[w]
            w_next = next_word(w)
            nxt = prons[w_next][0]
            states = []
            for j, c in enumerate(p):
                l = p[j - 1] if j > 0 else prev_last
                r = p[j + 1] if j + 1 < len(p) else nxt
                if info["triphone"]:
                    lbl = _resolve_context(phone_map, l, c, r) or c
                else:
                    lbl = c
                states.extend(phone_map[lbl].states)
            start = t
            for s in states:
                if getattr(model, "durations", None) is not None:
                    # stay lengths from the model's own gamma so the
                    # duration model (scale 3) rewards the true path
                    a, bb = model.durations[s]
                    d = int(np.clip(round(rng.gamma(a, bb)), 1, 12))
                else:
                    d = int(rng.integers(2, 6))
                plan[b, t:t + d] = s
                t += d
                if t >= T:
                    break
            if t < T:          # word fully planted
                seq.append(w)
            prev_last = p[-1]
            w = w_next
        true_words.append(seq)
    plan_dev = jnp.asarray(plan)
    S = model.num_states

    def obs_fn(key):
        z = jax.random.normal(key, (B, T, S), jnp.float32) * noise - 5.0
        oh = jax.nn.one_hot(plan_dev, S, dtype=jnp.float32) * gain
        return z + oh

    return obs_fn, true_words


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--frames", type=int, default=1000)
    p.add_argument("--words", type=int, default=1000)
    p.add_argument("--records", type=int, default=32,
                   help="word-end records per frame (lattice richness)")
    p.add_argument("--order", type=int, default=2,
                   help="n-gram order of the synthetic LM")
    p.add_argument("--triphone", action="store_true",
                   help="tied cross-word triphone task (reference "
                        "default model family)")
    p.add_argument("--durations", action="store_true",
                   help="gamma duration model, scale 3 (rectool.py:547)")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    from aaltoasr_tpu.decoder.search import SearchConfig
    from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch

    model, tree, fsa = synth_task(num_words=args.words, order=args.order,
                                  triphone=args.triphone,
                                  durations=args.durations)
    print(f"tree nodes: {tree.num_nodes}, lm states: {fsa.num_states}",
          flush=True)
    cfg = SearchConfig(
        lm_scale=30.0,
        duration_scale=3.0 if args.durations else 0.0,
        num_records=args.records)
    search = DenseBeamSearch(tree, fsa, model, cfg)

    B, T = args.batch, args.frames
    # obs generated on device from a planted word-sequence state plan
    # (production LNAs are produced on-chip by the scoring pipeline;
    # host->device upload is not part of decode)
    obs_fn, _ = synth_obs(model, synth_task.last_info, B, T)
    obs = jax.jit(obs_fn)(jax.random.PRNGKey(1))
    n = np.full(B, T, np.int32)

    res = search.decode_batch(obs, n, lattice=False)   # compile+run
    t0 = time.perf_counter()
    res = search.decode_batch(obs, n, lattice=False)
    dt = time.perf_counter() - t0
    # reference operating point is 125 fps (doc/feature_configuration.
    # txt:50-56): T frames = T/125 seconds of audio
    audio_sec = B * T / 125.0
    xrt = audio_sec / dt
    print(json.dumps({
        "metric": "dense_decode_realtime_factor",
        "value": round(xrt, 2), "unit": "x realtime/chip",
        "batch": B, "frames": T, "wall_sec": round(dt, 3)}))


if __name__ == "__main__":
    main()
