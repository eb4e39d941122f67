"""Diagnose the recurring planted-word miss in the dense bench rows
(the one miss in 35 words): locate the mismatching utterance/position,
print the planted plan around it, and re-decode with the exact engine
and with wider dense settings to classify the miss as (a) ambiguity by
construction, (b) truncation, or (c) a search error.
"""

import sys

import numpy as np
import jax

sys.path.insert(0, ".")
sys.path.insert(0, "benchmarks")

from bench_decode import synth_task, synth_obs  # noqa: E402
from aaltoasr_tpu.decoder.search import BeamSearch, SearchConfig  # noqa: E402
from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch  # noqa: E402


def main():
    model, tree, fsa = synth_task(num_words=1000, order=3,
                                  triphone=True, durations=True)
    info = synth_task.last_info
    B, T = 128, 1000
    obs_fn, true_words = synth_obs(model, info, B, T)
    obs = jax.jit(obs_fn)(jax.random.PRNGKey(1))
    n = np.full(B, T, np.int32)

    # replant to recover the per-word frame spans (synth_obs's rng is
    # deterministic: seed 1)
    # -> recompute plan segments per batch element
    rng = np.random.default_rng(1)
    from aaltoasr_tpu.decoder.lexicon import _resolve_context
    phone_map = {p.label: p for p in model.phones}
    prons, words = info["prons"], info["words"]
    follow = info.get("follow", {})
    spans = []  # per b: list of (word_id, t_start, t_end, fully_planted)
    for b in range(B):
        t = 0
        seq = []
        prev_last = "_"

        def next_word(prev):
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
                lbl = (_resolve_context(phone_map, l, c, r) or c) \
                    if info["triphone"] else c
                states.extend(phone_map[lbl].states)
            start = t
            state_ds = []
            for s in states:
                if getattr(model, "durations", None) is not None:
                    a, bb = model.durations[s]
                    d = int(np.clip(round(rng.gamma(a, bb)), 1, 12))
                else:
                    d = int(rng.integers(2, 6))
                state_ds.append((s, t, min(t + d, T)))
                t += d
                if t >= T:
                    break
            seq.append((w, start, min(t, T), t < T, state_ds))
            prev_last = p[-1]
            w = w_next
        spans.append(seq)

    def report(name, res):
        print(f"== {name}")
        for b in range(4):
            ref = [f"w{i}" for i, _, _, full, _ in spans[b] if full]
            hyp = list(res[b].words)
            if hyp == ref:
                continue
            print(f"b={b}: ref {len(ref)} words, hyp {len(hyp)}")
            # align by position
            import difflib
            sm = difflib.SequenceMatcher(a=ref, b=hyp)
            for op, i1, i2, j1, j2 in sm.get_opcodes():
                if op == "equal":
                    continue
                print(f"  {op}: ref[{i1}:{i2}]={ref[i1:i2]} "
                      f"hyp[{j1}:{j2}]={hyp[j1:j2]}")
                for k in range(i1, i2):
                    full_spans = [s for s in spans[b] if s[3]]
                    w, s0, s1, _, sds = full_spans[k]
                    print(f"    missed w{w} pron={prons[w]} "
                          f"frames [{s0},{s1}) "
                          f"state durs={[(int(s), e - st) for s, st, e in sds]}")
                    # neighbors
                    if k > 0:
                        pw = full_spans[k - 1]
                        print(f"    prev w{pw[0]} pron={prons[pw[0]]} "
                              f"frames [{pw[1]},{pw[2]})")
                    if k + 1 < len(full_spans):
                        nw = full_spans[k + 1]
                        print(f"    next w{nw[0]} pron={prons[nw[0]]} "
                              f"frames [{nw[1]},{nw[2]})")

    cfg = SearchConfig(lm_scale=30.0, duration_scale=3.0,
                       num_records=32, records_half=True)
    dense = DenseBeamSearch(tree, fsa, model, cfg)
    res = dense.decode_batch(obs, n, lattice=False)
    report("dense (bench settings)", res)

    # wider dense: does more search fix it?
    cfg_w = SearchConfig(lm_scale=30.0, duration_scale=3.0,
                         num_records=64, records_half=False)
    dense_w = DenseBeamSearch(tree, fsa, model, cfg_w)
    res_w = dense_w.decode_batch(obs, n, lattice=False)
    report("dense (records=64, full)", res_w)

    # exact engine at the same operating point
    cfg_e = SearchConfig(lm_scale=30.0, duration_scale=3.0,
                         num_tokens=1024, num_records=32,
                         overflow_tokens=128, we_prewalk=256,
                         reentry_records=8, reentry_prewalk=8)
    exact = BeamSearch(tree, fsa, model, cfg_e)
    res_e = exact.decode_batch(obs, n, lattice=False)
    report("exact (W=1024)", res_e)

    # lower lm_scale: is the miss an LM-vs-acoustics tradeoff?
    cfg_l = SearchConfig(lm_scale=10.0, duration_scale=3.0,
                         num_records=32, records_half=True)
    dense_l = DenseBeamSearch(tree, fsa, model, cfg_l)
    res_l = dense_l.decode_batch(obs, n, lattice=False)
    report("dense (lm_scale=10)", res_l)


if __name__ == "__main__":
    main()
