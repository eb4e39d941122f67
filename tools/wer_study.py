"""WER study: quantify the dense engine's node-level Viterbi
approximation against the exact token-passing engine (and the built
reference C++ decoder) across noise levels.

The dense engine (`decoder/search_dense.py`) recombines hypotheses with
different LM histories per tree node — a deliberate speed/accuracy
trade the reference does not make (`TokenPassSearch.cc:695-1400` keeps
one token per (node, LM history)).  This study puts a number on that
trade: planted-truth WER for each engine and pairwise 1-best agreement
on the ~1000-word golden battery task (tests/test_golden_lattice.py),
sweeping the acoustic noise level.

Run: python tools/wer_study.py [--utts 50] [--words 1000]
     [--noise 0.25,0.35,0.5,0.7] [--no-reference] [--out docs/ACCURACY.md]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "tests"))


def synth_ambig(tmp, model, lex, word_seq, decoys, seed, noise,
                name):
    """LNA planting word_seq, but each word whose decoy is not None is
    acoustically BLENDED with the decoy's states (both at log 0.5 -
    noise): the acoustics alone cannot tell them apart, so the decode
    must disambiguate by LM context — the regime where the dense
    engine's node-level history recombination can differ from the
    exact engine and the reference."""
    from aaltoasr_tpu.formats.lna import write_lna
    rng = np.random.default_rng(seed)
    phone_of = {ph.label: ph for ph in model.phones}
    segs = []
    for w, d in zip(word_seq, decoys):
        ws = [s2 for ph in lex[w] for s2 in phone_of[ph].states]
        if d is None:
            segs.extend([(s2, None) for s2 in ws for _ in range(2)])
        else:
            ds = [s2 for ph in lex[d] for s2 in phone_of[ph].states]
            assert len(ds) == len(ws)
            segs.extend([(a, b) for a, b in zip(ws, ds)
                         for _ in range(2)])
    sil = phone_of["__"].states
    segs = ([(s2, None) for s2 in sil for _ in range(2)] + segs
            + [(s2, None) for s2 in sil for _ in range(2)])
    T = len(segs)
    S = model.num_states
    lp = np.full((T, S), -8.0, np.float32)
    for t2, (a, b) in enumerate(segs):
        if b is None:
            lp[t2, a] = -0.5
        else:
            lp[t2, a] = -1.2          # ~log 0.3 each: a true toss-up
            lp[t2, b] = -1.2
    lp += noise * rng.standard_normal((T, S)).astype(np.float32)
    lp = lp - np.log(np.sum(np.exp(lp), axis=1, keepdims=True))
    write_lna(str(tmp / name), lp, lna_bytes=2)
    return str(tmp / name)


def synth_ambig_xw(tmp, model, lex, word_seq, decoys, seed, noise,
                   name):
    """Cross-word triphone variant of synth_ambig: state chains are
    resolved with contexts from the TRUE neighboring words (for both
    the word and its decoy, so the blend stays frame-aligned)."""
    from aaltoasr_tpu.formats.lna import write_lna
    rng = np.random.default_rng(seed)
    phone_of = {ph.label: ph for ph in model.phones}

    def chain(ps, left_ctx, right_ctx):
        states = []
        for j, p2 in enumerate(ps):
            left = ps[j - 1] if j else left_ctx
            right = ps[j + 1] if j + 1 < len(ps) else right_ctx
            states.extend(phone_of[f"{left}-{p2}+{right}"].states)
        return states

    segs = []
    for i, (w, d) in enumerate(zip(word_seq, decoys)):
        left = lex[word_seq[i - 1]][-1] if i else "_"
        right = (lex[word_seq[i + 1]][0]
                 if i + 1 < len(word_seq) else "_")
        ws = chain(lex[w], left, right)
        if d is None:
            segs.extend([(s2, None) for s2 in ws for _ in range(2)])
        else:
            ds = chain(lex[d], left, right)
            segs.extend([(a, b) for a, b in zip(ws, ds)
                         for _ in range(2)])
    sil = phone_of["__"].states
    segs = ([(s2, None) for s2 in sil for _ in range(2)] + segs
            + [(s2, None) for s2 in sil for _ in range(2)])
    T = len(segs)
    S = model.num_states
    lp = np.full((T, S), -8.0, np.float32)
    for t2, (a, b) in enumerate(segs):
        if b is None:
            lp[t2, a] = -0.5
        else:
            lp[t2, a] = -1.2
            lp[t2, b] = -1.2
    lp += noise * rng.standard_normal((T, S)).astype(np.float32)
    lp = lp - np.log(np.sum(np.exp(lp), axis=1, keepdims=True))
    write_lna(str(tmp / name), lp, lna_bytes=2)
    return str(tmp / name)


def decode_battery_xw(tmp, lnas, engine: str, token_limit=4096):
    """Batched decode at the cross-word + duration operating point.

    engine "bench" = the exact engine with bench.py's
    exact_crossword_trigram_xrt pruning set (W=512, records=32,
    overflow 128, word-end prewalk 256, re-entry records 8 /
    prewalk 8) — quantifies what the benched knobs cost vs the
    wide-open exact engine."""
    from aaltoasr_tpu.decoder.toolbox import Toolbox
    from aaltoasr_tpu.formats.lna import read_lna

    t = Toolbox(str(tmp / "m.ph"), str(tmp / "m.dur"))
    t.set_lm_scale(10.0)
    t.set_global_beam(220.0)
    t.set_token_limit(token_limit)
    if engine == "bench":
        t.set_token_limit(512)
        t.config.num_records = 32
        t.set_overflow_tokens(128)
        t.set_we_prewalk(256)
        t.set_reentry_records(8)
        t.set_reentry_prewalk(8)
    t.set_duration_scale(3.0)
    t.set_transition_scale(1.0)
    t.set_require_sentence_end(True)
    t.set_silence_is_word(False)
    t.set_optional_short_silence(True)
    t.lex_read(str(tmp / "our_lex.dict"))
    t.set_sentence_boundary("<s>", "</s>")
    t.ngram_read(str(tmp / "lm.arpa"))
    lps = [read_lna(p2)[0] for p2 in lnas]
    T = max(lp.shape[0] for lp in lps)
    obs = np.stack([np.pad(lp, ((0, T - lp.shape[0]), (0, 0)))
                    for lp in lps])
    n = np.asarray([lp.shape[0] for lp in lps], np.int32)
    if engine == "dense":
        from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch
        search = DenseBeamSearch(t.tree, t.lm, t.model, t.config)
        results = search.decode_batch(obs, n, lattice=False)
    else:
        results = t.decode_batch(obs, n, lattice=False)
    return [[w for w in r.words if w not in ("<s>", "</s>")]
            for r in results]


def wer_counts(refs: list, hyps: list) -> tuple:
    """Total (errors, ref_words) over paired word lists."""
    from aaltoasr_tpu.cli.wer import align_counts
    err = n = 0
    for r, h in zip(refs, hyps):
        s, d, i = align_counts(r, h)
        err += s + d + i
        n += len(r)
    return err, n


def decode_battery(tmp, lnas, engine: str, token_limit=2048):
    """Batched 1-best decode of the battery with one engine."""
    from aaltoasr_tpu.decoder.toolbox import Toolbox
    from aaltoasr_tpu.formats.lna import read_lna

    t = Toolbox(str(tmp / "m.ph"))
    t.set_lm_scale(10.0)
    t.set_global_beam(140.0)
    t.set_token_limit(token_limit)
    t.set_duration_scale(0.0)
    t.set_transition_scale(1.0)
    t.set_require_sentence_end(True)
    t.set_silence_is_word(False)
    t.set_optional_short_silence(True)
    t.set_lm_lookahead(1)
    t.lex_read(str(tmp / "lex.dict"))
    t.set_sentence_boundary("<s>", "</s>")
    t.ngram_read(str(tmp / "lm.arpa"))

    lps = [read_lna(p)[0] for p in lnas]
    T = max(lp.shape[0] for lp in lps)
    obs = np.stack([np.pad(lp, ((0, T - lp.shape[0]), (0, 0)))
                    for lp in lps])
    n = np.asarray([lp.shape[0] for lp in lps], np.int32)
    if engine == "dense":
        from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch
        search = DenseBeamSearch(t.tree, t.lm, t.model, t.config)
        results = search.decode_batch(obs, n, lattice=False)
    else:
        results = t.decode_batch(obs, n, lattice=False)
    return [[w for w in r.words if w not in ("<s>", "</s>")]
            for r in results]


def main() -> int:
    p = argparse.ArgumentParser(prog="wer_study")
    p.add_argument("--words", type=int, default=1000)
    p.add_argument("--utts", type=int, default=50)
    p.add_argument("--noise", default="0.25,0.35,0.5,0.7")
    p.add_argument("--ambig", default="0",
                   help="comma list: per-word probability of blending "
                        "the word's acoustics with a same-length decoy "
                        "word (LM must disambiguate)")
    p.add_argument("--token-limit", type=int, default=2048)
    p.add_argument("--crossword", action="store_true",
                   help="run on the cross-word triphone + duration "
                        "battery task (the headline bench operating "
                        "point) instead of the monophone battery")
    p.add_argument("--bench-knobs", action="store_true",
                   help="with --crossword: add an 'exact with "
                        "bench.py's pruning knobs' engine and report "
                        "its WER + agreement vs the wide-open exact "
                        "engine")
    p.add_argument("--no-reference", action="store_true",
                   help="skip the reference C++ driver rows")
    p.add_argument("--out", default=None,
                   help="write/refresh a markdown report here")
    args = p.parse_args()

    import subprocess

    from test_golden_decode import DRIVER, synth_lna
    from test_golden_lattice import make_battery_task
    if args.crossword:
        from test_golden_crossword_battery import (
            make_battery as make_xw_battery)

    def ref_decode(tmp_path, lna):
        # 1-best only: --wordgraph makes the reference decoder several
        # times slower and the study needs hundreds of decodes
        out = subprocess.run(
            [DRIVER, "--ph", str(tmp_path / "m.ph"),
             "--lex", str(tmp_path / "lex.dict"),
             "--arpa", str(tmp_path / "lm.arpa"), "--lna", lna,
             "--beam", "140", "--token-limit", "30000",
             "--lm-scale", "10", "--dur-scale", "0",
             "--trans-scale", "1", "--no-crossword",
             "--lookahead", str(tmp_path / "lm.arpa")],
            check=True, capture_output=True, text=True, timeout=600)
        return [w for w in out.stdout.split()
                if w not in ("<s>", "</s>", "*")]

    def ref_decode_xw(tmp_path, lna):
        out = subprocess.run(
            [DRIVER, "--ph", str(tmp_path / "m.ph"),
             "--dur", str(tmp_path / "m.dur"),
             "--lex", str(tmp_path / "ref_lex.dict"),
             "--arpa", str(tmp_path / "lm.arpa"), "--lna", lna,
             "--beam", "220", "--token-limit", "60000",
             "--lm-scale", "10", "--dur-scale", "3",
             "--trans-scale", "1"],
            check=True, capture_output=True, text=True, timeout=600)
        return [w for w in out.stdout.split()
                if w not in ("<s>", "</s>", "*")]

    use_ref = (not args.no_reference) and os.path.exists(DRIVER)
    if not args.no_reference and not use_ref:
        print("reference driver not built; continuing without it",
              file=sys.stderr)

    noise_levels = [float(x) for x in args.noise.split(",")]
    ambig_levels = [float(x) for x in args.ambig.split(",")]
    rows = []
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        if args.crossword:
            model, lexd = make_xw_battery(
                tmp, num_words=min(args.words, 1000))
            lex = dict(sorted(lexd.items()))
        else:
            model, lex, wi = make_battery_task(tmp,
                                               num_words=args.words)
        words = sorted(lex)
        for noise in noise_levels:
          for ambig in ambig_levels:
            rng = np.random.default_rng(
                int(1000 * noise) + int(100 * ambig) + 7)
            by_len: dict = {}
            for w in words:
                by_len.setdefault(len(lex[w]), []).append(w)
            lnas, truths = [], []
            for i in range(args.utts):
                seq = [words[int(rng.integers(len(words)))]
                       for _ in range(int(rng.integers(3, 7)))]
                if ambig > 0:
                    decoys = []
                    for w in seq:
                        cand = by_len[len(lex[w])]
                        if (rng.random() < ambig
                                and len(cand) > 1):
                            d = w
                            while d == w:
                                d = cand[int(rng.integers(len(cand)))]
                            decoys.append(d)
                        else:
                            decoys.append(None)
                    fn = (synth_ambig_xw if args.crossword
                          else synth_ambig)
                    lnas.append(fn(
                        tmp, model, lex, seq, decoys, seed=5000 + i,
                        noise=noise,
                        name=f"n{int(100 * noise)}_{i}.lna"))
                elif args.crossword:
                    lnas.append(synth_ambig_xw(
                        tmp, model, lex, seq, [None] * len(seq),
                        seed=5000 + i, noise=noise,
                        name=f"n{int(100 * noise)}_{i}.lna"))
                else:
                    lnas.append(synth_lna(
                        tmp, model, lex, seq, seed=5000 + i,
                        noise=noise, frames_per_state=2,
                        name=f"n{int(100 * noise)}_{i}.lna"))
                truths.append(seq)

            dec = decode_battery_xw if args.crossword \
                else decode_battery
            hyp = {"exact": dec(tmp, lnas, "exact", args.token_limit),
                   "dense": dec(tmp, lnas, "dense", args.token_limit)}
            if args.crossword and args.bench_knobs:
                hyp["bench"] = dec(tmp, lnas, "bench",
                                   args.token_limit)
            if use_ref:
                hyp["reference"] = [
                    ref_decode_xw(tmp, l) if args.crossword
                    else ref_decode(tmp, l) for l in lnas]

            row = {"noise": noise, "ambig": ambig}
            for name, hs in hyp.items():
                err, n = wer_counts(truths, hs)
                row[f"wer_{name}"] = 100.0 * err / max(n, 1)
            derr, dn = wer_counts(hyp["exact"], hyp["dense"])
            row["dense_vs_exact_wer"] = 100.0 * derr / max(dn, 1)
            row["dense_exact_agree"] = sum(
                a == b for a, b in zip(hyp["exact"], hyp["dense"]))
            if "bench" in hyp:
                row["bench_exact_agree"] = sum(
                    a == b for a, b in zip(hyp["exact"], hyp["bench"]))
            if use_ref:
                row["exact_ref_agree"] = sum(
                    a == b for a, b in
                    zip(hyp["exact"], hyp["reference"]))
            rows.append(row)
            print(f"noise={noise}: " + "  ".join(
                f"{k}={v:.2f}" if isinstance(v, float) and k != "noise"
                else f"{k}={v}" for k, v in row.items()), flush=True)

    has_bench = any("bench_exact_agree" in r for r in rows)
    hdr = ["noise", "ambig", "WER exact %", "WER dense %"]
    if has_bench:
        hdr.append("WER exact-bench-knobs %")
    if use_ref:
        hdr.append("WER reference %")
    hdr += ["dense-vs-exact WER %", f"dense==exact (of {args.utts})"]
    if has_bench:
        hdr.append(f"bench==exact (of {args.utts})")
    if use_ref:
        hdr.append(f"exact==reference (of {args.utts})")
    lines = ["| " + " | ".join(hdr) + " |",
             "|" + "---|" * len(hdr)]
    for r in rows:
        cells = [f"{r['noise']:.2f}", f"{r['ambig']:.2f}",
                 f"{r['wer_exact']:.2f}", f"{r['wer_dense']:.2f}"]
        if has_bench:
            cells.append(f"{r['wer_bench']:.2f}")
        if use_ref:
            cells.append(f"{r['wer_reference']:.2f}")
        cells += [f"{r['dense_vs_exact_wer']:.2f}",
                  str(r["dense_exact_agree"])]
        if has_bench:
            cells.append(str(r["bench_exact_agree"]))
        if use_ref:
            cells.append(str(r["exact_ref_agree"]))
        lines.append("| " + " | ".join(cells) + " |")
    table = "\n".join(lines)
    print("\n" + table)

    if args.out:
        doc = (
            "# Accuracy: dense-engine approximation, measured\n\n"
            "The dense serving engine recombines hypotheses with "
            "different LM histories at each tree node "
            "(`decoder/search_dense.py`), where the exact engine — "
            "like the reference `TokenPassSearch` — keeps one token "
            "per (node, LM history).  This table quantifies that "
            "approximation on the ~1000-word golden battery task "
            "(`tests/test_golden_lattice.py`): planted-truth WER per "
            "engine, the dense engine's WER measured against the "
            "exact engine's output, and utterance-level 1-best "
            "agreement.  Plain planted noise produces 0% WER on every "
            "engine up to noise 3.0 (the favored-state margin "
            "dominates), so the informative axis is AMBIGUITY: with "
            "probability `ambig`, a word's acoustics are blended "
            "50/50 with a same-length decoy word, and only LM context "
            "can disambiguate — exactly where per-node history "
            "recombination can diverge from exact token passing.\n\n"
            f"Task: {args.words}-word lexicon, bigram LM, LM lookahead "
            f"on, beam 140, token limit {args.token_limit}, "
            f"{args.utts} utterances per (noise, ambig) level "
            "(`tools/wer_study.py`).\n\n" + table + "\n\n"
            "Generated by `python tools/wer_study.py --out "
            "docs/ACCURACY.md`.\n")
        Path(args.out).write_text(doc)
        print(f"\nwrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
