"""recognize: the batch recognition driver (pyrectool equivalent).

Replicates `pyrectool/rectool.py`'s stages with its reuse semantics
(rectool.py:613-634, 1045-1056): LNA generation via the scoring pipeline
(skip-if-exists), optional per-speaker adaptation (VTLN / CMLLR into a
.spkc, rectool.py:753-915), then decoding — batched on device instead of
per-frame SWIG calls — with 1-best output, optional SLF lattices and
n-best lists.  Defaults follow recognize-batch.sh:15-23.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from aaltoasr_tpu.decoder.toolbox import Toolbox
from aaltoasr_tpu.formats.lna import read_lna
from aaltoasr_tpu.formats.recipe import Recipe
from aaltoasr_tpu.models.phone_probs import PhoneProbs

# --engine auto split point: below it the exact engine (the accuracy
# mode) is used, above it the dense engine, whose throughput falls off
# less with tree size (divergence bounds in docs/ACCURACY.md).  The
# value was set from measurements on another accelerator and is to be
# re-derived from H100 cells on both sides of it; its H100 speeds are
# not measured.
AUTO_ENGINE_NODE_THRESHOLD = 100_000


def select_engine(n_nodes: int) -> str:
    """Scale-based engine choice for --engine auto."""
    return "dense" if n_nodes >= AUTO_ENGINE_NODE_THRESHOLD else "exact"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="recognize")
    p.add_argument("-b", "--am", required=True,
                   help="acoustic model base name")
    p.add_argument("-c", "--config", required=True,
                   help="feature configuration")
    p.add_argument("-l", "--lexicon", required=True)
    p.add_argument("-n", "--lm", required=True, help="ARPA language model")
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-w", "--workdir", required=True)
    p.add_argument("--dur", default="", help="duration file")
    p.add_argument("--beam", type=float, default=280.0)
    p.add_argument("--tokens", type=int, default=1024)
    p.add_argument("--lm-scale", type=float, default=30.0)
    p.add_argument("--duration-scale", type=float, default=3.0)
    p.add_argument("--insertion-penalty", type=float, default=0.0)
    p.add_argument("--adapt",
                   choices=["", "vtln", "mllr", "cmllr", "vtln+mllr"],
                   default="",
                   help="per-speaker adaptation before decoding "
                        "(rectool.py:900-912: mllr = feature-space "
                        "lin_transform 'mllr' module, cmllr = model-"
                        "space transforms, vtln+mllr = chained)")
    p.add_argument("--engine", choices=["auto", "exact", "dense"],
                   default="auto",
                   help="decoder engine: exact token passing, the "
                        "dense batched fast mode (node-level Viterbi "
                        "recombination), or auto (exact below 100k "
                        "tree nodes, dense above; dense-vs-exact "
                        "divergence is 0%% at moderate ambiguity, "
                        "<=0.9%% WER at 50-60%% ambiguous words, "
                        "docs/ACCURACY.md)")
    p.add_argument("--decode-batch", type=int, default=32,
                   help="utterances decoded together (dense engine)")
    p.add_argument("--overflow-tokens", type=int, default=0,
                   help="exact engine: branch-expansion budget "
                        "(0 = full exact expansion; ~tokens/8 "
                        "prunes like a beam)")
    p.add_argument("--lattices", action="store_true",
                   help="write SLF word graphs next to the LNAs")
    p.add_argument("--nbest", type=int, default=0,
                   help="print n-best lists")
    p.add_argument("--stateseg", action="store_true",
                   help="write <lna>.stateseg state-segmentation files "
                        "(recognize-stateseg.py workflow; "
                        "Toolbox.hh:261-265,334)")
    p.add_argument("--confidence", action="store_true",
                   help="print per-word confusion-network confidences")
    p.add_argument("--we-prewalk", type=int, default=0,
                   help="exact engine: LM-walk only the top-N word-end "
                        "candidates ranked by a static unigram "
                        "estimate (0 = walk everything, exact)")
    p.add_argument("--word-end-beam", type=float, default=0.0,
                   help="prune word ends vs the frame's best word end "
                        "(Toolbox.hh:205; rectool uses 2/3 of the "
                        "global beam); 0 = off")
    p.add_argument("--reentry-records", type=int, default=0,
                   help="exact engine: only the top-N best-first "
                        "record slots seed cross-word re-entry (all "
                        "records still written for lattices); 0 = all")
    p.add_argument("--reentry-prewalk", type=int, default=0,
                   help="exact engine: each re-entering record keeps "
                        "its top-N cross-word entry nodes; 0 = all")
    p.add_argument("--lookahead", type=int, default=0,
                   help="LM lookahead: 0 off, 1 unigram table, 2 "
                        "bigram table, 3 context/trigram "
                        "(TokenPassSearch.cc:2015/2084)")
    p.add_argument("--lookahead-ngram", default=None,
                   help="separate (smaller) ARPA for lookahead scores "
                        "(Toolbox::read_lookahead_ngram)")
    p.add_argument("--split-multiwords", action="store_true",
                   help="score multiwords (give_me) as component-word "
                        "sequences in the LM (Toolbox.hh:223-232)")
    p.add_argument("--no-require-end", action="store_true",
                   help="do not add P(</s>|h) when ranking final "
                        "hypotheses (rectool.py:537 always requires "
                        "the sentence end)")
    p.add_argument("--no-oss", action="store_true",
                   help="disable the optional short silence between "
                        "words (the reference defaults it ON, "
                        "TPLexPrefixTree.cc:54)")
    p.add_argument("-B", "--batch", type=int, default=0)
    p.add_argument("-I", "--bindex", type=int, default=0)
    p.add_argument("-i", "--info", type=int, default=0)
    args = p.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    recipe = Recipe.read(args.recipe, args.batch, args.bindex)

    # -- stage 1: adaptation (writes .spkc consumed by LNA generation)
    spkc_path = ""
    if args.adapt:
        spkc_path = os.path.join(args.workdir, f"{args.adapt}.spkc")
        if not os.path.exists(spkc_path):
            if args.info > 0:
                print(f"Estimating {args.adapt} adaptation",
                      file=sys.stderr)
            from aaltoasr_tpu.cli.mllr import main as mllr_main
            from aaltoasr_tpu.cli.vtln import main as vtln_main
            if args.adapt == "vtln":
                vtln_main(["-b", args.am, "-c", args.config,
                           "-r", args.recipe, "-o", spkc_path,
                           "-i", str(args.info)])
            elif args.adapt == "vtln+mllr":
                # rectool.py:901-908: estimate VTLN, then MLLR on top
                vtln_spkc = os.path.join(args.workdir, "vtln.spkc")
                if not os.path.exists(vtln_spkc):
                    vtln_main(["-b", args.am, "-c", args.config,
                               "-r", args.recipe, "-o", vtln_spkc,
                               "-i", str(args.info)])
                mllr_main(["-b", args.am, "-c", args.config,
                           "-r", args.recipe, "-o", spkc_path,
                           "-S", vtln_spkc, "-M", "mllr",
                           "-i", str(args.info)])
            elif args.adapt == "mllr":
                mllr_main(["-b", args.am, "-c", args.config,
                           "-r", args.recipe, "-o", spkc_path,
                           "-M", "mllr", "-i", str(args.info)])
            else:  # cmllr: model-space constrained transforms
                mllr_main(["-b", args.am, "-c", args.config,
                           "-r", args.recipe, "-o", spkc_path,
                           "--model-transform",
                           "-i", str(args.info)])
        elif args.info > 0:
            print(f"Reusing {spkc_path}", file=sys.stderr)

    # -- stage 2: LNA generation (skip-if-exists, rectool.py:613-634)
    pp = PhoneProbs(args.am, args.config, lna_bytes=2)
    if spkc_path:
        pp.read_speaker_config(spkc_path)
    lna_dir = os.path.join(args.workdir, "lna")
    os.makedirs(lna_dir, exist_ok=True)
    lna_paths = []
    for rinfo in recipe:
        name = (rinfo.lna_path or
                os.path.basename(rinfo.audio_path) + ".lna")
        path = os.path.join(lna_dir, os.path.basename(name))
        lna_paths.append(path)
        if os.path.exists(path):
            continue
        if args.info > 0:
            print(f"LNA: {rinfo.audio_path}", file=sys.stderr)
        pp.set_speaker(rinfo.speaker_id)
        pp.set_utterance(rinfo.utterance_id)
        pp.generate_to_file(rinfo.audio_path, path)

    # -- stage 3: decoding
    t = Toolbox(args.am + ".ph", args.dur)
    # morph-LM autodetection (rectool.py:432-496 parse_lm + :529-530,
    # :563-564): an LM whose unigrams contain '<w>' is a morph LM —
    # silences become words and the short silence commits '<w>'
    morph_lm = False
    with open(args.lm) as f:
        in1 = False
        for line in f:
            line = line.strip()
            if line == "\\1-grams:":
                in1 = True
                continue
            if in1:
                if line.startswith("\\"):
                    break
                parts = line.split()
                if len(parts) >= 2 and parts[1] == "<w>":
                    morph_lm = True
                    break
    if morph_lm:
        if args.info > 0:
            print("Morph-based language model", file=sys.stderr)
        t.set_silence_is_word(True)
        t.set_word_boundary("<w>")
    # the reference's lexical trees default the optional short silence
    # ON (TPLexPrefixTree.cc:54); rectool never disables it, and it
    # always requires the sentence end (rectool.py:537)
    t.set_optional_short_silence(not args.no_oss)
    t.set_require_sentence_end(not args.no_require_end)
    t.lex_read(args.lexicon)
    t.ngram_read(args.lm)
    t.set_global_beam(args.beam)
    t.set_token_limit(args.tokens)
    t.set_lm_scale(args.lm_scale)
    t.set_duration_scale(args.duration_scale)
    t.set_insertion_penalty(args.insertion_penalty)
    if args.overflow_tokens:
        t.set_overflow_tokens(args.overflow_tokens)
    if args.split_multiwords:
        t.set_split_multiwords(True)
    if args.we_prewalk:
        t.set_we_prewalk(args.we_prewalk)
    if args.word_end_beam:
        t.set_word_end_beam(args.word_end_beam)
    if args.reentry_records:
        t.set_reentry_records(args.reentry_records)
    if args.reentry_prewalk:
        t.set_reentry_prewalk(args.reentry_prewalk)
    if args.lookahead:
        t.set_lm_lookahead(args.lookahead)
    if args.lookahead_ngram:
        t.read_lookahead_ngram(args.lookahead_ngram)

    need_lattice = bool(args.lattices or args.nbest or args.confidence)

    def emit(rinfo, lna_path, res):
        key = rinfo.utterance_id or os.path.basename(lna_path)
        text = " ".join(res.words)
        if morph_lm:
            # rectool.py:1025-1037: morphs concatenate; boundaries
            # and sentence breaks become spaces
            text = text.replace(" ", "")
            text = text.replace("<w></s><s><w>", " ")
            text = text.replace("<w>", " ")
            text = text.replace("<s>", "").replace("</s>", "")
            text = " ".join(text.split())
        print(f"{text} ({key})")
        if args.stateseg:
            lp, _ = read_lna(lna_path)
            t.write_state_segmentation(lna_path + ".stateseg", res, lp)
        if need_lattice:
            g = res.word_graph()
            if args.lattices:
                g.write_slf(lna_path + ".slf")
            if args.nbest > 0:
                for i, (words, score) in enumerate(g.nbest(args.nbest)):
                    print(f"  {i + 1}: {' '.join(words)} ({score:.3f})")
            if args.confidence:
                from aaltoasr_tpu.decoder.wordgraph import (
                    confusion_network)
                cn = confusion_network(g)
                conf = " ".join(f"{w}({c:.2f})" for w, c, _ in cn)
                print(f"  conf: {conf}")

    engine = args.engine
    if engine == "auto":
        # Scale-based engine selection: the exact engine is the
        # accuracy mode, the dense engine scales better with the tree
        # (0% divergence at moderate ambiguity, <=0.9% WER at 50-60%
        # ambiguous words, docs/ACCURACY.md)
        n_nodes = t.tree.num_nodes
        engine = select_engine(n_nodes)
        if args.info >= 0:
            print(f"engine auto: {n_nodes} tree nodes -> {engine} "
                  f"(exact below {AUTO_ENGINE_NODE_THRESHOLD} nodes, "
                  "dense above; override with --engine exact|dense)",
                  file=sys.stderr)

    if engine == "dense":
        # batched fast mode: utterances padded to a shared frame count
        # and decoded together; 1-best traceback stays on device unless
        # lattices were requested
        from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch
        search = DenseBeamSearch(t.tree, t.lm, t.model, t.config)
        items = list(zip(recipe, lna_paths))
        for lo in range(0, len(items), args.decode_batch):
            group = items[lo:lo + args.decode_batch]
            obs_list = [read_lna(p)[0] for _, p in group]
            S = obs_list[0].shape[1]
            T = max(o.shape[0] for o in obs_list)
            obs = np.zeros((len(group), T, S), np.float32)
            n = np.zeros(len(group), np.int32)
            for i, o in enumerate(obs_list):
                obs[i, :o.shape[0]] = o
                n[i] = o.shape[0]
            results = search.decode_batch(obs, n,
                                          lattice=need_lattice)
            for (rinfo, lna_path), res in zip(group, results):
                emit(rinfo, lna_path, res)
        return 0

    for rinfo, lna_path in zip(recipe, lna_paths):
        emit(rinfo, lna_path,
             t.lna_decode(lna_path, lattice=need_lattice))
    return 0


if __name__ == "__main__":
    sys.exit(main())
