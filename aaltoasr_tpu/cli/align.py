"""align: Viterbi forced alignment, writes state-level .phn files.

Equivalent of the reference tool (`aku/align.cc:171-347`).  Where the
reference runs a moving-window Viterbi (window 4000 frames, `align.cc:60`)
to bound memory, the device path runs the dense scan over the whole utterance
(the [T, P] lattice fits HBM comfortably; windowing is unnecessary).
Output lines are ``start_sample end_sample label.state`` with the 16 kHz
sample convention (`align.cc` print_line: frame * int(16000/frame_rate)).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import jax.numpy as jnp

from aaltoasr_tpu.cli.phone_probs import load_model
from aaltoasr_tpu.formats.phn import read_phn
from aaltoasr_tpu.formats.recipe import Recipe
from aaltoasr_tpu.formats.spkc import SpeakerConfig
from aaltoasr_tpu.frontend.audio import read_audio
from aaltoasr_tpu.frontend.generator import FeatureGenerator
from aaltoasr_tpu.models.hmm import TransitionTable, build_chain, pad_chain
from aaltoasr_tpu.ops.gmm import GmmScorer
from aaltoasr_tpu.ops.logsemiring import logsumexp
from aaltoasr_tpu.train import estep


def align_utterance(model, table, scorer, fg, samples, labels):
    """Returns (segments, score): segments = (start_f, end_f, label, state)."""
    feats = fg.features(samples)
    chain = build_chain(model, table, labels)
    gll = scorer.gaussian_log_likelihoods(feats)
    sll = logsumexp(gll[:, scorer.comp_idx] + scorer.comp_logw, axis=-1)
    obs = sll[:, chain.pdf]
    graph = {k: jnp.asarray(v) for k, v in
             estep.shift_compile(
                 pad_chain(chain, chain.num_positions)).items()}
    path, score = estep.masked_viterbi_shift(
        obs, graph, jnp.int32(obs.shape[0]))
    path = np.asarray(path)
    segments = []
    start = 0
    for t in range(1, len(path) + 1):
        if t == len(path) or path[t] != path[start]:
            p = int(path[start])
            segments.append((start, t, chain.labels[chain.phone_index[p]],
                             int(chain.state_in_phone[p])))
            start = t
    return segments, float(score)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="align")
    p.add_argument("-b", "--base", help="base filename for model files")
    p.add_argument("-g", "--gk"), p.add_argument("-m", "--mc")
    p.add_argument("-p", "--ph")
    p.add_argument("-c", "--config", required=True,
                   help="feature configuration")
    p.add_argument("-r", "--recipe", required=True, help="recipe file")
    p.add_argument("-O", "--ophn", action="store_true",
                   help="output phn format (ignored: always phn)")
    p.add_argument("-S", "--speakers", help="speaker configuration file")
    p.add_argument("-B", "--batch", type=int, default=0)
    p.add_argument("-I", "--bindex", type=int, default=0)
    p.add_argument("-i", "--info", type=int, default=0)
    args = p.parse_args(argv)

    model = load_model(args)
    if isinstance(model, str):
        from aaltoasr_tpu.formats.model_io import read_model
        model = read_model(model)
    table = TransitionTable.from_model(model)
    scorer = GmmScorer.from_model(model)
    fg = FeatureGenerator(args.config)
    spkc = SpeakerConfig.load(args.speakers) if args.speakers else None

    recipe = Recipe.read(args.recipe, args.batch, args.bindex)
    frame_mult = int(16000 / fg.frame_rate)
    for rinfo in recipe:
        if args.info > 0:
            print(f"Processing file: {rinfo.audio_path}", file=sys.stderr)
        if spkc is not None and rinfo.speaker_id:
            fg.apply_speaker_config(spkc.speaker_params(rinfo.speaker_id))
        samples, _ = read_audio(rinfo.audio_path, fg.sample_rate)
        entries = read_phn(rinfo.transcript_path)
        labels = [e.label for e in entries]
        segments, score = align_utterance(
            model, table, scorer, fg, samples, labels)
        out_path = rinfo.alignment_path or rinfo.transcript_path + ".aligned"
        with open(out_path, "w") as f:
            for (s, e, label, state) in segments:
                f.write(f"{s * frame_mult} {e * frame_mult} "
                        f"{label}.{state}\n")
        if args.info > 0:
            print(f"  log prob {score:.3f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
