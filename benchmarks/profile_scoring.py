"""Scoring-pipeline roofline: attribute the `scoring_frames_per_sec`
bench figure (MFCC features + GMM state log-probs, the `phone_probs`
hot path) to compute, HBM, or host/dispatch, and state the ceiling.

Method: time (a) the full jitted pipeline, (b) the GMM stage alone on
device-resident features, (c) the feature stage alone, at several
batch sizes, all on device-resident inputs; compare achieved FLOP/s
and HBM traffic against chip peaks.

FLOP model per frame (D=39, window 400 -> 512-pt GEMM real DFT,
G Gaussians):
  features: 2*512*(257*2) [rDFT re+im] + 2*257*40 [mel] + small
            ~= 1.1 MFLOP
  gmm:      2*(2D)*G = 2*78*G            (diag exponential form)
            G=10k -> 1.56 MFLOP
HBM per frame (weights re-read per matmul tile, batched over frames so
amortized): score_matrix [78, G] f32 ~ 3.1 MB per kernel invocation,
obs tiny.

Run: python benchmarks/profile_scoring.py [--gauss 10000] [--trace]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def timed(fn, *args, iters=10):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--gauss", type=int, default=10000)
    p.add_argument("--states", type=int, default=2500)
    p.add_argument("--seconds", type=int, default=10)
    p.add_argument("--batches", default="8,32,128")
    p.add_argument("--trace", action="store_true")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _MFCC_CFG, _random_model
    from aaltoasr_tpu.formats.feaconf import FeatureConfig
    from aaltoasr_tpu.frontend.generator import FeatureGenerator
    from aaltoasr_tpu.ops.gmm import GmmScorer

    dev = jax.devices()[0]
    print(f"device: {dev.device_kind} ({dev.platform})")

    fg = FeatureGenerator(FeatureConfig.parse(_MFCC_CFG))
    model = _random_model(G=args.gauss, S=args.states, D=39, K=8)
    scorer = GmmScorer.from_model(model)
    G = scorer.score_matrix.shape[1]
    S_LEN = 16000 * args.seconds
    n_frames_i = fg.num_frames(S_LEN)
    feature_fn = fg._compiled(S_LEN)
    params = fg.params

    feat_flop = 1.1e6          # per frame (GEMM rDFT + mel + dct)
    gmm_flop = 2.0 * 78 * G    # per frame

    for B in [int(x) for x in args.batches.split(",")]:
        rng = np.random.default_rng(0)
        samples = jax.device_put(jnp.asarray(
            rng.normal(0, 1000, (B, S_LEN)).astype(np.float32)))
        n_frames = jnp.full((B,), n_frames_i, jnp.int32)

        @jax.jit
        def feats_only(s, n):
            return jax.vmap(lambda a, m: feature_fn(a, m, params))(s, n)

        @jax.jit
        def full(s, n):
            return jax.vmap(scorer.lna_log_probs)(feats_only(s, n))

        @jax.jit
        def gmm_only(f):
            return jax.vmap(scorer.lna_log_probs)(f)

        feats = feats_only(samples, n_frames)
        jax.block_until_ready(feats)

        t_full = timed(full, samples, n_frames)
        t_feat = timed(feats_only, samples, n_frames)
        t_gmm = timed(gmm_only, feats)
        frames = B * n_frames_i
        fps = frames / t_full
        print(f"\nB={B}: full {t_full * 1e3:.2f} ms  "
              f"({fps / 1e3:.0f}k frames/s, {fps / 125:.0f}x RT)")
        print(f"  features-only {t_feat * 1e3:.2f} ms "
              f"({frames * feat_flop / t_feat / 1e12:.2f} TFLOP/s)")
        print(f"  gmm-only      {t_gmm * 1e3:.2f} ms "
              f"({frames * gmm_flop / t_gmm / 1e12:.2f} TFLOP/s)")
        print(f"  stage sum {1e3 * (t_feat + t_gmm):.2f} ms vs full "
              f"{t_full * 1e3:.2f} ms "
              f"(fusion/overlap gain: "
              f"{100 * (1 - t_full / (t_feat + t_gmm)):.0f}%)")
        # HBM floor for the gmm matmul: weights + activations read once
        bytes_gmm = (78 * G * 4 + frames * (78 + G) * 4)
        print(f"  gmm HBM floor {bytes_gmm / 1e6:.0f} MB -> "
              f"{bytes_gmm / t_gmm / 1e9:.0f} GB/s achieved-equiv")

    if args.trace:
        outdir = "/tmp/jax-trace-scoring"
        with jax.profiler.trace(outdir):
            for _ in range(3):
                out = full(samples, n_frames)
            jax.block_until_ready(out)
        print(f"trace written to {outdir}")


if __name__ == "__main__":
    main()
