"""E-step throughput on the live chip: chain_stats over realistic
shapes (the `stats` worker's hot path)."""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--frames", type=int, default=1000)
    p.add_argument("--positions", type=int, default=512)
    p.add_argument("--gauss", type=int, default=10000)
    p.add_argument("--states", type=int, default=2500)
    p.add_argument("--dim", type=int, default=39)
    p.add_argument("--trace", action="store_true")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _random_model
    from aaltoasr_tpu.models.hmm import (
        TransitionTable, build_chain, pad_chain)
    from aaltoasr_tpu.ops.gmm import GmmScorer
    from aaltoasr_tpu.train import estep


    model = _random_model(G=args.gauss, S=args.states, D=args.dim, K=8)
    table = TransitionTable.from_model(model)
    scorer = GmmScorer.from_model(model)

    labels = [f"p{i % (args.states // 2)}"
              for i in range(args.positions // 2)]
    chain = build_chain(model, table, labels)
    P = args.positions
    while chain.num_positions > P:
        P *= 2
    g = {k: jnp.asarray(v)
         for k, v in estep.shift_compile(
             pad_chain(chain, P, fan=4)).items()}
    B, T = args.batch, args.frames
    rng = np.random.default_rng(0)
    feats = jnp.asarray(
        rng.normal(0, 2, (B, T, args.dim)).astype(np.float32))
    graphs = {k: jnp.broadcast_to(v[None], (B,) + v.shape)
              for k, v in g.items()}
    n = jnp.full((B,), T, jnp.int32)

    fn = jax.jit(jax.vmap(
        lambda f, gg, nn: estep.chain_stats(
            scorer, f, gg, nn, table.num_slots)))
    out = fn(feats, graphs, n)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(feats, graphs, n)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    fps = B * T / dt
    print(json.dumps({"estep_frames_per_sec": round(fps, 1),
                      "xrt": round(fps / 125.0, 1),
                      "wall_s": round(dt, 3),
                      "B": B, "T": T, "P": P}))

    if args.trace:
        tdir = "/tmp/jaxtrace_estep"
        with jax.profiler.trace(tdir):
            out = fn(feats, graphs, n)
            jax.block_until_ready(out)
        files = sorted(glob.glob(f"{tdir}/**/*.trace.json.gz",
                                 recursive=True))
        data = json.load(gzip.open(files[-1]))
        dur = defaultdict(float)
        cnt = defaultdict(int)
        meta = {}
        for e in data["traceEvents"]:
            if e.get("ph") == "X" and "dur" in e:
                name = e.get("name", "?")
                dur[name] += e["dur"]
                cnt[name] += 1
                if name not in meta and "args" in e:
                    meta[name] = e["args"]
        for name, d in sorted(dur.items(), key=lambda kv: -kv[1])[:15]:
            a = meta.get(name, {})
            src = a.get("source", "")[-55:]
            print(f"{d/1e3:8.2f} ms x{cnt[name]:4d} {name[:22]:22s} "
                  f"{src}")


if __name__ == "__main__":
    main()
