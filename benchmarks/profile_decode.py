"""Phase profiling for the dense decoder on the live chip.

Separates: obs upload, device scan (block_until_ready), D2H fetch,
host-side result unwinding — so optimization effort goes where the
time actually is.

Usage: python benchmarks/profile_decode.py [--batch 64] [--frames 1000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bench_decode import synth_task  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--frames", type=int, default=1000)
    p.add_argument("--words", type=int, default=1000)
    p.add_argument("--records", type=int, default=32)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    from aaltoasr_tpu.decoder.search import SearchConfig
    from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch


    model, tree, fsa = synth_task(num_words=args.words)
    print(f"tree nodes: {tree.num_nodes}, lm states: {fsa.num_states}",
          flush=True)
    cfg = SearchConfig(lm_scale=30.0, duration_scale=0.0,
                       num_records=args.records)
    search = DenseBeamSearch(tree, fsa, model, cfg)

    B, T = args.batch, args.frames
    rng = np.random.default_rng(1)
    obs = rng.normal(-5, 2, (B, T, model.num_states)).astype(np.float32)
    n = np.full(B, T, np.int32)

    lm_init = np.atleast_1d(np.asarray(
        search.lm.initial_state("<s>"), dtype=np.int32))
    fn = jax.jit(jax.vmap(search._decode, in_axes=(0, 0, None)))

    t0 = time.perf_counter()
    obs_d = jax.device_put(jnp.asarray(obs))
    jax.block_until_ready(obs_d)
    t_upload = time.perf_counter() - t0

    # compile
    t0 = time.perf_counter()
    out = fn(obs_d, jnp.asarray(n), jnp.asarray(lm_init))
    jax.block_until_ready(out)
    t_compile = time.perf_counter() - t0

    # pure device run
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(obs_d, jnp.asarray(n), jnp.asarray(lm_init))
        jax.block_until_ready(out)
    t_run = (time.perf_counter() - t0) / reps

    # D2H fetch
    t0 = time.perf_counter()
    finals = np.asarray(out[0])
    rec_i = np.asarray(out[1])
    rec_f = np.asarray(out[2])
    t_fetch = time.perf_counter() - t0

    # host unwinding
    t0 = time.perf_counter()
    res = [search._result(finals[b], rec_i[b], rec_f[b])
           for b in range(B)]
    t_unwind = time.perf_counter() - t0
    del res

    audio = B * T / 125.0
    print(json.dumps({
        "batch": B, "frames": T,
        "upload_s": round(t_upload, 3),
        "compile_s": round(t_compile, 3),
        "device_run_s": round(t_run, 3),
        "per_step_ms": round(1000 * t_run / T, 3),
        "fetch_s": round(t_fetch, 3),
        "unwind_s": round(t_unwind, 3),
        "xrt_device_only": round(audio / t_run, 1),
        "xrt_with_io": round(audio / (t_run + t_fetch + t_unwind), 1),
    }))


if __name__ == "__main__":
    main()
