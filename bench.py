"""Benchmark: batched LVCSR decode real-time factor on one GPU — the
BASELINE.json north-star metric (>=100x real time per card) — plus
MFCC+GMM scoring throughput as a secondary field.

Refuses to run without a GPU.  Prints one JSON line naming the device
(platform, kind, count, and nvidia-smi's name and power limit).
vs_baseline = decode xRT / the 100x-real-time target (the reference
itself publishes no numbers).
"""

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "benchmarks"))


def scoring_fps():
    """MFCC+GMM scoring throughput (frames/sec/card)."""
    from __graft_entry__ import _MFCC_CFG, _random_model
    from aaltoasr_tpu.formats.feaconf import FeatureConfig
    from aaltoasr_tpu.frontend.generator import FeatureGenerator
    from aaltoasr_tpu.ops.gmm import GmmScorer

    fg = FeatureGenerator(FeatureConfig.parse(_MFCC_CFG))
    # realistic LVCSR operating point: 10k Gaussians, 2.5k tied states
    model = _random_model(G=10000, S=2500, D=39, K=8)
    scorer = GmmScorer.from_model(model)

    B, S_LEN = 32, 16000 * 10          # 32 x 10 s utterances
    rng = np.random.default_rng(0)
    samples = jnp.asarray(
        rng.normal(0, 1000, (B, S_LEN)).astype(np.float32))
    n_frames_i = fg.num_frames(S_LEN)
    n_frames = jnp.full((B,), n_frames_i, jnp.int32)
    feature_fn = fg._compiled(S_LEN)
    params = fg.params

    @jax.jit
    def pipeline(s, n):
        feats = jax.vmap(lambda a, m: feature_fn(a, m, params))(s, n)
        return jax.vmap(scorer.lna_log_probs)(feats)

    out = pipeline(samples, n_frames)
    out.block_until_ready()
    iters = 10
    t0 = time.time()
    for _ in range(iters):
        out = pipeline(samples, n_frames)
    out.block_until_ready()
    dt = (time.time() - t0) / iters
    return B * n_frames_i / dt


def decode_xrt(num_words=1000, triphone=True, durations=True, order=3,
               tag=""):
    """Dense batched decode real-time factor at the REFERENCE operating
    point: tied cross-word triphone tree (fan-in/fan-out,
    `TPLexPrefixTree.hh:172-240`), gamma duration model at scale 3
    (`rectool.py:547`), trigram backoff LM; 125 fps."""
    from bench_decode import synth_task, synth_obs
    from aaltoasr_tpu.decoder.search import SearchConfig
    from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch

    model, tree, fsa = synth_task(num_words=num_words, order=order,
                                  triphone=triphone, durations=durations)
    info = synth_task.last_info
    print(f"decode{tag}: {tree.num_nodes} nodes, {fsa.num_states} "
          f"lm states, {model.num_states} tied states", file=sys.stderr)
    cfg = SearchConfig(lm_scale=30.0,
                       duration_scale=3.0 if durations else 0.0,
                       num_records=32, records_half=True)
    search = DenseBeamSearch(tree, fsa, model, cfg)
    B, T = 128, 1000
    # structured observations generated ON device from a [B, T] planted
    # state plan (real LNAs come from the scoring pipeline on the card,
    # see e2e_xrt; a [B, T, S] host upload would be ~GB)
    obs_fn, true_words = synth_obs(model, info, B, T)
    obs = jax.jit(obs_fn)(jax.random.PRNGKey(1))
    n = np.full(B, T, np.int32)
    res = search.decode_batch(obs, n, lattice=False)   # compile + warm
    agree = tot = dec = 0
    for b in range(4):
        ref = [f"w{i}" for i in true_words[b]]
        agree += sum(h == r for h, r in zip(res[b].words, ref))
        tot += len(ref)
        dec += len(res[b].words)
    print(f"decode{tag}: planted-word check {agree}/{tot} "
          f"({dec} decoded)", file=sys.stderr)
    if agree == tot - 1:
        print(f"decode{tag}: single miss = the known utterance-final "
              "commit ambiguity (b=2's last word; identical in the "
              "exact engine, decoded at lm_scale=10 — DESIGN.md 'The "
              "34/35', benchmarks/diagnose_planted.py)",
              file=sys.stderr)
    dt = float("inf")
    for i in range(5):                         # take the best run
        t0 = time.perf_counter()
        res = search.decode_batch(obs, n, lattice=False)
        run = time.perf_counter() - t0
        print(f"decode{tag} run {i}: {run:.3f}s", file=sys.stderr)
        dt = min(dt, run)
    del res
    return (B * T / 125.0) / dt


def exact_decode_xrt(triphone=False, order=2, num_words=1000, tag=""):
    """Exact token-passing engine (the reference-faithful accuracy
    mode: multi-hypothesis (node, lm-state) recombination per
    `TokenPassSearch.cc:695-1400`) real-time factor, with the
    production pruning set: token-overflow budget, word-end prewalk
    compaction, best-first re-entry slice (+ per-record re-entry
    prewalk on cross-word trees).  triphone=True measures the FULL
    reference operating point: cross-word tied-triphone tree + gamma
    durations at scale 3 (+ trigram with order=3); num_words=10000
    is the production-vocabulary point (~287k tree nodes, ~110k LM
    states — the scale of `recognize-batch.sh`'s rectool runs)."""
    from bench_decode import synth_task, synth_obs
    from aaltoasr_tpu.decoder.search import BeamSearch, SearchConfig

    model, tree, fsa = synth_task(num_words=num_words, order=order,
                                  triphone=triphone, durations=triphone)
    info = synth_task.last_info
    if triphone and num_words >= 10000:
        # 10k-word operating point from a knob sweep on an earlier
        # accelerator with 16 GB (sweep_exact_xw.py): W=1024/records=32/
        # we_prewalk=256/reentry 8+8, planted words all agree; the
        # H100's 80 GB may allow more (not measured)
        cfg = SearchConfig(lm_scale=30.0, duration_scale=3.0,
                           num_tokens=1024, num_records=32,
                           overflow_tokens=128, we_prewalk=256,
                           reentry_records=8, reentry_prewalk=8)
    elif triphone:
        # knob sweep (benchmarks/sweep_exact_xw.py): planted-word
        # agreement is 69-70/70 from W=1024 down to W=512 and
        # we_prewalk 128; W=512/prewalk=256 is the conservative point
        # (its speed on the H100 is not measured)
        cfg = SearchConfig(lm_scale=30.0, duration_scale=3.0,
                           num_tokens=512, num_records=32,
                           overflow_tokens=128, we_prewalk=256,
                           reentry_records=8, reentry_prewalk=8)
    else:
        cfg = SearchConfig(lm_scale=30.0, duration_scale=0.0,
                           num_tokens=1024, num_records=64,
                           overflow_tokens=128, we_prewalk=256)
    search = BeamSearch(tree, fsa, model, cfg)
    B, T = 128, 1000
    obs_fn, true_words = synth_obs(model, info, B, T)
    obs = jax.jit(obs_fn)(jax.random.PRNGKey(1))
    n = np.full(B, T, np.int32)
    res = search.decode_batch(obs, n, lattice=False)   # compile + warm
    agree = tot = 0
    for b in range(4):
        ref = [f"w{i}" for i in true_words[b]]
        agree += sum(h == r for h, r in zip(res[b].words, ref))
        tot += len(ref)
    print(f"exact{tag}: planted-word check {agree}/{tot}",
          file=sys.stderr)
    if agree == tot - 1:
        print(f"exact{tag}: single miss = the known utterance-final "
              "commit ambiguity (DESIGN.md 'The 34/35')",
              file=sys.stderr)
    dt = float("inf")
    for i in range(3):
        t0 = time.perf_counter()
        res = search.decode_batch(obs, n, lattice=False)
        run = time.perf_counter() - t0
        print(f"exact{tag} run {i}: {run:.3f}s", file=sys.stderr)
        dt = min(dt, run)
    del res
    return (B * T / 125.0) / dt


def e2e_xrt():
    """True serve-path real-time factor: raw audio -> MFCC features ->
    GMM state log-probs (LNA-normalized) -> dense LVCSR decode ->
    1-best words, everything on device (words fetched as ids).
    This is the `decode-stream.cc` pipeline batched
    (audio -> FeatureGenerator -> HmmSet likelihoods -> TokenPassSearch).
    """
    from bench_decode import synth_task
    from __graft_entry__ import _MFCC_CFG
    from aaltoasr_tpu.decoder.search import SearchConfig
    from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch
    from aaltoasr_tpu.formats.feaconf import FeatureConfig
    from aaltoasr_tpu.frontend.generator import FeatureGenerator
    from aaltoasr_tpu.ops.gmm import GmmScorer

    # the full reference operating point: cross-word tied-triphone
    # tree + gamma durations (scale 3) + trigram LM
    model, tree, fsa = synth_task(num_words=1000, order=3,
                                  triphone=True, durations=True)
    scorer = GmmScorer.from_model(model)
    fg = FeatureGenerator(FeatureConfig.parse(_MFCC_CFG))
    B, SECONDS = 128, 8
    S_LEN = 16000 * SECONDS
    rng = np.random.default_rng(2)
    samples = jnp.asarray(
        rng.normal(0, 1000, (B, S_LEN)).astype(np.float32))
    n_frames_i = fg.num_frames(S_LEN)
    n_frames = jnp.full((B,), n_frames_i, jnp.int32)
    feature_fn = fg._compiled(S_LEN)
    params = fg.params

    @jax.jit
    def front(s, n):
        feats = jax.vmap(lambda a, m: feature_fn(a, m, params))(s, n)
        return jax.vmap(scorer.lna_log_probs)(feats)

    cfg = SearchConfig(lm_scale=30.0, duration_scale=3.0,
                       num_records=32)
    search = DenseBeamSearch(tree, fsa, model, cfg)

    def run():
        lna = front(samples, n_frames)
        return search.decode_batch(lna, np.asarray(n_frames),
                                   lattice=False)

    run()                                     # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = run()
        best = min(best, time.perf_counter() - t0)
    assert len(res) == B
    return B * SECONDS / best


def streaming_latency_ms():
    """Steady-state per-frame push latency of the streaming decoder
    (the `decode-stream.cc` set_one_frame + run loop).  BASELINE.json
    names "decode latency xRT"; this is the per-frame wall time of one
    exact-engine step, ended by a host fetch that data-depends on the
    step."""
    from bench_decode import synth_task
    from aaltoasr_tpu.decoder.search import (
        BeamSearch, SearchConfig, StreamingDecoder)

    model, tree, fsa = synth_task(num_words=1000, order=2)
    cfg = SearchConfig(lm_scale=30.0, duration_scale=0.0,
                       num_tokens=1024, num_records=32,
                       overflow_tokens=128, we_prewalk=256)
    search = BeamSearch(tree, fsa, model, cfg)
    sd = StreamingDecoder(search)
    rng = np.random.default_rng(0)
    S = model.num_states
    frames = rng.normal(-5.0, 2.0, (60, S)).astype(np.float32)
    for i in range(10):                         # compile + warm
        sd.push_frame(frames[i])
    float(np.asarray(sd._tokens[2][0]))
    lat = []
    for i in range(10, 60):
        t0 = time.perf_counter()
        sd.push_frame(frames[i])
        float(np.asarray(sd._tokens[2][0]))     # force the step
        lat.append(time.perf_counter() - t0)
    # amortized device-step latency: a pipelined consumer fetches
    # partials every K frames, so also time 50 pushes ended by ONE
    # fetch
    t0 = time.perf_counter()
    for i in range(10, 60):
        sd.push_frame(frames[i])
    float(np.asarray(sd._tokens[2][0]))
    step_ms = (time.perf_counter() - t0) / 50 * 1e3
    # the demonstrated pipelined consumer (decode_stream
    # --partial-every K): K pure device pushes, then a partial
    # hypothesis every K frames.  Metric definition (stable since r3):
    # per-frame wall time of a consumer that EMITS a partial every K
    # frames; since r5 the partial is StreamingDecoder.partial() — a
    # device traceback + one [64]-id fetch, no record flush.
    K, rounds = 32, 4
    sd.reset()
    frames2 = rng.normal(-5.0, 2.0, (K * (rounds + 1) + 2, S)).astype(
        np.float32)
    sd.push_frame(frames2[0])
    sd.push_frame(frames2[K * rounds + 1])
    sd.partial()              # compile + warm (ring + traceback)
    sd.reset()
    sd.push_frame(frames2[0])
    t0 = time.perf_counter()
    for i in range(1, K * rounds + 1):
        sd.push_frame(frames2[i])
        if i % K == 0:
            sd.partial()
    pipelined_ms = (time.perf_counter() - t0) / (K * rounds) * 1e3
    # chunked consumer (decode_stream block path): each K-frame audio
    # block is ONE lax.scan dispatch (push_frames), partial fetched per
    # block — amortizes the fixed per-dispatch cost K-fold
    sd.reset()
    sd.push_frames(frames2[:K])          # compile seed + (K-1) scan
    sd.push_frames(frames2[K:2 * K])     # compile K scan
    sd.partial()
    sd.reset()
    sd.push_frames(frames2[:K])
    t0 = time.perf_counter()
    for r in range(1, rounds + 1):
        sd.push_frames(frames2[r * K:(r + 1) * K])
        sd.partial()
    chunked_ms = (time.perf_counter() - t0) / (K * rounds) * 1e3
    return (float(np.median(lat) * 1e3), float(step_ms),
            float(pipelined_ms), float(chunked_ms))


def estep_fps():
    """Baum-Welch E-step throughput (the `stats` worker hot path)."""
    import jax
    from __graft_entry__ import _random_model
    from aaltoasr_tpu.models.hmm import (
        TransitionTable, build_chain, pad_chain)
    from aaltoasr_tpu.ops.gmm import GmmScorer
    from aaltoasr_tpu.train import estep

    model = _random_model(G=10000, S=2500, D=39, K=8)
    table = TransitionTable.from_model(model)
    scorer = GmmScorer.from_model(model)
    labels = [f"p{i % 1250}" for i in range(256)]
    chain = build_chain(model, table, labels)
    P = 512
    while chain.num_positions > P:
        P *= 2
    g = {k: jnp.asarray(v) for k, v in estep.shift_compile(
        pad_chain(chain, P, fan=4)).items()}
    B, T = 32, 1000
    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.normal(0, 2, (B, T, 39)).astype(np.float32))
    graphs = {k: jnp.broadcast_to(v[None], (B,) + v.shape)
              for k, v in g.items()}
    n = jnp.full((B,), T, jnp.int32)
    fn = jax.jit(jax.vmap(lambda f, gg, nn: estep.chain_stats(
        scorer, f, gg, nn, table.num_slots)))
    out = fn(feats, graphs, n)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(feats, graphs, n)
    jax.block_until_ready(out)
    return B * T / (time.perf_counter() - t0)


def device_info() -> dict:
    """The device this run measures; exits 2 unless it is a GPU."""
    from aaltoasr_tpu.utils.device import nvidia_smi, require_gpu
    dev = require_gpu("bench")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": nvidia_smi().splitlines()[0]}


def main():
    device = device_info()
    xrt = decode_xrt()
    # production-scale row: 10k words, ~100k nodes, trigram, duration
    # model on
    prod = decode_xrt(num_words=10000, triphone=False, durations=True,
                      order=3, tag="_prod10k")
    exact = exact_decode_xrt()
    # exact engine at the FULL reference operating point (cross-word
    # triphones + gamma durations scale 3 + trigram LM) — the
    # reference-faithful accuracy mode at the reference's own settings
    exact_xw = exact_decode_xrt(triphone=True, order=3, tag="_xw3")
    # exact engine at PRODUCTION scale: 10k words, cross-word
    # triphones, trigram, durations on.
    # Drop the earlier rows' executables + device tables first: the
    # 287k-node task needs the device memory they pin.
    import gc
    gc.collect()
    jax.clear_caches()
    exact_prod = exact_decode_xrt(triphone=True, order=3,
                                  num_words=10000, tag="_prod10k")
    e2e = e2e_xrt()
    lat, step_ms, pipe_ms, chunk_ms = streaming_latency_ms()
    fps = scoring_fps()
    efps = estep_fps()
    print(json.dumps({
        "device": device,
        "metric": "dense_decode_realtime_factor",
        "value": round(xrt, 1),
        "unit": "x realtime/card",
        "vs_baseline": round(xrt / 100.0, 2),
        "prod10k_trigram_xrt": round(prod, 1),
        "exact_engine_xrt": round(exact, 1),
        "exact_crossword_trigram_xrt": round(exact_xw, 1),
        "exact_prod10k_xrt": round(exact_prod, 1),
        "e2e_wav_to_words_xrt": round(e2e, 1),
        "streaming_latency_ms": round(lat, 1),
        "streaming_step_ms": round(step_ms, 2),
        "streaming_pipelined_ms_per_frame": round(pipe_ms, 2),
        "streaming_chunked_ms_per_frame": round(chunk_ms, 2),
        "scoring_frames_per_sec": round(fps, 1),
        "scoring_xrt": round(fps / 125.0, 1),
        "estep_frames_per_sec": round(efps, 1),
        "estep_xrt": round(efps / 125.0, 1),
    }))


if __name__ == "__main__":
    main()
