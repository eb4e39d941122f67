"""E-step roofline: time the hot path's components separately at the
bench operating point (B=32, T=1000, P=512, G=10k, S=2.5k, D=39, K=8)
to identify what bounds `estep_frames_per_sec`.

Components:
  score   — Gaussian scoring matmul [T,2D]@[2D,Gp] (+ per-state
            mixture logsumexp): the matmul part
  fb      — the masked forward-backward scan over T (latency part)
  resp    — responsibilities + the three stats matmuls + segment sums
            (the HBM part: R is [T, P*K])
  total   — full chain_stats
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def timeit(fn, *args, iters=3):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _random_model
    from aaltoasr_tpu.models.hmm import (
        TransitionTable, build_chain, pad_chain)
    from aaltoasr_tpu.ops.gmm import GmmScorer
    from aaltoasr_tpu.ops.logsemiring import logsumexp
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
    pdf = g["pdf"]

    # -- score: gll + state logsumexp ---------------------------------
    def score_only(f):
        gll = scorer.gaussian_log_likelihoods(f)
        sll = logsumexp(gll[:, scorer.comp_idx] + scorer.comp_logw,
                        axis=-1)
        return sll[:, pdf]
    score_fn = jax.jit(jax.vmap(score_only))
    t_score = timeit(score_fn, feats)
    obs = score_fn(feats)

    # -- score, per-position (what chain_stats now does when P < Sp:
    #    gather gll at the chain's [P, K] columns only) --------------
    def score_pos(f):
        gll = scorer.gaussian_log_likelihoods(f)
        return logsumexp(gll[:, scorer.comp_idx[pdf]]
                         + scorer.comp_logw[pdf], axis=-1)
    t_score_pos = timeit(jax.jit(jax.vmap(score_pos)), feats)

    # -- fb only ------------------------------------------------------
    def fb_only(o, gg, nn):
        return estep.masked_forward_backward_shift(
            o, gg, nn, table.num_slots)
    fb_fn = jax.jit(jax.vmap(fb_only))
    t_fb = timeit(fb_fn, obs, graphs, n)
    gamma = fb_fn(obs, graphs, n)[0]

    # -- resp + stats given gamma & obs -------------------------------
    def stats_only(f, gam, o):
        gll = scorer.gaussian_log_likelihoods(f)
        cidx = scorer.comp_idx[pdf]
        clogw = scorer.comp_logw[pdf]
        log_resp = clogw[None] + gll[:, cidx] - o[:, :, None]
        R = gam[:, :, None] * jnp.exp(jnp.maximum(log_resp, -80.0))
        R_flat = R.reshape(T, -1)
        g_flat = cidx.reshape(-1)
        Gp = scorer.score_matrix.shape[1]
        c = jnp.sum(R_flat, axis=0)
        gamma_g = jax.ops.segment_sum(c, g_flat, num_segments=Gp)
        m1 = jax.ops.segment_sum(jnp.dot(R_flat.T, f), g_flat,
                                 num_segments=Gp)
        m2 = jax.ops.segment_sum(jnp.dot(R_flat.T, f * f), g_flat,
                                 num_segments=Gp)
        return gamma_g, m1, m2
    stats_fn = jax.jit(jax.vmap(stats_only))
    t_stats = timeit(stats_fn, feats, gamma, obs)
    # note: stats_only re-runs scoring (gll feeds log_resp); isolate by
    # subtracting t_score when reading the numbers

    # -- total ---------------------------------------------------------
    total_fn = jax.jit(jax.vmap(lambda f, gg, nn: estep.chain_stats(
        scorer, f, gg, nn, table.num_slots)))
    t_total = timeit(total_fn, feats, graphs, n)

    fps = B * T / t_total
    print(json.dumps({
        "t_score_s": round(t_score, 4),
        "t_score_pos_s": round(t_score_pos, 4),
        "t_fb_s": round(t_fb, 4),
        "t_stats_plus_score_s": round(t_stats, 4),
        "t_stats_est_s": round(max(t_stats - t_score, 0.0), 4),
        "t_total_s": round(t_total, 4),
        "estep_frames_per_sec": round(fps, 1),
        "B": B, "T": T, "P": P,
    }))


if __name__ == "__main__":
    main()
