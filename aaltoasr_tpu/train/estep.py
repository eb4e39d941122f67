"""Baum-Welch / Viterbi E-step as one jitted device program per utterance
batch — the replacement for the `stats` worker's inner loops
(`aku/stats.cc:73-257` simple_train / collect_lattice_stats).

Pipeline on device: state log-likelihoods (GMM matmul) -> masked
forward-backward (or Viterbi) over the padded position graph -> component
responsibilities -> sufficient statistics via [P*K, T] x [T, D] matmuls and
segment-sums.  Variable utterance lengths use a validity mask inside the
scan (the carry freezes past the last frame), so one compiled program
serves a whole padded batch; `vmap` batches utterances and `psum` (see
parallel.mesh) reduces the resulting pytree across data-parallel devices —
replacing the reference's .gks/.mcs/.phs dump files + combine_stats reduce.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from aaltoasr_tpu.ops.logsemiring import LOG_ZERO, logsumexp

_F32 = jax.lax.Precision.HIGHEST


def _entry(graph, P):
    """Entry log-prob vector: explicit (hmmnet graphs) or position 0
    (transcript chains)."""
    if "entry" in graph:
        return graph["entry"]
    return jnp.where(jnp.arange(P) == 0, 0.0, LOG_ZERO)


def _final(graph, P):
    """Final log-prob vector: explicit or the chain's last position."""
    if "final" in graph:
        return graph["final"]
    return jnp.where(jnp.arange(P) == graph["num_positions"] - 1,
                     graph["final_logp"], LOG_ZERO)


def masked_forward_backward(obs_pos, graph, n_frames, num_trans_slots: int,
                            with_transitions: bool = True,
                            with_live: bool = False):
    """FB over [T_pad, P] with frames >= n_frames inert.

    Returns (gamma [T, P] linear, trans_post [NT], total_ll).
    with_transitions=False skips the xi scan (arc-synchronous hmmnet
    graphs derive transition occupancies from arc_slot instead — a
    ~40% saving of the FB device time).
    with_live=True appends a STRUCTURAL liveness mask [T, P] (alpha
    and beta both reachable, in log space before the exp clamp) — the
    reference's "arc in the segmented lattice" predicate, exact even
    for posteriors below the exp(-80) clamp floor.
    """
    T, P = obs_pos.shape
    in_src, in_logp = graph["in_src"], graph["in_logp"]
    in_slot = graph["in_slot"]
    out_tgt, out_logp = graph["out_tgt"], graph["out_logp"]
    nump = graph["num_positions"]

    valid = jnp.arange(T) < n_frames                      # [T]
    alpha0 = jnp.maximum(obs_pos[0] + _entry(graph, P), LOG_ZERO)

    def fwd(alpha, xs):
        obs_t, v = xs
        new = logsumexp(alpha[in_src] + in_logp, axis=1) + obs_t
        new = jnp.maximum(new, LOG_ZERO)
        new = jnp.where(v, new, alpha)                    # freeze past end
        return new, alpha

    alpha_T, alphas_prev = jax.lax.scan(
        fwd, alpha0, (obs_pos[1:], valid[1:]))
    alphas = jnp.concatenate([alphas_prev, alpha_T[None]], axis=0)

    beta_last = _final(graph, P)
    total = logsumexp(alpha_T + beta_last, axis=0)

    def bwd(beta, xs):
        # carry = beta[t+1]; emit beta[t] (scan stacks ys at xs index t)
        obs_next, v = xs
        contrib = out_logp + obs_next[out_tgt] + beta[out_tgt]
        new = jnp.maximum(logsumexp(contrib, axis=1), LOG_ZERO)
        new = jnp.where(v, new, beta)
        return new, new

    _, betas_head = jax.lax.scan(
        bwd, beta_last, (obs_pos[1:], valid[1:]), reverse=True)
    betas = jnp.concatenate([betas_head, beta_last[None]], axis=0)

    gamma = jnp.exp(jnp.maximum(alphas + betas - total, -80.0))
    gamma = gamma * valid[:, None]

    def trans_step(acc, xs):
        alpha_t, obs_next, beta_next, v = xs
        xi = (alpha_t[in_src] + in_logp + obs_next[:, None]
              + beta_next[:, None] - total)
        xi = jnp.exp(jnp.maximum(xi, -80.0)) * v
        acc = acc + jax.ops.segment_sum(
            xi.reshape(-1), in_slot.reshape(-1),
            num_segments=num_trans_slots)
        return acc, None

    trans0 = jnp.zeros(num_trans_slots, dtype=jnp.float32)
    if with_transitions:
        trans_post, _ = jax.lax.scan(
            trans_step, trans0,
            (alphas[:-1], obs_pos[1:], betas[1:], valid[1:]))
    else:
        trans_post = trans0
    if "final_slot" in graph:
        trans_post = trans_post.at[graph["final_slot"]].add(1.0)
    if with_live:
        live = ((alphas > LOG_ZERO / 2) & (betas > LOG_ZERO / 2)
                & valid[:, None])
        return gamma, trans_post, total, live
    return gamma, trans_post, total


def masked_viterbi(obs_pos, graph, n_frames):
    """Viterbi over [T_pad, P]; returns (path [T] positions, score).

    Frames >= n_frames replay the final state (mask before use).
    """
    T, P = obs_pos.shape
    in_src, in_logp = graph["in_src"], graph["in_logp"]
    nump = graph["num_positions"]
    valid = jnp.arange(T) < n_frames

    alpha0 = jnp.maximum(obs_pos[0] + _entry(graph, P), LOG_ZERO)

    def step(alpha, xs):
        obs_t, v = xs
        cand = alpha[in_src] + in_logp
        best = jnp.max(cand, axis=1)
        bp = jnp.argmax(cand, axis=1).astype(jnp.int32)
        new = jnp.maximum(best + obs_t, LOG_ZERO)
        new = jnp.where(v, new, alpha)
        bp = jnp.where(v, bp, jnp.zeros_like(bp))
        return new, (bp, v)

    alpha_T, (bps, vs) = jax.lax.scan(step, alpha0, (obs_pos[1:], valid[1:]))
    final_v = alpha_T + _final(graph, P)
    end_pos = jnp.argmax(final_v).astype(jnp.int32)
    score = final_v[end_pos]

    def back(pos, xs):
        bp_t, v = xs
        prev = jnp.where(v, in_src[pos, bp_t[pos]], pos)
        return prev, prev

    _, path_rev = jax.lax.scan(back, end_pos, (bps, vs), reverse=True)
    path = jnp.concatenate([path_rev, end_pos[None]])
    return path, score


def masked_multipath_viterbi_fb(obs_pos, graph, n_frames,
                                num_trans_slots: int,
                                with_live: bool = False):
    """Multipath-Viterbi forward-backward (`stats -M mpv`,
    `aku/HmmNetBaumWelch.hh:85`).  Matches the reference recursion
    exactly:

    * BACKWARD (`fill_backward_probabilities`, HmmNetBaumWelch.cc:
      904-985): per source node, arcs sharing the first-level logical
      arc (``mpv_gid`` = dense (source node, parent arc) ids) are
      maximized — only the best ("realized") arc keeps a backward
      score — and the realized arcs are summed to form the node score.
    * FORWARD (`create_segmented_lattice`, :1190-1330): plain
      Baum-Welch summation, but only over arcs realized at each frame
      (non-realized arcs carry a zero backward score, so the forward
      beam test at :1316 prunes them for any beam).
    * gamma: alpha*beta posteriors over realized arcs, renormalized per
      frame exactly like `next_frame`'s prob_sum division
      (HmmNetBaumWelch.cc:783-788).
    """
    T, P = obs_pos.shape
    in_src, in_logp = graph["in_src"], graph["in_logp"]
    out_tgt, out_logp = graph["out_tgt"], graph["out_logp"]
    gid = graph["mpv_gid"]
    valid = jnp.arange(T) < n_frames
    idx = jnp.arange(P)

    def realize(val):
        # winner-per-group mask over val [P]; ties keep the lowest
        # position id (the reference keeps the first arc encountered;
        # any single winner matches its semantics)
        gmax = jax.ops.segment_max(val, gid, num_segments=P)[gid]
        att = jnp.where(val >= gmax, idx, P)
        first = jax.ops.segment_min(att, gid, num_segments=P)[gid]
        return (idx == first) & (val > LOG_ZERO / 2)

    beta_last = _final(graph, P)

    def bwd(beta, xs):
        # carry = betas[t+1]; realization of arcs consuming frame t+1
        obs_next, v = xs
        val = obs_next + beta                              # [P]
        real = realize(val) & v
        rv = jnp.where(real, val, LOG_ZERO)
        new = jnp.maximum(
            logsumexp(out_logp + rv[out_tgt], axis=1), LOG_ZERO)
        new = jnp.where(v, new, beta)
        return new, (new, real)

    _, (betas_head, real_tail) = jax.lax.scan(
        bwd, beta_last, (obs_pos[1:], valid[1:]), reverse=True)
    betas = jnp.concatenate([betas_head, beta_last[None]], axis=0)
    real0 = realize(obs_pos[0] + betas[0])
    realized = jnp.concatenate([real0[None], real_tail], axis=0)

    entry = _entry(graph, P)
    # reference total = the mpv backward score at the initial node
    total = logsumexp(
        jnp.where(real0, entry + obs_pos[0] + betas[0], LOG_ZERO),
        axis=0)

    alpha0 = jnp.where(real0,
                       jnp.maximum(obs_pos[0] + entry, LOG_ZERO),
                       LOG_ZERO)

    def fwd(alpha, xs):
        obs_t, real_t, v = xs
        new = logsumexp(alpha[in_src] + in_logp, axis=1) + obs_t
        new = jnp.maximum(jnp.where(real_t, new, LOG_ZERO), LOG_ZERO)
        new = jnp.where(v, new, alpha)
        return new, alpha

    alpha_T, alphas_prev = jax.lax.scan(
        fwd, alpha0, (obs_pos[1:], realized[1:], valid[1:]))
    alphas = jnp.concatenate([alphas_prev, alpha_T[None]], axis=0)

    gamma = jnp.exp(jnp.maximum(alphas + betas - total, -80.0))
    gamma = gamma * realized * valid[:, None]
    denom = jnp.maximum(jnp.sum(gamma, axis=1, keepdims=True), 1e-30)
    gamma = jnp.where(valid[:, None], gamma / denom, 0.0)

    trans_post = jnp.zeros(num_trans_slots, dtype=jnp.float32)
    if "final_slot" in graph:
        trans_post = trans_post.at[graph["final_slot"]].add(1.0)
    if with_live:
        live = ((alphas > LOG_ZERO / 2) & (betas > LOG_ZERO / 2)
                & realized & valid[:, None])
        return gamma, trans_post, total, live
    return gamma, trans_post, total


def chain_stats(scorer, features, graph, n_frames, num_trans_slots: int,
                mode: str = "bw", full_stats: bool = False,
                arc_feacount: bool = False):
    """Full per-utterance E-step; returns a device stats pytree.

    mode: 'bw' (Baum-Welch posteriors, `-M bw`), 'vit' (Viterbi one-hot,
    `-M vit`; `aku/stats.cc:341`).  Output keys: gamma [Gp], mean_acc
    [Gp, D], sec_acc [Gp, D], feacount [Gp], mix_gamma [Sp, K],
    trans_acc [NT], log_likelihood, num_frames.
    """
    pdf = graph["pdf"]                                    # [P]
    T = features.shape[0]
    P = pdf.shape[0]
    K = scorer.comp_idx.shape[1]
    Gp = scorer.score_matrix.shape[1]
    Sp = scorer.comp_idx.shape[0]

    gll = scorer.gaussian_log_likelihoods(features)       # [T, Gp]
    if P < Sp:
        # Score only the states the chain actually visits: gather gll
        # at [P, K] component columns instead of all [Sp, K] and
        # logsumexp per position.  Identical values (same elements,
        # same reduction), but the gather shrinks Sp*K -> P*K columns
        # AND is the very gather log_resp needs below, so XLA reuses
        # it.  Roofline (benchmarks/roofline_estep.py): the all-state
        # gather was the single largest E-step component.
        state_obs = logsumexp(                            # [T, P]
            gll[:, scorer.comp_idx[pdf]] + scorer.comp_logw[pdf],
            axis=-1)
    else:
        sll = logsumexp(                                  # [T, Sp]
            gll[:, scorer.comp_idx] + scorer.comp_logw, axis=-1)
        state_obs = sll[:, pdf]                           # [T, P]
    obs_pos = state_obs
    if "obs_const" in graph:
        # hmmnet graphs: per-arc static score + ln(transition prob)
        # (get_arc_score, HmmNetBaumWelch.cc:1917-1943)
        obs_pos = obs_pos + graph["obs_const"][None, :]

    live = None                # structural liveness [T, P] when exact
    if mode == "bw":
        fb = (masked_forward_backward_shift if "sh_logp" in graph
              else masked_forward_backward)
        if arc_feacount:
            gamma, trans_post, total, live = fb(
                obs_pos, graph, n_frames, num_trans_slots,
                with_transitions="arc_slot" not in graph,
                with_live=True)
        else:
            gamma, trans_post, total = fb(
                obs_pos, graph, n_frames, num_trans_slots,
                with_transitions="arc_slot" not in graph)
    elif mode == "mpv":
        if arc_feacount:
            gamma, trans_post, total, live = \
                masked_multipath_viterbi_fb(
                    obs_pos, graph, n_frames, num_trans_slots,
                    with_live=True)
        else:
            gamma, trans_post, total = masked_multipath_viterbi_fb(
                obs_pos, graph, n_frames, num_trans_slots)
    elif mode == "vit":
        vit = (masked_viterbi_shift if "sh_logp" in graph
               else masked_viterbi)
        path, total = vit(obs_pos, graph, n_frames)
        valid = jnp.arange(T) < n_frames
        gamma = jax.nn.one_hot(path, P, dtype=jnp.float32) * valid[:, None]
        live = gamma > 0.5
        # transition counts along the path (arc-synchronous graphs
        # derive them from arc_slot occupancies below instead)
        trans_post = (jnp.zeros(num_trans_slots, dtype=jnp.float32)
                      if "arc_slot" in graph else
                      _viterbi_transition_counts(
                          path, graph, n_frames, num_trans_slots))
    else:
        raise ValueError(f"unknown segmentation mode {mode!r}")

    if "arc_slot" in graph:
        # arc-synchronous graphs: every frame spent on a position IS a
        # traversal of its transition slot
        trans_post = jax.ops.segment_sum(
            jnp.sum(gamma, axis=0), graph["arc_slot"],
            num_segments=num_trans_slots)

    # component responsibilities within each position's mixture
    cidx = scorer.comp_idx[pdf]                           # [P, K]
    clogw = scorer.comp_logw[pdf]                         # [P, K]
    # log resp[t, p, k] = logw + gll[t, cidx] - sll[t, pdf]
    # (denominator is the pure state likelihood, NOT the const-shifted
    # search observation)
    log_resp = clogw[None] + gll[:, cidx] - state_obs[:, :, None]
    R = gamma[:, :, None] * jnp.exp(jnp.maximum(log_resp, -80.0))
    R_flat = R.reshape(T, P * K)                          # [T, P*K]

    g_flat = cidx.reshape(-1)                             # [P*K]
    c = jnp.sum(R_flat, axis=0)                           # [P*K]
    gamma_g = jax.ops.segment_sum(c, g_flat, num_segments=Gp)
    m1 = jax.ops.segment_sum(
        jnp.dot(R_flat.T, features, precision=_F32), g_flat,
        num_segments=Gp)
    m2 = jax.ops.segment_sum(
        jnp.dot(R_flat.T, features * features, precision=_F32), g_flat,
        num_segments=Gp)
    m2_full = None
    if full_stats:
        # full second moments: one [P*K, T] x [T, D^2] matmul
        # (PDF_ML_FULL_STATS; FullStatisticsAccumulator)
        D = features.shape[1]
        outer = (features[:, :, None]
                 * features[:, None, :]).reshape(T, D * D)
        m2_full = jax.ops.segment_sum(
            jnp.dot(R_flat.T, outer, precision=_F32), g_flat,
            num_segments=Gp).reshape(Gp, D, D)
    # feacount: the reference increments it once per accumulate() call
    # for EVERY mixture component, and a call happens per (frame, pdf)
    # entry of the posterior map — i.e. per frame in which the state
    # has any live lattice arc (`HmmNetBaumWelch::next_frame`
    # m_pdf_prob_map fill, HmmNetBaumWelch.cc:735-741;
    # `Gaussian::accumulate` -> accumulate(1, ...),
    # Distributions.cc:282).  So count state-presence frames, then
    # spread over the state's real components.  Presence means a LIVE
    # lattice arc: structurally dead (alpha or beta = log-zero)
    # positions carry the exp(-80) clamp floor from the FB, not a real
    # posterior, so test above that floor rather than > 0 — backward-
    # zero arcs never enter the reference's pdf map
    # (create_segmented_lattice beam test, HmmNetBaumWelch.cc:1165).
    #
    # TWO reference counting conventions share this accumulator:
    # * ML-only path (simple_train): one accumulate per live
    #   (frame, pdf) — aggregate positions into per-state presence;
    # * discriminative path (collect_lattice_stats, stats.cc:254-306):
    #   one accumulate per SEGMENTED ARC of the unfolded frame
    #   lattice.  A live arc at frame t materializes one segmented-arc
    #   COPY per distinct epsilon-reachable continuation node that
    #   holds its pending arc and has a surviving out arc at t+1
    #   (create_segmented_lattice pending-arc copying,
    #   HmmNetBaumWelch.cc:1221-1250,1296-1338), plus exactly one copy
    #   at the utterance-final connection (:1389-1407).
    if live is None:
        # above the exp(-80) clamp floor ~1.8e-35 (see note above)
        live = gamma > 1e-32
    live = live.astype(jnp.float32)                      # [T, P]
    if arc_feacount:
        out_tgt = graph["out_tgt"]                       # [P, F]
        out_node = graph["src_node"][out_tgt]            # [P, F]
        real_edge = graph["out_logp"] > LOG_ZERO / 2     # [P, F]
        Fw = out_tgt.shape[1]
        live_next = jnp.concatenate(
            [live[1:], jnp.zeros((1, P), live.dtype)], axis=0)
        el = (live_next[:, out_tgt] > 0) & real_edge     # [T, P, F]
        same = out_node[:, :, None] == out_node[:, None, :]
        first = jnp.tril(jnp.ones((Fw, Fw), bool), k=-1)  # f' < f
        dup = jnp.any(el[:, :, None, :]
                      & (same & first[None])[None], axis=-1)
        copies = jnp.sum((el & ~dup).astype(jnp.float32), axis=-1)
        lastf = (jnp.arange(T) == n_frames - 1)[:, None]
        per = live * jnp.where(lastf, 1.0, copies)       # [T, P]
        frames_s = jax.ops.segment_sum(
            jnp.sum(per, axis=0), pdf,
            num_segments=Sp).astype(jnp.int32)
    else:
        pres = jax.ops.segment_sum(                      # [Sp, T]
            live.T, pdf, num_segments=Sp)
        frames_s = jnp.sum((pres > 0).astype(jnp.int32), axis=1)
    real_comp = scorer.comp_logw > LOG_ZERO / 2          # [Sp, K]
    feacount = jax.ops.segment_sum(
        jnp.where(real_comp, frames_s[:, None], 0).reshape(-1),
        scorer.comp_idx.reshape(-1), num_segments=Gp)
    mix_gamma = jax.ops.segment_sum(
        c.reshape(P, K), pdf, num_segments=Sp)            # [Sp, K]
    # mixture log-likelihood accumulator: gamma * ln(state likelihood)
    # per accumulation (Mixture::accumulate `mixture_ll`,
    # Distributions.cc:2150-2153); the likelihood is the PURE state
    # mixture value, not the const-shifted search observation
    mix_ll = jax.ops.segment_sum(
        jnp.sum(gamma * state_obs, axis=0), pdf, num_segments=Sp)

    out = {
        "gamma": gamma_g, "mean_acc": m1, "sec_acc": m2,
        "feacount": feacount, "mix_gamma": mix_gamma,
        "mix_ll": mix_ll,
        "trans_acc": trans_post, "log_likelihood": total,
        "num_frames": n_frames.astype(jnp.int32)
        if hasattr(n_frames, "astype") else jnp.int32(n_frames),
    }
    if m2_full is not None:
        out["sec_acc_full"] = m2_full
    return out


def _viterbi_transition_counts(path, graph, n_frames, num_trans_slots):
    """Count taken transitions along a Viterbi path onto slots."""
    in_src, in_slot = graph["in_src"], graph["in_slot"]
    T = path.shape[0]
    src = path[:-1]
    tgt = path[1:]
    # find which in-edge of tgt has source == src (first match)
    cand_src = in_src[tgt]                                # [T-1, F]
    match = cand_src == src[:, None]
    f = jnp.argmax(match, axis=1)
    slots = jnp.take_along_axis(in_slot[tgt], f[:, None], axis=1)[:, 0]
    valid = (jnp.arange(T - 1) + 1 < n_frames) & jnp.any(match, axis=1)
    counts = jax.ops.segment_sum(
        valid.astype(jnp.float32), slots, num_segments=num_trans_slots)
    return counts.at[graph["final_slot"]].add(1.0)


def batch_chain_stats(scorer, features, graphs, n_frames,
                      num_trans_slots: int, mode: str = "bw"):
    """vmap over a padded utterance batch; sums stats over the batch.

    features [B, T, D]; graphs: dict of stacked arrays [B, ...];
    n_frames [B].
    """
    per_utt = jax.vmap(
        lambda f, g, n: chain_stats(scorer, f, g, n, num_trans_slots, mode))
    stats = per_utt(features, graphs, n_frames)
    summed = {k: jnp.sum(v, axis=0) for k, v in stats.items()
              if k not in ("log_likelihood", "num_frames")}
    summed["log_likelihood"] = jnp.sum(stats["log_likelihood"])
    summed["num_frames"] = jnp.sum(stats["num_frames"])
    return summed


# ---------------------------------------------------------------------------
# shift-compiled forward-backward: positions are numbered phone-locally,
# so nearly every edge has target - source in {0, 1, 2}; those relax as
# array shifts (pure elementwise steps instead of dynamic gathers, which
# otherwise bound the whole E-step).  Remaining
# edges form a compact irregular list handled by one small gather +
# scatter-logsumexp per step.
# ---------------------------------------------------------------------------

def shift_compile(graph: dict) -> dict:
    """Host: split a padded graph's in-edges into shift classes.

    Returns the graph dict extended with:
      sh_logp [3, P]  — in-edge weight from p-d for d in {0,1,2}
      sh_slot [3, P]  — transition slot of that edge
      ir_src/ir_tgt/ir_logp/ir_slot [Ei] — leftover edges
    """
    import numpy as np
    in_src = np.asarray(graph["in_src"])
    in_logp = np.asarray(graph["in_logp"])
    in_slot = np.asarray(graph["in_slot"])
    P, F = in_src.shape
    sh_logp = np.full((3, P), LOG_ZERO, np.float32)
    sh_slot = np.zeros((3, P), np.int32)
    ir_src, ir_tgt, ir_logp, ir_slot = [], [], [], []
    for p in range(P):
        for f in range(F):
            s = int(in_src[p, f])
            w = float(in_logp[p, f])
            if w <= LOG_ZERO / 2:
                continue
            d = p - s
            if d in (0, 1, 2) and sh_logp[d, p] <= LOG_ZERO / 2:
                sh_logp[d, p] = w
                sh_slot[d, p] = in_slot[p, f]
            else:
                ir_src.append(s)
                ir_tgt.append(p)
                ir_logp.append(w)
                ir_slot.append(int(in_slot[p, f]))
    if not ir_src:
        ir_src, ir_tgt = [0], [0]
        ir_logp, ir_slot = [LOG_ZERO], [0]
    out = dict(graph)
    out["sh_logp"] = np.asarray(sh_logp)
    out["sh_slot"] = np.asarray(sh_slot)
    out["ir_src"] = np.asarray(ir_src, np.int32)
    out["ir_tgt"] = np.asarray(ir_tgt, np.int32)
    out["ir_logp"] = np.asarray(ir_logp, np.float32)
    out["ir_slot"] = np.asarray(ir_slot, np.int32)
    return out


def _sh(x, d, fill):
    """x[p-d] with fill for p < d (shift toward higher indices)."""
    if not d:
        return x
    pad = jnp.full((d,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([pad, x[:-d]])


def _sh_back(x, d, fill):
    """x[p+d] with fill past the end."""
    if not d:
        return x
    pad = jnp.full((d,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([x[d:], pad])


def _scatter_lse(contrib, tgt, P):
    """Log-sum-exp scatter of contrib [E] onto targets [E] -> [P]."""
    mx = jnp.full((P,), LOG_ZERO, jnp.float32).at[tgt].max(contrib)
    live = contrib > LOG_ZERO / 2
    sums = jnp.zeros((P,), jnp.float32).at[tgt].add(
        jnp.where(live, jnp.exp(contrib - mx[tgt]), 0.0))
    return jnp.where(sums > 0, mx + jnp.log(jnp.maximum(sums, 1e-30)),
                     LOG_ZERO)


def masked_forward_backward_shift(obs_pos, graph, n_frames,
                                  num_trans_slots: int,
                                  with_transitions: bool = True,
                                  with_live: bool = False):
    """Shift-structured FB; same contract as masked_forward_backward.

    Per-step transition statistics accumulate ELEMENTWISE into per-
    (position, shift-class) carries and hit transition slots with one
    segment-sum at the end (the per-step segment_sum of the plain path
    is another scatter bottleneck).
    """
    T, P = obs_pos.shape
    w0, w1, w2 = (graph["sh_logp"][d] for d in range(3))
    ir_src, ir_tgt = graph["ir_src"], graph["ir_tgt"]
    ir_logp = graph["ir_logp"]

    valid = jnp.arange(T) < n_frames
    alpha0 = jnp.maximum(obs_pos[0] + _entry(graph, P), LOG_ZERO)

    def lse4(a, b, c, d):
        m = jnp.maximum(jnp.maximum(a, b), jnp.maximum(c, d))
        m_safe = jnp.maximum(m, LOG_ZERO)
        s = (jnp.exp(a - m_safe) + jnp.exp(b - m_safe)
             + jnp.exp(c - m_safe) + jnp.exp(d - m_safe))
        return jnp.where(m > LOG_ZERO / 2,
                         m_safe + jnp.log(jnp.maximum(s, 1e-30)),
                         LOG_ZERO)

    def fwd(alpha, xs):
        obs_t, v = xs
        c0 = alpha + w0
        c1 = _sh(alpha, 1, LOG_ZERO) + w1
        c2 = _sh(alpha, 2, LOG_ZERO) + w2
        cir = _scatter_lse(alpha[ir_src] + ir_logp, ir_tgt, P)
        new = jnp.maximum(lse4(c0, c1, c2, cir) + obs_t, LOG_ZERO)
        new = jnp.where(v, new, alpha)
        return new, alpha

    # unroll: the step body is ~[P]-wide elementwise work, far below
    # the per-step dispatch floor — unrolling amortizes it (roofline:
    # the fb scans are the E-step's largest component after the
    # per-position scoring fix)
    alpha_T, alphas_prev = jax.lax.scan(
        fwd, alpha0, (obs_pos[1:], valid[1:]), unroll=4)
    alphas = jnp.concatenate([alphas_prev, alpha_T[None]], axis=0)

    beta_last = _final(graph, P)
    total = logsumexp(alpha_T + beta_last, axis=0)

    # backward: out-edge of q with shift d has weight w_d[q+d]
    def bwd(beta, xs):
        obs_next, v = xs
        t_ob = obs_next + beta                   # [P] target term
        c0 = w0 + t_ob
        c1 = _sh_back(w1 + t_ob, 1, LOG_ZERO)
        c2 = _sh_back(w2 + t_ob, 2, LOG_ZERO)
        cir = _scatter_lse(ir_logp + t_ob[ir_tgt], ir_src, P)
        new = jnp.maximum(lse4(c0, c1, c2, cir), LOG_ZERO)
        new = jnp.where(v, new, beta)
        return new, new

    _, betas_head = jax.lax.scan(
        bwd, beta_last, (obs_pos[1:], valid[1:]), reverse=True,
        unroll=4)
    betas = jnp.concatenate([betas_head, beta_last[None]], axis=0)

    gamma = jnp.exp(jnp.maximum(alphas + betas - total, -80.0))
    gamma = gamma * valid[:, None]

    trans_post = jnp.zeros(num_trans_slots, dtype=jnp.float32)
    if with_transitions:
        Ei = ir_src.shape[0]

        def trans_step(acc, xs):
            acc_sh, acc_ir = acc
            alpha_t, obs_next, beta_next, v = xs
            t_ob = obs_next + beta_next - total
            x0 = jnp.exp(jnp.maximum(alpha_t + w0 + t_ob, -80.0))
            x1 = jnp.exp(jnp.maximum(
                _sh(alpha_t, 1, LOG_ZERO) + w1 + t_ob, -80.0))
            x2 = jnp.exp(jnp.maximum(
                _sh(alpha_t, 2, LOG_ZERO) + w2 + t_ob, -80.0))
            xir = jnp.exp(jnp.maximum(
                alpha_t[ir_src] + ir_logp + t_ob[ir_tgt], -80.0))
            vf = v.astype(jnp.float32)
            acc_sh = acc_sh + vf * jnp.stack([x0, x1, x2])
            acc_ir = acc_ir + vf * xir
            return (acc_sh, acc_ir), None

        (acc_sh, acc_ir), _ = jax.lax.scan(
            trans_step,
            (jnp.zeros((3, P), jnp.float32),
             jnp.zeros((Ei,), jnp.float32)),
            (alphas[:-1], obs_pos[1:], betas[1:], valid[1:]))
        trans_post = jax.ops.segment_sum(
            jnp.concatenate([acc_sh.reshape(-1), acc_ir]),
            jnp.concatenate([graph["sh_slot"].reshape(-1),
                             graph["ir_slot"]]),
            num_segments=num_trans_slots)
    if "final_slot" in graph:
        trans_post = trans_post.at[graph["final_slot"]].add(1.0)
    if with_live:
        live = ((alphas > LOG_ZERO / 2) & (betas > LOG_ZERO / 2)
                & valid[:, None])
        return gamma, trans_post, total, live
    return gamma, trans_post, total


def masked_viterbi_shift(obs_pos, graph, n_frames):
    """Shift-structured Viterbi; same contract as masked_viterbi.

    Backpointers store the winning shift class (0/1/2) or 3+irregular
    winner; the backtrace resolves them against the static tables.
    """
    T, P = obs_pos.shape
    w0, w1, w2 = (graph["sh_logp"][d] for d in range(3))
    ir_src, ir_tgt = graph["ir_src"], graph["ir_tgt"]
    ir_logp = graph["ir_logp"]
    Ei = ir_src.shape[0]
    valid = jnp.arange(T) < n_frames

    alpha0 = jnp.maximum(obs_pos[0] + _entry(graph, P), LOG_ZERO)

    def step(alpha, xs):
        obs_t, v = xs
        c0 = alpha + w0
        c1 = _sh(alpha, 1, LOG_ZERO) + w1
        c2 = _sh(alpha, 2, LOG_ZERO) + w2
        contrib = alpha[ir_src] + ir_logp               # [Ei]
        cir = jnp.full((P,), LOG_ZERO, jnp.float32).at[ir_tgt].max(
            contrib)
        eidx = jnp.arange(Ei, dtype=jnp.int32)
        win = jnp.full((P,), 0, jnp.int32).at[ir_tgt].max(
            jnp.where(contrib >= cir[ir_tgt], eidx, 0))
        stacked = jnp.stack([c0, c1, c2, cir])
        choice = jnp.argmax(stacked, axis=0).astype(jnp.int32)
        best = jnp.max(stacked, axis=0)
        new = jnp.maximum(best + obs_t, LOG_ZERO)
        new = jnp.where(v, new, alpha)
        choice = jnp.where(v, choice, jnp.zeros_like(choice))
        win = jnp.where(v, win, jnp.zeros_like(win))
        return new, (choice, win, v)

    alpha_T, (chs, wins, vs) = jax.lax.scan(
        step, alpha0, (obs_pos[1:], valid[1:]))
    final_v = alpha_T + _final(graph, P)
    end_pos = jnp.argmax(final_v).astype(jnp.int32)
    score = final_v[end_pos]

    def back(pos, xs):
        ch_t, win_t, v = xs
        c = ch_t[pos]
        prev = jnp.where(c == 3, ir_src[win_t[pos]], pos - c)
        prev = jnp.where(v, prev, pos)
        return prev, prev

    _, path_rev = jax.lax.scan(back, end_pos, (chs, wins, vs),
                               reverse=True)
    path = jnp.concatenate([path_rev, end_pos[None]])
    return path, score
