"""Viterbi and forward-backward as time-major scans over position graphs.

The reference fills an explicit (frame x position) lattice with windowing
(`aku/Viterbi.cc:356` fill, `:296` compute_best_path) and runs beam-pruned
backward/forward passes over hmmnet FSTs (`aku/HmmNetBaumWelch.cc:817,
1079`).  Here both are dense `lax.scan`s over the padded fan-in tables from
`models.hmm.pad_chain`: no beams needed on device (the whole [T, P] lattice is
a few MB and the scan step is gather + small-axis reduction), no windowing
(HBM holds the full lattice; chunking only matters for hour-long audio).

All functions take ``obs_pos`` = per-position observation log-likelihoods
[T, P] (``state_ll[:, pdf]`` gathered by the caller) and the graph dict.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from aaltoasr_tpu.ops.logsemiring import LOG_ZERO, logsumexp


def _entry_vector(P, num_positions):
    p = jnp.arange(P)
    return jnp.where(p == 0, 0.0, LOG_ZERO)


def _final_vector(P, num_positions, final_logp):
    p = jnp.arange(P)
    return jnp.where(p == num_positions - 1, final_logp, LOG_ZERO)


def viterbi_chain(obs_pos, graph):
    """Dense Viterbi over a chain graph.

    Returns (path [T] int32 positions, total score).  Equivalent of
    Viterbi::fill + compute_best_path with the forced start at position 0
    and forced end at the last position (`aku/Viterbi.cc:296-392`).
    """
    T, P = obs_pos.shape
    in_src = graph["in_src"]
    in_logp = graph["in_logp"]
    nump = graph["num_positions"]

    alpha0 = jnp.maximum(obs_pos[0] + _entry_vector(P, nump), LOG_ZERO)

    def step(alpha, obs_t):
        cand = alpha[in_src] + in_logp                  # [P, F]
        best = jnp.max(cand, axis=1)
        bp = jnp.argmax(cand, axis=1).astype(jnp.int32)
        new = jnp.maximum(best + obs_t, LOG_ZERO)
        return new, (bp,)

    alpha_T, (bps,) = jax.lax.scan(step, alpha0, obs_pos[1:])
    final = alpha_T + _final_vector(P, nump, graph["final_logp"])
    end_pos = nump - 1
    score = final[end_pos]

    def back(pos, bp_t):
        prev = in_src[pos, bp_t[pos]]
        return prev, prev

    _, path_rev = jax.lax.scan(back, end_pos, bps, reverse=True)
    path = jnp.concatenate([path_rev, jnp.asarray([end_pos])])
    return path, score


def forward_backward_chain(obs_pos, graph, num_trans_slots: int):
    """Dense forward-backward; returns (gamma [T, P], trans_post [NT],
    total log-likelihood).

    gamma are linear-domain posteriors; trans_post accumulates transition
    posteriors onto TransitionTable slots (the .phs statistics).  The final
    exit transition of the utterance is accounted by `final_slot` (set by
    the caller via graph["final_slot"], posterior 1).
    """
    T, P = obs_pos.shape
    in_src = graph["in_src"]
    in_logp = graph["in_logp"]
    in_slot = graph["in_slot"]
    out_tgt = graph["out_tgt"]
    out_logp = graph["out_logp"]
    nump = graph["num_positions"]

    alpha0 = jnp.maximum(obs_pos[0] + _entry_vector(P, nump), LOG_ZERO)

    def fwd(alpha, obs_t):
        new = logsumexp(alpha[in_src] + in_logp, axis=1) + obs_t
        new = jnp.maximum(new, LOG_ZERO)
        return new, alpha

    alpha_T, alphas_prev = jax.lax.scan(fwd, alpha0, obs_pos[1:])
    alphas = jnp.concatenate([alphas_prev, alpha_T[None]], axis=0)  # [T, P]

    beta_T = _final_vector(P, nump, graph["final_logp"])
    total = logsumexp(alpha_T + beta_T, axis=0)

    def bwd(beta_next, obs_next):
        # beta[t, p] = logsum_f out_logp[p,f] + obs[t+1, tgt] + beta[t+1, tgt]
        contrib = out_logp + obs_next[out_tgt] + beta_next[out_tgt]
        beta = jnp.maximum(logsumexp(contrib, axis=1), LOG_ZERO)
        return beta, beta

    _, betas_head = jax.lax.scan(bwd, beta_T, obs_pos[1:], reverse=True)
    betas = jnp.concatenate([betas_head, beta_T[None]], axis=0)

    gamma = jnp.exp(jnp.maximum(alphas + betas - total, -80.0))

    # transition posteriors: xi[t, p, f] for arrival at frame t+1
    def trans_step(acc, inputs):
        alpha_t, obs_next, beta_next = inputs
        xi = (alpha_t[in_src] + in_logp + obs_next[:, None]
              + beta_next[:, None] - total)
        xi = jnp.exp(jnp.maximum(xi, -80.0))
        acc = acc + jax.ops.segment_sum(
            xi.reshape(-1), in_slot.reshape(-1),
            num_segments=num_trans_slots)
        return acc, None

    trans0 = jnp.zeros(num_trans_slots, dtype=jnp.float32)
    trans_post, _ = jax.lax.scan(
        trans_step, trans0,
        (alphas[:-1], obs_pos[1:], betas[1:]))
    # final exit transition: taken with posterior gamma[T-1, last] (== 1)
    final_slot = graph.get("final_slot", None)
    if final_slot is not None:
        trans_post = trans_post.at[final_slot].add(
            gamma[T - 1, nump - 1])
    return gamma, trans_post, total


def dense_transition_matrix(graph) -> jnp.ndarray:
    """[P, P] log-transition matrix M[i, j] = log p(j -> i) from the
    padded fan-in tables (duplicate arcs logaddexp-accumulated)."""
    import numpy as np
    in_src = np.asarray(graph["in_src"])
    in_logp = np.asarray(graph["in_logp"])
    P = in_src.shape[0]
    M = np.full((P, P), -np.inf)
    for i in range(P):
        for f in range(in_src.shape[1]):
            lp = in_logp[i, f]
            if lp > LOG_ZERO / 2:
                M[i, in_src[i, f]] = np.logaddexp(M[i, in_src[i, f]],
                                                  lp)
    return jnp.asarray(np.maximum(M, LOG_ZERO), jnp.float32)


def forward_assoc_chain(obs_pos, graph, trans_dense=None):
    """Forward pass as a log-semiring matrix `associative_scan` over
    time — the sequence-parallel formulation (SURVEY §5.7: the
    legitimate SP analog; there is no attention to ring-shard).

    alpha_t = (A_t (.) ... (.) A_1) alpha_0 with A_t[i, j] =
    trans[j->i] + obs_t[i] and (B (.) A)[i, j] = logsum_k B[i,k] +
    A[k,j].  `associative_scan` turns the T-step recurrence into a
    log2(T)-depth tree whose combine is a [P, P] log-matmul, so XLA
    can split the TIME axis across devices — shard `obs_pos` along T
    under a mesh and the prefix tree composes across chips with
    collectives.

    Cost: O(T P^3) FLOPs vs the sequential scan's O(T P^2) — P times
    the work, so unprofitable on ONE card at LVCSR sizes (P >= 512);
    use it when a single utterance must span devices (hour-scale
    audio) or P is small.  Returns (alphas [T, P], total log-likelihood).
    """
    T, P = obs_pos.shape
    if trans_dense is None:
        trans_dense = dense_transition_matrix(graph)
    nump = graph["num_positions"]
    alpha0 = jnp.maximum(obs_pos[0] + _entry_vector(P, nump), LOG_ZERO)

    # A_t for t = 1..T-1
    A = trans_dense[None, :, :] + obs_pos[1:, :, None]   # [T-1, P, P]

    def combine(a, b):
        # (b (.) a)[i, j] = logsum_k b[i, k] + a[k, j]
        return logsumexp(b[..., :, :, None] + a[..., None, :, :],
                         axis=-2)

    prefixes = jax.lax.associative_scan(combine, A, axis=0)
    alphas_tail = logsumexp(
        prefixes + alpha0[None, None, :], axis=-1)       # [T-1, P]
    alphas = jnp.concatenate([alpha0[None], alphas_tail], axis=0)
    alphas = jnp.maximum(alphas, LOG_ZERO)
    beta_T = _final_vector(P, nump, graph["final_logp"])
    total = logsumexp(alphas[-1] + beta_T, axis=0)
    return alphas, total


def occupancies_from_alignment(path, P: int):
    """One-hot gamma from a Viterbi path: [T, P] (PhnReader-style fixed
    segmentation, `aku/PhnReader.cc` next_frame semantics)."""
    return jax.nn.one_hot(path, P, dtype=jnp.float32)
