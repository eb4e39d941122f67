"""CMLLR (fMLLR) adaptation: statistics on device, row-iteration solve.

Reference: `aku/MllrTrainer.{hh,cc}`.  Per regression class the
sufficient statistics are (MllrTrainer.cc:148-161)::

    beta   = sum_t,g gamma_tg
    k_i    = sum_t,g gamma_tg * mu_gi / sigma_gi^2 * xi_t
    G_i    = sum_t,g gamma_tg / sigma_gi^2 * xi_t xi_t^T

with extended features ``xi = [1; x]``.  The transform solves the
constrained-MLLR objective by Gales' row iteration with the cofactor
alpha quadratic (MllrTrainer.cc:166-253; 20*dim rounds).

Device mapping: frame x Gaussian posteriors never materialize — the class/
dimension weights fold into two matmuls over the responsibility matrix
(R [T, P*K] from the E-step), giving G as a stack of small
weighted-Gram matrices.  The solve itself is tiny host NumPy.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from aaltoasr_tpu.ops.logsemiring import logsumexp
from aaltoasr_tpu.train import estep

_F32 = jax.lax.Precision.HIGHEST


def cmllr_stats(scorer, features, graph, n_frames, gauss_class,
                num_classes: int, means, covars):
    """Device CMLLR statistics for one utterance.

    gauss_class: [Gp] regression class per Gaussian (int32).
    means/covars: [Gp, D] model parameters (padded like the scorer).
    Returns dict(beta [C], k [C, D, D+1], G [C, D, D+1, D+1]).
    """
    pdf = graph["pdf"]
    T = features.shape[0]
    K = scorer.comp_idx.shape[1]
    P = pdf.shape[0]
    D = features.shape[1]

    gll = scorer.gaussian_log_likelihoods(features)
    sll = logsumexp(gll[:, scorer.comp_idx] + scorer.comp_logw, axis=-1)
    obs_pos = sll[:, pdf]
    if "obs_const" in graph:
        obs_pos = obs_pos + graph["obs_const"][None, :]
    gamma, _, total = estep.masked_forward_backward(
        obs_pos, graph, n_frames, 1)

    cidx = scorer.comp_idx[pdf]                       # [P, K]
    clogw = scorer.comp_logw[pdf]
    log_resp = clogw[None] + gll[:, cidx] - sll[:, pdf][:, :, None]
    R = gamma[:, :, None] * jnp.exp(jnp.maximum(log_resp, -80.0))
    R_flat = R.reshape(T, P * K)                      # [T, PK]
    g_flat = cidx.reshape(-1)                         # [PK]

    prec = jnp.where(covars > 0, 1.0 / covars, 0.0)   # [Gp, D]
    C = num_classes
    # per-(class, dim) weight tables indexed by Gaussian
    M = jnp.zeros((prec.shape[0], C * D), jnp.float32)
    cls_one_hot = jax.nn.one_hot(gauss_class, C, dtype=jnp.float32)
    # M[g, c*D + i] = 1[class g == c] * prec[g, i]
    M = (cls_one_hot[:, :, None] * prec[:, None, :]).reshape(-1, C * D)
    M2 = (cls_one_hot[:, :, None] * (means * prec)[:, None, :]
          ).reshape(-1, C * D)

    Wt = jnp.dot(R_flat, M[g_flat], precision=_F32)   # [T, C*D]
    Vt = jnp.dot(R_flat, M2[g_flat], precision=_F32)  # [T, C*D]

    xi = jnp.concatenate(
        [jnp.ones((T, 1), features.dtype), features], axis=1)  # [T, D+1]

    # k[c, i] = sum_t Vt[t, m] xi_t ; G[c, i] = sum_t Wt[t, m] xi xi^T
    k = jnp.einsum("tm,tj->mj", Vt, xi,
                   precision=_F32).reshape(C, D, D + 1)
    G = jnp.einsum("tm,ti,tj->mij", Wt, xi, xi,
                   precision=_F32).reshape(C, D, D + 1, D + 1)
    beta_cd = jnp.sum(Wt * 0, axis=0)  # placeholder, beta from gamma:
    # beta[c] = sum over Gaussians of class c of their occupancy
    occ_pk = jnp.sum(R_flat, axis=0)                  # [PK]
    occ_g = jax.ops.segment_sum(occ_pk, g_flat,
                                num_segments=prec.shape[0])
    beta = jnp.sum(cls_one_hot * occ_g[:, None], axis=0)
    return {"beta": beta, "k": k, "G": G, "ll": total}


def cmllr_stats_aligned(scorer, features, frame_pdfs, gauss_class,
                        num_classes: int, means, covars):
    """CMLLR statistics under a FIXED per-frame state segmentation
    (the reference mllr tool's PhnReader path, `aku/mllr.cc:126-145`:
    per-frame probability 1 on the aligned pdf, Gaussian-level
    responsibilities within its mixture —
    MllrTrainer::collect_data)."""
    T, D = features.shape
    gll = scorer.gaussian_log_likelihoods(features)
    cidx = scorer.comp_idx[frame_pdfs]                # [T, K]
    clogw = scorer.comp_logw[frame_pdfs]
    gl = jnp.take_along_axis(gll, cidx, axis=1)
    # the reference's within-mixture responsibilities use RAW Gaussian
    # likelihoods, NOT weighted by the mixture coefficients
    # (MllrTrainer::collect_data: probs[g] = compute_likelihood;
    # probs[g] = prior*probs[g]/probsum) — padding components carry
    # clogw = -inf, so mask on that rather than folding it in
    gl = jnp.where(clogw > -1e30, gl, -jnp.inf)
    sll = logsumexp(gl, axis=-1)
    R = jnp.exp(jnp.maximum(gl - sll[:, None], -80.0))   # [T, K]

    prec = jnp.where(covars > 0, 1.0 / covars, 0.0)
    C = num_classes
    cls_one_hot = jax.nn.one_hot(gauss_class, C, dtype=jnp.float32)
    M = (cls_one_hot[:, :, None] * prec[:, None, :]).reshape(-1, C * D)
    M2 = (cls_one_hot[:, :, None] * (means * prec)[:, None, :]
          ).reshape(-1, C * D)

    Wt = jnp.einsum("tk,tkm->tm", R, M[cidx], precision=_F32)
    Vt = jnp.einsum("tk,tkm->tm", R, M2[cidx], precision=_F32)
    xi = jnp.concatenate(
        [jnp.ones((T, 1), features.dtype), features], axis=1)
    k = jnp.einsum("tm,tj->mj", Vt, xi,
                   precision=_F32).reshape(C, D, D + 1)
    G = jnp.einsum("tm,ti,tj->mij", Wt, xi, xi,
                   precision=_F32).reshape(C, D, D + 1, D + 1)
    occ_g = jax.ops.segment_sum(R.reshape(-1), cidx.reshape(-1),
                                num_segments=prec.shape[0])
    beta = jnp.sum(cls_one_hot * occ_g[:, None], axis=0)
    return {"beta": beta, "k": k, "G": G,
            "ll": jnp.sum(jnp.maximum(sll, jnp.log(1e-50)))}


def solve_cmllr(G: np.ndarray, k: np.ndarray, beta: float,
                rounds_per_dim: int = 20) -> np.ndarray:
    """Row-iteration CMLLR solve -> W [D, D+1] with column 0 = bias.

    Exact port of the reference algorithm (MllrTrainer.cc:166-253):
    alpha from ``c2 a^2 + c1 a - beta = 0`` picking the higher-objective
    root, W_row = G_i^{-1} (alpha * p + k_i).
    """
    D = k.shape[0]
    W = np.zeros((D, D + 1))
    W[:, 1:] = np.eye(D)
    inv_G = np.stack([np.linalg.inv(G[i]) for i in range(D)])

    for rnd in range(rounds_per_dim * D):
        row = rnd % D
        A = W[:, 1:]
        detA = np.linalg.det(A)
        cof = np.linalg.inv(A).T * detA       # cofactor matrix
        p = np.zeros(D + 1)
        p[1:] = cof[row]
        c2 = p @ inv_G[row] @ p
        c1 = p @ inv_G[row] @ k[row]
        disc = np.sqrt(c1 * c1 + 4 * c2 * beta)
        a1 = (-c1 + disc) / (2 * c2)
        a2 = (-c1 - disc) / (2 * c2)
        m1 = beta * np.log(np.abs(a1 * c2 + c1)) - (c2 / 2) * a1 * a1
        m2 = beta * np.log(np.abs(a2 * c2 + c1)) - (c2 / 2) * a2 * a2
        alpha = a1 if m1 > m2 else a2
        W[row] = inv_G[row] @ (alpha * p + k[row])
    return W


class CmllrEstimator:
    """Accumulate CMLLR statistics over utterances, solve per class."""

    def __init__(self, scorer, table, gauss_class: np.ndarray,
                 num_classes: int, means, covars):
        self.scorer = scorer
        self.table = table
        self.gauss_class = jnp.asarray(gauss_class)
        self.num_classes = num_classes
        Gp = scorer.score_matrix.shape[1]
        D = means.shape[1]
        mp = np.zeros((Gp, D), np.float32)
        cp = np.ones((Gp, D), np.float32)
        mp[:means.shape[0]] = means
        cp[:covars.shape[0]] = covars
        self.means = jnp.asarray(mp)
        self.covars = jnp.asarray(cp)
        self._acc = None
        self._jit = jax.jit(
            lambda f, g, n: cmllr_stats(
                self.scorer, f, g, n, self.gauss_class,
                self.num_classes, self.means, self.covars))
        self._jit_aligned = jax.jit(
            lambda f, s: cmllr_stats_aligned(
                self.scorer, f, s, self.gauss_class,
                self.num_classes, self.means, self.covars))

    def _merge(self, out) -> None:
        out = {kk: np.asarray(v, dtype=np.float64)
               for kk, v in out.items()}
        if self._acc is None:
            self._acc = out
        else:
            for kk in ("beta", "k", "G"):
                self._acc[kk] += out[kk]

    def accumulate(self, features, graph, n_frames) -> None:
        self._merge(self._jit(jnp.asarray(features), graph,
                              jnp.int32(n_frames)))

    def accumulate_aligned(self, features, frame_pdfs) -> None:
        """Fixed-segmentation accumulation (mllr.cc PhnReader path)."""
        T = min(features.shape[0], len(frame_pdfs))
        self._merge(self._jit_aligned(
            jnp.asarray(features[:T]),
            jnp.asarray(np.asarray(frame_pdfs[:T], np.int32))))

    def transforms(self, min_frames: float = 1000.0):
        """Per-class W [D, D+1] (identity where beta < min_frames;
        MllrTrainer.cc:63-96 min_frames gate)."""
        D = self.means.shape[1]
        out = []
        for c in range(self.num_classes):
            if self._acc is None or self._acc["beta"][c] < min_frames:
                W = np.zeros((D, D + 1))
                W[:, 1:] = np.eye(D)
            else:
                W = solve_cmllr(self._acc["G"][c], self._acc["k"][c],
                                float(self._acc["beta"][c]))
            out.append(W)
        return out


# ---------------------------------------------------------------------------
# model-space CMLLR (ModelModules ConstrainedMllr)
# ---------------------------------------------------------------------------

def apply_model_cmllr(model, transforms: list, gauss_class) -> "HmmModel":
    """Fold per-class CMLLR transforms into the Gaussian pool
    (`aku/ModelModules.hh:72-210` ConstrainedMllr: Gaussians evaluate
    their class's transformed feature A_c x + b_c with a +log|det A_c|
    constant).

    The device form needs no per-frame branching: evaluating a diagonal
    Gaussian on A x + b is exactly a full-covariance Gaussian in x —
    precision A' diag(p) A, mean A^-1 (mu - b) — and our scorer's
    constant 0.5*log det(precision) reproduces log|det A| +
    0.5*sum log p automatically.  So the adaptation is a pure model
    rewrite feeding the existing exponential-form matmul.

    transforms: per class, [D, D+1] rows [b | A] (the CMLLR W).
    gauss_class: [G] class index per Gaussian.
    """
    from aaltoasr_tpu.formats.model_io import HmmModel

    G, D = model.means.shape
    prec = model.precisions()
    means = np.zeros_like(model.means)
    full = {}
    kind = []
    Ainvs = []
    for W in transforms:
        W = np.asarray(W, dtype=np.float64)
        Ainvs.append((np.linalg.inv(W[:, 1:]), W[:, 0]))
    for g in range(G):
        Ainv, b = Ainvs[int(gauss_class[g])]
        means[g] = Ainv @ (model.means[g] - b)
        if g in model.full_covars:
            cov = np.asarray(model.full_covars[g], dtype=np.float64)
        else:
            with np.errstate(divide="ignore"):
                cov = np.diag(np.where(prec[g] > 0, 1.0 / prec[g], 0.0))
        full[g] = Ainv @ cov @ Ainv.T
        kind.append("full")
    return HmmModel(
        dim=D, cov_type="variable", means=means, covars=model.covars,
        mixtures=model.mixtures, phones=model.phones,
        transitions=model.transitions, durations=model.durations,
        full_covars=full, gauss_kind=kind)
