"""Diagonal-GMM state likelihoods as batched matmuls — the scoring hot path.

The reference evaluates each Gaussian with a per-dimension scalar loop
(`aku/Distributions.cc:1034-1060`) and each mixture with a linear-domain
weighted sum in double precision (`aku/Distributions.cc:2079-2086`), frame
by frame behind a likelihood cache (`aku/Distributions.cc:2637-2710`,
`aku/HmmSet.cc:485`).  Here the whole frame x Gaussian grid is one
matmul:

    log N_g(x) = -0.5 * sum_d (x_d - mu_gd)^2 * p_gd + C_g
               = [x^2, x] @ [-0.5*p_g ; mu_g*p_g] + (C_g - 0.5*sum mu^2 p)

with ``C_g = log sqrt(prod p_g)`` — the reference's unnormalized constant
(no 2*pi term, `aku/Distributions.cc:1273-1287`).  Features and means are
first shifted by the pool's mean ``c`` (an exact identity for
``(x - mu)``): the expanded terms then stay the size of the spread, not
of the features' offsets, which keeps their cancellation error in
float32 well under the LNA quantization step.  Mixture scores follow as
a gather + masked logsumexp over padded component tables, and the LNA
normalization (`aku/PhoneProbsToolbox.cc:93-105`: divide by the linear sum
of state likelihoods, then safe_log) becomes ``clip(ll - logsumexp(ll),
log(1e-50))`` which is algebraically identical but float-stable.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from aaltoasr_tpu.formats.model_io import HmmModel
from aaltoasr_tpu.ops.logsemiring import LOG_ZERO, SAFE_LOG_FLOOR, logsumexp

_F32 = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class GmmScorer:
    """Device-resident scoring tables for one acoustic model.

    score_matrix  [2D, G]  stacked [-0.5*p ; mu*p], mu less ``center``
    score_bias    [G]      C_g - 0.5*sum_d mu^2 p, mu less ``center``
    comp_idx      [S, K]   mixture component Gaussian indices (padded)
    comp_logw     [S, K]   log mixture weights (LOG_ZERO padding)
    """

    dim: int
    num_states: int
    num_gaussians: int
    score_matrix: jax.Array
    score_bias: jax.Array
    comp_idx: jax.Array
    comp_logw: jax.Array
    full_cov: bool = False
    # [D] pool mean the diagonal expansion is centred on (None: no shift)
    center: jax.Array | None = None
    # factored subspace scoring (PCGMM/SCGMM, ops/subspaces.py): per
    # shared subspace one ([D_phi, B] basis, [B, Gp] coefficients) pair;
    # scores += (phi(x) @ basis) @ coeffs — two matmuls instead of
    # materialized per-Gaussian precisions
    sub_basis: tuple = ()
    sub_lambda: tuple = ()
    # cluster gating (PDFPool::compute_likelihoods clustering branch,
    # Distributions.cc:2684-2722): None = dense evaluation
    cluster_of: jax.Array | None = None       # [Gp] cluster per Gaussian
    cluster_matrix: jax.Array | None = None   # [2D, C] center tables
    cluster_bias: jax.Array | None = None     # [C]
    cluster_sizes: jax.Array | None = None    # [C]
    min_eval_clusters: int = 0
    min_eval_gauss: int = 0

    @classmethod
    def from_model(cls, model: HmmModel, pad_gaussians_to: int = 128,
                   pad_states_to: int = 8) -> "GmmScorer":
        means = model.means
        G, D = means.shape
        Gp = _round_up(G, pad_gaussians_to)
        has_sub = bool(model.pcgmm_params or model.scgmm_params)
        full_cov = (model.cov_type == "full_cov"
                    or "full" in model.gauss_kind or has_sub)

        if full_cov:
            # exponential form over phi(x) = [vec(x x^T), x]:
            # logN = C - mu'P mu/2 + (P mu).x - vec(P).vec(xx')/2
            # (FullCovarianceGaussian::compute_log_likelihood,
            # Distributions.cc:1413-1426; diagonal Gaussians embed as
            # diagonal precision matrices so `variable` models score in
            # the same matmul).
            diag_prec = model.precisions()
            A = np.zeros((D * D + D, Gp), dtype=np.float32)
            bias = np.full(Gp, LOG_ZERO, dtype=np.float32)
            for g in range(G):
                if g in model.pcgmm_params:
                    ssid, tm, lam = model.pcgmm_params[g]
                    ps = model.precision_subspaces[ssid]
                    A[D * D:, g] = tm
                    bias[g] = ps.constant(tm, lam)
                    continue
                if g in model.scgmm_params:
                    ssid, lam = model.scgmm_params[g]
                    es = model.exponential_subspaces[ssid]
                    bias[g] = es.constant(lam)
                    continue
                if g in model.full_covars:
                    cov = np.asarray(model.full_covars[g], np.float64)
                    P, C = _spd_precision(cov)
                else:
                    P = np.diag(diag_prec[g])
                    pr = np.prod(diag_prec[g])
                    C = 0.5 * np.log(max(pr, 1e-300)) if pr > 0 else 0.0
                mu = means[g]
                A[:D * D, g] = (-0.5 * P).reshape(-1)
                A[D * D:, g] = P @ mu
                bias[g] = C - 0.5 * mu @ P @ mu
        else:
            prec = model.precisions()
            const = model.gauss_constants()
            center = (means.mean(axis=0) if G else np.zeros(D)).astype(
                np.float32)
            mu = means - center.astype(np.float64)
            A = np.zeros((2 * D, Gp), dtype=np.float32)
            A[:D, :G] = (-0.5 * prec).T
            A[D:, :G] = (mu * prec).T
            bias = np.full(Gp, LOG_ZERO, dtype=np.float32)
            bias[:G] = const - 0.5 * np.sum(mu * mu * prec, axis=1)

        S = len(model.mixtures)
        K = max((len(ix) for ix, _ in model.mixtures), default=1)
        Sp = _round_up(S, pad_states_to)
        comp_idx = np.zeros((Sp, K), dtype=np.int32)
        comp_logw = np.full((Sp, K), LOG_ZERO, dtype=np.float32)
        for s, (idx, w) in enumerate(model.mixtures):
            comp_idx[s, :len(idx)] = idx
            with np.errstate(divide="ignore"):
                comp_logw[s, :len(w)] = np.where(
                    w > 0, np.log(np.maximum(w, 1e-300)), LOG_ZERO)
        sub_basis, sub_lambda = [], []
        if has_sub:
            from aaltoasr_tpu.ops.subspaces import (
                pcgmm_tables, scgmm_tables)
            for ssid, ps in sorted(model.precision_subspaces.items()):
                params = {g: (tm, lam) for g, (sid, tm, lam)
                          in model.pcgmm_params.items() if sid == ssid}
                t = pcgmm_tables(ps, params, D, Gp)
                sub_basis.append(jnp.asarray(t["sub_basis"]))
                sub_lambda.append(jnp.asarray(t["sub_lambda"]))
            for ssid, es in sorted(model.exponential_subspaces.items()):
                params = {g: lam for g, (sid, lam)
                          in model.scgmm_params.items() if sid == ssid}
                t = scgmm_tables(es, params, D, Gp)
                sub_basis.append(jnp.asarray(t["sub_basis"]))
                sub_lambda.append(jnp.asarray(t["sub_lambda"]))
        return cls(
            dim=D, num_states=S, num_gaussians=G,
            score_matrix=jnp.asarray(A), score_bias=jnp.asarray(bias),
            comp_idx=jnp.asarray(comp_idx), comp_logw=jnp.asarray(comp_logw),
            full_cov=full_cov,
            center=None if full_cov else jnp.asarray(center),
            sub_basis=tuple(sub_basis), sub_lambda=tuple(sub_lambda),
        )

    # -- scoring ----------------------------------------------------------
    def _centered(self, features: jax.Array) -> jax.Array:
        x = features.astype(jnp.float32)
        return x if self.center is None else x - self.center

    def gaussian_log_likelihoods(self, features: jax.Array) -> jax.Array:
        """[T, D] features -> [T, Gp] per-Gaussian log-likelihoods."""
        x = self._centered(features)
        if self.full_cov:
            T = x.shape[0]
            outer = (x[:, :, None] * x[:, None, :]).reshape(T, -1)
            xx = jnp.concatenate([outer, x], axis=-1)
        else:
            xx = jnp.concatenate([x * x, x], axis=-1)
        out = jnp.dot(xx, self.score_matrix, precision=_F32) + self.score_bias
        for sb, sl in zip(self.sub_basis, self.sub_lambda):
            # phi(x) through the shared subspace basis, then coefficients
            out = out + jnp.dot(jnp.dot(xx, sb, precision=_F32), sl,
                                precision=_F32)
        return out

    def with_clustering(self, model: HmmModel, assign: np.ndarray,
                        num_clusters: int, eval_minc: float = 0.0,
                        eval_ming: float = 0.1) -> "GmmScorer":
        """Attach Gaussian clustering for gated evaluation
        (HmmSet::set_clustering_min_evals, HmmSet.cc:1354-1366).

        Cluster centers merge their members with equal weights
        (PDFPool::read_clustering); non-selected Gaussians score their
        center's likelihood.  On the device the dense matmul is already
        cheap — the gate reproduces the reference's approximation
        OUTPUT (for parity), rather than saving compute."""
        import dataclasses
        G, D = model.means.shape
        C = num_clusters
        mu = np.zeros((C, D))
        var = np.ones((C, D))
        sizes = np.zeros(C, dtype=np.int32)
        for c in range(C):
            m = assign == c
            sizes[c] = int(m.sum())
            if sizes[c]:
                mu[c] = model.means[m].mean(axis=0)
                var[c] = ((model.covars[m]
                           + model.means[m] ** 2).mean(axis=0)
                          - mu[c] ** 2)
        with np.errstate(divide="ignore"):
            prec = np.where(var > 0, 1.0 / var, 0.0)
        if self.center is not None:
            mu = mu - np.asarray(self.center, np.float64)
        A = np.zeros((2 * D, C), dtype=np.float32)
        A[:D] = (-0.5 * prec).T
        A[D:] = (mu * prec).T
        prod = np.prod(prec, axis=1)
        const = np.where(prod > 0,
                         0.5 * np.log(np.maximum(prod, 1e-300)), 0.0)
        bias = (const - 0.5 * np.sum(mu * mu * prec, axis=1)
                ).astype(np.float32)
        Gp = int(self.score_matrix.shape[1])
        cl = np.zeros(Gp, dtype=np.int32)
        cl[:G] = assign
        return dataclasses.replace(
            self,
            cluster_of=jnp.asarray(cl),
            cluster_matrix=jnp.asarray(A),
            cluster_bias=jnp.asarray(bias),
            cluster_sizes=jnp.asarray(sizes),
            min_eval_clusters=max(int(eval_minc * C), 1),
            min_eval_gauss=max(int(eval_ming * G), 1))

    def gated_gaussian_log_likelihoods(self, features: jax.Array):
        """Clustered evaluation: exact likelihoods inside the
        top-ranked clusters, the center likelihood elsewhere
        (Distributions.cc:2695-2722)."""
        x = self._centered(features)
        gll = self.gaussian_log_likelihoods(features)
        xx = jnp.concatenate([x * x, x], axis=-1)
        cll = (jnp.dot(xx, self.cluster_matrix, precision=_F32)
               + self.cluster_bias)                       # [T, C]
        C = cll.shape[1]
        order = jnp.argsort(-cll, axis=1)
        sizes = self.cluster_sizes[order]
        cum_before = jnp.cumsum(sizes, axis=1) - sizes
        sel_sorted = ((jnp.arange(C)[None, :] < self.min_eval_clusters)
                      | (cum_before < self.min_eval_gauss))
        T = cll.shape[0]
        sel = jnp.zeros(cll.shape, bool).at[
            jnp.arange(T)[:, None], order].set(sel_sorted)
        mask = sel[:, self.cluster_of]                    # [T, Gp]
        return jnp.where(mask, gll, cll[:, self.cluster_of])

    def state_log_likelihoods(self, features: jax.Array) -> jax.Array:
        """[T, D] -> [T, Sp] mixture (tied-state) log-likelihoods.

        Equivalent of HmmSet::precompute_likelihoods + state_likelihood
        (`aku/HmmSet.cc:485`, `aku/Distributions.cc:2079`) over all frames.
        """
        if self.cluster_of is not None:
            gll = self.gated_gaussian_log_likelihoods(features)
        else:
            gll = self.gaussian_log_likelihoods(features)   # [T, Gp]
        comp = gll[:, self.comp_idx]                        # [T, Sp, K]
        return logsumexp(comp + self.comp_logw, axis=-1)    # [T, Sp]

    def lna_log_probs(self, features: jax.Array) -> jax.Array:
        """[T, D] -> [T, S] normalized LNA log-probs.

        Matches PPToolbox::generate_to_fd normalization
        (`aku/PhoneProbsToolbox.cc:93-105`): divide linear likelihoods by
        their sum over states, floor at safe_log(1e-50).
        """
        ll = self.state_log_likelihoods(features)[:, :self.num_states]
        norm = logsumexp(ll, axis=-1, keepdims=True)
        return jnp.maximum(ll - norm, SAFE_LOG_FLOOR)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _spd_precision(cov: np.ndarray):
    """(precision, log sqrt det precision) for an SPD covariance;
    zeros when not SPD (FullCovarianceGaussian::set_covariance,
    Distributions.cc:1560-1580: invalid parameters score constant)."""
    try:
        eig = np.linalg.eigvalsh(cov)
        if eig.min() <= 0:
            raise np.linalg.LinAlgError
        P = np.linalg.inv(cov)
        C = 0.5 * float(np.linalg.slogdet(P)[1])
        return P, C
    except np.linalg.LinAlgError:
        D = cov.shape[0]
        return np.zeros((D, D)), 0.0


# ---------------------------------------------------------------------------
# on-device LNA quantization (the phone_probs emission path)
# ---------------------------------------------------------------------------

def quantize_lna_u16(log_probs: jax.Array) -> jax.Array:
    """[T, S] log-probs -> [T, S] uint16 LNA codes (2-byte encoding).

    ``v = int(-1820*lp + 0.5)`` truncating toward zero, 0xFFFF below
    -36.008 (`aku/PhoneProbsToolbox.cc:106-124`).  Host writes big-endian.
    """
    v = (-1820.0 * log_probs + 0.5).astype(jnp.int32)
    v = jnp.where(log_probs < -36.008, 0xFFFF, jnp.clip(v, 0, 0xFFFF))
    return v.astype(jnp.uint16)
