"""GmmScorer state likelihoods and LNA normalization against a float64
NumPy oracle, including padded mixtures (fewer than K components) and
padded states; on the CPU at small widths and on the card at the
scoring width (10k Gaussians, 2.5k states, K=8, D=39)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aaltoasr_tpu.formats import model_io
from aaltoasr_tpu.ops.gmm import GmmScorer
from aaltoasr_tpu.ops.logsemiring import LOG_ZERO, SAFE_LOG_FLOOR


def random_model(G, S, D, K, seed, full_mixtures=False):
    rng = np.random.default_rng(seed)
    mixtures = []
    for _ in range(S):
        k = K if full_mixtures else int(rng.integers(1, K + 1))
        idx = rng.choice(G, size=k, replace=False).astype(np.int32)
        mixtures.append((idx, rng.dirichlet(np.ones(k))))
    return model_io.HmmModel(
        dim=D, cov_type="diagonal_cov", means=rng.normal(0, 2, (G, D)),
        covars=rng.uniform(0.3, 3.0, (G, D)), mixtures=mixtures,
        phones=[], transitions={})


def oracle_state_ll(model, feats):
    """[T, D] -> [T, S] in float64: Gaussian log-densities with the
    reference's unnormalized constant (`aku/Distributions.cc:1273-1287`)
    and a linear-domain mixture sum (`aku/Distributions.cc:2079`)."""
    x = np.asarray(feats, np.float64)
    prec = 1.0 / model.covars
    gll = (x * x) @ (-0.5 * prec).T + x @ (model.means * prec).T
    gll += 0.5 * np.log(prec).sum(1) - 0.5 * (
        model.means ** 2 * prec).sum(1)
    out = np.empty((x.shape[0], len(model.mixtures)))
    for s, (idx, w) in enumerate(model.mixtures):
        comp = gll[:, idx] + np.log(w)
        m = comp.max(1, keepdims=True)
        out[:, s] = (m + np.log(np.exp(comp - m).sum(1, keepdims=True)))[:, 0]
    return out


def oracle_lna(ll):
    m = ll.max(1, keepdims=True)
    norm = m + np.log(np.exp(ll - m).sum(1, keepdims=True))
    return np.maximum(ll - norm, SAFE_LOG_FLOOR)


def score(model, feats, what):
    sc = GmmScorer.from_model(model)
    f = jnp.asarray(feats, jnp.float32)
    if what == "state":
        return np.asarray(jax.jit(sc.state_log_likelihoods)(f))
    return np.asarray(jax.jit(sc.lna_log_probs)(f))


@pytest.mark.parametrize("what", ["state", "lna"])
@pytest.mark.parametrize("K", [1, 3, 8])
def test_matches_float64_oracle(K, what):
    model = random_model(G=60, S=13, D=7, K=K, seed=K)
    feats = np.random.default_rng(10 + K).normal(0, 2, (37, 7))
    want = oracle_state_ll(model, feats)
    got = score(model, feats, what)
    if what == "state":
        # S=13 pads to 16 states: the padding scores LOG_ZERO
        assert got.shape == (37, 16)
        assert (got[:, 13:] <= LOG_ZERO / 2).all()
        np.testing.assert_allclose(got[:, :13], want, rtol=0, atol=2e-4)
    else:
        assert got.shape == (37, 13)
        np.testing.assert_allclose(got, oracle_lna(want), rtol=0,
                                   atol=2e-4)


@pytest.mark.gpu
def test_scoring_width_on_card(gpu):
    """At HIGHEST precision the card's fp32 scores stay within 2e-3 of
    float64 on values of -100 to -300 (a TF32 matmul misses by ~1), and
    the LNA log-probs within half a quantization step (1/1820)."""
    model = random_model(G=10000, S=2500, D=39, K=8, seed=0,
                         full_mixtures=True)
    feats = np.random.default_rng(1).normal(0, 2, (1024, 39))
    want = oracle_state_ll(model, feats)
    got = score(model, feats, "state")[:, :2500]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    lna = score(model, feats, "lna")
    np.testing.assert_allclose(lna, oracle_lna(want), rtol=0,
                               atol=0.5 / 1820)
