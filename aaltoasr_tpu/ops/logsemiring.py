"""Log-semiring primitives shared by forward-backward, Viterbi and decoding.

The reference's scalar helpers (`aku/util.hh:111-139` logadd/safe_log,
`aku/HmmNetBaumWelch.hh:99-105` log-semiring ops) become vectorized masked
reductions.  ``LOG_ZERO`` plays the role of the reference's -inf sentinel
but stays finite so that float32 arithmetic never produces NaNs from
(-inf) - (-inf).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Finite stand-in for log(0); reference uses -1e15 semantics via "loglikelihoods
# smaller than this are pruned".  Small enough that exp() == 0 in f32 and two
# additions stay far from any real score, large enough to avoid f32 overflow.
LOG_ZERO = -1.0e30

# safe_log floor: log(1e-50) (`aku/util.hh:131-139`)
SAFE_LOG_FLOOR = float(np.log(1e-50))


def safe_log(x):
    """Elementwise log with the reference's 1e-50 floor (util.hh:133)."""
    return jnp.log(jnp.maximum(x, 1e-50))


def logaddexp(a, b):
    """Numerically stable pairwise log-add that tolerates LOG_ZERO inputs."""
    mx = jnp.maximum(a, b)
    mn = jnp.minimum(a, b)
    out = mx + jnp.log1p(jnp.exp(jnp.maximum(mn - mx, -80.0)))
    # both LOG_ZERO -> LOG_ZERO (avoid LOG_ZERO + log(2))
    return jnp.where(mx <= LOG_ZERO / 2, LOG_ZERO, out)


def logsumexp(x, axis=-1, keepdims=False, where=None):
    """Masked logsumexp that returns LOG_ZERO for fully-masked slices."""
    if where is not None:
        x = jnp.where(where, x, LOG_ZERO)
    mx = jnp.max(x, axis=axis, keepdims=True)
    safe_mx = jnp.maximum(mx, LOG_ZERO / 2)
    s = jnp.sum(jnp.exp(x - safe_mx), axis=axis, keepdims=True)
    out = jnp.where(mx <= LOG_ZERO / 2,
                    LOG_ZERO,
                    safe_mx + jnp.log(s))
    if not keepdims:
        out = jnp.squeeze(out, axis=axis)
    return out


def segment_logsumexp(x, segment_ids, num_segments: int):
    """Log-sum-exp of ``x`` grouped by ``segment_ids`` -> [num_segments].

    The log-domain analog of scatter-add, used to reduce arc scores onto
    lattice nodes.  Two-pass max-shift for stability.
    """
    import jax
    seg_max = jax.ops.segment_max(x, segment_ids, num_segments=num_segments)
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, LOG_ZERO)
    safe = jnp.maximum(seg_max, LOG_ZERO / 2)
    shifted = jnp.exp(x - safe[segment_ids])
    sums = jax.ops.segment_sum(shifted, segment_ids, num_segments=num_segments)
    return jnp.where(seg_max <= LOG_ZERO / 2,
                     LOG_ZERO, safe + jnp.log(jnp.maximum(sums, 1e-37)))
