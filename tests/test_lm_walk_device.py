"""Device LM walk against the host walk on a 1k-word trigram.

The hash table carries int32 columns bit-cast into float32; small ids
are denormal bit patterns, which must pass through the device's gathers
and selects unchanged (a flush-to-zero would turn next-state ids to 0).
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aaltoasr_tpu.decoder.ngram import lm_walk_device
from aaltoasr_tpu.ops.logsemiring import LOG_ZERO

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))


def check_walk(n_pairs):
    from bench_decode import synth_task
    _, _, fsa = synth_task(num_words=1000, order=3, triphone=False)
    tables = fsa.device_tables()
    h = np.asarray(tables["hash_packed"]).view(np.int32)
    # the table does hold denormal bit patterns (small positive ids)
    assert ((h > 0) & (h < 2 ** 23)).any()
    rng = np.random.default_rng(0)
    states = rng.integers(0, fsa.num_states, n_pairs).astype(np.int32)
    words = rng.integers(0, fsa.num_words, n_pairs).astype(np.int32)
    nxt, sc = jax.jit(lambda s, w: lm_walk_device(
        tables, fsa.num_words, fsa.order, s, w))(
            jnp.asarray(states), jnp.asarray(words))
    nxt, sc = np.asarray(nxt), np.asarray(sc)
    for i in range(n_pairs):
        hn, hs = fsa.walk(int(states[i]), int(words[i]))
        assert int(nxt[i]) == hn
        if hs <= LOG_ZERO / 2:
            assert sc[i] <= LOG_ZERO / 2
        else:
            assert sc[i] == pytest.approx(hs, abs=1e-4)


def test_walk_matches_host():
    check_walk(512)


@pytest.mark.gpu
def test_walk_matches_host_on_card(gpu):
    check_walk(4096)
