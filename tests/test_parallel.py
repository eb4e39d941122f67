"""SPMD training-step tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aaltoasr_tpu.models.hmm import TransitionTable, build_chain, pad_chain
from aaltoasr_tpu.ops.gmm import GmmScorer
from aaltoasr_tpu.parallel.mesh import make_mesh, sharded_train_step
from aaltoasr_tpu.train import estep

from tests.test_train import three_state_model


def make_batch(model, table, B=8, T=24, seed=0):
    rng = np.random.default_rng(seed)
    chain = build_chain(model, table, ["a", "_"])
    g = pad_chain(chain, 8, fan=4)
    graphs = {k: np.stack([np.asarray(v)] * B) for k, v in g.items()}
    feats = rng.normal(0, 2, (B, T, model.dim)).astype(np.float32)
    n_frames = np.full((B,), T, dtype=np.int32)
    return feats, graphs, n_frames


def pool_params(model, n_model=1):
    scorer = GmmScorer.from_model(model, pad_gaussians_to=8)
    G = scorer.score_matrix.shape[1]
    means = np.zeros((G, model.dim), dtype=np.float32)
    covars = np.ones((G, model.dim), dtype=np.float32)
    means[:model.num_gaussians] = model.means
    covars[:model.num_gaussians] = model.covars
    return {
        "means": means, "covars": covars,
        "comp_idx": np.asarray(scorer.comp_idx),
        "comp_logw": np.asarray(scorer.comp_logw),
    }, scorer


class TestShardedTrainStep:
    def test_8dev_matches_single_device(self):
        assert len(jax.devices()) >= 8
        model = three_state_model()
        table = TransitionTable.from_model(model)
        feats, graphs, n_frames = make_batch(model, table, B=8, T=24)
        params, scorer = pool_params(model)

        mesh = make_mesh(n_data=4, n_model=2)
        step = sharded_train_step(mesh, table.num_slots, minvar=0.01)
        new_params, ll = step(params, feats, graphs, n_frames)

        # single-device reference: sum chain_stats over the batch + ML update
        total_ll = 0.0
        agg = None
        for b in range(8):
            g = {k: jnp.asarray(v[b]) for k, v in graphs.items()}
            st = estep.chain_stats(scorer, jnp.asarray(feats[b]), g,
                                   jnp.int32(24), table.num_slots)
            total_ll += float(st["log_likelihood"])
            if agg is None:
                agg = {k: np.asarray(v, dtype=np.float64)
                       for k, v in st.items()}
            else:
                for k in agg:
                    agg[k] = agg[k] + np.asarray(st[k], dtype=np.float64)

        assert float(ll) == pytest.approx(total_ll, rel=1e-4)
        gamma = agg["gamma"]
        has = gamma > 0
        want_mean = np.where(has[:, None],
                             agg["mean_acc"] / np.where(has, gamma, 1)[:, None],
                             params["means"])
        np.testing.assert_allclose(np.asarray(new_params["means"]),
                                   want_mean, rtol=2e-3, atol=2e-3)

    def test_data_axis_psum_invariance(self):
        # different data-axis layouts must give identical results
        model = three_state_model()
        table = TransitionTable.from_model(model)
        feats, graphs, n_frames = make_batch(model, table, B=8, T=16, seed=2)
        params, _ = pool_params(model)

        outs = []
        for (nd, nm) in [(8, 1), (4, 2), (2, 4)]:
            mesh = make_mesh(n_data=nd, n_model=nm)
            step = sharded_train_step(mesh, table.num_slots)
            new_params, ll = step(params, feats, graphs, n_frames)
            outs.append((np.asarray(new_params["means"]), float(ll)))
        for m, ll in outs[1:]:
            np.testing.assert_allclose(m, outs[0][0], rtol=1e-4, atol=1e-4)
            assert ll == pytest.approx(outs[0][1], rel=1e-5)

    def test_em_improves_on_mesh(self):
        model = three_state_model(seed=7)
        table = TransitionTable.from_model(model)
        feats, graphs, n_frames = make_batch(model, table, B=8, T=32, seed=3)
        params, _ = pool_params(model)
        mesh = make_mesh(n_data=4, n_model=2)
        step = sharded_train_step(mesh, table.num_slots, minvar=0.01)
        lls = []
        for _ in range(3):
            params, ll = step(params, feats, graphs, n_frames)
            lls.append(float(ll))
        assert lls[1] > lls[0]
        assert lls[2] >= lls[1] - 1e-3


class TestDistributed:
    def test_initialize_wiring(self, monkeypatch):
        """initialize() resolves env topology and calls
        jax.distributed.initialize with it (process-count faked)."""
        from aaltoasr_tpu.parallel import distributed
        calls = {}

        def fake_init(coordinator_address=None, num_processes=None,
                      process_id=None):
            calls.update(addr=coordinator_address, n=num_processes,
                         pid=process_id)

        monkeypatch.setattr(jax.distributed, "initialize", fake_init)
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "h0:1234")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
        monkeypatch.setenv("SLURM_PROCID", "3")
        monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
        assert distributed.initialize() is True
        assert calls == {"addr": "h0:1234", "n": 4, "pid": 3}

    def test_initialize_single_process_noop(self, monkeypatch):
        from aaltoasr_tpu.parallel import distributed
        for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                    "JAX_PROCESS_ID", "SLURM_PROCID"):
            monkeypatch.delenv(var, raising=False)
        called = []
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda *a, **k: called.append(1))
        assert distributed.initialize() is False
        assert not called

    def test_global_mesh_spans_devices(self):
        from aaltoasr_tpu.parallel import distributed
        mesh = distributed.global_mesh(n_model=2)
        assert mesh.shape["model"] == 2
        assert mesh.shape["data"] * 2 == len(jax.devices())

    def test_process_shard_matches_recipe_split(self, monkeypatch):
        from aaltoasr_tpu.parallel import distributed
        from aaltoasr_tpu.formats.recipe import Recipe
        lines = [f"audio=/a/u{i}.wav" for i in range(10)]
        full = Recipe.read(lines)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda: 1)
        shard = distributed.process_shard(full)
        ref = Recipe.read(lines, 2, 2)      # 1-based batch index
        assert [r.audio_path for r in shard] == \
            [r.audio_path for r in ref]


class TestShardedDecode:
    def test_dense_decode_sharded_over_batch(self):
        """Multi-chip batched serving: obs sharded along the utterance
        axis across 8 devices; the decode program is embarrassingly
        parallel (tables replicated, no collectives) and results must
        equal the unsharded decode."""
        from jax.sharding import Mesh, NamedSharding, PartitionSpec
        from tests.test_decoder import make_decode_task, synth_obs
        from aaltoasr_tpu.decoder.search import SearchConfig
        from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch

        model, tree, fsa = make_decode_task()
        cfg = SearchConfig(num_tokens=256, num_records=16,
                           beam=1e9, lm_scale=1.0)
        dense = DenseBeamSearch(tree, fsa, model, cfg)
        seqs = [["a", "b", "b", "a"], ["c", "a", "_"],
                ["b", "a", "c", "a"], ["a", "b", "_"]] * 2
        obs_list = [synth_obs(tree, model, s, seed=i)
                    for i, s in enumerate(seqs)]
        T = max(o.shape[0] for o in obs_list)
        B = len(obs_list)
        pad = np.full((B, T, obs_list[0].shape[1]), -100.0, np.float32)
        n = np.zeros(B, np.int32)
        for i, o in enumerate(obs_list):
            pad[i, :o.shape[0]] = o
            n[i] = o.shape[0]

        base = dense.decode_batch(pad, n, lattice=False)

        mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
        sh = NamedSharding(mesh, PartitionSpec("data"))
        pad_s = jax.device_put(jnp.asarray(pad), sh)
        n_s = jax.device_put(jnp.asarray(n), sh)
        sharded = dense.decode_batch(pad_s, n_s, lattice=False)
        for a, b in zip(base, sharded):
            assert b.words == a.words
            assert b.log_prob == pytest.approx(a.log_prob, rel=1e-5)
