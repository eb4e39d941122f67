"""SPMD data/model parallelism over a `jax.sharding.Mesh`.

The reference's only parallelism is utterance sharding over a batch
cluster with file-based reduce (`aku/Recipe.hh:97-112` shard split,
`combine_stats` + scheduler epilogs, `train.pl:373-392`).  The replacement
here is one SPMD program over a device mesh:

* **data axis**: utterances of a padded batch are sharded; sufficient
  statistics are `psum`-reduced across it — the on-interconnect analog of the
  .gks/.mcs dump + combine_stats files.
* **model axis**: the Gaussian pool is sharded along G for the scoring
  matmul; per-Gaussian log-likelihoods are `all_gather`ed (mixtures mix
  arbitrary pool members), while Gaussian statistics and the M-step stay
  shard-local, with a final `all_gather` of updated parameters.

`sharded_train_step` is the complete EM training step (E-step FB + M-step
ML update) as one jitted SPMD program — multi-host ready via
`jax.distributed.initialize` (the mesh just spans more devices).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from aaltoasr_tpu.ops.logsemiring import LOG_ZERO, logsumexp
from aaltoasr_tpu.train import estep

_F32 = jax.lax.Precision.HIGHEST


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """A ("data", "model") mesh over the visible devices."""
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // n_model
    devs = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(devs, axis_names=("data", "model"))


def replicate(tree, mesh: Mesh):
    """Put a pytree on the mesh fully replicated."""
    sharding = jax.sharding.NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def _scorer_tables(means, covars):
    """Recompute scoring tables from means/covars on device.

    Mirrors GmmScorer.from_model / DiagonalGaussian::set_constant
    (`aku/Distributions.cc:1273-1287`): C = log sqrt(prod(precision)).
    """
    prec = jnp.where(covars > 0, 1.0 / covars, 0.0)
    A = jnp.concatenate([-0.5 * prec, means * prec], axis=1)  # [G, 2D]
    logprec = jnp.log(jnp.maximum(prec, 1e-30))
    const = 0.5 * jnp.sum(logprec, axis=1)
    bias = const - 0.5 * jnp.sum(means * means * prec, axis=1)
    return A, bias


def _estep_local(params, features, graph, n_frames, num_trans_slots):
    """Per-device E-step on the local utterance shard with the local
    Gaussian-pool shard; returns the local stats pytree.

    Inside shard_map: axes 'data' (utterances) and 'model' (pool shard).
    """
    means, covars = params["means"], params["covars"]
    comp_idx, comp_logw = params["comp_idx"], params["comp_logw"]
    A_local, bias_local = _scorer_tables(means, covars)     # [Gl, 2D], [Gl]

    def one_utt(feats, g, n):
        x = feats.astype(jnp.float32)
        xx = jnp.concatenate([x * x, x], axis=-1)           # [T, 2D]
        gll_local = jnp.dot(xx, A_local.T, precision=_F32) + bias_local
        # pool is sharded over 'model': gather the full [T, G] row
        gll = jax.lax.all_gather(
            gll_local, "model", axis=1, tiled=True)          # [T, G]
        sll = logsumexp(gll[:, comp_idx] + comp_logw, axis=-1)
        obs_pos = sll[:, g["pdf"]]
        gamma, trans_post, total = estep.masked_forward_backward(
            obs_pos, g, n, num_trans_slots)

        pdf = g["pdf"]
        T = x.shape[0]
        Pn = pdf.shape[0]
        K = comp_idx.shape[1]
        cidx = comp_idx[pdf]
        clogw = comp_logw[pdf]
        log_resp = clogw[None] + gll[:, cidx] - obs_pos[:, :, None]
        R = gamma[:, :, None] * jnp.exp(jnp.maximum(log_resp, -80.0))
        R_flat = R.reshape(T, Pn * K)
        g_flat = cidx.reshape(-1)
        Gtot = gll.shape[1]
        c = jnp.sum(R_flat, axis=0)
        gamma_g = jax.ops.segment_sum(c, g_flat, num_segments=Gtot)
        m1 = jax.ops.segment_sum(
            jnp.dot(R_flat.T, x, precision=_F32), g_flat,
            num_segments=Gtot)
        m2 = jax.ops.segment_sum(
            jnp.dot(R_flat.T, x * x, precision=_F32), g_flat,
            num_segments=Gtot)
        mix_gamma = jax.ops.segment_sum(
            c.reshape(Pn, K), pdf, num_segments=comp_idx.shape[0])
        return {"gamma": gamma_g, "mean_acc": m1, "sec_acc": m2,
                "mix_gamma": mix_gamma, "trans_acc": trans_post,
                "ll": total}

    stats = jax.vmap(one_utt)(features, graph, n_frames)
    return {k: jnp.sum(v, axis=0) for k, v in stats.items()}


def sharded_train_step(mesh: Mesh, num_trans_slots: int,
                       minvar: float = 0.1):
    """Build the jitted SPMD EM step: (params, batch) -> (params', ll).

    params: means/covars [G, D] sharded over 'model' on G; comp_idx/
    comp_logw replicated.  batch: features [B, T, D], graph arrays [B, ...],
    n_frames [B] — all sharded over 'data' on B.
    """
    from jax import shard_map

    param_specs = {
        "means": P("model", None), "covars": P("model", None),
        "comp_idx": P(), "comp_logw": P(),
    }
    graph_spec = {
        "pdf": P("data", None),
        "in_src": P("data", None, None), "in_logp": P("data", None, None),
        "in_slot": P("data", None, None),
        "out_tgt": P("data", None, None), "out_logp": P("data", None, None),
        "num_positions": P("data"), "final_logp": P("data"),
        "final_slot": P("data"),
        "inst": P("data", None),
        "mpv_gid": P("data", None),
    }

    def step(params, features, graph, n_frames):
        local = _estep_local(params, features, graph, n_frames,
                             num_trans_slots)
        # reduce utterance shards (the combine_stats analog)
        local = jax.lax.psum(local, "data")
        ll = local.pop("ll")
        # Gaussian stats arrive replicated over 'model' (all_gather'ed gll
        # indices are global); slice out this shard's rows for the M-step.
        m = jax.lax.axis_index("model")
        Gl = params["means"].shape[0]
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, m * Gl, Gl, axis=0)
        gamma = sl(local["gamma"])
        m1 = sl(local["mean_acc"])
        m2 = sl(local["sec_acc"])
        # also reduce over 'model' in case the pool shards disagree (they
        # are identical computations; psum is a no-op semantically but
        # keeps the program valid if XLA partitions differently)
        has_data = gamma > 0
        safe = jnp.where(has_data, gamma, 1.0)
        new_mean = m1 / safe[:, None]
        new_cov = jnp.maximum(m2 / safe[:, None] - new_mean ** 2, minvar)
        means = jnp.where(has_data[:, None], new_mean, params["means"])
        covars = jnp.where(has_data[:, None], new_cov, params["covars"])
        # mixture weight ML update (Distributions.cc:2277-2283)
        mg = local["mix_gamma"]
        tot = jnp.sum(mg, axis=1, keepdims=True)
        w = jnp.where(tot > 0, mg / jnp.maximum(tot, 1e-30),
                      jnp.exp(params["comp_logw"]))
        comp_logw = jnp.log(jnp.maximum(w, 1e-30))
        comp_logw = jnp.where(params["comp_logw"] <= LOG_ZERO / 2,
                              LOG_ZERO, comp_logw)
        new_params = {"means": means, "covars": covars,
                      "comp_idx": params["comp_idx"],
                      "comp_logw": comp_logw}
        return new_params, ll

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(param_specs, P("data", None, None), graph_spec,
                  P("data")),
        out_specs=(param_specs, P()),
        check_vma=False)
    return jax.jit(fn)
