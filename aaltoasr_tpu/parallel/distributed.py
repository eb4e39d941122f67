"""Multi-host entry: `jax.distributed` initialization + global meshes.

The reference scales over hosts with scheduler job arrays and a shared
filesystem (`submit-to-slurm.sh`, `ClusterManager.pm:42-115`,
`combine_stats` epilogs).  Here it is one SPMD program spanning every
host's cards: each host runs the same script, calls :func:`initialize`
once, and builds meshes over ``jax.devices()`` (which then lists every
card of every host).  The `psum` inside `sharded_train_step` crosses
the interconnect instead of .gks files.

Launch recipe (one command per host; the topology is always explicit)::

    JAX_COORDINATOR_ADDRESS=host0:1234 JAX_NUM_PROCESSES=4 \\
      JAX_PROCESS_ID=$SLURM_PROCID python train.py ...

SLURM integration mirrors ClusterManager.pm's array submission: use
``--ntasks=<hosts>`` and derive JAX_PROCESS_ID from $SLURM_PROCID.
"""

from __future__ import annotations

import os

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Initialize jax.distributed for a multi-host run.

    Arguments default from the environment (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID; SLURM_PROCID is used for the
    process id when present).  Returns True when distributed mode was
    initialized, False for a single-process run (no coordinator and no
    process count configured).
    """
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = (os.environ.get("JAX_PROCESS_ID")
               or os.environ.get("SLURM_PROCID"))
        process_id = int(env) if env else None

    if coordinator_address is None and num_processes is None:
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return True


def global_mesh(n_model: int = 1):
    """("data", "model") mesh over EVERY process's devices.

    Call after :func:`initialize`; with P processes of D local chips
    the data axis spans P*D//n_model entries, so recipes sharded with
    ``-B P -I process_id`` feed disjoint utterances into one psum.
    """
    from aaltoasr_tpu.parallel.mesh import make_mesh
    return make_mesh(n_model=n_model, devices=jax.devices())


def process_shard(recipe, num_batches: int = 0):
    """Split a recipe across processes like the reference's -B/-I
    (`aku/Recipe.hh:97-112`): process i (0-based) of N takes the
    1-based batch i+1."""
    n = num_batches or jax.process_count()
    return recipe.shard(n, jax.process_index() + 1)
