"""Multi-host scaffolding.

The single-host GSPMD path in `parallel.render` is topology-agnostic:
the same `Mesh` + `NamedSharding` code spans the GPUs of several hosts
once every host has called `jax.distributed.initialize`. This module is
that entry point plus the host-local <-> global array plumbing a
multi-process driver needs.

Pass the coordinator address (``host:port``), the process count and
this process's id explicitly; a GPU cluster without a scheduler that
JAX recognizes has nothing to infer them from. Tested by
tests/test_distributed.py with 2 CPU processes of 4 virtual devices
each (the standard JAX multi-process simulation).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.spec import Rays


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
):
    """Join (or create) a multi-host JAX runtime.

    Call once per process, before any other JAX API touches the backend,
    with all three of coordinator_address, num_processes and process_id
    (JAX infers them only under cluster schedulers it recognizes). After
    this returns,
    `jax.devices()` lists the GLOBAL device set and `global_ray_mesh()`
    spans it.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def is_multi_process() -> bool:
    return jax.process_count() > 1


def global_ray_mesh(axis_name: str = "rays") -> Mesh:
    """1-D mesh over the GLOBAL device set (all hosts), sharding rays.

    Identical to `make_ray_mesh` on one host; after `initialize()` it
    spans every process's devices, and GSPMD routes the feature-gradient
    psum over NVLink within a host and the network across hosts."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def shard_global_rays(
    mesh: Mesh, local_rays: Rays, axis_name: str = "rays"
) -> Rays:
    """Assemble a GLOBAL sharded ray batch from per-process local rays.

    Each process passes its own (B_local, 3) arrays; the result is a
    global (B_local * num_processes_in_axis, 3) jax.Array sharded along
    `axis_name` whose addressable shards are this process's data. On a
    single process this is equivalent to `shard_rays`.
    """
    sh = NamedSharding(mesh, P(axis_name))

    def _mk(x):
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(sh, x)

    return Rays(_mk(local_rays.origins), _mk(local_rays.dirs),
                _mk(local_rays.viewdirs))


def replicate_global(mesh: Mesh, arr) -> jax.Array:
    """Replicate a host-local array onto every device of the global mesh.

    All processes must pass the same values (the usual contract for
    replicated parameters like the feature pool)."""
    repl = NamedSharding(mesh, P())
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, repl, lambda idx: arr[idx])
