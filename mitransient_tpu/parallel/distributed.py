"""Multi-host (multi-process) SPMD support.

The reference is strictly single-process (SURVEY.md section 2.3): its only
parallelism is one Dr.Jit megakernel.  Here a render can span hosts — spp
sharded over every device of every host, scene replicated, film partials
and parameter gradients ``psum``-all-reduced within and across hosts.
JAX's collectives make the two cases the same program: :func:`init_distributed` wires the processes
together, :func:`global_mesh` spans all hosts' devices, and the sharded
render/backward entry points in ``parallel.mesh`` run unchanged.

Determinism across layouts: sample streams are keyed by *global* device
index (``stream = pass * n_devices + axis_index``), so a render over N
devices produces bit-identical films whether those N devices live in one
process or many (tested by tests/test_multihost.py).

On CPU (tests) cross-process collectives use the gloo backend; on GPUs
XLA's collectives go through NCCL.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_count: int | None = None,
) -> None:
    """Initialize the multi-process runtime (idempotent).

    Pass the coordinator address (``host:port``), the process count and
    this process's id explicitly; with no arguments JAX must find a cluster
    description in the environment.  For multi-process CPU runs (tests)
    ``local_device_count`` forces N virtual CPU devices per process and
    selects the gloo collectives backend.
    """
    if jax.distributed.is_initialized():
        return
    if local_device_count is not None:
        import os

        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{local_device_count}").strip()
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(name: str = "shard") -> Mesh:
    """1-D mesh over every device of every process, in global device order
    (the spp data-parallel axis, within and across hosts)."""
    return Mesh(np.asarray(jax.devices()), (name,))


def replicate(tree, mesh: Mesh):
    """Make every leaf a fully-replicated *global* array on ``mesh``.

    In multi-process SPMD, jit inputs must be global arrays; every process
    holds the same host value (scene tables, camera, seeds), so replication
    is a local device_put — no data moves between hosts.
    """
    s = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, s), tree)


def fetch(tree):
    """Host copies of fully-replicated global arrays (works in every
    process: the local shard of a replicated array is the whole array)."""

    def _get(x):
        if hasattr(x, "is_fully_addressable") and not x.is_fully_addressable:
            # replicated over a multi-process mesh: any local shard is the
            # whole array
            return np.asarray(x.addressable_data(0))
        return np.asarray(x)

    return jax.tree.map(_get, tree)


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()
