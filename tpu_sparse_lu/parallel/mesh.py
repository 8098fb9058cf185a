"""Device-mesh helpers.

The reference's (latent) parallel substrate is MPI-3 shared-memory windows —
exported as ``allocate_shared`` but never defined in the snapshot
(/root/reference/src/SharedMemSparseLU.jl:31; SURVEY.md C10). The device
equivalent of a node-shared window is a device-resident array sharded over a
``jax.sharding.Mesh``: one logical array, shards addressable by every
program, with XLA collectives instead of window synchronisation
(SURVEY.md §5.8).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "initialize_multihost",
    "make_global_mesh",
    "replicate_to_mesh",
    "replicated_factors",
    "allocate_shared",
]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "chunks") -> Mesh:
    """1-D device mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> None:
    """Join a multi-host (DCN) cluster: ``jax.distributed.initialize``.

    Call once per process before any JAX computation; afterwards
    ``jax.devices()`` is the GLOBAL device list (all hosts) and
    :func:`make_global_mesh` builds a mesh whose collectives cross hosts
    over the cluster network. Pass the coordinator address, process count
    and process id explicitly — nothing in the environment supplies them;
    CPU cross-process collectives use the gloo transport (the CI analogue
    of the multi-host path, SURVEY.md §5.8).
    """
    # NOTE: must not touch jax.default_backend() here — that would
    # initialize the backend before jax.distributed.initialize runs.
    import os

    platforms = (
        jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    )
    if "cpu" in str(platforms):
        try:  # gloo is the only CPU cross-process collective transport
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:  # noqa: BLE001 — older jax: flag absent
            pass
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def make_global_mesh(axis_name: str = "chunks") -> Mesh:
    """1-D mesh over ALL global devices (multi-host after
    :func:`initialize_multihost`; equals :func:`make_mesh` single-host)."""
    return Mesh(np.array(jax.devices()), (axis_name,))


def replicate_to_mesh(tree, mesh: Mesh):
    """Replicate a pytree of host/device arrays onto every device of a
    (possibly multi-process) mesh as GLOBAL arrays.

    Multi-controller JAX cannot feed process-local arrays to a global
    computation; this is the multi-host analogue of the reference's
    "every rank maps the same shared-memory window" (SURVEY.md C10) —
    every process contributes its identical local copy.
    """
    rep = NamedSharding(mesh, P())

    def put(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, rep, lambda idx: x[idx])

    return jax.tree.map(put, tree)


def replicated_factors(F, mesh: Mesh, *, multihost: bool = False):
    """Returns ``get()`` giving F's numeric state ``(ldata, udata, pperm,
    qperm, rs_blk)`` replicated over ``mesh``, for the mesh solvers.

    The copy is made once per numeric state: after a refactorization
    (``F._generation`` moves on) the next ``get()`` copies F's new arrays,
    so a solver built before ``refactor_numeric`` solves the new matrix. A
    host refactorization that changes the sparsity pattern replaces
    ``F.plan``, which the solvers bake in; ``get()`` then raises."""
    plan = F.plan
    cache = {}

    def get():
        if F.plan is not plan:
            raise RuntimeError(
                "the factor pattern changed since this mesh solver was "
                "built; build it again"
            )
        if cache.get("gen") != F._generation:
            args = (F.ldata, F.udata, F._pperm, F._qperm, F._rs_blk)
            cache["args"] = (
                replicate_to_mesh(args, mesh) if multihost
                else jax.device_put(args, NamedSharding(mesh, P()))
            )
            cache["gen"] = F._generation
        return cache["args"]

    return get


def allocate_shared(
    shape: Sequence[int],
    dtype=jnp.float32,
    *,
    mesh: Optional[Mesh] = None,
    spec: Optional[P] = None,
) -> jax.Array:
    """Allocate a zero array shared across the mesh.

    Device analogue of the reference's exported-but-undefined
    ``allocate_shared`` (src:31): where MPI-3 would hand out a node-local
    shared-memory window, this places one logical zero array in device
    memory with the
    given ``NamedSharding`` (replicated by default — every chip "sees" the
    whole array, like ranks sharing a window).
    """
    if mesh is None:
        return jnp.zeros(shape, dtype)
    sharding = NamedSharding(mesh, spec if spec is not None else P())
    return jax.device_put(jnp.zeros(shape, dtype), sharding)
