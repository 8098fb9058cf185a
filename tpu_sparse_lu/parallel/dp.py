"""Data-parallel multi-RHS solves: shard the RHS panel axis over the mesh.

The reference is single-RHS only (``x::AbstractVector``,
/root/reference/src/SharedMemSparseLU.jl:286); SURVEY.md §2.2 maps the DP
axis onto batched multi-RHS SpSM with RHS-axis sharding. Factors are
replicated (they are the "model"); the ``(n, R)`` panel is sharded on R.
Embarrassingly parallel — zero collectives in the solve itself.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import replicated_factors

__all__ = ["make_dp_ldiv"]


def make_dp_ldiv(F, mesh: Mesh, axis: str = "chunks"):
    """Returns ``solve(b)`` with ``b: (n, R)`` sharded column-wise over the
    mesh; ``R`` must be divisible by the mesh size. Factors replicated,
    and copied again after a refactorization."""
    exe = F._exe("ldiv")
    rhs_sharding = NamedSharding(mesh, P(None, axis))
    rep = NamedSharding(mesh, P())

    fn = jax.jit(
        lambda ldata, udata, pperm, qperm, rs_blk, b: exe(
            ldata, udata, pperm, qperm, rs_blk, b
        ),
        in_shardings=(rep, rep, rep, rep, rep, rhs_sharding),
        out_shardings=rhs_sharding,
    )

    factors = replicated_factors(F, mesh)

    def solve(b):
        b = jnp.asarray(b, dtype=F.dtype)
        if b.ndim != 2:
            raise ValueError("dp ldiv expects an (n, R) panel")
        b = jax.device_put(b, rhs_sharding)
        return fn(*factors(), b)

    return solve
