"""Row permutation of the chunk-blocked carriers, as one row gather.

The reference's ldiv applies a row permutation + scaling before the solves
and a column un-permutation after (src/SharedMemSparseLU.jl:324-339). Here
both act on the chunk-blocked carrier ``(K+1, cs, R)`` the solve engines
use, so permute → lsolve → rsolve → unpermute chains with no layout
changes. Row scaling ``Rs`` is a separate elementwise multiply, so a plan
is value-independent (a refactorization changes Rs but never the plan).

On the GPU a row gather is native: it beat the block-one-hot matmul
formulation this module used to carry (see PERF.md), and it is exact at any
matmul precision, where a one-hot product rounded to TF32 is not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["PermPlan", "build_perm_plan", "apply_perm"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PermPlan:
    """Static gather form of ``out[i] = v[perm[i]]`` on blocked carriers.

    Supports rectangular maps: the output carrier has ``K`` chunks while
    sources index a carrier of ``K_in`` chunks. ``idx[i]`` is the source
    row in the flat ``(K_in * cs, R)`` view of the input's real chunks;
    rows with ``perm[i] = -1`` (the nested-dissection padding embedding)
    and output rows past n hold the out-of-range index ``K_in * cs`` and
    read zero."""

    K: int
    cs: int
    K_in: int
    idx: jax.Array  # (K * cs,) int32

    def tree_flatten(self):
        return (self.idx,), (self.K, self.cs, self.K_in)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux, *children)


def build_perm_plan(perm: np.ndarray, n: int, cs: int, *,
                    n_in: Optional[int] = None) -> PermPlan:
    """Build the plan for ``out[i] = v[perm[i]]`` on blocked carriers.

    ``perm`` has length n (output rows); sources index a vector of length
    ``n_in`` (default n). ``perm[i] = -1`` rows are zero. Output rows past
    n (padding lanes) are zero."""
    K = -(-n // cs)
    n_in = n if n_in is None else n_in
    K_in = -(-n_in // cs)
    perm = np.asarray(perm, dtype=np.int64)
    idx = np.full(K * cs, K_in * cs, dtype=np.int32)
    idx[:n] = np.where(perm >= 0, perm, K_in * cs)
    return PermPlan(K=K, cs=cs, K_in=K_in, idx=jnp.asarray(idx))


def apply_perm(plan: PermPlan, xw: jax.Array) -> jax.Array:
    """Apply to chunk-blocked ``xw (K_in+1, cs, R)`` → ``(K+1, cs, R)``
    (the trailing dummy chunk of the result is zero)."""
    K, K_in, cs = plan.K, plan.K_in, plan.cs
    R = xw.shape[-1]
    flat = xw[:K_in].reshape(K_in * cs, R)
    out = jnp.take(flat, plan.idx, axis=0, mode="fill", fill_value=0)
    return jnp.concatenate(
        [out.reshape(K, cs, R), jnp.zeros((1, cs, R), xw.dtype)], axis=0
    )
