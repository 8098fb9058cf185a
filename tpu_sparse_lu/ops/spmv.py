"""Block-tile SpMV: ``y = A @ x`` as batched dense-tile matmuls.

A scatter-based SpMV (``zeros.at[rows].add(v * x[cols])``) processes one
index per nonzero. This packs A itself into the same chunk-grid dense
tile layout the solver uses: one gather + one batched matmul + one
segment reduction per matvec.

Used by iterative refinement (``ldiv(refine_steps=...)``) — the fp32+IR
accuracy story (SURVEY.md §7 hard part 5) — and exposed as
``ParallelSparseLU.matvec``. Residual products always run at full
precision: a residual rounded to TF32 would cap what refinement can
recover.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

__all__ = ["SpMVPlan", "build_spmv_plan", "apply_spmv"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SpMVPlan:
    """A as dense chunk-grid tiles, grouped by destination block row.

    ``tiles (G, S, cs, cs)`` where row g covers destination block g's
    incoming tiles (padded with zero tiles reading the dummy src chunk).
    """

    n: int
    cs: int
    K: int
    S: int
    src: jax.Array    # (K, S) int32 source chunk, K = dummy (zero rows)
    tiles: jax.Array  # (K, S, cs, cs)

    def tree_flatten(self):
        return (self.src, self.tiles), (self.n, self.cs, self.K, self.S)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], aux[2], aux[3], *children)


def build_spmv_plan(A: sp.spmatrix, cs: int, dtype=np.float32,
                    with_dest: bool = False):
    """Build the plan; with ``with_dest`` also return the flat scatter
    destination per csc nonzero (for in-place value refreshes)."""
    A = sp.csc_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    K = -(-n // cs)
    rows = A.indices
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    br = rows // cs
    bc = cols // cs
    keys = br * np.int64(K) + bc
    uniq, inv = np.unique(keys, return_inverse=True)
    ub, uc = uniq // K, uniq % K
    counts = np.bincount(ub, minlength=K)
    S = max(1, int(counts.max()))
    src = np.full((K, S), K, dtype=np.int32)
    slot_of = np.zeros(uniq.shape[0], dtype=np.int64)
    fill = np.zeros(K, dtype=np.int64)
    for t in range(uniq.shape[0]):
        g = ub[t]
        src[g, fill[g]] = uc[t]
        slot_of[t] = fill[g]
        fill[g] += 1
    tiles = np.zeros((K, S, cs, cs), dtype=dtype)
    np.add.at(
        tiles,
        (br, slot_of[inv], rows % cs, cols % cs),
        A.data.astype(dtype),
    )
    plan = SpMVPlan(
        n=n, cs=cs, K=K, S=S,
        src=jnp.asarray(src), tiles=jnp.asarray(tiles),
    )
    if with_dest:
        dest = ((br * S + slot_of[inv]) * cs + rows % cs) * cs + cols % cs
        return plan, dest
    return plan


def refresh_spmv_values(plan: SpMVPlan, dest: jax.Array, a_data: jax.Array) -> SpMVPlan:
    """New values, same pattern: rebuild the tile store on device (one
    scatter — only used on the device-resident refactor path)."""
    K, S, cs = plan.K, plan.S, plan.cs
    flat = jnp.zeros((K * S * cs * cs,), a_data.dtype).at[dest].add(a_data)
    return SpMVPlan(
        n=plan.n, cs=cs, K=K, S=S, src=plan.src,
        tiles=flat.reshape(K, S, cs, cs),
    )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DiaPlan:
    """A in DIA (diagonal) format for cheap high-precision residuals.

    ``y[i] = sum_d data[d, i] * x[i + offsets[d]]`` (out-of-range reads
    are zero). For the banded/stencil matrices this library targets, a
    5-point Poisson has 5 diagonals and a block-banded PDE operator a few
    dozen — so an f64 SpMV does O(nd * n) flops instead of the dense-tile
    plan's O(K * S * cs^2): the 128x128 tiles of a 5-point stencil are
    ~2% nonzero, and the DIA form recovers the sparsity the tiles gave
    up.
    """

    n: int
    offsets: tuple  # static python ints, length nd
    data: jax.Array  # (nd, n)

    def tree_flatten(self):
        return (self.data,), (self.n, self.offsets)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], *children)


def build_dia_plan(A: sp.spmatrix, dtype=np.float64,
                   max_cost: float = 8.0):
    """DIA plan, or None when the diagonal form is denser than
    ``max_cost`` x nnz (scattered patterns: fall back to the tile plan)."""
    A = sp.coo_matrix(A)
    n = A.shape[0]
    offs = np.unique(A.col.astype(np.int64) - A.row.astype(np.int64))
    if offs.shape[0] * n > max_cost * max(A.nnz, 1) + 8 * n:
        return None
    data = np.zeros((offs.shape[0], n), dtype=dtype)
    d_of = np.searchsorted(offs, A.col.astype(np.int64) - A.row)
    np.add.at(data, (d_of, A.row), A.data.astype(dtype))
    return DiaPlan(n=n, offsets=tuple(int(o) for o in offs),
                   data=jnp.asarray(data))


def apply_dia(plan: DiaPlan, x: jax.Array) -> jax.Array:
    """``y = A @ x`` for ``x (n, R)`` → ``(n, R)`` (unrolled over the
    static diagonal offsets; XLA fuses the shifts+multiply-adds)."""
    n = plan.n
    lo = -min(0, min(plan.offsets))
    hi = max(0, max(plan.offsets))
    xp = jnp.pad(x, ((lo, hi), (0, 0)))
    y = jnp.zeros_like(x)
    for d, off in enumerate(plan.offsets):
        y = y + plan.data[d][:, None] * lax_slice_rows(xp, lo + off, n)
    return y


def lax_slice_rows(xp: jax.Array, start: int, n: int) -> jax.Array:
    return xp[start:start + n]


def apply_spmv(plan: SpMVPlan, x: jax.Array) -> jax.Array:
    """``y = A @ x`` for ``x (n, R)`` → ``(n, R)``."""
    n, cs, K = plan.n, plan.cs, plan.K
    R = x.shape[-1]
    pad = K * cs - n
    xw = jnp.pad(x, ((0, pad + cs), (0, 0))).reshape(K + 1, cs, R)
    gathered = xw[plan.src]                    # (K, S, cs, R)
    y = jnp.einsum(
        "ksij,ksjr->kir", plan.tiles, gathered,
        preferred_element_type=x.dtype, precision=jax.lax.Precision.HIGHEST,
    )
    return y.reshape(K * cs, R)[:n]
