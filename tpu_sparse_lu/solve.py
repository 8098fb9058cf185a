"""Level-scheduled blocked triangular solves and the full ``ldiv``.

Device replacement for the reference's hot loop (SURVEY.md §3.2):
``lsolve!``/``rsolve!`` run a *serial* chunk loop of BLAS ``trsv!`` +
``gemm!`` (/root/reference/src/SharedMemSparseLU.jl:349-367, :374-392).
Here the chunk dependency DAG is layered into levels (host side, in
``plan_triangular``); each level executes as

* one **batched** diagonal-tile triangular solve over every chunk in the
  level (the reference's ``trsv!`` at src:359/:384), and
* one **batched** tile matmul + scatter-add applying every off-diagonal
  tile whose source chunk lives in this level (the reference's ``gemm!``
  at src:362-363/:387-388, with the tiles pre-negated at pack time).

The right-hand side is carried chunk-blocked as ``xw : (K+1, cs, R)`` —
row block ``K`` is a zero dummy slot absorbing padded lanes — so every
per-level op is a clean gather / batched-matmul / scatter with static
shapes. Multi-RHS (the SpSM config in BASELINE.md) falls out for free:
``R > 1`` turns every tile op into a batched matmul.

Two schedule executors:

* ``scan``     — ``lax.scan`` over levels padded to max level width; best
                 for long thin chains (banded matrices: width 1, no waste).
* ``unrolled`` — Python-unrolled ragged levels with exact widths and
                 static (constant-folded) index arrays; best for wide
                 shallow DAGs where padding would dominate.

Three diagonal-tile modes (``SolverConfig.tri_mode``): exact batched
``triangular_solve`` ("trsm"), precomputed tile inverses turning the whole
solve into matmuls ("inv"), and inverses plus one residual-correction step
("inv_refine").
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .symbolic import TriPlan

__all__ = [
    "TriKernelData",
    "prepare_tri_kernel",
    "blocked_tri_solve",
    "block_rhs",
    "unblock_rhs",
]


def _bmm(a, b):
    """Batched (tile) matmul, fp32-accumulated."""
    return lax.dot_general(
        a,
        b,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=a.dtype if a.dtype == jnp.float64 else jnp.float32,
    ).astype(a.dtype)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TriKernelData:
    """Device-resident numeric data + schedule for one triangular factor.

    Consumed by the XLA level-scan engine (:func:`blocked_tri_solve`) and
    the mesh engines."""

    diag: jax.Array  # (K+1, cs, cs) diagonal tiles (padding rows = I)
    diag_inv: Optional[jax.Array]  # (K+1, cs, cs) tile inverses, or None
    offdiag: jax.Array  # (T+1, cs, cs) negated off-diagonal tiles
    level_chunks: jax.Array  # (NL, MC) int32
    level_tiles: jax.Array  # (NL, MT) int32
    tile_brow: jax.Array  # (T+1,) int32
    tile_bcol: jax.Array  # (T+1,) int32

    def tree_flatten(self):
        return (
            (self.diag, self.diag_inv, self.offdiag, self.level_chunks,
             self.level_tiles, self.tile_brow, self.tile_bcol),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def tile_inverses(diag: jax.Array, *, lower: bool, unit: bool) -> jax.Array:
    """Batched inverses of the diagonal triangular tiles.

    One-time cost per (re)factorization; afterwards the hot solve path is
    pure batched matmul (partitioned-inverse trick — replaces the
    reference's per-chunk ``trsv!``, src:359/:384, with matmul work).
    Computed by blocked recursion over batched matmuls (ops/tri_inverse)
    rather than ``triangular_solve`` — no sequential substitution.
    """
    from .ops.tri_inverse import tri_inverse

    return tri_inverse(diag, lower=lower, unit=unit)


def prepare_tri_kernel(
    plan: TriPlan,
    diag: jax.Array,
    offdiag: jax.Array,
    *,
    tri_mode: str,
) -> TriKernelData:
    """Assemble device data for :func:`blocked_tri_solve` from packed tiles.

    Note the diagonal is always treated as explicit: SuperLU's L stores its
    unit diagonal (like UMFPACK's, reference src:359 trsv 'U' flag), and the
    packer writes it into the tiles, so ``unit_diagonal=False`` everywhere.
    """
    diag_inv = None
    if tri_mode in ("inv", "inv_refine"):
        diag_inv = tile_inverses(diag, lower=plan.lower, unit=False)
    return TriKernelData(
        diag=diag,
        diag_inv=diag_inv,
        offdiag=offdiag,
        level_chunks=jnp.asarray(plan.level_chunks),
        level_tiles=jnp.asarray(plan.level_tiles),
        tile_brow=jnp.asarray(plan.tile_brow),
        tile_bcol=jnp.asarray(plan.tile_bcol),
    )


def _solve_diag(data: TriKernelData, r, chunk_ids, *, lower: bool, tri_mode: str):
    """Solve the batched diagonal-tile systems T_k y_k = r_k for one level."""
    if tri_mode == "trsm":
        tri = data.diag[chunk_ids]
        return lax.linalg.triangular_solve(
            tri, r, left_side=True, lower=lower, unit_diagonal=False
        )
    tinv = data.diag_inv[chunk_ids]
    y = _bmm(tinv, r)
    if tri_mode == "inv_refine":
        tri = data.diag[chunk_ids]
        resid = r - _bmm(tri, y)
        y = y + _bmm(tinv, resid)
    return y


def _level_step(data: TriKernelData, xw, chunk_ids, tile_ids, *, lower, tri_mode):
    # 1) batched diagonal-tile solve (reference trsv!, src:359/:384)
    r = xw[chunk_ids]
    y = _solve_diag(data, r, chunk_ids, lower=lower, tri_mode=tri_mode)
    xw = xw.at[chunk_ids].set(y)
    # 2) batched off-diagonal apply + scatter-accumulate
    #    (reference gemm!, src:362-363/:387-388; tiles pre-negated)
    src = data.tile_bcol[tile_ids]
    dst = data.tile_brow[tile_ids]
    contrib = _bmm(data.offdiag[tile_ids], xw[src])
    return xw.at[dst].add(contrib)


def blocked_tri_solve(
    plan: TriPlan,
    data: TriKernelData,
    xw: jax.Array,
    *,
    tri_mode: str = "trsm",
    schedule: str = "auto",
) -> jax.Array:
    """Solve ``T x = b`` where ``b`` enters as chunk-blocked ``xw (K+1, cs, R)``
    and ``x`` leaves the same way. ``T`` is the factor `plan`/`data` describe.
    """
    if schedule == "auto":
        schedule = "unrolled" if _prefers_unrolled(plan) else "scan"
    lower = plan.lower

    if schedule == "scan":
        def step(carry, lev):
            lc, lt = lev
            return (
                _level_step(data, carry, lc, lt, lower=lower, tri_mode=tri_mode),
                None,
            )

        xw, _ = lax.scan(step, xw, (data.level_chunks, data.level_tiles))
        return xw

    # unrolled: static ragged index arrays per level (host constants)
    for l in range(plan.num_levels):
        nc = int(plan.level_chunk_counts[l])
        nt = int(plan.level_tile_counts[l])
        lc = jnp.asarray(plan.level_chunks[l, : max(nc, 1)])
        lt = jnp.asarray(plan.level_tiles[l, : max(nt, 1)])
        xw = _level_step(data, xw, lc, lt, lower=lower, tri_mode=tri_mode)
    return xw


def _prefers_unrolled(plan: TriPlan, max_unrolled_levels: int = 192) -> bool:
    """Schedule heuristic: the unrolled executor wins for wide shallow
    DAGs where padding waste dominates, on backends whose policy allows
    it (utils/config.backend_policy; compile time grows with the level
    count)."""
    from .utils.config import backend_policy

    if backend_policy().scan_only:
        return False
    if plan.num_levels > max_unrolled_levels:
        return False
    return plan.padding_waste() > 0.25


# ---------------------------------------------------------------------------
# RHS blocking helpers
# ---------------------------------------------------------------------------


def block_rhs(v: jax.Array, n: int, K: int, cs: int) -> jax.Array:
    """(n, R) → chunk-blocked (K+1, cs, R) with zero-padded tail + dummy."""
    R = v.shape[1]
    pad = K * cs - n
    vp = jnp.pad(v, ((0, pad + cs), (0, 0)))
    return vp.reshape(K + 1, cs, R)


def unblock_rhs(xw: jax.Array, n: int) -> jax.Array:
    """Chunk-blocked (K+1, cs, R) → (n, R)."""
    Kp1, cs, R = xw.shape
    return xw.reshape(Kp1 * cs, R)[:n]
