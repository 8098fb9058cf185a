"""Pallas (Triton route) dense-tile LU kernel, no pivoting, for the device
refactorization.

The blocked right-looking refactorization (refactor.py) is sequential in
exactly one place: the rank-1 elimination loop over a diagonal tile's
columns. As XLA ops that loop is a ``cs``-iteration device loop inside
every elimination level, each iteration a handful of small kernels. Here
one Triton program factors one ``cs x cs`` tile with the whole column loop
inside the program, the tile held on chip; the grid runs over the level's
batch of tiles, one program each.

Identical math to ``refactor._lu_nopivot``: merged L\\U (strict lower =
L, upper incl. diagonal = U, unit diagonal implicit). Row and column
``i`` are extracted with masked reductions over the whole block (Triton
has no dynamic indexing into a block held in registers), so every step is
block-wide ``where`` / reductions / a rank-1 update.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

__all__ = ["lu_tile", "supports_lu_tile"]


def supports_lu_tile(cs: int, dtype) -> bool:
    """Triton blocks are powers of two; a tile above 128 x 128 no longer
    fits one program's registers and shared memory."""
    return (0 < cs <= 128 and cs & (cs - 1) == 0
            and np.dtype(dtype) in (np.float32, np.float64))


def _num_warps(cs: int, itemsize: int) -> int:
    # timed on an H100 at cs = 128 (PERF.md): float32 tiles run fastest
    # on 4 warps of 1/2/4/8/16, float64 tiles on 16 of 4/8/16; smaller
    # tiles keep 4
    return 16 if itemsize == 8 and cs == 128 else 4


def _kernel(d_ref, out_ref):
    cs = d_ref.shape[-1]
    ridx = lax.broadcasted_iota(jnp.int32, (cs, cs), 0)
    cidx = lax.broadcasted_iota(jnp.int32, (cs, cs), 1)
    rcol = lax.broadcasted_iota(jnp.int32, (cs, 1), 0)
    crow = lax.broadcasted_iota(jnp.int32, (1, cs), 1)

    def step(i, D):
        urow = jnp.sum(jnp.where(ridx == i, D, 0.0), axis=0, keepdims=True)
        col = jnp.sum(jnp.where(cidx == i, D, 0.0), axis=1, keepdims=True)
        piv = jnp.sum(jnp.where(crow == i, urow, 0.0), axis=1, keepdims=True)
        l = jnp.where(rcol > i, col / piv, 0.0)           # (cs, 1)
        urow = jnp.where(crow > i, urow, 0.0)             # (1, cs)
        D = D - l * urow
        # multipliers into column i's strictly-lower part
        return jnp.where((cidx == i) & (ridx > i), l, D)

    out_ref[...] = lax.fori_loop(jnp.int32(0), jnp.int32(cs), step,
                                 d_ref[...])


@functools.partial(jax.jit, static_argnames=("interpret",))
def lu_tile(D: jax.Array, *, interpret: bool = False) -> jax.Array:
    """Factor a ``(B, cs, cs)`` batch of tiles into merged L\\U, one
    Triton program per tile. With ``interpret`` set, the same kernel body
    runs through the Pallas interpreter (tests on the CPU)."""
    B, cs, _ = D.shape
    spec = pl.BlockSpec((None, cs, cs), lambda b: (b, 0, 0))
    return pl.pallas_call(
        _kernel,
        out_shape=jax.ShapeDtypeStruct(D.shape, D.dtype),
        grid=(B,),
        in_specs=[spec],
        out_specs=spec,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_num_warps(cs, D.dtype.itemsize), num_stages=1),
        interpret=interpret,
        name="lu_tile",
    )(D)
