"""Triangular-tile inversion as batched matmuls (stable).

Sequential scalar substitution leaves matmul hardware idle, so tiles are
inverted by blocked recursion (the LAPACK ``trtri`` scheme):

    inv([[A, 0], [C, B]]) = [[inv(A), 0], [-inv(B) C inv(A), inv(B)]]

The two half-size sub-inversions are independent, so each recursion level
*batches* them (the tile batch doubles, the tile size halves): the whole
inversion is ~log2(cs) levels of batched matmuls. At the base size the
nilpotent-series identity

    inv(I + N) = prod_i (I + (-N)^(2^i)),  N strictly triangular

terminates exactly and is numerically safe for small tiles (powers of a
non-contractive N explode at large cs — measured 3e5 error at cs=128 —
but stay bounded at cs<=16).

This is numerically equivalent to blocked back-substitution (stable for
the well-scaled tiles a pivoted factorization produces) and replaces
``lax.linalg.triangular_solve`` on both the solve path and the device
refactorization panels.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["tri_inverse"]

_BASE = 16


def _mm(a, b):
    return lax.dot_general(
        a, b,
        dimension_numbers=(((a.ndim - 1,), (a.ndim - 2,)),
                           (tuple(range(a.ndim - 2)), tuple(range(a.ndim - 2)))),
        preferred_element_type=a.dtype,
    )


def _pow2_pad(T: jax.Array, lower: bool) -> jax.Array:
    """Pad to the next power-of-two size with an identity block."""
    cs = T.shape[-1]
    p = 1
    while p < cs:
        p *= 2
    if p == cs:
        return T
    pad = [(0, 0)] * (T.ndim - 2) + [(0, p - cs), (0, p - cs)]
    T = jnp.pad(T, pad)
    idx = jnp.arange(cs, p)
    return T.at[..., idx, idx].set(1.0)


def _series_inv_exact(T: jax.Array, lower: bool) -> jax.Array:
    """Terminating-series inverse for small tiles (cs <= _BASE)."""
    cs = T.shape[-1]
    eye = jnp.eye(cs, dtype=T.dtype)
    d = jnp.diagonal(T, axis1=-2, axis2=-1)
    dinv = 1.0 / d
    strict = jnp.tril(T, -1) if lower else jnp.triu(T, 1)
    N = strict * dinv[..., None, :]
    X = -N
    M = eye + X
    P = _mm(X, X)
    L = 0
    while (1 << L) < cs:
        L += 1
    for i in range(1, L):
        M = _mm(M, eye + P)
        if i < L - 1:
            P = _mm(P, P)
    return M * dinv[..., :, None]


def _rec_inv(T: jax.Array, lower: bool) -> jax.Array:
    cs = T.shape[-1]
    if cs <= _BASE:
        return _series_inv_exact(T, lower)
    h = cs // 2
    A = T[..., :h, :h]
    B = T[..., h:, h:]
    sub = jnp.stack([A, B], axis=-3)          # (..., 2, h, h)
    subinv = _rec_inv(sub, lower)
    Ai = subinv[..., 0, :, :]
    Bi = subinv[..., 1, :, :]
    if lower:
        C = T[..., h:, :h]
        X = -_mm(Bi, _mm(C, Ai))
        top = jnp.concatenate([Ai, jnp.zeros_like(C.swapaxes(-1, -2))], axis=-1)
        bot = jnp.concatenate([X, Bi], axis=-1)
    else:
        C = T[..., :h, h:]
        X = -_mm(Ai, _mm(C, Bi))
        top = jnp.concatenate([Ai, X], axis=-1)
        bot = jnp.concatenate([jnp.zeros_like(C.swapaxes(-1, -2)), Bi], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


@functools.partial(jax.jit, static_argnames=("lower", "unit"))
def tri_inverse(T: jax.Array, *, lower: bool, unit: bool = False) -> jax.Array:
    """Inverse of triangular tiles ``T (..., cs, cs)``.

    ``unit=True`` treats the diagonal as 1 regardless of stored values.

    Jitted at this boundary: the blocked recursion otherwise runs its
    ~130 primitive binds EAGERLY when called from the host pack path
    (``solve.prepare_tri_kernel``), which profiled at 8 s of the n=90k
    ``from_saved`` reload; under an enclosing jit the wrapper inlines.
    """
    cs = T.shape[-1]
    if unit:
        eye = jnp.eye(cs, dtype=T.dtype)
        strict = jnp.tril(T, -1) if lower else jnp.triu(T, 1)
        T = strict + eye
    if cs == 1:
        return 1.0 / T
    Tp = _pow2_pad(T, lower)
    inv = _rec_inv(Tp, lower)
    return inv[..., :cs, :cs]
