"""Log-depth bidiagonal substitution via ``lax.associative_scan``.

The reference's primary calling pattern is one ``ldiv!(x, F, b)`` per PDE
timestep with a single *vector* RHS (/root/reference/src/SharedMemSparseLU.jl:286-342).
For 1-D chain matrices (BASELINE config 1) the factors are BIDIAGONAL —
forward/backward substitution is the first-order linear recurrence

    y_i = a_i * y_{i-1} + c_i

which a serial CPU walks in O(n) but an accelerator can evaluate in O(log n)
parallel depth: the affine maps ``(a, c)`` compose associatively,
``(a2, c2) ∘ (a1, c1) = (a1*a2, a2*c1 + c2)``, so the whole substitution
is one ``lax.associative_scan`` of elementwise multiply-adds — exactly
the parallel-cyclic-reduction shape the level-scheduled tile engine
cannot reach (a chain's chunk DAG has no width to batch).

Stability: the composed prefix products ``prod a_i`` are exactly the
multipliers a serial substitution applies successively; for factors from
a pivoted (|l| <= 1) or equilibrated factorization they are bounded, so
the scan is as backward-stable as the serial loop in the same precision.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax import lax

__all__ = ["bidiag_bands", "scan_bidiag_solve"]


def bidiag_bands(M: sp.csc_matrix, *, lower: bool) -> Optional[dict]:
    """Extract (diag, off) bands when ``M`` is bidiagonal, else None.

    ``lower=True`` expects nonzeros only on the diagonal and first
    subdiagonal (SuperLU's L, unit diagonal stored explicitly —
    reference src:359 trsv 'U' flag); ``lower=False`` the first
    superdiagonal (U, non-unit diagonal).
    """
    M = sp.csc_matrix(M)
    n = M.shape[0]
    # a bidiagonal factor has at most 2n-1 nonzeros: bail before building
    # any nnz-length temporaries (this probe runs on EVERY factorization,
    # including 58M-nnz ones where the full check costs seconds)
    if M.nnz > 2 * n - 1:
        return None
    rows = M.indices
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(M.indptr))
    d = rows - cols if lower else cols - rows
    if d.min(initial=0) < 0 or d.max(initial=0) > 1:
        return None
    diag = np.ones(n, dtype=M.dtype)
    off = np.zeros(n, dtype=M.dtype)
    on_diag = d == 0
    diag[rows[on_diag]] = M.data[on_diag]
    # off[i]: coefficient coupling y_i to its already-solved neighbour —
    # L[i, i-1] for lower (entries at row i, col i-1), U[i, i+1] for upper
    # (entries at row i, col i+1) — both index by their ROW
    osel = d == 1
    off[rows[osel]] = M.data[osel]
    return {"diag": diag, "off": off}


def scan_bidiag_solve(diag, off, b, *, lower: bool):
    """Solve a bidiagonal system in log depth.

    ``lower=True``:  T[i,i] = diag[i], T[i,i-1] = off[i] (off[0] unused):
        y_i = (b_i - off_i * y_{i-1}) / diag_i
    ``lower=False``: T[i,i] = diag[i], T[i,i+1] = off[i] (off[n-1] unused):
        y_i = (b_i - off_i * y_{i+1}) / diag_i

    ``b`` is ``(n, R)``; ``diag``/``off`` are ``(n,)`` device arrays.
    """
    diag = diag[:, None]
    off = off[:, None]
    if not lower:
        diag, off, b = diag[::-1], off[::-1], b[::-1]
    a = -off / diag
    c = b / diag
    a = a.at[0].set(0.0)

    def compose(left, right):
        al, cl = left
        ar, cr = right
        return al * ar, ar * cl + cr

    _, y = lax.associative_scan(compose, (jnp.broadcast_to(a, c.shape), c))
    return y if lower else y[::-1]
