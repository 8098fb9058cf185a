"""Bidiagonal associative-scan fast path (ops/scan_solve.py).

BASELINE config 1's matrix family (1-D chains) factors into bidiagonal
L/U; the solver must detect that and dispatch to the log-depth scan path,
matching the reference's serial substitution semantics
(/root/reference/src/SharedMemSparseLU.jl:349-392) to f64 precision.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from tpu_sparse_lu import ParallelSparseLU, SolverConfig
from tpu_sparse_lu.models import laplacian_1d, poisson_2d
from tpu_sparse_lu.ops.scan_solve import bidiag_bands, scan_bidiag_solve


def _chain_F(n, dtype="float64"):
    A = laplacian_1d(n)
    return A, ParallelSparseLU(A, config=SolverConfig(
        chunk_size=128, ordering="natural", pivot_threshold=0.0,
        dtype=dtype))


@pytest.mark.parametrize("n", [7, 128, 257, 5000])
def test_scan_ldiv_matches_spsolve(rng, n):
    A, F = _chain_F(n)
    assert F._scan_bands is not None and F._scan_perm_id
    b = rng.random(n)
    x = np.asarray(F.ldiv(b))  # R=1: associative_scan path
    xr = spla.spsolve(A.tocsc(), b)
    np.testing.assert_allclose(x, xr, rtol=1e-10, atol=1e-12)
    b3 = rng.random((n, 3))
    x3 = np.asarray(F.ldiv(b3))  # R>1: associative_scan path
    xr3 = spla.spsolve(A.tocsc(), b3)
    np.testing.assert_allclose(x3, xr3, rtol=1e-10, atol=1e-12)


def test_scan_engines_match_triangular(rng):
    A, F = _chain_F(600)
    b = rng.random((600, 2))
    y = np.asarray(F.lsolve(b))
    yr = spla.spsolve_triangular(F.L.tocsr(), b, lower=True)
    np.testing.assert_allclose(y, yr, rtol=1e-10, atol=1e-12)
    z = np.asarray(F.rsolve(b))
    zr = spla.spsolve_triangular(F.U.tocsr(), b, lower=False)
    np.testing.assert_allclose(z, zr, rtol=1e-10, atol=1e-12)


def test_scan_lifecycle_refactor(rng):
    """Reference lifecycle (runtests.jl:108-188) through the scan path:
    solve → new values refactor → solve again."""
    A, F = _chain_F(900)
    b = rng.random(900)
    np.testing.assert_allclose(
        np.asarray(F.ldiv(b)), spla.spsolve(A.tocsc(), b),
        rtol=1e-10, atol=1e-12)
    A2 = A.copy()
    A2.data = A2.data * (1 + 0.1 * rng.random(A2.nnz))
    F.refactor(A2)
    assert F._scan_bands is not None  # re-detected after host refactor
    np.testing.assert_allclose(
        np.asarray(F.ldiv(b)), spla.spsolve(A2.tocsc(), b),
        rtol=1e-9, atol=1e-11)


def test_device_refactor_disables_stale_bands(rng):
    A, F = _chain_F(512)
    b = rng.random(512)
    A2 = A.copy()
    A2.data = A2.data * 1.25
    F.refactor_numeric(A2)
    assert F._scan_bands is None  # band values would be stale
    np.testing.assert_allclose(
        np.asarray(F.ldiv(b)), spla.spsolve(A2.tocsc(), b),
        rtol=1e-8, atol=1e-10)


def test_bidiag_detection_negative():
    A = poisson_2d(10, 10)
    F = ParallelSparseLU(A, config=SolverConfig(chunk_size=32))
    assert F._scan_bands is None  # 2-D stencil factors are not bidiagonal
    lb = bidiag_bands(sp.csc_matrix(np.triu(np.ones((5, 5)))), lower=False)
    assert lb is None  # bandwidth > 1


def test_scan_bidiag_solve_direct(rng):
    import jax.numpy as jnp

    n = 300
    ld = np.ones(n)
    lo = np.concatenate([[0.0], rng.uniform(-0.9, 0.9, n - 1)])
    b = rng.random((n, 2))
    y = np.asarray(scan_bidiag_solve(
        jnp.asarray(ld), jnp.asarray(lo), jnp.asarray(b), lower=True))
    L = sp.diags([lo[1:], ld], [-1, 0]).tocsr()
    np.testing.assert_allclose(
        y, spla.spsolve_triangular(L, b, lower=True),
        rtol=1e-10, atol=1e-12)
