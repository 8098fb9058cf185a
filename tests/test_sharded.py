"""Mesh-sharded solve tests on a simulated 8-device CPU mesh
(SURVEY.md §4: the CI analogue of a multi-GPU host)."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from _approx import assert_isapprox
from tpu_sparse_lu import ParallelSparseLU, SolverConfig
from tpu_sparse_lu.models import fe_block_matrix, laplacian_1d, poisson_2d
from tpu_sparse_lu.parallel.mesh import allocate_shared, make_mesh
from tpu_sparse_lu.parallel.sharded_solve import (
    build_sharded_tri_plan,
    make_sharded_ldiv,
)

TOL = 1e-12


def test_virtual_devices_present():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_sharded_ldiv_matches_single(rng, ndev):
    A = poisson_2d(12, 10)
    n = A.shape[0]
    F = ParallelSparseLU(A, chunk_size=8)
    mesh = make_mesh(ndev)
    solve = make_sharded_ldiv(F, mesh)
    b = rng.random(n)
    x = np.asarray(solve(b))
    x_single = np.asarray(F.ldiv(b))
    assert_isapprox(x, spla.spsolve(A, b), rtol=TOL, atol=TOL)
    # sharded and single-device paths agree to machine precision
    np.testing.assert_allclose(x, x_single, rtol=1e-13, atol=1e-13)


def test_sharded_multi_rhs(rng):
    A = fe_block_matrix(rng, 20, 5)
    n = A.shape[0]
    F = ParallelSparseLU(A, chunk_size=8)
    mesh = make_mesh(4)
    solve = make_sharded_ldiv(F, mesh)
    B = rng.random((n, 5))
    X = np.asarray(solve(B))
    for j in range(5):
        assert_isapprox(X[:, j], spla.spsolve(A, B[:, j]), rtol=TOL, atol=TOL)


def test_sharded_after_refactor(rng):
    A = laplacian_1d(96)
    F = ParallelSparseLU(A, chunk_size=8)
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.05 * rng.standard_normal(A2.data.shape))
    F.refactor(A2)
    mesh = make_mesh(4)
    solve = make_sharded_ldiv(F, mesh)
    b = rng.random(96)
    assert_isapprox(np.asarray(solve(b)), spla.spsolve(A2, b), rtol=TOL, atol=TOL)


def test_sharded_plan_covers_everything(rng):
    """Every chunk and tile appears exactly once across all devices."""
    A = poisson_2d(10, 10)
    F = ParallelSparseLU(A, chunk_size=8)
    for plan in (F.plan.lplan, F.plan.uplan):
        sp8 = build_sharded_tri_plan(plan, 8)
        chunks = sp8.level_chunks[sp8.level_chunks < plan.K]
        assert sorted(chunks.tolist()) == list(range(plan.K))
        tiles = sp8.level_tiles[sp8.level_tiles < plan.T]
        assert sorted(tiles.tolist()) == list(range(plan.T))


def test_allocate_shared():
    mesh = make_mesh(8)
    x = allocate_shared((64, 8), mesh=mesh)
    assert x.shape == (64, 8)
    assert float(x.sum()) == 0.0


def test_dp_multi_rhs_sharding(rng):
    """RHS-axis data parallelism (SURVEY §2.2 DP row): panel columns
    sharded over the mesh, zero collectives, matches single-device."""
    from tpu_sparse_lu.parallel.dp import make_dp_ldiv

    A = poisson_2d(10, 10)
    n = A.shape[0]
    F = ParallelSparseLU(A, chunk_size=8)
    mesh = make_mesh(8)
    solve = make_dp_ldiv(F, mesh)
    B = rng.random((n, 16))
    X = np.asarray(solve(B))
    X1 = np.asarray(F.ldiv(B))
    np.testing.assert_allclose(X, X1, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("engine", ["sharded", "dp", "pipeline"])
@pytest.mark.parametrize("how", ["device", "host"])
def test_mesh_solver_follows_refactor(rng, engine, how):
    """A mesh solver built once keeps solving the CURRENT matrix after
    each refactorization (the time-stepper pattern: build the mesh
    solver once, refactor every step)."""
    from tpu_sparse_lu.parallel.dp import make_dp_ldiv
    from tpu_sparse_lu.parallel.pipeline_solve import make_pipeline_ldiv

    A = laplacian_1d(96)
    F = ParallelSparseLU(A, chunk_size=8)
    mesh = make_mesh(4)
    solve = {"sharded": make_sharded_ldiv, "dp": make_dp_ldiv,
             "pipeline": make_pipeline_ldiv}[engine](F, mesh)
    assert solve is not None
    B = rng.random((96, 4))
    np.testing.assert_allclose(np.asarray(solve(B)), np.asarray(F.ldiv(B)),
                               rtol=1e-13, atol=1e-13)
    for _ in range(2):
        if how == "device":
            A2 = A.copy()
            A2.data = A2.data * (
                1.0 + 0.05 * rng.standard_normal(A2.data.shape))
            F.refactor_numeric(A2)
        else:
            # a heavier diagonal keeps SuperLU's pivots, hence the pattern
            A2 = (A + sp.diags(0.5 * rng.random(96))).tocsc()
            F.refactor(A2)
        X = np.asarray(solve(B))
        np.testing.assert_allclose(X, np.asarray(F.ldiv(B)),
                                   rtol=1e-13, atol=1e-13)
        for j in range(4):
            assert_isapprox(X[:, j], spla.spsolve(A2.tocsc(), B[:, j]),
                            rtol=1e-9, atol=1e-9)


def test_mesh_solver_refuses_changed_pattern(rng):
    """A host refactorization that changes the pattern replaces the plan
    the mesh solver baked in: the old solver refuses loudly."""
    A =laplacian_1d(64)
    F = ParallelSparseLU(A, chunk_size=8)
    solve = make_sharded_ldiv(F, make_mesh(2))
    b = rng.random(64)
    solve(b)
    F.refactor(A + sp.diags([0.1 * np.ones(62)], [2], shape=A.shape))
    with pytest.raises(RuntimeError, match="pattern changed"):
        solve(b)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_ldiv_nd_ordering(rng, ndev):
    """ordering="nd" composes with the mesh engine: the rectangular perm
    plans bridge input space and the extended factor space (VERDICT r1 #3)."""
    A = poisson_2d(12, 10)
    n = A.shape[0]
    F = ParallelSparseLU(
        A, config=SolverConfig(chunk_size=8, ordering="nd")
    )
    assert F.n_factor > F.n
    mesh = make_mesh(ndev)
    solve = make_sharded_ldiv(F, mesh)
    b = rng.random(n)
    x = np.asarray(solve(b))
    assert_isapprox(x, spla.spsolve(A, b), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        x, np.asarray(F.ldiv(b)), rtol=1e-13, atol=1e-13
    )


def test_pipeline_or_sharded_nd(rng):
    """The config-5 composition: nd ordering + distributed engines, with
    the pipeline engine falling back to the psum engine when the nd
    pattern's crossings exceed one device boundary."""
    from tpu_sparse_lu.models import block_banded
    from tpu_sparse_lu.parallel.pipeline_solve import make_pipeline_ldiv

    A = block_banded(rng, 24, 8)
    F = ParallelSparseLU(
        A, config=SolverConfig(chunk_size=8, ordering="nd")
    )
    mesh = make_mesh(4)
    solve = make_pipeline_ldiv(F, mesh) or make_sharded_ldiv(F, mesh)
    b = rng.random((A.shape[0], 3))
    X = np.asarray(solve(b))
    for j in range(3):
        assert_isapprox(X[:, j], spla.spsolve(A.tocsc(), b[:, j]),
                        rtol=1e-9, atol=1e-9)


def test_sharded_output_partitioned(rng):
    """shard_output=True returns the solution partitioned over the mesh
    axis (contiguous row blocks, zero-padded past n) — VERDICT r2 #5."""
    A = poisson_2d(12, 10)
    n = A.shape[0]
    F = ParallelSparseLU(A, chunk_size=8)
    mesh = make_mesh(4)
    solve = make_sharded_ldiv(F, mesh, shard_output=True)
    b = rng.random((n, 3))
    xs = solve(b)
    assert xs.shape[0] % 4 == 0 and xs.shape[0] >= n
    assert xs.sharding.spec[0] is not None  # rows actually partitioned
    got = np.asarray(xs)
    np.testing.assert_allclose(
        got[:n], np.asarray(F.ldiv(b)), rtol=1e-12, atol=1e-12
    )
    np.testing.assert_allclose(got[n:], 0.0)
