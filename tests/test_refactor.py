"""Device-side same-pattern numeric refactorization tests.

The reference's ``lu!`` path (src:245-279) re-runs UMFPACK's numeric
phase; our static-pivot device path must reproduce the factor-then-solve
results within the reference tolerances for same-pattern value changes.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from _approx import assert_isapprox
from tpu_sparse_lu import ParallelSparseLU, SolverConfig
from tpu_sparse_lu.models import (
    block_banded,
    fe_block_matrix,
    laplacian_1d,
    poisson_2d,
)

TOL = 1e-12


def _perturb_values(rng, A, scale=0.3):
    """New values, same pattern (the reference lifecycle's lu! case when
    sparsity is unchanged, runtests.jl:129-131)."""
    A2 = A.copy()
    A2.data = A2.data * (1.0 + scale * rng.standard_normal(A2.data.shape))
    return A2


@pytest.mark.parametrize("cs", [4, 8, 16])
def test_refactor_numeric_banded(rng, cs):
    A = laplacian_1d(100)
    F = ParallelSparseLU(A, chunk_size=cs)
    A2 = _perturb_values(rng, A, scale=0.05)
    F.refactor_numeric(A2)
    b = rng.random(100)
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A2, b), rtol=TOL, atol=TOL)


def test_refactor_numeric_poisson(rng):
    A = poisson_2d(10, 8)
    F = ParallelSparseLU(A, chunk_size=8)
    A2 = _perturb_values(rng, A, scale=0.05)
    F.refactor_numeric(A2)
    n = A.shape[0]
    b = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A2, b), rtol=TOL, atol=TOL)


def test_refactor_numeric_block_banded(rng):
    A = block_banded(rng, 12, 6)
    F = ParallelSparseLU(A, chunk_size=8)
    A2 = _perturb_values(rng, A, scale=0.1)
    F.refactor_numeric(A2)
    n = A.shape[0]
    b = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A2, b), rtol=TOL, atol=TOL)


def test_refactor_numeric_identical_values_matches_host(rng):
    """Refactorizing with the SAME values must reproduce the host
    factorization's solve to full precision."""
    A = fe_block_matrix(rng, 10, 5)
    n = A.shape[0]
    b = rng.random(n)
    F = ParallelSparseLU(A, chunk_size=8)
    x_host = np.asarray(F.ldiv(b))
    F.refactor_numeric(A)
    x_dev = np.asarray(F.ldiv(b))
    assert_isapprox(x_dev, x_host, rtol=TOL, atol=TOL)


def test_refactor_numeric_repeated(rng):
    """Many refactor→solve cycles (the library's raison d'être,
    runtests.jl:108-188) stay accurate."""
    A = laplacian_1d(64)
    F = ParallelSparseLU(A, chunk_size=8)
    for _ in range(4):
        A = _perturb_values(rng, A, scale=0.02)
        F.refactor_numeric(A)
        b = rng.random(64)
        # one refinement step absorbs the static-pivot conditioning loss
        # (SURVEY.md §7 hard part 2)
        assert_isapprox(
            np.asarray(F.ldiv(b, refine_steps=1)),
            spla.spsolve(A, b), rtol=TOL, atol=TOL,
        )


def test_refactor_numeric_rejects_pattern_change(rng):
    A = laplacian_1d(32)
    F = ParallelSparseLU(A)
    A2 = A.tolil()
    A2[0, 31] = 1.0  # new nonzero → pattern change
    with pytest.raises(ValueError):
        F.refactor_numeric(A2.tocsc())


def test_refactor_numeric_then_host_refactor(rng):
    """Host refactor after device refactor resets the static schedule."""
    A = laplacian_1d(48)
    F = ParallelSparseLU(A, chunk_size=8)
    F.refactor_numeric(_perturb_values(rng, A, 0.05))
    assert F.has_device_refactor
    A3 = _perturb_values(rng, A, 0.5)
    F.refactor(A3)
    assert not F.has_device_refactor
    b = rng.random(48)
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A3, b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tri_mode", ["trsm", "inv_refine"])
def test_refactor_numeric_tri_modes(rng, tri_mode):
    A = poisson_2d(8, 8)
    F = ParallelSparseLU(A, config=SolverConfig(chunk_size=8, tri_mode=tri_mode))
    A2 = _perturb_values(rng, A, scale=0.05)
    F.refactor_numeric(A2)
    b = rng.random(A.shape[0])
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A2, b), rtol=TOL, atol=TOL)


def test_fused_refactor_solve_step(rng):
    """make_refactor_solve_step: one jitted program doing device
    refactorization + full ldiv, matching the two-call path."""
    A = poisson_2d(8, 8)
    n = A.shape[0]
    F = ParallelSparseLU(A, chunk_size=8)
    step = F.make_refactor_solve_step()
    A2 = _perturb_values(rng, A, scale=0.05)
    b = rng.random((n, 3))
    x = np.asarray(step(A2.data, b))
    for j in range(3):
        assert_isapprox(x[:, j], spla.spsolve(A2, b[:, j]), rtol=TOL, atol=TOL)
    # F's cached state untouched: plain ldiv still solves the ORIGINAL A
    b1 = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b1)), spla.spsolve(A, b1),
                    rtol=TOL, atol=TOL)


def test_refactor_diagnostics_benign(rng):
    """Benign value change: growth ~ 1, finite min pivot, device kept."""
    A = laplacian_1d(64)
    F = ParallelSparseLU(A, chunk_size=8)
    kept = F.refactor_numeric(_perturb_values(rng, A, 0.05), check=True)
    assert kept
    d = F.refactor_diagnostics
    assert np.isfinite(float(d["growth"]))
    assert float(d["min_pivot"]) > 0
    assert float(d["growth"]) < 100


def test_refactor_hostile_values_detected(rng):
    """Values that demand a different pivot order (VERDICT r1 #5): the
    frozen static pivots blow up; check=True detects it and falls back to
    the re-pivoting host path, keeping the solve accurate."""
    n = 32
    rng2 = np.random.default_rng(3)
    A = sp.csc_matrix(
        np.eye(n) * 4.0 + 0.5 * rng2.standard_normal((n, n))
    )
    F = ParallelSparseLU(A, chunk_size=8)
    # same pattern, but the leading diagonal entry collapses: the frozen
    # pivot divides by ~1e-14 of the row max -> astronomical growth
    A2 = A.copy().tolil()
    A2[0, 0] = 1e-13
    A2 = sp.csc_matrix(A2)
    assert A2.nnz == A.nnz  # pattern unchanged
    kept = F.refactor_numeric(A2, check=True)
    d = F.refactor_diagnostics
    assert (not np.isfinite(float(d["growth"]))) or float(d["growth"]) > 1e7
    assert not kept  # fell back to the host (re-pivoting) path
    b = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A2, b),
                    rtol=1e-9, atol=1e-9)


def test_fused_step_in_step_refinement(rng):
    """refine_steps inside make_refactor_solve_step matches the two-call
    path's refined accuracy (VERDICT r1 #7)."""
    A = poisson_2d(8, 8)
    n = A.shape[0]
    F = ParallelSparseLU(
        A, config=SolverConfig(chunk_size=8, tri_mode="inv", dtype="float32")
    )
    step0 = F.make_refactor_solve_step()
    step1 = F.make_refactor_solve_step(refine_steps=1)
    A2 = _perturb_values(rng, A, scale=0.05)
    b = rng.random((n, 2))
    x_exact = np.column_stack(
        [spla.spsolve(A2, b[:, j]) for j in range(2)]
    )
    e0 = np.linalg.norm(np.asarray(step0(A2.data, b)) - x_exact)
    e1 = np.linalg.norm(np.asarray(step1(A2.data, b)) - x_exact)
    # fp32: one refinement sweep must tighten the solution materially
    assert e1 <= e0
    assert e1 < 1e-4 * np.linalg.norm(x_exact)


def test_refactor_pivot_move_same_pattern_fused(rng):
    """Regression (round-2 VERDICT confirmed hazard): a NON-reallocating
    host refactor() that moves pivots under an identical L/U pattern
    signature must invalidate every cached ldiv executable and
    permutation plan.

    Dense matrices keep the L/U patterns full for ANY pivot order, so the
    signature never changes; the first matrix is diagonally dominant
    (identity row pivots), the second is generic (pivots cross the chunk
    boundary). A solve that kept the OLD permutation would misroute the
    NEW factors (observed residual ~0.8 when this was broken)."""
    rng2 = np.random.default_rng(3)
    n = 256
    A1 = sp.csc_matrix(np.eye(n) * 50.0 + rng2.random((n, n)))
    A2 = sp.csc_matrix(rng2.random((n, n)) + np.eye(n))
    cfg = SolverConfig(chunk_size=128, tri_mode="inv", dtype="float32")
    F = ParallelSparseLU(A1, config=cfg)
    sig = F._factors.pattern_signature()
    p1 = F.p.copy()
    b = rng.random((n, 4))
    x1 = np.asarray(F.ldiv(b))  # warm the jit cache with the OLD stream
    assert np.linalg.norm(A1 @ x1 - b) / np.linalg.norm(b) < 1e-3

    plan_before = F.plan
    F.refactor(A2)
    # the hazard's preconditions — if any of these drifts the test is no
    # longer covering the non-reallocating pivot-move path
    assert F._factors.pattern_signature() == sig
    assert F.plan is plan_before  # non-reallocating branch taken
    assert not np.array_equal(p1, F.p)  # pivots actually moved

    x2 = np.asarray(F.ldiv(b))
    r = np.linalg.norm(A2 @ x2 - b) / np.linalg.norm(b)
    assert r < 1e-3, f"stale ldiv closure: residual {r}"


def test_refactor_solve_step_stale_after_host_refactor(rng):
    """A fused refactor+solve step made before a host refactor() closes
    over the old static schedule; using it afterwards must raise, not
    silently misroute."""
    A = poisson_2d(8, 8)
    F = ParallelSparseLU(A, chunk_size=8)
    step = F.make_refactor_solve_step()
    b = rng.random((A.shape[0], 2))
    np.asarray(step(A.data, b))  # valid before
    F.refactor(_perturb_values(rng, A, 0.3))
    with pytest.raises(RuntimeError, match="stale"):
        step(A.data, b)
    # a fresh step works
    step2 = F.make_refactor_solve_step()
    np.asarray(step2(A.data, b))


@pytest.mark.parametrize(
    "make,cs",
    [
        (lambda rng: block_banded(rng, 12, 10), 16),
        (lambda rng: poisson_2d(20, 20), 32),
        (lambda rng: sp.random(300, 300, density=0.02, random_state=7,
                               format="csc") + 10 * sp.eye(300, format="csc"),
         32),
    ],
)
def test_windowed_assembly_matches_dense_reference(rng, make, cs):
    """assemble.py's windowed scatter + permutation gather must place
    every value of (Rs*A)[p, q] exactly where the flat per-element
    scatter used to (including run edges, collisions -> leftovers, and
    the identity pads), with Rs in original row order."""
    import jax.numpy as jnp

    from tpu_sparse_lu.assemble import assemble_windowed
    from tpu_sparse_lu.refactor import _tile_pattern_of_permuted, blocked_fill

    A = sp.csc_matrix(make(rng))
    F = ParallelSparseLU(A, config=SolverConfig(chunk_size=cs))
    F.enable_device_refactor()
    rp, w = F._refactor_plan, F._refactor_plan.win
    dev = F._refactor_dev
    n, K, TF = rp.n, rp.K, rp.TF

    a_data = jnp.asarray(A.data, dtype=jnp.float32)
    tiles, rs = assemble_windowed(
        a_data, dev, n=n, cs=cs, TF=TF, TF2=w.TF2, W=w.W, R1=w.R1, Np=w.Np
    )
    tiles, rs = np.asarray(tiles), np.asarray(rs)

    # dense reference: equilibrate rows of A, permute, pad identity tail
    Ad = A.toarray()
    rowmax = np.abs(Ad).max(axis=1)
    rs_ref = np.where(rowmax > 0, 1.0 / rowmax, 1.0)
    assert_isapprox(rs, rs_ref.astype(np.float32), rtol=1e-6, atol=1e-6)
    p, q = F._factors.p, F._factors.q
    B = (rs_ref[:, None] * Ad)[np.ix_(p, q)]
    Bp = np.zeros((K * cs, K * cs))
    Bp[:n, :n] = B
    np.fill_diagonal(Bp[n:, n:], 1.0)

    pattern, _, _, _, _ = _tile_pattern_of_permuted(
        sp.csc_matrix((np.ones(A.nnz), A.indices, A.indptr), shape=A.shape),
        p, q, cs)
    order = sorted(blocked_fill(pattern, K))
    for t, (bi, tj) in enumerate(order):
        ref = Bp[bi * cs:(bi + 1) * cs, tj * cs:(tj + 1) * cs]
        assert_isapprox(tiles[t], ref.astype(np.float32),
                        rtol=1e-6, atol=1e-6)
    assert_isapprox(tiles[TF], np.eye(cs, dtype=np.float32),
                    rtol=0, atol=0)
    assert not tiles[TF + 1].any()


def test_refactor_store_budget_guard(rng):
    """The HBM working-set guard refuses clearly and leaves the solver
    usable; the budget is configurable per call and per SolverConfig
    (VERDICT r2 #10)."""
    from tpu_sparse_lu import ParallelSparseLU, SolverConfig
    from tpu_sparse_lu.models import poisson_2d

    A = poisson_2d(12, 12)
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, tri_mode="inv", dtype="float32"))
    with pytest.raises(RuntimeError, match="working set"):
        F.enable_device_refactor(store_budget=1)
    assert not F.has_device_refactor
    b = rng.random(A.shape[0])
    x = np.asarray(F.ldiv(b))  # solver still intact after the refusal
    import scipy.sparse.linalg as spla
    np.testing.assert_allclose(x, spla.spsolve(A.tocsc(), b),
                               rtol=1e-4, atol=1e-5)
    # per-config budget: same refusal through SolverConfig
    F2 = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, tri_mode="inv", dtype="float32",
        refactor_store_budget=1))
    with pytest.raises(RuntimeError, match="working set"):
        F2.enable_device_refactor()
    # a sane budget still works
    F.enable_device_refactor(store_budget=8 * 1024**3)
    assert F.has_device_refactor
