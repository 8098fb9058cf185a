"""Port of the reference test suite (SURVEY.md §4).

Six testsets mirroring /root/reference/test/runtests.jl:
  1/2. lsolve dense/sparse — forward engine alone vs scipy L \\ b
  3/4. rsolve dense/sparse — backward engine alone vs scipy U \\ b
  5/6. full ldiv dense/sparse — lifecycle: solve → new RHS same
       factorization → refactor with new values → solve → new RHS again
       (runtests.jl:108-188)

Tolerances: 1e-12 sparse-structured, 1e-10 dense-random
(runtests.jl:25-26). Ground truth is scipy's trusted solvers, never
hand-coded values — the reference's property-testing style.

The reference sweeps n in 1:200; we sweep a representative subset
(including every boundary case: n=1, n<cs, n=cs, n=cs±1, non-divisible n)
to keep JIT time sane, plus all three tri_modes and both schedules.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from _approx import assert_isapprox
from tpu_sparse_lu import ParallelSparseLU, SolverConfig
from tpu_sparse_lu.models import (
    dense_random,
    fe_block_matrix,
    laplacian_1d,
    poisson_2d,
)

TOL = 1e-12       # sparse tolerance (runtests.jl:25)
DENSE_TOL = 1e-10  # dense tolerance (runtests.jl:26)

DENSE_SIZES = [1, 2, 3, 7, 8, 9, 20, 33, 64, 100, 129]
# n = 4*nel + 1 with ngrid=5 → up to 801, matching the reference's
# nelement sweep ceiling (runtests.jl:39,56: nelement ∈ 1:200)
FE_SIZES = [1, 2, 5, 16, 50, 100, 200]


def _spsolve_lower(L, b):
    return spla.spsolve_triangular(sp.csr_matrix(L), b, lower=True)


def _spsolve_upper(U, b):
    return spla.spsolve_triangular(sp.csr_matrix(U), b, lower=False)


# ---------------------------------------------------------------------------
# Testsets 1-6, combined per matrix instance: lsolve and rsolve against the
# scipy triangular solves (runtests.jl testsets 1-4), then the full ldiv
# lifecycle (testsets 5-6, runtests.jl:108-188). One factorization serves
# all engine checks, which keeps the jit-compile count down.
# ---------------------------------------------------------------------------


def _engines_and_lifecycle(rng, make_matrix, tol, **f_kwargs):
    A = make_matrix()
    n = A.shape[0]
    F = ParallelSparseLU(A, **f_kwargs)
    b = rng.random(n)

    # lsolve / rsolve engines in isolation (runtests.jl:38-106)
    assert_isapprox(np.asarray(F.lsolve(b)), _spsolve_lower(F.L, b),
                    rtol=tol, atol=tol)
    assert_isapprox(np.asarray(F.rsolve(b)), _spsolve_upper(F.U, b),
                    rtol=tol, atol=tol)

    # full solve
    x = np.asarray(F.ldiv(b))
    assert_isapprox(x, spla.spsolve(A, b), rtol=tol, atol=tol)

    # new RHS, same factorization (runtests.jl:123-126)
    b2 = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b2)), spla.spsolve(A, b2),
                    rtol=tol, atol=tol)

    # new matrix values, refactorize in place (runtests.jl:129-131)
    A2 = make_matrix()
    F.refactor(A2)
    b3 = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b3)), spla.spsolve(A2, b3),
                    rtol=tol, atol=tol)

    # new RHS again (runtests.jl:141-144)
    b4 = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b4)), spla.spsolve(A2, b4),
                    rtol=tol, atol=tol)


@pytest.mark.parametrize("n", DENSE_SIZES)
def test_dense(rng, n):
    _engines_and_lifecycle(rng, lambda: dense_random(rng, n), DENSE_TOL)


@pytest.mark.parametrize("nel", FE_SIZES)
def test_sparse(rng, nel):
    _engines_and_lifecycle(rng, lambda: fe_block_matrix(rng, nel, 5), TOL)


# ---------------------------------------------------------------------------
# config matrix: tri modes, schedules, chunk sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tri_mode", ["trsm", "inv", "inv_refine"])
@pytest.mark.parametrize("schedule", ["scan", "unrolled"])
def test_modes_and_schedules(rng, tri_mode, schedule):
    A = fe_block_matrix(rng, 12, 5)
    n = A.shape[0]
    cfg = SolverConfig(chunk_size=8, tri_mode=tri_mode, schedule=schedule)
    F = ParallelSparseLU(A, config=cfg)
    b = rng.random(n)
    x = np.asarray(F.ldiv(b))
    tol = TOL if tri_mode != "inv" else 1e-9  # plain inverses lose a few digits
    assert_isapprox(x, spla.spsolve(A, b), rtol=tol, atol=tol)


@pytest.mark.parametrize("cs", [1, 2, 5, 8, 16, 200])
def test_chunk_sizes(rng, cs):
    """The reference never tests chunk_size != 8 (SURVEY.md §4 gap) — we do,
    including cs=1 and cs > n (clamped, src:72)."""
    A = fe_block_matrix(rng, 10, 5)
    n = A.shape[0]
    F = ParallelSparseLU(A, chunk_size=cs)
    assert F.chunk_size == min(cs, n)
    b = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A, b), rtol=TOL, atol=TOL)


def test_multi_rhs(rng):
    """SpSM: (n, R) panel solve (BASELINE config 3) vs column-by-column."""
    A = fe_block_matrix(rng, 15, 5)
    n = A.shape[0]
    F = ParallelSparseLU(A)
    B = rng.random((n, 7))
    X = np.asarray(F.ldiv(B))
    for j in range(7):
        assert_isapprox(X[:, j], spla.spsolve(A, B[:, j]), rtol=TOL, atol=TOL)


def test_dimension_mismatch(rng):
    A = fe_block_matrix(rng, 4, 5)
    F = ParallelSparseLU(A)
    with pytest.raises(ValueError):
        F.ldiv(np.ones(A.shape[0] + 1))


def test_determinism(rng):
    """Same input → bitwise-identical output (SURVEY.md §5.2)."""
    A = fe_block_matrix(rng, 10, 5)
    F = ParallelSparseLU(A)
    b = rng.random(A.shape[0])
    x1 = np.asarray(F.ldiv(b))
    x2 = np.asarray(F.ldiv(b))
    assert np.array_equal(x1, x2)


def test_nd_ordering_lifecycle(rng):
    """ordering="nd": solve, host refactor, device refactor, fused step —
    all against scipy ground truth."""
    from tpu_sparse_lu.models import poisson_2d

    A = poisson_2d(20, 20)
    n = A.shape[0]
    F = ParallelSparseLU(A, config=SolverConfig(chunk_size=16, ordering="nd"))
    assert F.n == n and F.n_factor >= n
    b = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A, b),
                    rtol=1e-10, atol=1e-10)
    A2 = A.copy()
    A2.data = A2.data * (1 + 0.05 * rng.standard_normal(A2.data.shape))
    F.refactor(A2)
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A2, b),
                    rtol=1e-10, atol=1e-10)
    A3 = A.copy()
    A3.data = A3.data * (1 + 0.05 * rng.standard_normal(A3.data.shape))
    F.refactor_numeric(A3)
    assert_isapprox(np.asarray(F.ldiv(b, refine_steps=1)),
                    spla.spsolve(A3, b), rtol=1e-10, atol=1e-10)
    step = F.make_refactor_solve_step()
    x = np.asarray(step(A3.data, b[:, None]))
    assert_isapprox(x[:, 0], spla.spsolve(A3, b), rtol=1e-8, atol=1e-8)


def test_matvec_tile_spmv(rng):
    """matvec == A @ x via the block-tile SpMV (ops/spmv.py), including
    after a device refactorization (lazy tile refresh)."""
    from tpu_sparse_lu.models import poisson_2d

    A = poisson_2d(13, 11)
    n = A.shape[0]
    F = ParallelSparseLU(A, chunk_size=8)
    x = rng.random((n, 3))
    np.testing.assert_allclose(np.asarray(F.matvec(x)), A @ x,
                               rtol=1e-12, atol=1e-12)
    # 1-D input
    v = rng.random(n)
    np.testing.assert_allclose(np.asarray(F.matvec(v)), A @ v,
                               rtol=1e-12, atol=1e-12)
    # after device refactor, matvec must see the NEW values
    A2 = A.copy()
    A2.data = A2.data * (1 + 0.1 * rng.standard_normal(A2.data.shape))
    F.refactor_numeric(A2)
    np.testing.assert_allclose(np.asarray(F.matvec(v)), A2 @ v,
                               rtol=1e-12, atol=1e-12)


def test_refactor_pattern_change_reallocates(rng):
    """The reference's reallocate branch (src:265-273): refactor() with a
    DIFFERENT sparsity pattern must re-plan, re-allocate and solve right.
    (Reference test gap closed — its test_matrix keeps the pattern.)"""
    A = fe_block_matrix(rng, 10, 5)
    n = A.shape[0]
    F = ParallelSparseLU(A, chunk_size=8)
    old_sig = F._factors.pattern_signature()
    # densify a band: new nonzeros → new L/U pattern
    A2 = (A + sp.diags([np.full(n - 3, 0.7)], [3], format="csc")).tocsc()
    assert A2.nnz != A.nnz
    F.refactor(A2)
    assert F._factors.pattern_signature() != old_sig
    b = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A2, b),
                    rtol=TOL, atol=TOL)
    # and back to a pattern-PRESERVING refactor on the new pattern
    A3 = A2.copy()
    A3.data = A3.data * (1 + 0.05 * rng.standard_normal(A3.data.shape))
    F.refactor(A3)
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A3, b),
                    rtol=TOL, atol=TOL)


def test_refactor_none_repacks(rng):
    """``lu!(F, nothing)`` parity (reference src:246): refactor(None) is a
    legal no-op re-pack and the factorization still solves."""
    A = fe_block_matrix(rng, 8, 5)
    n = A.shape[0]
    F = ParallelSparseLU(A, chunk_size=8)
    b = rng.random(n)
    x0 = np.asarray(F.ldiv(b))
    F.refactor(None)
    x1 = np.asarray(F.ldiv(b))
    np.testing.assert_allclose(x1, x0, rtol=1e-14, atol=1e-14)
    assert_isapprox(x1, spla.spsolve(A, b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    "n",
    list(range(1, 65))
    + [71, 81, 89, 97, 104, 113, 120, 128, 129, 137, 144, 152, 160,
       168, 176, 184, 192, 200],
)
def test_dense_n_sweep(rng, n):
    """Dense sweep toward the reference's 1:200 (runtests.jl:29): every
    n in 1..64 hits all chunk-boundary alignments at cs=8 twice over,
    plus spot checks at every ~8 up to n=200. Runs the FULL lifecycle at
    every n, matching the reference's per-n testset body
    (runtests.jl:108-146; VERDICT r3 #9, r4 #9): solve → new RHS, same
    factorization → refactor with new values → solve → new RHS again."""
    A = dense_random(rng, n)
    F = ParallelSparseLU(A, chunk_size=8)
    b = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A, b),
                    rtol=DENSE_TOL, atol=DENSE_TOL)
    # new RHS, same factorization (runtests.jl:123-126)
    b2 = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b2)), spla.spsolve(A, b2),
                    rtol=DENSE_TOL, atol=DENSE_TOL)
    # new values, same pattern: refactor in place (runtests.jl:129-131)
    A2 = A.copy()
    A2.data = A2.data + 0.1 * rng.random(A2.nnz)
    F.refactor(A2)
    assert_isapprox(np.asarray(F.ldiv(b2)), spla.spsolve(A2, b2),
                    rtol=DENSE_TOL, atol=DENSE_TOL)
    # and a fresh RHS on the refactored system (runtests.jl:141-144)
    b3 = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b3)), spla.spsolve(A2, b3),
                    rtol=DENSE_TOL, atol=DENSE_TOL)


@pytest.mark.parametrize("family", ["laplace1d", "banded", "spsm", "poisson", "block"])
def test_fp32_refine_accuracy_matrix(rng, family):
    """fp32 + tri_mode='inv' + one refinement sweep on all five BASELINE
    bench families: normwise backward error must reach fp32 machine-level
    (the accuracy story behind the bench numbers; VERDICT r1 #6)."""
    from tpu_sparse_lu.models import (
        block_banded, laplacian_1d, poisson_2d, random_sparse)

    A = {
        "laplace1d": lambda: laplacian_1d(400),
        "banded": lambda: block_banded(rng, 16, 8),
        "spsm": lambda: random_sparse(rng, 256, density=0.02),
        "poisson": lambda: poisson_2d(14, 14),
        "block": lambda: block_banded(rng, 12, 10),
    }[family]()
    n = A.shape[0]
    F = ParallelSparseLU(
        A, config=SolverConfig(chunk_size=16, tri_mode="inv",
                               dtype="float32"),
    )
    B = rng.random((n, 4)).astype(np.float32)
    X = np.asarray(F.ldiv(B, refine_steps=1), dtype=np.float64)
    An = spla.norm(A)
    for j in range(4):
        r = np.linalg.norm(A @ X[:, j] - B[:, j]) / (
            An * np.linalg.norm(X[:, j]) + np.linalg.norm(B[:, j]))
        assert r < 5e-6, f"{family}: backward error {r}"


def test_nd_cutoff_auto(rng):
    """nd_cutoff="auto" sweeps subdomain sizes under the byte cost model
    and still solves correctly; the chosen cutoff is one of the
    candidates and never costs more (by the model) than the default."""
    import scipy.sparse.linalg as spla

    from tpu_sparse_lu import ParallelSparseLU, SolverConfig
    from tpu_sparse_lu.models import poisson_2d

    A = poisson_2d(24, 20)
    cs = 16
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=cs, tri_mode="inv", dtype="float32",
        ordering="nd", nd_cutoff="auto"))
    assert F._nd_cutoff in (cs, 2 * cs, 4 * cs)
    b = rng.random(A.shape[0])
    x = np.asarray(F.ldiv(b, refine_steps=1))
    xe = spla.spsolve(A.tocsc(), b)
    np.testing.assert_allclose(x, xe, rtol=1e-4, atol=1e-5)
    # model score of the pick <= score of the plain default
    Fd = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=cs, tri_mode="inv", dtype="float32", ordering="nd"))
    def score(FF):
        lp, up = FF.plan.lplan, FF.plan.uplan
        return (89 * (lp.K + up.K + lp.T + up.T + 2)
                + 20 * (lp.num_levels + up.num_levels))
    assert score(F) <= score(Fd)


@pytest.mark.parametrize("family", ["fe", "poisson", "banded", "spsm"])
def test_f64_mixed_tier_meets_1e12_bar(rng, family):
    """Mixed-precision f64 tier (VERDICT r3 #1): f32 direct solve +
    float64-residual refinement must reach the reference's sparse
    accuracy bar (1e-12 rel, runtests.jl:25) — the reference's numeric
    regime is f64 end-to-end (UMFPACK, src:74)."""
    from tpu_sparse_lu.models import block_banded, poisson_2d, random_sparse

    A = {
        "fe": lambda: fe_block_matrix(rng, 40, 5),
        "poisson": lambda: poisson_2d(14, 14),
        "banded": lambda: block_banded(rng, 16, 8),
        "spsm": lambda: random_sparse(rng, 256, density=0.02),
    }[family]()
    n = A.shape[0]
    F = ParallelSparseLU(
        A, config=SolverConfig(chunk_size=16, tri_mode="inv",
                               dtype="float32"),
    )
    solve = F.make_f64_ldiv(refine_steps=2)
    B = rng.random((n, 3))
    X = np.asarray(solve(B))
    assert X.dtype == np.float64
    Xe = spla.spsolve(A.tocsc(), B)
    rel = np.linalg.norm(X - Xe) / np.linalg.norm(Xe)
    assert rel < TOL, f"{family}: rel err {rel} misses the 1e-12 bar"
    # single-vector call squeezes like ldiv
    b = rng.random(n)
    x = np.asarray(solve(b))
    assert x.shape == (n,)
    assert_isapprox(x, spla.spsolve(A.tocsc(), b), rtol=TOL, atol=TOL)


def test_f64_mixed_tier_guards(rng):
    """make_f64_ldiv refuses a non-f32 factorization and wrong-size b."""
    A = fe_block_matrix(rng, 5, 5)
    F64 = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=8, tri_mode="inv", dtype="float64"))
    with pytest.raises(ValueError, match="f32 factorization"):
        F64.make_f64_ldiv()
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=8, tri_mode="inv", dtype="float32"))
    solve = F.make_f64_ldiv(refine_steps=1)
    with pytest.raises(ValueError, match="same size"):
        solve(np.ones(A.shape[0] + 1))


# ---------------------------------------------------------------------------
# The XLA level engine (the one GPU solve path) against scipy, on the
# cases the removed fused-kernel tests covered: float32 tile modes at the
# chunk sizes and RHS widths the benchmarks use.
# ---------------------------------------------------------------------------


def _xla_engine_check(A, R, rng, *, tol=2e-4, **cfg):
    n = A.shape[0]
    cfg.setdefault("tri_mode", "inv")
    F = ParallelSparseLU(A, config=SolverConfig(dtype="float32", **cfg))
    b = rng.random((n, R)).astype(np.float32)
    got = np.asarray(F.ldiv(b), dtype=np.float64)
    want = spla.spsolve(sp.csc_matrix(A), b.astype(np.float64))
    want = np.asarray(want).reshape(n, R)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)
    return F


@pytest.mark.parametrize("make", [
    lambda rng: poisson_2d(10, 8),
    lambda rng: laplacian_1d(50),
    lambda rng: fe_block_matrix(rng, 10, 5),
], ids=["poisson", "chain", "fe"])
@pytest.mark.parametrize("R", [1, 4])
def test_xla_engine_matches_scipy(rng, make, R):
    _xla_engine_check(make(rng), R, rng, chunk_size=8)


def test_xla_engine_nd_embedding(rng):
    """Rectangular permutation maps (input space != factor space) through
    the nested-dissection embedding."""
    F = _xla_engine_check(poisson_2d(12, 12), 3, rng, chunk_size=16,
                          ordering="nd")
    assert F.n_factor > F.n  # the embedding actually extended


def test_xla_engine_wide_panel(rng):
    """A 64-wide RHS panel through the nd solve at the benchmark's
    cutoff ratio (nd_cutoff = 4 chunks)."""
    _xla_engine_check(poisson_2d(16, 16), 64, rng, chunk_size=16,
                      ordering="nd", nd_cutoff=64)


def test_xla_engine_fuzz(rng):
    """Property fuzz across sizes, chunk sizes, RHS widths, tile modes and
    scrambled pivots (reference-style randomized sweep, runtests.jl:31-34):
    ragged tails, non-divisible n."""
    from tpu_sparse_lu.models import random_sparse

    cases = 0
    for _ in range(12):
        n = int(rng.integers(17, 90))
        cs = int(rng.choice([4, 8, 16]))
        R = int(rng.choice([1, 3, 8]))
        mode = str(rng.choice(["trsm", "inv", "inv_refine"]))
        A = sp.csc_matrix(random_sparse(rng, n, density=0.08)
                          + sp.eye(n) * 3.0)
        try:
            _xla_engine_check(A, R, rng, chunk_size=cs, tri_mode=mode)
        except RuntimeError:
            continue  # singular draw
        cases += 1
    assert cases >= 8  # the sweep must mostly run, not skip


@pytest.mark.parametrize("n,n_in,cs", [(50, 50, 8), (64, 40, 16), (30, 70, 8)])
def test_perm_plan_gather(rng, n, n_in, cs):
    """The ldiv row permutation (ops/permute.py) on blocked carriers:
    square and rectangular maps, -1 rows (the nd embedding's padding) and
    padded lanes read zero, and the result's dummy chunk is zero."""
    import jax.numpy as jnp

    from tpu_sparse_lu.ops.permute import apply_perm, build_perm_plan
    from tpu_sparse_lu.solve import block_rhs

    perm = rng.integers(-1, n_in, n)
    plan = build_perm_plan(perm, n, cs, n_in=n_in)
    v = rng.random((n_in, 3))
    xw = block_rhs(jnp.asarray(v), n_in, plan.K_in, cs)
    xw = xw.at[-1].set(7.0)  # a dirty input dummy chunk must not leak
    out = np.asarray(apply_perm(plan, xw))
    assert out.shape == (plan.K + 1, cs, 3)
    flat = out.reshape(-1, 3)
    want = np.where(perm[:, None] >= 0, v[np.maximum(perm, 0)], 0.0)
    np.testing.assert_array_equal(flat[:n], want)
    assert not flat[n:].any()
