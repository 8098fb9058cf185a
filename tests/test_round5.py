"""Round-5 features: the backend policy behind tri_mode="auto", the
make_f64_ldiv generation guard, factorize="device" (first factorization
on device), and host-factor materialization after device
refactorizations.

Reference anchors: default-constructor parity (src:64-72), the
UMFPACK construct-time dependency being replaced (src:74), the factor
identity ``L @ U == (Rs .* A)[p, q]`` (src:292-316), and ``lu!`` keeping
solves correct after refactorization (src:245-279).
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from _approx import assert_isapprox
from tpu_sparse_lu import ParallelSparseLU, SolverConfig
from tpu_sparse_lu.models import fe_block_matrix, poisson_2d
from tpu_sparse_lu.utils.config import backend_policy, default_chunk_size


# ---------------------------------------------------------------------------
# backend policy: tri_mode="auto", chunk size, schedule, kernel choice
# ---------------------------------------------------------------------------


def test_tri_mode_auto_resolution(rng):
    """"auto" resolves to exact trsm on both supported backends; explicit
    modes pass through the constructor unchanged."""
    assert backend_policy("cpu").tri_mode == "trsm"
    assert backend_policy("gpu").tri_mode == "trsm"
    A = fe_block_matrix(rng, 4, 4)
    for m in ("trsm", "inv", "inv_refine"):
        F = ParallelSparseLU(A, config=SolverConfig(chunk_size=8,
                                                    tri_mode=m))
        assert F.config.tri_mode == m


def test_default_chunk_size_backend(rng, monkeypatch):
    """The size-based chunk policy, clamped to n (reference src:67-72),
    is what the solver picks on either backend."""
    assert default_chunk_size(100) == 8
    assert default_chunk_size(1000) == 32
    assert default_chunk_size(10_000) == 64
    assert default_chunk_size(5) == 5
    A = fe_block_matrix(rng, 4, 4)
    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        F = ParallelSparseLU(A)
        assert F.chunk_size == default_chunk_size(A.shape[0])


@pytest.mark.parametrize("backend,scan_only,tile_lu", [
    ("gpu", True, True),
    ("cpu", False, False),
])
def test_backend_policy(backend, scan_only, tile_lu):
    """One resolver decides every backend-dependent choice."""
    pol = backend_policy(backend)
    assert pol.backend == backend
    assert pol.scan_only is scan_only
    assert pol.tile_lu_kernel is tile_lu
    # the tile-LU kernel takes power-of-two edges up to 128, f32 and f64
    assert pol.use_tile_lu(128, np.float32) is tile_lu
    assert pol.use_tile_lu(64, np.float64) is tile_lu
    assert not pol.use_tile_lu(96, np.float32)
    assert not pol.use_tile_lu(256, np.float32)
    assert not pol.use_tile_lu(128, np.float16)


def test_backend_policy_unknown_backend_raises():
    with pytest.raises(ValueError, match="unsupported JAX backend"):
        backend_policy("rocm")
    with pytest.raises(ValueError, match="unsupported JAX backend"):
        backend_policy("metal")


def test_default_config_resolves_concrete_mode(rng):
    """The stored config always carries a concrete tri_mode after
    construction (on this CPU suite: trsm), and solves at the reference
    bar with no boilerplate — default-constructor parity (src:64-72)."""
    A = fe_block_matrix(rng, 10, 5)
    F = ParallelSparseLU(A)
    assert F.config.tri_mode == "trsm"  # CPU backend under conftest
    b = rng.random(A.shape[0])
    assert_isapprox(np.asarray(F.ldiv(b)), spla.spsolve(A, b),
                    rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# make_f64_ldiv generation guard (VERDICT r4 #6)
# ---------------------------------------------------------------------------


def test_f64_ldiv_stale_after_refactor(rng):
    """make_f64_ldiv -> refactor -> call raises; the silent-stale
    failure mode is the one a solver API must never have."""
    A = fe_block_matrix(rng, 5, 5)
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=8, tri_mode="inv", dtype="float32"))
    solve = F.make_f64_ldiv(refine_steps=1)
    b = rng.random(A.shape[0])
    x = np.asarray(solve(b))  # works before the refactorization
    assert_isapprox(x, spla.spsolve(A.tocsc(), b), rtol=1e-10, atol=1e-10)
    A2 = A.copy()
    A2.data = A2.data * 1.05
    F.refactor(A2)
    with pytest.raises(RuntimeError, match="stale make_f64_ldiv"):
        solve(b)
    # a fresh callable serves the new values
    solve2 = F.make_f64_ldiv(refine_steps=1)
    assert_isapprox(np.asarray(solve2(b)), spla.spsolve(A2.tocsc(), b),
                    rtol=1e-10, atol=1e-10)


def test_f64_ldiv_stale_after_refactor_none(rng):
    """Even the re-pack path (refactor(None), reference src:246) bumps
    the generation: the baked streams were rebuilt."""
    A = fe_block_matrix(rng, 5, 5)
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=8, tri_mode="inv", dtype="float32"))
    solve = F.make_f64_ldiv(refine_steps=1)
    solve(rng.random(A.shape[0]))
    F.refactor(None)
    with pytest.raises(RuntimeError, match="stale make_f64_ldiv"):
        solve(rng.random(A.shape[0]))


# ---------------------------------------------------------------------------
# factorize="device" — first factorization on device (VERDICT r4 #3)
# ---------------------------------------------------------------------------


def test_factorize_device_requires_static_pivots(rng):
    A = fe_block_matrix(rng, 10, 5)
    with pytest.raises(ValueError, match="static-diagonal-pivot"):
        ParallelSparseLU(A, config=SolverConfig(
            chunk_size=8, factorize="device"))


def test_factorize_auto_resolution(rng):
    """"auto" picks "device" exactly when the ordering freezes diagonal
    pivots (pattern-only pivot order), else "host"."""
    A = poisson_2d(10, 10)
    F_nd = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, ordering="nd", factorize="auto"))
    assert F_nd.config.factorize == "device"
    F_co = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, factorize="auto"))
    assert F_co.config.factorize == "host"


def test_factorize_device_lifecycle(rng):
    """Construct WITHOUT SuperLU (pattern-only host work + one device
    elimination, replacing the reference's construct-time lu(A),
    src:74), then the full reference lifecycle: solve -> new RHS ->
    device refactor with new values -> solve."""
    A = poisson_2d(20, 20)
    n = A.shape[0]
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, ordering="nd", factorize="device"))
    assert F.config.factorize == "device"
    assert F.has_device_refactor  # the construct built/ran the pipeline
    b = rng.random(n)
    xe = spla.spsolve(A.tocsc(), b)
    x = np.asarray(F.ldiv(b, refine_steps=1))
    assert_isapprox(x, xe, rtol=1e-9, atol=1e-9)
    # new RHS, same factorization
    b2 = rng.random(n)
    assert_isapprox(np.asarray(F.ldiv(b2, refine_steps=1)),
                    spla.spsolve(A.tocsc(), b2), rtol=1e-9, atol=1e-9)
    # value change, device refactorization (same pattern)
    A2 = A.copy()
    A2.data = A2.data * (1 + 0.05 * rng.standard_normal(A2.data.shape))
    F.refactor_numeric(A2)
    assert_isapprox(np.asarray(F.ldiv(b, refine_steps=1)),
                    spla.spsolve(A2.tocsc(), b), rtol=1e-9, atol=1e-9)


def test_factorize_device_factor_identity(rng):
    """The materialized factors satisfy the reference identity
    ``L @ U == (Rs .* A)[p, q]`` (src:292-316) even though no host
    factorization ever ran."""
    A = poisson_2d(12, 12)
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, ordering="nd", factorize="device"))
    L, U = F.L, F.U  # lazy materialization from the device tiles
    nf = F.n_factor
    # under nd the factored matrix is the chunk-aligned extension
    indptr, indices = F._a_factor_pattern
    Af = sp.csc_matrix(
        (F._ext_values(sp.csc_matrix(A)), indices, indptr), shape=(nf, nf)
    )
    B = (sp.diags(np.asarray(F.Rs)) @ Af)[F.p][:, F.q]
    err = abs(L @ U - B).max()
    assert err < 1e-5  # f32 elimination
    # L carries an explicit unit diagonal (reference convention)
    assert np.allclose(L.diagonal(), 1.0)


def test_materialized_LU_after_refactor_numeric(rng):
    """F.L/F.U refresh lazily after a device refactorization (the host
    csc values would otherwise be stale — worse than the reference,
    which updates its factors in place on every lu!, src:261-276)."""
    A = poisson_2d(14, 14)
    F = ParallelSparseLU(A, config=SolverConfig(chunk_size=16,
                                                ordering="nd"))
    A2 = A.copy()
    A2.data = A2.data * (1 + 0.1 * rng.standard_normal(A2.data.shape))
    F.refactor_numeric(A2)
    L, U = F.L, F.U
    nf = F.n_factor
    indptr, indices = F._a_factor_pattern
    Af = sp.csc_matrix(
        (F._ext_values(sp.csc_matrix(A2)), indices, indptr), shape=(nf, nf)
    )
    B = (sp.diags(np.asarray(F.Rs)) @ Af)[F.p][:, F.q]
    assert abs(L @ U - B).max() < 1e-5


def test_factorize_device_save_roundtrip(rng, tmp_path):
    """save() under factorize="device" defaults to the values-less light
    save (the solver has a device refactor schedule, so the load
    recomputes values from A's nonzeros — VERDICT r4 #8); from_saved
    solves at the same accuracy."""
    A = poisson_2d(12, 12)
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, ordering="nd", factorize="device"))
    b = rng.random(A.shape[0])
    x0 = np.asarray(F.ldiv(b, refine_steps=1))
    path = str(tmp_path / "state.npz")
    F.save(path)
    z = np.load(path)
    assert "light" in z.files and "L_data" not in z.files
    F2 = ParallelSparseLU.from_saved(A, path)
    x1 = np.asarray(F2.ldiv(b, refine_steps=1))
    assert_isapprox(x1, x0, rtol=1e-6, atol=1e-6)
    assert_isapprox(x1, spla.spsolve(A.tocsc(), b), rtol=1e-8, atol=1e-8)
    # values=True keeps the universally-loadable full save
    full = str(tmp_path / "full.npz")
    F.save(full, values=True)
    assert "L_data" in np.load(full).files
    x2 = np.asarray(ParallelSparseLU.from_saved(A, full).ldiv(
        b, refine_steps=1))
    assert_isapprox(x2, x0, rtol=1e-6, atol=1e-6)


def test_save_light_from_host_solver(rng, tmp_path):
    """values=False on a host-factorized solver builds the device
    schedule at save time; the reload never calls the host backend and
    recomputes the values via the device elimination. The light file
    drops the nnz(LU)-sized value arrays (the dominant bytes)."""
    A = poisson_2d(14, 14)
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, ordering="nd", dtype="float32", tri_mode="inv"))
    assert not F.has_device_refactor
    light = str(tmp_path / "light.npz")
    F.save(light, values=False)
    assert F.has_device_refactor  # built to serialize the schedule
    full = str(tmp_path / "full.npz")
    F.save(full, values=True)

    import tpu_sparse_lu.symbolic as sym
    calls = []
    orig = sym.factorize_host
    sym.factorize_host = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        G = ParallelSparseLU.from_saved(A, light)
    finally:
        sym.factorize_host = orig
    assert not calls, "light reload re-ran the host factorization backend"
    b = rng.random(A.shape[0])
    xe = spla.spsolve(A.tocsc(), b)
    assert_isapprox(np.asarray(G.ldiv(b, refine_steps=1), dtype=np.float64),
                    xe, rtol=1e-4, atol=1e-5)
    # the lifecycle continues after a light reload
    A2 = A.copy()
    A2.data = A2.data * (1 + 0.02 * rng.standard_normal(A2.data.shape))
    G.refactor_numeric(A2)
    assert_isapprox(np.asarray(G.ldiv(b, refine_steps=1), dtype=np.float64),
                    spla.spsolve(A2.tocsc(), b), rtol=1e-4, atol=1e-5)
    # on_value_change="error" still sanity-checks values in light mode
    with pytest.raises(ValueError, match="values differ"):
        ParallelSparseLU.from_saved(A2, light, on_value_change="error")
    # value change at load: the light reload factors A2 directly
    H = ParallelSparseLU.from_saved(A2, light)
    assert_isapprox(np.asarray(H.ldiv(b, refine_steps=1), dtype=np.float64),
                    spla.spsolve(A2.tocsc(), b), rtol=1e-4, atol=1e-5)


def test_light_save_preserves_config(rng, tmp_path):
    """The reload reconstructs the solver from the persisted config —
    tri mode, matmul precision, factorize mode, nd cutoff, chunk size all
    survive the light roundtrip (a dropped config field would silently
    rebuild the solver with defaults)."""
    A = poisson_2d(12, 12)
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, ordering="nd", factorize="device", tri_mode="inv",
        matmul_precision="high", nd_cutoff=32))
    path = str(tmp_path / "cfg.npz")
    F.save(path)
    assert "light" in np.load(path).files
    G = ParallelSparseLU.from_saved(A, path)
    assert G.config == F.config
    assert G.config.tri_mode == "inv"
    assert G.config.matmul_precision == "high"
    assert G.config.factorize == "device"
    assert G._nd_cutoff == F._nd_cutoff
    assert G.chunk_size == F.chunk_size


@pytest.mark.parametrize("light", [True, False])
def test_load_file_with_removed_fields(rng, tmp_path, light):
    """Files written before the fused-stream fields were removed carry
    ``stream_dtype`` / ``use_pallas`` in their config and, for light
    saves, span-gather arrays in the window plan: the loader ignores
    them. The old file is built here from a current save's dict."""
    import json

    A = poisson_2d(12, 12)
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, ordering="nd", dtype="float32", tri_mode="inv",
        factorize="device" if light else "host"))
    path = str(tmp_path / "new.npz")
    F.save(path)
    flat = dict(np.load(path))
    assert ("light" in flat) is light
    cfg = json.loads(bytes(flat["config_json"]).decode())
    cfg.update(stream_dtype="bfloat16", use_pallas="auto")
    flat["config_json"] = np.frombuffer(json.dumps(cfg).encode(),
                                        dtype=np.uint8)
    if light:
        for name in ("span_g", "span_lo", "span_hi", "span_left_src",
                     "span_left_row", "span_left_col"):
            flat[f"rpw_{name}"] = np.zeros(4, np.int32)
    old = str(tmp_path / "old.npz")
    np.savez(old, **flat)
    G = ParallelSparseLU.from_saved(A, old)
    assert G.config == F.config
    b = rng.random(A.shape[0])
    assert_isapprox(np.asarray(G.ldiv(b, refine_steps=1), dtype=np.float64),
                    spla.spsolve(A.tocsc(), b), rtol=1e-4, atol=1e-5)


def test_save_values_at_working_precision(rng, tmp_path):
    """Factor values persist at the solver dtype (f32 halves the file's
    dominant bytes, VERDICT r4 #8) and the reload still solves at the
    f32 accuracy tier."""
    A = fe_block_matrix(rng, 20, 5)
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, tri_mode="inv", dtype="float32"))
    path = str(tmp_path / "f32.npz")
    F.save(path)
    z = np.load(path)
    assert z["L_data"].dtype == np.float32
    assert z["U_data"].dtype == np.float32
    F2 = ParallelSparseLU.from_saved(A, path)
    b = rng.random(A.shape[0])
    x = np.asarray(F2.ldiv(b, refine_steps=1), dtype=np.float64)
    xe = spla.spsolve(A.tocsc(), b)
    assert np.linalg.norm(x - xe) / np.linalg.norm(xe) < 1e-5
    # f64 solvers keep full-precision values on disk
    F64 = ParallelSparseLU(A, chunk_size=16)
    p64 = str(tmp_path / "f64.npz")
    F64.save(p64)
    assert np.load(p64)["L_data"].dtype == np.float64
