"""The Triton tile-LU kernel (ops/pallas_factor.py) and the rule that no
kernel runs through the Pallas interpreter outside tests.

On the CPU the kernel runs in interpret mode: the same kernel body, traced
and executed by the Pallas interpreter. The compiled kernel is checked by
the ``gpu``-marked test here and by ``chip_smoke.py`` on the card.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_sparse_lu import ParallelSparseLU, SolverConfig
from tpu_sparse_lu.models import laplacian_1d, poisson_2d
from tpu_sparse_lu.ops import pallas_factor
from tpu_sparse_lu.ops.pallas_factor import lu_tile
from tpu_sparse_lu.refactor import _lu_nopivot

# max|L U - D| / max|D| for diagonally dominant tiles: a few hundred ulps
# of each dtype (cs-term dot products, error growth bounded by dominance)
_LU_BOUND = {np.float32: 1e-5, np.float64: 1e-13}


def _dominant_tiles(rng, batch, cs, dtype):
    D = rng.standard_normal((batch, cs, cs))
    D += cs * np.eye(cs)  # diagonally dominant: no-pivot LU is stable
    return D.astype(dtype)


def _check_lu(got, D, dtype):
    cs = D.shape[-1]
    got = np.asarray(got, dtype=np.float64)
    L = np.tril(got, -1) + np.eye(cs)
    U = np.triu(got)
    err = np.abs(L @ U - D).max() / np.abs(D).max()
    assert err <= _LU_BOUND[dtype], f"|LU - D| / |D| = {err:.2e}"


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cs", [16, 32, 64, 128])
def test_lu_tile_interpret_matches_reference(rng, cs, dtype, batch):
    """Interpret-mode kernel against the XLA rank-1 loop (_lu_nopivot) and
    a float64 NumPy reconstruction of every tile."""
    D = _dominant_tiles(rng, batch, cs, dtype)
    got = np.asarray(lu_tile(jnp.asarray(D), interpret=True))
    assert got.dtype == dtype and got.shape == D.shape
    want = np.asarray(_lu_nopivot(jnp.asarray(D)))
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)
    _check_lu(got, D.astype(np.float64), dtype)


@pytest.fixture
def gpu_device():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: SPARSE_LU_TESTS_ON_GPU=1 python -m "
                    "pytest tests -m gpu (chip_smoke.py runs the same check)")
    return jax.devices()[0]


@pytest.mark.gpu
def test_lu_tile_compiled_matches_reference(rng, gpu_device):
    """The kernel as Triton compiles it for the card, at the widths the
    device refactorization uses."""
    for cs in (64, 128):
        for dtype in (np.float32, np.float64):
            D = _dominant_tiles(rng, 5, cs, dtype)
            _check_lu(lu_tile(jnp.asarray(D)), D.astype(np.float64), dtype)


def test_no_interpret_outside_tests():
    """No library or entry-point source runs a kernel through the Pallas
    interpreter: interpret mode exists for the tests alone."""
    root = pathlib.Path(__file__).resolve().parents[1]
    files = list((root / "tpu_sparse_lu").rglob("*.py"))
    files += [root / "bench.py", root / "chip_smoke.py"]
    offenders = [str(f) for f in files
                 if f.exists() and "interpret=True" in f.read_text()]
    assert not offenders


def test_gpu_refactor_compiles_tile_lu_kernel(rng, monkeypatch):
    """With the backend reported as "gpu", the device refactorization
    routes its diagonal tiles through the tile-LU kernel, and never with
    interpret=True. The Pallas call itself is replaced by the XLA
    reference here (there is no card to compile for)."""
    calls = []

    def fake_pallas_call(kernel, **kw):
        calls.append(kw)
        return lambda D: _lu_nopivot(D)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(pallas_factor.pl, "pallas_call", fake_pallas_call)
    jax.clear_caches()
    try:
        A = poisson_2d(12, 12)
        F = ParallelSparseLU(A, config=SolverConfig(
            chunk_size=16, ordering="nd", dtype="float32",
            factorize="device"))
        assert F._tile_lu
    finally:
        jax.clear_caches()
    assert calls, "the refactorization never reached the tile-LU kernel"
    assert all(kw["interpret"] is False for kw in calls)
    assert all(kw["backend"] == "triton" for kw in calls)
    b = rng.random(A.shape[0])
    import scipy.sparse.linalg as spla

    x = np.asarray(F.ldiv(b, refine_steps=1), dtype=np.float64)
    np.testing.assert_allclose(x, spla.spsolve(A.tocsc(), b),
                               rtol=1e-4, atol=1e-5)


def test_gpu_single_rhs_chain_takes_associative_scan(rng, monkeypatch):
    """A 1-D chain's R = 1 solve on the GPU runs the lax.associative_scan
    substitution (ops/scan_solve.py), not a kernel."""
    from tpu_sparse_lu.ops import scan_solve

    seen = []
    orig = scan_solve.scan_bidiag_solve

    def spy(*a, **kw):
        seen.append(a[2].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(scan_solve, "scan_bidiag_solve", spy)
    A = laplacian_1d(300)
    F = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=128, ordering="natural", pivot_threshold=0.0))
    assert F._scan_bands is not None and F._scan_perm_id
    b = rng.random(300)
    x = np.asarray(F.ldiv(b))
    assert seen and all(shape[1] == 1 for shape in seen)
    import scipy.sparse.linalg as spla

    np.testing.assert_allclose(x, spla.spsolve(A.tocsc(), b),
                               rtol=1e-10, atol=1e-12)
