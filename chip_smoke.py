"""Smoke run of the solver's main path on NVIDIA GPUs, at real sizes.

    python chip_smoke.py          # one GPU: phases 1-6 below
    python chip_smoke.py --four   # four GPUs: the multi-device solve engines

Everything runs in this one process (a JAX process reserves most of a
card's memory, so a second one would fail). On a machine without a GPU the
script exits non-zero and prints no result: it never times or checks the
CPU in the card's place. Every phase checks its own output against a plain
float64 scipy/NumPy reference and raises on a miss, so the last line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

is printed only when every phase passed. Times are host-clock times around
work that ends in ``block_until_ready``: the first call (compile + run) is
reported apart from the warm median. Inputs and matrix values are made
from a fixed seed.

Phases (one GPU), in the order they run:
  2. host-factored solve at n = 90,000 (2D Poisson, nd ordering), R = 1,
     16, 64, in the default tri_mode and in "inv";
  6. the ldiv row permutation, on phase 2's carriers;
  3. device factorization, refactorization on entrywise 1 +- 5% values,
     the fused refactor+solve step and the light save/reload at
     n = 40,000;
  1. the Triton tile-LU kernel against the XLA rank-1 loop and a float64
     NumPy LU, at cs = 128 and phase 3's level batch width;
  3. again at n = 90,000, when the memory guard's estimate for that size
     (asked of phase 2's solver before phase 3 starts) fits the device;
  4. the 1-D chain path (associative scan) at n = 2^20;
  5. float64: the mixed tier and native float64 at the 1e-12 bar.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
U32 = 2.0 ** -24
# float32 normwise backward error bound, infinity norms, per column:
# 256 units of roundoff covers cs = 128-term tile dot products and the
# level-by-level accumulation; a product rounded to TF32 (unit roundoff
# 2^-11 ~ 4.9e-4, 8192x coarser) lands far above it.
BWD_BOUND = 256 * U32
F64_BAR = 1e-12          # the reference suite's sparse bar (runtests.jl:25)
LU_BOUND = 1e-5          # max|LU - D| / max|D|, float32 tiles


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them (a
    child process that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


CARD = "?"


def say(*a) -> None:
    print(*a, flush=True)


def report(label: str, seconds: float) -> None:
    say(f"  {label}: {seconds * 1e3:.3f} ms  [{CARD}]")


def timed(fn, *args, reps: int = 10):
    """(first call seconds, warm median seconds, result)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), out


def backward_error(A, x, b) -> float:
    """max over columns of ||A x - b||_inf / (||A||_inf ||x||_inf +
    ||b||_inf), in float64."""
    import scipy.sparse.linalg as spla

    x = np.asarray(x, dtype=np.float64).reshape(A.shape[0], -1)
    b = np.asarray(b, dtype=np.float64).reshape(A.shape[0], -1)
    r = np.abs(A @ x - b).max(axis=0)
    nA = spla.norm(A, np.inf)
    return float(np.max(r / (nA * np.abs(x).max(axis=0)
                             + np.abs(b).max(axis=0))))


def check_solve(label: str, A, x, b, xref, bound: float = BWD_BOUND):
    x = np.asarray(x, dtype=np.float64)
    check(x.shape == np.shape(b), f"{label}: shape {x.shape} != {np.shape(b)}")
    check(bool(np.isfinite(x).all()), f"{label}: non-finite solution")
    eta = backward_error(A, x, b)
    xref = np.asarray(xref).reshape(x.shape)
    rel = float(np.linalg.norm(x - xref) / np.linalg.norm(xref))
    say(f"  {label}: backward error {eta:.3e} (bound {bound:.3e}), "
        f"rel. diff. vs scipy float64 {rel:.3e}")
    check(eta < bound, f"{label}: backward error {eta:.3e} >= {bound:.3e}")
    return eta


def sync_solver(F):
    import jax

    jax.block_until_ready([F.ldata, F.udata, F._rs_blk])
    return F


def dominant_tiles(rng, batch, cs, dtype):
    D = rng.standard_normal((batch, cs, cs)) + cs * np.eye(cs)
    return D.astype(dtype)


def lu_error(merged, D) -> float:
    cs = D.shape[-1]
    got = np.asarray(merged, dtype=np.float64)
    L = np.tril(got, -1) + np.eye(cs)
    U = np.triu(got)
    D = np.asarray(D, dtype=np.float64)
    return float(np.abs(L @ U - D).max() / np.abs(D).max())


def value_update(A, rng):
    """New values on A's pattern: every entry scaled by its own seeded
    factor in 1 +- 5%. Under the frozen pivots of the device
    refactorization such an update can leave a 2D Poisson matrix
    indefinite, and the pivot growth that follows costs a plain float32
    solve its backward accuracy; one refinement sweep restores it, so the
    solves after a refactorization are checked with ``refine_steps=1``."""
    A2 = A.copy()
    A2.data = A.data * (1 + 0.05 * rng.uniform(-1, 1, A.nnz))
    return A2


def nd_config(**kw):
    from tpu_sparse_lu import SolverConfig

    base = dict(chunk_size=128, dtype="float32", ordering="nd",
                nd_cutoff=512)
    base.update(kw)
    return SolverConfig(**base)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_tile_lu(batch: int, cs: int = 128) -> None:
    import jax
    import jax.numpy as jnp

    from tpu_sparse_lu.ops.pallas_factor import lu_tile
    from tpu_sparse_lu.refactor import _lu_nopivot

    say(f"phase 1: tile LU kernel, cs={cs}, batch={batch}, float32")
    D = dominant_tiles(np.random.default_rng(SEED), batch, cs, np.float32)
    Dd = jnp.asarray(D)
    ref_fn = jax.jit(_lu_nopivot)
    first_k, t_k, got = timed(lu_tile, Dd)
    first_r, t_r, want = timed(ref_fn, Dd)
    err = lu_error(got, D)
    diff = float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(D).max())
    say(f"  lu_tile: max|LU - D|/max|D| = {err:.3e} (bound {LU_BOUND:.0e}); "
        f"max|lu_tile - _lu_nopivot|/max|D| = {diff:.3e}")
    check(err <= LU_BOUND, f"lu_tile error {err:.3e} > {LU_BOUND:.0e}")
    check(lu_error(want, D) <= LU_BOUND, "_lu_nopivot reference misses")
    report("lu_tile first call (compile + run)", first_k)
    report("lu_tile warm", t_k)
    report("_lu_nopivot (XLA) first call (compile + run)", first_r)
    report("_lu_nopivot (XLA) warm", t_r)


def phase_flagship(nx: int = 300, widths=(1, 16, 64)):
    """Host-factored nd solve at n = nx^2; returns the "inv" solver."""
    import jax
    import scipy.sparse.linalg as spla

    from tpu_sparse_lu import ParallelSparseLU
    from tpu_sparse_lu.models import poisson_2d

    A = poisson_2d(nx, nx).tocsc()
    n = A.shape[0]
    say(f"phase 2: host-factored solve, poisson_2d({nx}, {nx}) n={n}, "
        "cs=128, nd, nd_cutoff=512, float32")
    rng = np.random.default_rng(SEED)
    B = rng.random((n, max(widths)))
    X_ref = spla.splu(A).solve(B)
    F = None
    for mode in ("auto", "inv"):
        t0 = time.perf_counter()
        F = sync_solver(ParallelSparseLU(A, config=nd_config(tri_mode=mode)))
        say(f"  tri_mode={mode!r} -> {F.config.tri_mode!r}: construct "
            f"{time.perf_counter() - t0:.2f} s (host), n_factor="
            f"{F.n_factor}, levels L/U {F.plan.lplan.num_levels}/"
            f"{F.plan.uplan.num_levels}, tiles L/U "
            f"{F.plan.lplan.T}/{F.plan.uplan.T}")
        for R in widths:
            b = B[:, :R].astype(np.float32)
            first, warm, x = timed(F.ldiv, b)
            check_solve(f"{F.config.tri_mode} R={R}", A, x, b,
                        X_ref[:, :R])
            report(f"{F.config.tri_mode} R={R} ldiv first call", first)
            report(f"{F.config.tri_mode} R={R} ldiv warm", warm)
        exe, args = F._ldiv_callable()
        b = jax.numpy.asarray(B[:, :16], dtype=np.float32)
        mem = exe.lower(*args, b).compile().memory_analysis()
        say(f"  {F.config.tri_mode} R=16 compiled ldiv memory_analysis: "
            f"{mem}")
        stats = jax.devices()[0].memory_stats() or {}
        say(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    return A, F


def phase_permutation(F, R: int = 16) -> None:
    import jax
    import jax.numpy as jnp

    from tpu_sparse_lu.ops.permute import apply_perm
    from tpu_sparse_lu.solve import block_rhs

    say(f"phase 6: ldiv row permutation (gather) on the n={F.n} carriers, "
        f"R={R}")
    cs, n_in, K_in = F.plan.cs, F._n_orig, F._K_in
    v = np.random.default_rng(SEED).random((n_in, R)).astype(np.float32)
    xw = block_rhs(jnp.asarray(v), n_in, K_in, cs)
    pvec = np.asarray(F._pvec)
    want = np.where(pvec[:, None] >= 0, v[np.maximum(pvec, 0)], 0.0)
    first, warm, out = timed(jax.jit(apply_perm), F._pperm, xw)
    got = np.asarray(out).reshape(-1, R)
    check(np.array_equal(got[:F.plan.n], want), "permutation wrong")
    check(not got[F.plan.n:].any(), "permutation padding not zero")
    report("apply_perm first call", first)
    report("apply_perm warm", warm)


def phase_device_refactor(nx: int, steps: int = 3) -> None:
    import scipy.sparse.linalg as spla

    from tpu_sparse_lu import ParallelSparseLU
    from tpu_sparse_lu.models import poisson_2d

    A = poisson_2d(nx, nx).tocsc()
    n = A.shape[0]
    cfg = nd_config(tri_mode="inv", factorize="device")
    say(f"phase 3: device factorization, poisson_2d({nx}, {nx}) n={n}, "
        "cs=128, nd, nd_cutoff=512, inv, float32, factorize='device'")
    rng = np.random.default_rng(SEED + nx)
    B = rng.random((n, 16)).astype(np.float32)

    t0 = time.perf_counter()
    F = sync_solver(ParallelSparseLU(A, config=cfg))
    say(f"  construct (host planning + device elimination, with compile): "
        f"{time.perf_counter() - t0:.2f} s; tile LU kernel: {F._tile_lu}; "
        f"elimination levels {F._refactor_plan.NL}, merged tiles "
        f"{F._refactor_plan.TF}")
    check_solve("construct ldiv", A, F.ldiv(B), B, spla.splu(A).solve(B))
    A2 = value_update(A, rng)
    t0 = time.perf_counter()
    F.refactor_numeric(A2)
    sync_solver(F)
    report("refactor_numeric (warm)", time.perf_counter() - t0)
    diag = {k: float(v) for k, v in F.refactor_diagnostics.items()}
    say(f"  refactor_numeric on entrywise 1 +- 5% values: growth "
        f"{diag['growth']:.3e}, min pivot {diag['min_pivot']:.3e}")
    lu2 = spla.splu(A2)
    say(f"  refactor_numeric ldiv without refinement: backward error "
        f"{backward_error(A2, F.ldiv(B), B):.3e} (not held to the bound)")
    first, warm, x2 = timed(lambda b: F.ldiv(b, refine_steps=1), B, reps=3)
    check_solve("refactor_numeric ldiv(refine_steps=1)", A2, x2, B,
                lu2.solve(B))
    report("ldiv(refine_steps=1) warm", warm)
    step = F.make_refactor_solve_step(refine_steps=1)
    for k in range(steps):
        Ak = value_update(A, rng)
        first, warm, x = timed(step, Ak.data, B, reps=3)
        check_solve(f"fused step {k} (refine_steps=1)", Ak, x, B,
                    spla.splu(Ak).solve(B))
        if k == 0:
            report("fused step first call (compile + run)", first)
        report(f"fused step {k} warm", warm)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "light.npz")
        t0 = time.perf_counter()
        F.save(path)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        light = "light" in np.load(path).files
        check(light, "save() of a device-factorized solver was not light")
        t0 = time.perf_counter()
        G = sync_solver(ParallelSparseLU.from_saved(A2, path))
        t_load = time.perf_counter() - t0
    say(f"  light save {t_save:.2f} s ({size / 1e6:.1f} MB), from_saved "
        f"{t_load:.2f} s (host + device)")
    check_solve("from_saved ldiv(refine_steps=1)", A2,
                G.ldiv(B, refine_steps=1), B, lu2.solve(B))
    return F._refactor_plan.diag_ids.shape[1]


def refactor_admitted(F) -> bool:
    """Whether the device refactorization of ``F``'s matrix and
    configuration fits the device: the memory guard's own estimate and
    budget (host planning only; nothing is installed or allocated)."""
    nbytes, budget = F.refactor_footprint()
    admitted = budget is None or nbytes <= budget
    say(f"phase 3 at n={F.n}: refactorization working-set estimate "
        f"{nbytes / 1e9:.2f} GB, device budget "
        f"{'none' if budget is None else f'{budget / 1e9:.2f} GB'} -> "
        f"{'run' if admitted else 'skipped: over budget'}")
    return admitted


def phase_chain(n: int = 2 ** 20) -> None:
    import scipy.sparse.linalg as spla

    from tpu_sparse_lu import ParallelSparseLU, SolverConfig
    from tpu_sparse_lu.models import laplacian_1d

    say(f"phase 4: chain path, laplacian_1d({n}), natural ordering, float32")
    A = laplacian_1d(n).tocsc()
    F = sync_solver(ParallelSparseLU(A, config=SolverConfig(
        chunk_size=128, dtype="float32", ordering="natural",
        pivot_threshold=0.0)))
    check(F._scan_bands is not None and F._scan_perm_id,
          "the chain did not take the associative-scan path")
    B = np.random.default_rng(SEED).random((n, 16))
    X_ref = spla.splu(A).solve(B)
    for R in (1, 16):
        b = B[:, :R].astype(np.float32)
        first, warm, x = timed(F.ldiv, b)
        check_solve(f"chain R={R}", A, x, b, X_ref[:, :R])
        report(f"chain R={R} ldiv first call", first)
        report(f"chain R={R} ldiv warm", warm)


def phase_f64(nx: int = 100, R: int = 16) -> None:
    import jax
    import jax.numpy as jnp
    import scipy.sparse.linalg as spla

    from tpu_sparse_lu import ParallelSparseLU
    from tpu_sparse_lu.models import poisson_2d
    from tpu_sparse_lu.ops.pallas_factor import lu_tile

    jax.config.update("jax_enable_x64", True)
    A = poisson_2d(nx, nx).tocsc()
    n = A.shape[0]
    say(f"phase 5: float64, poisson_2d({nx}, {nx}) n={n}, R={R}, "
        f"bar {F64_BAR:.0e} relative error vs scipy float64")
    B = np.random.default_rng(SEED).random((n, R))
    X_ref = spla.splu(A).solve(B)

    def rel(x):
        x = np.asarray(x)
        check(x.dtype == np.float64, f"float64 tier returned {x.dtype}")
        return float(np.linalg.norm(x - X_ref) / np.linalg.norm(X_ref))

    F32 = ParallelSparseLU(A, config=nd_config(tri_mode="inv"))
    solve = F32.make_f64_ldiv(refine_steps=2)
    first, warm, x = timed(solve, jnp.asarray(B))
    e = rel(x)
    say(f"  mixed tier (f32 solve + 2 float64 refinement sweeps): rel err "
        f"{e:.3e}")
    check(e < F64_BAR, f"mixed tier rel err {e:.3e} misses {F64_BAR:.0e}")
    report("mixed tier first call", first)
    report("mixed tier warm", warm)
    for mode in ("trsm", "inv"):
        F = ParallelSparseLU(A, config=nd_config(tri_mode=mode,
                                                 dtype="float64"))
        first, warm, x = timed(F.ldiv, B)
        e = rel(x)
        say(f"  native float64 {mode}: rel err {e:.3e}")
        check(e < F64_BAR, f"native f64 {mode} rel err {e:.3e} misses "
              f"{F64_BAR:.0e}")
        report(f"native float64 {mode} first call", first)
        report(f"native float64 {mode} warm", warm)
    D = dominant_tiles(np.random.default_rng(SEED), 8, 128, np.float64)
    err = lu_error(lu_tile(jnp.asarray(D)), D)
    say(f"  lu_tile float64 cs=128: max|LU - D|/max|D| = {err:.3e}")
    check(err <= 1e-13, f"lu_tile float64 error {err:.3e}")


def phase_four(R: int = 16, nx: int = 300, banded=(1600, 64)) -> None:
    """The multi-device engines on four cards, each against the one-card
    ldiv of the same factorization."""
    import jax

    from tpu_sparse_lu import ParallelSparseLU
    from tpu_sparse_lu.models import block_banded, poisson_2d
    from tpu_sparse_lu.parallel.dp import make_dp_ldiv
    from tpu_sparse_lu.parallel.mesh import make_mesh
    from tpu_sparse_lu.parallel.pipeline_solve import make_pipeline_ldiv
    from tpu_sparse_lu.parallel.sharded_solve import make_sharded_ldiv

    check(len(jax.devices()) >= 4, f"--four needs 4 GPUs, found "
          f"{len(jax.devices())}")
    mesh = make_mesh(4)
    devs = set(mesh.devices.flat)
    rng = np.random.default_rng(SEED)

    def compare(label, A, F, solve, b):
        x1 = np.asarray(F.ldiv(b), dtype=np.float64)
        first, warm, x = timed(solve, b)
        check(set(x.sharding.device_set) == devs,
              f"{label}: result lives on {x.sharding.device_set}")
        xs = np.asarray(x, dtype=np.float64)[:A.shape[0]]
        # the engines sum the same tile products in another order: both
        # solutions must be backward stable, and they may differ by the
        # forward error that allows (condition number x bound)
        check_solve(f"{label} R={R}", A, xs, b, x1)
        first1, warm1, _ = timed(F.ldiv, b)
        report(f"{label} first call", first)
        report(f"{label} warm", warm)
        report(f"{label}: one-card ldiv warm", warm1)

    A = poisson_2d(nx, nx).tocsc()
    say(f"four cards: poisson_2d({nx}, {nx}) n={A.shape[0]}, nd, R={R}")
    F = sync_solver(ParallelSparseLU(A, config=nd_config()))
    b = rng.random((A.shape[0], R)).astype(np.float32)
    compare("psum-sharded", A, F, make_sharded_ldiv(F, mesh), b)
    compare("data-parallel", A, F, make_dp_ldiv(F, mesh), b)
    A5 = block_banded(rng, *banded).tocsc()
    say(f"four cards: block_banded{banded} n={A5.shape[0]}, R={R}")
    F5 = sync_solver(ParallelSparseLU(A5, config=nd_config(ordering="colamd",
                                                           nd_cutoff=None)))
    pipe = make_pipeline_ldiv(F5, mesh)
    check(pipe is not None, "the halo pipeline refused the banded factor")
    b5 = rng.random((A5.shape[0], R)).astype(np.float32)
    compare("halo-pipelined", A5, F5, pipe, b5)


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device engines on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r}); nothing is run in its place",
              file=sys.stderr)
        return 1
    from tpu_sparse_lu.utils.compile_cache import use_compile_cache

    cache = use_compile_cache(ROOT)
    CARD = card_line()
    dev = devices[0]
    say(f"card: {CARD}")
    say(f"jax {jax.__version__}, device_kind {dev.device_kind!r}, "
        f"devices {len(devices)}, XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}, "
        f"compile cache {cache}")
    t_all = time.perf_counter()
    if args.four:
        phase_four()
    else:
        _, F90 = phase_flagship()
        phase_permutation(F90)
        # the phase-2 "inv" solver has phase 3's configuration at n = 90k
        # (host-factored, same static pivots): ask its guard before starting
        run_90k = refactor_admitted(F90)
        del F90
        batch = phase_device_refactor(200)
        phase_tile_lu(batch=batch)
        if run_90k:
            phase_device_refactor(300)
        phase_chain()
        phase_f64()
    say(f"total {time.perf_counter() - t_all:.1f} s")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
