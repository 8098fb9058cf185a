"""Benchmark harness — the five BASELINE.json configs, on an NVIDIA GPU.

Default run: config 4, the 2D Poisson level-scheduled solve, printing ONE
JSON line

  {"metric": "poisson100_ldiv_throughput", "value": N, "unit": "nnz/s",
   "vs_baseline": N, "platform": "gpu", "device_kind": ..., ...}

against the reference-equivalent algorithm measured locally (SuperLU
factor + solve via scipy — the reference delegates to UMFPACK + chunked
BLAS, SURVEY.md C8/C9, and publishes no numbers of its own).

``--config N`` runs one config; ``--all`` runs configs 1-5, the n = 90k
scale probe and the save/reload probe in this process and logs their
detail as JSON. ``--f64-probe`` is its own invocation (float64 mode is
process-wide): run it before or after the float32 configs, never beside
them — one process owns the card.

Any failure propagates: the process exits non-zero. On a machine without a
GPU the harness refuses to run; it never times the CPU in the card's place.

Timing method: solves chained inside one jit (x_{i+1} = solve(x_i)/|..| —
the PDE time-stepper pattern) at two chain lengths, reporting the slope
(t(N2)-t(N1))/(N2-N1): the marginal steady-state cost of one more solve
(utils/profiling.slope_time).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import scipy.sparse.linalg as spla

from tpu_sparse_lu.utils.profiling import chain_time, slope_time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = {}


def log(*a):
    tag = f"[{DEVICE.get('platform')}/{DEVICE.get('device_kind')}]"
    print(tag, *a, file=sys.stderr, flush=True)


def _per(num, t):
    """num/t, or None when the timing never resolved (slope_time NaN)."""
    if t is None or not np.isfinite(t) or t <= 0:
        return None
    return num / t


def _ldiv_fn(F):
    exe, args = F._ldiv_callable()
    return (lambda v, *a: exe(*a, v)), args


def _scipy_panel_time(A, R, reps=20):
    lu = spla.splu(A.tocsc())
    bb = np.random.default_rng(1).random((A.shape[0], R))
    lu.solve(bb)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        lu.solve(bb)
        ts.append(time.perf_counter() - t0)
    # min: the baseline must not be inflated by transient host CPU load
    return float(np.min(ts))


def _make_F(A, cs, **kw):
    from tpu_sparse_lu import ParallelSparseLU, SolverConfig

    cfg = SolverConfig(chunk_size=cs, tri_mode="inv", dtype="float32", **kw)
    return ParallelSparseLU(A, config=cfg)


def _phase_breakdown(F, b):
    """Per-phase timing (perm / lsolve / rsolve) via the standalone
    engines, timed as separate programs, plus the tile-op count."""
    import jax
    import jax.numpy as jnp

    from tpu_sparse_lu.ops.permute import apply_perm
    from tpu_sparse_lu.solve import block_rhs, unblock_rhs

    plan = F.plan
    cs, K_in, n_in = plan.cs, F._K_in, F._n_orig
    bf = jnp.zeros((plan.n, b.shape[1]), b.dtype)  # factor-space RHS

    def perm_only(pperm, qperm, rs_blk, v):
        xw = apply_perm(pperm, block_rhs(v, n_in, K_in, cs) * rs_blk)
        return unblock_rhs(apply_perm(qperm, xw), n_in)

    exe_p = jax.jit(perm_only)
    exe_l, exe_u = F._exe("lsolve"), F._exe("rsolve")
    return {
        "perm": chain_time(
            ((lambda v, pp, qp, rs: exe_p(pp, qp, rs, v)),
             (F._pperm, F._qperm, F._rs_blk)), b),
        "lsolve": chain_time(((lambda v, ld: exe_l(ld, v)), (F.ldata,)), bf),
        "rsolve": chain_time(((lambda v, ud: exe_u(ud, v)), (F.udata,)), bf),
        "tile_ops": int(plan.lplan.K + plan.lplan.T
                        + plan.uplan.K + plan.uplan.T),
    }


def _check_residual(F, A, b, tol=1e-3):
    """Normwise backward error ||Ax-b|| / (||A|| ||x|| + ||b||): ~eps for a
    backward-stable solve regardless of conditioning (the relative-to-b
    residual scales with kappa(A) and is meaningless for e.g. the 1D
    Laplacian at n=20k, kappa ~ 4e8, in fp32)."""
    x = np.asarray(F.ldiv(b))
    bn = np.asarray(b)
    r = np.linalg.norm(A @ x - bn) / (
        spla.norm(A) * np.linalg.norm(x) + np.linalg.norm(bn)
    )
    if not r < tol:
        raise RuntimeError(f"solve inaccurate: backward error {r}")
    return float(r)


def bench_config(cfg_id: int) -> dict:
    import jax
    import jax.numpy as jnp

    from tpu_sparse_lu.models import (
        block_banded,
        laplacian_1d,
        poisson_2d,
        random_sparse,
    )

    rng = np.random.default_rng(0)

    if cfg_id == 1:
        # 1D Laplacian tridiagonal, single RHS. Natural ordering keeps the
        # factors bidiagonal, so the solver dispatches to the log-depth
        # associative-scan substitution (ops/scan_solve.py) — a chain has
        # no level width for the tile engines, but composes into O(log n)
        # parallel depth as affine maps.
        A = laplacian_1d(20000)
        F = _make_F(A, 128, ordering="natural", pivot_threshold=0.0)
        if not (F._scan_bands is not None and F._scan_perm_id):
            raise RuntimeError("config 1 missed the associative-scan path")
        b = jnp.asarray(rng.random((A.shape[0], 1)), dtype=jnp.float32)
        resid = _check_residual(F, A, b)
        t = chain_time(_ldiv_fn(F), b)
        nnz = F.L.nnz + F.U.nnz
        t_base = _scipy_panel_time(A, 1)
        return dict(config="laplace1d_single_rhs", n=A.shape[0], nnz_lu=nnz,
                    t_ours=t, t_scipy=t_base, resid=resid,
                    nnz_per_s=_per(nnz, t), vs_baseline=_per(t_base, t))

    if cfg_id == 2:
        # repeated same-sparsity refactorization + solve (device-side lu!
        # reuse): the fused refactor+solve step chained inside one jit —
        # the PDE-stepper inner loop
        from jax import lax

        A = block_banded(rng, 120, 30)
        F = _make_F(A, 128)
        step = F.make_refactor_solve_step()
        data0 = jnp.asarray(A.data, dtype=jnp.float32)
        b = jnp.asarray(rng.random((A.shape[0], 8)), dtype=jnp.float32)
        # accuracy gate on the step itself: refactorize with perturbed
        # values and check the solve against scipy on that exact matrix
        A_chk = A.copy()
        A_chk.data = A_chk.data * 1.01
        x_chk = np.asarray(step(jnp.asarray(A_chk.data, jnp.float32), b))
        bn = np.asarray(b)
        r = np.linalg.norm(A_chk @ x_chk - bn) / (
            spla.norm(A_chk) * np.linalg.norm(x_chk) + np.linalg.norm(bn)
        )
        if not r < 1e-3:
            raise RuntimeError(f"fused step inaccurate: backward error {r}")

        def make_chain(N):
            @jax.jit
            def chain(b, data0):
                # feed the solution back as the next RHS (renormalized so
                # deep chains stay finite), and perturb the matrix values
                # by the carry so the refactorization is loop-variant —
                # XLA's while-loop LICM would otherwise hoist a
                # loop-invariant refactorization out of the body and time
                # only the solves
                def body(i, v):
                    w = step(data0 * (1 + 1e-6 * v[0, 0]), v)
                    return w / (jnp.max(jnp.abs(w)) + 1e-30)
                return lax.fori_loop(0, N, body, b)
            return (lambda x0: chain(x0, data0)), b

        # scipy baseline: full splu factorization (it has no numeric-only
        # path); sampled before AND after our timing, min kept, so
        # transient host load cannot inflate the ratio
        Acsc = A.tocsc()

        def splu_time(M, **kw):
            ts_b = []
            for _ in range(5):
                t0 = time.perf_counter()
                spla.splu(M, **kw)
                ts_b.append(time.perf_counter() - t0)
            return float(np.min(ts_b))

        # tighter numeric-only bound (VERDICT r3 #6): factor the COLAMD-
        # preordered matrix with permc_spec="NATURAL" — identical fill
        # and flops, zero ordering cost; still pays SuperLU's structural
        # symbolic phase, so it remains an UPPER bound on a true
        # numeric-only lu! (UMFPACK src:247).
        Aq = Acsc[:, spla.splu(Acsc).perm_c].tocsc()
        t_base_pre = splu_time(Acsc)
        t_pre_pre = splu_time(Aq, permc_spec="NATURAL")
        t = slope_time(make_chain)
        t_base = min(t_base_pre, splu_time(Acsc))
        t_preord = min(t_pre_pre, splu_time(Aq, permc_spec="NATURAL"))
        nnz = F.L.nnz + F.U.nnz
        return dict(config="refactor_same_pattern", n=A.shape[0], nnz_lu=nnz,
                    t_ours=t, t_scipy=t_base,
                    t_scipy_preordered=t_preord, resid=float(r),
                    nnz_per_s=_per(nnz, t), vs_baseline=_per(t_base, t),
                    vs_preordered_splu=_per(t_preord, t))

    if cfg_id == 3:
        # multi-RHS SpSM on a random sparse matrix (scattered COLAMD perms)
        A = random_sparse(rng, 4096, density=0.002)
        R = 64
        F = _make_F(A, 128)
        b = jnp.asarray(rng.random((A.shape[0], R)), dtype=jnp.float32)
        resid = _check_residual(F, A, b)
        t = chain_time(_ldiv_fn(F), b)
        nnz = F.L.nnz + F.U.nnz
        t_base = _scipy_panel_time(A, R)
        return dict(config="spsm_multi_rhs", n=A.shape[0], R=R, nnz_lu=nnz,
                    t_ours=t, t_scipy=t_base, resid=resid,
                    nnz_per_s=_per(nnz * R, t), vs_baseline=_per(t_base, t))

    if cfg_id == 4:
        # 2D Poisson 5-point, level-scheduled solve (HEADLINE). Chunk-
        # aligned nested dissection turns the chunk DAG from a 69-level
        # chain (COLAMD) into ~9 wide levels. nd_cutoff=512 (4-chunk
        # subdomains) trades ~30% more factor nnz for fewer, denser tiles
        # and levels; not yet re-swept on the GPU.
        A = poisson_2d(100, 100)
        R = 16
        F = _make_F(A, 128, ordering="nd", nd_cutoff=512)
        log(f"config4: n={A.shape[0]} nnzLU={F.L.nnz + F.U.nnz} "
            f"levels={F.plan.lplan.num_levels}/{F.plan.uplan.num_levels}")
        b = jnp.asarray(rng.random((A.shape[0], R)), dtype=jnp.float32)
        resid = _check_residual(F, A, b)
        # host-load robustness: sample the scipy baseline BEFORE and
        # AFTER our timing and keep the min
        t_base_pre = _scipy_panel_time(A, R)
        t = chain_time(_ldiv_fn(F), b)
        nnz = F.L.nnz + F.U.nnz
        t_base = min(t_base_pre, _scipy_panel_time(A, R))
        out = dict(config="poisson100_ldiv_throughput", n=A.shape[0], R=R,
                   nnz_lu=nnz, t_ours=t, t_scipy=t_base, resid=resid,
                   nnz_per_s=_per(nnz * R, t),
                   vs_baseline=_per(t_base, t))
        # single-RHS (R=1) — the reference's primary calling pattern, a
        # vector per timestep (src:286)
        b1 = b[:, :1]
        r1 = _check_residual(F, A, b1)
        t1r = chain_time(_ldiv_fn(F), b1)
        t1_base = _scipy_panel_time(A, 1)
        out["single_rhs"] = dict(t_ours=t1r, t_scipy=t1_base, resid=r1,
                                 nnz_per_s=_per(nnz, t1r),
                                 vs_baseline=_per(t1_base, t1r))
        # wide panel (R=64)
        b64 = jnp.asarray(rng.random((A.shape[0], 64)), dtype=jnp.float32)
        r64 = _check_residual(F, A, b64)
        t64 = chain_time(_ldiv_fn(F), b64)
        t64_base = _scipy_panel_time(A, 64)
        out["wide_rhs_64"] = dict(t_ours=t64, t_scipy=t64_base, resid=r64,
                                  nnz_per_s=_per(nnz * 64, t64),
                                  vs_baseline=_per(t64_base, t64))
        out["phases"] = _phase_breakdown(F, b)
        log(f"config4: ours {t * 1e3:.3f} ms, scipy {t_base * 1e3:.3f} ms, "
            f"resid {resid:.2e}")
        return out

    if cfg_id == 5:
        # block-banded matrix, n = 102,400 rows: a PDE-step-sized banded
        # solve, row-partitioned across the devices when there are >= 2
        from tpu_sparse_lu.parallel.mesh import make_mesh
        from tpu_sparse_lu.parallel.pipeline_solve import make_pipeline_ldiv
        from tpu_sparse_lu.parallel.sharded_solve import make_sharded_ldiv

        ndev = len(jax.devices())
        A = block_banded(rng, 1600, 64)
        R = 16
        F = _make_F(A, 128)
        b = jnp.asarray(rng.random((A.shape[0], R)), dtype=jnp.float32)
        out = dict(config="block_banded", n=A.shape[0], R=R,
                   n_devices=ndev, nnz_lu=F.L.nnz + F.U.nnz)
        out["resid"] = _check_residual(F, A, b)
        t1 = chain_time(_ldiv_fn(F), b)
        out["t_single"] = t1
        t_base = _scipy_panel_time(A, R, reps=5)
        out["t_scipy"] = t_base
        out["nnz_per_s"] = _per((F.L.nnz + F.U.nnz) * R, t1)
        out["vs_baseline"] = _per(t_base, t1)
        out["t_single_r1"] = chain_time(_ldiv_fn(F), b[:, :1])
        b64 = jnp.asarray(rng.random((A.shape[0], 64)), dtype=jnp.float32)
        out["t_single_r64"] = chain_time(_ldiv_fn(F), b64)
        # nd ordering: level width from dissection
        F_nd = _make_F(A, 128, ordering="nd")
        out["nd_single_device"] = dict(
            t_r1=chain_time(_ldiv_fn(F_nd), b[:, :1]),
            resid=_check_residual(F_nd, A, b[:, :1], tol=1e-2),
            levels=(F_nd.plan.lplan.num_levels, F_nd.plan.uplan.num_levels),
        )
        if ndev >= 2:
            mesh = make_mesh(ndev)
            solve = make_pipeline_ldiv(F, mesh) or make_sharded_ldiv(F, mesh)
            jax.block_until_ready(solve(b))
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(solve(b))
                ts.append(time.perf_counter() - t0)
            tN = float(np.min(ts))
            out["t_sharded"] = tN
            out["scaling_efficiency"] = t1 / (tN * ndev)
        return out

    raise ValueError(cfg_id)


def _scale_probe() -> dict:
    """n = 90k nd Poisson solves at R = 8, 16, 64."""
    import jax.numpy as jnp

    from tpu_sparse_lu.models import poisson_2d

    rng = np.random.default_rng(0)
    A = poisson_2d(300, 300)
    F = _make_F(A, 128, ordering="nd", nd_cutoff=512)
    nnz = F.L.nnz + F.U.nnz
    out = dict(n=A.shape[0], nnz_lu=nnz,
               levels=(F.plan.lplan.num_levels, F.plan.uplan.num_levels))
    for R in (8, 16, 64):
        b = jnp.asarray(rng.random((A.shape[0], R)), dtype=jnp.float32)
        resid = _check_residual(F, A, b)
        t = chain_time(_ldiv_fn(F), b)
        t_base = _scipy_panel_time(A, R, reps=5)
        out[f"R{R}"] = dict(t_ours=t, t_scipy=t_base, resid=resid,
                            nnz_per_s=_per(nnz * R, t),
                            vs_baseline=_per(t_base, t))
        log(f"scale n=90k R={R}: ours {t * 1e3:.3f} ms, scipy "
            f"{t_base * 1e3:.1f} ms")
    return out


def _persist_probe() -> dict:
    """save()/from_saved() at scale, on the device: host construct and
    load times include the device work they start (block_until_ready).

    * n = 90k nd Poisson, FULL save (factor values at the solver dtype);
    * n = 40k nd Poisson, LIGHT save: constructed with factorize="device"
      (no SuperLU at all), save() persists pattern + plans + the refactor
      schedule only, and from_saved recomputes the factor values from A's
      nonzeros via the device elimination. ``from_saved_warm`` excludes
      the one-time compile; ``from_saved_cold`` includes it.
    """
    import jax

    from tpu_sparse_lu import ParallelSparseLU, SolverConfig
    from tpu_sparse_lu.models import poisson_2d

    rng = np.random.default_rng(0)

    def sync(F):
        jax.block_until_ready((F.ldata, F.udata, F._rs_blk))
        return F

    def roundtrip(A, cfg, path, force_full=False):
        t0 = time.perf_counter()
        F = sync(ParallelSparseLU(A, config=cfg))
        t_construct = time.perf_counter() - t0
        t0 = time.perf_counter()
        F.save(path, values=True if force_full else "auto")
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        light = bool("light" in np.load(path).files)
        t0 = time.perf_counter()
        G = sync(ParallelSparseLU.from_saved(A, path))
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        G = sync(ParallelSparseLU.from_saved(A, path))
        t_warm = time.perf_counter() - t0
        resid = _check_residual(G, A, rng.random(A.shape[0]))
        return dict(n=A.shape[0], nnz_lu=int(G.L.nnz + G.U.nnz),
                    light_save=light, construct=t_construct, save=t_save,
                    file_bytes=size, from_saved_cold=t_cold,
                    from_saved_warm=t_warm, resid=resid)

    cfg = dict(chunk_size=128, tri_mode="inv", dtype="float32",
               ordering="nd", nd_cutoff=512)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        return {
            "n90k_full": roundtrip(poisson_2d(300, 300),
                                   SolverConfig(**cfg), path,
                                   force_full=True),
            "n40k_light": roundtrip(poisson_2d(200, 200),
                                    SolverConfig(factorize="device", **cfg),
                                    path),
        }


def _f64_probe() -> dict:
    """float64 tiers against the reference's full-f64 UMFPACK bar
    (runtests.jl:25-26). Needs a process started with ``--f64-probe``
    (float64 mode is process-wide).

    * ``mixed``: f32 solve + float64 DIA-residual iterative refinement
      (``ParallelSparseLU.make_f64_ldiv``);
    * ``native``: dtype="float64" in tri_mode "trsm" and "inv".
    """
    import jax
    import jax.numpy as jnp

    from tpu_sparse_lu import ParallelSparseLU, SolverConfig
    from tpu_sparse_lu.models import poisson_2d

    if not jax.config.jax_enable_x64:
        raise RuntimeError("the f64 probe needs jax_enable_x64")
    rng = np.random.default_rng(0)
    A = poisson_2d(100, 100)
    R = 16
    bn = rng.random((A.shape[0], R))
    xs = spla.spsolve(A.tocsc(), bn)
    t_base = _scipy_panel_time(A, R)
    nrmA = spla.norm(A)

    def errs(x):
        resid = float(np.linalg.norm(A @ x - bn) / (
            nrmA * np.linalg.norm(x) + np.linalg.norm(bn)))
        rel = float(np.linalg.norm(x - xs) / np.linalg.norm(xs))
        return resid, rel

    F32 = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=128, tri_mode="inv", dtype="float32",
        ordering="nd", nd_cutoff=512))
    b64 = jnp.asarray(bn, jnp.float64)
    mixed = {}
    for steps in (1, 2):
        solve = F32.make_f64_ldiv(refine_steps=steps)
        resid, rel = errs(np.asarray(solve(b64)))
        t = chain_time(((lambda v, s=solve: s(v)), ()), b64)
        mixed[f"ir{steps}"] = dict(
            refine_steps=steps, t_ours=t, bwd_err=resid,
            rel_err_vs_scipy_f64=rel, meets_1e12_bar=rel < 1e-12,
            vs_baseline=_per(t_base, t))
    native = {}
    for mode in ("trsm", "inv"):
        F = ParallelSparseLU(A, config=SolverConfig(
            chunk_size=128, tri_mode=mode, dtype="float64", ordering="nd",
            nd_cutoff=512))
        resid, rel = errs(np.asarray(F.ldiv(b64)))
        t = chain_time(_ldiv_fn(F), b64)
        native[mode] = dict(t_ours=t, bwd_err=resid,
                            rel_err_vs_scipy_f64=rel,
                            meets_1e12_bar=rel < 1e-12,
                            vs_baseline=_per(t_base, t))
    return dict(n=A.shape[0], R=R, t_scipy=t_base, mixed=mixed,
                native=native)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--f64-probe", action="store_true")
    ap.add_argument("--scale", action="store_true")
    ap.add_argument("--persist", action="store_true")
    args = ap.parse_args()

    import jax

    from tpu_sparse_lu.utils.compile_cache import use_compile_cache

    if args.f64_probe:
        # float64 mode must be set before any trace exists
        jax.config.update("jax_enable_x64", True)
    use_compile_cache(ROOT)
    dev = jax.devices()[0]
    DEVICE.update(platform=dev.platform, device_kind=dev.device_kind,
                  device_count=len(jax.devices()))
    if dev.platform != "gpu":
        print(f"bench: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        sys.exit(1)
    log("device:", DEVICE)

    if args.f64_probe:
        r = _f64_probe()
        print(json.dumps(dict(r, **DEVICE)))
        return
    if args.scale:
        print(json.dumps(dict(_scale_probe(), **DEVICE)))
        return
    if args.persist:
        print(json.dumps(dict(_persist_probe(), **DEVICE)))
        return

    if args.all:
        detail = {}
        for c in (1, 2, 3, 4, 5):
            detail[c] = bench_config(c)
            log(f"config {c}: {json.dumps(detail[c])}")
        detail["scale_90k"] = _scale_probe()
        log(f"scale_90k: {json.dumps(detail['scale_90k'])}")
        detail["persistence"] = _persist_probe()
        log(f"persistence: {json.dumps(detail['persistence'])}")
        r = detail[4]
    elif args.config:
        r = bench_config(args.config)
        log(json.dumps(r, indent=2))
    else:
        r = bench_config(4)

    print(json.dumps(dict({
        "metric": r["config"],
        "value": r.get("nnz_per_s"),
        "unit": "nnz/s",
        "vs_baseline": r.get("vs_baseline"),
    }, **DEVICE)))


if __name__ == "__main__":
    main()
