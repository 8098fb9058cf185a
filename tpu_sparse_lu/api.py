"""Public solver API: the :class:`ParallelSparseLU` lifecycle.

Mirrors the reference's user contract (SURVEY.md §7 idea 3, test lifecycle
at /root/reference/test/runtests.jl:108-188): factor once → solve many →
refactor in place when values change but sparsity doesn't → solve again.

  * ``ParallelSparseLU(A, chunk_size)``  ↔ reference constructor src:64-99
  * ``F.ldiv(b)`` / ``F.solve(b)``       ↔ ``ldiv!(x, F, b)``   src:286-342
  * ``F.lsolve(b)`` / ``F.rsolve(b)``    ↔ ``lsolve!``/``rsolve!``
                                            src:349-392 (semi-public, tested
                                            directly by the reference suite)
  * ``F.refactor(A)``                    ↔ ``lu!(F, A)``        src:245-279
  * ``F.refactor_numeric(A)``            — device-side same-pattern numeric
                                            refactorization (static pivots;
                                            the device counterpart of
                                            UMFPACK's numeric-only ``lu!``).

Unlike the reference there is no shared ``wrk`` scratch (src:53, :80): the
solves are pure functions, hence reentrant and race-free by construction
(SURVEY.md §5.2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from .pack import pack_factor
from .solve import (
    TriKernelData,
    block_rhs,
    blocked_tri_solve,
    prepare_tri_kernel,
    unblock_rhs,
)
from .symbolic import (
    HostFactors,
    SymbolicPlan,
    build_symbolic_plan,
    factorize_host,
)
from .utils.config import SolverConfig, backend_policy, default_chunk_size

__all__ = ["ParallelSparseLU", "cleanup_ParallelSparseLU",
           "device_memory_budget"]


def device_memory_budget(device=None) -> Optional[int]:
    """Bytes the device's allocator may hand out (``memory_stats()
    ["bytes_limit"]``), or None where the backend reports no limit (the
    CPU): the default ceiling of :meth:`ParallelSparseLU.
    enable_device_refactor`'s memory guard."""
    device = jax.devices()[0] if device is None else device
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) if limit else None


def _refactor_store_envelope(lplan, uplan, cs: int, itemsize: int) -> int:
    """First-pass working-set estimate of the device refactorization: a
    4x envelope over the merged dense tile store of the elimination
    closure (``lplan``/``uplan`` from refactor.closure_solve_plans)."""
    K = lplan.K
    store_tiles = lplan.T + uplan.T + K
    return 4 * store_tiles * cs ** 2 * itemsize


def _refactor_working_set(rp, lplan, uplan, cs: int, itemsize: int,
                         tri_mode: str) -> int:
    """Working-set estimate once the refactor plan ``rp`` exists: the
    store envelope plus, in inv modes, the elimination's per-level
    panel-inverse stacks (2 * NL * BL tiles — a skewed schedule pads
    NL*BL well beyond K) and the windowed assembly's W-fold replicated
    value table."""
    extra = rp.win.W * rp.win.Np * itemsize
    if tri_mode in ("inv", "inv_refine"):
        BL = rp.diag_ids.shape[1]
        extra += 2 * rp.NL * BL * cs ** 2 * itemsize
    return _refactor_store_envelope(lplan, uplan, cs, itemsize) + extra


def _pattern_factors(A: sp.csc_matrix) -> HostFactors:
    """Pattern-only :class:`HostFactors` for ``factorize="device"``.

    Under a static-diagonal-pivot ordering (p = q = identity, no row
    pivoting) the factor patterns need no numeric factorization: L/U
    live inside the blocked-elimination closure of A's own pattern,
    which is exactly what the device refactorization plans on
    (refactor.closure_solve_plans). These placeholder factors carry the
    TRIANGLES of A's pattern with identity values (diag 1, off-diag 0 —
    keeps the initial, immediately-discarded pack/invert step finite);
    the first device refactorization then computes the real values and
    every closure fill tile. Replaces the reference's construct-time C
    dependency (UMFPACK ``lu(A)``, src:74) with one device program.
    """
    n = A.shape[0]
    eye = sp.eye(n, format="csc")

    def tri(M):
        M = (M + eye).tocsc()
        M.sort_indices()
        rows = M.indices
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(M.indptr))
        M.data = (rows == cols).astype(np.float64)
        return M

    ident = np.arange(n, dtype=np.int64)
    return HostFactors(
        m=n, n=n,
        L=tri(sp.tril(A, -1)),
        U=tri(sp.triu(A, 1)),
        p=ident, q=ident.copy(),
        Rs=np.ones(n, dtype=np.float64),
    )


def _resolve_dtype(config_dtype: Optional[str], A_dtype) -> jnp.dtype:
    if config_dtype is not None:
        return jnp.dtype(config_dtype)
    if A_dtype == np.float64 and jax.config.jax_enable_x64:
        return jnp.dtype(jnp.float64)
    return jnp.dtype(jnp.float32)


class ParallelSparseLU:
    """Sparse LU factorization with fast repeated solves on the device.

    Exposes the same quantities as the reference struct
    (src/SharedMemSparseLU.jl:43-62): ``m, n, L, U, p, q, Rs`` with
    ``L @ U == (Rs[:, None] * A)[p][:, q]`` (src:292-316), plus the static
    :class:`SymbolicPlan` and device-resident packed tiles.
    """

    def __init__(
        self,
        A: sp.spmatrix,
        chunk_size: Optional[int] = None,
        *,
        config: Optional[SolverConfig] = None,
    ):
        import dataclasses as _dc

        self.config = config or SolverConfig(chunk_size=chunk_size)
        if chunk_size is not None and self.config.chunk_size is None:
            self.config = _dc.replace(self.config, chunk_size=chunk_size)
        A = sp.csc_matrix(A)
        A.sort_indices()
        policy = backend_policy()
        cs = self.config.chunk_size or default_chunk_size(A.shape[0])
        cs = max(1, min(cs, A.shape[0]))  # reference clamp, src:72
        self._n_orig = A.shape[0]
        self.dtype = _resolve_dtype(self.config.dtype, A.dtype)
        # the stored config always carries a concrete tri_mode downstream
        if self.config.tri_mode == "auto":
            self.config = _dc.replace(self.config, tri_mode=policy.tri_mode)

        # nested-dissection embedding (config.ordering="nd"): factor an
        # extended matrix whose chunks align with the dissection stages
        self._ext = None
        self._nd_cutoff = self.config.nd_cutoff
        A_factor = A
        if self.config.ordering == "nd":
            from .ordering import staged_extension

            if self._nd_cutoff == "auto":
                self._nd_cutoff = self._autotune_nd_cutoff(A, cs)
            A_ext, ext_src, ext_pos, data_src = staged_extension(
                A, cs, cutoff=self._nd_cutoff
            )
            self._ext = {"src": ext_src, "pos": ext_pos, "data_src": data_src}
            A_factor = A_ext
        # first-factorization backend (SolverConfig.factorize):
        # "device" skips SuperLU entirely — pattern-only placeholder
        # factors now, real values from the blocked device elimination
        # below (VERDICT r4 #3; replaces the reference's construct-time
        # UMFPACK call, src:74)
        fac = self.config.factorize
        static_piv = self.config.ordering == "nd" or (
            self.config.ordering == "natural"
            and self.config.pivot_threshold == 0.0
        )
        if fac == "auto":
            fac = "device" if static_piv else "host"
        if fac == "device" and not static_piv:
            raise ValueError(
                "factorize='device' needs a static-diagonal-pivot ordering "
                "(ordering='nd', or 'natural' with pivot_threshold=0.0): "
                "the frozen pivot order must be known from the pattern "
                "alone before any numeric factorization exists"
            )
        self.config = _dc.replace(self.config, factorize=fac)
        if fac == "device":
            self._factors = _pattern_factors(A_factor)
        else:
            self._factors = self._factorize(A_factor)
        self.plan = build_symbolic_plan(self._factors, cs)
        # original input pattern, for refactorization pattern checks
        self._a_pattern = (A.indptr.copy(), A.indices.copy())
        self._a_pattern_sig = (A.indptr.tobytes(), A.indices.tobytes())
        # the pattern the refactor plan is built on (extended under nd)
        self._a_factor_pattern = (
            A_factor.indptr.copy(), A_factor.indices.copy()
        )
        self._refactor_plan = None
        self._jit_cache = {}
        self._factors_stale = False
        self._set_matrix_device(A)
        self._prepare_device()
        if fac == "device":
            # FIRST factorization on device: the blocked elimination over
            # the closure plans (enable_device_refactor raises its clear
            # HBM-budget error when the closure store cannot fit — the
            # host path remains for those matrices)
            self.refactor_numeric(A)

    def _autotune_nd_cutoff(self, A: sp.csc_matrix, cs: int) -> int:
        """Pick the nd base-subdomain size by the level-scan engine's
        padded work: each ``lax.scan`` step (solve.blocked_tri_solve)
        processes the widest level's chunk and tile counts, so a factor
        costs ``levels x (max chunks + max tiles per level)`` tile ops.
        Plain counts, equal weights per tile op (no device timing behind
        them). Tries {cs, 2cs, 4cs} (each costs one trial factorization —
        this is the opt-in ``nd_cutoff="auto"``) and keeps the min.
        Under ``factorize != "host"`` the trial is pattern-only: the tile
        counts come from the blocked closure (what the device elimination
        will actually materialize) instead of a SuperLU numeric pass.
        """
        from .ordering import staged_extension
        from .symbolic import plan_triangular

        pattern_only = self.config.factorize != "host"
        if pattern_only:
            from .refactor import closure_solve_plans

        best, best_cost = cs, None
        for cutoff in (cs, 2 * cs, 4 * cs):
            A_ext, _, _, _ = staged_extension(A, cs, cutoff=cutoff)
            if pattern_only:
                pf = _pattern_factors(A_ext)
                lp, up = closure_solve_plans(
                    A_ext, pf.L, pf.U, pf.p, pf.q, cs
                )
            else:
                f = self._factorize(A_ext)
                lp = plan_triangular(f.L, cs, lower=True)
                up = plan_triangular(f.U, cs, lower=False)
            cost = sum(p.level_chunks.shape[0]
                       * (p.level_chunks.shape[1] + p.level_tiles.shape[1])
                       for p in (lp, up))
            if best_cost is None or cost < best_cost:
                best, best_cost = cutoff, cost
        return best

    def _factorize(self, A_factor: sp.csc_matrix) -> HostFactors:
        if self.config.ordering == "nd":
            # pivoting would scramble the chunk-aligned embedding; default
            # to static diagonal pivots (cf. SolverConfig docs)
            thresh = self.config.pivot_threshold
            return factorize_host(
                A_factor, permc_spec="NATURAL",
                diag_pivot_thresh=0.0 if thresh is None else thresh,
            )
        kw = {}
        if self.config.ordering == "natural":
            kw["permc_spec"] = "NATURAL"
        elif self.config.ordering == "mmd":
            kw["permc_spec"] = "MMD_AT_PLUS_A"
        if self.config.pivot_threshold is not None:
            kw["diag_pivot_thresh"] = self.config.pivot_threshold
        return factorize_host(A_factor, **kw)

    def _ext_values(self, A: sp.csc_matrix) -> np.ndarray:
        """Map original csc data to the extended matrix's csc data."""
        ds = self._ext["data_src"]
        return np.where(ds >= 0, A.data[np.maximum(ds, 0)], 1.0)

    def _set_matrix_device(self, A: sp.csc_matrix) -> None:
        """Keep A on device for residual computation (iterative refinement;
        SURVEY.md §7 hard part 2 mitigation — the fp32 accuracy path).

        A is held as dense chunk-grid tiles (ops/spmv.py)."""
        from .ops.spmv import build_spmv_plan

        self._A_host = A  # current csc matrix (make_f64_ldiv's f64 residual)
        self._a_data_dev = jnp.asarray(A.data, dtype=self.dtype)
        cs = min(getattr(self.plan, "cs", 128), 128)
        self._spmv, dest = build_spmv_plan(
            A, cs, dtype=self.dtype, with_dest=True
        )
        self._spmv_dest = jnp.asarray(dest)
        self._spmv_dirty = False

    def matvec(self, x):
        """Device SpMV ``A @ x`` with the current matrix values (batched
        dense-tile matmuls)."""
        from .ops.spmv import apply_spmv, refresh_spmv_values

        if self._spmv_dirty:
            self._spmv = refresh_spmv_values(
                self._spmv, self._spmv_dest, self._a_data_dev
            )
            self._spmv_dirty = False
        x = jnp.asarray(x, dtype=self.dtype)
        squeeze = x.ndim == 1
        xv = x[:, None] if squeeze else x
        y = apply_spmv(self._spmv, xv)
        return y[:, 0] if squeeze else y

    # -- reference-parity attributes ---------------------------------------
    @property
    def m(self) -> int:
        """Size of the input matrix (under ordering="nd" the factored
        matrix is the chunk-aligned extension; see ``n_factor``)."""
        return self._n_orig

    @property
    def n(self) -> int:
        return self._n_orig

    @property
    def n_factor(self) -> int:
        """Dimension of the factored matrix (== n except under "nd")."""
        return self._factors.n

    @property
    def L(self) -> sp.csc_matrix:
        self._materialize_factors()
        return self._factors.L

    @property
    def U(self) -> sp.csc_matrix:
        self._materialize_factors()
        return self._factors.U

    def _materialize_factors(self) -> None:
        """Refresh the host csc factor VALUES from the device solve tiles.

        After a device factorization (``refactor_numeric`` or
        ``factorize="device"``) the numeric truth lives in the packed
        device tiles; the csc factors held for reference parity
        (``F.L``/``F.U``, reference struct fields src:43-62) are stale
        until someone reads them. Lazy and exact: tiles are pulled once,
        un-negated, restricted to real rows/cols, and explicit zeros
        dropped.
        """
        if not getattr(self, "_factors_stale", False):
            return
        self._factors_stale = False
        nf = self.plan.n

        def tocsc(tplan, data):
            cs = tplan.cs
            ar = np.arange(cs)
            rows_parts, cols_parts, vals_parts = [], [], []
            # diagonal tiles k = 0..K-1 at block (k, k)
            dv = np.asarray(data.diag[: tplan.K], dtype=np.float64)
            k = np.arange(tplan.K, dtype=np.int64)
            rows_parts.append(
                np.broadcast_to(
                    k[:, None, None] * cs + ar[None, :, None],
                    dv.shape,
                ).ravel()
            )
            cols_parts.append(
                np.broadcast_to(
                    k[:, None, None] * cs + ar[None, None, :],
                    dv.shape,
                ).ravel()
            )
            vals_parts.append(dv.ravel())
            if tplan.T:
                # off-diagonal tiles stored NEGATED for the solve update
                ov = -np.asarray(data.offdiag[: tplan.T], dtype=np.float64)
                br = tplan.tile_brow[: tplan.T].astype(np.int64)
                bc = tplan.tile_bcol[: tplan.T].astype(np.int64)
                rows_parts.append(
                    np.broadcast_to(
                        br[:, None, None] * cs + ar[None, :, None],
                        ov.shape,
                    ).ravel()
                )
                cols_parts.append(
                    np.broadcast_to(
                        bc[:, None, None] * cs + ar[None, None, :],
                        ov.shape,
                    ).ravel()
                )
                vals_parts.append(ov.ravel())
            r = np.concatenate(rows_parts)
            c = np.concatenate(cols_parts)
            v = np.concatenate(vals_parts)
            m = (r < nf) & (c < nf) & (v != 0.0)
            M = sp.coo_matrix((v[m], (r[m], c[m])), shape=(nf, nf)).tocsc()
            M.sort_indices()
            return M

        self._factors.L = tocsc(self.plan.lplan, self.ldata)
        self._factors.U = tocsc(self.plan.uplan, self.udata)
        # the device refactorization also recomputed the row equilibration
        # (refactor.py sets _rs_blk directly); sync the plan's host copy so
        # re-packs and save() see the live scaling
        self.plan.Rs = np.asarray(self.Rs, dtype=np.float64)
        # The plan's per-nonzero pack maps (diag_dest/offdiag_dest) were
        # sized to the factors the plan was built on; the materialized
        # csc carries the closure fill, so refresh the maps by re-planning
        # on the SAME tile set (extra_tiles = the plan's own tiles — the
        # materialized pattern is a subset, so tile ids, levels and device
        # layouts are unchanged; only the pack maps resize). Keeps
        # save()/from_saved() and host re-packs consistent.
        from .symbolic import plan_triangular

        for attr, M in (("lplan", self._factors.L),
                        ("uplan", self._factors.U)):
            tp = getattr(self.plan, attr)
            extra = list(zip(tp.tile_brow[: tp.T].tolist(),
                             tp.tile_bcol[: tp.T].tolist()))
            new = plan_triangular(M, tp.cs, lower=tp.lower,
                                  extra_tiles=extra)
            assert new.T == tp.T and new.K == tp.K
            setattr(self.plan, attr, new)

    @property
    def p(self) -> np.ndarray:
        return self._factors.p

    @property
    def q(self) -> np.ndarray:
        return self._factors.q

    @property
    def Rs(self) -> np.ndarray:
        rs = self._factors.Rs
        if not isinstance(rs, np.ndarray):  # device array after a device
            rs = np.asarray(rs, dtype=np.float64)  # refactorization
            self._factors.Rs = rs
        return rs

    @property
    def chunk_size(self) -> int:
        return self.plan.cs

    @property
    def total_chunks(self) -> int:
        return self.plan.lplan.K

    # -- device state -------------------------------------------------------
    def _prepare_device(self) -> None:
        """Pack factor nonzeros into tiles and build per-factor kernel data
        (the reference's allocate_chunks + fill_chunks!, src:151-243)."""
        # Everything below (perm plans, scan bands) is
        # baked into the jitted executables as trace-time constants, so any
        # cached executable is stale the moment this rebuilds them. In
        # particular a NON-reallocating host refactor() can move pivots
        # under an identical L/U pattern signature (SuperLU re-pivots on
        # value changes), and a cached ldiv closing over the OLD
        # permutation would silently misroute the NEW factors.
        self._jit_cache.clear()
        # numeric-state generation token: baked callables (make_f64_ldiv)
        # capture it and fail loudly on use-after-refactor (VERDICT r4 #6)
        self._generation = getattr(self, "_generation", 0) + 1
        plan = self.plan
        ldiag, loff = pack_factor(
            plan.lplan, np.asarray(self._factors.L.data, dtype=self.dtype)
        )
        udiag, uoff = pack_factor(
            plan.uplan, np.asarray(self._factors.U.data, dtype=self.dtype)
        )
        mode = self.config.tri_mode
        with jax.default_matmul_precision(self.config.matmul_precision):
            self.ldata: TriKernelData = prepare_tri_kernel(
                plan.lplan, ldiag, loff, tri_mode=mode,
            )
            self.udata: TriKernelData = prepare_tri_kernel(
                plan.uplan, udiag, uoff, tri_mode=mode,
            )
        # permutation/scaling for ldiv (src:324-339): row-gather plans on
        # the blocked carriers (ops/permute.py), plus the plain vectors
        # for the sharded path
        from .ops.permute import build_perm_plan

        self._p_dev = jnp.asarray(plan.p)
        self._qinv_dev = jnp.asarray(plan.qinv)
        self._rs_p_dev = jnp.asarray(plan.Rs[plan.p], dtype=self.dtype)
        cs = plan.cs
        n_in = self._n_orig
        self._K_in = -(-n_in // cs)
        if self._ext is None:
            n = plan.n
            self._pvec, self._qvec = plan.p, plan.qinv
            self._pperm = build_perm_plan(plan.p, n, cs)
            self._qperm = build_perm_plan(plan.qinv, n, cs)
            rs_orig = plan.Rs
        else:
            # composite maps through the nd embedding:
            #   wrk[i] = (Rs ⊙ b_ext)[p[i]],  b_ext[e] = b[ext_src[e]]
            #   x[j]   = wrk[qinv[ext_pos[j]]]
            src, pos = self._ext["src"], self._ext["pos"]
            comp_p = np.where(plan.p < src.shape[0], src[plan.p], -1)
            self._pperm = build_perm_plan(comp_p, plan.n, cs, n_in=n_in)
            comp_q = plan.qinv[pos]
            self._qperm = build_perm_plan(comp_q, n_in, cs, n_in=plan.n)
            self._pvec, self._qvec = comp_p, comp_q
            rs_orig = plan.Rs[pos]  # per ORIGINAL row
        # Rs in input row order: scale before permuting
        # ((Rs .* b)[p] == P(Rs ⊙ b)) — no Rs[p] gather on refactor.
        rs = np.zeros(self._K_in * cs + cs, dtype=self.dtype)
        rs[:n_in] = rs_orig
        self._rs_blk = jnp.asarray(rs.reshape(self._K_in + 1, cs, 1))
        self._prepare_scan_path()

    def _prepare_scan_path(self) -> None:
        """Detect bidiagonal factors (1-D chain matrices) and stage the
        log-depth associative-scan substitution path (ops/scan_solve.py).
        A chain's chunk DAG has no width for the tile engines to exploit;
        the scan path solves it in O(log n) parallel depth instead."""
        from .ops.scan_solve import bidiag_bands

        self._scan_bands = None
        self._scan_perm_id = False
        lb = bidiag_bands(self._factors.L, lower=True)
        if lb is None:
            return
        ub = bidiag_bands(self._factors.U, lower=False)
        if ub is None:
            return
        dt = self.dtype
        self._scan_bands = {
            "ld": jnp.asarray(lb["diag"], dt),
            "lo": jnp.asarray(lb["off"], dt),
            "ud": jnp.asarray(ub["diag"], dt),
            "uo": jnp.asarray(ub["off"], dt),
        }
        n = self.plan.n
        # the fused scale→lsolve→rsolve scan ldiv additionally requires
        # trivial pivot permutations (true for no-pivot/banded orderings)
        self._scan_perm_id = (
            self._ext is None
            and np.array_equal(self.plan.p, np.arange(n))
            and np.array_equal(self.plan.q, np.arange(n))
        )
        self._rs_vec = jnp.asarray(self.plan.Rs, dt)[:, None]

    @property
    def _tile_lu(self) -> bool:
        """Whether device refactorizations factor their diagonal tiles
        with the compiled tile-LU kernel (utils/config.backend_policy)."""
        return backend_policy().use_tile_lu(self.plan.cs, self.dtype)

    # -- functional core (jitted per RHS shape) -----------------------------
    def _exe(self, kind: str):
        """Build (and cache) the jitted executable for `kind`."""
        if kind in self._jit_cache:
            return self._jit_cache[kind]
        plan = self.plan
        mode = self.config.tri_mode
        schedule = self.config.schedule
        prec = self.config.matmul_precision
        n, cs = plan.n, plan.cs

        def _prec(f):
            def wrapped(*a):
                with jax.default_matmul_precision(prec):
                    return f(*a)
            return wrapped

        def tri(tplan, tdata, xw):
            return blocked_tri_solve(
                tplan, tdata, xw, tri_mode=mode, schedule=schedule
            )

        n_in = self._n_orig
        K_in = self._K_in

        def lsolve(ldata, b):
            xw = block_rhs(b, n, plan.lplan.K, cs)
            return unblock_rhs(tri(plan.lplan, ldata, xw), n)

        def rsolve(udata, b):
            xw = block_rhs(b, n, plan.uplan.K, cs)
            return unblock_rhs(tri(plan.uplan, udata, xw), n)

        def ldiv(ldata, udata, pperm, qperm, rs_blk, b):
            from .ops.permute import apply_perm

            xw = block_rhs(b, n_in, K_in, cs)
            # wrk = (Rs .* b)[p] == P(Rs ⊙ b)  (src:324-327) — scale in
            # input order, then permute (composed with the nd embedding
            # when active)
            xw = xw * rs_blk
            xw = apply_perm(pperm, xw)
            xw = tri(plan.lplan, ldata, xw)  # forward subst. (src:330)
            xw = tri(plan.uplan, udata, xw)  # backward subst. (src:333)
            # un-pivot: x[q] = wrk  (src:337-339)
            xw = apply_perm(qperm, xw)
            return unblock_rhs(xw, n_in)

        from .ops.scan_solve import scan_bidiag_solve

        def lsolve_scan(ld, lo, b):
            return scan_bidiag_solve(ld, lo, b, lower=True)

        def rsolve_scan(ud, uo, b):
            return scan_bidiag_solve(ud, uo, b, lower=False)

        def ldiv_scan(rs, ld, lo, ud, uo, b):
            # Rs ⊙ b then both scans (src:324-339; p == q == identity here)
            w = rs * b
            w = scan_bidiag_solve(ld, lo, w, lower=True)
            return scan_bidiag_solve(ud, uo, w, lower=False)

        fns = {
            "lsolve": lambda: jax.jit(_prec(lsolve)),
            "rsolve": lambda: jax.jit(_prec(rsolve)),
            "ldiv": lambda: jax.jit(_prec(ldiv)),
            "lsolve_scan": lambda: jax.jit(lsolve_scan),
            "rsolve_scan": lambda: jax.jit(rsolve_scan),
            "ldiv_scan": lambda: jax.jit(ldiv_scan),
        }
        self._jit_cache[kind] = fns[kind]()
        return self._jit_cache[kind]

    # -- public solves ------------------------------------------------------
    def _as_rhs(self, b, n=None):
        n = self.n if n is None else n
        b = jnp.asarray(b, dtype=self.dtype)
        if b.shape[0] != n:
            raise ValueError(
                f"`b` does not have same size as F: {b.shape[0]} vs n={n}"
            )
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        return b, squeeze

    def lsolve(self, b):
        """Solve ``L y = b`` (reference ``lsolve!``, src:349-367).

        Under ordering="nd" the factors live on the extended matrix:
        ``b`` has length ``n_factor``."""
        b, squeeze = self._as_rhs(b, self.n_factor)
        if self._scan_bands is not None:
            sb = self._scan_bands
            y = self._exe("lsolve_scan")(sb["ld"], sb["lo"], b)
        else:
            y = self._exe("lsolve")(self.ldata, b)
        return y[:, 0] if squeeze else y

    def rsolve(self, b):
        """Solve ``U y = b`` (reference ``rsolve!``, src:374-392)."""
        b, squeeze = self._as_rhs(b, self.n_factor)
        if self._scan_bands is not None:
            sb = self._scan_bands
            y = self._exe("rsolve_scan")(sb["ud"], sb["uo"], b)
        else:
            y = self._exe("rsolve")(self.udata, b)
        return y[:, 0] if squeeze else y

    def ldiv(self, b, *, refine_steps: int = 0):
        """Solve ``A x = b`` (reference ``ldiv!``, src:286-342).

        ``b`` may be ``(n,)`` or ``(n, R)`` — multi-RHS batches the entire
        solve into tile matmuls (SpSM; BASELINE.md config 3).

        ``refine_steps`` — iterative-refinement sweeps: after the direct
        solve, ``x += solve(b - A x)`` that many times. One step recovers
        full precision when the static-pivot device refactorization (or an
        fp32 factorization) loses digits to conditioning.
        """
        if self.m != self.n:
            raise ValueError(f"`F` is not square: m={self.m}, n={self.n}")
        b, squeeze = self._as_rhs(b)
        exe, args = self._ldiv_callable()
        x = exe(*args, b)
        for _ in range(refine_steps):
            r = b - self.matvec(x)
            x = x + exe(*args, r)
        return x[:, 0] if squeeze else x

    def _ldiv_callable(self):
        """(jitted executable, device args) for the full ldiv: ``exe(*args,
        b)``. Harnesses pass the args explicitly so that jitted wrappers
        take the factors as arguments, not as baked-in constants."""
        if self._scan_bands is not None and self._scan_perm_id:
            sb = self._scan_bands
            return self._exe("ldiv_scan"), (
                self._rs_vec, sb["ld"], sb["lo"], sb["ud"], sb["uo"],
            )
        exe = self._exe("ldiv")
        args = (self.ldata, self.udata, self._pperm, self._qperm,
                self._rs_blk)
        return exe, args

    solve = ldiv
    __call__ = ldiv

    def make_f64_ldiv(self, *, refine_steps: int = 2):
        """f64-accuracy solve: f32 direct solve + f64-residual refinement.

        The reference's numeric regime is float64 end-to-end — UMFPACK
        factors in f64 (/root/reference/src/SharedMemSparseLU.jl:74) and
        the test bar is 1e-12 (/root/reference/test/runtests.jl:25). A
        native-f64 solver (``dtype="float64"``) meets the bar directly;
        this tier instead runs classic mixed-precision iterative
        refinement on an f32 factorization:

            x_0 = solve_f32(b);   x_{k+1} = x_k + solve_f32(b - A x_k)

        with the residual ``b - A x`` computed in float64 (block-tile
        SpMV, ops/spmv.py) and ``x`` accumulated in float64, while every
        direct solve is the f32 solve. Each sweep contracts the error by
        ~kappa(A)*eps_f32, so 2-3 sweeps reach the 1e-12 bar for the
        reference's matrix families. Whether it beats the native f64
        solver is a property of the device's f64 rate.

        Requires ``jax_enable_x64`` (process-global) and an f32
        factorization. Returns ``solve(b) -> x`` (float64 in/out,
        ``(n,)`` or ``(n, R)``). The returned callable bakes the current
        numeric state; calling it after ``refactor``/``refactor_numeric``/
        ``from_saved`` changed that state raises ``RuntimeError`` (a
        generation-token guard — silently solving with stale factors is
        the worst failure mode a solver API can have). Rebuild the
        callable after any refactorization.
        """
        if not jax.config.jax_enable_x64:
            raise RuntimeError(
                "make_f64_ldiv needs jax_enable_x64 (set it at process "
                "start); the f64 residual cannot be represented otherwise"
            )
        if jnp.dtype(self.dtype).itemsize != 4:
            raise ValueError(
                "make_f64_ldiv refines an f32 factorization; this solver "
                f"was built with dtype={self.dtype}"
            )
        from .ops.spmv import (
            apply_dia, apply_spmv, build_dia_plan, build_spmv_plan,
        )

        # DIA-format f64 residual when the pattern is banded/stencil-like
        # (the library's target families): it skips the dense tiles'
        # zeros — see ops/spmv.py DiaPlan
        spmv64 = build_dia_plan(self._A_host, dtype=np.float64)
        matvec64 = apply_dia
        if spmv64 is None:  # scattered pattern: dense-tile fallback
            spmv64 = build_spmv_plan(
                self._A_host, min(self.plan.cs, 128), dtype=np.float64
            )
            matvec64 = apply_spmv
        exe, args = self._ldiv_callable()
        steps = int(refine_steps)
        n = self.n
        gen = self._generation  # numeric state this callable bakes

        @jax.jit
        def run(spmv64, args, b64):
            def solve32(v):
                return exe(*args, v.astype(jnp.float32))

            x = solve32(b64).astype(jnp.float64)
            for _ in range(steps):
                r = b64 - matvec64(spmv64, x)
                x = x + solve32(r).astype(jnp.float64)
            return x

        def solve(b):
            if self._generation != gen:
                raise RuntimeError(
                    "stale make_f64_ldiv solve: a refactorization replaced "
                    "the numeric state this callable was built on; call "
                    "make_f64_ldiv() again (generation "
                    f"{gen} -> {self._generation})"
                )
            b = jnp.asarray(b, jnp.float64)
            if b.shape[0] != n:
                raise ValueError(
                    f"`b` does not have same size as F: {b.shape[0]} vs {n}"
                )
            squeeze = b.ndim == 1
            if squeeze:
                b = b[:, None]
            x = run(spmv64, args, b)
            return x[:, 0] if squeeze else x

        return solve

    # -- refactorization ----------------------------------------------------
    def refactor(self, A: Optional[sp.spmatrix]) -> None:
        """Full host refactorization — reference ``lu!(F, A)`` (src:245-279).

        Re-runs the backend (which may re-pivot, like UMFPACK's numeric
        phase), detects a sparsity-pattern change exactly as the reference
        does (src:252-258), re-plans only when the pattern changed
        (src:265-273), and always re-packs (src:274-276). ``A=None`` is
        accepted for parity (src:246) and is a no-op re-pack.
        """
        if A is None:
            # sync host csc values/Rs first: after a device refactorization
            # they are stale and a bare re-pack would silently restore the
            # OLD factorization
            self._materialize_factors()
            self._prepare_device()
            return
        A = sp.csc_matrix(A)
        A.sort_indices()
        old_sig = self._factors.pattern_signature()
        A_factor = A
        if self._ext is not None:
            if (A.indptr.tobytes(), A.indices.tobytes()) != self._a_pattern_sig:
                # pattern changed: rebuild the nd embedding from scratch
                from .ordering import staged_extension

                A_ext, ext_src, ext_pos, data_src = staged_extension(
                    A, self.plan.cs, cutoff=self._nd_cutoff
                )
                self._ext = {"src": ext_src, "pos": ext_pos,
                             "data_src": data_src}
                A_factor = A_ext
            else:
                indptr, indices = self._a_factor_pattern
                A_factor = sp.csc_matrix(
                    (self._ext_values(A), indices, indptr),
                    shape=(indptr.shape[0] - 1, indptr.shape[0] - 1),
                )
        new_factors = self._factorize(A_factor)
        reallocate = new_factors.pattern_signature() != old_sig
        self._factors = new_factors
        self._factors_stale = False  # fresh host csc values
        self._a_factor_pattern = (
            A_factor.indptr.copy(), A_factor.indices.copy()
        )
        # Pivots (and possibly the pattern) may have moved: any cached
        # static-pivot refactorization schedule is stale.
        self._a_pattern = (A.indptr.copy(), A.indices.copy())
        self._a_pattern_sig = (A.indptr.tobytes(), A.indices.tobytes())
        self._refactor_plan = None
        self._set_matrix_device(A)
        if reallocate:
            self.plan = build_symbolic_plan(new_factors, self.plan.cs)
            self._jit_cache.clear()
        else:
            # Same L/U pattern, but the backend may still have picked new
            # pivots/scaling — refresh them unconditionally, exactly like
            # the reference's in-place copies (src:261-263).
            self.plan.p = new_factors.p.astype(np.int32)
            self.plan.q = new_factors.q.astype(np.int32)
            self.plan.Rs = new_factors.Rs
            self.plan.qinv = np.argsort(new_factors.q).astype(np.int32)
        self._prepare_device()

    @property
    def has_device_refactor(self) -> bool:
        return self._refactor_plan is not None

    def enable_device_refactor(
        self, *, store_budget: Optional[int] = None
    ) -> None:
        """Build (once) the static device-refactorization schedule.

        Rebuilds the solve plans on the blocked-fill closure of the input
        pattern (a tile superset of the factors' own patterns) so refactored
        tiles feed the solve engine directly, then re-packs the current
        factors onto the widened plans.

        ``store_budget`` — device working-set ceiling in bytes for the
        memory guard below (default: ``SolverConfig.refactor_store_budget``,
        else the device's own limit, :func:`device_memory_budget`; no
        limit where the backend reports none).
        """
        if self._refactor_plan is not None:
            return
        lplan, uplan, rp, _ = self._refactor_schedule(
            self._refactor_limit(store_budget))
        self.plan.lplan = lplan
        self.plan.uplan = uplan
        self._jit_cache.clear()
        self._refactor_plan = rp
        self._upload_refactor_dev(rp)
        self._prepare_device()

    def refactor_footprint(self) -> Tuple[int, Optional[int]]:
        """``(bytes, budget)``: the device refactorization's working-set
        estimate and the ceiling :meth:`enable_device_refactor`'s memory
        guard holds it to (None: no limit). Host work only: where the
        schedule is not built yet it is planned and not installed, so a
        solver the guard would refuse reports its footprint instead."""
        budget = self._refactor_limit()
        if self._refactor_plan is None:
            return self._refactor_schedule(None)[3], budget
        return _refactor_working_set(
            self._refactor_plan, self.plan.lplan, self.plan.uplan,
            self.plan.cs, jnp.dtype(self.dtype).itemsize,
            self.config.tri_mode), budget

    def _refactor_schedule(self, limit: Optional[int]):
        """Plan the device refactorization on the host: ``(lplan, uplan,
        rp, working-set bytes)``, refused with a clear error where the
        working set exceeds ``limit`` (None: no check)."""
        from .refactor import build_refactor_plan, closure_solve_plans

        # the refactor plan lives on the FACTORED pattern (extended when
        # ordering="nd")
        indptr, indices = self._a_factor_pattern
        nf = indptr.shape[0] - 1
        A_pat = sp.csc_matrix(
            (np.ones(indices.shape[0]), indices, indptr), shape=(nf, nf)
        )
        lplan, uplan = closure_solve_plans(
            A_pat, self._factors.L, self._factors.U,
            self._factors.p, self._factors.q, self.plan.cs,
        )
        # the merged tile store materializes the blocked elimination
        # closure as dense tiles; refuse clearly when that would not fit
        # on the device (e.g. nd-ordered 2D problems at n ~ 1e5 close to
        # a near-dense tile grid). The host `refactor()` path remains.
        itemsize = jnp.dtype(self.dtype).itemsize
        cs = self.plan.cs

        def refuse(nbytes: int, detail: str) -> None:
            raise RuntimeError(
                "device refactorization needs a working set of "
                f"~{nbytes / 1e9:.1f} GB ({detail}), above the budget "
                f"({limit / 1e9:.1f} GB). Use the host refactor() path, a "
                "smaller chunk_size, ordering='colamd' for this matrix, or "
                "raise the budget via enable_device_refactor("
                "store_budget=...) / SolverConfig.refactor_store_budget."
            )

        # fail fast before the (possibly long) host scheduling: a 4x
        # envelope over the merged tile store
        store_bytes = _refactor_store_envelope(lplan, uplan, cs, itemsize)
        if limit is not None and store_bytes > limit:
            refuse(store_bytes, "dense tile store of the elimination "
                   "closure + solve extraction")
        rp = build_refactor_plan(
            A_pat, self._factors.p, self._factors.q, self.plan.cs,
            lplan, uplan,
            data_src=None if self._ext is None else self._ext["data_src"],
        )
        # precise guard now that the level schedule exists
        total = _refactor_working_set(rp, lplan, uplan, cs, itemsize,
                                      self.config.tri_mode)
        if limit is not None and total > limit:
            refuse(total, "tile store + per-level inverse stacks + "
                   "assembly value table")
        return lplan, uplan, rp, total

    def _refactor_limit(self, store_budget: Optional[int] = None):
        return (store_budget or self.config.refactor_store_budget
                or device_memory_budget())

    def _upload_refactor_dev(self, rp) -> None:
        # one-time upload of the static schedule (the fused refactor
        # pipeline takes these as device-resident arguments)
        self._refactor_dev = {
            "win_src": jnp.asarray(rp.win.win_src),
            "win_dst": jnp.asarray(rp.win.win_dst),
            "win_mask": jnp.asarray(rp.win.win_mask),
            "left_src": jnp.asarray(rp.win.left_src),
            "left_row": jnp.asarray(rp.win.left_row),
            "left_col": jnp.asarray(rp.win.left_col),
            "ones_row": jnp.asarray(rp.win.ones_row),
            "ones_col": jnp.asarray(rp.win.ones_col),
            "brow2_tiles": jnp.asarray(rp.win.brow2_tiles),
            "tile_brow2": jnp.asarray(rp.win.tile_brow2),
            "permrow_src": jnp.asarray(rp.win.permrow_src),
            "pad_row": jnp.asarray(rp.win.pad_row),
            "pad_col": jnp.asarray(rp.win.pad_col),
            "diag_ids": jnp.asarray(rp.diag_ids),
            "diag_cnt": jnp.asarray(rp.diag_cnt),
            "row_ids": jnp.asarray(rp.row_ids),
            "row_owner": jnp.asarray(rp.row_owner),
            "col_ids": jnp.asarray(rp.col_ids),
            "col_owner": jnp.asarray(rp.col_owner),
            "schur": jnp.asarray(rp.schur),
            "diag_src": jnp.asarray(rp.diag_src),
            "l_off_src": jnp.asarray(rp.l_off_src),
            "u_off_src": jnp.asarray(rp.u_off_src),
            "diag_lvlslot": jnp.asarray(rp.diag_lvlslot),
        }

    def refactor_numeric(self, A: sp.spmatrix, *, check: bool = False,
                         growth_limit: float = 1e7) -> bool:
        """Device-side same-pattern numeric refactorization (static pivots).

        The device counterpart of UMFPACK's numeric-only ``lu!``
        (src:247): reuses the cached symbolic schedule (pivot order, fill
        pattern, tile plan) and recomputes only numeric values on device.
        Requires ``A`` to have the same sparsity pattern as the matrix this
        factorization was built from.

        Unlike UMFPACK, no numerical re-pivoting happens (the point of the
        static-pivot design); ``self.refactor_diagnostics`` afterwards
        holds device scalars ``min_pivot`` and ``growth`` (max |factor
        entry| of the equilibrated system — ~1 for benign updates). With
        ``check=True`` the diagnostics are synced and a value change that
        broke the frozen pivots (non-finite / growth > ``growth_limit`` /
        zero pivot) triggers an automatic fall back to the host
        ``refactor`` path, which re-pivots. Returns True when the device
        factorization was kept.
        """
        from .refactor import refactor_same_pattern

        return refactor_same_pattern(
            self, sp.csc_matrix(A), check=check, growth_limit=growth_limit
        )

    def make_refactor_solve_step(self, *, refine_steps: int = 0):
        """Fully-fused production step: ``step(a_data, b) -> x`` where
        ``a_data`` is A's new nonzero values (same pattern, original CSC
        order) and ``b`` an ``(n, R)`` RHS panel.

        Refactorizes (device, static pivots) and solves inside ONE jitted
        program — the shape of a PDE time-stepper's inner loop (update
        coefficients → lu! → ldiv!, the reference lifecycle,
        test/runtests.jl:108-188) with zero intermediate host syncs.
        Does not mutate F's cached state; call ``refactor_numeric`` for
        that.

        ``refine_steps`` — in-step iterative-refinement sweeps: after the
        direct solve, ``x += solve(b - A x)`` reusing the in-program SpMV
        tiles (refreshed from ``a_data``). One step recovers the two-call
        path's accuracy in fp32.
        """
        from .ops.permute import apply_perm
        from .ops.spmv import apply_spmv, refresh_spmv_values
        from .refactor import _refactor_pipeline
        from .solve import TriKernelData, blocked_tri_solve

        self.enable_device_refactor()
        rp = self._refactor_plan
        dev = self._refactor_dev
        plan = self.plan
        mode = self.config.tri_mode
        n, cs, K = plan.n, plan.cs, plan.lplan.K
        prec = self.config.matmul_precision
        tile_lu = self._tile_lu

        def mk(tplan, diag, off, dinv):
            return TriKernelData(
                diag=diag, diag_inv=dinv, offdiag=off,
                level_chunks=jnp.asarray(tplan.level_chunks),
                level_tiles=jnp.asarray(tplan.level_tiles),
                tile_brow=jnp.asarray(tplan.tile_brow),
                tile_bcol=jnp.asarray(tplan.tile_bcol),
            )

        n_in, K_in = self._n_orig, self._K_in
        ext = self._ext
        ext_pos = None if ext is None else jnp.asarray(ext["pos"])

        @jax.jit
        def step(a_data, b, pperm, qperm, spmv, spmv_dest):
            with jax.default_matmul_precision(prec):
                # the nd embedding's value mapping is folded into the
                # windowed-assembly schedule (assemble.py data_src), so
                # original CSC values go straight into the pipeline
                a_orig = a_data = a_data.astype(self.dtype)
                out = _refactor_pipeline(
                    a_data, dev,
                    n=rp.n, cs=rp.cs, TF=rp.TF, TF2=rp.win.TF2,
                    W=rp.win.W, R1=rp.win.R1, Np=rp.win.Np, tri_mode=mode,
                    tile_lu=tile_lu,
                )
                rs = out["rs"]
                if ext is not None:
                    rs = rs[ext_pos]
                rs_pad = jnp.zeros((K_in * cs + cs,), self.dtype).at[
                    :n_in].set(rs.astype(self.dtype))
                rs_blk = rs_pad.reshape(K_in + 1, cs, 1)
                b32 = b.astype(self.dtype)
                ldata = mk(plan.lplan, out["ldiag"], out["loff"],
                           out.get("ldiag_inv"))
                udata = mk(plan.uplan, out["udiag"], out["uoff"],
                           out.get("udiag_inv"))

                def solve(v):
                    xw = block_rhs(v, n_in, K_in, cs) * rs_blk
                    xw = apply_perm(pperm, xw)
                    xw = blocked_tri_solve(
                        plan.lplan, ldata, xw, tri_mode=mode,
                        schedule=self.config.schedule,
                    )
                    xw = blocked_tri_solve(
                        plan.uplan, udata, xw, tri_mode=mode,
                        schedule=self.config.schedule,
                    )
                    xw = apply_perm(qperm, xw)
                    return unblock_rhs(xw, n_in)

                x = solve(b32)
                if refine_steps:
                    # in-step refinement: SpMV tiles refreshed from the
                    # SAME a_data this step factorizes (original values)
                    spmv_new = refresh_spmv_values(spmv, spmv_dest, a_orig)
                    for _ in range(refine_steps):
                        x = x + solve(b32 - apply_spmv(spmv_new, x))
                return x

        def run(a_data, b):
            # the step closes over this factorization's static schedule; a
            # host refactor() (which may re-pivot) rebuilds that schedule,
            # so a step made before it must not silently misroute
            if self._refactor_plan is not rp:
                raise RuntimeError(
                    "stale refactor-solve step: refactor() rebuilt the "
                    "factorization after this step was created; call "
                    "make_refactor_solve_step() again"
                )
            return step(
                jnp.asarray(a_data), jnp.asarray(b), self._pperm,
                self._qperm, self._spmv, self._spmv_dest,
            )

        return run


    # -- persistence (SURVEY.md §5.4) ----------------------------------------
    def save_symbolic(self, path: str) -> None:
        """Persist just the symbolic schedule (SURVEY.md §5.4); see
        :meth:`save` for the full reusable factorization state."""
        self.plan.save(path)

    def save(self, path: str, *, compress: bool = False,
             values: object = "auto") -> None:
        """Persist everything host-computed — factors (patterns AND
        values), permutations, scaling, the symbolic plan, the nd
        embedding, the config — so :meth:`from_saved` can rebuild this
        solver without re-running SuperLU or the planner.

        The disk analogue of the reference keeping its UMFPACK object
        alive across refactorizations (src:53-54, :247): at n=90k the
        host construct (splu + normalization + planning) costs tens of
        seconds per process; a reload costs deserialization + device
        upload only. Uncompressed by default — zlib costs ~50 s on an
        80M-nnz factor pair (measured) for a ~2x size win; pass
        ``compress=True`` to trade CPU for disk.

        ``values`` (VERDICT r4 #8) — whether to persist the factor
        VALUES (the dominant bytes of the file: nnz(LU) ≫ nnz(A)):

        * ``"auto"`` (default): skip them when this solver has a device
          refactorization schedule (:meth:`has_device_refactor`) —
          :meth:`from_saved` then recomputes the values from ``A``'s
          nonzeros via the one-dispatch device elimination, which is
          how this solver produced its live values anyway. The
          refactor schedule itself is persisted, so the load pays no
          closure re-planning.
        * ``False``: force the light save; builds the device-refactor
          schedule first when missing (may raise its HBM-budget error
          — matrices whose closure store cannot fit must keep values).
        * ``True``: always store values (any solver, any loader).
        """
        import dataclasses as _dc
        import json

        if values is False and self._refactor_plan is None:
            self.enable_device_refactor()  # raises clearly when infeasible
        light = values is False or (
            values == "auto" and self._refactor_plan is not None
        )
        if not light:
            # device-factorized values live in the tiles; sync csc copies
            self._materialize_factors()
        flat = {
            "version": np.int64(1),
            "n_orig": np.int64(self._n_orig),
            "config_json": np.frombuffer(
                json.dumps(_dc.asdict(self.config)).encode(), dtype=np.uint8
            ),
            "nd_cutoff": np.int64(
                -1 if not isinstance(self._nd_cutoff, int) else self._nd_cutoff
            ),
            # input pattern + a value fingerprint: from_saved verifies the
            # pattern exactly and re-factorizes on device when only the
            # VALUES moved (the saved factor values belong to the saved A)
            "a_indptr": self._a_pattern[0],
            "a_indices": self._a_pattern[1],
            "a_data": np.asarray(self._A_host.data),
        }
        f = self._factors
        # factor VALUES travel at the solver's working precision: the
        # device only ever consumes them at self.dtype (pack_factor), so
        # an f32 solver's save halves the dominant bytes of the file and
        # of the reload (VERDICT r4 #8; at n=90k the factor values are
        # ~1.5 GB of a 1.6 GB save)
        vdt = np.dtype(self.dtype)
        flat.update(
            f_n=np.int64(f.n), f_m=np.int64(f.m),
            L_indptr=f.L.indptr, L_indices=f.L.indices,
            U_indptr=f.U.indptr, U_indices=f.U.indices,
            p=f.p, q=f.q, Rs=self.Rs,
        )
        if light:
            # values-less save: persist the device-refactor schedule so
            # the load runs the one-dispatch elimination directly —
            # pattern + plans only, no nnz(LU)-sized value arrays
            flat["light"] = np.int64(1)
            rp = self._refactor_plan
            from .assemble import WindowPlan as _WP
            from .refactor import RefactorPlan as _RP

            for fld in _dc.fields(_RP):
                if fld.name == "win":
                    continue
                flat[f"rp_{fld.name}"] = np.asarray(getattr(rp, fld.name))
            for fld in _dc.fields(_WP):
                flat[f"rpw_{fld.name}"] = np.asarray(getattr(rp.win, fld.name))
        else:
            flat.update(
                L_data=np.asarray(f.L.data, dtype=vdt),
                U_data=np.asarray(f.U.data, dtype=vdt),
            )
        if self._ext is not None:
            flat.update(
                ext_src=self._ext["src"], ext_pos=self._ext["pos"],
                ext_data_src=self._ext["data_src"],
                af_indptr=self._a_factor_pattern[0],
                af_indices=self._a_factor_pattern[1],
            )
        from .symbolic import TriPlan as _TriPlan

        plan = self.plan
        flat.update(plan_n=np.int64(plan.n), plan_cs=np.int64(plan.cs),
                    plan_p=plan.p, plan_q=plan.q, plan_Rs=plan.Rs,
                    plan_qinv=plan.qinv)
        for name, tp in (("l", plan.lplan), ("u", plan.uplan)):
            for fld in _dc.fields(_TriPlan):
                flat[f"{name}_{fld.name}"] = np.asarray(getattr(tp, fld.name))
        (np.savez_compressed if compress else np.savez)(path, **flat)

    @classmethod
    def from_saved(cls, A: sp.spmatrix, path: str,
                   *, on_value_change: str = "refactor"):
        """Rebuild a solver from :meth:`save` output, skipping SuperLU and
        all host planning (VERDICT r3 #5; reference analogue: live
        ``lu_object`` reuse, src:53-54).

        ``A`` must have exactly the sparsity pattern the state was saved
        from (a clear error otherwise — the reference's reallocate path,
        src:265-273, needs a full construct). If A's VALUES differ from
        the saved ones, the saved factors are stale; ``on_value_change``
        says what to do: ``"refactor"`` (default) runs the device
        static-pivot numeric refactorization, ``"error"`` raises.
        """
        import dataclasses
        import json

        from .symbolic import SymbolicPlan as _SP
        from .symbolic import TriPlan as _TriPlan

        z = np.load(path)
        if int(z["version"]) != 1:
            raise ValueError(f"unknown save version {int(z['version'])}")
        A = sp.csc_matrix(A)
        A.sort_indices()
        if (not np.array_equal(A.indptr, z["a_indptr"])
                or not np.array_equal(A.indices, z["a_indices"])):
            raise ValueError(
                "matrix sparsity pattern differs from the saved state; "
                "from_saved requires the exact saved pattern — construct "
                "a new ParallelSparseLU for pattern changes"
            )
        cfg_json = json.loads(bytes(z["config_json"]).decode())
        self = cls.__new__(cls)
        self.config = SolverConfig.from_dict(cfg_json)
        self._n_orig = int(z["n_orig"])
        self.dtype = _resolve_dtype(self.config.dtype, A.dtype)
        nd = int(z["nd_cutoff"])
        self._nd_cutoff = self.config.nd_cutoff if nd < 0 else nd
        self._ext = None
        if "ext_src" in z.files:
            self._ext = {"src": z["ext_src"], "pos": z["ext_pos"],
                         "data_src": z["ext_data_src"]}
        light = "light" in z.files and int(z["light"]) == 1
        nf = int(z["f_n"])

        def fdata(prefix):
            if not light:
                return z[f"{prefix}_data"]
            # values-less save: identity placeholder values (diag 1,
            # off-diag 0 — finite through the initial pack/invert, then
            # immediately replaced by the device elimination below), the
            # same trick as the ``factorize="device"`` constructor
            indptr, indices = z[f"{prefix}_indptr"], z[f"{prefix}_indices"]
            cols = np.repeat(np.arange(nf, dtype=np.int64),
                             np.diff(indptr))
            return (indices == cols).astype(np.float64)

        self._factors = HostFactors(
            m=int(z["f_m"]), n=nf,
            L=sp.csc_matrix((fdata("L"), z["L_indices"], z["L_indptr"]),
                            shape=(nf, nf)),
            U=sp.csc_matrix((fdata("U"), z["U_indices"], z["U_indptr"]),
                            shape=(nf, nf)),
            p=z["p"], q=z["q"], Rs=z["Rs"],
        )

        def tri(prefix):
            kw = {}
            for fld in dataclasses.fields(_TriPlan):
                v = z[f"{prefix}_{fld.name}"]
                if fld.name in ("n", "cs", "K", "T"):
                    v = int(v)
                elif fld.name == "lower":
                    v = bool(v)
                kw[fld.name] = v
            return _TriPlan(**kw)

        self.plan = _SP(
            n=int(z["plan_n"]), cs=int(z["plan_cs"]),
            lplan=tri("l"), uplan=tri("u"),
            p=z["plan_p"], q=z["plan_q"], Rs=z["plan_Rs"],
            qinv=z["plan_qinv"],
        )
        self._a_pattern = (z["a_indptr"].copy(), z["a_indices"].copy())
        self._a_pattern_sig = (
            self._a_pattern[0].tobytes(), self._a_pattern[1].tobytes()
        )
        if self._ext is None:
            self._a_factor_pattern = self._a_pattern
        else:  # extended factor pattern saved alongside the embedding
            self._a_factor_pattern = (z["af_indptr"].copy(),
                                      z["af_indices"].copy())
        self._refactor_plan = None
        self._jit_cache = {}
        self._factors_stale = False
        self._set_matrix_device(A)
        self._prepare_device()
        vals_changed = not np.array_equal(
            np.asarray(A.data, dtype=np.float64),
            np.asarray(z["a_data"], dtype=np.float64),
        )
        if vals_changed and on_value_change == "error":
            raise ValueError(
                "matrix values differ from the saved state (same "
                "pattern); pass on_value_change='refactor' to run the "
                "device numeric refactorization"
            )
        if light:
            # rebuild the persisted device-refactor schedule (no closure
            # re-planning) and compute the factor values from A's
            # nonzeros — the load-time counterpart of the
            # ``factorize="device"`` constructor
            from .assemble import WindowPlan as _WP
            from .refactor import RefactorPlan as _RP

            def load_dc(cls, prefix, **extra):
                kw = dict(extra)
                for fld in dataclasses.fields(cls):
                    if fld.name in kw:
                        continue
                    v = z[f"{prefix}_{fld.name}"]
                    kw[fld.name] = int(v) if fld.type in (int, "int") else v
                return cls(**kw)

            win = load_dc(_WP, "rpw")
            self._refactor_plan = load_dc(_RP, "rp", win=win)
            self._upload_refactor_dev(self._refactor_plan)
            self.refactor_numeric(A)
        elif vals_changed:
            self.refactor_numeric(A)
        return self

    def close(self) -> None:
        """Release device buffers (analogue of the reference's exported —
        but never defined — ``cleanup_ParallelSparseLU!``, src:31)."""
        self.ldata = self.udata = None
        self._jit_cache.clear()


def cleanup_ParallelSparseLU(F: ParallelSparseLU) -> None:
    """API-parity alias for the reference export (src:31)."""
    F.close()
