"""Device-side same-pattern numeric refactorization (static pivots).

The reference's ``lu!(F, A)`` delegates numeric-only refactorization to
UMFPACK, reusing its symbolic analysis
(/root/reference/src/SharedMemSparseLU.jl:245-279). Here the *entire*
numeric phase stays on device:

* Pivot order ``p, q`` is frozen from the first (host) factorization — the
  static-pivot prepass BASELINE.md specifies ("serial pivoting →
  static-pivot symbolic prepass").
* Host side (once): the chunk-grid tile pattern of ``B = (Rs·A)[p, q]`` is
  closed under blocked elimination (tile-level symbolic fill), and every
  per-step tile list (panel rows, panel cols, Schur updates) is emitted as
  a static padded schedule.
* Device side (every refactorization): recompute row scaling ``Rs``
  (UMFPACK recomputes it per-``lu!`` too, src:263), scatter ``A``'s
  nonzeros into the merged tile store, then run blocked right-looking LU as
  a ``lax.scan`` over block steps — each step: dense no-pivot LU of the
  diagonal tile, batched triangular solves for the row/column panels, and
  one batched-matmul Schur complement update.

The factored tiles are extracted straight into the solve engine's
(diag, negated-offdiag) layout, so a refactorization feeds subsequent
``ldiv`` calls with zero host traffic.

Accuracy note: no numerical pivoting happens during refactorization (the
point of the static-pivot design); like cuSolverRF/NICSLU-style
refactorization this assumes the new values don't demand a different pivot
order. ``ParallelSparseLU.refactor`` (host path, re-pivoting) remains the
fallback for hostile value changes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax import lax

from .assemble import WindowPlan, assemble_windowed, plan_windowed_assembly
from .solve import TriKernelData  # noqa: F401  (re-exported for callers)
from .symbolic import TriPlan, plan_triangular

__all__ = ["RefactorPlan", "build_refactor_plan", "refactor_same_pattern"]


# ---------------------------------------------------------------------------
# Host-side symbolic closure + schedule
# ---------------------------------------------------------------------------


def blocked_fill(tiles: set, K: int) -> set:
    """Close a tile pattern under blocked elimination:
    (i,k) and (k,j) present with i,j > k  ⇒  (i,j) present.
    Also guarantees every diagonal tile.

    Uses the C++ core (utils/_symcore) when built — the pure-Python closure
    is the dominant host cost at scale (22s at n=250k, ~0.1s native).
    """
    try:
        from .utils import _symcore

        if tiles:
            br, bc = map(np.asarray, zip(*tiles))
        else:
            br = bc = np.zeros(0, dtype=np.int64)
        r, c = _symcore.blocked_fill(
            br.astype(np.int64), bc.astype(np.int64), K
        )
        return set(zip(r.tolist(), c.tolist()))
    except ImportError:
        pass
    S = set(tiles)
    for k in range(K):
        S.add((k, k))
    # per-step adjacency so each step is O(|rows_k| * |cols_k|), not O(|S|)
    col_of = [[] for _ in range(K)]
    row_of = [[] for _ in range(K)]
    for (i, j) in S:
        if i > j:
            col_of[j].append(i)
        elif i < j:
            row_of[i].append(j)
    for k in range(K):
        rows = list(col_of[k])
        cols = list(row_of[k])
        for i in rows:
            for j in cols:
                if (i, j) not in S:
                    S.add((i, j))
                    if i > j:
                        col_of[j].append(i)
                    else:
                        row_of[i].append(j)
    return S


@dataclasses.dataclass
class RefactorPlan:
    """Static schedule for the device-side blocked refactorization.

    Elimination steps are grouped by LEVEL of the (symmetric) closure
    dependency DAG: chunks in one level share no closure tile, so their
    diagonal factorizations, panel solves and Schur updates each run as
    ONE batched op. On a chain (COLAMD banded) levels degenerate to K
    single steps — no worse than the sequential schedule — while the
    banded/nd orderings give ~log-depth levels (K=29 steps → 6 levels on
    BASELINE config 2, ~5x fewer sequential steps).
    """

    n: int
    cs: int
    K: int
    NL: int  # elimination levels
    TF: int  # number of merged fill tiles (dummy id = TF)
    # per-LEVEL padded schedules (dummy tile id TF pads everything)
    diag_ids: np.ndarray     # (NL, BL) merged ids of the level's diag tiles
    diag_cnt: np.ndarray     # (NL,) real diag count per level
    row_ids: np.ndarray      # (NL, MR) merged ids of L-panel tiles (i, k)
    row_owner: np.ndarray    # (NL, MR) slot of k in the level's diag batch
    col_ids: np.ndarray      # (NL, MU) merged ids of U-panel tiles (k, j)
    col_owner: np.ndarray    # (NL, MU)
    schur: np.ndarray        # (NL, MS, 3) (dst, l_tile, u_tile) merged ids
    # input assembly: windowed scatter + row-permutation gather schedule
    # (see assemble.py — replaces a flat per-element scatter)
    win: "WindowPlan"
    # extraction maps into the solve plans (built on the same closure)
    l_off_src: np.ndarray    # (TL+1,) merged id per L-solve offdiag tile
    u_off_src: np.ndarray    # (TU+1,) merged id per U-solve offdiag tile
    diag_src: np.ndarray     # (K+1,) merged id per chunk's diagonal tile
    # (K+1,) flattened (level*BL + slot) of each chunk's diag in the
    # elimination schedule; entry K = NL*BL (identity pad). Lets the
    # pipeline REUSE the per-level panel inverses the elimination already
    # computed instead of re-inverting every diagonal tile afterwards.
    diag_lvlslot: np.ndarray


def _tile_pattern_of_permuted(
    A: sp.csc_matrix, p: np.ndarray, q: np.ndarray, cs: int
) -> Tuple[set, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tile pattern of B = A[p][:, q] plus per-nonzero block coordinates."""
    A = sp.csc_matrix(A)
    n = A.shape[0]
    pinv = np.argsort(p)
    qinv = np.argsort(q)
    rows = A.indices
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    bi = pinv[rows]  # row in B
    bj = qinv[cols]  # col in B
    ti = bi // cs
    tj = bj // cs
    tiles = set(zip(ti.tolist(), tj.tolist()))
    return tiles, bi, bj, rows, cols


def build_refactor_plan(
    A_pattern: sp.csc_matrix,
    p: np.ndarray,
    q: np.ndarray,
    cs: int,
    solve_lplan: TriPlan,
    solve_uplan: TriPlan,
    data_src: np.ndarray | None = None,
) -> RefactorPlan:
    """Build the static refactorization schedule.

    ``solve_lplan``/``solve_uplan`` must have been planned on the *same*
    closure pattern (see :func:`closure_solve_plans`), so extraction maps
    line up tile-for-tile.
    """
    n = A_pattern.shape[0]
    K = -(-n // cs)
    tiles, bi, bj, rows, _ = _tile_pattern_of_permuted(A_pattern, p, q, cs)
    S = blocked_fill(tiles, K)

    order = sorted(S)
    tile_id: Dict[Tuple[int, int], int] = {t: i for i, t in enumerate(order)}
    TF = len(order)

    # --- per-chunk tile lists ----------------------------------------------
    rows_at = [[] for _ in range(K)]  # (i, k), i > k
    cols_at = [[] for _ in range(K)]  # (k, j), j > k
    for (i, j) in order:
        if i > j:
            rows_at[j].append(i)
        elif i < j:
            cols_at[i].append(j)

    # --- elimination levels (longest path over SYMMETRIC closure deps) -----
    # chunk k may eliminate once every c < k with a closure tile (k, c) OR
    # (c, k) has: its diag, panels and incoming Schur updates are then
    # final. Same-level chunks share no closure tile → batched steps.
    # dependencies of k: every c < k with (k, c) in S (k's L-panel col c)
    # or (c, k) in S (k's U-panel row c). All edges point from smaller to
    # larger chunk index, so ascending order is topological: push levels.
    level = np.zeros(K, dtype=np.int64)
    for c in range(K):
        for i in rows_at[c]:
            level[i] = max(level[i], level[c] + 1)
        for j in cols_at[c]:
            level[j] = max(level[j], level[c] + 1)
    NL = int(level.max()) + 1 if K else 1
    chunks_at = [np.nonzero(level == l)[0] for l in range(NL)]
    BL = max((len(c) for c in chunks_at), default=1) or 1

    diag_ids = np.full((NL, BL), TF, dtype=np.int32)
    diag_cnt = np.zeros(NL, dtype=np.int32)
    slot_of = np.zeros(K, dtype=np.int64)
    for l in range(NL):
        for a, k in enumerate(chunks_at[l]):
            diag_ids[l, a] = tile_id[(int(k), int(k))]
            slot_of[k] = a
        diag_cnt[l] = len(chunks_at[l])

    MR = max(
        (sum(len(rows_at[k]) for k in chunks_at[l]) for l in range(NL)),
        default=1,
    ) or 1
    MU = max(
        (sum(len(cols_at[k]) for k in chunks_at[l]) for l in range(NL)),
        default=1,
    ) or 1
    MS = max(
        (sum(len(rows_at[k]) * len(cols_at[k]) for k in chunks_at[l])
         for l in range(NL)),
        default=1,
    ) or 1
    row_ids = np.full((NL, MR), TF, dtype=np.int32)
    row_owner = np.full((NL, MR), BL, dtype=np.int32)  # BL = identity slot
    col_ids = np.full((NL, MU), TF, dtype=np.int32)
    col_owner = np.full((NL, MU), BL, dtype=np.int32)
    schur = np.full((NL, MS, 3), TF, dtype=np.int32)
    for l in range(NL):
        a = b = s = 0
        for k in chunks_at[l]:
            for i in rows_at[k]:
                row_ids[l, a] = tile_id[(i, int(k))]
                row_owner[l, a] = slot_of[k]
                a += 1
            for j in cols_at[k]:
                col_ids[l, b] = tile_id[(int(k), j)]
                col_owner[l, b] = slot_of[k]
                b += 1
            for i in rows_at[k]:
                for j in cols_at[k]:
                    schur[l, s] = (
                        tile_id[(i, j)],
                        tile_id[(i, int(k))],
                        tile_id[(int(k), j)],
                    )
                    s += 1

    # --- input assembly (windowed scatter + perm-gather, assemble.py) ------
    # identity pads: tail rows of the last chunk + dummy-tile diagonal,
    # as flat positions in the FINAL permuted store
    pads = []
    tail = n % cs
    if tail:
        kd = tile_id[(K - 1, K - 1)]
        idx = np.arange(tail, cs, dtype=np.int64)
        pads.append((np.int64(kd) * cs + idx) * cs + idx)
    idx = np.arange(cs, dtype=np.int64)
    pads.append((np.int64(TF) * cs + idx) * cs + idx)
    win = plan_windowed_assembly(
        A_pattern, p, q, cs, order, TF, np.concatenate(pads),
        data_src=data_src,
    )

    # --- extraction maps into the solve plans ------------------------------
    def off_src(plan: TriPlan) -> np.ndarray:
        src = np.full(plan.T + 1, TF, dtype=np.int32)
        for t in range(plan.T):
            src[t] = tile_id[(int(plan.tile_brow[t]), int(plan.tile_bcol[t]))]
        return src

    diag_src = np.array(
        [tile_id[(k, k)] for k in range(K)] + [TF], dtype=np.int32
    )
    diag_lvlslot = np.array(
        [int(level[k]) * BL + int(slot_of[k]) for k in range(K)] + [NL * BL],
        dtype=np.int32,
    )
    return RefactorPlan(
        n=n,
        cs=cs,
        K=K,
        NL=NL,
        TF=TF,
        diag_ids=diag_ids,
        diag_cnt=diag_cnt,
        row_ids=row_ids,
        row_owner=row_owner,
        col_ids=col_ids,
        col_owner=col_owner,
        schur=schur,
        win=win,
        l_off_src=off_src(solve_lplan),
        u_off_src=off_src(solve_uplan),
        diag_src=diag_src,
        diag_lvlslot=diag_lvlslot,
    )


def closure_solve_plans(
    A_pattern: sp.csc_matrix,
    factors_L: sp.csc_matrix,
    factors_U: sp.csc_matrix,
    p: np.ndarray,
    q: np.ndarray,
    cs: int,
) -> Tuple[TriPlan, TriPlan]:
    """Solve plans whose tile sets are the blocked closure of the permuted
    input pattern — a superset of the factors' own tile patterns, so both
    the host pack path and the device refactor path feed the same plans."""
    n = A_pattern.shape[0]
    K = -(-n // cs)
    tiles, _, _, _, _ = _tile_pattern_of_permuted(A_pattern, p, q, cs)
    S = blocked_fill(tiles, K)
    extra_lower = [(i, j) for (i, j) in S if i > j]
    extra_upper = [(i, j) for (i, j) in S if i < j]
    lplan = plan_triangular(factors_L, cs, lower=True, extra_tiles=extra_lower)
    uplan = plan_triangular(factors_U, cs, lower=False, extra_tiles=extra_upper)
    return lplan, uplan


# ---------------------------------------------------------------------------
# Device-side numeric phase
# ---------------------------------------------------------------------------


def _lu_nopivot(D: jax.Array) -> jax.Array:
    """Dense no-pivot LU of ``(..., cs, cs)`` tiles, in place: returns
    merged L\\U (strict lower = L, upper incl. diag = U, unit diag
    implicit). Batched: the rank-1 loop advances every tile at once."""
    cs = D.shape[-1]
    ridx = lax.broadcasted_iota(jnp.int32, (cs, 1), 0)[:, 0]

    def step(i, D):
        piv = D[..., i, i][..., None]                 # (..., 1)
        col = D[..., :, i]                            # (..., cs)
        lower = ridx > i
        l = jnp.where(lower, col / piv, 0.0)
        urow = jnp.where(lower, D[..., i, :], 0.0)    # cols > i of row i
        D = D - l[..., :, None] * urow[..., None, :]
        return D.at[..., :, i].set(jnp.where(lower, l, D[..., :, i]))

    return lax.fori_loop(0, cs, step, D)


@functools.partial(jax.jit, static_argnames=("cs", "tile_lu"))
def _blocked_elimination(tiles, diag_ids, diag_cnt, row_ids, row_owner,
                         col_ids, col_owner, schur, *, cs: int,
                         tile_lu: bool = False):
    """Right-looking blocked LU over the merged tile store, one LEVEL of
    independent chunks per scan step (diag LU, panel solves and Schur
    updates each batched across the level).

    Always full-precision matmuls: factorization error compounds into
    every subsequent solve, so reduced-precision (TF32/bf16) products are
    never acceptable here. ``tile_lu`` factors the diagonal tiles with
    the compiled tile-LU kernel (ops/pallas_factor.py) instead of the XLA
    rank-1 loop.
    """

    from .ops.pallas_factor import lu_tile
    from .ops.tri_inverse import tri_inverse

    BL = diag_ids.shape[1]

    def step(carry, xs):
        tiles, min_piv = carry
        dks, cnt, rids, rown, cids, cown, sch = xs
        # 1) the level's diagonal tiles: batched dense no-pivot LU
        D = tiles[dks]
        D = lu_tile(D) if tile_lu else _lu_nopivot(D)
        # static-pivot diagnostic: smallest |pivot| among REAL slots
        # (UMFPACK would re-pivot here, reference src:247; we detect)
        piv = jnp.min(
            jnp.abs(jnp.diagonal(D, axis1=-2, axis2=-1)), axis=-1
        )
        real = lax.broadcasted_iota(jnp.int32, (BL,), 0) < cnt
        min_piv = jnp.minimum(
            min_piv, jnp.min(jnp.where(real, piv, jnp.inf))
        )
        tiles = tiles.at[dks].set(D)
        # 2/3) panels via explicit triangular inverses (batched matmuls
        #      instead of sequential substitution). The two
        #      inverses run as ONE batched call: reversing both axes of an
        #      upper-triangular tile gives a lower-triangular one, and
        #      inv(J U J) = J inv(U) J for the reversal J — so the upper
        #      inverse is the flip of a lower inverse of the flip. Halving
        #      the op count matters because per-op dispatch, not FLOPs,
        #      dominates at small level widths. Slot BL holds identity for
        #      padded panel entries.
        eye1 = jnp.eye(cs, dtype=tiles.dtype)[None]
        Dl = jnp.tril(D, -1) + eye1
        Du_rev = jnp.flip(jnp.triu(D), (-2, -1))
        inv2 = tri_inverse(
            jnp.concatenate([Dl, Du_rev], axis=0), lower=True
        )
        Linv_b = inv2[:BL]
        Uinv_b = jnp.flip(inv2[BL:], (-2, -1))
        Uinv = jnp.concatenate([Uinv_b, eye1], axis=0)
        Linv = jnp.concatenate([Linv_b, eye1], axis=0)
        # row panel: L_ik = A_ik @ U_kk^{-1}
        X = lax.dot_general(
            tiles[rids], Uinv[rown],
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=tiles.dtype,
        )
        tiles = tiles.at[rids].set(X)
        # col panel: U_kj = L_kk^{-1} @ A_kj
        Y = lax.dot_general(
            Linv[cown], tiles[cids],
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=tiles.dtype,
        )
        tiles = tiles.at[cids].set(Y)
        # 4) Schur update: A_ij -= L_ik @ U_kj (batched matmul)
        dst, lt, ut = sch[:, 0], sch[:, 1], sch[:, 2]
        prod = lax.dot_general(
            tiles[lt],
            tiles[ut],
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=tiles.dtype,
        )
        tiles = tiles.at[dst].add(-prod)
        return (tiles, min_piv), (Linv_b, Uinv_b)

    min_piv0 = jnp.asarray(jnp.inf, tiles.dtype)
    with jax.default_matmul_precision("highest"):
        (tiles, min_piv), (linv_lv, uinv_lv) = lax.scan(
            step, (tiles, min_piv0),
            (diag_ids, diag_cnt, row_ids, row_owner,
             col_ids, col_owner, schur),
        )
    # (NL, BL, cs, cs) per-level diagonal inverses, for reuse downstream
    return tiles, min_piv, linv_lv, uinv_lv


@functools.partial(jax.jit, static_argnames=("cs",))
def _extract_solve_tiles(tiles, diag_src, l_off_src, u_off_src, *, cs: int):
    """Merged L\\U tiles → solve-engine layout (negated offdiag, split diag).

    The elimination's padded panel/Schur slots write garbage (up to inf)
    into the dummy merged tile by design; scrub the dummy slots here so
    the solve engines see exactly identity / zero (0*inf = nan would
    otherwise leak through the padded batched ops)."""
    eye = jnp.eye(cs, dtype=tiles.dtype)
    diag = tiles[diag_src]
    ldiag = (jnp.tril(diag, -1) + eye[None]).at[-1].set(eye)
    udiag = jnp.triu(diag).at[-1].set(eye)
    loff = (-tiles[l_off_src]).at[-1].set(0.0)
    uoff = (-tiles[u_off_src]).at[-1].set(0.0)
    return ldiag, udiag, loff, uoff


@functools.partial(
    jax.jit,
    static_argnames=("n", "cs", "TF", "TF2", "W", "R1", "Np", "tri_mode",
                     "tile_lu"),
)
def _refactor_pipeline(a_data, dev, *, n, cs, TF, TF2, W, R1, Np, tri_mode,
                       tile_lu=False):
    """The WHOLE numeric refactorization as one program: assemble →
    blocked elimination → solve-tile extraction → tile inverses. One
    dispatch per refactorization, no host round trip between stages."""
    tiles, rs = assemble_windowed(
        a_data, dev, n=n, cs=cs, TF=TF, TF2=TF2, W=W, R1=R1, Np=Np,
    )
    tiles, min_piv, linv_lv, uinv_lv = _blocked_elimination(
        tiles, dev["diag_ids"], dev["diag_cnt"],
        dev["row_ids"], dev["row_owner"],
        dev["col_ids"], dev["col_owner"], dev["schur"],
        cs=cs, tile_lu=tile_lu,
    )
    ldiag, udiag, loff, uoff = _extract_solve_tiles(
        tiles, dev["diag_src"], dev["l_off_src"], dev["u_off_src"], cs=cs
    )
    # pivot growth: rows of (Rs·A)[p,q] have max |entry| == 1 after the
    # in-program equilibration, so max |factor entry| IS the growth factor
    growth = jnp.maximum(
        jnp.max(jnp.abs(udiag)),
        jnp.maximum(jnp.max(jnp.abs(loff)), jnp.max(jnp.abs(uoff))),
    )
    out = {"ldiag": ldiag, "udiag": udiag, "loff": loff, "uoff": uoff,
           "rs": rs, "min_pivot": min_piv, "growth": growth}
    if tri_mode in ("inv", "inv_refine"):
        # the elimination already inverted every diagonal tile for its
        # panel solves — gather those per-level inverses into the solve
        # layout instead of re-inverting K+1 tiles
        eye = jnp.eye(cs, dtype=tiles.dtype)[None]
        ls = dev["diag_lvlslot"]
        linv_f = jnp.concatenate([linv_lv.reshape(-1, cs, cs), eye])
        uinv_f = jnp.concatenate([uinv_lv.reshape(-1, cs, cs), eye])
        out["ldiag_inv"] = linv_f[ls]
        out["udiag_inv"] = uinv_f[ls]
    return out


def refactor_numeric_values(F, a_data: jax.Array) -> None:
    """Refactorize from new nonzero values of A (device array, original
    CSC order). Updates F's device solve state in place."""
    rp: RefactorPlan = F._refactor_plan
    mode = F.config.tri_mode
    dev = F._refactor_dev

    out = _refactor_pipeline(
        jnp.asarray(a_data, dtype=F.dtype), dev,
        n=rp.n, cs=rp.cs, TF=rp.TF, TF2=rp.win.TF2, W=rp.win.W,
        R1=rp.win.R1, Np=rp.win.Np, tri_mode=mode, tile_lu=F._tile_lu,
    )

    def kern(plan, diag, off, dinv):
        from .solve import TriKernelData

        return TriKernelData(
            diag=diag,
            diag_inv=dinv,
            offdiag=off,
            level_chunks=jnp.asarray(plan.level_chunks),
            level_tiles=jnp.asarray(plan.level_tiles),
            tile_brow=jnp.asarray(plan.tile_brow),
            tile_bcol=jnp.asarray(plan.tile_bcol),
        )

    F.ldata = kern(F.plan.lplan, out["ldiag"], out["loff"],
                   out.get("ldiag_inv"))
    F.udata = kern(F.plan.uplan, out["udiag"], out["uoff"],
                   out.get("udiag_inv"))
    # numeric state changed: stale any baked solve callable (api.py
    # make_f64_ldiv's generation guard, VERDICT r4 #6), and the host csc
    # factor VALUES (F.L/F.U materialize lazily from these tiles)
    F._generation = getattr(F, "_generation", 0) + 1
    F._factors_stale = True
    # the bidiagonal-band fast path (api._prepare_scan_path) caches factor
    # VALUES; a device refactorization bypasses it until the next re-pack
    F._scan_bands = None
    F._scan_perm_id = False
    # device scalars; synced only when the caller asks (check=True)
    F.refactor_diagnostics = {
        "min_pivot": out["min_pivot"], "growth": out["growth"]
    }
    rs = out["rs"]
    # Rs changed; p, q are static. rs is in factor row order == input row
    # order (no gather), except under the nd embedding where it maps back
    # through ext_pos.
    cs = rp.cs
    n_in, K_in = F._n_orig, F._K_in
    rs_in = rs if F._ext is None else rs[jnp.asarray(F._ext["pos"])]
    rs_pad = jnp.zeros((K_in * cs + cs,), F.dtype).at[:n_in].set(
        rs_in.astype(F.dtype)
    )
    F._rs_blk = rs_pad.reshape(K_in + 1, cs, 1)
    # sharded path still uses the permuted vector (eager gather, small)
    F._rs_p_dev = rs[jnp.asarray(F.plan.p)].astype(F.dtype)
    # device array; converted lazily if the host-side .Rs is read
    F._factors.Rs = rs
    # refresh the device copy of A for residuals / iterative refinement
    # (skip under the nd embedding: a_data is factor-space there; the
    # caller refreshes from the original matrix instead)
    if F._ext is None:
        F._a_data_dev = jnp.asarray(a_data, dtype=F.dtype)
        F._spmv_dirty = True


def refactor_same_pattern(F, A: sp.csc_matrix, *, check: bool = False,
                          growth_limit: float = 1e7) -> bool:
    """Entry point used by :meth:`ParallelSparseLU.refactor_numeric`.

    With ``check=True``, syncs the static-pivot diagnostics (min |pivot|,
    pivot growth) after the device refactorization; if the new values broke
    the frozen pivot order (non-finite factors or growth beyond
    ``growth_limit``), falls back to a full host refactorization (which
    re-pivots, like the reference's UMFPACK ``lu!``, src:247). Returns
    True when the device factorization was kept."""
    A = sp.csc_matrix(A)
    A.sort_indices()
    if not F.has_device_refactor:
        F.enable_device_refactor()
    sig = (A.indptr.tobytes(), A.indices.tobytes())
    if sig != F._a_pattern_sig:
        raise ValueError(
            "refactor_numeric requires the same sparsity pattern as the "
            "matrix this factorization was built from; use refactor() for "
            "pattern changes (reference src:265-273 reallocate path)"
        )
    # nd-extension value mapping is folded into the windowed assembly
    # schedule (assemble.py data_src), so original values go straight in
    refactor_numeric_values(F, A.data)
    if F._ext is not None:
        F._a_data_dev = jnp.asarray(A.data, dtype=F.dtype)
        F._spmv_dirty = True
    if check:
        d = F.refactor_diagnostics
        growth = float(d["growth"])
        min_piv = float(d["min_pivot"])
        if not np.isfinite(growth) or growth > growth_limit or min_piv == 0.0:
            F.refactor(A)  # host path: re-pivots
            return False
    return True
