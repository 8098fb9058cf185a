"""Halo-pipelined distributed triangular solves (SURVEY.md §5.7).

The psum-based engine (sharded_solve.py) replicates the solution carrier —
the device analogue of an MPI shared-memory *window*. This module is the
message-passing analogue for **banded** operators (BASELINE config 5:
block-banded PDE matrix row-partitioned across hosts):

* chunks are partitioned **contiguously**: device ``d`` owns the chunk
  range ``[d*Kl, (d+1)*Kl)`` — the solution vector is truly distributed
  (x sharded by level-set row blocks);
* within a device the chunk chain solves locally (a ``lax.scan``, exactly
  the single-device engine on the local slice);
* dependencies crossing the partition boundary become **halo segments**:
  the off-diagonal tiles whose source chunk is local but whose destination
  chunk is on the next device are applied locally and the accumulated
  contribution is sent with one ``lax.ppermute`` per round — communication
  is point-to-point traffic between neighbours, not a global collective;
* the RHS panel is split into ``M`` micro-panels, software-pipelined: in
  round ``r`` device ``d`` processes micro-panel ``r - d``, so all devices
  work concurrently after the fill phase. Pipeline efficiency is
  ``M / (M + D - 1)`` per triangular solve.

Restrictions (checked at plan time, fall back to the psum engine
otherwise): every off-diagonal tile must stay within one boundary
crossing (bandwidth <= one device's chunk range).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..solve import TriKernelData
from .mesh import replicated_factors
from ..symbolic import TriPlan

__all__ = ["PipelinePlan", "build_pipeline_plan", "pipeline_tri_solve",
           "pipeline_ldiv_pair", "ShardedPermPlan",
           "build_sharded_perm_plan", "sharded_apply_perm",
           "make_pipeline_ldiv"]


@dataclasses.dataclass
class PipelinePlan:
    """Static per-device schedule for one pipelined triangular solve."""

    D: int            # devices
    Kl: int           # chunks per device (padded)
    H: int            # halo depth in chunks (max boundary crossing)
    forward: bool     # True: lsolve (halo flows d -> d+1); False: rsolve
    # (D, Kl) global chunk id per local step (K = dummy); steps run in
    # local dependency order (ascending chunks for L, descending for U)
    steps: np.ndarray
    # (D, Kl, MT) tile ids applied after each local step's chunk solve,
    # LOCAL destinations only (T = dummy)
    step_tiles: np.ndarray
    # (D, Kl, MT) local slot (0..Kl+H) of each tile's dst in the device's
    # extended carrier [halo_in | local chunks]
    step_tile_dst: np.ndarray
    # (D, Kl, MT) same for boundary tiles: applied after the step, into the
    # outgoing halo buffer slot 0..H-1 (H = dummy/no-op)
    bnd_tiles: np.ndarray
    bnd_tile_dst: np.ndarray
    MT: int
    MB: int


def _owner(k: int, Kl: int, D: int) -> int:
    return min(k // Kl, D - 1)


def build_pipeline_plan(plan: TriPlan, D: int) -> Optional[PipelinePlan]:
    """Build the pipelined schedule, or None if the pattern doesn't fit
    (crossings deeper than one device, or non-chain local structure is
    fine — local levels are honoured by processing in level order)."""
    K, T = plan.K, plan.T
    Kl = -(-K // D)
    fwd = plan.lower

    # halo depth: max |dst - src| in chunks, must stay within neighbour
    if T:
        span = np.abs(plan.tile_brow[:T].astype(int) - plan.tile_bcol[:T].astype(int))
        H = int(span.max())
    else:
        H = 1
    H = max(1, min(H, Kl))
    for t in range(T):
        src, dst = int(plan.tile_bcol[t]), int(plan.tile_brow[t])
        osrc, odst = _owner(src, Kl, D), _owner(dst, Kl, D)
        if abs(odst - osrc) > 1:
            return None  # crossing skips a device: psum engine instead
        if fwd and odst < osrc:
            return None
        if not fwd and odst > osrc:
            return None

    # local step order: within a device, chunks in dependency order
    steps = np.full((D, Kl), K, dtype=np.int32)
    local_index = {}
    for d in range(D):
        lo, hi = d * Kl, min((d + 1) * Kl, K)
        ids = list(range(lo, hi))
        if not fwd:
            ids = ids[::-1]
        for a, k in enumerate(ids):
            steps[d, a] = k
            local_index[k] = a

    # tiles grouped by their source chunk's local step; split local/boundary
    per_step_local = [[[] for _ in range(Kl)] for _ in range(D)]
    per_step_bnd = [[[] for _ in range(Kl)] for _ in range(D)]
    for t in range(T):
        src, dst = int(plan.tile_bcol[t]), int(plan.tile_brow[t])
        d = _owner(src, Kl, D)
        a = local_index[src]
        if _owner(dst, Kl, D) == d:
            # local slot: position of dst within the extended carrier
            # [H halo slots | Kl local chunks] — halo slots hold incoming
            # contributions for the FIRST chunks processed
            slot = H + (dst - d * Kl if fwd else (min((d + 1) * Kl, K) - 1 - dst))
            per_step_local[d][a].append((t, slot))
        else:
            # boundary: halo slot on the RECEIVER = position of dst in its
            # first H processed chunks
            nd = d + 1 if fwd else d - 1
            off = (dst - nd * Kl) if fwd else (min((nd + 1) * Kl, K) - 1 - dst)
            if off >= H:
                return None  # receiver processes it later than halo depth
            per_step_bnd[d][a].append((t, off))

    MT = max((len(x) for dd in per_step_local for x in dd), default=1) or 1
    MB = max((len(x) for dd in per_step_bnd for x in dd), default=1) or 1
    step_tiles = np.full((D, Kl, MT), T, dtype=np.int32)
    step_tile_dst = np.zeros((D, Kl, MT), dtype=np.int32)
    bnd_tiles = np.full((D, Kl, MB), T, dtype=np.int32)
    bnd_tile_dst = np.full((D, Kl, MB), H, dtype=np.int32)
    for d in range(D):
        for a in range(Kl):
            for i, (t, s) in enumerate(per_step_local[d][a]):
                step_tiles[d, a, i] = t
                step_tile_dst[d, a, i] = s
            for i, (t, s) in enumerate(per_step_bnd[d][a]):
                bnd_tiles[d, a, i] = t
                bnd_tile_dst[d, a, i] = s
    return PipelinePlan(
        D=D, Kl=Kl, H=H, forward=fwd,
        steps=steps, step_tiles=step_tiles, step_tile_dst=step_tile_dst,
        bnd_tiles=bnd_tiles, bnd_tile_dst=bnd_tile_dst, MT=MT, MB=MB,
    )


def _bmm(a, b):
    return lax.dot_general(
        a, b, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=a.dtype,
    )


def autotune_micro_panels(R: int, D: int, *, cap: Optional[int] = None) -> int:
    """Pick the micro-panel count M for the overlapped pipeline
    (VERDICT r3 #2b).

    Pipeline efficiency is ``M / (M + 2D - 1)`` — the fill/drain bubble is
    ``2D - 1`` rounds regardless of M, so more (thinner) panels amortize
    it better; the cost of thin panels (cs × R/M tile matmuls) is small
    because each round is latency-bound, not matmul-bound. M must divide R
    (equal static panel widths), so take the largest divisor of R that is
    ≤ ``cap``. The default cap scales with the bubble: ``max(16, 4*(2D-1))``
    — at D ≤ 3 the old cap of 16 already gives ≥ 0.76 pipeline
    efficiency, while D ≥ 4 with wide panels (R ≥ 32) needs M > 16 to
    stay above the 70% bar (M=32 at D=4: 32/39 = 0.82 vs 16/23 = 0.70);
    each extra round costs one more neighbour-exchange latency.

    ``R = 1`` (the reference's primary calling pattern, src:286) returns
    M=1: a banded chain is inherently serial across a contiguous row
    partition — device d+1's first chunk depends on device d's last
    chunks — so there is no intra-RHS axis to pipeline; single-RHS
    multi-chip solves should ride the level-striped psum engine over an
    nd ordering instead (level width is the parallelism there).
    """
    if cap is None:
        cap = max(16, 4 * (2 * D - 1))
    m = max(1, min(cap, R))
    while R % m:
        m -= 1
    return m


def pipeline_tri_solve(
    mesh: Mesh,
    axis: str,
    plan: TriPlan,
    pplan: PipelinePlan,
    data: TriKernelData,
    xw: jax.Array,   # (K+1, cs, R) chunk-blocked RHS (replicated)
    *,
    micro_panels: int = 4,
    tri_mode: str = "inv",
) -> jax.Array:
    """Pipelined solve; returns the replicated solved carrier."""
    D, Kl, H = pplan.D, pplan.Kl, pplan.H
    K, cs = plan.K, plan.cs
    R = xw.shape[-1]
    M = max(1, min(micro_panels, R))
    while R % M:
        M -= 1
    Rm = R // M
    fwd = pplan.forward

    steps = jnp.asarray(pplan.steps)            # (D, Kl)
    st_t = jnp.asarray(pplan.step_tiles)        # (D, Kl, MT)
    st_d = jnp.asarray(pplan.step_tile_dst)
    bn_t = jnp.asarray(pplan.bnd_tiles)
    bn_d = jnp.asarray(pplan.bnd_tile_dst)

    def solve_diag(r, k):
        if tri_mode == "trsm":
            return lax.linalg.triangular_solve(
                data.diag[k], r, left_side=True, lower=plan.lower,
                unit_diagonal=False,
            )
        y = _bmm(data.diag_inv[k], r)
        if tri_mode == "inv_refine":
            y = y + _bmm(data.diag_inv[k], r - _bmm(data.diag[k], y))
        return y

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    def run(xw, steps_me, st_t_me, st_d_me, bn_t_me, bn_d_me):
        d = lax.axis_index(axis)
        # position in the dependency chain: backward solves start at the
        # LAST device
        pos = d if fwd else (D - 1 - d)
        steps_me = steps_me[0]      # (Kl,)
        st_t_me = st_t_me[0]
        st_d_me = st_d_me[0]
        bn_t_me = bn_t_me[0]
        bn_d_me = bn_d_me[0]

        # local extended carrier per micro-panel: [H halo | Kl chunks]+dummy
        # filled from the replicated xw with this device's chunk rows
        def local_rows(m):
            # (Kl, cs, Rm) rows of micro-panel m in LOCAL STEP ORDER
            rows = xw[steps_me]                       # (Kl, cs, R)
            return lax.dynamic_slice_in_dim(rows, m * Rm, Rm, axis=2)

        loc0 = jnp.stack([local_rows(m) for m in range(M)])  # (M, Kl, cs, Rm)
        halo0 = jnp.zeros((M, H, cs, Rm), xw.dtype)
        out0 = jnp.zeros((M, Kl, cs, Rm), xw.dtype)

        def round_body(r, carry):
            loc, halo_in, out = carry
            m = r - pos
            active = jnp.logical_and(m >= 0, m < M)
            mi = jnp.clip(m, 0, M - 1)

            # rhs for this panel: local rows + incoming halo applied to the
            # first H processed chunks
            rhs = loc[mi]                                   # (Kl, cs, Rm)
            rhs = lax.dynamic_update_slice_in_dim(
                rhs, rhs[:H] + halo_in[mi], 0, axis=0
            )

            halo_out = jnp.zeros((H + 1, cs, Rm), xw.dtype)

            def step_body(a, sc):
                rhs, halo_out = sc
                k = steps_me[a]
                r_a = rhs[a]
                y = solve_diag(r_a, k)
                y = jnp.where(k < K, y, r_a)
                rhs = rhs.at[a].set(y)
                # local tile applies (ext slot = H + local index ≥ a+... )
                for j in range(pplan.MT):
                    t = st_t_me[a, j]
                    contrib = _bmm(data.offdiag[t], y)
                    # slot H+idx maps into rhs index (slot - H)
                    dstslot = st_d_me[a, j] - H
                    rhs = rhs.at[jnp.clip(dstslot, 0, Kl - 1)].add(
                        jnp.where(t < plan.T, contrib, 0.0)
                    )
                # boundary tile applies into halo_out
                for j in range(pplan.MB):
                    t = bn_t_me[a, j]
                    contrib = _bmm(data.offdiag[t], y)
                    halo_out = halo_out.at[bn_d_me[a, j]].add(
                        jnp.where(t < plan.T, contrib, 0.0)
                    )
                return rhs, halo_out

            rhs, halo_out = lax.fori_loop(0, Kl, step_body, (rhs, halo_out))
            rhs = jnp.where(active, rhs, loc[mi])
            halo_out = jnp.where(active, halo_out[:H], 0.0)

            out = out.at[mi].set(jnp.where(active, rhs, out[mi]))

            # send halo to the neighbour: the panel this device just
            # finished (m = r - d) is the panel the receiver processes in
            # round r+1 (their m' = r+1 - (d+1) = r - d)
            perm = (
                [(i, i + 1) for i in range(D - 1)]
                if fwd else [(i, i - 1) for i in range(1, D)]
            )
            received = lax.ppermute(halo_out, axis, perm)
            m_recv = r + 1 - pos  # receiver (pos+1) processes this next round
            halo_in = halo_in.at[jnp.clip(m_recv, 0, M - 1)].add(
                jnp.where(jnp.logical_and(m_recv >= 0, m_recv < M),
                          received, 0.0)
            )
            return loc, halo_in, out

        _, _, out = lax.fori_loop(0, D + M - 1, round_body,
                                  (loc0, halo0, out0))

        # scatter local results back into a zero global carrier and sum
        glob = jnp.zeros_like(xw)
        outR = jnp.concatenate([out[m] for m in range(M)], axis=-1)
        glob = glob.at[steps_me].add(outR)
        return lax.psum(glob, axis)

    return run(xw, steps, st_t, st_d, bn_t, bn_d)


@dataclasses.dataclass
class ShardedPermPlan:
    """Static owner-computes schedule for applying a row permutation to a
    chunk-SHARDED carrier (BASELINE north star: the solution stays
    "partitioned by level-set blocks" — the reference's latent design
    replicates via one MPI window, src:31).

    Output rows are grouped by boundary crossing ``owner(dst) -
    owner(src)`` ∈ {0, +1, -1}: each device gathers the rows whose SOURCE
    it owns into per-direction buffers laid out like the receiving
    device's output block; the off-device buffers travel with one
    ``ppermute`` per used direction (the "one boundary exchange"), never
    a global collective."""

    D: int
    Ko_l: int                # output chunks per device (padded)
    src_row: np.ndarray      # (D, 3, Ko_l*cs) local source row; Kl_src*cs = zero
    use_dir: tuple           # (stay, fwd, bwd) static usage flags


def build_sharded_perm_plan(qperm, Kl_src: int, D: int):
    """Schedule ``out[o] = x[perm[o]]`` over a carrier sharded in
    ``Kl_src`` contiguous source chunks per device. None when a row
    crosses more than one device boundary (replicated path instead)."""
    cs, K_out = qperm.cs, qperm.K
    Ko_l = -(-K_out // D)
    idx = np.asarray(qperm.idx, dtype=np.int64)
    o = np.nonzero(idx < qperm.K_in * cs)[0]
    src = idx[o]
    d_out = np.minimum(o // cs // Ko_l, D - 1)
    d_src = np.minimum(src // cs // Kl_src, D - 1)
    delta = d_out - d_src
    if np.any(np.abs(delta) > 1):
        return None
    src_row = np.full((D, 3, Ko_l * cs), Kl_src * cs, dtype=np.int32)
    src_row[d_src, delta % 3, o - d_out * Ko_l * cs] = (
        src - d_src * Kl_src * cs)
    use_dir = tuple(bool(np.any(delta % 3 == di)) for di in range(3))
    return ShardedPermPlan(D=D, Ko_l=Ko_l, src_row=src_row, use_dir=use_dir)


def sharded_apply_perm(mesh: Mesh, axis: str, qperm, spp: ShardedPermPlan,
                       x_loc: jax.Array) -> jax.Array:
    """Apply the permutation to a chunk-sharded carrier ``x_loc``
    ((D*Kl_src, cs, R), sharded on blocks) → (D*Ko_l, cs, R) sharded.
    Communication: at most one ppermute per used boundary direction."""
    D, Ko_l = spp.D, spp.Ko_l
    cs = qperm.cs

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    def go(x_me, sr_me):
        R = x_me.shape[-1]
        flat = x_me.reshape(-1, R)
        bufs = [
            jnp.take(flat, sr_me[0, di], axis=0, mode="fill",
                     fill_value=0).reshape(Ko_l, cs, R)
            if spp.use_dir[di] else None
            for di in range(3)
        ]
        out = bufs[0] if bufs[0] is not None else jnp.zeros(
            (Ko_l, cs, R), x_me.dtype
        )
        if bufs[1] is not None:  # rows for the NEXT device
            out = out + lax.ppermute(
                bufs[1], axis, [(i, i + 1) for i in range(D - 1)]
            )
        if bufs[2] is not None:  # rows for the PREVIOUS device
            out = out + lax.ppermute(
                bufs[2], axis, [(i, i - 1) for i in range(1, D)]
            )
        return out

    return go(x_loc, jnp.asarray(spp.src_row))


def make_pipeline_ldiv(F, mesh: Mesh, axis: str = "chunks",
                       micro_panels: Optional[int] = None, *,
                       replicate: bool = True):
    """Pipelined distributed ``ldiv`` for banded-enough factors.

    Returns ``solve(b)`` or None when either factor's pattern crosses more
    than one device boundary (use :func:`make_sharded_ldiv` instead).

    ``micro_panels=None`` (default) autotunes the panel count per RHS
    width via :func:`autotune_micro_panels` at trace time.

    ``replicate=False`` keeps the solution DISTRIBUTED end to end
    (VERDICT r2 #5): no final psum — the un-pivot runs owner-computes on
    the sharded carrier with at most one boundary ``ppermute`` per
    direction, and ``solve`` returns a global array of padded length
    ``D * ceil(K_out/D) * cs`` sharded over the mesh axis (rows past ``n``
    are zero). Falls back to the replicated path when the column
    permutation crosses more than one device boundary.
    """
    D = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    lp = build_pipeline_plan(F.plan.lplan, D)
    up = build_pipeline_plan(F.plan.uplan, D)
    if lp is None or up is None:
        return None
    from ..ops.permute import apply_perm
    from ..solve import block_rhs, unblock_rhs

    plan = F.plan
    tri_mode = F.config.tri_mode
    cs = plan.cs
    # input space may differ from factor space (ordering="nd" embedding);
    # the rectangular permutation plans bridge the two
    n_in, K_in = F._n_orig, F._K_in
    prec = F.config.matmul_precision
    spp = None
    if not replicate:
        spp = build_sharded_perm_plan(F._qperm, lp.Kl, D)
        replicate = spp is None

    @jax.jit
    def run(ldata, udata, pperm, qperm, rs_blk, b):
        with jax.default_matmul_precision(prec):
            M = (autotune_micro_panels(b.shape[-1], D)
                 if micro_panels is None else micro_panels)
            xw = block_rhs(b, n_in, K_in, cs)
            xw = apply_perm(pperm, xw * rs_blk)
            # overlapped L/U pipeline: panel m runs rsolve while panel
            # m+1 is still in lsolve — one fill/drain bubble, not two
            xw = pipeline_ldiv_pair(
                mesh, axis, plan.lplan, lp, ldata, plan.uplan, up, udata,
                xw, micro_panels=M, tri_mode=tri_mode,
                shard_output=not replicate,
            )
            if replicate:
                xw = apply_perm(qperm, xw)
                return unblock_rhs(xw, n_in)
            xw = sharded_apply_perm(mesh, axis, qperm, spp, xw)
            # (D*Ko_l, cs, R) sharded → (D*Ko_l*cs, R), still sharded on
            # rows (each shard is a contiguous block row range)
            return xw.reshape(-1, xw.shape[-1])

    factors = replicated_factors(F, mesh)

    def solve(b):
        b = jnp.asarray(b, dtype=F.dtype)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        x = run(*factors(), b)
        return x[:, 0] if squeeze else x

    return solve


def pipeline_ldiv_pair(
    mesh: Mesh,
    axis: str,
    lplan: TriPlan,
    lp: PipelinePlan,
    ldata: TriKernelData,
    uplan: TriPlan,
    up: PipelinePlan,
    udata: TriKernelData,
    xw: jax.Array,   # (K+1, cs, R) chunk-blocked, permuted+scaled RHS
    *,
    micro_panels: int = 4,
    tri_mode: str = "inv",
    shard_output: bool = False,
) -> jax.Array:
    """Both triangular solves with OVERLAPPED phases (VERDICT r1 #8).

    Running lsolve then rsolve as two pipelines pays the (D-1)-round
    fill/drain bubble twice. Here micro-panel ``m`` enters the backward
    solve at device D-1 (its first device) one round after the forward
    solve's last device finished it — while panel ``m+1`` is still mid
    lsolve. Device ``d`` at round ``r`` runs the L sweep of panel
    ``r - d`` and the U sweep of panel ``r - (2D-1-d)``; total rounds are
    ``M + 2D - 1`` versus the sequential ``2(M + D - 1)``.

    The forward solve's per-device results never leave the device: they
    are held locally and re-indexed (``u_from_l``) as the backward
    sweep's input when its wave arrives — the handoff costs zero
    communication.

    With ``shard_output=True`` the solution never re-replicates: each
    device returns its own chunk rows (ascending order, dummy rows
    zeroed) and the result is ``(D*Kl, cs, R)`` sharded over ``axis`` —
    the only collectives in the program are the in-loop halo ppermutes.
    """
    D, Kl = lp.D, lp.Kl
    assert up.D == D and up.Kl == Kl
    assert lp.forward and not up.forward
    K, cs = lplan.K, lplan.cs
    R = xw.shape[-1]
    M = max(1, min(micro_panels, R))
    while R % M:
        M -= 1
    Rm = R // M
    HL, HU = lp.H, up.H

    # U-step -> L-local-row index map (same chunk partition, opposite
    # traversal order); dummy steps clipped + masked downstream
    u_from_l = np.where(
        up.steps < K,
        up.steps - np.arange(D, dtype=np.int64)[:, None] * Kl,
        Kl - 1,
    ).astype(np.int32)

    # ascending-order maps for the sharded output: local chunk lo+i of
    # device d sits at U step u_asc[d, i]; padded tail rows masked to 0
    u_asc = np.zeros((D, Kl), dtype=np.int32)
    u_mask = np.zeros((D, Kl), dtype=np.float32)
    for d in range(D):
        for a in range(Kl):
            k = int(up.steps[d, a])
            if k < K:
                u_asc[d, k - d * Kl] = a
                u_mask[d, k - d * Kl] = 1.0

    dev_arrays = tuple(
        jnp.asarray(a) for a in (
            lp.steps, lp.step_tiles, lp.step_tile_dst,
            lp.bnd_tiles, lp.bnd_tile_dst,
            up.steps, up.step_tiles, up.step_tile_dst,
            up.bnd_tiles, up.bnd_tile_dst,
            u_from_l, u_asc, u_mask,
        )
    )

    def solve_diag(data, lower, r, k):
        if tri_mode == "trsm":
            return lax.linalg.triangular_solve(
                data.diag[k], r, left_side=True, lower=lower,
                unit_diagonal=False,
            )
        y = _bmm(data.diag_inv[k], r)
        if tri_mode == "inv_refine":
            y = y + _bmm(data.diag_inv[k], r - _bmm(data.diag[k], y))
        return y

    def sweep(data, plan_T, lower, steps_me, st_t, st_d, bn_t, bn_d,
              H, MT, MB, rhs):
        halo_out = jnp.zeros((H + 1, cs, Rm), rhs.dtype)

        def step_body(a, sc):
            rhs, halo_out = sc
            k = steps_me[a]
            r_a = rhs[a]
            y = solve_diag(data, lower, r_a, k)
            y = jnp.where(k < K, y, r_a)
            rhs = rhs.at[a].set(y)
            for j in range(MT):
                t = st_t[a, j]
                contrib = _bmm(data.offdiag[t], y)
                dstslot = st_d[a, j] - H
                rhs = rhs.at[jnp.clip(dstslot, 0, Kl - 1)].add(
                    jnp.where(t < plan_T, contrib, 0.0)
                )
            for j in range(MB):
                t = bn_t[a, j]
                contrib = _bmm(data.offdiag[t], y)
                halo_out = halo_out.at[bn_d[a, j]].add(
                    jnp.where(t < plan_T, contrib, 0.0)
                )
            return rhs, halo_out

        rhs, halo_out = lax.fori_loop(0, Kl, step_body, (rhs, halo_out))
        return rhs, halo_out[:H]

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(),) + (P(axis),) * 13,
        out_specs=P(axis) if shard_output else P(),
        check_vma=False,
    )
    def run(xw, l_steps, l_st_t, l_st_d, l_bn_t, l_bn_d,
            u_steps, u_st_t, u_st_d, u_bn_t, u_bn_d, u_fl,
            u_asc_me, u_mask_me):
        d = lax.axis_index(axis)
        pos_l = d
        pos_u = 2 * D - 1 - d
        l_steps, l_st_t, l_st_d = l_steps[0], l_st_t[0], l_st_d[0]
        l_bn_t, l_bn_d = l_bn_t[0], l_bn_d[0]
        u_steps, u_st_t, u_st_d = u_steps[0], u_st_t[0], u_st_d[0]
        u_bn_t, u_bn_d = u_bn_t[0], u_bn_d[0]
        u_fl = u_fl[0]

        def local_rows(m):
            rows = xw[l_steps]                         # (Kl, cs, R)
            return lax.dynamic_slice_in_dim(rows, m * Rm, Rm, axis=2)

        locL0 = jnp.stack([local_rows(m) for m in range(M)])
        haloL0 = jnp.zeros((M, HL, cs, Rm), xw.dtype)
        haloU0 = jnp.zeros((M, HU, cs, Rm), xw.dtype)
        outU0 = jnp.zeros((M, Kl, cs, Rm), xw.dtype)

        def round_body(r, carry):
            locL, haloL, haloU, outU = carry

            # ---- forward sweep: panel r - pos_l -------------------------
            m_l = r - pos_l
            al = jnp.logical_and(m_l >= 0, m_l < M)
            mli = jnp.clip(m_l, 0, M - 1)
            rhs = locL[mli]
            rhs = lax.dynamic_update_slice_in_dim(
                rhs, rhs[:HL] + haloL[mli], 0, axis=0
            )
            rhs, hol = sweep(ldata, lplan.T, True, l_steps,
                             l_st_t, l_st_d, l_bn_t, l_bn_d,
                             HL, lp.MT, lp.MB, rhs)
            rhs = jnp.where(al, rhs, locL[mli])
            hol = jnp.where(al, hol, 0.0)
            locL = locL.at[mli].set(rhs)

            # ---- backward sweep: panel r - pos_u (zero-comm handoff) ----
            m_u = r - pos_u
            au = jnp.logical_and(m_u >= 0, m_u < M)
            mui = jnp.clip(m_u, 0, M - 1)
            rhs_u = locL[mui][u_fl]          # L result rows in U step order
            rhs_u = lax.dynamic_update_slice_in_dim(
                rhs_u, rhs_u[:HU] + haloU[mui], 0, axis=0
            )
            rhs_u, hou = sweep(udata, uplan.T, False, u_steps,
                               u_st_t, u_st_d, u_bn_t, u_bn_d,
                               HU, up.MT, up.MB, rhs_u)
            hou = jnp.where(au, hou, 0.0)
            outU = outU.at[mui].set(jnp.where(au, rhs_u, outU[mui]))

            # ---- halo exchanges: L forward, U backward ------------------
            perm_f = [(i, i + 1) for i in range(D - 1)]
            perm_b = [(i, i - 1) for i in range(1, D)]
            recv_l = lax.ppermute(hol, axis, perm_f)
            recv_u = lax.ppermute(hou, axis, perm_b)
            m_rl = r + 1 - pos_l             # local pos: SPMD receiver math
            haloL = haloL.at[jnp.clip(m_rl, 0, M - 1)].add(
                jnp.where(jnp.logical_and(m_rl >= 0, m_rl < M), recv_l, 0.0)
            )
            m_ru = r + 1 - pos_u
            haloU = haloU.at[jnp.clip(m_ru, 0, M - 1)].add(
                jnp.where(jnp.logical_and(m_ru >= 0, m_ru < M), recv_u, 0.0)
            )
            return locL, haloL, haloU, outU

        _, _, _, outU = lax.fori_loop(
            0, M + 2 * D - 1, round_body, (locL0, haloL0, haloU0, outU0)
        )
        outR = jnp.concatenate([outU[m] for m in range(M)], axis=-1)
        if shard_output:
            # this device's chunk rows, ascending — no collective at all
            return outR[u_asc_me[0]] * u_mask_me[0][:, None, None]
        glob = jnp.zeros_like(xw)
        glob = glob.at[u_steps].add(outR)
        return lax.psum(glob, axis)

    return run(xw, *dev_arrays)
