"""Windowed tile-store assembly for the device refactorization.

The refactorization's input assembly scatters A's nonzeros into the
merged dense tile store as ``(Rs·A)[p, q]``. A flat per-element scatter
processes one index per nonzero; this module moves whole rows instead,
in vectorized stages built on three facts:

* CSC nonzeros of one column are stored consecutively, and consecutive
  rows within a column land at consecutive flat positions of a
  TRANSPOSED tile layout ``(tile, col, row)`` — but only if rows are NOT
  permuted (the pivot permutation scrambles runs);
* so the value stream splits into maximal runs (consecutive destination
  AND source positions) that move as W-wide rows;
* a row permutation of a blocked store is itself a static row GATHER.

Stages:

1. **Unpermuted transposed store build** — W-wide source rows gathered
   from a W-shifted replication of ``a_data`` and row-scattered into the
   store. Elements not covered (multiple runs colliding in one dest row)
   fall back to a flat per-element scatter on top.
2. **Equilibration** on the unpermuted store: per-row max reduces along
   the transposed store's minor axis (dense, vectorized), block-row
   combine via a tiny (K, MT, cs) gather — and Rs comes out directly in
   ORIGINAL row order (rows were never permuted).
3. **Transpose + row permutation**: one dense swapaxes pass, then one
   static row gather maps unpermuted store rows to the factor-closure
   store's ``(Rs·A)[p, q]`` rows.
4. **Identity pads**: the tail-diagonal and dummy-tile ones land with a
   tiny flat scatter at the end.

Mirrors the semantics of UMFPACK's per-``lu!`` row-scaling recompute
(reference src/SharedMemSparseLU.jl:263) and the packer's scatter
(src:180-243).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

__all__ = ["WindowPlan", "plan_windowed_assembly", "assemble_windowed"]


def _pick_W(cs: int) -> int:
    for w in (16, 8, 4, 2, 1):
        if (cs * cs) % w == 0:
            return w
    return 1


@dataclasses.dataclass
class WindowPlan:
    """Static schedule for the windowed assembly (all host-built)."""

    W: int
    TF2: int           # tiles in the UNPERMUTED pattern grid (+1 zero slot)
    R1: int            # rows per shift in the replicated source table
    Np: int            # padded a_data length (multiple of W, = R1*W + W)
    win_src: np.ndarray   # (Rw,) source row in the shifted table
    win_dst: np.ndarray   # (Rw,) dest W-row in the transposed store
    win_mask: np.ndarray  # (Rw, W) 1.0 where the run covers the slot
    left_src: np.ndarray  # (Lf,) leftover element -> a_data index
    # leftover / constant-1.0 destinations as (row, col) pairs into the
    # ((TF2+1)*cs, cs) row view of the transposed store: FLAT positions
    # can exceed int32 at large n and jnp.asarray would silently truncate
    # int64 when x64 is off (the JAX default) — rows and cols never can.
    # (ones = nd-embedding identity entries, scattered BEFORE the
    # equilibration so they are scaled like values.)
    left_row: np.ndarray  # (Lf,)
    left_col: np.ndarray  # (Lf,)
    ones_row: np.ndarray  # (Of,)
    ones_col: np.ndarray  # (Of,)
    brow2_tiles: np.ndarray  # (K, MT2) tile ids per block row (pad = TF2)
    tile_brow2: np.ndarray   # (TF2+1,) block row of each tile
    permrow_src: np.ndarray  # ((TF+2)*cs,) row-permutation gather map
    # identity-one positions in the final store, as (row, col) pairs into
    # the ((TF+2)*cs, cs) row view — flat positions can exceed int32 (the
    # closure store has TF*cs^2 slots), row/col never do
    pad_row: np.ndarray
    pad_col: np.ndarray


def plan_windowed_assembly(
    A_pattern: sp.csc_matrix,
    p: np.ndarray,
    q: np.ndarray,
    cs: int,
    order: list,
    TF: int,
    n_pad_tail: np.ndarray,
    data_src: np.ndarray | None = None,
) -> WindowPlan:
    """Build the static windowed-assembly schedule.

    ``order``/``TF`` describe the factor-closure tile grid (the store the
    elimination consumes); ``n_pad_tail`` is the list of final-store flat
    positions that receive identity ones (tail diagonal + dummy tile).

    ``data_src`` (optional, len = pattern nnz) maps each pattern nonzero
    to its index in the runtime value stream, with -1 meaning a constant
    1.0 (the nd embedding's identity entries). Folding this mapping into
    the window schedule removes a per-element gather (data_src has long
    runs: ~95 on the nd Poisson embedding).
    """
    A = sp.csc_matrix(A_pattern)
    n = A.shape[0]
    K = -(-n // cs)
    W = _pick_W(cs)
    qinv = np.argsort(q)

    rows = A.indices.astype(np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    bj = qinv[cols]
    trow, r = rows // cs, rows % cs
    tcol, c = bj // cs, bj % cs

    # unpermuted tile grid (pattern tiles only; slot TF2 stays all-zero)
    keys2 = trow * K + tcol
    uk = np.unique(keys2)
    TF2 = int(len(uk))
    t2 = np.searchsorted(uk, keys2)
    destT = (t2 * cs + c) * cs + r  # transposed layout: (tile, col, row)

    # value-stream source index per pattern nonzero (-1 = constant 1.0)
    if data_src is None:
        src = np.arange(len(rows), dtype=np.int64)
        ones_dst = np.empty(0, dtype=np.int64)
    else:
        data_src = np.asarray(data_src, dtype=np.int64)
        real = data_src >= 0
        ones_dst = destT[~real]
        destT = destT[real]
        src = data_src[real]
    nnz = int(src.max()) + 1 if len(src) else 1
    R1 = (nnz + 2 * W - 2) // W + 1
    Np = R1 * W + W

    # --- maximal runs: consecutive dest AND consecutive source -------------
    ne = len(destT)
    newrun = np.ones(ne, dtype=bool)
    if ne > 1:
        newrun[1:] = (destT[1:] != destT[:-1] + 1) | (src[1:] != src[:-1] + 1)
    run_start = np.nonzero(newrun)[0]
    run_d0 = destT[run_start]
    run_s0 = src[run_start]
    run_len = np.diff(np.append(run_start, ne))
    nruns = len(run_start)
    rid = np.cumsum(newrun) - 1

    # --- candidate (dest W-row, run) pairs; longest coverage wins ----------
    rf = run_d0 // W
    rl = (run_d0 + run_len - 1) // W
    cnt = rl - rf + 1
    tot = int(cnt.sum())
    cand_run = np.repeat(np.arange(nruns), cnt)
    off = np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    wrow = rf[cand_run] + off
    lo = np.maximum(run_d0[cand_run], wrow * W)
    hi = np.minimum(run_d0[cand_run] + run_len[cand_run], (wrow + 1) * W)
    ordr = np.lexsort((lo - hi, wrow))  # (wrow asc, coverage desc)
    first = np.ones(tot, dtype=bool)
    ws = wrow[ordr]
    if tot > 1:
        first[1:] = ws[1:] != ws[:-1]
    sel = ordr[first]
    win_wrow = wrow[sel]               # sorted ascending
    win_run = cand_run[sel]

    # gather source row: the value landing at slot 0 has source index
    # run_s0 + (wrow*W - run_d0); front-pad of W zeros keeps it >= 0
    g = run_s0[win_run] + win_wrow * W - run_d0[win_run] + W
    s = g % W
    win_src = (s * R1 + g // W).astype(np.int32)
    ar = np.arange(W, dtype=np.int64)
    lo_s = (lo[sel] - win_wrow * W)[:, None]
    hi_s = (hi[sel] - win_wrow * W)[:, None]
    win_mask = ((ar >= lo_s) & (ar < hi_s)).astype(np.float32)

    # leftovers: elements whose run lost its dest row to a longer run
    pos = np.searchsorted(win_wrow, destT // W)
    covered = rid == win_run[pos]
    left_src = src[~covered].astype(np.int32)
    left_dst = destT[~covered]
    # win_dst indexes W-wide rows, so it stays int32 far beyond any store
    # the HBM budget admits; a hard error (never stripped under -O, unlike
    # assert) rather than a silent index truncation
    if (TF2 + 1) * cs * cs // W >= 2**31:
        raise ValueError("window store exceeds int32 rows")

    # --- equilibration maps (unpermuted grid) ------------------------------
    browt: list = [[] for _ in range(K)]
    for t, key in enumerate(uk):
        browt[int(key // K)].append(t)
    MT2 = max(1, max(len(x) for x in browt))
    brow2_tiles = np.full((K, MT2), TF2, dtype=np.int32)
    for i, x in enumerate(browt):
        brow2_tiles[i, : len(x)] = x
    tile_brow2 = np.zeros(TF2 + 1, dtype=np.int32)
    tile_brow2[:TF2] = uk // K

    # --- row-permutation gather map ----------------------------------------
    # final store rows (after transpose back): row (t, u) of factor tile
    # t = (bi, tj) holds original row p[bi*cs + u] restricted to tj's
    # columns; its source is row (p[...] % cs) of unpermuted tile
    # (p[...]//cs, tj), or the all-zero slot TF2 when that tile is empty
    zero_row = TF2 * cs
    permrow_src = np.full(((TF + 2) * cs,), zero_row, dtype=np.int32)
    for t, (bi, tj) in enumerate(order):
        gr0 = bi * cs
        u_max = min(cs, n - gr0)
        if u_max <= 0:
            continue
        pr = p[gr0:gr0 + u_max].astype(np.int64)
        key = (pr // cs) * K + tj
        idx = np.searchsorted(uk, key)
        idx_c = np.minimum(idx, TF2 - 1)
        present = uk[idx_c] == key
        src = np.where(present, idx_c * cs + pr % cs, zero_row)
        permrow_src[t * cs:t * cs + u_max] = src

    return WindowPlan(
        W=W, TF2=TF2, R1=R1, Np=Np,
        win_src=win_src,
        win_dst=win_wrow.astype(np.int32),
        win_mask=win_mask,
        left_src=left_src,
        left_row=(left_dst // cs).astype(np.int32),
        left_col=(left_dst % cs).astype(np.int32),
        ones_row=(ones_dst // cs).astype(np.int32),
        ones_col=(ones_dst % cs).astype(np.int32),
        brow2_tiles=brow2_tiles,
        tile_brow2=tile_brow2,
        permrow_src=permrow_src,
        pad_row=(np.asarray(n_pad_tail) // cs).astype(np.int32),
        pad_col=(np.asarray(n_pad_tail) % cs).astype(np.int32),
    )


def assemble_windowed(a_data, dev, *, n: int, cs: int, TF: int,
                      TF2: int, W: int, R1: int, Np: int):
    """Device assembly: a_data (factor-pattern CSC order) → permuted,
    equilibrated tile store (TF+2, cs, cs) + Rs in original row order."""
    dt = a_data.dtype
    nnz = a_data.shape[0]
    n_rows = (TF2 + 1) * cs
    # W shifted views of the zero-padded value stream: row (s*R1 + k)
    # holds a_pad[s + k*W : s + k*W + W], so ANY W-span is one row
    a_pad = jnp.pad(a_data, (W, Np - W - nnz))
    a_big = jnp.concatenate(
        [a_pad[s:s + R1 * W].reshape(R1, W) for s in range(W)], axis=0
    )
    upd = jnp.take(a_big, dev["win_src"], axis=0, mode="clip")
    upd = upd * dev["win_mask"].astype(dt)
    M2 = (TF2 + 1) * cs * cs
    st = jnp.zeros((M2 // W, W), dt).at[dev["win_dst"]].set(
        upd, mode="drop", unique_indices=True
    )
    # leftover / identity destinations index the ((TF2+1)*cs, cs) row
    # view as (row, col) pairs — flat positions could exceed int32
    rows2v = st.reshape(n_rows, cs)
    if dev["left_src"].shape[0]:
        rows2v = rows2v.at[dev["left_row"], dev["left_col"]].set(
            a_data[dev["left_src"]], mode="drop", unique_indices=True
        )
    orow = dev["ones_row"]
    if orow.shape[0]:
        # nd-embedding identity entries: constant 1.0 values, placed
        # BEFORE the equilibration so they are row-scaled like the rest
        rows2v = rows2v.at[orow, dev["ones_col"]].set(
            jnp.ones(orow.shape, dt), mode="drop", unique_indices=True
        )
    t2 = rows2v.reshape(TF2 + 1, cs, cs)  # transposed: (tile, col, row)

    # row equilibration on the unpermuted store: reduce over the col axis
    # (dense), combine block rows with a tiny (K, MT2, cs) gather. Rows
    # were never permuted, so rs is directly in ORIGINAL row order.
    m = jnp.max(jnp.abs(t2), axis=1)                    # (TF2+1, cs)
    rowmax = jnp.max(m[dev["brow2_tiles"]], axis=1)     # (K, cs)
    rs2d = jnp.where(rowmax > 0, 1.0 / rowmax, jnp.ones((), dt))
    t2 = t2 * rs2d[dev["tile_brow2"]][:, None, :]
    rs = rs2d.reshape(-1)[:n]

    # transpose back + apply the row permutation as a static row gather
    rows2 = jnp.swapaxes(t2, -1, -2).reshape((TF2 + 1) * cs, cs)
    rowsP = jnp.take(rows2, dev["permrow_src"], axis=0, mode="clip")
    # identity pads via 2-D (row, col) indexing: the closure store's FLAT
    # index space can exceed int32 at large n, row/col never do
    pr, pc = dev["pad_row"], dev["pad_col"]
    rowsP = rowsP.at[pr, pc].set(
        jnp.ones(pr.shape, dt), mode="drop", unique_indices=True
    )
    return rowsP.reshape(TF + 2, cs, cs), rs
