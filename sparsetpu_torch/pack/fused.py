"""Fused resident-x pack: the round-3 layout (RFX).

Re-derivation of the packed format for matrices whose x vector fits in
VMEM (nr_cols <= ~1.5M f32), replacing BOTH the column-blocked forward
stream (csr_hw.cpp:270-318) and the host/device result accumulation
(csr_hw.cpp:1531-1565) with one kernel pass:

  * x is fully VMEM-resident — the 2D column blocking of the reference
    (util.h:43-58) exists only because BRAM couldn't hold x; VMEM can.
  * every (8, 128) tile gathers from a per-tile *dynamic* window of
    ``GLW`` 1024-column groups at an UNALIGNED base (scalar-prefetched),
    so a row's nnz chunk never splits at aligned window boundaries:
    chunks are simply consecutive nnz runs (the reference's exact-nnz
    stream, csr_hw.cpp:108-114, recovered at Q=8).  Simulated fill
    ~0.85-0.87 on the headline distribution vs 0.66 for the aligned
    per-step window.
  * tiles are ordered row-slab-major: each grid step's chunks come from
    one contiguous row range, so the chunk->row reduction happens INSIDE
    the same kernel step — finish tiles gather from the step's chunk-sum
    VMEM scratch and accumulate into a per-step output block.  No
    chunk-sum HBM round trip, no separate finish kernel.

Slot terminology matches pack/gather_stream.py (CHUNK/STRIPE/LANES).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..formats.csr import CSRMatrix
from ..utils.config import LANES
from .gather_stream import CHUNK, STRIPE, _fill_free_slots, _match_tiles

class _ScatterStarved(Exception):
    """Step-exact band packing hit availability starvation."""


GRP_COLS = CHUNK * STRIPE          # 1024 columns per window group
DEF_GLW = 16                       # window groups per tile (16384 cols)
DEF_T = 128                        # tiles per grid step
MAX_RESIDENT_COLS = 1_500_000      # x VMEM budget (~6 MB f32)
SCATTER_LANE_KEYS = 4              # lanes a row may use in the Q=1 pack
MAX_F1 = 96                        # stage-1 finish tiles per step cap
MAX_F2 = 64                        # stage-2 finish tiles per step cap
F2_DRAIN = 256                     # stage-2 drain cell sentinel


@dataclasses.dataclass(eq=False)
class FusedMatrix:
    """Packed fused-layout matrix (host arrays)."""

    values: np.ndarray      # (n_steps*T*8, 128) f32
    meta_i1: np.ndarray     # (n_steps*T*8, 128) int8 local stripe index
    meta_rt: np.ndarray     # (n_steps*T*8, 128) int8 lane route
    tile_base: np.ndarray   # (n_steps, T) int32 window group base per tile
    fin1_i1: np.ndarray     # (n_steps*F1_max*8, 128) i8 (drain = -1)
    fin1_rt: np.ndarray     # (n_steps*F1_max*8, 128) i8
    fin2_i1: np.ndarray     # (n_steps*F2_max*8, 128) i8 (drain = -1)
    fin2_rt: np.ndarray     # (n_steps*F2_max*8, 128) i8
    fin2_group: np.ndarray   # (n_steps, F2_max) i32 aligned out group
    fin1_cnt: np.ndarray     # (n_steps,) int32
    fin2_cnt: np.ndarray     # (n_steps,) int32
    step_slab: np.ndarray   # (n_steps,) int32 out block (slab) per step
    step_first: np.ndarray  # (n_steps,) int32 1 = first step of its slab
    slab_bounds: np.ndarray  # (n_slabs+1,) int64 slab row ranges
    spill_row: np.ndarray   # (n_spill,) int32 COO fixup (matcher losers)
    spill_col: np.ndarray   # (n_spill,) int32
    spill_val: np.ndarray   # (n_spill,) value dtype
    nr_rows: int
    nr_cols: int
    nr_nzeros: int
    Q: int                  # row-pad quantum
    GLW: int                # window groups per tile
    T: int                  # tiles per step
    GX: int                 # resident x groups (padded_cols / 1024)
    OBp: int                # out tiles per slab block
    F1_max: int
    F2_max: int
    F1S: int                # scratch2 height (pow2*8 >= F1_max)
    n_slabs: int
    fin_direct: int = 0     # 1 = stage 2 reads the step scratch directly
    SGRP: int = 1           # sub-steps folded into one kernel grid step

    @property
    def G(self) -> int:
        """Window groups per tile (classic-layout naming compat)."""
        return self.GLW

    @property
    def planes(self) -> int:
        return CHUNK // self.Q

    @property
    def n_tiles(self) -> int:
        return self.values.shape[0] // CHUNK

    @property
    def n_steps(self) -> int:
        return self.tile_base.shape[0]

    @property
    def padded_cols(self) -> int:
        return self.GX * GRP_COLS

    @property
    def n_slots(self) -> int:
        return self.n_tiles * CHUNK * LANES

    @property
    def fill_factor(self) -> float:
        return self.nr_nzeros / max(self.n_slots, 1)

    def storage_bytes(self) -> int:
        return (self.values.nbytes + self.meta_i1.nbytes
                + self.meta_rt.nbytes + self.fin1_i1.nbytes
                + self.fin1_rt.nbytes + self.fin2_i1.nbytes
                + self.fin2_rt.nbytes
                + self.tile_base.nbytes + self.fin2_group.nbytes)

    def storage_overhead(self) -> float:
        csr_bytes = (self.nr_nzeros * (self.values.dtype.itemsize + 4)
                     + 4 * (self.nr_rows + 1))
        return self.storage_bytes() / max(csr_bytes, 1)


def _cut_chunks(row_ptr, grp, Q, GLW):
    """Vectorized greedy chunk cut: per row, consecutive nnz runs of at
    most Q elements spanning at most GLW groups (spans never split at
    aligned boundaries — the per-tile base is free).  Returns row-major
    chunk (start, end) element ranges and the chunk row ids."""
    n_rows = row_ptr.shape[0] - 1
    nnz = int(row_ptr[-1])
    if nnz == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64),
                       np.diff(row_ptr).astype(np.int64))
    ng = int(grp.max()) + 1
    key = row_of * (ng + GLW + 1) + grp      # strictly row-monotone
    starts_list, ends_list = [], []
    bd = row_ptr[:-1].astype(np.int64)
    row_end = row_ptr[1:].astype(np.int64)
    alive = bd < row_end
    bd, row_end = bd[alive], row_end[alive]
    while bd.size:
        span_end = np.searchsorted(key, key[bd] + GLW, side="left")
        nb = np.minimum(np.minimum(bd + Q, span_end), row_end)
        starts_list.append(bd)
        ends_list.append(nb)
        alive = nb < row_end
        bd, row_end = nb[alive], row_end[alive]
    c_start = np.concatenate(starts_list)
    order = np.argsort(c_start, kind="stable")   # row-major chunk order
    c_start = c_start[order]
    c_end = np.concatenate(ends_list)[order]
    return c_start, c_end, row_of[c_start]


def _cut_steps(chunks_per_row_cum, n_rows, cpt_step, max_rows):
    """Cut contiguous row ranges (one slab == one grid step) holding at
    most ``cpt_step`` chunks and ``max_rows`` rows."""
    bounds = [0]
    r = 0
    while r < n_rows:
        target = chunks_per_row_cum[r] + cpt_step
        nr = int(np.searchsorted(chunks_per_row_cum, target,
                                 side="right")) - 1
        nr = min(max(nr, r + 1), n_rows, r + max_rows)
        bounds.append(nr)
        r = nr
    return np.asarray(bounds, dtype=np.int64)


def _bin_tiles(sgrp, egrp, GLW, cpt, max_open=24):
    """First-fit chunks (sorted by start group) into tiles whose member
    spans fit one GLW-group window.  Returns tile id per chunk and the
    tile count.  (Python loop; the native packer provides the fast
    path — see native/packer.cpp fused_bin.)"""
    n = sgrp.shape[0]
    tile_of = np.empty(n, dtype=np.int64)
    open_lo, open_hi, open_cnt, open_id = [], [], [], []
    n_tiles = 0
    for c in range(n):
        s, e = sgrp[c], egrp[c]
        placed = -1
        for k in range(len(open_id)):
            nlo = open_lo[k] if open_lo[k] < s else s
            nhi = open_hi[k] if open_hi[k] > e else e
            if nhi - nlo <= GLW - 1 and open_cnt[k] < cpt:
                open_lo[k], open_hi[k] = nlo, nhi
                open_cnt[k] += 1
                placed = k
                break
        if placed >= 0:
            tile_of[c] = open_id[placed]
            if open_cnt[placed] == cpt:
                for lst in (open_lo, open_hi, open_cnt, open_id):
                    lst.pop(placed)
        else:
            if len(open_id) >= max_open:
                k = int(np.argmax(open_cnt))
                for lst in (open_lo, open_hi, open_cnt, open_id):
                    lst.pop(k)
            open_lo.append(int(s))
            open_hi.append(int(e))
            open_cnt.append(1)
            open_id.append(n_tiles)
            tile_of[c] = n_tiles
            n_tiles += 1
    return tile_of, n_tiles


def _rank_within(keys):
    """Stable rank of each element within its key group (keys arbitrary
    order)."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    if ks.shape[0] == 0:
        return np.zeros(0, np.int64)
    runs = np.flatnonzero(np.diff(ks)) + 1
    starts = np.concatenate([[0], runs])
    counts = np.diff(np.concatenate([starts, [ks.shape[0]]]))
    rank = np.empty(ks.shape[0], dtype=np.int64)
    rank[order] = np.arange(ks.shape[0]) - np.repeat(starts, counts)
    return rank


def _native_fused_bin():
    try:
        from ..native.packer import available, fused_bin_native
        return fused_bin_native if available() else None
    except Exception:
        return None


def _native_v2():
    """The C++ single-pass pack (augmenting-path matching + first-fit
    with span constraints) — the fused forward is exactly one v2 block
    over the whole column range, packed per row slab."""
    try:
        from ..native.packer import available, pack_v2_native
        return pack_v2_native if available() else None
    except Exception:
        return None


def _finish_two_stage_numpy(orow, sub, lane, scr_rows, direct=False):
    """NumPy port of the native two-stage finish builder (packer.cpp
    stpu_fused_finish); used when the C++ library is absent.  Python
    loops — fine for the small matrices the fallback serves."""
    order = np.argsort(orow, kind="stable")
    orow, sub, lane = orow[order], sub[order], lane[order]
    n = orow.shape[0]
    t1 = []   # [cells (8,128), route, used, n_chunks, seed]
    partials = []
    i = 0
    if direct:
        partials = [(int(orow[k]), int(sub[k]), int(lane[k]))
                    for k in range(n)]
        i = n
    while i < n:
        r = orow[i]
        els = []
        while i < n and orow[i] == r and len(els) < CHUNK:
            els.append((int(lane[i]), int(sub[i])))
            i += 1

        def try_match(cells):
            # tiny augmenting matcher
            slot_of = [-1] * len(els)
            elem_of = [-1] * CHUNK

            def aug(e, visited):
                for s in range(CHUNK):
                    if visited[s]:
                        continue
                    c = cells[s][els[e][0]]
                    if c != -1 and c != els[e][1]:
                        continue
                    visited[s] = True
                    if elem_of[s] < 0 or aug(elem_of[s], visited):
                        elem_of[s] = e
                        slot_of[e] = s
                        return True
                return False
            for e in range(len(els)):
                if not aug(e, [False] * CHUNK):
                    return None
            return slot_of

        dst = None
        for ti, t in enumerate(t1):
            if t[3] >= LANES:
                continue
            so = try_match(t[0])
            if so is not None:
                dst, slot_of = ti, so
                break
        if dst is None:
            if len(t1) >= MAX_F1:
                return None
            t1.append([[[-1] * LANES for _ in range(CHUNK)],
                       np.zeros((CHUNK, LANES), np.int64),
                       np.zeros((CHUNK, LANES), bool), 0,
                       (len(t1) * 53 + 29) & (LANES - 1)])
            dst = len(t1) - 1
            slot_of = try_match(t1[dst][0])
        t = t1[dst]
        k = t[3]
        t[3] += 1
        l1 = (k * 37 + t[4]) & (LANES - 1)
        for e, (res, stripe) in enumerate(els):
            s = slot_of[e]
            t[0][s][res] = stripe
            t[1][s, l1] = res
            t[2][s, l1] = True
        partials.append((int(r), dst, l1))
    # stage 2
    t2 = []   # [group, cells, route, used]
    for r, t1i, l1 in partials:
        g = r // (CHUNK * LANES)
        s = (r // LANES) % CHUNK
        l = r % LANES
        dst = None
        for t in t2:
            if t[0] != g or t[3][s, l]:
                continue
            c = t[1][s][l1]
            if c != -1 and c != t1i:
                continue
            dst = t
            break
        if dst is None:
            if len(t2) >= MAX_F2:
                return None
            dst = [g, [[-1] * LANES for _ in range(CHUNK)],
                   np.zeros((CHUNK, LANES), np.int64),
                   np.zeros((CHUNK, LANES), bool)]
            t2.append(dst)
        dst[1][s][l1] = t1i
        dst[2][s, l] = l1
        dst[3][s, l] = True

    def finalize(tiles, drain, cell_i, route_i, used_i):
        cells_o, route_o = [], []
        for t in tiles:
            ca = np.asarray(t[cell_i], dtype=np.int64)
            ca[ca < 0] = drain
            ro = np.asarray(t[route_i], dtype=np.int64)
            used = t[used_i]
            free_r = np.argmax(np.asarray(t[cell_i]) == -1, axis=1)
            su, lu = np.nonzero(~used)
            ro[su, lu] = free_r[su]
            cells_o.append(ca)
            route_o.append(ro)
        return cells_o, route_o
    c1, r1 = finalize(t1, scr_rows, 0, 1, 2)
    c2, r2 = finalize(t2, F2_DRAIN, 1, 2, 3)
    g2 = [t[0] for t in t2]
    return c1, r1, g2, c2, r2


def _rechunk_lost(rows, cols, vals, grp_cols, Q, GLW):
    """Re-chunk matcher losers: group by row (column-sorted), cut runs
    of at most Q elements spanning at most GLW groups.  Returns padded
    element arrays (ch_row, el_col, el_val, el_real)."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    urow, inv, cnt = np.unique(rows, return_inverse=True,
                               return_counts=True)
    row_ptr = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    grp = cols // grp_cols
    c_start, c_end, c_rl = _cut_chunks(row_ptr, grp, Q, GLW)
    nck = c_start.shape[0]
    lens = c_end - c_start
    el_chunk = np.repeat(np.arange(nck, dtype=np.int64), Q)
    el_k = np.tile(np.arange(Q, dtype=np.int64), nck)
    real = el_k < lens[el_chunk]
    src = c_start[el_chunk] + np.minimum(el_k, lens[el_chunk] - 1)
    return (urow[c_rl], cols[src], np.where(real, vals[src], 0), real)


# stage-1 out-lane rule for the native finish builder: K >= 1 row-keys
# the lane ((row + j*128/K) & 127), making stage-2 cells near-conflict-
# free (see packer.cpp stpu_fused_finish); 0 = legacy 37-stride shuffle.
# Measured on the banded headline: K=1 trades F2 10 -> 6 against F1
# 19 -> 21 (keyed-lane matcher spills) — a small net win; K=2's extra
# key diversity gives the F2 conflicts back (F2 9).
FINISH_L1_KEYS = 1


def _finish_for_step(orows, sub_i, lane_i, scr_rows, direct=False):
    """Two-stage finish tiles for one step (native fast path with numpy
    fallback).  Returns (cells1, route1, group2, cells2, route2) lists
    or None on overflow.

    ``direct`` (decided globally per matrix — the kernel selects ONE
    stage-2 source) skips stage 1: for scattered rows (< ~3 children
    each) its one-group-per-lane shape caps a tile at 128 rows, wasting
    ~70% of its cells — children go straight to stage-2 slot-target
    tiles reading the step scratch (the VF=1 exact-stream regime,
    csr_hw.cpp:108-114)."""
    if orows.shape[0] == 0:
        return [], [], [], [], []
    osort = np.argsort(orows, kind="stable")
    try:
        from ..native.packer import fused_finish_native
        out = fused_finish_native(orows[osort], sub_i[osort],
                                  lane_i[osort], scr_rows,
                                  max_f1=MAX_F1, f1_drain=F2_DRAIN,
                                  direct=direct,
                                  l1_keys=0 if direct else FINISH_L1_KEYS)
        if out is None:
            return None
        cells1, route1, group2, cells2, route2 = out
        n1 = cells1.shape[0] // CHUNK
        n2 = group2.shape[0]
        if n2 > MAX_F2:
            return None
        c1 = [cells1[f * CHUNK:(f + 1) * CHUNK].astype(np.int64)
              for f in range(n1)]
        r1 = [route1[f * CHUNK:(f + 1) * CHUNK].astype(np.int64)
              for f in range(n1)]
        c2 = [cells2[f * CHUNK:(f + 1) * CHUNK].astype(np.int64)
              for f in range(n2)]
        r2 = [route2[f * CHUNK:(f + 1) * CHUNK].astype(np.int64)
              for f in range(n2)]
        return c1, r1, list(group2.astype(int)), c2, r2
    except ImportError:
        pass
    except OSError:
        pass
    return _finish_two_stage_numpy(orows, sub_i.astype(np.int64),
                                   lane_i.astype(np.int64), scr_rows,
                                   direct=direct)


SAMPLE_NNZ = 160_000          # Q-chooser candidate packs run on a sample
SAMPLE_BANDS = 8


def _sample_rows(matrix: CSRMatrix, target_nnz: int = SAMPLE_NNZ,
                 bands: int = SAMPLE_BANDS) -> CSRMatrix:
    """A small stand-in matrix made of ``bands`` contiguous row bands
    spread evenly through the matrix, totalling ~``target_nnz`` nnz.
    Used to COST candidate layouts without packing the full matrix per
    candidate (the reference's repack is a fixed two-pass phase,
    main.cpp:67-72 — the chooser must not multiply it)."""
    nr = matrix.nr_rows
    rp = matrix.row_ptr.astype(np.int64)
    per_band = max(target_nnz // bands, 1)
    ptr_parts = [np.zeros(1, np.int64)]
    ci_parts, v_parts = [], []
    off = 0
    for b in range(bands):
        r0 = (nr * b) // bands
        # extend the band until it holds per_band nnz (or hits the next
        # band's start region)
        r1 = int(np.searchsorted(rp, rp[r0] + per_band, side="left"))
        r1 = min(max(r1, r0 + 1), nr)
        lo, hi = int(rp[r0]), int(rp[r1])
        ptr_parts.append(rp[r0 + 1:r1 + 1] - lo + off)
        ci_parts.append(matrix.col_ind[lo:hi])
        v_parts.append(matrix.values[lo:hi])
        off += hi - lo
    return CSRMatrix(
        np.concatenate(ptr_parts).astype(matrix.row_ptr.dtype),
        np.concatenate(ci_parts) if ci_parts else
        np.zeros(0, matrix.col_ind.dtype),
        np.concatenate(v_parts) if v_parts else
        np.zeros(0, matrix.values.dtype),
        int(sum(p.shape[0] for p in ptr_parts) - 1), matrix.nr_cols)


def _layout_cost(c: "FusedMatrix") -> float:
    """Per-nnz total slot cost (forward + finish streams)."""
    return (c.n_slots + (c.fin1_i1.shape[0] + c.fin2_i1.shape[0])
            * LANES) / max(c.nr_nzeros, 1)


def _choose_q(matrix: CSRMatrix, GLW: int) -> int:
    """Pick the row-pad quantum by the matrix's chunk-run length: the
    mean number of consecutive nnz a row keeps inside one GLW window.
    Dense-ish rows (runs >= ~4) amortize Q=8's padding; the scattered
    regime (runs ~1 — the reference's VF=1 zero-pad case,
    csr_hw.cpp:108-114) packs each element as its own Q=1 chunk: the
    forward stream is then exactly nnz-sized (up to matcher occupancy)
    and the per-row reduction moves to the two-stage in-step finish."""
    grp = (matrix.col_ind // GRP_COLS).astype(np.int64)
    c_start, _, _ = _cut_chunks(matrix.row_ptr, grp, 8, GLW)
    if c_start.shape[0] == 0:
        return 8
    mean_len = matrix.nr_nzeros / c_start.shape[0]
    return 8 if mean_len >= 3.5 else 1


def pack_fused(matrix: CSRMatrix, Q: Optional[int] = None,
               GLW: int = DEF_GLW,
               T: Optional[int] = None, value_dtype=np.float32,
               use_native: bool = True, slack: float = 0.93,
               slab_steps: int = 12,
               band_exact: Optional[bool] = None,
               sgrp: Optional[int] = None) -> Optional[FusedMatrix]:
    """Pack a CSR matrix into the fused resident-x layout.  Returns None
    when the layout does not apply (x too large for VMEM, pathological
    finish, heavy rows) — callers fall back to the classic GStream path.

    Slabs (contiguous row ranges) hold ``slab_steps`` grid steps each:
    the slab's output block stays VMEM-resident and ACCUMULATES across
    its steps, so the first-fit binning only pays its open-tile tail
    once per slab (~1%), not once per step (~15%)."""
    nr_rows, nr_cols, nnz = matrix.nr_rows, matrix.nr_cols, matrix.nr_nzeros
    if GLW < 1 or (GLW & (GLW - 1)) or CHUNK * GLW > LANES:
        # the kernel's _tree_merge needs a power-of-two part count and
        # the int8 stripe meta holds at most 8*GLW-1 <= 127
        raise ValueError(f"GLW must be a power of two <= {LANES // CHUNK}"
                         f" (got {GLW})")
    if nr_cols > MAX_RESIDENT_COLS or nnz == 0:
        return None
    if Q is None:
        Q = _choose_q(matrix, GLW)
        if Q < 8:
            # scattered regime: the padding / matcher-occupancy / finish
            # trade is structure-sensitive, so COST the candidates and
            # pack the cheapest.  Small matrices pack all three fully;
            # larger ones cost each candidate on a row-band SAMPLE and
            # full-pack only the winner (one repack pass, not three —
            # the webbase-class chooser was 3x3 full packs before)
            cands = (1, 2, 8)
            if nnz <= 2 * SAMPLE_NNZ:
                best = None
                for qc in cands:
                    cand = pack_fused(matrix, Q=qc, GLW=GLW, T=T,
                                      value_dtype=value_dtype,
                                      use_native=use_native, slack=slack,
                                      slab_steps=slab_steps, sgrp=sgrp)
                    if cand is None:
                        continue
                    cost = _layout_cost(cand)
                    if best is None or cost < best[0]:
                        best = (cost, cand)
                return best[1] if best else None
            sample = _sample_rows(matrix)
            scored = []
            for qc in cands:
                sc = pack_fused(sample, Q=qc, GLW=GLW, T=T,
                                value_dtype=value_dtype,
                                use_native=use_native, slack=slack,
                                slab_steps=slab_steps, sgrp=sgrp)
                scored.append((_layout_cost(sc) if sc is not None
                               else float("inf"), qc))
            scored.sort()
            for cost, qc in scored:
                if cost == float("inf"):
                    continue
                cand = pack_fused(matrix, Q=qc, GLW=GLW, T=T,
                                  value_dtype=value_dtype,
                                  use_native=use_native, slack=slack,
                                  slab_steps=slab_steps, sgrp=sgrp)
                if cand is not None:
                    return cand
            return None
    P = CHUNK // Q
    # global finish shape: scattered matrices (rows with < ~3 chunks)
    # skip stage 1 everywhere (the kernel picks one stage-2 source)
    nz_rows = int((np.diff(matrix.row_ptr) > 0).sum())
    cpt = LANES * P                       # chunks per tile
    GX = max(GLW, -(-nr_cols // GRP_COLS))
    grp = (matrix.col_ind // GRP_COLS).astype(np.int64)
    c_start, c_end, c_row = _cut_chunks(matrix.row_ptr, grp, Q, GLW)
    # direct finish when rows have ~one chunk each (multiplicity ~1:
    # stage 1 would compress nothing, and stage-2 tiles absorb one
    # child per row cleanly), OR when the column range cannot be
    # covered by one grid step's window positions (GX >> T*GLW, the
    # webbase case): step-exact banding then starves — each band is
    # forced >= GX/GLW tiles regardless of its chunk count (measured:
    # fill collapsed to 0.001).  Otherwise the two-stage finish wins at
    # Q=1: stage 1 packs each row's children into one lane column, so
    # its slot count tracks children, while the direct stage-2 burns a
    # whole out-group tile row per child (measured 5.75 slots/nnz on
    # scircuit-class vs ~1.9 for banded two-stage).
    mult = c_start.shape[0] / max(nz_rows, 1)
    T_cap = (LANES // P) if Q < 8 else 128
    fin_direct = mult < 1.7 or (Q < 8
                                and GX > int(0.85 * T_cap * GLW))
    if T is None:
        if Q < 8 and not fin_direct:
            # scattered two-stage: children per step = T*cpt chunks;
            # stage-1 occupancy ~0.3 worst case must fit MAX_F1, so
            # try T=16 then halve on finish overflow
            for t_try in (16, 8, 4):
                out = pack_fused(matrix, Q=Q, GLW=GLW, T=t_try,
                                 value_dtype=value_dtype,
                                 use_native=use_native, slack=slack,
                                 slab_steps=slab_steps, sgrp=sgrp)
                if out is not None:
                    return out
            return None
        est_tiles = max(1, c_start.shape[0] // cpt)
        T = 128 if est_tiles >= 1024 else (32 if est_tiles >= 64 else 8)
    # int8 finish cells: scratch sublanes must fit 7 bits (drain = -1)
    T = min(T, 128 // P)
    if fin_direct:
        # scattered rows finish DIRECTLY from the step scratch (see
        # _finish_for_step): keep it at <= 128 rows so the stage-2
        # select tree stays 16 groups; small slabs keep the out block
        # (and so the aligned-group count the finish must touch per
        # step) small
        T = min(T, max(128 // P, 8))
        slab_steps = min(slab_steps, 2)
    if band_exact is None and Q == 8 and not fin_direct:
        # step-exact row bands trade forward fill for per-step finish
        # size; the kernel's cost is n_steps*(T + F1 + F2) tiles either
        # way, so COST both band policies (the Q-chooser pattern) and
        # keep the cheaper.  Wide-column few-row matrices (bands forced
        # to ~GX/GLW near-empty window tiles) fail band packing
        # outright -> fall back to False.  T is pinned FIRST and the
        # sample's bands sized to ~2.5 grid steps each — a band-exact
        # step is T*cpt chunks, so undersized sample bands would drown
        # the comparison in step padding that the full pack never pays.
        kw2 = dict(Q=Q, GLW=GLW, T=T, value_dtype=value_dtype,
                   use_native=use_native, slack=slack,
                   slab_steps=slab_steps, sgrp=sgrp)
        mean_len = nnz / max(c_start.shape[0], 1)
        band_nnz = int(2.5 * T * cpt * mean_len)
        if nnz <= 3 * band_nnz:
            a = pack_fused(matrix, band_exact=False, **kw2)
            b = pack_fused(matrix, band_exact=True, **kw2)
            if b is None or a is None:
                return a if b is None else b
            return b if _layout_cost(b) <= _layout_cost(a) else a
        sample = _sample_rows(matrix, target_nnz=3 * band_nnz, bands=3)
        sa = pack_fused(sample, band_exact=False, **kw2)
        sb = pack_fused(sample, band_exact=True, **kw2)
        band_exact = bool(sb is not None
                          and (sa is None or _layout_cost(sb)
                               <= _layout_cost(sa)))
        out = pack_fused(matrix, band_exact=band_exact, **kw2)
        if out is None and band_exact:
            out = pack_fused(matrix, band_exact=False, **kw2)
        return out
    scr_rows = T * P
    cpr = np.bincount(c_row, minlength=nr_rows)
    cpr_cum = np.concatenate([[0], np.cumsum(cpr)])
    OBp_cap = 256
    nat_v2 = _native_v2() if (use_native and
                              np.dtype(value_dtype) == np.float32) else None
    row_ptr64 = matrix.row_ptr.astype(np.int64)
    cols64 = matrix.col_ind.astype(np.int64)
    vals_all = matrix.values

    def _build_step(v, c16, r8, crow, tb, nt, band_trap, roff,
                    slab_trap):
        """Assemble one grid step from nt <= T packed tiles (zero-pad
        the rest; padded tiles contribute exact zeros).  crow arrives
        band-local; the finish needs slab-local rows."""
        vals_l = np.zeros((T * CHUNK, LANES), dtype=np.float32)
        i1_l = np.zeros((T * CHUNK, LANES), dtype=np.int8)
        rt_l = np.zeros((T * CHUNK, LANES), dtype=np.int8)
        tbase_l = np.zeros(T, dtype=np.int32)
        vals_l[:nt * CHUNK] = v
        i1_l[:nt * CHUNK] = c16.astype(np.int8)
        rt_l[:nt * CHUNK] = r8
        tbase_l[:nt] = tb
        crow_s = np.full((T * P, LANES), slab_trap, dtype=np.int64)
        crow_s[:nt * P] = np.where(crow == band_trap, slab_trap,
                                   crow.astype(np.int64) + roff)
        sub_i, lane_i = np.nonzero(crow_s != slab_trap)
        orows = crow_s[sub_i, lane_i]
        fin = _finish_for_step(orows, sub_i, lane_i, scr_rows,
                               direct=fin_direct)
        if fin is None:
            return None
        return (vals_l, (i1_l, rt_l), tbase_l, fin)

    def pack_slab_scatter(r0, r1, lane_mode):
        """Scattered two-stage regime: pack each grid step as its OWN
        row band (adaptive cursor, retry on tile overflow).  Rows
        touched per step == the band's rows, so the stage-1 finish pays
        its floor (one partial per row) instead of the ~2x spread that
        cross-band open tiles cause."""
        slab_trap = r1 - r0
        steps = []
        r = r0
        est_cpb = T * cpt * 0.55          # chunks per band, adapted
        starved = 0
        # degenerate-band guard: when window conflicts pin bands at a
        # few rows each, the loop makes O(rows) native calls of O(1)
        # work.  The per-band fill gate misses the regime when clustered
        # bands (fill >= 0.25) alternate with scattered ones and reset
        # the consecutive counter — measured: the Q=2 T=4 chooser
        # candidate ground 400+ s in ~1-row bands on mac_econ-class.
        # A healthy pack emits ~1 band per grid step; 8x + slack is
        # generous for structure variance.
        n_bands = 0
        exp_steps = max(1, int((cpr_cum[r1] - cpr_cum[r0])
                               // max(T * cpt, 1)))
        max_bands = 64 + 8 * exp_steps
        while r < r1:
            n_bands += 1
            if n_bands > max_bands:
                raise _ScatterStarved()
            target = cpr_cum[r] + est_cpb
            nr = int(np.searchsorted(cpr_cum, target, side="right")) - 1
            nr = min(max(nr, r + 1), r1)
            # aim the band at EXACTLY T tiles: every tile short of T is
            # a fully padded (8, 128) slot block the kernel still runs
            # (measured on the headline: undershooting bands by ~13%
            # cost the ENTIRE fill advantage of tight banding) — so
            # grow undershooting bands as well as shrinking overflows,
            # bisection-bounded
            packed = None
            nr_hi = r1 + 1            # smallest nr known to overflow T
            for _ in range(6):
                lo, hi = int(row_ptr64[r]), int(row_ptr64[nr])
                if lo == hi:
                    break
                rows_loc = (np.repeat(
                    np.arange(r, nr, dtype=np.int64),
                    np.diff(row_ptr64[r:nr + 1])) - r).astype(np.int32)
                out = nat_v2(
                    rows_loc, matrix.col_ind[lo:hi],
                    matrix.values[lo:hi].astype(np.float32, copy=False),
                    nr - r, q=Q, GL=GLW, G=GX, max_open=256,
                    slab_rows=0, lane_shuffle=lane_mode)
                nt = out[4].shape[0]
                if nt <= T:
                    if packed is None or nr > packed[1]:
                        packed = (out, nr)
                    if nt >= int(T * 0.985) or nr >= r1:
                        break
                    grown = r + max(int((nr - r) * T / max(nt, 1)),
                                    nr - r + 1)
                    nr = min(max(grown, nr + 1), r1, nr_hi - 1)
                    if nr <= packed[1]:
                        break
                else:
                    nr_hi = min(nr_hi, nr)
                    nr = r + max(1, int((nr - r) * T / nt * 0.93))
                    nr = min(nr, nr_hi - 1)
                    if packed is not None and nr <= packed[1]:
                        break
            if packed is not None:
                packed, nr = packed
            if int(row_ptr64[r]) == int(row_ptr64[nr]):
                r = nr
                continue
            if packed is None:
                return None           # a single heavy row overflows T
            v, c16, r8, crow, tb = packed
            nt = tb.shape[0]
            chunks_band = float(cpr_cum[nr] - cpr_cum[r])
            est_cpb = (0.5 * est_cpb
                       + 0.5 * chunks_band * min(T / max(nt, 1), 1.5))
            # availability starvation (bands forced to near-empty tiles
            # by the column-window count): bail out so the Q chooser
            # can fall back to a direct or Q=8 pack instead of grinding
            # out thousands of ~empty steps.  Keyed on BAND FILL, not
            # chunk count — a starved band can hold plenty of chunks
            # spread over near-empty window tiles (measured: Q=2 on
            # webbase-class packed 150 s to fill 0.005 under a
            # chunk-count guard)
            band_fill = chunks_band * Q / max(nt * CHUNK * LANES, 1)
            if band_fill < 0.25 and nr < r1:
                starved += 1
                if starved >= 2:
                    raise _ScatterStarved()
            else:
                starved = 0
            step = _build_step(v, c16, r8, crow, tb, nt,
                               band_trap=nr - r, roff=r - r0,
                               slab_trap=slab_trap)
            if step is None:
                return None
            steps.append(step)
            r = nr
        return steps

    # Each slab result: (r0, r1, [per-step (vals, meta16, tbase, ft)])
    def pack_slab_native(r0, r1):
        lo, hi = int(row_ptr64[r0]), int(row_ptr64[r1])
        if lo == hi:
            return []
        if Q < 8 and not fin_direct:
            return pack_slab_scatter(
                r0, r1, 2 + SCATTER_LANE_KEYS.bit_length() - 1)
        if band_exact and not fin_direct:
            # step-exact row bands for the DENSE regime too: rows
            # touched per step collapse to the band (measured 4416 ->
            # ~rows/step on the headline), shrinking the per-step
            # stage-1/2 finish at a forward-fill cost the caller opts
            # into (the kernel's cost is n_steps*(T + F1 + F2) tiles)
            return pack_slab_scatter(r0, r1, 1)
        rows_loc = (np.repeat(np.arange(r0, r1, dtype=np.int64),
                              np.diff(row_ptr64[r0:r1 + 1]))
                    - r0).astype(np.int32)
        trap = r1 - r0
        # chunks sorted by (step-sized row sub-slab, column group): the
        # glo sort keeps first-fit windows aligned (fill), the sub-slab
        # major keeps each step's rows concentrated (small finish), and
        # tiles staying OPEN across sub-slab boundaries is fine — the
        # slab's out block covers every row of the slab.  (Banding the
        # DIRECT mode was measured strictly worse on webbase-class:
        # fill 0.34 -> 0.25 and F2 padding doubled — the direct regime
        # is availability-bound, not locality-bound.)
        sub_rows = (0 if fin_direct
                    else max(1, (r1 - r0) // slab_steps))
        # direct-mode lane choice, measured on stand-ins: row-keyed
        # (mode 2) lifts webbase-class forward fill 0.34 -> 0.38 (the
        # matcher reuses the row's lane across its chunks), but hurts
        # the multiplicity~1 regime where fill gains only concentrate
        # more children per step (F2 33 -> 53); stage-2's tile count is
        # bound by max-children-per-row either way
        lm = 2 if (Q < 8 and fin_direct and mult >= 1.7) else 1
        v, c16, r8, crow, tb = nat_v2(
            rows_loc, matrix.col_ind[lo:hi],
            matrix.values[lo:hi].astype(np.float32, copy=False),
            trap, q=Q, GL=GLW, G=GX, max_open=256, slab_rows=sub_rows,
            lane_shuffle=lm)
        nt = tb.shape[0]
        # tiles retire when FULL, i.e. out of row order (a wide first-fit
        # window raises fill but lets tiles linger across sub-slabs);
        # re-sorting by min member row re-tightens each step's row range,
        # which is what keeps the per-step finish small
        tmin = np.where(crow == trap, np.iinfo(np.int32).max,
                        crow).reshape(nt, P * LANES).min(axis=1)
        order_t = np.argsort(tmin, kind="stable")
        v = v.reshape(nt, CHUNK, LANES)[order_t].reshape(-1, LANES)
        c16 = c16.reshape(nt, CHUNK, LANES)[order_t].reshape(-1, LANES)
        r8 = r8.reshape(nt, CHUNK, LANES)[order_t].reshape(-1, LANES)
        crow = crow.reshape(nt, P, LANES)[order_t].reshape(-1, LANES)
        tb = tb[order_t]
        n_steps_s = -(-nt // T)
        ntp = n_steps_s * T
        i8 = c16.astype(np.int8)       # relative stripe < 8*GLW <= 128
        steps = []
        for s2 in range(n_steps_s):
            t0, t1 = s2 * T, min((s2 + 1) * T, nt)
            vals_l = np.zeros((T * CHUNK, LANES), dtype=np.float32)
            i1_l = np.zeros((T * CHUNK, LANES), dtype=np.int8)
            rt_l = np.zeros((T * CHUNK, LANES), dtype=np.int8)
            tbase_l = np.zeros(T, dtype=np.int32)
            vals_l[:(t1 - t0) * CHUNK] = v[t0 * CHUNK:t1 * CHUNK]
            i1_l[:(t1 - t0) * CHUNK] = i8[t0 * CHUNK:t1 * CHUNK]
            rt_l[:(t1 - t0) * CHUNK] = r8[t0 * CHUNK:t1 * CHUNK]
            tbase_l[:t1 - t0] = tb[t0:t1]
            meta_l = (i1_l, rt_l)
            crow_s = np.full((T * P, LANES), trap, dtype=np.int64)
            crow_s[:(t1 - t0) * P] = crow[t0 * P:t1 * P]
            sub_i, lane_i = np.nonzero(crow_s != trap)
            orows = crow_s[sub_i, lane_i]
            fin = _finish_for_step(orows, sub_i, lane_i, scr_rows,
                                   direct=fin_direct)
            if fin is None:
                return None
            steps.append((vals_l, meta_l, tbase_l, fin))
        return steps

    def _dummy_step():
        """One all-drained step for a slab with zero nnz: its only job
        is tripping the kernel's step_first zeroing of the slab's out
        block (without it the block is never written and y slices read
        uninitialized HBM — interpret mode zero-fills, hardware does
        not)."""
        return (np.zeros((T * CHUNK, LANES), dtype=np.float32),
                (np.zeros((T * CHUNK, LANES), dtype=np.int8),
                 np.zeros((T * CHUNK, LANES), dtype=np.int8)),
                np.zeros(T, dtype=np.int32), ([], [], [], [], []))

    slab_results = []       # (r0, r1, steps)
    if nat_v2 is not None:
        slab_chunks = int(slab_steps * T * cpt * 0.985)
        # slab bounds at EXACT OBp*LANES row multiples: every slab's
        # block is then fully owned by its rows and y reassembles as
        # ONE slice of the flat output instead of n_slabs dynamic
        # slices + concat (~8 us on the headline).  Slab splits on
        # pack failure break alignment — the device detects uniformity
        # and falls back to the generic slices.
        rows_target = max(1, slab_chunks * nr_rows
                          // max(c_start.shape[0], 1))
        OBp_al = 8
        while OBp_al * LANES < rows_target and OBp_al < OBp_cap:
            OBp_al *= 2
        sb = list(range(0, nr_rows, OBp_al * LANES)) + [nr_rows]
        if len(sb) >= 2 and sb[-1] == sb[-2]:
            sb.pop()
        si = 0
        while si < len(sb) - 1:
            r0, r1 = int(sb[si]), int(sb[si + 1])
            try:
                res = pack_slab_native(r0, r1)
            except _ScatterStarved:
                return None   # let the Q chooser pick another layout
            if res is None:
                if r1 - r0 > 1:
                    sb.insert(si + 1, (r0 + r1) // 2)
                    continue
                return None   # heavy single row: not fusable
            if not res:       # all-empty row range
                res = [_dummy_step()]
            slab_results.append((r0, r1, res))
            si += 1
    else:
        # NumPy fallback: one step per slab (greedy matcher + retry
        # rounds; lower fill than the native augmenting-path pack)
        cpt_step = max(cpt, int(T * cpt * slack))
        sb = list(_cut_steps(cpr_cum, nr_rows, cpt_step, OBp_cap * LANES))
        si = 0
        sp_acc = [[], [], []]
        while si < len(sb) - 1:
            r0, r1 = int(sb[si]), int(sb[si + 1])
            res = _pack_step_numpy(matrix, c_start, c_end, c_row,
                                   cpr_cum, r0, r1, Q, GLW, T, GX,
                                   scr_rows, cpt, value_dtype,
                                   fin_direct)
            if res is None:
                if r1 - r0 > 1:
                    sb.insert(si + 1, (r0 + r1) // 2)
                    continue
                return None
            vals_l, meta_l, tbase_l, fin, spills = res
            if fin is None:
                return None
            for k in range(3):
                if spills[k].size:
                    sp_acc[k].append(spills[k])
            slab_results.append((r0, r1, [(vals_l, meta_l, tbase_l,
                                           fin)]))
            si += 1

    n_slabs = len(slab_results)
    if n_slabs == 0:
        return None

    # ---- grid-step grouping: fold SGRP sub-steps into one kernel grid
    # step.  Each grid iteration costs ~460 ns of fixed overhead (DMA
    # issue + grid machinery; measured via the S=1 vs S=2 differential
    # on chip) — at the scattered regime's T=16 that fixed cost is ~2.5x
    # the step's ~180 ns of tile compute, and even the T=128 headline
    # pays ~20%.  Grouping
    # requires each slab's step count to be a multiple of SGRP (the S
    # sub-steps of a grid step share one resident out block), so slabs
    # pad with drained steps; the chooser weighs that padding against
    # the saved iterations.
    # calibrated on chip (scripts/exp_sgrp.py): S=1->2 on the headline
    # saved 24 us over 52 iterations (~460 ns each); the same constant
    # reproduces the measured scircuit optimum (S=4) and the headline's
    # S=4 rejection (padding wins)
    _FIXED_NS = 460.0
    _TILE_NS = 11.0
    f1m = max([max((len(st[3][0]) for st in r[2]), default=0)
               for r in slab_results] + [1])
    f2m = max([max((len(st[3][2]) for st in r[2]), default=0)
               for r in slab_results] + [1])
    step_ns = (T + f1m + f2m) * _TILE_NS
    sub_bytes = (T * CHUNK * LANES * 6
                 + (-(-f1m // 4) * 4 + -(-f2m // 4) * 4)
                 * CHUNK * LANES * 2)
    counts = [len(r[2]) for r in slab_results]
    best_s, best_cost = 1, None
    for s_try in (1, 2, 4, 8, 16):
        if s_try * sub_bytes * 2 > 9 << 20:   # double-buffered VMEM cap
            continue
        padded = sum(-(-c // s_try) * s_try for c in counts)
        giters = sum(-(-c // s_try) for c in counts)
        cost = padded * step_ns + giters * _FIXED_NS
        if best_cost is None or cost < best_cost:
            best_s, best_cost = s_try, cost
    SGRP = best_s if sgrp is None else max(1, int(sgrp))
    if SGRP > 1:
        for r0s, r1s, steps_l in slab_results:
            while len(steps_l) % SGRP:
                steps_l.append(_dummy_step())

    n_steps = sum(len(r[2]) for r in slab_results)
    max_rows_slab = max(r[1] - r[0] for r in slab_results)
    OBp = 8           # stage-2 writes aligned (8, 128) out groups
    while OBp * LANES < max_rows_slab:
        OBp *= 2

    values = np.empty((n_steps * T * CHUNK, LANES), dtype=np.float32)
    meta_i1 = np.empty((n_steps * T * CHUNK, LANES), dtype=np.int8)
    meta_rt = np.empty((n_steps * T * CHUNK, LANES), dtype=np.int8)
    tile_base = np.empty((n_steps, T), dtype=np.int32)
    step_slab = np.empty(n_steps, dtype=np.int32)
    step_first = np.zeros(n_steps, dtype=np.int32)
    fin1_cnt = np.empty(n_steps, dtype=np.int32)
    fin2_cnt = np.empty(n_steps, dtype=np.int32)
    all_fin = []
    gi = 0
    for slab_i, (r0, r1, steps) in enumerate(slab_results):
        for s2, (vals_l, meta_l, tbase_l, fin) in enumerate(steps):
            values[gi * T * CHUNK:(gi + 1) * T * CHUNK] = vals_l
            meta_i1[gi * T * CHUNK:(gi + 1) * T * CHUNK] = meta_l[0]
            meta_rt[gi * T * CHUNK:(gi + 1) * T * CHUNK] = meta_l[1]
            tile_base[gi] = tbase_l
            step_slab[gi] = slab_i
            step_first[gi] = 1 if s2 == 0 else 0
            c1, r1_, g2, c2, r2_ = fin
            fin1_cnt[gi] = len(c1)
            fin2_cnt[gi] = len(c2)
            all_fin.append(fin)
            gi += 1

    F1_max = max(int(fin1_cnt.max()), 1) if n_steps else 1
    F2_max = max(int(fin2_cnt.max()), 1) if n_steps else 1
    F1S = 8
    while F1S < F1_max:
        F1S *= 2
    # finish cells ship as int8 with drain = -1 (scratch sublanes fit
    # 7 bits once T*P <= 128; the kernel masks i1 < 0).  The ALLOCATED
    # per-step tile counts round up to multiples of 4 so each step's
    # (F*8, 128) int8 block starts at a Mosaic (32, 128) int8-tile
    # boundary — misaligned blocks force a re-layout copy per step's
    # finish DMA.  The kernel still loops only F1_max/F2_max (it derives
    # the allocated stride from the array shape); the pad rows are never
    # read.
    F1A = -(-F1_max // 4) * 4
    F2A = -(-F2_max // 4) * 4
    fin1_meta = np.full((n_steps, F1A, CHUNK, LANES), -1,
                        dtype=np.int8)
    fin1_route = np.zeros((n_steps, F1A, CHUNK, LANES),
                          dtype=np.int8)
    fin2_meta = np.full((n_steps, F2A, CHUNK, LANES), -1,
                        dtype=np.int8)
    fin2_route = np.zeros((n_steps, F2A, CHUNK, LANES),
                          dtype=np.int8)
    fin2_group = np.zeros((n_steps, F2_max), dtype=np.int32)
    for s in range(n_steps):
        c1, r1_, g2, c2, r2_ = all_fin[s]
        for f in range(len(c1)):
            ca = np.asarray(c1[f])
            fin1_meta[s, f] = np.where(ca >= scr_rows, -1,
                                       ca).astype(np.int8)
            fin1_route[s, f] = np.asarray(r1_[f]).astype(np.int8)
        for f in range(len(c2)):
            ca = np.asarray(c2[f])
            fin2_meta[s, f] = np.where(ca >= F2_DRAIN, -1,
                                       ca).astype(np.int8)
            fin2_route[s, f] = np.asarray(r2_[f]).astype(np.int8)
            fin2_group[s, f] = g2[f]

    slab_bounds = np.asarray([slab_results[0][0]]
                             + [r[1] for r in slab_results],
                             dtype=np.int64)

    if nat_v2 is not None:
        sp_r = sp_c = np.zeros(0, np.int32)
        sp_v = np.zeros(0, value_dtype)
    else:
        def cat(parts, dtype):
            return (np.concatenate(parts).astype(dtype) if parts
                    else np.zeros(0, dtype))
        sp_r = cat(sp_acc[0], np.int32)
        sp_c = cat(sp_acc[1], np.int32)
        sp_v = cat(sp_acc[2], value_dtype)

    return FusedMatrix(
        values=values, meta_i1=meta_i1, meta_rt=meta_rt,
        tile_base=tile_base,
        fin1_i1=fin1_meta.reshape(-1, LANES),
        fin1_rt=fin1_route.reshape(-1, LANES),
        fin2_i1=fin2_meta.reshape(-1, LANES),
        fin2_rt=fin2_route.reshape(-1, LANES),
        fin2_group=fin2_group, fin1_cnt=fin1_cnt, fin2_cnt=fin2_cnt,
        step_slab=step_slab, step_first=step_first,
        slab_bounds=slab_bounds,
        spill_row=sp_r, spill_col=sp_c, spill_val=sp_v,
        nr_rows=nr_rows, nr_cols=nr_cols, nr_nzeros=nnz,
        Q=Q, GLW=GLW, T=T, GX=GX, OBp=OBp, F1_max=F1_max,
        F2_max=F2_max, F1S=F1S, n_slabs=n_slabs,
        fin_direct=1 if fin_direct else 0, SGRP=SGRP)


def _pack_step_numpy(matrix, c_start, c_end, c_row, cpr_cum, r0, r1,
                     Q, GLW, T, GX, scr_rows, cpt, value_dtype,
                     fin_direct=False):
    """NumPy fallback: pack rows [r0, r1) into one grid step with the
    greedy matcher + retry rounds.  Returns
    (vals, meta16, tbase, fin_tiles, spills) or None on overflow."""
    P = CHUNK // Q
    cols64 = matrix.col_ind.astype(np.int64)
    vals_all = matrix.values
    clo, chi = int(cpr_cum[r0]), int(cpr_cum[r1])
    vals_l = np.zeros((T, CHUNK, LANES), dtype=value_dtype)
    cells_l = np.zeros((T, CHUNK, LANES), dtype=np.int64)
    route_l = np.zeros((T, CHUNK, LANES), dtype=np.int64)
    tbase_l = np.zeros(T, dtype=np.int32)
    spills = [np.zeros(0, np.int64), np.zeros(0, np.int64),
              np.zeros(0, np.float64)]
    if clo == chi:
        return (vals_l.reshape(T * CHUNK, LANES),
                (np.zeros((T * CHUNK, LANES), np.int8),
                 np.zeros((T * CHUNK, LANES), np.int8)),
                tbase_l, [], spills)
    ci0 = clo + np.arange(chi - clo, dtype=np.int64)
    lens0 = (c_end[ci0] - c_start[ci0]).astype(np.int64)
    el_chunk0 = np.repeat(np.arange(chi - clo, dtype=np.int64), Q)
    el_k0 = np.tile(np.arange(Q, dtype=np.int64), chi - clo)
    real0 = el_k0 < lens0[el_chunk0]
    src0 = c_start[ci0][el_chunk0] + np.minimum(
        el_k0, lens0[el_chunk0] - 1)
    ch_row = c_row[ci0]
    el_col = cols64[src0]
    el_val = np.where(real0, vals_all[src0], 0)
    el_real = real0

    def spill(rows_e, cols_e, vals_e):
        spills[0] = np.concatenate([spills[0], rows_e])
        spills[1] = np.concatenate([spills[1], cols_e])
        spills[2] = np.concatenate([spills[2],
                                    vals_e.astype(np.float64)])

    n_t_used = 0
    fin_row_parts, fin_sub_parts, fin_lane_parts = [], [], []
    for rnd in range(4):
        nck = ch_row.shape[0]
        if nck == 0:
            break
        egrp_el = np.where(el_real, el_col // GRP_COLS, -1)
        sg = np.full(nck, 1 << 30, dtype=np.int64)
        eg = np.zeros(nck, dtype=np.int64)
        ch_of = np.repeat(np.arange(nck, dtype=np.int64), Q)
        live = el_real
        np.minimum.at(sg, ch_of[live], egrp_el[live])
        np.maximum.at(eg, ch_of[live], egrp_el[live])
        empty_ch = sg == (1 << 30)
        sg[empty_ch] = 0
        order = np.argsort(sg, kind="stable")
        t_of, n_t = _bin_tiles(sg[order], eg[order], GLW, cpt)
        if n_t_used + n_t > T:
            if rnd == 0:
                return None           # step too big: caller splits
            lost_f = el_real
            spill(np.repeat(ch_row, Q)[lost_f], el_col[lost_f],
                  el_val[lost_f])
            break
        t_lo = np.full(n_t, 1 << 30, dtype=np.int64)
        t_hi = np.zeros(n_t, dtype=np.int64)
        np.minimum.at(t_lo, t_of, sg[order])
        np.maximum.at(t_hi, t_of, eg[order])
        base = np.clip(np.minimum(t_lo, t_hi - GLW + 1), 0, GX - GLW)
        base[t_lo == (1 << 30)] = 0
        tbase_l[n_t_used:n_t_used + n_t] = base.astype(np.int32)

        within = _rank_within(t_of)
        plane_of = within // LANES
        lane_of = within % LANES

        oel = (order[:, None] * Q
               + np.arange(Q, dtype=np.int64)[None, :]).reshape(-1)
        ecol = el_col[oel]
        evals = el_val[oel].astype(value_dtype)
        ereal = el_real[oel]
        ech = np.repeat(np.arange(nck, dtype=np.int64), Q)
        ebase = base[t_of][ech]
        cmin = np.full(nck, 1 << 60, dtype=np.int64)
        np.minimum.at(cmin, ech[ereal], ecol[ereal])
        cmin = np.where(cmin == (1 << 60), base[t_of] * GRP_COLS, cmin)
        ecol = np.where(ereal, ecol, cmin[ech])
        estripe = ecol // STRIPE - ebase * CHUNK
        eres = ecol % STRIPE
        lc = ((n_t_used + t_of[ech]) * cpt
              + plane_of[ech] * LANES + lane_of[ech])
        el_kq = np.tile(np.arange(Q, dtype=np.int64), nck)
        slot = _match_tiles(T, lc, el_kq, eres, estripe, ereal, Q)
        lost = ereal & (slot < 0)
        slot = _fill_free_slots(np.where(lost, -1, slot), ~lost, Q)
        t_l = n_t_used + t_of[ech]
        sub = plane_of[ech] * Q + slot.astype(np.int64)
        ok = ~lost
        vals_l[t_l[ok], sub[ok], lane_of[ech][ok]] = evals[ok]
        route_l[t_l[ok], sub[ok], lane_of[ech][ok]] = eres[ok]
        realm = ereal & ok
        cells_l[t_l[realm], sub[realm], eres[realm]] = estripe[realm]

        keep_ch = ~empty_ch[order]
        fin_row_parts.append((np.repeat(ch_row, Q)[oel][::Q]
                              - r0)[keep_ch])
        fin_sub_parts.append(((n_t_used + t_of) * P
                              + plane_of)[keep_ch])
        fin_lane_parts.append(lane_of[keep_ch])
        n_t_used += n_t

        if not lost.any():
            break
        if rnd == 3:
            spill(np.repeat(ch_row, Q)[oel][lost], ecol[lost],
                  evals[lost])
            break
        lrows = np.repeat(ch_row, Q)[oel][lost]
        ch_row, el_col, el_val, el_real = _rechunk_lost(
            lrows, ecol[lost], evals[lost], GRP_COLS, Q, GLW)

    fin = _finish_for_step(
        np.concatenate(fin_row_parts).astype(np.int64)
        if fin_row_parts else np.zeros(0, np.int64),
        np.concatenate(fin_sub_parts).astype(np.int64)
        if fin_sub_parts else np.zeros(0, np.int64),
        np.concatenate(fin_lane_parts).astype(np.int64)
        if fin_lane_parts else np.zeros(0, np.int64), scr_rows,
        direct=fin_direct)
    if fin is None:
        return None
    meta_l = (cells_l.astype(np.int8).reshape(T * CHUNK, LANES),
              route_l.astype(np.int8).reshape(T * CHUNK, LANES))
    return vals_l.reshape(T * CHUNK, LANES), meta_l, tbase_l, fin, spills
