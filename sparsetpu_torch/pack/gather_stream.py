"""GStream: the TPU-native packed sparse format (pack side).

This is the re-design of the reference's packed-stream format
(csr_hw.cpp:270-318 ``generate_balanced_hw_submatrix``): where the FPGA packs
(15-bit in-block column index + end-of-row flag, value) pairs into 128-bit
bus words for a serial MAC pipeline, the TPU needs a layout that turns the
per-element ``x[col]`` access (spmv.cpp:87) into the two vector gather
primitives Mosaic supports on (8, 128) register tiles:

  * sublane gather: ``g1[s, r] = xw[i1[s, r], r]``
  * lane gather:    ``g2[s, l] = g1[s, j[s, l]]``

Layout
------
* Columns are processed in *windows* of ``W = 8 * G * 128`` columns (2D
  column blocking, util.h:43-58 analogue; G <= 32 gives W <= 32768 ==
  COLS_DIV_BLOCKS).  The x-window is staged HBM->VMEM per grid step by the
  Pallas pipeline (the per-CU BRAM x-copy of spmv.cpp:180-192, but
  double-buffered by the compiler).
* Within a (row x window) intersection, each row's nnz are padded to a
  multiple of the **quantum Q** (the reference pads rows to VF,
  csr_hw.cpp:108-114 — Q is the VF knob, Q in {1, 2, 4, 8}).  Each
  aligned group of Q is a **chunk**; a chunk belongs to exactly one
  row, so per-chunk partial sums never straddle rows.
* P = 8/Q **planes** of 128 chunks form a **tile**: the chunk at
  within-tile index w = plane*128 + lane spans sublanes
  [plane*Q, (plane+1)*Q) of lane ``lane``.  The chunk partial sums are
  then P free partial sums over the sublane axis, and the
  end-of-row-flag scan of the reference (spmv.cpp:99) becomes a
  precomputed chunk->row map (the empty-rows bitmap of csr_hw.cpp:340-347
  is subsumed: empty rows simply have no chunks).  Small Q trades more
  output planes (and a tighter slot assignment) for far less padding on
  matrices whose (row, window) runs are short — the scattered-row case
  the 8-slot quantum packed at fill 0.35.
* **Residue matching**: for the sublane gather, every element must expose
  its x-stripe index at cell (s, r) where ``r = local_col % 128`` is its
  lane residue.  Elements of one chunk may permute freely across the 8
  slots (a row sum is order-invariant), so pack time solves a bipartite
  assignment per tile: slot choice such that within each (tile, sublane)
  residues are distinct (equal (stripe, residue) pairs may share a cell).
  Chunks that cannot be placed spill to fresh tiles.

Arrays produced (n = number of (8,128) tiles, padded to tiles_per_step):
  values      (n*8, 128) value dtype          stream layout
  cell_idx    (n*8, 128) int16   per-cell local stripe index in [0, 8G)
  route       (n*8, 128) int8    per-stream-position residue in [0, 128)
  chunk_row   (n*P, 128) int32   global row per chunk, plane-major per
                                 tile (nr_rows = pad trap)
  step_window (n_steps,) int32   column-block index per grid step (the
                                 x-window staged for that step is block-row
                                 ``step_window[i]`` of x2 viewed in (8G, 128)
                                 blocks)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..formats.csr import CSRMatrix
from ..utils.config import LANES, SUBLANES, SpmvConfig

STRIPE = LANES                      # 128 columns per x stripe
CHUNK = SUBLANES                    # default row padding quantum (Q=8)
TILE_CHUNKS = LANES                 # chunks per plane of an (8, 128) tile
TILE_NNZ = CHUNK * TILE_CHUNKS      # 1024 elements per tile
DEFAULT_TILES_PER_STEP = 16         # tiles per Pallas grid step
MAX_G = 32                          # window groups cap => W <= 32768 cols
VALID_Q = (1, 2, 4, 8)              # row-pad quantum (VF, util.h:31-39)


@dataclasses.dataclass(eq=False)  # identity hash: usable as static jit aux
class GStreamMatrix:
    """Packed matrix + metadata (csr_hw_matrix analogue, csr_hw.h:16-26)."""

    values: np.ndarray       # (n_tiles*8, 128)
    cell_idx: np.ndarray     # (n_tiles*8, 128) int16
    route: np.ndarray        # (n_tiles*8, 128) int8
    chunk_row: np.ndarray    # (n_tiles*P, 128) int32, plane-major
    step_window: np.ndarray  # (n_steps,) int32
    nr_rows: int
    nr_cols: int
    nr_nzeros: int           # real nnz (before padding)
    G: int                   # window groups (window = G*1024 cols)
    tiles_per_step: int
    padded_cols: int         # nr_cols padded to window multiple
    sections: np.ndarray = None  # (n_blocks, 2) tile ranges per col block
    Q: int = CHUNK           # row-pad quantum (VF knob, util.h:31-39)
    GL: int = 0              # v2: locality groups per tile (0 = classic)
    tile_base: np.ndarray = None  # v2: (n_tiles,) int32 group offsets
    ordered: bool = False    # chunk positions row-major within each block
                             # (no lane shuffle) -> flat V2 finish applies

    @property
    def planes(self) -> int:
        """Chunk-sum planes per tile (P = 8/Q)."""
        return CHUNK // self.Q

    @property
    def n_tiles(self) -> int:
        return int(self.chunk_row.shape[0]) // self.planes

    @property
    def n_steps(self) -> int:
        return int(self.step_window.shape[0])

    @property
    def window_cols(self) -> int:
        return self.G * CHUNK * STRIPE

    @property
    def n_slots(self) -> int:
        return self.n_tiles * TILE_NNZ

    @property
    def fill_factor(self) -> float:
        """Real nnz / allocated slots (padding + spill overhead measure)."""
        return self.nr_nzeros / max(self.n_slots, 1)

    def storage_bytes(self) -> int:
        """Packed bytes moved to the device — the reference's 'MB
        transferred' report (csr_hw.cpp:420-421).  cell_idx and route ship
        fused as one int16 stream (kernels.spmv_pallas.combine_meta), so
        the device stream is values + 2 B/slot of metadata."""
        return (self.values.nbytes + self.cell_idx.nbytes
                + self.chunk_row.nbytes + self.step_window.nbytes)

    def storage_overhead(self) -> float:
        """Packed size / plain CSR size (csr_hw.cpp:1401-1409 analogue)."""
        csr_bytes = (self.nr_nzeros * (self.values.dtype.itemsize + 4)
                     + 4 * (self.nr_rows + 1))
        return self.storage_bytes() / max(csr_bytes, 1)


# ---------------------------------------------------------------------------
# pack passes
# ---------------------------------------------------------------------------

def _pad_rows_to_chunks(sub_rows, sub_cols, sub_vals, q: int = CHUNK):
    """Pad each row's nnz run to a multiple of the quantum ``q``
    (csr_hw.cpp:229-255 analogue; q is the VF row pad, csr_hw.cpp:108-114).
    Input is row-major sorted; returns flat padded
    (row, local_col, val, is_real) arrays.  Pad elements reuse the row's
    first column so their gather stays in-window."""
    # sub_rows is row-major sorted: run-length encode instead of np.unique
    # (which re-sorts)
    if sub_rows.shape[0]:
        bounds = np.flatnonzero(np.diff(sub_rows)) + 1
        starts_u = np.concatenate([[0], bounds])
        rows_u = sub_rows[starts_u]
        counts = np.diff(np.concatenate([starts_u,
                                         [sub_rows.shape[0]]]))
    else:
        rows_u = sub_rows
        counts = np.zeros(0, dtype=np.int64)
    padded_counts = (-(-counts // q) * q).astype(np.int64)
    total = int(padded_counts.sum())
    out_row = np.repeat(rows_u, padded_counts).astype(np.int32)
    out_col = np.zeros(total, dtype=np.int32)
    out_val = np.zeros(total, dtype=sub_vals.dtype)
    is_real = np.zeros(total, dtype=bool)

    starts = np.concatenate([[0], np.cumsum(padded_counts)[:-1]])
    row_first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    offset_within = np.arange(sub_vals.shape[0], dtype=np.int64)
    pos = (np.repeat(starts, counts)
           + (offset_within - np.repeat(row_first, counts)))
    out_col[pos] = sub_cols
    out_val[pos] = sub_vals
    is_real[pos] = True
    first_col_per_row = sub_cols[row_first]
    pad_fill = np.repeat(first_col_per_row, padded_counts)
    out_col = np.where(is_real, out_col, pad_fill)
    return out_row, out_col, out_val, is_real


def _match_tiles(n_tiles, local_chunk, rank, res, stripe, active,
                 q: int = CHUNK):
    """Slot assignment: per (tile, sublane) distinct residues; equal
    (stripe, residue) pairs share a cell.  Vectorized greedy — attempt k
    proposes slot (rank + k) % q; a contended free cell goes to the
    minimum-stripe contender; losers retry with the next slot.

    With quantum q < 8 a chunk owns only the q sublanes of its plane
    (plane-major within the tile), so its slot choices map to absolute
    sublanes plane*q + slot.  Only ``active`` elements (real nnz) claim
    cells; returns slot (-1 for unplaced/inactive) per element."""
    n = res.shape[0]
    p_planes = CHUNK // q
    slot = np.full(n, -1, dtype=np.int8)
    cell_stripe = np.full(n_tiles * CHUNK * LANES, -1, dtype=np.int64)
    tile_of = local_chunk // (TILE_CHUNKS * p_planes)
    plane_of = (local_chunk % (TILE_CHUNKS * p_planes)) // TILE_CHUNKS
    sub_base = tile_of * CHUNK + plane_of * q   # absolute sublane base
    n_chunks_local = int(local_chunk.max()) + 1 if n else 0
    chunk_slot_used = np.zeros((n_chunks_local, q), dtype=bool)
    contender = np.empty(cell_stripe.shape[0], dtype=np.int64)
    for attempt in range(q):
        un = active & (slot < 0)
        if not un.any():
            break
        idx = np.flatnonzero(un)
        cand_s = (rank[idx] + attempt) % q
        # a chunk-mate may already hold this slot from an earlier attempt
        avail = ~chunk_slot_used[local_chunk[idx], cand_s]
        idx, cand_s = idx[avail], cand_s[avail]
        if idx.shape[0] == 0:
            continue
        # same-chunk same-slot contention within one attempt (callers
        # with duplicate ranks): lowest-index proposer wins, others retry
        key_cs = local_chunk[idx] * q + cand_s
        uniq_first = np.full(n_chunks_local * q, -1, dtype=np.int64)
        uniq_first[key_cs[::-1]] = idx[::-1]    # first occurrence wins
        keep = uniq_first[key_cs] == idx
        idx, cand_s = idx[keep], cand_s[keep]
        if idx.shape[0] == 0:
            continue
        key = (sub_base[idx] + cand_s) * LANES + res[idx]
        st = stripe[idx]
        cur = cell_stripe[key]
        accept = cur == st                      # share an existing cell
        free = cur == -1
        if free.any():
            fkey = key[free]
            contender[fkey] = np.iinfo(np.int64).max
            np.minimum.at(contender, fkey, st[free])
            won = free & (contender[key] == st)
            cell_stripe[key[won]] = st[won]
            accept |= won
        slot[idx[accept]] = cand_s[accept]
        chunk_slot_used[local_chunk[idx[accept]], cand_s[accept]] = True
    return slot


def _fill_free_slots(slot, active, q: int = CHUNK):
    """Assign slot-less (pad / unplaced) elements the slots left free in
    their chunk, so no real element's stream position is clobbered."""
    nc = slot.shape[0] // q
    sl2 = slot.reshape(nc, q)
    used = np.zeros((nc, q), dtype=bool)
    taken = sl2 >= 0
    used[np.nonzero(taken)[0], sl2[taken].astype(np.int64)] = True
    # free slots first (stable argsort of the used mask)
    free_order = np.argsort(used, axis=1, kind="stable")
    missing = ~taken
    miss_rank = np.cumsum(missing, axis=1) - 1
    fill = np.take_along_axis(free_order, np.maximum(miss_rank, 0), axis=1)
    return np.where(missing, fill, sl2).astype(np.int8).reshape(-1)


def _materialize(chunks_el_row, pcol, pval, preal, slot, local_chunk,
                 nr_rows, value_dtype, q: int = CHUNK):
    """Build (values, cell_idx, route, chunk_row) tile arrays from a fully
    matched element set.  chunk_row is (n_t * P, 128) plane-major."""
    p_planes = CHUNK // q
    cpt = TILE_CHUNKS * p_planes                  # chunks per tile
    n_t = int(local_chunk.max() // cpt) + 1
    res = (pcol % STRIPE).astype(np.int64)
    stripe = (pcol // STRIPE).astype(np.int64)

    vals = np.zeros((n_t, CHUNK, LANES), dtype=value_dtype)
    cells = np.zeros((n_t, CHUNK, LANES), dtype=np.int16)
    route = np.zeros((n_t, CHUNK, LANES), dtype=np.int8)
    rowmap = np.full((n_t * p_planes, LANES), nr_rows, dtype=np.int32)

    tile_of = (local_chunk // cpt).astype(np.int64)
    plane_of = ((local_chunk % cpt) // TILE_CHUNKS).astype(np.int64)
    lane_of = (local_chunk % TILE_CHUNKS).astype(np.int64)
    s = plane_of * q + slot.astype(np.int64)      # absolute sublane
    vals[tile_of, s, lane_of] = np.where(preal, pval, 0).astype(value_dtype)
    route[tile_of, s, lane_of] = res
    real = np.flatnonzero(preal)
    cells[tile_of[real], s[real], res[real]] = stripe[real]
    # chunk -> row map (one row per chunk by construction)
    lc_c = local_chunk[::q]
    rowmap[(lc_c // cpt) * p_planes + (lc_c % cpt) // TILE_CHUNKS,
           lc_c % TILE_CHUNKS] = chunks_el_row
    return vals, cells, route, rowmap


def _rechunk_by_row(rows, cols, vals, q: int = CHUNK):
    """Group loose (row, col, val) elements into fresh single-row chunks,
    zero-padding each row's run to a quantum multiple."""
    order = np.argsort(rows, kind="stable")
    return _pad_rows_to_chunks(rows[order], cols[order], vals[order], q)


def _pack_block(prow, pcol, pval, preal, nr_rows, value_dtype,
                q: int = CHUNK):
    """Chunk + tile + residue-match one column block.  Returns stacked
    (values, cell_idx, route, chunk_row) arrays for the block's tiles.

    Elements that lose the residue matching in a round keep their tile
    *holes* (already-placed chunk mates stay put) and are re-chunked by row
    into fresh tiles for the next round; residue pressure drops every round
    so this converges quickly (the reference's analogous fallback is row
    padding, csr_hw.cpp:246-255 — here padding is the fallback, not the
    default)."""
    p_planes = CHUNK // q
    cpt = TILE_CHUNKS * p_planes
    parts: List[Tuple[np.ndarray, ...]] = []
    cur = (prow, pcol, pval, preal)
    prev_unplaced = None
    while cur[0].shape[0] > 0:
        qrow, qcol, qval, qreal = cur
        n_el = qrow.shape[0]
        assert n_el % q == 0
        nc = n_el // q
        local_chunk = np.repeat(np.arange(nc, dtype=np.int64), q)
        n_t = -(-nc // cpt)
        res = (qcol % STRIPE).astype(np.int64)
        stripe = (qcol // STRIPE).astype(np.int64)
        rank = np.arange(n_el, dtype=np.int64) % q
        slot = _match_tiles(n_t, local_chunk, rank, res, stripe, qreal, q)
        unplaced = qreal & (slot < 0)
        n_un = int(unplaced.sum())
        if prev_unplaced is not None and n_un >= prev_unplaced:
            # no progress: spread the stragglers one chunk per tile
            local_chunk = local_chunk * cpt
            slot = _match_tiles(nc, local_chunk, rank, res, stripe, qreal,
                                q)
            if (qreal & (slot < 0)).any():
                raise AssertionError(
                    "single-chunk-per-tile matching must always succeed")
            unplaced = np.zeros(n_el, dtype=bool)
            n_un = 0
        # materialize this round's placements (holes stay zero-padded)
        placed_mask = ~unplaced
        slot = _fill_free_slots(np.where(unplaced, -1, slot), ~unplaced, q)
        parts.append(_materialize(qrow[::q], qcol, qval,
                                  qreal & placed_mask, slot, local_chunk,
                                  nr_rows, value_dtype, q))
        if n_un == 0:
            break
        prev_unplaced = n_un
        cur = _rechunk_by_row(qrow[unplaced], qcol[unplaced],
                              qval[unplaced], q)

    vals = np.concatenate([p[0] for p in parts], axis=0)
    cells = np.concatenate([p[1] for p in parts], axis=0)
    route = np.concatenate([p[2] for p in parts], axis=0)
    rowmap = np.concatenate([p[3] for p in parts], axis=0)
    return vals, cells, route, rowmap


def _native_pack_block():
    """The C++ pack engine (native/packer.cpp), if built."""
    try:
        from ..native.packer import available, pack_block_native
        return pack_block_native if available() else None
    except Exception:
        return None


def _native_pack_v2():
    try:
        from ..native.packer import available, pack_v2_native
        return pack_v2_native if available() else None
    except Exception:
        return None


def _pack_block_v2_numpy(brows, bcols, bvals, nr_rows, value_dtype, q,
                         GL, G, slab=0):
    """NumPy v2 fallback: partition the block into (row slab,
    GL-group-aligned subwindow) cells and pack each with the classic
    matcher (correct but conservative — the C++ path places chunks at
    unaligned bases and splits runs only where a chunk's own span
    forces it)."""
    sub_w = GL * CHUNK * STRIPE
    sw_of = bcols // sub_w
    slab_of = (brows // slab).astype(np.int64) if slab else \
        np.zeros(brows.shape[0], dtype=np.int64)
    nsw = -(-G // GL)
    key = slab_of * nsw + sw_of
    order = np.argsort(key, kind="stable")
    n_keys = int(key.max()) + 1 if key.size else 0
    bounds = np.searchsorted(key[order], np.arange(n_keys + 1))
    vs, cs, rs, ms, bases = [], [], [], [], []
    for kk in range(n_keys):
        lo, hi = int(bounds[kk]), int(bounds[kk + 1])
        if lo == hi:
            continue
        s = kk % nsw
        idx = order[lo:hi]
        prow, pcol, pval, preal = _pad_rows_to_chunks(
            brows[idx], (bcols[idx] - s * sub_w).astype(np.int32),
            bvals[idx], q)
        v, c, r, mm = _pack_block(prow, pcol, pval, preal, nr_rows,
                                  value_dtype, q)
        vs.append(v)
        cs.append(c)
        rs.append(r)
        ms.append(mm)
        bases.append(np.full(v.shape[0], s * GL, dtype=np.int32))
    if not vs:
        z = np.zeros((0, CHUNK, LANES))
        return (z.astype(value_dtype), z.astype(np.int16),
                z.astype(np.int8), np.zeros((0, LANES), np.int32),
                np.zeros(0, np.int32))
    return (np.concatenate(vs), np.concatenate(cs), np.concatenate(rs),
            np.concatenate(ms), np.concatenate(bases))


def _choose_layout(matrix: CSRMatrix, tiles_per_step: int = 128,
                   q_candidates=(2, 4, 8),
                   g_cap: int = MAX_G,
                   rates=None) -> Tuple[int, int]:
    """Pick the column-window group count G and the row-pad quantum Q
    jointly from the (row, window) nnz histogram: predicted time =
    slot count (including per-block tile padding to tiles_per_step
    multiples and an empirical matching-spill inflation per Q) over the
    measured slot rate, plus a finish term per chunk (more chunks =
    more reduction children).  Rates come from ``rates`` (a
    ``pack.rates.refresh_rates`` table) when given, else pack.rates'
    default table."""
    from .rates import slot_rate, MATCH_INFLATION, FINISH_NS_PER_CHILD

    need = max(1, -(-matrix.nr_cols // (CHUNK * STRIPE)))
    w0 = 4 * CHUNK * STRIPE                     # finest candidate window
    nb0 = -(-matrix.nr_cols // w0)
    # sample a row prefix (~2M nnz) — the histogram shape, not its scale,
    # drives the choice
    end_row = matrix.nr_rows
    if matrix.nr_nzeros > 2_000_000:
        end_row = int(np.searchsorted(matrix.row_ptr, 2_000_000))
        end_row = max(1, min(end_row, matrix.nr_rows))
    end_nnz = int(matrix.row_ptr[end_row])
    rows_all = np.repeat(np.arange(end_row, dtype=np.int64),
                         np.diff(matrix.row_ptr[:end_row + 1]).astype(
                             np.int64))
    key = rows_all * nb0 + matrix.col_ind[:end_nnz].astype(np.int64) // w0
    uk, counts = np.unique(key, return_counts=True)
    urow, uw = uk // nb0, uk % nb0
    best, best_t = None, None
    for g in (1, 2, 4, 8, 16, 32):
        if g > g_cap:
            break                # block_cols cap (util.h:43-58 analogue)
        break_after = g >= need  # one window covers all cols: stop after

        if g < 4:
            if g < need and need > 4 and g < g_cap:
                continue        # tiny windows only for tiny matrices
                                # (unless block_cols forces them)
            nb = max(1, -(-matrix.nr_cols // (g * CHUNK * STRIPE)))
            key2 = rows_all * nb + (matrix.col_ind[:end_nnz].astype(
                np.int64) // (g * CHUNK * STRIPE))
            u2, c2 = np.unique(key2, return_counts=True)
        else:
            f = g // 4
            nb = -(-nb0 // f)
            key2 = urow * nb + uw // f
            u2, inv = np.unique(key2, return_inverse=True)
            c2 = np.zeros(u2.shape[0], dtype=np.int64)
            np.add.at(c2, inv, counts)
        blk_of_pair = (u2 % nb).astype(np.int64)
        # the flat V2 final needs <= 8 column blocks (its per-tile window
        # chain is per block); more blocks fall back to the pricier
        # legacy greedy-window final (~2x measured)
        finish_scale = 1.0 if nb <= 8 else 2.0
        for q in q_candidates:
            p_planes = CHUNK // q
            chunks_pair = -(-c2 // q)
            chunks_blk = np.bincount(blk_of_pair, weights=chunks_pair,
                                     minlength=1)
            nz = chunks_blk[chunks_blk > 0]
            tiles_blk = -(-nz // (TILE_CHUNKS * p_planes))
            tiles_pad = (-(-tiles_blk // tiles_per_step)) * tiles_per_step
            slots = int(tiles_pad.sum()) * TILE_NNZ * MATCH_INFLATION[q]
            children = float(chunks_pair.sum())
            t = slots / slot_rate(g, q, rates=rates) \
                + children * FINISH_NS_PER_CHILD * finish_scale
            if best_t is None or t < best_t:
                best, best_t = (g, q), t
        if break_after:
            break
    return best


def pack_gstream(matrix: CSRMatrix, config: Optional[SpmvConfig] = None,
                 tiles_per_step: Optional[int] = None,
                 value_dtype=np.float32, use_native: bool = True,
                 shuffle_lanes: Optional[bool] = None,
                 G: Optional[int] = None,
                 Q: Optional[int] = None,
                 GL: Optional[int] = None,
                 slab: int = 0,
                 rates=None) -> GStreamMatrix:
    """Pack a CSR matrix into GStream (create_csr_hw_matrix analogue,
    csr_hw.cpp:377-1398, collapsed to one parameterized routine).

    ``Q`` is the row-pad quantum — the reference's VF unroll knob
    (util.h:31-39): rows' per-window nnz runs pad to a Q multiple and
    the kernel emits 8/Q chunk-sum planes per tile.  Defaults to the
    config's ``vf`` if set (> 0), else model-chosen jointly with G.

    ``GL`` > 0 selects the v2 layout: every tile gathers from only GL
    window groups at a per-tile dynamic base, so the kernel's select
    chain costs O(GL) while the padding window stays the full G groups
    (the big-window fill at small-window speed).  Requires G % GL == 0.

    ``slab`` > 0 (a multiple of 128, with GL) orders chunks by
    (row // slab, group) instead of (group): positions stay
    row-slab-contiguous, so the flat V2 final level applies on top of
    the v2 forward kernel.

    ``rates``: a (G, Q) -> Gslot/s table (``pack.rates.refresh_rates``)
    for the layout model in place of its default table; None keeps the
    JAX package's choice.
    """
    nr_rows, nr_cols = matrix.nr_rows, matrix.nr_cols
    if tiles_per_step is None:
        # bigger steps amortize the Pallas pipeline: T=128 (1.5 MB blocks)
        # reaches ~90% of v5e HBM bandwidth vs ~40% at T=16 (bench/micro);
        # small matrices take smaller steps to bound padding
        est_tiles = max(1, int(matrix.nr_nzeros * 1.3) // TILE_NNZ)
        if est_tiles >= 1024:
            tiles_per_step = 128
        elif est_tiles >= 128:
            tiles_per_step = 32
        else:
            tiles_per_step = 8
    if Q is None and config is not None and config.vf:
        Q = config.vf
    # block_cols (COLS_DIV_BLOCKS analogue, util.h:43-58) caps the column
    # window the kernel stages; windows are G*1024 cols, so the cap is in
    # units of 1024 (sub-1024 settings round up to the tile minimum)
    g_cap = MAX_G
    if config is not None:
        g_cap = max(1, min(MAX_G, config.block_cols // (CHUNK * STRIPE)))
    if G is not None and G > g_cap:
        raise ValueError(
            f"G={G} exceeds block_cols={config.block_cols} "
            f"(max {g_cap} window groups of {CHUNK * STRIPE} cols)")
    if G is None or Q is None:
        g_m, q_m = _choose_layout(matrix, tiles_per_step, g_cap=g_cap,
                                  rates=rates)
        G = G if G is not None else g_m
        Q = Q if Q is not None else q_m
    if Q not in VALID_Q:
        raise ValueError(f"Q must be one of {VALID_Q}, got {Q}")
    if shuffle_lanes is None:
        # The lane shuffle decorrelates reduction-level residues, which
        # the HEAVY-row F levels need (fill 0.23 -> 0.85); but it
        # scatters each row's chunk positions, which defeats the flat V2
        # finish.  Auto: shuffle only when heavy rows will need F levels.
        est_children = (matrix.row_nnz().max() if matrix.nr_rows else 0)
        shuffle_lanes = bool(est_children / Q > 32)
    if GL:
        if G % GL != 0:
            raise ValueError(f"GL={GL} must divide G={G}")
        if GL == G:
            GL = None   # per-tile base degenerates to the classic layout
    P = CHUNK // Q
    W = G * CHUNK * STRIPE
    n_blocks = max(1, -(-nr_cols // W))
    padded_cols = n_blocks * W

    rows_all = np.repeat(np.arange(nr_rows, dtype=np.int32),
                         matrix.row_nnz())
    cols_all = matrix.col_ind.astype(np.int64)
    vals_all = matrix.values
    native = _native_pack_block() if (
        use_native and np.dtype(value_dtype) == np.float32) else None
    native_v2 = _native_pack_v2() if (
        GL and use_native and np.dtype(value_dtype) == np.float32) else None

    all_v, all_c, all_r, all_m, step_win = [], [], [], [], []
    all_b = []      # v2 per-tile bases
    sections = []   # (tile_start, tile_end) per emitted column block

    def _pad_tiles(k):
        all_v.append(np.zeros((k * CHUNK, LANES), dtype=value_dtype))
        all_c.append(np.zeros((k * CHUNK, LANES), dtype=np.int16))
        all_r.append(np.zeros((k * CHUNK, LANES), dtype=np.int8))
        all_m.append(np.full((k * P, LANES), nr_rows, dtype=np.int32))
        if GL:
            all_b.append(np.zeros(k, dtype=np.int32))

    if n_blocks > 1:
        # one stable sort by window (keeps row-major order inside each
        # block) instead of an O(n_blocks * nnz) mask scan per block
        blk = cols_all // W
        order = np.argsort(blk, kind="stable")
        rows_srt, cols_srt, vals_srt = (rows_all[order], cols_all[order],
                                        vals_all[order])
        blk_starts = np.searchsorted(blk[order],
                                     np.arange(n_blocks + 1))
    for b in range(n_blocks):
        if n_blocks == 1:
            brows, bcols, bvals = rows_all, cols_all, vals_all
        else:
            lo, hi = int(blk_starts[b]), int(blk_starts[b + 1])
            brows, bcols, bvals = (rows_srt[lo:hi], cols_srt[lo:hi],
                                   vals_srt[lo:hi])
        if brows.shape[0] == 0:
            continue
        local = (bcols - b * W).astype(np.int32)
        if GL:
            if native_v2 is not None:
                v, c, r, mm, tb = native_v2(
                    brows, local, bvals.astype(np.float32, copy=False),
                    nr_rows, q=Q, GL=GL, G=G, slab_rows=slab)
                v = v.reshape(-1, CHUNK, LANES)
                c = c.reshape(-1, CHUNK, LANES)
                r = r.reshape(-1, CHUNK, LANES)
            else:
                v, c, r, mm, tb = _pack_block_v2_numpy(
                    brows, local.astype(np.int64), bvals, nr_rows,
                    value_dtype, Q, GL, G, slab)
            all_b.append(tb)
        else:
            prow, pcol, pval, preal = _pad_rows_to_chunks(
                brows, local, bvals, Q)
            if native is not None:
                v, c, r, mm = native(prow, pcol,
                                     pval.astype(np.float32, copy=False),
                                     preal, nr_rows, q=Q)
                v = v.reshape(-1, CHUNK, LANES)
                c = c.reshape(-1, CHUNK, LANES)
                r = r.reshape(-1, CHUNK, LANES)
            else:
                v, c, r, mm = _pack_block(prow, pcol, pval, preal, nr_rows,
                                          value_dtype, Q)
        nt = v.shape[0]
        all_v.append(v.reshape(nt * CHUNK, LANES))
        all_c.append(c.reshape(nt * CHUNK, LANES))
        all_r.append(r.reshape(nt * CHUNK, LANES))
        all_m.append(mm)
        pad_t = (-nt) % tiles_per_step
        if pad_t:
            _pad_tiles(pad_t)
        start = sections[-1][1] if sections else 0
        sections.append((start, start + nt + pad_t))
        step_win.extend([b] * ((nt + pad_t) // tiles_per_step))

    if not step_win:  # fully empty matrix
        _pad_tiles(tiles_per_step)
        step_win.append(0)
        sections.append((0, tiles_per_step))

    values = np.concatenate(all_v, axis=0)
    cell_idx = np.concatenate(all_c, axis=0)
    route = np.concatenate(all_r, axis=0)
    chunk_row = np.concatenate(all_m, axis=0)
    if shuffle_lanes:
        _shuffle_chunk_lanes(values, route, chunk_row, q=Q)

    return GStreamMatrix(
        values=values, cell_idx=cell_idx, route=route, chunk_row=chunk_row,
        step_window=np.asarray(step_win, dtype=np.int32),
        nr_rows=nr_rows, nr_cols=nr_cols, nr_nzeros=matrix.nr_nzeros,
        G=G, tiles_per_step=tiles_per_step, padded_cols=padded_cols,
        sections=np.asarray(sections, dtype=np.int64).reshape(-1, 2),
        Q=Q, GL=GL or 0,
        tile_base=np.concatenate(all_b) if GL else None,
        # v2 first-fit orders chunks by column group, not row: positions
        # are row-slab-local (V2-finish-eligible) only for the classic
        # layout or the slab-sorted v2 layout
        ordered=not shuffle_lanes and (not GL or slab > 0))


def _shuffle_chunk_lanes(values, route, chunk_row, seed: int = 0x5eed,
                         q: int = CHUNK):
    """Randomly permute chunk lanes within every tile plane, in place.

    A chunk's lane is free (the x-gather cells are indexed by element
    residue, not by lane), but the chunk's *position*
    pos = (tile*P + plane)*128 + lane is the column index seen by the
    reduction (F) levels.  Row-major packing gives a row's chunks
    consecutive positions -> consecutive residues -> catastrophic cell
    conflicts when the F level packs them (measured fill 0.23).  A
    per-plane random lane permutation makes F-level residues uniform
    (fill back to ~0.85) at zero kernel cost."""
    p_planes = CHUNK // q
    n_tiles = chunk_row.shape[0] // p_planes
    rng = np.random.default_rng(seed)
    # one batched permutation matrix per plane: argsort of random keys
    perm = np.argsort(rng.random((n_tiles, p_planes, TILE_CHUNKS)), axis=2)
    v4 = values.reshape(n_tiles, p_planes, q, LANES)
    r4 = route.reshape(n_tiles, p_planes, q, LANES)
    idx = perm[:, :, None, :]
    v4[...] = np.take_along_axis(v4, idx, axis=3)
    r4[...] = np.take_along_axis(r4, idx, axis=3)
    m3 = chunk_row.reshape(n_tiles, p_planes, LANES)
    m3[...] = np.take_along_axis(m3, perm, axis=2)


def unpack_gstream(p: GStreamMatrix) -> CSRMatrix:
    """Inverse of pack (delete_csr_hw_matrix-adjacent capability: the
    packed format is self-describing, enabling serialization round-trips).

    Reconstructs CSR by replaying the dual-gather semantics on the host,
    fully vectorized (one pass over the tile arrays, no per-tile loop)."""
    n_t = p.n_tiles
    W = p.window_cols
    P = p.planes
    vals = p.values.reshape(n_t, CHUNK, LANES)
    cells = p.cell_idx.reshape(n_t, CHUNK, LANES).astype(np.int64)
    route = p.route.reshape(n_t, CHUNK, LANES).astype(np.int64)
    # local col of element (t, s, l) = cell stripe at (t, s, route)*128+route
    stripe = np.take_along_axis(cells, route, axis=2)
    if p.GL:
        # v2 cells are relative to the per-tile base (in groups of 8)
        stripe = stripe + (p.tile_base.astype(np.int64)
                           * CHUNK)[:, None, None]
    local_col = stripe * STRIPE + route
    # global column: window base of the tile's grid step
    win_of_tile = p.step_window[
        np.arange(n_t, dtype=np.int64) // p.tiles_per_step].astype(np.int64)
    col = local_col + (win_of_tile * W)[:, None, None]
    # row of element (t, s, l): chunk_row plane s // Q of the tile
    rowm = np.repeat(p.chunk_row.reshape(n_t, P, LANES), p.Q, axis=1)
    nzmask = (vals != 0) & (rowm < p.nr_rows)
    if not nzmask.any():
        return CSRMatrix(np.zeros(p.nr_rows + 1, np.int32),
                         np.zeros(0, np.int32),
                         np.zeros(0, p.values.dtype), p.nr_rows, p.nr_cols)
    return CSRMatrix.from_coo(rowm[nzmask], col[nzmask], vals[nzmask],
                              p.nr_rows, p.nr_cols)
