"""Ring-overlapped distributed SpMV (counterpart of
``sparsetpu/dist/ring.py``).

x stays sharded by column segment.  At ring stage t each rank multiplies
the segment it holds, (me + t) mod P, by the steps of its row band that
read that segment, while the segment moves on to its left neighbour
(``comm.shift_left``, a ``batch_isend_irecv``; under NCCL the transfer
runs on NCCL's stream and may overlap the stage's kernel).  The band is
packed once by the classic engine (the all-gather schedule's stream) and
its steps regrouped by segment into the rank's processing order, each
with its segment-local window (``ring.py:275-326``).  Stage t is one
launch of the window forward on a contiguous slice of the band's streams
(views, cut at step boundaries), writing its own range of one chunk-sum
workspace a call; after the last stage one row-sorted final over the map
of every stage's positions gives the band's y.  The JAX package runs P
finals a shard and pads stages to their max over shards for its one SPMD
program (``ring.py:152-183``); a rank here runs its own stage counts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..formats.csr import CSRMatrix
from ..kernels.final_rows import FinalRows, final_rows
from ..kernels.spmv_gstream import combine_meta, gstream_chunk_sums
from ..pack.balance import balance_rows
from ..pack.gather_stream import CHUNK, LANES, STRIPE, pack_gstream
from . import comm
from .spmv_dist import RowBands, _check_member, _slice_rows, band_device


def _balance_contiguous(weights: np.ndarray, k: int) -> np.ndarray:
    """Boundaries (len k+1) of a contiguous partition of ``weights``
    into k groups minimizing the max group sum (binary search + greedy
    feasibility).  Trailing groups may be empty."""
    w = np.asarray(weights, np.int64)
    lo, hi = int(w.max(initial=0)), int(w.sum())
    while lo < hi:
        mid = (lo + hi) // 2
        groups, run = 1, 0
        for v in w:
            if run + v > mid:
                groups += 1
                run = int(v)
            else:
                run += int(v)
        if groups <= k:
            hi = mid
        else:
            lo = mid + 1
    bounds = [0]
    run = 0
    for i, v in enumerate(w):
        if run + v > lo and len(bounds) < k:
            bounds.append(i)
            run = int(v)
        else:
            run += int(v)
    while len(bounds) < k:
        bounds.append(len(w))
    bounds.append(len(w))
    return np.asarray(bounds, np.int64)


class RingShardedSpmv(RowBands):
    """This rank's row band in ring order.

    ``values``/``meta16``/``step_window`` hold the band's steps in the
    rank's processing order (stage t reads segment (me + t) mod P), the
    windows local to their segment; stage t is steps
    ``stage_off[t]:stage_off[t + 1]``.  ``rows`` maps the chunk-sum
    positions of that order to the band's rows.  ``x_index`` (when the
    segments' widths differ) maps position s * seg_cols + j of the
    segmented x to its column, or to ``nr_cols`` (a zero)."""

    real = torch.float32

    def __init__(self, group, part, nr_cols: int, nr_nzeros: int, *,
                 values, meta16, step_window, stage_off, rows: FinalRows,
                 G: int, tiles_per_step: int, planes: int, seg_cols: int,
                 x_index: Optional[np.ndarray], device):
        super().__init__(group, part, nr_cols, nr_nzeros)
        dev = torch.device(device)
        self.G, self.tiles_per_step, self.planes = G, tiles_per_step, planes
        self.seg_cols = seg_cols
        self.stage_off = [int(v) for v in stage_off]
        for name, a in (("values", values), ("meta16", meta16),
                        ("step_window", step_window)):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(a)).to(dev))
        self.register_buffer("x_index", torch.from_numpy(x_index).to(dev)
                             if x_index is not None else None)
        self.rows = rows.to(dev)

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def stage_steps(self) -> tuple:
        return tuple(b - a for a, b in zip(self.stage_off,
                                           self.stage_off[1:]))

    def x_segment(self, x) -> torch.Tensor:
        """This rank's segment of the segmented x, from x (nr_cols,)."""
        x = self.vector(x, self.nr_cols)
        lo = self.rank * self.seg_cols
        if self.x_index is not None:
            x = torch.cat([x, x.new_zeros(1)])
            return x[self.x_index[lo:lo + self.seg_cols]]
        x = nn.functional.pad(
            x, (0, self.seg_cols * self.num_partitions - self.nr_cols))
        return x[lo:lo + self.seg_cols].contiguous()

    def stage(self, t: int, xseg: torch.Tensor, out: torch.Tensor,
              kernel=None) -> None:
        """Stage t's chunk sums into ``out``, the workspace, from the
        segment ``xseg`` (seg_cols,): one forward launch on the stage's
        slice of the streams (none for an empty stage), or ``kernel`` on
        the same inputs (``gstream_chunk_sums_reference`` to compare)."""
        a, b = self.stage_off[t], self.stage_off[t + 1]
        if a == b:
            return
        rps = self.tiles_per_step * CHUNK
        cps = self.tiles_per_step * self.planes
        args = (self.values[a * rps:b * rps], self.meta16[a * rps:b * rps],
                self.step_window[a:b], xseg.view(-1, STRIPE))
        kw = dict(T=self.tiles_per_step, G=self.G, P=self.planes)
        if kernel is None:
            gstream_chunk_sums(*args, **kw, out=out[a * cps:b * cps])
        else:
            out[a * cps:b * cps] = kernel(*args, **kw)

    def spmv_local(self, x_seg) -> torch.Tensor:
        """The band's y from this rank's segment: P stages, the segments
        moving left between them, then one final."""
        x_seg = self.vector(x_seg, self.seg_cols)
        cps = self.tiles_per_step * self.planes
        ws = torch.empty(self.stage_off[-1] * cps, LANES,
                         device=self.device)
        xseg, n = x_seg.contiguous(), self.num_partitions
        for t in range(n):
            shift = comm.shift_left(xseg, self.group) if t + 1 < n else None
            self.stage(t, xseg, ws)
            if shift is not None:
                xseg = shift.wait()
        return final_rows(ws.view(-1), self.rows)


def ring_shard_spmv(matrix: CSRMatrix, group=None, *, interpret=False,
                    tiles_per_step: int = 32,
                    device=None) -> RingShardedSpmv:
    """Pack this rank's band for the ring schedule (``ring.py:235``):
    every rank of ``group`` calls it with the whole matrix.  The layout
    (G, Q) is the global matrix's choice, the segments' boundaries balance
    nnz over whole windows (``_balance_contiguous``), and the band's pack
    is regrouped by segment in this rank's processing order."""
    from ..pack.gather_stream import _choose_layout
    _check_member(group)
    dev = band_device(device, interpret)
    n, me = comm.group_size(group), comm.group_rank(group)
    part = balance_rows(matrix, n)
    G, Q = _choose_layout(matrix)
    planes = CHUNK // Q
    W = G * CHUNK * STRIPE
    nblocks = -(-matrix.nr_cols // W)
    blk_nnz = np.bincount(
        np.minimum(matrix.col_ind // W, nblocks - 1), minlength=nblocks)
    seg_bounds = _balance_contiguous(blk_nnz, n)
    seg_nblocks = np.diff(seg_bounds)
    blocks_per_seg = int(max(seg_nblocks.max(), 1))
    seg_cols = blocks_per_seg * W
    rps, cps = tiles_per_step * CHUNK, tiles_per_step * planes

    pk = pack_gstream(_slice_rows(matrix, int(part.row_start[me]),
                                  int(part.row_end[me])),
                      G=G, Q=Q, tiles_per_step=tiles_per_step,
                      shuffle_lanes=True)
    # an empty band's pack emits one all-pad step at window 0: it falls to
    # the segment holding block 0 (zero values, harmless)
    seg_of_step = np.searchsorted(seg_bounds, pk.step_window,
                                  side="right") - 1
    m16 = combine_meta(pk.cell_idx, pk.route)
    cr = pk.chunk_row.reshape(-1, LANES)
    vals, metas, winds, crs, off = [], [], [], [], [0]
    for t in range(n):
        seg = (me + t) % n
        sel = np.flatnonzero(seg_of_step == seg)
        el = (sel[:, None] * rps + np.arange(rps)[None, :]).reshape(-1)
        cl = (sel[:, None] * cps + np.arange(cps)[None, :]).reshape(-1)
        vals.append(pk.values[el])
        metas.append(m16[el])
        winds.append((pk.step_window[sel] - int(seg_bounds[seg])
                      ).astype(np.int32))
        crs.append(cr[cl])
        off.append(off[-1] + sel.size)

    x_index = None
    if not np.all(seg_nblocks == blocks_per_seg):
        # unequal widths: position s*seg_cols + j reads source column
        # seg_bounds[s]*W + j (pads -> the appended zero)
        j = np.arange(seg_cols, dtype=np.int64)
        src = seg_bounds[:n, None] * W + j[None, :]
        valid = j[None, :] < seg_nblocks[:, None] * W
        x_index = np.where(valid & (src < matrix.nr_cols), src,
                           matrix.nr_cols).reshape(-1)
    rows = FinalRows.from_chunk_row(np.concatenate(crs), pk.nr_rows, dev)
    return RingShardedSpmv(
        group, part, matrix.nr_cols, matrix.nr_nzeros,
        values=np.concatenate(vals), meta16=np.concatenate(metas),
        step_window=np.concatenate(winds), stage_off=off, rows=rows, G=G,
        tiles_per_step=tiles_per_step, planes=planes, seg_cols=seg_cols,
        x_index=x_index, device=dev)
