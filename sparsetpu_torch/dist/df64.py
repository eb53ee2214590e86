"""Distributed f64 (DOUBLE=1) SpMV (counterpart of
``sparsetpu/dist/df64.py``).

Each rank packs its band's hi and lo planes exactly as the JAX package
does (``df64.py:198-213``: Q = 8, no lane shuffle, G and tiles_per_step
pinned to shard 0's hi pack) and uploads them through the port's classic
f64 device, ``DF64GStreamDevice.from_packed``, which joins them into one
float64 plane.  Its forward is the live-slot kernel (``live_slot_sums``)
and its final the f64 row-sorted final over the band's own map
(``FinalRows.from_chunk_row``), both in native FP64; the JAX package's
compensated f32 segmented scan (``df64.py:156-178``) has no counterpart.
x and y are float64 tensors (the port has no ``DF64`` pair), so
``cg_df64`` runs over ``spmv`` as it is.
"""

from __future__ import annotations

from typing import Optional

from ..formats.csr import CSRMatrix
from ..kernels.f64emu import DF64GStreamDevice, split_planes
from ..kernels.final_rows import FinalRows
from ..pack.balance import balance_rows
from ..pack.final_levels import FinishPlan
from ..pack.gather_stream import pack_gstream
from ..utils.config import SpmvConfig
from . import comm
from .spmv_dist import (ShardedSpmv, _check_member, _slice_rows,
                        band_device)


class ShardedSpmvDF64(ShardedSpmv):
    """This rank's row band of an f64 matrix: ``ShardedSpmv`` over a
    ``DF64GStreamDevice``; x and y float64."""


def shard_spmv_df64(matrix: CSRMatrix, group=None,
                    config: Optional[SpmvConfig] = None, *,
                    interpret=False, device=None) -> ShardedSpmvDF64:
    """Pack this rank's band of a float64 CSR matrix as the (hi, lo) pair
    and upload it (the multi-chip DOUBLE=1 create_csr_hw_matrix).  Group
    rank 0 packs band 0's hi plane and gives every rank its G and
    tiles_per_step."""
    _check_member(group)
    dev = band_device(device, interpret)
    n, me = comm.group_size(group), comm.group_rank(group)
    part = balance_rows(matrix, n)
    m_hi, m_lo = split_planes(_slice_rows(matrix, int(part.row_start[me]),
                                          int(part.row_end[me])))
    kw = dict(shuffle_lanes=False, Q=8)
    pk_hi = pack_gstream(m_hi, config, **kw) if me == 0 else None
    G, tps = comm.broadcast_ints(
        (pk_hi.G, pk_hi.tiles_per_step) if me == 0 else (0, 0), 0, group,
        dev)
    if me:
        pk_hi = pack_gstream(m_hi, config, G=G, tiles_per_step=tps, **kw)
    pk_lo = pack_gstream(m_lo, config, G=pk_hi.G,
                         tiles_per_step=pk_hi.tiles_per_step, **kw)
    rows = FinalRows.from_chunk_row(pk_hi.chunk_row, pk_hi.nr_rows, dev)
    band = DF64GStreamDevice.from_packed(pk_hi, pk_lo, dev,
                                         plan=FinishPlan([], rows, None))
    return ShardedSpmvDF64(band, group, part, matrix.nr_cols,
                           matrix.nr_nzeros)
