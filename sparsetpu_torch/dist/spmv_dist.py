"""Distributed SpMV over ranks joined by ``torch.distributed``: a matrix
sharded by rows (counterpart of ``sparsetpu/dist/spmv_dist.py``).

Each rank is one process with one device and holds one nnz-balanced row
band of the matrix (``pack.balance.balance_rows``), packed by the classic
engine and multiplied by the port's classic device: the window forward
(``gstream_chunk_sums``, ``csrc/gstream_spmv.cu``) and the row-sorted
final (``final_rows``, ``csrc/final_rows.cu``) over the band's own map
(``FinalRows.from_chunk_row``), which builds for every placement, so no
band finishes by a segment-sum.  x is sharded by column: each rank holds
a contiguous segment of the padded x and the ranks all-gather it before
the forward; the bands are disjoint in rows, so y needs no reduction, and
``spmv`` all-gathers the bands to give every rank the whole y.

The JAX package runs one SPMD program over the mesh and so pads every
shard's steps and finals to one shape (``spmv_dist.py:272-293,
387-444``).  A rank here runs its own shapes: nothing is padded but the
band's y, to ``rows_per_part``, for the all-gather of the bands.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..formats.csr import CSRMatrix
from ..kernels.final_rows import FinalRows
from ..kernels.spmv_gstream import GStreamDevice
from ..pack.balance import balance_rows
from ..pack.final_levels import FinishPlan
from ..pack.gather_stream import CHUNK, STRIPE, pack_gstream
from ..utils.config import SpmvConfig
from ..utils.device import CUDA, HBM_GBPS, NVLINK_GBPS, pick_device
from . import comm
from .launch import rank_device


def make_mesh(n_devices: Optional[int] = None):
    """The process group over the first ``n_devices`` ranks (all when
    None): the port's mesh of one row axis.  Every rank of the default
    group must call it (``dist.new_group``); a rank outside gets
    ``dist.GroupMember.NON_GROUP_MEMBER``."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    return dist.new_group(ranks=list(range(n)))


def default_device() -> torch.device:
    """This rank's card: ``cuda:{local_rank % device_count}``, the local
    rank from ``LOCAL_RANK`` (torchrun) or the global rank."""
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return rank_device(local, "cuda")


def band_device(device=None, interpret: bool = False) -> torch.device:
    """A rank's device: ``device``, or this rank's card when None;
    ``interpret=True`` is the CPU (``utils/device.py:pick_device``)."""
    dev = pick_device(CUDA if device is None else device, interpret)
    return default_device() if device is None and dev.type == "cuda" \
        else dev


def _slice_rows(matrix: CSRMatrix, r0: int, r1: int) -> CSRMatrix:
    lo, hi = int(matrix.row_ptr[r0]), int(matrix.row_ptr[r1])
    return CSRMatrix(matrix.row_ptr[r0:r1 + 1] - lo,
                     matrix.col_ind[lo:hi], matrix.values[lo:hi],
                     r1 - r0, matrix.nr_cols)


def _check_member(group) -> None:
    if group is dist.GroupMember.NON_GROUP_MEMBER:
        raise ValueError("this rank is not in the group")


class RowBands(nn.Module):
    """What every schedule's rank holds beside its streams: the group, the
    nnz-balanced row bands (``pack.balance.RowPartition``) and x's checks;
    ``spmv`` takes the whole x and gives the whole y on every rank, around
    the schedule's ``x_segment`` (this rank's part of x) and
    ``spmv_local`` (that part in, this rank's band of y out)."""

    def __init__(self, group, part, nr_cols: int, nr_nzeros: int):
        super().__init__()
        _check_member(group)
        self.group = group
        self.rank = comm.group_rank(group)
        self.row_starts = np.asarray(part.row_start, np.int64)
        self.row_ends = np.asarray(part.row_end, np.int64)
        self.nr_rows = int(self.row_ends[-1])
        self.nr_cols, self.nr_nzeros = nr_cols, nr_nzeros
        self.rows_per_part = int(max(self.row_ends - self.row_starts))

    @property
    def num_partitions(self) -> int:
        """The number of row bands, one a rank of the group
        (``spmv_dist.py:82``)."""
        return len(self.row_starts)

    def vector(self, v, n: int) -> torch.Tensor:
        """``v`` as a 1-D tensor of ``n`` values: a tensor must be of the
        real type on the device already; anything else is converted."""
        if isinstance(v, torch.Tensor):
            if v.dtype != self.real or v.device != self.device:
                raise ValueError(f"expected a {self.real} tensor on "
                                 f"{self.device}, got {v.dtype} on "
                                 f"{v.device}")
        else:
            v = torch.as_tensor(np.asarray(v), dtype=self.real,
                                device=self.device)
        if tuple(v.shape) != (n,):
            raise ValueError(f"expected shape ({n},), got {tuple(v.shape)}")
        return v

    def spmv(self, x) -> torch.Tensor:
        """y = A @ x (nr_rows,) on every rank, from the whole x (nr_cols,)
        on every rank: the bands, each padded to ``rows_per_part``,
        all-gathered and cut back (``_scatter_rows``,
        ``spmv_dist.py:133``)."""
        y = self.spmv_local(self.x_segment(x))
        y = nn.functional.pad(y, (0, self.rows_per_part - y.shape[0]))
        return torch.cat([
            b[:int(e) - int(s)] for b, s, e in zip(
                comm.all_gather(y, self.group), self.row_starts,
                self.row_ends)])


class ShardedSpmv(RowBands):
    """This rank's row band of a matrix sharded over a process group, for
    the all-gather schedule.

    ``band`` is the band on the rank's device: a ``GStreamDevice`` over
    the band's pack whose final is the band's ``FinalRows`` (the f64 form,
    ``ShardedSpmvDF64``, a ``DF64GStreamDevice``).  x is cut into equal
    segments of the padded x, one a rank."""

    def __init__(self, band: GStreamDevice, group, part, nr_cols: int,
                 nr_nzeros: int):
        super().__init__(group, part, nr_cols, nr_nzeros)
        self.band = band
        p = band.meta
        self.G, self.tiles_per_step, self.planes = (p.G, p.tiles_per_step,
                                                    p.planes)
        self.n_steps = p.n_steps
        self.padded_cols = p.padded_cols
        self.seg_cols = -(-self.padded_cols // self.num_partitions)

    @property
    def device(self) -> torch.device:
        return self.band.device

    @property
    def real(self) -> torch.dtype:
        return self.band.real

    def x_segment(self, x) -> torch.Tensor:
        """This rank's segment of x (nr_cols,), zero-padded."""
        x = self.vector(x, self.nr_cols)
        x = nn.functional.pad(
            x, (0, self.seg_cols * self.num_partitions - self.nr_cols))
        return x[self.rank * self.seg_cols:
                 (self.rank + 1) * self.seg_cols].contiguous()

    def spmv_local(self, x_seg) -> torch.Tensor:
        """The band's y (its rows only) from this rank's segment of x: the
        segments all-gathered into the padded x, then the forward and the
        final on the band."""
        x_seg = self.vector(x_seg, self.seg_cols)
        x = torch.cat(comm.all_gather(x_seg, self.group))
        x2 = x[:self.padded_cols].view(-1, STRIPE)
        return self.band.spmv(x2, x_is_packed=True)


def _band_device(pk, device) -> GStreamDevice:
    """The band's classic device: its pack, and its own row-sorted map as
    the final."""
    dev = torch.device(device)
    rows = FinalRows.from_chunk_row(pk.chunk_row, pk.nr_rows, dev)
    return GStreamDevice(pk, device=dev, plan=FinishPlan([], rows, None))


def shard_spmv(matrix: CSRMatrix, group=None,
               config: Optional[SpmvConfig] = None, *, interpret=False,
               device=None) -> ShardedSpmv:
    """Pack this rank's row band and upload it (the multi-chip
    create_csr_hw_matrix, ``spmv_dist.py:244``).  Every rank of ``group``
    (the default group when None) calls it with the whole matrix.  The
    band is packed with ``shuffle_lanes=True``; group rank 0 packs band 0
    and gives every rank its (G, Q, tiles_per_step), which pin the other
    bands' packs, as in the JAX package, so each band's stream equals the
    JAX shard's.  ``device``: the rank's card by default
    (``band_device``)."""
    _check_member(group)
    dev = band_device(device, interpret)
    n, me = comm.group_size(group), comm.group_rank(group)
    part = balance_rows(matrix, n)

    def band(p, **kw):
        return pack_gstream(_slice_rows(matrix, int(part.row_start[p]),
                                        int(part.row_end[p])),
                            config, shuffle_lanes=True, **kw)

    pk0 = band(0) if me == 0 else None
    pins = comm.broadcast_ints(
        (pk0.G, pk0.Q, pk0.tiles_per_step) if me == 0 else (0, 0, 0),
        0, group, dev)
    pk = pk0 if me == 0 else band(me, G=pins[0], Q=pins[1],
                                  tiles_per_step=pins[2])
    return ShardedSpmv(_band_device(pk, dev), group, part, matrix.nr_cols,
                       matrix.nr_nzeros)


def choose_schedule(matrix: CSRMatrix, n_dev: int,
                    hbm_gbps: Optional[float] = None,
                    link_gbps: Optional[float] = None) -> str:
    """Pick "ring" vs "allgather" by modelled cost (``spmv_dist.py:317``):
    the all-gather moves (P-1)/P of x over the links before any compute;
    the ring hides each segment's transfer under the previous stage's
    kernel but runs each stage at the max over ranks of their stage-t
    segment's work, a tax computed exactly from the (rank, segment) nnz
    matrix under the ring's own segment boundaries.  The rates default to
    the data sheet's (``utils/device.py``): the H100 SXM's HBM and its
    NVLink in one direction."""
    if n_dev < 2:
        return "allgather"
    from ..pack.gather_stream import _choose_layout
    from .ring import _balance_contiguous

    hbm = HBM_GBPS["H100 SXM"] if hbm_gbps is None else hbm_gbps
    link = NVLINK_GBPS if link_gbps is None else link_gbps
    G, _ = _choose_layout(matrix)
    W = G * CHUNK * STRIPE
    nblocks = -(-matrix.nr_cols // W)
    blk = np.bincount(np.minimum(matrix.col_ind // W, nblocks - 1),
                      minlength=nblocks)
    bounds = _balance_contiguous(blk, n_dev)
    part = balance_rows(matrix, n_dev)
    rn = np.diff(matrix.row_ptr.astype(np.int64))
    shard_of_row = np.searchsorted(part.row_end, np.arange(matrix.nr_rows),
                                   side="right")
    el_shard = np.repeat(shard_of_row, rn)
    el_seg = np.searchsorted(
        bounds, np.minimum(matrix.col_ind // W, nblocks - 1),
        side="right") - 1
    w2 = np.bincount(el_shard * n_dev + el_seg,
                     minlength=n_dev * n_dev).reshape(n_dev, n_dev)
    staged = sum(int(max(w2[p][(p + t) % n_dev] for p in range(n_dev)))
                 for t in range(n_dev))
    ideal = w2.sum() / n_dev
    pad_ratio = staged / max(ideal, 1.0)

    x_bytes = matrix.nr_cols * 4
    stream_bytes = matrix.nr_nzeros / 0.6 * 6      # fill-0.6 estimate
    compute = stream_bytes / (hbm * 1e9) / n_dev   # per-device total
    stage_comm = x_bytes / n_dev / (link * 1e9)
    # +5% step quantization on top of the exact nnz staged-pad ratio
    stage_comp = compute * (pad_ratio + 0.05) / n_dev
    # the ring pipelines: each stage's segment transfer rides under the
    # previous stage's compute (or vice versa when comm-bound)
    ring_time = (n_dev - 1) * max(stage_comm, stage_comp) + stage_comp
    ag_time = (n_dev - 1) * stage_comm + compute
    return "ring" if ring_time < 0.95 * ag_time else "allgather"


def shard_spmv_auto(matrix: CSRMatrix, group=None, *, interpret=False,
                    device=None):
    """Pack and shard with the modelled schedule (``spmv_dist.py:370``):
    the ring where hiding the x exchange pays, the all-gather otherwise."""
    if choose_schedule(matrix, comm.group_size(group)) == "ring":
        from .ring import ring_shard_spmv
        return ring_shard_spmv(matrix, group, interpret=interpret,
                               device=device)
    return shard_spmv(matrix, group, interpret=interpret, device=device)
