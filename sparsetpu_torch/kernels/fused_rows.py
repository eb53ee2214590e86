"""The fused f32 SpMV over a row-ordered map of a fused pack's live slots
(``csrc/fused_rows.cu``): a second design of #1's function, y = A @ x on a
fused pack, for the card.  ``FusedDevice`` runs it in place of #1 where
the map, with the 32-byte L2 sector each of its gathers moves, comes to
fewer bytes a call than the pack (``FusedDevice.traffic``); the pack
itself is uploaded and kept as it is.

``FusedRows.build(device)`` composes, on the device that holds the pack,
what #1's plain version computes: each live slot (a nonzero value) reads x
at the forward's gather index (``spmv_fused.forward_gather_index``) and
adds into chunk-sum row ``t*P + s//Q``, lane ``l``; finish stage 1 (unless
``fin_direct``) and stage 2 route that sum (``finish_gather_index``, to
the live counts) into the slab blocks (``step_slab``, ``fin2_group``),
whose flat positions ``FusedDevice._rows`` reads back as y's rows.  The
spills join the rows of their flat positions.  The result is a CSR in y's
row order, each row's entries in the pack's slot order, then its spills.

``fused_rows_spmv`` is the kernel's wrapper, ``fused_rows_spmv_reference``
its plain version (a gather, a product, a segment sum over ``rowptr``).
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from ..utils.timing import span
from ._build import check, library

INT32_MAX = 2**31 - 1
# the kernel's lanes a row, and the rows it leaves to a warp each
WIDTHS = (4, 8, 16, 32)
QUADS_A_LANE = 8
# the pack's slots a chunk of the map's build covers (whole steps, at
# least one): its temporaries, some 100-200 B a slot, stay this size
# however large the pack
BUILD_SLOTS = 1 << 20


def row_width(mean_len: float) -> int:
    """The kernel's lanes a row for a map whose rows hold ``mean_len``
    entries on average: the least power of two in 4-32 that gives each
    lane about one 16-byte quad (4 entries) of a mean row."""
    for w in WIDTHS:
        if 4 * w >= mean_len:
            return w
    return WIDTHS[-1]


class FusedRows(nn.Module):
    """y = A @ x as a CSR of a fused pack's live slots in y's row order.

      rowptr     (n_rows + 1,) int32: row r sums entries rowptr[r]..[r+1];
      col        int32 each entry's x index (its matrix column);
      val        float32 its value;
      long_rows  int32 the rows of more than ``max_len`` entries.

    ``col`` and ``val`` are padded with zeros to a multiple of 4 entries
    (the kernel reads them in 16-byte quads; given ``n_live``, they come
    padded); ``n_live`` is the entries before the padding.  ``width`` is
    the kernel's lanes a row (``row_width`` of the mean row), ``max_len``
    = 4 * QUADS_A_LANE * width; ``n_cols`` the least length of x."""

    def __init__(self, rowptr, col, val, n_cols: int, n_live=None):
        super().__init__()
        for name, t, dt in (("rowptr", rowptr, torch.int32),
                            ("col", col, torch.int32),
                            ("val", val, torch.float32)):
            if t.dtype != dt or t.dim() != 1:
                raise ValueError(f"{name} must be 1-D {dt}")
        padded = n_live is not None
        n_live = n_live if padded else col.numel()
        pad = -n_live % 4
        n = n_live + (pad if padded else 0)
        if rowptr.numel() < 1 or int(rowptr[0]) != 0 or \
                int(rowptr[-1]) != n_live or col.numel() != n or \
                val.numel() != n:
            raise ValueError("rowptr must run from 0 to the entries")
        if rowptr.numel() > 1 and bool((rowptr.diff() < 0).any()):
            raise ValueError("rowptr must not decrease")
        if n_live and (int(col.min()) < 0 or int(col.max()) >= n_cols):
            raise ValueError("an entry reads past the matrix's columns")
        if n_cols > INT32_MAX:
            raise ValueError(f"{n_cols} columns do not fit int32")
        self.n_cols, self.n_live = n_cols, n_live
        self.n_rows = rowptr.numel() - 1
        self.width = row_width(n_live / max(self.n_rows, 1))
        self.max_len = 4 * QUADS_A_LANE * self.width
        if not padded:
            col, val = (nn.functional.pad(t, (0, pad)) for t in (col, val))
        self.register_buffer("rowptr", rowptr.contiguous())
        self.register_buffer("col", col.contiguous())
        self.register_buffer("val", val.contiguous())
        self.register_buffer("long_rows", torch.nonzero(
            rowptr.diff() > self.max_len).squeeze(1).to(torch.int32))

    @property
    def nbytes(self) -> int:
        """The bytes a call moves: every entry's column and value, every
        row's pointer and y, x once (the kernel's bound)."""
        return 8 * self.n_live + 4 * (self.n_rows + 1) + 4 * self.n_rows \
            + 4 * self.n_cols

    @classmethod
    def build(cls, dev) -> "FusedRows":
        """The map of a ``FusedDevice``'s pack, on the device that holds
        it (see the module's docstring).  Two passes over the pack, a
        chunk of steps (``BUILD_SLOTS`` slots) at a time: the first counts
        each row's entries, the second places them.  Beside the pack the
        build holds the map, 16 B a row and one chunk's temporaries."""
        m = dev.meta
        on = dev.values.device
        rowptr = torch.zeros(m.nr_rows + 1, dtype=torch.int64, device=on)
        for row, _, _ in _entries(dev):
            rowptr[1:] += torch.bincount(row, minlength=m.nr_rows)
        rowptr.cumsum_(0)
        n_live = int(rowptr[-1])
        if n_live > INT32_MAX:
            raise ValueError(f"{n_live} entries do not fit int32")
        col = torch.zeros(n_live + -n_live % 4, dtype=torch.int32,
                          device=on)
        val = torch.zeros(col.numel(), dtype=torch.float32, device=on)
        fill = rowptr[:-1].clone()      # each row's next free entry
        for row, c, v in _entries(dev):
            # a chunk's entries by row, in their order within a row
            row, order = torch.sort(row, stable=True)
            uniq, cnt = torch.unique_consecutive(row, return_counts=True)
            first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt,
                                            output_size=row.numel())
            at = fill[row] + torch.arange(row.numel(), device=on) - first
            col[at] = c[order].to(torch.int32)
            val[at] = v[order]
            fill[uniq] += cnt
        del fill
        return cls(rowptr.to(torch.int32), col, val, m.nr_cols,
                   n_live=n_live)


def _entries(dev):
    """(y's row, column, value) of each live slot of a ``FusedDevice``'s
    pack, a chunk of ``BUILD_SLOTS`` slots (whole steps) at a time in the
    pack's slot order, then of the spills; entries past ``nr_cols`` (x
    reads 0 there) left out."""
    # spmv_fused imports this module
    from .spmv_fused import CHUNK, LANES, _cell
    m, d = dev.meta, dev._dims
    n_steps, T, P = d["n_steps"], d["T"], d["P"]
    values = dev.values.view(-1)
    on = values.device
    per = T * CHUNK * LANES
    k = max(1, BUILD_SLOTS // per)
    for a in range(0, n_steps, k):
        b = min(a + k, n_steps)
        # the live slots in the pack's order; slot (tile, s, l) reads x at
        # (8 * tile_base[tile] + cell(i1[s, j], GLW)) * 128 + j,
        # j = rt[s, l]
        slot = a * per + torch.nonzero(
            values[a * per:b * per] != 0).squeeze(1)
        tile = slot >> 10
        j = dev.meta_rt.view(-1)[slot].long() & (LANES - 1)
        c = dev.meta_i1.view(-1)[(slot & ~(LANES - 1)) + j].long()
        col = (CHUNK * dev.tile_base.view(-1)[tile].long()
               + _cell(c, m.GLW)) * LANES + j
        del c, j
        # ... and adds into chunk-sum row t * P + s // Q of its step
        rows = T * P
        pos = ((tile // T) * rows + (tile % T) * P
               + ((slot >> 7) & (CHUNK - 1)) // (CHUNK // P)) * LANES \
            + (slot & (LANES - 1))
        del tile
        item = torch.arange(slot.numel(), device=on)
        if not m.fin_direct:
            src, step, f, sl = _finish_edges(dev, "fin1", rows, d["F1A"],
                                             a, b)
            # stage 1's cell (i, f, s, l) adds into partial (i, f, l)
            dst = (step * m.F1S + f) * LANES + (sl & (LANES - 1))
            item, pos = _follow(item, pos, src, dst)
            rows = m.F1S
        src, step, f, sl = _finish_edges(dev, "fin2", rows, d["F2A"], a, b)
        # stage 2's cell (i, f, s, l) adds into slab block step_slab[i],
        # row 8 * fin2_group[i, f] + s, lane l
        dst = dev.step_slab[step].long() * m.OBp * LANES \
            + CHUNK * LANES * dev.fin2_group[step, f].long() + sl
        del step, f, sl
        item, pos = _follow(item, pos, src, dst)
        del src, dst
        row, ok = _row_of(m, pos)
        del pos
        ok &= col[item] < m.nr_cols     # past nr_cols x reads 0
        item = item[ok]
        yield row[ok], col[item], values[slot[item]]
        del item, row, ok, slot, col
    if dev.n_spills:
        row, ok = _row_of(m, dev.spill_pos)
        ok &= dev.spill_col < m.nr_cols
        yield row[ok], dev.spill_col[ok], dev.spill_val[ok]


def _finish_edges(dev, stage: str, rows: int, FA: int, a: int,
                  b: int) -> tuple:
    """Every cell of finish stage ``stage`` (fin1 or fin2) of steps a..b-1
    that reads a value, in the streams' order, over the live tiles only (f
    below the step's count; a drained cell reads nothing): (source, step
    i, tile f, s * 128 + l), the source a flat position among all steps'
    (rows, 128) planes, as ``spmv_fused.finish_gather_index`` reads it."""
    from .spmv_fused import CHUNK, LANES, _cell
    cnt = getattr(dev, f"{stage}_cnt")[a:b].long()
    on = cnt.device
    total = int(cnt.sum())
    local = torch.repeat_interleave(torch.arange(b - a, device=on), cnt,
                                    output_size=total)
    f = torch.arange(total, device=on) - (torch.cumsum(cnt, 0) - cnt)[local]
    step = local + a
    del local
    tile = step * FA + f
    i1 = getattr(dev, f"{stage}_i1").view(-1, CHUNK, LANES)[tile]
    rt = getattr(dev, f"{stage}_rt").view(-1, CHUNK, LANES)[tile].long() & \
        (LANES - 1)
    del tile
    c = torch.gather(i1, 2, rt)
    del i1
    cell = torch.nonzero(c.view(-1) >= 0).squeeze(1)
    src = (_cell(c.view(-1)[cell].long(), rows // CHUNK) * LANES
           + rt.view(-1)[cell] + step[cell >> 10] * rows * LANES)
    return src, step[cell >> 10], f[cell >> 10], cell & (CHUNK * LANES - 1)


def _follow(item: torch.Tensor, pos: torch.Tensor, src: torch.Tensor,
            dst: torch.Tensor) -> tuple:
    """Items at positions ``pos`` moved along the edges ``src`` -> ``dst``:
    (item, destination) of every edge whose source an item sits on, in the
    items' order; an item no edge reads drops out, one read twice
    appears twice."""
    src, order = torch.sort(src)
    dst = dst[order]
    lo = torch.searchsorted(src, pos)
    n = torch.searchsorted(src, pos, right=True) - lo
    total = int(n.sum())
    rep = torch.repeat_interleave(torch.arange(pos.numel(), device=pos.device),
                                  n, output_size=total)
    start = torch.cumsum(n, 0) - n
    k = torch.arange(total, device=pos.device) - start[rep] + lo[rep]
    return item[rep], dst[k]


def _row_of(m, flat: torch.Tensor) -> tuple:
    """y's row of each flat position in the slab blocks, and whether y
    holds it: the inverse of ``FusedDevice._rows`` (slab s holds rows
    slab_bounds[s]..[s+1] at its first positions)."""
    from .spmv_fused import LANES
    sb = torch.as_tensor(m.slab_bounds, dtype=torch.int64,
                         device=flat.device)
    sb = sb - sb[0]
    ob = m.OBp * LANES
    s = flat // ob
    off = flat - s * ob
    return sb[s] + off, off < sb[s + 1] - sb[s]


def _check_x(x: torch.Tensor, rows: FusedRows) -> None:
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 1-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.numel() < rows.n_cols:
        raise ValueError(f"x has {x.numel()} elements, the map reads "
                         f"{rows.n_cols}")
    if rows.rowptr.device != x.device:
        raise ValueError(f"the map lies on {rows.rowptr.device}, x on "
                         f"{x.device}")
    if rows.col.data_ptr() % 16 or rows.val.data_ptr() % 16:
        raise ValueError("the map's col and val need 16-byte aligned "
                         "addresses (the kernel's quads)")


def fused_rows_spmv_reference(x: torch.Tensor,
                              rows: FusedRows) -> torch.Tensor:
    """Plain PyTorch version of the rows kernel: each entry's value times
    its gathered x, summed by row (``index_add_`` in entry order); an
    empty row reads 0.  Returns y (n_rows,) f32."""
    _check_x(x, rows)
    n = rows.n_live
    seg = torch.repeat_interleave(
        torch.arange(rows.n_rows, device=x.device),
        rows.rowptr.diff().long(), output_size=n)
    y = torch.zeros(rows.n_rows, dtype=torch.float32, device=x.device)
    return y.index_add_(0, seg, rows.val[:n] * x[rows.col[:n].long()])


def fused_rows_spmv(x: torch.Tensor, rows: FusedRows) -> torch.Tensor:
    """y = A @ x (n_rows,) f32 over the map ``rows``, from x (1-D f32, at
    least ``n_cols`` long: unpadded, or a padded x flattened).

    On CUDA tensors it launches ``csrc/fused_rows.cu`` on the current
    stream (or raises; nothing falls back): one launch, every row of y
    written once.  On CPU tensors it runs ``fused_rows_spmv_reference``.
    ``fused_rows_spmv.launches`` counts launches.  A
    ``sparsetpu.launch.fused_rows`` span a call."""
    with span("launch.fused_rows"):
        if x.device.type == "cpu":
            return fused_rows_spmv_reference(x, rows)
        if x.device.type != "cuda":
            raise ValueError(f"fused_rows_spmv: unsupported device "
                             f"{x.device}")
        lib = library().lib
        _check_x(x, rows)
        with torch.cuda.device(x.device):
            y = torch.empty(rows.n_rows, dtype=torch.float32,
                            device=x.device)
            rc = lib.fused_rows_launch(
                ctypes.c_void_p(rows.rowptr.data_ptr()),
                ctypes.c_void_p(rows.col.data_ptr()),
                ctypes.c_void_p(rows.val.data_ptr()),
                ctypes.c_void_p(x.data_ptr()),
                ctypes.c_void_p(rows.long_rows.data_ptr()), rows.n_rows,
                rows.long_rows.numel(), rows.width, rows.max_len,
                ctypes.c_void_p(y.data_ptr()),
                ctypes.c_void_p(
                    torch.cuda.current_stream(x.device).cuda_stream))
        check(lib, rc, "fused_rows launch")
        fused_rows_spmv.launches += 1
        return y


fused_rows_spmv.launches = 0
