"""The classic GStream device on the card (counterpart of
``sparsetpu/kernels/spmv_pallas.py:270-401`` and of the final levels'
``apply``).

``GStreamDevice`` holds a GStream pack (``pack/gather_stream.py``, the very
arrays the JAX ``GStreamDevice`` uploads) and its finish plan
(``pack/final_levels.py``) as buffers, and runs y = A @ x as

  forward   ``gstream_chunk_sums``: per-chunk partial sums
            (``csrc/gstream_spmv.cu``; window or per-tile-base scheme);
  F levels  the same forward kernel on 0/1-incidence packs that pre-reduce
            heavy rows, their outputs appended to the position vector;
  final     ``final_rows.final_rows``: the final level (every level of a
            multi final, and the spills) as one row-sorted gather-sum built
            at upload from the TPU tables (``csrc/final_rows.cu``);

or, when no final could be built, a segment-sum of the position vector
(``spmv_coo.spmv_chunked``), the algorithm's own route.  Its k-plane
counterparts (``positions_multi``, ``apply_multi``) serve
``spmm.spmm_gstream``.  The TPU layout's per-instance final survives only
as its plain version, ``final_gather_reference`` (``FinalDevice.grid``),
the tests' yardstick; no device keeps its tables.  Each wrapper runs its
plain PyTorch version (``gstream_chunk_sums_reference``) for tensors on
the CPU, and launches its kernel (or raises) for tensors on a CUDA device.

The f64 device (``f64emu.DF64GStreamDevice``) is this device with float64
values, positions and y: its forward is ``live_slot_sums`` over a
``LiveSlots`` map built at upload (the pack's live slots at the positions
its finish reads), and ``final_rows`` takes float64 positions to its f64
entry point.  ``gstream_chunk_sums_reference`` still runs the whole f64
pack in plain PyTorch, the yardstick the live slots are held to.
"""

from __future__ import annotations

import collections
import ctypes
import types
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..pack.final_levels import (_FinalLevel, _FinalLevelMulti,
                                 _FinalLevelV2, build_finish)
from ..pack.gather_stream import CHUNK, LANES, STRIPE, GStreamMatrix
from ..utils.device import CUDA, pick_device, require_device
from ._build import check, library
from .final_rows import FinalRows, final_rows, final_rows_multi
from .spmv_coo import spmv_chunked


def combine_meta(cell_idx: np.ndarray, route: np.ndarray) -> np.ndarray:
    """Fuse the per-cell stripe index (< 8G <= 256, 8 bits) and the lane
    route (< 128, 7 bits) into one int16 stream: meta = cell << 7 | route
    (``spmv_pallas.py:47-53``)."""
    return ((cell_idx.astype(np.int32) << 7)
            | route.astype(np.int32) & 0x7F).astype(np.int16)


def _require(t: torch.Tensor, name: str, dtypes, dev) -> None:
    if t.dtype not in dtypes or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtypes} tensor on "
                         f"{dev}, got {t.dtype} on {t.device}")


# ---------------------------------------------------------------------------
# forward: chunk partial sums (TPU kernels _spmv_kernel / _spmv_kernel_v2)
# ---------------------------------------------------------------------------

def _check_forward(values, meta, step_window, tile_base, x2, *, T, G, P,
                   GL, multi=False) -> int:
    """Dtype, device, contiguity and shape checks shared by the forward
    kernels and their plain versions; returns the tile count.  ``multi``:
    x2 is the SpMM's X, row-major (padded_cols, k).  Values f32 or bf16
    take an f32 x2; f64 values an f64 x2, and GL = 0 only (the f64 device's
    pack; the TPU's df64 kernels add no tile base)."""
    dev = x2.device
    _require(values, "values", (torch.float32, torch.bfloat16,
                                torch.float64), dev)
    _require(meta, "meta", (torch.int16,), dev)
    _require(step_window, "step_window", (torch.int32,), dev)
    f64 = values.dtype == torch.float64
    _require(x2, "x2", (torch.float64 if f64 else torch.float32,), dev)
    if f64 and GL:
        raise ValueError(f"the f64 forward takes GL = 0 only (got GL={GL})")
    if P not in (1, 2, 4, 8) or T < 1 or not 1 <= G <= 32:
        raise ValueError(f"unsupported layout T={T} G={G} P={P}")
    n_tiles = step_window.shape[0] * T
    for name, a in (("values", values), ("meta", meta)):
        if tuple(a.shape) != (n_tiles * CHUNK, LANES):
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{(n_tiles * CHUNK, LANES)}")
    if GL:
        if G % GL:
            raise ValueError(f"GL={GL} must divide G={G}")
        _require(tile_base, "tile_base", (torch.int32,), dev)
        if tuple(tile_base.shape) != (n_tiles,):
            raise ValueError("tile_base must be (n_tiles,)")
    if multi:
        if x2.dim() != 2 or x2.shape[0] % (CHUNK * G * STRIPE) or \
                x2.shape[1] < 1:
            raise ValueError("X must be (n_windows*8G*128, k)")
    elif x2.dim() != 2 or x2.shape[1] != LANES or x2.shape[0] % (CHUNK * G):
        raise ValueError("x2 must be (n_windows*8G, 128)")
    return n_tiles


def forward_gather_index(meta, step_window, *, T: int, G: int, GL: int = 0,
                         tile_base=None):
    """The x element each forward slot reads: (flat index into x2, reads
    x), both (n_tiles, 8, 128).  A slot whose group lies past the window
    (G, or GL with per-tile bases) reads 0, as the select chain leaves it."""
    m = meta.view(-1, CHUNK, LANES).long() & 0x7FFF
    j = m & 127
    c = torch.gather(m, 2, j) >> 7
    base = (CHUNK * G * step_window.long()).repeat_interleave(T)
    if GL:
        base = base + CHUNK * tile_base.long()
    ok = (c >> 3) < (GL or G)
    return torch.where(ok, (base.view(-1, 1, 1) + c) * LANES + j, 0), ok


def gstream_chunk_sums_reference(values, meta, step_window, x2, *, T: int,
                                 G: int, P: int, GL: int = 0,
                                 tile_base=None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, over all tiles at once:
    decode, gather, multiply, sum over Q.  Returns the chunk sums,
    (n_tiles*P, 128), in x2's real type."""
    n_tiles = _check_forward(values, meta, step_window, tile_base, x2, T=T,
                             G=G, P=P, GL=GL)
    idx, ok = forward_gather_index(meta, step_window, T=T, G=G, GL=GL,
                                   tile_base=tile_base)
    xv = torch.where(ok, x2.reshape(-1)[idx], 0.0)
    prod = values.view(-1, CHUNK, LANES).to(x2.dtype) * xv
    return prod.view(n_tiles, P, CHUNK // P, LANES).sum(2).view(-1, LANES)


def gstream_chunk_sums(values, meta, step_window, x2, *, T: int, G: int,
                       P: int, GL: int = 0, tile_base=None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel: chunk sums (n_tiles*P, 128) f32.

    On CUDA tensors it launches ``csrc/gstream_spmv.cu`` on the current
    stream (or raises); on CPU tensors it runs
    ``gstream_chunk_sums_reference``.  ``gstream_chunk_sums.launches``
    counts launches by scheme: ``"window"`` (GL = 0) and ``"tile_base"``.
    f64 values run on the CPU only: on the card the f64 device's forward is
    ``live_slot_sums``, which reads the pack's live slots alone.

    The streams may be views of a larger pack cut at step boundaries (a
    ring stage's steps).  ``out``, when given, is a contiguous (n_tiles*P,
    128) tensor of the sums' type on x2's device (a range of a caller's
    workspace) that receives the sums, and is returned."""
    if out is not None:
        n = step_window.shape[0] * T * P
        want = torch.float64 if values.dtype == torch.float64 \
            else torch.float32
        if tuple(out.shape) != (n, LANES) or out.dtype != want or \
                out.device != x2.device or not out.is_contiguous():
            raise ValueError(f"out must be a contiguous {(n, LANES)} {want} "
                             f"tensor on {x2.device}, got {out.dtype} "
                             f"{tuple(out.shape)} on {out.device}")
    if x2.device.type == "cpu":
        sums = gstream_chunk_sums_reference(values, meta, step_window, x2,
                                            T=T, G=G, P=P, GL=GL,
                                            tile_base=tile_base)
        return sums if out is None else out.copy_(sums)
    if x2.device.type != "cuda":
        raise ValueError(f"gstream_chunk_sums: unsupported device "
                         f"{x2.device}")
    if values.dtype == torch.float64:
        raise ValueError("gstream_chunk_sums: no kernel reads the f64 pack "
                         "whole on the card; the f64 forward is "
                         "live_slot_sums over the device's LiveSlots")
    n_tiles = _check_forward(values, meta, step_window, tile_base, x2, T=T,
                             G=G, P=P, GL=GL)
    lib = library().lib
    with torch.cuda.device(x2.device):
        if out is None:
            out = torch.empty(n_tiles * P, LANES, device=x2.device)
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.gstream_spmv_launch(
            ctypes.c_void_p(values.data_ptr()),
            int(values.dtype == torch.bfloat16),
            ctypes.c_void_p(meta.data_ptr()),
            ctypes.c_void_p(step_window.data_ptr()),
            ctypes.c_void_p(tile_base.data_ptr() if GL else 0),
            ctypes.c_void_p(x2.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n_tiles, T, G, GL, P, ctypes.c_void_p(stream))
    check(lib, rc, "gstream_chunk_sums launch")
    gstream_chunk_sums.launches["tile_base" if GL else "window"] += 1
    return out


gstream_chunk_sums.launches = collections.Counter()


# ---------------------------------------------------------------------------
# the f64 forward over the live slots (TPU kernel _df64_spmv_kernel)
# ---------------------------------------------------------------------------

INT32_MAX = 2**31 - 1


class LiveSlots(nn.Module):
    """The f64 forward's map, built once at upload from a pack's stream
    (``build``): for each chunk position the finish reads, its live slots,
    in sublane order.  A slot is live when its value is nonzero and the
    select chain keeps its x index (``forward_gather_index``); the rest of
    the pack, padding and stored zeros, adds nothing on finite x.

      pos     (n_read,) int32 the read positions, ascending;
      rowptr  (n_read + 1,) int32: pos[r] sums entries rowptr[r]..[r+1];
      col     int32 each live slot's x index (its matrix column);
      val     float64 its value.

    ``n_positions`` is the length of the chunk-sum vector the map writes
    into (n_tiles * P * 128), ``n_cols`` the least length of x."""

    def __init__(self, pos, rowptr, col, val, n_positions: int,
                 n_cols: int):
        super().__init__()
        for name, t, dt in (("pos", pos, torch.int32),
                            ("rowptr", rowptr, torch.int32),
                            ("col", col, torch.int32),
                            ("val", val, torch.float64)):
            if t.dtype != dt or t.dim() != 1:
                raise ValueError(f"{name} must be 1-D {dt}")
        if rowptr.numel() != pos.numel() + 1 or int(rowptr[0]) != 0 or \
                int(rowptr[-1]) != col.numel() or col.numel() != val.numel():
            raise ValueError("rowptr must run from 0 to the live slots")
        if pos.numel() and (int(pos.min()) < 0
                            or int(pos.max()) >= n_positions):
            raise ValueError("a read position lies outside the chunk sums")
        if col.numel() and (int(col.min()) < 0 or int(col.max()) >= n_cols):
            raise ValueError("a live slot reads past the matrix's columns")
        self.n_positions, self.n_cols = n_positions, n_cols
        for name, t in (("pos", pos), ("rowptr", rowptr), ("col", col),
                        ("val", val)):
            self.register_buffer(name, t.contiguous())

    @property
    def n_read(self) -> int:
        return self.pos.numel()

    @property
    def n_live(self) -> int:
        return self.col.numel()

    @classmethod
    def build(cls, stream: "ForwardStream", read: torch.Tensor,
              n_cols: int) -> "LiveSlots":
        """The map of a forward stream (float64 values, on its device)
        over the positions ``read`` (any integer tensor of chunk
        positions, sorted ascending without repeats)."""
        if stream.values.dtype != torch.float64:
            raise ValueError("LiveSlots takes a stream of float64 values")
        idx, ok = forward_gather_index(stream.meta16, stream.step_window,
                                       T=stream.T, G=stream.G, GL=stream.GL,
                                       tile_base=stream.tile_base)
        n_pos = idx.shape[0] * stream.P * LANES
        if n_pos > INT32_MAX:
            raise ValueError(f"{n_pos} chunk positions do not fit int32")
        slot = torch.nonzero((ok & (stream.values.view(idx.shape) != 0))
                             .view(-1)).squeeze(1)
        del ok
        # slot (k, s, l) adds to chunk position (k * P + s // Q) * 128 + l;
        # (position, sublane) orders each position's slots by sublane
        s = (slot >> 7) & (CHUNK - 1)
        pos = ((slot >> 10) * stream.P + s // (CHUNK // stream.P)) * LANES \
            + (slot & (LANES - 1))
        order = torch.argsort(pos * CHUNK + s)
        slot, pos = slot[order], pos[order]
        read = read.to(torch.int64)
        n = read.numel()
        r = torch.searchsorted(read, pos)
        keep = r < n
        if n:
            keep &= read[r.clamp(max=n - 1)] == pos
        slot, r = slot[keep], r[keep]
        rowptr = torch.zeros(n + 1, dtype=torch.int64, device=read.device)
        rowptr[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
        return cls(read.to(torch.int32), rowptr.to(torch.int32),
                   idx.view(-1)[slot].to(torch.int32),
                   stream.values.view(-1)[slot], n_pos, n_cols)


def _check_live(x: torch.Tensor, slots: LiveSlots) -> None:
    if x.dtype != torch.float64 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 1-D float64 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.numel() < slots.n_cols or x.numel() > INT32_MAX:
        raise ValueError(f"x has {x.numel()} elements, the live slots read "
                         f"{slots.n_cols}")
    if slots.pos.device != x.device:
        raise ValueError(f"the live slots lie on {slots.pos.device}, x on "
                         f"{x.device}")


def live_slot_sums_reference(x: torch.Tensor,
                             slots: LiveSlots) -> torch.Tensor:
    """Plain PyTorch version of the live-slot kernel: each read position's
    live products added in sublane order (``index_add_``), the other
    positions 0.  Returns the chunk sums (n_positions / 128, 128) f64."""
    _check_live(x, slots)
    row = torch.repeat_interleave(
        torch.arange(slots.n_read, device=x.device),
        slots.rowptr.diff().long(), output_size=slots.n_live)
    sums = torch.zeros(slots.n_read, dtype=torch.float64, device=x.device)
    sums.index_add_(0, row, slots.val * x[slots.col.long()])
    out = torch.zeros(slots.n_positions, dtype=torch.float64,
                      device=x.device)
    out[slots.pos.long()] = sums
    return out.view(-1, LANES)


def live_slot_sums(x: torch.Tensor, slots: LiveSlots) -> torch.Tensor:
    """The f64 forward: chunk sums (n_positions / 128, 128) f64 at the
    positions ``slots`` reads, from x (1-D float64, at least ``n_cols``
    long: unpadded, or the padded x2 flattened).

    On CUDA tensors it launches the live-slot kernel of
    ``csrc/gstream_spmv.cu`` on the current stream (or raises): only the
    read positions are written, the rest of the output is left as
    allocated; on CPU tensors it runs ``live_slot_sums_reference``.
    ``live_slot_sums.launches`` counts launches."""
    if x.device.type == "cpu":
        return live_slot_sums_reference(x, slots)
    if x.device.type != "cuda":
        raise ValueError(f"live_slot_sums: unsupported device {x.device}")
    _check_live(x, slots)
    lib = library().lib
    with torch.cuda.device(x.device):
        out = torch.empty(slots.n_positions, dtype=torch.float64,
                          device=x.device)
        rc = lib.live_slots_f64_launch(
            ctypes.c_void_p(slots.pos.data_ptr()),
            ctypes.c_void_p(slots.rowptr.data_ptr()),
            ctypes.c_void_p(slots.col.data_ptr()),
            ctypes.c_void_p(slots.val.data_ptr()),
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            slots.n_read,
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    check(lib, rc, "live_slot_sums launch")
    live_slot_sums.launches += 1
    return out.view(-1, LANES)


live_slot_sums.launches = 0


class ForwardStream(nn.Module):
    """One GStream pack on the device: values (f32, bf16 in the bf16 value
    mode, or the f64 device's float64 plane), the int16 meta,
    ``step_window`` and, when GL > 0, ``tile_base``; ``forward(x2)`` gives
    its chunk sums.  ``values``, when given, is uploaded in place of
    ``p.values`` (same shape, its own dtype)."""

    def __init__(self, p: GStreamMatrix, device, value_dtype=None,
                 values: Optional[np.ndarray] = None):
        super().__init__()
        _check_forward_pack(p)
        dev = require_device(device)
        self.T, self.G, self.P, self.GL = (p.tiles_per_step, p.G, p.planes,
                                           p.GL)
        self.padded_cols = p.padded_cols
        plane = (np.ascontiguousarray(p.values, np.float32) if values is None
                 else np.ascontiguousarray(values))
        if plane.shape != p.values.shape:
            raise ValueError("values must have the pack's shape")
        self.register_buffer("values", torch.from_numpy(plane).to(
            dev, value_dtype))
        self.register_buffer("meta16", torch.from_numpy(
            combine_meta(p.cell_idx, p.route)).to(dev))
        self.register_buffer("step_window", torch.from_numpy(
            np.ascontiguousarray(p.step_window, np.int32)).to(dev))
        self.register_buffer("tile_base", torch.from_numpy(
            np.ascontiguousarray(p.tile_base, np.int32)).to(dev)
            if p.GL else None)

    def forward(self, x2: torch.Tensor, kernel=None) -> torch.Tensor:
        """Chunk sums through ``kernel`` (default the wrapper
        ``gstream_chunk_sums``; ``gstream_chunk_sums_reference`` to
        compare)."""
        if tuple(x2.shape) != (self.padded_cols // STRIPE, LANES):
            # the step windows were checked against this shape at upload
            raise ValueError(f"x2 has shape {tuple(x2.shape)}, expected "
                             f"{(self.padded_cols // STRIPE, LANES)}")
        return (kernel or gstream_chunk_sums)(
            self.values, self.meta16, self.step_window, x2, T=self.T,
            G=self.G, P=self.P, GL=self.GL, tile_base=self.tile_base)

    def forward_multi(self, X: torch.Tensor, kernel=None) -> torch.Tensor:
        """The k planes' chunk sums, row-major (n_tiles*P*128, k), for X
        row-major (padded_cols, k), through ``kernel`` (default the wrapper
        ``spmm.gstream_chunk_sums_multi``)."""
        from .spmm import gstream_chunk_sums_multi    # spmm imports this
        if X.dim() != 2 or X.shape[0] != self.padded_cols:
            raise ValueError(f"X has shape {tuple(X.shape)}, expected "
                             f"({self.padded_cols}, k)")
        return (kernel or gstream_chunk_sums_multi)(
            self.values, self.meta16, self.step_window, X, T=self.T,
            G=self.G, P=self.P, GL=self.GL, tile_base=self.tile_base)


def _check_forward_pack(p: GStreamMatrix) -> None:
    """Host-side bounds the forward kernel relies on for in-buffer
    addresses: every staged window inside the padded x, every per-tile
    base inside its window, and no cell past the window where the TPU
    kernel indexes without the select chain (G == 1, GL == 1)."""
    windows = p.padded_cols // (p.G * CHUNK * STRIPE)
    sw = p.step_window
    if p.padded_cols % (p.G * CHUNK * STRIPE) or (
            sw.size and (sw.min() < 0 or sw.max() >= windows)):
        raise ValueError("step_window outside the padded x")
    if p.GL:
        tb = p.tile_base
        if tb.size and (tb.min() < 0 or tb.max() > p.G - p.GL):
            raise ValueError("tile_base outside the x window")
    if (p.GL or p.G) == 1 and p.cell_idx.size and (
            p.cell_idx.min() < 0 or p.cell_idx.max() >= CHUNK):
        raise ValueError("a cell beyond the 8 rows of a one-group window")


# ---------------------------------------------------------------------------
# final levels: the TPU layout's plain final (TPU kernels _final_kernel /
# _final_kernel_v2, a yardstick and the map's decode), and the devices'
# ---------------------------------------------------------------------------

def _check_final(step_meta, tile_bases, inst_start, x2, cells, route, *,
                 tps, G, nw, GS, nt_pad, v2, multi=False) -> int:
    """Checks of the TPU layout's plain final and its k-plane form; returns
    the instance count.  ``multi``: x2 is the k position planes, row-major
    (x_pad_rows*128, k).  x2 is f32, or f64 for the legacy one-plane final
    (the f64 device's)."""
    dev = x2.device
    for name, a, dt in (("step_meta", step_meta, (torch.int32,)),
                        ("inst_start", inst_start, (torch.int32,)),
                        ("x2", x2, (torch.float32, torch.float64)),
                        ("cells", cells, (torch.int16,)),
                        ("route", route, (torch.int8,))):
        _require(a, name, dt, dev)
    if x2.dtype == torch.float64 and (v2 or multi):
        raise ValueError("the f64 final is the legacy one-plane scheme only")
    n_steps = step_meta.shape[0]
    if tps < 1 or G < 1 or nw < 1 or nt_pad % tps:
        raise ValueError(f"unsupported final tps={tps} G={G} nw={nw} "
                         f"nt_pad={nt_pad}")
    if tuple(step_meta.shape) != (n_steps, nw + 2):
        raise ValueError("step_meta must be (n_steps, nw + 2)")
    for name, a in (("cells", cells), ("route", route)):
        if tuple(a.shape) != (n_steps * tps * CHUNK, LANES):
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{(n_steps * tps * CHUNK, LANES)}")
    if tuple(inst_start.shape) != (nt_pad // tps + 1,):
        raise ValueError("inst_start must be (n_out_blocks + 1,)")
    if v2:
        _require(tile_bases, "tile_bases", (torch.int32,), dev)
        if tuple(tile_bases.shape) != (n_steps, tps * nw) or GS < G:
            raise ValueError("tile_bases must be (n_steps, tps * nwin)")
    if multi:
        if x2.dim() != 2 or x2.shape[0] % STRIPE or x2.shape[1] < 1:
            raise ValueError("X must be (x_pad_rows*128, k)")
    elif x2.dim() != 2 or x2.shape[1] != LANES:
        raise ValueError("x2 must be (x_pad_rows, 128)")
    return n_steps


def final_gather_index(step_meta, tile_bases, cells, route, *, tps: int,
                       G: int, nw: int, GS: int, v2: bool):
    """The position each final slot gathers: (flat index into the padded
    position vector, reads it), both (n_instances, tps, 8, 128).  A cell
    at or past nw windows (the drain) or below 0 reads 0."""
    n_steps = step_meta.shape[0]
    shape = (n_steps, tps, CHUNK, LANES)
    j = route.view(shape).long() & 127
    c = torch.gather(cells.view(shape).long(), 3, j)
    grp = c >> 3
    w = torch.div(grp, G, rounding_mode="floor")
    ok = (grp >= 0) & (w < nw)
    w = w.clamp(0, nw - 1)
    inst = torch.arange(n_steps, device=cells.device).view(-1, 1, 1, 1)
    sm = step_meta[:, :nw].long()[inst, w]
    row = CHUNK * (grp - w * G) + (c & 7)
    if v2:
        t = torch.arange(tps, device=cells.device).view(1, -1, 1, 1)
        tb = tile_bases.long().view(n_steps, tps, nw)[inst, t, w]
        row = row + CHUNK * GS * sm + CHUNK * tb
    else:
        row = row + CHUNK * G * sm
    return torch.where(ok, row * LANES + j, 0), ok


def final_gather_reference(step_meta, tile_bases, inst_start, x2, cells,
                           route, *, tps: int, G: int, nw: int, GS: int,
                           nt_pad: int, v2: bool) -> torch.Tensor:
    """The TPU layout's per-instance final (TPU kernels #4, #5, #12) in
    plain PyTorch, over all instances at once: decode, gather, sum over the
    8 sublanes, then ``index_add_`` of each instance into its out block (in
    instance order, so the first instance's sum is added to 0).  Returns
    y's grid, (nt_pad, 128), in x2's real type."""
    n_steps = _check_final(step_meta, tile_bases, inst_start, x2, cells,
                           route, tps=tps, G=G, nw=nw, GS=GS, nt_pad=nt_pad,
                           v2=v2)
    idx, ok = final_gather_index(step_meta, tile_bases, cells, route,
                                 tps=tps, G=G, nw=nw, GS=GS, v2=v2)
    part = torch.where(ok, x2.reshape(-1)[idx], 0.0).sum(2)
    out = torch.zeros(nt_pad // tps, tps, LANES, dtype=x2.dtype,
                      device=x2.device)
    out.index_add_(0, step_meta[:, nw + 1].long(), part)
    return out.view(nt_pad, LANES)


class FinalDevice(nn.Module):
    """One final level (a host ``_FinalLevel`` or ``_FinalLevelV2``) on the
    device; ``apply(vec)`` is y from the flat position vector ``vec`` of
    ``n_positions`` chunk sums, and ``apply_multi(vec)`` Y from the k-plane
    one, through ``rows``, the level's ``FinalRows`` built at upload
    (``rows=False``: none, for a level of a ``FinalMultiDevice``, which
    builds one for all its levels).  No TPU table stays on the device:
    ``tables`` uploads them from the host level for one use (the map's
    build, and ``grid``/``grid_multi``, the TPU layout's plain final, a
    yardstick).  Spills with ``spill_row == nr_rows`` (the padded slots of
    a uniform-shape final) are dropped at upload, as the JAX package drops
    them (``mode="drop"``)."""

    def __init__(self, final, nr_rows: int, n_positions: int, device,
                 rows: bool = True):
        super().__init__()
        dev = require_device(device)
        self.host, self.n_positions = final, n_positions
        self.v2 = isinstance(final, _FinalLevelV2)
        self.tps = final.tiles_per_step
        self.G = final.GL_f if self.v2 else final.G
        self.nw = final.nwin if self.v2 else final.nw
        self.GS = final.GS if self.v2 else 0
        self.nt_pad = final.nt_pad
        self.x_pad_rows = final.x_pad_rows
        self.nr_rows = nr_rows
        self._inst_start = _check_final_level(final, self.G, self.nw,
                                              self.GS, self.v2)
        self._spills = _spills(final, nr_rows, n_positions)
        self.n_spills = int(self._spills[0].size)
        self.rows = (FinalRows.from_levels([self.tables(dev)], nr_rows,
                                           n_positions, dev)
                     if rows else None)

    def tables(self, device) -> types.SimpleNamespace:
        """The level's TPU tables on ``device``, uploaded from the host
        level (``step_meta``, ``tile_bases``, ``inst_start``, ``cells``,
        ``route``, the kept spills ``spill_pos``/``spill_row``), beside its
        shape (``tps``, ``G``, ``nw``, ``GS``, ``v2``, ``nt_pad``)."""
        dev = torch.device(device)
        f = self.host

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        return types.SimpleNamespace(
            tps=self.tps, G=self.G, nw=self.nw, GS=self.GS, v2=self.v2,
            nt_pad=self.nt_pad,
            step_meta=up(f.step_meta, torch.int32),
            tile_bases=up(f.tile_bases, torch.int32) if self.v2 else None,
            inst_start=up(self._inst_start, torch.int32),
            cells=up(f.cell_idx, torch.int16), route=up(f.route, torch.int8),
            spill_pos=up(self._spills[0], torch.int64),
            spill_row=up(self._spills[1], torch.int64))

    def _padded(self, vec: torch.Tensor) -> torch.Tensor:
        """vec's first x_pad_rows * 128 positions, zero-padded to them."""
        need = self.x_pad_rows * STRIPE
        if vec.shape[0] < need:
            pad = (0, need - vec.shape[0]) if vec.dim() == 1 else \
                (0, 0, 0, need - vec.shape[0])
            vec = nn.functional.pad(vec, pad)
        return vec[:need].contiguous()

    def grid(self, vec: torch.Tensor,
             kernel=final_gather_reference) -> torch.Tensor:
        """y's grid (nt_pad, 128) as the TPU layout computes it, from the
        flat position vector, through ``kernel`` (the plain version) over
        tables uploaded for the call."""
        t = self.tables(vec.device)
        return kernel(t.step_meta, t.tile_bases, t.inst_start,
                      self._padded(vec.reshape(-1)).view(-1, STRIPE),
                      t.cells, t.route, tps=self.tps, G=self.G, nw=self.nw,
                      GS=self.GS, nt_pad=self.nt_pad, v2=self.v2)

    def grid_multi(self, vec: torch.Tensor) -> torch.Tensor:
        """The k planes' grid, row-major (nt_pad*128, k), as the TPU layout
        computes it, from the k-plane position vector (n_positions, k),
        through its plain version ``spmm.final_gather_multi_reference``."""
        from .spmm import final_gather_multi_reference   # spmm imports this
        t = self.tables(vec.device)
        return final_gather_multi_reference(
            t.step_meta, t.tile_bases, t.inst_start, self._padded(vec),
            t.cells, t.route, tps=self.tps, G=self.G, nw=self.nw, GS=self.GS,
            nt_pad=self.nt_pad, v2=self.v2)

    def apply(self, vec: torch.Tensor, kernel=None) -> torch.Tensor:
        """y (nr_rows,) through ``kernel`` (default the wrapper
        ``final_rows``; ``final_rows_reference`` to compare)."""
        return (kernel or final_rows)(vec.reshape(-1), self.rows)

    def apply_multi(self, vec: torch.Tensor, kernel=None) -> torch.Tensor:
        """Y (nr_rows, k) from the k-plane position vector (n_positions,
        k), row-major, through ``kernel`` (default the wrapper
        ``final_rows_multi``; ``final_rows_multi_reference`` to
        compare)."""
        return (kernel or final_rows_multi)(vec, self.rows)


def _check_final_level(final, G: int, nw: int, GS: int, v2: bool):
    """Host-side bounds the final kernel relies on; returns the instance
    range of each out block.  Instances of one block are consecutive and
    the first of them carries the first-instance flag."""
    sm = final.step_meta
    n_blocks = final.nt_pad // final.tiles_per_step
    o = sm[:, nw + 1].astype(np.int64)
    if o.size and (np.any(np.diff(o) < 0) or o.min() < 0
                   or o.max() >= n_blocks):
        raise ValueError("final instances are not sorted by out block")
    inst_start = np.searchsorted(o, np.arange(n_blocks + 1))
    starts = inst_start[:-1][inst_start[1:] > inst_start[:-1]]
    flag = np.zeros(o.size, np.int64)
    flag[starts] = 1
    if not np.array_equal(sm[:, nw].astype(np.int64), flag):
        raise ValueError("first-instance flags do not open the out blocks")
    unit = CHUNK * (GS if v2 else G)
    win = sm[:, :nw]
    if win.size and (win.min() < 0
                     or (int(win.max()) + 1) * unit > final.x_pad_rows):
        raise ValueError("a final window lies outside the padded positions")
    if v2:
        tb = final.tile_bases
        if tb.size and (tb.min() < 0 or tb.max() > GS - G):
            raise ValueError("tile_bases outside the staged block")
    return inst_start


def _spills(final, nr_rows: int, n_positions: int):
    """The final's spills, with the padded ones (row == nr_rows) dropped;
    raises on any other index out of range."""
    pos = np.asarray(final.spill_pos, np.int64)
    row = np.asarray(final.spill_row, np.int64)
    keep = row != nr_rows
    pos, row = pos[keep], row[keep]
    if pos.size and (pos.min() < 0 or pos.max() >= n_positions
                     or row.min() < 0 or row.max() >= nr_rows):
        raise ValueError("spill indices out of range")
    return pos, row


class MapFinal(nn.Module):
    """A final given as its map alone, ``rows`` (a ``FinalRows``, such as
    a rank's band builds from its pack's chunk rows,
    ``FinalRows.from_chunk_row``): ``apply`` and ``apply_multi`` as
    ``FinalDevice``'s, with no TPU tables behind it."""

    def __init__(self, rows: FinalRows):
        super().__init__()
        self.rows = rows

    def apply(self, vec: torch.Tensor, kernel=None) -> torch.Tensor:
        """y (nr_rows,) through ``kernel`` (default the wrapper
        ``final_rows``; ``final_rows_reference`` to compare)."""
        return (kernel or final_rows)(vec.reshape(-1), self.rows)

    def apply_multi(self, vec: torch.Tensor, kernel=None) -> torch.Tensor:
        """Y (nr_rows, k) from the k-plane position vector through
        ``kernel`` (default the wrapper ``final_rows_multi``;
        ``final_rows_multi_reference`` to compare)."""
        return (kernel or final_rows_multi)(vec, self.rows)


class FinalMultiDevice(MapFinal):
    """``_FinalLevelMulti`` on the device: y is the sum of one flat final
    per group of <= 8 column blocks, and of their spills, all folded into
    one ``FinalRows`` at upload from the groups' TPU tables, uploaded one
    level at a time; ``levels`` are the groups (their ``tables`` and
    ``grid`` upload them anew)."""

    def __init__(self, final, nr_rows: int, n_positions: int, device):
        dev = require_device(device)
        levels = nn.ModuleList(
            FinalDevice(lvl, nr_rows, n_positions, dev, rows=False)
            for lvl in final.levels)
        super().__init__(FinalRows.from_levels(
            (lvl.tables(dev) for lvl in levels), nr_rows, n_positions, dev))
        self.levels = levels


def final_device(final, nr_rows: int, n_positions: int, device):
    """The device module of a host final level, or of a ``FinalRows`` map
    (moved to ``device``)."""
    if isinstance(final, FinalRows):
        if (final.nr_rows, final.n_positions) != (nr_rows, n_positions):
            raise ValueError(f"the map has {final.nr_rows} rows and "
                             f"{final.n_positions} positions, the pack "
                             f"{nr_rows} and {n_positions}")
        return MapFinal(final.to(require_device(device)))
    if isinstance(final, _FinalLevelMulti):
        return FinalMultiDevice(final, nr_rows, n_positions, device)
    if isinstance(final, (_FinalLevel, _FinalLevelV2)):
        return FinalDevice(final, nr_rows, n_positions, device)
    raise TypeError(f"not a final level: {type(final).__name__}")


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

class GStreamDevice(nn.Module):
    """A GStream pack held on one device; ``spmv`` is y = A @ x through the
    forward kernel, the F levels and the final level.

    ``value_dtype=torch.bfloat16`` uploads the values in bf16 (the "ML
    precision" mode: half the value stream); x and every sum stay f32.
    ``values`` and ``plan`` replace the pack's value plane and its
    ``build_finish`` plan (the f64 device passes its float64 plane and a
    legacy final; a rank's band a ``FinalRows`` as its final); float64
    values make x, every sum and y float64.

    The positional arguments are the JAX ``GStreamDevice``'s
    (``spmv_pallas.py:285-286``).  ``interpret=True`` runs the plain
    versions on the CPU (``utils/device.py:pick_device``).
    ``finish_levels`` is accepted and unused, as in the JAX package, whose
    ``_build_finish`` takes it and never reads it (``spmv_pallas.py:298,
    301``): ``build_finish`` picks the levels."""

    def __init__(self, packed: GStreamMatrix, interpret=False,
                 finish_levels: Optional[int] = None,
                 value_dtype: Optional[torch.dtype] = None, *, device=CUDA,
                 values: Optional[np.ndarray] = None, plan=None):
        super().__init__()
        dev = pick_device(device, interpret)
        self.meta = packed
        self.stream = ForwardStream(packed, dev, value_dtype, values)
        plan = build_finish(packed) if plan is None else plan
        self.plan = plan
        self.flevels = nn.ModuleList(ForwardStream(fp, dev)
                                     for fp in plan.flevels)
        n_positions = packed.chunk_row.size + sum(
            fp.chunk_row.size for fp in plan.flevels)
        self.final = (final_device(plan.final, packed.nr_rows, n_positions,
                                   dev)
                      if plan.final is not None else None)
        # the segment-sum route reads only the positions that hold a row:
        # index_add_ of every padded position into the trap row serialises
        # on that one address
        pos = (np.flatnonzero(plan.chunk_row != packed.nr_rows)
               if plan.final is None else None)
        self.register_buffer("chunk_pos", torch.from_numpy(pos).to(dev)
                             if pos is not None else None)
        self.register_buffer("chunk_row", torch.from_numpy(
            plan.chunk_row[pos].astype(np.int64)).to(dev)
            if pos is not None else None)

    @property
    def device(self) -> torch.device:
        return self.stream.values.device

    @property
    def dtype(self) -> torch.dtype:
        return self.stream.values.dtype

    @property
    def real(self) -> torch.dtype:
        """The type of x, the sums and y: f64 for f64 values, else f32."""
        return torch.float64 if self.dtype == torch.float64 \
            else torch.float32

    def prepare_x(self, x) -> torch.Tensor:
        """x (nr_cols,) -> the (padded_cols / 128, 128) stripe matrix,
        zero-padded past nr_cols.  x stays f32 in the bf16 value mode."""
        x = torch.as_tensor(x, dtype=self.real, device=self.device)
        if tuple(x.shape) != (self.meta.nr_cols,):
            raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                             f"({self.meta.nr_cols},)")
        pad = self.meta.padded_cols - self.meta.nr_cols
        return nn.functional.pad(x, (0, pad)).view(-1, STRIPE)

    def prepare_x_multi(self, X) -> torch.Tensor:
        """X (nr_cols, k) -> row-major (padded_cols, k) in the real type,
        zero rows past nr_cols (f32 in the bf16 value mode too)."""
        X = torch.as_tensor(X, dtype=self.real, device=self.device)
        if X.dim() != 2 or X.shape[0] != self.meta.nr_cols or \
                X.shape[1] < 1:
            raise ValueError(f"X has shape {tuple(X.shape)}, expected "
                             f"({self.meta.nr_cols}, k)")
        pad = self.meta.padded_cols - self.meta.nr_cols
        return nn.functional.pad(X, (0, 0, 0, pad)).contiguous()

    def spmv(self, x, x_is_packed: bool = False) -> torch.Tensor:
        x2 = x if x_is_packed else self.prepare_x(x)
        return self.finish_vec(self.stream(x2))

    def positions(self, chunk_sums: torch.Tensor, kernel=None):
        """The flat position vector: the chunk sums, then each F level's
        outputs (computed through ``kernel``, default the wrapper)."""
        vec = chunk_sums.reshape(-1)
        for f in self.flevels:
            flat = vec
            pad = f.padded_cols - flat.shape[0]
            if pad > 0:
                flat = nn.functional.pad(flat, (0, pad))
            x2 = flat[:f.padded_cols].view(-1, STRIPE)
            vec = torch.cat([vec, f(x2, kernel).reshape(-1)])
        return vec

    def positions_multi(self, chunk_sums: torch.Tensor, kernel=None):
        """The k-plane position vector (n_positions, k), row-major: the
        k-plane chunk sums, then each F level's outputs, each level's k
        planes through one ``ForwardStream.forward_multi`` (``kernel``,
        default the wrapper ``spmm.gstream_chunk_sums_multi``) on the
        positions before it."""
        vec = chunk_sums
        for f in self.flevels:
            X = vec[:f.padded_cols]
            if X.shape[0] < f.padded_cols:
                X = nn.functional.pad(X, (0, 0, 0, f.padded_cols - X.shape[0]))
            vec = torch.cat([vec, f.forward_multi(X.contiguous(), kernel)])
        return vec

    def finish_vec(self, chunk_sums: torch.Tensor) -> torch.Tensor:
        """chunk partial sums -> y (the on-device accum_results): the
        final's one row-sorted gather-sum, or the segment-sum route."""
        vec = self.positions(chunk_sums)
        if self.final is not None:
            return self.final.apply(vec)
        return spmv_chunked(vec[self.chunk_pos], self.chunk_row,
                            self.meta.nr_rows)


def spmv_gstream(packed: GStreamMatrix, x, interpret=False, *,
                 device=CUDA) -> torch.Tensor:
    """One-shot y = A @ x: upload ``packed`` and multiply once (the JAX
    package's convenience wrapper, ``spmv_pallas.py:1190``)."""
    return GStreamDevice(packed, interpret, device=device).spmv(x)
