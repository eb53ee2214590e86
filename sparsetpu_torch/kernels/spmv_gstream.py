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
  final     ``final_gather``: the gather-accumulate final level whose
            output cell (r // 128, r % 128) IS y[r]
            (``csrc/gstream_final.cu``; legacy or flat scheme), then the
            final's spills by ``index_add_``;

or, when no final could be built, a segment-sum of the position vector
(``spmv_coo.spmv_chunked``), the algorithm's own route.  Each wrapper runs
its plain PyTorch version (``gstream_chunk_sums_reference``,
``final_gather_reference``) for tensors on the CPU, and launches its kernel
(or raises) for tensors on a CUDA device.

The f64 device (``f64emu.DF64GStreamDevice``) is this device with float64
values, positions and y: the wrappers hand float64 inputs to their native
FP64 forms, ``gstream_chunk_sums_f64`` (window scheme) and
``final_gather_f64`` (legacy scheme), whose plain versions are the same
``..._reference`` functions, which run in the inputs' real type.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..pack.final_levels import (_FinalLevel, _FinalLevelMulti,
                                 _FinalLevelV2, build_finish)
from ..pack.gather_stream import CHUNK, LANES, STRIPE, GStreamMatrix
from ..utils.device import require_device
from ._build import check, library
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
                       P: int, GL: int = 0, tile_base=None) -> torch.Tensor:
    """The forward kernel: chunk sums (n_tiles*P, 128) f32.

    On CUDA tensors it launches ``csrc/gstream_spmv.cu`` on the current
    stream (or raises); on CPU tensors it runs
    ``gstream_chunk_sums_reference``.  ``gstream_chunk_sums.launches``
    counts launches by scheme: ``"window"`` (GL = 0) and ``"tile_base"``.
    f64 values go to ``gstream_chunk_sums_f64``."""
    if values.dtype == torch.float64:
        return gstream_chunk_sums_f64(values, meta, step_window, x2, T=T,
                                      G=G, P=P, GL=GL, tile_base=tile_base)
    if x2.device.type == "cpu":
        return gstream_chunk_sums_reference(values, meta, step_window, x2,
                                            T=T, G=G, P=P, GL=GL,
                                            tile_base=tile_base)
    if x2.device.type != "cuda":
        raise ValueError(f"gstream_chunk_sums: unsupported device "
                         f"{x2.device}")
    n_tiles = _check_forward(values, meta, step_window, tile_base, x2, T=T,
                             G=G, P=P, GL=GL)
    lib = library().lib
    with torch.cuda.device(x2.device):
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


def gstream_chunk_sums_f64(values, meta, step_window, x2, *, T: int, G: int,
                           P: int, GL: int = 0,
                           tile_base=None) -> torch.Tensor:
    """The forward kernel in native FP64 (window scheme): chunk sums
    (n_tiles*P, 128) f64 for f64 values and x2.

    On CUDA tensors it launches the f64 form of ``csrc/gstream_spmv.cu``
    (or raises, also for GL > 0); on CPU tensors it runs
    ``gstream_chunk_sums_reference``.  ``gstream_chunk_sums_f64.launches``
    counts launches."""
    if values.dtype != torch.float64:
        raise ValueError("gstream_chunk_sums_f64 takes float64 values")
    if x2.device.type == "cpu":
        return gstream_chunk_sums_reference(values, meta, step_window, x2,
                                            T=T, G=G, P=P, GL=GL,
                                            tile_base=tile_base)
    if x2.device.type != "cuda":
        raise ValueError(f"gstream_chunk_sums_f64: unsupported device "
                         f"{x2.device}")
    n_tiles = _check_forward(values, meta, step_window, tile_base, x2, T=T,
                             G=G, P=P, GL=GL)
    lib = library().lib
    with torch.cuda.device(x2.device):
        out = torch.empty(n_tiles * P, LANES, dtype=torch.float64,
                          device=x2.device)
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.gstream_spmv_f64_launch(
            ctypes.c_void_p(values.data_ptr()),
            ctypes.c_void_p(meta.data_ptr()),
            ctypes.c_void_p(step_window.data_ptr()),
            ctypes.c_void_p(x2.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n_tiles, T, G, P, ctypes.c_void_p(stream))
    check(lib, rc, "gstream_chunk_sums_f64 launch")
    gstream_chunk_sums_f64.launches += 1
    return out


gstream_chunk_sums_f64.launches = 0


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
# final levels (TPU kernels _final_kernel / _final_kernel_v2)
# ---------------------------------------------------------------------------

def _check_final(step_meta, tile_bases, inst_start, x2, cells, route, *,
                 tps, G, nw, GS, nt_pad, v2, multi=False) -> int:
    """Checks shared by the final kernels and their plain versions; returns
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
    """Plain PyTorch version of the final kernel, over all instances at
    once: decode, gather, sum over the 8 sublanes, then ``index_add_`` of
    each instance into its out block (in instance order, so the first
    instance's sum is added to 0).  Returns y's grid, (nt_pad, 128), in
    x2's real type."""
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


def final_gather(step_meta, tile_bases, inst_start, x2, cells, route, *,
                 tps: int, G: int, nw: int, GS: int, nt_pad: int,
                 v2: bool) -> torch.Tensor:
    """The final kernel: y's grid (nt_pad, 128) f32.

    On CUDA tensors it launches ``csrc/gstream_final.cu`` on the current
    stream (or raises); on CPU tensors it runs ``final_gather_reference``.
    ``final_gather.launches`` counts launches by scheme: ``"legacy"`` and
    ``"flat"``.  f64 positions go to ``final_gather_f64``."""
    if x2.dtype == torch.float64:
        return final_gather_f64(step_meta, tile_bases, inst_start, x2, cells,
                                route, tps=tps, G=G, nw=nw, GS=GS,
                                nt_pad=nt_pad, v2=v2)
    if x2.device.type == "cpu":
        return final_gather_reference(step_meta, tile_bases, inst_start, x2,
                                      cells, route, tps=tps, G=G, nw=nw,
                                      GS=GS, nt_pad=nt_pad, v2=v2)
    if x2.device.type != "cuda":
        raise ValueError(f"final_gather: unsupported device {x2.device}")
    _check_final(step_meta, tile_bases, inst_start, x2, cells, route,
                 tps=tps, G=G, nw=nw, GS=GS, nt_pad=nt_pad, v2=v2)
    lib = library().lib
    with torch.cuda.device(x2.device):
        out = torch.empty(nt_pad, LANES, device=x2.device)
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.gstream_final_launch(
            int(v2), ctypes.c_void_p(step_meta.data_ptr()),
            ctypes.c_void_p(tile_bases.data_ptr() if v2 else 0),
            ctypes.c_void_p(inst_start.data_ptr()),
            ctypes.c_void_p(x2.data_ptr()), ctypes.c_void_p(cells.data_ptr()),
            ctypes.c_void_p(route.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), nt_pad, tps, G, nw, GS,
            ctypes.c_void_p(stream))
    check(lib, rc, "final_gather launch")
    final_gather.launches["flat" if v2 else "legacy"] += 1
    return out


final_gather.launches = collections.Counter()


def final_gather_f64(step_meta, tile_bases, inst_start, x2, cells, route, *,
                     tps: int, G: int, nw: int, GS: int, nt_pad: int,
                     v2: bool) -> torch.Tensor:
    """The final kernel in native FP64 (legacy scheme): y's grid
    (nt_pad, 128) f64 from f64 positions.

    On CUDA tensors it launches the f64 form of ``csrc/gstream_final.cu``
    (or raises, also for the flat scheme); on CPU tensors it runs
    ``final_gather_reference``.  ``final_gather_f64.launches`` counts
    launches."""
    if x2.dtype != torch.float64:
        raise ValueError("final_gather_f64 takes float64 positions")
    if x2.device.type == "cpu":
        return final_gather_reference(step_meta, tile_bases, inst_start, x2,
                                      cells, route, tps=tps, G=G, nw=nw,
                                      GS=GS, nt_pad=nt_pad, v2=v2)
    if x2.device.type != "cuda":
        raise ValueError(f"final_gather_f64: unsupported device {x2.device}")
    _check_final(step_meta, tile_bases, inst_start, x2, cells, route,
                 tps=tps, G=G, nw=nw, GS=GS, nt_pad=nt_pad, v2=v2)
    lib = library().lib
    with torch.cuda.device(x2.device):
        out = torch.empty(nt_pad, LANES, dtype=torch.float64,
                          device=x2.device)
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.gstream_final_f64_launch(
            ctypes.c_void_p(step_meta.data_ptr()),
            ctypes.c_void_p(inst_start.data_ptr()),
            ctypes.c_void_p(x2.data_ptr()), ctypes.c_void_p(cells.data_ptr()),
            ctypes.c_void_p(route.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), nt_pad, tps, G, nw,
            ctypes.c_void_p(stream))
    check(lib, rc, "final_gather_f64 launch")
    final_gather_f64.launches += 1
    return out


final_gather_f64.launches = 0


class FinalDevice(nn.Module):
    """One final level (a host ``_FinalLevel`` or ``_FinalLevelV2``) on the
    device; ``apply(vec)`` is y from the flat position vector ``vec`` of
    ``n_positions`` chunk sums.  Spills with ``spill_row == nr_rows`` (the
    padded slots of a uniform-shape final) are dropped at upload, as the
    JAX package drops them (``mode="drop"``)."""

    def __init__(self, final, nr_rows: int, n_positions: int, device):
        super().__init__()
        dev = require_device(device)
        self.v2 = isinstance(final, _FinalLevelV2)
        self.tps = final.tiles_per_step
        self.G = final.GL_f if self.v2 else final.G
        self.nw = final.nwin if self.v2 else final.nw
        self.GS = final.GS if self.v2 else 0
        self.nt_pad = final.nt_pad
        self.x_pad_rows = final.x_pad_rows
        self.nr_rows = nr_rows
        inst_start = _check_final_level(final, self.G, self.nw, self.GS,
                                        self.v2)

        def up(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        self.register_buffer("step_meta", up(final.step_meta, torch.int32))
        self.register_buffer("tile_bases", up(final.tile_bases, torch.int32)
                             if self.v2 else None)
        self.register_buffer("inst_start", up(inst_start, torch.int32))
        self.register_buffer("cells", up(final.cell_idx, torch.int16))
        self.register_buffer("route", up(final.route, torch.int8))
        spill_pos, spill_row = _spills(final, nr_rows, n_positions)
        self.n_spills = int(spill_pos.size)
        self.register_buffer("spill_pos", up(spill_pos, torch.int64))
        self.register_buffer("spill_row", up(spill_row, torch.int64))

    def grid(self, vec: torch.Tensor, kernel=None) -> torch.Tensor:
        """y's grid (nt_pad, 128) through ``kernel`` (default the wrapper
        ``final_gather``; ``final_gather_reference`` to compare)."""
        flat = vec.reshape(-1)
        need = self.x_pad_rows * STRIPE
        if flat.shape[0] < need:
            flat = nn.functional.pad(flat, (0, need - flat.shape[0]))
        x2 = flat[:need].view(-1, STRIPE)
        return (kernel or final_gather)(
            self.step_meta, self.tile_bases, self.inst_start, x2, self.cells,
            self.route, tps=self.tps, G=self.G, nw=self.nw, GS=self.GS,
            nt_pad=self.nt_pad, v2=self.v2)

    def apply(self, vec: torch.Tensor, kernel=None) -> torch.Tensor:
        y = self.grid(vec, kernel).view(-1)[:self.nr_rows]
        if self.n_spills:
            # in place: y is a view of this call's own grid
            y.index_add_(0, self.spill_row, vec.reshape(-1)[self.spill_pos])
        return y

    def grid_multi(self, vec: torch.Tensor, kernel=None) -> torch.Tensor:
        """The k planes' grid, row-major (nt_pad*128, k), from the k-plane
        position vector ``vec`` (n_positions, k), padded as ``grid`` pads,
        through ``kernel`` (default the wrapper
        ``spmm.final_gather_multi``)."""
        from .spmm import final_gather_multi          # spmm imports this
        need = self.x_pad_rows * STRIPE
        if vec.shape[0] < need:
            vec = nn.functional.pad(vec, (0, 0, 0, need - vec.shape[0]))
        return (kernel or final_gather_multi)(
            self.step_meta, self.tile_bases, self.inst_start,
            vec[:need].contiguous(), self.cells, self.route, tps=self.tps,
            G=self.G, nw=self.nw, GS=self.GS, nt_pad=self.nt_pad, v2=self.v2)

    def apply_multi(self, vec: torch.Tensor, kernel=None) -> torch.Tensor:
        """Y (nr_rows, k) from the k-plane position vector (n_positions,
        k): the multi-plane final, then the spills' k-plane adds."""
        Y = self.grid_multi(vec, kernel)[:self.nr_rows]
        if self.n_spills:
            # in place: Y is a view of this call's own grid
            Y.index_add_(0, self.spill_row, vec[self.spill_pos])
        return Y


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


class FinalMultiDevice(nn.Module):
    """``_FinalLevelMulti`` on the device: y is the sum of one flat final
    per group of <= 8 column blocks, in group order."""

    def __init__(self, final, nr_rows: int, n_positions: int, device):
        super().__init__()
        self.levels = nn.ModuleList(
            FinalDevice(lvl, nr_rows, n_positions, device)
            for lvl in final.levels)

    def apply(self, vec: torch.Tensor, kernel=None) -> torch.Tensor:
        y = None
        for lvl in self.levels:
            yg = lvl.apply(vec, kernel)
            y = yg if y is None else y + yg
        return y


def final_device(final, nr_rows: int, n_positions: int, device):
    """The device module of a host final level."""
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
    legacy final); float64 values make x, every sum and y float64."""

    def __init__(self, packed: GStreamMatrix, device,
                 value_dtype: Optional[torch.dtype] = None, *,
                 values: Optional[np.ndarray] = None, plan=None):
        super().__init__()
        dev = require_device(device)
        self.meta = packed
        self.stream = ForwardStream(packed, dev, value_dtype, values)
        plan = build_finish(packed) if plan is None else plan
        self.plan = plan
        self.flevels = nn.ModuleList(ForwardStream(fp, dev)
                                     for fp in plan.flevels)
        n_positions = packed.chunk_row.size + sum(
            fp.chunk_row.size for fp in plan.flevels)
        self.final = (final_device(plan.final, packed.nr_rows, n_positions,
                                   dev) if plan.final is not None else None)
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

    def finish_vec(self, chunk_sums: torch.Tensor) -> torch.Tensor:
        """chunk partial sums -> y (the on-device accum_results)."""
        vec = self.positions(chunk_sums)
        if self.final is not None:
            return self.final.apply(vec)
        return spmv_chunked(vec[self.chunk_pos], self.chunk_row,
                            self.meta.nr_rows)
