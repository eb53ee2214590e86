"""The TPU's fused-redesign prototypes on the card: the design experiments
``scripts/exp_fused.py`` (#20), ``exp_glw.py`` (#21), ``exp_selfirst.py``
(#24) and ``exp_streams.py`` (#25), their kernels in
``csrc/fused_proto.cu`` (#20, #25) and ``csrc/fused_stages.cu`` (#21 and
#24 through ``fused_stages.tile_forward``).

Phases of ``bench_fused_proto``, each timed back to back (``stream_ms``)
and a call at a time (``call_ms``, ``bench/harness.py``) unless it says:

  proto@24x448        ``fused_proto`` at the script's shape (exp_fused.py:
                      104-122): 24 slabs of 56 super-tiles, OT 64; 24 blocks;
                      ``proto@24x448:workspace`` the same with its scratch in
                      a device-memory workspace, not shared memory
  proto@192x56        the same 10,752 tiles, slots and output rows as 192
                      slabs of 7 super-tiles, OT 8: a grid that fills the card
  glw@<G>             #21's forward at G = 1, 2, 4, 8, 16 window groups
                      (exp_glw.py:44-66): ``tile_forward("full", G)``, 96
                      blocks of 128 tiles; ``glw@12`` is not timed: the
                      reference cannot build it (``_tree_merge`` needs a
                      power of two and raises IndexError)
  spans@<matrix>      host work, not timed: the span histogram of
                      exp_glw.py:75-102 on the pack of the headline and the
                      pdb1HYS, cant, shipsec1 and scircuit stand-ins, the
                      script's (each slot's cell at its own lane) and the
                      routed one (at the lane the kernel reads, ``glw_spans``)
  span-class:<c>@<G>  the headline pack's tiles of one class (narrow: routed
                      span <= 8 groups; wide: the rest), repeated in order up
                      to the pack's tile count, at 16 tiles a block:
                      ``tile_forward("full", G)`` for narrow@16, wide@16 and
                      narrow@8 (the control: the same addresses as narrow@16)
  selfirst@A, @B      #24 (exp_selfirst.py:108-135): ``tile_forward`` full
                      and selfirst at GLW 16, 100 blocks of 128 tiles
  streams@<form>      #25 (exp_streams.py:58-115): ``streams_sum`` with 7
                      input streams, 2, and 2 folding S = 2 or 4 steps a
                      block, at the script's 106 steps; ``streams@<form>:848``
                      at 848 steps (135 MB, past the L2)

``fused_proto`` (and ``proto_launch``, which the phases time) and
``streams_sum`` launch the CUDA kernels for CUDA tensors (or raise) and
run their plain versions (``*_reference``) for CPU tensors; each counts
its launches.  A phase whose bytes fit the card's L2 runs from the L2 back
to back, so it has no HBM bound.

    python -m sparsetpu_torch.bench.fused_proto [--only a,b]
        [--device cuda|cpu] [--small]

``--only`` takes phase names and the groups ``proto``, ``glw``, ``spans``,
``span-class``, ``selfirst`` and ``streams``.
"""

from __future__ import annotations

import collections
import ctypes
import json
import sys

import numpy as np
import torch

from .. import _host
from ..kernels._build import check as check_rc, library
from ..kernels.spmv_fused import card_limits
from ..utils.config import LANES, SUBLANES as CHUNK
from ..utils.device import hbm_gbps, require_device
from . import fused_stages as fs
from .fused_stages import tile_forward
from .harness import call_ms, stream_ms

# -- #20, exp_fused.py ---------------------------------------------------------
# the script's shape (exp_fused.py:104-108) and the same tiles on a grid
# that fills the card; with ``small``, 1/8 of the tiles, the same pairing
PROTO_SHAPES = {"24x448": dict(n_slabs=24, st_tiles=448, GL=16, OT=64),
                "192x56": dict(n_slabs=192, st_tiles=56, GL=16, OT=8)}
PROTO_SMALL = {"3x448": dict(n_slabs=3, st_tiles=448, GL=16, OT=64),
               "24x56": dict(n_slabs=24, st_tiles=56, GL=16, OT=8)}
PROTO_X_ROWS = 784           # exp_fused.py:107, padded to 8 GL rows

# -- #21, exp_glw.py ------------------------------------------------------------
GLW_T, GLW_STEPS, GLW_GX = 128, 96, 104      # exp_glw.py:19-21
GLWS = (1, 2, 4, 8, 12, 16)                  # exp_glw.py:109
GLW_UNBUILT = {12: "not built by the reference (IndexError in "
                   "_tree_merge, which needs a power of two)"}
SPAN_KS = (2, 4, 8, 12, 16)                  # exp_glw.py:100
SPAN_MATRICES = ("headline", "pdb1HYS", "cant", "shipsec1", "scircuit")
NARROW_GROUPS = 8           # a narrow tile's routed span, in window groups
SPAN_CLASS_T = 16           # tiles a block of the span classes

# -- #24, exp_selfirst.py --------------------------------------------------------
SELFIRST_STEPS = 100         # exp_selfirst.py:109

# -- #25, exp_streams.py -------------------------------------------------------
# rows a step (exp_streams.py:21-27): values T*8; the 6 int8 streams i1,
# rt and the 4 finish grids (F1 = 20, F2 = 8 tiles); merged, their sum
STREAM_ROWS_V = 16 * CHUNK
STREAM_ROWS_I8 = (16 * CHUNK, 16 * CHUNK, 20 * CHUNK, 20 * CHUNK,
                  8 * CHUNK, 8 * CHUNK)
STREAM_STEPS = (106, 848)    # the script's (exp_streams.py:23), past the L2
# form -> (input streams, steps folded into a block)
STREAM_FORMS = {"7": (7, 1), "2": (2, 1), "2xS2": (2, 2), "2xS4": (2, 4)}


def _need(name, t, dtype, dev) -> None:
    if t is None or t.dtype != dtype or t.device != dev or \
            not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor on "
                         f"{dev}")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _up(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


# -- #20: the fused prototype ------------------------------------------------------

def _check_proto(tile_base, xw, values, meta, fcell, froute, GL,
                 OT) -> tuple:
    """Dtype, device, contiguity and shape checks of the prototype; returns
    (slabs, super-tiles a slab, xw's groups)."""
    dev = values.device
    for name, t, dt in (("tile_base", tile_base, torch.int32),
                        ("xw", xw, torch.float32),
                        ("values", values, torch.float32),
                        ("meta", meta, torch.int16),
                        ("fcell", fcell, torch.int16),
                        ("froute", froute, torch.int8)):
        _need(name, t, dt, dev)
    if tile_base.dim() != 2 or tile_base.shape[1] < 1:
        raise ValueError("tile_base must be (n_slabs, ST): a base a "
                         "super-tile")
    if GL < 1 or OT < 1:
        raise ValueError(f"unsupported GL={GL} OT={OT}")
    n_slabs, ST = tile_base.shape
    for name, t, rows in (("values", values, n_slabs * ST * 64),
                          ("meta", meta, n_slabs * ST * 64),
                          ("fcell", fcell, n_slabs * OT * CHUNK),
                          ("froute", froute, n_slabs * OT * CHUNK)):
        if tuple(t.shape) != (rows, LANES):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(rows, LANES)}")
    if xw.dim() != 2 or xw.shape[1] != LANES or xw.shape[0] % CHUNK or \
            xw.shape[0] < CHUNK * GL:
        raise ValueError(f"xw must be (8*gx, 128) with gx >= GL={GL}")
    return n_slabs, ST, xw.shape[0] // CHUNK


def check_proto_values(tile_base, xw, values, meta, fcell, froute, *, GL,
                       OT) -> tuple:
    """The prototype's shape and value checks (one device sync): every base
    keeps the GL-group window inside xw, every final cell names a scratch
    row the forward writes (0 <= fcell < 8 ST) and every route a lane;
    returns (slabs, super-tiles a slab, xw's groups)."""
    dims = _check_proto(tile_base, xw, values, meta, fcell, froute, GL, OT)
    n_slabs, ST, gx = dims
    for name, t, lo, hi in (("tile_base", tile_base, 0, gx - GL + 1),
                            ("fcell", fcell, 0, CHUNK * ST),
                            ("froute", froute, 0, LANES)):
        if t.numel() and not (int(t.min()) >= lo and int(t.max()) < hi):
            raise ValueError(f"{name} outside [{lo}, {hi})")
    return dims


def proto_indexes(tile_base, xw, values, meta, fcell, froute, *, GL,
                  OT) -> dict:
    """What each slot of the prototype reads.  ``fwd_idx`` (n_tiles, 8,
    128): the flat index into xw of forward slot (r, l), x row 8 b + c at
    lane j with m = meta & 0x7FFF, j = m[r, l] & 127, c = m[r, j] >> 7 and
    b the super-tile's base clamped into [0, gx - GL]; ``fwd_ok``: c's
    group is inside the window (else the slot reads 0).  ``fin_src``
    (n_slabs*OT, 8, 128): the flat index into the scratch (n_slabs*ST*8,
    128) of final slot (r, l), row c = fcell[r, j] of its slab at lane j =
    froute[r, l] & 127; ``fin_ok``: 0 <= c < 8 ceil(ST / 8), the rows the
    TPU's select reaches (else 0)."""
    dims = _check_proto(tile_base, xw, values, meta, fcell, froute, GL, OT)
    return _indexes(dims, tile_base, meta, fcell, froute, GL, OT)


def _indexes(dims, tile_base, meta, fcell, froute, GL, OT) -> dict:
    n_slabs, ST, gx = dims
    dev = meta.device
    m = meta.view(-1, CHUNK, LANES).long() & 0x7FFF
    j = m & 127
    c = torch.gather(m, 2, j) >> 7
    b = tile_base.clamp(0, gx - GL).long().repeat_interleave(CHUNK)
    fwd_ok = (c >> 3) < GL
    fwd_idx = torch.where(fwd_ok, (CHUNK * b.view(-1, 1, 1) + c) * LANES + j,
                          0)
    fj = froute.view(-1, CHUNK, LANES).long() & 127
    fc = torch.gather(fcell.view(-1, CHUNK, LANES).long(), 2, fj)
    reach = -(-ST // CHUNK) * CHUNK
    fin_ok = (fc >= 0) & (fc < reach)
    slab = torch.arange(n_slabs, device=dev).repeat_interleave(OT)
    fin_src = torch.where(
        fin_ok, (slab.view(-1, 1, 1) * ST * CHUNK + fc) * LANES + fj, 0)
    return dict(fwd_idx=fwd_idx, fwd_ok=fwd_ok, fin_src=fin_src,
                fin_ok=fin_ok)


def _plain(ix, xw, values) -> torch.Tensor:
    x = torch.where(ix["fwd_ok"], xw.reshape(-1)[ix["fwd_idx"]], 0.0)
    scratch = (values.view(x.shape) * x).sum(1)
    cells = torch.where(ix["fin_ok"], scratch.reshape(-1)[ix["fin_src"]],
                        0.0)
    return cells.sum(1)


def fused_proto_reference(tile_base, xw, values, meta, fcell, froute, *,
                          GL: int, OT: int) -> torch.Tensor:
    """Plain PyTorch version of the prototype: (n_slabs*OT, 128) f32, each
    tile row the sum of its 8 sublanes' values times xw at
    ``proto_indexes``, then each out tile the sum of its 8 sublanes' scratch
    cells.  Like the kernel, it reads nothing out of bounds on any input of
    the right shapes."""
    return _plain(proto_indexes(tile_base, xw, values, meta, fcell, froute,
                                GL=GL, OT=OT), xw, values)


def fused_proto(tile_base, xw, values, meta, fcell, froute, *, GL: int,
                OT: int) -> torch.Tensor:
    """#20, the TPU's one-kernel SpMV prototype (exp_fused.py:34-98):
    (n_slabs*OT, 128) f32, one block a slab.  Runs
    ``check_proto_values`` first (a device sync) and raises on a value the
    script cannot draw; ``proto_launch`` is the same without the value
    checks, for a timing loop.

    On CUDA tensors it launches ``csrc/fused_proto.cu`` on the current
    stream (or raises), its scratch in shared memory where ST * 4 KB fits
    the opt-in, else in a device-memory workspace; on CPU tensors it runs
    the plain version.  ``fused_proto.launches`` counts the launches of
    both entry points by scratch (``shared``, ``global``)."""
    dims = check_proto_values(tile_base, xw, values, meta, fcell, froute,
                              GL=GL, OT=OT)
    return _run(dims, tile_base, xw, values, meta, fcell, froute, GL, OT,
                workspace=False)


def proto_launch(tile_base, xw, values, meta, fcell, froute, *, GL: int,
                 OT: int, workspace: bool = False) -> torch.Tensor:
    """``fused_proto`` with the shape checks alone (no sync): the kernel
    reads nothing out of bounds on any values, as it applies the TPU
    kernel's select reach and clamps the base.  ``workspace`` puts the
    scratch in device memory even where it fits shared memory."""
    dims = _check_proto(tile_base, xw, values, meta, fcell, froute, GL, OT)
    return _run(dims, tile_base, xw, values, meta, fcell, froute, GL, OT,
                workspace=workspace)


def _run(dims, tile_base, xw, values, meta, fcell, froute, GL, OT, *,
         workspace) -> torch.Tensor:
    if values.device.type == "cpu":
        return _plain(_indexes(dims, tile_base, meta, fcell, froute, GL, OT),
                      xw, values)
    if values.device.type != "cuda":
        raise ValueError(f"fused_proto: unsupported device {values.device}")
    n_slabs, ST, gx = dims
    smem = ST * CHUNK * LANES * 4
    form = "global" if workspace or smem > card_limits(values.device)[1] \
        else "shared"
    lib = library().lib
    p = ctypes.c_void_p
    with torch.cuda.device(values.device):
        out = torch.empty(n_slabs * OT, LANES, device=values.device)
        ws = (torch.empty(n_slabs * ST * CHUNK, LANES, device=values.device)
              if form == "global" else None)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.fused_proto_launch(
            p(tile_base.data_ptr()), p(xw.data_ptr()), p(values.data_ptr()),
            p(meta.data_ptr()), p(fcell.data_ptr()), p(froute.data_ptr()),
            p(out.data_ptr()), p(ws.data_ptr() if ws is not None else 0),
            n_slabs, ST, GL, OT, gx, p(stream))
    check_rc(lib, rc, "fused_proto launch")
    fused_proto.launches[form] += 1
    return out


fused_proto.launches = collections.Counter()


def fused_proto_inputs(n_slabs: int = 24, st_tiles: int = 448, GL: int = 16,
                       OT: int = 64, x_rows: int = PROTO_X_ROWS,
                       seed: int = 0, device="cuda") -> dict:
    """#20's inputs (exp_fused.py:102-122), from ``default_rng(seed)`` in
    the script's order: values (n_slabs*st_tiles*8, 128) f32, int16 meta
    (cells in [0, 8 GL) << 7 | routes in [0, 128)), fcell in [0, ST) int16
    and froute in [0, 128) int8 (n_slabs*OT*8, 128), a base a super-tile in
    [0, x_rows/8 - GL) (n_slabs, ST) int32, xw (x_rows padded to 8 GL, 128)
    f32.  Keys are ``fused_proto``'s arguments."""
    dev = require_device(device)
    if st_tiles % 8:
        raise ValueError(f"st_tiles={st_tiles}: super-tiles are 8 tiles")
    rng = np.random.default_rng(seed)
    ST = st_tiles // 8
    x_rows = -(-x_rows // (CHUNK * GL)) * (CHUNK * GL)
    rows = n_slabs * st_tiles * CHUNK
    values = rng.standard_normal((rows, LANES))
    cells = rng.integers(0, CHUNK * GL, size=(rows, LANES))
    route = rng.integers(0, LANES, size=(rows, LANES))
    meta = ((cells << 7) | route).astype(np.int16)
    fcell = rng.integers(0, ST, size=(n_slabs * OT * CHUNK, LANES))
    froute = rng.integers(0, LANES, size=(n_slabs * OT * CHUNK, LANES))
    tb = rng.integers(0, max(1, x_rows // CHUNK - GL), size=(n_slabs, ST))
    xw = rng.standard_normal((x_rows, LANES))
    return dict(tile_base=_up(tb, np.int32, dev), xw=_up(xw, np.float32, dev),
                values=_up(values, np.float32, dev),
                meta=_up(meta, np.int16, dev),
                fcell=_up(fcell, np.int16, dev),
                froute=_up(froute, np.int8, dev), GL=GL, OT=OT)


# -- #21: GLW and the tiles' spans -------------------------------------------

def glw_inputs(glw: int, n_steps: int = GLW_STEPS, T: int = GLW_T,
               device="cuda") -> dict:
    """#21's inputs (exp_glw.py:45-56), from ``default_rng(glw)`` in the
    script's order: x2 (104*8, 128) f32, values (n_steps
    T*8, 128) f32, int8 cells in [0, 8 glw), int8 routes in [0, 128), a
    base in [0, 104 - glw) a tile, (n_steps, T) int32.  Keys are
    ``tile_forward``'s tensor arguments."""
    dev = require_device(device)
    rng = np.random.default_rng(glw)
    rows = n_steps * T * CHUNK
    x2 = rng.standard_normal((GLW_GX * CHUNK, LANES))
    values = rng.standard_normal((rows, LANES))
    i1 = rng.integers(0, 8 * glw, (rows, LANES))
    rt = rng.integers(0, LANES, (rows, LANES))
    tb = rng.integers(0, GLW_GX - glw, (n_steps, T))
    return dict(tile_base=_up(tb, np.int32, dev), xw=_up(x2, np.float32, dev),
                values=_up(values, np.float32, dev),
                i1=_up(i1, np.int8, dev), rt=_up(rt, np.int8, dev))


def tile_spans(pack, routed: bool = True) -> np.ndarray:
    """The window groups each tile of a fused pack spans, (n_tiles,) int:
    (the largest cell of its used slots >> 3) + 1 (1 for a tile with
    none), as exp_glw.py:236-240 reconstructs it.  The script reads each
    slot's cell at its own lane; ``routed`` reads it where the kernel does,
    at the lane the slot's route names (i1[s, rt[s, l] & 127])."""
    i1 = pack.meta_i1.reshape(-1, CHUNK, LANES).astype(np.int32)
    used = pack.values.reshape(-1, CHUNK, LANES) != 0
    if routed:
        j = pack.meta_rt.reshape(-1, CHUNK, LANES).astype(np.int64) & 127
        i1 = np.take_along_axis(i1, j, axis=2)
    rel = np.where(used, i1, 0)
    return (rel.max(axis=(1, 2)) >> 3) + 1


def glw_spans(pack) -> dict:
    """exp_glw.py:75-102 on one fused pack: ``script`` the share of tiles
    spanning <= k groups for k in ``SPAN_KS``, as the script computes it,
    ``routed`` the same at the lanes the kernel reads, ``differ`` the tiles
    whose two spans differ."""
    spans = tile_spans(pack, routed=False)
    routed = tile_spans(pack, routed=True)
    return {"tiles": int(spans.size), "fill": float(pack.fill_factor),
            "script": [float((spans <= k).mean()) for k in SPAN_KS],
            "routed": [float((routed <= k).mean()) for k in SPAN_KS],
            "differ": int((spans != routed).sum())}


def span_class_inputs(dev, x2) -> dict:
    """The tiles of a ``FusedDevice`` (P = 1: a tile's 8 sublanes are one
    chunk sum) split by routed span into ``narrow`` (<= ``NARROW_GROUPS``
    groups) and ``wide``, each class's tiles repeated in order up to the
    pack's tile count: {class: (distinct tiles, ``tile_forward``'s tensor
    arguments at ``SPAN_CLASS_T`` tiles a block)}; a class without tiles is
    left out."""
    p = dev.meta
    if p.planes != 1:
        raise ValueError(f"the span classes need P = 1 (a tile a chunk "
                         f"sum), the pack has P = {p.planes}")
    spans = tile_spans(p)
    n = spans.size
    if n % SPAN_CLASS_T:
        raise ValueError(f"{n} tiles do not split into blocks of "
                         f"{SPAN_CLASS_T}")
    out = {}
    for name, idx in (("narrow", np.flatnonzero(spans <= NARROW_GROUPS)),
                      ("wide", np.flatnonzero(spans > NARROW_GROUPS))):
        if not idx.size:
            continue
        sel = torch.from_numpy(np.resize(idx, n)).to(dev.device)

        def pick(t):
            return t.view(-1, CHUNK * LANES)[sel].view(-1, LANES)
        out[name] = (int(idx.size), dict(
            tile_base=dev.tile_base.reshape(-1)[sel].view(
                -1, SPAN_CLASS_T).contiguous(),
            xw=x2, values=pick(dev.values), i1=pick(dev.meta_i1),
            rt=pick(dev.meta_rt)))
    return out


# -- #25: the input streams ---------------------------------------------------

def _check_streams(values, streams, n_steps, fold) -> tuple:
    """The streams' checks; returns (blocks, rows a step of each int8
    stream)."""
    dev = values.device
    _need("values", values, torch.float32, dev)
    if len(streams) not in (1, 6):
        raise ValueError(f"{len(streams)} int8 streams: the kernel takes 6 "
                         f"(the 7-input form) or 1 (the merged form)")
    for q, s in enumerate(streams):
        _need(f"streams[{q}]", s, torch.int8, dev)
    if n_steps < 1 or fold < 1 or n_steps % fold:
        raise ValueError(f"n_steps={n_steps} is not a multiple of "
                         f"fold={fold}")
    rows = []
    for name, t in (("values", values),) + tuple(
            (f"streams[{q}]", s) for q, s in enumerate(streams)):
        if t.dim() != 2 or t.shape[1] != LANES or t.shape[0] % n_steps:
            raise ValueError(f"{name} must be (n_steps*rows, 128), n_steps="
                             f"{n_steps}; it is {tuple(t.shape)}")
        rows.append(t.shape[0] // n_steps)
    return n_steps // fold, rows


def streams_sum_reference(values, streams, *, n_steps: int,
                          fold: int = 1) -> torch.Tensor:
    """Plain PyTorch version of #25's kernels: (n_steps/fold*8, 128) f32,
    each block's column sums of values plus those of each int8 stream (as
    f32), in stream order, on all 8 rows (exp_streams.py:34-55)."""
    nb, _ = _check_streams(values, streams, n_steps, fold)
    total = values.view(nb, -1, LANES).sum(1)
    for s in streams:
        total = total + s.view(nb, -1, LANES).sum(1, dtype=torch.float32)
    return total.repeat_interleave(CHUNK, dim=0)


def streams_sum(values, streams, *, n_steps: int,
                fold: int = 1) -> torch.Tensor:
    """#25: a step's input streams summed and broadcast to 8 rows, one
    block a fold of ``fold`` steps, through 6 int8 streams beside the f32
    values (the 7-input form, exp_streams.py:34) or one merged int8 stream
    (the 2-input form, :51; folded, :102-113).

    On CUDA tensors it launches ``csrc/fused_proto.cu`` (streams_kernel)
    on the current stream (or raises); on CPU tensors it runs
    ``streams_sum_reference``.  ``streams_sum.launches`` counts launches
    by form: ``7``, ``2``, ``2xS2``, ..."""
    if values.device.type == "cpu":
        return streams_sum_reference(values, streams, n_steps=n_steps,
                                     fold=fold)
    if values.device.type != "cuda":
        raise ValueError(f"streams_sum: unsupported device {values.device}")
    nb, rows = _check_streams(values, streams, n_steps, fold)
    lib = library().lib
    p = ctypes.c_void_p
    ptrs = (p * len(streams))(*(s.data_ptr() for s in streams))
    counts = (ctypes.c_int * len(streams))(*rows[1:])
    with torch.cuda.device(values.device):
        out = torch.empty(nb * CHUNK, LANES, device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.streams_launch(
            len(streams), p(values.data_ptr()), rows[0],
            ctypes.cast(ptrs, p), ctypes.cast(counts, p), p(out.data_ptr()),
            nb, fold, p(stream))
    check_rc(lib, rc, "streams_sum launch")
    streams_sum.launches[f"{len(streams) + 1}"
                         + (f"xS{fold}" if fold > 1 else "")] += 1
    return out


streams_sum.launches = collections.Counter()


def streams_inputs(n_steps: int = STREAM_STEPS[0], device="cuda") -> dict:
    """#25's inputs (exp_streams.py:58-65), from ``default_rng(0)`` in the
    script's order: values (n_steps*128, 128) f32, the 6 int8 streams
    (n_steps * rows, 128) for rows in ``STREAM_ROWS_I8``, then the merged
    int8 stream (n_steps*704, 128); the bytes in [0, 100)."""
    dev = require_device(device)
    rng = np.random.default_rng(0)
    values = _up(rng.standard_normal((n_steps * STREAM_ROWS_V, LANES)),
                 np.float32, dev)
    split = [_up(rng.integers(0, 100, (n_steps * r, LANES)), np.int8, dev)
             for r in STREAM_ROWS_I8]
    merged = _up(rng.integers(0, 100, (n_steps * sum(STREAM_ROWS_I8),
                                       LANES)), np.int8, dev)
    return dict(values=values, split=split, merged=merged, n_steps=n_steps)


def stream_args(inp: dict, form: str) -> dict:
    """``streams_sum``'s arguments for one form of ``STREAM_FORMS`` on
    ``streams_inputs``: a fold of S keeps the first n_steps // S * S steps,
    as exp_streams.py:242-251 slices its arrays."""
    n_in, fold = STREAM_FORMS[form]
    n = inp["n_steps"] // fold * fold
    streams = inp["split"] if n_in == 7 else [inp["merged"]]
    return dict(values=inp["values"][:n * STREAM_ROWS_V],
                streams=[s[:n * (s.shape[0] // inp["n_steps"])]
                         for s in streams],
                n_steps=n, fold=fold)


# -- the bench -------------------------------------------------------------------

def proto_shapes(small: bool = False) -> dict:
    """#20's two shapes by label: the script's, then the fine grid."""
    return PROTO_SMALL if small else PROTO_SHAPES


def _wanted(name: str, only) -> bool:
    """A phase runs when ``only`` is None or names it or its group (the
    name up to its ``@`` or ``:``)."""
    return only is None or name in only or \
        name.split("@")[0].split(":")[0] in only


def _tiles_phase(kind, glw, args) -> tuple:
    """(fn, bytes, slots) of ``tile_forward`` on ``args``."""
    streams = [args[k] for k in ("tile_base", "xw", "values", "i1", "rt")]
    n_tiles = args["tile_base"].numel()
    return (lambda: tile_forward(kind, glw, **args),
            _nbytes(*streams) + n_tiles * LANES * 4, n_tiles * CHUNK * LANES)


def _phases(dev, only, small) -> list:
    """(name, fn, bytes, args, extra) of every phase in order.  ``extra``
    maps a result key to a function of the phase's stream_ms; a host
    phase (``spans@``, the skipped ``glw@12``) has no fn and its result as
    ``extra``."""
    phases = []

    def per(n, what):
        return {f"ns_{what}": lambda ms: ms * 1e6 / n}

    def rate(slots):
        return {"gslot_s": lambda ms: slots / (ms * 1e-3) / 1e9}

    for k, (label, cfg) in enumerate(proto_shapes(small).items()):
        names = [f"proto@{label}"] + ([f"proto@{label}:workspace"]
                                      if k == 0 else [])
        names = [n for n in names if _wanted(n, only)]
        if not names:
            continue
        a = fused_proto_inputs(**cfg, device=dev)
        check_proto_values(**a)
        out_bytes = cfg["n_slabs"] * cfg["OT"] * LANES * 4
        nb = _nbytes(*(v for v in a.values() if torch.is_tensor(v)))
        for name in names:
            ws = name.endswith(":workspace")
            phases.append((name,
                           lambda a=a, ws=ws: proto_launch(**a, workspace=ws),
                           nb + out_bytes, a, rate(a["values"].numel())))
    for g in GLWS:
        name = f"glw@{g}"
        if not _wanted(name, only):
            continue
        if g in GLW_UNBUILT:
            phases.append((name, None, 0, None,
                           {"skipped": GLW_UNBUILT[g]}))
            continue
        a = glw_inputs(g, 2 if small else GLW_STEPS, device=dev)
        fn, nb, slots = _tiles_phase("full", g, a)
        phases.append((name, fn, nb, dict(a, kind="full", glw=g),
                       dict(per(a["tile_base"].numel(), "tile"),
                            **rate(slots))))
    want_class = any(_wanted(f"span-class:{c}@16", only)
                     for c in ("narrow", "wide"))
    for mname in SPAN_MATRICES[:1] if small else SPAN_MATRICES:
        name = f"spans@{mname}"
        if not (_wanted(name, only) or (mname == "headline" and want_class)):
            continue
        m, label = fs.stage_matrix(mname, small=small)
        if mname == "headline":
            inp = fs.stage_inputs(m, dev)
            pack = inp["device"].meta
        else:
            pack = _host.pack_fused(m)
        if _wanted(name, only):
            phases.append((name, None, 0, None,
                           dict(glw_spans(pack), matrix=label)))
        if mname == "headline" and want_class:
            classes = span_class_inputs(inp["device"], inp["x2"])
            for c, g in (("narrow", 16), ("wide", 16), ("narrow", 8)):
                name = f"span-class:{c}@{g}"
                if c not in classes or not _wanted(name, only):
                    continue
                n_distinct, a = classes[c]
                fn, nb, slots = _tiles_phase("full", g, a)
                extra = dict(per(a["tile_base"].numel(), "tile"),
                             **rate(slots))
                extra["distinct_tiles"] = lambda ms, n=n_distinct: n
                phases.append((name, fn, nb, dict(a, kind="full", glw=g),
                               extra))
    if any(_wanted(f"selfirst@{v}", only) for v in "AB"):
        lad = fs.tile_ladder_inputs(2 if small else SELFIRST_STEPS,
                                    device=dev)
        for v, kind in (("A", "full"), ("B", "selfirst")):
            name = f"selfirst@{v}"
            if _wanted(name, only):
                fn, nb, slots = _tiles_phase(kind, 16, lad)
                phases.append((name, fn, nb, dict(lad, kind=kind, glw=16),
                               dict(per(lad["tile_base"].numel(), "tile"),
                                    **rate(slots))))
    for k, steps in enumerate((10, 20) if small else STREAM_STEPS):
        names = {f: f"streams@{f}" + (f":{steps}" if k else "")
                 for f in STREAM_FORMS}
        names = {f: n for f, n in names.items() if _wanted(n, only)}
        if not names:
            continue
        inp = streams_inputs(steps, device=dev)
        for form, name in names.items():
            a = stream_args(inp, form)
            nblk = a["n_steps"] // a["fold"]
            nb = _nbytes(a["values"], *a["streams"]) + nblk * CHUNK * \
                LANES * 4
            extra = dict(per(nblk, "step"), **per(a["n_steps"], "substep"))
            phases.append((name, lambda a=a: streams_sum(**a), nb, a, extra))
    return phases


def launch_counts() -> dict:
    """Every launch counter of this bench, by kernel and form."""
    return {**{f"fused_proto:{k}": v for k, v in fused_proto.launches.items()},
            **{f"tile_forward:{k}": v
               for k, v in tile_forward.launches.items()},
            **{f"streams_sum:{k}": v for k, v in streams_sum.launches.items()}}


def bench_fused_proto(*, device="cuda", only=None, small: bool = False,
                      timer=None, verbose: bool = False) -> dict:
    """Time every phase of this module's docstring on ``device`` (with
    ``small``, the shapes cut for a CPU rehearsal).  ``only`` keeps the
    phases it names, by name or group.

    Returns {phase: {stream_ms, call_ms, bytes, bound_ms, l2_resident,
    launches, ...}}: ``bound_ms`` is ``bytes`` (each input read once, each
    output written once) at the card's HBM rate, None on the CPU and where
    ``l2_resident`` (the bytes fit the card's L2); ``launches`` counts
    each kernel's launches during the phase; ``ns_tile``, ``gslot_s``,
    ``ns_step``, ``ns_substep`` where they apply, from ``stream_ms``;
    ``args`` the kernel's arguments, to hold it against its plain version.  ``spans@`` phases
    hold ``glw_spans`` and ``glw@12`` only ``skipped``.  On the CPU the
    phases run the plain versions and ``timer(fn, device) -> ms`` must be
    given (it replaces both clocks): CPU times are not kernel times."""
    dev = require_device(device)
    if timer is None:
        if dev.type != "cuda":
            raise ValueError("bench_fused_proto on the CPU needs a timer: "
                             "CPU times are not kernel times")
        stream_t, call_t = stream_ms, call_ms
    else:
        stream_t = call_t = timer
    phases = _phases(dev, only, small)
    gbps = hbm_gbps(dev) if dev.type == "cuda" else None
    l2 = (torch.cuda.get_device_properties(dev).L2_cache_size
          if dev.type == "cuda" else 0)
    timed = [fn for _, fn, *_ in phases if fn is not None]
    if timed and dev.type == "cuda":
        # warm the card, so that the first phase is not timed at idle clocks
        for _ in range(200):
            timed[0]()
        torch.cuda.synchronize(dev)
    results = {}
    for name, fn, nbytes, args, extra in phases:
        if fn is None:
            results[name] = extra
            if verbose:
                print("  " + describe_phase(name, extra), flush=True)
            continue
        before = launch_counts()
        resident = nbytes <= l2
        r = {"stream_ms": stream_t(fn, dev), "call_ms": call_t(fn, dev),
             "bytes": nbytes, "l2_resident": resident,
             "bound_ms": nbytes / (gbps * 1e9) * 1e3
             if gbps and not resident else None}
        after = launch_counts()
        r["launches"] = {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}
        r.update({k: f(r["stream_ms"]) for k, f in extra.items()})
        r["args"] = args
        results[name] = r
        if verbose:
            print("  " + describe_phase(name, r), flush=True)
    a, b = results.get("span-class:narrow@16"), results.get(
        "span-class:narrow@8")
    if verbose and a and b:
        print(f"  span-class control: narrow at GLW 8 "
              f"{b['stream_ms'] / a['stream_ms'] - 1:+.2%} against GLW 16 "
              f"(the same addresses)", flush=True)
    return results


def describe_phase(name: str, r: dict) -> str:
    """One line of a phase's result."""
    if "skipped" in r:
        return f"{name}: {r['skipped']}"
    if "script" in r:
        ks = "/".join(str(k) for k in SPAN_KS)
        return (f"{name} ({r['matrix']}): tiles={r['tiles']} "
                f"fill={r['fill']:.3f} span<={ks}: script "
                + " ".join(f"{v:.3f}" for v in r["script"]) + ", routed "
                + " ".join(f"{v:.3f}" for v in r["routed"])
                + f"; {r['differ']} tiles differ")
    line = (f"{name:22s} {r['stream_ms']:8.4f} ms back to back "
            f"{r['call_ms']:8.4f} ms a call  {r['bytes'] / 1e6:7.2f} MB")
    if r["bound_ms"]:
        line += f"  {r['bound_ms'] / r['stream_ms']:.3f} of its bound"
    elif r["l2_resident"]:
        line += "  L2-resident (no HBM bound)"
    for k, what in (("ns_tile", "a tile"), ("ns_step", "a step"),
                    ("ns_substep", "a sub-step")):
        if k in r:
            line += f"  {r[k]:.2f} ns {what}"
    if "gslot_s" in r:
        line += f"  {r['gslot_s']:.1f} Gslot/s"
    if "distinct_tiles" in r:
        line += f"  ({r['distinct_tiles']} distinct tiles)"
    return line


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m sparsetpu_torch.bench.fused_proto",
        description="the TPU's fused-redesign prototypes on the card")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases or groups (proto, glw, "
                         "spans, span-class, selfirst, streams, glw@4, ...)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help="shapes cut for a CPU rehearsal")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    if dev.type == "cuda":
        from ..utils.device import card_line
        print(card_line(), flush=True)
        timer = None
    else:
        print("CPU run: plain versions, host clock (not kernel times)",
              flush=True)

        def timer(fn, d):
            return call_ms(fn, d, repeats=3)
    res = bench_fused_proto(device=dev,
                            only=args.only.split(",") if args.only else None,
                            small=args.small, timer=timer, verbose=True)
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "args"}
                      for k, v in res.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
