"""Fused resident-x SpMV and SpMM on the card (counterpart of
``sparsetpu/kernels/spmv_fused.py:337-474``), and f64 SpMV on the same
layout (``DF64FusedDevice``, counterpart of ``spmv_fused.py:672-803``).

``FusedDevice`` holds the fused pack (``sparsetpu/pack/fused.py``, the very
arrays the JAX ``FusedDevice`` uploads) with its live finish counts and its
spills' flat positions as buffers, checks them and builds the kernel's
launch plan once, and runs y = A @ x as one launch of
``csrc/fused_spmv.cu`` (the output zeroed in the same call, x read
unpadded, the spills added by the kernel), y a view of the per-slab output
blocks; ``spmm`` does the same for Y = A @ X, one launch of
``csrc/fused_spmm.cu`` for all k columns from the same plan, X unpadded,
the blocks and Y row-major.  ``fused_spmv`` and ``fused_spmm`` are the
kernels' free wrappers (checks and a plan a call); ``fused_spmv_reference``
and ``fused_spmm_reference`` are the same functions in plain PyTorch, used
for tensors on the CPU and for comparisons on the card, and
``FusedDevice.spmv_blocks_reference`` and ``spmm_blocks_reference`` the
device's calls in plain PyTorch.  ``fused_spmv_f64`` is the fused kernel in
native FP64 (the f32 wrapper hands it f64 inputs); its plain version is
``fused_spmv_reference``, which runs in the inputs' real type.

On a card, an f32 ``FusedDevice`` answers ``spmv`` with the rows kernel
(``kernels/fused_rows.py``, ``csrc/fused_rows.cu``: a CSR of the pack's
live slots in y's row order, built at upload) where that map and its
gathers move fewer bytes a call than the pack (``FusedDevice.traffic``);
``FusedDevice.kernel`` names the choice.  The blocks, the SpMM and the free wrappers run #1.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from .. import _host
from ..utils.device import CUDA, pick_device
from ..utils.timing import SETUP, span
from ._build import check, library, vector_width
from .fused_rows import FusedRows, fused_rows_spmv

LANES = _host.LANES
CHUNK = _host.CHUNK
STRIPE = _host.STRIPE
# the JAX package's SpMM budget (a TPU VMEM figure,
# ``sparsetpu/kernels/spmv_fused.py:279``): the CPU routes by it
SPMM_PLANE_BYTES_MAX = 12 << 20
# the JAX package's f64 column limit (``spmv_fused.py:485``): above it the
# f64 matrix goes to the classic f64 device, as there
MAX_RESIDENT_COLS_DF64 = 700_000
# the bytes an L2 sector holds: what one scattered 4-byte gather moves
SECTOR = 32

# (name, dtype) of each kernel input, in the C entry point's order; the
# values are float64 on the f64 device
_KERNEL_INPUTS = (
    ("values", torch.float32), ("meta_i1", torch.int8),
    ("meta_rt", torch.int8), ("tile_base", torch.int32),
    ("fin1_i1", torch.int8), ("fin1_rt", torch.int8),
    ("fin2_i1", torch.int8), ("fin2_rt", torch.int8),
    ("fin2_group", torch.int32), ("step_slab", torch.int32),
)


def _cell(c: torch.Tensor, groups: int) -> torch.Tensor:
    """Scratch row of cell ``c`` as the TPU kernel's select tree reads it
    (group bits masked to the part count)."""
    return ((c >> 3) & (groups - 1)) * CHUNK + (c & 7)


def _check_inputs(t: dict, x2: torch.Tensor, *, T, GLW, P, F1_max, F2_max,
                  F1S, GX=None) -> tuple:
    """Dtype, device, contiguity and shape checks shared by the kernels and
    their plain versions; returns (n_steps, F1A, F2A).  With ``GX`` given,
    x2 is the SpMM's X, (GX*8*128, k).  The values and x2 are both f32, or
    both f64."""
    dev = x2.device
    real = torch.float64 if t["values"].dtype == torch.float64 \
        else torch.float32
    for name, dtype in _KERNEL_INPUTS[1:] + (("values", real), ("x2", real)):
        a = x2 if name == "x2" else t[name]
        if a.dtype != dtype or a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor "
                             f"on {dev}, got {a.dtype} on {a.device}")
    n_steps = t["tile_base"].shape[0]
    rows = n_steps * T * CHUNK
    # the cell decode masks a chunk-sum row's group to a power of two
    # (T*P/8 groups), as the TPU kernel's select tree does
    SR = T * P
    if P not in (1, 2, 4, 8) or SR < CHUNK or SR > 128 or SR & (SR - 1) \
            or GLW & (GLW - 1):
        raise ValueError(f"unsupported layout T={T} P={P} GLW={GLW}")
    if F1S < F1_max or F1S % CHUNK:
        raise ValueError(f"F1S={F1S} does not hold F1_max={F1_max}")
    for name in ("values", "meta_i1", "meta_rt"):
        if tuple(t[name].shape) != (rows, LANES):
            raise ValueError(f"{name} has shape {tuple(t[name].shape)}, "
                             f"expected {(rows, LANES)}")
    if tuple(t["tile_base"].shape) != (n_steps, T):
        raise ValueError("tile_base must be (n_steps, T)")
    alloc = []
    for stage, fm in (("fin1", F1_max), ("fin2", F2_max)):
        a, b = t[f"{stage}_i1"], t[f"{stage}_rt"]
        if a.shape != b.shape or a.dim() != 2 or a.shape[1] != LANES or \
                (n_steps and a.shape[0] % (n_steps * CHUNK)):
            raise ValueError(f"{stage} streams must be (n_steps*F*8, 128)")
        fa = a.shape[0] // (n_steps * CHUNK) if n_steps else fm
        if fa < fm:
            raise ValueError(f"{stage} allocates {fa} tiles per step < {fm}")
        alloc.append(fa)
    if tuple(t["fin2_group"].shape) != (n_steps, F2_max):
        raise ValueError("fin2_group must be (n_steps, F2_max)")
    if tuple(t["step_slab"].shape) != (n_steps,):
        raise ValueError("step_slab must be (n_steps,)")
    if GX is not None:
        if x2.dim() != 2 or x2.shape[0] != GX * CHUNK * STRIPE or \
                x2.shape[1] < 1:
            raise ValueError(f"X must be ({GX * CHUNK * STRIPE}, k), got "
                             f"{tuple(x2.shape)}")
    elif x2.dim() != 2 or x2.shape[1] != LANES:
        raise ValueError("x2 must be (GX*8, 128)")
    return n_steps, alloc[0], alloc[1]


def _named(*inputs) -> dict:
    """The kernel inputs, in ``_KERNEL_INPUTS`` order, by name."""
    return dict(zip((name for name, _ in _KERNEL_INPUTS), inputs))


def forward_gather_index(t: dict, GLW: int) -> torch.Tensor:
    """The x element each slot of the fused kernels' forward reads: slot (s,
    l) of tile t reads x2[(8*tile_base + cell(i1[s, j], GLW))*128 + j], j =
    rt[s, l] & 127.  ``t`` holds meta_i1, meta_rt and tile_base.  Returns
    the flat index into x2 (rows of 128), (n_tiles, 8, 128)."""
    i1 = t["meta_i1"].view(-1, CHUNK, LANES).long()
    rt = t["meta_rt"].view(-1, CHUNK, LANES).long() & 127
    c = torch.gather(i1, 2, rt)
    xrow = CHUNK * t["tile_base"].reshape(-1, 1, 1).long() + _cell(c, GLW)
    return xrow * LANES + rt


def forward_sums(t: dict, X: torch.Tensor, n_steps: int, *, T, GLW,
                 P) -> torch.Tensor:
    """The fused kernels' forward in plain PyTorch, over all steps and
    planes at once: each slot reads X at ``forward_gather_index`` and each
    chunk's Q sublanes sum.  ``t`` holds the values, meta_i1, meta_rt and
    tile_base; X is row-major (cols, k).  Returns the chunk sums (n_steps,
    T*P, 128, k), in X's real type."""
    k = X.shape[1]
    prod = t["values"].view(-1, CHUNK, LANES, 1) * X[forward_gather_index(
        t, GLW)]
    return prod.view(n_steps, T * P, CHUNK // P, LANES, k).sum(2)


def finish_gather_index(t: dict, n_steps: int, rows: int, stage: str, F: int,
                        FA: int) -> tuple:
    """The source element each cell of finish stage ``stage`` (fin1 or fin2)
    reads: (flat index into a step's (rows*128) source, reads a value), both
    (n_steps, F, 8, 128); a drained cell (c < 0) reads nothing."""
    i1 = t[f"{stage}_i1"].view(n_steps, FA, CHUNK, LANES)[:, :F].long()
    rt = t[f"{stage}_rt"].view(n_steps, FA, CHUNK, LANES)[:, :F].long() & 127
    c = torch.gather(i1, 3, rt)
    return _cell(c, rows // CHUNK) * LANES + rt, c >= 0


def _finish_gather(t: dict, src: torch.Tensor, n_steps: int, rows: int,
                   stage: str, F: int, FA: int,
                   cnt: torch.Tensor = None) -> torch.Tensor:
    """(n_steps, F, 8, 128, k) cell values finish stage ``stage`` (fin1 or
    fin2) gathers from ``src`` (n_steps, rows, 128, k); drained cells, and
    with ``cnt`` (n_steps,) the tiles at or past a step's live count, read
    0."""
    k = src.shape[-1]
    idx, ok = finish_gather_index(t, n_steps, rows, stage, F, FA)
    if cnt is not None:
        live = torch.arange(F, device=src.device) < cnt.view(-1, 1).long()
        ok = ok & live.view(n_steps, F, 1, 1)
    got = torch.gather(src.reshape(n_steps, rows * LANES, k), 1,
                       idx.reshape(n_steps, -1, 1).expand(-1, -1, k))
    return torch.where(ok.unsqueeze(-1), got.view(*idx.shape, k),
                       torch.zeros((), dtype=src.dtype, device=src.device))


def stage1_partials(t: dict, scratch: torch.Tensor, n_steps: int, F1A: int,
                    *, F1_max, F1S, cnt=None) -> torch.Tensor:
    """The fused kernels' finish stage 1 in plain PyTorch: each row's chunk
    sums in ``scratch`` (``forward_sums``' output) collapse to one partial.
    ``t`` holds fin1_i1 and fin1_rt; ``cnt`` (n_steps,), where given, the
    live tiles a step.  Returns (n_steps, F1S, 128, k), rows past the live
    tiles zero."""
    n, rows, _, k = scratch.shape
    src = torch.zeros(n, F1S, LANES, k, dtype=scratch.dtype,
                      device=scratch.device)
    src[:, :F1_max] = _finish_gather(t, scratch, n_steps, rows, "fin1",
                                     F1_max, F1A, cnt).sum(2)
    return src


def _reference(t: dict, X: torch.Tensor, n_steps: int, F1A: int, F2A: int,
               *, T, GLW, P, F1_max, F2_max, F1S, OBp, n_slabs,
               fin_direct, counts=None) -> torch.Tensor:
    """The fused kernels' function in plain PyTorch, over all steps and
    planes at once: gather, sum over Q, gather, ``index_add_``.  X is
    row-major (cols, k); ``counts``, where given, the live finish tiles a
    step (fin1_cnt, fin2_cnt).  Returns the slab blocks (n_slabs*OBp*128,
    k), in X's real type."""
    dev, k, real = X.device, X.shape[1], X.dtype
    cnt1, cnt2 = counts or (None, None)
    scratch = forward_sums(t, X, n_steps, T=T, GLW=GLW, P=P)
    if fin_direct:
        src, rows = scratch, T * P
    else:
        src = stage1_partials(t, scratch, n_steps, F1A, F1_max=F1_max,
                              F1S=F1S, cnt=cnt1)
        rows = F1S
    add = _finish_gather(t, src, n_steps, rows, "fin2", F2_max, F2A, cnt2)
    sub = torch.arange(CHUNK, device=dev).view(1, 1, CHUNK, 1)
    lane = torch.arange(LANES, device=dev).view(1, 1, 1, LANES)
    dest = (t["step_slab"].long().view(-1, 1, 1, 1) * OBp * LANES
            + (CHUNK * t["fin2_group"].long().view(n_steps, F2_max, 1, 1)
               + sub) * LANES + lane)
    out = torch.zeros(n_slabs * OBp * LANES, k, dtype=real, device=dev)
    return out.index_add_(0, dest.reshape(-1), add.reshape(-1, k))


def fused_spmv_reference(values, meta_i1, meta_rt, tile_base, fin1_i1,
                         fin1_rt, fin2_i1, fin2_rt, fin2_group, step_slab,
                         x2, *, T: int, GLW: int, P: int, F1_max: int,
                         F2_max: int, F1S: int, OBp: int, n_slabs: int,
                         fin_direct: int) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, over all steps at once:
    gather, sum over Q, gather, ``index_add_``.  Returns the slab blocks,
    (n_slabs*OBp, 128), f32 (f64 for f64 values and x2)."""
    t = _named(values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt,
               fin2_i1, fin2_rt, fin2_group, step_slab)
    kw = dict(T=T, GLW=GLW, P=P, F1_max=F1_max, F2_max=F2_max, F1S=F1S)
    n_steps, F1A, F2A = _check_inputs(t, x2, **kw)
    return _reference(t, x2.reshape(-1, 1), n_steps, F1A, F2A, OBp=OBp,
                      n_slabs=n_slabs, fin_direct=fin_direct,
                      **kw).view(n_slabs * OBp, LANES)


# -- the kernel's launch: a plan built once, then a call ----------------------

# the streams the Tensor Memory Accelerator copies (the metadata) or
# prefetches (the values): their addresses must be multiples of 16 B
_STAGED = ("values", "meta_i1", "meta_rt", "fin1_i1", "fin1_rt", "fin2_i1",
           "fin2_rt")
_PLAN_INTS = ("n_steps", "T", "GLW", "P", "F1_max", "F2_max", "F1A", "F2A",
              "F1S", "OBp", "fin_direct", "n_spills", "f64", "device")


_PLAN_POINTERS = ("values", "meta_i1", "meta_rt", "tile_base", "fin1_i1",
                  "fin1_rt", "fin2_i1", "fin2_rt", "fin2_group", "step_slab",
                  "fin1_cnt", "fin2_cnt", "spill_pos", "spill_col",
                  "spill_val")


class _Plan(ctypes.Structure):
    """``struct FusedPlan`` of ``csrc/fused_spmv.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in _PLAN_POINTERS]
                + [("n_out", ctypes.c_longlong)]
                + [(name, ctypes.c_int) for name in _PLAN_INTS])


def _plan(t: dict, dims: dict, *, n_out: int, counts=None,
          spills=None) -> _Plan:
    """A prepared plan over the CUDA tensors ``t`` (by name) and layout
    ``dims``: the live counts (fin1_cnt, fin2_cnt) or None (F1_max/F2_max),
    the spills (flat positions, columns, values) or None.  The tensors must
    outlive the plan."""
    for name in _STAGED:
        if t[name].data_ptr() % 16:
            raise ValueError(f"{name}: the kernel's bulk copies need a "
                             f"16-byte aligned address")
    p = _Plan()
    for name, _ in _KERNEL_INPUTS:
        setattr(p, name, t[name].data_ptr())
    if counts is not None:
        p.fin1_cnt, p.fin2_cnt = (c.data_ptr() for c in counts)
    if spills is not None:
        p.spill_pos, p.spill_col, p.spill_val = (
            a.data_ptr() for a in spills)
        p.n_spills = spills[0].numel()
    for name, value in dims.items():
        setattr(p, name, value)
    p.n_out = n_out
    p.f64 = int(t["values"].dtype == torch.float64)
    p.device = t["values"].device.index
    lib = library().lib
    check(lib, lib.fused_spmv_prepare(ctypes.addressof(p)),
          "fused_spmv prepare")
    if not p.f64:
        check(lib, lib.fused_spmm_prepare(ctypes.addressof(p)),
              "fused_spmm prepare")
    return p


def _run(p: _Plan, x: torch.Tensor, out: torch.Tensor) -> None:
    """One call of a plan on the current stream of x's device: a
    workspace of this call's own (the chunk sums and scratch2 of every
    step; the caching allocator orders it on the stream), ``out`` zeroed
    and the kernel launched on x."""
    lib = library().lib
    ws = torch.empty(p.n_steps * (p.T * p.P + p.F1S) * LANES,
                     dtype=out.dtype, device=out.device)
    check(lib, lib.fused_spmv_run(
        ctypes.addressof(p), x.data_ptr(), x.numel(), out.data_ptr(),
        ws.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream),
        "fused_spmv launch")


def _run_multi(p: _Plan, X: torch.Tensor, out: torch.Tensor) -> None:
    """One SpMM call of a plan on the current stream of X's device: X
    (rows, k) row-major, ``out`` (n_out, k) zeroed and the kernel launched
    with the widest plane vector k and the buffers take; the chunk sums
    and stage-1 partials of every step in a workspace of this call's own
    (the caching allocator orders it on the stream)."""
    lib = library().lib
    k = X.shape[1]
    ws = torch.empty(p.n_steps * (p.T * p.P + p.F1S) * LANES * k,
                     dtype=torch.float32, device=X.device)
    check(lib, lib.fused_spmm_run(
        ctypes.addressof(p), X.data_ptr(), X.shape[0], k,
        vector_width(k, X, out, ws), out.data_ptr(), ws.data_ptr(),
        torch.cuda.current_stream(X.device).cuda_stream),
        "fused_spmm launch")


def _launch_free(t: dict, x2: torch.Tensor, *, T, GLW, P, F1_max, F2_max,
                 F1S, OBp, n_slabs, fin_direct) -> torch.Tensor:
    """Check the free wrappers' CUDA inputs, plan and launch the kernel
    once: no live counts (every step to F1_max/F2_max), no spills, x2
    padded."""
    n_steps, F1A, F2A = _check_inputs(t, x2, T=T, GLW=GLW, P=P,
                                      F1_max=F1_max, F2_max=F2_max, F1S=F1S)
    with torch.cuda.device(x2.device):
        out = torch.empty(n_slabs * OBp, LANES, dtype=x2.dtype,
                          device=x2.device)
        dims = dict(n_steps=n_steps, T=T, GLW=GLW, P=P, F1_max=F1_max,
                    F2_max=F2_max, F1A=F1A, F2A=F2A, F1S=F1S, OBp=OBp,
                    fin_direct=fin_direct)
        _run(_plan(t, dims, n_out=out.numel()), x2, out)
    return out


def fused_spmv(values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt,
               fin2_i1, fin2_rt, fin2_group, step_slab, x2, *, T: int,
               GLW: int, P: int, F1_max: int, F2_max: int, F1S: int,
               OBp: int, n_slabs: int, fin_direct: int) -> torch.Tensor:
    """The fused kernel: slab blocks (n_slabs*OBp, 128) f32 of y = A @ x.

    On CUDA tensors it checks its inputs, plans and launches
    ``csrc/fused_spmv.cu`` on the current stream (or raises); on CPU
    tensors it runs ``fused_spmv_reference``.  ``fused_spmv.launches``
    counts kernel launches, the devices' too.  f64 values go to
    ``fused_spmv_f64``.  A ``sparsetpu.launch.fused_spmv`` span a call."""
    kw = dict(T=T, GLW=GLW, P=P, F1_max=F1_max, F2_max=F2_max, F1S=F1S,
              OBp=OBp, n_slabs=n_slabs, fin_direct=fin_direct)
    args = (values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt, fin2_i1,
            fin2_rt, fin2_group, step_slab, x2)
    if values.dtype == torch.float64:
        return fused_spmv_f64(*args, **kw)
    with span("launch.fused_spmv"):
        if x2.device.type == "cpu":
            return fused_spmv_reference(*args, **kw)
        if x2.device.type != "cuda":
            raise ValueError(f"fused_spmv: unsupported device {x2.device}")
        out = _launch_free(_named(*args[:-1]), x2, **kw)
        fused_spmv.launches += 1
        return out


fused_spmv.launches = 0


def fused_spmv_f64(values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt,
                   fin2_i1, fin2_rt, fin2_group, step_slab, x2, *, T: int,
                   GLW: int, P: int, F1_max: int, F2_max: int, F1S: int,
                   OBp: int, n_slabs: int, fin_direct: int) -> torch.Tensor:
    """The fused kernel in native FP64: slab blocks (n_slabs*OBp, 128) f64
    of y = A @ x, for f64 values and x2.

    On CUDA tensors it checks its inputs, plans and launches the f64 form
    of ``csrc/fused_spmv.cu`` on the current stream (or raises); on CPU
    tensors it runs ``fused_spmv_reference``.
    ``fused_spmv_f64.launches`` counts kernel launches, the devices'
    too.  A ``sparsetpu.launch.fused_spmv_f64`` span a call."""
    kw = dict(T=T, GLW=GLW, P=P, F1_max=F1_max, F2_max=F2_max, F1S=F1S,
              OBp=OBp, n_slabs=n_slabs, fin_direct=fin_direct)
    if values.dtype != torch.float64:
        raise ValueError("fused_spmv_f64 takes float64 values and x2")
    with span("launch.fused_spmv_f64"):
        if x2.device.type == "cpu":
            return fused_spmv_reference(values, meta_i1, meta_rt, tile_base,
                                        fin1_i1, fin1_rt, fin2_i1, fin2_rt,
                                        fin2_group, step_slab, x2, **kw)
        if x2.device.type != "cuda":
            raise ValueError(f"fused_spmv_f64: unsupported device "
                             f"{x2.device}")
        out = _launch_free(_named(values, meta_i1, meta_rt, tile_base,
                                  fin1_i1, fin1_rt, fin2_i1, fin2_rt,
                                  fin2_group, step_slab), x2, **kw)
        fused_spmv_f64.launches += 1
        return out


fused_spmv_f64.launches = 0


def card_limits(device: torch.device) -> tuple:
    """(L2 cache bytes, shared memory bytes a block may opt in to) of a
    CUDA device."""
    props = torch.cuda.get_device_properties(device)
    return props.L2_cache_size, props.shared_memory_per_block_optin


def fused_spmm_reference(values, meta_i1, meta_rt, tile_base, fin1_i1,
                         fin1_rt, fin2_i1, fin2_rt, fin2_group, step_slab,
                         X, *, T: int, GLW: int, P: int, F1_max: int,
                         F2_max: int, F1S: int, OBp: int, n_slabs: int,
                         fin_direct: int, GX: int) -> torch.Tensor:
    """Plain PyTorch version of the fused SpMM kernel, over all steps and
    planes at once.  X is row-major (GX*8*128, k); returns the slab blocks
    (n_slabs*OBp*128, k) f32."""
    t = _named(values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt,
               fin2_i1, fin2_rt, fin2_group, step_slab)
    kw = dict(T=T, GLW=GLW, P=P, F1_max=F1_max, F2_max=F2_max, F1S=F1S)
    n_steps, F1A, F2A = _check_inputs(t, X, GX=GX, **kw)
    return _reference(t, X, n_steps, F1A, F2A, OBp=OBp, n_slabs=n_slabs,
                      fin_direct=fin_direct, **kw)


def fused_spmm(values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt,
               fin2_i1, fin2_rt, fin2_group, step_slab, X, *, T: int,
               GLW: int, P: int, F1_max: int, F2_max: int, F1S: int,
               OBp: int, n_slabs: int, fin_direct: int,
               GX: int) -> torch.Tensor:
    """The fused SpMM kernel: slab blocks (n_slabs*OBp*128, k) f32 of
    Y = A @ X, X row-major (GX*8*128, k).

    On CUDA tensors it checks its inputs, plans and launches
    ``csrc/fused_spmm.cu`` on the current stream (or raises): no live
    counts, no spills; on CPU tensors it runs ``fused_spmm_reference``.
    ``fused_spmm.launches`` counts kernel launches, the devices' too.  A
    ``sparsetpu.launch.fused_spmm`` span a call."""
    kw = dict(T=T, GLW=GLW, P=P, F1_max=F1_max, F2_max=F2_max, F1S=F1S)
    if values.dtype == torch.float64:
        raise ValueError("fused_spmm: there is no f64 SpMM kernel (the f64 "
                         "device runs one fused SpMV a column)")
    with span("launch.fused_spmm"):
        if X.device.type == "cpu":
            return fused_spmm_reference(
                values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt,
                fin2_i1, fin2_rt, fin2_group, step_slab, X, OBp=OBp,
                n_slabs=n_slabs, fin_direct=fin_direct, GX=GX, **kw)
        if X.device.type != "cuda":
            raise ValueError(f"fused_spmm: unsupported device {X.device}")
        t = _named(values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt,
                   fin2_i1, fin2_rt, fin2_group, step_slab)
        n_steps, F1A, F2A = _check_inputs(t, X, GX=GX, **kw)
        with torch.cuda.device(X.device):
            out = torch.empty(n_slabs * OBp * LANES, X.shape[1],
                              device=X.device)
            dims = dict(n_steps=n_steps, F1A=F1A, F2A=F2A, OBp=OBp,
                        fin_direct=fin_direct, **kw)
            _run_multi(_plan(t, dims, n_out=out.shape[0]), X, out)
        fused_spmm.launches += 1
        return out


fused_spmm.launches = 0


def slabs_uniform(m) -> bool:
    """True when every slab but the last spans exactly OBp*128 rows from
    row 0: the blocks are then y in row order and y is one slice."""
    sb = m.slab_bounds
    ob = m.OBp * LANES
    if int(sb[0]) != 0:
        return False
    deltas = np.diff(sb)
    return bool(np.all(deltas[:-1] == ob) and deltas[-1] <= ob)


def _check_pack(p) -> None:
    """Host-side bounds the kernel relies on for in-buffer addresses."""
    tb = p.tile_base
    if tb.size and (tb.min() < 0 or tb.max() > p.GX - p.GLW):
        raise ValueError("tile_base outside the resident x window")
    g = p.fin2_group
    if g.size and (g.min() < 0 or g.max() >= p.OBp // CHUNK):
        raise ValueError("fin2_group outside the slab's out block")
    ss = p.step_slab
    if ss.size and (ss.min() < 0 or ss.max() >= p.n_slabs):
        raise ValueError("step_slab outside the slab range")
    for name, fm in (("fin1_cnt", p.F1_max), ("fin2_cnt", p.F2_max)):
        c = np.asarray(getattr(p, name))
        if c.shape != (p.n_steps,) or (c.size and (c.min() < 0
                                                   or c.max() > fm)):
            raise ValueError(f"{name} must be (n_steps,) in [0, {fm}]")
    sb = np.asarray(p.slab_bounds, np.int64)
    if int(sb[-1]) - int(sb[0]) != p.nr_rows:
        raise ValueError("slab bounds do not cover the rows")
    if np.any(np.diff(sb) < 0) or np.any(np.diff(sb) > p.OBp * LANES):
        raise ValueError("a slab spans more rows than its out block")
    n = p.spill_row.shape[0]
    if n and (p.spill_row.min() < 0 or p.spill_row.max() >= p.nr_rows
              or p.spill_col.min() < 0
              or p.spill_col.max() >= p.GX * CHUNK * STRIPE):
        raise ValueError("spill indices out of range")


def pick_kernel(traffic: dict) -> str:
    """The kernel of an f32 device's ``spmv`` on a card, from its
    ``FusedDevice.traffic``: ``"rows"`` where the row map and its gathers
    move fewer bytes a call than the pack, else ``"tiles"``."""
    return "rows" if traffic["rows"] < traffic["tiles"] else "tiles"


def spill_positions(p) -> np.ndarray:
    """Each spill's flat position in the slab blocks (int64): y's row r
    lies in the slab s whose rows hold it, at s*OBp*128 + r - (slab_bounds[s]
    - slab_bounds[0]); exact for non-uniform slabs too (``_rows`` reads
    the blocks back in that order)."""
    sb = np.asarray(p.slab_bounds, np.int64)
    sb = sb - sb[0]
    rows = np.asarray(p.spill_row, np.int64)
    s = np.searchsorted(sb, rows, side="right") - 1
    return s * p.OBp * LANES + rows - sb[s]


class FusedDevice(nn.Module):
    """A fused pack held on one device; ``spmv`` is y = A @ x in one
    kernel launch.  ``FusedDevice(packed)`` uploads a ``FusedMatrix`` (from
    either package's ``pack_fused``), as the JAX constructor does
    (``spmv_fused.py:354``); ``interpret=True`` keeps it on the CPU for the
    plain versions (``utils/device.py:pick_device``).

    The buffers are checked once, here; on a card the kernel's launch plan
    (every buffer's address, the layout, the spills' flat positions) is
    built once too, so a call checks only x, allocates y's blocks and the
    kernel's workspace, and launches.  The upload is ``SETUP``'s phase
    ``upload``; a call opens ``sparsetpu.device.spmv`` and, around the
    checks and the launch, ``sparsetpu.launch.<kernel>``.

    ``kernel`` names what ``spmv`` runs: ``"rows"``, the rows kernel over
    ``rows`` (a ``FusedRows`` map built here), where the device is a card,
    the values are f32 and the map and its gathers move fewer bytes a call
    than the pack (``traffic``); else ``"tiles"``, #1 (``rows`` is then None).  CPU
    tensors keep #1's plain version, so CPU routes agree with the JAX
    package's; ``spmv_blocks``, ``blocks`` and the SpMM run #1 always."""

    @SETUP.phase("upload")
    def __init__(self, packed, interpret=False, *, device=CUDA):
        super().__init__()
        _check_pack(packed)
        self._setup(packed, self._upload(
            packed, pick_device(device, interpret),
            np.asarray(packed.values, np.float32),
            np.asarray(packed.spill_val, np.float32)))

    def _setup(self, meta, buffers: dict) -> None:
        """Hold the checked pack's ``buffers`` (``_upload``) and build the
        launch plan: the one path of every constructor."""
        self.meta = meta            # the host pack: layout scalars, bounds
        self.uniform_slabs = slabs_uniform(meta)
        self.n_spills = int(meta.spill_row.shape[0])
        for name, tensor in buffers.items():
            self.register_buffer(name, tensor)
        self._kernel = fused_spmv_f64 if self.dtype == torch.float64 \
            else fused_spmv
        self._launch_span = "launch." + self._kernel.__name__
        self._plan = self._dims = None
        self.rows = None
        self._build_plan()

    @staticmethod
    def _upload(packed, dev, values, spill_val) -> dict:
        """The buffers of a checked pack on ``dev``: the kernel inputs (with
        ``values``), the live counts and, where the pack spills, the spills'
        flat positions, columns and values (``spill_val``)."""
        def up(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        buffers = {name: up(getattr(packed, name), dtype)
                   for name, dtype in _KERNEL_INPUTS if name != "values"}
        buffers["values"] = up(values)
        buffers["fin1_cnt"] = up(packed.fin1_cnt, torch.int32)
        buffers["fin2_cnt"] = up(packed.fin2_cnt, torch.int32)
        if packed.spill_row.shape[0]:
            buffers["spill_pos"] = up(spill_positions(packed))
            buffers["spill_col"] = up(packed.spill_col, torch.int64)
            buffers["spill_val"] = up(spill_val)
        return buffers

    @classmethod
    def from_packed(cls, packed, device) -> "FusedDevice":
        """``FusedDevice(packed, device=device)``."""
        return cls(packed, device=device)

    def _build_plan(self) -> None:
        """Check the buffers and, on a card, build the launch plan."""
        m = self.meta
        t = {name: getattr(self, name) for name, _ in _KERNEL_INPUTS}
        x2 = torch.empty(m.GX * CHUNK, LANES, dtype=self.dtype,
                         device=self.device)
        n_steps, F1A, F2A = _check_inputs(
            t, x2, T=m.T, GLW=m.GLW, P=m.planes, F1_max=m.F1_max,
            F2_max=m.F2_max, F1S=m.F1S)
        self._dims = dict(n_steps=n_steps, T=m.T, GLW=m.GLW, P=m.planes,
                          F1_max=m.F1_max, F2_max=m.F2_max, F1A=F1A,
                          F2A=F2A, F1S=m.F1S, OBp=m.OBp,
                          fin_direct=m.fin_direct)
        if self.device.type != "cuda":
            self.kernel, self.rows = "tiles", None
            return
        spills = ((self.spill_pos, self.spill_col, self.spill_val)
                  if self.n_spills else None)
        self._plan = _plan(t, self._dims, n_out=m.n_slabs * m.OBp * LANES,
                           counts=(self.fin1_cnt, self.fin2_cnt),
                           spills=spills)
        self.kernel = "tiles"
        if self.dtype == torch.float32:
            self.kernel = pick_kernel(self.traffic())
        if self.kernel == "tiles":
            self.rows = None
        elif self.rows is None:     # a move (``_apply``) moves the map too
            self.rows = FusedRows.build(self)

    def traffic(self) -> dict:
        """The bytes a call moves on each layout, from counts the device
        holds.  ``tiles``, #1 over the pack: a value and two metadata
        bytes a forward slot; 2 B a live finish slot (``fin1_cnt``,
        ``fin2_cnt``); the chunk sums and stage-1 partials written to the
        workspace and read back; the slab blocks zeroed and written; a
        spill's position, column and value.  Its gathers read each tile's
        window of x, which the pack keeps small, through L1.  ``rows``,
        the rows kernel over ``FusedRows``: a column and a value a live
        slot (a nonzero value or a spill), a row pointer and a y element a
        row, and the 32-byte sector of x that each live slot's gather
        moves from the L2 (the map's order keeps no window)."""
        m, d = self.meta, self._dims
        elt = self.values.element_size()
        tile = CHUNK * LANES
        fin = int(self.fin2_cnt.sum()) + (
            0 if m.fin_direct else int(self.fin1_cnt.sum()))
        ws = d["n_steps"] * (m.T * m.planes
                             + (0 if m.fin_direct else m.F1S)) * LANES
        tiles = ((elt + 2) * d["n_steps"] * m.T * tile + 2 * fin * tile
                 + 2 * elt * (ws + m.n_slabs * m.OBp * LANES)
                 + (16 + elt) * self.n_spills)
        live = int((self.values != 0).sum()) + self.n_spills
        return {"tiles": tiles,
                "rows": (4 + elt) * (live + m.nr_rows) + SECTOR * live}

    def _apply(self, *args, **kwargs):
        # moving the buffers moves the addresses the plan holds
        out = super()._apply(*args, **kwargs)
        self._build_plan()
        return out

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def prepare_x(self, x) -> torch.Tensor:
        """x (nr_cols,) -> the resident layout (GX*8, 128) in the values'
        type (f32, or f64 on the f64 device)."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if tuple(x.shape) != (self.meta.nr_cols,):
            raise ValueError(
                f"x has shape {tuple(x.shape)}, expected "
                f"({self.meta.nr_cols},)")
        pad = self.meta.GX * CHUNK * STRIPE - self.meta.nr_cols
        return nn.functional.pad(x, (0, pad)).view(-1, STRIPE)

    def blocks(self, x2: torch.Tensor, kernel=None) -> torch.Tensor:
        """The slab blocks for a prepared x, without the spills, through
        ``kernel`` (default the wrapper ``fused_spmv``;
        ``fused_spmv_reference`` to compare)."""
        m = self.meta
        return (kernel or fused_spmv)(
            *(getattr(self, name) for name, _ in _KERNEL_INPUTS), x2,
            T=m.T, GLW=m.GLW, P=m.planes, F1_max=m.F1_max,
            F2_max=m.F2_max, F1S=m.F1S, OBp=m.OBp, n_slabs=m.n_slabs,
            fin_direct=m.fin_direct)

    def _rows(self, flat: torch.Tensor) -> torch.Tensor:
        """y's rows of the flat slab blocks: one slice when the slabs are
        uniform, else one slice a slab."""
        m = self.meta
        sb = m.slab_bounds
        if self.uniform_slabs:
            return flat[:int(sb[-1])]
        ob = m.OBp * LANES
        return torch.cat([flat[s * ob:s * ob + int(sb[s + 1] - sb[s])]
                          for s in range(m.n_slabs)])

    def _x(self, x, x_is_packed: bool, multi: bool = False) -> torch.Tensor:
        """x checked for a call: a tensor must already have the device's
        real type and device (anything else is converted); (nr_cols,), or
        (GX*8, 128) when ``x_is_packed``; with ``multi``, X of (nr_cols,
        k), or (GX*1024, k) when ``x_is_packed``."""
        m = self.meta
        if isinstance(x, torch.Tensor):
            if x.dtype != self.dtype or x.device != self.device:
                raise ValueError(f"x must be a {self.dtype} tensor on "
                                 f"{self.device}, got {x.dtype} on "
                                 f"{x.device}")
        else:
            x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if multi:
            rows = m.GX * CHUNK * STRIPE if x_is_packed else m.nr_cols
            ok = x.dim() == 2 and x.shape[0] == rows and x.shape[1] >= 1
            want = f"({rows}, k)"
        else:
            want = (m.GX * CHUNK, STRIPE) if x_is_packed else (m.nr_cols,)
            ok = tuple(x.shape) == want
        if not ok:
            raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                             f"{want}")
        return x if x.is_contiguous() else x.contiguous()

    def spmv_blocks(self, x, x_is_packed: bool = False) -> torch.Tensor:
        """The flat slab blocks (n_slabs*OBp*128,) of y = A @ x, spills
        included: on a card one launch of the plan (the output zeroed in
        it), on the CPU ``spmv_blocks_reference``."""
        with span(self._launch_span):
            x = self._x(x, x_is_packed)
            if x.device.type == "cpu":
                return self.spmv_blocks_reference(x)
            out = torch.empty(self.meta.n_slabs * self.meta.OBp * LANES,
                              dtype=self.dtype, device=self.device)
            _run(self._plan, x, out)
            self._kernel.launches += 1
            return out

    def spmv_blocks_reference(self, x: torch.Tensor) -> torch.Tensor:
        """``spmv_blocks`` in plain PyTorch: x (any length up to the padded
        columns) read as zero past its end, the finish loops cut to the
        live counts, the spills added at their flat positions."""
        return self.spmm_blocks_reference(x.reshape(-1, 1)).view(-1)

    def spmm_blocks_reference(self, X: torch.Tensor) -> torch.Tensor:
        """``spmm_blocks`` in plain PyTorch: X (rows up to the padded
        columns, k) read as zero past its last row, the finish loops cut to
        the live counts, the spills' k planes added at their flat
        positions.  Returns (n_slabs*OBp*128, k)."""
        Xp = nn.functional.pad(
            X, (0, 0, 0, self.meta.GX * CHUNK * STRIPE - X.shape[0]))
        t = {name: getattr(self, name) for name, _ in _KERNEL_INPUTS}
        d = self._dims
        flat = _reference(
            t, Xp, d["n_steps"], d["F1A"], d["F2A"], T=d["T"],
            GLW=d["GLW"], P=d["P"], F1_max=d["F1_max"], F2_max=d["F2_max"],
            F1S=d["F1S"], OBp=d["OBp"], n_slabs=self.meta.n_slabs,
            fin_direct=d["fin_direct"],
            counts=(self.fin1_cnt, self.fin2_cnt))
        if self.n_spills:
            flat.index_add_(0, self.spill_pos,
                            self.spill_val[:, None] * Xp[self.spill_col])
        return flat

    def spmv(self, x, x_is_packed: bool = False) -> torch.Tensor:
        """y = A @ x (nr_rows,): x unpadded, or prepared (``prepare_x``)
        with ``x_is_packed``.  On a ``"rows"`` device y is the rows
        kernel's output; else a view of the slab blocks when the slabs
        are uniform."""
        with span("device.spmv"):
            if self.kernel == "rows":
                return fused_rows_spmv(self._x(x, x_is_packed).view(-1),
                                       self.rows)
            return self._rows(self.spmv_blocks(x, x_is_packed))

    def launch(self, x2: torch.Tensor) -> torch.Tensor:
        """The kernel ``spmv`` runs, alone, on a prepared x: the rows
        kernel's y on a ``"rows"`` device, else #1's slab blocks without
        the spills (``blocks``)."""
        if self.kernel == "rows":
            return fused_rows_spmv(x2.view(-1), self.rows)
        return self.blocks(x2)

    @property
    def bytes_a_call(self) -> int:
        """The bytes of the layout ``spmv`` streams: the row map's
        (``FusedRows.nbytes``) on a ``"rows"`` device, else the pack's."""
        if self.kernel == "rows":
            return self.rows.nbytes
        return self.meta.storage_bytes()

    # -- SpMM (counterpart of sparsetpu/kernels/spmv_fused.py:423-474) ------
    def spmm_applicable(self, k: int) -> bool:
        """True when the fused SpMM kernel takes k planes.  On a card: the k
        X planes fit half the L2 (X stays resident, as in VMEM on the TPU;
        the scratch lives in a workspace, so shared memory sets no limit).
        On the CPU: the JAX package's VMEM budget, so routes agree with
        it."""
        m = self.meta
        if k < 1:
            return False
        if self.device.type == "cuda":
            l2, _ = card_limits(self.device)
            return k * m.padded_cols * 4 <= l2 // 2
        plane = m.padded_cols + (m.T * m.planes + m.F1S + m.OBp) * LANES
        return k * plane * 4 <= SPMM_PLANE_BYTES_MAX

    def prepare_x_multi(self, X) -> torch.Tensor:
        """X (nr_cols, k) -> the resident layout: row-major
        (padded_cols, k) f32, zero rows past nr_cols."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        if X.dim() != 2 or X.shape[0] != self.meta.nr_cols:
            raise ValueError(f"X has shape {tuple(X.shape)}, expected "
                             f"({self.meta.nr_cols}, k)")
        pad = self.meta.GX * CHUNK * STRIPE - self.meta.nr_cols
        return nn.functional.pad(X, (0, 0, 0, pad)).contiguous()

    def blocks_multi(self, X: torch.Tensor, kernel=None) -> torch.Tensor:
        """The slab blocks (n_slabs*OBp*128, k) for a prepared X, through
        ``kernel`` (default the wrapper ``fused_spmm``;
        ``fused_spmm_reference`` to compare)."""
        m = self.meta
        return (kernel or fused_spmm)(
            *(getattr(self, name) for name, _ in _KERNEL_INPUTS), X,
            T=m.T, GLW=m.GLW, P=m.planes, F1_max=m.F1_max,
            F2_max=m.F2_max, F1S=m.F1S, OBp=m.OBp, n_slabs=m.n_slabs,
            fin_direct=m.fin_direct, GX=m.GX)

    def spmm_blocks(self, X, x_is_packed: bool = False) -> torch.Tensor:
        """The flat slab blocks (n_slabs*OBp*128, k) of Y = A @ X, spills
        included: on a card one launch of the plan (the output zeroed in
        it), on the CPU ``spmm_blocks_reference``."""
        with span("launch.fused_spmm"):
            X = self._x(X, x_is_packed, multi=True)
            if X.device.type == "cpu":
                return self.spmm_blocks_reference(X)
            out = torch.empty(self.meta.n_slabs * self.meta.OBp * LANES,
                              X.shape[1], device=self.device)
            _run_multi(self._plan, X, out)
            fused_spmm.launches += 1
            return out

    def spmm(self, X, x_is_packed: bool = False) -> torch.Tensor:
        """Y = A @ X, (nr_rows, k): X unpadded, or prepared
        (``prepare_x_multi``) with ``x_is_packed``; one launch for all k
        planes and the spills, y's rows sliced out."""
        return self._rows(self.spmm_blocks(X, x_is_packed))


# -- f64 (DOUBLE=1) on the fused layout ---------------------------------------

def _check_planes(packed_hi, packed_lo) -> None:
    """The hi and lo packs must share every metadata array: the pack
    engine is value-agnostic (``spmv_fused.py:682-686`` checks the same)."""
    for name in ("meta_i1", "meta_rt", "tile_base", "fin1_i1", "fin1_rt",
                 "fin2_i1", "fin2_rt", "fin2_group", "step_slab",
                 "slab_bounds", "spill_row", "spill_col"):
        if not np.array_equal(getattr(packed_hi, name),
                              getattr(packed_lo, name)):
            raise ValueError(f"hi/lo fused packs diverged ({name}): the pack "
                             f"engine must be value-agnostic")
    if packed_hi.values.shape != packed_lo.values.shape:
        raise ValueError("hi/lo fused packs diverged (values shape)")


@SETUP.phase("pack")
def _fused_df64_packs(matrix, **kw):
    """The fused packs (hi, lo) of an f64 CSR matrix, the hi and lo value
    planes packed as two f32 packs with the same Q/GLW/T
    (``spmv_fused.py:781-803``); None when the layout does not apply: more
    than ``MAX_RESIDENT_COLS_DF64`` columns, or either pack is None.
    Raises ``ValueError`` if the two packs' metadata diverge."""
    from .f64emu import split_planes      # f64emu imports this module
    if matrix.nr_cols > MAX_RESIDENT_COLS_DF64:
        return None
    m_hi, m_lo = split_planes(matrix)
    ph = _host.pack_fused(m_hi, **kw)
    if ph is None:
        return None
    pl = _host.pack_fused(m_lo, Q=ph.Q, GLW=ph.GLW, T=ph.T, **{
        k: v for k, v in kw.items() if k not in ("Q", "GLW", "T")})
    if pl is None:
        return None
    _check_planes(ph, pl)
    return ph, pl


def pack_fused_df64(matrix, interpret=False, *, device=CUDA, **kw):
    """A ``DF64FusedDevice`` for an f64 CSR matrix on ``device``, or None
    where the fused layout does not apply (the JAX package's,
    ``spmv_fused.py:781-803``; callers then take ``DF64GStreamDevice``).
    ``kw`` goes to ``pack_fused`` (``Q``, ``GLW``, ...)."""
    dev = pick_device(device, interpret)
    packs = _fused_df64_packs(matrix, **kw)
    return None if packs is None else DF64FusedDevice(*packs, device=dev)


class DF64FusedDevice(FusedDevice):
    """f64 SpMV on the fused layout (counterpart of the JAX package's
    ``DF64FusedDevice``, ``spmv_fused.py:672-778``).  The JAX device keeps
    two f32 value planes and (hi, lo) x planes because the TPU has no
    usable FP64; here the planes are joined at upload into one float64
    value plane, x stays float64, and the kernel (``fused_spmv_f64``)
    computes in native FP64.  ``spmv`` returns a float64 y; the spills are
    added by the kernel, every one (the JAX device's ``set`` keeps one
    spill per row: ROADMAP Queue 3).  ``DF64FusedDevice(packed_hi,
    packed_lo)`` uploads the (hi, lo) ``FusedMatrix`` pair (from either
    package's ``pack_fused``), as the JAX constructor does
    (``spmv_fused.py:679``): the metadata once, the values and the spill
    values as hi + lo in float64 (padded slots are 0 in both)."""

    @SETUP.phase("upload")
    def __init__(self, packed_hi, packed_lo, interpret=False, *,
                 device=CUDA):
        from .f64emu import join_f64          # f64emu imports this module
        nn.Module.__init__(self)
        _check_planes(packed_hi, packed_lo)
        _check_pack(packed_hi)
        self._setup(packed_hi, self._upload(
            packed_hi, pick_device(device, interpret),
            join_f64(packed_hi.values, packed_lo.values),
            join_f64(packed_hi.spill_val, packed_lo.spill_val)))

    @classmethod
    def from_packed(cls, packed_hi, packed_lo, device) -> "DF64FusedDevice":
        """``DF64FusedDevice(packed_hi, packed_lo, device=device)``."""
        return cls(packed_hi, packed_lo, device=device)

    def spmv_f64(self, x) -> torch.Tensor:
        """y = A @ x, float64, on this device: ``spmv`` of x as float64
        (the JAX device's ``spmv_f64``, ``spmv_fused.py:775``, joins its
        (hi, lo) y; here y is float64 already)."""
        return self.spmv(torch.as_tensor(x, dtype=torch.float64,
                                         device=self.device))

    def spmm_applicable(self, k: int) -> bool:
        """No k-plane f64 kernel: ``spmm`` runs one SpMV a column."""
        return False

    def spmm(self, X, x_is_packed: bool = False) -> torch.Tensor:
        """Y = A @ X (nr_rows, k) float64: one fused f64 SpMV a column, as
        the JAX package's ``spmm_df64`` does on this device
        (``f64emu.py:396-412``)."""
        if x_is_packed:
            raise ValueError("DF64FusedDevice.spmm takes X unpacked")
        X = torch.as_tensor(X, dtype=torch.float64, device=self.device)
        if X.dim() != 2 or X.shape[0] != self.meta.nr_cols:
            raise ValueError(f"X has shape {tuple(X.shape)}, expected "
                             f"({self.meta.nr_cols}, k)")
        cols = X.t().contiguous()
        return torch.stack([self.spmv(c) for c in cols], dim=1)
