"""Fused resident-x SpMV and SpMM on the card (counterpart of
``sparsetpu/kernels/spmv_fused.py:337-474``), and f64 SpMV on the same
layout (``DF64FusedDevice``, counterpart of ``spmv_fused.py:672-803``).

``FusedDevice`` holds the fused pack (``sparsetpu/pack/fused.py``, the very
arrays the JAX ``FusedDevice`` uploads) as buffers and runs y = A @ x as one
kernel (``csrc/fused_spmv.cu``), then reassembles y from the per-slab output
blocks and adds the pack's spills; ``spmm`` does the same for Y = A @ X
with one kernel for all k columns (``csrc/fused_spmm.cu``), X, the blocks
and Y row-major.  ``fused_spmv`` and ``fused_spmm`` are the kernels'
wrappers; ``fused_spmv_reference`` and ``fused_spmm_reference`` are the
same functions in plain PyTorch, used for tensors on the CPU and for
comparisons on the card.  ``fused_spmv_f64`` is the fused kernel in native
FP64 (the f32 wrapper hands it f64 inputs); its plain version is
``fused_spmv_reference``, which runs in the inputs' real type.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from .. import _host
from ..utils.device import require_device
from ._build import check, library

LANES = _host.LANES
CHUNK = _host.CHUNK
STRIPE = _host.STRIPE
# the JAX package's SpMM budget (a TPU VMEM figure,
# ``sparsetpu/kernels/spmv_fused.py:279``): the CPU routes by it
SPMM_PLANE_BYTES_MAX = 12 << 20
# the JAX package's f64 column limit (``spmv_fused.py:485``): above it the
# f64 matrix goes to the classic f64 device, as there
MAX_RESIDENT_COLS_DF64 = 700_000

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
    if P not in (1, 2, 4, 8) or T * P > 128 or GLW & (GLW - 1):
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
                   stage: str, F: int, FA: int) -> torch.Tensor:
    """(n_steps, F, 8, 128, k) cell values finish stage ``stage`` (fin1 or
    fin2) gathers from ``src`` (n_steps, rows, 128, k); drained cells read
    0."""
    k = src.shape[-1]
    idx, ok = finish_gather_index(t, n_steps, rows, stage, F, FA)
    got = torch.gather(src.reshape(n_steps, rows * LANES, k), 1,
                       idx.reshape(n_steps, -1, 1).expand(-1, -1, k))
    return torch.where(ok.unsqueeze(-1), got.view(*idx.shape, k),
                       torch.zeros((), dtype=src.dtype, device=src.device))


def stage1_partials(t: dict, scratch: torch.Tensor, n_steps: int, F1A: int,
                    *, F1_max, F1S) -> torch.Tensor:
    """The fused kernels' finish stage 1 in plain PyTorch: each row's chunk
    sums in ``scratch`` (``forward_sums``' output) collapse to one partial.
    ``t`` holds fin1_i1 and fin1_rt.  Returns (n_steps, F1S, 128, k), rows
    past F1_max zero."""
    n, rows, _, k = scratch.shape
    src = torch.zeros(n, F1S, LANES, k, dtype=scratch.dtype,
                      device=scratch.device)
    src[:, :F1_max] = _finish_gather(t, scratch, n_steps, rows, "fin1",
                                     F1_max, F1A).sum(2)
    return src


def _reference(t: dict, X: torch.Tensor, n_steps: int, F1A: int, F2A: int,
               *, T, GLW, P, F1_max, F2_max, F1S, OBp, n_slabs,
               fin_direct) -> torch.Tensor:
    """The fused kernels' function in plain PyTorch, over all steps and
    planes at once: gather, sum over Q, gather, ``index_add_``.  X is
    row-major (cols, k); returns the slab blocks (n_slabs*OBp*128, k), in
    X's real type."""
    dev, k, real = X.device, X.shape[1], X.dtype
    scratch = forward_sums(t, X, n_steps, T=T, GLW=GLW, P=P)
    if fin_direct:
        src, rows = scratch, T * P
    else:
        src = stage1_partials(t, scratch, n_steps, F1A, F1_max=F1_max,
                              F1S=F1S)
        rows = F1S
    add = _finish_gather(t, src, n_steps, rows, "fin2", F2_max, F2A)
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


def fused_spmv(values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt,
               fin2_i1, fin2_rt, fin2_group, step_slab, x2, *, T: int,
               GLW: int, P: int, F1_max: int, F2_max: int, F1S: int,
               OBp: int, n_slabs: int, fin_direct: int) -> torch.Tensor:
    """The fused kernel: slab blocks (n_slabs*OBp, 128) f32 of y = A @ x.

    On CUDA tensors it launches ``csrc/fused_spmv.cu`` on the current
    stream (or raises); on CPU tensors it runs ``fused_spmv_reference``.
    ``fused_spmv.launches`` counts kernel launches.  f64 values go to
    ``fused_spmv_f64``."""
    if values.dtype == torch.float64:
        return fused_spmv_f64(
            values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt, fin2_i1,
            fin2_rt, fin2_group, step_slab, x2, T=T, GLW=GLW, P=P,
            F1_max=F1_max, F2_max=F2_max, F1S=F1S, OBp=OBp,
            n_slabs=n_slabs, fin_direct=fin_direct)
    if x2.device.type == "cpu":
        return fused_spmv_reference(
            values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt, fin2_i1,
            fin2_rt, fin2_group, step_slab, x2, T=T, GLW=GLW, P=P,
            F1_max=F1_max, F2_max=F2_max, F1S=F1S, OBp=OBp,
            n_slabs=n_slabs, fin_direct=fin_direct)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_spmv: unsupported device {x2.device}")
    t = _named(values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt,
               fin2_i1, fin2_rt, fin2_group, step_slab)
    n_steps, F1A, F2A = _check_inputs(t, x2, T=T, GLW=GLW, P=P,
                                      F1_max=F1_max, F2_max=F2_max, F1S=F1S)
    lib = library().lib
    with torch.cuda.device(x2.device):
        out = torch.zeros(n_slabs * OBp, LANES, device=x2.device)
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.fused_spmv_launch(
            *(ctypes.c_void_p(t[name].data_ptr())
              for name, _ in _KERNEL_INPUTS),
            ctypes.c_void_p(x2.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n_steps, T, GLW, P, F1_max, F2_max, F1A, F2A, F1S, OBp,
            fin_direct, ctypes.c_void_p(stream))
    check(lib, rc, "fused_spmv launch")
    fused_spmv.launches += 1
    return out


fused_spmv.launches = 0


def f64_scratch_fits(T: int, P: int, F1S: int, fin_direct: int,
                     device: torch.device) -> bool:
    """True when the f64 kernel's two scratch planes, (T*P + F1S) x 128
    doubles (T*P alone with fin_direct), fit the shared memory a block of
    ``device`` may opt in to; else scratch2 goes to a global workspace."""
    need = (T * P + (0 if fin_direct else F1S)) * LANES * 8
    return need <= card_limits(device)[1]


def _fused_spmv_f64_launch(t: dict, x2: torch.Tensor, *, workspace: bool,
                           T, GLW, P, F1_max, F2_max, F1S, OBp, n_slabs,
                           fin_direct) -> torch.Tensor:
    """Launch the f64 kernel on f64 CUDA inputs ``t`` (by name) and x2,
    with scratch2 in a global workspace when ``workspace``."""
    n_steps, F1A, F2A = _check_inputs(t, x2, T=T, GLW=GLW, P=P,
                                      F1_max=F1_max, F2_max=F2_max, F1S=F1S)
    lib = library().lib
    with torch.cuda.device(x2.device):
        out = torch.zeros(n_slabs * OBp, LANES, dtype=torch.float64,
                          device=x2.device)
        ws = (torch.empty(max(n_steps, 1) * F1S * LANES, dtype=torch.float64,
                          device=x2.device)
              if workspace and not fin_direct else None)
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.fused_spmv_f64_launch(
            *(ctypes.c_void_p(t[name].data_ptr())
              for name, _ in _KERNEL_INPUTS),
            ctypes.c_void_p(x2.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(ws.data_ptr() if ws is not None else 0),
            n_steps, T, GLW, P, F1_max, F2_max, F1A, F2A, F1S, OBp,
            fin_direct, ctypes.c_void_p(stream))
    check(lib, rc, "fused_spmv_f64 launch")
    fused_spmv_f64.launches += 1
    return out


def fused_spmv_f64(values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt,
                   fin2_i1, fin2_rt, fin2_group, step_slab, x2, *, T: int,
                   GLW: int, P: int, F1_max: int, F2_max: int, F1S: int,
                   OBp: int, n_slabs: int, fin_direct: int) -> torch.Tensor:
    """The fused kernel in native FP64: slab blocks (n_slabs*OBp, 128) f64
    of y = A @ x, for f64 values and x2.

    On CUDA tensors it launches the f64 form of ``csrc/fused_spmv.cu`` (or
    raises), with scratch2 in shared memory where the card's opt-in holds
    both scratch planes and in a global workspace where it does not; on CPU
    tensors it runs ``fused_spmv_reference``.  ``fused_spmv_f64.launches``
    counts kernel launches."""
    kw = dict(T=T, GLW=GLW, P=P, F1_max=F1_max, F2_max=F2_max, F1S=F1S,
              OBp=OBp, n_slabs=n_slabs, fin_direct=fin_direct)
    if values.dtype != torch.float64:
        raise ValueError("fused_spmv_f64 takes float64 values and x2")
    if x2.device.type == "cpu":
        return fused_spmv_reference(values, meta_i1, meta_rt, tile_base,
                                    fin1_i1, fin1_rt, fin2_i1, fin2_rt,
                                    fin2_group, step_slab, x2, **kw)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_spmv_f64: unsupported device {x2.device}")
    t = _named(values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt,
               fin2_i1, fin2_rt, fin2_group, step_slab)
    fits = f64_scratch_fits(T, P, F1S, fin_direct, x2.device)
    return _fused_spmv_f64_launch(t, x2, workspace=not fits, **kw)


fused_spmv_f64.launches = 0


def card_limits(device: torch.device) -> tuple:
    """(L2 cache bytes, shared memory bytes a block may opt in to) of a
    CUDA device: the two limits of the fused SpMM kernel."""
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

    On CUDA tensors it launches ``csrc/fused_spmm.cu`` on the current
    stream (or raises), with as many planes a block as the card's opt-in
    shared memory holds; on CPU tensors it runs ``fused_spmm_reference``.
    ``fused_spmm.launches`` counts kernel launches."""
    kw = dict(T=T, GLW=GLW, P=P, F1_max=F1_max, F2_max=F2_max, F1S=F1S)
    if values.dtype == torch.float64:
        raise ValueError("fused_spmm: there is no f64 SpMM kernel (the f64 "
                         "device runs one fused SpMV a column)")
    if X.device.type == "cpu":
        return fused_spmm_reference(
            values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt, fin2_i1,
            fin2_rt, fin2_group, step_slab, X, OBp=OBp, n_slabs=n_slabs,
            fin_direct=fin_direct, GX=GX, **kw)
    if X.device.type != "cuda":
        raise ValueError(f"fused_spmm: unsupported device {X.device}")
    t = _named(values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt,
               fin2_i1, fin2_rt, fin2_group, step_slab)
    n_steps, F1A, F2A = _check_inputs(t, X, GX=GX, **kw)
    k = X.shape[1]
    plane = (T * P + (0 if fin_direct else F1S)) * LANES * 4
    _, smem = card_limits(X.device)
    if plane > smem:
        raise ValueError(f"fused_spmm: one plane's scratch ({plane} B) "
                         f"exceeds the {smem} B a block may use")
    kg = min(k, smem // plane)
    lib = library().lib
    with torch.cuda.device(X.device):
        out = torch.zeros(n_slabs * OBp * LANES, k, device=X.device)
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.fused_spmm_launch(
            *(ctypes.c_void_p(t[name].data_ptr())
              for name, _ in _KERNEL_INPUTS),
            ctypes.c_void_p(X.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n_steps, T, GLW, P, F1_max, F2_max, F1A, F2A, F1S, OBp,
            fin_direct, k, kg, ctypes.c_void_p(stream))
    check(lib, rc, "fused_spmm launch")
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
    if int(p.slab_bounds[-1]) - int(p.slab_bounds[0]) != p.nr_rows:
        raise ValueError("slab bounds do not cover the rows")
    n = p.spill_row.shape[0]
    if n and (p.spill_row.min() < 0 or p.spill_row.max() >= p.nr_rows
              or p.spill_col.min() < 0
              or p.spill_col.max() >= p.GX * CHUNK * STRIPE):
        raise ValueError("spill indices out of range")


class FusedDevice(nn.Module):
    """A fused pack held on one device; ``spmv`` is y = A @ x in one
    kernel pass.  Build it with ``FusedDevice.from_packed``."""

    def __init__(self, meta, buffers: dict):
        super().__init__()
        self.meta = meta            # the host pack: layout scalars, bounds
        self.uniform_slabs = slabs_uniform(meta)
        self.n_spills = int(meta.spill_row.shape[0])
        for name, tensor in buffers.items():
            self.register_buffer(name, tensor)

    @classmethod
    def from_packed(cls, packed, device) -> "FusedDevice":
        """Upload a ``FusedMatrix`` (from either package's ``pack_fused``)
        to ``device``."""
        dev = require_device(device)
        _check_pack(packed)

        def up(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device=dev, dtype=dtype)

        buffers = {name: up(getattr(packed, name), dtype)
                   for name, dtype in _KERNEL_INPUTS}
        if packed.spill_row.shape[0]:
            buffers["spill_row"] = up(packed.spill_row, torch.int64)
            buffers["spill_col"] = up(packed.spill_col, torch.int64)
            buffers["spill_val"] = up(packed.spill_val, torch.float32)
        return cls(packed, buffers)

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
        """The slab blocks for a prepared x, through ``kernel`` (default
        the wrapper ``fused_spmv``; ``fused_spmv_reference`` to compare)."""
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

    def spmv(self, x, x_is_packed: bool = False) -> torch.Tensor:
        x2 = x if x_is_packed else self.prepare_x(x)
        y = self._rows(self.blocks(x2).view(-1))
        if self.n_spills:
            # in place: y is this call's own output
            y.index_add_(0, self.spill_row,
                         self.spill_val * x2.reshape(-1)[self.spill_col])
        return y

    # -- SpMM (counterpart of sparsetpu/kernels/spmv_fused.py:423-474) ------
    def spmm_applicable(self, k: int) -> bool:
        """True when the fused SpMM kernel takes k planes.  On a card: the k
        X planes fit half the L2 (x stays resident, as in VMEM on the TPU)
        and one plane's scratch fits a block's opt-in shared memory.  On the
        CPU: the JAX package's VMEM budget, so routes agree with it."""
        m = self.meta
        if k < 1:
            return False
        if self.device.type == "cuda":
            l2, smem = card_limits(self.device)
            scratch = (m.T * m.planes + m.F1S) * LANES * 4
            return k * m.padded_cols * 4 <= l2 // 2 and scratch <= smem
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

    def spmm(self, X, x_is_packed: bool = False) -> torch.Tensor:
        """Y = A @ X, (nr_rows, k): one kernel for all k planes, y's rows
        sliced out, then the spills' k-plane scatter-add."""
        Xp = X if x_is_packed else self.prepare_x_multi(X)
        Y = self._rows(self.blocks_multi(Xp))
        if self.n_spills:
            # in place: Y is this call's own output
            Y.index_add_(0, self.spill_row,
                         self.spill_val[:, None] * Xp[self.spill_col])
        return Y


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


def pack_fused_df64(matrix, **kw):
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


class DF64FusedDevice(FusedDevice):
    """f64 SpMV on the fused layout (counterpart of the JAX package's
    ``DF64FusedDevice``, ``spmv_fused.py:672-778``).  The JAX device keeps
    two f32 value planes and (hi, lo) x planes because the TPU has no
    usable FP64; here the planes are joined at upload into one float64
    value plane, x stays float64, and the kernel (``fused_spmv_f64``)
    computes in native FP64.  ``spmv`` returns a float64 y; the spills are
    added with ``index_add_`` (the JAX device's ``set`` keeps one spill
    per row: ROADMAP Queue 3).  Build it with ``from_packed``."""

    @classmethod
    def from_packed(cls, packed_hi, packed_lo, device) -> "DF64FusedDevice":
        """Upload the (hi, lo) ``FusedMatrix`` pair (from either package's
        ``pack_fused``) to ``device``: the metadata once, the values and
        the spill values as hi + lo in float64 (padded slots are 0 in
        both)."""
        from .f64emu import join_f64          # f64emu imports this module
        dev = require_device(device)
        _check_planes(packed_hi, packed_lo)
        _check_pack(packed_hi)

        def up(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        buffers = {name: up(getattr(packed_hi, name), dtype)
                   for name, dtype in _KERNEL_INPUTS}
        buffers["values"] = up(join_f64(packed_hi.values, packed_lo.values))
        if packed_hi.spill_row.shape[0]:
            buffers["spill_row"] = up(packed_hi.spill_row, torch.int64)
            buffers["spill_col"] = up(packed_hi.spill_col, torch.int64)
            buffers["spill_val"] = up(join_f64(packed_hi.spill_val,
                                               packed_lo.spill_val))
        return cls(packed_hi, buffers)

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
        return torch.stack([self.spmv(X[:, j]) for j in range(X.shape[1])],
                           dim=1)
