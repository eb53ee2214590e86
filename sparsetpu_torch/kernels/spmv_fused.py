"""Fused resident-x SpMV and SpMM on the card (counterpart of
``sparsetpu/kernels/spmv_fused.py:337-474``).

``FusedDevice`` holds the fused pack (``sparsetpu/pack/fused.py``, the very
arrays the JAX ``FusedDevice`` uploads) as buffers and runs y = A @ x as one
kernel (``csrc/fused_spmv.cu``), then reassembles y from the per-slab output
blocks and adds the pack's spills; ``spmm`` does the same for Y = A @ X
with one kernel for all k columns (``csrc/fused_spmm.cu``), X, the blocks
and Y row-major.  ``fused_spmv`` and ``fused_spmm`` are the kernels'
wrappers; ``fused_spmv_reference`` and ``fused_spmm_reference`` are the
same functions in plain PyTorch, used for tensors on the CPU and for
comparisons on the card.
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

# (name, dtype) of each kernel input, in the C entry point's order
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
    x2 is the SpMM's X, (GX*8*128, k)."""
    dev = x2.device
    for name, dtype in _KERNEL_INPUTS + (("x2", torch.float32),):
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


def _reference(t: dict, X: torch.Tensor, n_steps: int, F1A: int, F2A: int,
               *, T, GLW, P, F1_max, F2_max, F1S, OBp, n_slabs,
               fin_direct) -> torch.Tensor:
    """The fused kernels' function in plain PyTorch, over all steps and
    planes at once: gather, sum over Q, gather, ``index_add_``.  X is
    row-major (cols, k); returns the slab blocks (n_slabs*OBp*128, k)."""
    dev, k = X.device, X.shape[1]
    SR = T * P
    # forward: slot (s, l) reads X[(8*tile_base + cell(i1[s, j]))*128 + j]
    i1 = t["meta_i1"].view(-1, CHUNK, LANES).long()
    rt = t["meta_rt"].view(-1, CHUNK, LANES).long() & 127
    c = torch.gather(i1, 2, rt)
    xrow = CHUNK * t["tile_base"].reshape(-1, 1, 1).long() + _cell(c, GLW)
    prod = t["values"].view(-1, CHUNK, LANES, 1) * X[xrow * LANES + rt]
    scratch = prod.view(n_steps, SR, CHUNK // P, LANES, k).sum(2)

    def finish(src, rows, stage, F, FA):
        """(n_steps, F, 8, 128, k) cell values a finish stage gathers."""
        i1 = t[f"{stage}_i1"].view(n_steps, FA, CHUNK, LANES)[:, :F].long()
        rt = t[f"{stage}_rt"].view(n_steps, FA, CHUNK, LANES)[:, :F].long() \
            & 127
        c = torch.gather(i1, 3, rt)
        idx = (_cell(c, rows // CHUNK) * LANES + rt).reshape(n_steps, -1, 1)
        got = torch.gather(src.reshape(n_steps, rows * LANES, k), 1,
                           idx.expand(-1, -1, k)).view(*c.shape, k)
        return torch.where((c >= 0).unsqueeze(-1), got,
                           torch.zeros((), device=dev))

    if fin_direct:
        src, rows = scratch, SR
    else:
        src = torch.zeros(n_steps, F1S, LANES, k, device=dev)
        src[:, :F1_max] = finish(scratch, SR, "fin1", F1_max, F1A).sum(2)
        rows = F1S
    add = finish(src, rows, "fin2", F2_max, F2A)
    sub = torch.arange(CHUNK, device=dev).view(1, 1, CHUNK, 1)
    lane = torch.arange(LANES, device=dev).view(1, 1, 1, LANES)
    dest = (t["step_slab"].long().view(-1, 1, 1, 1) * OBp * LANES
            + (CHUNK * t["fin2_group"].long().view(n_steps, F2_max, 1, 1)
               + sub) * LANES + lane)
    out = torch.zeros(n_slabs * OBp * LANES, k, device=dev)
    return out.index_add_(0, dest.reshape(-1), add.reshape(-1, k))


def fused_spmv_reference(values, meta_i1, meta_rt, tile_base, fin1_i1,
                         fin1_rt, fin2_i1, fin2_rt, fin2_group, step_slab,
                         x2, *, T: int, GLW: int, P: int, F1_max: int,
                         F2_max: int, F1S: int, OBp: int, n_slabs: int,
                         fin_direct: int) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, over all steps at once:
    gather, sum over Q, gather, ``index_add_``.  Returns the slab blocks,
    (n_slabs*OBp, 128) f32."""
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
    ``fused_spmv.launches`` counts kernel launches."""
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

    def prepare_x(self, x) -> torch.Tensor:
        """x (nr_cols,) -> the resident layout (GX*8, 128) f32."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
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
