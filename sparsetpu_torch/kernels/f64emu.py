"""f64 (DOUBLE=1) SpMV and SpMM on the card (counterpart of
``sparsetpu/kernels/f64emu.py:389-586``).

The JAX package emulates f64 as two f32 numbers (hi, lo) because the TPU
has no usable FP64: two value planes, (hi, lo) x planes, TwoProd products
and double-float add trees in every kernel, and a ``DF64`` pytree so the
pairs can flow through ``jit``.  Hopper has native FP64, and a double
takes the same 8 bytes as a (hi, lo) pair.  So the port packs exactly as
the JAX package does (the hi and lo planes as two f32 packs, byte-identical
to its packs) and joins the two value planes into one float64 plane at
upload; x, every partial sum and y are ``torch.float64``, and the kernels
compute in FP64.  The function is the same, f64 SpMV/SpMM, at least as
precise as the JAX package's ~2^-48; a plain float64 tensor takes the
place of ``DF64``.

  ``DF64GStreamDevice``  the classic f64 device: one forward stream with
                         float64 values (Q pinned to 8, no lane shuffle)
                         and a legacy ``_FinalLevel`` only, or the
                         segment-sum route when none builds; its forward
                         reads only the pack's live slots at the positions
                         the finish reads (``LiveSlots``);
  ``spmm_df64``          Y = A @ X on either f64 device: one fused f64 SpMV
                         a column on ``DF64FusedDevice``, the k-plane f64
                         forward once then the k-plane f64 final here;
  ``spmv_f64_emulated``  the JAX package's user-level f64 SpMV of a CSR
                         matrix, here in native FP64 over the COO path.

The kernels are the f64 forms of ``csrc/fused_spmv.cu``,
``final_rows.cu`` and ``gstream_spmm.cu`` and the live-slot kernel of
``gstream_spmv.cu``, behind ``fused_spmv_f64``, ``final_rows`` and
``final_rows_multi`` (on f64 positions), ``gstream_chunk_sums_multi_f64``
and ``live_slot_sums``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _host
from ..pack.final_levels import FinishPlan, _FinalLevel
from ..utils.device import CUDA, pick_device, require_device
from ..utils.timing import SETUP, span
from .spmm import spmm_gstream
from .spmv_coo import spmv_coo
from .spmv_fused import DF64FusedDevice
from .spmv_gstream import GStreamDevice, LiveSlots, live_slot_sums


def split_f64(x: np.ndarray):
    """Exact host-side split: f64 -> (hi, lo) f32 with hi + lo == x to
    ~2^-48 relative (``f64emu.py:41-47``)."""
    hi = np.asarray(x, dtype=np.float32)
    lo = (np.asarray(x, dtype=np.float64) - hi.astype(np.float64)
          ).astype(np.float32)
    return hi, lo


def join_f64(hi, lo) -> np.ndarray:
    """hi + lo in float64 (``f64emu.py:50-51``)."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def split_planes(matrix):
    """The (hi, lo) f32 CSR matrices of an f64 CSR matrix: same structure,
    the split values."""
    vhi, vlo = split_f64(matrix.values.astype(np.float64))
    return tuple(_host.CSRMatrix(matrix.row_ptr, matrix.col_ind, v,
                                 matrix.nr_rows, matrix.nr_cols)
                 for v in (vhi, vlo))


@SETUP.phase("pack")
def pack_gstream_df64(matrix, G=None):
    """The classic f64 packs (hi, lo), as the JAX device packs them
    (``f64emu.py:454-470``): the hi plane with Q = 8 and no lane shuffle,
    the lo plane with the same G, Q and ``tiles_per_step``; the config is
    not read.  ``G`` pins the group count (the model picks it otherwise)."""
    m_hi, m_lo = split_planes(matrix)
    packed = _host.pack_gstream(m_hi, value_dtype=np.float32,
                                shuffle_lanes=False, Q=8, G=G)
    packed_lo = _host.pack_gstream(m_lo, value_dtype=np.float32,
                                   shuffle_lanes=False, G=packed.G, Q=8,
                                   tiles_per_step=packed.tiles_per_step)
    return packed, packed_lo


class DF64GStreamDevice(GStreamDevice):
    """The classic f64 device (counterpart of the JAX package's
    ``DF64GStreamDevice``): a ``GStreamDevice`` with the hi + lo value
    plane in float64, no F levels, and the legacy ``_FinalLevel`` or, when
    none builds, the segment-sum route, in float64.  ``spmv`` returns a
    float64 y: the forward over ``slots``, the pack's live slots at the
    positions the finish reads (``LiveSlots``, built at upload: the final
    map's positions, or the segment-sum's), one launch of
    ``live_slot_sums``; then ``finish_vec``, the JAX ``finish_df64``
    (``f64emu.py:527-581``): the f64 final with its spills, one row-sorted
    gather-sum in FP64 (the padded spills dropped at upload); or the f64
    segment-sum.  The pack stays on the device for ``A @ X`` (the k-plane
    forward reads it whole) and as the plain yardstick
    (``stream(x2, gstream_chunk_sums_reference)``).
    ``DF64GStreamDevice(matrix)`` packs an f64 CSR matrix inside the
    constructor, as the JAX one does (``f64emu.py:445``; ``interpret=True``
    keeps it on the CPU, ``utils/device.py:pick_device``);
    ``from_packed`` uploads a (hi, lo) pack pair.  ``SETUP``'s phases:
    the packs ``pack``, the legacy level's build with its map
    ``final_rows``, the live slots' ``live_slots``, the rest ``upload``;
    a call opens ``sparsetpu.device.spmv``."""

    def __init__(self, matrix, interpret=False, *, device=CUDA):
        dev = pick_device(device, interpret)
        self._build(*pack_gstream_df64(matrix), dev)

    @classmethod
    def from_packed(cls, packed_hi, packed_lo, device,
                    plan: Optional[FinishPlan] = None) -> "DF64GStreamDevice":
        """Upload the (hi, lo) ``GStreamMatrix`` pair (from either
        package's ``pack_gstream``).  ``plan``, a ``FinishPlan`` with no F
        levels, takes the place of the legacy level built here: its final
        a ``FinalRows`` over the pack's positions (a rank's band,
        ``FinalRows.from_chunk_row``), or a checkpoint's legacy level or
        segment-sum chunk rows (``pack/serialize.py:load_device``)."""
        self = cls.__new__(cls)
        self._build(packed_hi, packed_lo, device, plan)
        return self

    @SETUP.phase("upload")
    def _build(self, packed_hi, packed_lo, device, plan=None) -> None:
        if packed_lo.values.shape != packed_hi.values.shape or not all(
                np.array_equal(getattr(packed_hi, k), getattr(packed_lo, k))
                for k in ("chunk_row", "cell_idx", "route", "step_window")):
            raise ValueError("hi/lo packs diverged (the pack engine must be "
                             "deterministic)")
        if packed_hi.GL:
            raise ValueError("the f64 device takes GL = 0 packs only")
        if plan is None:
            with SETUP.phase("final_rows"):
                chunk_row = packed_hi.chunk_row.reshape(-1).astype(np.int64)
                final = _FinalLevel.build(chunk_row, packed_hi.nr_rows)
            plan = FinishPlan([], final, chunk_row.astype(np.int32)
                              if final is None else None)
        elif plan.flevels:
            raise ValueError("the f64 device takes no F levels")
        GStreamDevice.__init__(
            self, packed_hi, device=require_device(device),
            values=join_f64(packed_hi.values, packed_lo.values), plan=plan)
        with SETUP.phase("live_slots"):
            read = (torch.unique(self.final.rows.idx)
                    if self.final is not None else self.chunk_pos)
            self.slots = LiveSlots.build(self.stream, read, packed_hi.nr_cols)

    def forward_live(self, x: torch.Tensor, kernel=None) -> torch.Tensor:
        """The chunk sums the finish reads, through ``kernel`` (default
        the wrapper ``live_slot_sums``; ``live_slot_sums_reference`` to
        compare), from x 1-D float64: unpadded, or x2 flattened."""
        return (kernel or live_slot_sums)(x, self.slots)

    def spmv(self, x, x_is_packed: bool = False) -> torch.Tensor:
        """y = A @ x (nr_rows,) float64: x unpadded, or prepared
        (``prepare_x``) with ``x_is_packed``.  A tensor must be float64 on
        the device already (anything else is converted)."""
        with span("device.spmv"):
            if isinstance(x, torch.Tensor):
                if x.dtype != torch.float64 or x.device != self.device:
                    raise ValueError(f"x must be a float64 tensor on "
                                     f"{self.device}, got {x.dtype} on "
                                     f"{x.device}")
            else:
                x = torch.as_tensor(x, dtype=torch.float64,
                                    device=self.device)
            want = ((self.meta.padded_cols // 128, 128) if x_is_packed
                    else (self.meta.nr_cols,))
            if tuple(x.shape) != want:
                raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                                 f"{want}")
            return self.finish_vec(
                self.forward_live(x.contiguous().view(-1)))

    def spmv_f64(self, x) -> torch.Tensor:
        """y = A @ x, float64, on this device: ``spmv`` of x as float64
        (the JAX device's ``spmv_f64``, ``f64emu.py:583``, joins its (hi,
        lo) y; here y is float64 already)."""
        return self.spmv(torch.as_tensor(x, dtype=torch.float64,
                                         device=self.device))


def spmm_df64(device, x_multi) -> torch.Tensor:
    """Y = A @ X (nr_rows, k) float64 for X = ``x_multi`` (nr_cols, k) on
    an f64 device, routed as the JAX package's ``spmm_df64``
    (``f64emu.py:389-436``): one fused f64 SpMV a column on
    ``DF64FusedDevice``; on ``DF64GStreamDevice`` the k-plane f64 forward
    once for all k, then the k-plane f64 final (the JAX package finishes a
    plane at a time)."""
    if isinstance(device, DF64FusedDevice):
        return device.spmm(x_multi)
    if isinstance(device, DF64GStreamDevice):
        return spmm_gstream(device, x_multi)
    raise TypeError(f"spmm_df64 needs an f64 device, got "
                    f"{type(device).__name__}")


def spmv_f64_emulated(matrix, x, *, device=CUDA) -> torch.Tensor:
    """y = A @ x in float64 for an f64 CSR matrix, on ``device`` (the JAX
    package's user-level f64 SpMV, ``f64emu.py:135``, a df64 COO product
    with a compensated segmented scan): native FP64 over the COO path
    (``spmv_coo``), no pack."""
    dev = require_device(device)
    coo = matrix.to_coo()

    def up(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    return spmv_coo(up(coo.row_ind, torch.int64), up(coo.col_ind, torch.int64),
                    up(coo.values, torch.float64), up(x, torch.float64),
                    matrix.nr_rows)
