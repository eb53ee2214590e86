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
                         segment-sum route when none builds;
  ``spmm_df64``          Y = A @ X on either f64 device: one fused f64 SpMV
                         a column on ``DF64FusedDevice``, the k-plane f64
                         forward once then the f64 finish a plane here.

The kernels are the f64 forms of ``csrc/fused_spmv.cu``,
``gstream_spmv.cu``, ``gstream_final.cu`` and ``gstream_spmm.cu``, behind
``fused_spmv_f64``, ``gstream_chunk_sums_f64``, ``final_gather_f64`` and
``gstream_chunk_sums_multi_f64``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _host
from ..pack.final_levels import FinishPlan, _FinalLevel
from .spmm import spmm_gstream
from .spmv_fused import DF64FusedDevice
from .spmv_gstream import GStreamDevice


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
    float64 y.  ``finish_vec`` is the JAX ``finish_df64``
    (``f64emu.py:527-581``): the f64 final, then its spills by
    ``index_add_``, with the padded spills dropped at upload; or the f64
    segment-sum.  ``DF64GStreamDevice(matrix, device)`` packs an f64 CSR
    matrix; ``from_packed`` uploads a (hi, lo) pack pair."""

    def __init__(self, matrix, device):
        self._build(*pack_gstream_df64(matrix), device)

    @classmethod
    def from_packed(cls, packed_hi, packed_lo,
                    device) -> "DF64GStreamDevice":
        """Upload the (hi, lo) ``GStreamMatrix`` pair (from either
        package's ``pack_gstream``)."""
        self = cls.__new__(cls)
        self._build(packed_hi, packed_lo, device)
        return self

    def _build(self, packed_hi, packed_lo, device) -> None:
        if packed_lo.values.shape != packed_hi.values.shape or not all(
                np.array_equal(getattr(packed_hi, k), getattr(packed_lo, k))
                for k in ("chunk_row", "cell_idx", "route", "step_window")):
            raise ValueError("hi/lo packs diverged (the pack engine must be "
                             "deterministic)")
        if packed_hi.GL:
            raise ValueError("the f64 device takes GL = 0 packs only")
        chunk_row = packed_hi.chunk_row.reshape(-1).astype(np.int64)
        final = _FinalLevel.build(chunk_row, packed_hi.nr_rows)
        plan = FinishPlan([], final, chunk_row.astype(np.int32)
                          if final is None else None)
        GStreamDevice.__init__(
            self, packed_hi, device,
            values=join_f64(packed_hi.values, packed_lo.values), plan=plan)


def spmm_df64(device, X) -> torch.Tensor:
    """Y = A @ X (nr_rows, k) float64 on an f64 device, routed as the JAX
    package's ``spmm_df64`` (``f64emu.py:389-436``): one fused f64 SpMV a
    column on ``DF64FusedDevice``; on ``DF64GStreamDevice`` the k-plane f64
    forward once for all k, then the f64 finish a plane."""
    if isinstance(device, DF64FusedDevice):
        return device.spmm(X)
    if isinstance(device, DF64GStreamDevice):
        return spmm_gstream(device, X)
    raise TypeError(f"spmm_df64 needs an f64 device, got "
                    f"{type(device).__name__}")
