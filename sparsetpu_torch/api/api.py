"""Public user API for f32 SpMV (counterpart of ``sparsetpu/api/api.py``).

``SparseMatrix(m, device=...)`` packs a CSR matrix and answers ``A @ x``.
It routes exactly as the JAX package's ``SparseMatrix`` does: the fused
resident-x layout where that applies, else the classic GStream device, the
heavy-row hybrid, the two-float f64 device or row partitions.  Only the
fused layout is ported so far; where the JAX package would take another
device, this raises ``NotImplementedError`` naming the ROADMAP item that
ports it.  Nothing falls back to COO or to the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _host
from ..kernels.spmv_coo import spmm_coo, spmv_coo
from ..kernels.spmv_fused import FusedDevice
from ..utils.device import require_device

_CLASSIC = ("the classic GStream device (sparsetpu/kernels/spmv_pallas.py) "
            "is not ported yet: ROADMAP Queue 1 #4")


def _route_fused(matrix, config, backend: str):
    """The fused pack the JAX package would run ``matrix`` on
    (``api/api.py:120-200``), or raise where it takes another device."""
    if config.is_bf16:
        raise NotImplementedError(f"bf16 values run on {_CLASSIC}")
    if config.block_cols < 16 * 1024:
        raise NotImplementedError(f"block_cols < 16384 runs on {_CLASSIC}")
    # heavy-row threshold ladder (4096, 32), or (32,) for the scattered
    # profile picked by the median row occupancy.  A rung with heavy rows
    # ends in the heavy-row hybrid or the classic device, and a later rung
    # only has more heavy rows, so the plain fused device is taken exactly
    # when the first rung has none and the whole matrix packs with fill
    # >= 0.02.
    rn = matrix.row_nnz() if matrix.nr_rows else np.zeros(0, np.int64)
    nzr = rn[rn > 0]
    med = float(np.median(nzr)) if nzr.size else 8.0
    first_rung = 4096 if med >= 8 else 32
    if np.any(rn > first_rung):
        raise NotImplementedError(
            f"rows with more than {first_rung} nnz take the heavy-row hybrid "
            f"or {_CLASSIC}")
    fp = _host.pack_fused(matrix, Q=config.vf or None)
    if fp is not None and fp.fill_factor < 0.02:
        fp = None                       # pathological pack
    if fp is None:
        if backend == "fused":
            raise ValueError("fused layout not applicable to this matrix "
                             "(nr_cols too large or pathological structure)")
        raise NotImplementedError(f"this matrix does not fuse; {_CLASSIC}")
    return fp


class SparseMatrix:
    """A packed sparse matrix on one device, with an ``@`` operator.

    ``backend``: ``"auto"`` and ``"fused"`` take the fused kernel (``fused``
    raises ``ValueError`` when the layout does not apply, as in the JAX
    package); ``"coo"`` is the gather + ``index_add_`` path, the counterpart
    of the JAX package's ``"xla"``."""

    def __init__(self, matrix, config=None, backend: str = "auto", *,
                 device):
        if backend not in ("auto", "fused", "coo"):
            raise ValueError(f"backend must be auto, fused or coo "
                             f"(got {backend!r})")
        self.device = require_device(device)
        self.config = config or _host.SpmvConfig(dtype=matrix.dtype)
        self.nr_rows = matrix.nr_rows
        self.nr_cols = matrix.nr_cols
        self.nr_nzeros = matrix.nr_nzeros
        self.backend = "coo" if backend == "coo" else "fused"
        self.dtype = (torch.float64 if self.config.is_double
                      else torch.float32)
        self._packed = None
        self._device: Optional[FusedDevice] = None
        if self.backend == "fused":
            if self.config.is_double:
                raise NotImplementedError(
                    "f64 (DOUBLE=1) runs on the two-float devices, not "
                    "ported yet: ROADMAP Queue 1 #6")
            if self.config.num_partitions > 1:
                raise NotImplementedError(
                    f"num_partitions > 1: row partitions run on {_CLASSIC}")
            self._packed = _route_fused(matrix, self.config, backend)
            self._device = FusedDevice.from_packed(self._packed, self.device)
        else:
            coo = matrix.to_coo()

            def up(a, dtype):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=self.device)
            self._row_ind = up(coo.row_ind, torch.int64)
            self._col_ind = up(coo.col_ind, torch.int64)
            self._values = up(coo.values, self.dtype)

    @property
    def shape(self):
        return (self.nr_rows, self.nr_cols)

    @property
    def packed(self):
        """The host ``FusedMatrix`` (None on the COO backend)."""
        return self._packed

    @property
    def fused_device(self) -> Optional[FusedDevice]:
        return self._device

    def prepare_x(self, x) -> torch.Tensor:
        """Pre-pack x for repeated ``spmv_packed_x`` calls."""
        if self._device is not None:
            return self._device.prepare_x(x)
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def spmv_packed_x(self, x_packed) -> torch.Tensor:
        if self._device is not None:
            return self._device.spmv(x_packed, x_is_packed=True)
        return spmv_coo(self._row_ind, self._col_ind, self._values,
                        x_packed, self.nr_rows)

    def spmv(self, x) -> torch.Tensor:
        """y = A @ x, a tensor on this matrix's device."""
        return self.spmv_packed_x(self.prepare_x(x))

    def spmm(self, x) -> torch.Tensor:
        """Y = A @ X for X of shape (nr_cols, k)."""
        if self._device is not None:
            raise NotImplementedError("SpMM on the fused layout is not "
                                      "ported yet: ROADMAP Queue 1 #5")
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        return spmm_coo(self._row_ind, self._col_ind, self._values, x,
                        self.nr_rows)

    def __matmul__(self, x):
        if isinstance(x, SparseMatrix) or hasattr(x, "row_ptr"):
            raise NotImplementedError("SpGEMM is not ported yet: ROADMAP "
                                      "Queue 1 #8")
        ndim = x.ndim if hasattr(x, "ndim") else np.ndim(x)
        if ndim == 1:
            return self.spmv(x)
        if ndim == 2:
            return self.spmm(x)
        raise ValueError("operand must be a vector or matrix")

    # reporting (the reference's main.cpp:84-88)
    def storage_overhead(self) -> float:
        if self._packed is None:
            return 1.0
        return self._packed.storage_overhead()

    def fill_factor(self) -> float:
        return 1.0 if self._packed is None else self._packed.fill_factor


def pack(matrix, config=None, backend: str = "auto", *,
         device) -> SparseMatrix:
    """Pack ``matrix`` onto ``device`` (create_csr_hw_matrix analogue)."""
    return SparseMatrix(matrix, config, backend=backend, device=device)


def spmv(matrix, x, config=None, *, device) -> torch.Tensor:
    """y = A @ x for a CSR matrix (packed here) or a ``SparseMatrix``."""
    if not isinstance(matrix, SparseMatrix):
        matrix = pack(matrix, config, device=device)
    elif matrix.device != require_device(device):
        raise ValueError(f"matrix lives on {matrix.device}, not {device}")
    return matrix.spmv(x)
