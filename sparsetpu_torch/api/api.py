"""Public user API for f32 SpMV (counterpart of ``sparsetpu/api/api.py``).

``SparseMatrix(m)`` packs a CSR matrix onto the card (``device="cuda"`` by
default; pass ``device="cpu"`` for the plain PyTorch versions) and answers
``A @ x``.  It routes exactly as the JAX package's ``SparseMatrix`` does
(``api/api.py:62-200``):

  fused      the resident-x layout, one kernel, where x fits its budget;
  hybrid     rows with many nnz split off to a classic device, the light
             rest fused, y = y_light + the heavy rows' y;
  classic    the GStream device, for wide x, matrices that do not fuse,
             ``block_cols < 16384`` and the bf16 value mode;
  partitions ``num_partitions > 1`` nnz-balanced row ranges, each fused or
             classic.

The f64 devices and SpMM are not ported yet and raise
``NotImplementedError`` naming the ROADMAP item.  Nothing falls back to COO
or to the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _host
from ..kernels.spmv_coo import spmm_coo, spmv_coo
from ..kernels.spmv_fused import FusedDevice
from ..kernels.spmv_gstream import GStreamDevice
from ..pack.balance import balance_rows
from ..utils.device import require_device


def _pack_fused(matrix, config):
    """``pack_fused`` as the JAX package gates it: None where the layout
    does not apply or the pack is pathological (fill < 0.02)."""
    fp = _host.pack_fused(matrix, Q=config.vf or None)
    if fp is not None and fp.fill_factor < 0.02:
        fp = None
    return fp


def _pack_classic(matrix, config):
    return _host.pack_gstream(matrix, config, value_dtype=np.float32)


class SparseMatrix:
    """A packed sparse matrix on one device, with an ``@`` operator.

    ``backend``: ``"auto"`` routes as the JAX package does; ``"fused"`` is
    the same but raises ``ValueError`` where the fused layout does not
    apply; ``"coo"`` is the gather + ``index_add_`` path, the counterpart
    of the JAX package's ``"xla"``."""

    def __init__(self, matrix, config=None, backend: str = "auto", *,
                 device="cuda"):
        if backend not in ("auto", "fused", "coo"):
            raise ValueError(f"backend must be auto, fused or coo "
                             f"(got {backend!r})")
        self.device = require_device(device)
        self.config = config or _host.SpmvConfig(dtype=matrix.dtype)
        self.nr_rows = matrix.nr_rows
        self.nr_cols = matrix.nr_cols
        self.nr_nzeros = matrix.nr_nzeros
        self.backend = backend
        self.dtype = (torch.float64 if self.config.is_double
                      else torch.float32)
        self._packed = None
        self._device = None        # FusedDevice or GStreamDevice
        self._parts = None         # row partitions (num_partitions > 1)
        self._heavy_dev = None     # the hybrid's heavy-row device
        self._heavy_rows = None
        if backend == "coo":
            coo = matrix.to_coo()

            def up(a, dtype):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=self.device)
            self._row_ind = up(coo.row_ind, torch.int64)
            self._col_ind = up(coo.col_ind, torch.int64)
            self._values = up(coo.values, self.dtype)
            return
        if self.config.is_double:
            raise NotImplementedError(
                "f64 (DOUBLE=1) runs on the two-float devices, not ported "
                "yet: ROADMAP Queue 1 #6")
        vdt = torch.bfloat16 if self.config.is_bf16 else None
        if self.config.num_partitions > 1:
            self._build_partitions(matrix, vdt)
            return
        fp = None
        if vdt is None and self.config.block_cols >= 16 * 1024:
            fp = self._route_fused(matrix)
        if fp is not None:
            self._packed = fp
            self._device = FusedDevice.from_packed(fp, self.device)
        elif backend == "fused":
            raise ValueError("fused layout not applicable to this matrix "
                             "(nr_cols too large or pathological structure)")
        else:
            self._packed = _pack_classic(matrix, self.config)
            self._device = GStreamDevice(self._packed, self.device, vdt)

    def _route_fused(self, matrix):
        """The fused pack of ``matrix`` or of its light rows (the heavy ones
        then go to ``_heavy_dev``), as the JAX package's threshold ladder
        picks it (``api/api.py:137-181``); None where it goes classic."""
        rn = matrix.row_nnz() if matrix.nr_rows else np.zeros(0, np.int64)
        # threshold ladder: 4096 for ordinary matrices; 32 for the
        # scattered/powerlaw profile, picked by the median row occupancy
        nzr = rn[rn > 0]
        med = float(np.median(nzr)) if nzr.size else 8.0
        ladder = (4096, 32) if med >= 8 else (32,)
        for thresh in ladder:
            heavy_rows = np.flatnonzero(rn > thresh)
            if thresh == 32 and not heavy_rows.size and len(ladder) > 1:
                break
            target, heavy = matrix, None
            if heavy_rows.size:
                light, heavy = _split_rows(matrix, heavy_rows)
                if heavy.nr_nzeros > 0.7 * matrix.nr_nzeros:
                    continue            # mostly heavy: go classic
                target = light
            fp = _pack_fused(target, self.config)
            if fp is not None:
                if heavy is not None:
                    self._heavy_dev = GStreamDevice(
                        _pack_classic(heavy, self.config), self.device)
                    self._heavy_rows = torch.as_tensor(
                        heavy_rows, dtype=torch.int64, device=self.device)
                return fp
        return None

    def _build_partitions(self, matrix, vdt) -> None:
        """nnz-balanced contiguous row partitions, one device each: fused
        where the partition fuses (f32 only), else classic."""
        part = balance_rows(matrix, self.config.num_partitions)
        self._parts = []
        for s, e in zip(part.row_start, part.row_end):
            sub = matrix.row_slice(int(s), int(e))
            fp = _pack_fused(sub, self.config) if vdt is None else None
            if fp is not None:
                self._parts.append(FusedDevice.from_packed(fp, self.device))
            else:
                self._parts.append(GStreamDevice(
                    _pack_classic(sub, self.config), self.device, vdt))
        self._packed = self._parts[0].meta

    @property
    def shape(self):
        return (self.nr_rows, self.nr_cols)

    @property
    def packed(self):
        """The host pack (``FusedMatrix`` or ``GStreamMatrix``; the first
        partition's with row partitions; None on the COO backend)."""
        return self._packed

    @property
    def device_module(self):
        """The ``FusedDevice`` or ``GStreamDevice`` that answers ``@``
        (None with row partitions and on the COO backend)."""
        return self._device

    @property
    def fused_device(self) -> Optional[FusedDevice]:
        return self._device if isinstance(self._device, FusedDevice) \
            else None

    @property
    def heavy_device(self) -> Optional[GStreamDevice]:
        """The hybrid's classic device for the heavy rows, if any."""
        return self._heavy_dev

    @property
    def parts(self):
        return self._parts

    def prepare_x(self, x) -> torch.Tensor:
        """Pre-pack x for repeated ``spmv_packed_x`` calls.  Partitions and
        the hybrid keep x unpacked: their devices pad it differently."""
        if self.backend == "coo":
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if self._parts is not None or self._heavy_dev is not None:
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=self.device)
        return self._device.prepare_x(x)

    def spmv_packed_x(self, x_packed) -> torch.Tensor:
        if self._parts is not None:
            return torch.cat([d.spmv(x_packed) for d in self._parts])
        if self._heavy_dev is not None:
            y = self._device.spmv(x_packed)
            # heavy rows packed compacted: add their y back (in place: y
            # is this call's own output)
            return y.index_add_(0, self._heavy_rows,
                                self._heavy_dev.spmv(x_packed))
        if self._device is not None:
            return self._device.spmv(x_packed, x_is_packed=True)
        return spmv_coo(self._row_ind, self._col_ind, self._values,
                        x_packed, self.nr_rows)

    def spmv(self, x) -> torch.Tensor:
        """y = A @ x, a tensor on this matrix's device."""
        return self.spmv_packed_x(self.prepare_x(x))

    def spmm(self, x) -> torch.Tensor:
        """Y = A @ X for X of shape (nr_cols, k)."""
        if self.backend != "coo":
            raise NotImplementedError("SpMM on the packed devices is not "
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
        if self._parts is not None:
            csr_bytes = self.nr_nzeros * (4 + 4) + 4 * (self.nr_rows + 1)
            return sum(d.meta.storage_bytes()
                       for d in self._parts) / max(csr_bytes, 1)
        if self._packed is None:
            return 1.0
        return self._packed.storage_overhead()

    def fill_factor(self) -> float:
        if self._parts is not None:
            return self.nr_nzeros / max(
                sum(d.meta.n_slots for d in self._parts), 1)
        return 1.0 if self._packed is None else self._packed.fill_factor


def _split_rows(matrix, heavy_rows: np.ndarray):
    """(light, heavy): light is full-shape with the heavy rows' nnz
    removed; heavy is compacted to len(heavy_rows) rows (``api/api.py:
    418-441``).  Callers add heavy's y back at ``heavy_rows``."""
    mask = np.zeros(matrix.nr_rows, dtype=bool)
    mask[heavy_rows] = True
    rn = matrix.row_nnz()
    el_heavy = np.repeat(mask, rn)

    counts = np.where(~mask, rn, 0)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(
        matrix.row_ptr.dtype)
    light = _host.CSRMatrix(ptr, matrix.col_ind[~el_heavy],
                            matrix.values[~el_heavy],
                            matrix.nr_rows, matrix.nr_cols)
    hptr = np.concatenate(
        [[0], np.cumsum(rn[heavy_rows])]).astype(matrix.row_ptr.dtype)
    heavy = _host.CSRMatrix(hptr, matrix.col_ind[el_heavy],
                            matrix.values[el_heavy],
                            int(heavy_rows.shape[0]), matrix.nr_cols)
    return light, heavy


def pack(matrix, config=None, backend: str = "auto", *,
         device="cuda") -> SparseMatrix:
    """Pack ``matrix`` onto ``device`` (create_csr_hw_matrix analogue)."""
    return SparseMatrix(matrix, config, backend=backend, device=device)


def spmv(matrix, x, config=None, *, device="cuda") -> torch.Tensor:
    """y = A @ x for a CSR matrix (packed here) or a ``SparseMatrix``."""
    if not isinstance(matrix, SparseMatrix):
        matrix = pack(matrix, config, device=device)
    elif matrix.device != require_device(device):
        raise ValueError(f"matrix lives on {matrix.device}, not {device}")
    return matrix.spmv(x)
