"""Public user API for SpMV and SpMM (counterpart of
``sparsetpu/api/api.py``).

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

``A @ X`` with X of shape (nr_cols, k) routes as the JAX package's
``spmm`` (``api/api.py:255-291``): the fused SpMM kernel where the device
takes k planes, the classic k-plane SpMM otherwise (on a classic device
built from the kept source CSR when the matrix is fused).

f64 configs (the default for an f64 matrix) route as the JAX package's
DOUBLE path (``api/api.py:62-83``): the fused f64 device where the layout
applies, else the classic f64 device; x, X and y are float64, and ``A @ X``
is ``spmm_df64``.  ``A @ B`` for a sparse B (a ``SparseMatrix`` or a CSR
matrix) is SpGEMM (``kernels/spgemm.py``): the symbolic phase on the host,
the numeric phase an SpMV on this matrix's device; it returns a host
``CSRMatrix``.  Nothing falls back to COO or to the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _host
from ..kernels.f64emu import DF64GStreamDevice, spmm_df64
from ..kernels.spgemm import spgemm
from ..kernels.spmm import spmm_gstream
from ..kernels.spmv_coo import spmm_coo, spmv_coo
from ..kernels.spmv_fused import FusedDevice, pack_fused_df64
from ..kernels.spmv_gstream import GStreamDevice
from ..pack.balance import balance_rows
from ..pack.gather_stream import GStreamMatrix, unpack_gstream
from ..utils.device import CUDA, pick_device, require_device
from ..utils.timing import SETUP, span

# the JAX package's backend names and the port's: "pallas" is "auto" (the
# Pallas kernels, routed), "xla" is "coo" (gather + segment sum)
BACKENDS = {"auto": "auto", "pallas": "auto", "fused": "fused",
            "coo": "coo", "xla": "coo"}


@SETUP.phase("pack")
def _pack_fused(matrix, config):
    """``pack_fused`` as the JAX package gates it: None where the layout
    does not apply or the pack is pathological (fill < 0.02)."""
    fp = _host.pack_fused(matrix, Q=config.vf or None)
    if fp is not None and fp.fill_factor < 0.02:
        fp = None
    return fp


@SETUP.phase("pack")
def _pack_classic(matrix, config):
    return _host.pack_gstream(matrix, config, value_dtype=np.float32)


class SparseMatrix:
    """A packed sparse matrix on one device, with an ``@`` operator.

    ``backend``: ``"auto"`` (or the JAX package's ``"pallas"``) routes as
    the JAX package does; ``"fused"`` is the same but raises
    ``ValueError`` where the fused layout does not apply; ``"coo"`` (or
    the JAX package's ``"xla"``) is the gather + ``index_add_`` path.
    ``backend`` holds the port's name.  ``interpret=True`` runs the plain
    PyTorch versions on the CPU (``utils/device.py:pick_device``)."""

    def __init__(self, matrix, config=None, backend: str = "auto",
                 interpret=None, *, device=CUDA):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {sorted(BACKENDS)} "
                             f"(got {backend!r})")
        backend = BACKENDS[backend]
        self._init_state(matrix, config or _host.SpmvConfig(
            dtype=matrix.dtype), backend, pick_device(device, interpret))
        if backend == "coo":
            coo = matrix.to_coo()

            def up(a, dtype):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=self.device)
            self._row_ind = up(coo.row_ind, torch.int64)
            self._col_ind = up(coo.col_ind, torch.int64)
            self._values = up(coo.values, self.dtype)
            return
        self._source = matrix
        if self.config.is_double:
            self._build_double(matrix)
            return
        vdt = torch.bfloat16 if self.config.is_bf16 else None
        if self.config.num_partitions > 1:
            self._build_partitions(matrix, vdt)
            return
        fp = None
        if vdt is None and self.config.block_cols >= 16 * 1024:
            fp = self._route_fused(matrix)
        if fp is not None:
            self._packed = fp
            self._device = FusedDevice(fp, device=self.device)
        elif backend == "fused":
            raise ValueError("fused layout not applicable to this matrix "
                             "(nr_cols too large or pathological structure)")
        else:
            self._packed = _pack_classic(matrix, self.config)
            self._device = GStreamDevice(self._packed, value_dtype=vdt,
                                         device=self.device)

    def _init_state(self, matrix, config, backend: str, device) -> None:
        self.device = require_device(device)
        self.config = config
        self.nr_rows = matrix.nr_rows
        self.nr_cols = matrix.nr_cols
        self.nr_nzeros = matrix.nr_nzeros
        self.backend = backend
        self.dtype = (torch.float64 if self.config.is_double
                      else torch.float32)
        self._packed = None
        self._device = None        # FusedDevice or GStreamDevice (or the
                                   # f64 devices, their subclasses)
        self._parts = None         # row partitions (num_partitions > 1)
        self._heavy_dev = None     # the hybrid's heavy-row device
        self._heavy_rows = None
        self._source = None        # the CSR, for a lazy classic device,
                                   # unpack() and SpGEMM
        self._classic = None
        self._transposed = None

    @classmethod
    def _from_classic(cls, matrix, device_module: GStreamDevice
                      ) -> "SparseMatrix":
        """An f32 matrix on an already uploaded classic ``GStreamDevice``
        of ``matrix`` (``autotune_pack``'s result, as
        ``sparsetpu/api/autotune.py:92-105`` builds it)."""
        sm = cls.__new__(cls)
        sm._init_state(matrix, _host.SpmvConfig(dtype=np.float32), "auto",
                       device_module.device)
        sm._source = matrix
        sm._packed = device_module.meta
        sm._device = device_module
        return sm

    def _build_double(self, matrix) -> None:
        """The f64 device, routed as ``api/api.py:62-83``: fused where
        ``block_cols >= 16384`` and ``pack_fused_df64`` applies
        (``backend="fused"`` too falls back to classic, as there), else
        classic; no hybrid, and no row partitions."""
        cfg = self.config
        if cfg.num_partitions > 1:
            raise ValueError(
                "num_partitions > 1 with dtype=float64 is not supported on "
                "one chip; shard over a mesh with sparsetpu.dist instead")
        dev = None
        if cfg.block_cols >= 16 * 1024:
            dev = pack_fused_df64(matrix, Q=cfg.vf or None,
                                  device=self.device)
        self._device = (dev if dev is not None else
                        DF64GStreamDevice(matrix, device=self.device))
        self._packed = self._device.meta

    @SETUP.phase("pack")
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
                        _pack_classic(heavy, self.config),
                        device=self.device)
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
                self._parts.append(FusedDevice(fp, device=self.device))
            else:
                self._parts.append(GStreamDevice(
                    _pack_classic(sub, self.config), value_dtype=vdt,
                    device=self.device))
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
        """Pre-pack x for repeated ``spmv_packed_x`` calls (float64 for an
        f64 config).  Partitions and the hybrid keep x unpacked: their
        devices pad it differently."""
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
        """y = A @ x, a tensor on this matrix's device.  A fused matrix
        takes x unpadded: one kernel launch and its output's memset; the
        classic f64 device takes it unpadded too (its forward reads the
        live slots' columns).  One ``sparsetpu.spmv`` span a call."""
        with span("spmv"):
            if self._parts is None and self._heavy_dev is None and \
                    isinstance(self._device, (FusedDevice, DF64GStreamDevice)):
                d = self._device
                return d.spmv(torch.as_tensor(x, dtype=d.dtype,
                                              device=d.device))
            return self.spmv_packed_x(self.prepare_x(x))

    def spmm(self, x) -> torch.Tensor:
        """Y = A @ X (nr_rows, k) for X of shape (nr_cols, k); float64 X
        and Y for an f64 config.  One ``sparsetpu.spmm`` span a call."""
        with span("spmm"):
            return self._spmm(x)

    def _spmm(self, x) -> torch.Tensor:
        if self.backend == "coo":
            x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
            return spmm_coo(self._row_ind, self._col_ind, self._values, x,
                            self.nr_rows)
        if self.config.is_double:
            return spmm_df64(self._device, torch.as_tensor(
                x, dtype=torch.float64, device=self.device))
        X = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if X.dim() != 2 or X.shape[0] != self.nr_cols:
            raise ValueError(f"X has shape {tuple(X.shape)}, expected "
                             f"({self.nr_cols}, k)")
        k = X.shape[1]
        if self._parts is not None:
            # row segments concatenate in order (partitions are contiguous)
            return torch.cat([_part_spmm(d, X) for d in self._parts])
        if isinstance(self._device, FusedDevice) and \
                self._device.spmm_applicable(k):
            Y = self._device.spmm(X)
            if self._heavy_dev is not None:
                # in place: Y is this call's own output
                Y.index_add_(0, self._heavy_rows,
                             spmm_gstream(self._heavy_dev, X))
            return Y
        return spmm_gstream(self._classic_device(), X)

    def _classic_device(self) -> GStreamDevice:
        """The classic device: the one that answers ``@``, or for a fused
        matrix one packed lazily from the kept source CSR (SpMM past the
        fused kernel's limits)."""
        if not isinstance(self._device, FusedDevice):
            return self._device
        if self._classic is None:
            self._classic = GStreamDevice(
                _pack_classic(self._source, self.config),
                device=self.device)
        return self._classic

    def __matmul__(self, x):
        if isinstance(x, SparseMatrix) or (hasattr(x, "row_ptr") and
                                           np.ndim(x.values) == 1):
            # sparse @ sparse -> SpGEMM (numeric phase on this device)
            other = x.unpack() if isinstance(x, SparseMatrix) else x
            if self.backend == "coo":
                raise ValueError("SpGEMM needs a packed backend (auto or "
                                 "fused), not coo")
            return spgemm(self.unpack(), other, device=self.device)
        ndim = x.ndim if hasattr(x, "ndim") else np.ndim(x)
        if ndim == 1:
            return self.spmv(x)
        if ndim == 2:
            return self.spmm(x)
        raise ValueError("operand must be a vector or matrix")

    def unpack(self):
        """The matrix as a host ``CSRMatrix``: the kept source, or the
        classic pack unpacked (``api/api.py:369-384`` of the JAX
        package)."""
        if self._source is not None:
            return self._source
        if self._parts is not None:
            raise ValueError("partitioned matrix lost its source CSR; "
                             "unpack the original handle")
        if self._packed is None:
            raise ValueError("COO-backend matrix: keep the original CSR")
        if not isinstance(self._packed, GStreamMatrix) or \
                self.config.is_double:
            raise ValueError("fused (or f64) matrix lost its source CSR; "
                             "unpack the original handle")
        return unpack_gstream(self._packed)

    def transpose(self) -> "SparseMatrix":
        """A^T, packed lazily on first access (cached), with the same
        config, backend and device."""
        if self._transposed is None:
            self._transposed = SparseMatrix(
                self.unpack().transpose(), self.config, backend=self.backend,
                device=self.device)
        return self._transposed

    @property
    def T(self) -> "SparseMatrix":
        return self.transpose()

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


def _part_spmm(d, X: torch.Tensor) -> torch.Tensor:
    """One row partition's Y, as the JAX package's ``part_spmm``
    (``api/api.py:271-277``): the fused SpMM where it takes k planes, else
    one fused SpMV a column; ``spmm_gstream`` on a classic partition."""
    if isinstance(d, FusedDevice):
        if d.spmm_applicable(X.shape[1]):
            return d.spmm(X)
        return torch.stack([d.spmv(X[:, i]) for i in range(X.shape[1])],
                           dim=1)
    return spmm_gstream(d, X)


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


def pack(matrix, config=None, backend: str = "auto", interpret=None, *,
         device=CUDA) -> SparseMatrix:
    """Pack ``matrix`` onto ``device`` (create_csr_hw_matrix analogue)."""
    return SparseMatrix(matrix, config, backend, interpret, device=device)


def spmv(matrix, x, config=None, *, device=CUDA) -> torch.Tensor:
    """y = A @ x for a CSR matrix (packed here) or a ``SparseMatrix``."""
    if not isinstance(matrix, SparseMatrix):
        matrix = pack(matrix, config, device=device)
    elif matrix.device != require_device(device):
        raise ValueError(f"matrix lives on {matrix.device}, not {device}")
    return matrix.spmv(x)


def unpack(matrix: SparseMatrix):
    return matrix.unpack()


# --- reference-named aliases (the reference's README.md:34-46) -------------

def create_csr_hw_matrix(matrix, config=None, *,
                         device=CUDA) -> SparseMatrix:
    return pack(matrix, config, device=device)


def create_csr_hw_x_vector(hw_matrix: SparseMatrix, x) -> torch.Tensor:
    return hw_matrix.prepare_x(x)


def spmv_hw(hw_matrix: SparseMatrix, hw_x) -> torch.Tensor:
    return hw_matrix.spmv_packed_x(hw_x)


def delete_csr_hw_matrix(hw_matrix) -> None:
    """No-op: device buffers are freed with the last reference to them.
    Kept so reference-shaped programs port line for line."""


def delete_csr_hw_x_vector(hw_x) -> None:
    """No-op (see ``delete_csr_hw_matrix``)."""
