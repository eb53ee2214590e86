"""Runtime configuration for sparsetpu.

The reference (euroexa/spmv-fpga) configures everything at *compile* time via
Makefile ``-D`` macros (Makefile:13-18 -> util.h:18-59): ``CU`` (compute
units), ``VF`` (vector/unroll factor), ``DOUBLE`` (precision), plus derived
bus-packing ratios (util.h:61-67).  On TPU none of that needs a compile-time
fan-out: it is a runtime dataclass consumed by the pack engine and the Pallas
kernels.  The ``#if CU == N`` x6 code replication of the reference collapses
to the single ``num_partitions`` integer here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# --- Hardware-derived constants (TPU analogues of util.h:61-69) -------------
# The reference sizes its stream words to the ZCU102 128-bit HP ports
# (BUS_BIT_WIDTH, util.h:61).  The TPU analogues are the VPU register tile:
LANES = 128          # minor dimension of every vector register / VMEM tile
SUBLANES = 8         # second-minor dimension for float32
TILE = SUBLANES * LANES  # 1024 elements per (8, 128) register tile

# The reference caps the in-block column index at 15 bits so that an index and
# its end-of-row flag fit 16 bits (csr_hw.cpp:288-292, README.md:63).  We keep
# the same 15-bit local-column capability bound for the parity format:
MAX_BLOCK_COLS = 1 << 15  # 32768 == COLS_DIV_BLOCKS for CU<=8 (util.h:43-58)

# Default 2D column-block width: sized so the x-vector block comfortably fits
# VMEM (~16 MiB higher bound, we budget a fraction of it), the TPU analogue of
# the BRAM-capacity-derived COLS_DIV_BLOCKS (util.h:43-58).
DEFAULT_BLOCK_COLS = MAX_BLOCK_COLS

VALID_VF = (0, 1, 2, 4, 8)              # util.h:31-39 (0 = auto-choose)
VALID_CU_REFERENCE = (1, 2, 4, 8, 10, 12)  # util.h:41-59 (we accept any >=1)

# NumPy has no bfloat16 without ml_dtypes, so the bf16 value mode is named
# by this string; torch.bfloat16 and ml_dtypes' bfloat16 map onto it.
BFLOAT16 = "bfloat16"


def _canonical_dtype(dtype):
    """np.float32, np.float64 or BFLOAT16 for any name of one of them
    (a NumPy dtype, a torch dtype or a string)."""
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = str(dtype).replace("torch.", "")
    if name == BFLOAT16:
        return BFLOAT16
    if name in ("float32", "float64"):
        return np.dtype(name)
    raise ValueError("dtype must be float32, float64 or bfloat16")


@dataclasses.dataclass(frozen=True)
class SpmvConfig:
    """All knobs of the reference build system, as one runtime object.

    Maps to reference knobs:
      * ``dtype``          <- DOUBLE=0/1 (util.h:18-26).  On TPU float64 is
                              emulated with two-float arithmetic (no native
                              f64 MXU/VPU); on CPU it is native.
      * ``vf``             <- VF unroll factor of the MAC pipeline
                              (util.h:31-39): the GStream row-pad quantum Q.
                              Rows' per-window nnz runs pad to a multiple of
                              vf and the kernel emits 8/vf chunk-sum planes
                              per tile (the VF-wide accumulator tree of
                              spmv.cpp:91-97).  0 (default) = chosen per
                              matrix by the pack cost model.
      * ``num_partitions`` <- CU compute units (util.h:41-59): how many
                              nnz-balanced row partitions the matrix is split
                              into (Pallas grid dimension / shard count).
      * ``block_cols``     <- COLS_DIV_BLOCKS 2D column-block width
                              (util.h:43-58): the x-vector tile staged in
                              VMEM, like the per-CU BRAM x buffer.
      * ``interpret``      <- TARGET=emu (Makefile:11): run the Pallas
                              kernels in interpreter mode (the SDSoC
                              emulator analogue); honored by SparseMatrix
                              when its ``interpret`` argument is None.
    """

    dtype: np.dtype = np.dtype(np.float64)
    vf: int = 0
    num_partitions: int = 1
    block_cols: int = DEFAULT_BLOCK_COLS
    interpret: Optional[bool] = None  # None => auto (emu off-TPU)

    def __post_init__(self):
        if self.vf not in VALID_VF:
            raise ValueError(f"vf must be one of {VALID_VF}, got {self.vf}")
        if self.num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        if self.block_cols < LANES or self.block_cols % LANES != 0:
            raise ValueError(
                f"block_cols must be a positive multiple of {LANES}")
        if self.block_cols > MAX_BLOCK_COLS:
            raise ValueError(
                f"block_cols must be <= {MAX_BLOCK_COLS} (15-bit local index, "
                "csr_hw.cpp:288-292 parity)")
        object.__setattr__(self, "dtype", _canonical_dtype(self.dtype))

    # -- derived quantities (util.h:63-67 analogues) -------------------------
    @property
    def value_bytes(self) -> int:
        return 2 if self.is_bf16 else self.dtype.itemsize

    @property
    def is_double(self) -> bool:
        return not self.is_bf16 and self.dtype == np.dtype(np.float64)

    @property
    def is_bf16(self) -> bool:
        return isinstance(self.dtype, str)

    def nr_blocks(self, nr_cols: int) -> int:
        """ceil(nr_cols / block_cols) — csr.cpp:39-43 / csr_hw.cpp:25-27."""
        return -(-int(nr_cols) // self.block_cols)


DEFAULT_CONFIG = SpmvConfig()
