"""sparsetpu_torch: the sparsetpu SpMV on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX/Pallas package ``sparsetpu`` beside it, which stays the
reference.  The host layer (CSR containers, golds, the pack engines and
their C++ runtime) is this package's own copy of the JAX package's, so both
build byte-identical packs; the device side is PyTorch, with each TPU kernel
rewritten by hand for ``sm_90a`` under ``csrc/``.  This package imports
torch and never jax, and nothing of ``sparsetpu``.

Layer map:
  formats/    CSR containers, matrix files, random matrices, golds
  pack/       fused and GStream packs, row balance, final-level builders
  native/     C++ loader, packer and final builder (ctypes)
  _host       the host layer in one namespace
  kernels/    kernel wrappers + plain versions: fused, GStream, COO
  api/        pack()/spmv()/SparseMatrix
  bench/      the main.cpp measurement protocol, CUDA-event timing
  utils/      configuration, device selection, card facts
"""

__version__ = "0.1.0"

from ._host import (CSRMatrix, SpmvConfig, default_tolerance, read_matrix,
                    spmv_gold, verification)
from .api.api import SparseMatrix, pack, spmv
from .kernels.spmv_fused import FusedDevice, fused_spmv
from .kernels.spmv_gstream import (GStreamDevice, final_gather,
                                   gstream_chunk_sums)

__all__ = [
    "SparseMatrix", "pack", "spmv", "FusedDevice", "fused_spmv",
    "GStreamDevice", "final_gather", "gstream_chunk_sums",
    "CSRMatrix", "SpmvConfig", "default_tolerance", "read_matrix",
    "spmv_gold", "verification",
]
