"""sparsetpu_torch: the sparsetpu SpMV on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX/Pallas package ``sparsetpu`` beside it, which stays the
reference.  The host layer (CSR containers, golds, the fused pack and its
C++ packer) is shared, loaded without JAX (``_host``); the device side is
PyTorch, with each TPU kernel rewritten by hand for ``sm_90a`` under
``csrc/``.  This package imports torch and never jax.

Layer map:
  _host       shared NumPy/C++ host layer of sparsetpu (formats, pack)
  kernels/    fused SpMV kernel wrapper + plain version, COO paths
  api/        pack()/spmv()/SparseMatrix
  bench/      the main.cpp measurement protocol, CUDA-event timing
  utils/      device selection, card facts
"""

__version__ = "0.1.0"

from ._host import (CSRMatrix, SpmvConfig, default_tolerance, read_matrix,
                    spmv_gold, verification)
from .api.api import SparseMatrix, pack, spmv
from .kernels.spmv_fused import FusedDevice, fused_spmv

__all__ = [
    "SparseMatrix", "pack", "spmv", "FusedDevice", "fused_spmv",
    "CSRMatrix", "SpmvConfig", "default_tolerance", "read_matrix",
    "spmv_gold", "verification",
]
