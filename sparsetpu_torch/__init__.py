"""sparsetpu_torch: the sparsetpu SpMV and SpMM on PyTorch and CUDA (NVIDIA
Hopper), in f32 and in f64 (native FP64).

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
  kernels/    kernel wrappers + plain versions: fused, GStream, SpMM, f64,
              COO
  api/        pack()/spmv()/SparseMatrix
  bench/      the main.cpp measurement protocol, CUDA-event timing
  utils/      configuration, device selection, card facts
"""

__version__ = "0.1.0"

from ._host import (CSRMatrix, SpmvConfig, default_tolerance, read_matrix,
                    spmv_gold, verification)
from .api.api import SparseMatrix, pack, spmv
from .kernels.f64emu import DF64GStreamDevice, spmm_df64
from .kernels.spmm import (final_gather_multi, gstream_chunk_sums_multi,
                           gstream_chunk_sums_multi_f64, spmm_gstream)
from .kernels.spmv_fused import (DF64FusedDevice, FusedDevice, fused_spmm,
                                 fused_spmv, fused_spmv_f64)
from .kernels.spmv_gstream import (GStreamDevice, final_gather,
                                   final_gather_f64, gstream_chunk_sums,
                                   gstream_chunk_sums_f64)

__all__ = [
    "SparseMatrix", "pack", "spmv", "FusedDevice", "fused_spmm",
    "fused_spmv", "GStreamDevice", "final_gather", "final_gather_multi",
    "gstream_chunk_sums", "gstream_chunk_sums_multi", "spmm_gstream",
    "DF64FusedDevice", "DF64GStreamDevice", "spmm_df64", "fused_spmv_f64",
    "gstream_chunk_sums_f64", "final_gather_f64",
    "gstream_chunk_sums_multi_f64",
    "CSRMatrix", "SpmvConfig", "default_tolerance", "read_matrix",
    "spmv_gold", "verification",
]
