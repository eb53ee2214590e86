"""sparsetpu_torch: the sparsetpu SpMV, SpMM, BSR SpMV, SpGEMM and iterative
solvers on PyTorch and CUDA (NVIDIA Hopper), in f32 and in f64 (native
FP64).

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
              BSR, COO; SpGEMM's plan
  api/        pack()/spmv()/SparseMatrix and the reference-named host API
  solvers/    CG, PCG, BiCGSTAB, GMRES, power and Jacobi iterations
  bench/      the main.cpp measurement protocol, CUDA-event timing
  utils/      configuration, device selection, card facts
"""

__version__ = "0.1.0"

from ._host import (BSRMatrix, CSRMatrix, SpmvConfig, bsr_to_csr,
                    csr_to_bsr, default_tolerance, read_matrix, spmv_gold,
                    verification)
from .api.api import (SparseMatrix, create_csr_hw_matrix,
                      create_csr_hw_x_vector, delete_csr_hw_matrix,
                      delete_csr_hw_x_vector, pack, spmv, spmv_hw, unpack)
from .kernels.bsr import BSRDevice, bsr_partials, bsr_spmv
from .kernels.f64emu import DF64GStreamDevice, spmm_df64
from .kernels.spmm import (final_gather_multi, gstream_chunk_sums_multi,
                           gstream_chunk_sums_multi_f64, spmm_gstream)
from .kernels.spmv_fused import (DF64FusedDevice, FusedDevice, fused_spmm,
                                 fused_spmv, fused_spmv_f64)
from .kernels.spmv_gstream import (GStreamDevice, final_gather,
                                   final_gather_f64, gstream_chunk_sums,
                                   gstream_chunk_sums_f64)
from .kernels.spgemm import SpGEMMPlan, spgemm
from .solvers import (CGResult, bicgstab, cg, cg_df64, cg_step, gmres,
                      jacobi_iteration, jacobi_preconditioner, pcg, pcg_df64,
                      power_iteration)

__all__ = [
    "SparseMatrix", "pack", "spmv", "unpack", "FusedDevice", "fused_spmm",
    "fused_spmv", "GStreamDevice", "final_gather", "final_gather_multi",
    "gstream_chunk_sums", "gstream_chunk_sums_multi", "spmm_gstream",
    "DF64FusedDevice", "DF64GStreamDevice", "spmm_df64", "fused_spmv_f64",
    "gstream_chunk_sums_f64", "final_gather_f64",
    "gstream_chunk_sums_multi_f64",
    "BSRDevice", "bsr_partials", "bsr_spmv", "SpGEMMPlan", "spgemm",
    "CGResult", "bicgstab", "cg", "cg_df64", "cg_step", "gmres",
    "jacobi_iteration", "jacobi_preconditioner", "pcg", "pcg_df64",
    "power_iteration",
    "create_csr_hw_matrix", "create_csr_hw_x_vector", "spmv_hw",
    "delete_csr_hw_matrix", "delete_csr_hw_x_vector",
    "BSRMatrix", "CSRMatrix", "SpmvConfig", "bsr_to_csr", "csr_to_bsr",
    "default_tolerance", "read_matrix", "spmv_gold", "verification",
]
