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
  bench/      the main.cpp measurement protocol, CUDA-event timing, the
              stage ladder, ``python -m sparsetpu_torch.bench``
  utils/      configuration, device selection, card facts

The top level names what ``sparsetpu`` names (``formats``, ``kernels``,
``api``, ``utils``, ``pack_matrix``, ``COOMatrix``, ...) and more, with two
differences: ``pack`` is the pack function (``pack_matrix``), not the
subpackage, which stays importable as ``sparsetpu_torch.pack``; and there
is no ``DF64``: f64 runs in native FP64 on the card, so a float64 tensor
takes the place of the JAX package's (hi, lo) pair.
"""

__version__ = "0.1.0"

from . import formats, kernels, api, utils
from ._host import (BSRMatrix, COOMatrix, CSRMatrix, SpmvConfig, bsr_to_csr,
                    csr_to_bsr, default_tolerance, read_matrix, spmv_gold,
                    verification)
from .api.api import (SparseMatrix, create_csr_hw_matrix,
                      create_csr_hw_x_vector, delete_csr_hw_matrix,
                      delete_csr_hw_x_vector, pack, spmv, spmv_hw, unpack)
from .api.autotune import autotune_candidates, autotune_pack
from .kernels.bsr import BSRDevice, bsr_partials, bsr_spmv
from .kernels.final_rows import FinalRows, final_rows, final_rows_multi
from .kernels.f64emu import DF64GStreamDevice, spmm_df64
from .kernels.spmm import (gstream_chunk_sums_multi,
                           gstream_chunk_sums_multi_f64, spmm_gstream)
from .kernels.spmv_fused import (DF64FusedDevice, FusedDevice, fused_spmm,
                                 fused_spmv, fused_spmv_f64)
from .kernels.spmv_gstream import (GStreamDevice, LiveSlots,
                                   gstream_chunk_sums, live_slot_sums)
from .kernels.spgemm import SpGEMMPlan, spgemm
from .solvers import (CGResult, bicgstab, cg, cg_df64, cg_step, gmres,
                      jacobi_iteration, jacobi_preconditioner, pcg, pcg_df64,
                      power_iteration)

pack_matrix = pack

__all__ = [
    "SparseMatrix", "pack", "pack_matrix", "spmv", "unpack",
    "autotune_candidates", "autotune_pack", "FusedDevice", "fused_spmm",
    "fused_spmv", "GStreamDevice",
    "gstream_chunk_sums", "gstream_chunk_sums_multi", "spmm_gstream",
    "DF64FusedDevice", "DF64GStreamDevice", "spmm_df64", "fused_spmv_f64",
    "LiveSlots", "live_slot_sums", "FinalRows", "final_rows",
    "final_rows_multi", "gstream_chunk_sums_multi_f64",
    "BSRDevice", "bsr_partials", "bsr_spmv", "SpGEMMPlan", "spgemm",
    "CGResult", "bicgstab", "cg", "cg_df64", "cg_step", "gmres",
    "jacobi_iteration", "jacobi_preconditioner", "pcg", "pcg_df64",
    "power_iteration",
    "create_csr_hw_matrix", "create_csr_hw_x_vector", "spmv_hw",
    "delete_csr_hw_matrix", "delete_csr_hw_x_vector",
    "BSRMatrix", "COOMatrix", "CSRMatrix", "SpmvConfig", "bsr_to_csr",
    "csr_to_bsr", "default_tolerance", "read_matrix", "spmv_gold",
    "verification", "formats", "kernels", "api", "utils",
]
