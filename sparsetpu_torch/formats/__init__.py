"""Sparse containers, ingest and golden models (the port's own copy of the
JAX package's ``formats/``: ``csr``, ``gold``, ``random``, ``io``,
``convert``), with the same 28 names as ``sparsetpu.formats``."""

from .csr import (BSRMatrix, COOMatrix, CSRMatrix, DenseVector, INDEX_DTYPE,
                  create_csr_vector, init_vector_rand)
from .io import CSRHeader, read_csr_header, read_matrix, write_matrix
from .gold import (DIFF_THRES, bsr_spmv_gold, default_tolerance, spgemm_gold,
                   spmm_gold, spmv_gold, verification)
from .convert import bsr_to_csr, coo_to_csr, csr_to_bsr, csr_to_coo
from .random import (banded_csr, circuit_netlist, fem_poisson_3d,
                     laplace_2d, random_csr, shell_3d)

__all__ = [
    "BSRMatrix", "COOMatrix", "CSRMatrix", "DenseVector", "INDEX_DTYPE",
    "create_csr_vector", "init_vector_rand", "CSRHeader", "read_csr_header",
    "read_matrix", "write_matrix", "DIFF_THRES", "bsr_spmv_gold",
    "default_tolerance", "spgemm_gold", "spmm_gold", "spmv_gold",
    "verification", "bsr_to_csr", "coo_to_csr", "csr_to_bsr", "csr_to_coo",
    "banded_csr", "circuit_netlist", "fem_poisson_3d",
    "laplace_2d", "random_csr", "shell_3d",
]
