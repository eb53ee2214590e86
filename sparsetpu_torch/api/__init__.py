from .api import (SparseMatrix, create_csr_hw_matrix, create_csr_hw_x_vector,
                  delete_csr_hw_matrix, delete_csr_hw_x_vector, pack, spmv,
                  spmv_hw, unpack)

__all__ = ["SparseMatrix", "create_csr_hw_matrix", "create_csr_hw_x_vector",
           "delete_csr_hw_matrix", "delete_csr_hw_x_vector", "pack", "spmv",
           "spmv_hw", "unpack"]
