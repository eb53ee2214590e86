from .api import SparseMatrix, pack, spmv

__all__ = ["SparseMatrix", "pack", "spmv"]
