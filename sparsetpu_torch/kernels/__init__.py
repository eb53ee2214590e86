from .spmv_coo import spmm_coo, spmv_chunked, spmv_coo
from .spmv_fused import FusedDevice, fused_spmv, fused_spmv_reference

__all__ = ["FusedDevice", "fused_spmv", "fused_spmv_reference", "spmm_coo",
           "spmv_chunked", "spmv_coo"]
