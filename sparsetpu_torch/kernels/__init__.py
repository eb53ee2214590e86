from .spmv_coo import spmm_coo, spmv_chunked, spmv_coo
from .spmv_fused import FusedDevice, fused_spmv, fused_spmv_reference
from .spmv_gstream import (GStreamDevice, final_gather,
                           final_gather_reference, gstream_chunk_sums,
                           gstream_chunk_sums_reference)

__all__ = ["FusedDevice", "GStreamDevice", "final_gather",
           "final_gather_reference", "fused_spmv", "fused_spmv_reference",
           "gstream_chunk_sums", "gstream_chunk_sums_reference", "spmm_coo",
           "spmv_chunked", "spmv_coo"]
