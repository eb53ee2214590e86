from .bsr import BSRDevice, bsr_partials, bsr_partials_reference, bsr_spmv
from .spmm import (final_gather_multi, final_gather_multi_reference,
                   gstream_chunk_sums_multi,
                   gstream_chunk_sums_multi_reference, spmm_gstream)
from .spgemm import SpGEMMPlan, spgemm
from .spmv_coo import spmm_coo, spmv_chunked, spmv_coo
from .spmv_fused import (FusedDevice, fused_spmm, fused_spmm_reference,
                         fused_spmv, fused_spmv_reference)
from .spmv_gstream import (GStreamDevice, final_gather,
                           final_gather_reference, gstream_chunk_sums,
                           gstream_chunk_sums_reference)

__all__ = ["BSRDevice", "FusedDevice", "GStreamDevice", "SpGEMMPlan",
           "bsr_partials", "bsr_partials_reference", "bsr_spmv",
           "final_gather",
           "final_gather_multi", "final_gather_multi_reference",
           "final_gather_reference", "fused_spmm", "fused_spmm_reference",
           "fused_spmv", "fused_spmv_reference", "gstream_chunk_sums",
           "gstream_chunk_sums_multi", "gstream_chunk_sums_multi_reference",
           "gstream_chunk_sums_reference", "spmm_coo", "spmm_gstream",
           "spgemm", "spmv_chunked", "spmv_coo"]
