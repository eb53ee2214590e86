from .bsr import BSRDevice, bsr_partials, bsr_partials_reference, bsr_spmv
# (the wrapper final_rows stays under its module, whose name it shares)
from .final_rows import (FinalRows, final_rows_multi,
                         final_rows_multi_reference, final_rows_reference)
from .spmm import (final_gather_multi_reference, gstream_chunk_sums_multi,
                   gstream_chunk_sums_multi_reference, spmm_gstream)
from .spgemm import SpGEMMPlan, spgemm
from .spmv_coo import (spmm_coo, spmm_coo_xla, spmv_chunked,
                       spmv_chunked_xla, spmv_coo, spmv_coo_xla)
from .spmv_fused import (FusedDevice, fused_spmm, fused_spmm_reference,
                         fused_spmv, fused_spmv_reference)
from .spmv_gstream import (GStreamDevice, final_gather_reference,
                           gstream_chunk_sums, gstream_chunk_sums_reference)

__all__ = ["BSRDevice", "FusedDevice", "GStreamDevice", "SpGEMMPlan",
           "bsr_partials", "bsr_partials_reference", "bsr_spmv",
           "FinalRows", "final_rows_multi",
           "final_rows_multi_reference", "final_rows_reference",
           "final_gather_multi_reference",
           "final_gather_reference", "fused_spmm", "fused_spmm_reference",
           "fused_spmv", "fused_spmv_reference", "gstream_chunk_sums",
           "gstream_chunk_sums_multi", "gstream_chunk_sums_multi_reference",
           "gstream_chunk_sums_reference", "spmm_coo", "spmm_coo_xla",
           "spmm_gstream", "spgemm", "spmv_chunked", "spmv_chunked_xla",
           "spmv_coo", "spmv_coo_xla"]
