from .harness import (BenchResult, bench_spmv, call_ms, detect_hbm_gbps,
                      stream_ms)
from .scaling import scaling_report

__all__ = ["BenchResult", "bench_spmv", "call_ms", "detect_hbm_gbps",
           "scaling_report", "stream_ms"]
