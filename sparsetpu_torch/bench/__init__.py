from .harness import BenchResult, bench_spmv, call_ms, stream_ms

__all__ = ["BenchResult", "bench_spmv", "call_ms", "stream_ms"]
