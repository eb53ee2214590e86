"""Mean host microseconds of an ``sm @ x`` in the window: perf_counter
spans around each call, which returns once its launches are queued."""
KIND, UNIT = "per_layer", "us"


def read(run):
    spans = run.spans.get("spmv_call")
    return sum(spans) / len(spans) * 1e6 if spans else None
