"""Device work a traced ``sm @ x`` enqueues: the host runtime's kernel
launches, memsets, copies and graph launches that start inside a
``sparsetpu.spmv`` span of the traced slice, over the spans."""
from spbench.metrics import _spans

KIND, UNIT = "per_layer", "count"


def read(run):
    tr = run.traces.get("spmv")
    if tr is None:
        return None
    return _spans.enqueues_per(_spans.named(tr, "spmv"), tr)
