"""Device work a traced CG iteration enqueues: the host runtime's kernel
launches, memsets, copies and graph launches that start inside a
``sparsetpu.pcg.iter`` span of the traced sets, over the iterations."""
from spbench.metrics import _spans

KIND, UNIT = "per_layer", "count"


def read(run):
    tr = run.traces.get("cg")
    if tr is None:
        return None
    return _spans.enqueues_per(_spans.named(tr, "pcg.iter"), tr)
