"""Host microseconds of a traced ``sm @ x`` outside its launches: the mean
over the ``sparsetpu.spmv`` spans of the traced slice of each span's
length less the union of the ``sparsetpu.launch.*`` spans inside it
(routing, x's conversion and checks, the device module's own work).  On
the profiler's clock, so the profiler's own host cost is in it."""
from spbench.metrics import _spans

KIND, UNIT = "per_layer", "us"


def read(run):
    tr = run.traces.get("spmv")
    if tr is None:
        return None
    return _spans.less_children(_spans.named(tr, "spmv"),
                                _spans.prefixed(tr, "launch."))
