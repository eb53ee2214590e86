"""Host microseconds a traced CG iteration spends issuing work: the mean
over the ``sparsetpu.pcg.iter`` spans of the traced sets of each span's
length less its ``sparsetpu.pcg.check`` (the host's read of the
convergence test, where the device drains).  On the profiler's clock, so
the profiler's own host cost is in it."""
from spbench.metrics import _spans

KIND, UNIT = "per_layer", "us"


def read(run):
    tr = run.traces.get("cg")
    if tr is None:
        return None
    return _spans.less_children(_spans.named(tr, "pcg.iter"),
                                _spans.named(tr, "pcg.check"))
