"""The share of the traced sets' iterations that the solver replayed as
one CUDA graph: the ``sparsetpu.pcg.iter`` spans that hold a
``sparsetpu.pcg.replay``, over the iterations the sets ran.  0 where
every iteration ran eagerly; None without the iteration spans."""
from spbench.metrics import _spans

KIND, UNIT = "per_layer", "frac"


def read(run):
    tr = run.traces.get("cg")
    its = run.counts.get("trace_iterations")
    if tr is None or not its:
        return None
    iters = _spans.named(tr, "pcg.iter")
    if not len(iters):
        return None
    replays = _spans.named(tr, "pcg.replay")
    return sum(1 for it in iters.events if replays.inside(it)) / its
