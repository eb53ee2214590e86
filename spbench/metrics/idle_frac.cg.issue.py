"""The share of the traced sets' window in which the device is idle while
the host issues an iteration: inside a ``sparsetpu.pcg.iter`` span and
outside its ``sparsetpu.pcg.check``.  Idle is the complement of the union
of the device's kernels, memsets and copies, as ``idle_frac.cg`` reads
it."""
from spbench.metrics import _spans

KIND, UNIT = "per_layer", "frac"


def read(run):
    tr = run.traces.get("cg")
    if tr is None:
        return None
    iters = _spans.named(tr, "pcg.iter")
    if not len(iters):
        return None
    lo, hi = tr.window_us

    def clipped(events):
        return _spans.merged((max(e.start_us, lo), min(e.end_us, hi))
                             for e in events)
    issue = _spans.minus(clipped(iters.events),
                         clipped(_spans.named(tr, "pcg.check").events))
    idle = _spans.minus(issue, clipped(tr.device))
    return _spans.length(idle) / (hi - lo)
