"""The device's idle share of a traced slice's window: one minus the
union of its kernels', memsets' and copies' intervals over the window."""
from spbench import timing


def idle(run, key):
    tr = run.traces.get(key)
    if tr is None:
        return None
    lo, hi = tr.window_us
    return 1.0 - timing.busy_us(tr.device, lo, hi) / (hi - lo)
