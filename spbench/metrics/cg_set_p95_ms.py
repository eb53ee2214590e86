"""The 95th percentile of the window's CG set times (linear
interpolation between order statistics).  A tail of host-bound sets: its
spread between runs passes half of any bound allowed, so it is read in
the traced runs and held to none."""
import numpy as np

KIND, UNIT = "per_layer", "ms"


def read(run):
    sets = run.spans.get("cg_set")
    return float(np.percentile(sets, 95)) * 1e3 if sets else None
