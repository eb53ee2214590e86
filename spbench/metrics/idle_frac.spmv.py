"""Idle share of the device over a traced slice of ``sm @ x`` blocks, as
the window issues them."""
from spbench.metrics._idle import idle

KIND, UNIT = "per_layer", "frac"


def read(run):
    return idle(run, "spmv")
