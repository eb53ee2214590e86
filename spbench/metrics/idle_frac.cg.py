"""Idle share of the device over traced whole CG sets."""
from spbench.metrics._idle import idle

KIND, UNIT = "per_layer", "frac"


def read(run):
    return idle(run, "cg")
