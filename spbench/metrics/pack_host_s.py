"""The host pack's seconds in set-up: the port's ``SETUP`` phase
``pack`` (the route's row scan, the host packs of every value plane, the
host finish build), always on, read after the run."""
from sparsetpu_torch.utils import timing

KIND, UNIT = "per_layer", "s"


def read(run):
    setup = getattr(timing, "SETUP", None)
    return None if setup is None else setup.phases.get("pack")
