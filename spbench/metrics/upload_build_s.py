"""The device constructors' seconds in set-up: the port's ``SETUP`` phases
``upload`` (the constructors' copies and checks), ``final_rows`` (the
final level's builds) and ``live_slots`` (``LiveSlots.build``), always
on, read after the run."""
from sparsetpu_torch.utils import timing

KIND, UNIT = "per_layer", "s"
PHASES = ("upload", "final_rows", "live_slots")


def read(run):
    setup = getattr(timing, "SETUP", None)
    if setup is None:
        return None
    found = [setup.phases[p] for p in PHASES if p in setup.phases]
    return sum(found) if found else None
