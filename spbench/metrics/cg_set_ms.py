"""The whole window / the CG sets completed in it."""
KIND, UNIT = "end_to_end", "ms"


def read(run):
    sets = run.counts.get("sets")
    return run.window_s / sets * 1e3 if sets else None
