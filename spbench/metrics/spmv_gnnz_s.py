"""nnz x calls completed / wall seconds of the whole window, which ends in
a sync."""
KIND, UNIT = "end_to_end", "Gnnz/s"


def read(run):
    calls = run.counts.get("calls")
    return run.nnz * calls / run.window_s / 1e9 if calls else None
