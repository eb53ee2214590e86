"""Process start to the first timed call: generation, pack, upload and the
warm-up of the cell's own shapes."""
KIND, UNIT = "end_to_end", "s"


def read(run):
    return run.setup_s
