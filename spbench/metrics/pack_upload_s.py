"""The benchmark's clock around ``SparseMatrix(...)`` and a sync: the host
pack, the finish build and the upload constructors."""
KIND, UNIT = "per_layer", "s"


def read(run):
    spans = run.spans.get("pack_upload")
    return spans[0] if spans else None
