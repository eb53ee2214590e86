"""The CSR bound (each value and column index, the row pointers, x and y
moved once, at the card's data-sheet bandwidth) / the device time a call
of a held burst, in percent.  The bound counts the generated matrix's CSR
bytes, never the pack's, so a layout that moves more cannot raise it."""
from spbench import roofline

KIND, UNIT = "per_layer", "%"


def read(run):
    if not run.held_ms:
        return None
    bound_s = roofline.csr_spmv_bytes(
        run.nr_rows, run.nr_cols, run.nnz, run.value_bytes) / (
        roofline.hbm_gbps(run.device_name) * 1e9)
    return 100.0 * bound_s / (run.held_ms * 1e-3)
