"""The yardstick's constants: each card's data-sheet memory bandwidth, and
the bytes a CSR SpMV has to move, whatever implements it."""

from __future__ import annotations

# Device-memory GB/s from NVIDIA's data sheets, matched against
# torch.cuda.get_device_name() in this order (the SXM H100 reports itself
# as "NVIDIA H100 80GB HBM3").
HBM_GBPS = {
    "H100 NVL": 3900.0,
    "H100 PCIe": 2000.0,
    "H100 SXM": 3350.0,
    "H100 80GB HBM3": 3350.0,
    "H200": 4800.0,
}

INDEX_BYTES = 4


def hbm_gbps(device_name: str) -> float:
    """Data-sheet bandwidth of the card named ``device_name``; raises for a
    card not in the table rather than guess."""
    for key, gbps in HBM_GBPS.items():
        if key in device_name:
            return gbps
    raise KeyError(f"no HBM bandwidth on record for {device_name!r}")


def csr_spmv_bytes(nr_rows: int, nr_cols: int, nnz: int,
                   value_bytes: int) -> int:
    """Each input read once and the output written once: the values and
    their column indices, the row pointers, x and y."""
    return (nnz * (value_bytes + INDEX_BYTES) + (nr_rows + 1) * INDEX_BYTES
            + nr_cols * value_bytes + nr_rows * value_bytes)
