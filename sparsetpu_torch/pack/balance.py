"""Load-balanced row partitioning.

Generalizes the reference's ``prepare_balanced_hw_matrix`` family
(csr_hw.cpp:327-1237): the reference greedily splits non-empty rows across
1-12 compute units at breakpoints where the running nnz exceeds the
per-CU share, aligned to the vector factor (conditions S1-S3,
csr_hw.cpp:459-468).  On TPU the "compute units" axis is a single
``num_partitions`` parameter (a Pallas grid dimension or a mesh shard
axis), so one parameterized routine replaces the six textual replicas.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..formats.csr import CSRMatrix


@dataclasses.dataclass
class RowPartition:
    """Per-partition contiguous row ranges (row_start inclusive,
    row_end exclusive) chosen so nnz is near-balanced."""

    row_start: np.ndarray   # (num_partitions,)
    row_end: np.ndarray     # (num_partitions,)
    nnz: np.ndarray         # (num_partitions,) nnz per partition

    @property
    def num_partitions(self) -> int:
        return int(self.row_start.shape[0])


def balance_rows(matrix: CSRMatrix, num_partitions: int,
                 align_rows: int = 1) -> RowPartition:
    """Greedy nnz-balanced split of rows into ``num_partitions`` contiguous
    ranges (csr_hw.cpp:459-468 S1 condition, vectorized via searchsorted).

    ``align_rows`` rounds boundaries down to a multiple (the reference's S3
    ``row_cnt % RATIO_v == 0`` alignment); the last partition absorbs the
    remainder, like the reference's tail padding (csr_hw.cpp:776-781).
    """
    nnz = matrix.nr_nzeros
    cum = matrix.row_ptr.astype(np.int64)
    targets = (np.arange(1, num_partitions, dtype=np.int64) * nnz
               ) // num_partitions
    # boundary rows: first row whose cumulative nnz reaches each target
    bounds = np.searchsorted(cum[1:], targets, side="left") + 1
    if align_rows > 1:
        bounds = (bounds // align_rows) * align_rows
    bounds = np.clip(bounds, 0, matrix.nr_rows)
    bounds = np.maximum.accumulate(bounds)
    starts = np.concatenate([[0], bounds]).astype(np.int64)
    ends = np.concatenate([bounds, [matrix.nr_rows]]).astype(np.int64)
    part_nnz = cum[ends] - cum[starts]
    return RowPartition(starts, ends, part_nnz)


def balance_report(p: RowPartition) -> str:
    total = int(p.nnz.sum())
    ideal = total / max(p.num_partitions, 1)
    imbalance = float(p.nnz.max() / ideal) if ideal else 1.0
    return (f"partitions={p.num_partitions} nnz={total} "
            f"max/ideal imbalance={imbalance:.3f}")
