"""Reference-parity packed format: the 128-bit interleaved stream.

Bit-exact re-implementation (vectorized NumPy, no scalar loops) of the
reference's FPGA stream format, kept for format parity, interchange and
as the serialization target:

  * 2D column blocking with per-block rebased column indices
    (create_block_matrix, csr_hw.cpp:190-265)
  * per-row zero padding to a VectFactor multiple (csr_hw.cpp:229-238)
  * greedy nnz-balanced partitioning with empty-row compaction and an
    empty-rows bitmap (prepare_balanced_hw_matrix, csr_hw.cpp:327-1237)
  * bit-packing into 128-bit bus words: 8 x 16-bit entries per index word
    (15-bit in-block column index at bits [14:0], end-of-row flag at bit
    15 on the padded last element of each row), interleaved with value
    words every RATIO_col_val words (generate_balanced_hw_submatrix,
    csr_hw.cpp:270-318; word layout README.md:63, util.h:61-67)
  * partial-y accumulation with bitmap-guided row skip
    (accum_results, csr_hw.cpp:1531-1565)
  * packed x vector per block with zero tail padding
    (write_csr_hw_vector, csr_hw.cpp:1470-1488)

The stream is represented as a uint16 array of shape (n_words, 8) — one
row per 128-bit bus word (ap_uint<128> little-endian 16-bit limbs).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..formats.csr import CSRMatrix
from ..pack.balance import balance_rows
from ..utils.config import SpmvConfig

BUS_BITS = 128                  # util.h:61
RATIO_CI = 8                    # 16-bit packed indices per word, util.h:64
COL_BITS = 15                   # in-block column index width
EOR_BIT = 15                    # end-of-row flag bit (csr_hw.cpp:288-292)


def _ratio_v(dtype) -> int:
    """Values per 128-bit word: 2 for f64, 4 for f32 (util.h:63)."""
    return BUS_BITS // (np.dtype(dtype).itemsize * 8)


def _ratio_col_val(dtype) -> int:
    """Stream period: 1 index word + (RATIO_ci/RATIO_v) value words per
    group of 8 nnz (util.h:67): 5 for f64, 3 for f32."""
    return RATIO_CI // _ratio_v(dtype) + 1


@dataclasses.dataclass
class PackedSubmatrix:
    """One (partition, block) packed stream (csr_hw_matrix per-block slice,
    csr_hw.h:16-26)."""

    stream: np.ndarray        # (n_words, 8) uint16 bus words
    nr_rows: int              # compacted (non-empty) rows, padded
    nr_nzeros: int            # padded nnz in this block for this partition
    nr_ci: int                # index words (csr_hw.cpp:174-178)
    nr_val: int               # value words (csr_hw.cpp:179)


@dataclasses.dataclass
class BlockedHwMatrix:
    """create_csr_hw_matrix output: per-partition, per-block streams +
    the empty-rows bitmap (README.md:38)."""

    submatrices: List[List[PackedSubmatrix]]   # [partition][block]
    empty_rows_bitmap: np.ndarray              # (blocks, nr_rows) bool
    part_row_start: np.ndarray                 # (P,) partition row ranges
    part_row_end: np.ndarray
    nr_rows: int
    nr_cols: int
    nr_nzeros: int
    block_cols: int
    vf: int
    dtype: np.dtype

    @property
    def nr_blocks(self) -> int:
        return len(self.submatrices[0]) if self.submatrices else 0

    @property
    def num_partitions(self) -> int:
        return len(self.submatrices)

    def storage_bytes(self) -> int:
        """Total packed MB moved (csr_hw.cpp:420-421)."""
        return sum(s.stream.nbytes for row in self.submatrices for s in row)

    def storage_overhead(self) -> float:
        """Packed vs plain CSR (csr_hw.cpp:1401-1409)."""
        csr = (self.nr_nzeros * (self.dtype.itemsize + 4)
               + 4 * (self.nr_rows + 1))
        return self.storage_bytes() / max(csr, 1)


def _pack_one(rows, cols, vals, thres_l, vf, dtype):
    """Pack one (partition, block)'s row-major (row, col, val) triplets into
    the interleaved word stream.  Vectorized replica of
    generate_balanced_hw_submatrix (csr_hw.cpp:270-318)."""
    ratio_v = _ratio_v(dtype)
    period = _ratio_col_val(dtype)

    # per-row pad to vf multiple (csr_hw.cpp:108-114); empty rows are
    # already compacted away by the caller (csr_hw.cpp:213 guard)
    rows_u, counts = np.unique(rows, return_counts=True)
    padded = -(-counts // vf) * vf
    total = int(padded.sum())
    # pad the padded-nnz total itself to a whole group of RATIO_CI
    total_g = -(-total // RATIO_CI) * RATIO_CI

    local = np.zeros(total_g, dtype=np.uint16)
    value = np.zeros(total_g, dtype=dtype)
    eor = np.zeros(total_g, dtype=bool)

    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    row_first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = (np.repeat(starts, counts)
           + np.arange(rows.shape[0]) - np.repeat(row_first, counts))
    lc = (cols - thres_l).astype(np.uint16)
    if lc.size and int(lc.max()) >= (1 << COL_BITS):
        raise ValueError("in-block column index exceeds 15 bits "
                         "(block_cols too large, csr_hw.cpp:288)")
    local[pos] = lc
    value[pos] = vals
    # end-of-row flag on the (padded) LAST element of each row
    # (csr_hw.cpp:288-292): position starts[i] + padded[i] - 1
    eor[(starts + padded - 1)] = True
    # pads reuse local col 0 and value 0 (harmless MAC, like the reference's
    # zero-value pads, csr_hw.cpp:246-255)

    # words: per group of 8 nnz: 1 index word + ratio_ci/ratio_v value words
    n_groups = total_g // RATIO_CI
    idx_words = (local | (eor.astype(np.uint16) << EOR_BIT)
                 ).reshape(n_groups, RATIO_CI)
    # values bit-cast to 16-bit limbs (Union_double_uint, util.h:71-74)
    limbs_per_val = np.dtype(dtype).itemsize // 2
    val_limbs = value.view(np.uint16).reshape(
        n_groups, RATIO_CI, limbs_per_val)
    val_words = val_limbs.reshape(n_groups, period - 1, RATIO_CI)
    stream = np.concatenate([idx_words[:, None, :], val_words], axis=1)
    stream = stream.reshape(n_groups * period, RATIO_CI)

    n_ci = n_groups
    n_val = n_groups * (period - 1)
    return PackedSubmatrix(stream=stream, nr_rows=int(rows_u.shape[0]),
                           nr_nzeros=total_g, nr_ci=n_ci, nr_val=n_val)


def pack_blocked(matrix: CSRMatrix, config: Optional[SpmvConfig] = None
                 ) -> BlockedHwMatrix:
    """create_csr_hw_matrix (csr_hw_wrapper.cpp:3-80 + csr_hw.cpp:377-1398)
    for any num_partitions."""
    cfg = config or SpmvConfig(dtype=matrix.dtype)
    bc = cfg.block_cols
    n_blocks = cfg.nr_blocks(matrix.nr_cols)
    part = balance_rows(matrix, cfg.num_partitions)

    rows_all = np.repeat(np.arange(matrix.nr_rows, dtype=np.int64),
                         matrix.row_nnz())
    cols_all = matrix.col_ind.astype(np.int64)
    blk_all = cols_all // bc

    bitmap = np.ones((n_blocks, matrix.nr_rows), dtype=bool)
    subs: List[List[PackedSubmatrix]] = []
    for p in range(cfg.num_partitions):
        r0, r1 = int(part.row_start[p]), int(part.row_end[p])
        prow: List[PackedSubmatrix] = []
        in_part = (rows_all >= r0) & (rows_all < r1)
        for b in range(n_blocks):
            m = in_part & (blk_all == b)
            r, c, v = rows_all[m], cols_all[m], matrix.values[m]
            bitmap[b][np.unique(r)] = False
            if r.shape[0] == 0:
                prow.append(PackedSubmatrix(
                    np.zeros((0, RATIO_CI), np.uint16), 0, 0, 0, 0))
            else:
                prow.append(_pack_one(r, c, v.astype(cfg.dtype), b * bc,
                                      cfg.vf or 1, cfg.dtype))
        subs.append(prow)
    return BlockedHwMatrix(
        submatrices=subs, empty_rows_bitmap=bitmap,
        part_row_start=part.row_start, part_row_end=part.row_end,
        nr_rows=matrix.nr_rows, nr_cols=matrix.nr_cols,
        nr_nzeros=matrix.nr_nzeros, block_cols=bc, vf=cfg.vf or 1,
        dtype=np.dtype(cfg.dtype))


def unpack_stream(sub: PackedSubmatrix, dtype) -> tuple:
    """Decode one stream back to (local_cols, eor_flags, values) —
    print_wide's (csr_hw.cpp:1493-1521) machine-readable sibling, also the
    spmv-emulation input."""
    period = _ratio_col_val(dtype)
    n_groups = sub.nr_ci
    words = sub.stream.reshape(n_groups, period, RATIO_CI)
    idx = words[:, 0, :]
    local = (idx & ((1 << COL_BITS) - 1)).astype(np.int64).reshape(-1)
    eor = (idx >> EOR_BIT).astype(bool).reshape(-1)
    limbs = words[:, 1:, :].reshape(n_groups, -1)
    vals = limbs.view(np.uint16).reshape(-1).view(dtype)
    return local, eor, vals


def spmv_blocked_emulated(hw: BlockedHwMatrix, x: np.ndarray) -> np.ndarray:
    """Execute the packed streams with the device kernel's semantics on the
    host (the reference's sdsoc_emulator role, Makefile:103-112): stream
    decode -> MAC with row-end emission (compute_results, spmv.cpp:66-104)
    -> bitmap-guided accumulation (accum_results, csr_hw.cpp:1531-1565)."""
    y = np.zeros(hw.nr_rows, dtype=hw.dtype)
    bc = hw.block_cols
    for p in range(hw.num_partitions):
        r0, r1 = int(hw.part_row_start[p]), int(hw.part_row_end[p])
        for b, sub in enumerate(hw.submatrices[p]):
            if sub.nr_nzeros == 0:
                continue
            local, eor, vals = unpack_stream(sub, hw.dtype)
            xs = x[b * bc:(b + 1) * bc]
            xs = np.pad(xs, (0, bc - xs.shape[0]))
            terms = vals * xs[local]
            # rows end where eor is set: segment boundaries
            ends = np.flatnonzero(eor)
            seg = np.zeros(terms.shape[0], dtype=np.int64)
            seg[ends[:-1] + 1] = 1
            seg = np.cumsum(seg)
            partial = np.zeros(ends.shape[0], dtype=hw.dtype)
            np.add.at(partial, seg, terms)
            # bitmap-guided scatter (+= across blocks, csr_hw.cpp:1555)
            present = np.flatnonzero(~hw.empty_rows_bitmap[b][r0:r1]) + r0
            y[present] += partial[:present.shape[0]]
    return y


def write_hw_x_vector(x: np.ndarray, nr_blocks: int, block_cols: int,
                      dtype) -> np.ndarray:
    """Packed per-block x (write_csr_hw_vector, csr_hw.cpp:1470-1488):
    (nr_blocks, block_cols) with zero padding past nr_cols."""
    out = np.zeros((nr_blocks, block_cols), dtype=dtype)
    flat = out.reshape(-1)
    flat[:x.shape[0]] = x
    return out


def print_wide(sub: PackedSubmatrix, dtype, max_words: int = 16) -> str:
    """Debug dump of packed words (print_wide, csr_hw.cpp:1493-1521)."""
    lines = []
    period = _ratio_col_val(dtype)
    for w in range(min(sub.stream.shape[0], max_words)):
        limbs = sub.stream[w]
        if w % period == 0:
            cols = [f"{int(v) & 0x7fff}{'*' if v >> 15 else ''}"
                    for v in limbs]
            lines.append(f"[{w:4d}] idx: " + " ".join(cols))
        else:
            vals = limbs.view(np.uint16).view(dtype)
            lines.append(f"[{w:4d}] val: "
                         + " ".join(f"{float(v):.4g}" for v in vals))
    return "\n".join(lines)
