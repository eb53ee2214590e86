"""BSR SpMV on the card: dense (8, 128) blocks (counterpart of
``sparsetpu/kernels/bsr.py``).

``BSRDevice`` holds a ``BSRMatrix`` with (8, 128) blocks as f32 buffers,
laid out as the JAX ``BSRDevice`` lays it out (``bsr.py:76-111``): the
blocks padded to a multiple of ``BLOCKS_PER_STEP`` with zero blocks at
block column 0 and block row ``nr_block_rows`` (the trap), and the block-row
reduction built as a legacy final level whose child (block b, local row i)
at position 8b + i belongs to y row 8 * brow[b] + i.  ``spmv`` is

  partials  ``bsr_partials``: the (n_blocks, 8) row sums of every block
            times its x segment (``csrc/bsr_spmv.cu``);
  final     the legacy final level over the partials, as its row-sorted
            gather-sum (``final_rows.final_rows``, built at upload from the
            level's tables), or, where no final builds, a segment sum over
            the block rows by ``index_add_``.

The padding is kept although the card's grid does not need it: the final
level is then byte-identical to the JAX package's.  The TPU kernel packs
16 blocks' sums into lanes of an (8, 128) tile; that is its layout, not
the function, and the port writes the (n_blocks, 8) partials directly.
Values, x and y are f32, as on the TPU (an f64 ``BSRMatrix`` is rounded).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from ..pack.final_levels import _FinalLevel
from ..utils.device import CUDA, pick_device
from ._build import check, library
from .spmv_gstream import _require, final_device

BH, BW = 8, 128              # the block shape the device takes
# block row sums the TPU kernel packs into one (8, 128) output tile
# (``bsr.py:27``); the card's kernel writes the (n_blocks, 8) sums directly
GROUP = 16


def _check_partials(blocks, bcol, x2) -> int:
    """Dtype, device, contiguity, shape and alignment checks shared by the
    kernel and its plain version; returns the block count."""
    dev = x2.device
    _require(blocks, "blocks", (torch.float32,), dev)
    _require(bcol, "bcol", (torch.int32,), dev)
    _require(x2, "x2", (torch.float32,), dev)
    nb = bcol.shape[0]
    if bcol.dim() != 1 or tuple(blocks.shape) != (nb * BH, BW):
        raise ValueError(f"blocks must be (n_blocks*8, 128) for n_blocks="
                         f"{nb}, got {tuple(blocks.shape)}")
    if x2.dim() != 2 or x2.shape[1] != BW:
        raise ValueError("x2 must be (padded_cols / 128, 128)")
    return nb


def bsr_partials_reference(blocks, bcol, x2) -> torch.Tensor:
    """Plain PyTorch version of the BSR kernel: (n_blocks, 8) row sums of
    each (8, 128) block times the x segment at its block column."""
    nb = _check_partials(blocks, bcol, x2)
    return (blocks.view(nb, BH, BW) * x2[bcol.long()][:, None, :]).sum(-1)


def bsr_partials(blocks, bcol, x2) -> torch.Tensor:
    """The BSR kernel: (n_blocks, 8) f32 row sums.

    On CUDA tensors it launches ``csrc/bsr_spmv.cu`` on the current stream
    (or raises); on CPU tensors it runs ``bsr_partials_reference``.  Every
    ``bcol`` must index a row of ``x2`` (``BSRDevice`` checks at upload).
    ``bsr_partials.launches`` counts launches."""
    if x2.device.type == "cpu":
        return bsr_partials_reference(blocks, bcol, x2)
    if x2.device.type != "cuda":
        raise ValueError(f"bsr_partials: unsupported device {x2.device}")
    nb = _check_partials(blocks, bcol, x2)
    if blocks.data_ptr() % 16 or x2.data_ptr() % 16:
        raise ValueError("bsr_partials: blocks and x2 must be 16-byte "
                         "aligned (float4 loads)")
    out = torch.empty(nb, BH, device=x2.device)
    if nb == 0:
        return out
    lib = library().lib
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.bsr_spmv_launch(
            ctypes.c_void_p(blocks.data_ptr()),
            ctypes.c_void_p(bcol.data_ptr()), ctypes.c_void_p(x2.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), nb, ctypes.c_void_p(stream))
    check(lib, rc, "bsr_partials launch")
    bsr_partials.launches += 1
    return out


bsr_partials.launches = 0


class BSRDevice(nn.Module):
    """A ``BSRMatrix`` with (8, 128) blocks held on one device; ``spmv`` is
    y = A @ x through the BSR kernel and the block-row final level.

    Reads only ``row_ptr``, ``col_ind``, ``values`` and ``shape``, so it
    takes a ``BSRMatrix`` of either package."""

    BLOCKS_PER_STEP = 64

    def __init__(self, m, interpret=False, *, device=CUDA):
        super().__init__()
        vals = np.asarray(m.values)
        if vals.ndim != 3 or vals.shape[1:] != (BH, BW):
            raise ValueError(f"device BSR requires {(BH, BW)} blocks")
        dev = pick_device(device, interpret)
        self.nr_rows, self.nr_cols = m.shape
        self.nr_block_rows = int(m.row_ptr.shape[0]) - 1
        nb = vals.shape[0]
        pad = (-nb) % self.BLOCKS_PER_STEP
        self.n_blocks = nb + pad
        self.padded_cols = -(-self.nr_cols // BW) * BW
        blocks = np.zeros((self.n_blocks, BH, BW), np.float32)
        blocks[:nb] = vals
        bcol = np.concatenate([np.asarray(m.col_ind, np.int32),
                               np.zeros(pad, np.int32)])
        if bcol.size and (bcol.min() < 0
                          or bcol.max() >= self.padded_cols // BW):
            raise ValueError("a block column lies outside the padded x")
        brow = np.repeat(np.arange(self.nr_block_rows, dtype=np.int64),
                         np.diff(np.asarray(m.row_ptr, np.int64)))
        brow = np.concatenate(
            [brow, np.full(pad, self.nr_block_rows, np.int64)])
        if brow.size != self.n_blocks:
            raise ValueError("row_ptr does not count the blocks")
        self.register_buffer("blocks", torch.from_numpy(
            blocks.reshape(-1, BW)).to(dev))
        self.register_buffer("bcol", torch.from_numpy(bcol).to(dev))
        # block-row reduction as a fixed-position final level (the JAX
        # device's): child (block b, local row i) at position 8b + i
        # belongs to y row 8 * brow[b] + i; padded blocks go to the trap
        self.rows_pad = self.nr_block_rows * BH
        child_row = (brow[:, None] * BH + np.arange(BH)[None, :]).reshape(-1)
        child_row[child_row >= self.rows_pad] = self.rows_pad
        self.plan = _FinalLevel.build(child_row, self.rows_pad)
        self.final = (final_device(self.plan, self.rows_pad, child_row.size,
                                   dev)
                      if self.plan is not None else None)
        self.register_buffer("brow", torch.from_numpy(brow).to(dev)
                             if self.plan is None else None)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def prepare_x(self, x) -> torch.Tensor:
        """x (nr_cols,) -> the (padded_cols / 128, 128) f32 segment matrix,
        zero-padded past nr_cols."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if tuple(x.shape) != (self.nr_cols,):
            raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                             f"({self.nr_cols},)")
        return nn.functional.pad(
            x, (0, self.padded_cols - self.nr_cols)).view(-1, BW)

    def partials(self, x2: torch.Tensor, kernel=None) -> torch.Tensor:
        """The (n_blocks, 8) row sums through ``kernel`` (default the
        wrapper ``bsr_partials``; ``bsr_partials_reference`` to compare)."""
        if tuple(x2.shape) != (self.padded_cols // BW, BW):
            # the block columns were checked against this shape at upload
            raise ValueError(f"x2 has shape {tuple(x2.shape)}, expected "
                             f"{(self.padded_cols // BW, BW)}")
        return (kernel or bsr_partials)(self.blocks, self.bcol, x2)

    def spmv(self, x) -> torch.Tensor:
        """y = A @ x, f32, on this device."""
        parts8 = self.partials(self.prepare_x(x))
        if self.final is not None:
            return self.final.apply(parts8.reshape(-1))[:self.nr_rows]
        ysum = torch.zeros(self.nr_block_rows + 1, BH, device=self.device)
        ysum.index_add_(0, self.brow, parts8)
        return ysum[:self.nr_block_rows].reshape(-1)[:self.nr_rows]


def bsr_spmv(m, x, interpret=False, *, device=CUDA) -> torch.Tensor:
    """y = A @ x for a ``BSRMatrix`` with (8, 128) blocks."""
    return BSRDevice(m, interpret, device=device).spmv(x)
