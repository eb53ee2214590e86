"""The host pack engines (the port's own copy of the JAX package's
``pack/``): the fused resident-x pack, the classic GStream pack, row
balancing, the layout model's rate tables, and the final-level builders;
the scan, balance and ``gather_stream`` names of ``sparsetpu.pack``."""

from .scan import BlockScan, scan_matrix
from .balance import RowPartition, balance_report, balance_rows
from .gather_stream import (GStreamMatrix, pack_gstream, unpack_gstream,
                            CHUNK, STRIPE, TILE_CHUNKS, TILE_NNZ)

__all__ = [
    "BlockScan", "scan_matrix", "RowPartition", "balance_report",
    "balance_rows", "GStreamMatrix", "pack_gstream", "unpack_gstream",
    "CHUNK", "STRIPE", "TILE_CHUNKS", "TILE_NNZ",
]
