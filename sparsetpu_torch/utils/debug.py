"""Packed-format debug dumps — the reference's ``print_wide``
(csr_hw.cpp:1493-1521), which prints packed 128-bit words in value or
index+flag view, re-targeted at GStream tiles."""

from __future__ import annotations

import numpy as np


def dump_tiles(packed, start: int = 0, count: int = 1, lanes: int = 8,
               file=None) -> str:
    """Human-readable dump of GStream tiles [start, start+count): per tile
    the chunk->row map and, per lane, the (slot value, cell stripe, route)
    triples that drive the dual gather.  ``lanes`` limits the printed lane
    columns (a full tile has 128)."""
    import sys
    file = file or sys.stdout
    n_tiles = packed.n_tiles
    vals = packed.values.reshape(n_tiles, 8, 128)
    cells = packed.cell_idx.reshape(n_tiles, 8, 128)
    route = packed.route.reshape(n_tiles, 8, 128)
    P = packed.planes
    rows = packed.chunk_row.reshape(n_tiles, P, 128)
    out = []
    for t in range(start, min(start + count, n_tiles)):
        out.append(f"tile {t} (window step {t // packed.tiles_per_step}, "
                   f"x-window {packed.step_window[t // packed.tiles_per_step]})")
        for p in range(P):
            out.append(f"  chunk rows (plane {p}): "
                       + " ".join(f"{int(r)}" if r != packed.nr_rows
                                  else "-"
                                  for r in rows[t, p, :lanes])
                       + (" ..." if lanes < 128 else ""))
        for s in range(8):
            cols = []
            for l in range(min(lanes, 128)):
                v = vals[t, s, l]
                cols.append(f"{v:+.3g}/r{int(route[t, s, l])}")
            out.append(f"  slot {s}: " + " ".join(cols))
        out.append("  cells[s, residue] stripes (first "
                   f"{lanes} residues):")
        for s in range(8):
            out.append("    " + " ".join(f"{int(cells[t, s, r]):4d}"
                                         for r in range(lanes)))
    text = "\n".join(out)
    print(text, file=file)
    return text


def format_stats(packed) -> str:
    """One-line summary of a packed matrix (the reference's data-moved /
    overhead prints, csr_hw.cpp:420-421, main.cpp:84-88)."""
    return (f"tiles={packed.n_tiles} steps={packed.n_steps} "
            f"G={packed.G} Q={packed.Q} fill={packed.fill_factor:.3f} "
            f"bytes={packed.storage_bytes()} "
            f"overhead={100 * (packed.storage_overhead() - 1):+.1f}%")
