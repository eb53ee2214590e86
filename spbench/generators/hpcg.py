"""HPCG's problem matrix (HPCG 3.1 reference, ``GenerateProblem_ref.cpp``):
the 27-point stencil on an nx x ny x nz grid, 26 on the diagonal and -1 for
every neighbour inside the grid, rows in HPCG's order ix + nx (iy + ny iz).
The matrix does not depend on the seed."""

from __future__ import annotations

import numpy as np

from spbench.generators.csr import Csr, from_sorted_keys


def generate(cfg: dict, rng: np.random.Generator) -> Csr:
    nx, ny, nz = (int(cfg[k]) for k in ("nx", "ny", "nz"))
    dtype = np.dtype(cfg["dtype"])
    n = nx * ny * nz
    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    # offsets in (dz, dy, dx) lexicographic order: ascending column within
    # each row, since |dx| < nx and |dy| < ny
    cols, valid = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
                      & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
                valid.append(ok)
                cols.append(np.arange(n) + dx + nx * (dy + ny * dz))
    valid = np.stack(valid, axis=1)
    cols = np.stack(cols, axis=1)[valid]
    rows = np.broadcast_to(np.arange(n)[:, None], valid.shape)[valid]
    values = np.where(rows == cols, 26.0, -1.0).astype(dtype)
    return from_sorted_keys(rows, cols, values, n, n)
