"""GAP's urand graph (Beamer, Asanovic, Patterson, arXiv:1508.03619): 2^scale
vertices and edge_factor * 2^scale edges whose ends are drawn uniformly,
self-loops dropped, made undirected (each edge both ways) and duplicates
removed, as GAP builds it with ``-u scale -k edge_factor -s``.  The values
are PageRank's operator A^T D^-1: entry (i, j) is 1 / deg(j), the graph
being symmetric.  Ends are drawn by NumPy's generator from the seed
(GAP's own generator draws other ones from the same distribution)."""

from __future__ import annotations

import numpy as np

from spbench.generators.csr import Csr, from_sorted_keys


def generate(cfg: dict, rng: np.random.Generator) -> Csr:
    scale = int(cfg["scale"])
    n = 1 << scale
    m = int(cfg["edge_factor"]) * n
    dtype = np.dtype(cfg["dtype"])
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    keys = np.concatenate([(src << scale) | dst, (dst << scale) | src])
    # sort and drop repeats (np.unique hashes from NumPy 2.3 on, which
    # takes minutes at this size)
    keys.sort()
    keys = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
    rows, cols = keys >> scale, keys & (n - 1)
    deg = np.bincount(rows, minlength=n)
    # deg(col) >= 1 for every stored entry: the graph is symmetric
    values = (1.0 / deg[cols]).astype(dtype)
    return from_sorted_keys(rows, cols, values, n, n)
