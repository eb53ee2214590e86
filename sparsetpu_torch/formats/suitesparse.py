"""SuiteSparse Matrix Collection matrices (counterpart of
``sparsetpu/formats/suitesparse.py``), read from a local cache only.

The reference benchmarks on externally supplied matrix files, in practice
SuiteSparse exports.  The port never opens a network connection:

  * ``fetch(name)`` reads ``<name>.mtx`` (or ``<name>/<name>.mtx``) that is
    already in ``cache_dir()`` (``$SPARSETPU_TORCH_SS_DIR``, default
    ``$SPARSETPU_TORCH_CACHE/suitesparse``, that default
    ``~/.cache/sparsetpu_torch``) through the standard reader
    (``formats/io.py``).  Place the file there by hand.
  * ``synthetic_stand_in(name)`` builds a random matrix with the registered
    matrix's published shape and nnz count, byte-identical to the JAX
    package's stand-in; ``fetch(..., allow_synthetic=True)`` returns it,
    labelled, when the file is missing.

The classic SpMV benchmark set (Williams et al., "Optimization of sparse
matrix-vector multiplication on emerging multicore platforms", SC'07) is
registered in ``CLASSIC_SUITE`` with published dimensions.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from .csr import CSRMatrix
from .io import read_matrix
from .random import random_csr


@dataclasses.dataclass(frozen=True)
class MatrixInfo:
    group: str
    name: str
    rows: int
    cols: int
    nnz: int              # nonzeros after symmetric expansion
    kind: str = "general"  # general | symmetric | powerlaw


# The classic SpMV set: published (rows, cols, nnz) from the collection.
CLASSIC_SUITE: Dict[str, MatrixInfo] = {
    "pdb1HYS": MatrixInfo("Williams", "pdb1HYS", 36_417, 36_417,
                          4_344_765, "symmetric"),
    "consph": MatrixInfo("Williams", "consph", 83_334, 83_334,
                         6_010_480, "symmetric"),
    "cant": MatrixInfo("Williams", "cant", 62_451, 62_451,
                       4_007_383, "symmetric"),
    "pwtk": MatrixInfo("Boeing", "pwtk", 217_918, 217_918,
                       11_524_432, "symmetric"),
    "rma10": MatrixInfo("Bova", "rma10", 46_835, 46_835,
                        2_329_092, "general"),
    "shipsec1": MatrixInfo("DNVS", "shipsec1", 140_874, 140_874,
                           3_568_176, "symmetric"),
    "mac_econ_fwd500": MatrixInfo("Williams", "mac_econ_fwd500",
                                  206_500, 206_500, 1_273_389, "general"),
    "scircuit": MatrixInfo("Hamm", "scircuit", 170_998, 170_998,
                           958_936, "general"),
    "webbase-1M": MatrixInfo("Williams", "webbase-1M", 1_000_005,
                             1_000_005, 3_105_536, "powerlaw"),
    "cop20k_A": MatrixInfo("Williams", "cop20k_A", 121_192, 121_192,
                           2_624_331, "symmetric"),
}


def cache_dir() -> str:
    return os.environ.get(
        "SPARSETPU_TORCH_SS_DIR",
        os.path.join(os.environ.get(
            "SPARSETPU_TORCH_CACHE",
            os.path.expanduser("~/.cache/sparsetpu_torch")), "suitesparse"))


def _find_cached_mtx(name: str) -> Optional[str]:
    base = cache_dir()
    for cand in (os.path.join(base, f"{name}.mtx"),
                 os.path.join(base, name, f"{name}.mtx")):
        if os.path.exists(cand):
            return cand
    return None


def fetch(name: str, group: Optional[str] = None,
          allow_synthetic: bool = False) -> Tuple[CSRMatrix, bool]:
    """Load a SuiteSparse matrix as CSR from the cache directory.  Returns
    (matrix, is_real); ``is_real`` is False when the file is missing and
    the synthetic stand-in (same shape and nnz) was substituted, which only
    ``allow_synthetic=True`` permits.  Raises FileNotFoundError otherwise;
    ``group`` is the collection group, needed for a name outside
    ``CLASSIC_SUITE``."""
    info = CLASSIC_SUITE.get(name)
    if group is None and info is None:
        raise KeyError(f"{name!r} is not in CLASSIC_SUITE; pass group=")
    path = _find_cached_mtx(name)
    if path is not None:
        return read_matrix(path), True
    if not allow_synthetic or info is None:
        raise FileNotFoundError(
            f"{name}.mtx is not in {cache_dir()!r} (the port reads only "
            f"pre-placed files; SuiteSparse group "
            f"{group or info.group!r})")
    return synthetic_stand_in(name), False


def synthetic_stand_in(name: str, seed: int = 1234) -> CSRMatrix:
    """A random matrix with the registered matrix's published shape and
    nnz count (power-law row distribution for web-graph-like entries),
    byte-identical to the JAX package's stand-in.  A stand-in for
    throughput runs without the file: numerics match the format, not the
    original operator."""
    info = CLASSIC_SUITE[name]
    density = info.nnz / (info.rows * float(info.cols))
    # stable per-name seed: Python's str hash is randomized per process
    return random_csr(info.rows, info.cols, density=density,
                      seed=seed ^ (zlib.crc32(name.encode()) & 0xFFFF),
                      dtype=np.float32,
                      powerlaw=(info.kind == "powerlaw"))
