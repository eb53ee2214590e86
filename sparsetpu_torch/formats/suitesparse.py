"""SuiteSparse Matrix Collection ingestion (counterpart of
``sparsetpu/formats/suitesparse.py``, the same host code).

The reference benchmarks on externally supplied matrix files, in practice
SuiteSparse exports:

  * ``fetch(name)`` reads ``<name>.mtx`` (or ``<name>/<name>.mtx``) from
    ``cache_dir()`` (``$SPARSETPU_TORCH_SS_DIR``, default
    ``$SPARSETPU_TORCH_CACHE/suitesparse``, that default
    ``~/.cache/sparsetpu_torch``) through the standard reader
    (``formats/io.py``).  A matrix not there is downloaded first
    (``download``): the MatrixMarket tarball from the first of ``MIRRORS``
    that answers, kept in the cache and its ``.mtx`` extracted.  On a
    machine without a network, place the file (or the tarball) there by
    hand, or set ``MIRRORS`` to ``()`` so that nothing is tried.
  * ``synthetic_stand_in(name)`` builds a random matrix with the registered
    matrix's published shape and nnz count, byte-identical to the JAX
    package's stand-in; ``fetch(..., allow_synthetic=True)`` returns it,
    labelled, when the download fails.

The classic SpMV benchmark set (Williams et al., "Optimization of sparse
matrix-vector multiplication on emerging multicore platforms", SC'07) is
registered in ``CLASSIC_SUITE`` with published dimensions.
"""

from __future__ import annotations

import dataclasses
import os
import tarfile
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from .csr import CSRMatrix
from .io import read_matrix
from .random import random_csr

MIRRORS = (
    "https://suitesparse-collection-website.herokuapp.com/MM/{group}/{name}.tar.gz",
    "https://sparse.tamu.edu/MM/{group}/{name}.tar.gz",
)


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


def _extract(tar_path: str, name: str) -> str:
    base = cache_dir()
    with tarfile.open(tar_path) as tf:
        for member in tf.getmembers():
            if member.name.endswith(f"{name}.mtx"):
                member.name = os.path.join(name, f"{name}.mtx")
                tf.extract(member, base)
                return os.path.join(base, name, f"{name}.mtx")
    raise FileNotFoundError(f"{name}.mtx not found inside {tar_path}")


def download(group: str, name: str, timeout: float = 120.0) -> str:
    """Fetch the MatrixMarket tarball into the cache; returns the .mtx
    path.  A cached ``.mtx`` or tarball is used as it is.  Raises
    ConnectionError (with each mirror's reason) when no mirror answers,
    at once where ``MIRRORS`` is empty; callers can fall back to
    ``synthetic_stand_in``."""
    mtx = _find_cached_mtx(name)
    if mtx:
        return mtx
    base = cache_dir()
    os.makedirs(base, exist_ok=True)
    tar_path = os.path.join(base, f"{name}.tar.gz")
    if not os.path.exists(tar_path):
        import urllib.request
        errs = []
        for url_t in MIRRORS:
            url = url_t.format(group=group, name=name)
            try:
                with urllib.request.urlopen(url, timeout=timeout) as r, \
                        open(tar_path + ".part", "wb") as f:
                    while True:
                        chunk = r.read(1 << 20)
                        if not chunk:
                            break
                        f.write(chunk)
                os.replace(tar_path + ".part", tar_path)
                break
            except Exception as e:
                errs.append(f"{url}: {type(e).__name__}: {e}")
        else:
            raise ConnectionError(
                "SuiteSparse download failed on every mirror (offline "
                f"environment? pre-place {name}.mtx in "
                f"{base!r} instead):\n  " + "\n  ".join(errs))
    return _extract(tar_path, name)


def fetch(name: str, group: Optional[str] = None,
          allow_synthetic: bool = False) -> Tuple[CSRMatrix, bool]:
    """Load a SuiteSparse matrix as CSR, downloading it into the cache when
    it is not there (``download``).  Returns (matrix, is_real);
    ``is_real`` is False when the download failed and the synthetic
    stand-in (same shape and nnz) was substituted, which only
    ``allow_synthetic=True`` permits; ConnectionError otherwise.
    ``group`` is the collection group, needed for a name outside
    ``CLASSIC_SUITE``."""
    info = CLASSIC_SUITE.get(name)
    if group is None:
        if info is None:
            raise KeyError(
                f"{name!r} is not in CLASSIC_SUITE; pass group=")
        group = info.group
    try:
        return read_matrix(download(group, name)), True
    except ConnectionError:
        if not allow_synthetic or info is None:
            raise
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
