"""The host layer in one namespace: CSR containers, golds, the pack
engines and the native packer, from this package's own modules
(``formats/``, ``pack/``, ``native/``, ``utils/config.py``).  These import
only numpy and ctypes.
"""

from __future__ import annotations

from .formats.csr import CSRMatrix
from .formats.gold import default_tolerance, spmv_gold, verification
from .formats.io import read_matrix
from .formats.random import fem_poisson_3d, random_csr
from .native import loader as _loader
from .native.packer import available as native_available
from .pack.fused import FusedMatrix, pack_fused
from .pack.gather_stream import CHUNK, STRIPE, GStreamMatrix, pack_gstream
from .pack.scan import scan_matrix
from .utils.config import BFLOAT16, LANES, SpmvConfig

__all__ = [
    "BFLOAT16", "CHUNK", "CSRMatrix", "FusedMatrix", "GStreamMatrix",
    "LANES", "STRIPE", "SpmvConfig", "default_tolerance",
    "ensure_native_packer", "fem_poisson_3d", "native_available",
    "pack_fused", "pack_gstream", "random_csr", "read_matrix",
    "scan_matrix", "spmv_gold", "verification",
]


def ensure_native_packer() -> None:
    """Build the C++ packer on first use (``native/loader.py``'s make) and
    raise if it is unusable: the NumPy engine packs another layout, and
    far more slowly."""
    _loader._lib()
    if not native_available():
        raise RuntimeError("the native packer (sparsetpu_torch/native) is "
                           "not available after its build")
