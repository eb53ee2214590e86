"""The shared host layer (CSR containers, golds, the fused pack engine and
its C++ packer), loaded without importing JAX.

``import sparsetpu.pack.fused`` would first run ``sparsetpu/__init__.py``,
which imports the JAX kernels.  The host modules themselves (``formats/``,
``pack/``, ``native/``, ``utils/config.py``) import only numpy and ctypes,
so they are loaded here through a bare package registered under a private
name whose ``__path__`` is the ``sparsetpu/`` directory: its ``__init__.py``
never runs, and the real ``sparsetpu`` entry of ``sys.modules`` is never
touched (a process may import both packages).  The port therefore packs
with the very code the JAX package packs with: the packs are byte-identical.

Objects built by either package are used by their attributes, never by
``isinstance``: the two loads define distinct classes.
"""

from __future__ import annotations

import importlib
import os
import sys
import types

_ALIAS = "_sparsetpu_host"
_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "sparsetpu")


def _module(name: str):
    if _ALIAS not in sys.modules:
        if not os.path.isfile(os.path.join(_ROOT, "pack", "fused.py")):
            raise ImportError(f"sparsetpu host layer not found at {_ROOT}")
        pkg = types.ModuleType(_ALIAS)
        pkg.__path__ = [_ROOT]
        pkg.__package__ = _ALIAS
        sys.modules[_ALIAS] = pkg
    return importlib.import_module(f"{_ALIAS}.{name}")


_csr = _module("formats.csr")
_gold = _module("formats.gold")
_random = _module("formats.random")
_io = _module("formats.io")
_fused = _module("pack.fused")
_scan = _module("pack.scan")
_gstream = _module("pack.gather_stream")
_config = _module("utils.config")
_packer = _module("native.packer")
_loader = _module("native.loader")

CSRMatrix = _csr.CSRMatrix
random_csr = _random.random_csr
fem_poisson_3d = _random.fem_poisson_3d
read_matrix = _io.read_matrix
spmv_gold = _gold.spmv_gold
verification = _gold.verification
default_tolerance = _gold.default_tolerance
pack_fused = _fused.pack_fused
FusedMatrix = _fused.FusedMatrix
scan_matrix = _scan.scan_matrix
SpmvConfig = _config.SpmvConfig
CHUNK = _gstream.CHUNK
STRIPE = _gstream.STRIPE
LANES = _config.LANES
native_available = _packer.available


def ensure_native_packer() -> None:
    """Build the C++ packer on first use (``native/loader.py``'s make) and
    raise if it is unusable: the NumPy engine packs another layout, and
    far more slowly."""
    _loader._lib()
    if not native_available():
        raise RuntimeError("the native packer (sparsetpu/native) is not "
                           "available after its build")
