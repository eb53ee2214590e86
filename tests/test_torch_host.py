"""sparsetpu_torch: its own host layer, device selection and build.

The port imports torch and never jax, and nothing of ``sparsetpu``: it
keeps its own copy of the host layer (formats, pack, native), whose packs
are byte-identical to the JAX package's, and builds its native library
under ``build/sparsetpu_torch/``.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparsetpu.formats.random import random_csr
from sparsetpu.pack.fused import pack_fused
from sparsetpu_torch import _host
from sparsetpu_torch.kernels import _build
from sparsetpu_torch.kernels.spmv_fused import fused_spmv
from sparsetpu_torch.utils import device as device_mod
from test_torch_fused import native_engines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_BLOCKED = r"""
import sys
sys.modules["jax"] = None          # any jax import now fails
import numpy as np
import torch
import sparsetpu_torch as st
from sparsetpu_torch import _host
m = _host.random_csr(700, 3000, density=0.01, seed=4, dtype=np.float32)
x = np.random.default_rng(1).standard_normal(m.nr_cols)
sm = st.SparseMatrix(m, device="cpu")
assert sm.fused_device is not None
y = (sm @ x).numpy()
tol = _host.default_tolerance(np.float32, m.nr_nzeros / m.nr_rows)
assert _host.verification(_host.spmv_gold(m, x), y, *tol) == 0
# the classic device, in the bf16 value mode
cfg = _host.SpmvConfig(dtype="bfloat16")
sm = st.SparseMatrix(m, cfg, device="cpu")
assert isinstance(sm.device_module, st.GStreamDevice)
tol = _host.default_tolerance("bfloat16", m.nr_nzeros / m.nr_rows)
assert _host.verification(_host.spmv_gold(m, x), (sm @ x).numpy(), *tol) == 0
# SpMM: the fused kernel's plain version and the classic k-plane SpMM
from sparsetpu_torch.kernels import spmm
from sparsetpu_torch.formats.gold import spmm_gold
X = np.random.default_rng(2).standard_normal((m.nr_cols, 3))
G = spmm_gold(m, X)
tol = _host.default_tolerance(np.float32, m.nr_nzeros / m.nr_rows)
for Y in (st.SparseMatrix(m, device="cpu") @ X,
          spmm.spmm_gstream(st.GStreamDevice(_host.pack_gstream(m),
                                             device="cpu"),
                            X)):
    for j in range(3):
        assert _host.verification(G[:, j], Y[:, j].numpy(), *tol) == 0
# f64: the fused and the classic f64 devices, A @ x and A @ X in float64
from sparsetpu_torch.kernels import f64emu
m64 = _host.random_csr(700, 3000, density=0.01, seed=4)
x64 = np.random.default_rng(1).standard_normal(m64.nr_cols)
tol = _host.default_tolerance(np.float64, m64.nr_nzeros / m64.nr_rows)
for cfg in (None, _host.SpmvConfig(dtype=np.float64, block_cols=8192)):
    sm = st.SparseMatrix(m64, cfg, device="cpu")
    assert sm.device_module.dtype == torch.float64
    assert _host.verification(_host.spmv_gold(m64, x64),
                              (sm @ x64).numpy(), *tol) == 0
    Y = (sm @ X).numpy()
    G = spmm_gold(m64, X)
    for j in range(3):
        assert _host.verification(G[:, j], Y[:, j], *tol) == 0
assert isinstance(sm.device_module, f64emu.DF64GStreamDevice)
loaded = [k for k, v in sys.modules.items()
          if v is not None and (k == "jax" or k.startswith("jax."))]
assert not loaded, loaded
assert "sparsetpu" not in sys.modules
assert "_sparsetpu_host" not in sys.modules
import os
jax_pkg = os.path.join(os.getcwd(), "sparsetpu") + os.sep
inside = [k for k, v in sys.modules.items() if v is not None and
          os.path.abspath(getattr(v, "__file__", None) or "").startswith(
              jax_pkg)]
assert not inside, inside
from sparsetpu_torch.native import loader
assert loader.LIB_PATH.startswith(
    os.path.join(os.getcwd(), "build", "sparsetpu_torch") + os.sep)
print("OK", _host.native_available())
"""


def test_port_packs_and_multiplies_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _JAX_BLOCKED], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def test_port_sources_never_import_jax():
    """No import of jax or sparsetpu, and no path built into the JAX
    package's directory (a ``"sparsetpu"`` path component or a
    ``sparsetpu/`` string other than a ``file.py:line`` citation of the
    TPU kernel a port replaces), in the port's sources, the smoke script
    or the classic routes' A/B script."""
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|sparsetpu(\.|\s|$))",
                     re.M)
    path = re.compile(r"""["']([^"'\s]*/)?sparsetpu(/[^"'\s]*)?["']""")
    cite = re.compile(r"""\.py:\d+["']$""")
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py",
                                              "classic_calls.py")]
    for root, _, names in os.walk(os.path.join(REPO, "sparsetpu_torch")):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", "Makefile"))]
    assert len(files) > 20
    for f in files:
        with open(f) as fh:
            text = fh.read()
        hit = pat.search(text)
        assert hit is None, f"{f}: {hit.group(0)!r}"
        hits = [h.group(0) for h in path.finditer(text)
                if not cite.search(h.group(0))]
        assert not hits, f"{f}: {hits}"


def test_host_pack_is_byte_identical_to_jax_package():
    native_engines()
    m = random_csr(1500, 9000, density=0.004, seed=2, dtype=np.float32)
    a, b = pack_fused(m), _host.pack_fused(m)
    for k in ("values", "meta_i1", "meta_rt", "tile_base", "fin1_i1",
              "fin1_rt", "fin2_i1", "fin2_rt", "fin2_group", "step_slab",
              "step_first", "slab_bounds", "spill_row"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for k in ("Q", "GLW", "T", "GX", "OBp", "F1_max", "F2_max", "F1S",
              "n_slabs", "fin_direct", "SGRP"):
        assert getattr(a, k) == getattr(b, k), k


def test_require_device_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        device_mod.require_device("cuda")


def test_require_device_rejects_other_devices():
    assert device_mod.require_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.require_device("meta")


@pytest.mark.parametrize("name,gbps", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 2000.0),
    ("NVIDIA H100 NVL", 3900.0), ("NVIDIA H200", 4800.0),
    ("Tesla V100-SXM2-16GB", None)])
def test_hbm_table_by_device_name(monkeypatch, name, gbps):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    if gbps is None:
        with pytest.raises(KeyError):
            device_mod.hbm_gbps("cuda")
    else:
        assert device_mod.hbm_gbps("cuda") == gbps


def test_hbm_of_cpu_raises():
    with pytest.raises(ValueError):
        device_mod.hbm_gbps("cpu")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_LIBRARY", _build._Library())
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()


def test_build_dir_is_git_ignored():
    rel = os.path.relpath(_build.BUILD_DIR, REPO)
    assert rel.split(os.sep)[0] == "build"
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()


def test_wrapper_on_cpu_counts_no_launch():
    m = random_csr(300, 2000, density=0.01, seed=5, dtype=np.float32)
    from sparsetpu_torch.kernels.spmv_fused import FusedDevice
    d = FusedDevice.from_packed(_host.pack_fused(m), "cpu")
    before = fused_spmv.launches
    d.spmv(np.ones(m.nr_cols))
    assert fused_spmv.launches == before
