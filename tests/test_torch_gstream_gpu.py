"""sparsetpu_torch's classic GStream kernels on the card, against their
plain PyTorch versions and the gold.

Imports nothing of JAX, so it runs on the card's machine:
``python -m pytest tests/test_torch_gstream_gpu.py -m gpu --noconftest``;
without a card every test skips.  Tolerances: kernel vs plain rtol 1e-5,
atol 1e-5 * max(1, max|ref|) (the same f32 terms summed in another order);
y vs gold ``default_tolerance`` of the value type.
"""

import numpy as np
import pytest
import torch

import sparsetpu_torch as st
from sparsetpu_torch import _host
from sparsetpu_torch.kernels import spmv_gstream as sg
from sparsetpu_torch.kernels.final_rows import final_rows_reference


def _close_to(y, ref):
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


def _gold_ok(m, x, y, dtype=np.float32):
    tol = _host.default_tolerance(dtype, m.nr_nzeros / max(m.nr_rows, 1))
    assert _host.verification(_host.spmv_gold(m, x), y, *tol) == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kw,vdt", [
    (dict(G=1, Q=8), None), (dict(G=4, Q=2), None),
    (dict(Q=8, G=8, GL=2, slab=256, shuffle_lanes=False), None),
    (dict(G=4, Q=8), torch.bfloat16)])
def test_kernels_match_plain_on_card(cuda, kw, vdt):
    m = _host.random_csr(3000, 20_000, density=0.002, seed=1,
                         dtype=np.float32)
    p = _host.pack_gstream(m, **kw)
    dev = sg.GStreamDevice(p, value_dtype=vdt, device=cuda)
    x2 = dev.prepare_x(np.random.default_rng(0).standard_normal(m.nr_cols))
    n_fwd = sum(sg.gstream_chunk_sums.launches.values())
    ck = dev.stream(x2)
    torch.cuda.synchronize()
    assert sum(sg.gstream_chunk_sums.launches.values()) == n_fwd + 1
    cr = dev.stream(x2, sg.gstream_chunk_sums_reference)
    _close_to(ck.cpu().numpy(), cr.cpu().numpy())
    vec = dev.positions(cr)
    yk = dev.final.apply(vec)
    yr = dev.final.apply(vec, final_rows_reference)
    torch.cuda.synchronize()
    _close_to(yk.cpu().numpy(), yr.cpu().numpy())
    # the TPU layout's plain final (each level's grid, sliced, and its
    # spills), the map's yardstick
    yt = 0
    for lvl in getattr(dev.final, "levels", [dev.final]):
        t = lvl.tables(vec.device)
        yl = lvl.grid(vec).reshape(-1)[:m.nr_rows].clone()
        yt = yt + yl.index_add_(0, t.spill_row, vec[t.spill_pos])
    _close_to(yk.cpu().numpy(), yt.cpu().numpy())
    y = dev.spmv(x2, x_is_packed=True).cpu().numpy()
    _gold_ok(m, np.asarray(x2.reshape(-1)[:m.nr_cols].cpu()), y,
             "bfloat16" if vdt is not None else np.float32)


def _powerlaw():
    return _host.random_csr(20_000, 20_000, density=2.5 / 20_000, seed=3,
                            dtype=np.float32, powerlaw=True)


def _uniform():
    return _host.random_csr(1000, 2000, density=0.02, seed=71,
                            dtype=np.float32)


def _wide():
    return _host.random_csr(200, 1_600_000, density=2e-5, seed=2,
                            dtype=np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("make,cfg", [
    (_wide, {}), (_powerlaw, {}),
    (_powerlaw, dict(block_cols=8192)), (_powerlaw, dict(num_partitions=2)),
    (_uniform, dict(dtype="bfloat16"))])
def test_sparse_matrix_routes_on_card(cuda, make, cfg):
    """Every classic route through ``SparseMatrix`` launches the classic
    kernels on the card and passes the gold."""
    m = make()
    x = np.random.default_rng(4).standard_normal(m.nr_cols)
    config = _host.SpmvConfig(**{"dtype": np.float32, **cfg})
    sm = st.SparseMatrix(m, config, device=cuda)
    before = sum(sg.gstream_chunk_sums.launches.values())
    y = sm @ x
    torch.cuda.synchronize()
    assert y.device.type == "cuda" and y.shape == (m.nr_rows,)
    assert sum(sg.gstream_chunk_sums.launches.values()) > before
    _gold_ok(m, x, y.cpu().numpy(), config.dtype)
