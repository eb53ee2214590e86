"""sparsetpu_torch's BSR kernel (#14) on the card, against its plain
PyTorch version and the gold.

Imports nothing of JAX, so it runs on the card's machine:
``python -m pytest tests/test_torch_bsr_gpu.py -m gpu --noconftest``;
without a card every test skips.  Tolerances: partials kernel vs plain
max abs error <= 1e-5 * max|plain| (128 f32 products a row summed in
another order); y vs gold ``default_tolerance(float32, nnz/row)``.
"""

import numpy as np
import pytest
import torch

import sparsetpu_torch as st
from sparsetpu_torch import _host
from sparsetpu_torch.kernels import bsr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _gold_ok(m, x, y):
    tol = _host.default_tolerance(np.float32, m.nr_nzeros / max(m.nr_rows, 1))
    assert _host.verification(_host.spmv_gold(m, x), y, *tol) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("make", [
    lambda: _host.banded_csr(300, 300, bandwidth=10),
    lambda: _host.banded_csr(1000, 700, bandwidth=40),
    lambda: _host.random_csr(200, 500, density=0.05, seed=72),
    # ragged: nr_rows % 8 and nr_cols % 128 nonzero, 1001 blocks padded
    # to the next multiple of 64 with zero blocks
    lambda: _host.random_csr(1001, 1001, density=0.01, seed=73),
    lambda: _host.fem_poisson_3d(24, np.float32)])
def test_bsr_kernel_matches_plain_on_card(cuda, make):
    m = make()
    d = st.BSRDevice(_host.csr_to_bsr(m), device=cuda)
    x = np.random.default_rng(3).standard_normal(m.nr_cols)
    x2 = d.prepare_x(x)
    before = bsr.bsr_partials.launches
    pk = d.partials(x2)
    torch.cuda.synchronize()
    assert bsr.bsr_partials.launches == before + 1
    pr = d.partials(x2, bsr.bsr_partials_reference)
    err = float((pk - pr).abs().max())
    assert err <= 1e-5 * float(pr.abs().max())
    assert tuple(pk.shape) == (d.n_blocks, 8)
    # the padded tail blocks (zero values) give zero sums
    nb = _host.csr_to_bsr(m).values.shape[0]
    assert not bool(pk[nb:].any())
    y = d.spmv(x)
    torch.cuda.synchronize()
    assert y.device.type == "cuda" and y.shape == (m.nr_rows,)
    _gold_ok(m, x, y.cpu().numpy())


@pytest.mark.gpu
def test_bsr_wrapper_raises_on_bad_input(cuda):
    m = _host.random_csr(200, 500, density=0.05, seed=72)
    d = st.BSRDevice(_host.csr_to_bsr(m), device=cuda)
    x2 = d.prepare_x(np.ones(m.nr_cols))
    with pytest.raises(ValueError):
        bsr.bsr_partials(d.blocks.double(), d.bcol, x2)
    with pytest.raises(ValueError):
        bsr.bsr_partials(d.blocks, d.bcol, x2.reshape(-1, 64))


@pytest.mark.gpu
def test_pcg_on_bsr_on_card(cuda):
    """PCG through the BSR operator: #14 and the final once an SpMV."""
    m = _host.fem_poisson_3d(16, np.float32)
    d = st.BSRDevice(_host.csr_to_bsr(m), device=cuda)
    before = bsr.bsr_partials.launches
    res = st.pcg(d.spmv, torch.ones(m.nr_rows, device=cuda),
                 st.jacobi_preconditioner(m, device=cuda), tol=1e-5,
                 maxiter=500)
    assert bsr.bsr_partials.launches - before == res.iterations + 1
    r = 1.0 - _host.spmv_gold(m, res.x.cpu().numpy().astype(np.float64))
    assert np.linalg.norm(r) <= 1e-4 * np.sqrt(m.nr_rows)
