"""sparsetpu_torch's row-sorted final (``csrc/final_rows.cu``) on the card,
against its plain version and the gold.

Imports nothing of JAX, so it runs on the card's machine:
``python -m pytest tests/test_torch_final_rows_gpu.py -m gpu --noconftest``;
without a card every test skips.  Tolerances: kernel vs plain rtol 1e-5,
atol 1e-5 * max(1, max|ref|) in f32 and 1e-12 in f64 (the same terms
added in another order); y vs gold ``default_tolerance`` of the value
type.
"""

import numpy as np
import pytest
import torch

import sparsetpu_torch as st
from sparsetpu_torch import _host
from sparsetpu_torch.kernels import f64emu as pf
from sparsetpu_torch.kernels import spmv_gstream as sg
from sparsetpu_torch.kernels.final_rows import (
    SHORT_MAX, FinalRows, final_rows, final_rows_multi,
    final_rows_multi_reference, final_rows_reference, short_max_multi)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _agree(yk, yr):
    rtol = 1e-12 if yr.dtype == torch.float64 else 1e-5
    yk, yr = yk.cpu().numpy(), yr.cpu().numpy()
    atol = rtol * max(1.0, float(np.abs(yr).max()) if yr.size else 1.0)
    np.testing.assert_allclose(yk, yr, rtol=rtol, atol=atol)


def _launched(before, keys):
    return sum(final_rows.launches[k] for k in keys) - sum(
        before[k] for k in keys)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_both_bins_match_plain_on_card(cuda, dtype):
    """Rows of 0 to 3000 entries (empty ones among them): the short ones a
    thread each, the long ones a warp each."""
    rng = np.random.default_rng(1)
    lens = np.concatenate([rng.integers(0, 8, 3000), [0, 0, 1],
                           rng.integers(SHORT_MAX + 1, 3000, 40)])
    rng.shuffle(lens)
    n_pos = int(lens.sum()) + 1000
    rowptr = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                          dtype=torch.int32, device=cuda)
    idx = torch.tensor(rng.permutation(n_pos)[:int(lens.sum())],
                       dtype=torch.int32, device=cuda)
    rows = FinalRows(rowptr, idx, n_pos)
    assert rows.n_long == 40
    vec = torch.tensor(rng.standard_normal(n_pos), dtype=dtype, device=cuda)
    suffix = "_f64" if dtype == torch.float64 else ""
    before = final_rows.launches.copy()
    yk = final_rows(vec, rows)
    torch.cuda.synchronize()
    assert _launched(before, ["short" + suffix]) == 1
    assert _launched(before, ["long" + suffix]) == 1
    yr = final_rows_reference(vec, rows)
    _agree(yk, yr)
    assert bool((yk[torch.from_numpy(lens == 0).to(cuda)] == 0).all())


@pytest.mark.gpu
def test_one_bin_launches_once_on_card(cuda):
    """No long row: one launch; every row long: one launch of the other
    bin; no row at all: none."""
    for lens, key in (([3, 0, 5, 1], "short"), ([40, 100], "long")):
        rowptr = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                              dtype=torch.int32, device=cuda)
        idx = torch.arange(sum(lens), dtype=torch.int32, device=cuda)
        rows = FinalRows(rowptr, idx, sum(lens))
        vec = torch.randn(sum(lens), device=cuda)
        before = final_rows.launches.copy()
        y = final_rows(vec, rows)
        torch.cuda.synchronize()
        assert _launched(before, ["short", "long"]) == 1
        assert _launched(before, [key]) == 1
        _agree(y, final_rows_reference(vec, rows))
    empty = FinalRows(torch.zeros(1, dtype=torch.int32, device=cuda),
                      torch.zeros(0, dtype=torch.int32, device=cuda), 0)
    assert final_rows(torch.zeros(0, device=cuda), empty).numel() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("make,cfg", [
    (lambda: _host.random_csr(200, 1_600_000, density=2e-5, seed=2,
                              dtype=np.float32), {}),
    (lambda: _host.random_csr(20_000, 20_000, density=2.5 / 20_000, seed=3,
                              dtype=np.float32, powerlaw=True), {})])
def test_sparse_matrix_routes_through_final_rows_on_card(cuda, make, cfg):
    """The wide-x and hybrid routes of ``SparseMatrix @ x`` finish through
    the kernel, which agrees with its plain version; y passes the gold."""
    m = make()
    x = np.random.default_rng(4).standard_normal(m.nr_cols)
    sm = st.SparseMatrix(m, _host.SpmvConfig(dtype=np.float32, **cfg),
                         device=cuda)
    d = sm.heavy_device or sm.device_module
    assert isinstance(d, sg.GStreamDevice) and d.final is not None
    before = final_rows.launches.copy()
    y = sm @ x
    torch.cuda.synchronize()
    assert _launched(before, ["short", "long"]) >= 1
    tol = _host.default_tolerance(np.float32, m.nr_nzeros / m.nr_rows)
    assert _host.verification(_host.spmv_gold(m, x), y.cpu().numpy(),
                              *tol) == 0
    vec = d.positions(d.stream(d.prepare_x(x)))
    _agree(d.final.apply(vec), d.final.apply(vec, final_rows_reference))


@pytest.mark.gpu
def test_f64_device_through_final_rows_on_card(cuda):
    """The classic f64 device's final with spills, in FP64."""
    m = _host.random_csr(1000, 300_000, density=40 / 300_000, seed=1)
    d = pf.DF64GStreamDevice.from_packed(*pf.pack_gstream_df64(m, G=4),
                                         cuda)
    assert d.final.n_spills > 1000
    x = np.random.default_rng(9).standard_normal(m.nr_cols)
    before = final_rows.launches.copy()
    y = d.spmv(x)
    torch.cuda.synchronize()
    assert y.dtype == torch.float64
    assert _launched(before, ["short_f64", "long_f64"]) >= 1
    g = _host.spmv_gold(m, x)
    tol = _host.default_tolerance(np.float64, m.nr_nzeros / m.nr_rows)
    assert _host.verification(g, y.cpu().numpy(), *tol) == 0
    # the forward over the live slots writes the positions the final reads
    vec = d.positions(d.forward_live(torch.as_tensor(x, device=cuda)))
    _agree(d.final.apply(vec), d.final.apply(vec, final_rows_reference))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 3, 4, 8, 21, 72])
def test_multi_bins_match_plain_on_card(cuda, dtype, k):
    """The k-plane entry: rows of 0 to 3000 entries, a group of threads a
    short row, a warp per (long row, plane vector); and vec and Y at an
    address of one value past the allocation (plane vectors of one
    value)."""
    rng = np.random.default_rng(2)
    lens = np.concatenate([rng.integers(0, 8, 2000), [0, 0, 1],
                           rng.integers(2000, 3000, 20)])
    rng.shuffle(lens)
    n_pos = int(lens.sum()) + 1000
    rowptr = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                          dtype=torch.int32, device=cuda)
    idx = torch.tensor(rng.permutation(n_pos)[:int(lens.sum())],
                       dtype=torch.int32, device=cuda)
    rows = FinalRows(rowptr, idx, n_pos)
    # past the threshold at any plane vector width (k / W <= k vectors)
    assert rows.count_over(short_max_multi(k)) == 20
    vec = torch.tensor(rng.standard_normal((n_pos, k)), dtype=dtype,
                       device=cuda)
    suffix = "_f64" if dtype == torch.float64 else ""
    before = final_rows_multi.launches.copy()
    yk = final_rows_multi(vec, rows)
    torch.cuda.synchronize()
    for b in ("short", "long"):
        assert final_rows_multi.launches[b + suffix] == before[b + suffix] + 1
    yr = final_rows_multi_reference(vec, rows)
    _agree(yk, yr)
    assert bool((yk[torch.from_numpy(lens == 0).to(cuda)] == 0).all())
    off = torch.empty(n_pos * k + 1, dtype=dtype, device=cuda)[1:]
    off.copy_(vec.reshape(-1))
    _agree(final_rows_multi(off.view(n_pos, k), rows), yr)
