"""The f64 CUDA kernels on the card, against their plain PyTorch versions
and the gold.  Needs an NVIDIA GPU; skips without one.  Imports nothing of
JAX:

    python -m pytest tests/test_torch_f64_gpu.py -m gpu --noconftest

Tolerances: kernel vs plain version rtol 1e-12, atol 1e-12 * max(1,
max|ref|) (the same f64 terms, summed in another order where atomics add
into a shared row); y against ``spmv_gold`` (Y against ``spmm_gold``
column by column) 0 errors at ``default_tolerance(float64)`` and max abs
error <= 1e-10 * max(1, max|y|), which f32 misses by orders of magnitude.
"""

import numpy as np
import pytest
import torch

import sparsetpu_torch as st
from sparsetpu_torch import _host
from sparsetpu_torch.formats.gold import spmm_gold
from sparsetpu_torch.kernels import f64emu as pf
from sparsetpu_torch.kernels import final_rows as fr
from sparsetpu_torch.kernels import spmm as sp
from sparsetpu_torch.kernels import spmv_fused as sf
from sparsetpu_torch.kernels import spmv_gstream as sg
from sparsetpu_torch.pack import final_levels as fl
import test_torch_fused as _tf
from test_torch_fused import REGIMES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _agree(yk, yr):
    yk, yr = yk.cpu().numpy(), yr.cpu().numpy()
    atol = 1e-12 * max(1.0, float(np.abs(yr).max()) if yr.size else 1.0)
    np.testing.assert_allclose(yk, yr, rtol=1e-12, atol=atol)


def _gold_ok(m, x, y):
    y = y.cpu().numpy()
    assert y.dtype == np.float64 and np.isfinite(y).all()
    g = _host.spmv_gold(m, x)
    tol = _host.default_tolerance(np.float64, m.nr_nzeros / max(m.nr_rows, 1))
    assert _host.verification(g, y, *tol) == 0
    assert np.abs(y - g).max() <= 1e-10 * max(1.0, float(np.abs(y).max()))


def _gold_multi_ok(m, X, Y):
    for j in range(X.shape[1]):
        _gold_ok(m, X[:, j], Y[:, j])


def _fused(case, device):
    make, kw, regime = REGIMES[case]
    m = make()
    ph, pl = sf.pack_fused_df64(m, **kw)
    assert regime(ph), case
    return m, sf.DF64FusedDevice.from_packed(ph, pl, device)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(REGIMES))
def test_fused_f64_kernel_matches_plain_on_card(cuda, case):
    m, d = _fused(case, cuda)
    x = np.random.default_rng(9).standard_normal(m.nr_cols)
    x2 = d.prepare_x(x)
    before = sf.fused_spmv_f64.launches
    yk = d.blocks(x2)
    torch.cuda.synchronize()
    assert sf.fused_spmv_f64.launches == before + 1
    _agree(yk, d.blocks(x2, kernel=sf.fused_spmv_reference))
    _gold_ok(m, x, d.spmv(x))
    X = np.random.default_rng(3).standard_normal((m.nr_cols, 3))
    _gold_multi_ok(m, X, pf.spmm_df64(d, X))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["q1_two_stage_sgrp2", "q4",
                                  "q8_spills_nonuniform_slabs"])
def test_fused_f64_workspace_placement_on_card(cuda, case):
    """The chunk sums and scratch2 in a global workspace of each call's
    own: calls on two streams at once, and the free wrapper, give the
    plain version's blocks."""
    m, d = _fused(case, cuda)
    assert not d.meta.fin_direct
    xs = [torch.as_tensor(np.random.default_rng(4 + k).standard_normal(
        m.nr_cols), device=cuda) for k in range(2)]
    refs = [d.spmv_blocks_reference(x) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    torch.cuda.synchronize()
    ys = []
    for _ in range(3):
        for x, st_ in zip(xs, streams):
            with torch.cuda.stream(st_):
                ys.append((d.spmv_blocks(x), st_))
    torch.cuda.synchronize()
    for k, (y, _) in enumerate(ys):
        _agree(y, refs[k % 2])
    x2 = d.prepare_x(xs[0].cpu().numpy())
    _agree(d.blocks(x2), d.blocks(x2, kernel=sf.fused_spmv_reference))


def _classic_cases():
    return {
        "G=1": (lambda: _host.random_csr(1000, 900, density=0.02, seed=1),
                1, lambda d: d.meta.G == 1),
        "G=4": (lambda: _host.random_csr(1000, 3000, density=0.01, seed=24),
                4, lambda d: d.meta.G == 4),
        "legacy final spills": (
            lambda: _host.random_csr(1000, 300_000, density=40 / 300_000,
                                     seed=1),
            4, lambda d: d.final is not None and d.final.n_spills > 1000),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_classic_cases()))
def test_classic_f64_kernels_match_plain_on_card(cuda, case):
    make, G, regime = _classic_cases()[case]
    m = make()
    d = pf.DF64GStreamDevice.from_packed(*pf.pack_gstream_df64(m, G=G), cuda)
    assert regime(d), case
    x = np.random.default_rng(9).standard_normal(m.nr_cols)
    x2 = d.prepare_x(x)
    n_fwd = sg.gstream_chunk_sums_f64.launches
    n_fin = fr.final_rows.launches.copy()
    ck = d.stream(x2)
    cr = d.stream(x2, sg.gstream_chunk_sums_reference)
    torch.cuda.synchronize()
    assert sg.gstream_chunk_sums_f64.launches == n_fwd + 1
    _agree(ck, cr)
    if d.final is not None:
        yk = d.final.apply(cr)
        torch.cuda.synchronize()
        assert sum(fr.final_rows.launches[b] - n_fin[b]
                   for b in ("short_f64", "long_f64")) >= 1
        _agree(yk, d.final.apply(cr, fr.final_rows_reference))
    _gold_ok(m, x, d.spmv(x))
    for k in (1, 3, 8):
        X = np.random.default_rng(k).standard_normal((m.nr_cols, k))
        Xp = d.prepare_x_multi(X)
        n = sp.gstream_chunk_sums_multi_f64.launches
        mk = d.stream.forward_multi(Xp)
        torch.cuda.synchronize()
        assert sp.gstream_chunk_sums_multi_f64.launches == n + 1
        mr = d.stream.forward_multi(Xp,
                                    sp.gstream_chunk_sums_multi_reference)
        _agree(mk, mr)
        if d.final is not None:
            n = fr.final_rows_multi.launches.copy()
            Yk = d.final.apply_multi(mr)
            torch.cuda.synchronize()
            assert sum(fr.final_rows_multi.launches[b] - n[b]
                       for b in ("short_f64", "long_f64")) >= 1
            _agree(Yk, d.final.apply_multi(mr, fr.final_rows_multi_reference))
        _gold_multi_ok(m, X, pf.spmm_df64(d, X))


@pytest.mark.gpu
def test_classic_f64_segment_sum_route_on_card(cuda, monkeypatch):
    m = _host.random_csr(3000, 6000, density=0.004, seed=5)
    monkeypatch.setattr(fl._FinalLevel, "build",
                        classmethod(lambda cls, *a, **k: None))
    d = pf.DF64GStreamDevice(m, cuda)
    assert d.final is None
    x = np.random.default_rng(9).standard_normal(m.nr_cols)
    _gold_ok(m, x, d.spmv(x))
    X = np.random.default_rng(3).standard_normal((m.nr_cols, 3))
    _gold_multi_ok(m, X, pf.spmm_df64(d, X))


@pytest.mark.gpu
@pytest.mark.parametrize("block_cols", [16384, 8192])
def test_sparse_matrix_f64_on_card_matches_gold(cuda, block_cols):
    """The user's call: an f64 matrix, ``sm @ x`` and ``sm @ X`` on the
    card, through the fused (#10) or the classic (#11, #12, #13) route."""
    m = _host.random_csr(4000, 20_000, density=0.002, seed=1)
    cfg = _host.SpmvConfig(dtype=np.float64, block_cols=block_cols)
    sm = st.SparseMatrix(m, cfg, device=cuda)
    fused = isinstance(sm.device_module, sf.DF64FusedDevice)
    assert fused == (block_cols >= 16384)
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    counts = (sf.fused_spmv_f64.launches, sg.gstream_chunk_sums_f64.launches,
              sp.gstream_chunk_sums_multi_f64.launches)
    y = sm @ x
    X = np.random.default_rng(1).standard_normal((m.nr_cols, 4))
    Y = sm @ X
    torch.cuda.synchronize()
    assert y.device.type == "cuda" and Y.dtype == torch.float64
    after = (sf.fused_spmv_f64.launches, sg.gstream_chunk_sums_f64.launches,
             sp.gstream_chunk_sums_multi_f64.launches)
    if fused:
        assert after[0] == counts[0] + 5
    else:
        assert after[1] == counts[1] + 1 and after[2] == counts[2] + 1
    _gold_ok(m, x, y)
    _gold_multi_ok(m, X, Y)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(REGIMES) + list(_tf.RING_EDGES))
def test_fused_f64_device_call_matches_plain_on_card(cuda, case):
    """The f64 device's one launch (live counts, spills, unpadded x)
    against its plain version; one launch a call."""
    make, kw, regime = {**REGIMES, **_tf.RING_EDGES}[case]
    m = make()
    ph, pl = sf.pack_fused_df64(m, **kw)
    assert regime(ph), case
    d = sf.DF64FusedDevice.from_packed(ph, pl, cuda)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(m.nr_cols),
                        device=cuda)
    ref = d.spmv_blocks_reference(x)
    before = sf.fused_spmv_f64.launches
    yk = d.spmv_blocks(x)
    torch.cuda.synchronize()
    assert sf.fused_spmv_f64.launches == before + 1
    _agree(yk, ref)
    _gold_ok(m, x.cpu().numpy(), d.spmv(x))
