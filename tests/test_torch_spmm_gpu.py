"""sparsetpu_torch's SpMM kernels on the card, against their plain PyTorch
versions and the gold.

Imports nothing of JAX, so it runs on the card's machine:
``python -m pytest tests/test_torch_spmm_gpu.py -m gpu --noconftest``;
without a card every test skips.  Tolerances: kernel vs plain rtol 1e-5,
atol 1e-5 * max(1, max|ref|) (the same f32 terms summed in another order);
Y vs ``spmm_gold`` at ``default_tolerance`` of the value type, column by
column.
"""

import numpy as np
import pytest
import torch

import sparsetpu_torch as st
from sparsetpu_torch import _host
from sparsetpu_torch.formats.gold import spmm_gold
from sparsetpu_torch.kernels import spmm as sp
from sparsetpu_torch.kernels import spmv_fused as sf
from sparsetpu_torch.kernels import spmv_gstream as sg
from test_torch_fused import REGIMES


def _close_to(y, ref):
    y, ref = y.cpu().numpy(), ref.cpu().numpy()
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


def _gold_ok(m, X, Y, dtype=np.float32):
    G, Y = spmm_gold(m, X), Y.cpu().numpy()
    tol = _host.default_tolerance(dtype, m.nr_nzeros / max(m.nr_rows, 1))
    for j in range(X.shape[1]):
        assert _host.verification(G[:, j], Y[:, j], *tol) == 0, j


def _X(n, k, seed=0):
    """(n, k) f64 from a seed: the gold sums in f64 (scipy keeps the
    operands' type), the devices take X as f32."""
    return np.random.default_rng(seed).standard_normal((n, k))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(REGIMES))
@pytest.mark.parametrize("k", [1, 3, 8])
def test_fused_spmm_matches_plain_on_card(cuda, case, k):
    make, kw, regime = REGIMES[case]
    m = make()
    p = _host.pack_fused(m, **kw)
    assert regime(p)
    d = sf.FusedDevice.from_packed(p, cuda)
    X = _X(m.nr_cols, k, seed=k)
    Xp = d.prepare_x_multi(X)
    before = sf.fused_spmm.launches
    yk = d.blocks_multi(Xp)
    torch.cuda.synchronize()
    assert sf.fused_spmm.launches == before + 1
    _close_to(yk, d.blocks_multi(Xp, sf.fused_spmm_reference))
    _gold_ok(m, X, d.spmm(Xp, x_is_packed=True))


@pytest.mark.gpu
@pytest.mark.parametrize("kw,vdt", [
    (dict(G=1, Q=8), None), (dict(G=4, Q=1), None),
    (dict(G=4, Q=2, shuffle_lanes=True), None),
    (dict(G=8, GL=2), None), (dict(G=4, Q=8), torch.bfloat16)])
def test_classic_spmm_kernels_match_plain_on_card(cuda, kw, vdt):
    """#7 at G = 1 and G > 1, P = 1 and 8, GL pinned, bf16 values; #8 or #9
    wherever the device has a final with no F levels."""
    m = _host.random_csr(3000, 20_000, density=0.002, seed=1,
                         dtype=np.float32)
    dev = sg.GStreamDevice(_host.pack_gstream(m, **kw), cuda, vdt)
    X = _X(m.nr_cols, 3, seed=2)
    Xp = dev.prepare_x_multi(X)
    before = sp.gstream_chunk_sums_multi.launches
    ck = dev.stream.forward_multi(Xp)
    torch.cuda.synchronize()
    assert sp.gstream_chunk_sums_multi.launches == before + 1
    cr = dev.stream.forward_multi(Xp, sp.gstream_chunk_sums_multi_reference)
    _close_to(ck, cr)
    if isinstance(dev.final, sg.FinalDevice) and not len(dev.flevels):
        _close_to(dev.final.grid_multi(cr),
                  dev.final.grid_multi(cr, sp.final_gather_multi_reference))
    _gold_ok(m, X, sp.spmm_gstream(dev, X),
             "bfloat16" if vdt is not None else np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["flat", "legacy"])
def test_final_multi_with_spills_on_card(cuda, kind):
    """Finals that spill: the k-plane kernel against its plain
    version and against the per-plane final kernel."""
    seed, nr, nc, dens = (7, 3000, 20_000, 0.002) if kind == "flat" else \
        (12, 5000, 5000, 0.01)
    p = _host.pack_gstream(_host.random_csr(nr, nc, dens, seed=seed,
                                            dtype=np.float32), G=4, Q=2)
    from sparsetpu_torch.pack import final_levels as fl
    cr = p.chunk_row.reshape(-1).astype(np.int64)
    fin = (fl._FinalLevelV2.build(cr, nr, p.sections, p.planes)
           if kind == "flat" else fl._FinalLevel.build(cr, nr))
    assert fin.spill_pos.size > 0
    dev = sg.final_device(fin, nr, cr.size, cuda)
    vec = torch.from_numpy(_X(cr.size, 8, seed=3)).float().to(cuda)
    _close_to(dev.grid_multi(vec),
              dev.grid_multi(vec, sp.final_gather_multi_reference))
    Y = dev.apply_multi(vec)
    for j in range(8):
        _close_to(Y[:, j], dev.apply(vec[:, j].contiguous()))


@pytest.mark.gpu
@pytest.mark.parametrize("make,cfg", [
    (lambda: _host.random_csr(4000, 20_000, 0.002, seed=1,
                              dtype=np.float32), {}),
    (lambda: _host.random_csr(20_000, 20_000, 2.5 / 20_000, seed=3,
                              dtype=np.float32, powerlaw=True), {}),
    (lambda: _host.random_csr(200, 1_600_000, 2e-5, seed=2,
                              dtype=np.float32), {}),
    (lambda: _host.random_csr(3000, 20_000, 0.002, seed=1,
                              dtype=np.float32), dict(num_partitions=2)),
    (lambda: _host.random_csr(1000, 2000, 0.02, seed=71, dtype=np.float32),
     dict(dtype="bfloat16"))])
def test_sparse_matrix_spmm_on_card(cuda, make, cfg):
    """Every route of ``SparseMatrix @ X`` launches SpMM kernels on the
    card and passes the gold."""
    m = make()
    config = _host.SpmvConfig(**{"dtype": np.float32, **cfg})
    sm = st.SparseMatrix(m, config, device=cuda)
    X = _X(m.nr_cols, 4, seed=5)
    before = sf.fused_spmm.launches + sp.gstream_chunk_sums_multi.launches
    Y = sm @ X
    torch.cuda.synchronize()
    assert Y.device.type == "cuda" and tuple(Y.shape) == (m.nr_rows, 4)
    assert sf.fused_spmm.launches + sp.gstream_chunk_sums_multi.launches \
        > before
    _gold_ok(m, X, Y, config.dtype)


@pytest.mark.gpu
def test_spmm_budget_is_the_cards(cuda):
    """The fused SpMM takes k planes while k X planes fit half the L2 and
    one plane's scratch fits the opt-in shared memory; past it ``@`` runs
    the classic k-plane SpMM on a classic device of the source CSR."""
    m = _host.random_csr(2000, 100_000, 0.0005, seed=1, dtype=np.float32)
    sm = st.SparseMatrix(m, device=cuda)
    d = sm.fused_device
    l2, _ = sf.card_limits(cuda)
    kmax = (l2 // 2) // (d.meta.padded_cols * 4)
    assert d.spmm_applicable(kmax) and not d.spmm_applicable(kmax + 1)
    X = _X(m.nr_cols, kmax + 1, seed=6)
    before = sp.gstream_chunk_sums_multi.launches
    Y = sm @ X
    torch.cuda.synchronize()
    assert sp.gstream_chunk_sums_multi.launches == before + 1
    assert isinstance(sm._classic, st.GStreamDevice)
    _gold_ok(m, X, Y)
