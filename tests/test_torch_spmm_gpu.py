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
from sparsetpu_torch.kernels import final_rows as fr
from sparsetpu_torch.kernels import spmm as sp
from sparsetpu_torch.kernels import spmv_fused as sf
from sparsetpu_torch.kernels import spmv_gstream as sg
from test_torch_fused import REGIMES, RING_EDGES


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
@pytest.mark.parametrize("case", list(REGIMES) + ["T1_two_stage",
                                                  "T1_fin_direct", "T8"])
@pytest.mark.parametrize("k", [1, 3, 4, 8, 64])
def test_fused_spmm_device_call_matches_plain_on_card(cuda, case, k):
    """The device's one launch (X unpadded, live counts, spills in the
    launch) against its plain version: plane vectors of 1 (k = 1, 3) and 4
    floats, several sweeps of the registers' 8 planes (k = 64), the ring's
    edges (T = 1 and 8); one launch a call."""
    make, kw, regime = {**REGIMES, **RING_EDGES}[case]
    m = make()
    p = _host.pack_fused(m, **kw)
    assert p is not None and regime(p), case
    d = sf.FusedDevice.from_packed(p, cuda)
    X = torch.as_tensor(_X(m.nr_cols, k, seed=k), dtype=torch.float32,
                        device=cuda)
    ref = d.spmm_blocks_reference(X)
    before = sf.fused_spmm.launches
    yk = d.spmm_blocks(X)
    torch.cuda.synchronize()
    assert sf.fused_spmm.launches == before + 1
    _close_to(yk, ref)
    _gold_ok(m, X.cpu().numpy().astype(np.float64), d.spmm(X))
    # a strided X and a packed one read as their values
    _close_to(d.spmm(X.t().contiguous().t()), d.spmm(X))
    Xp = d.prepare_x_multi(X)
    _close_to(d.spmm(Xp, x_is_packed=True), d.spmm(X))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["q1_two_stage_sgrp2",
                                  "q8_spills_nonuniform_slabs"])
def test_fused_spmm_two_streams_on_card(cuda, case):
    """Each call's own workspace: calls on two streams at once give the
    plain version's blocks."""
    make, kw, regime = REGIMES[case]
    m = make()
    p = _host.pack_fused(m, **kw)
    assert regime(p)
    d = sf.FusedDevice.from_packed(p, cuda)
    Xs = [torch.as_tensor(_X(m.nr_cols, 8, seed=4 + j), dtype=torch.float32,
                          device=cuda) for j in range(2)]
    refs = [d.spmm_blocks_reference(X) for X in Xs]
    streams = [torch.cuda.Stream() for _ in Xs]
    torch.cuda.synchronize()
    ys = []
    for _ in range(3):
        for X, st_ in zip(Xs, streams):
            with torch.cuda.stream(st_):
                ys.append(d.spmm_blocks(X))
    torch.cuda.synchronize()
    for j, y in enumerate(ys):
        _close_to(y, refs[j % 2])


KS = [1, 3, 4, 8, 21, 72]     # plane vectors of 1, 2 and 4 floats


@pytest.mark.gpu
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kw,vdt", [
    (dict(G=1, Q=8), None), (dict(G=4, Q=1), None),
    (dict(G=4, Q=2, shuffle_lanes=True), None),
    (dict(G=8, GL=2), None), (dict(G=4, Q=8), torch.bfloat16)])
def test_classic_spmm_kernels_match_plain_on_card(cuda, kw, vdt, k):
    """#7 at G = 1 and G > 1, P = 1 and 8, GL pinned, bf16 values; the
    k-plane final (#8, #9 as ``final_rows_multi``) wherever the device has a
    final; Y against the gold; one forward launch a forward stream."""
    m = _host.random_csr(3000, 20_000, density=0.002, seed=1,
                         dtype=np.float32)
    dev = sg.GStreamDevice(_host.pack_gstream(m, **kw), value_dtype=vdt,
                           device=cuda)
    X = _X(m.nr_cols, k, seed=2)
    Xp = dev.prepare_x_multi(X)
    before = sp.gstream_chunk_sums_multi.launches
    ck = dev.stream.forward_multi(Xp)
    torch.cuda.synchronize()
    assert sp.gstream_chunk_sums_multi.launches == before + 1
    cr = dev.stream.forward_multi(Xp, sp.gstream_chunk_sums_multi_reference)
    _close_to(ck, cr)
    vec = dev.positions_multi(cr, sp.gstream_chunk_sums_multi_reference)
    _close_to(dev.positions_multi(cr), vec)
    if dev.final is not None:
        before = sum(fr.final_rows_multi.launches.values())
        Yk = dev.final.apply_multi(vec)
        torch.cuda.synchronize()
        assert sum(fr.final_rows_multi.launches.values()) > before
        _close_to(Yk, dev.final.apply_multi(vec,
                                            fr.final_rows_multi_reference))
    before = sp.gstream_chunk_sums_multi.launches
    Y = sp.spmm_gstream(dev, X)
    torch.cuda.synchronize()
    assert sp.gstream_chunk_sums_multi.launches == \
        before + 1 + len(dev.flevels)
    _gold_ok(m, X, Y, "bfloat16" if vdt is not None else np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["flat", "legacy"])
def test_final_multi_with_spills_on_card(cuda, kind, k):
    """Finals that spill: the k-plane kernel against its plain version and
    against the one-plane kernel a plane."""
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
    vec = torch.from_numpy(_X(cr.size, k, seed=3)).float().to(cuda)
    Y = dev.apply_multi(vec)
    _close_to(Y, dev.apply_multi(vec, fr.final_rows_multi_reference))
    for j in range(k):
        _close_to(Y[:, j], dev.apply(vec[:, j].contiguous()))


@pytest.mark.gpu
@pytest.mark.parametrize("k", KS)
def test_classic_spmm_f64_kernels_match_plain_on_card(cuda, k):
    """#13 and the k-plane f64 final on the f64 device whose legacy final
    spills; Y against the gold at the f64 tolerance."""
    from sparsetpu_torch.kernels import f64emu as pf
    m = _host.random_csr(1000, 300_000, density=40 / 300_000, seed=1)
    d = pf.DF64GStreamDevice.from_packed(*pf.pack_gstream_df64(m, G=4),
                                         cuda)
    assert d.final.n_spills > 1000
    X = _X(m.nr_cols, k, seed=4)
    Xp = d.prepare_x_multi(X)
    ck = d.stream.forward_multi(Xp)
    cr = d.stream.forward_multi(Xp, sp.gstream_chunk_sums_multi_reference)
    _close_to(ck, cr)
    _close_to(d.final.apply_multi(cr),
              d.final.apply_multi(cr, fr.final_rows_multi_reference))
    _gold_ok(m, X, pf.spmm_df64(d, X), np.float64)


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
    """The fused SpMM takes k planes while k X planes fit half the L2 (its
    scratch lives in a workspace: shared memory sets no limit); past it
    ``@`` runs the classic k-plane SpMM on a classic device of the source
    CSR."""
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
