"""The fused devices' call on the CPU: one plan built at upload, live finish
counts, the spills at their flat positions in the slab blocks, x unpadded;
and the f32 device's SpMM call (``FusedDevice.spmm``) on the same plan.

``FusedDevice.spmv`` (f32) and ``DF64FusedDevice.spmv`` (f64) run, on CPU
tensors, ``spmv_blocks_reference``: the plain version of the card's one
launch.  Each regime of ``test_torch_fused.REGIMES`` and each of its
``RING_EDGES`` holds it to the old formulation of the call, the free
wrapper's plain version on the padded x (``fused_spmv_reference``), y's
rows read back (``_rows``) and the spills added by row with
``index_add_``.  ``FusedDevice.spmm`` runs ``spmm_blocks_reference`` on
CPU tensors, the plain version of its one launch (X unpadded, the live
counts, the spills' k planes at their flat positions), held likewise to the
free SpMM wrapper's plain version (``fused_spmm_reference``) on the padded
X and to ``spmm_gold``.  Tolerances: rtol 1e-5, atol 1e-5 *
max(1, max|y|) in f32; 1e-12 in f64 (the same terms, summed in another
order at most).  No JAX run here: ``test_torch_fused.py`` and
``test_torch_f64.py`` hold the devices to the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sparsetpu_torch import _host
from sparsetpu_torch.formats.gold import spmm_gold
from sparsetpu_torch.kernels import spmv_fused as sf
from test_torch_fused import (RING_EDGES, REGIMES,  # noqa: F401
                              native_engines_first)

REL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _device(case, dtype):
    """(matrix, device on the CPU) of a regime or a ring edge, f32 or
    f64."""
    make, kw, regime = {**REGIMES, **RING_EDGES}[case]
    m = make()
    if dtype == torch.float32:
        p = _host.pack_fused(m, **kw)
        assert p is not None and regime(p), case
        return m, sf.FusedDevice.from_packed(p, "cpu")
    m = _host.CSRMatrix(m.row_ptr, m.col_ind, m.values.astype(np.float64),
                        m.nr_rows, m.nr_cols)
    packs = sf._fused_df64_packs(m, **kw)
    assert packs is not None and regime(packs[0]), case
    return m, sf.DF64FusedDevice.from_packed(*packs, "cpu")


def _old_call(d, x):
    """The call as the parent formed it: padded x, the free wrapper's plain
    version, y's rows, then the spills by row."""
    x2 = d.prepare_x(x)
    y = d._rows(d.blocks(x2, kernel=sf.fused_spmv_reference).reshape(-1))
    y = y.clone()
    rows = torch.as_tensor(d.meta.spill_row, dtype=torch.int64)
    if rows.numel():
        y.index_add_(0, rows, d.spill_val * x2.reshape(-1)[d.spill_col])
    return y


def _close(y, ref):
    rel = REL[ref.dtype]
    assert y.dtype == ref.dtype and y.shape == ref.shape
    atol = rel * max(1.0, float(ref.abs().max()) if ref.numel() else 1.0)
    torch.testing.assert_close(y, ref, rtol=rel, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(REGIMES) + list(RING_EDGES))
def test_device_call_matches_old_formulation(case, dtype):
    m, d = _device(case, dtype)
    x = np.random.default_rng(9).standard_normal(m.nr_cols)
    ref = _old_call(d, x)
    _close(d.spmv(x), ref)
    _close(d.spmv(d.prepare_x(x), x_is_packed=True), ref)
    _close(d.spmv(torch.as_tensor(x, dtype=dtype)), ref)


def test_spill_positions_map_back_to_rows():
    """Non-uniform slabs: each spill's flat position is its y row once the
    blocks are read back; uniform slabs: the position is the row."""
    _, d = _device("q8_spills_nonuniform_slabs", torch.float32)
    p = d.meta
    assert not sf.slabs_uniform(p) and p.spill_row.size
    flat = torch.arange(p.n_slabs * p.OBp * sf.LANES, dtype=torch.float64)
    rows = d._rows(flat)
    assert np.array_equal(rows[p.spill_row.astype(np.int64)].long().numpy(),
                          d.spill_pos.numpy())
    m = _host.random_csr(3000, 12_000, density=0.004, seed=1)
    u = _host.pack_fused(m)
    assert sf.slabs_uniform(u)
    assert np.array_equal(sf.spill_positions(u), u.spill_row)


@pytest.mark.parametrize("name,delta", [("fin1_cnt", 1), ("fin1_cnt", -1),
                                        ("fin2_cnt", 1), ("fin2_cnt", -1)])
def test_from_packed_rejects_counts_outside_their_range(name, delta):
    _, d = _device("q2", torch.float32)
    p = d.meta
    c = getattr(p, name).copy()
    c[0] = (p.F1_max if name == "fin1_cnt" else p.F2_max) + 1 \
        if delta > 0 else -1
    with pytest.raises(ValueError, match=name):
        sf.FusedDevice.from_packed(dataclasses.replace(p, **{name: c}), "cpu")
    with pytest.raises(ValueError, match=name):
        sf.FusedDevice.from_packed(
            dataclasses.replace(p, **{name: c[:-1]}), "cpu")


@pytest.mark.parametrize("T", [1, 24])
def test_from_packed_rejects_layouts_the_cell_decode_cannot_address(T):
    """T*P chunk-sum rows must be 8 times a power of two: the cells'
    group bits are masked to T*P/8 groups, as on the TPU, so T*P = 1 or
    24 would address rows no forward wrote."""
    p = _host.pack_fused(_host.random_csr(2000, 5000, 0.002, seed=2), T=T,
                         Q=8)
    assert p is not None and p.T * p.planes == T
    with pytest.raises(ValueError, match="unsupported layout"):
        sf.FusedDevice.from_packed(p, "cpu")


def test_live_counts_cut_the_finish():
    """Counts of 0 finish nothing: every row reads 0 (the kernel's loops
    run to the counts, so the plain version does too)."""
    m, d = _device("q1_two_stage_sgrp2", torch.float32)
    p = dataclasses.replace(d.meta, fin1_cnt=np.zeros_like(d.meta.fin1_cnt))
    y = sf.FusedDevice.from_packed(p, "cpu").spmv(np.ones(m.nr_cols))
    assert y.shape == (m.nr_rows,) and not y.any()
    p = dataclasses.replace(d.meta, fin2_cnt=np.zeros_like(d.meta.fin2_cnt))
    assert not sf.FusedDevice.from_packed(p, "cpu").spmv(
        np.ones(m.nr_cols)).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_call_rejects_wrong_x(dtype):
    m, d = _device("q4", dtype)
    other = torch.float64 if dtype == torch.float32 else torch.float32
    with pytest.raises(ValueError, match="shape"):
        d.spmv(np.ones(m.nr_cols + 1))
    with pytest.raises(ValueError, match="shape"):
        d.spmv(torch.ones(m.nr_cols, dtype=dtype), x_is_packed=True)
    with pytest.raises(ValueError, match="tensor"):
        d.spmv(torch.ones(m.nr_cols, dtype=other))
    with pytest.raises(ValueError, match="tensor"):
        d.spmv(torch.ones(m.nr_cols, dtype=dtype, device="meta"))


def test_inputs_checked_once_a_device(monkeypatch):
    calls = []
    check = sf._check_inputs

    def counted(*args, **kwargs):
        calls.append(1)
        return check(*args, **kwargs)

    monkeypatch.setattr(sf, "_check_inputs", counted)
    m, d = _device("q8_spills_nonuniform_slabs", torch.float32)
    assert len(calls) == 1
    x = np.random.default_rng(1).standard_normal(m.nr_cols)
    for _ in range(3):
        d.spmv(x)
    assert len(calls) == 1


def test_strided_x_and_f64_columns():
    """A strided x is read as its values (the call makes it contiguous);
    the f64 device's SpMM, one call a column, agrees with the calls."""
    m, d = _device("q2", torch.float64)
    X = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (m.nr_cols, 3)))
    Y = d.spmm(X)
    for j in range(3):
        _close(d.spmv(X[:, j]), _old_call(d, X[:, j].numpy()))
        _close(Y[:, j], _old_call(d, X[:, j].numpy()))


def _old_call_multi(d, X):
    """The SpMM call as the parent formed it: padded X, the free wrapper's
    plain version, Y's rows, then the spills' k planes by row."""
    Xp = d.prepare_x_multi(X)
    Y = d._rows(d.blocks_multi(Xp, sf.fused_spmm_reference)).clone()
    rows = torch.as_tensor(d.meta.spill_row, dtype=torch.int64)
    if rows.numel():
        Y.index_add_(0, rows, d.spill_val[:, None] * Xp[d.spill_col])
    return Y


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("case", list(REGIMES) + ["T1_two_stage", "T8"])
def test_device_spmm_matches_old_formulation(case, k):
    """Every regime (fin_direct 0 and 1, spills, non-uniform and empty
    trailing slabs) and two ring edges: the one-launch SpMM's plain
    version against the parent's formulation and the gold; X unpadded,
    packed, or a tensor, read alike."""
    m, d = _device(case, torch.float32)
    X = np.random.default_rng(k).standard_normal((m.nr_cols, k))
    ref = _old_call_multi(d, X)
    Y = d.spmm(X)
    _close(Y, ref)
    _close(d.spmm(d.prepare_x_multi(X), x_is_packed=True), ref)
    _close(d.spmm(torch.as_tensor(X, dtype=torch.float32)), ref)
    G = spmm_gold(m, X)
    atol = 1e-5 * max(1.0, float(np.abs(G).max()))
    np.testing.assert_allclose(Y.numpy(), G, rtol=1e-4, atol=atol)


def test_spmm_live_counts_cut_the_finish():
    """Counts of 0 finish nothing on k planes either."""
    m, d = _device("q1_two_stage_sgrp2", torch.float32)
    p = dataclasses.replace(d.meta, fin2_cnt=np.zeros_like(d.meta.fin2_cnt))
    Y = sf.FusedDevice.from_packed(p, "cpu").spmm(np.ones((m.nr_cols, 3)))
    assert tuple(Y.shape) == (m.nr_rows, 3) and not Y.any()


def test_spmm_call_rejects_wrong_x():
    m, d = _device("q4", torch.float32)
    with pytest.raises(ValueError, match="shape"):
        d.spmm(np.ones((m.nr_cols + 1, 2)))
    with pytest.raises(ValueError, match="shape"):
        d.spmm(torch.ones(m.nr_cols, 2), x_is_packed=True)
    with pytest.raises(ValueError, match="shape"):
        d.spmm(torch.ones(m.nr_cols))
    with pytest.raises(ValueError, match="tensor"):
        d.spmm(torch.ones(m.nr_cols, 2, dtype=torch.float64))
