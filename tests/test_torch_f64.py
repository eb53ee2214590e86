"""sparsetpu_torch's f64 (DOUBLE=1) devices against the JAX package's.

The JAX package emulates f64 as (hi, lo) float pairs; the port packs the
same two f32 planes (byte-identical packs), joins them into one float64
value plane at upload and computes in float64.  The same numpy inputs
(matrices and vectors from seeds) go through the JAX functions (Pallas
interpret mode, their (hi, lo) results joined with ``join_f64``) and the
port's plain PyTorch versions, which are what its wrappers run on CPU
tensors:

  packs     ``pack_fused_df64`` and ``pack_gstream_df64`` (with the legacy
            final) byte-identical to the JAX device's;
  #10       ``fused_spmv_reference`` in f64 vs ``_fused_df64_blocks``;
  #11       ``gstream_chunk_sums_reference`` in f64 vs ``_df64_chunk_sums``;
  #12       ``final_gather_reference`` in f64 vs ``_df64_final_sums``;
  #13       ``gstream_chunk_sums_multi_reference`` in f64 vs
            ``_df64_chunk_sums_multi``;
  devices   ``DF64FusedDevice``, ``DF64GStreamDevice`` and ``spmm_df64``
            vs the JAX devices and the gold; the API and the CLI.

Tolerance: max abs difference <= 1e-11 * max(1, max|y|), the bound of
``tests/test_f64emu.py:70``: both sides carry ~2^-48 relative error (the
JAX (hi, lo) arithmetic, the port's hi + lo joined values) on sums of a few
dozen terms.  Where the JAX package rounds more (its segment-sum route sums
hi and lo apart in f32), the port is held to the gold at 1e-11 and to JAX
at 1e-5 * max(1, max|y|).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparsetpu.api.api import SparseMatrix as JaxSparseMatrix
from sparsetpu.kernels import f64emu as jf
from sparsetpu.kernels import spmv_pallas as jsp
from sparsetpu.kernels.spmv_fused import DF64FusedDevice as JaxDF64Fused
from sparsetpu.kernels.spmv_fused import _fused_df64_blocks
from sparsetpu.kernels.spmv_fused import pack_fused_df64 as jax_pack_df64
from sparsetpu.utils.config import SpmvConfig

import sparsetpu_torch as st
from sparsetpu_torch import _host
from sparsetpu_torch.formats.gold import spmm_gold
from sparsetpu_torch.kernels import f64emu as pf
from sparsetpu_torch.kernels import spmv_fused as sf
from sparsetpu_torch.kernels import spmv_gstream as sg
from sparsetpu_torch.kernels.spmm import gstream_chunk_sums_multi_reference
from sparsetpu_torch.pack import final_levels as fl
from test_torch_fused import REGIMES, native_engines_first  # noqa: F401


def _close(y, ref, rel=1e-11):
    """max |y - ref| <= rel * max(1, max|ref|)."""
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    err = float(np.abs(y - ref).max()) if ref.size else 0.0
    assert err <= rel * scale, (err, scale)


def _gold_ok(m, x, y):
    """y against spmv_gold: 0 errors at the f64 tolerance, and max abs
    error <= 1e-11 * max(1, max|y|)."""
    y = np.asarray(y)
    assert y.dtype == np.float64
    g = _host.spmv_gold(m, x)
    tol = _host.default_tolerance(np.float64, m.nr_nzeros / max(m.nr_rows, 1))
    assert _host.verification(g, y, *tol) == 0
    _close(y, g)


def _f64(m):
    """The matrix with float64 values (REGIMES' are f64 already)."""
    return _host.CSRMatrix(m.row_ptr, m.col_ind, m.values.astype(np.float64),
                           m.nr_rows, m.nr_cols)


def test_split_and_join_match_jax():
    v = np.random.default_rng(0).standard_normal(1000) * 10.0 ** np.arange(
        -5, 5).repeat(100)
    hi, lo = pf.split_f64(v)
    jhi, jlo = jf.split_f64(v)
    assert hi.dtype == lo.dtype == np.float32
    assert np.array_equal(hi, jhi) and np.array_equal(lo, jlo)
    assert np.array_equal(pf.join_f64(hi, lo), jf.join_f64(jhi, jlo))
    assert np.abs(pf.join_f64(hi, lo) - v).max() <= 2.0 ** -46 * np.abs(
        v).max()


# ---------------------------------------------------------------------------
# the fused f64 device (#10)
# ---------------------------------------------------------------------------

def _fused_case(case):
    make, kw, regime = REGIMES[case]
    m = _f64(make())
    packs = sf.pack_fused_df64(m, **kw)
    assert packs is not None and regime(packs[0]), case
    return m, kw, packs


@pytest.mark.parametrize("case", list(REGIMES))
def test_fused_df64_packs_byte_identical_to_jax(case):
    m, kw, (ph, pl) = _fused_case(case)
    jd = jax_pack_df64(m, interpret=True, **kw)
    for k in ("values", "meta_i1", "meta_rt", "tile_base", "fin1_i1",
              "fin1_rt", "fin2_i1", "fin2_rt", "fin2_group", "step_slab",
              "step_first", "slab_bounds", "spill_row", "spill_col",
              "spill_val"):
        assert np.array_equal(getattr(ph, k), getattr(jd.meta, k)), k
    assert np.array_equal(pl.values, np.asarray(jd.vlo))
    if ph.spill_row.size:
        assert np.array_equal(pl.spill_val, np.asarray(jd.spill_vl))
    for k in ("Q", "GLW", "T", "GX", "OBp", "F1_max", "F2_max", "F1S",
              "n_slabs", "fin_direct", "SGRP"):
        assert getattr(ph, k) == getattr(pl, k) == getattr(jd.meta, k), k


@pytest.mark.parametrize("case", [c for c in REGIMES if c != "q2"])
def test_fused_df64_kernel_matches_jax(case):
    """#10's plain version against ``_fused_df64_blocks`` (hi + lo joined)
    on the fused regimes (q2 is held to the gold only: its interpret run
    alone costs ~12 s on this CPU)."""
    m, kw, (ph, pl) = _fused_case(case)
    x = np.random.default_rng(9).standard_normal(m.nr_cols)
    jd = JaxDF64Fused(ph, pl, interpret=True)
    x2h, x2l = jd.prepare_x(x)
    bh, bl = _fused_df64_blocks(
        jd.tile_base, jd.fin1_cnt, jd.fin2_cnt, jd.fin2_group, jd.step_slab,
        jd.step_first, x2h, x2l, jd.vhi, jd.vlo, jd.meta_i1, jd.meta_rt,
        jd.fin1_i1, jd.fin1_rt, jd.fin2_i1, jd.fin2_rt, T=ph.T, GLW=ph.GLW,
        P=ph.planes, F1_max=ph.F1_max, F2_max=ph.F2_max, F1S=ph.F1S,
        OBp=ph.OBp, n_steps=ph.n_steps, n_slabs=ph.n_slabs,
        fin_direct=ph.fin_direct, interpret=True)
    d = sf.DF64FusedDevice.from_packed(ph, pl, "cpu")
    x2 = d.prepare_x(x)
    assert x2.dtype == torch.float64 and tuple(x2.shape) == (ph.GX * 8, 128)
    blocks = d.blocks(x2, kernel=sf.fused_spmv_reference)
    assert blocks.dtype == torch.float64
    _close(blocks.numpy(), jf.join_f64(bh, bl))


@pytest.mark.parametrize("case", list(REGIMES))
def test_df64_fused_device_meets_gold(case):
    """``DF64FusedDevice.spmv`` and ``spmm`` (k = 2) against the gold on
    every fused regime.  (The JAX device's y is compared in
    ``test_spmm_df64_on_the_fused_device_matches_jax``; on the spilling
    pack it keeps one spill a row: ROADMAP Queue 3,
    ``test_numpy_engine_spills_are_added``.)"""
    m, kw, (ph, pl) = _fused_case(case)
    d = sf.DF64FusedDevice.from_packed(ph, pl, "cpu")
    x = np.random.default_rng(9).standard_normal(m.nr_cols)
    y = d.spmv(x).numpy()
    assert y.shape == (m.nr_rows,)
    _gold_ok(m, x, y)
    X = np.random.default_rng(10).standard_normal((m.nr_cols, 2))
    _close(d.spmm(X).numpy(), spmm_gold(m, X))


def test_numpy_engine_spills_are_added():
    """The JAX ``DF64FusedDevice`` adds its spills with ``.at[].set``
    (``spmv_fused.py:771-772``), so where several spills share a row only
    one counts: on this NumPy-engine pack (4,360 spills on 857 rows) its
    y is off by ~11.5 against max|y| ~22.4 (ROADMAP Queue 3).  The port
    adds them with ``index_add_`` and meets the gold."""
    m = _host.random_csr(1000, 8000, density=0.004, seed=1,
                         dtype=np.float64)
    ph, pl = sf.pack_fused_df64(m, use_native=False)
    _, counts = np.unique(ph.spill_row, return_counts=True)
    assert ph.spill_row.size == 4360 and (counts > 1).sum() > 800
    x = np.random.default_rng(2).standard_normal(m.nr_cols)
    y = sf.DF64FusedDevice.from_packed(ph, pl, "cpu").spmv(x).numpy()
    _gold_ok(m, x, y)


def test_fused_df64_returns_none_where_jax_does():
    wide = _host.random_csr(10, sf.MAX_RESIDENT_COLS_DF64 + 128,
                            density=1e-5, seed=0)
    assert sf.pack_fused_df64(wide) is None
    assert jax_pack_df64(wide, interpret=True) is None


def test_diverged_planes_raise():
    m, _, (ph, pl) = _fused_case("q2")
    bad = dataclasses.replace(pl, meta_rt=pl.meta_rt[::-1].copy())
    with pytest.raises(ValueError, match="diverged"):
        sf.DF64FusedDevice.from_packed(ph, bad, "cpu")
    ph, pl = pf.pack_gstream_df64(_host.random_csr(300, 2000, density=0.01,
                                                   seed=1))
    bad = dataclasses.replace(pl, route=pl.route[::-1].copy())
    with pytest.raises(ValueError, match="diverged"):
        pf.DF64GStreamDevice.from_packed(ph, bad, "cpu")


def test_ill_conditioned_rows_keep_f64_precision():
    """``tests/test_fused_df64.py:63-81``: 1e8 + 1 - 1e8 + 1/3 rows.  The
    f64 port keeps them; f32 loses the +1."""
    n = 256
    vals = np.tile([1e8, 1.0, -1e8, 1.0 / 3], n).astype(np.float64)
    rp = np.arange(0, 4 * n + 1, 4).astype(np.int64)
    ci = (np.arange(4 * n) * 7 % 3000).astype(np.int64)
    x = np.ones(3000)
    m = _host.CSRMatrix(rp, ci, vals, n, 3000)
    yg = _host.spmv_gold(m, x)
    for cfg in (None, _host.SpmvConfig(dtype=np.float64, block_cols=8192)):
        sm = st.SparseMatrix(m, cfg, device="cpu")
        assert isinstance(sm.device_module, (sf.DF64FusedDevice,
                                             pf.DF64GStreamDevice))
        assert np.abs((sm @ x).numpy() - yg).max() < 1e-6
    m32 = _host.CSRMatrix(rp, ci, vals.astype(np.float32), n, 3000)
    y32 = (st.SparseMatrix(m32, device="cpu") @ x).numpy()
    assert np.abs(y32 - yg).max() > 0.1


# ---------------------------------------------------------------------------
# the classic f64 device (#11, #12, #13)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def classic():
    """(m, port device, JAX device) of a small f64 matrix."""
    m = _host.random_csr(1500, 2000, density=0.01, seed=7)
    return m, pf.DF64GStreamDevice(m, "cpu"), jf.DF64GStreamDevice(
        m, interpret=True)


def test_df64_gstream_packs_byte_identical_to_jax(classic):
    m, d, jd = classic
    p = d.meta
    assert (p.Q, p.GL) == (8, 0)
    for k in ("values", "cell_idx", "route", "chunk_row", "step_window"):
        assert np.array_equal(getattr(p, k), getattr(jd.meta, k)), k
    vlo = d.stream.values.numpy() - p.values.astype(np.float64)
    assert np.array_equal(vlo.astype(np.float32), np.asarray(jd.vlo))
    f, jfin = d.plan.final, jd.final
    assert isinstance(f, fl._FinalLevel) and not d.plan.flevels
    for k in ("step_meta", "cell_idx", "route"):
        assert np.array_equal(getattr(f, k), np.asarray(getattr(jfin, k))), k
    assert f.spill_pos.size == 0 and jfin.spill_pos is None
    assert (f.nw, f.G, f.tiles_per_step, f.nt_pad) == (
        jfin.nw, jfin.G, jfin.tiles_per_step, jfin.nt_pad)


@pytest.mark.parametrize("G", [1, 4])
def test_df64_chunk_sums_match_jax(G):
    """#11 at G = 1 and G > 1."""
    m = _host.random_csr(1000, 3000, density=0.01, seed=20 + G)
    ph, pl = pf.pack_gstream_df64(m, G=G)
    assert ph.G == G and ph.Q == 8
    d = pf.DF64GStreamDevice.from_packed(ph, pl, "cpu")
    x = np.random.default_rng(G).standard_normal(m.nr_cols)
    x2 = d.prepare_x(x)
    assert x2.dtype == torch.float64
    cs = d.stream(x2, sg.gstream_chunk_sums_reference)
    assert cs.dtype == torch.float64
    x2h, x2l = (jnp.asarray(a.reshape(-1, 128)) for a in jf.split_f64(
        np.pad(x, (0, ph.padded_cols - ph.nr_cols))))
    ch, cl = jf._df64_chunk_sums(
        jnp.asarray(ph.step_window), x2h, x2l, jnp.asarray(ph.values),
        jnp.asarray(pl.values), jnp.asarray(jsp.combine_meta(ph.cell_idx,
                                                              ph.route)),
        tiles_per_step=ph.tiles_per_step, G=ph.G, n_steps=ph.n_steps,
        interpret=True)
    _close(cs.numpy(), jf.join_f64(ch, cl))
    _gold_ok(m, x, d.spmv(x).numpy())


def test_df64_final_matches_jax():
    """#12 with spills: a pack pinned to G = 4 whose legacy final spills
    (the final depends on the chunk rows only), on a random f64 position
    vector; the final's arrays byte-identical to the JAX package's; the
    device's y (spills added) against the gold."""
    m = _host.random_csr(1000, 300_000, density=40 / 300_000, seed=1)
    ph, pl = pf.pack_gstream_df64(m, G=4)
    d = pf.DF64GStreamDevice.from_packed(ph, pl, "cpu")
    cr = ph.chunk_row.reshape(-1).astype(np.int64)
    f, jfin = d.plan.final, jsp._FinalLevel.build(cr, m.nr_rows, True)
    assert d.final.n_spills > 1000
    for k in ("step_meta", "cell_idx", "route", "spill_pos", "spill_row"):
        assert np.array_equal(getattr(f, k), np.asarray(getattr(jfin, k))), k
    vec = np.random.default_rng(5).standard_normal(cr.size)
    grid = d.final.grid(torch.from_numpy(vec), sg.final_gather_reference)
    assert grid.dtype == torch.float64
    need = f.x_pad_rows * 128
    vh, vl = jf.split_f64(np.pad(vec, (0, max(0, need - cr.size)))[:need])
    gh, gl = jf._df64_final_sums(
        jfin.step_meta, jnp.asarray(vh.reshape(-1, 128)),
        jnp.asarray(vl.reshape(-1, 128)), jfin.cell_idx, jfin.route,
        tiles_per_step=jfin.tiles_per_step, G=jfin.G, n_steps=jfin.n_steps,
        nw=jfin.nw, n_out_tiles=jfin.nt_pad, interpret=True)
    _close(grid.numpy(), jf.join_f64(gh, gl))
    y = d.final.apply(torch.from_numpy(vec)).numpy()
    gold = np.zeros(m.nr_rows + 1)
    np.add.at(gold, np.minimum(cr, m.nr_rows), vec)
    _close(y, gold[:m.nr_rows])
    x = np.random.default_rng(6).standard_normal(m.nr_cols)
    _gold_ok(m, x, d.spmv(x).numpy())


def test_df64_chunk_sums_multi_match_jax(classic):
    """#13 at k = 3 (X row-major here, (k, rows/128, 128) planes there)."""
    m, d, jd = classic
    p = d.meta
    X = np.random.default_rng(3).standard_normal((m.nr_cols, 3))
    Xp = d.prepare_x_multi(X)
    assert Xp.dtype == torch.float64
    cs = d.stream.forward_multi(Xp, gstream_chunk_sums_multi_reference)
    xh, xl = jf.split_f64(np.pad(X, ((0, p.padded_cols - p.nr_cols),
                                     (0, 0))))
    ch, cl = jf._df64_chunk_sums_multi(
        jd.step_window, jnp.asarray(xh.T.reshape(3, -1, 128)),
        jnp.asarray(xl.T.reshape(3, -1, 128)), jd.vhi, jd.vlo, jd.meta16,
        tiles_per_step=p.tiles_per_step, G=p.G, n_steps=p.n_steps, k=3,
        interpret=True)
    ref = jf.join_f64(ch, cl).reshape(3, -1).T
    _close(cs.numpy(), ref)


def test_df64_gstream_device_and_spmm_match_jax(classic):
    m, d, jd = classic
    x = np.random.default_rng(4).standard_normal(m.nr_cols)
    y = d.spmv(x)
    assert y.dtype == torch.float64
    _close(y.numpy(), jd.spmv_f64(x))
    _gold_ok(m, x, y.numpy())
    X = np.random.default_rng(6).standard_normal((m.nr_cols, 3))
    Y = pf.spmm_df64(d, X).numpy()
    _close(Y, jf.spmm_df64(jd, X))
    _close(Y, spmm_gold(m, X))


def test_spmm_df64_on_the_fused_device_matches_jax():
    """``DF64FusedDevice.spmv`` and ``spmm_df64`` (one SpMV a column)
    against the JAX device's."""
    m = _host.random_csr(300, 2000, density=0.01, seed=1)
    X = np.random.default_rng(3).standard_normal((m.nr_cols, 2))
    ph, pl = sf.pack_fused_df64(m)
    d = sf.DF64FusedDevice.from_packed(ph, pl, "cpu")
    jd = JaxDF64Fused(ph, pl, interpret=True)
    Y = pf.spmm_df64(d, X).numpy()
    assert Y.dtype == np.float64
    Yj = jf.spmm_df64(jd, X)
    _close(Y, Yj)
    _close(Y, spmm_gold(m, X))
    _close(d.spmv(X[:, 0]).numpy(), Yj[:, 0])


def test_segment_sum_route(monkeypatch):
    """No final builds: the segment-sum route.  The port sums in f64 and
    meets the gold at 1e-11; the JAX package sums hi and lo apart in f32
    there (``f64emu.py:531-539``), so the two meet at 1e-5 only."""
    m = _host.random_csr(800, 3000, density=0.008, seed=5)
    none = classmethod(lambda cls, *a, **k: None)
    monkeypatch.setattr(fl._FinalLevel, "build", none)
    monkeypatch.setattr(jsp._FinalLevel, "build", none)
    d = pf.DF64GStreamDevice(m, "cpu")
    jd = jf.DF64GStreamDevice(m, interpret=True)
    assert d.final is None and jd.final is None
    x = np.random.default_rng(8).standard_normal(m.nr_cols)
    y = d.spmv(x).numpy()
    _gold_ok(m, x, y)
    _close(y, jd.spmv_f64(x), rel=1e-5)
    X = np.random.default_rng(9).standard_normal((m.nr_cols, 2))
    _close(pf.spmm_df64(d, X).numpy(), spmm_gold(m, X))


def test_wrappers_reject_what_the_f64_kernels_do_not_take():
    m = _host.random_csr(300, 2000, density=0.01, seed=1)
    p32 = _host.pack_gstream(_host.random_csr(300, 2000, density=0.01,
                                              seed=1, dtype=np.float32),
                             G=8, GL=2)
    fwd = sg.ForwardStream(p32, "cpu", values=p32.values.astype(np.float64))
    with pytest.raises(ValueError, match="GL"):
        fwd(torch.zeros(p32.padded_cols // 128, 128, dtype=torch.float64))
    d = pf.DF64GStreamDevice(m, "cpu")
    with pytest.raises(ValueError, match="x2"):
        d.stream(torch.zeros(d.meta.padded_cols // 128, 128))
    with pytest.raises(ValueError, match="float64"):
        sg.gstream_chunk_sums_f64(d.stream.values.float(), d.stream.meta16,
                                  d.stream.step_window,
                                  torch.zeros(d.meta.padded_cols // 128, 128),
                                  T=d.stream.T, G=d.stream.G, P=d.stream.P)
    with pytest.raises(ValueError, match="legacy"):
        d.final.grid_multi(torch.zeros(d.meta.chunk_row.size, 2,
                                       dtype=torch.float64))
    fd = sf.DF64FusedDevice.from_packed(*sf.pack_fused_df64(m), "cpu")
    with pytest.raises(ValueError, match="f64"):
        fd.blocks_multi(torch.zeros(fd.meta.GX * 1024, 2,
                                    dtype=torch.float64))


# ---------------------------------------------------------------------------
# the API and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,kind", [
    (dict(), "fused"), (dict(vf=8), "fused"),
    (dict(block_cols=8192), "classic")])
def test_api_routes_as_jax(cfg, kind):
    m = _host.random_csr(600, 4000, density=0.01, seed=3)
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    jsm = JaxSparseMatrix(m, SpmvConfig(dtype=np.float64, **cfg),
                          interpret=True)
    sm = st.SparseMatrix(m, _host.SpmvConfig(dtype=np.float64, **cfg),
                         device="cpu")
    want = (sf.DF64FusedDevice, JaxDF64Fused) if kind == "fused" else (
        pf.DF64GStreamDevice, jf.DF64GStreamDevice)
    assert isinstance(sm.device_module, want[0])
    assert isinstance(jsm._device, want[1])
    assert np.array_equal(sm.packed.values, jsm.packed.values)
    assert sm.dtype == torch.float64
    y = sm @ x
    assert y.dtype == torch.float64 and y.device.type == "cpu"
    _close(y.numpy(), jsm @ x)
    _gold_ok(m, x, y.numpy())
    np.testing.assert_array_equal(sm.spmv_packed_x(sm.prepare_x(x)).numpy(),
                                  y.numpy())


def test_api_default_config_of_an_f64_matrix_is_f64():
    m = _host.random_csr(300, 2000, density=0.01, seed=1)
    sm = st.SparseMatrix(m, device="cpu")
    assert sm.config.is_double and sm.dtype == torch.float64
    assert isinstance(sm.device_module, sf.DF64FusedDevice)


def test_api_wide_x_goes_classic():
    m = _host.random_csr(20, sf.MAX_RESIDENT_COLS_DF64 + 1024, density=2e-5,
                         seed=0)
    x = np.random.default_rng(1).standard_normal(m.nr_cols)
    sm = st.SparseMatrix(m, device="cpu")
    assert isinstance(sm.device_module, pf.DF64GStreamDevice)
    # backend="fused" falls back to classic in f64, as the JAX package does
    assert isinstance(st.SparseMatrix(m, backend="fused",
                                      device="cpu").device_module,
                      pf.DF64GStreamDevice)
    _gold_ok(m, x, (sm @ x).numpy())


def test_api_partitions_raise_as_jax():
    m = _host.random_csr(300, 2000, density=0.01, seed=1)
    cfg = dict(dtype=np.float64, num_partitions=2)
    with pytest.raises(ValueError, match="num_partitions") as got:
        st.SparseMatrix(m, _host.SpmvConfig(**cfg), device="cpu")
    with pytest.raises(ValueError) as want:
        JaxSparseMatrix(m, SpmvConfig(**cfg), interpret=True)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cfg", [dict(), dict(block_cols=8192)])
def test_api_spmm_keeps_x_in_f64(cfg):
    """``sm @ X`` keeps X float64: Y meets spmm_gold far below f32
    rounding, on the fused and the classic f64 device."""
    m = _host.random_csr(400, 3000, density=0.01, seed=2)
    X = np.random.default_rng(7).standard_normal((m.nr_cols, 3))
    sm = st.SparseMatrix(m, _host.SpmvConfig(dtype=np.float64, **cfg),
                         device="cpu")
    Y = sm @ X
    assert Y.dtype == torch.float64 and tuple(Y.shape) == (m.nr_rows, 3)
    _close(Y.numpy(), spmm_gold(m, X))
    assert np.abs(Y.numpy() - spmm_gold(m, X.astype(np.float32))).max() \
        > 1e-9


def test_cli_double_cpu_passes(capsys):
    from sparsetpu_torch.cli import main
    assert main(["--double", "--device", "cpu", "--random",
                 "1500x3000x0.004", "--repeats", "2"]) == 0
    out = capsys.readouterr().out
    assert "precision=double" in out and "Verification: PASS" in out
