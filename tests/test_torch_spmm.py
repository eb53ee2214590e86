"""sparsetpu_torch's SpMM (Y = A @ X) against the JAX package's and the gold.

The same numpy inputs (matrices and X from seeds) go through the JAX
functions (Pallas interpret mode) and the port's plain PyTorch versions,
which are what the port's wrappers run on CPU tensors:

  fused     ``FusedDevice.spmm`` vs the JAX ``FusedDevice.spmm`` (#6);
  forward   ``gstream_chunk_sums_multi`` vs ``_gstream_chunk_sums_multi``
            (#7);
  finals    ``FinalDevice.apply_multi`` (the row-sorted map on k planes,
            ``final_rows_multi``) vs ``_final_v2_sums_multi`` (#8) and
            ``_final_gather_sums_multi`` (#9);
  device    ``spmm_gstream`` vs the JAX ``spmm_gstream``, on every finish
            (the JAX route finishes a plane at a time where there are F
            levels, a multi final or no final; the port never does);
  API       ``SparseMatrix @ X`` on every route vs the JAX ``spmm``.

The JAX fused SpMM in interpret mode costs seconds a plane, so it runs on
a few regimes and plane counts; every regime at k in {1, 3, 8} is held to
the gold and to the port's own per-column SpMV (itself held to JAX in
``test_torch_fused.py``).  Tolerances: f32 results rtol 1e-5, atol 1e-5 *
max(1, max|Y|) (the same f32 terms summed in another order); against the
gold ``default_tolerance`` of the value type, column by column.  The JAX
bf16 mode rounds X to bf16 and sums in bf16; the port keeps X and its sums
in f32, so the two meet at the bf16 tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparsetpu.api.api import SparseMatrix as JaxSparseMatrix
from sparsetpu.kernels import spmm as jspmm
from sparsetpu.kernels import spmv_pallas as jsp
from sparsetpu.kernels.spmv_fused import FusedDevice as JaxFusedDevice
from sparsetpu.utils.config import SpmvConfig

import sparsetpu_torch as st
from sparsetpu_torch import _host
from sparsetpu_torch.formats.gold import spmm_gold
from sparsetpu_torch.kernels import f64emu as pf
from sparsetpu_torch.kernels import final_rows as fr
from sparsetpu_torch.kernels import spmm as sp
from sparsetpu_torch.kernels import spmv_fused as sf
from sparsetpu_torch.kernels import spmv_gstream as sg
from sparsetpu_torch.pack import final_levels as fl
from test_torch_api import _heavy_matrix as _heavy_rows
from test_torch_fused import REGIMES, native_engines_first  # noqa: F401
from test_torch_gstream import _heavy_matrix


def _close_to(y, ref):
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


def _gold_ok(m, X, Y, dtype=np.float32):
    """Y against spmm_gold column by column, 0 errors."""
    Y = np.asarray(Y)
    G = spmm_gold(m, X)
    assert Y.shape == G.shape
    tol = _host.default_tolerance(dtype, m.nr_nzeros / max(m.nr_rows, 1))
    for j in range(X.shape[1]):
        assert _host.verification(G[:, j], Y[:, j], *tol) == 0, j


def _X(n, k, seed=0):
    """(n, k) f64 from a seed: the gold sums in f64 (scipy keeps the
    operands' type), the devices take X as f32."""
    return np.random.default_rng(seed).standard_normal((n, k))


# ---------------------------------------------------------------------------
# the fused SpMM (#6)
# ---------------------------------------------------------------------------

def _fused(case):
    make, kw, regime = REGIMES[case]
    m = make()
    p = _host.pack_fused(m, **kw)
    assert p is not None and regime(p), case
    return m, p


@pytest.mark.parametrize("case", list(REGIMES))
@pytest.mark.parametrize("k", [1, 3, 8])
def test_fused_spmm_matches_gold_and_spmv(case, k):
    """Every fused regime: Y is the gold and the per-column SpMV."""
    m, p = _fused(case)
    d = sf.FusedDevice.from_packed(p, "cpu")
    X = _X(m.nr_cols, k, seed=k)
    before = sf.fused_spmm.launches
    Y = d.spmm(X).numpy()
    assert sf.fused_spmm.launches == before      # no launch on the CPU
    assert Y.shape == (m.nr_rows, k) and Y.dtype == np.float32
    _gold_ok(m, X, Y)
    _close_to(Y, np.stack([d.spmv(X[:, j]).numpy() for j in range(k)], 1))


@pytest.mark.parametrize("case,k", [
    ("q8_spills_nonuniform_slabs", 8), ("empty_trailing_slabs", 3)])
def test_fused_spmm_matches_jax_interpret(case, k):
    """The two-stage finish, spills with per-slab reassembly, and empty
    trailing slabs against the JAX kernel."""
    m, p = _fused(case)
    X = _X(m.nr_cols, k, seed=k)
    y_jax = np.asarray(JaxFusedDevice(p, interpret=True).spmm(X))
    _close_to(sf.FusedDevice.from_packed(p, "cpu").spmm(X).numpy(), y_jax)


def test_fused_prepare_x_multi_and_checks():
    m, p = _fused("q4")
    d = sf.FusedDevice.from_packed(p, "cpu")
    X = np.arange(m.nr_cols * 2, dtype=np.float32).reshape(-1, 2)
    Xp = d.prepare_x_multi(X)
    assert tuple(Xp.shape) == (p.padded_cols, 2) and Xp.is_contiguous()
    assert np.array_equal(Xp[:m.nr_cols].numpy(), X)
    assert not Xp[m.nr_cols:].any()
    with pytest.raises(ValueError, match="X has shape"):
        d.prepare_x_multi(X[:-1])
    with pytest.raises(ValueError, match="X must be"):
        d.blocks_multi(Xp[:-128])
    with pytest.raises(ValueError, match="x2"):
        d.blocks_multi(Xp.double())


@pytest.mark.parametrize("k", [1, 8, 21, 64])
def test_spmm_applicable_on_cpu_is_the_jax_budget(k):
    """On CPU tensors the budget is the JAX package's, so both route
    alike; on a card it is the card's (tested in the gpu file)."""
    m = _host.random_csr(2000, 100_000, density=0.0005, seed=1,
                         dtype=np.float32)
    p = _host.pack_fused(m)
    ours = sf.FusedDevice.from_packed(p, "cpu").spmm_applicable(k)
    assert ours == JaxFusedDevice(p, interpret=True).spmm_applicable(k)


# ---------------------------------------------------------------------------
# the classic k-plane forward (#7) and finals (#8, #9)
# ---------------------------------------------------------------------------

def _jax_chunk_sums_multi(p, X, values=None):
    k = X.shape[1]
    Xp = np.pad(X, ((0, p.padded_cols - p.nr_cols), (0, 0)))
    cs = jspmm._gstream_chunk_sums_multi(
        jnp.asarray(p.step_window), jnp.asarray(Xp.T.reshape(k, -1, 128)),
        jnp.asarray(p.values if values is None else values),
        jnp.asarray(jsp.combine_meta(p.cell_idx, p.route)),
        tiles_per_step=p.tiles_per_step, G=p.G, n_steps=p.n_steps, k=k,
        P=p.planes, interpret=True)
    return np.asarray(cs).reshape(k, -1).T        # row-major (n_pos, k)


@pytest.mark.parametrize("g,q", [(1, 8), (4, 2)])
def test_chunk_sums_multi_match_jax(g, q):
    """G = 1 and G > 1 (the select chain), Q = 8 and Q = 2 (P = 4)."""
    m = _host.random_csr(1200, 6000, density=0.004, seed=10 + g + q,
                         dtype=np.float32)
    p = _host.pack_gstream(m, G=g, Q=q)
    assert (p.G, p.Q, p.GL) == (g, q, 0)
    X = _X(m.nr_cols, 3, seed=g)
    dev = sg.GStreamDevice(p, device="cpu")
    before = sp.gstream_chunk_sums_multi.launches
    cs = dev.stream.forward_multi(dev.prepare_x_multi(X))
    assert sp.gstream_chunk_sums_multi.launches == before
    assert tuple(cs.shape) == (p.n_tiles * p.planes * 128, 3)
    _close_to(cs.numpy(), _jax_chunk_sums_multi(p, X))
    # each plane is the SpMV forward of that column
    for j in range(3):
        _close_to(cs[:, j].numpy(),
                  dev.stream(dev.prepare_x(X[:, j])).reshape(-1).numpy())


@pytest.mark.parametrize("kind", ["flat", "legacy"])
def test_final_multi_matches_jax(kind):
    """The k-plane finals against the JAX kernels and the per-plane final,
    with spills: two that add, and one with ``spill_row == nr_rows`` (a
    padded slot), which both packages drop."""
    m = _host.random_csr(800, 3000, 0.004, seed=12, dtype=np.float32)
    p = _host.pack_gstream(m, G=4, Q=2)
    cr = p.chunk_row.reshape(-1).astype(np.int64)
    nr = p.nr_rows
    if kind == "flat":
        port = fl._FinalLevelV2.build(cr, nr, p.sections, p.planes)
        jfin = jsp._FinalLevelV2.build(cr, nr, p.sections, p.planes, True)
        jax_fn = jspmm._final_v2_sums_multi
    else:
        port = fl._FinalLevel.build(cr, nr)
        jfin = jsp._FinalLevel.build(cr, nr, True)
        jax_fn = jspmm._final_gather_sums_multi
    pos = np.concatenate([port.spill_pos, [3, 11, 40]]).astype(np.int32)
    row = np.concatenate([port.spill_row, [5, nr, 7]]).astype(np.int32)
    port.spill_pos, port.spill_row = pos, row
    jfin.spill_pos, jfin.spill_row = jnp.asarray(pos), jnp.asarray(row)
    dev = sg.final_device(port, nr, cr.shape[0], "cpu")
    assert dev.v2 == (kind == "flat") and dev.n_spills == pos.size - 1
    vec = np.random.default_rng(5).standard_normal((cr.shape[0], 3)).astype(
        np.float32)
    before = sum(fr.final_rows_multi.launches.values())
    Y = dev.apply_multi(torch.from_numpy(vec)).numpy()
    assert sum(fr.final_rows_multi.launches.values()) == before
    assert Y.shape == (nr, 3)
    cs = jnp.asarray(np.ascontiguousarray(vec.T).reshape(3, -1, 128))
    _close_to(Y, np.asarray(jax_fn(jfin, cs, nr)))
    for j in range(3):
        _close_to(Y[:, j], dev.apply(torch.from_numpy(
            np.ascontiguousarray(vec[:, j]))).numpy())


# ---------------------------------------------------------------------------
# spmm_gstream on every finish
# ---------------------------------------------------------------------------

def _no_final(monkeypatch):
    none = classmethod(lambda cls, *a, **k: None)
    for mod in (fl, jsp):
        monkeypatch.setattr(mod._FinalLevel, "build", none)
        monkeypatch.setattr(mod._FinalLevelV2, "build", none)


DEVICES = {
    # name: (matrix, pack kwargs, final kind, F levels?)
    "legacy": (lambda: _host.random_csr(1200, 5000, 0.004, seed=12,
                                        dtype=np.float32),
               dict(shuffle_lanes=True), "FinalDevice", False),
    "flat": (lambda: _host.random_csr(400, 4000, 0.006, seed=3,
                                      dtype=np.float32),
             dict(shuffle_lanes=False), "FinalDevice", False),
    # 10 sections of 4096 columns: flat finals past 8 sections
    "multi": (lambda: _host.random_csr(200, 40_000, 0.002, seed=4,
                                       dtype=np.float32),
              dict(config=_host.SpmvConfig(dtype=np.float32,
                                           block_cols=4096)),
              "FinalMultiDevice", False),
    "f_levels": (_heavy_matrix, {}, "FinalDevice", True),
    "segment_sum": (lambda: _host.random_csr(1000, 3000, 0.004, seed=5,
                                             dtype=np.float32), {},
                    "NoneType", False),
}


def _one_pass(monkeypatch, dev):
    """Make ``dev``'s SpMM count its k-plane forwards and finals, and fail
    on a per-plane finish (``finish_vec``); returns the counts."""
    calls = {"forward_multi": 0, "apply_multi": 0}

    def count(cls, name):
        fn = getattr(cls, name)

        def counted(self, *a, **kw):
            calls[name] += 1
            return fn(self, *a, **kw)
        monkeypatch.setattr(cls, name, counted)

    count(sg.ForwardStream, "forward_multi")
    if dev.final is not None:
        count(type(dev.final), "apply_multi")

    def per_plane(self, *a, **kw):
        raise AssertionError("spmm_gstream finished a plane at a time")
    monkeypatch.setattr(sg.GStreamDevice, "finish_vec", per_plane)
    return calls


@pytest.mark.parametrize("case", list(DEVICES))
def test_spmm_gstream_matches_jax_and_gold(monkeypatch, case):
    """Every finish: Y against the JAX ``spmm_gstream`` and the gold, in
    one pass over the k planes: one k-plane forward a forward stream (the
    pack's and each F level's), one k-plane final (or ``index_add_``), and
    no per-plane finish."""
    make, kw, final_kind, has_f = DEVICES[case]
    if case == "segment_sum":
        _no_final(monkeypatch)
    m = make()
    p = _host.pack_gstream(m, **kw)
    dev = sg.GStreamDevice(p, device="cpu")
    assert type(dev.final).__name__ == final_kind
    assert bool(len(dev.flevels)) == has_f
    if case in ("legacy", "flat"):
        assert dev.final.v2 == (case == "flat")
    X = _X(m.nr_cols, 2, seed=4)
    Y_jax = np.asarray(jspmm.spmm_gstream(
        jsp.GStreamDevice(p, interpret=True), X))
    calls = _one_pass(monkeypatch, dev)
    n_multi = sum(fr.final_rows_multi.launches.values())
    Y = sp.spmm_gstream(dev, X).numpy()
    assert sum(fr.final_rows_multi.launches.values()) == n_multi
    assert calls == {"forward_multi": 1 + len(dev.flevels),
                     "apply_multi": int(dev.final is not None)}
    _close_to(Y, Y_jax)
    _gold_ok(m, X, Y)


def test_spmm_gstream_f64_meets_gold_and_spmv(monkeypatch):
    """The f64 device's legacy final with spills, on 3 columns: one k-plane
    f64 forward and one k-plane f64 final, against the gold and the
    device's own f64 ``spmv`` a column at 1e-11 * max(1, max|Y|).  (Its
    SpMM against the JAX ``spmm_df64``, a df64 finish a plane, is
    ``test_torch_f64.py::test_df64_gstream_device_and_spmm_match_jax``.)"""
    m = _host.random_csr(1000, 300_000, density=40 / 300_000, seed=1)
    d = pf.DF64GStreamDevice.from_packed(*pf.pack_gstream_df64(m, G=4),
                                         "cpu")
    assert d.final.n_spills > 1000
    X = _X(m.nr_cols, 3, seed=5)
    cols = np.stack([d.spmv(X[:, j]).numpy() for j in range(3)], 1)
    calls = _one_pass(monkeypatch, d)
    Y = pf.spmm_df64(d, X).numpy()
    assert Y.dtype == np.float64
    assert calls == {"forward_multi": 1, "apply_multi": 1}
    for ref in (cols, spmm_gold(m, X)):
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.abs(Y - ref).max() <= 1e-11 * scale


def test_spmm_gstream_bf16_meets_jax_and_gold_at_bf16_tolerance():
    """The JAX bf16 mode rounds X and its sums to bf16; the port keeps
    them f32: both are held to the gold, and to each other, at the bf16
    tolerance."""
    m = _host.random_csr(1000, 2000, density=0.02, seed=71,
                         dtype=np.float32)
    p = _host.pack_gstream(m)
    X = _X(m.nr_cols, 3, seed=6)
    Y = sp.spmm_gstream(sg.GStreamDevice(p, value_dtype=torch.bfloat16,
                                         device="cpu"),
                        X).numpy()
    assert Y.dtype == np.float32
    _gold_ok(m, X, Y, "bfloat16")
    y_jax = np.asarray(jspmm.spmm_gstream(jsp.GStreamDevice(
        p, interpret=True, value_dtype=jnp.bfloat16), X), np.float32)
    tol = _host.default_tolerance("bfloat16", m.nr_nzeros / m.nr_rows)
    for j in range(3):
        assert _host.verification(y_jax[:, j], Y[:, j], *tol) == 0


def test_spmm_gstream_gl_pinned_adds_the_tile_bases():
    """A GL-pinned pack: the port's k-plane forward adds each tile's base
    (the JAX kernel does not), so Y is the gold and k SpMV calls."""
    m = _host.random_csr(300, 20_000, density=0.003, seed=5,
                         dtype=np.float32)
    p = _host.pack_gstream(m, G=8, GL=2)
    assert p.GL == 2
    dev = sg.GStreamDevice(p, device="cpu")
    X = _X(m.nr_cols, 2, seed=2)
    Y = sp.spmm_gstream(dev, X).numpy()
    _gold_ok(m, X, Y)
    _close_to(Y, np.stack([dev.spmv(X[:, j]).numpy() for j in range(2)], 1))


def test_spmm_gstream_rejects_other_devices_and_shapes():
    m = _host.random_csr(300, 2000, density=0.01, seed=1, dtype=np.float32)
    with pytest.raises(TypeError, match="GStreamDevice"):
        sp.spmm_gstream(sf.FusedDevice.from_packed(_host.pack_fused(m),
                                                   "cpu"), _X(2000, 2))
    dev = sg.GStreamDevice(_host.pack_gstream(m), device="cpu")
    with pytest.raises(ValueError, match="X has shape"):
        sp.spmm_gstream(dev, _X(1999, 2))
    with pytest.raises(ValueError, match="X has shape"):
        dev.stream.forward_multi(torch.zeros(128, 2))


# ---------------------------------------------------------------------------
# SparseMatrix @ X on every route
# ---------------------------------------------------------------------------

ROUTES = {
    "fused": (lambda: _host.random_csr(800, 5000, 0.01, seed=7,
                                       dtype=np.float32), {}),
    "hybrid": (lambda: _heavy_rows(600, 150, 100), {}),
    "classic_block_cols": (lambda: _host.random_csr(
        300, 2000, 0.01, seed=1, dtype=np.float32), dict(block_cols=8192)),
    "partitions": (lambda: _host.random_csr(300, 2000, 0.01, seed=1,
                                            dtype=np.float32),
                   dict(num_partitions=2)),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_sparse_matrix_spmm_matches_jax_and_gold(route):
    make, cfg = ROUTES[route]
    m = make()
    config = SpmvConfig(**{"dtype": np.float32, **cfg})
    jsm = JaxSparseMatrix(m, config, interpret=True)
    sm = st.SparseMatrix(m, _host.SpmvConfig(**{"dtype": np.float32, **cfg}),
                         device="cpu")
    if route == "hybrid":
        assert sm.heavy_device is not None and jsm._heavy_dev is not None
    if route == "partitions":
        assert [type(d).__name__ for d in sm.parts] == \
            [type(d).__name__ for d in jsm._parts]
    X = _X(m.nr_cols, 2, seed=1)
    Y = (sm @ X).numpy()
    _close_to(Y, np.asarray(jsm @ X))
    _gold_ok(m, X, Y)
    assert sm._classic is None              # no classic device was built


def test_sparse_matrix_spmm_past_the_budget_takes_the_classic_device(
        monkeypatch):
    """k past the fused budget: both packages pack the kept source CSR
    onto a classic device and run the k-plane classic SpMM; a partition
    takes one fused SpMV a column."""
    m = _host.random_csr(800, 5000, 0.01, seed=7, dtype=np.float32)
    sm = st.SparseMatrix(m, device="cpu")
    assert sm.fused_device is not None
    monkeypatch.setattr(sf, "SPMM_PLANE_BYTES_MAX", 0)
    assert not sm.fused_device.spmm_applicable(1)
    X = _X(m.nr_cols, 2, seed=3)
    n_fused = sf.fused_spmm.launches
    Y = (sm @ X).numpy()
    assert isinstance(sm._classic, st.GStreamDevice)
    assert sm._classic_device() is sm._classic
    jsm = JaxSparseMatrix(m, SpmvConfig(dtype=np.float32), interpret=True)
    import sparsetpu.kernels.spmv_fused as jsf
    monkeypatch.setattr(jsf, "SPMM_PLANE_BYTES_MAX", 0)
    _close_to(Y, np.asarray(jsm @ X))
    _gold_ok(m, X, Y)
    assert sf.fused_spmm.launches == n_fused
    parts = st.SparseMatrix(m, _host.SpmvConfig(dtype=np.float32,
                                                num_partitions=2),
                            device="cpu")
    _gold_ok(m, X, (parts @ X).numpy())


def test_sparse_matrix_spmm_bf16_and_shape_checks():
    m = _host.random_csr(1000, 2000, density=0.02, seed=71,
                         dtype=np.float32)
    sm = st.SparseMatrix(m, _host.SpmvConfig(dtype="bfloat16"), device="cpu")
    X = _X(m.nr_cols, 2, seed=8)
    _gold_ok(m, X, sm.spmm(torch.from_numpy(X)).numpy(), "bfloat16")
    with pytest.raises(ValueError, match="X has shape"):
        sm.spmm(X[:-1])
