"""sparsetpu_torch's classic GStream device against the JAX package's.

The same numpy inputs (matrices and vectors from seeds) go through the JAX
functions (Pallas interpret mode) and through the port's plain PyTorch
versions, which are what the port's wrappers run on CPU tensors:

  forward   ``gstream_chunk_sums`` vs ``_gstream_chunk_sums`` (#3 window
            kernel, #2 per-tile-base kernel);
  finals    ``FinalDevice``/``FinalMultiDevice`` vs ``_FinalLevel``,
            ``_FinalLevelV2``, ``_FinalLevelMulti`` ``apply`` (#5, #4);
  device    ``GStreamDevice.spmv`` vs ``GStreamDevice(interpret=True)``,
            with F levels, spills, the segment-sum route and bf16 values.

Tolerances: f32 results rtol 1e-5, atol 1e-5 * max(1, max|ref|): the same
f32 terms summed in another order.  bf16 values against the JAX bf16 mode
and the gold at ``default_tolerance("bfloat16", nnz/row)``.  The port's
host copies (packers and final builders) must give byte-identical arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sparsetpu.native.final as jax_native_final
import sparsetpu.pack.gather_stream as jax_gs
from sparsetpu.formats.csr import CSRMatrix as JaxCSRMatrix
from sparsetpu.kernels import spmv_pallas as jsp
from sparsetpu.pack.fused import pack_fused as jax_pack_fused

import sparsetpu_torch.native.final as port_native_final
from sparsetpu_torch import _host
from sparsetpu_torch.kernels import spmv_gstream as sg
from sparsetpu_torch.pack import final_levels as fl
from test_torch_fused import native_engines_first  # noqa: F401 (autouse)

RTOL = 1e-5


def _close_to(y, ref):
    y, ref = np.asarray(y), np.asarray(ref)
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=RTOL, atol=atol)


def _gold_ok(m, x, y, dtype=np.float32):
    tol = _host.default_tolerance(dtype, m.nr_nzeros / max(m.nr_rows, 1))
    assert _host.verification(_host.spmv_gold(m, x), np.asarray(y),
                              *tol) == 0


def _both(m):
    """The port's and the JAX package's CSRMatrix of the same arrays."""
    return m, JaxCSRMatrix(m.row_ptr, m.col_ind, m.values, m.nr_rows,
                           m.nr_cols)


def _heavy_matrix():
    """test_finish_heavy_rows_f_levels's power-law rows (F levels)."""
    rng = np.random.default_rng(7)
    r, c = 300, 20000
    nnz_per_row = np.minimum((rng.pareto(1.0, r) * 30).astype(int) + 1, c)
    rows = np.repeat(np.arange(r), nnz_per_row)
    cols = np.concatenate(
        [rng.choice(c, k, replace=False) for k in nnz_per_row])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return _host.CSRMatrix.from_coo(rows, cols, vals, r, c)


def _jax_chunk_sums(p, x2, values=None):
    tb = (jnp.asarray(p.tile_base.reshape(p.n_steps, p.tiles_per_step))
          if p.GL else None)
    return np.asarray(jsp._gstream_chunk_sums(
        jnp.asarray(p.step_window), jnp.asarray(x2),
        jnp.asarray(p.values if values is None else values),
        jnp.asarray(jsp.combine_meta(p.cell_idx, p.route)),
        tiles_per_step=p.tiles_per_step, G=p.G, n_steps=p.n_steps,
        P=p.planes, GL=p.GL, tile_base=tb, interpret=True))


def _x2(p, seed):
    x = np.random.default_rng(seed).standard_normal(p.nr_cols)
    return np.pad(x, (0, p.padded_cols - p.nr_cols)).astype(
        np.float32).reshape(-1, 128)


# ---------------------------------------------------------------------------
# forward chunk sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,q", [(1, 8), (1, 2), (4, 8), (4, 2)])
def test_window_chunk_sums_match_jax(g, q):
    """#3 (GL = 0): the select chain over G groups, Q sublanes a plane."""
    m = _host.random_csr(1200, 6000, density=0.004, seed=10 + g + q,
                         dtype=np.float32)
    p = _host.pack_gstream(m, G=g, Q=q)
    assert (p.G, p.Q, p.GL) == (g, q, 0)
    x2 = _x2(p, 3)
    fwd = sg.ForwardStream(p, "cpu")
    before = sum(sg.gstream_chunk_sums.launches.values())
    out = fwd(torch.from_numpy(x2))
    assert sum(sg.gstream_chunk_sums.launches.values()) == before
    assert tuple(out.shape) == (p.n_tiles * p.planes, 128)
    _close_to(out.numpy(), _jax_chunk_sums(p, x2))


@pytest.mark.parametrize("q,g,gl,slab", [
    (8, 8, 2, 0), (4, 8, 4, 0), (8, 8, 2, 256), (4, 8, 4, 512),
    (4, 4, 2, 256)])
def test_tile_base_chunk_sums_match_jax(q, g, gl, slab):
    """#2 (GL > 0), the (q, g, gl, slab) cases of test_v2."""
    m = _host.random_csr(1500, 15000, density=0.003, seed=9,
                         dtype=np.float32)
    p = _host.pack_gstream(m, Q=q, G=g, GL=gl, slab=slab,
                           shuffle_lanes=False)
    assert p.GL == gl and p.tile_base is not None
    x2 = _x2(p, 4)
    out = sg.ForwardStream(p, "cpu")(torch.from_numpy(x2))
    _close_to(out.numpy(), _jax_chunk_sums(p, x2))


def test_bf16_chunk_sums_match_jax_bf16():
    """bf16 values, f32 x and sums: both round the values to bf16 the same
    way (nearest even), so only the summation order differs."""
    m = _host.random_csr(1000, 4000, density=0.01, seed=71,
                         dtype=np.float32)
    p = _host.pack_gstream(m, Q=8, G=4)
    x2 = _x2(p, 6)
    out = sg.ForwardStream(p, "cpu", torch.bfloat16)(torch.from_numpy(x2))
    ref = _jax_chunk_sums(p, x2, jnp.asarray(p.values, jnp.bfloat16))
    _close_to(out.numpy(), ref)


# ---------------------------------------------------------------------------
# final levels
# ---------------------------------------------------------------------------

def _final_pair(kind):
    """(port final, JAX final, chunk_row, nr_rows) of one final level."""
    if kind == "legacy":
        m = _host.random_csr(2500, 9000, density=0.003, seed=12,
                             dtype=np.float32)
        p = _host.pack_gstream(m, Q=8, G=4, shuffle_lanes=True)
        cr = p.chunk_row.reshape(-1).astype(np.int64)
        return (fl._FinalLevel.build(cr, p.nr_rows),
                jsp._FinalLevel.build(cr, p.nr_rows, True), cr, p.nr_rows)
    if kind == "flat":
        # test_final_v2_oracle_random_vectors
        m = _host.random_csr(3000, 20000, density=0.002, seed=7,
                             dtype=np.float32)
        p = _host.pack_gstream(m, Q=8, G=8, shuffle_lanes=False)
        cr = p.chunk_row.reshape(-1).astype(np.int64)
        return (fl._FinalLevelV2.build(cr, p.nr_rows, p.sections, p.planes),
                jsp._FinalLevelV2.build(cr, p.nr_rows, p.sections, p.planes,
                                        True), cr, p.nr_rows)
    # test_final_multi_past_8_blocks (cut to 600 rows)
    m = _host.random_csr(600, 400_000, density=0.0002, seed=4,
                         dtype=np.float32)
    p = _host.pack_gstream(m)
    assert p.sections.shape[0] > 8
    cr = p.chunk_row.reshape(-1).astype(np.int64)
    return (fl._FinalLevelMulti.build(cr, p.nr_rows, p.sections, p.planes),
            jsp._FinalLevelMulti.build(cr, p.nr_rows, p.sections, p.planes,
                                       True), cr, p.nr_rows)


@pytest.mark.parametrize("kind", ["legacy", "flat", "multi"])
def test_final_apply_matches_jax(kind):
    """Random position vectors (test_v2's oracle) through both finals."""
    port, jfin, cr, nr = _final_pair(kind)
    assert port is not None and jfin is not None
    dev = sg.final_device(port, nr, cr.shape[0], "cpu")
    vec = np.random.default_rng(5).standard_normal(cr.shape[0]).astype(
        np.float32)
    y = dev.apply(torch.from_numpy(vec)).numpy()
    _close_to(y, np.asarray(jfin.apply(jnp.asarray(vec), nr)))
    gold = np.zeros(nr + 1)
    np.add.at(gold, np.minimum(cr, nr), vec)
    assert np.abs(y - gold[:nr]).max() < 1e-3


def test_padded_spills_are_dropped_as_in_jax():
    """A spill with ``spill_row == nr_rows`` (a padded slot) is dropped, as
    the JAX package's ``mode="drop"`` drops it; the others add."""
    port, jfin, cr, nr = _final_pair("legacy")
    pos = np.concatenate([port.spill_pos, [3, 11, 40]]).astype(np.int32)
    row = np.concatenate([port.spill_row, [5, nr, 7]]).astype(np.int32)
    port.spill_pos, port.spill_row = pos, row
    jfin.spill_pos, jfin.spill_row = jnp.asarray(pos), jnp.asarray(row)
    dev = sg.final_device(port, nr, cr.shape[0], "cpu")
    assert dev.n_spills == pos.size - 1
    vec = np.random.default_rng(8).standard_normal(cr.shape[0]).astype(
        np.float32)
    y = dev.apply(torch.from_numpy(vec)).numpy()
    _close_to(y, np.asarray(jfin.apply(jnp.asarray(vec), nr)))
    port.spill_row = np.concatenate([row[:-1], [nr + 1]]).astype(np.int32)
    with pytest.raises(ValueError, match="spill"):
        sg.final_device(port, nr, cr.shape[0], "cpu")


def test_final_out_of_range_window_is_rejected():
    port, _, cr, nr = _final_pair("legacy")
    port.step_meta = port.step_meta.copy()
    port.step_meta[0, 0] = port.x_pad_rows     # a window past the padding
    with pytest.raises(ValueError, match="window"):
        sg.final_device(port, nr, cr.shape[0], "cpu")


# ---------------------------------------------------------------------------
# the whole device
# ---------------------------------------------------------------------------

DEVICES = {
    "g1_flat": lambda: (_host.random_csr(1500, 3000, 0.004, seed=21,
                                         dtype=np.float32),
                        dict(G=1, Q=8)),
    "gl_slab_flat": lambda: (_host.random_csr(1500, 15000, 0.003, seed=9,
                                              dtype=np.float32),
                             dict(Q=8, G=8, GL=2, slab=256,
                                  shuffle_lanes=False)),
    "f_levels_legacy": lambda: (_heavy_matrix(), {}),
}


@pytest.mark.parametrize("case", list(DEVICES))
def test_device_spmv_matches_jax_and_gold(case):
    m, kw = DEVICES[case]()
    p = _host.pack_gstream(m, **kw)
    jdev = jsp.GStreamDevice(p, interpret=True)
    dev = sg.GStreamDevice(p, device="cpu")
    assert type(dev.plan.final).__name__ == type(jdev.final).__name__
    assert len(dev.flevels) == len(jdev.finish)
    if case == "f_levels_legacy":
        assert len(dev.flevels) >= 1
    x = np.random.default_rng(1).standard_normal(m.nr_cols)
    y = dev.spmv(x).numpy()
    _close_to(y, np.asarray(jdev.spmv(x)))
    _gold_ok(m, x, y)


def test_f_level_positions_match_jax():
    """The position vector after the F levels (chunk sums, then each F
    level's outputs) is the JAX package's."""
    m = _heavy_matrix()
    p = _host.pack_gstream(m)
    jdev = jsp.GStreamDevice(p, interpret=True)
    dev = sg.GStreamDevice(p, device="cpu")
    x2 = _x2(p, 2)
    cs = np.array(_jax_chunk_sums(p, x2))
    vec = jnp.asarray(cs).reshape(-1)
    for f in jdev.finish:
        vec = jnp.concatenate([vec, f.apply(vec).reshape(-1)])
    _close_to(dev.positions(torch.from_numpy(cs)).numpy(), np.asarray(vec))


def test_segment_sum_route_matches_jax(monkeypatch):
    """No final can be built: both packages reduce the position vector by
    a segment-sum (the port's ``spmv_chunked``)."""
    none = classmethod(lambda cls, *a, **k: None)
    for mod in (fl, jsp):
        monkeypatch.setattr(mod._FinalLevel, "build", none)
        monkeypatch.setattr(mod._FinalLevelV2, "build", none)
    m = _heavy_matrix()
    p = _host.pack_gstream(m)
    jdev = jsp.GStreamDevice(p, interpret=True)
    dev = sg.GStreamDevice(p, device="cpu")
    assert jdev.final is None and dev.final is None
    jrow = np.asarray(jdev.chunk_row)
    keep = np.flatnonzero(jrow != m.nr_rows)
    assert np.array_equal(dev.chunk_pos.numpy(), keep)
    assert np.array_equal(dev.chunk_row.numpy(), jrow[keep])
    x = np.random.default_rng(3).standard_normal(m.nr_cols)
    y = dev.spmv(x).numpy()
    _close_to(y, np.asarray(jdev.spmv(x)))
    _gold_ok(m, x, y)


def test_bf16_device_matches_jax_bf16_mode():
    """test_bf16_value_mode's matrix on the classic device, bf16 values."""
    m = _host.random_csr(1000, 2000, density=0.02, seed=71,
                         dtype=np.float32)
    p = _host.pack_gstream(m)
    x = np.random.default_rng(6).standard_normal(m.nr_cols)
    y = sg.GStreamDevice(p, value_dtype=torch.bfloat16,
                         device="cpu").spmv(x).numpy()
    y_jax = np.asarray(jsp.GStreamDevice(
        p, interpret=True, value_dtype=jnp.bfloat16).spmv(x))
    assert y.dtype == np.float32
    tol = _host.default_tolerance("bfloat16", m.nr_nzeros / m.nr_rows)
    assert _host.verification(y_jax, y, *tol) == 0
    _gold_ok(m, x, y, "bfloat16")


def test_prepare_x_pads_to_the_window():
    m = _host.random_csr(300, 2500, density=0.01, seed=1, dtype=np.float32)
    p = _host.pack_gstream(m)
    dev = sg.GStreamDevice(p, device="cpu")
    x = np.arange(m.nr_cols, dtype=np.float32)
    x2 = dev.prepare_x(x)
    assert tuple(x2.shape) == (p.padded_cols // 128, 128)
    assert np.array_equal(x2.reshape(-1)[:m.nr_cols].numpy(), x)
    assert not x2.reshape(-1)[m.nr_cols:].any()
    with pytest.raises(ValueError):
        dev.prepare_x(x[:-1])


def test_pack_out_of_range_is_rejected():
    """Upload checks: a step window past the padded x, a per-tile base past
    the window, and a cell past the 8 rows of a one-group window."""
    import dataclasses
    m = _host.random_csr(1500, 15000, density=0.003, seed=9,
                         dtype=np.float32)
    p = _host.pack_gstream(m, Q=8, G=8, GL=2, shuffle_lanes=False)
    bad = dataclasses.replace(p, step_window=p.step_window + 100)
    with pytest.raises(ValueError, match="step_window"):
        sg.ForwardStream(bad, "cpu")
    bad = dataclasses.replace(p, tile_base=p.tile_base + p.G)
    with pytest.raises(ValueError, match="tile_base"):
        sg.ForwardStream(bad, "cpu")
    p1 = _host.pack_gstream(m, G=1, Q=8)
    cells = p1.cell_idx.copy()
    cells[0, 0] = 8
    with pytest.raises(ValueError, match="one-group"):
        sg.ForwardStream(dataclasses.replace(p1, cell_idx=cells), "cpu")


# ---------------------------------------------------------------------------
# the host copies give the JAX package's very arrays
# ---------------------------------------------------------------------------

BYTE_MATRICES = [
    lambda: _host.random_csr(1500, 9000, 0.004, seed=2, dtype=np.float32),
    lambda: _host.random_csr(2000, 2000, 0.01, seed=9, dtype=np.float32,
                             powerlaw=True),
]


def _same(a, b, names):
    for k in names:
        va, vb = getattr(a, k), getattr(b, k)
        if va is None or vb is None:
            assert va is None and vb is None, k
        elif isinstance(va, (int, float, bool, np.integer)):
            assert va == vb, k
        else:
            va, vb = np.asarray(va), np.asarray(vb)
            assert va.dtype == vb.dtype and np.array_equal(va, vb), k


GS_FIELDS = ("values", "cell_idx", "route", "chunk_row", "step_window",
             "sections", "tile_base", "G", "Q", "GL", "tiles_per_step",
             "padded_cols", "ordered", "nr_nzeros")
FINAL_FIELDS = ("step_meta", "cell_idx", "route", "spill_pos", "spill_row",
                "tiles_per_step", "nt_pad", "x_pad_rows", "n_spills")


def _same_final(a, b):
    assert type(a).__name__ == type(b).__name__
    if a is None:
        return
    if hasattr(a, "levels"):
        assert len(a.levels) == len(b.levels)
        for la, lb in zip(a.levels, b.levels):
            _same_final(la, lb)
        return
    extra = (("tile_bases", "GL_f", "nwin", "GS") if hasattr(a, "GL_f")
             else ("G", "nw"))
    _same(a, b, FINAL_FIELDS[:3] + FINAL_FIELDS[5:] + extra)
    for k in ("spill_pos", "spill_row"):
        va, vb = getattr(a, k), getattr(b, k)
        vb = np.zeros(0, va.dtype) if vb is None else np.asarray(vb)
        assert np.array_equal(va, vb), k


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("which", [0, 1])
def test_host_copies_are_byte_identical(monkeypatch, native, which):
    """pack_fused, pack_gstream (v1 and v2) and the finish plan (F levels
    and final) of the port's copies equal the JAX package's, with the
    native engines on and off."""
    if not native:
        for mod in (jax_native_final, port_native_final):
            monkeypatch.setattr(mod, "available", lambda: False)
    m, jm = _both(BYTE_MATRICES[which]())
    a, b = _host.pack_fused(m, use_native=native), jax_pack_fused(
        jm, use_native=native)
    assert (a is None) == (b is None)
    if a is not None:
        _same(a, b, ("values", "meta_i1", "meta_rt", "tile_base", "fin1_i1",
                     "fin1_rt", "fin2_i1", "fin2_rt", "fin2_group",
                     "step_slab", "step_first", "slab_bounds", "spill_row",
                     "Q", "GLW", "T", "GX", "OBp", "F1_max", "F2_max",
                     "n_slabs", "fin_direct", "SGRP"))
    for kw in (dict(), dict(Q=4, G=8, GL=2, slab=256, shuffle_lanes=False)):
        pa = _host.pack_gstream(m, use_native=native, **kw)
        pb = jax_gs.pack_gstream(jm, use_native=native, **kw)
        _same(pa, pb, GS_FIELDS)
        plan = fl.build_finish(pa)
        jdev = jsp.GStreamDevice(pb, interpret=True)
        assert len(plan.flevels) == len(jdev.finish)
        for fa, fb in zip(plan.flevels, jdev.finish):
            _same(fa, fb.meta, GS_FIELDS)
        _same_final(plan.final, jdev.final)
        cr = pa.chunk_row.reshape(-1).astype(np.int64)
        _same_final(fl._FinalLevel.build(cr, pa.nr_rows),
                    jsp._FinalLevel.build(cr, pa.nr_rows, True))
