"""sparsetpu_torch's row-sorted final (``kernels/final_rows.py``) against
the TPU layout's final, the JAX package's and the gold, on one plane and on
k planes.

``FinalRows`` is the final level's 0/1 map from positions to rows, built at
upload from the very tables the JAX package builds.  The same final levels
(``_final_pair``: legacy, flat, and multi past 8 sections) and random
position vectors from seeds go through

  ``final_rows_reference``   what the port's wrappers run on CPU tensors
  ``final_rows_multi_reference``  (one plane, and k planes);
  the TPU layout             each level's ``final_gather_reference`` grid
                             (``final_gather_multi_reference`` on k
                             planes), sliced to nr_rows, plus its spills;
  the JAX finals             ``apply``, and the k-plane
                             ``_final_v2_sums_multi`` and
                             ``_final_gather_sums_multi``, in Pallas
                             interpret mode;
  the gold                   ``np.add.at`` over ``chunk_row``.

Tolerances: against the TPU layout 1e-6 * max(1, max|y|) in f32 (the same
terms added in another order), against JAX ``_close_to``'s (rtol 1e-5,
atol 1e-5 * max(1, max|ref|)), against the gold 1e-3 (as
``test_final_apply_matches_jax``); f64 at ``tests/test_torch_f64.py``'s
1e-11 * max(1, max|y|).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparsetpu.kernels import f64emu as jf
from sparsetpu.kernels import spmm as jspmm
from sparsetpu.kernels import spmv_pallas as jsp

import sparsetpu_torch as st
from sparsetpu_torch import _host
from sparsetpu_torch.kernels import f64emu as pf
from sparsetpu_torch.kernels import final_rows as fr
from sparsetpu_torch.kernels import spmv_gstream as sg
from sparsetpu_torch.pack import final_levels as fl
from test_torch_fused import native_engines_first  # noqa: F401 (autouse)
from test_torch_gstream import _close_to, _final_pair


def _tpu_layout(dev, vec):
    """y (Y for a k-plane vec) as the TPU layout computes it: every level's
    grid (plain version), sliced to nr_rows and summed, then every level's
    spills."""
    nr = dev.rows.nr_rows
    levels = list(getattr(dev, "levels", [dev]))
    if vec.dim() == 1:
        y = sum(lvl.grid(vec, sg.final_gather_reference).reshape(-1)[:nr]
                for lvl in levels)
    else:
        y = sum(lvl.grid_multi(vec)[:nr] for lvl in levels)
    for lvl in levels:
        t = lvl.tables(vec.device)
        y.index_add_(0, t.spill_row, vec[t.spill_pos])
    return y


def _near(y, ref, rel):
    """max |y - ref| <= rel * max(1, max|ref|)."""
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape and y.dtype == ref.dtype
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    err = float(np.abs(y - ref).max()) if ref.size else 0.0
    assert err <= rel * scale, (err, scale)


def _vec(n, seed, dtype=np.float32):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(n).astype(dtype))


@pytest.mark.parametrize("kind", ["legacy", "flat", "multi"])
def test_final_rows_match_tpu_layout_jax_and_gold(kind):
    port, jfin, cr, nr = _final_pair(kind)
    dev = sg.final_device(port, nr, cr.shape[0], "cpu")
    rows = dev.rows
    assert rows.nr_rows == nr and rows.n_positions == cr.shape[0]
    # one map for every level of a multi final, spills in
    levels = list(getattr(dev, "levels", [dev]))
    assert (len(levels) > 1) == (kind == "multi")
    assert all(getattr(lvl, "rows", None) is None for lvl in levels) \
        == (kind == "multi")
    # every chunk of a real row is an entry, once
    live = np.sort(np.flatnonzero(cr < nr))
    assert np.array_equal(np.sort(rows.idx.numpy()), live)
    vec = _vec(cr.shape[0], 5)
    y = fr.final_rows_reference(vec, rows)
    assert y.dtype == torch.float32 and tuple(y.shape) == (nr,)
    _near(y.numpy(), _tpu_layout(dev, vec).numpy(), 1e-6)
    _close_to(y.numpy(), np.asarray(jfin.apply(jnp.asarray(vec.numpy()),
                                               nr)))
    gold = np.zeros(nr + 1)
    np.add.at(gold, np.minimum(cr, nr), vec.numpy())
    assert np.abs(y.numpy() - gold[:nr]).max() < 1e-3
    # the device's apply is this map through the wrapper
    before = dict(fr.final_rows.launches)
    assert torch.equal(dev.apply(vec), y)
    assert dict(fr.final_rows.launches) == before


def test_no_device_keeps_tpu_tables():
    """No final keeps the TPU tables on its device, on any kind of level,
    on the f32, f64 and BSR devices: the map is the only buffer; ``tables``
    uploads them anew from the host level, equal to the host arrays, and
    the TPU layout's plain final over them (``grid``, ``grid_multi``) agrees
    with the map on one plane and on k."""
    def buffers(d):
        return {n for n, b in d.named_buffers() if b is not None}

    for kind in ("legacy", "flat", "multi"):
        port, _, cr, nr = _final_pair(kind)
        dev = sg.final_device(port, nr, cr.shape[0], "cpu")
        assert buffers(dev) == {"rows.rowptr", "rows.idx", "rows.by_length",
                                "rows.long_rows"}
        for lvl, host in zip(getattr(dev, "levels", [dev]),
                             getattr(port, "levels", [port])):
            t = lvl.tables("cpu")
            assert np.array_equal(t.cells.numpy(), host.cell_idx)
            assert np.array_equal(t.step_meta.numpy(), host.step_meta)
        vec = _vec(cr.shape[0], 3)
        _near(fr.final_rows_reference(vec, dev.rows).numpy(),
              _tpu_layout(dev, vec).numpy(), 1e-6)
        V = torch.stack([vec, 2 * vec], 1)
        _near(dev.apply_multi(V).numpy(), _tpu_layout(dev, V).numpy(), 1e-6)
    m = _host.random_csr(1000, 300_000, density=40 / 300_000, seed=1)
    d = pf.DF64GStreamDevice.from_packed(*pf.pack_gstream_df64(m, G=4),
                                         "cpu")
    assert d.final.rows.n_entries > 0 and not hasattr(d.final, "cells")
    b = st.BSRDevice(_host.csr_to_bsr(_host.fem_poisson_3d(
        4, np.float32)), device="cpu")
    assert b.final is not None and buffers(b.final) == {
        "rows.rowptr", "rows.idx", "rows.by_length", "rows.long_rows"}
    p = _host.pack_gstream(_host.random_csr(1500, 3000, 0.004, seed=21,
                                            dtype=np.float32), G=1, Q=8)
    d = sg.GStreamDevice(p, device="cpu")
    assert isinstance(d.final, sg.FinalDevice) and not len(d.flevels)
    assert {n for n in buffers(d) if n.startswith("final.")} == {
        "final.rows.rowptr", "final.rows.idx", "final.rows.by_length",
        "final.rows.long_rows"}


def _spilling_legacy():
    """(legacy final with spills, chunk_row, nr_rows): the f64 device's
    pack of ``test_df64_final_matches_jax``."""
    m = _host.random_csr(1000, 300_000, density=40 / 300_000, seed=1)
    cr = pf.pack_gstream_df64(m, G=4)[0].chunk_row.reshape(-1).astype(
        np.int64)
    return fl._FinalLevel.build(cr, m.nr_rows), cr, m.nr_rows


def test_final_rows_keep_level_order_then_spills():
    """Within a row the entries keep (level, instance, tile, sublane) order
    with the spills last: the stable sort of the live slots."""
    port, cr, nr = _spilling_legacy()
    assert port.spill_pos.size > 1000
    dev = sg.final_device(port, nr, cr.shape[0], "cpu")
    tb = dev.tables("cpu")
    idx, ok = sg.final_gather_index(
        tb.step_meta, tb.tile_bases, tb.cells, tb.route, tps=dev.tps,
        G=dev.G, nw=dev.nw, GS=dev.GS, v2=dev.v2)
    o = tb.step_meta[:, dev.nw + 1].long().view(-1, 1, 1, 1)
    t = torch.arange(dev.tps).view(1, -1, 1, 1)
    row = ((o * dev.tps + t) * 128 + torch.arange(128)).expand_as(idx)
    keep = ok & (row < nr)
    ent = np.concatenate([np.stack([row[keep].numpy(), idx[keep].numpy()]),
                          np.stack([tb.spill_row.numpy(),
                                    tb.spill_pos.numpy()])], axis=1)
    order = np.argsort(ent[0], kind="stable")
    assert np.array_equal(dev.rows.idx.numpy(), ent[1, order])
    counts = np.bincount(ent[0], minlength=nr)
    assert np.array_equal(np.diff(dev.rows.rowptr.numpy()), counts)


def test_f64_final_rows_match_jax_and_gold():
    """The f64 device's legacy final with spills (#12), in float64."""
    m = _host.random_csr(1000, 300_000, density=40 / 300_000, seed=1)
    ph, pl = pf.pack_gstream_df64(m, G=4)
    d = pf.DF64GStreamDevice.from_packed(ph, pl, "cpu")
    cr = ph.chunk_row.reshape(-1).astype(np.int64)
    assert d.final.n_spills > 1000
    vec = _vec(cr.size, 5, np.float64)
    y = fr.final_rows_reference(vec, d.final.rows)
    assert y.dtype == torch.float64
    _near(y.numpy(), _tpu_layout(d.final, vec).numpy(), 1e-11)
    jfin = jsp._FinalLevel.build(cr, m.nr_rows, True)
    need = jfin.x_pad_rows * 128
    vh, vl = jf.split_f64(np.pad(vec.numpy(), (0, need - cr.size)))
    gh, gl = jf._df64_final_sums(
        jfin.step_meta, jnp.asarray(vh.reshape(-1, 128)),
        jnp.asarray(vl.reshape(-1, 128)), jfin.cell_idx, jfin.route,
        tiles_per_step=jfin.tiles_per_step, G=jfin.G, n_steps=jfin.n_steps,
        nw=jfin.nw, n_out_tiles=jfin.nt_pad, interpret=True)
    jy = jf.join_f64(gh, gl).reshape(-1)[:m.nr_rows]
    keep = np.asarray(jfin.spill_row) < m.nr_rows
    np.add.at(jy, np.asarray(jfin.spill_row)[keep],
              vec.numpy()[np.asarray(jfin.spill_pos)[keep]])
    _near(y.numpy(), jy, 1e-11)
    gold = np.zeros(m.nr_rows + 1)
    np.add.at(gold, np.minimum(cr, m.nr_rows), vec.numpy())
    _near(y.numpy(), gold[:m.nr_rows], 1e-11)


def test_final_rows_drop_padded_spills():
    port, jfin, cr, nr = _final_pair("flat")
    plain = sg.final_device(port, nr, cr.shape[0], "cpu")
    pos = np.concatenate([port.spill_pos, [3, 11, 40]]).astype(np.int32)
    row = np.concatenate([port.spill_row, [5, nr, 7]]).astype(np.int32)
    port.spill_pos, port.spill_row = pos, row
    jfin.spill_pos, jfin.spill_row = jnp.asarray(pos), jnp.asarray(row)
    dev = sg.final_device(port, nr, cr.shape[0], "cpu")
    assert dev.rows.n_entries == plain.rows.n_entries + 2
    vec = _vec(cr.shape[0], 8)
    y = fr.final_rows_reference(vec, dev.rows)
    _near(y.numpy(), _tpu_layout(dev, vec).numpy(), 1e-6)
    _close_to(y.numpy(), np.asarray(jfin.apply(jnp.asarray(vec.numpy()),
                                               nr)))


def test_final_rows_empty_and_long_rows():
    """Rows with no entry give 0; a row past SHORT_MAX is in the long bin;
    both through the map built directly and through a final level."""
    lens = np.array([2, 0, 3, 0, fr.SHORT_MAX + 5, 1, 0, 200])
    rowptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(
        np.int32))
    n = int(lens.sum())
    idx = torch.from_numpy(np.random.default_rng(0).permutation(
        n + 10)[:n].astype(np.int32))
    rows = fr.FinalRows(rowptr, idx, n + 10)
    assert rows.long_rows.tolist() == [4, 7] and rows.n_long == 2
    vec = _vec(n + 10, 1)
    y = fr.final_rows(vec, rows).numpy()
    ref = np.zeros(lens.size, np.float64)
    np.add.at(ref, np.repeat(np.arange(lens.size), lens), vec.numpy()[idx])
    _near(y, ref.astype(np.float32), 1e-6)
    assert (y[lens == 0] == 0).all()

    # a final level over rows with no chunk and a row of 100 chunks
    nr = 700
    cr = np.concatenate([np.arange(0, nr, 2).repeat(2), np.full(100, 5),
                         np.full(37, nr)])
    cr = cr[np.random.default_rng(3).permutation(cr.size)].astype(np.int64)
    lvl = fl._FinalLevel.build(cr, nr)
    assert lvl is not None
    dev = sg.final_device(lvl, nr, cr.size, "cpu")
    assert 5 in dev.rows.long_rows.tolist()
    vec = _vec(cr.size, 2)
    y = fr.final_rows_reference(vec, dev.rows)
    _near(y.numpy(), _tpu_layout(dev, vec).numpy(), 1e-6)
    empty = np.arange(1, nr, 2)
    assert (y.numpy()[empty[empty != 5]] == 0).all()
    gold = np.zeros(nr + 1)
    np.add.at(gold, np.minimum(cr, nr), vec.numpy())
    assert np.abs(y.numpy() - gold[:nr]).max() < 1e-4


def test_final_rows_level_without_live_slots():
    """A level whose every cell reads the drain adds nothing: the map keeps
    the other levels' slots and the spills."""
    port, _, cr, nr = _final_pair("multi")
    full = sg.final_device(port, nr, cr.shape[0], "cpu")
    dead = port.levels[1]
    dead.cell_idx = np.full_like(dead.cell_idx, -1)
    dev = sg.final_device(port, nr, cr.shape[0], "cpu")
    vec = _vec(cr.shape[0], 9)
    y = fr.final_rows_reference(vec, dev.rows)
    _near(y.numpy(), _tpu_layout(dev, vec).numpy(), 1e-6)
    assert dev.rows.n_entries < full.rows.n_entries
    assert not np.allclose(y.numpy(), fr.final_rows_reference(
        vec, full.rows).numpy())


def test_final_rows_drop_positions_past_n_positions():
    """Positions at or past n_positions read the TPU layout's zero pad:
    the map drops them."""
    port, _, cr, nr = _final_pair("legacy")
    port.spill_pos = port.spill_pos[:0]
    port.spill_row = port.spill_row[:0]
    n = cr.shape[0] // 2
    full = sg.final_device(port, nr, cr.shape[0], "cpu")
    dev = sg.final_device(port, nr, n, "cpu")
    assert int(dev.rows.idx.max()) < n
    assert dev.rows.n_entries == int((full.rows.idx < n).sum())
    vec = _vec(n, 4)
    y = fr.final_rows_reference(vec, dev.rows)
    _near(y.numpy(), _tpu_layout(dev, vec).numpy(), 1e-6)


def test_final_rows_int32_guard(monkeypatch):
    """n_positions past int32 raises; so does an entry count past it (here
    made by duplicate spills, under a lowered limit)."""
    port, _, cr, nr = _final_pair("legacy")
    with pytest.raises(ValueError, match="int32"):
        sg.final_device(port, nr, 2**31, "cpu")
    n = cr.shape[0]
    port.spill_pos = np.concatenate([port.spill_pos, np.zeros(n, np.int32)])
    port.spill_row = np.concatenate([port.spill_row, np.zeros(n, np.int32)])
    monkeypatch.setattr(fr, "INT32_MAX", n)
    with pytest.raises(ValueError, match="entries"):
        sg.final_device(port, nr, n, "cpu")


def test_final_rows_wrapper_checks():
    rows = fr.FinalRows(torch.tensor([0, 2, 3], dtype=torch.int32),
                        torch.tensor([1, 0, 4], dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="positions"):
        fr.final_rows(_vec(4, 0), rows)
    with pytest.raises(ValueError, match="f32 or f64"):
        fr.final_rows(_vec(5, 0).half(), rows)
    with pytest.raises(ValueError, match="outside"):
        fr.FinalRows(rows.rowptr, torch.tensor([1, 0, 5], dtype=torch.int32),
                     5)
    with pytest.raises(ValueError, match="rise"):
        fr.FinalRows(torch.tensor([0, 3, 2], dtype=torch.int32), rows.idx, 5)
    v = _vec(5, 0)
    assert fr.final_rows(v, rows).tolist() == [float(v[1] + v[0]),
                                               float(v[4])]


def test_sparse_matrix_wide_x_through_final_rows():
    """The slice as a whole: ``SparseMatrix @ x`` with x past the fused
    budget takes the classic device, whose multi final (x past 8
    sections) finishes through the row-sorted map; y against the gold."""
    m = _host.random_csr(200, 1_600_000, density=2e-5, seed=2,
                         dtype=np.float32)
    sm = st.SparseMatrix(m, device="cpu")
    dev = sm.device_module
    assert isinstance(dev, sg.GStreamDevice)
    assert isinstance(dev.final, sg.FinalMultiDevice)
    assert isinstance(dev.final.rows, st.FinalRows)
    x = np.random.default_rng(1).standard_normal(m.nr_cols)
    y = (sm @ x).numpy()
    tol = _host.default_tolerance(np.float32, m.nr_nzeros / m.nr_rows)
    assert _host.verification(_host.spmv_gold(m, x), y, *tol) == 0


# ---------------------------------------------------------------------------
# k planes: final_rows_multi (#8, #9, and the f64 devices' k-plane final)
# ---------------------------------------------------------------------------

def _planes(n, k, seed, dtype=np.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, k)).astype(dtype))


def _gold_multi(cr, nr, V):
    """The gold of a k-plane final: each plane's ``np.add.at`` over
    ``chunk_row`` (the trap row nr dropped)."""
    gold = np.zeros((nr + 1, V.shape[1]))
    np.add.at(gold, np.minimum(cr, nr), V)
    return gold[:nr]


@pytest.mark.parametrize("kind", ["legacy", "flat", "multi"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_final_rows_multi_match_tpu_layout_and_gold(kind, k):
    """The k-plane map on every final kind: against the TPU layout's
    k-plane final (each level's grid and spills), the one-plane map plane
    by plane, and the gold; the devices' ``apply_multi`` is it, with no
    launch on the CPU."""
    port, _, cr, nr = _final_pair(kind)
    dev = sg.final_device(port, nr, cr.shape[0], "cpu")
    V = _planes(cr.shape[0], k, 10 + k)
    Y = fr.final_rows_multi_reference(V, dev.rows)
    assert Y.dtype == torch.float32 and tuple(Y.shape) == (nr, k)
    _near(Y.numpy(), _tpu_layout(dev, V).numpy(), 1e-6)
    for j in range(k):
        _near(Y[:, j].numpy(), fr.final_rows_reference(
            V[:, j].contiguous(), dev.rows).numpy(), 1e-6)
    assert np.abs(Y.numpy() - _gold_multi(cr, nr, V.numpy())).max() < 1e-3
    before = dict(fr.final_rows_multi.launches)
    assert torch.equal(dev.apply_multi(V), Y)
    assert dict(fr.final_rows_multi.launches) == before


def _small_final(kind):
    """(port final, JAX final, chunk_row, nr_rows) of a small legacy or flat
    level with spills: two that add and one padded (``spill_row ==
    nr_rows``), which both packages drop; small enough for the JAX k-plane
    kernels in interpret mode (a few seconds a call)."""
    m = _host.random_csr(300, 3000, 0.01, seed=12, dtype=np.float32)
    p = _host.pack_gstream(m, G=4, Q=2, shuffle_lanes=kind == "legacy")
    cr = p.chunk_row.reshape(-1).astype(np.int64)
    nr = p.nr_rows
    if kind == "flat":
        port = fl._FinalLevelV2.build(cr, nr, p.sections, p.planes)
        jfin = jsp._FinalLevelV2.build(cr, nr, p.sections, p.planes, True)
    else:
        port = fl._FinalLevel.build(cr, nr)
        jfin = jsp._FinalLevel.build(cr, nr, True)
    pos = np.concatenate([port.spill_pos, [3, 11, 40]]).astype(np.int32)
    row = np.concatenate([port.spill_row, [5, nr, 7]]).astype(np.int32)
    port.spill_pos, port.spill_row = pos, row
    jfin.spill_pos, jfin.spill_row = jnp.asarray(pos), jnp.asarray(row)
    return port, jfin, cr, nr


@pytest.mark.parametrize("kind,k", [("legacy", 1), ("flat", 3),
                                    ("legacy", 8)])
def test_final_rows_multi_match_jax(kind, k):
    """Against the JAX k-plane finals in interpret mode
    (``_final_gather_sums_multi``, #9; ``_final_v2_sums_multi``, #8), with
    spills, and against the gold."""
    port, jfin, cr, nr = _small_final(kind)
    dev = sg.final_device(port, nr, cr.shape[0], "cpu")
    assert dev.v2 == (kind == "flat") and dev.n_spills == 2
    V = _planes(cr.shape[0], k, 20 + k)
    Y = fr.final_rows_multi_reference(V, dev.rows).numpy()
    fn = (jspmm._final_v2_sums_multi if kind == "flat"
          else jspmm._final_gather_sums_multi)
    cs = jnp.asarray(np.ascontiguousarray(V.numpy().T).reshape(k, -1, 128))
    _close_to(Y, np.asarray(fn(jfin, cs, nr)))
    gold = _gold_multi(cr, nr, V.numpy())
    gold[5] += V.numpy()[3]
    gold[7] += V.numpy()[40]
    assert np.abs(Y - gold).max() < 1e-3


def test_f64_final_rows_multi_match_jax_and_gold():
    """The f64 device's legacy final with spills (#12's map) on 3 float64
    planes: against the JAX df64 final a plane (``_df64_final_sums``, as
    the JAX ``spmm_df64`` finishes), the TPU layout's k-plane plain final
    and the gold, at 1e-11."""
    m = _host.random_csr(1000, 300_000, density=40 / 300_000, seed=1)
    ph, pl = pf.pack_gstream_df64(m, G=4)
    d = pf.DF64GStreamDevice.from_packed(ph, pl, "cpu")
    cr = ph.chunk_row.reshape(-1).astype(np.int64)
    assert d.final.n_spills > 1000
    V = _planes(cr.size, 3, 7, np.float64)
    Y = fr.final_rows_multi_reference(V, d.final.rows)
    assert Y.dtype == torch.float64
    jfin = jsp._FinalLevel.build(cr, m.nr_rows, True)
    need = jfin.x_pad_rows * 128
    keep = np.asarray(jfin.spill_row) < m.nr_rows
    for j in range(3):
        vh, vl = jf.split_f64(np.pad(V[:, j].numpy(), (0, need - cr.size)))
        gh, gl = jf._df64_final_sums(
            jfin.step_meta, jnp.asarray(vh.reshape(-1, 128)),
            jnp.asarray(vl.reshape(-1, 128)), jfin.cell_idx, jfin.route,
            tiles_per_step=jfin.tiles_per_step, G=jfin.G,
            n_steps=jfin.n_steps, nw=jfin.nw, n_out_tiles=jfin.nt_pad,
            interpret=True)
        jy = jf.join_f64(gh, gl).reshape(-1)[:m.nr_rows]
        np.add.at(jy, np.asarray(jfin.spill_row)[keep],
                  V[:, j].numpy()[np.asarray(jfin.spill_pos)[keep]])
        _near(Y[:, j].numpy(), jy, 1e-11)
    # the TPU layout's k-plane final takes no f64: its planes one at a time
    t = d.final.tables("cpu")
    for j in range(3):
        yt = d.final.grid(V[:, j]).reshape(-1)[:m.nr_rows]
        yt.index_add_(0, t.spill_row, V[t.spill_pos, j])
        _near(Y[:, j].numpy(), yt.numpy(), 1e-11)
    _near(Y.numpy(), _gold_multi(cr, m.nr_rows, V.numpy()), 1e-11)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_final_rows_multi_empty_and_long_rows(k):
    """Empty rows give 0 rows; rows past ``short_max_multi`` are the
    k-plane long bin's (the threshold grows with the plane vectors a row);
    through a map built directly and through a final level with a row of
    100 chunks, against numpy, in f32 and f64."""
    assert [fr.short_max_multi(nv) for nv in (1, 2, 3, 18)] == [16, 16, 16,
                                                                 144]
    lens = np.array([2, 0, 3, 0, 170, 1, 0, 200, 144, 17])
    rowptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(
        np.int32))
    n = int(lens.sum())
    idx = torch.from_numpy(np.random.default_rng(0).permutation(
        n + 10)[:n].astype(np.int32))
    rows = fr.FinalRows(rowptr, idx, n + 10)
    assert rows.rows_over(fr.short_max_multi(18)).tolist() == [4, 7]
    assert rows.rows_over(fr.short_max_multi(2)).tolist() == [9, 8, 4, 7]
    assert rows.long_rows.tolist() == [9, 8, 4, 7] and rows.n_long == 4
    for dtype in (np.float32, np.float64):
        V = _planes(n + 10, k, 1, dtype)
        Y = fr.final_rows_multi(V, rows).numpy()
        ref = np.zeros((lens.size, k))
        np.add.at(ref, np.repeat(np.arange(lens.size), lens),
                  V.numpy()[idx.numpy()])
        assert Y.dtype == dtype
        _near(Y, ref.astype(dtype), 1e-6 if dtype == np.float32 else 1e-12)
        assert (Y[lens == 0] == 0).all()

    nr = 700
    cr = np.concatenate([np.arange(0, nr, 2).repeat(2), np.full(100, 5),
                         np.full(37, nr)])
    cr = cr[np.random.default_rng(3).permutation(cr.size)].astype(np.int64)
    dev = sg.final_device(fl._FinalLevel.build(cr, nr), nr, cr.size, "cpu")
    assert 5 in dev.rows.rows_over(fr.short_max_multi(2)).tolist()
    V = _planes(cr.size, k, 2)
    Y = dev.apply_multi(V)
    _near(Y.numpy(), _tpu_layout(dev, V).numpy(), 1e-6)
    empty = np.arange(1, nr, 2)
    assert (Y.numpy()[empty[empty != 5]] == 0).all()
    assert np.abs(Y.numpy() - _gold_multi(cr, nr, V.numpy())).max() < 1e-4


def test_final_rows_multi_wrapper_checks():
    rows = fr.FinalRows(torch.tensor([0, 2, 3], dtype=torch.int32),
                        torch.tensor([1, 0, 4], dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="positions"):
        fr.final_rows_multi(_planes(4, 2, 0), rows)
    with pytest.raises(ValueError, match="2-D f32 or f64"):
        fr.final_rows_multi(_vec(5, 0), rows)
    with pytest.raises(ValueError, match="2-D f32 or f64"):
        fr.final_rows_multi(_planes(5, 2, 0).half(), rows)
    with pytest.raises(ValueError, match="2-D f32 or f64"):
        fr.final_rows_multi(_planes(5, 2, 0).t(), rows)
    V = _planes(5, 2, 0)
    assert fr.final_rows_multi(V, rows).tolist() == [
        (V[1] + V[0]).tolist(), V[4].tolist()]
