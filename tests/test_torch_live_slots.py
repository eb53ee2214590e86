"""The classic f64 device's forward over its live slots (``LiveSlots``,
``live_slot_sums``) on the CPU, against the forward over the whole pack.

``DF64GStreamDevice`` builds, at upload, the pack's live slots (a nonzero
value whose x index the select chain keeps) at the chunk positions its
finish reads, and its forward sums only those.  Held here:

  * its plain version ``live_slot_sums_reference`` against the TPU-form
    plain version ``gstream_chunk_sums_reference`` at every read position,
    bit for bit on finite x (both sum each chunk in sublane order, and a
    dropped slot only ever added +0), on the classic f64 cases of
    ``test_torch_f64.py`` and the segment-sum route;
  * against the JAX ``_df64_chunk_sums`` (interpret mode, hi + lo joined)
    at 1e-11 * max(1, max|y|), on one small case (the JAX df64 forward
    costs seconds in interpret mode);
  * a read position with no live slot reads 0;
  * x holding inf: stored zeros and padding are dropped, so the port's y
    is the product of the matrix without its stored zeros, where the
    TPU-form sums turn NaN (ROADMAP Queue 3, a standing difference).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from sparsetpu.kernels import f64emu as jf
from sparsetpu.kernels import spmv_pallas as jsp

from sparsetpu_torch import _host
from sparsetpu_torch.kernels import f64emu as pf
from sparsetpu_torch.kernels import spmv_gstream as sg
from sparsetpu_torch.pack import final_levels as fl

# (matrix, G) of the classic f64 cases: G = 1 and G > 1, a legacy final
# that spills, the model's G
CASES = {
    "G=1": (lambda: _host.random_csr(1000, 3000, density=0.01, seed=21), 1),
    "G=4": (lambda: _host.random_csr(1000, 3000, density=0.01, seed=24), 4),
    "legacy final spills": (
        lambda: _host.random_csr(1000, 300_000, density=40 / 300_000,
                                 seed=1), 4),
    "model G": (lambda: _host.random_csr(1500, 2000, density=0.01, seed=7),
                None),
}


def _stored_zeros():
    """A matrix whose rows 10-59 hold stored zeros only."""
    m = _host.random_csr(1000, 3000, density=0.01, seed=1)
    v = m.values.copy()
    v[m.row_ptr[10]:m.row_ptr[60]] = 0.0
    return _host.CSRMatrix(m.row_ptr, m.col_ind, v, m.nr_rows, m.nr_cols)


def _device(m, G=None):
    return pf.DF64GStreamDevice.from_packed(*pf.pack_gstream_df64(m, G=G),
                                            "cpu")


def _tpu_form(d, x):
    """The chunk sums of the whole pack, flat (the TPU-form plain
    version)."""
    return d.stream(d.prepare_x(x),
                    sg.gstream_chunk_sums_reference).reshape(-1)


def _bit_for_bit(d, x):
    sl = d.slots
    pos = sl.pos.long()
    live = d.forward_live(torch.as_tensor(x)).reshape(-1)
    assert live.dtype == torch.float64 and live.numel() == sl.n_positions
    assert torch.equal(live[pos], _tpu_form(d, x)[pos])
    return live


@pytest.mark.parametrize("case", list(CASES))
def test_live_slots_equal_the_tpu_form_bit_for_bit(case):
    make, G = CASES[case]
    m = make()
    d = _device(m, G)
    sl = d.slots
    # the read positions are the final map's, every live slot once
    assert torch.equal(sl.pos, torch.unique(d.final.rows.idx))
    vals = d.stream.values
    assert sl.n_live == int((vals != 0).sum()) == m.nr_nzeros
    x = np.random.default_rng(3).standard_normal(m.nr_cols)
    _bit_for_bit(d, x)
    y = d.spmv(x).numpy()
    g = _host.spmv_gold(m, x)
    assert np.abs(y - g).max() <= 1e-11 * max(1.0, float(np.abs(g).max()))


def test_segment_sum_route_reads_its_own_positions(monkeypatch):
    monkeypatch.setattr(fl._FinalLevel, "build",
                        classmethod(lambda cls, *a, **k: None))
    m = _host.random_csr(800, 3000, density=0.008, seed=5)
    d = pf.DF64GStreamDevice(m, device="cpu")
    assert d.final is None
    assert torch.equal(d.slots.pos.long(), d.chunk_pos)
    x = np.random.default_rng(8).standard_normal(m.nr_cols)
    _bit_for_bit(d, x)


def test_live_slots_meet_jax_df64_chunk_sums():
    m = _host.random_csr(300, 2000, density=0.01, seed=1)
    ph, pl = pf.pack_gstream_df64(m, G=4)
    d = pf.DF64GStreamDevice.from_packed(ph, pl, "cpu")
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    x2h, x2l = (jnp.asarray(a.reshape(-1, 128)) for a in jf.split_f64(
        np.pad(x, (0, ph.padded_cols - ph.nr_cols))))
    ch, cl = jf._df64_chunk_sums(
        jnp.asarray(ph.step_window), x2h, x2l, jnp.asarray(ph.values),
        jnp.asarray(pl.values), jnp.asarray(jsp.combine_meta(ph.cell_idx,
                                                              ph.route)),
        tiles_per_step=ph.tiles_per_step, G=ph.G, n_steps=ph.n_steps,
        interpret=True)
    ref = jf.join_f64(ch, cl).reshape(-1)
    pos = d.slots.pos.numpy()
    got = d.forward_live(torch.as_tensor(x)).reshape(-1).numpy()[pos]
    scale = max(1.0, float(np.abs(ref[pos]).max()))
    assert np.abs(got - ref[pos]).max() <= 1e-11 * scale


def test_read_position_without_live_slot_reads_zero():
    m = _stored_zeros()
    d = _device(m, 4)
    sl = d.slots
    empty = sl.rowptr.diff() == 0
    assert bool(empty.any()) and not bool(empty.all())
    assert sl.n_live == int((m.values != 0).sum()) < m.nr_nzeros
    x = np.random.default_rng(2).standard_normal(m.nr_cols)
    live = _bit_for_bit(d, x)
    assert not bool(live[sl.pos.long()[empty]].any())
    y = d.spmv(x).numpy()
    assert not y[10:60].any()
    g = _host.spmv_gold(m, x)
    assert np.abs(y - g).max() <= 1e-11 * max(1.0, float(np.abs(g).max()))


def test_inf_in_x_drops_stored_zeros_and_padding():
    """Standing difference (ROADMAP Queue 3): where x holds inf, a stored
    zero or a padding slot that reads it adds 0 * inf = NaN to the TPU
    form's chunk sum; the live slots drop both, so y is the product of the
    matrix without its stored zeros, finite where that product is."""
    m = _host.random_csr(1000, 3000, density=0.01, seed=1)
    c = int(m.col_ind[0])
    v = np.where(m.col_ind == c, 0.0, m.values)    # column c: stored zeros
    m = _host.CSRMatrix(m.row_ptr, m.col_ind, v, m.nr_rows, m.nr_cols)
    d = _device(m, 4)
    a = sps.csr_matrix((m.values, m.col_ind, m.row_ptr),
                       shape=(m.nr_rows, m.nr_cols))
    x = np.random.default_rng(4).standard_normal(m.nr_cols)
    x[c] = np.inf
    y = d.spmv(x).numpy()
    with np.errstate(invalid="ignore"):
        gold = a @ x
        a.eliminate_zeros()
        dropped = a @ x
    assert np.isnan(gold).any() and np.isfinite(dropped).all()
    assert np.isfinite(y).all()
    assert np.abs(y - dropped).max() <= 1e-11 * max(
        1.0, float(np.abs(dropped).max()))
    with np.errstate(invalid="ignore"):
        tpu = _tpu_form(d, x)[d.slots.pos.long()]
    assert bool(tpu.isnan().any())


def test_wrapper_and_map_checks():
    m = _host.random_csr(300, 2000, density=0.01, seed=1)
    d = _device(m, 4)
    sl = d.slots
    with pytest.raises(ValueError, match="float64"):
        sg.live_slot_sums(torch.zeros(m.nr_cols), sl)
    with pytest.raises(ValueError, match="elements"):
        sg.live_slot_sums(torch.zeros(m.nr_cols - 1, dtype=torch.float64),
                          sl)
    with pytest.raises(ValueError, match="columns"):
        sg.LiveSlots(sl.pos, sl.rowptr, sl.col, sl.val, sl.n_positions,
                     int(sl.col.max()))
    with pytest.raises(ValueError, match="outside"):
        sg.LiveSlots(sl.pos, sl.rowptr, sl.col, sl.val, int(sl.pos.max()),
                     sl.n_cols)
    with pytest.raises(ValueError, match="float64"):
        d.spmv(torch.zeros(m.nr_cols))
    # x padded (prepare_x) or unpadded reads the same
    x = np.random.default_rng(1).standard_normal(m.nr_cols)
    assert torch.equal(d.spmv(d.prepare_x(x), x_is_packed=True), d.spmv(x))
