"""The fused f32 SpMV's row map on the CPU (``kernels/fused_rows.py``):
``FusedRows``, built at upload from a ``FusedDevice``'s own buffers, the
rows kernel's plain version, and the byte rule by which a device on a card
picks the rows kernel or #1.

  * ``FusedRows.build`` yields exactly the CSR's (row, column, value)
    entries, spills included, bit for bit: Q = 1 with and without
    ``fin_direct``, Q = 2, Q = 8 with spills and non-uniform slabs, the
    hybrid's light rows and a row partition; built a step at a time it is
    the same map as built in one chunk;
  * ``fused_rows_spmv_reference`` equals #1's plain call
    (``spmv_blocks_reference``, y's rows read back by ``_rows``) at the f32
    tolerance, rtol 1e-5, atol 1e-5 * max(1, max|y|): the same terms,
    summed in another order;
  * ``FusedDevice.traffic`` at pinned counts (the map's bytes with a
    32-byte sector a gather): ``"rows"`` on a scattered random graph (one
    nnz a row over 400,000 columns, fill 0.089), ``"tiles"`` on a banded
    matrix; on the CPU every device keeps #1 (``kernel == "tiles"``, no
    map);
  * ``FusedDevice.launch`` and ``bytes_a_call`` follow the device's pick;
  * a CUDA tensor where the kernels cannot be built raises, and nothing
    falls back to the plain version;
  * the kernel's walk over a row's aligned quads (a transcription of
    ``row_part`` in ``csrc/fused_rows.cu``) reads each entry once.

On the card (marked ``gpu``; ``python -m pytest
tests/test_torch_fused_rows.py -m gpu --noconftest``): the kernel against
its plain version at each width, with empty and long rows, and each
regime's device on the card (its pick, its map the CPU build's, one launch
of the rows kernel a ``"rows"`` call), and the build's peak memory
within twice the map's bytes.  Small matrices only: the whole
file takes seconds.
"""

import types

import numpy as np
import pytest
import torch

import sparsetpu_torch as st
from sparsetpu_torch import _host
from sparsetpu_torch.kernels import _build
from sparsetpu_torch.kernels import fused_rows as fr
from sparsetpu_torch.kernels import spmv_fused as sf
from test_torch_fused import REGIMES, native_engines_first  # noqa: F401


def _heavy_light():
    """The light part of a matrix the heavy-row hybrid splits."""
    m = _host.random_csr(2000, 6000, density=0.002, seed=4)
    rp = m.row_ptr.copy()
    cols, vals = list(np.split(m.col_ind, rp[1:-1])), \
        list(np.split(m.values, rp[1:-1]))
    rng = np.random.default_rng(5)
    for r in (7, 900):                       # two rows past 4096 entries
        cols[r] = np.sort(rng.choice(6000, 4500, replace=False))
        vals[r] = rng.standard_normal(4500)
    ptr = np.concatenate([[0], np.cumsum([c.size for c in cols])])
    return _host.CSRMatrix(ptr, np.concatenate(cols), np.concatenate(vals),
                           2000, 6000)


def _device(case):
    """(CSR the device's pack holds, FusedDevice on the CPU)."""
    if case in REGIMES:
        make, kw, regime = REGIMES[case]
        m = make()
        p = _host.pack_fused(m, **kw)
        assert p is not None and regime(p), case
        return m, sf.FusedDevice.from_packed(p, "cpu")
    if case == "hybrid light rows":
        sm = st.SparseMatrix(_heavy_light(),
                             _host.SpmvConfig(dtype=np.float32),
                             device="cpu")
        assert sm.fused_device is not None and sm.heavy_device is not None
        heavy = set(sm._heavy_rows.tolist())
        m = sm._source
        keep = ~np.isin(np.repeat(np.arange(m.nr_rows), np.diff(m.row_ptr)),
                        list(heavy))
        rows = np.repeat(np.arange(m.nr_rows), np.diff(m.row_ptr))[keep]
        light = _host.CSRMatrix.from_coo(rows, m.col_ind[keep],
                                         m.values[keep], m.nr_rows,
                                         m.nr_cols)
        return light, sm.fused_device
    assert case == "partition"
    m = _host.random_csr(3000, 20_000, 3 / 20_000, seed=1)
    sm = st.SparseMatrix(m, _host.SpmvConfig(dtype=np.float32,
                                             num_partitions=2),
                         device="cpu")
    d = sm.parts[1]
    assert isinstance(d, sf.FusedDevice)
    start = m.nr_rows - d.meta.nr_rows
    return m.row_slice(start, m.nr_rows), d


CASES = ["q1_fin_direct", "q1_two_stage_sgrp2", "q2",
         "q8_spills_nonuniform_slabs", "hybrid light rows", "partition"]


def _entries(rows, cols, vals):
    """(row, col) sorted entries with their f32 values."""
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order].astype(np.float32)


@pytest.mark.parametrize("case", CASES)
def test_build_yields_the_csr_entries(case):
    m, d = _device(case)
    rm = fr.FusedRows.build(d)
    assert rm.n_rows == m.nr_rows and rm.n_cols == m.nr_cols
    assert rm.col.numel() % 4 == 0 and rm.val.numel() == rm.col.numel()
    n = rm.n_live
    got = _entries(np.repeat(np.arange(rm.n_rows),
                             rm.rowptr.diff().numpy()),
                   rm.col[:n].numpy().astype(np.int64), rm.val[:n].numpy())
    nz = m.values != 0
    want = _entries(np.repeat(np.arange(m.nr_rows), np.diff(m.row_ptr))[nz],
                    m.col_ind[nz].astype(np.int64), m.values[nz])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if case == "q8_spills_nonuniform_slabs":
        assert d.n_spills > 0 and not d.uniform_slabs


@pytest.mark.parametrize("case", CASES)
def test_reference_equals_the_tiles_plain_call(case):
    m, d = _device(case)
    rm = fr.FusedRows.build(d)
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(m.nr_cols),
                        dtype=torch.float32)
    y = fr.fused_rows_spmv_reference(x, rm)
    ref = d._rows(d.spmv_blocks_reference(x))
    atol = 1e-5 * max(1.0, float(ref.abs().max()))
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-5, atol=atol)
    before = fr.fused_rows_spmv.launches
    assert torch.equal(fr.fused_rows_spmv(x, rm), y)
    assert fr.fused_rows_spmv.launches == before


@pytest.mark.parametrize("case", ["q1_two_stage_sgrp2",
                                  "q8_spills_nonuniform_slabs"])
def test_build_in_chunks_equals_one_chunk(monkeypatch, case):
    """A chunk of one step at a time builds the same map, entry for entry
    and in the same order, as the whole pack in one chunk."""
    _, d = _device(case)
    monkeypatch.setattr(fr, "BUILD_SLOTS", 1 << 40)
    whole = fr.FusedRows.build(d)
    monkeypatch.setattr(fr, "BUILD_SLOTS", 1)
    assert d._dims["n_steps"] > 1
    steps = fr.FusedRows.build(d)
    for name in ("rowptr", "col", "val", "long_rows"):
        assert torch.equal(getattr(steps, name), getattr(whole, name))
    assert steps.n_live == whole.n_live


def test_launch_and_bytes_a_call_follow_the_pick():
    """``launch`` and ``bytes_a_call`` answer for the kernel the device
    runs: #1's blocks and the pack's bytes on ``"tiles"``, the rows
    kernel's y and the map's bytes on ``"rows"``."""
    m, d = _device("q2")
    x2 = d.prepare_x(torch.as_tensor(
        np.random.default_rng(4).standard_normal(m.nr_cols),
        dtype=torch.float32))
    assert d.bytes_a_call == d.meta.storage_bytes()
    assert torch.equal(d.launch(x2), d.blocks(x2))
    d.kernel, d.rows = "rows", fr.FusedRows.build(d)
    assert d.bytes_a_call == d.rows.nbytes
    assert torch.equal(d.launch(x2),
                       fr.fused_rows_spmv_reference(x2.view(-1), d.rows))


def test_rows_device_call_through_spmv():
    """A device set to ``"rows"`` answers ``spmv`` from the map, x
    unpadded or prepared, as #1's call does."""
    m, d = _device("q8_spills_nonuniform_slabs")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(m.nr_cols),
                        dtype=torch.float32)
    ref = d.spmv(x)
    d.kernel, d.rows = "rows", fr.FusedRows.build(d)
    for y in (d.spmv(x), d.spmv(d.prepare_x(x), x_is_packed=True)):
        assert y.shape == (m.nr_rows,)
        atol = 1e-5 * max(1.0, float(ref.abs().max()))
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=atol)


def _band8(n):
    """A banded matrix of 8 diagonals (offsets -3..4): each row one full
    chunk of 8, so the pack's tiles fill (fill 1.0 at n = 4096)."""
    rows = np.repeat(np.arange(n), 8)
    cols = rows + np.tile(np.arange(-3, 5), n)
    ok = (cols >= 0) & (cols < n)
    vals = np.random.default_rng(2).standard_normal(int(ok.sum()))
    return _host.CSRMatrix.from_coo(rows[ok], cols[ok],
                                    vals.astype(np.float32), n, n)


# matrix -> (traffic at the native engine's pack, the pick)
RULE = {
    "scattered random graph": (
        lambda: _host.random_csr(3000, 400_000, 1 / 400_000, seed=5),
        {"tiles": 565248, "rows": 140880}, "rows"),
    "banded": (lambda: _band8(4096), {"tiles": 270336, "rows": 1342848},
               "tiles"),
}


@pytest.mark.parametrize("case", list(RULE))
def test_byte_rule(case):
    make, pinned, pick = RULE[case]
    d = sf.FusedDevice.from_packed(_host.pack_fused(make()), "cpu")
    t = d.traffic()
    assert t == pinned
    assert sf.pick_kernel(t) == pick
    # on the CPU the device keeps #1's plain version
    assert d.kernel == "tiles" and d.rows is None


def test_cuda_tensor_without_the_library_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_LIBRARY", _build._Library())
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))

    def plain(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(fr, "fused_rows_spmv_reference", plain)
    _, d = _device("q2")
    rm = fr.FusedRows.build(d)
    x = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="nvcc"):
        fr.fused_rows_spmv(x, rm)
    with pytest.raises(ValueError, match="unsupported device"):
        fr.fused_rows_spmv(types.SimpleNamespace(
            device=torch.device("meta")), rm)


def test_map_checks_and_long_rows():
    rowptr = torch.tensor([0, 3, 3, 300], dtype=torch.int32)
    col = torch.arange(300, dtype=torch.int32) % 7
    val = torch.ones(300)
    rm = fr.FusedRows(rowptr, col, val, n_cols=7)
    assert rm.width == 32 and rm.max_len == 1024 and rm.long_rows.numel() \
        == 0
    assert rm.col.numel() == 300 and rm.nbytes == 8 * 300 + 16 + 12 + 28
    rm = fr.FusedRows(torch.tensor([0, 1, 2, 300], dtype=torch.int32),
                      col[:300], val, n_cols=7)
    assert rm.width == 32 and rm.long_rows.tolist() == []
    rm = fr.FusedRows(torch.tensor([0] * 40 + [298, 300],
                                   dtype=torch.int32), col[:300], val,
                      n_cols=7)
    assert rm.width == 4 and rm.long_rows.tolist() == [39]
    assert [fr.row_width(n) for n in (0, 16, 17, 32, 33, 64, 65, 500)] == \
        [4, 4, 8, 8, 16, 16, 32, 32]
    with pytest.raises(ValueError, match="past the matrix's columns"):
        fr.FusedRows(rowptr, col, val, n_cols=6)
    with pytest.raises(ValueError, match="rowptr"):
        fr.FusedRows(torch.tensor([0, 3, 2, 300], dtype=torch.int32), col,
                     val, n_cols=7)
    with pytest.raises(ValueError, match="rowptr"):
        fr.FusedRows(rowptr[:-1], col, val, n_cols=7)
    x = torch.ones(7, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        fr.fused_rows_spmv_reference(x, rm)
    with pytest.raises(ValueError, match="elements"):
        fr.fused_rows_spmv_reference(torch.ones(6), rm)


def _lane_walk(b, e, W, lane):
    """``row_part`` of ``csrc/fused_rows.cu`` for one lane: the entries it
    adds (quads lane, lane + W, ... of the row's aligned quads, two a loop,
    the entries outside [b, e) masked)."""
    got = []
    qe = (e + 3) >> 2 if e > b else 0
    q = (b >> 2) + lane
    while q < qe:
        for qq, ee in ((q, e), (q + W, e if q + W < qe else 0)):
            got += [k for k in range(4 * qq, 4 * qq + 4) if b <= k < ee]
        q += 2 * W
    return got


@pytest.mark.parametrize("W", fr.WIDTHS)
def test_kernel_lane_walk_reads_each_entry_once(W):
    rng = np.random.default_rng(W)
    for _ in range(200):
        b = int(rng.integers(0, 50))
        e = b + int(rng.integers(0, 4 * fr.QUADS_A_LANE * W + 1))
        got = sorted(k for lane in range(W) for k in _lane_walk(b, e, W,
                                                                lane))
        assert got == list(range(b, e))


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _close_to(y, ref):
    y, ref = y.cpu().numpy(), ref.cpu().numpy()
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


def _map(mean, n_rows=3000, n_cols=5000, heavy=3, seed=0):
    """A map of Poisson(mean) rows, a tenth of them empty and ``heavy``
    rows of 5 * max_len entries (the kernel's warp a long row)."""
    rng = np.random.default_rng(seed)
    lengths = rng.poisson(mean, n_rows)
    lengths[rng.random(n_rows) < 0.1] = 0
    w = fr.row_width(lengths.mean())
    lengths[rng.choice(n_rows, heavy, replace=False)] = \
        5 * 4 * fr.QUADS_A_LANE * w
    rowptr = np.concatenate([[0], np.cumsum(lengths)])
    n = int(rowptr[-1])
    return fr.FusedRows(torch.as_tensor(rowptr, dtype=torch.int32),
                        torch.as_tensor(rng.integers(0, n_cols, n),
                                        dtype=torch.int32),
                        torch.as_tensor(rng.standard_normal(n),
                                        dtype=torch.float32), n_cols)


@pytest.mark.gpu
@pytest.mark.parametrize("mean", [2, 20, 50, 200])
def test_kernel_matches_plain_on_card(cuda, mean):
    """Each width (4, 8, 16, 32 lanes a row), empty rows and the long
    rows' warps: one launch, every row of y written."""
    rm = _map(mean).to(cuda)
    assert rm.width == fr.row_width(mean) and rm.long_rows.numel() == 3
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(rm.n_cols),
                        dtype=torch.float32, device=cuda)
    before = fr.fused_rows_spmv.launches
    y = fr.fused_rows_spmv(x, rm)
    torch.cuda.synchronize()
    assert fr.fused_rows_spmv.launches == before + 1
    _close_to(y, fr.fused_rows_spmv_reference(x, rm))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(REGIMES))
def test_device_on_card_runs_its_pick(cuda, case):
    """The byte rule on the card; a ``"rows"`` device's map is the CPU
    build's, entry for entry, and ``spmv`` is one launch of the rows
    kernel, equal to #1's plain call."""
    m, d = _device(case)
    dc = sf.FusedDevice.from_packed(d.meta, cuda)
    assert dc.kernel == sf.pick_kernel(d.traffic())
    if dc.kernel == "tiles":
        assert dc.rows is None
        return
    rm = fr.FusedRows.build(d)
    for name in ("rowptr", "col", "val", "long_rows"):
        assert torch.equal(getattr(dc.rows, name).cpu(), getattr(rm, name))
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(m.nr_cols),
                        dtype=torch.float32, device=cuda)
    before = (fr.fused_rows_spmv.launches, sf.fused_spmv.launches)
    y = dc.spmv(x)
    torch.cuda.synchronize()
    assert (fr.fused_rows_spmv.launches, sf.fused_spmv.launches) == \
        (before[0] + 1, before[1])
    _close_to(y, dc._rows(dc.spmv_blocks_reference(x)))


@pytest.mark.gpu
def test_build_peak_on_card(cuda, monkeypatch):
    """The build holds, beside the pack, the map, 16 B a row and one
    chunk's temporaries: with chunks of a step, its peak past what the
    card held before stays within twice the map's bytes."""
    m = _host.random_csr(1 << 16, 1 << 16, 32 / (1 << 16), seed=7,
                         dtype=np.float32)
    d = sf.FusedDevice.from_packed(_host.pack_fused(m), cuda)
    monkeypatch.setattr(fr, "BUILD_SLOTS", 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    rm = fr.FusedRows.build(d)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - before
    assert rm.n_live == m.nr_nzeros
    assert peak <= 2 * rm.nbytes, (peak, rm.nbytes)
