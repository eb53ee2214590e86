"""sparsetpu_torch's distributed SpMV (``sparsetpu_torch/dist/``) on gloo
ranks on the CPU, against the JAX package's on conftest's simulated
8-device mesh (``interpret="xla"``) and against the gold.

The ranks start once for the file (``ranks``, a module fixture: 4 gloo
processes, ``dist.launch.run_ranks``); they run every case, at P = 2 (a
group of ranks 0-1) and at P = 4, through the kernels' plain versions,
and hand back each band's streams and y.  The ranks import this module
to find their function, so it imports JAX and ``sparsetpu`` only inside
the tests.

What is held, on the matrices of ``tests/test_dist.py`` and
``test_multihost.py``: each rank's values, meta, chunk rows and windows
equal the JAX shard's, but for the JAX step padding (all-gather,
multi-host; the ring's per stage); y meets the JAX ``spmv`` at rtol 1e-5,
atol 1e-5 * max(1, max|y|) (the same sums in another order) and the gold
with 0 errors at ``default_tolerance``.
"""

import numpy as np
import pytest
import torch

from sparsetpu_torch import _host
from sparsetpu_torch.dist import (choose_schedule, make_mesh, run_ranks,
                                  ring_shard_spmv, shard_spmv,
                                  shard_spmv_auto, shard_spmv_multihost)
from sparsetpu_torch.dist.dryrun import dryrun_rank
from sparsetpu_torch.dist.ring import _balance_contiguous
from sparsetpu_torch.kernels.final_rows import (FinalRows,
                                                final_rows_reference)
from sparsetpu_torch.kernels.spmv_gstream import FinalDevice
from sparsetpu_torch.pack.final_levels import _FinalLevel

WORLD = 4
PS = (2, 4)


def _matrices():
    """name -> the matrix of a JAX dist test (its shape, density, seed)."""
    r = _host.random_csr
    return {
        "512x1024": r(512, 1024, density=0.02, seed=20),
        "1000x3000": r(1000, 3000, density=0.01, seed=20),
        "16x200": r(16, 200, density=0.2, seed=21),
        "1200x4000": r(1200, 4000, density=0.01, seed=22, dtype=np.float32),
        "600x2000": r(600, 2000, density=0.02, seed=23, dtype=np.float32),
        "laplace_24": _host.laplace_2d(24),
        "2500x3000": r(2500, 3000, density=0.004, seed=22, dtype=np.float32),
        # wide enough for the ring to pay at the H100's rates
        "1000x60000": r(1000, 60000, density=0.005, seed=7,
                        dtype=np.float32),
    }


ALLGATHER = ("512x1024", "1000x3000", "16x200", "600x2000", "laplace_24")
RING = ("1200x4000", "1000x60000")
AUTO = ("1200x4000", "1000x60000")
MULTIHOST = ("2500x3000", "1000x3000")


def _x(m):
    return np.random.default_rng(5).standard_normal(m.nr_cols)


def _streams(band):
    """A band's streams as the card holds them."""
    s = band.stream
    return {"values": s.values.numpy(), "meta": s.meta16.numpy(),
            "window": s.step_window.numpy(),
            "chunk_row": band.meta.chunk_row.reshape(-1).copy(),
            "band_rows": band.meta.nr_rows}


def _rank_cases(rank, world, device):
    """Every case on this rank: {(kind, name, P): what it gave}."""
    mats = _matrices()
    out = {"dryrun": dryrun_rank(rank, world, device)}
    for P in PS:
        group = make_mesh(P)
        if rank >= P:
            continue
        for name in ALLGATHER:
            sh = shard_spmv(mats[name], group, device=device)
            out["allgather", name, P] = dict(
                _streams(sh.band), y=sh.spmv(_x(mats[name])).numpy())
        for name in MULTIHOST:
            sh = shard_spmv_multihost(mats[name], group, device=device)
            out["multihost", name, P] = dict(
                _streams(sh.band), y=sh.spmv(_x(mats[name])).numpy())
        for name in RING:
            rs = ring_shard_spmv(mats[name], group, device=device)
            out["ring", name, P] = {
                "values": rs.values.numpy(), "meta": rs.meta16.numpy(),
                "window": rs.step_window.numpy(),
                "stage_steps": rs.stage_steps,
                "x_index": (None if rs.x_index is None
                            else rs.x_index.numpy()),
                "y": rs.spmv(_x(mats[name])).numpy()}
        for name in AUTO:
            sh = shard_spmv_auto(mats[name], group, device=device)
            out["auto", name, P] = {"kind": type(sh).__name__,
                                    "y": sh.spmv(_x(mats[name])).numpy()}
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_rank_cases, WORLD, "gloo", device="cpu", timeout=300)


@pytest.fixture(scope="module")
def mats():
    return _matrices()


def _agree(y, ref, rtol=1e-5):
    atol = rtol * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=rtol, atol=atol)


def _gold_ok(m, x, y):
    atol, rtol = _host.default_tolerance(
        np.float32, m.nr_nzeros / max(m.nr_rows, 1))
    assert _host.verification(_host.spmv_gold(m, x), y, diff_thres=atol,
                              rel_thres=rtol) == 0


def _jax_y(sh, x):
    return np.asarray(sh.spmv(x))


def _same_band(got, jax_sh, p):
    """A rank's band against the JAX shard p's stacked arrays, the JAX
    step padding cut off (its chunk rows' trap is rows_per_part)."""
    n = got["window"].shape[0]
    rows = got["values"].shape[0]
    np.testing.assert_array_equal(
        got["window"], np.asarray(jax_sh.step_window)[p][:n])
    np.testing.assert_array_equal(got["values"],
                                  np.asarray(jax_sh.values)[p][:rows])
    np.testing.assert_array_equal(got["meta"],
                                  np.asarray(jax_sh.meta16)[p][:rows])
    cr = got["chunk_row"].astype(np.int64)
    cr[cr == got["band_rows"]] = jax_sh.rows_per_part
    np.testing.assert_array_equal(
        cr, np.asarray(jax_sh.chunk_row)[p][:cr.size])


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("name", ALLGATHER)
def test_allgather_bands_equal_the_jax_shards_and_y_meets_jax_and_gold(
        ranks, mats, name, P):
    from sparsetpu.dist.spmv_dist import make_mesh as jax_mesh
    from sparsetpu.dist.spmv_dist import shard_spmv as jax_shard
    m, x = mats[name], _x(mats[name])
    jsh = jax_shard(m, jax_mesh(P), interpret="xla")
    yj = _jax_y(jsh, x)
    for p in range(P):
        got = ranks[p]["allgather", name, P]
        _same_band(got, jsh, p)
        _agree(got["y"], yj)
        np.testing.assert_array_equal(got["y"], ranks[0]["allgather", name,
                                                          P]["y"])
    _gold_ok(m, x, ranks[0]["allgather", name, P]["y"])


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("name", MULTIHOST)
def test_multihost_bands_equal_the_jax_shards_and_y_meets_jax_and_gold(
        ranks, mats, name, P):
    from sparsetpu.dist.multihost import shard_spmv_multihost as jax_mh
    from sparsetpu.dist.spmv_dist import make_mesh as jax_mesh
    m, x = mats[name], _x(mats[name])
    jsh = jax_mh(m, jax_mesh(P), interpret="xla")
    yj = _jax_y(jsh, x)
    for p in range(P):
        got = ranks[p]["multihost", name, P]
        _same_band(got, jsh, p)
        _agree(got["y"], yj)
    _gold_ok(m, x, ranks[0]["multihost", name, P]["y"])


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("name", RING)
def test_ring_stages_equal_the_jax_shards_and_y_meets_jax_and_gold(
        ranks, mats, name, P):
    """Each stage's steps equal the JAX shard's at that stage (the JAX
    stage padded to its max over shards), the segmented x's map equals
    the JAX one, and y meets the JAX ring's and the gold."""
    from sparsetpu.dist.ring import ring_shard_spmv as jax_ring
    from sparsetpu.dist.spmv_dist import make_mesh as jax_mesh
    m, x = mats[name], _x(mats[name])
    jrs = jax_ring(m, jax_mesh(P), interpret="xla")
    yj = _jax_y(jrs, x)
    rps = jrs.tiles_per_step * 8
    for p in range(P):
        got = ranks[p]["ring", name, P]
        own, jo, po = got["stage_steps"], 0, 0
        for t in range(P):
            assert own[t] <= jrs.stage_steps[t]
            np.testing.assert_array_equal(
                got["window"][po:po + own[t]],
                np.asarray(jrs.step_window)[p][jo:jo + own[t]])
            for key, jarr in (("values", jrs.values), ("meta", jrs.meta16)):
                np.testing.assert_array_equal(
                    got[key][po * rps:(po + own[t]) * rps],
                    np.asarray(jarr)[p][jo * rps:(jo + own[t]) * rps])
            jo, po = jo + jrs.stage_steps[t], po + own[t]
        if jrs.x_index is None:
            assert got["x_index"] is None
        else:
            np.testing.assert_array_equal(got["x_index"],
                                          np.asarray(jrs.x_index))
        _agree(got["y"], yj)
    _gold_ok(m, x, ranks[0]["ring", name, P]["y"])


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("name, kind", zip(AUTO, ("ShardedSpmv",
                                                   "RingShardedSpmv")))
def test_auto_follows_the_schedule_choice(ranks, mats, name, kind, P):
    m = mats[name]
    assert choose_schedule(m, P) == ("ring" if kind.startswith("Ring")
                                     else "allgather")
    got = ranks[0]["auto", name, P]
    assert got["kind"] == kind
    _gold_ok(m, _x(m), got["y"])


@pytest.mark.parametrize("n_dev", (2, 4, 8))
@pytest.mark.parametrize("name", ("1200x4000", "600x2000", "laplace_24",
                                  "2500x3000", "1000x60000", "2000x20000"))
def test_choose_schedule_matches_jax_at_its_rates(mats, name, n_dev):
    """At the JAX module's own rates (819 GB/s HBM, 45 GB/s a link) the
    port picks what the JAX package picks (both schedules occur)."""
    from sparsetpu.dist.spmv_dist import _ICI_GBPS
    from sparsetpu.dist.spmv_dist import choose_schedule as jax_choose
    m = (_host.random_csr(2000, 20000, density=0.0055, seed=7,
                          dtype=np.float32)
         if name == "2000x20000" else mats[name])
    want = jax_choose(m, n_dev)
    assert choose_schedule(m, n_dev, hbm_gbps=819.0,
                           link_gbps=_ICI_GBPS) == want
    assert choose_schedule(m, n_dev) in ("ring", "allgather")


@pytest.mark.parametrize("k", (1, 2, 3, 4, 8))
def test_balance_contiguous_matches_jax(k):
    from sparsetpu.dist.ring import _balance_contiguous as jax_balance
    rng = np.random.default_rng(k)
    for n in (0, 1, 5, 37):
        w = rng.integers(0, 50, n)
        np.testing.assert_array_equal(_balance_contiguous(w, k),
                                      jax_balance(w, k))


@pytest.mark.parametrize("name", ("1000x3000", "600x2000", "laplace_24"))
def test_band_map_agrees_with_the_legacy_level_map(mats, name):
    """A band's map from its chunk rows holds the entries of the map built
    from its legacy final level (``_FinalLevel.build``), row by row, and
    the two finals give the same y."""
    from sparsetpu_torch.dist.spmv_dist import _slice_rows
    m = mats[name]
    sub = _slice_rows(m, 0, m.nr_rows // 2)
    pk = _host.pack_gstream(sub, shuffle_lanes=True)
    cr = pk.chunk_row.reshape(-1).astype(np.int64)
    lvl = _FinalLevel.build(cr, pk.nr_rows)
    assert lvl is not None
    a = FinalDevice(lvl, pk.nr_rows, cr.size, "cpu").rows
    b = FinalRows.from_chunk_row(pk.chunk_row, pk.nr_rows, "cpu")
    assert torch.equal(a.rowptr, b.rowptr)
    rp = a.rowptr.numpy()
    ia, ib = a.idx.numpy(), b.idx.numpy()
    for r in range(pk.nr_rows):
        np.testing.assert_array_equal(np.sort(ia[rp[r]:rp[r + 1]]),
                                      ib[rp[r]:rp[r + 1]])
    vec = torch.from_numpy(
        np.random.default_rng(1).standard_normal(cr.size).astype(np.float32))
    _agree(final_rows_reference(vec, b).numpy(),
           final_rows_reference(vec, a).numpy())


def test_dryrun_multichip_on_four_ranks(ranks):
    """The dry run's body (``dryrun_rank``) on the file's four ranks: one
    CG step, a ring SpMV, a multi-host SpMV and an f64 CG solve, finite,
    every rank alike."""
    got = [r["dryrun"] for r in ranks]
    assert all(g == got[0] for g in got)
    assert np.isfinite(got[0]["cg_step_residual"])
    assert got[0]["cg_df64_residual"] < 1e-6


def test_scaling_report_refuses_multihost_and_verifies(capsys):
    from sparsetpu_torch.bench.scaling import scaling_report
    rep = scaling_report(rows_per_dev=1500, nnz_per_row=6, max_devices=2,
                         verbose=False, multihost=True, device="cpu")
    out = capsys.readouterr().out
    assert "--multihost: a single process" in out
    assert rep["backend"] == "cpu"
    assert [r["devices"] for r in rep["weak_scaling"]] == [1, 2]
    assert all(r["verify_errors"] == 0 for r in rep["weak_scaling"])
    assert rep["weak_scaling"][1]["ring_fill"] is not None


def _raise_on_rank_1(rank, world, device):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def test_a_rank_that_raises_fails_run_ranks_with_its_traceback():
    with pytest.raises(RuntimeError) as e:
        run_ranks(_raise_on_rank_1, 2, "gloo", device="cpu", timeout=120)
    msg = str(e.value)
    assert "rank 1 failed" in msg
    assert "ValueError: rank one fails on purpose" in msg
    assert "_raise_on_rank_1" in msg
