"""sparsetpu_torch's distributed f64 SpMV (``dist/df64.py``) on gloo ranks
on the CPU, against the JAX package's df64 mesh SpMV on conftest's
simulated 8-device mesh (``interpret="xla"``) and against the gold.

The ranks start once for the file (``ranks``: 4 gloo processes); they
run every case at P = 2 and P = 4 through the kernels' plain versions
(the live-slot forward and the f64 row-sorted final, native FP64), and a
CG solve in f64 over the sharded SpMV.  JAX and ``sparsetpu`` are imported
inside the tests only (the ranks import this module).

What is held, on the matrices of ``tests/test_dist_df64.py``: each rank's
hi + lo value plane, meta, chunk rows and windows equal the JAX shard's,
but for its step padding; y is within 1e-10 * max(1, max|y|) of the gold
and of the JAX df64 y joined; ``cg_df64`` over the shards solves the
Laplace system to a relative residual under 1e-10, as the JAX test does.
"""

import numpy as np
import pytest
import torch

from sparsetpu_torch import _host
from sparsetpu_torch.dist import make_mesh, run_ranks, shard_spmv_df64
from sparsetpu_torch.kernels.f64emu import join_f64
from sparsetpu_torch.solvers.cg import cg_df64

WORLD = 4
PS = (2, 4)
F64_REL = 1e-10


def _matrices():
    return {"600x800": _host.random_csr(600, 800, density=0.02, seed=11,
                                        dtype=np.float64),
            "laplace_24": _host.laplace_2d(24)}


def _x(m):
    return np.random.default_rng(5).standard_normal(m.nr_cols)


def _rank_cases(rank, world, device):
    mats = _matrices()
    out = {}
    for P in PS:
        group = make_mesh(P)
        if rank >= P:
            continue
        for name, m in mats.items():
            sh = shard_spmv_df64(m, group, device=device)
            s = sh.band.stream
            out[name, P] = {
                "values": s.values.numpy(), "meta": s.meta16.numpy(),
                "window": s.step_window.numpy(),
                "chunk_row": sh.band.meta.chunk_row.reshape(-1).copy(),
                "band_rows": sh.band.meta.nr_rows,
                "y": sh.spmv(_x(m)).numpy()}
        lap = mats["laplace_24"]
        sh = shard_spmv_df64(lap, group, device=device)
        res = cg_df64(sh.spmv, torch.ones(lap.nr_rows, dtype=torch.float64),
                      tol=1e-12, maxiter=600, device=device)
        out["cg", P] = res.x.numpy()
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_rank_cases, WORLD, "gloo", device="cpu", timeout=300)


@pytest.fixture(scope="module")
def mats():
    return _matrices()


def _near(y, ref):
    err = float(np.abs(y - ref).max())
    assert err <= F64_REL * max(1.0, float(np.abs(y).max())), err


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("name", ("600x800", "laplace_24"))
def test_df64_bands_equal_the_jax_shards_and_y_meets_gold_and_jax(
        ranks, mats, name, P):
    from sparsetpu.dist.df64 import shard_spmv_df64 as jax_df64
    from sparsetpu.dist.spmv_dist import make_mesh as jax_mesh
    from sparsetpu.kernels.f64emu import join_f64 as jax_join
    m, x = mats[name], _x(mats[name])
    jsh = jax_df64(m, jax_mesh(P), interpret="xla")
    yd = jsh.spmv(x)
    yj = jax_join(np.asarray(yd.hi), np.asarray(yd.lo))
    gold = _host.spmv_gold(m, x)
    for p in range(P):
        got = ranks[p][name, P]
        n, rows = got["window"].shape[0], got["values"].shape[0]
        np.testing.assert_array_equal(
            got["window"], np.asarray(jsh.step_window)[p][:n])
        np.testing.assert_array_equal(
            got["values"], join_f64(np.asarray(jsh.vhi)[p][:rows],
                                    np.asarray(jsh.vlo)[p][:rows]))
        np.testing.assert_array_equal(got["meta"],
                                      np.asarray(jsh.meta16)[p][:rows])
        # the JAX shard keeps its chunk rows sorted, with the order
        cr_j = np.empty(jsh.cr_rows.shape[1], np.int64)
        cr_j[np.asarray(jsh.cr_order)[p]] = np.asarray(jsh.cr_rows)[p]
        cr = got["chunk_row"].astype(np.int64)
        cr[cr == got["band_rows"]] = jsh.rows_per_part
        np.testing.assert_array_equal(cr, cr_j[:cr.size])
        assert got["y"].dtype == np.float64
        _near(got["y"], gold)
        _near(got["y"], yj)


@pytest.mark.parametrize("P", PS)
def test_cg_df64_over_the_shards_solves_laplace(ranks, mats, P):
    m = mats["laplace_24"]
    b = np.ones(m.nr_rows)
    x = ranks[0]["cg", P]
    rel = np.linalg.norm(b - _host.spmv_gold(m, x)) / np.linalg.norm(b)
    assert rel < 1e-10, rel
    for p in range(1, P):
        np.testing.assert_array_equal(ranks[p]["cg", P], x)
