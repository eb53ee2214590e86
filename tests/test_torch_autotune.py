"""sparsetpu_torch's ``autotune_pack`` and ``bench_spmv(autotune=True)``
against the JAX package's (``sparsetpu/api/autotune.py``,
``tests/test_misc.py``): the gold, the candidate set, the pick a timer
makes fastest, and the picked pack byte-identical to the JAX
``pack_gstream(m, G=g, Q=q)``.  On the CPU the timer is a stub: CPU times
of the plain versions are not the card's.
"""

import numpy as np
import pytest
import torch

import sparsetpu.pack.gather_stream as jax_gs
from sparsetpu.formats.csr import CSRMatrix as JaxCSRMatrix

import sparsetpu_torch as st
from sparsetpu_torch import _host
from sparsetpu_torch.bench.harness import bench_spmv
from sparsetpu_torch.kernels.spmv_gstream import GStreamDevice
from sparsetpu_torch.pack.rates import RATE_COMBOS


@pytest.fixture(scope="module")
def m():
    return _host.random_csr(500, 2000, density=0.02, seed=3,
                            dtype=np.float32)


def _gold_ok(m, x, y):
    assert _host.verification(_host.spmv_gold(m, x), np.asarray(y),
                              1e-3, 1e-3) == 0


def _stub(order, fast):
    """A timer that calls each candidate's SpMV once and makes ``fast``
    (its index in ``order``) the quickest."""
    it = iter(order)

    def timer(fn, dev):
        assert tuple(fn().shape) == (500,) and dev.type == "cpu"
        return 1.0 if next(it) == order[fast] else 2.0
    return timer


def test_single_candidate_meets_the_gold(m):
    """``tests/test_misc.py:8-14`` on the port: one bare G."""
    sm = st.autotune_pack(m, candidates=[4], device="cpu")
    x = np.random.default_rng(1).standard_normal(m.nr_cols)
    _gold_ok(m, x, sm.spmv(x).numpy())
    assert sm.packed.G == 4 and isinstance(sm.device_module, GStreamDevice)


def test_candidates_around_the_model_choice(m):
    cands, (g0, q0) = st.autotune_candidates(m)
    assert (g0, q0) == jax_gs._choose_layout(JaxCSRMatrix(
        m.row_ptr, m.col_ind, m.values, m.nr_rows, m.nr_cols))
    assert (g0, q0) in cands and cands == sorted(set(cands))
    assert {(max(1, g0 // 2), q0), (g0, min(8, q0 * 2))} <= set(cands)
    favour = {k: (1000.0 if k == (1, 4) else 10.0) for k in RATE_COMBOS}
    assert st.autotune_candidates(m, favour)[1] == (1, 4) != (g0, q0)


@pytest.mark.parametrize("fast", [0, 2, -1])
def test_stub_timer_picks_the_fastest(m, fast):
    cands, _ = st.autotune_candidates(m)
    sm = st.autotune_pack(m, device="cpu", timer=_stub(cands, fast))
    assert (sm.packed.G, sm.packed.Q) == cands[fast]


def test_the_pick_is_the_jax_pack(m):
    cands, _ = st.autotune_candidates(m)
    sm = st.autotune_pack(m, device="cpu", timer=_stub(cands, 1))
    g, q = cands[1]
    jp = jax_gs.pack_gstream(JaxCSRMatrix(m.row_ptr, m.col_ind, m.values,
                                          m.nr_rows, m.nr_cols), G=g, Q=q)
    p = sm.packed
    assert (p.G, p.Q, p.tiles_per_step) == (jp.G, jp.Q, jp.tiles_per_step)
    for k in ("values", "cell_idx", "route", "chunk_row", "step_window"):
        a, b = getattr(p, k), getattr(jp, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_cpu_without_a_timer_refuses_to_choose(m):
    with pytest.raises(ValueError, match="needs a timer"):
        st.autotune_pack(m, device="cpu")


def test_the_pick_is_a_whole_sparse_matrix(m):
    """The classic-device ``SparseMatrix`` the JAX function returns: x
    and X, the transpose from the kept source."""
    cands, _ = st.autotune_candidates(m)
    sm = st.autotune_pack(m, device="cpu", timer=_stub(cands, 0))
    assert sm.shape == (500, 2000) and sm.dtype == torch.float32
    assert sm.fused_device is None and sm.unpack() is m
    X = np.random.default_rng(2).standard_normal((m.nr_cols, 3))
    Y = (sm @ X).numpy()
    for j in range(3):
        _gold_ok(m, X[:, j], Y[:, j])
    xt = np.random.default_rng(3).standard_normal(m.nr_rows)
    _gold_ok(m.transpose(), xt, (sm.T @ xt).numpy())


def test_bench_spmv_autotune_reports_the_pick(m):
    cands, _ = st.autotune_candidates(m)
    r = bench_spmv(m, repeats=2, autotune=True, device="cpu",
                   timer=_stub(cands, -1))
    assert (r.layout_g, r.layout_q) == cands[-1]
    assert r.verify_errors == 0 and "Verification: PASS" in r.report()
    # f64 benchmarks the default device, as the JAX harness's condition
    r64 = bench_spmv(_host.random_csr(300, 900, density=0.02, seed=4),
                     repeats=2, autotune=True, device="cpu")
    assert r64.verify_errors == 0
