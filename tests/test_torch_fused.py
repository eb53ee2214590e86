"""sparsetpu_torch fused SpMV against the JAX FusedDevice and the gold.

One pack per case, made by ``sparsetpu.pack.fused.pack_fused`` from numpy
seeds, goes to both ``sparsetpu.kernels.spmv_fused.FusedDevice`` (Pallas
interpret mode) and ``sparsetpu_torch``'s ``FusedDevice`` (on the CPU: the
kernel's plain PyTorch version).  Tolerances: port vs JAX rtol 1e-5, atol
1e-5 * max(1, max|y|) (the same f32 terms summed in another order); port vs
gold ``default_tolerance(float32, nnz/row)``.  Interpret runs are slow, so
only the regime cases go through JAX; the rest hold the port to the gold.

The host layer comes from ``sparsetpu_torch._host`` (the same code as
``sparsetpu.formats``/``pack``) and the JAX package is imported inside the
tests that run it, so the ``gpu`` tests here also run on a machine without
JAX: ``python -m pytest tests/test_torch_fused.py -m gpu --noconftest``.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import sparsetpu_torch as st
from sparsetpu_torch._host import (CSRMatrix, default_tolerance, pack_fused,
                                   random_csr, spmv_gold, verification)
from sparsetpu_torch.kernels.spmv_fused import (FusedDevice, fused_spmv,
                                                fused_spmv_reference,
                                                slabs_uniform)


def _empty_trailing_slabs():
    """After test_empty_trailing_slabs_get_zeroing_step: nnz in the first
    1000 of 35000 rows, so trailing slabs own only a zeroing step."""
    rng = np.random.default_rng(3)
    nr, nc = 35_000, 4000
    rows = np.repeat(np.arange(1000), 5)
    cols = rng.integers(0, nc, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    order = np.lexsort((cols, rows))
    ptr = np.zeros(nr + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    return CSRMatrix(np.cumsum(ptr), cols[order], vals[order], nr, nc)


# (matrix, pack kwargs, regime the pack must hit)
REGIMES = {
    # after test_scatter_multiplicity_one_direct
    "q1_fin_direct": (
        lambda: random_csr(5000, 20_000, 1.05 / 20_000, seed=6),
        dict(Q=1, sgrp=1), lambda p: p.Q == 1 and p.fin_direct == 1),
    # after test_sgrp_grouped_steps_bitwise
    "q1_two_stage_sgrp2": (
        lambda: random_csr(1000, 4000, 5.6 / 4000, seed=3),
        dict(Q=1, sgrp=2),
        lambda p: p.Q == 1 and p.SGRP == 2 and p.fin_direct == 0),
    # after test_fused_forced_q_fuzz
    "q2": (lambda: random_csr(3000, 20_000, 3 / 20_000, seed=1),
           dict(Q=2), lambda p: p.Q == 2),
    "q4": (lambda: random_csr(800, 5000, density=0.01, seed=7),
           dict(Q=4, sgrp=1), lambda p: p.Q == 4),
    # after test_fused_no_native_spills: the NumPy engine spills, and its
    # slab bounds are not OBp*128 multiples (per-slab reassembly)
    "q8_spills_nonuniform_slabs": (
        lambda: random_csr(1000, 8000, density=0.004, seed=1),
        dict(use_native=False),
        lambda p: p.Q == 8 and p.spill_row.size > 0
        and not slabs_uniform(p)),
    # after test_empty_trailing_slabs_get_zeroing_step
    "empty_trailing_slabs": (
        _empty_trailing_slabs, dict(sgrp=1), lambda p: p.n_slabs >= 2),
}


def native_engines(timeout: float = 300.0) -> None:
    """Hold both packages to their native (C++) pack engines before a test
    compares a pack or a final level built by the JAX package with the
    port's, or a regime the native engine packs.

    Each package builds its library at first use.  The JAX package's
    ``make`` links ``sparsetpu/native/libsparsetpu_native.so`` in place,
    and its ``native.packer.available()`` turns any error into False.  A
    test process that loads the file while another process's link is still
    writing it (an empty file: ``ctypes.CDLL`` raises "file too short")
    would pack with the NumPy engine, another layout.  So wait until both
    ``available()`` are True in this process (a library once loaded stays
    loaded), retrying up to ``timeout`` seconds, and fail naming the
    engine that never loaded: two engines are never compared."""
    import sparsetpu.native.packer as jax_packer
    from sparsetpu_torch.native import packer as port_packer
    deadline = time.monotonic() + timeout
    while True:
        down = [name for name, mod in (
            ("sparsetpu (JAX package) native packer", jax_packer),
            ("sparsetpu_torch native packer", port_packer))
            if not mod.available()]
        if not down:
            return
        if time.monotonic() > deadline:
            pytest.fail(f"{' and '.join(down)} not loadable after "
                        f"{timeout:.0f} s: a comparison with it would hold "
                        f"the NumPy engine's packs to the native engine's")
        time.sleep(0.2)


@pytest.fixture(autouse=True)
def native_engines_first(request):
    """``native_engines`` before every test here that is not marked
    ``gpu`` (those also run where JAX is absent), and in every test file
    that imports this fixture: the files that compare packs, finals or
    routes with the JAX package's."""
    if request.node.get_closest_marker("gpu") is None:
        native_engines()


def _pack(case, pack=pack_fused):
    make, kw, regime = REGIMES[case]
    m = make()
    p = pack(m, **kw)
    assert p is not None and regime(p), case
    return m, p


def _close_to(y, ref):
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


def _gold_ok(m, x, y):
    tol = default_tolerance(np.float32, m.nr_nzeros / max(m.nr_rows, 1))
    assert verification(spmv_gold(m, x), y, *tol) == 0


@pytest.mark.parametrize("case", list(REGIMES))
def test_port_matches_jax_interpret(case):
    from sparsetpu.kernels.spmv_fused import FusedDevice as JaxFusedDevice
    from sparsetpu.pack.fused import pack_fused as jax_pack_fused
    m, p = _pack(case, jax_pack_fused)
    x = np.random.default_rng(9).standard_normal(m.nr_cols)
    y_jax = np.asarray(JaxFusedDevice(p, interpret=True).spmv(x))
    y = FusedDevice.from_packed(p, "cpu").spmv(x).numpy()
    assert y.shape == (m.nr_rows,) and y.dtype == np.float32
    _close_to(y, y_jax)
    _gold_ok(m, x, y)


@pytest.mark.parametrize("q", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_port_forced_q_fuzz_matches_gold(q, seed):
    """test_fused_forced_q_fuzz's random scattered shapes (plus Q=8)."""
    rng = np.random.default_rng(800 + seed)
    r = int(rng.integers(500, 6000))
    c = int(rng.integers(5000, 150000))
    per_row = float(rng.uniform(1.0, 9.0))
    m = random_csr(r, c, density=per_row / c, seed=seed,
                   empty_row_frac=float(rng.uniform(0, 0.3)))
    p = pack_fused(m, Q=q)
    assert p is not None and p.Q == q
    x = rng.standard_normal(c)
    _gold_ok(m, x, FusedDevice.from_packed(p, "cpu").spmv(x).numpy())


def test_port_sgrp_grouping_is_bitwise_neutral():
    """SGRP only pads slabs with drained steps: y is bitwise the same."""
    m = random_csr(3000, 12_000, density=5.6 / 12_000, seed=3)
    x = np.random.default_rng(5).standard_normal(m.nr_cols)
    ys = []
    for s in (1, 2, 4):
        p = pack_fused(m, Q=1, sgrp=s)
        assert p.SGRP == s and p.n_steps % s == 0
        ys.append(FusedDevice.from_packed(p, "cpu").spmv(x).numpy())
    assert np.array_equal(ys[0], ys[1]) and np.array_equal(ys[0], ys[2])


def test_port_empty_slabs_read_exact_zero():
    m, p = _pack("empty_trailing_slabs")
    y = FusedDevice.from_packed(p, "cpu").spmv(np.ones(m.nr_cols)).numpy()
    assert np.all(y[1000:] == 0.0)
    assert np.any(y[:1000] != 0.0)


def test_port_spill_fixup_is_applied():
    m, p = _pack("q8_spills_nonuniform_slabs")
    x = np.random.default_rng(2).standard_normal(m.nr_cols)
    d = FusedDevice.from_packed(p, "cpu")
    _gold_ok(m, x, d.spmv(x).numpy())
    no_spill = dataclasses.replace(p, spill_row=p.spill_row[:0],
                                   spill_col=p.spill_col[:0],
                                   spill_val=p.spill_val[:0])
    y = FusedDevice.from_packed(no_spill, "cpu").spmv(x).numpy()
    assert np.abs(y - spmv_gold(m, x)).max() > 1e-3


@pytest.mark.parametrize("kw", [dict(), dict(use_native=False),
                                dict(Q=1, sgrp=2)])
def test_slabs_uniform_agrees_with_jax(kw):
    from sparsetpu.kernels.spmv_fused import _slabs_uniform
    m = random_csr(3000, 12_000, density=0.003, seed=8)
    p = pack_fused(m, **kw)
    assert slabs_uniform(p) == _slabs_uniform(p)


def test_prepare_x_layout():
    m = random_csr(400, 2500, density=0.01, seed=1)
    p = pack_fused(m)
    d = FusedDevice.from_packed(p, "cpu")
    x = np.arange(m.nr_cols, dtype=np.float32)
    x2 = d.prepare_x(x)
    assert tuple(x2.shape) == (p.GX * 8, 128) and x2.dtype == torch.float32
    assert np.array_equal(x2.reshape(-1)[:m.nr_cols].numpy(), x)
    assert not x2.reshape(-1)[m.nr_cols:].any()
    with pytest.raises(ValueError):
        d.prepare_x(x[:-1])


def test_pack_out_of_range_is_rejected():
    m = random_csr(400, 2500, density=0.01, seed=1)
    p = pack_fused(m)
    bad = dataclasses.replace(p, tile_base=p.tile_base + p.GX)
    with pytest.raises(ValueError, match="tile_base"):
        FusedDevice.from_packed(bad, "cpu")
    bad = dataclasses.replace(p, fin2_group=p.fin2_group + p.OBp)
    with pytest.raises(ValueError, match="fin2_group"):
        FusedDevice.from_packed(bad, "cpu")


def test_wrapper_rejects_wrong_dtype_and_shape():
    m = random_csr(400, 2500, density=0.01, seed=1)
    d = FusedDevice.from_packed(pack_fused(m), "cpu")
    x2 = d.prepare_x(np.ones(m.nr_cols))
    with pytest.raises(ValueError, match="x2"):
        d.blocks(x2.double())
    d.meta_rt = d.meta_rt[:-8]
    with pytest.raises(ValueError, match="meta_rt"):
        d.blocks(x2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(REGIMES))
def test_kernel_matches_plain_on_card(cuda, case):
    m, p = _pack(case)
    d = FusedDevice.from_packed(p, cuda)
    x2 = d.prepare_x(np.random.default_rng(9).standard_normal(m.nr_cols))
    before = fused_spmv.launches
    yk = d.blocks(x2)
    torch.cuda.synchronize()
    assert fused_spmv.launches == before + 1
    yr = d.blocks(x2, kernel=fused_spmv_reference)
    _close_to(yk.cpu().numpy(), yr.cpu().numpy())


@pytest.mark.gpu
def test_sparse_matrix_on_card_matches_gold(cuda):
    m = random_csr(4000, 20_000, density=0.002, seed=1, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    before = fused_spmv.launches
    y = st.SparseMatrix(m, device=cuda) @ x
    assert y.device.type == "cuda" and y.shape == (m.nr_rows,)
    assert fused_spmv.launches == before + 1
    _gold_ok(m, x, y.cpu().numpy())


# ring edges: one tile a step (T = 1, P = 8: seven of a block's eight
# groups have no forward tile and start on the finish streams), fewer
# tiles a step than a block has groups (T = 2, 4), one tile a group, fewer
# than the f32 ring of 2 (T = 8 at P = 1), two a group (T = 16)
RING_EDGES = {
    "T1_two_stage": (lambda: random_csr(2000, 2000, 0.001, seed=1),
                     dict(T=1, Q=1), lambda p: p.T == 1 and not p.fin_direct),
    "T1_fin_direct": (lambda: random_csr(5000, 20_000, 1.05 / 20_000, seed=6),
                      dict(T=1, Q=1), lambda p: p.T == 1 and p.fin_direct),
    "T2_two_stage": (lambda: random_csr(3000, 20_000, 3 / 20_000, seed=1),
                     dict(T=2, Q=1), lambda p: p.T == 2 and not p.fin_direct),
    "T4_fin_direct": (lambda: random_csr(3000, 20_000, 3 / 20_000, seed=1),
                      dict(T=4, Q=4), lambda p: p.T == 4 and p.fin_direct),
    "T8": (lambda: random_csr(2000, 5000, 0.002, seed=2),
           dict(T=8, Q=8), lambda p: p.T == 8),
    "T16": (lambda: random_csr(3000, 20_000, 3 / 20_000, seed=1),
            dict(T=16, Q=8), lambda p: p.T == 16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(REGIMES) + list(RING_EDGES))
def test_device_call_matches_plain_on_card(cuda, case):
    """The device's one launch (live counts, spills, unpadded x) against
    its plain version; one launch a call."""
    make, kw, regime = {**REGIMES, **RING_EDGES}[case]
    m = make()
    p = pack_fused(m, **kw)
    assert p is not None and regime(p), case
    d = FusedDevice.from_packed(p, cuda)
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(m.nr_cols),
                        dtype=torch.float32, device=cuda)
    ref = d.spmv_blocks_reference(x)
    before = fused_spmv.launches
    yk = d.spmv_blocks(x)
    torch.cuda.synchronize()
    assert fused_spmv.launches == before + 1
    _close_to(yk.cpu().numpy(), ref.cpu().numpy())
    _gold_ok(m, x.cpu().numpy(), d.spmv(x).cpu().numpy())


def _kernels_a_call(fn):
    """(kernel launches, memsets) in one call of ``fn``, from a profiler
    trace of that call alone: its record of the runtime API calls on the
    host (``cudaLaunchKernel``, ``cudaMemsetAsync``).  The card's own
    record drops events near a trace's start, and a one-call trace can
    hold none of them; the host's record stays whole (``chip_smoke.py:
    traced`` counts from it too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    api = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    return (sum("LaunchKernel" in a for a in api),
            sum("Memset" in a for a in api))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_one_launch_a_call_on_card(cuda, dtype):
    """``sm @ x`` on a fused matrix: one kernel and one memset."""
    m = random_csr(4000, 20_000, density=0.002, seed=1, dtype=dtype)
    sm = st.SparseMatrix(m, device=cuda)
    assert sm.fused_device is not None
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(m.nr_cols),
                        dtype=getattr(torch, np.dtype(dtype).name),
                        device=cuda)
    assert _kernels_a_call(lambda: sm @ x) == (1, 1)
