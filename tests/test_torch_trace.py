"""The port's own instrumentation on the CPU (``utils/timing.py``): the
``sparsetpu.*`` spans, opened only while a profiler runs and nested under
their call, and the ``SETUP`` phases of a matrix's build.  Each case runs
on the fused f32 route and on the classic f64 route, over a 2D Laplacian
(symmetric positive definite, for the solvers).  One case needs the card
(``python -m pytest tests/test_torch_trace.py -m gpu --noconftest``; it
skips without one): there the spans must add no CUDA-typed event to the
profiler's record, which ``record_function``'s user ranges do."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import sparsetpu_torch as st
from sparsetpu_torch import solvers
from sparsetpu_torch.formats.random import laplace_2d
from sparsetpu_torch.kernels.f64emu import DF64GStreamDevice
from sparsetpu_torch.kernels.spmv_fused import FusedDevice
from sparsetpu_torch.utils import timing

# route: (real type, config's block_cols, the device module it must pick)
ROUTES = {"fused_f32": (np.float32, None, FusedDevice),
          "classic_f64": (np.float64, 8192, DF64GStreamDevice)}


def _matrix(route, device="cpu"):
    dtype, block_cols, device_type = ROUTES[route]
    cfg = None if block_cols is None else st.SpmvConfig(
        dtype=dtype, block_cols=block_cols)
    sm = st.SparseMatrix(laplace_2d(20, dtype), cfg, device=device)
    assert type(sm.device_module) is device_type
    return sm


@pytest.fixture(scope="module", params=sorted(ROUTES))
def route(request):
    return request.param, _matrix(request.param)


def _x(sm, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(sm.nr_cols, generator=g, dtype=sm.dtype).to(sm.device)


def _spans(prof):
    """The profiler's ``sparsetpu.*`` events as (name, start, end)."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("sparsetpu.")]


def _inside(spans, outer):
    """The names of the spans that lie inside ``outer``."""
    return [s[0] for s in spans if s is not outer and outer[1] <= s[1]
            and s[2] <= outer[2]]


def _refuse(name):
    raise AssertionError(f"a range was opened with no profiler: {name}")


def test_no_profiler_opens_no_range(route, monkeypatch):
    _, sm = route
    x = _x(sm, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        y_traced = sm @ x
    monkeypatch.setattr(timing, "_emit", _refuse)
    y = sm @ x
    assert y.dtype == sm.dtype and torch.equal(y, y_traced)
    res = solvers.pcg_df64(sm.spmv, x.double(), lambda r: r, tol=0.0,
                           maxiter=2, device="cpu")
    assert res.iterations == 2


def test_spmv_spans_nest_under_each_call(route):
    _, sm = route
    x = _x(sm, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            sm @ x
    spans = _spans(prof)
    calls = [s for s in spans if s[0] == "sparsetpu.spmv"]
    assert len(calls) == 3
    for call in calls:
        inner = _inside(spans, call)
        assert inner.count("sparsetpu.device.spmv") == 1
        assert "sparsetpu.spmv" not in inner
        assert any(n.startswith("sparsetpu.launch.") for n in inner)
    # every span lies under a call
    assert len(spans) == sum(1 + len(_inside(spans, c)) for c in calls)


@pytest.mark.parametrize("solver", ["pcg", "cg"])
def test_solver_spans(route, solver):
    _, sm = route
    k = 4
    b = _x(sm, 2).double()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if solver == "pcg":
            res = solvers.pcg_df64(sm.spmv, b, lambda r: r, tol=0.0,
                                   maxiter=k, device="cpu")
        else:
            res = solvers.cg_df64(sm.spmv, b, tol=0.0, maxiter=k,
                                  device="cpu")
    assert res.iterations == k
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert names.count(f"sparsetpu.{solver}") == 1
    iters = [s for s in spans if s[0] == f"sparsetpu.{solver}.iter"]
    assert len(iters) == k
    for it in iters:
        inner = _inside(spans, it)
        assert inner.count(f"sparsetpu.{solver}.check") == 1
        assert inner.count("sparsetpu.spmv") == 1
    assert names.count(f"sparsetpu.{solver}.check") == k
    assert names.count("sparsetpu.spmv") == k + 1     # and r0 = b - A x0


def test_solver_that_converges_ends_on_its_check(route):
    _, sm = route
    b = _x(sm, 3).double()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = solvers.pcg_df64(sm.spmv, b, lambda r: r, tol=1e-3,
                               maxiter=500, device="cpu")
    assert 0 < res.iterations < 500
    names = [s[0] for s in _spans(prof)]
    assert names.count("sparsetpu.pcg.iter") == res.iterations + 1
    assert names.count("sparsetpu.pcg.check") == res.iterations + 1


def test_build_adds_to_setup_phases(route):
    name, _ = route
    before = dict(timing.SETUP.phases)
    _matrix(name)
    grew = {p for p, v in timing.SETUP.phases.items()
            if v > before.get(p, 0.0)}
    assert {"pack", "upload"} <= grew
    if name == "classic_f64":
        assert {"final_rows", "live_slots"} <= grew


def test_nested_phases_add_up_to_the_wall_time(monkeypatch):
    ticks = iter([0.0, 1.0, 2.0, 4.0, 5.0, 10.0])
    monkeypatch.setattr(timing, "get_timestamp", lambda: next(ticks))
    t = timing.PhaseTimer()
    with t.phase("a"):                  # 0 .. 10
        with t.phase("b"):              # 1 .. 5
            with t.phase("a"):          # 2 .. 4
                pass
    assert t.phases == {"a": 2.0 + 6.0, "b": 2.0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_spans_add_no_device_event_on_the_card(cuda, name):
    sm = _matrix(name, cuda)
    x = _x(sm, 4)
    sm @ x
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sm @ x
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    assert device and not [n for n in device if n.startswith("sparsetpu.")]
    spans = _spans(prof)
    (call,) = [s for s in spans if s[0] == "sparsetpu.spmv"]
    assert any(n.startswith("sparsetpu.launch.") for n in _inside(spans, call))
    assert any(e.name == "cudaLaunchKernel"
               and call[1] <= e.time_range.start <= call[2]
               for e in prof.events())
