"""The readers of the port's own spans and set-up phases on hand-built
traces: each gives its exact value on known spans, runtime calls and
device events, and None where the spans (or the phases) are missing, as
in a program that has none."""

import pytest
import torch

from spbench import harness
from spbench.timing import Event, Trace
from sparsetpu_torch.utils import timing as port_timing

READERS = harness.metric_readers()
SPMV = ("spmv_wrapper_us_per_call", "launches_per_call")
CG = ("cg_issue_us_per_iter", "cg_launches_per_iter", "idle_frac.cg.issue")
SETUP = ("pack_host_s", "upload_build_s")


def _run(**kw):
    r = harness.Run("c", {}, {}, 0, 1.0, True, torch.device("cpu"),
                    "NVIDIA H100 80GB HBM3")
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def _spmv_trace():
    """Two calls: the first 0-40 us with two launches (10-15 and a nested
    pair 20-30 over 22-28), the second 50-70 with one (55-65); runtime
    enqueues 3 in the first (one a versioned name), 1 in the second, and
    one outside both."""
    host = [Event("sparsetpu.spmv", 0, 40),
            Event("sparsetpu.device.spmv", 2, 38),
            Event("sparsetpu.launch.fused_spmv", 10, 15),
            Event("cudaLaunchKernel", 12, 13),
            Event("sparsetpu.launch.live_slot_sums", 20, 30),
            Event("sparsetpu.launch.final_rows", 22, 28),
            Event("cudaMemsetAsync", 23, 24),
            Event("cudaLaunchKernelExC_v11060", 25, 26),
            Event("aten::empty", 31, 32),
            Event("cudaLaunchKernel", 45, 46),
            Event("sparsetpu.spmv", 50, 70),
            Event("sparsetpu.launch.fused_spmv", 55, 65),
            Event("cudaLaunchKernel", 60, 61),
            Event("cudaStreamSynchronize", 66, 67)]
    dev = [Event("k", 14, 30), Event("k", 62, 80)]
    return Trace(dev, host, (0.0, 100.0), True)


def _cg_trace():
    """Window 0-100.  Two iterations: 10-50 with its check 40-50 and
    launches at 12, 20, 41 (the check's copy); 50-90 with its check 80-90
    and a launch at 55.  Device busy 15-25, 45-60, 85-88: the idle time
    while issuing is 10-15, 25-40 in the first, 60-80 in the second; the
    gap 40-45 and 88-90 lie under a check and do not count, the gap 0-10
    and 90-100 lie outside the iterations."""
    host = [Event("sparsetpu.pcg", 5, 95),
            Event("sparsetpu.pcg.iter", 10, 50),
            Event("cudaLaunchKernel", 12, 13),
            Event("sparsetpu.spmv", 18, 30),
            Event("cudaLaunchKernel", 20, 21),
            Event("sparsetpu.pcg.check", 40, 50),
            Event("cudaMemcpyAsync", 41, 49),
            Event("sparsetpu.pcg.iter", 50, 90),
            Event("cudaLaunchKernel", 55, 56),
            Event("sparsetpu.pcg.check", 80, 90),
            Event("cudaLaunchKernel", 92, 93)]
    dev = [Event("k", 15, 25), Event("dot", 45, 60), Event("copy", 85, 88)]
    return Trace(dev, host, (0.0, 100.0), True)


def test_spmv_readers():
    r = _run(traces={"spmv": _spmv_trace()})
    # (40 - 5 - 10) and (20 - 10) us outside the launches
    assert READERS["spmv_wrapper_us_per_call"].read(r) == pytest.approx(
        (25 + 10) / 2)
    assert READERS["launches_per_call"].read(r) == pytest.approx((3 + 1) / 2)


def test_cg_readers():
    r = _run(traces={"cg": _cg_trace()})
    assert READERS["cg_issue_us_per_iter"].read(r) == pytest.approx(
        (30 + 30) / 2)
    assert READERS["cg_launches_per_iter"].read(r) == pytest.approx(
        (3 + 1) / 2)
    assert READERS["idle_frac.cg.issue"].read(r) == pytest.approx(
        (5 + 15 + 20) / 100)


def test_idle_share_clips_to_the_window():
    tr = _cg_trace()._replace(window_us=(20.0, 70.0))
    # issue 20-40 and 50-70, busy 15-25 and 45-60: idle 25-40 and 60-70
    assert READERS["idle_frac.cg.issue"].read(
        _run(traces={"cg": tr})) == pytest.approx((15 + 10) / 50)


@pytest.mark.parametrize("name", SPMV + CG)
def test_span_readers_none_without_spans(name):
    key = "spmv" if name in SPMV else "cg"
    assert READERS[name].read(_run()) is None
    tr = _spmv_trace() if key == "spmv" else _cg_trace()
    bare = tr._replace(host=[e for e in tr.host
                             if not e.name.startswith("sparsetpu.")])
    assert READERS[name].read(_run(traces={key: bare})) is None
    other = "cg" if key == "spmv" else "spmv"
    assert READERS[name].read(_run(traces={other: tr})) is None


def test_setup_readers(monkeypatch):
    setup = port_timing.PhaseTimer()
    for phase, s in (("pack", 30.5), ("upload", 2.0), ("final_rows", 4.0),
                     ("live_slots", 1.5), ("csrc", 11.0)):
        setup.record(phase, s)
    monkeypatch.setattr(port_timing, "SETUP", setup)
    assert READERS["pack_host_s"].read(_run()) == 30.5
    assert READERS["upload_build_s"].read(_run()) == 2.0 + 4.0 + 1.5
    fused = port_timing.PhaseTimer()
    fused.record("pack", 40.0)
    fused.record("upload", 3.0)
    monkeypatch.setattr(port_timing, "SETUP", fused)
    assert READERS["upload_build_s"].read(_run()) == 3.0


@pytest.mark.parametrize("name", SETUP)
def test_setup_readers_none_without_phases(monkeypatch, name):
    monkeypatch.setattr(port_timing, "SETUP", port_timing.PhaseTimer())
    assert READERS[name].read(_run()) is None
    monkeypatch.delattr(port_timing, "SETUP")
    assert READERS[name].read(_run()) is None
