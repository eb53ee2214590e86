"""The trace arithmetic and the per-layer readers on synthetic records
(the traces themselves come from the card)."""

import pytest
import torch

from spbench import harness, roofline
from spbench.timing import Event, Trace, busy_us, idle_gaps, top


def _trace():
    dev = [Event("k1", 10, 20), Event("k2", 15, 30), Event("k1", 50, 60),
           Event("memset", 80, 85)]
    host = [Event("spbench.block", 0, 100), Event("aten::item", 30, 49),
            Event("cudaLaunchKernel", 49, 50)]
    return Trace(dev, host, (5.0, 95.0), True)


def test_busy_union():
    tr = _trace()
    assert busy_us(tr.device, *tr.window_us) == 20 + 10 + 5
    assert busy_us(tr.device, 12, 55) == 18 + 5
    assert busy_us([], 0, 10) == 0.0


def test_idle_gaps_labelled():
    gaps = idle_gaps(_trace())
    assert [g[1] for g in gaps] == [5, 20, 20, 10]
    # the gap 30-50: the host was inside aten::item, after nothing ended
    assert gaps[1][0] == "host: aten::item after -"
    # the gap 60-80: inside the block, after the launch
    assert gaps[2][0] == "host: spbench.block after cudaLaunchKernel"
    # summed by label: 60-80 and 85-95 share one
    assert top(gaps, 2)[0] == ["host: spbench.block after cudaLaunchKernel",
                               pytest.approx(30e-6)]


def _run(**kw):
    r = harness.Run("c", {}, {}, 0, 1.0, True, torch.device("cpu"),
                    "NVIDIA H100 80GB HBM3")
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_readers():
    readers = harness.metric_readers()
    r = _run(nr_rows=1124864, nr_cols=1124864, nnz=29791000, value_bytes=8,
             held_ms=0.2268592740)
    bound_ms = roofline.csr_spmv_bytes(1124864, 1124864, 29791000,
                                       8) / 3350e9 * 1e3
    assert readers["spmv_roofline"].read(r) == pytest.approx(
        100 * bound_ms / 0.2268592740)
    assert readers["spmv_roofline"].read(_run()) is None
    r = _run(traces={"cg": _trace()}, spmv_kernels=frozenset({"k1"}),
             counts={"trace_iterations": 5})
    assert readers["idle_frac.cg"].read(r) == pytest.approx(1 - 35 / 90)
    assert readers["idle_frac.spmv"].read(r) is None
    assert readers["cg_vecops_ms_per_iter"].read(r) == pytest.approx(
        (15 + 5) / 5 * 1e-3)
    r = _run(spans={"spmv_call": [1e-5, 3e-5], "pack_upload": [2.5]},
             counts={"calls": 1000}, nnz=10 ** 6, window_s=2.0)
    assert readers["host_us_per_call"].read(r) == pytest.approx(20.0)
    assert readers["pack_upload_s"].read(r) == 2.5
    assert readers["spmv_gnnz_s"].read(r) == pytest.approx(0.5)
    r = _run(spans={"cg_set": [0.01] * 19 + [0.03]}, counts={"sets": 20},
             window_s=0.4)
    assert readers["cg_set_ms"].read(r) == pytest.approx(20.0)
    assert readers["cg_set_p95_ms"].read(r) == pytest.approx(11.0)
