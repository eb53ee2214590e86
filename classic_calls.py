"""The routes' call times on the card, end to end, so that two trees of the
port can be compared on one card, in turns:

    python3 classic_calls.py [--label NAME]
    python3 classic_calls.py --device cpu --small

Builds ``chip_smoke.py``'s matrices from their seeds (the headline, the
roadNet-CA and webbase-1M stand-ins, FEM-3D Poisson 72^3, the SpGEMM cut of
roadNet-CA to 2M nnz), checks each y (each Y's first column) against the
gold, and times, as ms a call (the median of 20 calls after 5 warm-up
calls, CUDA events: ``bench/harness.py:call_ms``):

  headline          ``sm @ x`` at the headline, f32 (the fused device);
  headline_f64      ``sm @ x`` at the headline in f64 (the fused f64
                    device);
  headline_f64_k4   ``sm @ X`` there, k = 4 (one fused f64 SpMV a column);
  headline_k8       ``sm @ X`` at the headline, k = 8: the fused SpMM;
  headline_k8_loop  8 ``sm @ x`` calls (8 fused SpMVs) on its columns;
  headline_k72      ``sm @ X`` at the headline, k = 72: past the fused
                    SpMM's limit on an H100, the classic device's k-plane
                    forward and final;
  headline_k72_loop 72 ``sm @ x`` calls (72 fused SpMVs) on its columns;
  headline_k96, headline_k128 and their ``_loop``: the same at k = 96, 128
                    (the crossing of the classic route and k fused SpMVs);
  shuffled_k8       ``spmm_gstream`` on the headline's
                    ``pack_gstream(shuffle_lanes=True)`` (a legacy final),
                    k = 8;
  wide_x            ``sm @ x`` at the roadNet-CA stand-in (classic device);
  wide_x_k2         ``sm @ X`` there, k = 2;
  web_graph         ``sm @ x`` at the webbase-1M stand-in (the hybrid: the
                    heavy rows' legacy final);
  web_graph_k4      ``sm @ X`` there, k = 4 (the heavy rows' F levels);
  wide_x_f64        ``sm @ x`` at the roadNet-CA stand-in in f64;
  wide_x_f64_k8     ``sm @ X`` there, k = 8;
  bsr_spmv          ``BSRDevice.spmv`` at FEM-3D Poisson 72^3;
  pcg_iteration     ``pcg`` (Jacobi, tol 1e-5) on that operator: host clock
                    around a whole solve over its iterations, the median of
                    3 solves after one;
  spgemm_numeric    the numeric phase ``plan(b.values)`` of A @ A at the
                    roadNet-CA stand-in cut to 2M nnz;
  cg_df64_iteration ``cg_df64`` (tol 1e-10) on FEM-3D Poisson 72^3 in f64
                    through ``SparseMatrix``: host clock around a whole warm
                    solve over its iterations, the median of 3 solves after
                    one.

``back_to_back`` holds the headline calls' device time a call with the
calls back to back (``bench/harness.py:stream_ms``; for ``headline_k8``
and its loop too), and
``cg_df64_profile`` one warm iteration of that solve under the profiler
(10 iterations traced): device us an iteration by kernel name, launches an
iteration, and the host clock's us an iteration.

It calls only entry points the port has had since its SpGEMM slice, and
``chip_smoke.py``'s matrix builders and gold checks beside it, so the same
file runs in an older tree of the port, copied into its root.  Prints one
JSON line: ``label``, ``card`` (``nvidia-smi``'s name and power limit),
``ms``, ``back_to_back``, ``pcg_iterations``, ``cg_df64_iterations`` and
``cg_df64_profile``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np


def run(device: str, small: bool) -> dict:
    """Every call on ``device``; ``small`` cuts the matrices (a rehearsal
    of the control flow on the CPU, not a measurement)."""
    import torch

    import chip_smoke as cs

    import sparsetpu_torch as st
    from sparsetpu_torch import _host as h
    from sparsetpu_torch.bench.harness import call_ms, stream_ms
    from sparsetpu_torch.utils.device import require_device

    dev = require_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    ms, b2b, its = {}, {}, None

    def spmv(tag, m, dtype=np.float32, back_to_back=False):
        sm = st.SparseMatrix(m, device=dev)
        x = np.random.default_rng(0).standard_normal(m.nr_cols)
        xt = torch.as_tensor(x, dtype=getattr(torch, np.dtype(dtype).name),
                             device=dev)
        cs._gold_errors(h, m, x, (sm @ xt).cpu().numpy(), dtype)
        ms[tag] = call_ms(lambda: sm @ xt, dev, repeats=20)
        if back_to_back and dev.type == "cuda":
            b2b[tag] = stream_ms(lambda: sm @ xt, dev)
        return sm

    def spmm(tag, sm, m, k, dtype=np.float32, fn=None):
        """``sm @ X`` (or ``fn(X)``) at k columns; returns X."""
        fn = fn or (lambda X: sm @ X)
        X = cs._X(m.nr_cols, k, seed=k)
        Xt = torch.as_tensor(X, dtype=getattr(torch, np.dtype(dtype).name),
                             device=dev)
        G = h.spmv_gold(m, X[:, 0])
        Y = fn(Xt).cpu().numpy()
        tol = h.default_tolerance(dtype, m.nr_nzeros / m.nr_rows)
        if h.verification(G, Y[:, 0], *tol):
            raise RuntimeError(f"{tag}: Y's first column disagrees with "
                               "the gold")
        ms[tag] = call_ms(lambda: fn(Xt), dev, repeats=20)
        return Xt

    nr = 20_000 if small else 200_000
    m = h.random_csr(nr, 100_000, density=0.0005, seed=1, dtype=np.float64)
    sm = spmv("headline_f64", m, np.float64, back_to_back=True)
    spmm("headline_f64_k4", sm, m, 4, np.float64)
    del sm, m
    m = h.random_csr(nr, 100_000, density=0.0005, seed=1, dtype=np.float32)
    sm = spmv("headline", m, back_to_back=True)
    for k in (8, 72, 96, 128):
        Xt = spmm(f"headline_k{k}", sm, m, k)
        cols = [Xt[:, j].contiguous() for j in range(k)]
        ms[f"headline_k{k}_loop"] = call_ms(lambda: [sm @ c for c in cols],
                                            dev, repeats=10)
        if k == 8 and dev.type == "cuda":
            b2b["headline_k8"] = stream_ms(lambda: sm @ Xt, dev)
            b2b["headline_k8_loop"] = stream_ms(
                lambda: [sm @ c for c in cols], dev)
    del sm, Xt, cols
    shuf = st.GStreamDevice(h.pack_gstream(m, shuffle_lanes=True), device=dev)
    spmm("shuffled_k8", None, m, 8, fn=lambda X: st.spmm_gstream(shuf, X))
    del shuf, m

    road = 20_000 if small else 5_533_214
    m = cs.road_net_ca(h, nnz=road)
    sm = spmv("wide_x", m)
    spmm("wide_x_k2", sm, m, 2)
    del sm, m
    m = (cs.webbase_1m(h, nr=100_000, nnz=310_000) if small
         else cs.webbase_1m(h))
    sm = spmv("web_graph", m)
    spmm("web_graph_k4", sm, m, 4)
    del sm, m
    m = cs.road_net_ca(h, nnz=road, dtype=np.float64)
    sm = spmv("wide_x_f64", m, np.float64)
    spmm("wide_x_f64_k8", sm, m, 8, np.float64)
    del sm, m

    n = 16 if small else 72
    m = h.fem_poisson_3d(n, np.float32)
    d = st.BSRDevice(h.csr_to_bsr(m), device=dev)
    xt = torch.as_tensor(np.random.default_rng(0).standard_normal(
        m.nr_cols), dtype=torch.float32, device=dev)
    cs._gold_errors(h, m, xt.cpu().numpy().astype(np.float64),
                    d.spmv(xt).cpu().numpy())
    ms["bsr_spmv"] = call_ms(lambda: d.spmv(xt), dev, repeats=20)
    rhs = torch.ones(m.nr_rows, device=dev)
    m_inv = st.jacobi_preconditioner(m, device=dev)
    per_it = []
    for i in range(4):
        sync()
        t0 = time.perf_counter()
        res = st.pcg(d.spmv, rhs, m_inv, tol=1e-5, maxiter=2000)
        sync()
        if i:
            per_it.append((time.perf_counter() - t0) * 1e3
                          / max(res.iterations, 1))
        its = res.iterations
    ms["pcg_iteration"] = statistics.median(per_it)
    del d, m

    m = cs.road_net_ca(h, nnz=20_000 if small else 2_000_000)
    plan = st.SpGEMMPlan(m, m, device=dev)
    bv = torch.as_tensor(m.values, device=dev)
    cs._spgemm_gold(h, m, m, plan.to_csr(plan(bv)), "spgemm")
    ms["spgemm_numeric"] = call_ms(lambda: plan(bv), dev, repeats=20)
    del plan, bv, m

    m = h.fem_poisson_3d(n)
    sm = st.SparseMatrix(m, device=dev)
    rhs = torch.ones(m.nr_rows, dtype=torch.float64, device=dev)
    per_it, cg_its = [], None
    for i in range(4):
        sync()
        t0 = time.perf_counter()
        res = st.cg_df64(sm.spmv, rhs, tol=1e-10, maxiter=3000, device=dev)
        sync()
        if i:
            per_it.append((time.perf_counter() - t0) * 1e3
                          / max(res.iterations, 1))
        cg_its = res.iterations
    rel = float(np.linalg.norm(1.0 - h.spmv_gold(m, res.x.cpu().numpy()))
                / np.sqrt(m.nr_rows))
    if not rel <= 1e-9:
        raise RuntimeError(f"cg_df64: ||b - A x|| / ||b|| {rel:.3e}")
    ms["cg_df64_iteration"] = statistics.median(per_it)
    profile = cg_profile(lambda k: st.cg_df64(sm.spmv, rhs, tol=0.0,
                                              maxiter=k, device=dev), dev)
    return {"ms": ms, "back_to_back": b2b, "pcg_iterations": its,
            "cg_df64_iterations": cg_its, "cg_df64_profile": profile}


def cg_profile(solve, dev, iters: int = 10) -> dict:
    """One warm iteration of ``solve(k)`` (a solve of k iterations) under
    the profiler: ``iters`` iterations traced beside a solve of none, the
    difference an iteration.  Device us by kernel name, launches and the
    host clock's us, each an iteration; empty on the CPU."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        return {}
    out = {}
    for k in (0, iters):
        solve(k)
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve(k)
            torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1e6
        kern = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us, n = kern.get(e.name[:60], (0.0, 0))
                kern[e.name[:60]] = (us + e.time_range.elapsed_us(), n + 1)
        out[k] = (wall, kern)
    (w0, k0), (w1, k1) = out[0], out[iters]
    by_kernel = {name: ((us - k0.get(name, (0.0, 0))[0]) / iters,
                        (n - k0.get(name, (0.0, 0))[1]) / iters)
                 for name, (us, n) in k1.items()}
    return {"host_us": (w1 - w0) / iters,
            "device_us": sum(us for us, _ in by_kernel.values()),
            "launches": sum(n for _, n in by_kernel.values()),
            "by_kernel": {k: [round(us, 3), n] for k, (us, n) in sorted(
                by_kernel.items(), key=lambda kv: -kv[1][0])[:8]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--label", default="")
    a = ap.parse_args(argv)
    if a.small and a.device != "cpu":
        ap.error("--small is a CPU rehearsal")
    card = "cpu"
    if a.device != "cpu":
        from sparsetpu_torch.utils.device import card_line
        card = card_line()
    t0 = time.perf_counter()
    out = run(a.device, a.small)
    print(json.dumps({"label": a.label, "card": card, **out,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
