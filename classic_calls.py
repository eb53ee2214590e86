"""The classic routes' call times on the card, end to end, so that two trees
of the port can be compared on one card, in turns:

    python3 classic_calls.py [--label NAME]
    python3 classic_calls.py --device cpu --small

Builds ``chip_smoke.py``'s matrices from their seeds (the headline, the
roadNet-CA and webbase-1M stand-ins, FEM-3D Poisson 72^3, the SpGEMM cut of
roadNet-CA to 2M nnz), checks each y (each Y's first column) against the
gold, and times, as ms a call (the median of 20 calls after 5 warm-up
calls, CUDA events: ``bench/harness.py:call_ms``):

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
                    roadNet-CA stand-in cut to 2M nnz.

It calls only entry points the port has had since its SpGEMM slice, and
``chip_smoke.py``'s matrix builders and gold checks beside it, so the same
file runs in an older tree of the port, copied into its root.  Prints one
JSON line: ``label``, ``card`` (``nvidia-smi``'s name and power limit),
``ms`` and ``pcg_iterations``.
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
    from sparsetpu_torch.bench.harness import call_ms
    from sparsetpu_torch.utils.device import require_device

    dev = require_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    ms, its = {}, None

    def spmv(tag, m, dtype=np.float32):
        sm = st.SparseMatrix(m, device=dev)
        x = np.random.default_rng(0).standard_normal(m.nr_cols)
        xt = torch.as_tensor(x, dtype=getattr(torch, np.dtype(dtype).name),
                             device=dev)
        cs._gold_errors(h, m, x, (sm @ xt).cpu().numpy(), dtype)
        ms[tag] = call_ms(lambda: sm @ xt, dev, repeats=20)
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

    m = h.random_csr(20_000 if small else 200_000, 100_000, density=0.0005,
                     seed=1, dtype=np.float32)
    sm = st.SparseMatrix(m, device=dev)
    for k in (72, 96, 128):
        Xt = spmm(f"headline_k{k}", sm, m, k)
        cols = [Xt[:, j].contiguous() for j in range(k)]
        ms[f"headline_k{k}_loop"] = call_ms(lambda: [sm @ c for c in cols],
                                            dev, repeats=10)
    del sm, Xt, cols
    shuf = st.GStreamDevice(h.pack_gstream(m, shuffle_lanes=True), dev)
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
    d = st.BSRDevice(h.csr_to_bsr(m), dev)
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
    return {"ms": ms, "pcg_iterations": its}


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
