"""HPCG's CG sets back to back, one closed-loop client: each set is
``pcg_df64(sm.spmv, b, jacobi_preconditioner(m), tol=0,
maxiter=iterations)`` from x0 = 0, and ends when its residual norm is read
on the host.  b = A x*, x* drawn from the seed; the reference makes b.

Mix parameters: ``iterations`` (a set's, every one of which has to run),
``keep`` (solutions kept for the comparison, a reservoir over the sets),
``trace_sets`` (sets in the traced slice)."""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import torch

import sparsetpu_torch as port
from sparsetpu_torch import solvers

from spbench import timing
from spbench.reference import spmv as ref
from spbench.traffic._sample import Reservoir


class State:
    def __init__(self, sm, m_inv, b, b_host):
        self.sm, self.m_inv, self.b, self.b_host = sm, m_inv, b, b_host
        self.kept, self.short = None, []


def make_b(csr, rng):
    """b = A x*, x* uniform from the seed, by the reference."""
    x_star = rng.uniform(0.0, 1.0, csr.nr_cols).astype(csr.values.dtype)
    with ThreadPoolExecutor(ref.threads()) as ex:
        return ref.spmv(csr, x_star, csr.values.dtype, ex)


def prepare(run, sm, csr, rng):
    b_host = make_b(csr, rng)
    m_inv = port.jacobi_preconditioner(
        port.CSRMatrix(csr.row_ptr, csr.col_ind, csr.values, csr.nr_rows,
                       csr.nr_cols), device=run.device)
    st = State(sm, m_inv, torch.as_tensor(b_host, device=run.device),
               b_host)
    _set(run, st)
    return st


def _set(run, st):
    res = solvers.pcg_df64(st.sm.spmv, st.b, st.m_inv, tol=0.0,
                           maxiter=int(run.mix["iterations"]),
                           device=run.device)
    float(res.residual_norm)
    return res


def window(run, st, rng):
    st.kept = Reservoir(int(run.mix["keep"]), rng)
    perf, t0, sets = time.perf_counter, time.perf_counter(), 0
    while True:
        t = perf()
        res = _set(run, st)
        run.span("cg_set", perf() - t)
        st.short.append(float(int(run.mix["iterations"]) - res.iterations))
        st.kept.offer(res.x)
        sets += 1
        if perf() - t0 >= run.seconds:
            break
    run.window_s = perf() - t0
    run.counts["sets"] = run.counts["attempted"] = sets


def trace(run, st):
    bare = timing.traced(torch, lambda: st.sm.spmv(st.b))
    run.spmv_kernels = frozenset(e.name for e in bare.device)
    n = int(run.mix["trace_sets"])

    def sets():
        for _ in range(n):
            _set(run, st)
    run.traces["cg"] = timing.traced(torch, sets)
    run.counts["trace_iterations"] = n * int(run.mix["iterations"])


def outputs(st):
    return [x.cpu().numpy() for x in st.kept.items], st.b_host, st.short


def _solve(mix, csr, b, dtype):
    """The reference's solution and the iterations it fell short by."""
    n = int(mix["iterations"])
    with ThreadPoolExecutor(ref.threads()) as ex:
        x, _, steps = ref.pcg(csr, b, n, dtype, ex)
    return x, float(n - steps)


def judge(run, csr, outs):
    xs, b, short = outs
    x_ref, _ = _solve(run.mix, csr, b, csr.values.dtype)
    return {"cg_x_err": [ref.vec_err(x, x_ref) for x in xs],
            "cg_short": short}


def control(mix, csr, rng, lower):
    """The readings of the reference's CG put in the program's place,
    computed in the real type ``lower``, on the b a run with this ``rng``
    makes."""
    b = make_b(csr, rng)
    x_ref, _ = _solve(mix, csr, b, csr.values.dtype)
    x, short = _solve(mix, csr, b, lower)
    return {"cg_x_err": [ref.vec_err(x, x_ref)], "cg_short": [short]}
