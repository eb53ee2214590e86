"""``sm @ x`` issued back to back by one host thread, x taken in turn from
a pool made from the seed; the host syncs every ``sync_every`` calls and
at the end of the window: a closed loop with work dispatched ahead, as
PageRank and power iteration issue it.

Mix parameters: ``pool`` (vectors), ``sync_every`` (calls between syncs),
``keep`` (answers kept for the comparison, one drawn from each block of
``sync_every`` calls, a reservoir over the blocks), ``held_calls`` (calls
a held burst in a traced run), ``trace_blocks`` (blocks in the traced
slice)."""

from __future__ import annotations

import itertools
import time
from concurrent.futures import ThreadPoolExecutor
from statistics import median

import numpy as np
import torch

from spbench import timing
from spbench.reference import spmv as ref
from spbench.traffic._sample import Reservoir


class State:
    def __init__(self, sm, pool, xs):
        self.sm, self.pool, self.xs = sm, pool, xs
        self.kept = None


def make_pool(mix, csr, rng):
    """The x vectors, in the matrix's real type."""
    return [rng.uniform(0.0, 1.0, csr.nr_cols).astype(csr.values.dtype)
            for _ in range(int(mix["pool"]))]


def prepare(run, sm, csr, rng):
    pool = make_pool(run.mix, csr, rng)
    xs = [torch.as_tensor(p, device=run.device) for p in pool]
    for _ in range(2):
        for x in xs:
            sm @ x
    return State(sm, pool, xs)


def _blocks(run, st, n_blocks, keep=None, rng=None, spans=None):
    """``n_blocks`` blocks of calls (or blocks until the window's seconds
    have passed, with ``n_blocks`` None), each call's host seconds appended
    to ``spans`` when given; returns the calls made and their seconds."""
    sm, xs, every = st.sm, st.xs, int(run.mix["sync_every"])
    perf = time.perf_counter
    t0, calls, block = perf(), 0, 0
    while True:
        pick = int(rng.integers(0, every)) if keep is not None else -1
        for j in range(every):
            i = calls % len(xs)
            if spans is not None:
                t = perf()
                y = sm @ xs[i]
                spans.append(perf() - t)
            else:
                y = sm @ xs[i]
            if j == pick:
                kept = (i, y)
            calls += 1
        run.sync()
        if keep is not None:
            keep.offer(kept)
        block += 1
        if (block >= n_blocks if n_blocks is not None
                else perf() - t0 >= run.seconds):
            return calls, perf() - t0


def window(run, st, rng):
    st.kept = Reservoir(int(run.mix["keep"]), rng)
    spans = run.spans.setdefault("spmv_call", []) if run.trace else None
    calls, run.window_s = _blocks(run, st, None, st.kept, rng, spans)
    run.counts["calls"] = run.counts["attempted"] = calls


def trace(run, st):
    xs = itertools.cycle(st.xs)
    n = int(run.mix["held_calls"])
    run.held_ms = median(timing.held_ms(torch, lambda: st.sm @ next(xs), n)
                         for _ in range(3))
    blocks = int(run.mix["trace_blocks"])
    run.traces["spmv"] = timing.traced(
        torch, lambda: _blocks(run, st, blocks))


def outputs(st):
    return [(i, y.cpu().numpy()) for i, y in st.kept.items], st.pool


def _errors(csr, pool, kept):
    errs = []
    with ThreadPoolExecutor(ref.threads()) as ex:
        for i in sorted({i for i, _ in kept}):
            y_ref = ref.spmv(csr, pool[i], np.float64, ex)
            scale = ref.abs_row_sums(csr, pool[i], ex)
            errs += [ref.spmv_err(y, y_ref, scale) for j, y in kept
                     if j == i]
    return errs


def judge(run, csr, outs):
    kept, pool = outs
    return {"spmv_err": _errors(csr, pool, kept)}


def control(mix, csr, rng, lower):
    """The readings of the reference put in the program's place, computed
    in the real type ``lower``, on the inputs a run with this ``rng``
    makes: every vector of the pool."""
    pool = make_pool(mix, csr, rng)
    with ThreadPoolExecutor(ref.threads()) as ex:
        kept = [(i, ref.spmv(csr, x, lower, ex)) for i, x in enumerate(pool)]
    return {"spmv_err": _errors(csr, pool, kept)}
