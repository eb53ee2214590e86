"""Autotuning of the pack layout on the card (counterpart of
``sparsetpu/api/autotune.py``).

The pack picks (G window groups, Q quantum) from a cost model
(``pack/gather_stream._choose_layout``); ``autotune_pack`` packs a few
candidates around that choice, times each one's SpMV on the device and
keeps the fastest: the pattern for a matrix multiplied thousands of times,
where a few packs are paid once.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..kernels.spmv_gstream import GStreamDevice
from ..pack.gather_stream import MAX_G, VALID_Q, _choose_layout, pack_gstream
from ..utils.device import CUDA, pick_device
from .api import SparseMatrix


def autotune_candidates(matrix, rates=None):
    """The model's (G, Q) choice plus its neighbours: half and double G at
    its Q, half and double Q at its G, and the two diagonals (half G with
    double Q and double G with double Q), as
    ``sparsetpu/api/autotune.py:35-45``.  Returns (candidates, (g0, q0))."""
    g0, q0 = _choose_layout(matrix, rates=rates)
    gs = sorted({max(1, g0 // 2), g0, min(MAX_G, g0 * 2)})
    qs = sorted({max(1, q0 // 2), q0, min(8, q0 * 2)} & set(VALID_Q))
    cands = sorted({(g, q0) for g in gs} | {(g0, q) for q in qs}
                   | {(max(1, g0 // 2), min(8, q0 * 2)),
                      (min(MAX_G, g0 * 2), min(8, q0 * 2))})
    return cands, (g0, q0)


def autotune_pack(matrix, candidates: Optional[Sequence] = None,
                  interpret=None, verbose: bool = False, *, device=CUDA,
                  rates=None, timer=None) -> SparseMatrix:
    """Pack ``matrix`` at several (G, Q) layouts, time each one's
    ``GStreamDevice.spmv`` on ``device`` and return the fastest as a
    classic-device ``SparseMatrix`` (also where the default route would be
    fused, as the JAX function does).

    ``candidates`` defaults to ``autotune_candidates(matrix, rates)``;
    bare ints are window sizes G at the model's Q.  Each candidate is
    timed back to back (``bench.harness.stream_ms``); ``timer(fn, device)
    -> ms a call`` replaces that clock.  On the CPU, without a timer, only
    a single candidate is taken (there is nothing to choose): CPU times of
    the plain versions say nothing of the card.  ``interpret=True`` is the
    CPU (``utils/device.py:pick_device``)."""
    from ..bench.harness import stream_ms     # the harness imports api

    dev = pick_device(device, interpret)
    default, (g0, q0) = autotune_candidates(matrix, rates)
    if candidates is None:
        candidates = default
    else:
        # bare ints are window sizes (the pre-Q calling convention)
        candidates = [(c, q0) if isinstance(c, (int, np.integer))
                      else tuple(c) for c in candidates]
    if timer is None:
        if dev.type != "cuda" and len(candidates) > 1:
            raise ValueError("autotune_pack on the CPU needs a timer to "
                             "choose between candidates: CPU times are not "
                             "the card's")
        timer = stream_ms if dev.type == "cuda" else None

    x = np.random.default_rng(0).standard_normal(matrix.nr_cols)
    best = None
    for g, q in candidates:
        packed = pack_gstream(matrix, G=int(g), Q=int(q))
        d = GStreamDevice(packed, device=dev)
        x2 = d.prepare_x(x)
        ms = (timer(lambda: d.spmv(x2, x_is_packed=True), dev)
              if timer is not None else math.nan)
        if verbose:
            print(f"autotune G={g} Q={q}: {ms:.4f} ms "
                  f"(fill {packed.fill_factor:.3f})", flush=True)
        if best is None or ms < best[0]:
            best = (ms, d)
    return SparseMatrix._from_classic(matrix, best[1])
