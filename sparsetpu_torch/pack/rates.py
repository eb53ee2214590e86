"""Kernel rate tables for the pack-time layout model, and their measurement
on the card (counterpart of ``sparsetpu/pack/rates.py``).

The pack chooses (G window groups, Q row-pad quantum) by predicted
time = slots / rate + finish, so it needs the forward kernel's slot
throughput per (G, Q).  The default table below was measured on a TPU v5e
for the JAX package's kernel (tiles_per_step=128, fused int16 meta stream);
this package keeps it unchanged, so that its default packs are the very
packs the JAX package builds on a machine without a TPU.

``refresh_rates`` measures the same table for this package's own forward
kernel (``csrc/gstream_spmv.cu``, window scheme) on the card and caches it
as ``rates_<card name>.json`` under ``$SPARSETPU_TORCH_CACHE`` (default
``~/.cache/sparsetpu_torch``); ``load_rates`` reads it back.  Unlike the
JAX package, which picks up a cached table on its own, a card table
reaches the chooser only when a caller passes it
(``pack_gstream(..., rates=table)``).  ``MATCH_INFLATION`` and
``FINISH_NS_PER_CHILD`` stay the reference's: a card table beside them
mixes the card's forward cost with a finish cost fitted on a TPU.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..utils.config import LANES, SUBLANES
# HBM_GBPS: device-memory GB/s by card name (the JAX module's table is by
# TPU kind)
from ..utils.device import CUDA, HBM_GBPS  # noqa: F401

# Gslot/s of the dual-gather kernel on TPU v5e, keyed (G, Q).  Q=8 -> 1
# output plane, Q=4 -> 2, Q=2 -> 4, Q=1 -> 8.  (The G select chain costs
# ~linearly, extra output planes cost ~5-10% each.)
_V5E_RATES: Dict[Tuple[int, int], float] = {
    (1, 8): 119.6, (1, 4): 111.2, (1, 2): 100.1, (1, 1): 85.0,
    (2, 8): 115.0, (2, 4): 105.0, (2, 2): 90.4, (2, 1): 77.0,
    (4, 8): 109.9, (4, 4): 97.6, (4, 2): 84.6, (4, 1): 72.0,
    (8, 8): 95.5, (8, 4): 86.3, (8, 2): 74.8, (8, 1): 64.0,
    (16, 8): 88.0, (16, 4): 67.4, (16, 2): 57.5, (16, 1): 49.0,
    (32, 8): 46.5, (32, 4): 43.0, (32, 2): 39.9, (32, 1): 34.0,
}

# Residue matching gets harder as the quantum shrinks (fewer candidate
# slots per chunk): empirical slot inflation of real packs vs the
# padding-only model, measured on the 10M-nnz headline matrix at the
# per-Q first-fit windows of native.packer.DEFAULT_MAX_OPEN.
MATCH_INFLATION = {8: 1.03, 4: 1.12, 2: 1.10, 1: 1.25}

# Per reduction child (chunk partial sum) cost of the finish levels,
# in the same unit as slots/rate above (slots per Gslot/s = ns):
# measured V2 final on the 10M-nnz headline: 0.111 ms for 1.88M
# children (G=16 forward, 2 sub-windows per block) ~= 0.06 ns/child.
# More chunks = a more expensive finish, which is what rules out tiny
# quanta on dense rows.
FINISH_NS_PER_CHILD = 0.06

# the (G, Q) grid refresh_rates sweeps, as the JAX package's
RATE_COMBOS = tuple((g, q) for g in (1, 2, 4, 8, 16, 32) for q in (1, 2, 4, 8))
# tiles the sweep streams on the card: 134 MB of values and 67 MB of meta,
# four times the H100's 50 MB L2, so back-to-back calls read HBM (the JAX
# package's 4096 tiles would sit in L2)
CARD_RATE_TILES = 32768

RateTable = Dict[Tuple[int, int], float]


def _device_kind() -> str:
    """The device kind the default table is keyed by.  The JAX package
    reads its accelerator's kind and takes "cpu" without one; this package
    always takes "cpu", so both choose the same layouts."""
    return "cpu"


def _rates_for(kind: str) -> RateTable:
    if kind != "cpu":
        raise KeyError(f"no rate table for device kind {kind!r}")
    return _V5E_RATES


def slot_rate(G: int, Q: int, kind: Optional[str] = None,
              rates: Optional[RateTable] = None) -> float:
    """Gslot/s of the forward kernel at window groups G, quantum Q: from
    ``rates`` when given (a ``refresh_rates`` table), else the default
    table."""
    table = rates if rates is not None else _rates_for(kind or _device_kind())
    if (G, Q) in table:
        return table[(G, Q)]
    # nearest measured G at same Q (G off-grid only via explicit G= pins)
    gs = sorted({g for g, q in table if q == Q})
    gn = min(gs, key=lambda g: abs(g - G)) if gs else 8
    return table.get((gn, Q), 80.0)


# ---------------------------------------------------------------------------
# the measuring half (sparsetpu/pack/rates.py:115-191)
# ---------------------------------------------------------------------------

def _cache_path(kind: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", kind)
    base = os.environ.get("SPARSETPU_TORCH_CACHE",
                          os.path.expanduser("~/.cache/sparsetpu_torch"))
    return os.path.join(base, f"rates_{safe}.json")


def load_rates(kind: str) -> Optional[RateTable]:
    """The table ``refresh_rates`` cached for device kind ``kind`` (the
    card's name, or "cpu"); None when there is none."""
    try:
        with open(_cache_path(kind)) as f:
            raw = json.load(f)
    except FileNotFoundError:
        return None
    return {tuple(map(int, k.split(","))): float(v) for k, v in raw.items()}


def rate_inputs(G, n_tiles: int):
    """The sweep's inputs, drawn from ``default_rng(0)`` in the JAX
    package's order (``sparsetpu/pack/rates.py:133-151``): values
    (n_tiles*8, 128) f32, the lane route, the x window (8*32, 128) f32,
    then for each G (an int, or the Gs in the order the sweep first meets
    them) the int16 meta ``cells << 7 | route`` with cells in [0, 8G).
    Returns (values, xw0, {G: meta}) as numpy arrays."""
    gs = [G] if isinstance(G, (int, np.integer)) else list(G)
    rng = np.random.default_rng(0)
    rows = n_tiles * SUBLANES
    val = rng.standard_normal((rows, LANES)).astype(np.float32)
    route = rng.integers(0, LANES, size=(rows, LANES)).astype(np.int32)
    xw0 = rng.standard_normal((SUBLANES * 32, LANES)).astype(np.float32)
    metas = {}
    for g in gs:
        if g not in metas:
            cells = rng.integers(0, SUBLANES * g, size=(rows, LANES))
            metas[g] = ((cells << 7) | route).astype(np.int16)
    return val, xw0, metas


def refresh_rates(verbose: bool = False, combos: Optional[Iterable] = None,
                  interpret: bool = False, n_tiles: Optional[int] = None,
                  *, device=CUDA, timer=None) -> RateTable:
    """Measure the forward kernel's Gslot/s at every (G, Q) on ``device``
    and cache the table for its kind.

    Each (G, Q) runs ``gstream_chunk_sums`` (``csrc/gstream_spmv.cu``,
    window scheme) on ``rate_inputs`` with 128 tiles a step, P = 8 / Q
    planes, every step on window 0 and x2 = the x window, timed back to
    back (``bench.harness.stream_ms``); Gslot/s = n_tiles * 1024 / t.
    ``n_tiles`` defaults to ``CARD_RATE_TILES`` on the card (4096, the JAX
    package's, on the CPU).  ``timer(fn, device) -> ms a call`` replaces
    the clock; it exists for tests on the CPU, where without it this raises:
    CPU times are not rates.  The positional arguments are the JAX
    function's; ``interpret=True`` is the CPU
    (``utils/device.py:pick_device``)."""
    import torch

    from ..bench.harness import stream_ms
    from ..kernels.spmv_gstream import gstream_chunk_sums
    from ..utils.device import pick_device

    dev = pick_device(device, interpret)
    if timer is None:
        if dev.type != "cuda":
            raise ValueError("refresh_rates on the CPU needs a timer: CPU "
                             "times are not kernel rates")
        timer = stream_ms
    if n_tiles is None:
        n_tiles = CARD_RATE_TILES if dev.type == "cuda" else 4096
    T = min(128, n_tiles)
    if n_tiles % T:
        raise ValueError(f"n_tiles={n_tiles} must be a multiple of {T}")
    combos = [tuple(c) for c in (RATE_COMBOS if combos is None else combos)]
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    val, xw0, metas = rate_inputs([g for g, _ in combos], n_tiles)

    def up(a):
        return torch.from_numpy(a).to(dev)
    val, xw0 = up(val), up(xw0)
    metas = {g: up(m) for g, m in metas.items()}
    step_window = torch.zeros(n_tiles // T, dtype=torch.int32, device=dev)
    table = {}
    for G, Q in combos:
        meta, P = metas[G], SUBLANES // Q

        def call(meta=meta, G=G, P=P):
            return gstream_chunk_sums(val, meta, step_window, xw0, T=T, G=G,
                                      P=P)
        ms = timer(call, dev)
        table[(G, Q)] = n_tiles * 1024 / (ms * 1e-3) / 1e9
        if verbose:
            print(f"  G={G:2d} Q={Q}: {table[(G, Q)]:6.1f} Gslot/s "
                  f"({ms:.4f} ms)", flush=True)
    path = _cache_path(kind)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({f"{g},{q}": v for (g, q), v in table.items()}, f)
    return table
