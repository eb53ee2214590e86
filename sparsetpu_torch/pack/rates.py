"""Kernel rate tables for the pack-time layout model.

The pack chooses (G window groups, Q row-pad quantum) by predicted
time = slots / rate + finish, so it needs the dual-gather kernel's slot
throughput per (G, Q).  The table below was measured on a TPU v5e for the
JAX package's kernel (tiles_per_step=128, fused int16 meta stream); this
package keeps it unchanged, so that its packs are the very packs the JAX
package builds on a machine without a TPU.  Rates measured on the H100
would replace it through a parameter, not in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def _device_kind() -> str:
    """The device kind the rate table is keyed by.  The JAX package reads
    its accelerator's kind and takes "cpu" without one; this package
    always takes "cpu", so both choose the same layouts."""
    return "cpu"


def _rates_for(kind: str) -> Dict[Tuple[int, int], float]:
    if kind != "cpu":
        raise KeyError(f"no rate table for device kind {kind!r}")
    return _V5E_RATES


def slot_rate(G: int, Q: int, kind: Optional[str] = None) -> float:
    """Gslot/s of the dual-gather kernel at window groups G, quantum Q."""
    table = _rates_for(kind or _device_kind())
    if (G, Q) in table:
        return table[(G, Q)]
    # nearest measured G at same Q (G off-grid only via explicit G= pins)
    gs = sorted({g for g, q in table if q == Q})
    gn = min(gs, key=lambda g: abs(g - G)) if gs else 8
    return table.get((gn, Q), 80.0)
