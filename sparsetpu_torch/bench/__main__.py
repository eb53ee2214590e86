"""The headline SpMV line of the port (counterpart of the repository's
``bench.py``), on the card:

    python -m sparsetpu_torch.bench [--device cuda|cpu] [--small]

Runs ``bench.py``'s protocol (its lines 73-153) on this package: the same
matrix, ``random_csr(200_000, 100_000, density=0.0005, seed=1, float32)``
(``--small``, on the CPU only: 40k x 20k), packed by ``SparseMatrix`` on
the fused route; the correctness gate first (``verification`` against
``spmv_gold`` at 1e-2, 1e-3 on a standard-normal x; a failed gate scores
0); then the time of ``spmv_packed_x``.  On the card ``value`` comes from
``stream_ms`` (calls back to back, host launch gaps out, as the JAX
bench's chained in-jit loop leaves host dispatch out), and ``call_ms`` (one
call, as a caller sees it) is printed beside it; on the CPU both are the
plain versions' host times.  Prints one JSON line with ``bench.py``'s keys
and ``stream_ms``, ``call_ms``, ``card`` and ``verify_errors``; without a
card (and ``--device cuda``, the default), or on any failure, it prints
``bench.py``'s error line and exits 1.  Nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import numpy as np

# ZCU102 HP ports ~10 GB/s / ~10 B per nnz (the reference's ceiling, as
# bench.py's REFERENCE_CEILING_GNNZ_S)
REFERENCE_CEILING_GNNZ_S = 1.0


def run(device: str, small: bool) -> dict:
    """The protocol on ``device``; returns the line's fields."""
    from .. import _host
    from ..api.api import SparseMatrix
    from ..utils.device import card_line, hbm_gbps, require_device
    from .harness import call_ms, stream_ms

    dev = require_device(device)
    nr, nc = (40_000, 20_000) if small else (200_000, 100_000)
    m = _host.random_csr(nr, nc, density=0.0005, seed=1, dtype=np.float32)
    sm = SparseMatrix(m, backend="fused", device=dev)
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    xp = sm.prepare_x(x)

    # correctness gate first: a fast wrong kernel scores zero
    y = sm.spmv_packed_x(xp).cpu().numpy()
    errors = _host.verification(_host.spmv_gold(m, x), y, diff_thres=1e-2,
                                rel_thres=1e-3)

    one_ms = call_ms(lambda: sm.spmv_packed_x(xp), dev)
    back_ms = None
    if dev.type == "cuda":
        back_ms = float(np.median([stream_ms(lambda: sm.spmv_packed_x(xp),
                                             dev) for _ in range(5)]))
    per_call = (back_ms if back_ms is not None else one_ms) * 1e-3
    gnnz = 0.0 if errors else m.nr_nzeros / per_call / 1e9
    roofline = None
    d = sm.device_module
    if dev.type == "cuda":
        floor_s = d.bytes_a_call / (hbm_gbps(dev) * 1e9)
        roofline = round(floor_s / per_call, 3) if gnnz else 0.0
    final = getattr(d, "final", None)
    return {
        "metric": "spmv_throughput",
        "value": round(gnnz, 3),
        "unit": "Gnnz/s",
        "vs_baseline": round(gnnz / REFERENCE_CEILING_GNNZ_S, 2),
        "roofline_frac": roofline,
        "fill": round(sm.fill_factor(), 3),
        "backend": dev.type,
        "layout": {"G": getattr(sm.packed, "GLW", None) or sm.packed.G,
                   "Q": sm.packed.Q,
                   "final": ("fused-instep" if final is None
                             else type(final).__name__)},
        "stream_ms": back_ms,
        "call_ms": one_ms,
        "card": card_line() if dev.type == "cuda" else None,
        "verify_errors": int(errors),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sparsetpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help="40k x 20k (with --device cpu only)")
    args = ap.parse_args(argv)
    if args.small and args.device != "cpu":
        ap.error("--small is for --device cpu")
    try:
        line = run(args.device, args.small)
    except Exception as e:            # noqa: BLE001 (the error line)
        traceback.print_exc()
        print(json.dumps({
            "metric": "spmv_throughput", "value": 0.0, "unit": "Gnnz/s",
            "vs_baseline": 0.0, "backend": "error",
            "error": f"{type(e).__name__}: {e}"[:500]}), flush=True)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
