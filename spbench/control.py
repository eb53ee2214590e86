"""The control of each cell's comparison: the reference put in the
program's place, computed in the nearest real type below the one the
configuration states, has to come out not correct.

``python -m spbench.control --workload <cell> --seeds <n> ...`` prints,
for each seed, every number compared beside its limit, and exits 1 if the
control passed any seed's comparison.  It needs no card: the reference is
NumPy."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from spbench.reference.spmv import BF16

# the nearest real type below the configuration's: bfloat16 for float32,
# float32 for float64
LOWER = {"float32": BF16, "float64": np.float32}


def control_readings(cell: str, seed: int, root=None) -> dict:
    """{key: (value, limit)} of the control on the inputs of a run of
    ``cell`` with ``seed``."""
    from spbench import harness
    root = root or harness.ROOT
    wl = harness.load_json("workloads", cell, root)
    cfg = harness.load_json("configs", wl["config"], root)
    mix = harness.load_json("traffic", wl["traffic"], root)
    kind = harness.load_module("traffic", mix["kind"], root)
    gen = harness.load_module("generators", cfg["generator"], root)
    csr = gen.generate(cfg, harness.seeded_rng(seed, 0))
    readings = kind.control(mix, csr, harness.seeded_rng(seed, 2),
                            LOWER[cfg["dtype"]])
    return {k: (max(readings[k]), lim) for k, lim in wl["limits"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    passed = 0
    for seed in args.seeds:
        t = time.perf_counter()
        r = control_readings(args.workload, seed)
        ok = all(v <= lim for v, lim in r.values())
        passed += ok
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": ok,
                          "seconds": time.perf_counter() - t,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in r.items()}}),
              flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
