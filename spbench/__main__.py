"""``python -m spbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>``: one run of one cell on the card; the last line of standard output
is the result, a JSON object, and the numbers compared with the reference
are the last lines of standard error."""

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock, from
    /proc (to 10 ms); this module's import time where /proc has none."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return _T_IMPORT
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return min(_T_IMPORT, time.perf_counter() - age)


def main(argv=None, root=None, device=None, allowance_s=None) -> int:
    """The entry point.  ``root`` (the benchmark's folder), ``device``
    ("cpu" runs with no card) and ``allowance_s`` (a run on ranks: its
    set-up allowance, ``ranks.SETUP_ALLOWANCE_S`` when None) are for the
    tests; the command line sets none of them."""
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="python -m spbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .harness import ROOT, load_json
    from .imports import forbidden_loaded
    root = root or ROOT
    wl = load_json("workloads", args.workload, root)
    chips = int(wl["chips"])
    if chips > 1 and "layout" not in load_json("configs", wl["config"],
                                               root):
        print(f"spbench: {args.workload} asks for {chips} cards, and its "
              f"configuration {wl['config']} names no layout "
              f"(layouts/<name>.py) to cut the matrix by rank",
              file=sys.stderr)
        return 5
    import torch
    if device is None and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < chips):
        print(f"spbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    from . import harness
    beside = os.path.dirname(os.path.dirname(
        os.path.abspath(harness.port.__file__)))
    if beside != os.path.dirname(harness.ROOT):
        print(f"spbench: the port was imported from {beside}, not from "
              f"the checkout that holds the benchmark", file=sys.stderr)
        return 4
    if chips == 1:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start, device=device,
                                  root=root)
        bad = []
    else:
        from . import ranks
        result, parts = ranks.launch(
            args.workload, args.seed, args.seconds, bool(args.trace),
            t_start, chips, device=device or "cuda", root=root,
            allowance_s=allowance_s)
        differ = ranks.merge_devices(result, parts)
        if differ:
            print(f"spbench: the ranks' cards differ: {differ}",
                  file=sys.stderr)
            return 6
        bad = [f"{m} (rank {r})" for r, p in enumerate(parts, 1)
               for m in p["forbidden"]]
    bad = forbidden_loaded() + bad
    if bad:
        print(f"spbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print("phases " + " ".join(f"{k} {v:.3f} s" for k, v in
                               result["phases_s"].items()), file=sys.stderr)
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
