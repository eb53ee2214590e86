"""CLI driver: ``python -m sparsetpu_torch <matrix-file>``.

The reference executable's run protocol, as ``python -m sparsetpu`` runs it
(banner -> read matrix -> random x -> timed CPU gold -> timed repack ->
device SpMV -> verification PASS/FAIL -> storage report), on the port: the
device is chosen with ``--device`` (default ``cuda``; nothing falls back to
the CPU).  It takes the JAX CLI's flags: ``--backend pallas|fused|xla``
(``pallas`` the default, as there; the port's own names ``auto`` and
``coo`` too) and ``-v/--verbose``, counted and, as in the JAX CLI, read
nowhere.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sparsetpu_torch",
        description="PyTorch/CUDA SpMV benchmark driver (main.cpp protocol)")
    p.add_argument("matrix", nargs="?",
                   help="matrix file (row-sorted triplet or .mtx); "
                        "omit with --random")
    p.add_argument("--random", type=str, default=None, metavar="RxCxD",
                   help="use a random matrix, e.g. 200000x100000x0.0005")
    p.add_argument("--double", action="store_true",
                   help="double precision (DOUBLE=1): f64 matrix, x and y "
                        "on the f64 devices (native FP64 kernels)")
    p.add_argument("--vf", type=int, default=0, choices=(0, 1, 2, 4, 8),
                   help="vector factor / row-pad quantum (VF); 0 = chosen "
                        "by the layout model")
    p.add_argument("--partitions", type=int, default=1,
                   help="row partitions (CU), nnz-balanced")
    p.add_argument("--backend", default="pallas",
                   choices=("pallas", "fused", "xla", "auto", "coo"),
                   help="pallas (or auto) routes as the JAX package "
                        "(fused, hybrid or classic GStream kernels); fused "
                        "errors when the fused layout does not apply; xla "
                        "(or coo) is gather + index_add_")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--repeats", type=int, default=50,
                   help="timed calls (median reported)")
    p.add_argument("--verbose", "-v", action="count", default=0)
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the benchmark "
                        "into DIR (a Chrome trace: chrome://tracing, "
                        "Perfetto)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from . import _host
    from .bench.harness import bench_spmv
    from .utils.device import require_device
    from .utils.timing import maybe_profiler_trace

    device = require_device(args.device)
    dtype = np.float64 if args.double else np.float32
    print(f"sparsetpu_torch SpMV: partitions={args.partitions} "
          f"vf={args.vf or 'auto'} "
          f"precision={'double' if args.double else 'single'} "
          f"backend={args.backend} device={device}")
    if device.type == "cuda":
        import torch
        print(f"device: {torch.cuda.get_device_name(device)}")

    if args.random:
        r, c, d = args.random.split("x")
        matrix = _host.random_csr(int(r), int(c), float(d), dtype=dtype,
                                  seed=0)
        name = f"random-{args.random}"
    elif args.matrix:
        matrix = _host.read_matrix(args.matrix, dtype=dtype)
        name = args.matrix
    else:
        print("error: provide a matrix file or --random RxCxD",
              file=sys.stderr)
        return 2

    cfg = _host.SpmvConfig(dtype=dtype, vf=args.vf,
                           num_partitions=args.partitions)
    with maybe_profiler_trace(args.profile):
        result = bench_spmv(matrix, name=name, config=cfg,
                            repeats=args.repeats, backend=args.backend,
                            device=device)
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    print(result.report())
    return 0 if result.verify_errors == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
