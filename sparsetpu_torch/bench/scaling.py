"""Weak-scaling report of the distributed SpMV: nnz/s at 1, 2, 4, ...
ranks (counterpart of ``sparsetpu/bench/scaling.py``).

Each row shards a ``random_csr`` matrix of ``rows_per_dev`` rows a rank
(constant work a rank) with ``dist.shard_spmv`` (or, with ``--multihost``
under a multi-process launch, ``shard_spmv_multihost``), checks y against
the gold, and times one ``spmv`` call on group rank 0 with CUDA events
(``bench/harness.py:call_ms``) after a barrier, every rank making the same
calls; beside it the fill of the all-gather bands and, from 2 ranks on,
of the ring's (``ring_shard_spmv``, whose errors are not caught).

On the card the rank counts go up to the number of cards, one rank a card
over NCCL: one card gives the P = 1 row alone.  With ``--device cpu`` the
ranks are gloo processes on the CPU (``--devices`` of them, 1 by
default) and the report says ``"backend": "cpu"``: its numbers check the
protocol and the collectives, not a device's speed.

    python -m sparsetpu_torch.bench.scaling [--rows-per-dev 50000]
        [--nnz-per-row 32] [--devices N] [--device cpu] [--multihost]
        [--json]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

COUNTS = (1, 2, 4, 8, 16, 32)


def _fill(nnz: int, slots: int, group, device) -> float:
    """nnz over the slots of every rank's band."""
    from ..dist import comm
    t = torch.tensor([slots], dtype=torch.int64, device=device)
    total = sum(int(s) for s in comm.all_gather(t, group))
    return nnz / max(total, 1)


def report_rank(rank: int, world: int, device, counts, rows_per_dev: int,
                nnz_per_row: int, multihost: bool, verbose: bool):
    """One rank's part of the report: a row for each rank count in
    ``counts`` (each a group of the first P ranks; the other ranks only
    join the group's creation).  Returns the report on rank 0, None
    elsewhere."""
    from ..dist.multihost import shard_spmv_multihost
    from ..dist.ring import ring_shard_spmv
    from ..dist.spmv_dist import make_mesh, shard_spmv
    from ..formats.gold import spmv_gold, verification
    from ..formats.random import random_csr
    from .harness import call_ms

    rows, base = [], None
    for p in counts:
        group = make_mesh(p)
        if rank >= p:
            continue
        r = c = rows_per_dev * p
        m = random_csr(r, c, density=nnz_per_row / c, seed=11,
                       dtype=np.float32)
        shard = shard_spmv_multihost if multihost else shard_spmv
        sh = shard(m, group, device=device)
        x = np.random.default_rng(4).standard_normal(c)
        xt = torch.as_tensor(x, dtype=torch.float32, device=device)
        y = sh.spmv(xt).cpu().numpy()
        errs = verification(spmv_gold(m, x), y, diff_thres=1e-3,
                            rel_thres=1e-3)
        dist.barrier(group)
        ms = call_ms(lambda: sh.spmv(xt), device)
        ag_fill = _fill(m.nr_nzeros, sh.band.stream.values.numel(), group,
                        device)
        ring_fill = None
        if p > 1 and not multihost:
            rs = ring_shard_spmv(m, group, device=device)
            ring_fill = _fill(m.nr_nzeros, rs.values.numel(), group, device)
        gnnz = m.nr_nzeros / ms / 1e6
        base = gnnz if base is None else base
        eff = gnnz / (base * p)
        rows.append({"devices": p, "rows": r, "nnz": m.nr_nzeros,
                     "gnnz_s": round(gnnz, 3),
                     "weak_scaling_eff": round(eff, 3),
                     "allgather_fill": round(ag_fill, 3),
                     "ring_fill": (round(ring_fill, 3)
                                   if ring_fill is not None else None),
                     "verify_errors": int(errs)})
        if verbose and rank == 0:
            rf = (f"ring_fill={ring_fill:.3f}" if ring_fill is not None
                  else "")
            print(f"P={p:3d}  rows={r:9d}  {gnnz:8.3f} Gnnz/s  "
                  f"eff={eff:6.1%}  fill={ag_fill:.3f}  {rf}  verify="
                  f"{'PASS' if errs == 0 else 'FAIL'}", flush=True)
    if rank:
        return None
    return {"backend": torch.device(device).type, "weak_scaling": rows}


def scaling_report(rows_per_dev: int = 50_000, nnz_per_row: int = 32,
                   max_devices: int = None, verbose: bool = True,
                   multihost: bool = False, *, device="cuda"):
    """The report's rows at P = 1, 2, 4, ... up to the cards present (or
    ``max_devices``; on the CPU ``max_devices`` gloo ranks, 1 by
    default).  Under a multi-process launch (``torchrun``, the group
    already initialized) every process calls it and the rows run on the
    world's ranks; otherwise it starts its own ranks
    (``dist.launch.run_ranks``).  ``multihost`` without a multi-process
    launch prints the refusal and runs the single-process path."""
    from ..dist.launch import rank_device, run_ranks
    from ..dist.multihost import is_multiprocess

    if multihost and not is_multiprocess():
        print("--multihost: a single process (torch.distributed is not "
              "initialized by a multi-process launch: no cluster "
              "environment; run every process under torchrun, which sets "
              "MASTER_ADDR, RANK, WORLD_SIZE etc.).  Falling back to the "
              "single-process path over all local devices.", flush=True)
        multihost = False
    dev = torch.device(device)
    if is_multiprocess():
        n = dist.get_world_size()
    elif dev.type == "cuda":
        rank_device(0, dev)             # raises without a card
        n = torch.cuda.device_count()
    else:
        n = 1 if max_devices is None else max_devices
    if max_devices is not None:
        n = min(n, max_devices)
    counts = [p for p in COUNTS if p <= n]
    args = (counts, rows_per_dev, nnz_per_row, multihost, verbose)
    if is_multiprocess():
        from ..dist.spmv_dist import default_device
        return report_rank(dist.get_rank(), n, default_device()
                           if dev.type == "cuda" else dev, *args)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    return run_ranks(report_rank, counts[-1], backend, *args,
                     device=dev)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sparsetpu_torch.bench.scaling")
    ap.add_argument("--rows-per-dev", type=int, default=50_000)
    ap.add_argument("--nnz-per-row", type=int, default=32)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--multihost", action="store_true",
                    help="each process packs its own band with the global "
                         "layout (needs a torchrun launch; see "
                         "dist/multihost.py)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.multihost and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from ..dist.multihost import init_multihost
        init_multihost(None if args.device == "cuda" else "gloo")
    rep = scaling_report(args.rows_per_dev, args.nnz_per_row, args.devices,
                         verbose=not args.json, multihost=args.multihost,
                         device=args.device)
    if args.json and rep is not None:
        print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
