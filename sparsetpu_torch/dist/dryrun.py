"""A dry run of the distributed pipeline on n gloo ranks on the CPU, tiny
shapes (the port's ``dryrun_multichip``, after
``__graft_entry__.py:28-80``): one CG iteration over the all-gather
schedule, a ring SpMV, a multi-host SpMV and an f64 CG solve over the
sharded f64 SpMV, each result finite.

    python -m sparsetpu_torch.dist [n]      # n ranks, 4 by default
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.random import laplace_2d
from ..solvers.cg import cg_df64, cg_step
from .df64 import shard_spmv_df64
from .launch import run_ranks
from .multihost import shard_spmv_multihost
from .ring import ring_shard_spmv
from .spmv_dist import make_mesh, shard_spmv


def dryrun_rank(rank: int, world: int, device) -> dict:
    """The dry run's body on one rank of a ``world``-rank group; returns
    its numbers (every rank computes the same)."""
    group = make_mesh(world)
    m = laplace_2d(24)                       # 576 x 576, SPD
    sh = shard_spmv(m, group, device=device)
    b = torch.ones(m.nr_rows, device=device)
    x0 = torch.zeros_like(b)
    r0 = b - sh.spmv(x0)
    _, r1, _, _ = cg_step(sh.spmv)(x0, r0, r0, torch.dot(r0, r0))
    resid = float(torch.linalg.norm(r1))
    if not np.isfinite(resid):
        raise RuntimeError("non-finite residual in the distributed CG step")
    yr = ring_shard_spmv(m, group, device=device).spmv(b)
    ym = shard_spmv_multihost(m, group, device=device).spmv(b)
    for name, y in (("ring", yr), ("multihost", ym)):
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError(f"{name} SpMV non-finite")
    m64 = laplace_2d(16)
    shd = shard_spmv_df64(m64, group, device=device)
    res = cg_df64(shd.spmv, torch.ones(m64.nr_rows, dtype=torch.float64,
                                       device=device),
                  tol=1e-10, maxiter=200)
    if not bool(torch.isfinite(res.x).all()):
        raise RuntimeError("f64 CG over the sharded f64 SpMV non-finite")
    return {"cg_step_residual": resid, "cg_df64_iterations": res.iterations,
            "cg_df64_residual": float(res.residual_norm)}


def dryrun_multichip(n_devices: int) -> dict:
    """The dry run on ``n_devices`` gloo ranks on the CPU; prints rank 0's
    summary and returns its numbers."""
    out = run_ranks(dryrun_rank, n_devices, "gloo", device="cpu")[0]
    print(f"dryrun_multichip({n_devices}): {n_devices} gloo ranks, CG-step "
          f"residual={out['cg_step_residual']:.4f}, ring-SpMV OK, multihost "
          f"OK, f64 CG {out['cg_df64_iterations']} iterations to "
          f"{out['cg_df64_residual']:.3e}", flush=True)
    return out
