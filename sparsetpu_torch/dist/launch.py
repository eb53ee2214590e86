"""One process a rank: the port's stand-in for the JAX package's simulated
mesh (``tests/conftest.py`` fakes 8 devices in one process; a rank here is
a real process with its own device, joined to the others by
``torch.distributed``).

``run_ranks(fn, world, backend, *args, device=...)`` starts ``world``
processes (``torch.multiprocessing``, spawn), joins them into one process
group over a ``FileStore`` in a temporary directory, and calls
``fn(rank, world, device, *args)`` in each, with the rank's device:
``cuda:{rank % device_count}`` for ``device="cuda"`` (NCCL refuses two
ranks on one card; gloo takes them), the CPU for ``device="cpu"``.  Each
rank's return value comes back pickled in a file of that directory; a rank
that raises fails the whole call with its traceback, and the other ranks,
which may wait on it in a collective, are stopped.

The native packer and, for CUDA ranks, the kernels' library are built in
the calling process before any rank starts, so no two ranks build them at
once.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback

import torch


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device of local rank ``rank``: ``cuda:{rank % device_count}``
    where ``device`` names CUDA (it raises when no card is present), else
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(fn, rank: int, world: int, backend: str, device: str,
               run_dir: str, timeout_s: float, args) -> None:
    """The body of one rank's process: join the group, run ``fn``, write
    its result (or the traceback) under ``run_dir``."""
    import torch.distributed as dist
    try:
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        store = dist.FileStore(os.path.join(run_dir, "store"), world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, world, dev, *args)
        with open(os.path.join(run_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        # written before the group's teardown, which may wait on the others
        with open(os.path.join(run_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _prepare(device) -> None:
    """Build what the ranks load, once, here."""
    from .. import _host
    _host.ensure_native_packer()
    if torch.device(device).type == "cuda":
        from ..kernels import _build
        _build.library()


def run_ranks(fn, world: int, backend: str, *args, device="cuda",
              timeout: float = 900.0) -> list:
    """``fn(rank, world, device, *args)`` in ``world`` processes joined by
    a ``backend`` ("nccl" or "gloo") process group; returns each rank's
    result, in rank order.  ``fn`` and ``args`` are pickled (``fn`` by its
    import path).  Raises ``RuntimeError`` with the traceback of every rank
    that failed, and ``TimeoutError`` when the ranks outlast ``timeout``
    seconds; either way no rank is left running."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    _prepare(device)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="sparsetpu_ranks_") as run_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, str(device),
                                   run_dir, timeout, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            _join(procs, time.monotonic() + timeout, run_dir)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(world):
            with open(os.path.join(run_dir, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _join(procs, deadline: float, run_dir: str) -> None:
    """Wait for every rank; on the first failure give the others a moment
    to report theirs, then raise with every traceback written."""
    grace = None
    while any(p.is_alive() for p in procs):
        if grace is None and any(p.exitcode not in (None, 0)
                                 for p in procs):
            grace = time.monotonic() + 2.0
        if grace is not None and time.monotonic() > grace:
            break
        if time.monotonic() > deadline:
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            raise TimeoutError(f"ranks {alive} still running at the time "
                               f"limit")
        time.sleep(0.05)
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(run_dir, f"error_{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r} failed:\n{f.read()}")
        elif p.exitcode not in (None, 0):
            errors.append(f"rank {r} exited with code {p.exitcode}")
    if errors:
        raise RuntimeError("\n".join(errors))
