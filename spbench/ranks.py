"""A cell on N > 1 cards: this process is rank 0 on the first card and
spawns ranks 1..N-1, rank r on card r, each a fresh interpreter
(``python -m spbench.ranks``, given its part as JSON).  All N
join one process group (NCCL on cards, gloo on the CPU) over a
``FileStore`` in a temporary directory, with no network port, and each
runs ``harness.run_cell`` with the same seed (the rank contract is in
``harness.py``'s docstring).

This is the benchmark's own launcher, apart from the port's
(``sparsetpu_torch.dist.launch``), so that a change to the port cannot
move it.

Failure is bounded.  A rank that raises writes its traceback and exits;
rank 0's watch then prints every failed rank's traceback, stops the
others and ends this process with code 1, with no result line.  A run
still going ``seconds + SETUP_ALLOWANCE_S`` after the process started (a
rank hung, say in a collective whose partner died) ends the same way,
after each rank has printed its stack.  A rank is killed by the kernel
when rank 0's process ends (``PR_SET_PDEATHSIG``), so none outlives it.
"""

from __future__ import annotations

import ctypes
import datetime
import faulthandler
import json
import os
import shutil
import signal
import sys
import subprocess
import tempfile
import threading
import time
import traceback

import torch

from spbench import harness
from spbench.imports import forbidden_loaded

# The seconds a run on ranks may take besides its window: set-up with a
# first build of the kernels in each rank, the trace and the judge.  A
# sound run ends well inside it; past it the run is taken for hung.
SETUP_ALLOWANCE_S = 600.0
# once a rank has failed, how long the others get to report theirs
GRACE_S = 2.0
PR_SET_PDEATHSIG = 1


def _device(kind: str, rank: int, world: int) -> torch.device:
    if kind == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        return dev
    # CPU ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    return torch.device("cpu")


def _join_group(rank: int, world: int, dev: torch.device, run_dir: str,
                timeout_s: float):
    store = torch.distributed.FileStore(os.path.join(run_dir, "store"),
                                        world)
    torch.distributed.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", store=store, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return torch.distributed.group.WORLD


def _write(path: str, text: str) -> None:
    with open(f"{path}.tmp", "w") as f:
        f.write(text)
    os.replace(f"{path}.tmp", path)


def _rank_main(parent: int, rank: int, world: int, device: str, cell: str,
               seed: int, seconds: float, trace: bool, root: str,
               run_dir: str, timeout_s: float) -> None:
    """The body of rank ``rank`` > 0: its part of the run, then its card's
    name, memory peak and forbidden modules in ``rank_<r>.json``; on an
    exception its traceback in ``error_<r>.txt`` and exit code 1."""
    try:
        ctypes.CDLL(None).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:     # rank 0 ended before the prctl
        os._exit(1)
    # rank 0 asks for this rank's stack where the run outlasts its limit
    stack = open(os.path.join(run_dir, f"stack_{rank}.txt"), "w")
    faulthandler.register(signal.SIGUSR1, file=stack, all_threads=True)
    try:
        dev = _device(device, rank, world)
        group = _join_group(rank, world, dev, run_dir, timeout_s)
        part = harness.run_cell(cell, seed, seconds, trace,
                                time.perf_counter(), device=dev, root=root,
                                group=group)
        part["forbidden"] = forbidden_loaded()
        _write(os.path.join(run_dir, f"rank_{rank}.json"), json.dumps(part))
        torch.distributed.destroy_process_group()
    except BaseException:
        _write(os.path.join(run_dir, f"error_{rank}.txt"),
               traceback.format_exc())
        os._exit(1)


class _Ranks:
    """Ranks 1..N-1 as rank 0 sees them: their processes, the directory
    they report to, and the run's time limit, kept by a watching thread
    while rank 0 runs its own part."""

    def __init__(self, procs, run_dir: str, deadline: float, limit_s: float):
        self.procs, self.run_dir = procs, run_dir
        self.deadline, self.limit_s = deadline, limit_s
        self.lock, self.done = threading.Lock(), False
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def _check(self) -> None:
        """Abort where a rank has failed or the time limit has passed."""
        if any(p.poll() not in (None, 0) for p in self.procs):
            self.abort("")
        if time.perf_counter() > self.deadline:
            self.abort(f"spbench: the ranks outlasted the run's limit of "
                       f"{self.limit_s:.0f} s (--seconds and the set-up "
                       f"allowance); each rank's stack follows\n", hung=True)

    def _watch(self) -> None:
        while not self.stop.wait(0.05):
            self._check()

    def abort(self, head: str, hung: bool = False) -> None:
        """Print ``head`` and every failed rank's traceback, stop every
        rank and end this process with code 1."""
        with self.lock:
            if self.done:
                return
            sys.stderr.write(head)
            sys.stderr.flush()
            if hung:
                for p in self.procs:
                    if p.poll() is None:
                        p.send_signal(signal.SIGUSR1)
                sys.stderr.write("rank 0's stack:\n")
                sys.stderr.flush()
                faulthandler.dump_traceback(all_threads=True)
                time.sleep(1.0)
                for r in range(1, len(self.procs) + 1):
                    path = os.path.join(self.run_dir, f"stack_{r}.txt")
                    if os.path.exists(path):
                        with open(path) as f:
                            sys.stderr.write(f"rank {r}'s stack:\n"
                                             f"{f.read()}")
            else:
                grace = time.monotonic() + GRACE_S
                while (time.monotonic() < grace
                       and any(p.poll() is None for p in self.procs)):
                    time.sleep(0.05)
            for r, p in enumerate(self.procs, 1):
                path = os.path.join(self.run_dir, f"error_{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        sys.stderr.write(f"rank {r} failed:\n{f.read()}")
                elif p.poll() not in (None, 0):
                    sys.stderr.write(f"rank {r} exited with code "
                                     f"{p.returncode}\n")
            for p in self.procs:
                p.kill()
                p.wait(10)
            shutil.rmtree(self.run_dir, ignore_errors=True)
            sys.stderr.flush()
            os._exit(1)

    def finish(self) -> list:
        """Wait for every rank to end; their reports, in rank order."""
        while not all(p.poll() == 0 for p in self.procs):
            self._check()
            time.sleep(0.05)
        with self.lock:
            self.done = True
        self.stop.set()
        self.thread.join()
        parts = []
        for r in range(1, len(self.procs) + 1):
            with open(os.path.join(self.run_dir, f"rank_{r}.json")) as f:
                parts.append(json.load(f))
        return parts


def launch(cell: str, seed: int, seconds: float, trace: bool,
           t_start: float, world: int, device: str = "cuda",
           root: str = harness.ROOT,
           allowance_s=None) -> tuple:
    """Run ``cell`` on ``world`` ranks; returns rank 0's result and the
    other ranks' reports (``kind``, ``memory_peak_bytes``, ``forbidden``).
    Ends this process with code 1 where a rank fails, or where the run is
    still going ``seconds + allowance_s`` (``SETUP_ALLOWANCE_S`` where
    None) after ``t_start``, the process's start on the
    ``time.perf_counter`` clock."""
    if allowance_s is None:
        allowance_s = SETUP_ALLOWANCE_S
    limit_s = seconds + allowance_s
    run_dir = tempfile.mkdtemp(prefix="spbench_ranks_")
    try:
        procs = [subprocess.Popen([sys.executable, "-m", "spbench.ranks",
                                   json.dumps([os.getpid(), r, world, device,
                                               cell, seed, seconds, trace,
                                               root, run_dir, limit_s])])
                 for r in range(1, world)]
        ranks = _Ranks(procs, run_dir, t_start + limit_s, limit_s)
        try:
            dev = _device(device, 0, world)
            group = _join_group(0, world, dev, run_dir, limit_s)
            result = harness.run_cell(cell, seed, seconds, trace, t_start,
                                      device=dev, root=root, group=group)
            torch.distributed.destroy_process_group()
        except BaseException:
            ranks.abort(f"rank 0 failed:\n{traceback.format_exc()}")
        return result, ranks.finish()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def merge_devices(result: dict, parts: list) -> list:
    """Rank 0's device block made the run's: ``count`` the ranks,
    ``memory_peak_bytes`` the fullest card's, ``per_rank_peak_bytes`` each
    rank's.  Returns the ranks' card names where they differ, else []."""
    dev = result["device"]
    names = [dev["kind"], *(p["kind"] for p in parts)]
    peaks = [dev["memory_peak_bytes"],
             *(p["memory_peak_bytes"] for p in parts)]
    dev.update(count=len(peaks), memory_peak_bytes=max(peaks),
               per_rank_peak_bytes=peaks)
    return names if len(set(names)) > 1 else []


if __name__ == "__main__":
    _rank_main(*json.loads(sys.argv[1]))
