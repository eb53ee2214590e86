"""One run of one cell: set-up, the measured window, an optional traced
slice, the comparison with the reference, and the result's line.

Everything is found by name, so a later cell, configuration, traffic kind
or metric is a new file and no edit here:

  workloads/<cell>.json    the cell: its configuration, its traffic mix,
                           the cards it needs and the limit of each number
                           compared with the reference
  configs/<name>.json      a deployment: its source, sizes, real type and
                           the generator that makes its matrix
  generators/<name>.py     ``generate(cfg, rng) -> Csr``
  traffic/<mix>.json       a traffic mix: the parameters of one kind
  traffic/<kind>.py        the code of a kind: ``prepare``, ``window``,
                           ``trace``, ``outputs``, ``judge``
  metrics/<name>.py        one metric: ``KIND`` (end_to_end or per_layer),
                           ``UNIT``, ``read(run)``, None where the run has
                           nothing for it to read
  layouts/<name>.py        where a configuration names ``"layout"``:
                           ``build(run, csr)``, what the traffic kind's
                           ``prepare`` takes as ``sm``, in place of the
                           one-card ``SparseMatrix``

A cell whose ``chips`` is N > 1 runs as N ranks, one process a card
(``ranks.py``): ``python -m spbench`` is rank 0 on ``cuda:0`` and spawns
ranks 1..N-1, rank r on ``cuda:r``, all joined in one process group (NCCL
on cards, gloo on the CPU).  Its configuration has to name a layout: it
is refused at start-up otherwise.  Every rank runs ``run_cell`` with the
same seed: it generates the matrix, calls the layout's ``build`` (which
cuts the rank's part by ``run.rank``, ``run.world`` and ``run.group``),
and the kind's ``prepare``, ``window``, ``trace`` (if traced) and
``outputs``, since each may hold collectives.  Rank 0 alone calls
``judge`` and builds the result's line, so the metric readers read rank
0's ``Run``: its spans, counts and traces.  With N > 1, ``Run.sync``
synchronises the card and then waits at a barrier of all ranks, so every
``run.phase`` ends on all ranks together, and a kind agrees on the
window's end by ``run.agree``; ``timing.traced`` takes ``agree=run.agree``
so that the ranks retry a trace together.  ``setup_s`` is rank 0's, from
the launching process's start.  With ``chips`` 1 there is no process, no
group and no barrier: ``run.group`` is None and ``run.agree`` returns its
flag.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import sparsetpu_torch as port

from . import timing

ROOT = os.path.dirname(os.path.abspath(__file__))
KINDS = ("end_to_end", "per_layer")


def load_json(folder: str, name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, folder, f"{name}.json")) as f:
        return json.load(f)


def load_module(folder: str, name: str, root: str = ROOT):
    """``<root>/<folder>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(root, folder, f"{name}.py")
    mod_name = f"spbench_{folder}_{name}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers(root: str = ROOT) -> Dict[str, object]:
    """Every reader under ``metrics/``, by metric name."""
    folder = os.path.join(root, "metrics")
    return {f[:-3]: load_module("metrics", f[:-3], root)
            for f in sorted(os.listdir(folder))
            if f.endswith(".py") and not f.startswith("_")}


@dataclasses.dataclass
class Run:
    """What one run measured, for the metric readers."""
    cell: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    device_name: str
    nr_rows: int = 0
    nr_cols: int = 0
    nnz: int = 0
    value_bytes: int = 0
    setup_s: float = 0.0
    window_s: float = 0.0
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    held_ms: Optional[float] = None
    traces: Dict[str, timing.Trace] = dataclasses.field(default_factory=dict)
    spmv_kernels: frozenset = frozenset()
    rank: int = 0
    world: int = 1
    group: object = None

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    @contextlib.contextmanager
    def phase(self, name: str):
        """A span of the block, ended by a sync."""
        t = time.perf_counter()
        yield
        self.sync()
        self.span(name, time.perf_counter() - t)

    def sync(self) -> None:
        """The card's queue drained; with ranks, then a barrier of all."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.group is not None:
            ids = ({"device_ids": [self.device.index]}
                   if self.device.type == "cuda" else {})
            torch.distributed.barrier(group=self.group, **ids)

    def agree(self, flag: bool) -> bool:
        """True on every rank where ``flag`` is true on all of them (an
        all-reduce); ``flag`` itself with one rank."""
        if self.group is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], device=self.device)
        torch.distributed.all_reduce(t, torch.distributed.ReduceOp.MIN,
                                     group=self.group)
        return bool(t.item())


def seeded_rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use of the seed (0: the matrix, 1: which answers
    are kept for the comparison, 2: the vectors); any whole number is a
    seed."""
    return np.random.default_rng([seed % (1 << 64), stream])


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, root: str = ROOT,
             group=None) -> dict:
    """Run ``cell`` once and return its result as a dict (the line the
    benchmark prints).  ``t_start`` is the process's start on the
    ``time.perf_counter`` clock; ``device`` defaults to the first card.
    ``group``: the process group of a run on ranks, None on one card; a
    rank past 0 returns only its card's name and memory peak."""
    wl = load_json("workloads", cell, root)
    cfg = load_json("configs", wl["config"], root)
    mix = load_json("traffic", wl["traffic"], root)
    kind = load_module("traffic", mix["kind"], root)
    gen = load_module("generators", cfg["generator"], root)
    layout = (load_module("layouts", cfg["layout"], root)
              if "layout" in cfg else None)
    dev = torch.device(device or "cuda:0")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    run = Run(cell, cfg, mix, seed, float(seconds), bool(trace), dev, name)
    if group is not None:
        run.group = group
        run.rank = torch.distributed.get_rank(group)
        run.world = torch.distributed.get_world_size(group)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    with run.phase("generate"):
        csr = gen.generate(cfg, seeded_rng(seed, 0))
    run.nr_rows, run.nr_cols, run.nnz = csr.nr_rows, csr.nr_cols, csr.nnz
    run.value_bytes = csr.values.dtype.itemsize
    with run.phase("pack_upload"):
        if layout is not None:
            sm = layout.build(run, csr)
        else:
            sm = port.SparseMatrix(port.CSRMatrix(
                csr.row_ptr, csr.col_ind, csr.values, csr.nr_rows,
                csr.nr_cols), device=dev)
    with run.phase("prepare"):
        state = kind.prepare(run, sm, csr, seeded_rng(seed, 2))
    run.setup_s = time.perf_counter() - t_start

    kind.window(run, state, seeded_rng(seed, 1))
    if trace:
        with run.phase("trace"):
            kind.trace(run, state)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    outs = kind.outputs(state)
    del state, sm
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with run.phase("judge"):
        readings = kind.judge(run, csr, outs) if run.rank == 0 else None
    if run.rank:
        return {"kind": name, "memory_peak_bytes": int(peak)}
    checks, failed = {}, 0
    for key, limit in wl["limits"].items():
        values = readings.get(key) or [float("inf")]
        failed += sum(1 for v in values if not v <= limit)
        checks[key] = {"value": max(values), "limit": limit}
    correct = failed == 0

    want = "per_layer" if trace else "end_to_end"
    metrics = {}
    for mname, reader in metric_readers(root).items():
        if reader.KIND == want:
            value = reader.read(run)
            if value is not None:
                metrics[mname] = {"value": float(value), "unit": reader.UNIT}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": name, "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct,
              "attempted": int(run.counts.get("attempted", 0)),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    main_trace = next(iter(run.traces.values()), None)
    if main_trace is not None:
        lo, hi = main_trace.window_us
        device_info["busy_s"] = timing.busy_us(main_trace.device, lo,
                                               hi) * 1e-6
        device_info["window_s"] = (hi - lo) * 1e-6
        result["trace_whole"] = main_trace.whole
        result["breakdown"] = {
            "device_ops": timing.top((e.name, e.end_us - e.start_us)
                                     for e in main_trace.device),
            "idle_gaps": timing.top(timing.idle_gaps(main_trace))}
    result["size"] = {"rows": run.nr_rows, "cols": run.nr_cols,
                      "nnz": run.nnz}
    result["phases_s"] = {k: run.spans[k][0] for k in
                          ("generate", "pack_upload", "prepare", "trace",
                           "judge") if k in run.spans}
    result["phases_s"]["setup_s"] = run.setup_s
    result["checks"] = checks
    return result
