"""Kernel micro-benchmarks on the card (counterpart of
``sparsetpu/bench/micro.py``): the forward kernel's stage ladder.

Stage ladder (each adds one mechanism of ``csrc/gstream_spmv.cu``):
  stream         read value tiles, sum their 8 rows      -> HBM floor
  lane           + lane gather by route
  dual           + x gather by cell from an 8-row window (G = 1)
  tilebase       + a per-tile window base
  window-G       cells over G groups, x read from global memory (L2)
  window-G-smem  the same, the window first staged in shared memory

The TPU ladder's select chains and scalar prefetch are TPU mechanisms and
are not carried over: on this card the window question is what G groups
cost read from L2 against staged in shared memory.  ``ladder_stage``
launches ``csrc/micro_ladder.cu`` for CUDA tensors (or raises) and runs
``ladder_reference``, the plain PyTorch version, for CPU tensors.

    python -m sparsetpu_torch.bench.micro [n_tiles] [tiles_per_step]
"""

from __future__ import annotations

import collections
import ctypes
import time

import numpy as np
import torch

from ..kernels._build import check, library
from ..utils.config import LANES, SUBLANES as CHUNK
from ..utils.device import require_device

STAGES = {"stream": 0, "lane": 1, "dual": 2, "tilebase": 3, "window": 4,
          "window-smem": 5}
# tiles the ladder streams on the card: 134 MB of values, with route and
# cell streams 285 MB, past the H100's 50 MB L2 (the JAX package's 8192
# tiles would mostly sit in it)
LADDER_TILES = 32768


def stage_name(stage: str, G: int = 1) -> str:
    """The ladder's key of a stage: ``window-G`` and ``window-G-smem``
    carry their G."""
    if stage == "window":
        return f"window-{G}"
    if stage == "window-smem":
        return f"window-{G}-smem"
    return stage


def _check(stage, val, idx, cell, xw, base, G, T) -> int:
    """Dtype, device, contiguity and shape checks shared by the kernel and
    its plain version; returns the tile count."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r} (one of {list(STAGES)})")
    dev = val.device
    rows = val.shape[0] if val.dim() == 2 else -1
    if rows % CHUNK or val.shape[-1] != LANES:
        raise ValueError("values must be (n_tiles*8, 128)")
    need = [("values", val, torch.float32), ("xw", xw, torch.float32)]
    if stage != "stream":
        need.append(("idx", idx, torch.int16))
    if STAGES[stage] >= STAGES["dual"]:
        need.append(("cell", cell, torch.int16))
    if stage == "tilebase":
        need.append(("base", base, torch.int32))
    for name, t, dt in need:
        if t is None or t.dtype != dt or t.device != dev or \
                not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dt} tensor on "
                             f"{dev}")
    for name, t, dt in need[2:]:
        want = (rows // CHUNK,) if name == "base" else (rows, LANES)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want}")
    groups = G if stage.startswith("window") else 1
    if xw.dim() != 2 or xw.shape[1] != LANES or \
            xw.shape[0] < CHUNK * groups or not 1 <= G <= 32 or T < 1:
        raise ValueError(f"xw must be (>= 8G, 128) with 1 <= G <= 32 "
                         f"(G={G}, T={T})")
    return rows // CHUNK


def ladder_reference(stage, val, idx, cell, xw, base=None, *, G: int = 1,
                     T: int = 16) -> torch.Tensor:
    """Plain PyTorch version of one stage over all tiles at once: (n_tiles,
    128) f32.  A cell past its window or a base past xw reads 0."""
    n = _check(stage, val, idx, cell, xw, base, G, T)
    v = val.view(n, CHUNK, LANES)
    if stage == "stream":
        return v.sum(1) * xw[0, 0]
    j = idx.view(n, CHUNK, LANES).long() & 127
    if stage == "lane":
        return torch.gather(v, 2, j).sum(1) * xw[0, 0]
    c = torch.gather(cell.view(n, CHUNK, LANES).long(), 2, j)
    if stage == "tilebase":
        b = base.long().view(n, 1, 1)
        ok = ((b >= 0) & ((b + 1) * CHUNK <= xw.shape[0])).expand_as(c)
        r = b * CHUNK + (c & 7)
    else:
        groups = G if stage.startswith("window") else 1
        ok, r = (c >= 0) & ((c >> 3) < groups), c
    xv = torch.where(ok, xw.reshape(-1)[torch.where(ok, r * LANES + j, 0)],
                     0.0)
    return (v * xv).sum(1)


def ladder_stage(stage, val, idx, cell, xw, base=None, *, G: int = 1,
                 T: int = 16) -> torch.Tensor:
    """One stage of the ladder: (n_tiles, 128) f32, T tiles a thread
    block.  On CUDA tensors it launches ``csrc/micro_ladder.cu`` on the
    current stream (or raises); on CPU tensors it runs ``ladder_reference``.
    ``ladder_stage.launches`` counts launches by ``stage_name``."""
    if val.device.type == "cpu":
        return ladder_reference(stage, val, idx, cell, xw, base, G=G, T=T)
    if val.device.type != "cuda":
        raise ValueError(f"ladder_stage: unsupported device {val.device}")
    n = _check(stage, val, idx, cell, xw, base, G, T)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    lib = library().lib
    with torch.cuda.device(val.device):
        out = torch.empty(n, LANES, device=val.device)
        stream = torch.cuda.current_stream(val.device).cuda_stream
        rc = lib.micro_ladder_launch(
            STAGES[stage], ptr(val), ptr(idx), ptr(cell), ptr(base), ptr(xw),
            ptr(out), n, T, G, xw.shape[0], ctypes.c_void_p(stream))
    check(lib, rc, f"ladder stage {stage} launch")
    ladder_stage.launches[stage_name(stage, G)] += 1
    return out


ladder_stage.launches = collections.Counter()


def timeit(fn, device, n: int = 20, warmup: int = 3) -> float:
    """Minimum time of one call of ``fn`` in ms over ``n`` calls, after
    ``warmup`` (counterpart of ``sparsetpu/bench/micro.py:26-34``): CUDA
    events around each call, the calls queued back to back, on a CUDA
    device; ``time.perf_counter`` on the CPU."""
    dev = require_device(device)
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        events = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(dev)
        return min(s.elapsed_time(e) for s, e in events)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def ladder_inputs(n_tiles: int, G_list=(1, 2, 4, 8, 16, 32),
                  tiles_per_step: int = 16, device="cuda"):
    """The ladder's inputs from ``default_rng(0)``, drawn in the JAX
    package's order (``sparsetpu/bench/micro.py:100-108, 182-183``): values
    (n_tiles*8, 128) f32, int16 routes, int16 cells < 8, the x window
    (8*32, 128) f32 and a base in [0, 32) a tile; then, for each G of
    ``G_list``, int16 cells in [0, 8G) for the window stages.  A dict of
    tensors on ``device`` (``cells``: G -> tensor)."""
    dev = require_device(device)
    if n_tiles % tiles_per_step:
        raise ValueError(f"n_tiles={n_tiles} must be a multiple of "
                         f"tiles_per_step={tiles_per_step}")
    rng = np.random.default_rng(0)
    rows = n_tiles * CHUNK

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    inp = {
        "val": up(rng.standard_normal((rows, LANES)).astype(np.float32)),
        "idx": up(rng.integers(0, LANES, size=(rows, LANES)).astype(np.int16)),
        "cell": up(rng.integers(0, CHUNK, size=(rows, LANES)).astype(
            np.int16)),
        "xw": up(rng.standard_normal((CHUNK * 32, LANES)).astype(np.float32)),
        "base": up(rng.integers(0, 32, size=(n_tiles // tiles_per_step,
                                             tiles_per_step)).astype(
            np.int32).reshape(-1)),
    }
    inp["cells"] = {G: up(rng.integers(0, CHUNK * G, size=(rows, LANES))
                          .astype(np.int16)) for G in G_list}
    return inp


def ladder_runs(inp, G_list=(1, 2, 4, 8, 16, 32)):
    """(name, stage, cell stream, G, extra bytes read) of each ladder
    stage, in the ladder's order; the extra bytes are the streams read
    beside the values (the effective-rate convention of
    ``sparsetpu/bench/micro.py:125-130``)."""
    ib, cb = inp["idx"].nbytes, inp["cell"].nbytes
    runs = [("stream", "stream", None, 1, 0), ("lane", "lane", None, 1, ib),
            ("dual", "dual", inp["cell"], 1, ib + cb),
            ("tilebase", "tilebase", inp["cell"], 1, ib + cb)]
    for G in G_list:
        for stage in ("window", "window-smem"):
            runs.append((stage_name(stage, G), stage, inp["cells"][G], G,
                         ib + cb))
    return runs


def bench_ladder(n_tiles=None, G_list=(1, 2, 4, 8, 16, 32), *,
                 device="cuda", verbose: bool = True,
                 tiles_per_step: int = 16):
    """Returns {stage: (ms, effective GB/s, Gslot/s)} for n_tiles (8, 128)
    f32 tiles (default ``LADDER_TILES`` on the card, 64 on the CPU, where
    the times are those of the plain versions and mean nothing).  Times
    are ``timeit``'s: the minimum of 20 calls."""
    dev = require_device(device)
    if n_tiles is None:
        n_tiles = LADDER_TILES if dev.type == "cuda" else 64
    T = tiles_per_step
    inp = ladder_inputs(n_tiles, G_list, T, dev)
    val, idx, xw, base = inp["val"], inp["idx"], inp["xw"], inp["base"]
    runs = ladder_runs(inp, G_list)

    def call(stage, cell, G):
        return lambda: ladder_stage(stage, val, idx, cell, xw, base, G=G,
                                    T=T)
    # warm the card first, so that the first stage is not timed at idle
    # clocks (timed cold, stream read slower than lane, which streams more)
    timeit(call(*runs[0][1:4]), dev, n=1, warmup=200)
    results = {}
    for name, stage, cell, G, extra in runs:
        ms = timeit(call(stage, cell, G), dev)
        t = ms * 1e-3
        gbs = (val.nbytes + extra) / t / 1e9
        gslot = n_tiles * 1024 / t / 1e9
        results[name] = (ms, gbs, gslot)
        if verbose:
            print(f"  {name:14s} {ms:8.4f} ms   {gbs:7.1f} GB/s eff   "
                  f"{gslot:6.1f} Gslot/s", flush=True)
    return results


if __name__ == "__main__":
    import sys
    n_tiles = int(sys.argv[1]) if len(sys.argv) > 1 else LADDER_TILES
    tps = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    print(f"n_tiles={n_tiles} ({n_tiles * 1024 / 1e6:.1f}M slots), "
          f"tiles_per_step={tps}, main stream "
          f"{n_tiles * CHUNK * LANES * 4 / 1e6:.0f} MB", flush=True)
    bench_ladder(n_tiles, tiles_per_step=tps)
