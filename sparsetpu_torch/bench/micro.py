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
import contextlib
import ctypes
import time

import numpy as np
import torch

from ..kernels._build import check, library
from ..utils.config import LANES, SUBLANES as CHUNK
from ..utils.device import CUDA, require_device

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


def ladder_index(stage, val, idx, cell, xw, base=None, *, G: int = 1,
                 T: int = 16) -> tuple:
    """The x element each slot of a gather stage (dual, tilebase, window,
    window-smem) reads: (flat index into xw, reads x), both (n_tiles, 8,
    128).  A cell past its window or a base past xw reads 0."""
    n = _check(stage, val, idx, cell, xw, base, G, T)
    if STAGES[stage] < STAGES["dual"]:
        raise ValueError(f"stage {stage!r} gathers no x")
    j = idx.view(n, CHUNK, LANES).long() & 127
    c = torch.gather(cell.view(n, CHUNK, LANES).long(), 2, j)
    if stage == "tilebase":
        b = base.long().view(n, 1, 1)
        ok = ((b >= 0) & ((b + 1) * CHUNK <= xw.shape[0])).expand_as(c)
        r = b * CHUNK + (c & 7)
    else:
        groups = G if stage.startswith("window") else 1
        ok, r = (c >= 0) & ((c >> 3) < groups), c
    return torch.where(ok, r * LANES + j, 0), ok


def ladder_reference(stage, val, idx, cell, xw, base=None, *, G: int = 1,
                     T: int = 16) -> torch.Tensor:
    """Plain PyTorch version of one stage over all tiles at once: (n_tiles,
    128) f32.  A cell past its window or a base past xw reads 0."""
    n = _check(stage, val, idx, cell, xw, base, G, T)
    v = val.view(n, CHUNK, LANES)
    if stage == "stream":
        return v.sum(1) * xw[0, 0]
    if stage == "lane":
        j = idx.view(n, CHUNK, LANES).long() & 127
        return torch.gather(v, 2, j).sum(1) * xw[0, 0]
    i, ok = ladder_index(stage, val, idx, cell, xw, base, G=G, T=T)
    return (v * torch.where(ok, xw.reshape(-1)[i], 0.0)).sum(1)


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


def timeit(f, n: int = 20, warmup: int = 3, *, device=CUDA) -> float:
    """Minimum time of one call of ``f`` in ms over ``n`` calls, after
    ``warmup`` (counterpart of ``sparsetpu/bench/micro.py:26-34``, which
    gives seconds): CUDA events around each call, the calls queued back to
    back, on a CUDA device; ``time.perf_counter`` on the CPU."""
    dev = require_device(device)
    for _ in range(warmup):
        f()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        events = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(dev)
        return min(s.elapsed_time(e) for s, e in events)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        f()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def timeit_chained(make_call, xw, n: int = 1024, n_base: int = 16,
                   reps: int = 5) -> float:
    """Time of one call of ``make_call(xw)`` in ms by the chained
    differential loop (counterpart of ``sparsetpu/bench/micro.py:37-78``,
    which gives seconds): ``n`` and ``n_base`` calls queued back to back,
    each loop timed whole, and the median over ``reps`` of (t_n -
    t_n_base) / (n - n_base).  The difference takes out the loop's fixed
    cost.  On the card the loops are timed with CUDA events on the current
    stream; on the CPU with ``time.perf_counter``.  The JAX loop carries
    each call's output into the next call's input so that no dispatch is
    served from a cache; a CUDA launch always runs, so the calls here are
    independent and nothing but ``make_call`` is timed."""
    if n <= n_base:
        raise ValueError(f"n={n} must exceed n_base={n_base}")
    cuda = isinstance(xw, torch.Tensor) and xw.device.type == "cuda"

    def loop(k):
        if not cuda:
            t0 = time.perf_counter()
            for _ in range(k):
                make_call(xw)
            return (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            make_call(xw)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    with torch.cuda.device(xw.device) if cuda else contextlib.nullcontext():
        loop(n_base)                              # warm
        diffs = sorted((loop(n) - loop(n_base)) / (n - n_base)
                       for _ in range(reps))
    return max(diffs[len(diffs) // 2], 1e-9)


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


def bench_ladder(n_tiles=None, tiles_per_step: int = 16,
                 G_list=(1, 2, 4, 8, 16, 32), verbose: bool = True,
                 chain_n=None, *, device=CUDA):
    """Returns {stage: (ms, effective GB/s, Gslot/s)} for n_tiles (8, 128)
    f32 tiles (default ``LADDER_TILES`` on the card, 64 on the CPU, where
    the times are those of the plain versions and mean nothing).  Times
    are ``timeit``'s, the minimum of 20 calls; with ``chain_n`` they are
    ``timeit_chained``'s over ``chain_n`` calls, as the JAX ladder times
    each stage (its default 1024)."""
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
    timeit(call(*runs[0][1:4]), n=1, warmup=200, device=dev)
    results = {}
    for name, stage, cell, G, extra in runs:
        fn = call(stage, cell, G)
        ms = (timeit(fn, device=dev) if chain_n is None else
              timeit_chained(lambda _: fn(), xw, chain_n))
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
