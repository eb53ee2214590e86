"""Benchmark harness: the reference's main.cpp measurement protocol on the
port (counterpart of ``sparsetpu/bench/harness.py``).

Times on a CUDA device come from CUDA events and times on the CPU from
``time.perf_counter``; a CPU run reports no roofline (``nan``): the HBM
bound is a property of the card.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import _host
from ..api.api import SparseMatrix
from ..utils.device import hbm_gbps, require_device


@dataclasses.dataclass
class BenchResult:
    matrix: str
    nr_rows: int
    nr_cols: int
    nr_nzeros: int
    gold_ms: float
    scan_ms: float
    pack_ms: float
    compile_ms: float
    kernel_ms: float
    finish_ms: float
    total_ms: float
    data_mb: float
    storage_overhead: float
    fill_factor: float
    gnnz_s: float
    gflop_s: float
    roofline_frac: float
    verify_errors: int
    layout_g: int = 0
    layout_q: int = 0

    def report(self) -> str:
        status = "PASS" if self.verify_errors == 0 else "FAIL"
        return "\n".join([
            f"Matrix {self.matrix}: {self.nr_rows} x {self.nr_cols}, "
            f"{self.nr_nzeros} non-zeros",
            f"SW (gold) execution time {self.gold_ms:.3f} msec",
            f"Scan matrix time {self.scan_ms:.3f} msec",
            f"Matrix repack time {self.pack_ms:.3f} msec",
            f"Compile + upload time {self.compile_ms:.3f} msec",
            f"HW (kernel) execution time {self.kernel_ms:.3f} msec",
            f"Results accumulation time {self.finish_ms:.3f} msec",
            f"Total SpMV time {self.total_ms:.3f} msec",
            f"Data transferred {self.data_mb:.2f} MB",
            f"Storage overhead vs CSR {100 * (self.storage_overhead - 1):+.1f}% "
            f"(fill factor {self.fill_factor:.3f})",
            f"Throughput {self.gnnz_s:.2f} Gnnz/s, {self.gflop_s:.2f} GFLOP/s "
            f"({100 * self.roofline_frac:.1f}% of HBM roofline)",
            f"Verification: {status} ({self.verify_errors} errors)",
        ])


def call_ms(fn, device, repeats: int = 50) -> float:
    """Median time of one call of ``fn`` in ms, after 5 warm-up calls: CUDA
    events around each call on a CUDA device (host launch gaps included,
    as a caller sees them), ``time.perf_counter`` on the CPU."""
    dev = require_device(device)
    for _ in range(5):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        events = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(dev)
        times = [s.elapsed_time(e) for s, e in events]
    else:
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def stream_ms(fn, device, calls: int = 100) -> float:
    """Device time per call in ms with calls back to back: a spin on the
    stream holds the card while the host queues all ``calls``, so host
    launch gaps drop out of the CUDA-event interval."""
    dev = require_device(device)
    if dev.type != "cuda":
        raise ValueError("stream_ms times a CUDA device")
    fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(calls * 1_000_000)    # ~0.5 ms a call at ~2 GHz
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / calls


def bench_spmv(matrix, name: str = "random", config=None, repeats: int = 50,
               backend: str = "auto", autotune: bool = False, *, device,
               timer=None) -> BenchResult:
    """Pack ``matrix`` on ``device``, multiply a random x, verify against
    the CPU gold and time the SpMV and its kernel.

    ``autotune=True`` times candidate (G, Q) layouts on the device and
    benchmarks the fastest (``api.autotune.autotune_pack``, its candidate
    clock ``timer``), for the auto and fused backends in f32, as
    ``sparsetpu/bench/harness.py:118-120``."""
    dev = require_device(device)
    ms = {}

    def phase(key, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms[key] = (time.perf_counter() - t0) * 1e3
        return out

    x = np.random.default_rng(0).uniform(0.0, 1.0, matrix.nr_cols)
    y_gold = phase("gold", lambda: _host.spmv_gold(matrix, x))
    cfg = config or _host.SpmvConfig(dtype=matrix.dtype)
    phase("scan", lambda: _host.scan_matrix(matrix, cfg))
    if autotune and backend in ("auto", "fused") and not cfg.is_double:
        from ..api.autotune import autotune_pack
        sm = phase("pack", lambda: autotune_pack(matrix, device=dev,
                                                 timer=timer))
    else:
        sm = phase("pack", lambda: SparseMatrix(matrix, cfg, backend=backend,
                                                device=dev))

    def first_call():       # builds the kernels' library on first use
        xp = sm.prepare_x(x)
        return xp, sm.spmv_packed_x(xp)
    xp, y = phase("compile", first_call)
    y = y.cpu().numpy()

    total_ms = call_ms(lambda: sm.spmv_packed_x(xp), dev, repeats)
    if sm.fused_device is not None:
        # the hybrid keeps x unpacked (its heavy rows' device pads it
        # another way): the fused kernel of its light rows takes its own
        xf = xp if sm.heavy_device is None else \
            sm.fused_device.prepare_x(x)
        kernel_ms = call_ms(lambda: sm.fused_device.blocks(xf), dev, repeats)
        finish_ms = max(total_ms - kernel_ms, 0.0)
    else:
        kernel_ms, finish_ms = total_ms, 0.0

    atol, rtol = _host.default_tolerance(
        np.float32 if sm.dtype == torch.float32 else np.float64,
        matrix.nr_nzeros / max(matrix.nr_rows, 1))
    errors = _host.verification(y_gold, y, diff_thres=atol, rel_thres=rtol)
    nnz = matrix.nr_nzeros
    data_mb = (sm.packed.storage_bytes() if sm.packed is not None
               else nnz * 8) / 1e6
    if sm.packed is not None and sm.dtype == torch.float64:
        # the f64 devices stream the hi + lo plane as one 8-byte value
        data_mb += sm.packed.values.nbytes / 1e6
    total_s = total_ms / 1e3
    roofline = (data_mb * 1e6 / (hbm_gbps(dev) * 1e9) / total_s
                if dev.type == "cuda" else float("nan"))
    return BenchResult(
        matrix=name, nr_rows=matrix.nr_rows, nr_cols=matrix.nr_cols,
        nr_nzeros=nnz, gold_ms=ms["gold"], scan_ms=ms["scan"],
        pack_ms=ms["pack"], compile_ms=ms["compile"], kernel_ms=kernel_ms,
        finish_ms=finish_ms, total_ms=total_ms, data_mb=data_mb,
        storage_overhead=sm.storage_overhead(),
        fill_factor=sm.fill_factor(),
        gnnz_s=nnz / total_s / 1e9, gflop_s=2 * nnz / total_s / 1e9,
        roofline_frac=roofline, verify_errors=errors,
        layout_g=(getattr(sm.packed, "GLW", None) or sm.packed.G)
        if sm.packed is not None else 0,
        layout_q=sm.packed.Q if sm.packed is not None else 0)
