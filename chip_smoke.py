#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparsetpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels and the native packer from this checkout, then:

  regimes   small fused packs covering every layout regime the kernel
            handles (Q 1/2/4/8, SGRP > 1, fin_direct, spills, non-uniform
            and empty trailing slabs); each runs through the kernel and
            through its plain PyTorch version on the card, and y is checked
            against the CPU gold.
  headline  the bench.py matrix (200k x 100k, 50 nnz/row, f32, ~10M nnz)
            through ``SparseMatrix(m, device="cuda") @ x``, with the
            kernels' launch counts read around that call, y verified
            against the CPU gold, and the kernel and its plain version
            compared and timed with CUDA events.

Every check raises on failure, so any failed phase exits non-zero.  The
line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Needs one card; exits non-zero without
one, and without the repository beside it.
"""

import json
import os
import sys
import time

import numpy as np

# kernel vs plain version: the same f32 terms summed in another order
RTOL = 1e-5
ATOL_REL = 1e-5          # times max(1, max|y|)


def _agree(yk, yr) -> float:
    """Max abs difference of kernel and plain outputs; raises when it is
    outside RTOL / ATOL_REL."""
    diff = (yk - yr).abs()
    atol = ATOL_REL * max(1.0, yr.abs().max().item())
    bad = int((diff > atol + RTOL * yr.abs()).sum().item())
    err = diff.max().item() if diff.numel() else 0.0
    if bad or not bool(yk.isfinite().all()):
        raise RuntimeError(f"kernel disagrees with its plain version: "
                           f"{bad} elements, max abs err {err:.3e}")
    return err


def _gold_errors(h, m, x, y) -> int:
    atol, rtol = h.default_tolerance(np.float32,
                                     m.nr_nzeros / max(m.nr_rows, 1))
    errors = h.verification(h.spmv_gold(m, x), y, diff_thres=atol,
                            rel_thres=rtol)
    if errors:
        raise RuntimeError(f"{errors} elements disagree with spmv_gold")
    return errors


def _empty_trailing_slabs(h):
    """Nonzeros in the first 1000 rows only, so the last slabs own no nnz
    and must still be zeroed."""
    rng = np.random.default_rng(3)
    nr, nc = 35_000, 4000
    rows = np.repeat(np.arange(1000), 5)
    cols = rng.integers(0, nc, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    order = np.lexsort((cols, rows))
    ptr = np.zeros(nr + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    return h.CSRMatrix(np.cumsum(ptr), cols[order], vals[order], nr, nc)


def regimes(h, fused):
    """Kernel vs plain version and vs gold on one small pack per regime."""
    import torch
    rc = h.random_csr
    f32 = np.float32
    cases = [
        ("Q=1 fin_direct", rc(30_000, 120_000, 1.05 / 120_000, seed=6,
                              dtype=f32), dict(Q=1),
         lambda p: p.Q == 1 and p.fin_direct == 1),
        ("Q=1 two-stage SGRP=4", rc(20_000, 90_000, 5.6 / 90_000, seed=3,
                                    dtype=f32), dict(Q=1, sgrp=4),
         lambda p: p.Q == 1 and p.SGRP == 4 and p.fin_direct == 0),
        ("Q=2", rc(3000, 20_000, 3 / 20_000, seed=1, dtype=f32), dict(Q=2),
         lambda p: p.Q == 2),
        ("Q=4", rc(800, 5000, 0.01, seed=7, dtype=f32), dict(Q=4),
         lambda p: p.Q == 4),
        ("Q=8", rc(12_000, 10_000, 0.002, seed=11, dtype=f32), dict(Q=8),
         lambda p: p.Q == 8),
        ("spills + non-uniform slabs (NumPy engine)",
         rc(2000, 20_000, 0.002, seed=1, dtype=f32), dict(use_native=False),
         lambda p: p.spill_row.size > 0 and not fused.slabs_uniform(p)),
        ("empty trailing slabs", _empty_trailing_slabs(h), {},
         lambda p: p.n_slabs >= 2 and np.diff(p.slab_bounds)[-1] > 0),
    ]
    for tag, m, kw, regime in cases:
        p = h.pack_fused(m, **kw)
        if p is None or not regime(p):
            raise RuntimeError(f"{tag}: the pack does not hit its regime")
        dev = fused.FusedDevice.from_packed(p, "cuda")
        x = np.random.default_rng(9).standard_normal(m.nr_cols)
        x2 = dev.prepare_x(x)
        yk = dev.blocks(x2)
        yr = dev.blocks(x2, kernel=fused.fused_spmv_reference)
        torch.cuda.synchronize()
        err = _agree(yk, yr)
        rel = err / max(yr.abs().max().item(), 1e-30)
        y = dev.spmv(x2, x_is_packed=True).cpu().numpy()
        _gold_errors(h, m, x, y)
        print(f"regime {tag}: Q={p.Q} T={p.T} steps={p.n_steps} "
              f"SGRP={p.SGRP} fin_direct={p.fin_direct} slabs={p.n_slabs} "
              f"spills={p.spill_row.size} | kernel vs plain max abs "
              f"{err:.3e} rel {rel:.3e} | vs spmv_gold 0 errors",
              flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import sparsetpu_torch as st
    from sparsetpu_torch import _host as h
    from sparsetpu_torch.bench.harness import call_ms, stream_ms
    from sparsetpu_torch.kernels import _build
    from sparsetpu_torch.kernels import spmv_fused as fused
    from sparsetpu_torch.utils.device import card_line, hbm_gbps

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # ---- build: the CUDA library and the native packer
    lib = _build.library()
    print(f"built {os.path.relpath(lib.path)} in {lib.build_s:.1f} s",
          flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  nvcc:", line.strip())
    t0 = time.perf_counter()
    h.ensure_native_packer()
    print(f"pack engine: native C++ packer "
          f"(ready in {time.perf_counter() - t0:.1f} s)", flush=True)

    regimes(h, fused)

    # ---- headline: the main path as a user drives it
    m = h.random_csr(200_000, 100_000, density=0.0005, seed=1,
                     dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    fused.fused_spmv.launches = 0
    t0 = time.perf_counter()
    sm = st.SparseMatrix(m, device="cuda")
    y = sm @ x
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fused.fused_spmv.launches
    if launches < 1:
        raise RuntimeError("the main path did not launch the fused kernel")
    if tuple(y.shape) != (m.nr_rows,) or not bool(y.isfinite().all()):
        raise RuntimeError(f"bad y: shape {tuple(y.shape)}")
    _gold_errors(h, m, x, y.cpu().numpy())
    p = sm.packed
    print(f"headline {m.nr_rows}x{m.nr_cols} nnz={m.nr_nzeros}: pack + "
          f"upload + first y in {first_s:.2f} s, launches={launches}, "
          f"0 errors vs spmv_gold | layout Q={p.Q} T={p.T} GLW={p.GLW} "
          f"GX={p.GX} steps={p.n_steps} slabs={p.n_slabs} OBp={p.OBp} "
          f"SGRP={p.SGRP} F1_max={p.F1_max} F2_max={p.F2_max} "
          f"fin_direct={p.fin_direct} spills={p.spill_row.size} "
          f"fill={p.fill_factor:.4f} stream={p.storage_bytes()} B",
          flush=True)

    dev = sm.fused_device
    x2 = sm.prepare_x(x)
    yk = dev.blocks(x2)
    yr = dev.blocks(x2, kernel=fused.fused_spmv_reference)
    max_abs = _agree(yk, yr)

    def kernel():
        return dev.blocks(x2)

    def plain():
        return dev.blocks(x2, kernel=fused.fused_spmv_reference)

    # in turns on one card: plain, kernel, kernel, plain
    runs = {"kernel": [], "plain": []}
    for name, fn in (("plain", plain), ("kernel", kernel),
                     ("kernel", kernel), ("plain", plain)):
        runs[name].append((call_ms(fn, "cuda", repeats=50),
                           stream_ms(fn, "cuda")))
    spmv_ms = call_ms(lambda: sm.spmv_packed_x(x2), "cuda", repeats=50)
    hbm = hbm_gbps("cuda")
    nbytes = p.storage_bytes()
    ms = {}
    for name, pairs in runs.items():
        ms[name] = float(np.mean([a for a, _ in pairs]))
        back = float(np.mean([b for _, b in pairs]))
        print(f"{name}: {ms[name]:.4f} ms a call (median of 50, CUDA "
              f"events), {back:.4f} ms back to back -> "
              f"{m.nr_nzeros / ms[name] / 1e6:.2f} Gnnz/s, roofline_frac "
              f"{nbytes / (hbm * 1e9) / (ms[name] / 1e3):.4f} "
              f"({nbytes / (hbm * 1e9) / (back / 1e3):.4f} back to back), "
              f"fill {p.fill_factor:.4f} [{card}, HBM {hbm:.0f} GB/s]",
              flush=True)
    print(f"spmv (kernel + reassembly): {spmv_ms:.4f} ms a call -> "
          f"{m.nr_nzeros / spmv_ms / 1e6:.2f} Gnnz/s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_spmv", "route": "cuda",
        "source": "sparsetpu_torch/csrc/fused_spmv.cu",
        "replaces": "sparsetpu/kernels/spmv_fused.py:48",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms["kernel"], "plain_ms": ms["plain"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
