#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparsetpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels and the native packer from this checkout, then:

  fused regimes    small fused packs covering every layout regime of the
                   fused kernel (Q 1/2/4/8, SGRP > 1, fin_direct, spills,
                   non-uniform and empty trailing slabs);
  classic regimes  small GStream packs covering the classic device: the
                   window forward at G = 1 and G > 1 with Q = 2 and 8, the
                   per-tile-base forward with and without slab, the flat
                   final alone and summed past 8 sections, the legacy final
                   behind F levels, final spills, the segment-sum route and
                   bf16 values.  Each kernel runs beside its plain PyTorch
                   version on the card and y is checked against the gold;
  headline         the bench.py matrix (200k x 100k, 50 nnz/row, ~10M nnz):
                   the fused main path;
  wide x           a stand-in with the shape and nnz of SNAP/roadNet-CA
                   (1,971,281^2, 5,533,214 nnz, uniform random columns):
                   x too wide for the fused layout, so the whole matrix goes
                   to the classic device;
  web graph        the webbase-1M stand-in (1,000,005^2, power-law rows):
                   the heavy-row hybrid, light rows fused and heavy rows on a
                   classic device with F levels and the legacy final;
  per-tile base    the roadNet-CA stand-in packed with GL pinned
                   (``pack_gstream(G=8, GL=2)``) through ``GStreamDevice``.

Each main path (the last four) is driven once through the entry points a
user calls, with every kernel's launch count set to 0 just before and read
just after; a kernel of that path that did not launch fails the run.  Then
each of its kernels is compared with its plain version on the path's own
inputs and timed with CUDA events beside its bound (the bytes it must move
at the card's HBM rate) and one PyTorch call computing the same function.
Every check raises on failure, so any failed phase exits non-zero.  The
line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Needs one card; exits non-zero without
one, and without the repository beside it.
"""

import json
import os
import sys
import time
import zlib

import numpy as np

# kernel vs plain version: the same f32 terms summed in another order
RTOL = 1e-5
ATOL_REL = 1e-5          # times max(1, max|y|)
F32_TFLOPS = 67.0        # H100 SXM, f32 outside the tensor cores (data sheet)

# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "fused_spmv": ("sparsetpu_torch/csrc/fused_spmv.cu",
                   "sparsetpu/kernels/spmv_fused.py:48"),
    "gstream_spmv_window": ("sparsetpu_torch/csrc/gstream_spmv.cu",
                            "sparsetpu/kernels/spmv_pallas.py:63"),
    "gstream_spmv_tile_base": ("sparsetpu_torch/csrc/gstream_spmv.cu",
                               "sparsetpu/kernels/spmv_pallas.py:101"),
    "gstream_final_flat": ("sparsetpu_torch/csrc/gstream_final.cu",
                           "sparsetpu/kernels/spmv_pallas.py:767"),
    "gstream_final_legacy": ("sparsetpu_torch/csrc/gstream_final.cu",
                             "sparsetpu/kernels/spmv_pallas.py:196"),
}


def _agree(yk, yr) -> float:
    """Max abs difference of kernel and plain outputs; raises when it is
    outside RTOL / ATOL_REL."""
    diff = (yk - yr).abs()
    atol = ATOL_REL * max(1.0, yr.abs().max().item() if yr.numel() else 0.0)
    bad = int((diff > atol + RTOL * yr.abs()).sum().item())
    err = diff.max().item() if diff.numel() else 0.0
    if bad or not bool(yk.isfinite().all()):
        raise RuntimeError(f"kernel disagrees with its plain version: "
                           f"{bad} elements, max abs err {err:.3e}")
    return err


def _gold_errors(h, m, x, y, dtype=np.float32) -> int:
    atol, rtol = h.default_tolerance(dtype, m.nr_nzeros / max(m.nr_rows, 1))
    errors = h.verification(h.spmv_gold(m, x), y, diff_thres=atol,
                            rel_thres=rtol)
    if errors:
        raise RuntimeError(f"{errors} elements disagree with spmv_gold")
    return errors


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


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


def _heavy_rows(h):
    """Power-law rows up to 20000 nnz: the classic device pre-reduces them
    with F levels before the legacy final."""
    rng = np.random.default_rng(7)
    r, c = 300, 20000
    nnz_per_row = np.minimum((rng.pareto(1.0, r) * 30).astype(int) + 1, c)
    rows = np.repeat(np.arange(r), nnz_per_row)
    cols = np.concatenate(
        [rng.choice(c, k, replace=False) for k in nnz_per_row])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return h.CSRMatrix.from_coo(rows, cols, vals, r, c)


def road_net_ca(h, nr=1_971_281, nnz=5_533_214, seed=2):
    """SNAP/roadNet-CA's shape and nnz with uniform random columns and
    rows, f32 values; vectorised (no per-row loop)."""
    rng = np.random.default_rng(seed)
    keys = np.zeros(0, np.int64)
    while keys.size < nnz:
        more = rng.integers(0, nr * nr, nnz - keys.size + nnz // 100 + 16,
                            dtype=np.int64)
        keys = np.unique(np.concatenate([keys, more]))
    keys = np.sort(rng.choice(keys, nnz, replace=False))
    rows, cols = keys // nr, keys % nr
    ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=nr))])
    vals = rng.standard_normal(nnz).astype(np.float32)
    return h.CSRMatrix(ptr, cols, vals, nr, nr)


def webbase_1m(h, nr=1_000_005, nnz=3_105_536):
    """The webbase-1M stand-in of the suite: its shape and density, power-law
    rows, the suite's per-name seed (1234 ^ crc32 of the name)."""
    return h.random_csr(nr, nr, density=nnz / (nr * float(nr)),
                        seed=1234 ^ (zlib.crc32(b"webbase-1M") & 0xFFFF),
                        dtype=np.float32, powerlaw=True)


class Smoke:
    """The port's modules, the device, and what the run has measured."""

    def __init__(self, device, hbm: float):
        import torch
        import sparsetpu_torch as st
        from sparsetpu_torch import _host
        from sparsetpu_torch.bench.harness import call_ms, stream_ms
        from sparsetpu_torch.kernels import spmv_fused, spmv_gstream
        from sparsetpu_torch.pack import final_levels
        self.torch, self.st, self.h = torch, st, _host
        self.fused, self.sg, self.fl = spmv_fused, spmv_gstream, final_levels
        self._call_ms, self._stream_ms = call_ms, stream_ms
        self.dev = torch.device(device)
        self.hbm = hbm
        self.records = {}                 # name -> the JSON entry
        self.launches = {k: 0 for k in KERNELS}

    # -- timing -------------------------------------------------------------
    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def call_ms(self, fn, repeats=50):
        return self._call_ms(fn, self.dev, repeats=repeats)

    # -- launch counts --------------------------------------------------------
    def _zero_counts(self):
        self.fused.fused_spmv.launches = 0
        self.sg.gstream_chunk_sums.launches.clear()
        self.sg.final_gather.launches.clear()

    def _counts(self):
        f = self.sg.gstream_chunk_sums.launches
        w = self.sg.final_gather.launches
        return {"fused_spmv": self.fused.fused_spmv.launches,
                "gstream_spmv_window": f["window"],
                "gstream_spmv_tile_base": f["tile_base"],
                "gstream_final_flat": w["flat"],
                "gstream_final_legacy": w["legacy"]}

    def kernels_of(self, d):
        """The kernels a device's ``spmv`` launches."""
        if isinstance(d, self.fused.FusedDevice):
            return {"fused_spmv"}
        ks = {"gstream_spmv_tile_base" if d.stream.GL
              else "gstream_spmv_window"}
        if len(d.flevels):
            ks.add("gstream_spmv_window")
        if d.final is not None:
            ks |= {"gstream_final_flat" if lvl.v2 else "gstream_final_legacy"
                   for lvl in getattr(d.final, "levels", [d.final])}
        return ks

    def drive(self, tag, fn, expected):
        """The main path: counts set to 0 just before ``fn``, read just
        after; every expected kernel must have launched."""
        self._zero_counts()
        t0 = time.perf_counter()
        y = fn()
        self.sync()
        dt = time.perf_counter() - t0
        counts = self._counts()
        if self.dev.type == "cuda":
            missing = sorted(k for k in expected if counts[k] < 1)
            if missing:
                raise RuntimeError(f"{tag}: the main path did not launch "
                                   f"{missing} (counts {counts})")
        for k, v in counts.items():
            self.launches[k] += v
        print(f"{tag}: main path in {dt:.2f} s, launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        return y

    # -- per-kernel measurement ------------------------------------------------
    def record(self, name, tag, err, ms, plain_ms, nbytes, flops, lib_ms):
        byte_ms = nbytes / (self.hbm * 1e9) * 1e3
        op_ms = flops / (F32_TFLOPS * 1e12) * 1e3
        bound_ms = max(byte_ms, op_ms)
        by = "bytes" if byte_ms >= op_ms else "operations"
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        print(f"  {name} [{tag}]: kernel vs plain max abs {err:.3e} | "
              f"kernel {ms:.4f} ms a call, plain {plain_ms:.4f} ms, library "
              f"call {lib} | bound {nbytes} B, {flops} flop -> "
              f"{bound_ms:.4f} ms ({by}), kernel at {bound_ms / ms:.3f} of "
              f"it", flush=True)
        if name not in self.records:
            src, rep = KERNELS[name]
            self.records[name] = {
                "name": name, "route": "cuda", "source": src,
                "replaces": rep, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                "library_ms": lib_ms}

    def library_spmv(self, rows, cols, vals, shape, x, ref):
        """One sparse product computing the same function (cuSPARSE on the
        card), checked against the kernel's plain output; its time."""
        torch = self.torch
        a = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                    shape).coalesce().to_sparse_csr()
        y = a @ x
        _agree(y[:ref.numel()].view_as(ref), ref)
        return self.call_ms(lambda: a @ x)

    def forward(self, fwd, x2, tag, measure=True):
        """The forward kernel of one pack vs its plain version; measured
        (time, bound, library call) when ``measure``.  Returns the plain
        chunk sums."""
        torch, sg = self.torch, self.sg
        ref = sg.gstream_chunk_sums_reference
        ck, cr = fwd(x2), fwd(x2, ref)
        self.sync()
        err = _agree(ck, cr)
        if not measure:
            return cr
        name = ("gstream_spmv_tile_base" if fwd.GL
                else "gstream_spmv_window")
        ms = self.call_ms(lambda: fwd(x2))
        plain_ms = self.call_ms(lambda: fwd(x2, ref), repeats=10)
        idx, ok = sg.forward_gather_index(fwd.meta16, fwd.step_window,
                                          T=fwd.T, G=fwd.G, GL=fwd.GL,
                                          tile_base=fwd.tile_base)
        vals = fwd.values.view(idx.shape).float()
        keep = ok & (vals != 0)
        d = self.dev
        out = ((torch.arange(idx.shape[0], device=d).view(-1, 1, 1) * fwd.P
                + torch.arange(8, device=d).view(1, -1, 1) // (8 // fwd.P))
               * 128 + torch.arange(128, device=d).view(1, 1, -1))
        lib_ms = self.library_spmv(
            out.expand_as(idx)[keep], idx[keep], vals[keep],
            (cr.numel(), x2.numel()), x2.reshape(-1), cr.reshape(-1))
        nb = _nbytes(fwd.values, fwd.meta16, fwd.step_window, fwd.tile_base,
                     x2, ck)
        self.record(name, tag, err, ms, plain_ms, nb,
                    2 * fwd.values.numel(), lib_ms)
        return cr

    def final(self, final, vec, nr_rows, tag, measure=True):
        """A final level (all its flat levels, for a multi final) vs its
        plain version on the position vector ``vec``."""
        torch, sg = self.torch, self.sg
        ref = sg.final_gather_reference
        levels = list(getattr(final, "levels", [final]))
        gk = [lvl.grid(vec) for lvl in levels]
        gr = [lvl.grid(vec, ref) for lvl in levels]
        self.sync()
        err = max(_agree(a, b) for a, b in zip(gk, gr))
        if not measure:
            return
        name = "gstream_final_flat" if levels[0].v2 else \
            "gstream_final_legacy"
        ms = self.call_ms(lambda: [lvl.grid(vec) for lvl in levels])
        plain_ms = self.call_ms(lambda: [lvl.grid(vec, ref)
                                         for lvl in levels], repeats=10)
        rows, cols = [], []
        for lvl in levels:
            idx, ok = sg.final_gather_index(
                lvl.step_meta, lvl.tile_bases, lvl.cells, lvl.route,
                tps=lvl.tps, G=lvl.G, nw=lvl.nw, GS=lvl.GS, v2=lvl.v2)
            o = lvl.step_meta[:, lvl.nw + 1].long().view(-1, 1, 1, 1)
            t = torch.arange(lvl.tps, device=self.dev).view(1, -1, 1, 1)
            lane = torch.arange(128, device=self.dev).view(1, 1, 1, -1)
            out = ((o * lvl.tps + t) * 128 + lane).expand_as(idx)
            rows.append(out[ok])
            cols.append(idx[ok])
        n_pos = max(lvl.x_pad_rows for lvl in levels) * 128
        flat = vec.reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, max(0, n_pos - flat.numel())))
        n_out = max(lvl.nt_pad for lvl in levels) * 128
        total = sum(g.reshape(-1)[:nr_rows] for g in gr)
        rows, cols = torch.cat(rows), torch.cat(cols)
        lib_ms = self.library_spmv(
            rows, cols, torch.ones(rows.numel(), device=self.dev),
            (n_out, n_pos), flat[:n_pos], total)
        nb = n_pos * 4 + n_out * 4 + sum(
            _nbytes(lvl.step_meta, lvl.tile_bases, lvl.inst_start,
                    lvl.cells, lvl.route) for lvl in levels)
        self.record(name, tag, err, ms, plain_ms, nb,
                    sum(lvl.cells.numel() for lvl in levels), lib_ms)

    def gstream(self, d, x, tag, measure=True):
        """Every kernel of one classic device vs its plain version."""
        sg = self.sg
        x2 = d.prepare_x(x)
        cr = self.forward(d.stream, x2, tag, measure)
        # the F levels (the forward kernel on incidence packs) extend the
        # position vector: through the kernel and through the plain version
        vec = d.positions(cr, sg.gstream_chunk_sums_reference)
        vk = d.positions(cr)
        self.sync()
        if len(d.flevels):
            _agree(vk, vec)
        if d.final is not None:
            self.final(d.final, vec, d.meta.nr_rows, tag, measure)

    def fused_kernel(self, dev, x2, tag, lib_ms):
        """The fused kernel vs its plain version, timed in turns."""
        fused = self.fused
        ref = fused.fused_spmv_reference
        yk, yr = dev.blocks(x2), dev.blocks(x2, kernel=ref)
        self.sync()
        err = _agree(yk, yr)
        runs = {"kernel": [], "plain": []}
        for name, fn in (("plain", lambda: dev.blocks(x2, kernel=ref)),
                         ("kernel", lambda: dev.blocks(x2)),
                         ("kernel", lambda: dev.blocks(x2)),
                         ("plain", lambda: dev.blocks(x2, kernel=ref))):
            runs[name].append((self.call_ms(fn),
                               self._stream_ms(fn, self.dev)
                               if self.dev.type == "cuda" else np.nan))
        ms = {k: float(np.mean([a for a, _ in v])) for k, v in runs.items()}
        back = {k: float(np.mean([b for _, b in v])) for k, v in runs.items()}
        print(f"  fused_spmv [{tag}]: back to back kernel {back['kernel']:.4f}"
              f" ms, plain {back['plain']:.4f} ms", flush=True)
        nb = _nbytes(*(getattr(dev, n) for n, _ in fused._KERNEL_INPUTS),
                     x2, yk)
        self.record("fused_spmv", tag, err, ms["kernel"], ms["plain"], nb,
                    2 * dev.values.numel(), lib_ms)

    def whole_call(self, sm, m, xt, tag):
        """``sm @ x`` a call beside one cuSPARSE CSR SpMV of the matrix;
        returns the library call's time."""
        torch = self.torch
        ms = self.call_ms(lambda: sm @ xt, repeats=20)
        a = torch.sparse_csr_tensor(
            torch.from_numpy(m.row_ptr.astype(np.int64)),
            torch.from_numpy(m.col_ind.astype(np.int64)),
            torch.from_numpy(m.values), (m.nr_rows, m.nr_cols)).to(self.dev)
        lib_ms = self.call_ms(lambda: a @ xt, repeats=20)
        print(f"  {tag}: SparseMatrix @ x {ms:.4f} ms a call "
              f"({m.nr_nzeros / ms / 1e6:.2f} Gnnz/s) | torch.sparse_csr "
              f"@ x (cuSPARSE) {lib_ms:.4f} ms "
              f"({m.nr_nzeros / lib_ms / 1e6:.2f} Gnnz/s)", flush=True)
        return lib_ms

    def profile(self, tag, fn, calls=10):
        """Device time by kernel over ``calls`` calls of ``fn`` (a
        torch.profiler trace), and the share of the window the card was
        busy.  Reporting only: a profiler that fails prints why."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        if self.dev.type != "cuda":
            return
        try:
            fn()
            self.sync()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            rows = sorted(((e.self_device_time_total / calls, e.count / calls,
                            e.key) for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA
                           and e.self_device_time_total > 0), reverse=True)
        except Exception as e:          # noqa: BLE001
            print(f"  profile [{tag}]: not available ({e!r})", flush=True)
            return
        busy = sum(r[0] for r in rows)
        print(f"  profile [{tag}]: {busy:.1f} us of device time a call, "
              f"busy {busy * calls / wall_us:.3f} of the window "
              f"({calls} calls, host clock)", flush=True)
        for us, n, key in rows[:8]:
            print(f"    {us:9.1f} us  x{n:g}  {key[:90]}", flush=True)

    def describe(self, d) -> str:
        if isinstance(d, self.fused.FusedDevice):
            p = d.meta
            return (f"fused Q={p.Q} T={p.T} GLW={p.GLW} GX={p.GX} "
                    f"steps={p.n_steps} slabs={p.n_slabs} SGRP={p.SGRP} "
                    f"fin_direct={p.fin_direct} spills={p.spill_row.size} "
                    f"fill={p.fill_factor:.4f} stream={p.storage_bytes()} B")
        p = d.meta
        out = (f"classic G={p.G} Q={p.Q} GL={p.GL} T={p.tiles_per_step} "
               f"steps={p.n_steps} sections={p.sections.shape[0]} "
               f"ordered={p.ordered} fill={p.fill_factor:.4f} "
               f"stream={p.storage_bytes()} B; "
               f"F levels (G, steps)="
               f"{[(f.G, f.step_window.numel()) for f in d.flevels]}")
        fin = d.plan.final
        if fin is None:
            return out + "; final: none (segment-sum)"
        levels = getattr(fin, "levels", [fin])
        kinds = ", ".join(
            f"{type(lvl).__name__}(tps={lvl.tiles_per_step} "
            + (f"GL_f={lvl.GL_f} nwin={lvl.nwin} GS={lvl.GS}"
               if hasattr(lvl, "GL_f") else f"G={lvl.G} nw={lvl.nw}")
            + f" instances={lvl.step_meta.shape[0]} "
            f"spills={lvl.spill_pos.size})" for lvl in levels)
        return out + f"; final {type(fin).__name__}: {kinds}"


def fused_regimes(s):
    """Kernel vs plain version and vs gold on one small pack per regime."""
    h, fused = s.h, s.fused
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
        dev = fused.FusedDevice.from_packed(p, s.dev)
        x = np.random.default_rng(9).standard_normal(m.nr_cols)
        x2 = dev.prepare_x(x)
        yk = dev.blocks(x2)
        yr = dev.blocks(x2, kernel=fused.fused_spmv_reference)
        s.sync()
        err = _agree(yk, yr)
        rel = err / max(yr.abs().max().item(), 1e-30)
        y = dev.spmv(x2, x_is_packed=True).cpu().numpy()
        _gold_errors(h, m, x, y)
        print(f"fused regime {tag}: Q={p.Q} T={p.T} steps={p.n_steps} "
              f"SGRP={p.SGRP} fin_direct={p.fin_direct} slabs={p.n_slabs} "
              f"spills={p.spill_row.size} | kernel vs plain max abs "
              f"{err:.3e} rel {rel:.3e} | vs spmv_gold 0 errors",
              flush=True)


def classic_regimes(s):
    """Each classic kernel vs its plain version, and y vs the gold, on one
    small pack per regime."""
    torch, h, sg, fl = s.torch, s.h, s.sg, s.fl
    rc = h.random_csr
    f32 = np.float32

    def final_kinds(d):
        fin = d.plan.final
        return {type(lvl).__name__
                for lvl in getattr(fin, "levels", [fin])} if fin else set()

    def spills(d):
        fin = d.plan.final
        return sum(lvl.spill_pos.size
                   for lvl in getattr(fin, "levels", [fin])) if fin else 0

    cases = [
        ("window G=1 Q=8", rc(3000, 900, 0.02, seed=1, dtype=f32),
         dict(G=1, Q=8), None, lambda d: d.meta.G == 1),
        ("window G=4 Q=2, final spills", rc(5000, 5000, 0.01, seed=0,
                                           dtype=f32),
         dict(G=4, Q=2), None,
         lambda d: d.meta.G == 4 and d.meta.Q == 2 and spills(d) > 0),
        ("window G=8 Q=8, flat final", rc(3000, 20_000, 0.002, seed=7,
                                          dtype=f32),
         dict(G=8, Q=8, shuffle_lanes=False), None,
         lambda d: final_kinds(d) == {"_FinalLevelV2"}
         and not hasattr(d.plan.final, "levels")),
        ("tile base GL=2", rc(4000, 9000, 0.01, seed=3, dtype=f32),
         dict(G=8, Q=4, GL=2), None, lambda d: d.meta.GL == 2),
        ("tile base GL=2 slab=256", rc(4000, 9000, 0.01, seed=3, dtype=f32),
         dict(G=8, Q=4, GL=2, slab=256, shuffle_lanes=False), None,
         lambda d: d.meta.GL == 2 and d.meta.ordered),
        ("flat finals past 8 sections", rc(2000, 400_000, 0.0002, seed=4,
                                           dtype=f32), {}, None,
         lambda d: hasattr(d.plan.final, "levels")),
        ("F levels + legacy final", _heavy_rows(h), {}, None,
         lambda d: len(d.flevels) >= 1
         and final_kinds(d) == {"_FinalLevel"}),
        ("bf16 values", rc(1000, 2000, 0.02, seed=71, dtype=f32), {},
         torch.bfloat16, lambda d: d.dtype == torch.bfloat16),
    ]
    for tag, m, kw, vdt, regime in cases:
        d = sg.GStreamDevice(h.pack_gstream(m, **kw), s.dev, vdt)
        if not regime(d):
            raise RuntimeError(f"{tag}: the pack does not hit its regime: "
                               f"{s.describe(d)}")
        x = np.random.default_rng(9).standard_normal(m.nr_cols)
        s.gstream(d, x, tag, measure=False)
        y = d.spmv(x).cpu().numpy()
        _gold_errors(h, m, x, y, "bfloat16" if vdt is not None else f32)
        print(f"classic regime {tag}: {s.describe(d)} | kernels agree with "
              f"their plain versions | vs spmv_gold 0 errors", flush=True)

    # no final can be built: the segment-sum route (its build is stubbed to
    # fail for this one device, as a pathological placement makes it)
    m = rc(3000, 6000, 0.004, seed=5, dtype=f32)
    builds = fl._FinalLevel.build, fl._FinalLevelV2.build
    fl._FinalLevel.build = fl._FinalLevelV2.build = classmethod(
        lambda cls, *a, **k: None)
    try:
        d = sg.GStreamDevice(h.pack_gstream(m), s.dev)
    finally:
        fl._FinalLevel.build, fl._FinalLevelV2.build = builds
    if d.final is not None:
        raise RuntimeError("segment-sum route: a final was built")
    x = np.random.default_rng(9).standard_normal(m.nr_cols)
    s.gstream(d, x, "segment-sum", measure=False)
    _gold_errors(h, m, x, d.spmv(x).cpu().numpy())
    print(f"classic regime segment-sum route: {s.describe(d)} | vs "
          f"spmv_gold 0 errors", flush=True)


def main_path(s, tag, make, run_devices, t0):
    """Build a matrix, pack it with ``run_devices`` (a ``SparseMatrix`` or a
    ``GStreamDevice``, and the devices behind it), drive its ``spmv`` once
    as the main path and check y against the gold."""
    torch, h = s.torch, s.h
    m = make()
    t_gen = time.perf_counter() - t0
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    xt = torch.as_tensor(x, dtype=torch.float32, device=s.dev)
    t1 = time.perf_counter()
    sm, devices = run_devices(m)
    t_pack = time.perf_counter() - t1
    expected = set().union(*(s.kernels_of(d) for d in devices))
    y = s.drive(tag, lambda: sm.spmv(xt), expected)
    if tuple(y.shape) != (m.nr_rows,) or not bool(y.isfinite().all()):
        raise RuntimeError(f"{tag}: bad y, shape {tuple(y.shape)}")
    _gold_errors(h, m, x, y.cpu().numpy())
    print(f"{tag}: {m.nr_rows}x{m.nr_cols} nnz={m.nr_nzeros}, matrix in "
          f"{t_gen:.1f} s, pack + upload in {t_pack:.1f} s, 0 errors vs "
          f"spmv_gold", flush=True)
    for d in devices:
        print(f"  device: {s.describe(d)}", flush=True)
    return m, x, xt, sm, devices


def run(device, hbm: float, small: bool = False):
    """Every phase on ``device``; ``small`` cuts the full-size matrices (a
    rehearsal of the control flow, not a measurement)."""
    s = Smoke(device, hbm)
    st, h, fused, sg = s.st, s.h, s.fused, s.sg

    t0 = time.perf_counter()
    fused_regimes(s)
    classic_regimes(s)
    print(f"phase regimes: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- headline: the fused main path (bench.py's matrix)
    t0 = time.perf_counter()

    def fused_only(m):
        sm = st.SparseMatrix(m, device=s.dev)
        if sm.fused_device is None or sm.heavy_device is not None:
            raise RuntimeError("headline: expected the fused device")
        return sm, [sm.fused_device]

    m, x, xt, sm, _ = main_path(
        s, "headline",
        lambda: h.random_csr(20_000 if small else 200_000, 100_000,
                             density=0.0005, seed=1, dtype=np.float32),
        fused_only, t0)
    lib_ms = s.whole_call(sm, m, xt, "headline")
    s.profile("headline", lambda: sm @ xt)
    s.fused_kernel(sm.fused_device, sm.prepare_x(x), "headline", lib_ms)
    print(f"phase headline: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- wide x: roadNet-CA's shape, wholly classic
    t0 = time.perf_counter()

    def classic_only(m):
        sm = st.SparseMatrix(m, device=s.dev)
        if not isinstance(sm.device_module, sg.GStreamDevice):
            raise RuntimeError("wide x: expected the classic device")
        return sm, [sm.device_module]

    road = (lambda: road_net_ca(h, nr=1_971_281, nnz=20_000)) if small \
        else (lambda: road_net_ca(h))
    m, x, xt, sm, _ = main_path(s, "wide x (roadNet-CA)", road,
                                classic_only, t0)
    s.whole_call(sm, m, xt, "wide x (roadNet-CA)")
    s.profile("wide x (roadNet-CA)", lambda: sm @ xt)
    s.gstream(sm.device_module, xt, "wide x (roadNet-CA)")
    print(f"phase wide x: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- per-tile base: the same matrix with GL pinned
    t0 = time.perf_counter()

    def pinned(mat):
        d = st.GStreamDevice(h.pack_gstream(mat, G=8, GL=2), s.dev)
        return d, [d]

    _, _, xt2, pin, devs = main_path(s, "per-tile base (roadNet-CA, GL=2)",
                                     lambda: m, pinned, t0)
    print(f"  per-tile base: GStreamDevice.spmv "
          f"{s.call_ms(lambda: pin.spmv(xt2), repeats=20):.4f} ms a call",
          flush=True)
    s.profile("per-tile base (roadNet-CA, GL=2)", lambda: pin.spmv(xt2))
    s.gstream(devs[0], xt2, "per-tile base (roadNet-CA, GL=2)")
    print(f"phase per-tile base: {time.perf_counter() - t0:.1f} s",
          flush=True)
    del m, sm, pin, devs

    # ---- web graph: the heavy-row hybrid
    t0 = time.perf_counter()

    def hybrid(mat):
        sm = st.SparseMatrix(mat, device=s.dev)
        if sm.fused_device is None or sm.heavy_device is None:
            raise RuntimeError("web graph: expected the heavy-row hybrid")
        return sm, [sm.fused_device, sm.heavy_device]

    web = (lambda: webbase_1m(h, nr=100_000, nnz=310_000)) if small \
        else (lambda: webbase_1m(h))
    m, x, xt, sm, _ = main_path(s, "web graph (webbase-1M)", web, hybrid, t0)
    print(f"  heavy rows: {sm.heavy_device.meta.nr_rows} holding "
          f"{sm.heavy_device.meta.nr_nzeros} nnz", flush=True)
    s.whole_call(sm, m, xt, "web graph (webbase-1M)")
    s.profile("web graph (webbase-1M)", lambda: sm @ xt)
    light = sm.fused_device
    lx = light.prepare_x(xt)
    yk, yr = light.blocks(lx), light.blocks(
        lx, kernel=fused.fused_spmv_reference)
    s.sync()
    print(f"  fused_spmv [web graph, light rows]: kernel vs plain max abs "
          f"{_agree(yk, yr):.3e}", flush=True)
    s.gstream(sm.heavy_device, xt, "web graph (webbase-1M), heavy rows")
    print(f"phase web graph: {time.perf_counter() - t0:.1f} s", flush=True)

    missing = sorted(set(KERNELS) - set(s.records))
    if missing:
        raise RuntimeError(f"kernels never measured on a main path: "
                           f"{missing}")
    return [dict(s.records[k], launches=s.launches[k]) for k in KERNELS]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sparsetpu_torch import _host as h
    from sparsetpu_torch.kernels import _build
    from sparsetpu_torch.utils.device import card_line, hbm_gbps

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # ---- build: the CUDA library and the native packer
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"built {os.path.relpath(lib.path)} in {lib.build_s:.1f} s",
          flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  nvcc:", line.strip())
    h.ensure_native_packer()
    print(f"phase build (CUDA library + native packer): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    hbm = hbm_gbps("cuda")
    kernels = run("cuda", hbm)
    print(f"[{card}, HBM {hbm:.0f} GB/s]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
