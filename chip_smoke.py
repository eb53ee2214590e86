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

and Y = A @ X (SpMM) beside them:

  regimes          every fused and classic regime above at k = 1, 3, 8,
                   plus P = 8 and shuffled (legacy-final) packs and finals
                   that spill: the fused SpMM, the k-plane forward and the
                   k-plane finals against their plain versions, Y against
                   ``spmm_gold``;
  headline k = 8   the fused SpMM (``sm @ X``), against eight ``sm @ x``
                   calls and cuSPARSE;
  headline k = 72  (the smallest multiple of 8 the fused SpMM rejects on
                   an H100): ``sm @ X`` on the lazily built classic
                   device, the k-plane forward and flat final;
  shuffled k = 8   ``spmm_gstream`` on the headline's
                   ``pack_gstream(shuffle_lanes=True)``: the k-plane
                   forward and legacy final;
  web graph k = 4  the hybrid: fused SpMM on the light rows, the k-plane
                   forward then per-plane F levels and legacy final on the
                   heavy rows;
  wide x k = 2     the k-plane forward, then per-plane flat finals.

and f64 (DOUBLE=1, native FP64 kernels) beside them:

  f64 regimes      the fused regimes with f64 values, plus the fused f64
                   kernel with its second scratch plane in a global
                   workspace; the classic f64 device at G = 1 and G > 1,
                   with a legacy final that spills, and the segment-sum
                   route; A @ X at k = 1, 3, 8 on each;
  headline f64     the headline matrix with f64 values: ``sm @ x`` on the
                   fused f64 device, and ``sm @ X`` at k = 4 (one fused f64
                   SpMV a column);
  wide x f64       the roadNet-CA stand-in with f64 values: ``sm @ x`` on
                   the classic f64 device (forward and legacy final, with
                   its spills), and ``sm @ X`` at k = 8 (the k-plane f64
                   forward, then the final a plane).

Each f64 kernel is held to its plain version at rtol 1e-12, atol 1e-12 *
max(1, max|ref|), and each f64 y (Y column by column) to the gold at the
f64 tolerance with 0 errors and at max abs error <= 1e-10 * max(1,
max|y|).

and BSR SpMV, the solvers and SpGEMM last:

  regimes          BSR SpMV on the JAX tests' banded and random shapes, a
                   ragged one and the segment-sum route (the BSR kernel and
                   the legacy final against their plain versions, y against
                   the gold); ``bicgstab``, ``gmres`` (also through a
                   breakdown) and ``power_iteration`` once each; ``sm @ m``
                   and ``sm @ sm`` at the JAX SpGEMM tests' shapes;
  BSR FEM 72^3     ``BSRDevice.spmv`` on ``csr_to_bsr(fem_poisson_3d(72))``:
                   the BSR kernel and the legacy final, beside the CSR
                   route of the same matrix and cuSPARSE;
  pcg on BSR       ``pcg`` with the Jacobi preconditioner on that operator:
                   one launch of each kernel an SpMV, b - A x recomputed in
                   f64 by the gold;
  cg_df64          ``fem_poisson_3d(72)`` in f64 through ``SparseMatrix``
                   (the fused f64 device) to 1e-10;
  SpGEMM           A @ A at the roadNet-CA stand-in cut to 2M nnz: the
                   plan once, then its numeric phase and C against scipy's
                   product, beside cuSPARSE's SpGEMM.

The BSR partials are held to their plain version at max abs error <= 1e-5
* max|plain|.

and the measurement path (``bench/micro.py``, ``pack/rates.py``,
``api/autotune.py``, ``bench/__main__.py``):

  micro ladder     ``bench_ladder`` at 32768 tiles: each stage of
                   ``csrc/micro_ladder.cu`` (stream, lane, dual, tilebase,
                   window-G from L2 and from shared memory, G = 1..32)
                   timed beside its bound, then held to ``ladder_reference``
                   on the same inputs;
  rates            ``refresh_rates`` over the 24 (G, Q) at 32768 tiles (the
                   forward kernel #3, counted as ``rates_forward``), the
                   cache in a temporary directory; #3 at two combos against
                   its plain version; the roadNet-CA stand-in packed with the
                   default chooser and with the card's table, each ``A @ x``
                   against the gold;
  autotune         ``autotune_pack`` on the roadNet-CA stand-in cut to 1M
                   nnz, each candidate's time, the pick's y against the
                   gold, then ``bench_spmv(..., autotune=True)`` on the same
                   matrix;
  bench entry      ``python -m sparsetpu_torch.bench`` in a subprocess: its
                   last line parses, value > 0, 0 gate errors.

Each main path is driven once through the entry points a user calls, with
every kernel's launch count set to 0 just before and read just after; a
kernel of that path that did not launch fails the run.  Then
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

# kernel vs plain version: the same terms summed in another order, in f32
# and in f64
RTOL = {"float32": 1e-5, "float64": 1e-12}   # atol: RTOL * max(1, max|y|)
# an f64 y against the gold: max abs error <= F64_GOLD_REL * max(1, max|y|)
F64_GOLD_REL = 1e-10
# BSR partials, kernel vs plain: max abs err <= BSR_REL * max|partials| (128
# f32 products a row summed in another order)
BSR_REL = 1e-5
# H100 SXM data sheet, outside the tensor cores: f32 67, FP64 34 TFLOP/s
TFLOPS = {"float32": 67.0, "float64": 34.0}

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
    "fused_spmm": ("sparsetpu_torch/csrc/fused_spmm.cu",
                   "sparsetpu/kernels/spmv_fused.py:144"),
    "gstream_spmm": ("sparsetpu_torch/csrc/gstream_spmm.cu",
                     "sparsetpu/kernels/spmm.py:28"),
    "gstream_final_multi_flat": ("sparsetpu_torch/csrc/gstream_final_multi.cu",
                                 "sparsetpu/kernels/spmm.py:156"),
    "gstream_final_multi_legacy": (
        "sparsetpu_torch/csrc/gstream_final_multi.cu",
        "sparsetpu/kernels/spmm.py:117"),
    "fused_spmv_f64": ("sparsetpu_torch/csrc/fused_spmv.cu",
                       "sparsetpu/kernels/spmv_fused.py:507"),
    "gstream_spmv_window_f64": ("sparsetpu_torch/csrc/gstream_spmv.cu",
                                "sparsetpu/kernels/f64emu.py:163"),
    "gstream_final_legacy_f64": ("sparsetpu_torch/csrc/gstream_final.cu",
                                 "sparsetpu/kernels/f64emu.py:196"),
    "gstream_spmm_f64": ("sparsetpu_torch/csrc/gstream_spmm.cu",
                         "sparsetpu/kernels/f64emu.py:319"),
    "bsr_partials": ("sparsetpu_torch/csrc/bsr_spmv.cu",
                     "sparsetpu/kernels/bsr.py:30"),
    "rates_forward": ("sparsetpu_torch/csrc/gstream_spmv.cu",
                      "sparsetpu/pack/rates.py:115"),
}
# the stage ladder: one entry a stage (bench_ladder's keys)
LADDER_GS = (1, 2, 4, 8, 16, 32)
LADDER_STAGES = ("stream", "lane", "dual", "tilebase") + tuple(
    f"window-{G}{kind}" for G in LADDER_GS for kind in ("", "-smem"))
for _stage in LADDER_STAGES:
    KERNELS[f"ladder_{_stage}"] = ("sparsetpu_torch/csrc/micro_ladder.cu",
                                   "sparsetpu/bench/micro.py:95")


def _real(t) -> str:
    """"float64" for a float64 tensor or array, else "float32"."""
    return "float64" if str(t.dtype).endswith("float64") else "float32"


def _agree(yk, yr) -> float:
    """Max abs difference of kernel and plain outputs; raises when it is
    outside RTOL of their real type (and RTOL * max(1, max|y|))."""
    rtol = RTOL[_real(yr)]
    diff = (yk - yr).abs()
    atol = rtol * max(1.0, yr.abs().max().item() if yr.numel() else 0.0)
    bad = int((diff > atol + rtol * yr.abs()).sum().item())
    err = diff.max().item() if diff.numel() else 0.0
    if bad or not bool(yk.isfinite().all()):
        raise RuntimeError(f"kernel disagrees with its plain version: "
                           f"{bad} elements, max abs err {err:.3e}")
    return err


def _agree_partials(pk, pr) -> float:
    """Max abs difference of BSR partials; raises past BSR_REL *
    max|plain|."""
    err = (pk - pr).abs().max().item() if pr.numel() else 0.0
    lim = BSR_REL * (pr.abs().max().item() if pr.numel() else 0.0)
    if err > lim or not bool(pk.isfinite().all()):
        raise RuntimeError(f"BSR partials disagree with the plain version: "
                           f"max abs err {err:.3e} > {lim:.3e}")
    return err


def _gold_errors(h, m, x, y, dtype=np.float32) -> int:
    """y (numpy) against ``spmv_gold`` at the tolerance of ``dtype``; an
    f64 y also at max abs error <= F64_GOLD_REL * max(1, max|y|).  Raises
    on any error."""
    gold = h.spmv_gold(m, x)
    atol, rtol = h.default_tolerance(dtype, m.nr_nzeros / max(m.nr_rows, 1))
    errors = h.verification(gold, y, diff_thres=atol, rel_thres=rtol)
    if errors:
        raise RuntimeError(f"{errors} elements disagree with spmv_gold")
    if dtype == np.float64:
        err = float(np.abs(y - gold).max()) if y.size else 0.0
        lim = F64_GOLD_REL * max(1.0, float(np.abs(y).max()) if y.size
                                 else 0.0)
        if y.dtype != np.float64 or err > lim:
            raise RuntimeError(f"f64 y ({y.dtype}) off the gold by {err:.3e}"
                               f" > {lim:.3e}")
    return errors


def _gold_errors_multi(s, m, X, Y, dtype=np.float32) -> int:
    """Y (a tensor) against ``spmm_gold`` column by column at the SpMV
    tolerance; raises on any error."""
    h = s.h
    if tuple(Y.shape) != (m.nr_rows, X.shape[1]) or \
            not bool(Y.isfinite().all()):
        raise RuntimeError(f"bad Y, shape {tuple(Y.shape)}")
    G, Y = s.spmm_gold(m, X), Y.cpu().numpy()
    atol, rtol = h.default_tolerance(dtype, m.nr_nzeros / max(m.nr_rows, 1))
    errors = sum(h.verification(G[:, j], Y[:, j], diff_thres=atol,
                                rel_thres=rtol) for j in range(X.shape[1]))
    if errors:
        raise RuntimeError(f"{errors} elements disagree with spmm_gold")
    if dtype == np.float64:
        err = float(np.abs(Y - G).max(initial=0.0))
        lim = F64_GOLD_REL * max(1.0, float(np.abs(Y).max(initial=0.0)))
        if Y.dtype != np.float64 or err > lim:
            raise RuntimeError(f"f64 Y ({Y.dtype}) off the gold by {err:.3e}"
                               f" > {lim:.3e}")
    return errors


def _X(n, k, seed):
    """(n, k) f64 from a seed: the gold sums in f64 (scipy keeps the
    operands' type), the f32 devices take X as f32."""
    return np.random.default_rng(seed).standard_normal((n, k))



def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _empty_trailing_slabs(h, dtype=np.float32):
    """Nonzeros in the first 1000 rows only, so the last slabs own no nnz
    and must still be zeroed."""
    rng = np.random.default_rng(3)
    nr, nc = 35_000, 4000
    rows = np.repeat(np.arange(1000), 5)
    cols = rng.integers(0, nc, rows.size)
    vals = rng.standard_normal(rows.size).astype(dtype)
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


def road_net_ca(h, nr=1_971_281, nnz=5_533_214, seed=2, dtype=np.float32):
    """SNAP/roadNet-CA's shape and nnz with uniform random columns and
    rows, values of ``dtype`` (f32 by default); vectorised (no per-row
    loop)."""
    rng = np.random.default_rng(seed)
    keys = np.zeros(0, np.int64)
    while keys.size < nnz:
        more = rng.integers(0, nr * nr, nnz - keys.size + nnz // 100 + 16,
                            dtype=np.int64)
        keys = np.unique(np.concatenate([keys, more]))
    keys = np.sort(rng.choice(keys, nnz, replace=False))
    rows, cols = keys // nr, keys % nr
    ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=nr))])
    vals = rng.standard_normal(nnz).astype(dtype)
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
        from sparsetpu_torch.bench import micro
        from sparsetpu_torch.bench.harness import call_ms, stream_ms
        from sparsetpu_torch.formats.gold import spmm_gold
        from sparsetpu_torch.kernels import (bsr, f64emu, spmm, spmv_fused,
                                             spmv_gstream)
        from sparsetpu_torch.pack import final_levels, rates
        self.torch, self.st, self.h = torch, st, _host
        self.micro, self.rates = micro, rates
        self.fused, self.sg, self.fl = spmv_fused, spmv_gstream, final_levels
        self.f64, self.bsr = f64emu, bsr
        self.sp, self.spmm_gold = spmm, spmm_gold
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
        self.fused.fused_spmm.launches = 0
        self.sp.gstream_chunk_sums_multi.launches = 0
        self.sp.final_gather_multi.launches.clear()
        self.fused.fused_spmv_f64.launches = 0
        self.sg.gstream_chunk_sums_f64.launches = 0
        self.sg.final_gather_f64.launches = 0
        self.sp.gstream_chunk_sums_multi_f64.launches = 0
        self.bsr.bsr_partials.launches = 0
        self.micro.ladder_stage.launches.clear()

    def _counts(self):
        f = self.sg.gstream_chunk_sums.launches
        w = self.sg.final_gather.launches
        mw = self.sp.final_gather_multi.launches
        return {"fused_spmv": self.fused.fused_spmv.launches,
                "gstream_spmv_window": f["window"],
                "gstream_spmv_tile_base": f["tile_base"],
                "gstream_final_flat": w["flat"],
                "gstream_final_legacy": w["legacy"],
                "fused_spmm": self.fused.fused_spmm.launches,
                "gstream_spmm": self.sp.gstream_chunk_sums_multi.launches,
                "gstream_final_multi_flat": mw["flat"],
                "gstream_final_multi_legacy": mw["legacy"],
                "fused_spmv_f64": self.fused.fused_spmv_f64.launches,
                "gstream_spmv_window_f64":
                    self.sg.gstream_chunk_sums_f64.launches,
                "gstream_final_legacy_f64": self.sg.final_gather_f64.launches,
                "gstream_spmm_f64":
                    self.sp.gstream_chunk_sums_multi_f64.launches,
                "bsr_partials": self.bsr.bsr_partials.launches,
                "rates_forward": 0,
                **{f"ladder_{k}": self.micro.ladder_stage.launches[k]
                   for k in LADDER_STAGES}}

    def kernels_of(self, d):
        """The kernels a device's ``spmv`` launches."""
        if d.dtype == self.torch.float64:
            if isinstance(d, self.fused.FusedDevice):
                return {"fused_spmv_f64"}
            return {"gstream_spmv_window_f64"} | (
                {"gstream_final_legacy_f64"} if d.final is not None
                else set())
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

    def spmm_kernels_of(self, d):
        """The kernels a device's SpMM launches (``spmm``,
        ``spmm_gstream`` or ``spmm_df64``)."""
        if d.dtype == self.torch.float64:
            if isinstance(d, self.fused.FusedDevice):
                return {"fused_spmv_f64"}
            return {"gstream_spmm_f64"} | (
                {"gstream_final_legacy_f64"} if d.final is not None
                else set())
        if isinstance(d, self.fused.FusedDevice):
            return {"fused_spmm"}
        ks = {"gstream_spmm"}
        if isinstance(d.final, self.sg.FinalDevice) and not len(d.flevels):
            return ks | {"gstream_final_multi_flat" if d.final.v2
                         else "gstream_final_multi_legacy"}
        if len(d.flevels):
            ks.add("gstream_spmv_window")
        if d.final is not None:
            ks |= {"gstream_final_flat" if lvl.v2 else "gstream_final_legacy"
                   for lvl in getattr(d.final, "levels", [d.final])}
        return ks

    def drive(self, tag, fn, expected, main=True, rename=None):
        """The main path: counts set to 0 just before ``fn``, read just
        after; every expected kernel must have launched.  The counts add to
        the run's totals when ``main`` (not for the regimes).  ``rename``
        moves a wrapper's count to the entry of the kernel it stands for on
        this path (the rate sweep's forward launches are ``rates_forward``)."""
        self._zero_counts()
        t0 = time.perf_counter()
        y = fn()
        self.sync()
        dt = time.perf_counter() - t0
        counts = self._counts()
        for a, b in (rename or {}).items():
            counts[b], counts[a] = counts[b] + counts[a], 0
        if self.dev.type == "cuda":
            missing = sorted(k for k in expected if counts[k] < 1)
            if missing:
                raise RuntimeError(f"{tag}: the main path did not launch "
                                   f"{missing} (counts {counts})")
        for k, v in counts.items():
            self.launches[k] += v if main else 0
        print(f"{tag}: {'main path' if main else 'run'} in {dt:.2f} s, "
              f"launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        return y

    # -- per-kernel measurement ------------------------------------------------
    def record(self, name, tag, err, ms, plain_ms, nbytes, flops, lib_ms):
        byte_ms = nbytes / (self.hbm * 1e9) * 1e3
        real = "float64" if name.endswith("_f64") else "float32"
        op_ms = flops / (TFLOPS[real] * 1e12) * 1e3
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
        _agree(y[:ref.shape[0]].view_as(ref), ref)
        return self.call_ms(lambda: a @ x)

    def _forward_incidence(self, fwd):
        """(rows, cols, values, n_out) of the forward as one sparse matrix:
        chunk-sum position by x column."""
        torch, sg, d = self.torch, self.sg, self.dev
        idx, ok = sg.forward_gather_index(fwd.meta16, fwd.step_window,
                                          T=fwd.T, G=fwd.G, GL=fwd.GL,
                                          tile_base=fwd.tile_base)
        real = torch.float64 if fwd.values.dtype == torch.float64 \
            else torch.float32
        vals = fwd.values.view(idx.shape).to(real)
        keep = ok & (vals != 0)
        out = ((torch.arange(idx.shape[0], device=d).view(-1, 1, 1) * fwd.P
                + torch.arange(8, device=d).view(1, -1, 1) // (8 // fwd.P))
               * 128 + torch.arange(128, device=d).view(1, 1, -1))
        return (out.expand_as(idx)[keep], idx[keep], vals[keep],
                idx.shape[0] * fwd.P * 128)

    def forward(self, fwd, x2, tag, measure=True):
        """The forward kernel of one pack vs its plain version; measured
        (time, bound, library call) when ``measure``.  Returns the plain
        chunk sums."""
        sg = self.sg
        ref = sg.gstream_chunk_sums_reference
        ck, cr = fwd(x2), fwd(x2, ref)
        self.sync()
        err = _agree(ck, cr)
        if not measure:
            return cr
        name = ("gstream_spmv_tile_base" if fwd.GL
                else "gstream_spmv_window")
        if x2.dtype == self.torch.float64:
            name = "gstream_spmv_window_f64"
        ms = self.call_ms(lambda: fwd(x2))
        plain_ms = self.call_ms(lambda: fwd(x2, ref), repeats=10)
        rows, cols, vals, n_out = self._forward_incidence(fwd)
        lib_ms = self.library_spmv(rows, cols, vals, (n_out, x2.numel()),
                                   x2.reshape(-1), cr.reshape(-1))
        nb = _nbytes(fwd.values, fwd.meta16, fwd.step_window, fwd.tile_base,
                     x2, ck)
        self.record(name, tag, err, ms, plain_ms, nb,
                    2 * fwd.values.numel(), lib_ms)
        return cr

    def forward_multi(self, fwd, X, tag, measure=True):
        """The k-plane forward kernel vs its plain version (X row-major
        (padded_cols, k)); measured when ``measure``.  Returns the plain
        chunk sums (n_positions, k)."""
        ref = self.sp.gstream_chunk_sums_multi_reference
        ck, cr = fwd.forward_multi(X), fwd.forward_multi(X, ref)
        self.sync()
        err = _agree(ck, cr)
        if not measure:
            return cr
        ms = self.call_ms(lambda: fwd.forward_multi(X))
        plain_ms = self.call_ms(lambda: fwd.forward_multi(X, ref), repeats=10)
        rows, cols, vals, n_out = self._forward_incidence(fwd)
        lib_ms = self.library_spmv(rows, cols, vals, (n_out, X.shape[0]), X,
                                   cr)
        nb = _nbytes(fwd.values, fwd.meta16, fwd.step_window, fwd.tile_base,
                     X, ck)
        name = ("gstream_spmm_f64" if X.dtype == self.torch.float64
                else "gstream_spmm")
        self.record(name, tag, err, ms, plain_ms, nb,
                    2 * fwd.values.numel() * X.shape[1], lib_ms)
        return cr

    def _final_incidence(self, levels):
        """(rows, cols, n_pos, n_out) of final levels as one 0/1 sparse
        matrix: y row by position."""
        torch, sg = self.torch, self.sg
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
        return (torch.cat(rows), torch.cat(cols),
                max(lvl.x_pad_rows for lvl in levels) * 128,
                max(lvl.nt_pad for lvl in levels) * 128)

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
        if vec.dtype == torch.float64:
            name = "gstream_final_legacy_f64"
        ms = self.call_ms(lambda: [lvl.grid(vec) for lvl in levels])
        plain_ms = self.call_ms(lambda: [lvl.grid(vec, ref)
                                         for lvl in levels], repeats=10)
        rows, cols, n_pos, n_out = self._final_incidence(levels)
        flat = vec.reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, max(0, n_pos - flat.numel())))
        total = sum(g.reshape(-1)[:nr_rows] for g in gr)
        lib_ms = self.library_spmv(
            rows, cols, torch.ones(rows.numel(), dtype=vec.dtype,
                                   device=self.dev),
            (n_out, n_pos), flat[:n_pos], total)
        nb = (n_pos + n_out) * vec.element_size() + sum(
            _nbytes(lvl.step_meta, lvl.tile_bases, lvl.inst_start,
                    lvl.cells, lvl.route) for lvl in levels)
        self.record(name, tag, err, ms, plain_ms, nb,
                    sum(lvl.cells.numel() for lvl in levels), lib_ms)

    def final_multi(self, lvl, vec, tag, measure=True):
        """The k-plane final kernel of one final level vs its plain version
        on the k-plane position vector ``vec`` (n_positions, k)."""
        torch = self.torch
        ref = self.sp.final_gather_multi_reference
        gk, gr = lvl.grid_multi(vec), lvl.grid_multi(vec, ref)
        self.sync()
        err = _agree(gk, gr)
        if not measure:
            return
        name = ("gstream_final_multi_flat" if lvl.v2
                else "gstream_final_multi_legacy")
        ms = self.call_ms(lambda: lvl.grid_multi(vec))
        plain_ms = self.call_ms(lambda: lvl.grid_multi(vec, ref), repeats=10)
        rows, cols, n_pos, n_out = self._final_incidence([lvl])
        k = vec.shape[1]
        X = torch.nn.functional.pad(
            vec, (0, 0, 0, max(0, n_pos - vec.shape[0])))[:n_pos]
        lib_ms = self.library_spmv(
            rows, cols, torch.ones(rows.numel(), device=self.dev),
            (n_out, n_pos), X.contiguous(), gr)
        nb = (n_pos + n_out) * k * 4 + _nbytes(
            lvl.step_meta, lvl.tile_bases, lvl.inst_start, lvl.cells,
            lvl.route)
        self.record(name, tag, err, ms, plain_ms, nb, lvl.cells.numel() * k,
                    lib_ms)

    def gstream_multi(self, d, X, tag, measure=True):
        """The k-plane kernels of one classic device's SpMM vs their plain
        versions (the per-plane finishes run the SpMV kernels, which
        ``gstream`` checks)."""
        cr = self.forward_multi(d.stream, d.prepare_x_multi(X), tag, measure)
        if isinstance(d.final, self.sg.FinalDevice) and not len(d.flevels) \
                and cr.dtype == self.torch.float32:
            self.final_multi(d.final, cr, tag, measure)

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

    def bsr_kernel(self, d, x2, tag, measure=True):
        """The BSR kernel of one ``BSRDevice`` vs its plain version;
        measured (time, bound, and ``torch.bmm`` of the blocks by their
        gathered x segments, the gather timed in) when ``measure``.
        Returns the plain partials."""
        torch = self.torch
        ref = self.bsr.bsr_partials_reference
        pk, pr = d.partials(x2), d.partials(x2, ref)
        self.sync()
        err = _agree_partials(pk, pr)
        if not measure:
            return pr
        ms = self.call_ms(lambda: d.partials(x2))
        plain_ms = self.call_ms(lambda: d.partials(x2, ref), repeats=10)
        blocks3 = d.blocks.view(d.n_blocks, 8, 128)
        bcol = d.bcol.long()

        def library():
            return torch.bmm(blocks3, x2[bcol].unsqueeze(-1))
        _agree_partials(library().view(d.n_blocks, 8), pr)
        lib_ms = self.call_ms(library)
        self.record("bsr_partials", tag, err, ms, plain_ms,
                    _nbytes(d.blocks, d.bcol, x2, pk), 2 * d.blocks.numel(),
                    lib_ms)
        return pr

    def fused_kernel(self, dev, x, tag, lib_ms, multi=False):
        """The fused SpMV (or, with ``multi``, SpMM on X row-major
        (padded_cols, k)) kernel vs its plain version, timed in turns."""
        fused = self.fused
        if multi:
            name, blocks = "fused_spmm", dev.blocks_multi
            ref, k = fused.fused_spmm_reference, x.shape[1]
        else:
            name, blocks = "fused_spmv", dev.blocks
            ref, k = fused.fused_spmv_reference, 1
            if dev.dtype == self.torch.float64:
                name = "fused_spmv_f64"
        yk, yr = blocks(x), blocks(x, ref)
        self.sync()
        err = _agree(yk, yr)
        runs = {"kernel": [], "plain": []}
        for which, fn in (("plain", lambda: blocks(x, ref)),
                          ("kernel", lambda: blocks(x)),
                          ("kernel", lambda: blocks(x)),
                          ("plain", lambda: blocks(x, ref))):
            runs[which].append((self.call_ms(fn),
                                self._stream_ms(fn, self.dev)
                                if self.dev.type == "cuda" else np.nan))
        ms = {k: float(np.mean([a for a, _ in v])) for k, v in runs.items()}
        back = {k: float(np.mean([b for _, b in v])) for k, v in runs.items()}
        print(f"  {name} [{tag}]: back to back kernel {back['kernel']:.4f}"
              f" ms, plain {back['plain']:.4f} ms", flush=True)
        stream = _nbytes(*(getattr(dev, n) for n, _ in fused._KERNEL_INPUTS))
        nb = stream + _nbytes(x, yk)
        if multi:
            p = dev.meta
            plane = (p.T * p.planes + (0 if p.fin_direct else p.F1S)) * 512
            passes = -(-k // min(k, fused.card_limits(self.dev)[1] // plane)) \
                if self.dev.type == "cuda" else 1
            design = (passes * stream + _nbytes(x, yk)) / (self.hbm * 1e6)
            print(f"  fused_spmm [{tag}]: {passes} passes over the "
                  f"{stream} B stream (plane groups of the opt-in shared "
                  f"memory): this design's bound {design:.4f} ms, the "
                  f"one-pass bound {nb / (self.hbm * 1e6):.4f} ms",
                  flush=True)
        self.record(name, tag, err, ms["kernel"], ms["plain"], nb,
                    2 * dev.values.numel() * k, lib_ms)

    def csr(self, m):
        """The matrix as a torch CSR tensor on the device (cuSPARSE)."""
        torch = self.torch
        return torch.sparse_csr_tensor(
            torch.from_numpy(m.row_ptr.astype(np.int64)),
            torch.from_numpy(m.col_ind.astype(np.int64)),
            torch.from_numpy(m.values), (m.nr_rows, m.nr_cols)).to(self.dev)

    def whole_call(self, sm, m, xt, tag):
        """``sm @ x`` a call beside one cuSPARSE CSR SpMV of the matrix;
        returns the library call's time."""
        ms = self.call_ms(lambda: sm @ xt, repeats=20)
        a = self.csr(m)
        lib_ms = self.call_ms(lambda: a @ xt, repeats=20)
        print(f"  {tag}: SparseMatrix @ x {ms:.4f} ms a call "
              f"({m.nr_nzeros / ms / 1e6:.2f} Gnnz/s) | torch.sparse_csr "
              f"@ x (cuSPARSE) {lib_ms:.4f} ms "
              f"({m.nr_nzeros / lib_ms / 1e6:.2f} Gnnz/s)", flush=True)
        return lib_ms

    def whole_call_multi(self, sm, m, Xt, tag):
        """``sm @ X`` a call beside k back-to-back ``sm @ x`` calls (one a
        column) and one cuSPARSE CSR SpMM; returns the library call's
        time.  Gnnz/s counts nnz * k."""
        k = Xt.shape[1]
        cols = [Xt[:, j].contiguous() for j in range(k)]
        a = self.csr(m)
        ms = self.call_ms(lambda: sm @ Xt, repeats=20)
        per_col = self.call_ms(lambda: [sm @ c for c in cols], repeats=10)
        lib_ms = self.call_ms(lambda: a @ Xt, repeats=20)
        work = m.nr_nzeros * k / 1e6
        print(f"  {tag}: SparseMatrix @ X (k={k}) {ms:.4f} ms a call "
              f"({work / ms:.2f} Gnnz/s) | {k} x SparseMatrix @ x "
              f"{per_col:.4f} ms ({work / per_col:.2f} Gnnz/s) | "
              f"torch.sparse_csr @ X (cuSPARSE) {lib_ms:.4f} ms "
              f"({work / lib_ms:.2f} Gnnz/s)", flush=True)
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


def _fused_cases(s, dtype):
    """(tag, matrix, pack kwargs, regime) of one small pack per regime of
    the fused kernel, with values of ``dtype`` (the f64 hi planes are the
    f32 values, so both packs hit the same regimes)."""
    h, fused = s.h, s.fused
    rc = h.random_csr
    return [
        ("Q=1 fin_direct", rc(30_000, 120_000, 1.05 / 120_000, seed=6,
                              dtype=dtype), dict(Q=1),
         lambda p: p.Q == 1 and p.fin_direct == 1),
        ("Q=1 two-stage SGRP=4", rc(20_000, 90_000, 5.6 / 90_000, seed=3,
                                    dtype=dtype), dict(Q=1, sgrp=4),
         lambda p: p.Q == 1 and p.SGRP == 4 and p.fin_direct == 0),
        ("Q=2", rc(3000, 20_000, 3 / 20_000, seed=1, dtype=dtype),
         dict(Q=2), lambda p: p.Q == 2),
        ("Q=4", rc(800, 5000, 0.01, seed=7, dtype=dtype), dict(Q=4),
         lambda p: p.Q == 4),
        ("Q=8", rc(12_000, 10_000, 0.002, seed=11, dtype=dtype), dict(Q=8),
         lambda p: p.Q == 8),
        ("spills + non-uniform slabs (NumPy engine)",
         rc(2000, 20_000, 0.002, seed=1, dtype=dtype),
         dict(use_native=False),
         lambda p: p.spill_row.size > 0 and not fused.slabs_uniform(p)),
        ("empty trailing slabs", _empty_trailing_slabs(h, dtype), {},
         lambda p: p.n_slabs >= 2 and np.diff(p.slab_bounds)[-1] > 0),
    ]


def fused_regimes(s):
    """Kernel vs plain version and vs gold on one small pack per regime."""
    h, fused = s.h, s.fused
    cases = _fused_cases(s, np.float32)
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
        errs = []
        for k in (1, 3, 8):
            X = _X(m.nr_cols, k, seed=k)
            Xp = dev.prepare_x_multi(X)
            yk = dev.blocks_multi(Xp)
            yr = dev.blocks_multi(Xp, fused.fused_spmm_reference)
            s.sync()
            errs.append(_agree(yk, yr))
            _gold_errors_multi(s, m, X, dev.spmm(Xp, x_is_packed=True))
        print(f"fused regime {tag}, SpMM k=1,3,8: fused_spmm vs plain max "
              f"abs {max(errs):.3e} | vs spmm_gold 0 errors", flush=True)


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
        ("window G=4 Q=1 (P=8)", rc(5000, 5000, 0.01, seed=0, dtype=f32),
         dict(G=4, Q=1), None, lambda d: d.meta.planes == 8),
        ("legacy final, no F levels (shuffled lanes)",
         rc(1200, 5000, 0.004, seed=12, dtype=f32),
         dict(shuffle_lanes=True), None,
         lambda d: final_kinds(d) == {"_FinalLevel"} and not len(d.flevels)),
    ]
    for tag, m, kw, vdt, regime in cases:
        d = sg.GStreamDevice(h.pack_gstream(m, **kw), s.dev, vdt)
        if not regime(d):
            raise RuntimeError(f"{tag}: the pack does not hit its regime: "
                               f"{s.describe(d)}")
        x = np.random.default_rng(9).standard_normal(m.nr_cols)
        s.gstream(d, x, tag, measure=False)
        y = d.spmv(x).cpu().numpy()
        dt = "bfloat16" if vdt is not None else f32
        _gold_errors(h, m, x, y, dt)
        print(f"classic regime {tag}: {s.describe(d)} | kernels agree with "
              f"their plain versions | vs spmv_gold 0 errors", flush=True)
        for k in (1, 3, 8):
            X = _X(m.nr_cols, k, seed=k)
            s.gstream_multi(d, X, tag, measure=False)
            _gold_errors_multi(s, m, X, s.sp.spmm_gstream(d, X), dt)
        print(f"classic regime {tag}, SpMM k=1,3,8: kernels "
              f"{sorted(s.spmm_kernels_of(d))} agree with their plain "
              f"versions | vs spmm_gold 0 errors", flush=True)

    # k-plane finals that spill, on random position planes:
    # against their plain versions and the per-plane final kernel
    for kind, m in (("flat", rc(3000, 20_000, 0.002, seed=7, dtype=f32)),
                    ("legacy", rc(5000, 5000, 0.01, seed=12, dtype=f32))):
        p = h.pack_gstream(m, G=4, Q=2)
        cr = p.chunk_row.reshape(-1).astype(np.int64)
        fin = (fl._FinalLevelV2.build(cr, p.nr_rows, p.sections, p.planes)
               if kind == "flat" else fl._FinalLevel.build(cr, p.nr_rows))
        if fin is None or not fin.spill_pos.size:
            raise RuntimeError(f"{kind} final: expected spills")
        lvl = sg.final_device(fin, p.nr_rows, cr.size, s.dev)
        for k in (1, 3, 8):
            vec = torch.as_tensor(_X(cr.size, k, seed=k),
                                  dtype=torch.float32, device=s.dev)
            s.final_multi(lvl, vec, f"{kind} final with spills", False)
            Y = lvl.apply_multi(vec)
            for j in range(k):
                _agree(Y[:, j], lvl.apply(vec[:, j].contiguous()))
        print(f"classic regime {kind} final with {fin.spill_pos.size} "
              f"spills, k=1,3,8: k-plane final vs plain and vs the "
              f"per-plane final agree", flush=True)

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
    X = _X(m.nr_cols, 3, seed=3)
    s.gstream_multi(d, X, "segment-sum", measure=False)
    _gold_errors_multi(s, m, X, s.sp.spmm_gstream(d, X))
    print(f"classic regime segment-sum route: {s.describe(d)} | vs "
          f"spmv_gold and (k=3) spmm_gold 0 errors", flush=True)


def f64_fused_regimes(s):
    """The fused regimes with f64 values: the f64 fused kernel vs its plain
    version, the workspace placement of its second scratch plane, and y
    (Y at k = 1, 3, 8: one f64 SpMV a column) vs the gold."""
    h, fused, torch = s.h, s.fused, s.torch
    f64 = np.float64
    cases = _fused_cases(s, f64)
    for tag, m, kw, regime in cases:
        packs = fused.pack_fused_df64(m, **kw)
        if packs is None or not regime(packs[0]):
            raise RuntimeError(f"f64 {tag}: the pack does not hit its regime")
        dev = fused.DF64FusedDevice.from_packed(*packs, s.dev)
        p = dev.meta
        x = np.random.default_rng(9).standard_normal(m.nr_cols)
        x2 = dev.prepare_x(x)
        y = s.drive(f"f64 fused regime {tag}",
                    lambda: dev.spmv(x2, x_is_packed=True),
                    {"fused_spmv_f64"}, main=False)
        _gold_errors(h, m, x, y.cpu().numpy(), f64)
        yk = dev.blocks(x2)
        yr = dev.blocks(x2, kernel=fused.fused_spmv_reference)
        s.sync()
        err = _agree(yk, yr)
        ws = "-"
        if not p.fin_direct and s.dev.type == "cuda":
            # the second scratch plane in a global workspace, as the
            # wrapper places it where the opt-in shared memory is too small
            t = {n: getattr(dev, n) for n, _ in fused._KERNEL_INPUTS}
            yw = fused._fused_spmv_f64_launch(
                t, x2, workspace=True, T=p.T, GLW=p.GLW, P=p.planes,
                F1_max=p.F1_max, F2_max=p.F2_max, F1S=p.F1S, OBp=p.OBp,
                n_slabs=p.n_slabs, fin_direct=p.fin_direct)
            s.sync()
            ws = f"{_agree(yw, yr):.3e}"
        fits = (fused.f64_scratch_fits(p.T, p.planes, p.F1S, p.fin_direct,
                                       s.dev) if s.dev.type == "cuda"
                else True)
        for k in (1, 3, 8):
            X = _X(m.nr_cols, k, seed=k)
            _gold_errors_multi(s, m, X, s.f64.spmm_df64(dev, torch.as_tensor(
                X, device=s.dev)), f64)
        print(f"f64 fused regime {tag}: Q={p.Q} T={p.T} steps={p.n_steps} "
              f"SGRP={p.SGRP} fin_direct={p.fin_direct} F1S={p.F1S} "
              f"spills={p.spill_row.size} scratch in shared memory={fits} | "
              f"kernel vs plain max abs {err:.3e}, workspace placement vs "
              f"plain {ws} | y and Y (k=1,3,8) vs the gold 0 errors",
              flush=True)


def f64_classic_regimes(s):
    """The classic f64 device: forward at G = 1 and G > 1, a legacy final
    that spills, the segment-sum route; each kernel vs its plain version,
    y and Y (k = 1, 3, 8) vs the gold."""
    h, fl, f64 = s.h, s.fl, np.float64
    rc = h.random_csr
    cases = [
        ("G=1", rc(3000, 900, 0.02, seed=1, dtype=f64), 1,
         lambda d: d.meta.G == 1 and d.final is not None),
        ("G=4", rc(3000, 5000, 0.004, seed=24, dtype=f64), 4,
         lambda d: d.meta.G == 4 and d.final is not None),
        ("legacy final with spills",
         rc(1000, 300_000, 40 / 300_000, seed=1, dtype=f64), 4,
         lambda d: d.final is not None and d.final.n_spills > 1000),
        ("model-chosen G", rc(5000, 5000, 0.01, seed=0, dtype=f64), None,
         lambda d: d.final is not None),
    ]
    builds = fl._FinalLevel.build
    for tag, m, G, regime in cases + [("segment-sum route",
                                       rc(3000, 6000, 0.004, seed=5,
                                          dtype=f64), None,
                                       lambda d: d.final is None)]:
        if tag == "segment-sum route":
            # no final builds, as a pathological placement makes it
            fl._FinalLevel.build = classmethod(lambda cls, *a, **k: None)
        try:
            d = s.f64.DF64GStreamDevice.from_packed(
                *s.f64.pack_gstream_df64(m, G=G), s.dev)
        finally:
            fl._FinalLevel.build = builds
        if not regime(d):
            raise RuntimeError(f"f64 classic {tag}: the pack does not hit "
                               f"its regime: {s.describe(d)}")
        x = np.random.default_rng(9).standard_normal(m.nr_cols)
        xt = s.torch.as_tensor(x, device=s.dev)
        y = s.drive(f"f64 classic regime {tag}", lambda: d.spmv(xt),
                    s.kernels_of(d), main=False)
        _gold_errors(h, m, x, y.cpu().numpy(), f64)
        s.gstream(d, xt, tag, measure=False)
        for k in (1, 3, 8):
            X = _X(m.nr_cols, k, seed=k)
            Xt = s.torch.as_tensor(X, device=s.dev)
            Y = s.drive(f"f64 classic regime {tag} SpMM k={k}",
                        lambda: s.f64.spmm_df64(d, Xt), s.spmm_kernels_of(d),
                        main=False)
            _gold_errors_multi(s, m, X, Y, f64)
            s.gstream_multi(d, Xt, tag, measure=False)
        print(f"f64 classic regime {tag}: {s.describe(d)} | kernels agree "
              f"with their plain versions | y and Y (k=1,3,8) vs the gold 0 "
              f"errors", flush=True)


def describe_bsr(d) -> str:
    fin = d.plan
    out = (f"BSR {d.nr_rows}x{d.nr_cols}, {d.n_blocks} blocks (padded), "
           f"{d.blocks.numel() * 4} B of values")
    if fin is None:
        return out + "; final: none (segment sum)"
    return (out + f"; legacy final tps={fin.tiles_per_step} G={fin.G} "
            f"nw={fin.nw} instances={fin.step_meta.shape[0]} "
            f"spills={fin.spill_pos.size}")


def bsr_regimes(s):
    """The BSR kernel vs its plain version and y vs the gold on small
    matrices: the JAX tests' banded and random shapes, a ragged one
    (nr_rows % 8 and nr_cols % 128 nonzero) and the segment-sum route."""
    torch, h, fl = s.torch, s.h, s.fl
    cases = [
        ("banded 300x300 bw 10", h.banded_csr(300, 300, bandwidth=10), False),
        ("banded 1000x700 bw 40", h.banded_csr(1000, 700, bandwidth=40),
         False),
        ("random 200x500 d 0.05", h.random_csr(200, 500, density=0.05,
                                               seed=72), False),
        ("ragged 1001x1001", h.random_csr(1001, 1001, density=0.01,
                                          seed=73), False),
        ("segment-sum route", h.banded_csr(1000, 700, bandwidth=40, seed=1),
         True),
    ]
    build = fl._FinalLevel.build
    for tag, m, seg in cases:
        b = h.csr_to_bsr(m)
        if seg:
            # no final builds, as a pathological placement makes it
            fl._FinalLevel.build = classmethod(lambda cls, *a, **k: None)
        try:
            d = s.bsr.BSRDevice(b, s.dev)
        finally:
            fl._FinalLevel.build = build
        if (d.final is None) != seg:
            raise RuntimeError(f"bsr regime {tag}: {describe_bsr(d)}")
        x = np.random.default_rng(3).standard_normal(m.nr_cols)
        xt = torch.as_tensor(x, dtype=torch.float32, device=s.dev)
        expected = {"bsr_partials"} | (
            {"gstream_final_legacy"} if d.final is not None else set())
        y = s.drive(f"bsr regime {tag}", lambda: d.spmv(xt), expected,
                    main=False)
        _gold_errors(h, m, x, y.cpu().numpy())
        parts = s.bsr_kernel(d, d.prepare_x(xt), tag, measure=False)
        if d.final is not None:
            s.final(d.final, parts.reshape(-1), d.rows_pad, tag,
                    measure=False)
        print(f"bsr regime {tag}: {describe_bsr(d)} | kernels agree with "
              f"their plain versions | vs spmv_gold 0 errors", flush=True)


def solver_checks(s):
    """``bicgstab``, ``gmres`` (also through a breakdown) and
    ``power_iteration`` once each on the card, at the JAX tests' sizes,
    against dense host solutions."""
    import scipy.sparse as sp
    torch, h, st = s.torch, s.h, s.st

    def on_card(dense):
        rows, cols = np.nonzero(dense)
        m = h.CSRMatrix.from_coo(rows, cols, dense[rows, cols].astype(
            np.float32), *dense.shape)
        return st.SparseMatrix(m, device=s.dev)

    rng = np.random.default_rng(0)
    dense = h.random_csr(80, 80, density=0.2, seed=30).to_dense()
    dense = dense + np.diag(np.abs(dense).sum(axis=1) + 1.0)
    b = rng.standard_normal(80).astype(np.float32)
    res = st.bicgstab(on_card(dense).spmv, torch.as_tensor(b, device=s.dev),
                      tol=1e-6, maxiter=500)
    err = float(np.abs(dense @ res.x.cpu().numpy() - b).max())
    if err > 1e-3:
        raise RuntimeError(f"bicgstab: |A x - b| {err:.3e}")
    print(f"solver bicgstab (80x80, diagonally dominant): {res.iterations} "
          f"iterations, max |A x - b| {err:.3e}", flush=True)

    rng = np.random.default_rng(3)
    a = (sp.eye(400) + sp.random(
        400, 400, density=0.02, random_state=5,
        data_rvs=lambda k: 0.1 * rng.standard_normal(k))).toarray()
    low = np.random.default_rng(4).standard_normal((64, 2))
    breakdown = np.eye(64) + 0.3 * low @ np.random.default_rng(
        5).standard_normal((2, 64))
    for tag, dense, restart in (("I + sparse 400x400", a, 25),
                                ("I + rank 2, 64x64, restart 10",
                                 breakdown, 10)):
        b = np.random.default_rng(6).standard_normal(
            dense.shape[0]).astype(np.float32)
        res = st.gmres(on_card(dense).spmv, torch.as_tensor(b, device=s.dev),
                       restart=restart, tol=1e-5, maxiter=300)
        rel = float(np.linalg.norm(dense @ res.x.cpu().numpy() - b)
                    / np.linalg.norm(b))
        if rel > 1e-3:
            raise RuntimeError(f"gmres {tag}: relative residual {rel:.3e}")
        print(f"solver gmres ({tag}): {res.iterations} Arnoldi steps, "
              f"||A x - b|| / ||b|| {rel:.3e}", flush=True)

    m = h.laplace_2d(8)
    lam, _ = st.power_iteration(st.SparseMatrix(m, device=s.dev).spmv,
                                m.nr_rows, iters=200, device=s.dev)
    top = float(np.linalg.eigvalsh(m.to_dense())[-1])
    if abs(float(lam) - top) > 1e-2 * abs(top):
        raise RuntimeError(f"power_iteration: {float(lam)} vs {top}")
    print(f"solver power_iteration (laplace_2d(8), 200 iterations): "
          f"{float(lam):.6f} vs eigvalsh {top:.6f}", flush=True)


def bsr_main(s, small, t0):
    """BSR SpMV at FEM-3D Poisson 72^3 (``BSRDevice.spmv``: #14 then the
    legacy final #5), then PCG on it."""
    torch, h, st = s.torch, s.h, s.st
    n = 16 if small else 72
    m = h.fem_poisson_3d(n, np.float32)
    b = h.csr_to_bsr(m)
    t1 = time.perf_counter()
    d = st.BSRDevice(b, s.dev)
    s.sync()
    tag = f"bsr FEM-3D Poisson {n}^3"
    print(f"{tag}: {m.nr_rows}x{m.nr_cols} nnz={m.nr_nzeros}, "
          f"{b.values.shape[0]} blocks (fill "
          f"{m.nr_nzeros / max(b.nr_nzeros, 1):.4f}), matrix and csr_to_bsr "
          f"in {t1 - t0:.1f} s, upload + final build in "
          f"{time.perf_counter() - t1:.1f} s: {describe_bsr(d)}", flush=True)
    if d.final is None:
        raise RuntimeError(f"{tag}: expected the legacy final")
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    xt = torch.as_tensor(x, dtype=torch.float32, device=s.dev)
    y = s.drive(tag, lambda: d.spmv(xt),
                {"bsr_partials", "gstream_final_legacy"})
    counts = s._counts()
    if s.dev.type == "cuda" and (counts["bsr_partials"] != 1 or
                                 counts["gstream_final_legacy"] != 1):
        raise RuntimeError(f"{tag}: expected one launch each of #14 and #5,"
                           f" got {counts}")
    if tuple(y.shape) != (m.nr_rows,) or not bool(y.isfinite().all()):
        raise RuntimeError(f"{tag}: bad y, shape {tuple(y.shape)}")
    _gold_errors(h, m, x, y.cpu().numpy())
    print(f"{tag}: 0 errors vs spmv_gold", flush=True)
    parts = s.bsr_kernel(d, d.prepare_x(xt), tag)
    s.final(d.final, parts.reshape(-1), d.rows_pad, tag, measure=False)
    ms = s.call_ms(lambda: d.spmv(xt), repeats=20)
    print(f"  {tag}: BSRDevice.spmv {ms:.4f} ms a call "
          f"({m.nr_nzeros / ms / 1e6:.2f} Gnnz/s)", flush=True)
    s.profile(tag, lambda: d.spmv(xt))
    sm = st.SparseMatrix(m, device=s.dev)
    print(f"  {tag}, CSR route: {s.describe(sm.device_module)}", flush=True)
    s.whole_call(sm, m, xt, tag + " (CSR route)")
    s.profile(tag + " (CSR route)", lambda: sm @ xt)
    del sm
    print(f"phase {tag}: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- PCG on the BSR operator
    t0 = time.perf_counter()
    tag = f"pcg on BSR (FEM-3D Poisson {n}^3)"
    rhs = torch.ones(m.nr_rows, device=s.dev)
    m_inv = st.jacobi_preconditioner(m, device=s.dev)
    t1 = time.perf_counter()
    res = s.drive(tag, lambda: st.pcg(d.spmv, rhs, m_inv, tol=1e-5,
                                      maxiter=2000),
                  {"bsr_partials", "gstream_final_legacy"})
    wall = time.perf_counter() - t1
    counts = s._counts()
    k = res.iterations
    if s.dev.type == "cuda" and (
            counts["bsr_partials"] != k + 1 or
            counts["gstream_final_legacy"] != k + 1):
        raise RuntimeError(f"{tag}: expected {k + 1} launches of #14 and #5"
                           f" (one an SpMV), got {counts}")
    xs = res.x.cpu().numpy().astype(np.float64)
    rel = float(np.linalg.norm(1.0 - h.spmv_gold(m, xs)) /
                np.sqrt(m.nr_rows))
    if not rel <= 1e-4 or k >= 2000:
        raise RuntimeError(f"{tag}: ||b - A x|| / ||b|| {rel:.3e} after {k}"
                           f" iterations")
    print(f"{tag}: {k} iterations, {wall * 1e3 / max(k, 1):.4f} ms an "
          f"iteration (host clock, the loop's scalar syncs included), "
          f"||b - A x|| / ||b|| {rel:.3e} (f64, spmv_gold), #14 and #5 "
          f"launched {k + 1} times each", flush=True)
    print(f"phase {tag}: {time.perf_counter() - t0:.1f} s", flush=True)


def cg_df64_main(s, small, t0):
    """``cg_df64`` on FEM-3D Poisson 72^3 in f64 through ``SparseMatrix``."""
    torch, h, st = s.torch, s.h, s.st
    n = 16 if small else 72
    m = h.fem_poisson_3d(n)
    sm = st.SparseMatrix(m, device=s.dev)
    d = sm.device_module
    route = "fused f64" if isinstance(d, s.fused.DF64FusedDevice) \
        else "classic f64 (not the fused f64 device)"
    tag = f"cg_df64 (FEM-3D Poisson {n}^3, f64)"
    print(f"{tag}: {route} device: {s.describe(d)}", flush=True)
    rhs = torch.ones(m.nr_rows, dtype=torch.float64, device=s.dev)
    t1 = time.perf_counter()
    res = s.drive(tag, lambda: st.cg_df64(sm.spmv, rhs, tol=1e-10,
                                          maxiter=3000), s.kernels_of(d))
    wall = time.perf_counter() - t1
    k = res.iterations
    rel = float(np.linalg.norm(1.0 - h.spmv_gold(m, res.x.cpu().numpy())) /
                np.sqrt(m.nr_rows))
    if res.x.dtype != torch.float64 or not rel <= 1e-9 or k >= 3000:
        raise RuntimeError(f"{tag}: ||b - A x|| / ||b|| {rel:.3e} after {k}"
                           f" iterations ({res.x.dtype})")
    print(f"{tag}: {k} iterations, {wall * 1e3 / max(k, 1):.4f} ms an "
          f"iteration, ||b - A x|| / ||b|| {rel:.3e} (f64, spmv_gold)",
          flush=True)
    print(f"phase {tag}: {time.perf_counter() - t0:.1f} s", flush=True)


def _spgemm_gold(h, a, b, c, tag) -> float:
    """C against scipy's A @ B in f64: the same pattern (sorted columns),
    values with 0 errors at the f32 tolerance of its terms a value.
    Returns the max abs error; raises on a mismatch."""
    import scipy.sparse  # noqa: F401  (to_scipy)
    g = (a.to_scipy().astype(np.float64) @ b.to_scipy().astype(
        np.float64)).tocsr()
    g.sum_duplicates()
    g.sort_indices()
    if not (np.array_equal(c.row_ptr, g.indptr)
            and np.array_equal(c.col_ind, g.indices)):
        raise RuntimeError(f"{tag}: C's pattern is not the gold's")
    terms = int(np.diff(b.row_ptr)[a.col_ind].sum())
    atol, rtol = h.default_tolerance(np.float32, terms / max(g.nnz, 1))
    errors = h.verification(g.data, c.values, diff_thres=atol, rel_thres=rtol)
    if errors or c.values.dtype != np.float32:
        raise RuntimeError(f"{tag}: {errors} values disagree with the gold")
    return float(np.abs(c.values - g.data).max(initial=0.0))


def spgemm_regimes(s):
    """``sm @ m`` and ``sm @ sm`` on the card at the JAX tests' shapes: the
    operator builds its plan and runs the numeric phase on A's device."""
    h, st = s.h, s.st
    for (ra, ca), (rb, cb), da, db in (((200, 300), (300, 150), 0.05, 0.05),
                                       ((64, 64), (64, 64), 0.2, 0.2),
                                       ((500, 100), (100, 800), 0.02, 0.03)):
        a = h.random_csr(ra, ca, density=da, seed=31, dtype=np.float32)
        b = h.random_csr(rb, cb, density=db, seed=32, dtype=np.float32)
        sa = st.SparseMatrix(a, device=s.dev)
        tag = f"SpGEMM regime {ra}x{ca} @ {rb}x{cb}"
        for operand, name in ((b, "CSR"), (st.SparseMatrix(b, device=s.dev),
                                          "SparseMatrix")):
            c = s.drive(f"{tag} ({name})", lambda: sa @ operand,
                        {"fused_spmv"}, main=False)
            err = _spgemm_gold(h, a, b, c, tag)
        print(f"{tag}: sm @ m and sm @ sm give the gold's pattern, values "
              f"0 errors (max abs {err:.3e})", flush=True)


def spgemm_main(s, small, t0):
    """C = A @ A on the roadNet-CA stand-in cut to 2M nnz (its shape; at
    the full 5.5M nnz the host plan alone took 250-290 s on the H100
    machine): the plan ``sm @ m`` builds (``SpGEMMPlan``, once), then what
    ``sm @ m`` runs on it, ``plan.to_csr(plan(b.values))``, as the main
    path; the numeric phase timed beside cuSPARSE's SpGEMM."""
    torch, h, st = s.torch, s.h, s.st
    m = road_net_ca(h, nnz=20_000 if small else 2_000_000)
    tag = "SpGEMM roadNet-CA A @ A"
    t1 = time.perf_counter()
    plan = st.SpGEMMPlan(m, m, device=s.dev)
    s.sync()
    plan_s = time.perf_counter() - t1
    ev = plan.event_matrix
    d = ev.device_module
    print(f"{tag}: matrix in {t1 - t0:.1f} s; plan (host symbolic phase, "
          f"event matrix {ev.nr_rows}x{ev.nr_cols} nnz={ev.nr_nzeros}, "
          f"pack + upload) in {plan_s:.1f} s; "
          f"{plan.flops // 2} multiplications, nnz(C) = {plan.nnz_c}; "
          f"numeric phase on: {s.describe(d)}", flush=True)
    bv = torch.as_tensor(m.values, device=s.dev)
    t1 = time.perf_counter()
    c = s.drive(tag, lambda: plan.to_csr(plan(bv)), s.kernels_of(d))
    print(f"{tag}: numeric phase and C to the host in "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    err = _spgemm_gold(h, m, m, c, tag)
    print(f"{tag}: C pattern equal to the gold's, values 0 errors at the f32 "
          f"tolerance (max abs {err:.3e})", flush=True)
    ms = s.call_ms(lambda: plan(bv), repeats=20)
    print(f"  {tag}: numeric phase plan(b.values) {ms:.4f} ms a call "
          f"({plan.flops / 2 / ms / 1e6:.2f} G multiplications/s)",
          flush=True)
    s.profile(tag + ", numeric phase", lambda: plan(bv))
    a = s.csr(m)
    try:
        lib_ms = s.call_ms(lambda: a @ a, repeats=5)
        print(f"  {tag}: torch.sparse_csr @ itself (cuSPARSE SpGEMM, "
              f"symbolic + numeric) {lib_ms:.4f} ms a call", flush=True)
    except RuntimeError as e:
        print(f"  {tag}: cuSPARSE SpGEMM not available ({e})", flush=True)
    print(f"phase {tag}: {time.perf_counter() - t0:.1f} s", flush=True)


def ladder_main(s, small, t0):
    """#15 on the card: ``bench_ladder`` as the main path (every stage's
    kernel launched), then each stage held to ``ladder_reference`` on the
    same inputs, beside its bound and, for ``stream``, one ``torch.sum``
    of the value stream."""
    torch, micro = s.torch, s.micro
    n, T = (256 if small else micro.LADDER_TILES), 16
    tag = f"micro ladder ({n} tiles, {T} a block)"
    res = s.drive(tag, lambda: micro.bench_ladder(
        n, LADDER_GS, device=s.dev, tiles_per_step=T),
        {f"ladder_{k}" for k in LADDER_STAGES})
    inp = micro.ladder_inputs(n, LADDER_GS, T, s.dev)
    val, idx, xw, base = inp["val"], inp["idx"], inp["xw"], inp["base"]
    for name, stage, cell, G, _ in micro.ladder_runs(inp, LADDER_GS):
        args = (stage, val, idx, cell, xw, base)
        yk = micro.ladder_stage(*args, G=G, T=T)
        yr = micro.ladder_reference(*args, G=G, T=T)
        s.sync()
        err = _agree(yk, yr)
        plain_ms = s.call_ms(lambda: micro.ladder_reference(*args, G=G, T=T),
                             repeats=10)
        streams = [val, xw] + ([idx] if stage != "stream" else []) + (
            [cell] if cell is not None else []) + (
            [base] if stage == "tilebase" else [])
        lib_ms = None
        if stage == "stream":
            v = val.view(n, 8, 128)
            _agree(torch.sum(v, 1) * xw[0, 0], yr)
            lib_ms = s.call_ms(lambda: torch.sum(v, 1))
        flops = n * 1024 * (1 if stage in ("stream", "lane") else 2)
        s.record(f"ladder_{name}", tag, err, res[name][0], plain_ms,
                 _nbytes(*streams, yk), flops, lib_ms)
    print(f"phase {tag}: {time.perf_counter() - t0:.1f} s", flush=True)


def _cpu_timer(s):
    """None on the card (the entry points' own clock); on a CPU rehearsal
    a host clock, which the entry points refuse to take on their own."""
    if s.dev.type == "cuda":
        return None
    return lambda fn, dev: s.call_ms(fn, repeats=2)


def rates_main(s, m, default_dev, small, t0):
    """#16 on the card: ``refresh_rates`` as the main path (its forward
    launches are ``rates_forward``), the cache in a temporary directory;
    #3 at two combos against its plain version; then ``m`` (the roadNet-CA
    stand-in) on ``default_dev`` (its pack by the default chooser, the
    wide-x phase's) and packed with the card's table, each ``A @ x``
    against the gold."""
    import tempfile
    torch, rates, sg, h = s.torch, s.rates, s.sg, s.h
    n = 1024 if small else rates.CARD_RATE_TILES
    tag = f"rates ({n} tiles)"
    kind = (torch.cuda.get_device_name(s.dev) if s.dev.type == "cuda"
            else "cpu")
    with tempfile.TemporaryDirectory(prefix="sparsetpu_torch_rates_") as d:
        os.environ["SPARSETPU_TORCH_CACHE"] = d
        try:
            table = s.drive(tag, lambda: rates.refresh_rates(
                s.dev, n_tiles=n, timer=_cpu_timer(s), verbose=True),
                {"rates_forward"},
                rename={"gstream_spmv_window": "rates_forward"})
            cached = rates.load_rates(kind)
        finally:
            del os.environ["SPARSETPU_TORCH_CACHE"]
    if cached != table:
        raise RuntimeError(f"{tag}: the cached table is not the measured one")
    qs = (1, 2, 4, 8)
    print(f"  {tag}: Gslot/s by G (rows) and Q {qs}, cached as "
          f"{os.path.basename(rates._cache_path(kind))}", flush=True)
    for g in LADDER_GS:
        print(f"    G={g:2d}  " + "  ".join(f"{table[(g, q)]:7.1f}"
                                           for q in qs), flush=True)
    val, xw0, metas = rates.rate_inputs([g for g, _ in rates.RATE_COMBOS], n)
    val, xw0 = (torch.from_numpy(a).to(s.dev) for a in (val, xw0))
    sw = torch.zeros(n // 128, dtype=torch.int32, device=s.dev)
    err = 0.0
    for G, Q in ((2, 8), (8, 2)):
        args = (val, torch.from_numpy(metas[G]).to(s.dev), sw, xw0)
        ck = sg.gstream_chunk_sums(*args, T=128, G=G, P=8 // Q)
        cr = sg.gstream_chunk_sums_reference(*args, T=128, G=G, P=8 // Q)
        s.sync()
        err = max(err, _agree(ck, cr))
    # the sweep's own time at (G, Q) = (8, 2), the last combo checked
    ms = n * 1024 / table[(8, 2)] / 1e6
    plain_ms = s.call_ms(lambda: sg.gstream_chunk_sums_reference(
        *args, T=128, G=8, P=4), repeats=10)
    s.record("rates_forward", tag + ", G=8 Q=2", err, ms, plain_ms,
             _nbytes(*args, ck), 2 * val.numel(), None)
    del val, xw0, metas, args, ck, cr

    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    xt = torch.as_tensor(x, dtype=torch.float32, device=s.dev)
    t1 = time.perf_counter()
    card = s.st.GStreamDevice(h.pack_gstream(
        m, h.SpmvConfig(dtype=np.float32), rates=table), s.dev)
    s.sync()
    print(f"  {tag}: roadNet-CA packed with the card's table and uploaded "
          f"in {time.perf_counter() - t1:.1f} s", flush=True)
    for label, d in (("default chooser", default_dev), ("card rates", card)):
        y = s.drive(f"{tag}: roadNet-CA, {label}", lambda: d.spmv(xt),
                    s.kernels_of(d))
        _gold_errors(h, m, x, y.cpu().numpy())
        ms = s.call_ms(lambda: d.spmv(xt), repeats=20)
        print(f"  {tag}: roadNet-CA, {label}: G={d.meta.G} Q={d.meta.Q}, "
              f"A @ x (GStreamDevice.spmv) {ms:.4f} ms a call, 0 errors vs "
              f"spmv_gold | {s.describe(d)}", flush=True)
    del card
    print(f"phase {tag}: {time.perf_counter() - t0:.1f} s", flush=True)
    return table


def autotune_main(s, m, table, small, t0):
    """``autotune_pack`` on ``m`` (the roadNet-CA stand-in) as the main
    path, each candidate's time printed beside the model's choice with the
    default table and with the card's ``table``; the pick's ``A @ x``
    against the gold; then ``bench_spmv(..., autotune=True)`` on the same
    matrix."""
    torch, h, st = s.torch, s.h, s.st
    from sparsetpu_torch.bench.harness import bench_spmv
    tag = f"autotune (roadNet-CA stand-in, nnz={m.nr_nzeros})"
    cands, choice = st.autotune_candidates(m)
    card = st.autotune_candidates(m, table)[1]
    print(f"{tag}: model choice G={choice[0]} Q={choice[1]} (with the "
          f"card's table G={card[0]} Q={card[1]}), candidates {cands}",
          flush=True)
    t1 = time.perf_counter()
    sm = s.drive(tag, lambda: st.autotune_pack(
        m, device=s.dev, timer=_cpu_timer(s), verbose=True),
        {"gstream_spmv_window"})
    wall = time.perf_counter() - t1
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    xt = torch.as_tensor(x, dtype=torch.float32, device=s.dev)
    y = s.drive(f"{tag}: the pick's A @ x", lambda: sm @ xt,
                s.kernels_of(sm.device_module))
    _gold_errors(h, m, x, y.cpu().numpy())
    print(f"{tag}: picked G={sm.packed.G} Q={sm.packed.Q} (fill "
          f"{sm.fill_factor():.4f}) of {len(cands)} candidates in {wall:.1f} s"
          f" (packs, uploads and timing); sm @ x "
          f"{s.call_ms(lambda: sm @ xt, repeats=20):.4f} ms a call, 0 errors "
          f"vs spmv_gold", flush=True)
    del sm
    t1 = time.perf_counter()
    r = s.drive(f"{tag}: bench_spmv(autotune=True)", lambda: bench_spmv(
        m, "roadNet-CA stand-in", autotune=True, device=s.dev,
        timer=_cpu_timer(s)), {"gstream_spmv_window"})
    if r.verify_errors:
        raise RuntimeError(f"{tag}: bench_spmv counted {r.verify_errors} "
                           f"errors")
    print(r.report(), flush=True)
    print(f"{tag}: bench_spmv(autotune=True) chose G={r.layout_g} "
          f"Q={r.layout_q} in {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"phase {tag}: {time.perf_counter() - t0:.1f} s", flush=True)


def bench_entry(s, t0):
    """``python -m sparsetpu_torch.bench`` in a subprocess (``--device cpu
    --small`` on a CPU rehearsal): its last line parses, value > 0, the
    gate counted 0 errors."""
    import subprocess
    argv = [sys.executable, "-m", "sparsetpu_torch.bench"]
    if s.dev.type != "cuda":
        argv += ["--device", "cpu", "--small"]
    out = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=900)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"bench entry: rc {out.returncode}, stdout "
                           f"{out.stdout[-2000:]!r}, stderr "
                           f"{out.stderr[-2000:]!r}")
    line = json.loads(lines[-1])
    if not (line["value"] > 0 and line["verify_errors"] == 0
            and line["backend"] == s.dev.type):
        raise RuntimeError(f"bench entry: {lines[-1]}")
    print(f"bench entry ({' '.join(argv[1:])}): {lines[-1]}", flush=True)
    print(f"phase bench entry: {time.perf_counter() - t0:.1f} s", flush=True)


def main_path(s, tag, make, run_devices, t0):
    """Build a matrix, pack it with ``run_devices`` (a ``SparseMatrix`` or a
    ``GStreamDevice``, and the devices behind it), drive its ``spmv`` once
    as the main path and check y against the gold."""
    torch, h = s.torch, s.h
    m = make()
    t_gen = time.perf_counter() - t0
    dt = np.float64 if m.values.dtype == np.float64 else np.float32
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    xt = torch.as_tensor(x, dtype=getattr(torch, np.dtype(dt).name),
                         device=s.dev)
    t1 = time.perf_counter()
    sm, devices = run_devices(m)
    t_pack = time.perf_counter() - t1
    expected = set().union(*(s.kernels_of(d) for d in devices))
    y = s.drive(tag, lambda: sm.spmv(xt), expected)
    if tuple(y.shape) != (m.nr_rows,) or not bool(y.isfinite().all()):
        raise RuntimeError(f"{tag}: bad y, shape {tuple(y.shape)}")
    _gold_errors(h, m, x, y.cpu().numpy(), dt)
    gerr = float(np.abs(y.cpu().numpy() - h.spmv_gold(m, x)).max())
    print(f"{tag}: {m.nr_rows}x{m.nr_cols} nnz={m.nr_nzeros} "
          f"{np.dtype(dt).name}, matrix in {t_gen:.1f} s, pack + upload in "
          f"{t_pack:.1f} s, 0 errors vs spmv_gold (max abs {gerr:.3e}, "
          f"max|y| {y.abs().max().item():.3e})", flush=True)
    for d in devices:
        print(f"  device: {s.describe(d)}", flush=True)
    return m, x, xt, sm, devices


def spmm_path(s, tag, m, fn, devices, k):
    """Drive ``fn(X)`` (Y = A @ X through a user's entry point) once as a
    main path with k columns, the launch counts of ``devices``' SpMM
    kernels read around it, and check Y against ``spmm_gold``."""
    X = _X(m.nr_cols, k, seed=k)
    dt = np.float64 if m.values.dtype == np.float64 else np.float32
    Xt = s.torch.as_tensor(X, dtype=getattr(s.torch, np.dtype(dt).name),
                           device=s.dev)
    expected = set().union(*(s.spmm_kernels_of(d) for d in devices))
    Y = s.drive(tag, lambda: fn(Xt), expected)
    _gold_errors_multi(s, m, X, Y, dt)
    print(f"{tag}: Y {tuple(Y.shape)}, 0 errors vs spmm_gold (column by "
          f"column)", flush=True)
    return Xt


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

    # ---- headline SpMM, k = 8: the fused SpMM kernel
    t0 = time.perf_counter()
    tag = "headline SpMM k=8"
    Xt = spmm_path(s, tag, m, lambda X: sm @ X, [sm.fused_device], 8)
    lib_ms = s.whole_call_multi(sm, m, Xt, tag)
    s.profile(tag, lambda: sm @ Xt)
    s.fused_kernel(sm.fused_device, sm.fused_device.prepare_x_multi(Xt), tag,
                   lib_ms, multi=True)
    print(f"phase headline SpMM: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- past the fused SpMM's limit: the classic device of the source CSR
    t0 = time.perf_counter()
    k = 8
    while sm.fused_device.spmm_applicable(k):
        k += 8
    cd = sm._classic_device()
    s.sync()
    print(f"headline: the fused SpMM takes k <= {k - 8} on this device, so "
          f"k={k} takes the classic device, packed and uploaded in "
          f"{time.perf_counter() - t0:.1f} s: {s.describe(cd)}", flush=True)
    if not (isinstance(cd.final, sg.FinalDevice) and cd.final.v2
            and not len(cd.flevels)):
        raise RuntimeError("headline classic: expected a flat final with no "
                           "F levels")
    tag = f"headline SpMM k={k} (classic device)"
    Xt = spmm_path(s, tag, m, lambda X: sm @ X, [cd], k)
    s.whole_call_multi(sm, m, Xt, tag)
    s.profile(tag, lambda: sm @ Xt)
    s.gstream_multi(cd, Xt, tag)
    print(f"phase headline classic SpMM: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- the headline's shuffled pack: the k-plane legacy final
    t0 = time.perf_counter()
    shuf = st.GStreamDevice(h.pack_gstream(m, shuffle_lanes=True), s.dev)
    print(f"headline shuffled: {s.describe(shuf)}", flush=True)
    if not (isinstance(shuf.final, sg.FinalDevice) and not shuf.final.v2
            and not len(shuf.flevels)):
        raise RuntimeError("headline shuffled: expected a legacy final with "
                           "no F levels")
    tag = "headline shuffled SpMM k=8"
    Xt = spmm_path(s, tag, m, lambda X: st.spmm_gstream(shuf, X), [shuf], 8)
    print(f"  {tag}: spmm_gstream "
          f"{s.call_ms(lambda: st.spmm_gstream(shuf, Xt), repeats=20):.4f} "
          f"ms a call", flush=True)
    s.profile(tag, lambda: st.spmm_gstream(shuf, Xt))
    s.gstream_multi(shuf, Xt, tag)
    print(f"phase headline shuffled SpMM: {time.perf_counter() - t0:.1f} s",
          flush=True)
    del cd, shuf, Xt

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
    tag = "wide x SpMM k=2 (roadNet-CA)"
    Xt = spmm_path(s, tag, m, lambda X: sm @ X, [sm.device_module], 2)
    s.whole_call_multi(sm, m, Xt, tag)
    s.profile(tag, lambda: sm @ Xt)
    s.gstream_multi(sm.device_module, Xt, tag, measure=False)
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
    del pin, devs

    # ---- the rate sweep (#16) and the chooser with its table, on the same
    # matrix; autotune on a cut of it: at full size its five candidates'
    # host packing took 155.7 s on the H100 machine (the 8 flat finals'
    # build, over every row)
    table = rates_main(s, m, sm.device_module, small, time.perf_counter())
    del m, sm
    t0 = time.perf_counter()
    autotune_main(s, road_net_ca(h, nnz=20_000 if small else 1_000_000),
                  table, small, t0)

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
    tag = "web graph SpMM k=4 (webbase-1M)"
    Xt = spmm_path(s, tag, m, lambda X: sm @ X,
                   [sm.fused_device, sm.heavy_device], 4)
    s.whole_call_multi(sm, m, Xt, tag)
    s.profile(tag, lambda: sm @ Xt)
    lX = light.prepare_x_multi(Xt)
    yk, yr = light.blocks_multi(lX), light.blocks_multi(
        lX, fused.fused_spmm_reference)
    s.sync()
    print(f"  fused_spmm [web graph, light rows]: kernel vs plain max abs "
          f"{_agree(yk, yr):.3e}", flush=True)
    s.gstream_multi(sm.heavy_device, Xt, tag + ", heavy rows", measure=False)
    print(f"phase web graph: {time.perf_counter() - t0:.1f} s", flush=True)
    del m, sm, light, Xt

    # ---- f64 (DOUBLE=1): the regimes, then the headline and wide x in f64
    t0 = time.perf_counter()
    f64_fused_regimes(s)
    f64_classic_regimes(s)
    print(f"phase f64 regimes: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()

    def fused_f64(mat):
        sm = st.SparseMatrix(mat, device=s.dev)
        if not isinstance(sm.device_module, fused.DF64FusedDevice):
            raise RuntimeError("headline f64: expected the fused f64 device")
        return sm, [sm.device_module]

    m, x, xt, sm, _ = main_path(
        s, "headline f64",
        lambda: h.random_csr(20_000 if small else 200_000, 100_000,
                             density=0.0005, seed=1, dtype=np.float64),
        fused_f64, t0)
    lib_ms = s.whole_call(sm, m, xt, "headline f64")
    s.profile("headline f64", lambda: sm @ xt)
    s.fused_kernel(sm.device_module, sm.prepare_x(x), "headline f64", lib_ms)
    tag = "headline f64 SpMM k=4"
    Xt = spmm_path(s, tag, m, lambda X: sm @ X, [sm.device_module], 4)
    s.whole_call_multi(sm, m, Xt, tag)
    s.profile(tag, lambda: sm @ Xt)
    print(f"phase headline f64: {time.perf_counter() - t0:.1f} s", flush=True)
    del m, sm, Xt

    t0 = time.perf_counter()

    def classic_f64(mat):
        sm = st.SparseMatrix(mat, device=s.dev)
        if not isinstance(sm.device_module, s.f64.DF64GStreamDevice):
            raise RuntimeError("wide x f64: expected the classic f64 device")
        return sm, [sm.device_module]

    road64 = (lambda: road_net_ca(h, nnz=20_000, dtype=np.float64)) \
        if small else (lambda: road_net_ca(h, dtype=np.float64))
    tag = "wide x f64 (roadNet-CA)"
    m, x, xt, sm, _ = main_path(s, tag, road64, classic_f64, t0)
    d = sm.device_module
    s.whole_call(sm, m, xt, tag)
    s.profile(tag, lambda: sm @ xt)
    s.gstream(d, xt, tag)
    tag = "wide x f64 SpMM k=8 (roadNet-CA)"
    Xt = spmm_path(s, tag, m, lambda X: sm @ X, [d], 8)
    s.whole_call_multi(sm, m, Xt, tag)
    s.profile(tag, lambda: sm @ Xt)
    s.gstream_multi(d, Xt, tag)
    print(f"phase wide x f64: {time.perf_counter() - t0:.1f} s", flush=True)

    del m, sm, Xt, d

    # ---- BSR, the solvers and SpGEMM
    t0 = time.perf_counter()
    bsr_regimes(s)
    solver_checks(s)
    spgemm_regimes(s)
    print(f"phase bsr, solver and SpGEMM regimes: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    bsr_main(s, small, time.perf_counter())
    cg_df64_main(s, small, time.perf_counter())
    spgemm_main(s, small, time.perf_counter())

    # ---- the stage ladder (#15) and the port's bench line
    ladder_main(s, small, time.perf_counter())
    bench_entry(s, time.perf_counter())

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
    # full f32 in matrix products (the BSR kernel's library yardstick)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = run("cuda", hbm)
    print(f"[{card}, HBM {hbm:.0f} GB/s]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
