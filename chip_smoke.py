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
                   every classic final runs as the row-sorted final
                   (``csrc/final_rows.cu``, the map built at upload),
                   held to its plain version and to the TPU layout's plain
                   final (the per-level grids, the spills, the adds);
  headline         the bench.py matrix (200k x 100k, 50 nnz/row, ~10M nnz):
                   the fused main path, one kernel and one memset a call
                   (a whole one-call profiler trace, every launch
                   recorded; the run fails otherwise);
                   the device's launch a call and back to back beside the
                   free wrapper, held to its plain version (also in f64);
  wide x           a stand-in with the shape and nnz of SNAP/roadNet-CA
                   (1,971,281^2, 5,533,214 nnz, uniform random columns):
                   x too wide for the fused layout, so the whole matrix goes
                   to the classic device; its final (8 sections and the
                   spills in one map) timed as the row-sorted kernel,
                   plain and as cuSPARSE on the same 0/1 matrix; a thread
                   a row against a warp a row on uniform rows of 4-4096
                   entries (the short bin's threshold), and on k = 8 and 72
                   planes a group of threads a row against a warp a plane
                   vector (the k-plane form's);
  web graph        the webbase-1M stand-in (1,000,005^2, power-law rows):
                   the heavy-row hybrid, light rows fused and heavy rows on a
                   classic device with F levels and the legacy final;
  per-tile base    the roadNet-CA stand-in packed with GL pinned
                   (``pack_gstream(G=8, GL=2)``) through ``GStreamDevice``;
  rows kernel      ``csrc/fused_rows.cu`` over the f32 device's row map,
                   against its plain version and #1's y, the two kernels
                   timed in turns beside the byte rule's pick
                   (``FusedDevice.traffic``): at the headline, at the web
                   graph's light rows, at the ``urand20`` cell's matrix
                   (seed 1, ``spbench/``'s generator; the rule takes the
                   rows kernel: one kernel and no memset a call) and at a
                   band of 8 diagonals (1M rows, fill 1.0: the rule keeps
                   #1), each beside cuSPARSE on the whole matrix.

and Y = A @ X (SpMM) beside them:

  regimes          every fused and classic regime above at k = 1, 3, 8,
                   plus P = 8 and shuffled (legacy-final) packs and finals
                   that spill: the fused SpMM, the k-plane forward (also
                   on the F levels) and the k-plane final (the row-sorted
                   map on k planes) against their plain versions, Y
                   against ``spmm_gold``;
  headline k = 8   the fused SpMM (``sm @ X``): one kernel and one memset
                   a call (a whole one-call profiler trace), the device's
                   launch (X unpadded, the spills in it) and the free
                   wrapper held to their plain versions, beside the
                   one-pass bound and the bytes of its gathers of X's
                   rows; against eight ``sm @ x`` calls and cuSPARSE;
  headline k = 72  (the smallest multiple of 8 the fused SpMM rejects on
                   an H100): ``sm @ X`` on the lazily built classic
                   device, the k-plane forward and the k-plane final (flat
                   level), the forward beside its HBM bound and the bytes
                   of its gathers of X's rows, which X's place in the L2
                   serves;
  crossing         ``sm @ X`` at k = 72, 96 and 128 on that device, each
                   beside k ``sm @ x`` calls (k fused SpMVs) and cuSPARSE;
  shuffled k = 8   ``spmm_gstream`` on the headline's
                   ``pack_gstream(shuffle_lanes=True)``: the k-plane
                   forward and the k-plane final (legacy level);
  web graph k = 4  the hybrid: fused SpMM on the light rows, the k-plane
                   forward on the heavy rows and on their F levels, then
                   the k-plane final (legacy level, long rows);
  wide x k = 2     the k-plane forward, then the k-plane final (8 flat
                   sections in one map).

and f64 (DOUBLE=1, native FP64 kernels) beside them:

  f64 regimes      the fused regimes with f64 values, the free wrapper
                   and the device's launch each held to the plain version;
                   the classic f64 device at G = 1 and G > 1,
                   with a legacy final that spills, and the segment-sum
                   route; A @ X at k = 1, 3, 8 on each;
  headline f64     the headline matrix with f64 values: ``sm @ x`` on the
                   fused f64 device, and ``sm @ X`` at k = 4 (one fused f64
                   SpMV a column);
  wide x f64       the roadNet-CA stand-in with f64 values: ``sm @ x`` on
                   the classic f64 device (the forward over the live
                   slots, held to its plain version and to the forward
                   over the whole pack at every read position, beside its
                   bound and the TPU layout's; the legacy final, with its
                   spills), and ``sm @ X`` at k = 8 (the k-plane f64
                   forward, then the k-plane f64 final).

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
                   the BSR kernel and the legacy final (row-sorted), beside
                   the CSR route of the same matrix and cuSPARSE;
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
                   on the same inputs, and the lane and each gather stage
                   beside cuSPARSE on its incidence with xw;
  rates            ``refresh_rates`` over the 24 (G, Q) at 32768 tiles (the
                   forward kernel #3, counted as ``rates_forward``), the
                   cache in a temporary directory; #3 at two combos against
                   its plain version, and at G = 8, Q = 2 beside cuSPARSE on
                   its chunk incidence; the roadNet-CA stand-in packed with
                   the default chooser and with the card's table, each
                   ``A @ x`` against the gold;
  autotune         ``autotune_pack`` on the roadNet-CA stand-in cut to a
                   third of its rows (657,094) and 333,333 nnz, each
                   candidate's time, the pick's y against the gold, then
                   ``bench_spmv(..., autotune=True)`` on the same matrix;
  fused stages     ``bench_fused_stages`` (``bench/fused_stages.py``, the
                   kernels of ``csrc/fused_stages.cu``): at the headline the
                   forward alone, the forward with finish stage 1, #1's
                   blocks and ``FusedDevice.spmv`` (y against the gold),
                   ``spmv`` under a ``torch.profiler`` trace, and the forward
                   at #17's five other tile-base inputs; the same split on
                   the pwtk stand-in; the tile ladder's 8 variants at 128
                   tiles a block (the headline's grid) and at 16.  Each
                   kernel is held to its plain version;
  fused prototypes ``bench_fused_proto`` (``bench/fused_proto.py``, the
                   kernels of ``csrc/fused_proto.cu`` and ``tile_forward``
                   of ``csrc/fused_stages.cu``): #20's one-kernel SpMV
                   prototype at the script's 24 x 448 tiles (its scratch
                   in shared memory, then in a workspace) and as 192 x
                   56; #21's forward at GLW 1, 2, 4, 8, 16; the span
                   histograms of the headline and four stand-ins; the
                   headline's narrow and wide tiles at GLW 16, the narrow
                   ones at GLW 8; #24's forward and selects-first tile; #25's
                   stream sums in 7 and 2 streams, 2 folded by 2 and 4, at
                   106 steps (in the L2) and 848, the kernels line's.  Each
                   kernel is held to its plain version;
  select chains    ``bench_select_chains`` (``bench/select_chains.py``, the
                   kernel of ``csrc/select_chains.cu`` in its chain, tree,
                   direct and hilo forms): every kernel of #22
                   (``exp_q.py``: the chain at 18 (G, P), bigdual, the tile
                   bases) and #23 (``exp_r3.py``: chain16, tree16, hilo16,
                   the tile-base forms, split int8 meta), and direct16, at
                   the scripts' own tile counts and at 32768; each phase
                   held to its plain version at both sizes, and at 32768
                   timed beside its bound and cuSPARSE on its incidence
                   with x; the chain's rates beside ``refresh_rates``' table
                   for #3; the kernels' registers and global loads
                   (``-Xptxas -v``, ``cuobjdump -sass``);
  bench entry      ``python -m sparsetpu_torch.bench`` in a subprocess: its
                   last line parses, value > 0, 0 gate errors.

and the distributed SpMV (``sparsetpu_torch/dist/``), in ranks started by
``dist.launch.run_ranks``, before the bench entry:

  dist             one rank over NCCL (a process group of world size 1),
                   then four ranks sharing the card over gloo: the
                   all-gather, ring, multi-host and auto schedules at the
                   headline and the roadNet-CA stand-in, and the f64
                   shards at the headline in f64, at full width; each
                   rank's launches counted (#3's window forward and the
                   final; #11's live slots and the f64 final), y against
                   the gold on rank 0, rank 0's forward and final against
                   their plain versions; at one rank the sharded call
                   beside the band's own ``spmv``, ``SparseMatrix @ x`` and
                   cuSPARSE, and its pieces (x's segment, the all-gathers);
                   ``cg`` and ``cg_df64`` over the shards at FEM-3D Poisson
                   32^3; ``python -m sparsetpu_torch.bench.scaling --json``
                   in a subprocess, every row at 0 verify errors.

and the checkpoints (``pack/serialize.py``), after the f64 paths, and the
SuiteSparse suite (``bench/suite.py``), after the dist phase:

  checkpoints      the devices of five main paths (the headline's fused
                   device, f32 and f64; the roadNet-CA stand-in's classic
                   device with its multi final, its GL = 2 pack on the
                   segment-sum route, and its classic f64 device), each
                   saved by ``save_device`` where its phase built it, then
                   loaded by ``load_device`` and driven once as a main
                   path: y beside the saved device's (bit for bit, or
                   within the gold tolerance) and the gold, each kernel
                   beside its plain version; the archive's bytes and the
                   save and load seconds beside the pack-and-upload
                   seconds the load replaces;
  suite            ``run_suite(allow_synthetic=True)``: its 13 rows (the
                   10 stand-ins and 3 structured generators) must PASS;
                   beside each row cuSPARSE on the same matrix and x.

and the reference's own programs, through the JAX package's entry points,
keywords and CLI flags, each where its matrix's phase built it:

  reference        the headline through bench.py's protocol on the
  programs         headline phase's ``SparseMatrix(m, backend="pallas")``
                   (``d = sm._device``, ``d.spmv(d.prepare_x(x),
                   x_is_packed=True)``) and through ``FusedDevice(p)`` on
                   its pack (#1); the headline in f64 through
                   ``pack_fused_df64(m).spmv_f64(x)`` (#10); the
                   roadNet-CA stand-in through ``GStreamDevice(p)`` on the
                   wide x phase's pack (#3 and the final) and
                   ``spmm_gstream(dev, x_multi=X)`` at k = 8 (#7 and the
                   k-plane final), and in f64 through ``spmv_f64`` of a
                   ``DF64GStreamDevice`` on the phase's (hi, lo) packs
                   (#11 and the f64 final; ``DF64GStreamDevice(m)``
                   repacks for 24 s); ``python -m sparsetpu_torch
                   --backend pallas -v`` and ``--backend xla`` on the
                   headline's shape in subprocesses.  Each result must be
                   a tensor on the card, meet the gold with 0 errors and
                   equal the port's own entry point's (``sm @ x``, ``sm @
                   X``) within the gold tolerance; its kernels are held to
                   their plain versions; its ms a call is printed beside
                   the entry point's, with the card's name and power
                   limit.

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
import tempfile
import time
import types
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
    "fused_spmm": ("sparsetpu_torch/csrc/fused_spmm.cu",
                   "sparsetpu/kernels/spmv_fused.py:144"),
    "gstream_spmm": ("sparsetpu_torch/csrc/gstream_spmm.cu",
                     "sparsetpu/kernels/spmm.py:28"),
    "fused_spmv_f64": ("sparsetpu_torch/csrc/fused_spmv.cu",
                       "sparsetpu/kernels/spmv_fused.py:507"),
    # no TPU kernel: #1's function over a row map of the pack's live slots
    "fused_rows": ("sparsetpu_torch/csrc/fused_rows.cu",
                   "none: a second design of #1 "
                   "(sparsetpu/kernels/spmv_fused.py:48)"),
    "live_slots_f64": ("sparsetpu_torch/csrc/gstream_spmv.cu",
                       "sparsetpu/kernels/f64emu.py:163"),
    "gstream_spmm_f64": ("sparsetpu_torch/csrc/gstream_spmm.cu",
                         "sparsetpu/kernels/f64emu.py:319"),
    "bsr_partials": ("sparsetpu_torch/csrc/bsr_spmv.cu",
                     "sparsetpu/kernels/bsr.py:30"),
    "rates_forward": ("sparsetpu_torch/csrc/gstream_spmv.cu",
                      "sparsetpu/pack/rates.py:115"),
    # the classic devices' final, the row-sorted map: #4 and #5 in f32,
    # #12 in f64; on k planes #8 and #9 (the f64 SpMM's k-plane final
    # stands for #12 a plane, as the JAX package finishes it)
    "final_rows": ("sparsetpu_torch/csrc/final_rows.cu",
                   "sparsetpu/kernels/spmv_pallas.py:767, :196"),
    "final_rows_f64": ("sparsetpu_torch/csrc/final_rows.cu",
                       "sparsetpu/kernels/f64emu.py:196"),
    "final_rows_multi": ("sparsetpu_torch/csrc/final_rows.cu",
                         "sparsetpu/kernels/spmm.py:156, :117"),
    "final_rows_multi_f64": ("sparsetpu_torch/csrc/final_rows.cu",
                             "sparsetpu/kernels/f64emu.py:196"),
}
# the stage ladder: one entry a stage (bench_ladder's keys)
LADDER_GS = (1, 2, 4, 8, 16, 32)
LADDER_STAGES = ("stream", "lane", "dual", "tilebase") + tuple(
    f"window-{G}{kind}" for G in LADDER_GS for kind in ("", "-smem"))
for _stage in LADDER_STAGES:
    KERNELS[f"ladder_{_stage}"] = ("sparsetpu_torch/csrc/micro_ladder.cu",
                                   "sparsetpu/bench/micro.py:95")
# the fused kernel's stage split: the forward (#18, and #17 at its other
# tile-base inputs), the forward with finish stage 1 (#19) and the tile
# ladder's variants (#26, ``bench/fused_stages.py:LADDER_VARIANTS``)
STAGES_SRC = "sparsetpu_torch/csrc/fused_stages.cu"
KERNELS["stages_fwd"] = (STAGES_SRC, "scripts/exp_diag_r3.py:29")
KERNELS["stages_fwd_tile_bases"] = (STAGES_SRC, "scripts/exp_asm_r5.py:70")
KERNELS["stages_fwd_s1"] = (STAGES_SRC, "scripts/exp_diag_r5.py:48")
STAGE_LADDER = ("full-glw16", "full-glw8", "full-glw4", "no-route", "no-tree",
                "no-gathers", "no-sum", "bare-glw1")
for _v in STAGE_LADDER:
    KERNELS[f"stages_ladder_{_v}"] = (STAGES_SRC,
                                      "scripts/exp_tile_ladder.py:61")
# the fused-redesign prototypes: #20 at its two shapes (the script's first,
# also with its scratch in a device-memory workspace),
# #21 at each GLW the reference builds, #24's selects-first tile (its A is
# glw_16's kernel) and #25's four stream forms
PROTO_SRC = "sparsetpu_torch/csrc/fused_proto.cu"
KERNELS["proto_fused_24x448"] = (PROTO_SRC, "scripts/exp_fused.py:34")
KERNELS["proto_fused_24x448_workspace"] = (PROTO_SRC,
                                           "scripts/exp_fused.py:34")
KERNELS["proto_fused_192x56"] = (PROTO_SRC, "scripts/exp_fused.py:34")
PROTO_GLWS = (1, 2, 4, 8, 16)
for _g in PROTO_GLWS:
    KERNELS[f"glw_{_g}"] = (STAGES_SRC, "scripts/exp_glw.py:26")
KERNELS["selfirst_b"] = (STAGES_SRC, "scripts/exp_selfirst.py:66")
# kernels-line name -> streams_sum form
STREAM_KERNELS = {"streams7": "7", "streams2": "2", "streams2_s2": "2xS2",
                  "streams2_s4": "2xS4"}
KERNELS["streams7"] = (PROTO_SRC, "scripts/exp_streams.py:34")
for _k in ("streams2", "streams2_s2", "streams2_s4"):
    KERNELS[_k] = (PROTO_SRC, "scripts/exp_streams.py:51")
# the select chains: kernels-line name -> (``select_forward``'s launch key,
# the phase the line records at the large size, the TPU kernel)
SELECT_SRC = "sparsetpu_torch/csrc/select_chains.cu"
SELECT_KERNELS = {
    "select_chain": ("chain", "q:chain@16,1", "scripts/exp_q.py:55"),
    "select_direct": ("direct", "q:bigdual@32", "scripts/exp_q.py:89"),
    "select_tree": ("tree", "r3:tree16", "scripts/exp_r3.py:96"),
    "select_hilo": ("hilo", "r3:hilo16", "scripts/exp_r3.py:119"),
    "select_tree_i8": ("tree_i8", "r3:tb_tree16_i8", "scripts/exp_r3.py:403"),
}
for _k, (_, _, _rep) in SELECT_KERNELS.items():
    KERNELS[_k] = (SELECT_SRC, _rep)
TILE_ARGS = ("tile_base", "xw", "values", "i1", "rt")
# #1 back to back at the headline as PERF.md section 6 records it (NVIDIA
# H100 80GB HBM3, 700 W): the stage split reads it again beside its phases
FUSED_BACK_TO_BACK_REF_MS = 0.0528
# a profiler trace: host seconds between its edges and the traced calls,
# the spin kernels that bracket them, the tries at a whole one-call trace
TRACE_PAD_S = (0.25, 1.0, 4.0)
TRACE_MARKS = 4


def traced(torch, fn, pads=TRACE_PAD_S):
    """The device events of ``fn()`` from a profiler trace, the host us
    ``fn`` took (through a synchronize), whether the device record is
    whole, and ``fn``'s (kernel launches, memsets) from the trace's record
    of the runtime API calls on the host.

    The profiler drops device events near the start of its window: on
    the card, a trace of one call recorded none of it late in a run, and
    10-call traces 0.1-0.9 of each kernel, while its record of the host's
    runtime calls (``cudaLaunchKernel``, ``cudaMemsetAsync``) stayed whole.
    So the calls sit a pad's host seconds inside the window, between
    ``TRACE_MARKS`` spin kernels on each side (``torch.cuda._sleep``); the
    device record is whole when every marker was recorded, the leading
    ones before all of ``fn``'s events and the trailing ones after.  Tries
    ``pads`` in turn, returns the first whole trace, else the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for pad in pads:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(TRACE_MARKS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            for _ in range(TRACE_MARKS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(pad)
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        spin = [i for i, e in enumerate(ev) if "spin_kernel" in e.name]
        n = len(ev)
        whole = spin == [*range(TRACE_MARKS),
                         *range(n - TRACE_MARKS, n)]
        calls = [e for e in ev if "spin_kernel" not in e.name]
        api = [e.name for e in prof.events()
               if e.device_type == DeviceType.CPU]
        host = (sum("LaunchKernel" in a for a in api) - 2 * TRACE_MARKS,
                sum("Memset" in a for a in api))
        if whole:
            break
        print(f"  trace: {len(spin)} of {2 * TRACE_MARKS} markers (at "
              f"{spin} of {n} events) with {pad} s of room, not whole",
              flush=True)
    return calls, wall_us, whole, host


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


def _fused_bytes(dev, k, spills) -> int:
    """Bytes a fused SpMV (SpMM: k columns) must read on this run's data:
    the forward stream (values, both metadata planes, tile bases); of the
    finish streams only the live tiles (fin1_cnt and fin2_cnt a step, 2 B
    a slot) and their out groups; the steps' slabs and live counts; with
    ``spills``, the spills; x at its real length."""
    p = dev.meta
    elem = dev.values.element_size()
    live1 = 0 if p.fin_direct else int(np.asarray(p.fin1_cnt).sum())
    live2 = int(np.asarray(p.fin2_cnt).sum())
    nb = _nbytes(dev.values, dev.meta_i1, dev.meta_rt, dev.tile_base,
                 dev.step_slab, dev.fin1_cnt, dev.fin2_cnt)
    nb += (live1 + live2) * 2 * 8 * 128 + live2 * 4    # 8 x 128 a tile
    if spills and dev.n_spills:
        nb += _nbytes(dev.spill_pos, dev.spill_col, dev.spill_val)
    return nb + p.nr_cols * k * elem


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


# the autotune phase's cut of the roadNet-CA stand-in (the density of a
# row kept): a third of its rows, 0.06 of its nnz
AUTOTUNE_ROWS, AUTOTUNE_NNZ = 657_094, 333_333


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
        from sparsetpu_torch.bench import (fused_proto, fused_stages, micro,
                                           select_chains)
        from sparsetpu_torch.bench.harness import call_ms, stream_ms
        from sparsetpu_torch.formats.gold import spmm_gold
        from sparsetpu_torch.kernels import (_build, bsr, f64emu, spmm,
                                             spmv_fused, spmv_gstream)
        from sparsetpu_torch.kernels import final_rows as fr
        from sparsetpu_torch.kernels import fused_rows
        from sparsetpu_torch.pack import final_levels, rates
        self.torch, self.st, self.h = torch, st, _host
        self.micro, self.rates, self.fs = micro, rates, fused_stages
        self.fp, self.sc = fused_proto, select_chains
        self.fused, self.sg, self.fl = spmv_fused, spmv_gstream, final_levels
        self.f64, self.bsr, self.fr = f64emu, bsr, fr
        self.rows = fused_rows
        self.sp, self.spmm_gold, self.build = spmm, spmm_gold, _build
        self._call_ms, self._stream_ms = call_ms, stream_ms
        self.dev = torch.device(device)
        self.hbm = hbm
        self.records = {}                 # name -> the JSON entry
        self.calls = {}                   # tag -> whole_call_multi's ms
        self.pack_s = {}                  # main path -> pack + upload s
        self.ckpts = []                   # checkpoint_save's records
        self.ckpt_dir = None              # their temporary directory
        self.whole = {}                   # tag -> whole_call's ms
        self.refs = {}                    # reference program -> (ms, the
                                          # port's entry point's ms)
        self.ref_s = 0.0                  # the reference programs' seconds
        if self.dev.type == "cuda":
            from sparsetpu_torch.utils.device import card_line
            self.card = card_line()
        else:
            self.card = "cpu"
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
        self.rows.fused_rows_spmv.launches = 0
        self.sg.gstream_chunk_sums.launches.clear()
        self.fused.fused_spmm.launches = 0
        self.sp.gstream_chunk_sums_multi.launches = 0
        self.fused.fused_spmv_f64.launches = 0
        self.sg.live_slot_sums.launches = 0
        self.fr.final_rows.launches.clear()
        self.fr.final_rows_multi.launches.clear()
        self.sp.gstream_chunk_sums_multi_f64.launches = 0
        self.bsr.bsr_partials.launches = 0
        self.micro.ladder_stage.launches.clear()
        self.fs.fused_forward.launches = 0
        self.fs.fused_forward_stage1.launches = 0
        self.fs.tile_ladder.launches.clear()
        self.fs.tile_forward.launches.clear()
        self.fp.fused_proto.launches.clear()
        self.fp.streams_sum.launches.clear()
        self.sc.select_forward.launches.clear()

    def _counts(self):
        f = self.sg.gstream_chunk_sums.launches
        r = self.fr.final_rows.launches
        rm = self.fr.final_rows_multi.launches
        return {"fused_spmv": self.fused.fused_spmv.launches,
                "fused_rows": self.rows.fused_rows_spmv.launches,
                "gstream_spmv_window": f["window"],
                "gstream_spmv_tile_base": f["tile_base"],
                "fused_spmm": self.fused.fused_spmm.launches,
                "gstream_spmm": self.sp.gstream_chunk_sums_multi.launches,
                "fused_spmv_f64": self.fused.fused_spmv_f64.launches,
                "live_slots_f64": self.sg.live_slot_sums.launches,
                "gstream_spmm_f64":
                    self.sp.gstream_chunk_sums_multi_f64.launches,
                "bsr_partials": self.bsr.bsr_partials.launches,
                "rates_forward": 0,
                "final_rows": r["short"] + r["long"],
                "final_rows_f64": r["short_f64"] + r["long_f64"],
                "final_rows_multi": rm["short"] + rm["long"],
                "final_rows_multi_f64": rm["short_f64"] + rm["long_f64"],
                **{f"ladder_{k}": self.micro.ladder_stage.launches[k]
                   for k in LADDER_STAGES},
                "stages_fwd": self.fs.fused_forward.launches,
                "stages_fwd_tile_bases": 0,
                "stages_fwd_s1": self.fs.fused_forward_stage1.launches,
                **{f"stages_ladder_{v}": self.fs.tile_ladder.launches[v]
                   for v in STAGE_LADDER},
                "proto_fused_24x448": self.fp.fused_proto.launches["shared"],
                "proto_fused_24x448_workspace":
                    self.fp.fused_proto.launches["global"],
                "proto_fused_192x56": 0,
                **{f"glw_{g}": self.fs.tile_forward.launches[f"full-glw{g}"]
                   for g in PROTO_GLWS},
                "selfirst_b": self.fs.tile_forward.launches["selfirst-glw16"],
                **{k: self.fp.streams_sum.launches[f]
                   for k, f in STREAM_KERNELS.items()},
                **{k: self.sc.select_forward.launches[key]
                   for k, (key, _, _) in SELECT_KERNELS.items()}}

    def kernels_of(self, d):
        """The kernels a device's ``spmv`` launches."""
        if d.dtype == self.torch.float64:
            if isinstance(d, self.fused.FusedDevice):
                return {"fused_spmv_f64"}
            return {"live_slots_f64"} | (
                {"final_rows_f64"} if d.final is not None else set())
        if isinstance(d, self.fused.FusedDevice):
            return {"fused_rows" if d.kernel == "rows" else "fused_spmv"}
        ks = {"gstream_spmv_tile_base" if d.stream.GL
              else "gstream_spmv_window"}
        if len(d.flevels):
            ks.add("gstream_spmv_window")
        if d.final is not None:
            ks.add("final_rows")
        return ks

    def spmm_kernels_of(self, d):
        """The kernels a device's SpMM launches (``spmm``,
        ``spmm_gstream`` or ``spmm_df64``)."""
        if d.dtype == self.torch.float64:
            if isinstance(d, self.fused.FusedDevice):
                return {"fused_spmv_f64"}
            return {"gstream_spmm_f64"} | (
                {"final_rows_multi_f64"} if d.final is not None else set())
        if isinstance(d, self.fused.FusedDevice):
            return {"fused_spmm"}
        # the F levels' k planes run the same forward kernel
        return {"gstream_spmm"} | (
            {"final_rows_multi"} if d.final is not None else set())

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
    def record(self, name, tag, err, ms, plain_ms, nbytes, flops, lib_ms,
               extra=None, replace=False):
        """Print a kernel's line; keep its first record, or this one where
        ``replace``."""
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
        if name not in self.records or replace:
            src, rep = KERNELS[name]
            self.records[name] = {
                "name": name, "route": "cuda", "source": src,
                "replaces": rep, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                "library_ms": lib_ms, **(extra or {})}

    def library_spmv(self, rows, cols, vals, shape, x, ref,
                     back_to_back=False):
        """One sparse product computing the same function (cuSPARSE on the
        card), checked against the kernel's plain output; its time (and,
        with ``back_to_back``, its time back to back)."""
        torch = self.torch
        a = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                    shape).coalesce().to_sparse_csr()
        y = a @ x
        _agree(y[:ref.shape[0]].view_as(ref), ref)
        ms = self.call_ms(lambda: a @ x)
        if back_to_back:
            return ms, self.back_to_back(lambda: a @ x)
        return ms

    def back_to_back(self, fn):
        """``stream_ms`` on the card (device time a call, host gaps out);
        nan on the CPU."""
        return self._stream_ms(fn, self.dev) if self.dev.type == "cuda" \
            else float("nan")

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

    def live_forward(self, d, x, tag, measure=True):
        """The f64 device's forward over its live slots (``live_slot_sums``)
        vs its plain version, and vs the TPU-form plain version (the whole
        pack, ``gstream_chunk_sums_reference``) at every read position;
        measured when ``measure``: beside its bound (the live map and x,
        read once, the read positions written once) and the TPU layout's
        bound, and cuSPARSE on the live incidence.  Returns the TPU-form
        plain chunk sums (every position)."""
        torch, sg = self.torch, self.sg
        sl = d.slots
        pos = sl.pos.long()
        x = torch.as_tensor(x, dtype=torch.float64,
                            device=self.dev).contiguous().view(-1)
        ck = d.forward_live(x).reshape(-1)
        cl = d.forward_live(x, sg.live_slot_sums_reference).reshape(-1)
        x2 = d.prepare_x(x)
        ct = d.stream(x2, sg.gstream_chunk_sums_reference)
        self.sync()
        err = _agree(ck[pos], cl[pos])
        tpu_err = _agree(ck[pos], ct.reshape(-1)[pos])
        if not measure:
            return ct
        ms = self.call_ms(lambda: d.forward_live(x))
        plain_ms = self.call_ms(
            lambda: d.forward_live(x, sg.live_slot_sums_reference),
            repeats=10)
        b2b = self.back_to_back(lambda: d.forward_live(x))
        rows = torch.repeat_interleave(pos, sl.rowptr.diff().long(),
                                       output_size=sl.n_live)
        lib_ms = self.library_spmv(rows, sl.col.long(), sl.val,
                                   (sl.n_positions, x.numel()), x, cl)
        del rows
        nb = _nbytes(sl.pos, sl.rowptr, sl.col, sl.val) + \
            d.meta.nr_cols * 8 + sl.n_read * 8
        fwd = d.stream
        tpu_nb = _nbytes(fwd.values, fwd.meta16, fwd.step_window, x2, ct)
        tpu_ms = tpu_nb / (self.hbm * 1e6)
        self.record("live_slots_f64", tag, err, ms, plain_ms, nb,
                    2 * sl.n_live, lib_ms,
                    extra={"back_to_back_ms": b2b,
                           "tpu_layout_bound_ms": tpu_ms})
        print(f"  live_slots_f64 [{tag}]: {sl.n_read} read positions, "
              f"{sl.n_live} live slots of {fwd.values.numel()} "
              f"({sl.n_live / max(fwd.values.numel(), 1):.4f}), "
              f"{ms:.4f} ms a call, {b2b:.4f} back to back | vs the "
              f"TPU-form plain version at the read positions max abs "
              f"{tpu_err:.3e} | the TPU layout's bound {tpu_nb} B, "
              f"{tpu_ms:.4f} ms", flush=True)
        return ct

    def forward_multi(self, fwd, X, tag, measure=True):
        """The k-plane forward kernel vs its plain version (X row-major
        (padded_cols, k)); measured when ``measure``: beside its HBM bound,
        the bytes of its gathers (every slot that reads x gathers its row
        of X, k values; X at full size fits the L2), and the rate at which
        the kernel moved them.  Returns the plain chunk sums (n_positions,
        k)."""
        sg = self.sg
        ref = self.sp.gstream_chunk_sums_multi_reference
        ck, cr = fwd.forward_multi(X), fwd.forward_multi(X, ref)
        self.sync()
        err = _agree(ck, cr)
        if not measure:
            return cr
        ms = self.call_ms(lambda: fwd.forward_multi(X))
        plain_ms = self.call_ms(lambda: fwd.forward_multi(X, ref), repeats=10)
        b2b = self.back_to_back(lambda: fwd.forward_multi(X))
        rows, cols, vals, n_out = self._forward_incidence(fwd)
        lib_ms = self.library_spmv(rows, cols, vals, (n_out, X.shape[0]), X,
                                   cr)
        del rows, cols, vals
        nb = _nbytes(fwd.values, fwd.meta16, fwd.step_window, fwd.tile_base,
                     X, ck)
        name = ("gstream_spmm_f64" if X.dtype == self.torch.float64
                else "gstream_spmm")
        k = X.shape[1]
        _, ok = sg.forward_gather_index(fwd.meta16, fwd.step_window, T=fwd.T,
                                        G=fwd.G, GL=fwd.GL,
                                        tile_base=fwd.tile_base)
        live = int(ok.sum())
        gather = live * k * X.element_size()
        self.record(name, tag, err, ms, plain_ms, nb,
                    2 * fwd.values.numel() * k, lib_ms,
                    extra={"gather_bytes": gather,
                           "gather_gbps": gather / ms / 1e6})
        print(f"  {name} [{tag}]: k={k}, plane vectors of "
              f"{self.build.vector_width(k, X, ck)} values, "
              f"{b2b:.4f} ms back to back | gathers: {live} of "
              f"{ok.numel()} slots read x, {gather} B (X {_nbytes(X)} B), "
              f"moved at {gather / ms / 1e6:.0f} GB/s a call, "
              f"{gather / b2b / 1e6:.0f} back to back", flush=True)
        return cr

    def _final_incidence(self, final):
        """(rows, cols, shape) of a device final as one 0/1 sparse matrix,
        y row by position: what ``apply`` computes, every level and spill
        (the map's entries)."""
        rows = final.rows
        r = self.torch.repeat_interleave(
            self.torch.arange(rows.nr_rows, device=self.dev),
            rows.rowptr.diff().long(), output_size=rows.n_entries)
        return r, rows.idx.long(), (rows.nr_rows, rows.n_positions)

    def tpu_final(self, final, vec):
        """y (Y for k-plane positions) as the TPU layout computes it, in
        plain PyTorch: each level's grid over its TPU tables, uploaded for
        the call, sliced to nr_rows, its spills by ``index_add_``, the
        levels' ys added (f64 planes one at a time: the TPU layout's
        k-plane final takes f32 only)."""
        torch = self.torch
        if vec.dim() == 2 and vec.dtype == torch.float64:
            return torch.stack([self.tpu_final(final, vec[:, j].contiguous())
                                for j in range(vec.shape[1])], 1)
        nr, y = final.rows.nr_rows, None
        for lvl in getattr(final, "levels", [final]):
            t = lvl.tables(self.dev)
            yl = (lvl.grid(vec).reshape(-1) if vec.dim() == 1
                  else lvl.grid_multi(vec))[:nr]
            yl.index_add_(0, t.spill_row, vec[t.spill_pos])
            y = yl if y is None else y + yl
        return y

    def rows_build(self, final, tag):
        """``FinalRows.from_levels`` once more for ``final``, from its
        levels' TPU tables uploaded one level at a time, as the upload
        builds it; timed (host clock, synchronised): the set-up cost the
        upload pays."""
        torch = self.torch
        rows = final.rows
        levels = list(getattr(final, "levels", [final]))
        self.sync()
        t0 = time.perf_counter()
        again = self.fr.FinalRows.from_levels(
            (lvl.tables(self.dev) for lvl in levels), rows.nr_rows,
            rows.n_positions, self.dev)
        self.sync()
        dt = time.perf_counter() - t0
        if not (torch.equal(again.rowptr, rows.rowptr)
                and torch.equal(again.idx, rows.idx)):
            raise RuntimeError(f"{tag}: FinalRows built twice differ")
        lens = rows.rowptr.diff()
        tables = sum(_nbytes(*(v for v in vars(lvl.tables(self.dev)).values()
                               if torch.is_tensor(v))) for lvl in levels)
        kept = sum(_nbytes(b) for n, b in final.named_buffers()
                   if not (n.startswith("rows.") or ".rows." in n))
        mapb = _nbytes(rows.rowptr, rows.idx, rows.by_length, rows.long_rows)
        print(f"  FinalRows [{tag}]: {rows.nr_rows} rows, {rows.n_entries} "
              f"entries ({rows.n_entries / max(rows.nr_rows, 1):.3f} a row, "
              f"longest {int(lens.max()) if lens.numel() else 0}, "
              f"{int((lens == 0).sum())} empty), {rows.n_long} long rows, "
              f"from {len(levels)} levels and "
              f"{sum(lvl.n_spills for lvl in levels)} spills; built in "
              f"{dt:.4f} s (the tables' upload in); the map {mapb} B, the "
              f"TPU tables {tables} B, of which the device keeps {kept} B",
              flush=True)
        return dt

    def gather_sectors(self, rows, elt):
        """32 B sectors of vec the kernel's gathers touch, from the
        indices: distinct ones, and distinct ones a warp load summed (the
        short bin's thread a row: lane i of warp w at its row's j-th entry
        in load j; the int4 body ignored)."""
        torch = self.torch
        sec = rows.idx.long() * elt // 32
        row = torch.repeat_interleave(
            torch.arange(rows.nr_rows, device=self.dev),
            rows.rowptr.diff().long(), output_size=rows.n_entries)
        j = torch.arange(rows.n_entries, device=self.dev) - \
            rows.rowptr.long()[row]
        key = ((row // 32) * (int(j.max()) + 1 if j.numel() else 1) + j) * \
            (int(sec.max()) + 1 if sec.numel() else 1) + sec
        return (int(torch.unique(sec).numel()),
                int(torch.unique(key).numel()))

    def final(self, final, vec, tag, measure=True):
        """The row-sorted final (every level of a multi final, and the
        spills) vs its plain version and vs the TPU layout's plain final
        (each level's grid, its spills, the adds), on the position vector
        ``vec``.  Measured: the kernel, its plain version and cuSPARSE on
        the same 0/1 matrix with the spills."""
        torch, fr = self.torch, self.fr
        rows = final.rows
        yk, yr = final.apply(vec), final.apply(vec, fr.final_rows_reference)
        yt = self.tpu_final(final, vec)
        self.sync()
        err = _agree(yk, yr)
        _agree(yk, yt)
        del yt
        if not measure:
            return
        name = "final_rows_f64" if vec.dtype == torch.float64 \
            else "final_rows"
        build_s = self.rows_build(final, tag)
        n_launch = int(rows.n_long < rows.nr_rows) + int(rows.n_long > 0)
        ms = self.call_ms(lambda: final.apply(vec))
        plain_ms = self.call_ms(
            lambda: final.apply(vec, fr.final_rows_reference), repeats=10)
        r, c, shape = self._final_incidence(final)
        lib_ms, lib_b2b = self.library_spmv(
            r, c, torch.ones(r.numel(), dtype=vec.dtype, device=self.dev),
            shape, vec.reshape(-1)[:rows.n_positions], yr, back_to_back=True)
        del r, c
        b2b = self.back_to_back(lambda: final.apply(vec))
        elt = vec.element_size()
        nb = _nbytes(rows.rowptr, rows.idx, rows.long_rows) + \
            (rows.n_entries + rows.nr_rows) * elt
        self.record(name, tag, err, ms, plain_ms, nb, rows.n_entries, lib_ms)
        touched, requested = self.gather_sectors(rows, elt)
        print(f"  final [{tag}]: row-sorted {ms:.4f} ms a call, {b2b:.4f} "
              f"back to back ({n_launch} launches) | cuSPARSE "
              f"{lib_ms:.4f} ms, {lib_b2b:.4f} back to back | FinalRows "
              f"build {build_s:.4f} s | vec "
              f"sectors: {touched} touched ({touched * 32} B), {requested} "
              f"a warp load summed ({requested * 32} B; at "
              f"{self.hbm:.0f} GB/s {requested * 32 / self.hbm / 1e6:.4f} "
              f"ms)", flush=True)

    def final_multi(self, final, vec, tag, measure=True):
        """The row-sorted final on k planes (``apply_multi``) vs its plain
        version and vs the TPU layout's plain k-plane final, on the k-plane
        position vector ``vec`` (n_positions, k); measured (time, bound,
        cuSPARSE's SpMM on the same 0/1 matrix) when ``measure``."""
        torch, fr = self.torch, self.fr
        ref = fr.final_rows_multi_reference
        Yk, Yr = final.apply_multi(vec), final.apply_multi(vec, ref)
        Yt = self.tpu_final(final, vec)
        self.sync()
        err = _agree(Yk, Yr)
        _agree(Yk, Yt)
        del Yt
        if not measure:
            return
        rows, k = final.rows, vec.shape[1]
        name = "final_rows_multi_f64" if vec.dtype == torch.float64 \
            else "final_rows_multi"
        max_len = fr.short_max_multi(k // self.build.vector_width(k, vec,
                                                                   Yk))
        long_rows = rows.rows_over(max_len)
        n_long = long_rows.numel()
        n_launch = int(n_long < rows.nr_rows) + int(n_long > 0)
        ms = self.call_ms(lambda: final.apply_multi(vec))
        plain_ms = self.call_ms(lambda: final.apply_multi(vec, ref),
                                repeats=10)
        r, c, shape = self._final_incidence(final)
        lib_ms, lib_b2b = self.library_spmv(
            r, c, torch.ones(r.numel(), dtype=vec.dtype, device=self.dev),
            shape, vec[:rows.n_positions], Yr, back_to_back=True)
        del r, c
        b2b = self.back_to_back(lambda: final.apply_multi(vec))
        nb = _nbytes(rows.rowptr, rows.idx, long_rows) + \
            (rows.n_entries + rows.nr_rows) * k * vec.element_size()
        self.record(name, tag, err, ms, plain_ms, nb, rows.n_entries * k,
                    lib_ms)
        print(f"  {name} [{tag}]: k={k}, plane vectors of "
              f"{self.build.vector_width(k, vec, Yk)} values, {ms:.4f} ms a "
              f"call, {b2b:.4f} back to back ({n_launch} launches, {n_long} "
              f"rows past {max_len} entries) | plain "
              f"{plain_ms:.4f} ms | cuSPARSE {lib_ms:.4f} ms, {lib_b2b:.4f} "
              f"back to back", flush=True)

    def gstream_multi(self, d, X, tag, measure=True):
        """The k-plane kernels of one classic device's SpMM vs their plain
        versions: the forward, each F level's k planes (the same kernel),
        and the k-plane final."""
        cr = self.forward_multi(d.stream, d.prepare_x_multi(X), tag, measure)
        vec = d.positions_multi(cr, self.sp.gstream_chunk_sums_multi_reference)
        if len(d.flevels):
            vk = d.positions_multi(cr)
            self.sync()
            _agree(vk, vec)
            del vk
        if d.final is not None:
            self.final_multi(d.final, vec, tag, measure)

    def gstream(self, d, x, tag, measure=True):
        """Every kernel of one classic device vs its plain version."""
        sg = self.sg
        if isinstance(d, self.f64.DF64GStreamDevice):
            cr = self.live_forward(d, x, tag, measure)
        else:
            cr = self.forward(d.stream, d.prepare_x(x), tag, measure)
        # the F levels (the forward kernel on incidence packs) extend the
        # position vector: through the kernel and through the plain version
        vec = d.positions(cr, sg.gstream_chunk_sums_reference)
        vk = d.positions(cr)
        self.sync()
        if len(d.flevels):
            _agree(vk, vec)
        if d.final is not None:
            self.final(d.final, vec, tag, measure)

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
        """The fused SpMV (or, with ``multi``, SpMM on X (nr_cols, k)) kernel
        vs its plain version, timed in turns: the device's one launch (x
        unpadded for the SpMM, prepared for the SpMV; the spills, the live
        counts) beside its plain version (``spmv_blocks_reference``,
        ``spmm_blocks_reference``); the free wrapper (``fused_spmv``,
        ``fused_spmm``: no counts, no spills, x padded) is held to its
        plain version and timed beside it."""
        fused = self.fused
        if multi:
            name, k = "fused_spmm", x.shape[1]
            kern = lambda: dev.spmm_blocks(x)                   # noqa: E731
            plain = lambda: dev.spmm_blocks_reference(x)        # noqa: E731
            xf = dev.prepare_x_multi(x)
            free = lambda: dev.blocks_multi(xf)                 # noqa: E731
            free_ref = fused.fused_spmm_reference
        else:
            name, k = "fused_spmv", 1
            if dev.dtype == self.torch.float64:
                name = "fused_spmv_f64"
            kern = lambda: dev.spmv_blocks(x, x_is_packed=True)  # noqa: E731
            plain = lambda: dev.spmv_blocks_reference(x)        # noqa: E731
            xf = x
            free = lambda: dev.blocks(xf)                       # noqa: E731
            free_ref = fused.fused_spmv_reference
        yf = free()
        yfr = (dev.blocks_multi(xf, free_ref) if multi
               else dev.blocks(xf, free_ref))
        self.sync()
        free_ms = (self.call_ms(free), self.back_to_back(free))
        print(f"  {name} [{tag}]: the free wrapper vs its plain version "
              f"max abs {_agree(yf, yfr):.3e}, {free_ms[0]:.4f} ms a call, "
              f"{free_ms[1]:.4f} back to back", flush=True)
        del yf, yfr
        yk, yr = kern(), plain()
        self.sync()
        err = _agree(yk, yr)
        runs = {"kernel": [], "plain": []}
        for which, fn in (("plain", plain), ("kernel", kern),
                          ("kernel", kern), ("plain", plain)):
            runs[which].append((self.call_ms(fn), self.back_to_back(fn)))
        ms = {k: float(np.mean([a for a, _ in v])) for k, v in runs.items()}
        back = {k: float(np.mean([b for _, b in v])) for k, v in runs.items()}
        print(f"  {name} [{tag}]: back to back kernel {back['kernel']:.4f}"
              f" ms, plain {back['plain']:.4f} ms; host "
              f"{(ms['kernel'] - back['kernel']) * 1e3:.1f} us a call",
              flush=True)
        nb = _fused_bytes(dev, k, spills=True) + _nbytes(yk)
        extra = {"back_to_back_ms": back["kernel"]}
        if multi:
            # every forward slot whose x index lies inside X gathers its
            # row of X, k floats, from the L2
            idx = fused.forward_gather_index(
                {n: getattr(dev, n) for n in ("meta_i1", "meta_rt",
                                              "tile_base")}, dev.meta.GLW)
            gather = int((idx < dev.meta.nr_cols).sum()) * k * 4
            del idx
            extra.update(gather_bytes=gather,
                         gather_gbps=gather / ms["kernel"] / 1e6)
            print(f"  {name} [{tag}]: k={k}, plane vectors of "
                  f"{self.build.vector_width(k, x, yk)} floats, the one-pass "
                  f"bound {nb / (self.hbm * 1e6):.4f} ms | L2 gathers of X's "
                  f"rows {gather} B, moved at "
                  f"{gather / ms['kernel'] / 1e6:.0f} GB/s a call, "
                  f"{gather / back['kernel'] / 1e6:.0f} back to back",
                  flush=True)
        self.record(name, tag, err, ms["kernel"], ms["plain"], nb,
                    2 * dev.values.numel() * k, lib_ms, extra)

    def rows_kernel(self, dev, x, tag, lib_ms):
        """The rows kernel over an f32 device's row map (the device's own,
        or one built here where its rule kept #1) vs its plain version and
        #1's y; then the two kernels timed in turns (#1, rows, rows, #1),
        each the device's launch on x unpadded (#1 with its memset), a
        call and back to back, beside the map's bound and the pick of the
        device's byte rule (``FusedDevice.traffic``)."""
        rows, torch = self.rows, self.torch
        cuda = self.dev.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
            before = torch.cuda.memory_allocated(self.dev)
        t0 = time.perf_counter()
        built = rows.FusedRows.build(dev)
        self.sync()
        build_s = time.perf_counter() - t0
        # the build's peak beyond what the card held before it, the map
        # included, beside the pack it reads (``FusedDevice.bytes_a_call``
        # of a "tiles" device)
        peak = torch.cuda.max_memory_allocated(self.dev) - before if cuda \
            else float("nan")
        pack = dev.meta.storage_bytes()
        rm = dev.rows if dev.rows is not None else built
        kern = lambda: rows.fused_rows_spmv(x, rm)              # noqa: E731
        plain = lambda: rows.fused_rows_spmv_reference(x, rm)  # noqa: E731
        tiles = lambda: dev.spmv_blocks(x)                      # noqa: E731
        yk, yr, yt = kern(), plain(), dev._rows(tiles())
        self.sync()
        err = _agree(yk, yr)
        err_tiles = _agree(yk, yt)
        runs = {"rows": [], "tiles": []}
        for which, fn in (("tiles", tiles), ("rows", kern), ("rows", kern),
                          ("tiles", tiles)):
            runs[which].append((self.call_ms(fn), self.back_to_back(fn)))
        ms = {k: float(np.mean([a for a, _ in v])) for k, v in runs.items()}
        back = {k: float(np.mean([b for _, b in v]))
                for k, v in runs.items()}
        plain_ms = self.call_ms(plain, repeats=5)
        traffic = dev.traffic()
        pick = self.fused.pick_kernel(traffic)
        faster = min(back, key=back.get)
        print(f"  fused_rows [{tag}]: map of {rm.n_rows} rows, {rm.n_live} "
              f"entries, {rm.width} lanes a row, {rm.long_rows.numel()} "
              f"long rows, built in {build_s:.3f} s, peak {peak} B beside "
              f"the map's {built.nbytes} B and the pack's {pack} B; vs #1's "
              f"y max abs "
              f"{err_tiles:.3e} | back to back: rows {back['rows']:.4f} ms, "
              f"#1 {back['tiles']:.4f} ms; a call: rows {ms['rows']:.4f}, "
              f"#1 {ms['tiles']:.4f} | byte rule: tiles {traffic['tiles']} "
              f"B, rows {traffic['rows']} B -> {pick!r}, the faster is "
              f"{faster!r} ({'agrees' if pick == faster else 'DISAGREES'})",
              flush=True)
        # the record of the first path whose device runs the rows kernel
        prior = self.records.get("fused_rows")
        self.record("fused_rows", tag, err, ms["rows"], plain_ms, rm.nbytes,
                    2 * rm.n_live, lib_ms,
                    {"tag": tag, "device_kernel": dev.kernel,
                     "back_to_back_ms": back["rows"],
                     "tiles_ms": ms["tiles"],
                     "tiles_back_to_back_ms": back["tiles"],
                     "pick": pick, "build_s": build_s,
                     "build_peak_bytes": peak, "pack_bytes": pack},
                    replace=dev.kernel == "rows" and (
                        prior is None or prior["device_kernel"] != "rows"))

    def launches_a_call(self, tag, fn):
        """(kernel launches, memsets) in one call of ``fn``, from a
        profiler trace of that call alone: the host's record of its
        runtime calls, which holds every launch, beside the card's record,
        printed by name where it is whole (``traced``); raises when the
        two disagree."""
        if self.dev.type != "cuda":
            return None
        fn()
        self.sync()
        ev, _, whole, host = traced(self.torch, fn)
        memsets = sum("memset" in e.name.lower() for e in ev)
        dev = (len(ev) - memsets, memsets)
        print(f"  launches [{tag}]: {host[0]} kernel launch(es) and "
              f"{host[1]} memset(s) in one call (the host's API record); "
              f"on the card "
              + (f"{sorted(e.name[:48] for e in ev)}" if whole else
                 f"no whole record in {len(TRACE_PAD_S)} tries"),
              flush=True)
        if whole and dev != host:
            raise RuntimeError(f"launches [{tag}]: the card recorded {dev}, "
                               f"the host's API {host}")
        return host

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
        self.whole[tag] = (ms, lib_ms)
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
        self.calls[tag] = (ms, per_col, lib_ms)
        work = m.nr_nzeros * k / 1e6
        print(f"  {tag}: SparseMatrix @ X (k={k}) {ms:.4f} ms a call "
              f"({work / ms:.2f} Gnnz/s) | {k} x SparseMatrix @ x "
              f"{per_col:.4f} ms ({work / per_col:.2f} Gnnz/s) | "
              f"torch.sparse_csr @ X (cuSPARSE) {lib_ms:.4f} ms "
              f"({work / lib_ms:.2f} Gnnz/s)", flush=True)
        return lib_ms

    def profile(self, tag, fn, calls=10):
        """Device time by kernel over ``calls`` calls of ``fn`` (a
        torch.profiler trace, ``traced``), and the share of the window the
        card was busy.  Reporting only: a profiler that fails prints why."""
        if self.dev.type != "cuda":
            return
        try:
            fn()
            self.sync()
            ev, wall_us, whole, host = traced(
                self.torch, lambda: [fn() for _ in range(calls)],
                TRACE_PAD_S[:2])
        except Exception as e:          # noqa: BLE001
            print(f"  profile [{tag}]: not available ({e!r})", flush=True)
            return
        by_name = {}
        for e in ev:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        rows = sorted(((us / calls, n / calls, name)
                       for name, (us, n) in by_name.items()), reverse=True)
        busy = sum(r[0] for r in rows)
        print(f"  profile [{tag}]: {busy:.1f} us of device time a call, "
              f"busy {busy * calls / wall_us:.3f} of the window "
              f"({calls} calls, host clock, "
              f"{'whole' if whole else 'NOT whole'} trace); "
              f"{host[0] / calls:g} launches and {host[1] / calls:g} "
              f"memsets a call (the host's API record)", flush=True)
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


def _device_call_agrees(s, dev, x) -> float:
    """The device's one launch on x unpadded against its plain version
    (``spmv_blocks_reference``); the max abs difference."""
    xt = s.torch.as_tensor(x, dtype=dev.dtype, device=s.dev)
    yk = dev.spmv_blocks(xt)
    s.sync()
    return _agree(yk, dev.spmv_blocks_reference(xt))


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
        dev_err = _device_call_agrees(s, dev, x)
        y = dev.spmv(x2, x_is_packed=True).cpu().numpy()
        _gold_errors(h, m, x, y)
        print(f"fused regime {tag}: Q={p.Q} T={p.T} steps={p.n_steps} "
              f"SGRP={p.SGRP} fin_direct={p.fin_direct} slabs={p.n_slabs} "
              f"spills={p.spill_row.size} | kernel vs plain max abs "
              f"{err:.3e} rel {rel:.3e}; the device's one launch (x "
              f"unpadded, live counts, spills) vs its plain version "
              f"{dev_err:.3e} | vs spmv_gold 0 errors", flush=True)
        errs, dev_errs = [], []
        for k in (1, 3, 8):
            X = _X(m.nr_cols, k, seed=k)
            Xp = dev.prepare_x_multi(X)
            yk = dev.blocks_multi(Xp)
            yr = dev.blocks_multi(Xp, fused.fused_spmm_reference)
            s.sync()
            errs.append(_agree(yk, yr))
            Xt = s.torch.as_tensor(X, dtype=s.torch.float32, device=s.dev)
            yk = dev.spmm_blocks(Xt)
            s.sync()
            dev_errs.append(_agree(yk, dev.spmm_blocks_reference(Xt)))
            _gold_errors_multi(s, m, X, dev.spmm(Xt))
            _gold_errors_multi(s, m, X, dev.spmm(Xp, x_is_packed=True))
        print(f"fused regime {tag}, SpMM k=1,3,8: the free wrapper vs plain "
              f"max abs {max(errs):.3e}; the device's one launch (X "
              f"unpadded, live counts, spills) vs its plain version "
              f"{max(dev_errs):.3e} | vs spmm_gold 0 errors", flush=True)


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
        d = sg.GStreamDevice(h.pack_gstream(m, **kw), value_dtype=vdt,
                             device=s.dev)
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
        d = sg.GStreamDevice(h.pack_gstream(m), device=s.dev)
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
    """The fused regimes with f64 values: the f64 fused kernel (its free
    wrapper and the device's one launch) vs its plain version, and y (Y at
    k = 1, 3, 8: one f64 SpMV a column) vs the gold."""
    h, fused, torch = s.h, s.fused, s.torch
    f64 = np.float64
    cases = _fused_cases(s, f64)
    for tag, m, kw, regime in cases:
        packs = fused._fused_df64_packs(m, **kw)
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
        dev_err = _device_call_agrees(s, dev, x)
        for k in (1, 3, 8):
            X = _X(m.nr_cols, k, seed=k)
            _gold_errors_multi(s, m, X, s.f64.spmm_df64(dev, torch.as_tensor(
                X, device=s.dev)), f64)
        print(f"f64 fused regime {tag}: Q={p.Q} T={p.T} steps={p.n_steps} "
              f"SGRP={p.SGRP} fin_direct={p.fin_direct} F1S={p.F1S} "
              f"spills={p.spill_row.size} | the free wrapper vs plain max "
              f"abs {err:.3e}, the device's one launch vs its plain version "
              f"{dev_err:.3e} | y and Y (k=1,3,8) vs the gold 0 errors",
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


def final_rows_bins(s, small):
    """The row-sorted final's threshold ``SHORT_MAX`` on the card: on
    uniform rows of 4 to 4096 entries at random positions (4M entries, an
    8M-position vec, from a seed), its two launches over every row, a
    thread a row against a warp a row, each held to the plain version."""
    import ctypes

    from sparsetpu_torch.kernels._build import check, library
    torch, fr = s.torch, s.fr
    lib = library().lib
    stream = ctypes.c_void_p(torch.cuda.current_stream(s.dev).cuda_stream)
    n_pos, n_ent = (1 << 16, 1 << 15) if small else (1 << 23, 1 << 22)
    g = torch.Generator(device=s.dev).manual_seed(0)
    v = torch.randn(n_pos, generator=g, device=s.dev)
    times = []
    for length in (4, 8, 16, 32, 64, 512, 4096):
        nr = n_ent // length
        rowptr = torch.arange(nr + 1, dtype=torch.int32,
                              device=s.dev) * length
        idx = torch.randint(0, n_pos, (nr * length,), generator=g,
                            dtype=torch.int32, device=s.dev)
        rows = fr.FinalRows(rowptr, idx, n_pos)
        every = torch.arange(nr, dtype=torch.int32, device=s.dev)
        yr = fr.final_rows_reference(v, rows)
        y = torch.empty_like(yr)

        def launch(lst):
            # rows null: a thread a row over every row (max_len -1: none
            # left to the long launch); a row list: a warp a row over it
            check(lib, lib.final_rows_launch(
                ctypes.c_void_p(rowptr.data_ptr()),
                ctypes.c_void_p(idx.data_ptr()),
                ctypes.c_void_p(v.data_ptr()),
                ctypes.c_void_p(lst.data_ptr() if lst is not None else 0),
                nr, -1, ctypes.c_void_p(y.data_ptr()), stream),
                "final_rows launch")
            return y

        ms = []
        for lst in (None, every):
            _agree(launch(lst), yr)
            ms.append(s.back_to_back(lambda: launch(lst)))
        times.append(f"{length}: {ms[0]:.4f} / {ms[1]:.4f}")
    print(f"  final_rows: uniform rows, {n_ent} entries over {n_pos} "
          f"positions, length: a thread a row / a warp a row, ms back to "
          f"back: {', '.join(times)} (SHORT_MAX {fr.SHORT_MAX})", flush=True)


def final_rows_multi_bins(s, small):
    """The k-plane form's threshold ``short_max_multi`` on the card: on
    uniform rows of 4 to 4096 entries at random positions (from a seed), at
    k = 8 (4M entries over 8M positions) and k = 72 (1M over 1M), its short
    launch over every row (a group of k / 4 threads a row) against its long
    launch over every row (a warp per row and plane vector), each held to
    the plain version."""
    import ctypes

    from sparsetpu_torch.kernels._build import check, library
    torch, fr = s.torch, s.fr
    lib = library().lib
    stream = ctypes.c_void_p(torch.cuda.current_stream(s.dev).cuda_stream)
    g = torch.Generator(device=s.dev).manual_seed(1)
    for k, n_pos, n_ent in ((8, 1 << 23, 1 << 22), (72, 1 << 20, 1 << 20)):
        if small:
            n_pos, n_ent = n_pos >> 6, n_ent >> 6
        v = torch.randn(n_pos, k, generator=g, device=s.dev)
        times = []
        for length in (4, 8, 16, 32, 64, 512, 4096):
            nr = n_ent // length
            rowptr = torch.arange(nr + 1, dtype=torch.int32,
                                  device=s.dev) * length
            idx = torch.randint(0, n_pos, (nr * length,), generator=g,
                                dtype=torch.int32, device=s.dev)
            rows = fr.FinalRows(rowptr, idx, n_pos)
            every = torch.arange(nr, dtype=torch.int32, device=s.dev)
            Yr = fr.final_rows_multi_reference(v, rows)
            Y = torch.empty_like(Yr)

            def launch(lst):
                # rows null: k / 4 threads a row over every row (max_len
                # -1: none left to the long launch); a row list: a warp
                # per (row, plane vector) over it
                check(lib, lib.final_rows_multi_launch(
                    0, ctypes.c_void_p(rowptr.data_ptr()),
                    ctypes.c_void_p(idx.data_ptr()),
                    ctypes.c_void_p(v.data_ptr()),
                    ctypes.c_void_p(lst.data_ptr() if lst is not None
                                    else 0),
                    nr, -1, k, 4, ctypes.c_void_p(Y.data_ptr()), stream),
                    "final_rows_multi launch")
                return Y

            ms = []
            for lst in (None, every):
                _agree(launch(lst), Yr)
                ms.append(s.back_to_back(lambda: launch(lst)))
            times.append(f"{length}: {ms[0]:.4f} / {ms[1]:.4f}")
            del rows, idx, Yr, Y
        print(f"  final_rows_multi: k={k}, uniform rows, {n_ent} entries "
              f"over {n_pos} positions, length: a group a row / a warp a "
              f"plane vector, ms back to back: {', '.join(times)} "
              f"(short_max_multi {fr.short_max_multi(k // 4)})", flush=True)
        del v


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
            d = s.bsr.BSRDevice(b, device=s.dev)
        finally:
            fl._FinalLevel.build = build
        if (d.final is None) != seg:
            raise RuntimeError(f"bsr regime {tag}: {describe_bsr(d)}")
        x = np.random.default_rng(3).standard_normal(m.nr_cols)
        xt = torch.as_tensor(x, dtype=torch.float32, device=s.dev)
        expected = {"bsr_partials"} | (
            {"final_rows"} if d.final is not None else set())
        y = s.drive(f"bsr regime {tag}", lambda: d.spmv(xt), expected,
                    main=False)
        _gold_errors(h, m, x, y.cpu().numpy())
        parts = s.bsr_kernel(d, d.prepare_x(xt), tag, measure=False)
        if d.final is not None:
            s.final(d.final, parts.reshape(-1), tag, measure=False)
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
    d = st.BSRDevice(b, device=s.dev)
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
    rows = d.final.rows
    n_fin = int(rows.n_long < rows.nr_rows) + int(rows.n_long > 0)
    y = s.drive(tag, lambda: d.spmv(xt), {"bsr_partials", "final_rows"})
    counts = s._counts()
    if s.dev.type == "cuda" and (counts["bsr_partials"] != 1 or
                                 counts["final_rows"] != n_fin):
        raise RuntimeError(f"{tag}: expected one launch of #14 and {n_fin} "
                           f"of the final, got {counts}")
    if tuple(y.shape) != (m.nr_rows,) or not bool(y.isfinite().all()):
        raise RuntimeError(f"{tag}: bad y, shape {tuple(y.shape)}")
    _gold_errors(h, m, x, y.cpu().numpy())
    print(f"{tag}: 0 errors vs spmv_gold", flush=True)
    parts = s.bsr_kernel(d, d.prepare_x(xt), tag)
    s.final(d.final, parts.reshape(-1), tag)
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
                  {"bsr_partials", "final_rows"})
    wall = time.perf_counter() - t1
    counts = s._counts()
    k = res.iterations
    if s.dev.type == "cuda" and (
            counts["bsr_partials"] != k + 1 or
            counts["final_rows"] != (k + 1) * n_fin):
        raise RuntimeError(f"{tag}: expected {k + 1} launches of #14 and "
                           f"{(k + 1) * n_fin} of the final (one an SpMV), "
                           f"got {counts}")
    xs = res.x.cpu().numpy().astype(np.float64)
    rel = float(np.linalg.norm(1.0 - h.spmv_gold(m, xs)) /
                np.sqrt(m.nr_rows))
    if not rel <= 1e-4 or k >= 2000:
        raise RuntimeError(f"{tag}: ||b - A x|| / ||b|| {rel:.3e} after {k}"
                           f" iterations")
    print(f"{tag}: {k} iterations, {wall * 1e3 / max(k, 1):.4f} ms an "
          f"iteration (host clock, the loop's scalar syncs included), "
          f"||b - A x|| / ||b|| {rel:.3e} (f64, spmv_gold), #14 launched "
          f"{k + 1} times, the row-sorted final {(k + 1) * n_fin}",
          flush=True)
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
        # the kernels of the event matrix's device, which ``sa @ b`` builds
        # again the same (its pick of #1 or the rows kernel)
        ev = st.SpGEMMPlan(a, b, device=s.dev).event_matrix
        expected = s.kernels_of(ev.device_module) if ev is not None \
            else set()
        for operand, name in ((b, "CSR"), (st.SparseMatrix(b, device=s.dev),
                                          "SparseMatrix")):
            c = s.drive(f"{tag} ({name})", lambda: sa @ operand, expected,
                        main=False)
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
    if getattr(d, "final", None) is not None:
        s.rows_build(d.final, tag + ", event matrix")
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
    same inputs, beside its bound and one library call: for ``stream``
    ``torch.sum`` of the value stream, for every other stage cuSPARSE on
    its incidence with xw."""
    torch, micro = s.torch, s.micro
    n, T = (256 if small else micro.LADDER_TILES), 16
    tag = f"micro ladder ({n} tiles, {T} a block)"
    res = s.drive(tag, lambda: micro.bench_ladder(
        n, T, LADDER_GS, device=s.dev),
        {f"ladder_{k}" for k in LADDER_STAGES})
    inp = micro.ladder_inputs(n, LADDER_GS, T, s.dev)
    val, idx, xw, base = inp["val"], inp["idx"], inp["xw"], inp["base"]
    gather_lib = {}      # window-G and window-G-smem share one function
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
        else:
            key = (stage.split("-")[0], G)
            if key not in gather_lib:
                gather_lib[key] = _ladder_library_ms(s, args, G, T, yr)
            lib_ms = gather_lib[key]
        flops = n * 1024 * (1 if stage in ("stream", "lane") else 2)
        s.record(f"ladder_{name}", tag, err, res[name][0], plain_ms,
                 _nbytes(*streams, yk), flops, lib_ms)
    print(f"phase {tag}: {time.perf_counter() - t0:.1f} s", flush=True)


def _ladder_library_ms(s, args, G, T, ref):
    """cuSPARSE's product of one stage's incidence with xw (tile output by
    xw position, zero values dropped), checked against the plain output
    ``ref``; its time.  A gather stage's slots read ``ladder_index``'s
    addresses; the lane stage's read xw[0, 0], each with the value its
    route picks (a row's 8 slots coalesce into one entry)."""
    torch, d = s.torch, s.dev
    stage, val, idx = args[:3]
    if stage == "lane":
        j = idx.view(-1, 8, 128).long() & 127
        vals = torch.gather(val.view(j.shape), 2, j)
        i, ok = torch.zeros_like(j), torch.ones_like(j, dtype=torch.bool)
    else:
        i, ok = s.micro.ladder_index(*args, G=G, T=T)
        vals = val.view(i.shape)
    rows = (torch.arange(i.shape[0], device=d).view(-1, 1, 1) * 128
            + torch.arange(128, device=d)).expand_as(i)
    keep = ok & (vals != 0)
    xw = args[4]
    return s.library_spmv(rows[keep], i[keep], vals[keep],
                          (i.shape[0] * 128, xw.numel()), xw.reshape(-1),
                          ref.reshape(-1))


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
                True, n_tiles=n, device=s.dev, timer=_cpu_timer(s)),
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
    fwd = types.SimpleNamespace(values=val, meta16=args[1], step_window=sw,
                                T=128, G=8, GL=0, tile_base=None, P=4)
    rows, cols, vals, n_out = s._forward_incidence(fwd)
    lib_ms = s.library_spmv(rows, cols, vals, (n_out, xw0.numel()),
                            xw0.reshape(-1), cr.reshape(-1))
    print(f"  {tag}: #3 at G=8 Q=2 {ms:.4f} ms back to back, cuSPARSE on "
          f"its chunk incidence {lib_ms:.4f} ms", flush=True)
    s.record("rates_forward", tag + ", G=8 Q=2", err, ms, plain_ms,
             _nbytes(*args, ck), 2 * val.numel(), lib_ms)
    del val, xw0, metas, args, ck, cr

    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    xt = torch.as_tensor(x, dtype=torch.float32, device=s.dev)
    t1 = time.perf_counter()
    card = s.st.GStreamDevice(h.pack_gstream(
        m, h.SpmvConfig(dtype=np.float32), rates=table), device=s.dev)
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


# the phases of ``bench_fused_stages`` that split #1 on one pack (its
# ``blocks+flat`` and ``blocks+flat+slice`` are views of ``blocks`` here: no
# device work, nothing to time)
STAGE_SPLIT = ("fwd", "fwd_s1", "blocks", "dev.spmv")


def _stage_incidence(s, key, a):
    """(rows, cols, values, n_out) of one stage-split kernel on its
    arguments ``a`` as one sparse matrix over x2 (the ladder's over xw),
    zero values dropped, through the port's own gather indexes: ``fwd``
    chunk sum by x2 position; ``fwd_s1`` row partial by x2 position, each
    stage-1 cell composed with the Q forward slots of the chunk it reads;
    ``ladder:<variant>`` tile output by xw position (for ``no-sum`` sublane
    0 alone, its output on finite inputs)."""
    torch, d, fs = s.torch, s.dev, s.fs
    lanes = torch.arange(128, device=d)
    if key.startswith("ladder:"):
        kind, glw = fs.LADDER_VARIANTS[key.split(":", 1)[1]]
        return _tile_incidence(s, kind, glw, a,
                               1 if kind == "no-sum" else 8)
    T, P = a["T"], a["P"]
    idx = fs.forward_index(*(a[k] for k in ("values", "meta_i1", "meta_rt",
                                            "tile_base", "x2")),
                           T=T, GLW=a["GLW"], P=P)
    n, Q = idx.shape[0], 8 // P
    vals = a["values"].view(idx.shape)
    if key == "fwd":
        rows = ((torch.arange(n, device=d).view(-1, 1, 1) * P
                 + torch.arange(8, device=d).view(1, -1, 1) // Q) * 128
                + lanes).expand_as(idx)
        keep = vals != 0
        return rows[keep], idx[keep], vals[keep], n * P * 128
    # fwd_s1: cell (i, f, s, l) reads chunk r of step i at lane j, the sum
    # of tile i*T + r // P's sublanes (r % P)*Q .. + Q-1 at lane j
    n_steps, F1_max, F1S = n // T, a["F1_max"], a["F1S"]
    F1A = a["fin1_i1"].shape[0] // (n_steps * 8)
    src, ok = s.fused.finish_gather_index(a, n_steps, T * P, "fin1", F1_max,
                                          F1A)
    r, j = src // 128, src % 128
    step = torch.arange(n_steps, device=d).view(-1, 1, 1, 1)
    first = ((step * T + r // P) * 8 + (r % P) * Q) * 128 + j
    slot = first.unsqueeze(-1) + torch.arange(Q, device=d) * 128
    out = ((step * F1S + torch.arange(F1_max, device=d).view(1, -1, 1, 1))
           * 128 + lanes).expand_as(first).unsqueeze(-1).expand_as(slot)
    keep = ok.unsqueeze(-1).expand_as(slot)
    slot, out = slot[keep], out[keep]
    cols, vals = idx.reshape(-1)[slot], vals.reshape(-1)[slot]
    keep = vals != 0
    return out[keep], cols[keep], vals[keep], n_steps * F1S * 128


def _tile_incidence(s, kind, glw, a, sublanes=8):
    """(rows, cols, values, n_out) of the ladder kernel's ``kind`` at
    ``glw`` on its arguments ``a`` as one sparse matrix over xw: tile
    output by xw position (``tile_gather_index``), the first ``sublanes``
    of each tile, zero values dropped."""
    torch, d = s.torch, s.dev
    idx = s.fs.tile_gather_index(kind, glw, *(a[k] for k in TILE_ARGS))
    n = idx.shape[0]
    rows = (torch.arange(n, device=d).view(-1, 1, 1) * 128
            + torch.arange(128, device=d)).expand_as(idx)
    vals = a["values"].view(idx.shape)
    idx, rows, vals = (t[:, :sublanes] for t in (idx, rows, vals))
    keep = vals != 0
    return rows[keep], idx[keep], vals[keep], n * 128


def _stage_library_ms(s, key, a, ref):
    """cuSPARSE's product of ``_stage_incidence`` with x2 (xw), checked
    against the plain output ``ref``; its time."""
    rows, cols, vals, n_out = _stage_incidence(s, key, a)
    x = (a["xw"] if key.startswith("ladder:") else a["x2"]).reshape(-1)
    return s.library_spmv(rows, cols, vals, (n_out, x.numel()), x,
                          ref.reshape(-1))


def _stage_split(s, tag, m, inp, profile):
    """The stage split of one pack driven as a main path (with
    ``FusedDevice.spmv`` under a profiler trace when ``profile``), the
    forward kernels held to their plain versions, y from ``spmv`` held to
    the gold; returns the phases."""
    fs = s.fs
    dev = inp["device"]
    p = dev.meta
    expected = {"stages_fwd", "fused_spmv"} | (
        set() if p.fin_direct else {"stages_fwd_s1"})
    with tempfile.TemporaryDirectory() as prof:
        res = s.drive(tag, lambda: fs.bench_fused_stages(
            dev, device=s.dev, only=STAGE_SPLIT,
            profile_dir=prof if profile else None, timer=_cpu_timer(s),
            verbose=True), expected)
    if profile:
        s.profile(tag + ", spmv", lambda: dev.spmv(inp["x2"],
                                                   x_is_packed=True))
    for key, fn, ref in (
            ("fwd", fs.fused_forward, fs.fused_forward_reference),
            ("fwd_s1", fs.fused_forward_stage1,
             fs.fused_forward_stage1_reference)):
        if inp[key] is not None:
            yk, yr = fn(**inp[key]), ref(**inp[key])
            s.sync()
            print(f"  {tag}: {key} kernel vs plain max abs "
                  f"{_agree(yk, yr):.3e}", flush=True)
    x = np.random.default_rng(0).standard_normal(m.nr_cols)  # stage_inputs'
    y = dev.spmv(inp["x2"], x_is_packed=True)
    s.sync()
    if tuple(y.shape) != (m.nr_rows,) or not bool(y.isfinite().all()):
        raise RuntimeError(f"{tag}: bad y, shape {tuple(y.shape)}")
    _gold_errors(s.h, m, x, y.cpu().numpy())
    b2b = {k: v["stream_ms"] for k, v in res.items() if "stream_ms" in v}
    blocks, spmv = b2b["blocks"], b2b["dev.spmv"]
    first = "fwd_s1" if "fwd_s1" in b2b else "fwd"
    parts = [("forward and stage 1" if first == "fwd_s1" else "forward",
              b2b[first]),
             ("stage 2 with its atomics", blocks - b2b[first]),
             ("assembly", spmv - blocks)]
    print(f"  {tag}: y {tuple(y.shape)}, 0 errors vs spmv_gold; back to "
          f"back, dev.spmv {spmv:.4f} ms = "
          + " + ".join(f"{k} {v:.4f}" for k, v in parts) + " ms; the "
          f"forward alone, its sums copied out, {b2b['fwd']:.4f} ms",
          flush=True)
    return res


def fused_stages_main(s, small, t0):
    """#17, #18, #19 and #26 on the card: ``bench_fused_stages`` as the
    main path, in three drives at the headline (the split, with #1 and
    ``spmv``; the forward at #17's other tile-base inputs; the tile ladder
    at 128 and 16 tiles a block) and the split on the pwtk stand-in; then
    each kernel held to its plain version, beside its bound and cuSPARSE's
    product of its incidence (``_stage_incidence``) with x."""
    fs = s.fs
    if tuple(fs.LADDER_VARIANTS) != STAGE_LADDER:
        raise RuntimeError(f"the ladder's variants are "
                           f"{list(fs.LADDER_VARIANTS)}, not STAGE_LADDER")
    m, label = fs.stage_matrix("headline", small=small)
    inp = fs.stage_inputs(m, s.dev)
    dev = inp["device"]
    p = dev.meta
    print(f"fused stages: {label}, nnz {m.nr_nzeros}, packed and uploaded "
          f"in {time.perf_counter() - t0:.1f} s: {fs.describe(dev)}",
          flush=True)
    if p.fin_direct:
        raise RuntimeError("headline: expected a finish stage 1")
    tag = "fused stages (headline)"
    res = _stage_split(s, tag, m, inp, profile=True)
    ms1 = res["blocks"]["stream_ms"]
    print(f"  #1 (fused_spmv) back to back {ms1:.4f} ms, recorded "
          f"{FUSED_BACK_TO_BACK_REF_MS} ms: "
          f"{ms1 / FUSED_BACK_TO_BACK_REF_MS - 1:+.2%}", flush=True)
    res.update(s.drive(tag + ", tile bases", lambda: fs.bench_fused_stages(
        dev, device=s.dev, only=["bases"], timer=_cpu_timer(s),
        verbose=True),
        {"stages_fwd_tile_bases"},
        rename={"stages_fwd": "stages_fwd_tile_bases"}))
    res.update(s.drive(tag + ", tile ladder", lambda: fs.bench_fused_stages(
        dev, device=s.dev, only=["ladder"], tiles_per_block=16,
        timer=_cpu_timer(s), verbose=True),
        {f"stages_ladder_{v}" for v in STAGE_LADDER}))

    # each kernel against its plain version on the path's inputs
    f, s1 = inp["fwd"], inp["fwd_s1"]
    slots = f["values"].numel()
    bases = fs.tile_base_variants(dev)
    for name, key, args in (
            ("stages_fwd", "fwd", f),
            ("stages_fwd_tile_bases", "fwd@random",
             dict(f, **bases["random"])),
            ("stages_fwd_s1", "fwd_s1", s1)):
        kern, ref = ((fs.fused_forward_stage1,
                      fs.fused_forward_stage1_reference) if key == "fwd_s1"
                     else (fs.fused_forward, fs.fused_forward_reference))
        yk, yr = kern(**args), ref(**args)
        s.sync()
        err = _agree(yk, yr)
        lib_ms = _stage_library_ms(s, key.split("@")[0], args, yr)
        plain_ms = s.call_ms(lambda: ref(**args), repeats=10)
        flops = 2 * slots + (p.n_steps * p.F1_max * 1024
                             if key == "fwd_s1" else 0)
        s.record(name, f"{tag}, {key}, back to back", err,
                 res[key]["stream_ms"], plain_ms, res[key]["bytes"], flops,
                 lib_ms)
    for v in fs.TILE_BASE_VARIANTS[1:]:
        a = dict(f, **bases[v])
        yk, yr = fs.fused_forward(**a), fs.fused_forward_reference(**a)
        s.sync()
        r = res[f"fwd@{v}"]
        print(f"  fwd@{v}: {r['stream_ms']:.4f} ms back to back "
              f"({r['call_ms']:.4f} a call), kernel vs plain max abs "
              f"{_agree(yk, yr):.3e}", flush=True)

    L = fs.tile_ladder_inputs(p.n_steps if s.dev.type == "cuda" else 2,
                              device=s.dev)
    n_tiles = L["tile_base"].numel()
    for v in STAGE_LADDER:
        errs = []
        for T in (128, 16):
            a = dict(L, tile_base=L["tile_base"].view(-1, T))
            yk, yr = fs.tile_ladder(v, **a), fs.tile_ladder_reference(v, **a)
            s.sync()
            errs.append(_agree(yk, yr))
        plain_ms = s.call_ms(lambda v=v: fs.tile_ladder_reference(v, **L),
                             repeats=10)
        lib_ms = _stage_library_ms(s, f"ladder:{v}", L,
                                   fs.tile_ladder_reference(v, **L))
        wide, fine = res[f"ladder:{v}@128"], res[f"ladder:{v}@16"]
        print(f"  ladder {v}: {n_tiles // 128} blocks of 128 tiles "
              f"{wide['stream_ms']:.4f} ms, {n_tiles // 16} blocks of 16 "
              f"{fine['stream_ms']:.4f} ms back to back (bound "
              f"{wide['bound_ms'] or float('nan'):.4f} ms)", flush=True)
        s.record(f"stages_ladder_{v}", f"{tag}, ladder, 128 tiles a block, "
                 f"back to back", max(errs), wide["stream_ms"], plain_ms,
                 wide["bytes"], 2 * n_tiles * 1024, lib_ms)
    del inp, dev, L, bases

    # the same split on a SuiteSparse stand-in whose pack has a stage 1
    name = "scircuit" if small else "pwtk"
    t1 = time.perf_counter()
    m, label = fs.stage_matrix(name)
    inp = fs.stage_inputs(m, s.dev)
    print(f"fused stages: {label}, {m.nr_rows}x{m.nr_cols} nnz "
          f"{m.nr_nzeros}, made, packed and uploaded in "
          f"{time.perf_counter() - t1:.1f} s: fin_direct "
          f"{inp['device'].meta.fin_direct}; {fs.describe(inp['device'])}",
          flush=True)
    _stage_split(s, f"fused stages ({name})", m, inp, profile=False)
    print(f"phase fused stages: {time.perf_counter() - t0:.1f} s", flush=True)


def _proto_incidence(s, a):
    """(rows, cols, values, n_out) of #20 on its arguments ``a`` as one
    sparse matrix over xw: each final slot's 0/1 read of a scratch row
    composed with the 8 forward slots that row sums (``proto_indexes``),
    zero values dropped."""
    torch, d = s.torch, s.dev
    ix = s.fp.proto_indexes(**a)
    n_out = ix["fin_src"].shape[0]
    tile = (ix["fin_src"] // 128).unsqueeze(-1)
    j = (ix["fin_src"] % 128).unsqueeze(-1)
    sub = torch.arange(8, device=d)
    cols = ix["fwd_idx"][tile, sub, j]
    vals = (a["values"].view(ix["fwd_ok"].shape) * ix["fwd_ok"])[tile, sub, j]
    rows = (torch.arange(n_out, device=d).view(-1, 1, 1, 1) * 128
            + torch.arange(128, device=d).view(1, 1, -1, 1)).expand_as(cols)
    keep = ix["fin_ok"].unsqueeze(-1) & (vals != 0)
    return rows[keep], cols[keep], vals[keep], n_out * 128


def _tile_check(s, kind, glw, r, tag):
    """One ``tile_forward`` phase's kernel against its plain version, its
    plain time and cuSPARSE's product of its incidence with xw."""
    fs = s.fs
    a = {k: r["args"][k] for k in TILE_ARGS}
    yk, yr = fs.tile_forward(kind, glw, **a), \
        fs.tile_forward_reference(kind, glw, **a)
    s.sync()
    err = _agree(yk, yr)
    plain_ms = s.call_ms(lambda: fs.tile_forward_reference(kind, glw, **a),
                         repeats=10)
    rows, cols, vals, n_out = _tile_incidence(s, kind, glw, a)
    lib_ms = s.library_spmv(rows, cols, vals, (n_out, a["xw"].numel()),
                            a["xw"].reshape(-1), yr.reshape(-1))
    print(f"  {tag}: {r['stream_ms']:.4f} ms back to back "
          f"({r['call_ms']:.4f} a call), {r['ns_tile']:.3f} ns a tile, "
          f"{r['gslot_s']:.1f} Gslot/s, kernel vs plain max abs {err:.3e}",
          flush=True)
    return err, plain_ms, lib_ms


def fused_proto_main(s, small, t0):
    """#20, #21, #24 and #25 on the card: ``bench_fused_proto`` as the
    main path, in two drives (#20 at the script's shape; then the rest,
    #20's count moved to its 192 x 56 entry); then each kernel held to its
    plain version, beside its bound and a library call: cuSPARSE's product
    of its incidence with xw (#20: the final's 0/1 reads composed with the
    forward's), ``torch.sum`` of the streams (#25)."""
    fp, fs, torch = s.fp, s.fs, s.torch
    script, fine = fp.proto_shapes(small)
    opts = dict(device=s.dev, small=small, timer=_cpu_timer(s),
                verbose=True)
    res = s.drive(f"fused prototypes, proto@{script}",
                  lambda: fp.bench_fused_proto(
                      only=[f"proto@{script}", f"proto@{script}:workspace"],
                      **opts),
                  {"proto_fused_24x448", "proto_fused_24x448_workspace"})
    res.update(s.drive(
        "fused prototypes", lambda: fp.bench_fused_proto(
            only=[f"proto@{fine}", "glw", "spans", "span-class", "selfirst",
                  "streams"], **opts),
        {"proto_fused_192x56", "selfirst_b", *(f"glw_{g}" for g in
                                               PROTO_GLWS),
         *STREAM_KERNELS}, rename={"proto_fused_24x448":
                                   "proto_fused_192x56"}))

    for name, label in zip(("proto_fused_24x448", "proto_fused_192x56"),
                           (script, fine)):
        r = res[f"proto@{label}"]
        a = r["args"]
        yk, yr = fp.fused_proto(**a), fp.fused_proto_reference(**a)
        s.sync()
        err = _agree(yk, yr)
        plain_ms = s.call_ms(
            lambda: fp.fused_proto_reference(**a), repeats=10)
        rows, cols, vals, n_out = _proto_incidence(s, a)
        lib_ms = s.library_spmv(rows, cols, vals, (n_out, a["xw"].numel()),
                                a["xw"].reshape(-1), yr.reshape(-1))
        n_slabs, ST = a["tile_base"].shape
        print(f"  proto@{label}: {n_slabs} blocks of {ST} super-tiles, "
              f"{r['stream_ms']:.4f} ms back to back ({r['call_ms']:.4f} a "
              f"call), {r['gslot_s']:.1f} Gslot/s, y {tuple(yk.shape)}, "
              f"kernel vs plain max abs {err:.3e}", flush=True)
        flops = 2 * a["values"].numel() + yk.numel() * 8
        s.record(name, f"fused prototypes, proto@{label}, back to back", err,
                 r["stream_ms"], plain_ms, r["bytes"], flops, lib_ms)
        if label != script:
            continue
        # the same function and inputs, the scratch in a workspace
        rw = res[f"proto@{script}:workspace"]
        yw = fp.proto_launch(**a, workspace=True)
        s.sync()
        err = _agree(yw, yr)
        print(f"  proto@{script}:workspace: {rw['stream_ms']:.4f} ms back to "
              f"back ({rw['call_ms']:.4f} a call), "
              f"{rw['stream_ms'] / r['stream_ms']:.3f}x the shared scratch, "
              f"kernel vs plain max abs {err:.3e}", flush=True)
        s.record(f"{name}_workspace",
                 f"fused prototypes, proto@{script}:workspace, back to back",
                 err, rw["stream_ms"], plain_ms, rw["bytes"], flops, lib_ms)

    for g in PROTO_GLWS:
        r = res[f"glw@{g}"]
        err, plain_ms, lib_ms = _tile_check(s, "full", g, r, f"glw@{g}")
        s.record(f"glw_{g}", f"fused prototypes, glw@{g}, back to back",
                 err, r["stream_ms"], plain_ms, r["bytes"],
                 2 * r["args"]["values"].numel(), lib_ms)
    print(f"  glw@12: {res['glw@12']['skipped']}", flush=True)

    ms = []
    for c, g in (("narrow", 16), ("wide", 16), ("narrow", 8)):
        r = res[f"span-class:{c}@{g}"]
        _tile_check(s, "full", g, r, f"span-class:{c}@{g} "
                    f"({r['distinct_tiles']} distinct tiles)")
        ms.append(r["stream_ms"])
    n16, w16, n8 = ms
    print(f"  span classes at 16 tiles a block: narrow {n16:.4f} ms, wide "
          f"{w16:.4f} ms ({w16 / n16 - 1:+.2%}); the control, narrow at GLW "
          f"8, {n8:.4f} ms ({n8 / n16 - 1:+.2%}: "
          f"{'within' if abs(n8 / n16 - 1) <= 0.02 else 'outside'} 2%)",
          flush=True)

    ra, rb = res["selfirst@A"], res["selfirst@B"]
    _tile_check(s, "full", 16, ra, "selfirst@A (full, GLW 16)")
    err, plain_ms, lib_ms = _tile_check(s, "selfirst", 16, rb,
                                        "selfirst@B (selects-first)")
    print(f"  selfirst: B/A {rb['stream_ms'] / ra['stream_ms']:.3f}",
          flush=True)
    s.record("selfirst_b", "fused prototypes, selfirst@B, back to back", err,
             rb["stream_ms"], plain_ms, rb["bytes"],
             2 * rb["args"]["values"].numel(), lib_ms)

    for name, form in STREAM_KERNELS.items():
        # the script's 106 steps sit in the L2 back to back, so the line
        # records the run past it, which the HBM bound fits
        near = res[f"streams@{form}"]
        (far,) = (k for k in res if k.startswith(f"streams@{form}:"))
        r = res[far]
        a = r["args"]
        yk, yr = fp.streams_sum(**a), fp.streams_sum_reference(**a)
        s.sync()
        err = _agree(yk, yr)
        nb = a["n_steps"] // a["fold"]

        def library(a=a, nb=nb):
            total = a["values"].view(nb, -1, 128).sum(1)
            for x in a["streams"]:
                total = total + x.view(nb, -1, 128).sum(1,
                                                        dtype=torch.float32)
            return total
        _agree(library(), yr[::8])
        lib_ms = s.call_ms(library)
        plain_ms = s.call_ms(lambda a=a: fp.streams_sum_reference(**a),
                             repeats=10)
        print(f"  {far}: {r['stream_ms']:.4f} ms back to back "
              f"({r['call_ms']:.4f} a call), {r['ns_step']:.1f} ns a step, "
              f"{r['ns_substep']:.1f} ns a sub-step; at the script's "
              f"{near['args']['n_steps']} steps"
              f"{' (L2-resident)' if near['l2_resident'] else ''} "
              f"{near['stream_ms']:.4f} ms, {near['ns_substep']:.1f} ns a "
              f"sub-step; kernel vs plain max abs {err:.3e}", flush=True)
        s.record(name, f"fused prototypes, {far}, back to back",
                 err, r["stream_ms"], plain_ms, r["bytes"],
                 a["values"].numel() + sum(x.numel() for x in a["streams"]),
                 lib_ms)
    print(f"phase fused prototypes: {time.perf_counter() - t0:.1f} s",
          flush=True)


def _select_incidence(s, a):
    """(rows, cols, values, n_out, x) of one select-chain phase on its
    arguments ``a`` as one sparse matrix over x (hilo: the f32 x its planes
    rebuild): output plane position by x position (``select_index``), zero
    values dropped."""
    torch, d, sc = s.torch, s.dev, s.sc
    idx, ok = sc.select_index(**a)
    n, P = idx.shape[0], a.get("P", 1)
    rows = ((torch.arange(n, device=d).view(-1, 1, 1) * P
             + torch.arange(8, device=d).view(1, -1, 1) // (8 // P)) * 128
            + torch.arange(128, device=d)).expand_as(idx)
    vals = a["values"].view(idx.shape)
    keep = ok & (vals != 0)
    x = sc.hilo_x(a["xw"]) if a["form"] == "hilo" else a["xw"]
    return rows[keep], idx[keep], vals[keep], n * P * 128, x


def _select_kernel_report():
    """Registers (``-Xptxas -v``) and global loads (``LDG``), local loads
    and stores (``LDL``, ``STL``: spills) in ``cuobjdump -sass`` of each
    ``select_kernel`` instance: the chains' loads are volatile, so their
    count shows none was merged or dropped."""
    import collections
    import re
    import shutil
    import subprocess
    from sparsetpu_torch.kernels import _build
    lib = _build.library()
    forms = ("chain", "tree", "direct", "hilo")

    def label(mangled):
        m = re.search(r"select_kernelILi(\d)ELb([01])E", mangled)
        if m:
            return forms[int(m.group(1))] + ("_i8" if m.group(2) == "1"
                                             else "")
        return None
    regs, name = {}, None
    for line in lib.log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            name = label(m.group(1))
        elif name and "registers" in line:
            regs[name] = line.split(":", 1)[-1].strip()
            name = None
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    loads = {}
    if os.path.exists(exe):
        sass = subprocess.run([exe, "-sass", lib.path], capture_output=True,
                              text=True, timeout=300).stdout
        name = None
        for line in sass.splitlines():
            if "Function :" in line:
                name = label(line)
                if name:
                    loads[name] = collections.Counter()
            elif name:
                for op in ("LDG", "LDL", "STL"):
                    if re.search(rf"\b{op}\b", line):
                        loads[name][op] += 1
    for k in sorted(set(regs) | set(loads)):
        ops = loads.get(k)
        what = (f"{ops['LDG']} LDG, {ops['LDL']} LDL, {ops['STL']} STL"
                if ops is not None else "not read")
        print(f"  select_kernel<{k}>: SASS {what}; ptxas: "
              f"{regs.get(k, 'not read')}", flush=True)
    if not loads:
        print(f"  select chains: no SASS read ({exe} not found)", flush=True)


def select_chains_main(s, table, small, t0):
    """#22 and #23 on the card: ``bench_select_chains`` as the main path
    (every form's launch count zeroed before, non-zero after); then each
    phase held to its plain version at both sizes and, at the large size,
    beside its plain time and cuSPARSE on its incidence with x; the
    chain's rates beside ``table`` (``refresh_rates``' card table for #3 at
    Q = 8 / P); the G = 16 forms set against the direct load."""
    sc = s.sc
    q_n, r3_n, big = sc.tile_counts(small)
    res = s.drive("select chains", lambda: sc.bench_select_chains(
        device=s.dev, small=small, timer=_cpu_timer(s), verbose=True),
        set(SELECT_KERNELS))
    worst = 0.0
    for name, r in res.items():
        a = r["args"]
        yk, yr = sc.select_forward(**a), sc.select_forward_reference(**a)
        s.sync()
        r["err"] = err = _agree(yk, yr)
        worst = max(worst, err)
        if not name.endswith(f":{big}"):
            continue
        r["plain_ms"] = s.call_ms(lambda: sc.select_forward_reference(**a),
                                  repeats=5)
        rows, cols, vals, n_out, x = _select_incidence(s, a)
        r["lib_ms"] = s.library_spmv(rows, cols, vals, (n_out, x.numel()),
                                     x.reshape(-1), yr.reshape(-1))
        del rows, cols, vals
        print(f"  {name}: {r['stream_ms']:.4f} ms back to back "
              f"({r['call_ms']:.4f} a call), bound "
              f"{r['bound_ms'] or float('nan'):.4f}, "
              f"plain {r['plain_ms']:.4f}, cuSPARSE {r['lib_ms']:.4f}, "
              f"kernel vs plain max abs {err:.3e}", flush=True)
    print(f"  select chains: {len(res)} phases, every kernel within "
          f"{worst:.3e} of its plain version at {q_n}, {r3_n} and {big} "
          f"tiles", flush=True)
    for kname, (_, phase, _) in SELECT_KERNELS.items():
        r = res[f"{phase}:{big}"]
        s.record(kname, f"select chains, {phase}:{big}, back to back",
                 r["err"], r["stream_ms"], r["plain_ms"], r["bytes"],
                 2 * r["args"]["values"].numel(), r["lib_ms"])
    print(f"  select chains: q:chain@G,P:{big} against #3 in refresh_rates "
          f"at (G, Q = 8/P), Gslot/s", flush=True)
    for g, p in sc.Q_COMBOS:
        rate, card = res[f"q:chain@{g},{p}:{big}"]["gslot_s"], \
            table[(g, 8 // p)]
        print(f"    G={g:2d} P={p}: chain {rate:7.1f}  #3 {card:7.1f}  "
              f"ratio {rate / card:.3f}", flush=True)
    for suffix, what in (("", f"{r3_n} tiles"), (f":{big}", f"{big} tiles"),
                         (f":{big}:T{sc.FINE_T}",
                          f"{big} tiles, {sc.FINE_T} a block")):
        d = res[f"r3:direct16{suffix}"]["stream_ms"]
        print(f"  select chains at {what}, G = 16 against the direct load "
              f"({d:.4f} ms): " + ", ".join(
                  f"{v} {res[f'r3:{v}{suffix}']['stream_ms'] / d:.3f}x"
                  for v in ("chain16", "tree16", "hilo16")), flush=True)
    for suffix in ("", f":{big}"):
        ratios = [res[f"q:chain@{g},1{suffix}"]["stream_ms"]
                  / res[f"q:bigdual@{g}{suffix}"]["stream_ms"]
                  for g in sc.Q_BIGDUAL]
        print(f"  select chains at {q_n if not suffix else big} tiles, the "
              f"chain against bigdual (P = 1): " + ", ".join(
                  f"G={g} {v:.3f}x" for g, v in zip(sc.Q_BIGDUAL, ratios)),
              flush=True)
    if s.dev.type == "cuda":
        _select_kernel_report()
    print(f"phase select chains: {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# the distributed SpMV (sparsetpu_torch/dist/): ranks over NCCL and gloo
# ---------------------------------------------------------------------------

DIST_SCHEDULES = ("allgather", "ring", "multihost", "auto")
# FEM-3D Poisson's grid for the solves over the shards (cg, cg_df64)
DIST_FEM_N = 32


def _save_csr(path, m):
    np.savez(path, row_ptr=m.row_ptr, col_ind=m.col_ind, values=m.values,
             shape=np.array([m.nr_rows, m.nr_cols]))


def _load_csr(h, path):
    with np.load(path) as f:
        return h.CSRMatrix(f["row_ptr"], f["col_ind"], f["values"],
                           int(f["shape"][0]), int(f["shape"][1]))


class _DistRank:
    """One rank of the dist phase: its modules, device and launch
    counters."""

    def __init__(self, rank, world, device):
        import torch
        from sparsetpu_torch import _host, dist
        from sparsetpu_torch.bench.harness import call_ms
        from sparsetpu_torch.kernels import final_rows, spmv_gstream
        self.torch, self.h, self.dist = torch, _host, dist
        self.fr, self.sg, self._call_ms = final_rows, spmv_gstream, call_ms
        self.rank, self.world, self.dev = rank, world, device

    def zero(self):
        self.sg.gstream_chunk_sums.launches.clear()
        self.sg.live_slot_sums.launches = 0
        self.fr.final_rows.launches.clear()

    def counts(self):
        f = self.fr.final_rows.launches
        return {"gstream_spmv_window":
                self.sg.gstream_chunk_sums.launches["window"],
                "final_rows": f["short"] + f["long"],
                "live_slots_f64": self.sg.live_slot_sums.launches,
                "final_rows_f64": f["short_f64"] + f["long_f64"]}

    def call_ms(self, fn, repeats=20):
        return self._call_ms(fn, self.dev, repeats=repeats)

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def path(self, tag, build, m, x, expected):
        """Pack this rank's band with ``build`` and drive its ``spmv`` once
        as the main path (counts set to 0 just before, read just after;
        each expected kernel must have launched on this rank); y against
        the gold on rank 0; then the launches of one call and its time
        (every rank calls alike: the calls are collective)."""
        torch = self.torch
        f64 = m.values.dtype == np.float64
        xt = torch.as_tensor(x, dtype=torch.float64 if f64
                             else torch.float32, device=self.dev)
        t0 = time.perf_counter()
        sh = build(m, device=self.dev)
        self.sync()
        pack_s = time.perf_counter() - t0
        self.zero()
        y = sh.spmv(xt)
        self.sync()
        counts = self.counts()
        missing = sorted(k for k in expected if counts[k] < 1)
        if missing and self.dev.type == "cuda":
            raise RuntimeError(f"{tag}: rank {self.rank} did not launch "
                               f"{missing} (counts {counts})")
        if tuple(y.shape) != (m.nr_rows,) or not bool(y.isfinite().all()):
            raise RuntimeError(f"{tag}: bad y, shape {tuple(y.shape)}")
        rec = {"tag": tag, "kind": type(sh).__name__, "pack_s": pack_s,
               "counts": counts}
        if self.rank == 0:
            yh = y.cpu().numpy()
            _gold_errors(self.h, m, x, yh, np.float64 if f64
                         else np.float32)
            rec["gold_max_abs"] = float(np.abs(
                yh - self.h.spmv_gold(m, x)).max())
        self.zero()
        sh.spmv(xt)
        self.sync()
        rec["counts_a_call"] = {k: v for k, v in self.counts().items() if v}
        rec["ms"] = self.call_ms(lambda: sh.spmv(xt))
        return sh, xt, rec

    def band_kernels(self, sh, xt, rec):
        """Rank 0's kernels against their plain versions on its band's own
        inputs (RTOL): the forward (the live-slot forward in f64; stage 0
        on the ring) and the final; with one rank, the band's own
        ``spmv`` a call (the whole matrix on one classic device)."""
        torch, sg, fr = self.torch, self.sg, self.fr
        if isinstance(sh, self.dist.RingShardedSpmv):
            xseg = sh.x_segment(xt)
            cps = sh.tiles_per_step * sh.planes
            wk = torch.zeros(sh.stage_off[-1] * cps, 128, device=self.dev)
            wr = torch.zeros_like(wk)
            sh.stage(0, xseg, wk)
            sh.stage(0, xseg, wr, sg.gstream_chunk_sums_reference)
            self.sync()
            rec["forward_err"] = _agree(wk, wr)
            rec["stage_steps"] = sh.stage_steps
            return
        band = sh.band
        x2 = band.prepare_x(xt)
        if band.dtype == torch.float64:
            pos = band.slots.pos.long()
            ck = band.forward_live(xt)
            cr = band.forward_live(xt, sg.live_slot_sums_reference)
            self.sync()
            rec["forward_err"] = _agree(ck.reshape(-1)[pos],
                                        cr.reshape(-1)[pos])
        else:
            ck, cr = band.stream(x2), band.stream(
                x2, sg.gstream_chunk_sums_reference)
            self.sync()
            rec["forward_err"] = _agree(ck, cr)
        vec = cr.reshape(-1)
        yk, yr = band.final.apply(vec), band.final.apply(
            vec, fr.final_rows_reference)
        self.sync()
        rec["final_err"] = _agree(yk, yr)
        if self.world == 1:
            rec["band_ms"] = self.call_ms(
                lambda: band.spmv(x2, x_is_packed=True))
            self.split(sh, xt, x2, rec)

    def split(self, sh, xt, x2, rec):
        """At one rank, the sharded call and its pieces, each a call and
        back to back (ms): x's segment, the two all-gathers, the band's
        own ``spmv`` and the local body (segment in, band out)."""
        from sparsetpu_torch.bench.harness import stream_ms
        from sparsetpu_torch.dist import comm
        xseg = sh.x_segment(xt)
        yb = self.torch.zeros(sh.rows_per_part, dtype=sh.real,
                              device=self.dev)
        pieces = {"spmv": lambda: sh.spmv(xt),
                  "spmv_local": lambda: sh.spmv_local(xseg),
                  "band spmv": lambda: sh.band.spmv(x2, x_is_packed=True),
                  "x_segment": lambda: sh.x_segment(xt),
                  "all_gather x": lambda: comm.all_gather(xseg, sh.group),
                  "all_gather y": lambda: comm.all_gather(yb, sh.group)}
        rec["split_ms"] = {
            k: (self.call_ms(fn, repeats=50),
                stream_ms(fn, self.dev) if self.dev.type == "cuda"
                else float("nan"))
            for k, fn in pieces.items()}

    def cusparse_ms(self, m, xt):
        torch = self.torch
        a = torch.sparse_csr_tensor(
            torch.from_numpy(m.row_ptr.astype(np.int64)),
            torch.from_numpy(m.col_ind.astype(np.int64)),
            torch.from_numpy(m.values), (m.nr_rows, m.nr_cols)).to(self.dev)
        return self.call_ms(lambda: a @ xt)


def _dist_rank(rank, world, device, paths, fem_n):
    """The dist phase on one rank: every schedule at the headline and the
    roadNet-CA stand-in, the f64 shards at the headline in f64, and (one
    rank) the solves over the shards.  Returns the rank's records."""
    r = _DistRank(rank, world, device)
    torch, d, h = r.torch, r.dist, r.h
    group = d.make_mesh(world)
    builds = {"allgather": d.shard_spmv, "ring": d.ring_shard_spmv,
              "multihost": d.shard_spmv_multihost,
              "auto": d.shard_spmv_auto}
    f32 = {"gstream_spmv_window", "final_rows"}
    recs = []
    for name in ("headline", "roadNet-CA"):
        m = _load_csr(h, paths[name])
        x = np.random.default_rng(0).standard_normal(m.nr_cols)
        for kind in DIST_SCHEDULES:
            sh, xt, rec = r.path(f"{name} {kind}", lambda mat, device: (
                builds[kind](mat, group, device=device)), m, x, f32)
            if rank == 0 and kind in ("allgather", "ring"):
                r.band_kernels(sh, xt, rec)
            if rank == 0 and world == 1 and kind == "allgather":
                rec["cusparse_ms"] = r.cusparse_ms(m, xt)
            recs.append(rec)
            del sh
        del m
    m = _load_csr(h, paths["headline f64"])
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    sh, xt, rec = r.path("headline f64 df64", lambda mat, device: (
        d.shard_spmv_df64(mat, group, device=device)), m, x,
        {"live_slots_f64", "final_rows_f64"})
    if rank == 0:
        r.band_kernels(sh, xt, rec)
        if world == 1:
            rec["cusparse_ms"] = r.cusparse_ms(m, xt)
    recs.append(rec)
    del sh, m
    if world == 1:
        from sparsetpu_torch.solvers.cg import cg, cg_df64
        for dtype, solve, tol in ((np.float32, cg, 1e-5),
                                  (np.float64, cg_df64, 1e-10)):
            m = h.fem_poisson_3d(fem_n, dtype=dtype)
            build = d.shard_spmv if dtype == np.float32 else \
                d.shard_spmv_df64
            sh = build(m, group, device=device)
            b = torch.ones(m.nr_rows, dtype=getattr(torch, np.dtype(
                dtype).name), device=device)
            r.zero()
            t0 = time.perf_counter()
            res = solve(sh.spmv, b, tol=tol, maxiter=2000)
            r.sync()
            dt = time.perf_counter() - t0
            xs = res.x.cpu().numpy().astype(np.float64)
            rel = float(np.linalg.norm(1.0 - h.spmv_gold(m, xs))
                        / np.sqrt(m.nr_rows))
            # the f32 solve stops on its f32 residual: allow its rounding
            lim = tol * (10.0 if dtype == np.float32 else 1.0)
            if not rel <= lim:
                raise RuntimeError(f"{solve.__name__} over the shards: "
                                   f"relative residual {rel:.3e} > {lim}")
            recs.append({"tag": f"{solve.__name__} FEM-3D Poisson "
                         f"{fem_n}^3 ({m.nr_rows} rows, {m.nr_nzeros} nnz)",
                         "iterations": res.iterations, "rel_residual": rel,
                         "s": dt, "counts": r.counts()})
    return recs


def _dist_report(s, world, backend, recs_by_rank):
    """Print the ranks' records and add their main paths' launches to the
    run's counts."""
    for rank, recs in enumerate(recs_by_rank):
        for rec in recs:
            for k, v in rec["counts"].items():
                s.launches[k] += v
            if rank:
                continue
            extra = ", ".join(
                f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                for k, v in rec.items()
                if k not in ("tag", "counts", "split_ms"))
            print(f"  dist [{world} {backend} rank(s)] {rec['tag']}: "
                  f"{extra}; main-path launches "
                  f"{ {k: v for k, v in rec['counts'].items() if v} }",
                  flush=True)


def dist_main(s, paths, small, t0):
    """The distributed SpMV through its entry points, in ranks started by
    ``dist.launch.run_ranks``: one rank over NCCL (a real process group of
    world size 1), then four ranks sharing the one card over gloo, each at
    full width; then ``python -m sparsetpu_torch.bench.scaling --json``.
    NCCL refuses two ranks on one device (NCCL 2.28.9: ncclInvalidUsage,
    "Duplicate GPU detected" at the first collective), so the ranks that
    share the card join by gloo, whose collectives carry their CUDA
    tensors through pinned host memory (``dist/comm.py``)."""
    import subprocess
    from sparsetpu_torch.dist import run_ranks
    fem_n = 12 if small else DIST_FEM_N
    # a CPU rehearsal joins its one rank by gloo
    one = "nccl" if s.dev.type == "cuda" else "gloo"
    whole = {"headline allgather": "headline",
             "roadNet-CA allgather": "wide x (roadNet-CA)",
             "headline f64 df64": "headline f64"}
    for world, backend in ((1, one), (4, "gloo")):
        t1 = time.perf_counter()
        recs = run_ranks(_dist_rank, world, backend, paths, fem_n,
                         device=s.dev, timeout=900)
        _dist_report(s, world, backend, recs)
        if world == 1:
            for rec in recs[0]:
                if "band_ms" in rec:
                    sm_ms = s.whole.get(whole[rec["tag"]], (float("nan"),))
                    print(f"  dist P = 1 [{rec['tag']}]: sharded spmv "
                          f"{rec['ms']:.4f} ms a call | the band's "
                          f"spmv (the whole matrix on one classic device) "
                          f"{rec['band_ms']:.4f} | SparseMatrix @ x "
                          f"{sm_ms[0]:.4f} (its phase) | cuSPARSE "
                          f"{rec['cusparse_ms']:.4f} | split, ms a call "
                          f"(back to back): " + ", ".join(
                              f"{k} {a:.4f} ({b:.4f})" for k, (a, b) in
                              rec["split_ms"].items()), flush=True)
        else:
            print("  dist: four ranks sharing one card: no scaling figure "
                  "(" + "; ".join(f"{rec['tag']} {rec['ms']:.4f} ms"
                                  for rec in recs[0] if "ms" in rec) + ")",
                  flush=True)
        print(f"phase dist ({world} {backend} rank(s)): "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    argv = [sys.executable, "-m", "sparsetpu_torch.bench.scaling", "--json"]
    if s.dev.type != "cuda":
        argv += ["--device", "cpu", "--rows-per-dev", "2000"]
    out = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"scaling: rc {out.returncode}, stdout "
                           f"{out.stdout[-2000:]!r}, stderr "
                           f"{out.stderr[-2000:]!r}")
    rep = json.loads(lines[-1])
    if not rep["weak_scaling"] or any(
            row["verify_errors"] for row in rep["weak_scaling"]):
        raise RuntimeError(f"scaling: {lines[-1]}")
    print(f"scaling ({' '.join(argv[1:])}): {lines[-1]}", flush=True)
    print(f"phase dist scaling: {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"phase dist: {time.perf_counter() - t0:.1f} s", flush=True)


def _layout(s, d):
    """What a device's launches depend on: its class, its pack's layout
    and its finish (F levels, final kind, spills, the map's entries); a
    loaded device must match the device saved."""
    if isinstance(d, s.fused.FusedDevice):
        p = d.meta
        return (type(d).__name__, p.Q, p.T, p.GLW, p.GX, p.n_steps,
                p.n_slabs, p.SGRP, p.fin_direct, int(p.spill_row.size))
    p, fin = d.meta, d.plan.final
    return (type(d).__name__, p.G, p.Q, p.GL, p.tiles_per_step, p.n_steps,
            len(d.flevels), type(fin).__name__,
            getattr(fin, "n_spills", None),
            d.final.rows.n_entries if d.final is not None else None)


def checkpoint_save(s, tag, dev, m, x):
    """Save a main path's device (``pack/serialize.py:save_device``) to the
    run's checkpoint directory, timed (host clock), beside its y for ``x``:
    ``checkpoint_main`` loads it and compares."""
    from sparsetpu_torch.pack.serialize import save_device
    xt = s.torch.as_tensor(x, dtype=s.torch.float64 if dev.dtype ==
                           s.torch.float64 else s.torch.float32,
                           device=s.dev)
    y = dev.spmv(xt).cpu().numpy()
    if s.ckpt_dir is None:
        s.ckpt_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")
    path = os.path.join(s.ckpt_dir.name, f"{len(s.ckpts)}.npz")
    s.sync()
    t0 = time.perf_counter()
    save_device(path, dev)
    save_s = time.perf_counter() - t0
    s.ckpts.append(dict(tag=tag, path=path, m=m, x=x, y=y,
                        layout=_layout(s, dev), save_s=save_s,
                        pack_s=s.pack_s[tag],
                        nbytes=os.path.getsize(path)))
    print(f"checkpoint [{tag}]: saved {os.path.getsize(path)} B in "
          f"{save_s:.2f} s", flush=True)


def checkpoint_main(s, t0):
    """Each saved device loaded on the card (``load_device``: the uploads,
    the launch plan, ``FinalRows`` and ``LiveSlots`` built again, no pack
    or finish build) and driven once as a main path: y beside the saved
    device's (bit for bit, or within the gold tolerance where a kernel adds
    with atomics), against the gold, each kernel against its plain
    version; the archive's size, the save and load seconds beside the
    pack-and-upload seconds the load replaces.  The files are deleted."""
    from sparsetpu_torch.pack.serialize import load_device
    torch, h = s.torch, s.h
    load_total = 0.0
    for c in s.ckpts:
        tag = f"checkpoint [{c['tag']}]"
        m, x, y0 = c["m"], c["x"], c["y"]
        s.sync()
        t1 = time.perf_counter()
        d = load_device(c["path"], device=s.dev)
        s.sync()
        load_s = time.perf_counter() - t1
        load_total += load_s
        os.remove(c["path"])
        if _layout(s, d) != c["layout"]:
            raise RuntimeError(f"{tag}: loaded {_layout(s, d)}, saved "
                               f"{c['layout']}")
        dt = np.float64 if y0.dtype == np.float64 else np.float32
        xt = torch.as_tensor(x, dtype=getattr(torch, np.dtype(dt).name),
                             device=s.dev)
        y = s.drive(tag, lambda: d.spmv(xt), s.kernels_of(d)).cpu().numpy()
        same = y.tobytes() == y0.tobytes()
        diff = float(np.abs(y - y0).max()) if y.size else 0.0
        atol, rtol = h.default_tolerance(dt, m.nr_nzeros / max(m.nr_rows, 1))
        if h.verification(y0, y, diff_thres=atol, rel_thres=rtol) or (
                dt == np.float64 and diff > F64_GOLD_REL * max(
                    1.0, float(np.abs(y0).max()))):
            raise RuntimeError(f"{tag}: y off the saved device's by {diff}")
        _gold_errors(h, m, x, y, dt)
        if isinstance(d, s.fused.FusedDevice):
            x2 = d.prepare_x(xt)
            yk = d.blocks(x2)
            yr = d.blocks(x2, kernel=s.fused.fused_spmv_reference)
            s.sync()
            agree = (f"the free wrapper vs plain max abs {_agree(yk, yr):.3e}"
                     f", the device's one launch vs its plain version "
                     f"{_device_call_agrees(s, d, x):.3e}")
            del yk, yr
        else:
            s.gstream(d, xt, c["tag"], measure=False)
            agree = "each kernel agrees with its plain version"
        print(f"{tag}: {c['layout'][0]}, archive {c['nbytes']} B, saved in "
              f"{c['save_s']:.2f} s, loaded in {load_s:.2f} s (pack + "
              f"upload {c['pack_s']:.2f} s) | y "
              + ("bit-identical to the saved device's" if same else
                 f"max abs {diff:.3e} off the saved device's (within the "
                 f"gold tolerance)")
              + f", 0 errors vs spmv_gold | {agree}", flush=True)
        del d
    if s.ckpt_dir is not None:
        s.ckpt_dir.cleanup()
    save_total = sum(c["save_s"] for c in s.ckpts)
    s.ckpts.clear()
    print(f"phase checkpoints: {time.perf_counter() - t0 + save_total:.1f} s"
          f" (saves {save_total:.1f} s in their phases, loads "
          f"{load_total:.1f} s)", flush=True)


def reference_program(s, tag, call, expected, m, x, existing, plain):
    """One program written for the reference (``sparsetpu``'s entry points
    and keywords), driven once on the card as a main path, its launches
    read around it, then checked four ways: its result is a tensor on the
    card; it meets the gold (``spmv_gold``, or ``spmm_gold`` column by
    column for an X of k columns) with 0 errors; it equals the result of
    ``existing`` = (label, call), the port's own entry point on the same
    matrix, within the gold tolerance (bit for bit reported); and
    ``plain()`` holds the kernels it launched to their plain versions (it
    raises, or returns what it printed).  Its ms a call beside the entry
    point's, with the card's name and power limit."""
    torch, h = s.torch, s.h
    t0 = time.perf_counter()
    dt = np.float64 if m.values.dtype == np.float64 else np.float32
    y = s.drive(f"reference program [{tag}]", call, expected)
    if not (isinstance(y, torch.Tensor) and y.device.type == s.dev.type):
        raise RuntimeError(f"{tag}: the result is a {type(y).__name__} on "
                           f"{getattr(y, 'device', 'the host')}, not a "
                           f"tensor on {s.dev}")
    label, entry = existing
    y0 = entry()
    s.sync()
    if x.ndim == 2:
        _gold_errors_multi(s, m, x, y, dt)
    else:
        _gold_errors(h, m, x, y.cpu().numpy(), dt)
    yn, y0 = y.cpu().numpy(), y0.cpu().numpy()
    same = yn.shape == y0.shape and yn.tobytes() == y0.tobytes()
    diff = float(np.abs(yn - y0).max(initial=0.0))
    atol, rtol = h.default_tolerance(dt, m.nr_nzeros / max(m.nr_rows, 1))
    cols = [(yn, y0)] if yn.ndim == 1 else [
        (yn[:, j], y0[:, j]) for j in range(yn.shape[1])]
    if yn.shape != y0.shape or any(
            h.verification(b, a, diff_thres=atol, rel_thres=rtol)
            for a, b in cols) or (dt == np.float64 and diff > F64_GOLD_REL
                                  * max(1.0, float(np.abs(y0).max()))):
        raise RuntimeError(f"{tag}: {diff} off {label}'s result")
    agree = plain()
    ms = s.call_ms(call, repeats=20)
    ms0 = s.call_ms(entry, repeats=20)
    s.refs[tag] = (ms, ms0)
    print(f"reference program [{tag}]: {ms:.4f} ms a call | {label} "
          f"{ms0:.4f} ms | {tuple(y.shape)} {_real(y)} tensor on {y.device}"
          f", 0 errors vs the gold, "
          + ("bit-identical to" if same else f"max abs {diff:.3e} off")
          + f" {label}'s | {agree} | [{s.card}]", flush=True)
    s.ref_s += time.perf_counter() - t0


def _fused_call_agrees(s, dev, x2):
    """A fused device's one launch on a prepared x against its plain
    version; what it printed."""
    yk = dev.spmv_blocks(x2, x_is_packed=True)
    s.sync()
    return (f"the device's one launch vs its plain version max abs "
            f"{_agree(yk, dev.spmv_blocks_reference(x2)):.3e}")


def reference_programs_headline(s, m, x, xt, sm):
    """bench.py's protocol (``bench.py:84-92``: ``d = sm._device``,
    ``d.spmv(d.prepare_x(x), x_is_packed=True)``) on the headline phase's
    ``SparseMatrix(m, backend="pallas")``, and ``FusedDevice(p)`` on its
    pack ``p``; each beside ``sm @ x``."""
    fused = s.fused
    kw = {} if s.dev.type == "cuda" else {"device": s.dev}
    d = sm._device
    if sm.backend != "auto" or not isinstance(d, fused.FusedDevice):
        raise RuntimeError("SparseMatrix(backend='pallas'): expected the "
                           "fused device")
    x2 = d.prepare_x(x)
    existing = ("SparseMatrix(m) @ x", lambda: sm @ xt)
    reference_program(
        s, "headline: bench.py's protocol on SparseMatrix(m, "
        "backend='pallas')", lambda: d.spmv(x2, x_is_packed=True),
        s.kernels_of(d), m, x, existing,
        lambda: _fused_call_agrees(s, d, x2))
    del d, x2
    t0 = time.perf_counter()
    fd = fused.FusedDevice(sm.packed, **kw)
    s.ref_s += time.perf_counter() - t0
    reference_program(
        s, "headline: FusedDevice(pack_fused(m)), the phase's pack",
        lambda: fd.spmv(xt), s.kernels_of(fd), m, x, existing,
        lambda: _fused_call_agrees(s, fd, fd.prepare_x(xt)))


def reference_programs_headline_f64(s, m, x, xt, sm):
    """``pack_fused_df64(m).spmv_f64(x)`` (the program packs the two f32
    planes), beside ``sm @ x`` on the phase's fused f64 device."""
    kw = {} if s.dev.type == "cuda" else {"device": s.dev}
    t0 = time.perf_counter()
    dev = s.fused.pack_fused_df64(m, **kw)
    s.sync()
    if not isinstance(dev, s.fused.DF64FusedDevice):
        raise RuntimeError(f"pack_fused_df64: got {type(dev).__name__}")
    print(f"reference programs [headline f64]: pack_fused_df64(m) packed "
          f"and uploaded in {time.perf_counter() - t0:.1f} s: "
          f"{s.describe(dev)}", flush=True)
    s.ref_s += time.perf_counter() - t0
    reference_program(
        s, "headline f64: pack_fused_df64(m).spmv_f64(x)",
        lambda: dev.spmv_f64(xt), {"fused_spmv_f64"}, m, x,
        ("SparseMatrix(m) @ x", lambda: sm @ xt),
        lambda: _fused_call_agrees(s, dev, dev.prepare_x(xt)))


def reference_programs_road(s, m, x, xt, sm):
    """``GStreamDevice(p)`` on the wide x phase's pack (the device builds
    its finish plan, as the JAX one does), its ``spmv`` and
    ``spmm_gstream(dev, x_multi=X)`` at k = 8, beside ``sm @ x`` and ``sm
    @ X``."""
    kw = {} if s.dev.type == "cuda" else {"device": s.dev}
    t0 = time.perf_counter()
    d = s.st.GStreamDevice(sm.device_module.meta, **kw)
    s.sync()
    print(f"reference programs [roadNet-CA]: GStreamDevice(p) on the phase's"
          f" pack, uploaded with its finish in {time.perf_counter() - t0:.1f}"
          f" s: {s.describe(d)}", flush=True)
    s.ref_s += time.perf_counter() - t0

    def kernels_agree():
        s.gstream(d, xt, "reference program, roadNet-CA", measure=False)
        return "each kernel agrees with its plain version"
    reference_program(
        s, "roadNet-CA: GStreamDevice(p).spmv(x)", lambda: d.spmv(xt),
        s.kernels_of(d), m, x, ("SparseMatrix(m) @ x", lambda: sm @ xt),
        kernels_agree)
    X = _X(m.nr_cols, 8, seed=8)
    Xt = s.torch.as_tensor(X, dtype=s.torch.float32, device=s.dev)

    def multi_agree():
        s.gstream_multi(d, Xt, "reference program, roadNet-CA k=8",
                        measure=False)
        return "each k-plane kernel agrees with its plain version"
    reference_program(
        s, "roadNet-CA: spmm_gstream(dev, x_multi=X), k=8",
        lambda: s.sp.spmm_gstream(d, x_multi=Xt), s.spmm_kernels_of(d), m,
        X, ("SparseMatrix(m) @ X", lambda: sm @ Xt), multi_agree)


def reference_programs_road_f64(s, m, x, xt, sm):
    """``DF64GStreamDevice(...).spmv_f64(x)`` beside ``sm @ x``.  The device
    packs the (hi, lo) planes and builds its final inside
    ``DF64GStreamDevice(m)``, as the JAX one does: 23.7 s at this matrix
    (NVIDIA H100 80GB HBM3, 700 W), so the program takes the phase's packs
    and finish plan through the class's buffer path, ``from_packed`` (the
    lo plane is the card's float64 plane minus hi, exact)."""
    import dataclasses
    from sparsetpu_torch.pack.serialize import _lo_plane
    d0 = sm.device_module
    t0 = time.perf_counter()
    lo = dataclasses.replace(d0.meta, values=_lo_plane(d0.stream.values,
                                                       d0.meta.values))
    d = s.f64.DF64GStreamDevice.from_packed(d0.meta, lo, s.dev, plan=d0.plan)
    s.sync()
    print(f"reference programs [roadNet-CA f64]: "
          f"DF64GStreamDevice.from_packed(the phase's hi and lo packs, its "
          f"finish plan) in place of DF64GStreamDevice(m), uploaded in "
          f"{time.perf_counter() - t0:.1f} s: {s.describe(d)}", flush=True)
    s.ref_s += time.perf_counter() - t0

    def kernels_agree():
        s.gstream(d, xt, "reference program, roadNet-CA f64",
                  measure=False)
        return "each kernel agrees with its plain version"
    reference_program(
        s, "roadNet-CA f64: DF64GStreamDevice.from_packed(hi, lo, "
        "plan).spmv_f64(x)",
        lambda: d.spmv_f64(xt), s.kernels_of(d), m, x,
        ("SparseMatrix(m) @ x", lambda: sm @ xt), kernels_agree)


def reference_cli(s, small):
    """``python -m sparsetpu_torch --backend pallas -v --random ...`` and
    ``--backend xla`` (the JAX CLI's flags) in subprocesses: each must
    exit 0 with 0 verify errors; its median SpMV ms a call printed."""
    import subprocess
    t0 = time.perf_counter()
    spec = f"{20_000 if small else 200_000}x100000x0.0005"
    for backend in ("pallas", "xla"):
        argv = [sys.executable, "-m", "sparsetpu_torch", "--backend",
                backend, "-v", "--random", spec]
        if s.dev.type != "cuda":
            argv += ["--device", "cpu", "--repeats", "3"]
        t1 = time.perf_counter()
        out = subprocess.run(
            argv, cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        lines = out.stdout.strip().splitlines()
        total = [ln for ln in lines if ln.startswith("Total SpMV time")]
        if out.returncode != 0 or not total or \
                "Verification: PASS (0 errors)" not in lines:
            raise RuntimeError(f"reference CLI {backend}: rc "
                               f"{out.returncode}, stdout "
                               f"{out.stdout[-2000:]!r}, stderr "
                               f"{out.stderr[-2000:]!r}")
        ms = float(total[0].split()[3])
        s.refs[f"cli {backend}"] = (ms, None)
        print(f"reference program [python -m sparsetpu_torch "
              f"{' '.join(argv[3:])}]: rc 0 in "
              f"{time.perf_counter() - t1:.1f} s, {ms:.4f} ms a call "
              f"(Total SpMV time), Verification: PASS (0 errors) | "
              f"[{s.card}]", flush=True)
    s.ref_s += time.perf_counter() - t0
    print(f"phase reference programs: {s.ref_s:.1f} s (in the headline, "
          f"wide x and f64 phases and here)", flush=True)


SUITE_ROWS = 13                   # CLASSIC_SUITE's 10 and 3 structured


def suite_main(s, small, t0):
    """``bench.suite.run_suite(allow_synthetic=True)`` on the card: every
    row must PASS.  Beside each row, cuSPARSE (``torch.sparse_csr @ x``) on
    the same matrix and x, a call timed as ``bench_spmv`` times the port's
    (CUDA events, median of 20 warm calls), measured here and not part of
    the suite's rows.  A CPU rehearsal (``small``) runs the netlist row
    alone."""
    from sparsetpu_torch.bench import harness, suite
    torch = s.torch
    bench, lib = harness.bench_spmv, {}

    def bench_beside_cusparse(matrix, name, **kw):
        r = bench(matrix, name=name, **kw)
        if s.dev.type == "cuda":
            # bench_spmv's x
            x = np.random.default_rng(0).uniform(0.0, 1.0, matrix.nr_cols)
            xt = torch.as_tensor(x, dtype=torch.float32, device=s.dev)
            a = s.csr(matrix)
            lib[name] = (s.call_ms(lambda: a @ xt, repeats=20), r.total_ms)
            del a
        return r

    harness.bench_spmv = bench_beside_cusparse
    try:
        rows = suite.run_suite(["netlist"] if small else None,
                               allow_synthetic=True, device=s.dev)
    finally:
        harness.bench_spmv = bench
    for row in rows:
        print(f"  suite row: {json.dumps(row)}", flush=True)
        if row["matrix"] in lib:
            ms, port_ms = lib[row["matrix"]]
            print(f"    cuSPARSE (torch.sparse_csr @ x): {ms:.4f} ms a call "
                  f"({row['nnz'] / ms / 1e6:.3f} Gnnz/s) | the port "
                  f"{port_ms:.4f} ms ({row['gnnz_s']:.3f} Gnnz/s)",
                  flush=True)
    bad = [r["matrix"] for r in rows if r.get("verify") != "PASS"]
    if bad or len(rows) != (1 if small else SUITE_ROWS):
        raise RuntimeError(f"suite: {len(rows)} rows, not PASS: {bad}")
    print(f"phase suite: {time.perf_counter() - t0:.1f} s", flush=True)


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


def one_launch(s, tag, fn, memsets=1):
    """A fused ``sm @ x`` (or ``sm @ X``) call must be one kernel and
    ``memsets`` memsets (#1 and #6 zero their output, the rows kernel
    writes every row)."""
    got = s.launches_a_call(tag, fn)
    if got is not None and got != (1, memsets):
        raise RuntimeError(f"{tag}: expected one kernel and {memsets} "
                           f"memset(s) a call, the trace shows {got}")


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
    s.pack_s[tag] = t_pack
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


def urand20(h, small):
    """The ``urand20`` cell's matrix at seed 1 (``spbench/``'s generator
    and configuration; ``small``: scale 14)."""
    from spbench.generators import urand
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "spbench", "configs", "urand20.json")) as f:
        cfg = json.load(f)
    if small:
        cfg["scale"] = 14
    g = urand.generate(cfg, np.random.default_rng([1, 0]))
    return h.CSRMatrix(g.row_ptr, g.col_ind, g.values, g.nr_rows, g.nr_cols)


def band8(h, n):
    """n rows of 8 diagonals (offsets -3..4): each row one full chunk of
    the pack, so its tiles fill and the byte rule keeps #1."""
    rows = np.repeat(np.arange(n), 8)
    cols = rows + np.tile(np.arange(-3, 5), n)
    ok = (cols >= 0) & (cols < n)
    vals = np.random.default_rng(2).standard_normal(int(ok.sum()))
    return h.CSRMatrix.from_coo(rows[ok], cols[ok], vals.astype(np.float32),
                                n, n)


def fused_rows_main(s, small, t0):
    """The rows kernel against #1 where the byte rule decides: the
    ``urand20`` cell's matrix (the rule takes the rows kernel) and a band
    of 8 diagonals (it keeps #1), each driven as a main path, then both
    kernels timed on the device's own inputs."""
    st = s.st

    def fused_f32(mat):
        sm = st.SparseMatrix(mat, st.SpmvConfig(dtype=np.float32),
                             device=s.dev)
        if sm.fused_device is None or sm.heavy_device is not None:
            raise RuntimeError("expected the fused device")
        return sm, [sm.fused_device]

    for tag, make in (("urand20", lambda: urand20(s.h, small)),
                      ("band of 8 diagonals",
                       lambda: band8(s.h, 1 << (14 if small else 20)))):
        m, _, xt, sm, _ = main_path(s, tag, make, fused_f32, t0)
        d = sm.fused_device
        lib_ms = s.whole_call(sm, m, xt, tag)
        s.rows_kernel(d, xt, tag, lib_ms)
        s.profile(tag, lambda: sm @ xt)
        one_launch(s, tag, lambda: sm @ xt,
                   memsets=int(d.kernel == "tiles"))
        del m, xt, sm, d
    print(f"phase rows kernel: {time.perf_counter() - t0:.1f} s", flush=True)


def run(device, hbm: float, small: bool = False):
    """Every phase on ``device``; ``small`` cuts the full-size matrices (a
    rehearsal of the control flow, not a measurement)."""
    s = Smoke(device, hbm)
    st, h, fused, sg = s.st, s.h, s.fused, s.sg
    # the run opens no connection: a SuiteSparse matrix missing from the
    # cache is its synthetic stand-in, with no mirror tried
    from sparsetpu_torch.formats import suitesparse
    suitesparse.MIRRORS = ()
    # the main paths' matrices, kept for the dist phase's ranks
    keep = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    paths = {name: os.path.join(keep.name, f"{i}.npz") for i, name in
             enumerate(("headline", "roadNet-CA", "headline f64"))}

    t0 = time.perf_counter()
    fused_regimes(s)
    classic_regimes(s)
    print(f"phase regimes: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- headline: the fused main path (bench.py's matrix)
    t0 = time.perf_counter()

    def fused_only(m):
        # bench.py's call (``bench.py:85``): "pallas" is the port's "auto"
        sm = st.SparseMatrix(m, backend="pallas", device=s.dev)
        if sm.fused_device is None or sm.heavy_device is not None:
            raise RuntimeError("headline: expected the fused device")
        return sm, [sm.fused_device]

    m, x, xt, sm, _ = main_path(
        s, "headline",
        lambda: h.random_csr(20_000 if small else 200_000, 100_000,
                             density=0.0005, seed=1, dtype=np.float32),
        fused_only, t0)
    _save_csr(paths["headline"], m)
    lib_ms = s.whole_call(sm, m, xt, "headline")
    # times first: a profiler trace slows the host's later launches
    s.fused_kernel(sm.fused_device, sm.prepare_x(x), "headline", lib_ms)
    s.rows_kernel(sm.fused_device, xt, "headline", lib_ms)
    s.profile("headline", lambda: sm @ xt)
    one_launch(s, "headline", lambda: sm @ xt,
               memsets=int(sm.fused_device.kernel == "tiles"))
    checkpoint_save(s, "headline", sm.fused_device, m, x)
    reference_programs_headline(s, m, x, xt, sm)
    print(f"phase headline: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- headline SpMM, k = 8: the fused SpMM kernel
    t0 = time.perf_counter()
    tag = "headline SpMM k=8"
    Xt = spmm_path(s, tag, m, lambda X: sm @ X, [sm.fused_device], 8)
    lib_ms = s.whole_call_multi(sm, m, Xt, tag)
    s.fused_kernel(sm.fused_device, Xt, tag, lib_ms, multi=True)
    s.profile(tag, lambda: sm @ Xt)
    one_launch(s, tag, lambda: sm @ Xt)
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

    # ---- the crossing: past the fused SpMM's limit, the classic route
    # against k fused SpMVs (k sm @ x) and cuSPARSE, at k = 72, 96, 128 on
    # an H100 (the first k the fused SpMM rejects, then 96 and 128)
    t0 = time.perf_counter()
    crossing = [k] + [kc for kc in (96, 128) if kc > k]
    for kc in crossing[1:]:
        tag = f"headline SpMM k={kc} (classic device)"
        Xt = spmm_path(s, tag, m, lambda X: sm @ X, [cd], kc)
        s.whole_call_multi(sm, m, Xt, tag)
    del Xt
    print("  crossing (ms a call): " + "; ".join(
        f"k={kc}: sm @ X {ms:.4f}, {kc} x sm @ x {per_col:.4f} "
        f"({per_col / ms:.2f}x), cuSPARSE {lib:.4f}"
        for kc in crossing
        for ms, per_col, lib in [s.calls[f"headline SpMM k={kc} (classic "
                                         f"device)"]]), flush=True)
    print(f"phase crossing: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- the headline's shuffled pack: the k-plane legacy final
    t0 = time.perf_counter()
    shuf = st.GStreamDevice(h.pack_gstream(m, shuffle_lanes=True),
                            device=s.dev)
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
    _save_csr(paths["roadNet-CA"], m)
    s.whole_call(sm, m, xt, "wide x (roadNet-CA)")
    s.profile("wide x (roadNet-CA)", lambda: sm @ xt)
    s.gstream(sm.device_module, xt, "wide x (roadNet-CA)")
    if s.dev.type == "cuda":
        final_rows_bins(s, small)
        final_rows_multi_bins(s, small)
    tag = "wide x SpMM k=2 (roadNet-CA)"
    Xt = spmm_path(s, tag, m, lambda X: sm @ X, [sm.device_module], 2)
    s.whole_call_multi(sm, m, Xt, tag)
    s.profile(tag, lambda: sm @ Xt)
    s.gstream_multi(sm.device_module, Xt, tag)
    checkpoint_save(s, "wide x (roadNet-CA)", sm.device_module, m, x)
    reference_programs_road(s, m, x, xt, sm)
    print(f"phase wide x: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- per-tile base: the same matrix with GL pinned
    t0 = time.perf_counter()

    def pinned(mat):
        d = st.GStreamDevice(h.pack_gstream(mat, G=8, GL=2), device=s.dev)
        return d, [d]

    _, x2, xt2, pin, devs = main_path(s, "per-tile base (roadNet-CA, GL=2)",
                                      lambda: m, pinned, t0)
    print(f"  per-tile base: GStreamDevice.spmv "
          f"{s.call_ms(lambda: pin.spmv(xt2), repeats=20):.4f} ms a call",
          flush=True)
    s.profile("per-tile base (roadNet-CA, GL=2)", lambda: pin.spmv(xt2))
    s.gstream(devs[0], xt2, "per-tile base (roadNet-CA, GL=2)")
    checkpoint_save(s, "per-tile base (roadNet-CA, GL=2)", pin, m, x2)
    print(f"phase per-tile base: {time.perf_counter() - t0:.1f} s",
          flush=True)
    del pin, devs

    # ---- the rate sweep (#16) and the chooser with its table, on the same
    # matrix; autotune on a cut of it: its five candidates' host packing
    # took 155.7 s on the H100 machine at full size and 83 s at 1M nnz (the
    # finals' build, over every row), and the phase runs it twice
    table = rates_main(s, m, sm.device_module, small, time.perf_counter())
    del m, sm
    t0 = time.perf_counter()
    autotune_main(s, road_net_ca(h, nr=AUTOTUNE_ROWS,
                                 nnz=20_000 if small else AUTOTUNE_NNZ),
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
    yd = light.spmv_blocks(xt)
    s.sync()
    print(f"  fused_spmv [web graph, light rows]: kernel vs plain max abs "
          f"{_agree(yk, yr):.3e}; the device's one launch vs its plain "
          f"version {_agree(yd, light.spmv_blocks_reference(xt)):.3e}",
          flush=True)
    s.rows_kernel(light, xt, "web graph (webbase-1M), light rows", None)
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
    s.gstream_multi(sm.heavy_device, Xt, tag + ", heavy rows")
    print(f"phase web graph: {time.perf_counter() - t0:.1f} s", flush=True)
    del m, sm, light, Xt
    fused_rows_main(s, small, time.perf_counter())

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
    _save_csr(paths["headline f64"], m)
    lib_ms = s.whole_call(sm, m, xt, "headline f64")
    s.fused_kernel(sm.device_module, sm.prepare_x(x), "headline f64", lib_ms)
    s.profile("headline f64", lambda: sm @ xt)
    one_launch(s, "headline f64", lambda: sm @ xt)
    checkpoint_save(s, "headline f64", sm.device_module, m, x)
    reference_programs_headline_f64(s, m, x, xt, sm)
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
    checkpoint_save(s, "wide x f64 (roadNet-CA)", d, m, x)
    reference_programs_road_f64(s, m, x, xt, sm)
    print(f"phase wide x f64: {time.perf_counter() - t0:.1f} s", flush=True)

    del m, sm, Xt, d
    reference_cli(s, small)

    # ---- checkpoints: the five devices saved above, loaded and driven
    checkpoint_main(s, time.perf_counter())

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

    # ---- the stage ladder (#15), the fused kernel's stage split (#17-#19,
    # #26), the fused-redesign prototypes (#20, #21, #24, #25), the select
    # chains (#22, #23) and the port's bench line
    ladder_main(s, small, time.perf_counter())
    fused_stages_main(s, small, time.perf_counter())
    fused_proto_main(s, small, time.perf_counter())
    select_chains_main(s, table, small, time.perf_counter())
    dist_main(s, paths, small, time.perf_counter())
    keep.cleanup()
    suite_main(s, small, time.perf_counter())
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
    from sparsetpu_torch.utils.timing import SETUP

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # ---- build: the CUDA library and the native packer
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"built {os.path.relpath(lib.path)} in "
          f"{SETUP.phases['csrc']:.1f} s", flush=True)
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
