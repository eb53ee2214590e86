"""Where the fused kernel's time goes on the card: the stage split of
``csrc/fused_spmv.cu`` (#1), counterpart of the TPU experiments
``scripts/exp_diag_r3.py``, ``exp_diag_r5.py``, ``exp_asm_r5.py`` and
``exp_tile_ladder.py`` (their kernels in ``csrc/fused_stages.cu``).

Phases of ``bench_fused_stages``, each timed back to back (``stream_ms``)
and a call at a time (``call_ms``, ``bench/harness.py``):

  fwd                 the forward alone, chunk sums to device memory
                      (``fused_forward``; exp_diag_r3.py:29, exp_diag_r5.py:48)
  fwd_s1              the forward into shared memory, then finish stage 1,
                      row partials to device memory (``fused_forward_stage1``,
                      the phase exp_diag_r5.py:3 names); absent where the pack
                      has ``fin_direct`` (no stage 1)
  blocks              #1 itself, ``FusedDevice.blocks``: the forward, both
                      finish stages and stage 2's atomics into the slabs
  blocks+flat         the blocks as one row (exp_asm_r5.py:46-52)
  blocks+flat+slice   then y's rows sliced out; in PyTorch both are views,
                      no device work, so they time ``blocks`` again (the
                      TPU script's XLA reshapes cost time; these cannot)
  dev.spmv            ``FusedDevice.spmv`` on a prepared x: the blocks, the
                      rows (one slice, or ``torch.cat`` on non-uniform slabs)
                      and the spills' ``index_add_``
  fwd@<variant>       the forward at #17's tile-base variants
                      (exp_asm_r5.py:107-141): random, randmeta, shuffled,
                      interleave, stride37 (``fwd`` is ``real``)
  ladder:<v>@<T>      the forward tile's component ladder
                      (exp_tile_ladder.py:31-112, ``tile_ladder``) at T tiles
                      a block: 128, the headline's grid (a block a step), and
                      ``tiles_per_block`` (default 16)

``fused_forward``, ``fused_forward_stage1`` and ``tile_ladder`` launch the
CUDA kernels for CUDA tensors (or raise) and run their plain versions
(``*_reference``) for CPU tensors; each counts its launches.
``tile_forward`` reaches the ladder kernel at any kind and GLW, and its
selects-first form, for ``bench/fused_proto.py``.

    python -m sparsetpu_torch.bench.fused_stages [headline|NAME]
        [--only a,b] [--tiles-per-block N] [--profile DIR]
        [--device cuda|cpu] [--small]

``--only`` takes phase names and the groups ``bases`` (the five fwd@
phases), ``ladder`` and ``ladder:<variant>``.
"""

from __future__ import annotations

import collections
import ctypes
import json
import sys

import numpy as np
import torch

from .. import _host
from ..formats.suitesparse import CLASSIC_SUITE, fetch
from ..kernels import spmv_fused
from ..kernels._build import check, library
from ..kernels.spmv_fused import FusedDevice
from ..utils.config import LANES, SUBLANES as CHUNK
from ..utils.device import hbm_gbps, require_device
from ..utils.timing import maybe_profiler_trace
from .harness import call_ms, stream_ms

# bench.py:81-84's matrix: (rows, cols, density, seed)
HEADLINE = (200_000, 100_000, 0.0005, 1)
# the tile ladder's variants (exp_tile_ladder.py:95-112): name -> (kernel
# variant, window groups)
LADDER_VARIANTS = {
    "full-glw16": ("full", 16), "full-glw8": ("full", 8),
    "full-glw4": ("full", 4), "no-route": ("no-route", 16),
    "no-tree": ("no-tree", 16), "no-gathers": ("no-gathers", 16),
    "no-sum": ("no-sum", 16), "bare-glw1": ("bare", 1),
}
# the ladder kernel's compile-time variants by kind (``tile_forward``);
# ``selfirst`` is #24's selects-first tile (exp_selfirst.py:66)
_VARIANT_CODE = {"full": 0, "no-route": 1, "no-tree": 2, "no-gathers": 3,
                 "no-sum": 4, "bare": 5, "selfirst": 6}
LADDER_T = 128          # tiles a step (exp_tile_ladder.py:17)
LADDER_GX8 = 800        # rows of the ladder's x window (exp_tile_ladder.py:81)
# #17's forward inputs (exp_asm_r5.py:107-141), ``real`` the pack's own
TILE_BASE_VARIANTS = ("real", "random", "randmeta", "shuffled",
                      "interleave", "stride37")


def _need(name, t, dtype, dev) -> None:
    if t is None or t.dtype != dtype or t.device != dev or \
            not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor on "
                         f"{dev}")


def _check_forward(values, meta_i1, meta_rt, tile_base, x2, T, GLW,
                   P) -> tuple:
    """Dtype, device, contiguity and shape checks shared by the forward
    kernels and their plain versions; returns (n_steps, GX)."""
    dev = x2.device
    for name, t, dt in (("values", values, torch.float32),
                        ("meta_i1", meta_i1, torch.int8),
                        ("meta_rt", meta_rt, torch.int8),
                        ("tile_base", tile_base, torch.int32),
                        ("x2", x2, torch.float32)):
        _need(name, t, dt, dev)
    if P not in (1, 2, 4, 8) or T < 1 or T * P > 128 or GLW < 1 or \
            GLW & (GLW - 1):
        raise ValueError(f"unsupported layout T={T} P={P} GLW={GLW}")
    if tile_base.dim() != 2 or tile_base.shape[1] != T:
        raise ValueError("tile_base must be (n_steps, T)")
    n_steps = tile_base.shape[0]
    for name, t in (("values", values), ("meta_i1", meta_i1),
                    ("meta_rt", meta_rt)):
        if tuple(t.shape) != (n_steps * T * CHUNK, LANES):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(n_steps * T * CHUNK, LANES)}")
    if x2.dim() != 2 or x2.shape[1] != LANES or x2.shape[0] % CHUNK or \
            x2.shape[0] < CHUNK * GLW:
        raise ValueError(f"x2 must be (GX*8, 128) with GX >= GLW={GLW}")
    return n_steps, x2.shape[0] // CHUNK


def _check_stage1(fin1_i1, fin1_rt, dev, n_steps, F1_max, F1S,
                  fin_direct) -> int:
    """The stage-1 streams' checks; returns F1A, their allocated tiles a
    step.  A ``fin_direct`` pack has no stage 1: this raises."""
    if fin_direct:
        raise ValueError("fin_direct pack: finish stage 1 is empty (stage 2 "
                         "reads the chunk sums), so there is nothing to run")
    _need("fin1_i1", fin1_i1, torch.int8, dev)
    _need("fin1_rt", fin1_rt, torch.int8, dev)
    if F1S < F1_max or F1S % CHUNK:
        raise ValueError(f"F1S={F1S} does not hold F1_max={F1_max}")
    if fin1_i1.shape != fin1_rt.shape or fin1_i1.dim() != 2 or \
            fin1_i1.shape[1] != LANES or not n_steps or \
            fin1_i1.shape[0] % (n_steps * CHUNK):
        raise ValueError("fin1 streams must be (n_steps*F*8, 128)")
    F1A = fin1_i1.shape[0] // (n_steps * CHUNK)
    if F1A < F1_max:
        raise ValueError(f"fin1 allocates {F1A} tiles per step < {F1_max}")
    return F1A


def _named_forward(values, meta_i1, meta_rt, tile_base, GX, GLW) -> dict:
    """The forward's inputs by name, tile bases clamped into [0, GX - GLW]
    as the kernel clamps them."""
    return dict(values=values, meta_i1=meta_i1, meta_rt=meta_rt,
                tile_base=tile_base.clamp(0, GX - GLW))


def forward_index(values, meta_i1, meta_rt, tile_base, x2, *, T: int,
                  GLW: int, P: int) -> torch.Tensor:
    """The flat index into x2 each forward slot reads, (n_tiles, 8, 128):
    ``spmv_fused.forward_gather_index`` at the tile bases clamped as the
    kernel clamps them."""
    _, GX = _check_forward(values, meta_i1, meta_rt, tile_base, x2, T, GLW, P)
    return spmv_fused.forward_gather_index(
        _named_forward(values, meta_i1, meta_rt, tile_base, GX, GLW), GLW)


def fused_forward_reference(values, meta_i1, meta_rt, tile_base, x2, *,
                            T: int, GLW: int, P: int) -> torch.Tensor:
    """Plain PyTorch version of the forward alone: the chunk sums
    (n_steps*T*P, 128) f32, through ``spmv_fused.forward_sums`` (the fused
    kernel's own plain forward)."""
    n_steps, GX = _check_forward(values, meta_i1, meta_rt, tile_base, x2, T,
                                 GLW, P)
    t = _named_forward(values, meta_i1, meta_rt, tile_base, GX, GLW)
    return spmv_fused.forward_sums(t, x2.reshape(-1, 1), n_steps, T=T,
                                   GLW=GLW, P=P).view(-1, LANES)


def fused_forward(values, meta_i1, meta_rt, tile_base, x2, *, T: int,
                  GLW: int, P: int) -> torch.Tensor:
    """The fused kernel's forward alone: chunk sums (n_steps*T*P, 128) f32.

    On CUDA tensors it launches ``csrc/fused_stages.cu`` (forward stage) on
    the current stream (or raises); on CPU tensors it runs
    ``fused_forward_reference``.  ``fused_forward.launches`` counts
    launches."""
    if x2.device.type == "cpu":
        return fused_forward_reference(values, meta_i1, meta_rt, tile_base,
                                       x2, T=T, GLW=GLW, P=P)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_forward: unsupported device {x2.device}")
    n_steps, GX = _check_forward(values, meta_i1, meta_rt, tile_base, x2, T,
                                 GLW, P)
    lib = library().lib
    p = ctypes.c_void_p
    with torch.cuda.device(x2.device):
        out = torch.empty(n_steps * T * P, LANES, device=x2.device)
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.fused_stage_launch(
            0, p(values.data_ptr()), p(meta_i1.data_ptr()),
            p(meta_rt.data_ptr()), p(tile_base.data_ptr()), p(0), p(0),
            p(x2.data_ptr()), p(out.data_ptr()), n_steps, T, GLW, P, GX, 0,
            0, 0, p(stream))
    check(lib, rc, "fused_forward launch")
    fused_forward.launches += 1
    return out


fused_forward.launches = 0


def fused_forward_stage1_reference(values, meta_i1, meta_rt, tile_base,
                                   fin1_i1, fin1_rt, x2, *, T: int, GLW: int,
                                   P: int, F1_max: int, F1S: int,
                                   fin_direct: int) -> torch.Tensor:
    """Plain PyTorch version of the forward and finish stage 1: the row
    partials (n_steps*F1S, 128) f32, rows past F1_max zero, through
    ``spmv_fused.forward_sums`` and ``spmv_fused.stage1_partials``."""
    n_steps, GX = _check_forward(values, meta_i1, meta_rt, tile_base, x2, T,
                                 GLW, P)
    F1A = _check_stage1(fin1_i1, fin1_rt, x2.device, n_steps, F1_max, F1S,
                        fin_direct)
    t = _named_forward(values, meta_i1, meta_rt, tile_base, GX, GLW)
    t.update(fin1_i1=fin1_i1, fin1_rt=fin1_rt)
    sums = spmv_fused.forward_sums(t, x2.reshape(-1, 1), n_steps, T=T,
                                   GLW=GLW, P=P)
    return spmv_fused.stage1_partials(t, sums, n_steps, F1A, F1_max=F1_max,
                                      F1S=F1S).view(-1, LANES)


def fused_forward_stage1(values, meta_i1, meta_rt, tile_base, fin1_i1,
                         fin1_rt, x2, *, T: int, GLW: int, P: int,
                         F1_max: int, F1S: int,
                         fin_direct: int) -> torch.Tensor:
    """The fused kernel's forward into shared memory, then finish stage 1:
    row partials (n_steps*F1S, 128) f32.  A ``fin_direct`` pack has no
    stage 1: this raises ``ValueError`` rather than time nothing.

    On CUDA tensors it launches ``csrc/fused_stages.cu`` (stage-1 form) on
    the current stream (or raises); on CPU tensors it runs
    ``fused_forward_stage1_reference``.  ``fused_forward_stage1.launches``
    counts launches."""
    if x2.device.type == "cpu":
        return fused_forward_stage1_reference(
            values, meta_i1, meta_rt, tile_base, fin1_i1, fin1_rt, x2, T=T,
            GLW=GLW, P=P, F1_max=F1_max, F1S=F1S, fin_direct=fin_direct)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_forward_stage1: unsupported device "
                         f"{x2.device}")
    n_steps, GX = _check_forward(values, meta_i1, meta_rt, tile_base, x2, T,
                                 GLW, P)
    F1A = _check_stage1(fin1_i1, fin1_rt, x2.device, n_steps, F1_max, F1S,
                        fin_direct)
    lib = library().lib
    p = ctypes.c_void_p
    with torch.cuda.device(x2.device):
        out = torch.empty(n_steps * F1S, LANES, device=x2.device)
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.fused_stage_launch(
            1, p(values.data_ptr()), p(meta_i1.data_ptr()),
            p(meta_rt.data_ptr()), p(tile_base.data_ptr()),
            p(fin1_i1.data_ptr()), p(fin1_rt.data_ptr()), p(x2.data_ptr()),
            p(out.data_ptr()), n_steps, T, GLW, P, GX, F1_max, F1A, F1S,
            p(stream))
    check(lib, rc, "fused_forward_stage1 launch")
    fused_forward_stage1.launches += 1
    return out


fused_forward_stage1.launches = 0


def _check_tiles(kind, glw, tile_base, xw, values, i1, rt) -> tuple:
    """The ladder kernel's checks for one kind at ``glw`` window groups;
    returns (blocks, tiles a block, xw's groups)."""
    if kind not in _VARIANT_CODE:
        raise ValueError(f"unknown tile kind {kind!r} (one of "
                         f"{list(_VARIANT_CODE)})")
    if glw < 1 or glw & (glw - 1):
        raise ValueError(f"glw={glw}: the window's cell decode masks the "
                         f"group bits, so glw must be a power of two")
    dev = values.device
    for name, t, dt in (("tile_base", tile_base, torch.int32),
                        ("xw", xw, torch.float32),
                        ("values", values, torch.float32),
                        ("i1", i1, torch.int8), ("rt", rt, torch.int8)):
        _need(name, t, dt, dev)
    if tile_base.dim() != 2:
        raise ValueError("tile_base must be (n_blocks, tiles a block)")
    n_blocks, T = tile_base.shape
    rows = n_blocks * T * CHUNK
    for name, t in (("values", values), ("i1", i1), ("rt", rt)):
        if tuple(t.shape) != (rows, LANES):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(rows, LANES)}")
    if xw.dim() != 2 or xw.shape[1] != LANES or xw.shape[0] % CHUNK or \
            xw.shape[0] < CHUNK * glw:
        raise ValueError(f"xw must be (8*gx, 128) with gx >= {glw}")
    return n_blocks, T, xw.shape[0] // CHUNK


def _ladder_kind(variant) -> tuple:
    """(kernel kind, window groups) of a tile ladder variant."""
    if variant not in LADDER_VARIANTS:
        raise ValueError(f"unknown ladder variant {variant!r} (one of "
                         f"{list(LADDER_VARIANTS)})")
    return LADDER_VARIANTS[variant]


def tile_gather_index(kind, glw, tile_base, xw, values, i1,
                      rt) -> torch.Tensor:
    """The flat index into xw each slot of the ladder kernel's ``kind`` at
    ``glw`` window groups reads, (n_tiles, 8, 128): slot (s, l) of tile t
    reads xw[8 b + r, j], b the tile's base clamped into [0, gx - glw], j
    the lane route (l where the kind has none), c = i1[s, j] and r its row
    in the window (see ``csrc/fused_stages.cu``)."""
    n_blocks, T, gx = _check_tiles(kind, glw, tile_base, xw, values, i1, rt)
    n = n_blocks * T
    dev = values.device
    b = tile_base.reshape(n, 1, 1).long().clamp(0, gx - glw)
    if kind in ("no-route", "bare"):
        j = torch.arange(LANES, device=dev).expand(n, CHUNK, LANES)
    else:
        j = rt.view(n, CHUNK, LANES).long() & 127
    tiles = i1.view(n, CHUNK, LANES).long()
    c = torch.gather(tiles, 2, j)
    if kind in ("no-tree", "bare"):
        r = c & 7
    elif kind == "no-gathers":
        r = ((c >> 3) & (glw - 1)) * CHUNK + torch.arange(
            CHUNK, device=dev).view(1, CHUNK, 1)
    elif kind == "selfirst":
        # the group read at the stripe cell: i1[c & 7, j] of the same tile
        g = tiles.reshape(n, -1).gather(1, ((c & 7) * LANES + j).view(n, -1))
        r = ((g.view_as(c) >> 3) & (glw - 1)) * CHUNK + (c & 7)
    else:
        r = ((c >> 3) & (glw - 1)) * CHUNK + (c & 7)
    return (CHUNK * b + r) * LANES + j


def tile_forward_reference(kind, glw, tile_base, xw, values, i1,
                           rt) -> torch.Tensor:
    """Plain PyTorch version of the ladder kernel's ``kind`` at ``glw``
    over all tiles at once: (n_tiles, 128) f32, each slot's value times xw
    at ``tile_gather_index``, summed over the tile's 8 sublanes;
    ``no-sum`` keeps sublane 0's product unless the sum is NaN."""
    idx = tile_gather_index(kind, glw, tile_base, xw, values, i1, rt)
    prod = values.view(idx.shape) * xw.reshape(-1)[idx]
    total = prod.sum(1)
    if kind == "no-sum":
        return torch.where(total.isnan(), total, prod[:, 0])
    return total


def tile_ladder_reference(variant, tile_base, xw, values, i1,
                          rt) -> torch.Tensor:
    """Plain PyTorch version of one ladder variant:
    ``tile_forward_reference`` at its kind and window."""
    return tile_forward_reference(*_ladder_kind(variant), tile_base, xw,
                                  values, i1, rt)


def _launch_tiles(kind, glw, tile_base, xw, values, i1, rt) -> torch.Tensor:
    """One launch of the ladder kernel's ``kind`` at ``glw`` on CUDA
    tensors (or raises)."""
    if values.device.type != "cuda":
        raise ValueError(f"the tile kernel: unsupported device "
                         f"{values.device}")
    n_blocks, T, gx = _check_tiles(kind, glw, tile_base, xw, values, i1, rt)
    lib = library().lib
    p = ctypes.c_void_p
    with torch.cuda.device(values.device):
        out = torch.empty(n_blocks * T, LANES, device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.tile_ladder_launch(
            _VARIANT_CODE[kind], p(tile_base.data_ptr()), p(xw.data_ptr()),
            p(values.data_ptr()), p(i1.data_ptr()), p(rt.data_ptr()),
            p(out.data_ptr()), n_blocks, T, glw, gx, p(stream))
    check(lib, rc, f"tile kernel {kind} at glw {glw} launch")
    return out


def tile_ladder(variant, tile_base, xw, values, i1, rt) -> torch.Tensor:
    """One variant of the forward tile's component ladder: (n_tiles, 128)
    f32, tile_base (n_blocks, T) giving the grid (T tiles a block).

    On CUDA tensors it launches ``csrc/fused_stages.cu`` (the ladder
    kernel) on the current stream (or raises); on CPU tensors it runs
    ``tile_ladder_reference``.  ``tile_ladder.launches`` counts launches by
    variant."""
    if values.device.type == "cpu":
        return tile_ladder_reference(variant, tile_base, xw, values, i1, rt)
    out = _launch_tiles(*_ladder_kind(variant), tile_base, xw, values, i1,
                        rt)
    tile_ladder.launches[variant] += 1
    return out


tile_ladder.launches = collections.Counter()


def tile_forward(kind, glw, tile_base, xw, values, i1, rt) -> torch.Tensor:
    """The ladder kernel at any kind (``full``, the ladder's others, or
    ``selfirst``, #24's selects-first tile) and any power-of-two ``glw``:
    (n_tiles, 128) f32, tile_base (n_blocks, T) giving the grid.  #21's
    GLW ladder is ``full`` at each GLW, #24's A ``full`` at 16 and its B
    ``selfirst`` at 16.

    On CUDA tensors it launches ``csrc/fused_stages.cu`` on the current
    stream (or raises); on CPU tensors it runs ``tile_forward_reference``.
    ``tile_forward.launches`` counts launches by ``"<kind>-glw<glw>"``,
    apart from ``tile_ladder``'s."""
    if values.device.type == "cpu":
        return tile_forward_reference(kind, glw, tile_base, xw, values, i1,
                                      rt)
    out = _launch_tiles(kind, glw, tile_base, xw, values, i1, rt)
    tile_forward.launches[f"{kind}-glw{glw}"] += 1
    return out


tile_forward.launches = collections.Counter()


# -- inputs -------------------------------------------------------------------

def stage_matrix(name: str = "headline", small: bool = False) -> tuple:
    """(f32 CSR matrix, label) of a stage split: ``headline`` is
    ``bench.py:81-84``'s (20,000 rows with ``small``), any other name a
    ``CLASSIC_SUITE`` entry from the cache directory or, without the file,
    its synthetic stand-in (``exp_diag_r5.py:25-28``)."""
    if name == "headline":
        rows, cols, density, seed = HEADLINE
        m = _host.random_csr(20_000 if small else rows, cols,
                             density=density, seed=seed, dtype=np.float32)
        return m, f"headline {m.nr_rows}x{m.nr_cols}"
    if name not in CLASSIC_SUITE:
        raise KeyError(f"{name!r}: headline or one of {list(CLASSIC_SUITE)}")
    m, real = fetch(name, allow_synthetic=True)
    m.values = m.values.astype(np.float32)
    return m, f"{name} ({'file' if real else 'synthetic stand-in'})"


def stage_inputs(source, device="cuda", seed: int = 0) -> dict:
    """The stage split's inputs from a ``FusedDevice`` (its uploaded
    streams) or a CSR matrix (packed with ``pack_fused`` and uploaded to
    ``device``).  x is ``default_rng(seed).standard_normal(nr_cols)``, as
    the scripts draw it (``exp_diag_r5.py:33``).  Returns ``device`` (the
    FusedDevice), ``x2`` (x prepared), ``fwd`` (``fused_forward``'s
    arguments) and ``fwd_s1`` (``fused_forward_stage1``'s, None where the
    pack has ``fin_direct``)."""
    if isinstance(source, FusedDevice):
        dev = source
    else:
        packed = _host.pack_fused(source)
        if packed is None:
            raise ValueError("the fused layout does not apply to this matrix")
        dev = FusedDevice.from_packed(packed, device)
    p = dev.meta
    x2 = dev.prepare_x(np.random.default_rng(seed).standard_normal(
        p.nr_cols))
    fwd = dict(values=dev.values, meta_i1=dev.meta_i1, meta_rt=dev.meta_rt,
               tile_base=dev.tile_base, x2=x2, T=p.T, GLW=p.GLW, P=p.planes)
    s1 = None if p.fin_direct else dict(
        fwd, fin1_i1=dev.fin1_i1, fin1_rt=dev.fin1_rt, F1_max=p.F1_max,
        F1S=p.F1S, fin_direct=p.fin_direct)
    return {"device": dev, "x2": x2, "fwd": fwd, "fwd_s1": s1}


def tile_base_variants(dev: FusedDevice, seed: int = 0) -> dict:
    """#17's forward inputs (``exp_asm_r5.py:107-141``), by name: tile_base,
    meta_i1 and meta_rt tensors on ``dev``'s device.  ``real`` is the pack;
    ``random`` bases from ``default_rng(seed)`` in [0, GX - GLW), then
    ``randmeta`` (real bases, int8 metadata in [0, 128) from the same
    generator); ``shuffled`` each step's bases permuted by
    ``default_rng(seed + 1)``; ``interleave`` the two halves of a step
    alternated; ``stride37`` taken in stride 37 (41 where 37 divides T).
    The script rebinds the device's metadata for ``randmeta``, so where it
    runs every group its later variants inherit the random metadata; here
    each variant other than ``randmeta`` keeps the pack's."""
    p = dev.meta
    real = dict(tile_base=dev.tile_base, meta_i1=dev.meta_i1,
                meta_rt=dev.meta_rt)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            dev.device)
    rng = np.random.default_rng(seed)
    out = {"real": real, "random": dict(real, tile_base=up(rng.integers(
        0, max(p.GX - p.GLW, 1), (p.n_steps, p.T)), np.int32))}
    i1 = up(rng.integers(0, 128, tuple(dev.meta_i1.shape)), np.int8)
    rt = up(rng.integers(0, 128, tuple(dev.meta_rt.shape)), np.int8)
    out["randmeta"] = dict(real, meta_i1=i1, meta_rt=rt)
    tb = dev.tile_base.cpu().numpy()
    rng = np.random.default_rng(seed + 1)
    out["shuffled"] = dict(real, tile_base=up(
        np.stack([rng.permutation(r) for r in tb]), np.int32))
    T = tb.shape[1]
    order = np.empty(T, np.int64)
    order[0::2] = np.arange(T // 2)
    order[1::2] = np.arange(T // 2, T)
    out["interleave"] = dict(real, tile_base=up(tb[:, order], np.int32))
    s = 37 if np.gcd(37, T) == 1 else 41
    out["stride37"] = dict(real, tile_base=up(tb[:, (np.arange(T) * s) % T],
                                              np.int32))
    return out


def tile_ladder_inputs(n_steps: int, tiles_per_block: int = LADDER_T,
                       seed: int = 0, device="cuda") -> dict:
    """The ladder's inputs (``exp_tile_ladder.py:78-91``), drawn from
    ``default_rng(seed)`` in the script's order: the x window (800, 128)
    f32, values (n_steps*128*8, 128) f32, int8 cells and routes in [0,
    128), and a base in [0, 800/8 - 16) a tile, (n_steps, 128) in the
    script and here (n_steps*128/tiles_per_block, tiles_per_block), the
    kernel's grid.  Keys are ``tile_ladder``'s arguments."""
    dev = require_device(device)
    n_tiles = n_steps * LADDER_T
    if n_tiles % tiles_per_block:
        raise ValueError(f"{n_tiles} tiles do not split into blocks of "
                         f"{tiles_per_block}")
    rng = np.random.default_rng(seed)
    rows = n_tiles * CHUNK

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
    xw = up(rng.standard_normal((LADDER_GX8, LANES)), np.float32)
    values = up(rng.standard_normal((rows, LANES)), np.float32)
    i1 = up(rng.integers(0, 128, (rows, LANES)), np.int8)
    rt = up(rng.integers(0, 128, (rows, LANES)), np.int8)
    tb = rng.integers(0, LADDER_GX8 // CHUNK - 16, (n_steps, LADDER_T))
    return dict(tile_base=up(tb.reshape(-1, tiles_per_block), np.int32),
                xw=xw, values=values, i1=i1, rt=rt)


# -- the split ----------------------------------------------------------------

def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _launch_counts() -> dict:
    return {"fused_forward": fused_forward.launches,
            "fused_forward_stage1": fused_forward_stage1.launches,
            "fused_spmv": spmv_fused.fused_spmv.launches,
            **{f"tile_ladder:{k}": v
               for k, v in tile_ladder.launches.items()}}


def _wanted(name: str, only) -> bool:
    """A phase runs when ``only`` is None or names it or its group:
    ``bases`` (the forward at #17's other inputs), ``ladder`` (every ladder
    phase) or ``ladder:<variant>`` (that variant at every grid)."""
    if only is None:
        return True
    groups = {name}
    if name.startswith("fwd@"):
        groups.add("bases")
    if name.startswith("ladder:"):
        groups |= {"ladder", name.split("@")[0]}
    return not groups.isdisjoint(only)


def _phases(inp: dict, ladder: dict, grids) -> list:
    """(name, fn, bytes) of every phase, in order."""
    dev, x2, fwd, s1 = inp["device"], inp["x2"], inp["fwd"], inp["fwd_s1"]
    p = dev.meta
    fwd_in = _nbytes(dev.values, dev.meta_i1, dev.meta_rt, dev.tile_base,
                     x2)
    fwd_bytes = fwd_in + p.n_steps * p.T * p.planes * LANES * 4
    phases = [("fwd", lambda: fused_forward(**fwd), fwd_bytes)]
    if s1 is not None:
        s1_bytes = fwd_in + 2 * p.n_steps * p.F1_max * CHUNK * LANES \
            + p.n_steps * p.F1S * LANES * 4
        phases.append(("fwd_s1", lambda: fused_forward_stage1(**s1),
                       s1_bytes))
    n = int(p.slab_bounds[-1])
    blocks_bytes = _nbytes(*(getattr(dev, k) for k, _ in
                             spmv_fused._KERNEL_INPUTS), x2) \
        + p.n_slabs * p.OBp * LANES * 4
    spill_bytes = _nbytes(*(getattr(dev, k) for k in
                            ("spill_row", "spill_col", "spill_val")
                            if hasattr(dev, k)))
    phases += [
        ("blocks", lambda: dev.blocks(x2), blocks_bytes),
        ("blocks+flat", lambda: dev.blocks(x2).view(1, -1), blocks_bytes),
        ("blocks+flat+slice",
         lambda: dev.blocks(x2).view(-1)[:n].view(1, -1), blocks_bytes),
        ("dev.spmv", lambda: dev.spmv(x2, x_is_packed=True),
         blocks_bytes + spill_bytes)]
    for name, arrays in inp.get("tile_bases", {}).items():
        if name != "real":
            phases.append((f"fwd@{name}",
                           lambda a=arrays: fused_forward(**dict(fwd, **a)),
                           fwd_bytes))
    for T in grids:
        args = dict(ladder, tile_base=ladder["tile_base"].view(-1, T))
        for v, (kind, _) in LADDER_VARIANTS.items():
            streams = [args[k] for k in ("tile_base", "xw", "values", "i1")]
            if kind not in ("no-route", "bare"):
                streams.append(args["rt"])
            nb = _nbytes(*streams) + args["values"].numel() // CHUNK * 4
            phases.append((f"ladder:{v}@{T}",
                           lambda v=v, a=args: tile_ladder(v, **a), nb))
    return phases


def _profile_rows(prof, calls: int, cuda: bool) -> list:
    """(op, us a call, launches a call) from a profiler, by self time on
    the device (the host clock for a CPU run), largest first."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        us = e.self_device_time_total if cuda else e.self_cpu_time_total
        if us > 0 and (e.device_type == DeviceType.CUDA) == cuda:
            rows.append((e.key, us / calls, e.count / calls))
    return sorted(rows, key=lambda r: -r[1])


def bench_fused_stages(matrix="headline", *, device="cuda", only=None,
                       tiles_per_block=None, profile_dir=None, timer=None,
                       verbose: bool = False) -> dict:
    """Time every phase of the fused kernel's stage split (this module's
    docstring) on ``matrix``: ``headline``, a ``CLASSIC_SUITE`` name, a
    CSR matrix or a ``FusedDevice`` already on ``device``.  ``only`` keeps
    the phases it names, by name or group (``bases``, ``ladder``,
    ``ladder:<variant>``); the ladder runs at 128 tiles a
    block and at ``tiles_per_block`` (default 16), on as many steps as the
    pack has on a card (2 on the CPU).

    Returns {phase: {stream_ms, call_ms, bytes, bound_ms, launches}}:
    ``bound_ms`` is ``bytes`` (each input read once, each output written
    once) at the card's HBM rate, None on the CPU; ``launches`` counts each
    kernel's launches during the phase.  A ``fin_direct`` pack's ``fwd_s1``
    holds only ``skipped``.  With ``profile_dir``, ``dev.spmv`` runs 20
    more times under ``maybe_profiler_trace`` and its entry gains
    ``profile``: (op, us a call, launches a call) by device time.  On the
    CPU the phases run the plain versions and ``timer(fn, device) -> ms``
    must be given (it replaces both clocks): CPU times are not kernel
    times."""
    dev = require_device(device)
    if timer is None:
        if dev.type != "cuda":
            raise ValueError("bench_fused_stages on the CPU needs a timer: "
                             "CPU times are not kernel times")
        stream_t, call_t = stream_ms, call_ms
    else:
        stream_t = call_t = timer
    if isinstance(matrix, str):
        matrix, _ = stage_matrix(matrix)
    inp = stage_inputs(matrix, dev)
    fdev = inp["device"]
    p = fdev.meta
    if any(_wanted(f"fwd@{v}", only) for v in TILE_BASE_VARIANTS[1:]):
        inp["tile_bases"] = {
            k: v for k, v in tile_base_variants(fdev).items()
            if k == "real" or _wanted(f"fwd@{k}", only)}
    grids = tuple(dict.fromkeys((LADDER_T, tiles_per_block or 16)))
    ladder = None
    if any(_wanted(f"ladder:{v}@{T}", only) for v in LADDER_VARIANTS
           for T in grids):
        ladder = tile_ladder_inputs(
            p.n_steps if dev.type == "cuda" else 2, LADDER_T, device=dev)
    phases = [ph for ph in _phases(inp, ladder or {}, grids if ladder
                                   else ()) if _wanted(ph[0], only)]
    gbps = hbm_gbps(dev) if dev.type == "cuda" else None
    results = {}
    if p.fin_direct and _wanted("fwd_s1", only):
        results["fwd_s1"] = {"skipped": "fin_direct: the pack has no finish "
                                        "stage 1"}
    if phases and dev.type == "cuda":
        # warm the card, so that the first phase is not timed at idle clocks
        for _ in range(200):
            phases[0][1]()
        torch.cuda.synchronize(dev)
    for name, fn, nbytes in phases:
        before = _launch_counts()
        r = {"stream_ms": stream_t(fn, dev), "call_ms": call_t(fn, dev),
             "bytes": nbytes,
             "bound_ms": nbytes / (gbps * 1e9) * 1e3 if gbps else None}
        after = _launch_counts()
        r["launches"] = {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}
        results[name] = r
        if verbose:
            share = (f"{r['bound_ms'] / r['stream_ms']:.3f} of its bound"
                     if gbps else "no bound on the CPU")
            print(f"  {name:26s} {r['stream_ms']:8.4f} ms back to back "
                  f"{r['call_ms']:8.4f} ms a call  {nbytes / 1e6:8.2f} MB  "
                  f"{share}", flush=True)
    if profile_dir is not None and "dev.spmv" in results:
        fn = dict((n, f) for n, f, _ in phases)["dev.spmv"]
        calls = 20
        with maybe_profiler_trace(profile_dir) as prof:
            for _ in range(calls):
                fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        rows = _profile_rows(prof, calls, dev.type == "cuda")
        results["dev.spmv"]["profile"] = rows
        if verbose:
            clock = "device" if dev.type == "cuda" else "host (CPU run)"
            print(f"  dev.spmv by op ({clock} time a call over {calls} "
                  f"calls, trace in {profile_dir}):"
                  + ("" if rows else " the profiler recorded none"),
                  flush=True)
            for key, us, count in rows[:10]:
                print(f"    {us:9.2f} us  x{count:g}  {key[:80]}",
                      flush=True)
    return results


def describe(dev: FusedDevice) -> str:
    """The pack's layout, as the scripts print it (exp_diag_r5.py:37-38)."""
    p = dev.meta
    return (f"steps={p.n_steps} T={p.T} P={p.planes} (Q={p.Q}) "
            f"GLW={p.GLW} F1={p.F1_max} F2={p.F2_max} F1S={p.F1S} "
            f"OBp={p.OBp} fill={p.fill_factor:.3f} slabs={p.n_slabs} "
            f"SGRP={p.SGRP} fin_direct={p.fin_direct} "
            f"spills={p.spill_row.size}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m sparsetpu_torch.bench.fused_stages",
        description="where the fused kernel's time goes: its stage split")
    ap.add_argument("matrix", nargs="?", default="headline",
                    help="headline (bench.py's matrix) or a CLASSIC_SUITE "
                         "name (the cached .mtx, else its stand-in)")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases or groups (fwd, fwd_s1, "
                         "blocks, dev.spmv, bases, ladder, "
                         "ladder:no-sum, ...)")
    ap.add_argument("--tiles-per-block", type=int, default=None,
                    help="the ladder's second grid (default 16)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of dev.spmv to DIR")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help="the headline cut to 20,000 rows (a CPU rehearsal)")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    m, label = stage_matrix(args.matrix, small=args.small)
    inp = stage_inputs(m, dev)
    print(f"{label}: nnz={m.nr_nzeros} {describe(inp['device'])}",
          flush=True)
    if dev.type == "cuda":
        from ..utils.device import card_line
        print(card_line(), flush=True)
        timer = None
    else:
        print("CPU run: plain versions, host clock (not kernel times)",
              flush=True)

        def timer(fn, d):
            return call_ms(fn, d, repeats=3)
    res = bench_fused_stages(
        inp["device"], device=dev,
        only=args.only.split(",") if args.only else None,
        tiles_per_block=args.tiles_per_block, profile_dir=args.profile,
        timer=timer, verbose=True)
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                      for k, v in res.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
