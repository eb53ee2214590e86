"""Multi-RHS SpMM on the classic GStream device (counterpart of
``sparsetpu/kernels/spmm.py``).

Y = A @ X for X of shape (nr_cols, k).  The k planes share one pass over
the packed stream: the forward decodes each slot once and gathers it for
every plane (``csrc/gstream_spmm.cu``), and the multi-plane final decodes
each final slot once for up to 8 planes (``csrc/gstream_final_multi.cu``).

Layout: X, the chunk sums and the final's grid are row-major (rows, k), so
the k values of one column, position or row are contiguous; Y is (nr_rows,
k).  (The JAX package keeps (k, rows/128, 128) planes: its test compares
``Y``.)  X and every sum stay f32, in the bf16 value mode too; on the f64
device (float64 values) they are float64, the forward runs
``gstream_chunk_sums_multi_f64`` and each plane finishes through the
device's own f64 final (there is no k-plane f64 final, as in the JAX
package's ``spmm_df64``).

Each wrapper runs its plain PyTorch version (``..._reference``) for tensors
on the CPU and launches its kernel (or raises) for tensors on a CUDA
device.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ._build import check, library
from .spmv_gstream import (CHUNK, LANES, FinalDevice, GStreamDevice,
                           _check_final, _check_forward, final_gather_index,
                           forward_gather_index)


# ---------------------------------------------------------------------------
# forward: k planes of chunk sums (TPU kernel _spmm_kernel)
# ---------------------------------------------------------------------------

def gstream_chunk_sums_multi_reference(values, meta, step_window, X, *,
                                       T: int, G: int, P: int, GL: int = 0,
                                       tile_base=None) -> torch.Tensor:
    """Plain PyTorch version of the k-plane forward, over all tiles and
    planes at once.  X row-major (padded_cols, k); returns the chunk sums,
    row-major (n_tiles*P*128, k), in X's real type."""
    n_tiles = _check_forward(values, meta, step_window, tile_base, X, T=T,
                             G=G, P=P, GL=GL, multi=True)
    k = X.shape[1]
    idx, ok = forward_gather_index(meta, step_window, T=T, G=G, GL=GL,
                                   tile_base=tile_base)
    xv = torch.where(ok.unsqueeze(-1), X[idx], 0.0)
    prod = values.view(-1, CHUNK, LANES, 1).to(X.dtype) * xv
    return prod.view(n_tiles, P, CHUNK // P, LANES, k).sum(2).view(-1, k)


def gstream_chunk_sums_multi(values, meta, step_window, X, *, T: int, G: int,
                             P: int, GL: int = 0,
                             tile_base=None) -> torch.Tensor:
    """The k-plane forward kernel: chunk sums (n_tiles*P*128, k) f32.

    On CUDA tensors it launches ``csrc/gstream_spmm.cu`` on the current
    stream (or raises); on CPU tensors it runs
    ``gstream_chunk_sums_multi_reference``.
    ``gstream_chunk_sums_multi.launches`` counts launches.  f64 values go
    to ``gstream_chunk_sums_multi_f64``."""
    if values.dtype == torch.float64:
        return gstream_chunk_sums_multi_f64(values, meta, step_window, X,
                                            T=T, G=G, P=P, GL=GL,
                                            tile_base=tile_base)
    if X.device.type == "cpu":
        return gstream_chunk_sums_multi_reference(
            values, meta, step_window, X, T=T, G=G, P=P, GL=GL,
            tile_base=tile_base)
    if X.device.type != "cuda":
        raise ValueError(f"gstream_chunk_sums_multi: unsupported device "
                         f"{X.device}")
    n_tiles = _check_forward(values, meta, step_window, tile_base, X, T=T,
                             G=G, P=P, GL=GL, multi=True)
    k = X.shape[1]
    lib = library().lib
    with torch.cuda.device(X.device):
        out = torch.empty(n_tiles * P * LANES, k, device=X.device)
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.gstream_spmm_launch(
            ctypes.c_void_p(values.data_ptr()),
            int(values.dtype == torch.bfloat16),
            ctypes.c_void_p(meta.data_ptr()),
            ctypes.c_void_p(step_window.data_ptr()),
            ctypes.c_void_p(tile_base.data_ptr() if GL else 0),
            ctypes.c_void_p(X.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n_tiles, T, G, GL, P, k, ctypes.c_void_p(stream))
    check(lib, rc, "gstream_chunk_sums_multi launch")
    gstream_chunk_sums_multi.launches += 1
    return out


gstream_chunk_sums_multi.launches = 0


def gstream_chunk_sums_multi_f64(values, meta, step_window, X, *, T: int,
                                 G: int, P: int, GL: int = 0,
                                 tile_base=None) -> torch.Tensor:
    """The k-plane forward kernel in native FP64 (window scheme): chunk
    sums (n_tiles*P*128, k) f64 for f64 values and X.

    On CUDA tensors it launches the f64 form of ``csrc/gstream_spmm.cu``
    (or raises, also for GL > 0); on CPU tensors it runs
    ``gstream_chunk_sums_multi_reference``.
    ``gstream_chunk_sums_multi_f64.launches`` counts launches."""
    if values.dtype != torch.float64:
        raise ValueError("gstream_chunk_sums_multi_f64 takes float64 values")
    if X.device.type == "cpu":
        return gstream_chunk_sums_multi_reference(
            values, meta, step_window, X, T=T, G=G, P=P, GL=GL,
            tile_base=tile_base)
    if X.device.type != "cuda":
        raise ValueError(f"gstream_chunk_sums_multi_f64: unsupported device "
                         f"{X.device}")
    n_tiles = _check_forward(values, meta, step_window, tile_base, X, T=T,
                             G=G, P=P, GL=GL, multi=True)
    k = X.shape[1]
    lib = library().lib
    with torch.cuda.device(X.device):
        out = torch.empty(n_tiles * P * LANES, k, dtype=torch.float64,
                          device=X.device)
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.gstream_spmm_f64_launch(
            ctypes.c_void_p(values.data_ptr()),
            ctypes.c_void_p(meta.data_ptr()),
            ctypes.c_void_p(step_window.data_ptr()),
            ctypes.c_void_p(X.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n_tiles, T, G, P, k, ctypes.c_void_p(stream))
    check(lib, rc, "gstream_chunk_sums_multi_f64 launch")
    gstream_chunk_sums_multi_f64.launches += 1
    return out


gstream_chunk_sums_multi_f64.launches = 0


# ---------------------------------------------------------------------------
# final levels: k planes (TPU kernels _final_multi_kernel /
# _final_v2_multi_kernel)
# ---------------------------------------------------------------------------

def final_gather_multi_reference(step_meta, tile_bases, inst_start, X, cells,
                                 route, *, tps: int, G: int, nw: int,
                                 GS: int, nt_pad: int,
                                 v2: bool) -> torch.Tensor:
    """Plain PyTorch version of the k-plane final, over all instances and
    planes at once: decode, gather, sum over the 8 sublanes, ``index_add_``
    of each instance into its out block (in instance order).  X row-major
    (x_pad_rows*128, k); returns the grid, row-major (nt_pad*128, k)."""
    n_steps = _check_final(step_meta, tile_bases, inst_start, X, cells,
                           route, tps=tps, G=G, nw=nw, GS=GS, nt_pad=nt_pad,
                           v2=v2, multi=True)
    k = X.shape[1]
    idx, ok = final_gather_index(step_meta, tile_bases, cells, route,
                                 tps=tps, G=G, nw=nw, GS=GS, v2=v2)
    part = torch.where(ok.unsqueeze(-1), X[idx], 0.0).sum(2)
    out = torch.zeros(nt_pad // tps, tps, LANES, k, device=X.device)
    out.index_add_(0, step_meta[:, nw + 1].long(), part)
    return out.view(nt_pad * LANES, k)


def final_gather_multi(step_meta, tile_bases, inst_start, X, cells, route,
                       *, tps: int, G: int, nw: int, GS: int, nt_pad: int,
                       v2: bool) -> torch.Tensor:
    """The k-plane final kernel: the grid (nt_pad*128, k) f32.

    On CUDA tensors it launches ``csrc/gstream_final_multi.cu`` on the
    current stream (or raises); on CPU tensors it runs
    ``final_gather_multi_reference``.  ``final_gather_multi.launches``
    counts launches by scheme: ``"legacy"`` and ``"flat"``."""
    if X.device.type == "cpu":
        return final_gather_multi_reference(
            step_meta, tile_bases, inst_start, X, cells, route, tps=tps, G=G,
            nw=nw, GS=GS, nt_pad=nt_pad, v2=v2)
    if X.device.type != "cuda":
        raise ValueError(f"final_gather_multi: unsupported device "
                         f"{X.device}")
    _check_final(step_meta, tile_bases, inst_start, X, cells, route,
                 tps=tps, G=G, nw=nw, GS=GS, nt_pad=nt_pad, v2=v2, multi=True)
    k = X.shape[1]
    lib = library().lib
    with torch.cuda.device(X.device):
        out = torch.empty(nt_pad * LANES, k, device=X.device)
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.gstream_final_multi_launch(
            int(v2), ctypes.c_void_p(step_meta.data_ptr()),
            ctypes.c_void_p(tile_bases.data_ptr() if v2 else 0),
            ctypes.c_void_p(inst_start.data_ptr()),
            ctypes.c_void_p(X.data_ptr()), ctypes.c_void_p(cells.data_ptr()),
            ctypes.c_void_p(route.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), nt_pad, tps, G, nw, GS, k,
            ctypes.c_void_p(stream))
    check(lib, rc, "final_gather_multi launch")
    final_gather_multi.launches["flat" if v2 else "legacy"] += 1
    return out


final_gather_multi.launches = collections.Counter()


# ---------------------------------------------------------------------------
# the device's SpMM
# ---------------------------------------------------------------------------

def spmm_gstream(device: GStreamDevice, X) -> torch.Tensor:
    """Y = A @ X (nr_rows, k) on a classic device, routed as the JAX
    package's ``spmm_gstream`` (``sparsetpu/kernels/spmm.py:107-114``): the
    k-plane forward, then the k-plane flat final for a ``_FinalLevelV2``
    with no F levels, the k-plane legacy final for a ``_FinalLevel`` with
    no F levels, and otherwise each plane through the device's own finish
    (F levels, ``_FinalLevelMulti``, the segment-sum route, and every final
    of the f64 device).  On a GL-pinned pack the forward adds the per-tile
    bases, which the JAX kernel leaves out."""
    if not isinstance(device, GStreamDevice):
        raise TypeError(f"spmm_gstream needs a GStreamDevice, got "
                        f"{type(device).__name__}")
    cs = device.stream.forward_multi(device.prepare_x_multi(X))
    if isinstance(device.final, FinalDevice) and not len(device.flevels) \
            and cs.dtype == torch.float32:
        return device.final.apply_multi(cs)
    return torch.stack([device.finish_vec(cs[:, kk].contiguous())
                        for kk in range(cs.shape[1])], dim=1)
