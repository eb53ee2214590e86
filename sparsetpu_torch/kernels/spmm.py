"""Multi-RHS SpMM on the classic GStream device (counterpart of
``sparsetpu/kernels/spmm.py``).

Y = A @ X for X of shape (nr_cols, k).  The k planes share one pass over
the packed stream: the forward decodes each tile once into shared memory
and gathers each slot's row of X for every plane
(``csrc/gstream_spmm.cu``); each F level's k planes are one more launch of
it; the final level is the row-sorted map on k planes
(``final_rows.final_rows_multi``, ``csrc/final_rows.cu``), every final
kind and spill in one launch (two where rows are long), or one k-plane
``index_add_`` on the segment-sum route.

Layout: X, the chunk sums and the position vector are row-major (rows, k),
so the k values of one column or position are contiguous; Y is (nr_rows,
k).  (The JAX package keeps (k, rows/128, 128) planes: its test compares
``Y``.)  X and every sum stay f32, in the bf16 value mode too; on the f64
device (float64 values) they are float64, the forward runs
``gstream_chunk_sums_multi_f64`` and the final its f64 form (the JAX
package's ``spmm_df64`` finishes a plane at a time).

Each wrapper runs its plain PyTorch version (``..._reference``) for tensors
on the CPU and launches its kernel (or raises) for tensors on a CUDA
device.  ``final_gather_multi_reference`` is the TPU layout's k-plane
final in plain PyTorch, the tests' yardstick.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.timing import span
from ._build import check, library, vector_width
from .spmv_gstream import (CHUNK, LANES, GStreamDevice, _check_final,
                           _check_forward, final_gather_index,
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


def _check_kernel_forward(values, meta, step_window, tile_base, X, *, T, G,
                          P, GL) -> int:
    """``_check_forward`` and what the kernel adds: X's rows fit int32 (the
    decoded rows are 32-bit) and the meta stream is 16-byte aligned (its
    tiles are read in 16-byte loads)."""
    n_tiles = _check_forward(values, meta, step_window, tile_base, X, T=T,
                             G=G, P=P, GL=GL, multi=True)
    if X.shape[0] > 2**31 - 1:
        raise ValueError(f"X has {X.shape[0]} rows, past int32")
    if meta.data_ptr() % 16:
        raise ValueError("meta must be 16-byte aligned")
    return n_tiles


def gstream_chunk_sums_multi(values, meta, step_window, X, *, T: int, G: int,
                             P: int, GL: int = 0,
                             tile_base=None) -> torch.Tensor:
    """The k-plane forward kernel: chunk sums (n_tiles*P*128, k) f32.

    On CUDA tensors it launches ``csrc/gstream_spmm.cu`` on the current
    stream, a block a tile, a thread a (chunk sum, 16-byte vector of its k
    planes) (or it raises); on CPU tensors it runs
    ``gstream_chunk_sums_multi_reference``.
    ``gstream_chunk_sums_multi.launches`` counts launches.  f64 values go
    to ``gstream_chunk_sums_multi_f64``.  A
    ``sparsetpu.launch.gstream_chunk_sums_multi`` span a call."""
    if values.dtype == torch.float64:
        return gstream_chunk_sums_multi_f64(values, meta, step_window, X,
                                            T=T, G=G, P=P, GL=GL,
                                            tile_base=tile_base)
    with span("launch.gstream_chunk_sums_multi"):
        if X.device.type == "cpu":
            return gstream_chunk_sums_multi_reference(
                values, meta, step_window, X, T=T, G=G, P=P, GL=GL,
                tile_base=tile_base)
        if X.device.type != "cuda":
            raise ValueError(f"gstream_chunk_sums_multi: unsupported "
                             f"device {X.device}")
        n_tiles = _check_kernel_forward(values, meta, step_window,
                                        tile_base, X, T=T, G=G, P=P, GL=GL)
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
                n_tiles, T, G, GL, P, k, vector_width(k, X, out),
                ctypes.c_void_p(stream))
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
    ``gstream_chunk_sums_multi_f64.launches`` counts launches.  A
    ``sparsetpu.launch.gstream_chunk_sums_multi_f64`` span a call."""
    if values.dtype != torch.float64:
        raise ValueError("gstream_chunk_sums_multi_f64 takes float64 values")
    with span("launch.gstream_chunk_sums_multi_f64"):
        if X.device.type == "cpu":
            return gstream_chunk_sums_multi_reference(
                values, meta, step_window, X, T=T, G=G, P=P, GL=GL,
                tile_base=tile_base)
        if X.device.type != "cuda":
            raise ValueError(f"gstream_chunk_sums_multi_f64: unsupported "
                             f"device {X.device}")
        n_tiles = _check_kernel_forward(values, meta, step_window,
                                        tile_base, X, T=T, G=G, P=P, GL=GL)
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
                n_tiles, T, G, P, k, vector_width(k, X, out),
                ctypes.c_void_p(stream))
        check(lib, rc, "gstream_chunk_sums_multi_f64 launch")
        gstream_chunk_sums_multi_f64.launches += 1
        return out


gstream_chunk_sums_multi_f64.launches = 0


# ---------------------------------------------------------------------------
# the TPU layout's k-plane final (TPU kernels _final_multi_kernel /
# _final_v2_multi_kernel), in plain PyTorch: the tests' yardstick; the
# device runs final_rows.final_rows_multi
# ---------------------------------------------------------------------------

def final_gather_multi_reference(step_meta, tile_bases, inst_start, X, cells,
                                 route, *, tps: int, G: int, nw: int,
                                 GS: int, nt_pad: int,
                                 v2: bool) -> torch.Tensor:
    """The TPU layout's k-plane final in plain PyTorch, over all instances
    and planes at once: decode, gather, sum over the 8 sublanes, ``index_add_``
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


# ---------------------------------------------------------------------------
# the device's SpMM
# ---------------------------------------------------------------------------

def spmm_gstream(device: GStreamDevice, x_multi) -> torch.Tensor:
    """Y = A @ X (nr_rows, k) for X = ``x_multi`` (nr_cols, k) on a classic
    device: the k-plane forward, each F level's k planes through the same
    kernel, then the final on all k planes at once (``apply_multi``: one
    row-sorted gather-sum over every level and spill), or, with no final, one k-plane ``index_add_`` of the
    positions that hold a row.  The JAX package's ``spmm_gstream``
    (``sparsetpu/kernels/spmm.py:107-114``) finishes a plane at a time
    where there are F levels, a multi final or no final; the results
    differ only in the order of the adds.  On a GL-pinned pack the forward
    adds the per-tile bases, which the JAX kernel leaves out."""
    if not isinstance(device, GStreamDevice):
        raise TypeError(f"spmm_gstream needs a GStreamDevice, got "
                        f"{type(device).__name__}")
    vec = device.positions_multi(
        device.stream.forward_multi(device.prepare_x_multi(x_multi)))
    if device.final is not None:
        return device.final.apply_multi(vec)
    Y = torch.zeros(device.meta.nr_rows, vec.shape[1], dtype=vec.dtype,
                    device=vec.device)
    return Y.index_add_(0, device.chunk_row, vec[device.chunk_pos])
