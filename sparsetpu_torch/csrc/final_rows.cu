// The final level of the classic devices for Hopper (sm_90a), redesigned
// for the card: a row-sorted gather-sum.  The flat position vector vec (the
// chunk sums and the F levels' outputs) -> y, where
//
//   y[r] = sum of vec[idx[e]] for rowptr[r] <= e < rowptr[r + 1],
//
// and its k-plane form, vec row-major (n_positions, k) -> Y (nr_rows, k):
//
//   Y[r, :] = sum of vec[idx[e], :] over the same entries.
//
// rowptr and idx are built once at upload (kernels/final_rows.py:FinalRows)
// from the TPU final level's own tables: every live slot of every level of
// the final, then its spills, stably sorted by output row.  So one launch
// (two where some rows are long) does the work of the TPU layout's
// per-instance final a level, its spill index_add_ and the sum of the
// levels' ys.
//
// Replaces five TPU kernels, each launched through pl.pallas_call:
//   sparsetpu/kernels/spmv_pallas.py:_final_kernel_v2  (flat, #4);
//   sparsetpu/kernels/spmv_pallas.py:_final_kernel     (legacy, #5);
//   sparsetpu/kernels/f64emu.py:_df64_final_kernel     (f64 legacy, #12),
// here in native FP64 (entry point final_rows_f64_launch);
//   sparsetpu/kernels/spmm.py:_final_v2_multi_kernel   (flat, k planes, #8);
//   sparsetpu/kernels/spmm.py:_final_multi_kernel      (legacy, k planes,
// #9), both through final_rows_multi_launch, f32 and f64 (the JAX f64
// SpMM finishes a plane at a time through #12).
//
// What bounds it on the card: the bytes of idx (4 B an entry), rowptr (4 B
// a row) and y (4 or 8 B a row, times k), and one gather of vec an entry
// (times k).  The TPU layout streamed 3 B of cells and routes for every
// slot of every instance, most of them drain, ceil(k / 8) times for k
// planes; this form reads only live entries, once for any k.  The gathers
// land where the forward wrote the row's chunks; each moves a 32 B sector.
//
// Design, simple first.  One plane: a thread a row over every row (the
// short bin), and a warp a row over the list of rows longer than max_len
// (the long bin), where the warp's lanes sum every 32nd entry and add up
// by shuffles.  idx is read four entries a lane by one 16-byte load past
// the row's first multiple of 4; vec through the read-only path.  k
// planes: a group of k / W threads a row, each owning one W-wide plane
// vector (W = 4 floats or 2 doubles, 16 B; 2 or 1 where k or the buffers'
// alignment allow no more), so the k values of each gathered position are
// one coalesced read across the group and the row's store is contiguous;
// the group's threads read the same idx entries (one broadcast), four at a
// time.  Its long bin: a warp per (long row, plane vector), the lanes
// striding over the entries and adding up by shuffles.  Each row is
// written once by its owner (0 for an empty row): no atomics, and the
// order of the adds is the same from run to run.  The short launch covers
// every row and leaves the rows past max_len to the long launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;

// L lanes a row: 1 (the short bin) or 32 (the long bin).
template <int L, typename R>
__global__ void __launch_bounds__(kThreads)
final_rows_kernel(const int32_t* __restrict__ rowptr,
                  const int32_t* __restrict__ idx, const R* __restrict__ vec,
                  const int32_t* __restrict__ rows, long long n, int max_len,
                  R* __restrict__ y) {
  static_assert(L == 1 || L == 32, "a thread or a warp a row");
  const long long g = ((long long)blockIdx.x * kThreads + threadIdx.x) / L;
  if (g >= n) return;                       // the whole group leaves
  const int lane = threadIdx.x % L;
  const int r = rows ? __ldg(rows + g) : (int)g;
  const int b = __ldg(rowptr + r);
  const int e = __ldg(rowptr + r + 1);
  if (e - b > max_len) return;              // the long launch's row
  R s = 0;
  const int a = min(e, (b + 3) & ~3);       // the first multiple of 4
  for (int k = b + lane; k < a; k += L) s += __ldg(vec + __ldg(idx + k));
  const int nq = (e - a) >> 2;
  const int4* idx4 = reinterpret_cast<const int4*>(idx + a);
  for (int q = lane; q < nq; q += L) {
    const int4 p = __ldg(idx4 + q);
    s += __ldg(vec + p.x) + __ldg(vec + p.y) + __ldg(vec + p.z) +
         __ldg(vec + p.w);
  }
  for (int k = a + 4 * nq + lane; k < e; k += L)
    s += __ldg(vec + __ldg(idx + k));
  if (L == 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if (lane == 0) y[r] = s;
}

// k planes, a group of nv = k / W threads a row (the short bin), W values
// of the row's k a thread.
template <typename R, int W>
__global__ void __launch_bounds__(kThreads)
final_rows_multi_short(const int32_t* __restrict__ rowptr,
                       const int32_t* __restrict__ idx,
                       const R* __restrict__ vec, long long n, int max_len,
                       int k, R* __restrict__ y) {
  const int nv = k / W;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = t / nv;
  if (r >= n) return;
  const int cv = (int)(t - r * nv);
  const int b = __ldg(rowptr + r);
  const int e = __ldg(rowptr + r + 1);
  if (e - b > max_len) return;              // the long launch's row
  const R* v = vec + cv * W;
  Vec<R, W> acc;
#pragma unroll
  for (int w = 0; w < W; ++w) acc.v[w] = 0;
  int q = b;
  for (; q + 4 <= e; q += 4) {
    Vec<R, W> x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = load_vec<R, W>(v + (long long)__ldg(idx + q + u) * k);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < W; ++w) acc.v[w] += x[u].v[w];
  }
  for (; q < e; ++q) {
    const Vec<R, W> x = load_vec<R, W>(v + (long long)__ldg(idx + q) * k);
#pragma unroll
    for (int w = 0; w < W; ++w) acc.v[w] += x.v[w];
  }
  store_vec<R, W>(y + r * k + cv * W, acc);
}

// k planes, a warp per (row of rows[0..n), plane vector) (the long bin).
template <typename R, int W>
__global__ void __launch_bounds__(kThreads)
final_rows_multi_long(const int32_t* __restrict__ rowptr,
                      const int32_t* __restrict__ idx,
                      const R* __restrict__ vec,
                      const int32_t* __restrict__ rows, long long n, int k,
                      R* __restrict__ y) {
  const int nv = k / W;
  const long long g = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  if (g >= n * nv) return;                  // the whole warp leaves
  const int lane = threadIdx.x % 32;
  const int r = __ldg(rows + g / nv);
  const int cv = (int)(g % nv);
  const int b = __ldg(rowptr + r);
  const int e = __ldg(rowptr + r + 1);
  const R* v = vec + cv * W;
  Vec<R, W> acc;
#pragma unroll
  for (int w = 0; w < W; ++w) acc.v[w] = 0;
  for (int q = b + lane; q < e; q += 32) {
    const Vec<R, W> x = load_vec<R, W>(v + (long long)__ldg(idx + q) * k);
#pragma unroll
    for (int w = 0; w < W; ++w) acc.v[w] += x.v[w];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int w = 0; w < W; ++w)
      acc.v[w] += __shfl_down_sync(0xffffffffu, acc.v[w], off);
  if (lane == 0) store_vec<R, W>(y + (long long)r * k + cv * W, acc);
}

template <typename R, int W>
int launch_multi_w(const void* rowptr, const void* idx, const void* vec,
                   const void* rows, long long n, int max_len, int k,
                   void* y, cudaStream_t s) {
  const long long groups = n * (k / W);
  if (rows) {
    const long long blocks = (groups * 32 + kThreads - 1) / kThreads;
    final_rows_multi_long<R, W><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)rowptr, (const int32_t*)idx, (const R*)vec,
        (const int32_t*)rows, n, k, (R*)y);
  } else {
    const long long blocks = (groups + kThreads - 1) / kThreads;
    final_rows_multi_short<R, W><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)rowptr, (const int32_t*)idx, (const R*)vec, n,
        max_len < 0 ? INT_MAX : max_len, k, (R*)y);
  }
  return (int)cudaGetLastError();
}

template <typename R>
int launch_multi(const void* rowptr, const void* idx, const void* vec,
                 const void* rows, long long n, int max_len, int k, int vw,
                 void* y, void* stream) {
  if (k < 1 || k % vw || vw * sizeof(R) > 16 ||
      (vw != 1 && vw != 2 && vw != 4))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  // vw 4 is floats only (rejected above for double, whose branch names W 2
  // so that no Vec<double, 4> is built)
  if (vw == 4)
    return launch_multi_w<R, sizeof(R) == 4 ? 4 : 2>(rowptr, idx, vec, rows,
                                                     n, max_len, k, y, s);
  if (vw == 2)
    return launch_multi_w<R, 2>(rowptr, idx, vec, rows, n, max_len, k, y, s);
  return launch_multi_w<R, 1>(rowptr, idx, vec, rows, n, max_len, k, y, s);
}

template <int L, typename R>
int launch_lanes(const void* rowptr, const void* idx, const void* vec,
                 const void* rows, long long n, int max_len, void* y,
                 cudaStream_t s) {
  const long long blocks = (n * L + kThreads - 1) / kThreads;
  final_rows_kernel<L, R><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int32_t*)rowptr, (const int32_t*)idx, (const R*)vec,
      (const int32_t*)rows, n, max_len, (R*)y);
  return (int)cudaGetLastError();
}

template <typename R>
int launch(const void* rowptr, const void* idx, const void* vec,
           const void* rows, long long n, int max_len, void* y,
           void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows)
    return launch_lanes<32, R>(rowptr, idx, vec, rows, n, INT_MAX, y, s);
  return launch_lanes<1, R>(rowptr, idx, vec, rows, n,
                            max_len < 0 ? INT_MAX : max_len, y, s);
}

}  // namespace

// One launch: with rows null, a thread a row over rows 0..n-1, leaving the
// rows of more than max_len entries alone (max_len < 0: none); with rows
// given, a warp a row over rows[0..n).  rowptr, idx and rows int32; idx
// 16-B aligned.
extern "C" int final_rows_launch(const void* rowptr, const void* idx,
                                 const void* vec, const void* rows,
                                 long long n, int max_len, void* y,
                                 void* stream) {
  return launch<float>(rowptr, idx, vec, rows, n, max_len, y, stream);
}

// f64: double vec and y (the f64 device's final), the same tables.
extern "C" int final_rows_f64_launch(const void* rowptr, const void* idx,
                                     const void* vec, const void* rows,
                                     long long n, int max_len, void* y,
                                     void* stream) {
  return launch<double>(rowptr, idx, vec, rows, n, max_len, y, stream);
}

// k planes: vec (n_positions, k) and Y (nr_rows, k) row-major, float
// (f64 = 0) or double; rows null and rows given as final_rows_launch's; vw
// the plane vector's width (1, 2 or 4 values, at most 16 B) dividing k,
// vec and y aligned to it.
extern "C" int final_rows_multi_launch(int f64, const void* rowptr,
                                       const void* idx, const void* vec,
                                       const void* rows, long long n,
                                       int max_len, int k, int vw, void* y,
                                       void* stream) {
  return f64 ? launch_multi<double>(rowptr, idx, vec, rows, n, max_len, k,
                                    vw, y, stream)
             : launch_multi<float>(rowptr, idx, vec, rows, n, max_len, k, vw,
                                   y, stream);
}
