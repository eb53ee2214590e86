// The final level of the classic devices for Hopper (sm_90a), redesigned
// for the card: a row-sorted gather-sum.  The flat position vector vec (the
// chunk sums and the F levels' outputs) -> y, where
//
//   y[r] = sum of vec[idx[k]] for rowptr[r] <= k < rowptr[r + 1].
//
// rowptr and idx are built once at upload (kernels/final_rows.py:FinalRows)
// from the TPU final level's own tables: every live slot of every level of
// the final, then its spills, stably sorted by output row.  So one launch
// (two where some rows are long) does the work of the per-instance final
// of csrc/gstream_final.cu a level, its spill index_add_ and the sum of the
// levels' ys.
//
// Replaces three TPU kernels, each launched through pl.pallas_call:
//   sparsetpu/kernels/spmv_pallas.py:_final_kernel_v2  (flat, #4);
//   sparsetpu/kernels/spmv_pallas.py:_final_kernel     (legacy, #5);
//   sparsetpu/kernels/f64emu.py:_df64_final_kernel     (f64 legacy, #12),
// here in native FP64 (entry point final_rows_f64_launch).
//
// What bounds it on the card: the bytes of idx (4 B an entry), rowptr (4 B
// a row) and y (4 or 8 B a row), and one gather of vec an entry.  The TPU
// layout streamed 3 B of cells and routes for every slot of every instance,
// most of them drain; this form reads only live entries.  The gathers land
// where the forward wrote the row's chunks; each moves a 32 B sector.
//
// Design, simple first: a thread a row over every row (the short bin), and a
// warp a row over the list of rows longer than max_len (the long bin),
// where the warp's lanes sum every 32nd entry and add up by shuffles.  idx
// is read four entries a lane by one 16-byte load past the row's first
// multiple of 4; vec through the read-only path.  Each row is written once
// by its owner (0 for an empty row): no atomics, and the order of the adds
// is the same from run to run.  The short launch covers every row and
// leaves the rows past max_len to the long launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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
