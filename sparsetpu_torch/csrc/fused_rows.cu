// Fused f32 SpMV over a row-ordered map of a fused pack's live slots, for
// Hopper (sm_90a):
//
//   y[r] = sum of val[e] * x[col[e]]   for rowptr[r] <= e < rowptr[r + 1]
//
// over FusedRows (kernels/fused_rows.py), built once at upload from a
// FusedDevice's own buffers: every live slot (a nonzero value) of the pack
// with the x index the forward reads and the y row its chunk sum reaches
// through the finish stages and the slab blocks, then the spills, sorted by
// row (a row's entries in the pack's slot order).  The pack is not changed.
//
// Replaces no TPU kernel.  It is a second design of #1's function
// (sparsetpu/kernels/spmv_fused.py:_fused_kernel, here fused_spmv.cu) for
// this card.  The fused pack pads its slots into dense (8, 128) tiles,
// which the TPU needs and the H100 does not: at GAP urand scale 20 (fill
// 0.333, Q = 1) #1 reads a value and two metadata bytes for each of about
// 100M slots, gathers x once a slot, padding included, and writes and reads
// back a chunk sum a slot, for 33.5M nonzeros.  FusedDevice runs this
// kernel instead wherever the map, with the 32-byte L2 sector each of its
// gathers moves, comes to fewer bytes a call than the pack
// (FusedDevice.traffic): #1's gathers read each tile's window of x through
// L1, this kernel's read x where the matrix puts them.  #1 keeps the
// blocks, the SpMM's pack and the f64 form.
//
// What bounds it on the card: 8 B a live slot (its column, int32, and its
// value, f32) and 8 B a row (rowptr and y), each read or written once, and
// one gather of x a live slot from the L2 (x is at most 1.5M columns, 6 MB,
// against the 50 MB L2): at urand20 about 281 MB and 33.5M gathers.  The
// gathers set the pace there: on an H100 a call takes 0.29-0.30 ms, and
// 0.10 ms with its gathers kept inside 1024 columns (in L1), so the 33.5M
// scattered 32-byte L2 sectors cost about 0.19 ms; no load form (.cg,
// L1::no_allocate, no hint) and no deeper pipelining moved it.
//
// Design.  W lanes a row (a power of two, 4-32, chosen at upload so that
// one quad of 4 entries a lane covers a mean row); a block of 256 threads
// takes 256 / W consecutive rows, so a warp's loads cover one contiguous
// span of the streams.  A row's lanes read the aligned quads that hold its
// entries, col and val by one 16-byte load each, two quads a lane in
// flight a loop, and mask the entries of the neighbouring rows that share
// the first and last quad (the map pads col and val to a multiple of 4, so
// every quad lies inside its buffer).  The streams are read once:
// L1::no_allocate and an L2 evict-first policy, so they do not push x out
// of the L2; x is gathered through the read-only path with an L2
// evict-last policy (createpolicy, a hint on each load: no stream state
// that other kernels would inherit).  The W lanes add up by shuffles and
// the first writes y[r]: every row, empty ones included, is written once by
// its owner, so there is no workspace, no atomic and no memset, and the
// order of the adds is the same from run to run (within a row it differs
// from the plain version's, which adds in entry order).  Rows of more than
// max_len entries (8 quads a lane) would hold their warp back: the map
// lists them (long_rows), the row blocks skip them, and the blocks past the
// row blocks take one a warp, the 32 lanes striding over its quads.  One
// launch a call.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// four entries of a stream, read once
__device__ __forceinline__ int4 load_stream(const int4* p, uint64_t pol) {
  int4 v;
  asm(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 "
      "{%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float4 load_stream(const float4* p, uint64_t pol) {
  float4 v;
  asm(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 "
      "{%0, %1, %2, %3}, [%4], %5;\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

// an element of x, kept in the L2
__device__ __forceinline__ float load_x(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\n"
               : "=f"(v)
               : "l"(p), "l"(pol));
  return v;
}

// x at the entries of quad q (entries 4q..4q+3) that lie in [b, e), else 0
__device__ __forceinline__ float4 gather(const float* __restrict__ x,
                                         int4 c, int q, int b, int e,
                                         uint64_t keep) {
  const int k = 4 * q;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k >= b && k < e) g.x = load_x(x + c.x, keep);
  if (k + 1 >= b && k + 1 < e) g.y = load_x(x + c.y, keep);
  if (k + 2 >= b && k + 2 < e) g.z = load_x(x + c.z, keep);
  if (k + 3 >= b && k + 3 < e) g.w = load_x(x + c.w, keep);
  return g;
}

// the sum of the entries of quad q that lie in [b, e)
__device__ __forceinline__ float dot(float4 v, float4 g, int q, int b,
                                     int e) {
  const int k = 4 * q;
  float s = 0.f;
  if (k >= b && k < e) s += v.x * g.x;
  if (k + 1 >= b && k + 1 < e) s += v.y * g.y;
  if (k + 2 >= b && k + 2 < e) s += v.z * g.z;
  if (k + 3 >= b && k + 3 < e) s += v.w * g.w;
  return s;
}

// lane `lane` of L's part of row [b, e): quads lane, lane + L, ... of the
// row's aligned quads, two a loop (both loads issued before the gathers)
template <int L>
__device__ __forceinline__ float row_part(const int4* __restrict__ col4,
                                          const float4* __restrict__ val4,
                                          const float* __restrict__ x, int b,
                                          int e, int lane, uint64_t stream,
                                          uint64_t keep) {
  float s = 0.f;
  const int qe = e > b ? (e + 3) >> 2 : 0;
  for (int q = (b >> 2) + lane; q < qe; q += 2 * L) {
    const int q1 = q + L;
    const int4 c0 = load_stream(col4 + q, stream);
    const float4 v0 = load_stream(val4 + q, stream);
    int4 c1 = make_int4(0, 0, 0, 0);
    float4 v1 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q1 < qe) {
      c1 = load_stream(col4 + q1, stream);
      v1 = load_stream(val4 + q1, stream);
    }
    const float4 g0 = gather(x, c0, q, b, e, keep);
    const float4 g1 = gather(x, c1, q1, b, q1 < qe ? e : 0, keep);
    s += dot(v0, g0, q, b, e);
    s += dot(v1, g1, q1, b, q1 < qe ? e : 0);
  }
  return s;
}

// W lanes a row over the row blocks [0, row_blocks); past them a warp a
// long row
template <int W>
__global__ void __launch_bounds__(kThreads)
fused_rows_kernel(const int32_t* __restrict__ rowptr,
                  const int4* __restrict__ col4,
                  const float4* __restrict__ val4,
                  const float* __restrict__ x,
                  const int32_t* __restrict__ long_rows, int n_rows,
                  int n_long, int row_blocks, int max_len,
                  float* __restrict__ y) {
  static_assert(W >= 4 && W <= 32 && (W & (W - 1)) == 0, "W lanes a row");
  const uint64_t stream = l2_evict_first();
  const uint64_t keep = l2_evict_last();
  if ((int)blockIdx.x < row_blocks) {
    const long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) / W;
    if (r >= n_rows) return;                  // the whole row's lanes leave
    const int b = __ldg(rowptr + r);
    const int e = __ldg(rowptr + r + 1);
    if (e - b > max_len) return;              // a long row: its own warp
    const int lane = threadIdx.x % W;
    float s = row_part<W>(col4, val4, x, b, e, lane, stream, keep);
    const unsigned mask =
        W == 32 ? 0xffffffffu
                : ((1u << W) - 1) << ((threadIdx.x & 31) & ~(W - 1));
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(mask, s, off);
    if (lane == 0) y[r] = s;
    return;
  }
  const long long w =
      ((long long)(blockIdx.x - row_blocks) * kThreads + threadIdx.x) / 32;
  if (w >= n_long) return;                    // the whole warp leaves
  const int r = __ldg(long_rows + w);
  const int lane = threadIdx.x % 32;
  float s = row_part<32>(col4, val4, x, __ldg(rowptr + r),
                         __ldg(rowptr + r + 1), lane, stream, keep);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) y[r] = s;
}

template <int W>
cudaError_t launch(const int32_t* rowptr, const void* col, const void* val,
                   const float* x, const int32_t* long_rows, int n_rows,
                   int n_long, int max_len, float* y, cudaStream_t stream) {
  const long long row_blocks =
      ((long long)n_rows * W + kThreads - 1) / kThreads;
  const long long long_blocks =
      ((long long)n_long * 32 + kThreads - 1) / kThreads;
  if (row_blocks + long_blocks > INT_MAX) return cudaErrorInvalidValue;
  const int grid = (int)(row_blocks + long_blocks);
  if (grid == 0) return cudaSuccess;
  fused_rows_kernel<W><<<grid, kThreads, 0, stream>>>(
      rowptr, static_cast<const int4*>(col), static_cast<const float4*>(val),
      x, long_rows, n_rows, n_long, (int)row_blocks, max_len, y);
  return cudaGetLastError();
}

}  // namespace

// One call: y (n_rows floats) = the map (rowptr, col, val; col and val
// 16-byte aligned and padded to a multiple of 4 entries) times x, with
// `width` lanes a row and the n_long rows of long_rows (more than max_len
// entries) a warp each, on `stream`.
extern "C" int fused_rows_launch(const void* rowptr, const void* col,
                                 const void* val, const void* x,
                                 const void* long_rows, int n_rows,
                                 int n_long, int width, int max_len, void* y,
                                 void* stream) {
  if (n_rows < 0 || n_long < 0 || n_long > n_rows ||
      (reinterpret_cast<uintptr_t>(col) | reinterpret_cast<uintptr_t>(val)) %
          16)
    return (int)cudaErrorInvalidValue;
  const auto* rp = static_cast<const int32_t*>(rowptr);
  const auto* xs = static_cast<const float*>(x);
  const auto* lr = static_cast<const int32_t*>(long_rows);
  auto* out = static_cast<float*>(y);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (width) {
    case 4:
      return (int)launch<4>(rp, col, val, xs, lr, n_rows, n_long, max_len,
                            out, st);
    case 8:
      return (int)launch<8>(rp, col, val, xs, lr, n_rows, n_long, max_len,
                            out, st);
    case 16:
      return (int)launch<16>(rp, col, val, xs, lr, n_rows, n_long, max_len,
                             out, st);
    case 32:
      return (int)launch<32>(rp, col, val, xs, lr, n_rows, n_long, max_len,
                             out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
