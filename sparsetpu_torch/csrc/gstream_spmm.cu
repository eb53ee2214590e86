// Classic GStream forward with k planes for Hopper (sm_90a): per-chunk
// partial sums of Y = A @ X over a GStream pack, for X with k columns.
//
// Replaces two TPU kernels, each launched through pl.pallas_call:
//   sparsetpu/kernels/spmm.py:_spmm_kernel        (f32, launched by
//       _gstream_chunk_sums_multi);
//   sparsetpu/kernels/f64emu.py:_df64_spmm_kernel (f64, launched by
//       _df64_chunk_sums_multi): the same on the f64 device's pack, whose
//       TPU kernel carries X and the sums as (hi, lo) float pairs.  Here
//       the value type V = double makes X, the sums and the output double
//       and every product and add native FP64 (entry point
//       gstream_spmm_f64_launch; window scheme only, as the TPU's).
// It is the window forward of csrc/gstream_spmv.cu with a plane loop.  Slot (s, l) of tile q, in
// step i = q / T, decodes once, exactly as the SpMV forward does:
//   j    = meta[s, l] & 127,  c = (meta[s, j] & 0x7FFF) >> 7
//   col  = (8G * step_window[i] (+ 8 * tile_base[q]) + c) * 128 + j
//   x    = (c >> 3) < G (GL) ? X[col, kk] : 0
// and every plane kk sums the Q = 8 / P sublanes of each chunk:
//   out[(q * P + p) * 128 + l, kk] = sum_s value[s, l] * x.
// The TPU kernel stages only step_window and never adds a per-tile base,
// so on a GL-pinned pack its result is wrong; this kernel adds tile_base
// when GL > 0, as the SpMV per-tile-base forward does.  Values are f32, or
// bf16 widened to f32; X and every sum stay f32 (the TPU kernel casts X to
// the value type).
//
// Layout: X row-major (padded_cols, k), so a slot's k values are
// contiguous (one 32-byte sector at k = 8); out row-major
// (n_tiles * P * 128, k), the position vector of the final's k planes.
//
// What bounds it on the card: the packed stream (4, 2 or 8 B of value, 2 B
// of meta a slot), read once for all k planes, plus X's window gathers (L2)
// and 4k B (8k B in f64) per chunk sum written.  Design: one thread a lane of one tile,
// as gstream_spmv.cu; the 8 decoded (value, column) pairs stay in
// registers while the thread loops over the k planes, so the meta is read
// once however large k is.  Offsets are 64-bit; the wrapper checks X's
// shape and the upload checks bound every window and tile base inside X.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 8;
constexpr int kThreads = 256;
constexpr int kTilesPerBlock = kThreads / kLanes;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double widen(double v) { return v; }

// the type of X, the sums and the output for values of type V
template <typename V> struct RealOf { using type = float; };
template <> struct RealOf<double> { using type = double; };
template <typename V> using Real = typename RealOf<V>::type;

template <typename V, bool kTileBase>
__global__ void __launch_bounds__(kThreads)
gstream_spmm_kernel(const V* __restrict__ values,
                    const int16_t* __restrict__ meta,
                    const int32_t* __restrict__ step_window,
                    const int32_t* __restrict__ tile_base,
                    const Real<V>* __restrict__ X,
                    Real<V>* __restrict__ out,
                    long long n_tiles, int T, int G, int GL, int P, int k) {
  const long long q =
      (long long)blockIdx.x * kTilesPerBlock + threadIdx.x / kLanes;
  if (q >= n_tiles) return;
  const int l = threadIdx.x % kLanes;
  const int groups = kTileBase ? GL : G;
  long long xbase = (long long)kChunk * G * step_window[q / T];
  if (kTileBase) xbase += (long long)kChunk * tile_base[q];
  const int Q = kChunk / P;
  Real<V> v[kChunk];
  long long xa[kChunk];                       // -1: the select chain's 0
#pragma unroll
  for (int s = 0; s < kChunk; ++s) {
    const long long row = (q * kChunk + s) * kLanes;
    const int j = meta[row + l] & 127;
    const int c = (meta[row + j] & 0x7FFF) >> 7;
    v[s] = widen(values[row + l]);
    xa[s] = (c >> 3) < groups ? ((xbase + c) * kLanes + j) * k : -1;
  }
  for (int kk = 0; kk < k; ++kk) {
    Real<V> sum = 0;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const Real<V> xv = xa[s] >= 0 ? X[xa[s] + kk] : Real<V>(0);
      sum += v[s] * xv;
      if ((s + 1) % Q == 0) {
        out[((q * P + s / Q) * kLanes + l) * k + kk] = sum;
        sum = 0;
      }
    }
  }
}

template <typename V, bool kTileBase>
int launch(const void* values, const void* meta, const void* step_window,
           const void* tile_base, const void* X, void* out,
           long long n_tiles, int T, int G, int GL, int P, int k,
           cudaStream_t stream) {
  const long long blocks = (n_tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  gstream_spmm_kernel<V, kTileBase><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(
      (const V*)values, (const int16_t*)meta, (const int32_t*)step_window,
      (const int32_t*)tile_base, (const Real<V>*)X, (Real<V>*)out, n_tiles,
      T, G, GL, P, k);
  return (int)cudaGetLastError();
}

}  // namespace

// value_bf16: 0 for f32 values, 1 for bf16; GL = 0 takes the window scheme
// (tile_base unused), GL > 0 the per-tile-base scheme.
extern "C" int gstream_spmm_launch(const void* values, int value_bf16,
                                   const void* meta, const void* step_window,
                                   const void* tile_base, const void* X,
                                   void* out, long long n_tiles, int T, int G,
                                   int GL, int P, int k, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_bf16) {
    return GL ? launch<__nv_bfloat16, true>(values, meta, step_window,
                                            tile_base, X, out, n_tiles, T,
                                            G, GL, P, k, s)
              : launch<__nv_bfloat16, false>(values, meta, step_window,
                                             tile_base, X, out, n_tiles, T,
                                             G, GL, P, k, s);
  }
  return GL ? launch<float, true>(values, meta, step_window, tile_base, X,
                                  out, n_tiles, T, G, GL, P, k, s)
            : launch<float, false>(values, meta, step_window, tile_base, X,
                                   out, n_tiles, T, G, GL, P, k, s);
}

// f64: double values, X and out, window scheme (G groups, no tile base).
extern "C" int gstream_spmm_f64_launch(const void* values, const void* meta,
                                       const void* step_window,
                                       const void* X, void* out,
                                       long long n_tiles, int T, int G, int P,
                                       int k, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  return launch<double, false>(values, meta, step_window, nullptr, X, out,
                               n_tiles, T, G, 0, P, k, (cudaStream_t)stream);
}
