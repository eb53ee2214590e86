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
// Slot (s, l) of tile q, in step i = q / T, decodes exactly as the SpMV
// forward (gstream_spmv.cu) decodes it:
//   j    = meta[s, l] & 127,  c = (meta[s, j] & 0x7FFF) >> 7
//   row  = (8G * step_window[i] (+ 8 * tile_base[q]) + c) * 128 + j
//   x    = (c >> 3) < G (GL) ? X[row, :] : 0
// and every plane sums the Q = 8 / P sublanes of each chunk:
//   out[(q * P + p) * 128 + l, :] = sum_s value[s, l] * x.
// The TPU kernel stages only step_window and never adds a per-tile base,
// so on a GL-pinned pack its result is wrong; this kernel adds tile_base
// when GL > 0, as the SpMV per-tile-base forward does.  Values are f32, or
// bf16 widened to f32; X and every sum stay f32 (the TPU kernel casts X to
// the value type).
//
// Layout: X row-major (padded_cols, k), so a slot's k values are one
// contiguous row; out row-major (n_tiles * P * 128, k), the position
// vector of the final's k planes.
//
// What bounds it on the card: the packed stream (4, 2 or 8 B of value, 2 B
// of meta a slot) read once for all k planes, X read once and the output
// (4k B, 8k B in f64, a chunk sum) written once; that is the HBM bound.
// But every slot that reads x gathers its whole row of X, k * 4 B, and X
// at full size fits the 50 MB L2: so the L2 must deliver slots * k * 4 B,
// far more than HBM at k = 72, and that gather traffic is the floor
// (chip_smoke.py's "L2 gather bound").
//
// Design.  A thread a lane looping over the k planes (this kernel's first
// form) gathered one float of 8 different X rows a plane: a warp load
// touched 32 sectors for 128 useful bytes, and its stores were strided by
// k.  Here a block takes one tile in two phases:
//   1. decode: the tile's 1024 int16 meta words go to shared memory in
//      16-byte loads; each slot's value (widened) and X row, -1 for the
//      select chain's 0, go to shared memory (8 KB in f32, 12 KB in f64);
//   2. sweep: the block's threads take (position, plane vector) pairs,
//      consecutive threads the consecutive W-wide vectors of one position
//      (W = 4 floats or 2 doubles, 16 B; 2 or 1 where k or the buffers'
//      alignment allow no more, so no caller pads X).  A thread sums its
//      position's Q slots into W registers (every gather of a slot's row
//      is then one coalesced read of k values across the threads of the
//      position), and writes them to out[pos, W*c : W*c + W]: a warp's
//      stores are contiguous.
// The sums add the Q sublanes in order, as the plain version's; each
// output is written once, no atomics.  Rows are 32-bit (the wrapper checks
// X has fewer than 2^31 rows), offsets into X and out 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 8;
constexpr int kSlots = kChunk * kLanes;      // 1024 slots a tile
constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double widen(double v) { return v; }

// the type of X, the sums and the output for values of type V
template <typename V> struct RealOf { using type = float; };
template <> struct RealOf<double> { using type = double; };
template <typename V> using Real = typename RealOf<V>::type;

template <typename V, int W, bool kTileBase>
__global__ void __launch_bounds__(kThreads)
gstream_spmm_kernel(const V* __restrict__ values,
                    const int16_t* __restrict__ meta,
                    const int32_t* __restrict__ step_window,
                    const int32_t* __restrict__ tile_base,
                    const Real<V>* __restrict__ X,
                    Real<V>* __restrict__ out,
                    int T, int G, int GL, int P, int k) {
  using R = Real<V>;
  __shared__ __align__(16) int16_t smeta[kSlots];
  __shared__ R sval[kSlots];
  __shared__ int32_t srow[kSlots];           // -1: the select chain's 0
  const long long q = blockIdx.x;            // one tile a block
  const int nt = blockDim.x;
  const long long base = q * kSlots;

  // 1. decode the tile
  const int4* meta4 = reinterpret_cast<const int4*>(meta + base);
  for (int i = threadIdx.x; i < kSlots / 8; i += nt)
    reinterpret_cast<int4*>(smeta)[i] = meta4[i];
  __syncthreads();
  long long xbase = (long long)kChunk * G * step_window[q / T];
  if (kTileBase) xbase += (long long)kChunk * tile_base[q];
  const int groups = kTileBase ? GL : G;
  for (int i = threadIdx.x; i < kSlots; i += nt) {
    const int s = i / kLanes;
    const int j = smeta[i] & 127;
    const int c = (smeta[s * kLanes + j] & 0x7FFF) >> 7;
    sval[i] = widen(values[base + i]);
    srow[i] = (c >> 3) < groups ? (int)((xbase + c) * kLanes + j) : -1;
  }
  __syncthreads();

  // 2. sweep (position, plane vector) pairs
  const int nv = k / W;
  const int Q = kChunk / P;
  const int items = P * kLanes * nv;
  for (int t = threadIdx.x; t < items; t += nt) {
    const int pos = t / nv;                  // p * 128 + l
    const int cv = t - pos * nv;
    const int p = pos / kLanes, l = pos % kLanes;
    Vec<R, W> acc;
#pragma unroll
    for (int w = 0; w < W; ++w) acc.v[w] = 0;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < Q) {
        const int slot = (p * Q + i) * kLanes + l;
        const int r = srow[slot];
        const R v = sval[slot];
        Vec<R, W> x;
        if (r >= 0) {
          x = load_vec<R, W>(X + (long long)r * k + cv * W);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) x.v[w] = 0;
        }
#pragma unroll
        for (int w = 0; w < W; ++w) acc.v[w] += v * x.v[w];
      }
    }
    store_vec<R, W>(out + ((q * P + p) * kLanes + l) * (long long)k + cv * W,
                    acc);
  }
}

template <typename V, int W, bool kTileBase>
int launch_w(const void* values, const void* meta, const void* step_window,
             const void* tile_base, const void* X, void* out,
             long long n_tiles, int T, int G, int GL, int P, int k,
             cudaStream_t stream) {
  // a thread a (position, vector) pair where a tile has fewer than 256
  const int threads = P * kLanes * (k / W) <= kLanes ? kLanes : kThreads;
  gstream_spmm_kernel<V, W, kTileBase><<<(unsigned)n_tiles, threads, 0,
                                         stream>>>(
      (const V*)values, (const int16_t*)meta, (const int32_t*)step_window,
      (const int32_t*)tile_base, (const Real<V>*)X, (Real<V>*)out, T, G, GL,
      P, k);
  return (int)cudaGetLastError();
}

template <typename V, bool kTileBase>
int launch(const void* values, const void* meta, const void* step_window,
           const void* tile_base, const void* X, void* out,
           long long n_tiles, int T, int G, int GL, int P, int k, int vw,
           cudaStream_t s) {
  if (k < 1 || k % vw || vw * sizeof(Real<V>) > 16 ||
      (vw != 1 && vw != 2 && vw != 4))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  // vw 4 is floats only (rejected above for double, whose branch names W 2
  // so that no Vec<double, 4> is built)
  if (vw == 4)
    return launch_w<V, sizeof(Real<V>) == 4 ? 4 : 2, kTileBase>(
        values, meta, step_window, tile_base, X, out, n_tiles, T, G, GL, P, k,
        s);
  if (vw == 2)
    return launch_w<V, 2, kTileBase>(values, meta, step_window, tile_base, X,
                                     out, n_tiles, T, G, GL, P, k, s);
  return launch_w<V, 1, kTileBase>(values, meta, step_window, tile_base, X,
                                   out, n_tiles, T, G, GL, P, k, s);
}

}  // namespace

// value_bf16: 0 for f32 values, 1 for bf16; GL = 0 takes the window scheme
// (tile_base unused), GL > 0 the per-tile-base scheme.  vw: the plane
// vector's width, 1, 2 or 4 floats, dividing k, X and out aligned to it.
extern "C" int gstream_spmm_launch(const void* values, int value_bf16,
                                   const void* meta, const void* step_window,
                                   const void* tile_base, const void* X,
                                   void* out, long long n_tiles, int T, int G,
                                   int GL, int P, int k, int vw,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (value_bf16) {
    return GL ? launch<__nv_bfloat16, true>(values, meta, step_window,
                                            tile_base, X, out, n_tiles, T,
                                            G, GL, P, k, vw, s)
              : launch<__nv_bfloat16, false>(values, meta, step_window,
                                             tile_base, X, out, n_tiles, T,
                                             G, GL, P, k, vw, s);
  }
  return GL ? launch<float, true>(values, meta, step_window, tile_base, X,
                                  out, n_tiles, T, G, GL, P, k, vw, s)
            : launch<float, false>(values, meta, step_window, tile_base, X,
                                   out, n_tiles, T, G, GL, P, k, vw, s);
}

// f64: double values, X and out, window scheme (G groups, no tile base);
// vw 1 or 2 doubles.
extern "C" int gstream_spmm_f64_launch(const void* values, const void* meta,
                                       const void* step_window,
                                       const void* X, void* out,
                                       long long n_tiles, int T, int G, int P,
                                       int k, int vw, void* stream) {
  return launch<double, false>(values, meta, step_window, nullptr, X, out,
                               n_tiles, T, G, 0, P, k, vw,
                               (cudaStream_t)stream);
}
