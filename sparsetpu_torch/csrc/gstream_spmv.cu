// Classic GStream forward for Hopper (sm_90a): per-chunk partial sums of
// y = A @ x over a GStream pack (sparsetpu_torch/pack/gather_stream.py).
//
// Replaces three TPU kernels, each launched through pl.pallas_call:
//   sparsetpu/kernels/spmv_pallas.py:_spmv_kernel     (GL = 0, launched by
//       _gstream_chunk_sums): each step gathers over the G groups of its x
//       window (every classic device, every F level);
//   sparsetpu/kernels/spmv_pallas.py:_spmv_kernel_v2  (GL > 0, the same
//       launcher): each tile gathers over GL groups at its own base
//       tile_base[k] inside the window;
//   sparsetpu/kernels/f64emu.py:_df64_spmv_kernel     (f64, launched by
//       _df64_chunk_sums): the window scheme on the f64 device's pack, whose
//       TPU kernel carries values, x and sums as (hi, lo) float pairs with
//       TwoProd products and double-float add trees.
// One template covers all three: kTileBase, and the value type V (f32;
// bf16 in the bf16 value mode, widened to f32 before the multiply; or
// double, the f64 device's joined hi + lo plane).  x, the sums and the
// output are Real<V>: float, or double for double values, so the f64
// kernel multiplies and adds in native FP64 (entry point
// gstream_spmv_f64_launch; window scheme only, as the TPU's df64 kernel).
//
// Slot (s, l) of tile k, in step i = k / T, with the int16 meta stream
// meta = cell << 7 | route:
//   j    = meta[s, l] & 127                  route (lane of x)
//   c    = (meta[s, j] & 0x7FFF) >> 7        cell, read at the routed lane
//   row  = 8G * step_window[i] (+ 8 * tile_base[k]) + c
//   x    = (c >> 3) < G (GL) ? x2[row, j] : 0   (the select chain's where)
//   out[k * P + p, l] = sum over the Q = 8 / P sublanes of plane p of
//                       value[s, l] * x
// The wrapper checks on the host that every staged window lies inside x2
// (step_window, tile_base), so every address stays in its buffer.
//
// What bounds it on the card: the packed stream, read once: 4 B (f32),
// 2 B (bf16) or 8 B (f64) of value plus 2 B of meta per slot, and 4 B (8 B
// in f64) per output chunk sum written.  The second meta read hits the same
// 256-byte row the warp just loaded (L1), and the x gathers stay inside one
// window of at most 32768 columns (128 KB, 256 KB in f64), which L2 holds.
//
// Design, simple first: nothing carries from one step to the next (the
// TPU walks steps in order only to pipeline its DMA), so each thread owns
// one lane of one tile and walks its 8 sublanes: a warp reads 128
// contiguous bytes of values and 64 of meta per sublane, thousands of
// blocks fill the card at full size, and the output is written, not
// accumulated (no atomics).  Each chunk sums its Q terms in sublane order.

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

// the type of x, the sums and the output for values of type V
template <typename V> struct RealOf { using type = float; };
template <> struct RealOf<double> { using type = double; };
template <typename V> using Real = typename RealOf<V>::type;

template <typename V, bool kTileBase>
__global__ void __launch_bounds__(kThreads)
gstream_spmv_kernel(const V* __restrict__ values,
                    const int16_t* __restrict__ meta,
                    const int32_t* __restrict__ step_window,
                    const int32_t* __restrict__ tile_base,
                    const Real<V>* __restrict__ x2,
                    Real<V>* __restrict__ out,
                    long long n_tiles, int T, int G, int GL, int P) {
  const long long k =
      (long long)blockIdx.x * kTilesPerBlock + threadIdx.x / kLanes;
  if (k >= n_tiles) return;
  const int l = threadIdx.x % kLanes;
  const int groups = kTileBase ? GL : G;
  long long xbase = (long long)kChunk * G * step_window[k / T];
  if (kTileBase) xbase += (long long)kChunk * tile_base[k];
  const int Q = kChunk / P;
  Real<V> sum = 0;
#pragma unroll
  for (int s = 0; s < kChunk; ++s) {
    const long long row = (k * kChunk + s) * kLanes;
    const int j = meta[row + l] & 127;
    const int c = (meta[row + j] & 0x7FFF) >> 7;
    const Real<V> xv =
        (c >> 3) < groups ? x2[(xbase + c) * kLanes + j] : Real<V>(0);
    sum += widen(values[row + l]) * xv;
    if ((s + 1) % Q == 0) {
      out[(k * P + s / Q) * kLanes + l] = sum;
      sum = 0;
    }
  }
}

template <typename V, bool kTileBase>
int launch(const void* values, const void* meta, const void* step_window,
           const void* tile_base, const void* x2, void* out,
           long long n_tiles, int T, int G, int GL, int P,
           cudaStream_t stream) {
  const long long blocks = (n_tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  gstream_spmv_kernel<V, kTileBase><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(
      (const V*)values, (const int16_t*)meta, (const int32_t*)step_window,
      (const int32_t*)tile_base, (const Real<V>*)x2, (Real<V>*)out, n_tiles,
      T, G, GL, P);
  return (int)cudaGetLastError();
}

}  // namespace

// value_bf16: 0 for f32 values, 1 for bf16; GL = 0 takes the window kernel
// (tile_base unused), GL > 0 the per-tile-base kernel.
extern "C" int gstream_spmv_launch(const void* values, int value_bf16,
                                   const void* meta, const void* step_window,
                                   const void* tile_base, const void* x2,
                                   void* out, long long n_tiles, int T, int G,
                                   int GL, int P, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_bf16) {
    return GL ? launch<__nv_bfloat16, true>(values, meta, step_window,
                                            tile_base, x2, out, n_tiles, T,
                                            G, GL, P, s)
              : launch<__nv_bfloat16, false>(values, meta, step_window,
                                             tile_base, x2, out, n_tiles, T,
                                             G, GL, P, s);
  }
  return GL ? launch<float, true>(values, meta, step_window, tile_base, x2,
                                  out, n_tiles, T, G, GL, P, s)
            : launch<float, false>(values, meta, step_window, tile_base, x2,
                                   out, n_tiles, T, G, GL, P, s);
}

// f64: double values, x2 and out, window scheme (G groups, no tile base).
extern "C" int gstream_spmv_f64_launch(const void* values, const void* meta,
                                       const void* step_window,
                                       const void* x2, void* out,
                                       long long n_tiles, int T, int G, int P,
                                       void* stream) {
  if (n_tiles == 0) return 0;
  return launch<double, false>(values, meta, step_window, nullptr, x2, out,
                               n_tiles, T, G, 0, P, (cudaStream_t)stream);
}
