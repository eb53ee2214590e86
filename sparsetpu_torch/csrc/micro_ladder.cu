// Stage ladder of the forward kernel for Hopper (sm_90a): one kernel
// template whose compile-time stage adds one mechanism of the GStream
// forward (csrc/gstream_spmv.cu) at a time, so that each stage's time
// against the last says what that mechanism costs on this card.
//
// Replaces the TPU ladder sparsetpu/bench/micro.py:bench_ladder (its
// kernels built by _mk and pl.pallas_call at micro.py:90, :118, :194).  It
// keeps the ladder's questions and drops the TPU mechanisms (sublane select
// chains, scalar prefetch).  Over n_tiles (8, 128) f32 tiles of values v,
// int16 lane routes idx and int16 cells, with j = idx[8t+s, l] & 127 and
// c = cell[8t+s, j] (the cell read at the routed lane, as
// take_along_axis reads it), out[t, l] is:
//   kStream      xw[0, 0] * sum_s v[8t+s, l]                 (the HBM floor)
//   kLane        xw[0, 0] * sum_s v[8t+s, j]             (+ the lane gather)
//   kDual        sum_s v[8t+s, l] * xw[c, j], c < 8     (+ the x gather, G=1)
//   kTileBase    sum_s v[8t+s, l] * xw[8 base[t] + (c & 7), j]
//                                                     (+ a per-tile x base)
//   kWindow      sum_s v[8t+s, l] * xw[c, j], c < 8G: a window of G groups
//                read from global memory (L1/L2), as gstream_spmv.cu reads x
//   kWindowSmem  the same, after the block has staged the window (G * 4 KB)
//                in shared memory
// A cell past its window (c >> 3 >= G, G = 1 for kDual) or a base past xw
// reads 0, as the forward's select chain leaves it, so every address stays
// in its buffer.
//
// What bounds it: the streams, read once: 4 B of value a slot (kStream),
// + 2 B of route (kLane), + 2 B of cell (the gathers), and 4 B an output
// element.  The x window (at most 128 KB) stays in L2.
//
// Design, simple first: a block of 256 threads walks T tiles, two at a
// time, a thread a lane (the forward's layout); kWindowSmem stages the
// window once a block, so T sets how many tiles share one staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 8;
constexpr int kThreads = 256;
constexpr int kTilesPerPass = kThreads / kLanes;

enum Stage {
  kStream = 0,
  kLane = 1,
  kDual = 2,
  kTileBase = 3,
  kWindow = 4,
  kWindowSmem = 5
};

template <int kStage>
__global__ void __launch_bounds__(kThreads)
ladder_kernel(const float* __restrict__ v, const int16_t* __restrict__ idx,
              const int16_t* __restrict__ cell,
              const int32_t* __restrict__ base,
              const float* __restrict__ xw, float* __restrict__ out,
              long long n_tiles, int T, int G, int xw_rows) {
  extern __shared__ float sx[];
  const int groups = kStage == kDual ? 1 : G;
  if constexpr (kStage == kWindowSmem) {
    for (int i = threadIdx.x; i < groups * kChunk * kLanes; i += kThreads)
      sx[i] = xw[i];
    __syncthreads();
  }
  const int l = threadIdx.x % kLanes;
  const long long first = (long long)blockIdx.x * T;
  for (int tt = threadIdx.x / kLanes; tt < T; tt += kTilesPerPass) {
    const long long t = first + tt;
    if (t >= n_tiles) break;
    int xrow0 = 0;
    bool base_ok = true;
    if constexpr (kStage == kTileBase) {
      const int b = base[t];
      base_ok = b >= 0 && (b + 1) * kChunk <= xw_rows;
      xrow0 = b * kChunk;
    }
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const long long row = (t * kChunk + s) * kLanes;
      if constexpr (kStage == kStream) {
        sum += v[row + l];
      } else {
        const int j = idx[row + l] & 127;
        if constexpr (kStage == kLane) {
          sum += v[row + j];
        } else {
          const int c = cell[row + j];
          float xv = 0.f;
          if constexpr (kStage == kTileBase) {
            if (base_ok) xv = xw[(xrow0 + (c & 7)) * kLanes + j];
          } else if constexpr (kStage == kWindowSmem) {
            if (c >= 0 && (c >> 3) < groups) xv = sx[c * kLanes + j];
          } else {
            if (c >= 0 && (c >> 3) < groups) xv = xw[c * kLanes + j];
          }
          sum += v[row + l] * xv;
        }
      }
    }
    out[t * kLanes + l] = kStage <= kLane ? sum * xw[0] : sum;
  }
}

template <int kStage>
int launch(const void* v, const void* idx, const void* cell,
           const void* base, const void* xw, void* out, long long n_tiles,
           int T, int G, int xw_rows, cudaStream_t stream) {
  size_t smem = 0;
  if constexpr (kStage == kWindowSmem) {
    smem = (size_t)G * kChunk * kLanes * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ladder_kernel<kStage>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n_tiles + T - 1) / T;
  ladder_kernel<kStage><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const float*)v, (const int16_t*)idx, (const int16_t*)cell,
      (const int32_t*)base, (const float*)xw, (float*)out, n_tiles, T, G,
      xw_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// stage: 0 stream, 1 lane, 2 dual, 3 tilebase, 4 window (global),
// 5 window (shared memory); T tiles a block; G window groups (stages 4-5);
// xw_rows the rows of xw (8G <= xw_rows is checked by the wrapper).
extern "C" int micro_ladder_launch(int stage, const void* v, const void* idx,
                                   const void* cell, const void* base,
                                   const void* xw, void* out,
                                   long long n_tiles, int T, int G,
                                   int xw_rows, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (stage) {
    case kStream:
      return launch<kStream>(v, idx, cell, base, xw, out, n_tiles, T, G,
                             xw_rows, s);
    case kLane:
      return launch<kLane>(v, idx, cell, base, xw, out, n_tiles, T, G,
                           xw_rows, s);
    case kDual:
      return launch<kDual>(v, idx, cell, base, xw, out, n_tiles, T, G,
                           xw_rows, s);
    case kTileBase:
      return launch<kTileBase>(v, idx, cell, base, xw, out, n_tiles, T, G,
                               xw_rows, s);
    case kWindow:
      return launch<kWindow>(v, idx, cell, base, xw, out, n_tiles, T, G,
                             xw_rows, s);
    case kWindowSmem:
      return launch<kWindowSmem>(v, idx, cell, base, xw, out, n_tiles, T, G,
                                 xw_rows, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
