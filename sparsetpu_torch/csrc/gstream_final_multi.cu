// Final level of the classic GStream device with k planes for Hopper
// (sm_90a): the k chunk-sum planes (the position vector, X below) -> Y,
// where output row r of the grid IS Y[r, :].
//
// Replaces two TPU kernels of sparsetpu/kernels/spmm.py:
//   _final_multi_kernel     (legacy, launched by _final_gather_sums_multi);
//   _final_v2_multi_kernel  (flat, launched by _final_v2_sums_multi);
// the k-plane forms of _final_kernel and _final_kernel_v2 (csrc/
// gstream_final.cu, which has the slot decode: window, row, drain).  One
// template covers both (kV2).
//
// Layout: X row-major (x_pad_rows * 128, k), so the k values of a gathered
// position are contiguous (one 32-byte sector at k = 8); out row-major
// (nt_pad * 128, k), so Y is a slice of it.
//
// Design, simple first: gstream_final.cu's, with a plane loop.  One thread
// a lane of one out tile loops over its block's instances in order (first
// writes, later add: the TPU's summation order, no atomics) and decodes
// each slot once for the kPlanes planes it keeps in registers; a grid row
// (blockIdx.y) per group of kPlanes planes.  So the cell and route streams
// (3 B a slot of every instance) are read once for k <= 8 and
// ceil(k / 8) times beyond; the position gathers land in windows the
// final-level build chose to be local, which L2 holds.  Offsets are 64-bit; the
// upload checks bound every window and tile base inside X's rows and the
// wrapper checks X's shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 8;
constexpr int kThreads = 256;
constexpr int kTilesPerBlock = kThreads / kLanes;
constexpr int kPlanes = 8;                    // planes a thread accumulates

template <bool kV2>
__global__ void __launch_bounds__(kThreads)
gstream_final_multi_kernel(const int32_t* __restrict__ step_meta,
                           const int32_t* __restrict__ tile_bases,
                           const int32_t* __restrict__ inst_start,
                           const float* __restrict__ X,
                           const int16_t* __restrict__ cells,
                           const int8_t* __restrict__ route,
                           float* __restrict__ out, long long nt_pad,
                           int tps, int G, int nw, int GS, int k) {
  const long long ot =
      (long long)blockIdx.x * kTilesPerBlock + threadIdx.x / kLanes;
  if (ot >= nt_pad) return;
  const int l = threadIdx.x % kLanes;
  const long long o = ot / tps;
  const int t = (int)(ot % tps);
  const int k0 = blockIdx.y * kPlanes;
  const int kn = min(kPlanes, k - k0);
  const int first = inst_start[o];
  const int last = inst_start[o + 1];
  float total[kPlanes];
#pragma unroll
  for (int kk = 0; kk < kPlanes; ++kk) total[kk] = 0.f;
  for (int i = first; i < last; ++i) {
    const int32_t* sm = step_meta + (long long)i * (nw + 2);
    const long long tile = (long long)i * tps + t;
    float part[kPlanes];
#pragma unroll
    for (int kk = 0; kk < kPlanes; ++kk) part[kk] = 0.f;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const long long row = (tile * kChunk + s) * kLanes;
      const int j = route[row + l] & 127;
      const int c = cells[row + j];
      const int grp = c >> 3;
      const int w = grp / G;
      if (grp >= 0 && w < nw) {
        long long xrow = (long long)kChunk * (grp - w * G) + (c & 7);
        if (kV2)
          xrow += (long long)kChunk * GS * sm[w] +
                  (long long)kChunk * tile_bases[tile * nw + w];
        else
          xrow += (long long)kChunk * G * sm[w];
        const float* xp = X + (xrow * kLanes + j) * k + k0;
#pragma unroll
        for (int kk = 0; kk < kPlanes; ++kk)
          if (kk < kn) part[kk] += xp[kk];
      }
    }
#pragma unroll
    for (int kk = 0; kk < kPlanes; ++kk)
      total[kk] = i == first ? part[kk] : total[kk] + part[kk];
  }
  float* op = out + (ot * kLanes + l) * k + k0;
#pragma unroll
  for (int kk = 0; kk < kPlanes; ++kk)
    if (kk < kn) op[kk] = total[kk];
}

}  // namespace

// v2: 0 for the legacy scheme (tile_bases unused, GS ignored), 1 for flat.
// The grid is (ceil(nt_pad / 2), ceil(k / 8)).
extern "C" int gstream_final_multi_launch(int v2, const void* step_meta,
                                          const void* tile_bases,
                                          const void* inst_start,
                                          const void* X, const void* cells,
                                          const void* route, void* out,
                                          long long nt_pad, int tps, int G,
                                          int nw, int GS, int k,
                                          void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (nt_pad == 0) return 0;
  const dim3 grid(
      (unsigned)((nt_pad + kTilesPerBlock - 1) / kTilesPerBlock),
      (unsigned)((k + kPlanes - 1) / kPlanes));
  cudaStream_t s = (cudaStream_t)stream;
  if (v2)
    gstream_final_multi_kernel<true><<<grid, kThreads, 0, s>>>(
        (const int32_t*)step_meta, (const int32_t*)tile_bases,
        (const int32_t*)inst_start, (const float*)X, (const int16_t*)cells,
        (const int8_t*)route, (float*)out, nt_pad, tps, G, nw, GS, k);
  else
    gstream_final_multi_kernel<false><<<grid, kThreads, 0, s>>>(
        (const int32_t*)step_meta, (const int32_t*)tile_bases,
        (const int32_t*)inst_start, (const float*)X, (const int16_t*)cells,
        (const int8_t*)route, (float*)out, nt_pad, tps, G, nw, GS, k);
  return (int)cudaGetLastError();
}
