// The TPU's fused-redesign prototypes for Hopper (sm_90a): two measurement
// kernels, each the function of one TPU design experiment, launched
// through pl.pallas_call there:
//   scripts/exp_fused.py:34 kernel (-> :95), a one-kernel SpMV prototype:
//     fused_proto_kernel;
//   scripts/exp_streams.py:34 kern8 and :51 kern2 (-> :67, :76, :104), a
//     step's input streams summed: streams_kernel.
//
// fused_proto_kernel, one block a slab i of ST super-tiles (8 tiles each,
// one x base b = tile_base[i, s] a super-tile) and OT out tiles:
//   forward  scr[8 s + t, l] = sum_r values[r, l] * (g < GL ? xw[8 b + c,
//            j] : 0), r the 8 sublanes of tile t, m = meta & 0x7FFF (int16),
//            j = m[r, l] & 127, c = m[r, j] >> 7, g = c >> 3: the TPU's
//            select over GL window groups reads nothing past the window;
//   final    out[i OT + o, l] = sum_r (0 <= c < 8 SG ? scr[c, j] : 0), j =
//            froute[r, l] & 127, c = fcell[r, j], SG = ceil(ST / 8): the
//            TPU's select reaches SG groups of 8 scratch rows, all of them
//            written (8 SG <= 8 ST), so no row is read unwritten.
// A base outside [0, x_groups - GL] is clamped into it, as Pallas clamps
// the window's dynamic slice.  scr is ST * 8 rows of 128 floats in shared
// memory (229,376 B at the script's ST 56, of the 232,448 B opt-in); where
// a caller's ST does not fit, it is the slab's part of a workspace in
// device memory the caller allocates.  Thread map: 8 tile groups of 128
// threads, group t the tile t of each super-tile, a thread a lane, then
// group t the out tiles t, t + 8, ...; each sum in sublane order.
//
// streams_kernel<N>, N int8 streams (6: the 7-input form, or 1: the
// merged 2-input form), one block a fold of S steps: out[8 k + q, l] for q
// in 0..7 = sum over the fold's rows of values[., l] (f32) + sum over the
// streams of their rows' bytes at lane l.  8 row groups of 128 threads,
// each a lane's partial sums (f32 values, int32 bytes: exact), then added
// in group order through shared memory.
//
// What bounds them on the card: the bytes, read once.  fused_proto: 6 B a
// slot (value, int16 meta), 3 B a final slot, xw (0.46 MB, in the 50 MB
// L2), 4 B an output element; the script's shape is 72.0 MB.  streams:
// 155,648 B a step (16.9 MB at the script's 106 steps, in the L2; 135 MB
// at 848 steps).  Neither is tuned: the prototype's 24 slabs fill 24 of
// 132 SMs, which is the question its 192-slab shape asks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 8;
constexpr int kThreads = 1024;
constexpr int kGroups = kThreads / kLanes;
constexpr int kMaxStreams = 6;

struct Int8Streams {
  const int8_t* p[kMaxStreams];
  int rows[kMaxStreams];     // rows a step
};

template <bool kGlobalScratch>
__global__ void __launch_bounds__(kThreads)
fused_proto_kernel(const int32_t* __restrict__ tile_base,
                   const float* __restrict__ xw,
                   const float* __restrict__ values,
                   const int16_t* __restrict__ meta,
                   const int16_t* __restrict__ fcell,
                   const int8_t* __restrict__ froute,
                   float* __restrict__ out, float* workspace, int ST, int GL,
                   int OT, int top) {
  extern __shared__ float proto_smem[];
  const long long i = blockIdx.x;
  const int l = threadIdx.x % kLanes;
  const int t = threadIdx.x / kLanes;
  float* scr = kGlobalScratch
                   ? workspace + i * ST * kChunk * kLanes : proto_smem;

  for (int s = 0; s < ST; ++s) {
    const long long tile = (i * ST + s) * kChunk + t;
    const long long xrow =
        (long long)kChunk * min(max(tile_base[i * ST + s], 0), top);
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const long long row = (tile * kChunk + r) * kLanes;
      const int j = meta[row + l] & 0x7F;
      const int c = (meta[row + j] & 0x7FFF) >> 7;
      const float x = (c >> 3) < GL ? xw[(xrow + c) * kLanes + j] : 0.f;
      sum += values[row + l] * x;
    }
    scr[(s * kChunk + t) * kLanes + l] = sum;
  }
  __syncthreads();

  const int reach = (ST + kChunk - 1) / kChunk * kChunk;
  for (int o = t; o < OT; o += kGroups) {
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const long long row = ((i * OT + o) * kChunk + r) * kLanes;
      const int j = froute[row + l] & 127;
      const int c = fcell[row + j];
      sum += (c >= 0 && c < reach) ? scr[c * kLanes + j] : 0.f;
    }
    out[(i * OT + o) * kLanes + l] = sum;
  }
}

template <int kN>
__global__ void __launch_bounds__(kThreads)
streams_kernel(const float* __restrict__ values, int rows_v, Int8Streams in,
               float* __restrict__ out, int fold) {
  __shared__ float part_v[kGroups][kLanes];
  __shared__ int part_b[kGroups][kLanes];
  const long long k = blockIdx.x;
  const int l = threadIdx.x % kLanes;
  const int g = threadIdx.x / kLanes;

  const long long nv = (long long)rows_v * fold;
  const float* v = values + k * nv * kLanes;
  float sv = 0.f;
#pragma unroll 4
  for (long long r = g; r < nv; r += kGroups) sv += v[r * kLanes + l];
  int sb = 0;
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    const long long n = (long long)in.rows[q] * fold;
    const int8_t* b = in.p[q] + k * n * kLanes;
#pragma unroll 4
    for (long long r = g; r < n; r += kGroups) sb += b[r * kLanes + l];
  }
  part_v[g][l] = sv;
  part_b[g][l] = sb;
  __syncthreads();
  float tv = 0.f;
  int tb = 0;
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    tv += part_v[q][l];
    tb += part_b[q][l];
  }
  out[(k * kChunk + g) * kLanes + l] = tv + (float)tb;
}

template <bool kGlobal>
int launch_proto(const void* tile_base, const void* xw, const void* values,
                 const void* meta, const void* fcell, const void* froute,
                 void* out, void* workspace, int n_slabs, int ST, int GL,
                 int OT, int top, cudaStream_t stream) {
  const size_t smem =
      kGlobal ? 0 : (size_t)ST * kChunk * kLanes * sizeof(float);
  if (!kGlobal) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_proto_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_slabs == 0) return 0;
  fused_proto_kernel<kGlobal><<<n_slabs, kThreads, smem, stream>>>(
      (const int32_t*)tile_base, (const float*)xw, (const float*)values,
      (const int16_t*)meta, (const int16_t*)fcell, (const int8_t*)froute,
      (float*)out, (float*)workspace, ST, GL, OT, top);
  return (int)cudaGetLastError();
}

}  // namespace

// One block a slab: n_slabs slabs of ST super-tiles and OT out tiles;
// x_groups is xw's rows / 8.  workspace: null for the scratch in shared
// memory, else n_slabs * ST * 8 * 128 floats.
extern "C" int fused_proto_launch(const void* tile_base, const void* xw,
                                  const void* values, const void* meta,
                                  const void* fcell, const void* froute,
                                  void* out, void* workspace, int n_slabs,
                                  int ST, int GL, int OT, int x_groups,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ST < 1 || GL < 1 || OT < 0 || x_groups < GL)
    return (int)cudaErrorInvalidValue;
  if (workspace)
    return launch_proto<true>(tile_base, xw, values, meta, fcell, froute,
                              out, workspace, n_slabs, ST, GL, OT,
                              x_groups - GL, s);
  return launch_proto<false>(tile_base, xw, values, meta, fcell, froute, out,
                             nullptr, n_slabs, ST, GL, OT, x_groups - GL, s);
}

// n_int8 int8 streams (6 or 1) at ptrs, rows[q] rows a step each; values
// rows_v rows a step; n_blocks blocks of fold steps.
extern "C" int streams_launch(int n_int8, const void* values, int rows_v,
                              const void* const* ptrs, const int* rows,
                              void* out, int n_blocks, int fold,
                              void* stream) {
  Int8Streams in = {};
  if (n_int8 < 1 || n_int8 > kMaxStreams || fold < 1)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < n_int8; ++q) {
    in.p[q] = (const int8_t*)ptrs[q];
    in.rows[q] = rows[q];
  }
  if (n_blocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_int8) {
    case 6:
      streams_kernel<6><<<n_blocks, kThreads, 0, s>>>(
          (const float*)values, rows_v, in, (float*)out, fold);
      break;
    case 1:
      streams_kernel<1><<<n_blocks, kThreads, 0, s>>>(
          (const float*)values, rows_v, in, (float*)out, fold);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
