// Stage split of the fused SpMV kernel for Hopper (sm_90a): where the time
// of csrc/fused_spmv.cu goes, stage by stage.  Three kernels, each a
// template whose compile-time stage selects what it computes; nothing here
// touches fused_spmv.cu, so the kernel it measures cannot move.
//
// Replaces the TPU design experiments that time the fused kernel's pieces,
// each launched through pl.pallas_call:
//   scripts/exp_asm_r5.py:70 fwd_kernel (-> :96), the forward at the real,
//     random, shuffled, interleaved and stride-37 tile bases and with random
//     metadata: kForward on those inputs;
//   scripts/exp_diag_r3.py:29 fwd_kernel (-> :56), the forward alone:
//     kForward;
//   scripts/exp_diag_r5.py:48 fwd_kernel (-> :76), the forward, the forward
//     plus finish stage 1 (its docstring's second phase): kForward and
//     kForwardStage1;
//   scripts/exp_tile_ladder.py:61 build (-> :74), the forward tile's
//     component ladder: tile_ladder_kernel, one stage a variant;
//   scripts/exp_glw.py:26 fwd_kernel (-> :66), the forward tile at GLW
//     window groups: kFull at that GLW (cells drawn below 8 GLW, so the
//     mask of cell() does nothing);
//   scripts/exp_selfirst.py:44 _fwd_kernel_a and :66 _fwd_kernel_b (->
//     :102), the forward tile and its selects-first form: kFull at GLW 16
//     and kSelFirst.
// The full kernel and the full SpMV are fused_spmv.cu itself, timed by the
// caller (bench/fused_stages.py).
//
//   kForward        the forward of fused_spmv.cu (its lines 113-129) into
//                   shared memory, as #1 runs it, then the step's chunk sums
//                   copied to device memory (16 B a thread): out[(i*T + t)*P
//                   + p, l] = sum over the Q sublanes of chunk p of
//                   values[s, l] * x2[8 * tile_base[i, t] + cell(i1[s, j],
//                   GLW), j], with j = rt[s, l] & 127.  Each sum stored
//                   straight to device memory from inside the sublane loop
//                   (a store under a run-time test of Q) took 0.0784 ms at
//                   the headline against 0.0587 for kForwardStage1 (H100 SXM,
//                   700 W): that form times another forward than #1's;
//   kForwardStage1  the same forward, then finish stage 1
//                   (fused_spmv.cu:138-154): out[i*F1S + f, l] = sum_s
//                   (c >= 0 ? scratch[cell(c, T*P/8), j] : 0), c = fin1_i1[s,
//                   j], j = fin1_rt[s, l] & 127; rows F1_max..F1S-1 zero.
//
// A tile base outside [0, GX - GLW] is clamped into it (one min/max a tile),
// so the #17 variants' random bases and any caller's stay inside x2; a valid
// pack's bases are inside already (FusedDevice checks them at upload).
//
// The tile ladder (scripts/exp_tile_ladder.py:31-57) on (tile_base, xw,
// values, i1, rt) with n_blocks x T tiles: each variant drops one piece of
// the full forward tile, and computes a defined function all the same:
//   kFull       the forward tile at window GLW (16, 8 or 4): #1's forward
//               at P = 1, x row 8 b + cell(c, GLW), c = i1[s, j];
//   kNoRoute    j = l (no lane route: rt is not read);
//   kNoTree     the TPU's select tree picks the window group; here the cell
//               decode into the GLW-group window does: without it the row
//               is 8 b + (c & 7), the window's first group;
//   kNoGathers  no sublane gather: row 8 (b + ((c >> 3) & (GLW - 1))) + s,
//               the slot's own sublane in the cell's group;
//   kNoSum      out = the product of sublane 0; the sum of all 8 is still
//               formed and stored where it is NaN, a predicate on the data
//               that finite inputs never meet, so nvcc keeps every load;
//   kBare       GLW 1, no route: row 8 b + (c & 7), lane l;
//   kSelFirst   the group read at the stripe cell: with s' = c & 7, row
//               8 b + 8 ((i1[s', j] >> 3) & (GLW - 1)) + s', lane j.  The
//               second read is another sublane's byte of the same tile; it
//               goes through L1, not a copy in shared memory: the first
//               read of each sublane (c = i1[s, j], the group's 128
//               threads over one 128-B row) has already brought the
//               tile's 1 KB of i1 in, and a copy would cost a barrier a
//               tile group.
//
// What bounds it on the card: the streams, read once: 6 B a slot (value and
// two int8 metadata bytes; 5 B where rt is not read), 4 B a tile base, 2 B
// a stage-1 slot, x2 (at most 6 MB, in the 50 MB L2) and 4 B an output
// element.  The headline's streams are 86.5 MB, past the L2.
//
// Design: fused_spmv.cu's thread map, so each stage costs what it costs
// inside #1: a block of 1024 threads (8 tiles in flight, a thread a lane,
// 8 independent gather chains) walks one step's T tiles; the tile ladder's
// T is the caller's tiles a block, so the same tiles run at #1's grid (one
// block a step of 128 tiles) and at a finer one.  Each chunk sum and
// stage-1 cell adds its terms in sublane order, as the TPU kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 8;
constexpr int kThreads = 1024;
constexpr int kGroups = kThreads / kLanes;   // tiles in flight per block

enum Stage { kForward = 0, kForwardStage1 = 1 };
enum Variant {
  kFull = 0,
  kNoRoute = 1,
  kNoTree = 2,
  kNoGathers = 3,
  kNoSum = 4,
  kBare = 5,
  kSelFirst = 6
};

__device__ __forceinline__ int cell(int c, int groups) {
  return ((c >> 3) & (groups - 1)) * kChunk + (c & 7);
}

__device__ __forceinline__ long long tile_row(const int32_t* tile_base,
                                              long long tile, int top) {
  return (long long)kChunk * min(max(tile_base[tile], 0), top);
}

template <int kStage>
__global__ void __launch_bounds__(kThreads)
fused_stage_kernel(const float* __restrict__ values,
                   const int8_t* __restrict__ meta_i1,
                   const int8_t* __restrict__ meta_rt,
                   const int32_t* __restrict__ tile_base,
                   const int8_t* __restrict__ fin1_i1,
                   const int8_t* __restrict__ fin1_rt,
                   const float* __restrict__ x2, float* __restrict__ out,
                   int T, int GLW, int P, int GX, int F1_max, int F1A,
                   int F1S) {
  extern __shared__ float stage_smem[];     // the chunk sums, T*P x 128
  const long long i = blockIdx.x;
  const int l = threadIdx.x % kLanes;
  const int grp = threadIdx.x / kLanes;
  const int Q = kChunk / P;

  for (int t = grp; t < T; t += kGroups) {
    const long long r0 = (i * T + t) * kChunk;
    const long long xrow = tile_row(tile_base, i * T + t, GX - GLW);
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const long long row = (r0 + s) * kLanes;
      const int j = meta_rt[row + l] & 127;
      const int c = meta_i1[row + j];
      sum += values[row + l] * x2[(xrow + cell(c, GLW)) * kLanes + j];
      if ((s + 1) % Q == 0) {
        stage_smem[(t * P + s / Q) * kLanes + l] = sum;
        sum = 0.f;
      }
    }
  }
  if constexpr (kStage == kForward) {
    __syncthreads();
    const float4* src = reinterpret_cast<const float4*>(stage_smem);
    float4* dst = reinterpret_cast<float4*>(out + i * T * P * kLanes);
    for (int k = threadIdx.x; k < T * P * kLanes / 4; k += kThreads)
      dst[k] = src[k];
  } else {
    float* part = out + i * F1S * kLanes;
    for (int k = threadIdx.x; k < (F1S - F1_max) * kLanes; k += kThreads)
      part[F1_max * kLanes + k] = 0.f;
    __syncthreads();
    const int SG = T * P / kChunk;
    for (int f = grp; f < F1_max; f += kGroups) {
      const long long r0 = (i * F1A + f) * kChunk;
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const long long row = (r0 + s) * kLanes;
        const int j = fin1_rt[row + l] & 127;
        const int c = fin1_i1[row + j];
        if (c >= 0) sum += stage_smem[cell(c, SG) * kLanes + j];
      }
      part[f * kLanes + l] = sum;
    }
  }
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
tile_ladder_kernel(const int32_t* __restrict__ tile_base,
                   const float* __restrict__ xw,
                   const float* __restrict__ values,
                   const int8_t* __restrict__ i1,
                   const int8_t* __restrict__ rt, float* __restrict__ out,
                   int T, int glw, int gx) {
  const long long blk = blockIdx.x;
  const int l = threadIdx.x % kLanes;
  const int grp = threadIdx.x / kLanes;
  for (int t = grp; t < T; t += kGroups) {
    const long long tile = blk * T + t;
    const long long xrow = tile_row(tile_base, tile, gx - glw);
    float sum = 0.f, first = 0.f;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const long long row = (tile * kChunk + s) * kLanes;
      const int j = (kVariant == kNoRoute || kVariant == kBare)
                        ? l : rt[row + l] & 127;
      const int c = i1[row + j];
      int r;
      if constexpr (kVariant == kNoTree || kVariant == kBare) {
        r = c & 7;
      } else if constexpr (kVariant == kNoGathers) {
        r = ((c >> 3) & (glw - 1)) * kChunk + s;
      } else if constexpr (kVariant == kSelFirst) {
        const int g = i1[(tile * kChunk + (c & 7)) * kLanes + j] >> 3;
        r = (g & (glw - 1)) * kChunk + (c & 7);
      } else {
        r = cell(c, glw);
      }
      const float p = values[row + l] * xw[(xrow + r) * kLanes + j];
      sum += p;
      if (s == 0) first = p;
    }
    if constexpr (kVariant == kNoSum) {
      out[tile * kLanes + l] = isnan(sum) ? sum : first;
    } else {
      out[tile * kLanes + l] = sum;
    }
  }
}

template <int kStage>
int launch_stage(const void* values, const void* meta_i1, const void* meta_rt,
                 const void* tile_base, const void* fin1_i1,
                 const void* fin1_rt, const void* x2, void* out, int n_steps,
                 int T, int GLW, int P, int GX, int F1_max, int F1A, int F1S,
                 cudaStream_t stream) {
  const size_t smem = (size_t)T * P * kLanes * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_stage_kernel<kStage>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_steps == 0) return 0;
  fused_stage_kernel<kStage><<<n_steps, kThreads, smem, stream>>>(
      (const float*)values, (const int8_t*)meta_i1, (const int8_t*)meta_rt,
      (const int32_t*)tile_base, (const int8_t*)fin1_i1,
      (const int8_t*)fin1_rt, (const float*)x2, (float*)out, T, GLW, P, GX,
      F1_max, F1A, F1S);
  return (int)cudaGetLastError();
}

template <int kVariant>
int launch_ladder(const void* tile_base, const void* xw, const void* values,
                  const void* i1, const void* rt, void* out, int n_blocks,
                  int T, int glw, int gx, cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  tile_ladder_kernel<kVariant><<<n_blocks, kThreads, 0, stream>>>(
      (const int32_t*)tile_base, (const float*)xw, (const float*)values,
      (const int8_t*)i1, (const int8_t*)rt, (float*)out, T, glw, gx);
  return (int)cudaGetLastError();
}

}  // namespace

// stage: 0 the forward alone (out (n_steps*T*P, 128); fin1_* unused),
// 1 the forward and finish stage 1 (out (n_steps*F1S, 128)).  GX: x2's rows
// / 8; F1A: the fin1 streams' allocated tiles a step.
extern "C" int fused_stage_launch(int stage, const void* values,
                                  const void* meta_i1, const void* meta_rt,
                                  const void* tile_base, const void* fin1_i1,
                                  const void* fin1_rt, const void* x2,
                                  void* out, int n_steps, int T, int GLW,
                                  int P, int GX, int F1_max, int F1A, int F1S,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (stage) {
    case kForward:
      return launch_stage<kForward>(values, meta_i1, meta_rt, tile_base,
                                    fin1_i1, fin1_rt, x2, out, n_steps, T,
                                    GLW, P, GX, F1_max, F1A, F1S, s);
    case kForwardStage1:
      return launch_stage<kForwardStage1>(values, meta_i1, meta_rt,
                                          tile_base, fin1_i1, fin1_rt, x2,
                                          out, n_steps, T, GLW, P, GX, F1_max,
                                          F1A, F1S, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// variant: 0 full, 1 no-route, 2 no-tree, 3 no-gathers, 4 no-sum, 5 bare,
// 6 selects-first;
// n_blocks blocks of T tiles; glw the window groups; gx xw's rows / 8.
extern "C" int tile_ladder_launch(int variant, const void* tile_base,
                                  const void* xw, const void* values,
                                  const void* i1, const void* rt, void* out,
                                  int n_blocks, int T, int glw, int gx,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kFull:
      return launch_ladder<kFull>(tile_base, xw, values, i1, rt, out,
                                  n_blocks, T, glw, gx, s);
    case kNoRoute:
      return launch_ladder<kNoRoute>(tile_base, xw, values, i1, rt, out,
                                     n_blocks, T, glw, gx, s);
    case kNoTree:
      return launch_ladder<kNoTree>(tile_base, xw, values, i1, rt, out,
                                    n_blocks, T, glw, gx, s);
    case kNoGathers:
      return launch_ladder<kNoGathers>(tile_base, xw, values, i1, rt, out,
                                       n_blocks, T, glw, gx, s);
    case kNoSum:
      return launch_ladder<kNoSum>(tile_base, xw, values, i1, rt, out,
                                   n_blocks, T, glw, gx, s);
    case kBare:
      return launch_ladder<kBare>(tile_base, xw, values, i1, rt, out,
                                  n_blocks, T, glw, gx, s);
    case kSelFirst:
      return launch_ladder<kSelFirst>(tile_base, xw, values, i1, rt, out,
                                      n_blocks, T, glw, gx, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
