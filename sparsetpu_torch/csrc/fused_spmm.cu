// Fused resident-x SpMM for Hopper (sm_90a): Y = A @ X on the fused pack,
// for X with k columns.
//
// Replaces the TPU kernel sparsetpu/kernels/spmv_fused.py:_fused_spmm_kernel
// (launched by _fused_spmm_blocks through pl.pallas_call): _fused_kernel
// (csrc/fused_spmv.cu) with k planes.  Each slot's route, cell and value
// are decoded once and serve every plane of the block's group:
//
//   forward   prod[kk] = values[s, l] * X[col, k0 + kk],
//             col = (8 * tile_base[i, t] + cell(i1[s, j])) * 128 + j,
//             the Q sublanes of each chunk summed into scratch;
//   stage 1   (skipped when fin_direct) scratch2[f, l, kk] = sum_s
//             (c >= 0 ? scratch[c, j, kk] : 0);
//   stage 2   out[8 * fin2_group[i, f] + s, l, kk] += (c >= 0 ? src[c, j,
//             kk] : 0) into the slab step_slab[i].
//
// Layout: X is row-major (GX * 8 * 128, k), so the k values a slot gathers
// are contiguous (one 32-byte sector at k = 8), and out is row-major
// (n_slabs * OBp * 128, k), so Y is a slice of it.  Scratch is row-major
// too: [(row * 128 + lane) * kn + kk].
//
// Design (a) of the two simple ones: a grid of (step, plane group).  A
// group holds kg planes, as many as fit the opt-in shared memory:
// kg * (T*P + F1S) * 128 * 4 B (the wrapper picks kg; at the headline one
// plane takes 80 KB, so kg = 2 of 227 KB).  Each group re-reads its step's
// streams, so the streams are read ceil(k / kg) times; that, not the ideal
// one pass, is this kernel's bound.  Everything else is fused_spmv.cu's
// design: one 1024-thread block a step, each thread one lane of one tile
// walking its 8 sublanes, stage 2 by atomicAdd into an output the wrapper
// zeroes, drained SGRP sub-steps as ordinary steps.  Sums: each chunk and
// each stage-1 cell adds its terms in sublane order; the order in which
// steps reach a shared output row is not fixed.  Every offset is 64-bit
// where it can pass 2^31; the wrapper checks X's shape and the pack's
// bounds, so every address stays in its buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 8;
constexpr int kThreads = 1024;
constexpr int kGroups = kThreads / kLanes;   // tiles in flight per block

__device__ __forceinline__ int cell(int c, int groups) {
  return ((c >> 3) & (groups - 1)) * kChunk + (c & 7);
}

__global__ void __launch_bounds__(kThreads)
fused_spmm_kernel(const float* __restrict__ values,
                  const int8_t* __restrict__ meta_i1,
                  const int8_t* __restrict__ meta_rt,
                  const int32_t* __restrict__ tile_base,
                  const int8_t* __restrict__ fin1_i1,
                  const int8_t* __restrict__ fin1_rt,
                  const int8_t* __restrict__ fin2_i1,
                  const int8_t* __restrict__ fin2_rt,
                  const int32_t* __restrict__ fin2_group,
                  const int32_t* __restrict__ step_slab,
                  const float* __restrict__ X,
                  float* __restrict__ out,
                  int T, int GLW, int P, int F1_max, int F2_max, int F1A,
                  int F2A, int F1S, int OBp, int fin_direct, int k, int kg) {
  extern __shared__ float smem[];
  const int SR = T * P;
  const int k0 = blockIdx.y * kg;
  const int kn = min(kg, k - k0);             // planes of this group
  float* scratch = smem;                      // SR*128 x kn chunk sums
  float* scratch2 = smem + SR * kLanes * kn;  // F1S*128 x kn row partials
  const long long i = blockIdx.x;
  const int l = threadIdx.x % kLanes;
  const int grp = threadIdx.x / kLanes;
  const int Q = kChunk / P;

  // ---- forward: decode the tile's 8 slots once, then every plane
  for (int t = grp; t < T; t += kGroups) {
    const long long r0 = (i * T + t) * kChunk;
    const long long xrow = (long long)kChunk * tile_base[i * T + t];
    float v[kChunk];
    long long xa[kChunk];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const long long row = (r0 + s) * kLanes;
      const int j = meta_rt[row + l] & 127;
      const int c = meta_i1[row + j];
      v[s] = values[row + l];
      xa[s] = ((xrow + cell(c, GLW)) * kLanes + j) * k + k0;
    }
    for (int kk = 0; kk < kn; ++kk) {
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        sum += v[s] * X[xa[s] + kk];
        if ((s + 1) % Q == 0) {
          scratch[((t * P + s / Q) * kLanes + l) * kn + kk] = sum;
          sum = 0.f;
        }
      }
    }
  }
  if (!fin_direct) {
    // rows stage 1 does not write are never addressed by a valid pack;
    // keep them defined all the same
    for (int e = threadIdx.x; e < (F1S - F1_max) * kLanes * kn;
         e += kThreads)
      scratch2[F1_max * kLanes * kn + e] = 0.f;
  }
  __syncthreads();

  // ---- finish stage 1: each row's chunk sums -> one partial in scratch2
  if (!fin_direct) {
    const int SG = SR / kChunk;
    for (int f = grp; f < F1_max; f += kGroups) {
      const long long r0 = (i * F1A + f) * kChunk;
      int a[kChunk];                          // scratch offset, -1: drain
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const long long row = (r0 + s) * kLanes;
        const int j = fin1_rt[row + l] & 127;
        const int c = fin1_i1[row + j];
        a[s] = c >= 0 ? (cell(c, SG) * kLanes + j) * kn : -1;
      }
      for (int kk = 0; kk < kn; ++kk) {
        float sum = 0.f;
#pragma unroll
        for (int s = 0; s < kChunk; ++s)
          if (a[s] >= 0) sum += scratch[a[s] + kk];
        scratch2[(f * kLanes + l) * kn + kk] = sum;
      }
    }
    __syncthreads();
  }

  // ---- finish stage 2: partials -> aligned (8, 128) groups of the slab
  const float* src = fin_direct ? scratch : scratch2;
  const int S2G = (fin_direct ? SR : F1S) / kChunk;
  float* block = out + (long long)step_slab[i] * OBp * kLanes * k + k0;
  for (int f = grp; f < F2_max; f += kGroups) {
    const long long r0 = (i * F2A + f) * kChunk;
    const int g = fin2_group[i * F2_max + f];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const long long row = (r0 + s) * kLanes;
      const int j = fin2_rt[row + l] & 127;
      const int c = fin2_i1[row + j];
      if (c >= 0) {
        const float* a = src + (cell(c, S2G) * kLanes + j) * kn;
        float* o = block + ((long long)(g * kChunk + s) * kLanes + l) * k;
        for (int kk = 0; kk < kn; ++kk) atomicAdd(o + kk, a[kk]);
      }
    }
  }
}

}  // namespace

// kg planes a block (the wrapper picks it from the opt-in shared memory);
// the grid is (n_steps, ceil(k / kg)).
extern "C" int fused_spmm_launch(
    const void* values, const void* meta_i1, const void* meta_rt,
    const void* tile_base, const void* fin1_i1, const void* fin1_rt,
    const void* fin2_i1, const void* fin2_rt, const void* fin2_group,
    const void* step_slab, const void* X, void* out, int n_steps, int T,
    int GLW, int P, int F1_max, int F2_max, int F1A, int F2A, int F1S,
    int OBp, int fin_direct, int k, int kg, void* stream) {
  if (k < 1 || kg < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kg * (T * P + (fin_direct ? 0 : F1S)) *
                      kLanes * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_steps == 0) return 0;
  const dim3 grid((unsigned)n_steps, (unsigned)((k + kg - 1) / kg));
  fused_spmm_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)values, (const int8_t*)meta_i1, (const int8_t*)meta_rt,
      (const int32_t*)tile_base, (const int8_t*)fin1_i1,
      (const int8_t*)fin1_rt, (const int8_t*)fin2_i1, (const int8_t*)fin2_rt,
      (const int32_t*)fin2_group, (const int32_t*)step_slab, (const float*)X,
      (float*)out, T, GLW, P, F1_max, F2_max, F1A, F2A, F1S, OBp, fin_direct,
      k, kg);
  return (int)cudaGetLastError();
}
