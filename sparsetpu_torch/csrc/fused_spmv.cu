// Fused resident-x SpMV for Hopper (sm_90a): y = A @ x on the fused pack.
//
// Replaces the TPU kernel sparsetpu/kernels/spmv_fused.py:_fused_kernel
// (launched by _fused_spmv_blocks through pl.pallas_call).  It computes the
// same three phases on the same packed streams (sparsetpu/pack/fused.py):
//
//   forward   for each tile t of step i, slot (s, l) with route j = rt[s, l]
//             and cell c = i1[s, j]:
//               prod = values[s, l] * x2[8 * tile_base[i, t] + c, j]
//             and the Q sublanes of each chunk sum into scratch[t * P + p, l]
//   stage 1   (skipped when fin_direct) for each of F1_max tiles:
//               scratch2[f, l] = sum_s (c >= 0 ? scratch[c, j] : 0)
//   stage 2   for each of F2_max tiles, into the slab step_slab[i]:
//               out[8 * fin2_group[i, f] + s, l] += (c >= 0 ? src[c, j] : 0)
//             with src = scratch when fin_direct, else scratch2.
//
// Cells decode as the TPU's select tree does: ((c >> 3) & (groups - 1)) * 8
// + (c & 7), and routes as a negative index wraps in jnp (j & 127), so every
// address stays inside its buffer; the wrapper checks tile_base, fin2_group
// and step_slab on the host.  The finish streams are strided by their
// allocated tile counts F1A/F2A, not by F1_max/F2_max.
//
// What bounds it on the card: the packed stream, 6 B per slot forward
// (f32 value + two int8 metadata bytes) plus 2 B per finish slot, read once.
// x is at most 1.5M columns (6 MB), so its gathers hit the 50 MB L2; the
// scratch planes live in shared memory (T*P*128*4 B <= 64 KB, F1S*128*4 B
// <= 64 KB) and never touch device memory.
//
// Design, simple first: one thread block per step (SGRP is a TPU grid-cost
// device; every padded sub-step is an ordinary drained step here).  1024
// threads: each owns one lane of one tile and walks its 8 sublanes, so a
// warp reads 128 contiguous bytes of values and 32 of routes per sublane
// and has 8 independent gather chains in flight.  Blocks run in no order
// and several steps share a slab, so stage 2 adds into the slab with
// atomicAdd on an output the wrapper zeroes first; a slab that owns only
// drained steps therefore reads 0.  Sums: each chunk and each stage-1 cell
// adds its terms in sublane order, as the TPU kernel does; the order in
// which steps reach a shared output row is not fixed, so results differ
// from the plain PyTorch version in the order of f32 adds only (compared at
// rtol 1e-5, atol 1e-5 * max(1, max|y|)).

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
fused_spmv_kernel(const float* __restrict__ values,
                  const int8_t* __restrict__ meta_i1,
                  const int8_t* __restrict__ meta_rt,
                  const int32_t* __restrict__ tile_base,
                  const int8_t* __restrict__ fin1_i1,
                  const int8_t* __restrict__ fin1_rt,
                  const int8_t* __restrict__ fin2_i1,
                  const int8_t* __restrict__ fin2_rt,
                  const int32_t* __restrict__ fin2_group,
                  const int32_t* __restrict__ step_slab,
                  const float* __restrict__ x2,
                  float* __restrict__ out,
                  int T, int GLW, int P, int F1_max, int F2_max, int F1A,
                  int F2A, int F1S, int OBp, int fin_direct) {
  extern __shared__ float smem[];
  const int SR = T * P;
  float* scratch = smem;                    // SR x 128 chunk sums
  float* scratch2 = smem + SR * kLanes;     // F1S x 128 row partials
  const long long i = blockIdx.x;
  const int l = threadIdx.x % kLanes;
  const int grp = threadIdx.x / kLanes;
  const int Q = kChunk / P;

  // ---- forward: T tiles -> per-chunk sums in shared memory
  for (int t = grp; t < T; t += kGroups) {
    const long long r0 = (i * T + t) * kChunk;
    const long long xrow = (long long)kChunk * tile_base[i * T + t];
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const long long row = (r0 + s) * kLanes;
      const int j = meta_rt[row + l] & 127;
      const int c = meta_i1[row + j];
      sum += values[row + l] * x2[(xrow + cell(c, GLW)) * kLanes + j];
      if ((s + 1) % Q == 0) {
        scratch[(t * P + s / Q) * kLanes + l] = sum;
        sum = 0.f;
      }
    }
  }
  if (!fin_direct) {
    // rows stage 1 does not write are never addressed by a valid pack;
    // keep them defined all the same
    for (int k = threadIdx.x; k < (F1S - F1_max) * kLanes; k += kThreads)
      scratch2[F1_max * kLanes + k] = 0.f;
  }
  __syncthreads();

  // ---- finish stage 1: each row's chunk sums -> one partial in scratch2
  if (!fin_direct) {
    const int SG = SR / kChunk;
    for (int f = grp; f < F1_max; f += kGroups) {
      const long long r0 = (i * F1A + f) * kChunk;
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const long long row = (r0 + s) * kLanes;
        const int j = fin1_rt[row + l] & 127;
        const int c = fin1_i1[row + j];
        if (c >= 0) sum += scratch[cell(c, SG) * kLanes + j];
      }
      scratch2[f * kLanes + l] = sum;
    }
    __syncthreads();
  }

  // ---- finish stage 2: partials -> aligned (8, 128) groups of the slab
  const float* src = fin_direct ? scratch : scratch2;
  const int S2G = (fin_direct ? SR : F1S) / kChunk;
  float* block = out + (long long)step_slab[i] * OBp * kLanes;
  for (int f = grp; f < F2_max; f += kGroups) {
    const long long r0 = (i * F2A + f) * kChunk;
    const int g = fin2_group[i * F2_max + f];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const long long row = (r0 + s) * kLanes;
      const int j = fin2_rt[row + l] & 127;
      const int c = fin2_i1[row + j];
      if (c >= 0)
        atomicAdd(&block[(g * kChunk + s) * kLanes + l],
                  src[cell(c, S2G) * kLanes + j]);
    }
  }
}

}  // namespace

extern "C" int fused_spmv_launch(
    const void* values, const void* meta_i1, const void* meta_rt,
    const void* tile_base, const void* fin1_i1, const void* fin1_rt,
    const void* fin2_i1, const void* fin2_rt, const void* fin2_group,
    const void* step_slab, const void* x2, void* out, int n_steps, int T,
    int GLW, int P, int F1_max, int F2_max, int F1A, int F2A, int F1S,
    int OBp, int fin_direct, void* stream) {
  const size_t smem =
      (size_t)(T * P + (fin_direct ? 0 : F1S)) * kLanes * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_spmv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_steps == 0) return 0;
  fused_spmv_kernel<<<n_steps, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)values, (const int8_t*)meta_i1, (const int8_t*)meta_rt,
      (const int32_t*)tile_base, (const int8_t*)fin1_i1,
      (const int8_t*)fin1_rt, (const int8_t*)fin2_i1, (const int8_t*)fin2_rt,
      (const int32_t*)fin2_group, (const int32_t*)step_slab,
      (const float*)x2, (float*)out, T, GLW, P, F1_max, F2_max, F1A, F2A,
      F1S, OBp, fin_direct);
  return (int)cudaGetLastError();
}

extern "C" const char* sparsetpu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
