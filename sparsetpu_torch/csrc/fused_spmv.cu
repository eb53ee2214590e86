// Fused resident-x SpMV for Hopper (sm_90a): y = A @ x on the fused pack.
//
// Replaces two TPU kernels, both launched through pl.pallas_call:
//   sparsetpu/kernels/spmv_fused.py:_fused_kernel       (f32, launched by
//     _fused_spmv_blocks; entry point fused_spmv_launch);
//   sparsetpu/kernels/spmv_fused.py:_fused_df64_kernel  (f64, launched by
//     _fused_df64_blocks; entry point fused_spmv_f64_launch).
// The TPU has no usable FP64, so its f64 kernel carries every value, x
// element and partial sum as two floats (hi, lo) with TwoProd products and
// double-float add trees.  Hopper has native FP64: one template, on the
// real type R, computes both; in f64 the values, x, the scratch planes and
// the output are double (the wrapper joins the pack's hi and lo value
// planes into one double plane at upload) and every product and add is an
// FP64 instruction, at least as precise as the TPU's ~2^-48.  It computes
// the same three phases on the same packed streams (sparsetpu/pack/fused.py):
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
// What bounds it on the card: the packed stream, read once: 6 B per slot
// forward in f32 (value + two int8 metadata bytes), 10 B in f64, plus 2 B
// per finish slot.  x is at most 1.5M columns in f32 (6 MB) and 700k in f64
// (5.6 MB), so its gathers hit the 50 MB L2.  The scratch planes live in
// shared memory: T*P*128*sizeof(R) B (<= 128 KB in f64, since T*P <= 128)
// and F1S*128*sizeof(R) B.  In f64 the two can exceed the 227 KB a block
// may opt in to (F1S <= 128: up to 256 KB); the wrapper then passes a
// global workspace of n_steps*F1S*128 doubles and scratch2 lives there,
// one F1S x 128 plane a block (__syncthreads makes a block's own global
// writes visible to the block; the plane stays in L2).
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
// from the plain PyTorch version in the order of adds only (compared at
// rtol 1e-5, atol 1e-5 * max(1, max|y|) in f32; rtol 1e-12, atol 1e-12 *
// max(1, max|y|) in f64).  atomicAdd on double is native on sm_60 and up.

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

// the block's dynamic shared memory, as an array of the real type
template <typename R> __device__ __forceinline__ R* shared_planes();
template <> __device__ __forceinline__ float* shared_planes<float>() {
  extern __shared__ float smem_f32[];
  return smem_f32;
}
template <> __device__ __forceinline__ double* shared_planes<double>() {
  extern __shared__ double smem_f64[];
  return smem_f64;
}

// kWorkspace: scratch2 in the global workspace (else in shared memory; a
// template parameter, so the shared-memory form addresses both scratch
// planes as shared memory)
template <typename R, bool kWorkspace>
__global__ void __launch_bounds__(kThreads)
fused_spmv_kernel(const R* __restrict__ values,
                  const int8_t* __restrict__ meta_i1,
                  const int8_t* __restrict__ meta_rt,
                  const int32_t* __restrict__ tile_base,
                  const int8_t* __restrict__ fin1_i1,
                  const int8_t* __restrict__ fin1_rt,
                  const int8_t* __restrict__ fin2_i1,
                  const int8_t* __restrict__ fin2_rt,
                  const int32_t* __restrict__ fin2_group,
                  const int32_t* __restrict__ step_slab,
                  const R* __restrict__ x2, R* __restrict__ out,
                  R* workspace,   // written, then read: no __restrict__
                  int T, int GLW, int P, int F1_max, int F2_max, int F1A,
                  int F2A, int F1S, int OBp, int fin_direct) {
  R* smem = shared_planes<R>();
  const int SR = T * P;
  const long long i = blockIdx.x;
  R* scratch = smem;                        // SR x 128 chunk sums
  R* scratch2 = kWorkspace                  // F1S x 128 row partials
                    ? workspace + i * F1S * kLanes
                    : smem + SR * kLanes;
  const int l = threadIdx.x % kLanes;
  const int grp = threadIdx.x / kLanes;
  const int Q = kChunk / P;

  // ---- forward: T tiles -> per-chunk sums in shared memory
  for (int t = grp; t < T; t += kGroups) {
    const long long r0 = (i * T + t) * kChunk;
    const long long xrow = (long long)kChunk * tile_base[i * T + t];
    R sum = 0;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const long long row = (r0 + s) * kLanes;
      const int j = meta_rt[row + l] & 127;
      const int c = meta_i1[row + j];
      sum += values[row + l] * x2[(xrow + cell(c, GLW)) * kLanes + j];
      if ((s + 1) % Q == 0) {
        scratch[(t * P + s / Q) * kLanes + l] = sum;
        sum = 0;
      }
    }
  }
  if (!fin_direct) {
    // rows stage 1 does not write are never addressed by a valid pack;
    // keep them defined all the same
    for (int k = threadIdx.x; k < (F1S - F1_max) * kLanes; k += kThreads)
      scratch2[F1_max * kLanes + k] = 0;
  }
  __syncthreads();

  // ---- finish stage 1: each row's chunk sums -> one partial in scratch2
  if (!fin_direct) {
    const int SG = SR / kChunk;
    for (int f = grp; f < F1_max; f += kGroups) {
      const long long r0 = (i * F1A + f) * kChunk;
      R sum = 0;
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
  const R* src = fin_direct ? scratch : scratch2;
  const int S2G = (fin_direct ? SR : F1S) / kChunk;
  R* block = out + (long long)step_slab[i] * OBp * kLanes;
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

template <typename R, bool kWorkspace>
int launch(const void* values, const void* meta_i1, const void* meta_rt,
           const void* tile_base, const void* fin1_i1, const void* fin1_rt,
           const void* fin2_i1, const void* fin2_rt, const void* fin2_group,
           const void* step_slab, const void* x2, void* out, void* workspace,
           int n_steps, int T, int GLW, int P, int F1_max, int F2_max,
           int F1A, int F2A, int F1S, int OBp, int fin_direct,
           cudaStream_t stream) {
  const int s2 = (fin_direct || kWorkspace) ? 0 : F1S;
  const size_t smem = (size_t)(T * P + s2) * kLanes * sizeof(R);
  cudaError_t err = cudaFuncSetAttribute(
      fused_spmv_kernel<R, kWorkspace>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_steps == 0) return 0;
  fused_spmv_kernel<R, kWorkspace><<<n_steps, kThreads, smem, stream>>>(
      (const R*)values, (const int8_t*)meta_i1, (const int8_t*)meta_rt,
      (const int32_t*)tile_base, (const int8_t*)fin1_i1,
      (const int8_t*)fin1_rt, (const int8_t*)fin2_i1, (const int8_t*)fin2_rt,
      (const int32_t*)fin2_group, (const int32_t*)step_slab, (const R*)x2,
      (R*)out, (R*)workspace, T, GLW, P, F1_max, F2_max, F1A, F2A, F1S, OBp,
      fin_direct);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_spmv_launch(
    const void* values, const void* meta_i1, const void* meta_rt,
    const void* tile_base, const void* fin1_i1, const void* fin1_rt,
    const void* fin2_i1, const void* fin2_rt, const void* fin2_group,
    const void* step_slab, const void* x2, void* out, int n_steps, int T,
    int GLW, int P, int F1_max, int F2_max, int F1A, int F2A, int F1S,
    int OBp, int fin_direct, void* stream) {
  return launch<float, false>(values, meta_i1, meta_rt, tile_base, fin1_i1,
                              fin1_rt, fin2_i1, fin2_rt, fin2_group,
                              step_slab, x2, out, nullptr, n_steps, T, GLW,
                              P, F1_max, F2_max, F1A, F2A, F1S, OBp,
                              fin_direct, (cudaStream_t)stream);
}

// f64: double values, x2 and out; workspace is null (scratch2 in shared
// memory) or n_steps * F1S * 128 doubles (scratch2 in device memory).
extern "C" int fused_spmv_f64_launch(
    const void* values, const void* meta_i1, const void* meta_rt,
    const void* tile_base, const void* fin1_i1, const void* fin1_rt,
    const void* fin2_i1, const void* fin2_rt, const void* fin2_group,
    const void* step_slab, const void* x2, void* out, void* workspace,
    int n_steps, int T, int GLW, int P, int F1_max, int F2_max, int F1A,
    int F2A, int F1S, int OBp, int fin_direct, void* stream) {
  if (workspace)
    return launch<double, true>(values, meta_i1, meta_rt, tile_base, fin1_i1,
                                fin1_rt, fin2_i1, fin2_rt, fin2_group,
                                step_slab, x2, out, workspace, n_steps, T,
                                GLW, P, F1_max, F2_max, F1A, F2A, F1S, OBp,
                                fin_direct, (cudaStream_t)stream);
  return launch<double, false>(values, meta_i1, meta_rt, tile_base, fin1_i1,
                               fin1_rt, fin2_i1, fin2_rt, fin2_group,
                               step_slab, x2, out, nullptr, n_steps, T, GLW,
                               P, F1_max, F2_max, F1A, F2A, F1S, OBp,
                               fin_direct, (cudaStream_t)stream);
}

extern "C" const char* sparsetpu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
