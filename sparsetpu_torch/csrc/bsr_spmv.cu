// BSR SpMV partials for Hopper (sm_90a): dense (8, 128) f32 blocks times
// the 128-wide x segment at their block column, 8 row sums per block.
//
// Replaces sparsetpu/kernels/bsr.py:_bsr_kernel (launched by _bsr_partials
// through pl.pallas_call).  For block b with block column bcol[b]:
//   out[b, r] = sum over c < 128 of blocks[8b + r, c] * x2[bcol[b], c]
// for r < 8.  The TPU kernel packs 16 blocks' sums into lanes 0-15 of an
// (8, 128) output tile (its layout, undone by a reshape and transpose on
// the host); here the sums are written as the (n_blocks, 8) array itself.
// The block-row reduction (y rows from the partials) is the legacy final
// level or a segment sum, run after this kernel.
//
// What bounds it on the card: the value stream, 4 KB per block read once,
// plus 4 B of bcol and 32 B of sums written per block.  x (4 B per column)
// is read once per block that covers a column segment; for banded
// structure the same few segments recur in neighbouring blocks and stay in
// L2.  The wrapper checks bcol against x2's rows at upload, since nothing
// on the card checks the gather.
//
// Design, simple first: one warp per block.  Lane l reads one float4 of
// each of the 8 rows (columns 4l..4l+3: the warp's 8 loads cover the 4 KB
// block, each row one coalesced 512-byte transaction) and the matching
// float4 of the x segment, and forms 8 partial dot products.  Eight
// butterfly reductions over the warp leave every lane with the 8 sums;
// lanes 0-7 store them (32 contiguous bytes).  The values are read with a
// streaming (evict-first) load so they do not push the x segments out of
// L2.  Index arithmetic is 64-bit: 524,288 blocks already span 2^31 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;
constexpr int kCols = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
bsr_spmv_kernel(const float* __restrict__ blocks,
                const int32_t* __restrict__ bcol,
                const float* __restrict__ x2, float* __restrict__ out,
                long long n_blocks) {
  const long long b =
      (long long)blockIdx.x * kWarps + (long long)(threadIdx.x / 32);
  if (b >= n_blocks) return;
  const int lane = threadIdx.x % 32;
  const float4 xv = reinterpret_cast<const float4*>(
      x2 + (long long)bcol[b] * kCols)[lane];
  const float4* blk =
      reinterpret_cast<const float4*>(blocks + b * (kRows * kCols));
  float4 v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = __ldcs(blk + r * (kCols / 4) + lane);
  float s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    s[r] = v[r].x * xv.x + v[r].y * xv.y + v[r].z * xv.z + v[r].w * xv.w;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
  }
  if (lane < kRows) {
    float mine = s[0];
#pragma unroll
    for (int r = 1; r < kRows; ++r)
      if (lane == r) mine = s[r];
    out[b * kRows + lane] = mine;
  }
}

}  // namespace

// blocks: (n_blocks * 8, 128) f32; bcol: (n_blocks,) int32, each below
// x2's row count; x2: (padded_cols / 128, 128) f32; out: (n_blocks, 8) f32.
// All four 16-byte aligned (the wrapper checks).
extern "C" int bsr_spmv_launch(const void* blocks, const void* bcol,
                               const void* x2, void* out, long long n_blocks,
                               void* stream) {
  if (n_blocks == 0) return 0;
  const long long grid = (n_blocks + kWarps - 1) / kWarps;
  bsr_spmv_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)blocks, (const int32_t*)bcol, (const float*)x2,
      (float*)out, n_blocks);
  return (int)cudaGetLastError();
}
