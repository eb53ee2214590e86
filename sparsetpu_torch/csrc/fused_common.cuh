// What the fused SpMV (fused_spmv.cu) and the fused SpMM (fused_spmm.cu)
// share: the launch plan built once a device, and the pieces of their
// metadata ring (bulk copies into shared memory, completion on mbarriers,
// the values prefetched to L2 and read once past L1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Every buffer of a device and its layout, built once a device (the free
// wrappers build one a call).  Mirrored field for field by the ctypes
// structure in kernels/spmv_fused.py.
struct FusedPlan {
  const void* values;
  const int8_t* meta_i1;
  const int8_t* meta_rt;
  const int32_t* tile_base;
  const int8_t* fin1_i1;
  const int8_t* fin1_rt;
  const int8_t* fin2_i1;
  const int8_t* fin2_rt;
  const int32_t* fin2_group;
  const int32_t* step_slab;
  const int32_t* fin1_cnt;   // null: F1_max every step
  const int32_t* fin2_cnt;   // null: F2_max every step
  const int64_t* spill_pos;  // flat positions in the slab blocks
  const int64_t* spill_col;
  const void* spill_val;
  long long n_out;           // rows of the slab blocks (elements for k = 1)
  int n_steps, T, GLW, P, F1_max, F2_max, F1A, F2A, F1S, OBp, fin_direct;
  int n_spills, f64, device;
};

namespace fused {

constexpr int kLanes = 128;
constexpr int kChunk = 8;
constexpr int kSlots = kChunk * kLanes;   // a tile: 8 x 128 slots
constexpr int kThreads = 1024;            // a block, a step
constexpr int kGroups = kThreads / kLanes;

// Layout of a block's shared memory, in bytes: a ring of `ring` slots a
// group, each the int8 planes of one tile (i1 then rt), the mbarriers, the
// step's tile bases.
template <int ring> struct Layout {
  static constexpr int slots = kGroups * ring;
  static constexpr size_t bars = (size_t)slots * 2 * kSlots;
  static constexpr size_t tb = bars + (size_t)slots * sizeof(uint64_t);
  static constexpr size_t total = tb + (size_t)kLanes * sizeof(int32_t);
};

__device__ __forceinline__ int cell(int c, int groups) {
  return ((c >> 3) & (groups - 1)) * kChunk + (c & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the phase of parity `parity` to complete; a copy that never
// lands (a fault the host checks should rule out) traps after ~2^28 polls
// instead of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// bytes from global into the L2, ahead of their loads
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

// a value of the stream, read once: not kept in L1, which holds the x
// window's lines
__device__ __forceinline__ float load_once(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];\n"
               : "=f"(v)
               : "l"(p));
  return v;
}
__device__ __forceinline__ double load_once(const double* p) {
  double v;
  asm volatile("ld.global.nc.L1::no_allocate.f64 %0, [%1];\n"
               : "=d"(v)
               : "l"(p));
  return v;
}

// bytes from global to this block's shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the 128 threads of group g meet (named barrier g + 1; 0 is
// __syncthreads)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(kLanes) : "memory");
}

// The least shared memory carve-out, in percent of the SM's 228 KB, that
// holds `bytes` of a block and its 1 KB reserve: the rest of the SM's
// 256 KB stays L1 for the x gathers.
inline int carveout(size_t bytes) {
  return (int)(((bytes + 1024) * 100 + 232447) / 232448);
}

}  // namespace fused
