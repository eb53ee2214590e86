// Fused resident-x SpMV for Hopper (sm_90a): y = A @ x on the fused pack.
//
// Replaces two TPU kernels, both launched through pl.pallas_call:
//   sparsetpu/kernels/spmv_fused.py:_fused_kernel       (f32, launched by
//     _fused_spmv_blocks);
//   sparsetpu/kernels/spmv_fused.py:_fused_df64_kernel  (f64, launched by
//     _fused_df64_blocks).
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
//               prod = values[s, l] * x[(8 * tile_base[i, t] + c) * 128 + j]
//             and the Q sublanes of each chunk sum into scratch[t * P + p, l]
//   stage 1   (skipped when fin_direct) for each of fin1_cnt[i] tiles:
//               scratch2[f, l] = sum_s (c >= 0 ? scratch[c, j] : 0)
//   stage 2   for each of fin2_cnt[i] tiles, into the slab step_slab[i]:
//               out[8 * fin2_group[i, f] + s, l] += (c >= 0 ? src[c, j] : 0)
//             with src = scratch when fin_direct, else scratch2.
//
// and, in the same launch, the pack's spills: out[spill_pos[k]] +=
// spill_val[k] * x[spill_col[k]], spill_pos a flat position in the slab
// blocks (the wrapper maps each spill's y row there at upload).  x is read
// unpadded: an index at or past n_x reads 0.
//
// Cells decode as the TPU's select tree does: ((c >> 3) & (groups - 1)) * 8
// + (c & 7), and routes as a negative index wraps in jnp (j & 127), so every
// address stays inside its buffer; the wrapper checks tile_base, fin2_group,
// step_slab and the live counts (0 <= cnt <= F_max) on the host.  The
// finish streams are strided by their allocated tile counts F1A/F2A.  The
// finish loops run to each step's live counts (tiles past them are drains;
// null counts mean F1_max/F2_max, the free wrappers' form); scratch2 rows
// from fin1_cnt[i] to F1S are zeroed, so every row stage 2 can address is
// defined.
//
// What bounds it on the card: the packed stream, read once: 6 B per slot
// forward in f32 (value + two int8 metadata bytes), 10 B in f64, plus 2 B
// per live finish slot.  x is at most 1.5M columns in f32 (6 MB) and 700k
// in f64 (5.6 MB), so its gathers hit the 50 MB L2; measured on the card,
// what holds the kernel back is the x gathers' rate through L1 (every
// slot a scattered 4 or 8 B load), so the design keeps L1 for them.
//
// Design.  The parent kernel read, for each slot, the route, then i1 at the
// routed lane, then x: three dependent global loads, and nothing of the
// next tile was in flight while a tile gathered; its 80 KB (f32) or 160 KB
// (f64) of shared scratch left L1 small.
//
//   * A step's 1024 threads form groups of 128, a thread a lane.  Each
//     group owns a ring of kRing slots, the i1 and rt planes of one tile
//     (2 KB), filled by the Tensor Memory Accelerator's bulk copies
//     (cp.async.bulk, completion on the slot's mbarrier) kRing tiles ahead
//     of the compute; its first thread issues them.  The routed i1 lookup is
//     a shared-memory read.  A group walks one sequence of items: its
//     forward tiles, then its stage-1 tiles, then its stage-2 tiles, so
//     the finish streams are in flight while the forward still runs.
//     After an item the group meets at a named barrier (its own id) and
//     its first thread refills the slot.
//   * The values, read once by their own lane, are not staged: the copy
//     that stages a tile's metadata also prefetches its values into the L2
//     (cp.async.bulk.prefetch.L2), and each lane loads its 8 values with
//     L1::no_allocate before it waits for the metadata.
//   * The chunk sums and scratch2 live in a global workspace, one
//     (T*P + F1S) x 128 plane a step (in L2, cached by L1), which the
//     caller allocates for each call on the call's stream.  The block
//     takes 17-33 KB of shared memory and the carve-out leaves L1 the rest
//     of the SM's 256 KB for the x gathers.  (Measured on the card and
//     dropped: the scratch in shared memory, and a cluster of 2 blocks a
//     step; PERF.md section 6.)
//   * One block of 1024 threads a step; kRing is 2 in f32 and 1 in f64
//     (the depths the card's sweep chose).
//   * One launch a call: the C entry zeroes the output (cudaMemsetAsync)
//     and launches one grid of n_steps steps plus ceil(n_spills / 1024)
//     spill blocks.

// Blocks run in no order and several steps share a slab, so stage 2 and
// the spills add into the slab with atomicAdd on the zeroed output; a slab
// that owns only drained steps reads 0.  Sums: each chunk and each stage-1
// cell adds its terms in sublane order, as the TPU kernel does; the order
// in which steps reach a shared output row is not fixed, so results differ
// from the plain PyTorch version in the order of adds only (compared at
// rtol 1e-5, atol 1e-5 * max(1, max|y|) in f32; rtol 1e-12, atol 1e-12 *
// max(1, max|y|) in f64).  atomicAdd on double is native on sm_60 and up.

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
  long long n_out;           // elements of the slab blocks
  int n_steps, T, GLW, P, F1_max, F2_max, F1A, F2A, F1S, OBp, fin_direct;
  int n_spills, f64, device;
};

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 8;
constexpr int kSlots = kChunk * kLanes;   // a tile: 8 x 128 slots
constexpr int kThreads = 1024;            // a block, a step
constexpr int kGroups = kThreads / kLanes;

// tiles in flight a group of 128 threads
template <typename R> constexpr int kRing = sizeof(R) == 4 ? 2 : 1;

// Layout of a block's shared memory, in bytes: the ring's int8 planes (i1
// then rt a slot), the mbarriers, the step's tile bases.
template <typename R> struct Layout {
  static constexpr int slots = kGroups * kRing<R>;
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

// ws: the call's workspace, n_steps planes of (T*P + F1S) x 128
template <typename R>
__global__ void __launch_bounds__(kThreads, 1)
fused_spmv_kernel(const FusedPlan p, const R* __restrict__ x, int n_x,
                  R* out, R* ws) {
  constexpr int ring = kRing<R>;
  using L = Layout<R>;
  const int tid = threadIdx.x;

  // ---- spill blocks, past the steps
  if (blockIdx.x >= (unsigned)p.n_steps) {
    const long long k = (long long)(blockIdx.x - p.n_steps) * kThreads + tid;
    if (k < p.n_spills) {
      const long long c = p.spill_col[k];
      const R xv = c < n_x ? x[c] : R(0);
      atomicAdd(out + p.spill_pos[k],
                static_cast<const R*>(p.spill_val)[k] * xv);
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  const int g = tid / kLanes;
  const int l = tid % kLanes;
  const bool lead = l == 0;
  const long long i = blockIdx.x;
  int8_t* ring_meta = reinterpret_cast<int8_t*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars) + g * ring;
  int32_t* tb = reinterpret_cast<int32_t*>(smem + L::tb);  // x row bases
  const int Q = kChunk / p.P;

  // the step's live finish tiles
  const int cnt1 = p.fin_direct ? 0 : (p.fin1_cnt ? p.fin1_cnt[i] : p.F1_max);
  const int cnt2 = p.fin2_cnt ? p.fin2_cnt[i] : p.F2_max;
  // the chunk sums, then scratch2: the step's plane of the workspace
  R* scratch = ws + i * (p.T * p.P + p.F1S) * kLanes;
  R* scratch2 = scratch + p.T * p.P * kLanes;
  // this group's items: forward tiles g + k G, then stage-1 rows g + k G,
  // then stage-2 tiles g + k G (G = kGroups)
  auto share = [&](int n) {
    return n > g ? (n - g + kGroups - 1) / kGroups : 0;
  };
  const int nf = share(p.T), e1 = nf + share(cnt1), e2 = e1 + share(cnt2);

  auto issue = [&](int q) {
    const int slot = q % ring;
    uint64_t* bar = bars + slot;
    int8_t* mi1 = ring_meta + (size_t)(g * ring + slot) * 2 * kSlots;
    const int8_t* si1;
    const int8_t* srt;
    if (q < nf) {
      const long long tile = i * p.T + g + (long long)q * kGroups;
      prefetch_l2(static_cast<const R*>(p.values) + tile * kSlots,
                  kSlots * sizeof(R));
      si1 = p.meta_i1 + tile * kSlots;
      srt = p.meta_rt + tile * kSlots;
    } else if (q < e1) {
      const long long off =
          (i * p.F1A + g + (long long)(q - nf) * kGroups) * kSlots;
      si1 = p.fin1_i1 + off;
      srt = p.fin1_rt + off;
    } else {
      const long long off =
          (i * p.F2A + g + (long long)(q - e1) * kGroups) * kSlots;
      si1 = p.fin2_i1 + off;
      srt = p.fin2_rt + off;
    }
    bar_expect(bar, 2 * kSlots);
    bulk_copy(mi1, si1, kSlots, bar);
    bulk_copy(mi1 + kSlots, srt, kSlots, bar);
  };

  if (tid < p.T) tb[tid] = kChunk * p.tile_base[i * p.T + tid];
  if (lead)
    for (int s = 0; s < ring; ++s) bar_init(bars + s);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (lead)
    for (int q = 0; q < min(ring, e2); ++q) issue(q);

  // consume item q: wait for its slot, hand the slot's planes to fn, then
  // meet the group and refill the slot with item q + ring
  auto consume = [&](int q, auto fn) {
    const int slot = q % ring;
    bar_wait(bars + slot, (q / ring) & 1);
    const size_t s = (size_t)(g * ring + slot);
    fn(ring_meta + s * 2 * kSlots, ring_meta + s * 2 * kSlots + kSlots);
    group_sync(g);
    if (lead && q + ring < e2) issue(q + ring);
  };

  // ---- forward: the step's tiles -> per-chunk sums
  for (int q = 0; q < nf; ++q) {
    const int t = g + q * kGroups;
    // this lane's values, from the L2 (prefetched with the tile's
    // metadata), in flight while the group waits for the metadata
    const R* vg =
        static_cast<const R*>(p.values) + (i * p.T + t) * kSlots + l;
    R v[kChunk];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) v[s] = load_once(vg + s * kLanes);
    consume(q, [&](const int8_t* i1, const int8_t* rt) {
      const int xrow = tb[t];
      R sum = 0;
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const int j = rt[s * kLanes + l] & 127;
        const int c = i1[s * kLanes + j];
        const int xi = (xrow + cell(c, p.GLW)) * kLanes + j;
        const R xv = (unsigned)xi < (unsigned)n_x ? x[xi] : R(0);
        sum += v[s] * xv;
        if ((s + 1) % Q == 0) {
          scratch[(t * p.P + s / Q) * kLanes + l] = sum;
          sum = 0;
        }
      }
    });
  }

  if (!p.fin_direct) {
    // rows stage 1 does not write are never addressed by a valid pack;
    // keep them defined all the same
    for (int k = tid; k < (p.F1S - cnt1) * kLanes; k += kThreads)
      scratch2[cnt1 * kLanes + k] = 0;
  }
  __syncthreads();

  // ---- finish stage 1: each row's chunk sums -> one partial in scratch2
  if (!p.fin_direct) {
    const int SG = p.T * p.P / kChunk;
    for (int q = nf; q < e1; ++q) {
      const int f = g + (q - nf) * kGroups;
      consume(q, [&](const int8_t* i1, const int8_t* rt) {
        R sum = 0;
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {
          const int j = rt[s * kLanes + l] & 127;
          const int c = i1[s * kLanes + j];
          if (c >= 0) sum += scratch[cell(c, SG) * kLanes + j];
        }
        scratch2[f * kLanes + l] = sum;
      });
    }
    __syncthreads();
  }

  // ---- finish stage 2: partials -> aligned (8, 128) groups of the slab
  const R* src = p.fin_direct ? scratch : scratch2;
  const int S2G = (p.fin_direct ? p.T * p.P : p.F1S) / kChunk;
  R* block = out + (long long)p.step_slab[i] * p.OBp * kLanes;
  for (int q = e1; q < e2; ++q) {
    const int f = g + (q - e1) * kGroups;
    const int grp = p.fin2_group[i * p.F2_max + f];
    consume(q, [&](const int8_t* i1, const int8_t* rt) {
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const int j = rt[s * kLanes + l] & 127;
        const int c = i1[s * kLanes + j];
        if (c >= 0)
          atomicAdd(&block[(grp * kChunk + s) * kLanes + l],
                    src[cell(c, S2G) * kLanes + j]);
      }
    });
  }
}

template <typename R>
cudaError_t prepare() {
  // the least shared memory carve-out that holds the block and its 1 KB
  // reserve: the rest of the SM's 256 KB stays L1 for the x window
  const size_t need = ((Layout<R>::total + 1024) * 100 + 232447) / 232448;
  return cudaFuncSetAttribute(fused_spmv_kernel<R>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)need);
}

template <typename R>
cudaError_t launch(const FusedPlan& p, const void* x, int n_x, void* out,
                   void* ws, cudaStream_t stream) {
  const int grid = p.n_steps + (p.n_spills + kThreads - 1) / kThreads;
  if (grid == 0) return cudaSuccess;
  fused_spmv_kernel<R><<<grid, kThreads, Layout<R>::total, stream>>>(
      p, static_cast<const R*>(x), n_x, static_cast<R*>(out),
      static_cast<R*>(ws));
  return cudaGetLastError();
}

}  // namespace

// Once a plan: set the kernel's shared memory carve-out.
extern "C" int fused_spmv_prepare(const FusedPlan* plan) {
  if (plan->T < 1 || plan->T > kLanes) return (int)cudaErrorInvalidValue;
  return (int)(plan->f64 ? prepare<double>() : prepare<float>());
}

// A call: zero the n_out slab blocks and launch one kernel, on `stream` of
// the plan's device.  x holds n_x elements (float, or double for f64); ws,
// this call's own, n_steps * (T*P + F1S) * 128 elements of the same type.
extern "C" int fused_spmv_run(const FusedPlan* plan, const void* x,
                              long long n_x, void* out, void* ws,
                              void* stream) {
  if (plan->T < 1 || plan->T > kLanes || n_x < 0 || n_x > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaGetDevice(&current);
  if (current != plan->device) cudaSetDevice(plan->device);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)plan->n_out * (plan->f64 ? 8 : 4), st);
  if (err == cudaSuccess)
    err = plan->f64 ? launch<double>(*plan, x, (int)n_x, out, ws, st)
                    : launch<float>(*plan, x, (int)n_x, out, ws, st);
  if (current != plan->device) cudaSetDevice(current);
  return (int)err;
}

extern "C" const char* sparsetpu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
