// Fused resident-x SpMM for Hopper (sm_90a): Y = A @ X on the fused pack,
// for X with k columns.
//
// Replaces the TPU kernel sparsetpu/kernels/spmv_fused.py:_fused_spmm_kernel
// (launched by _fused_spmm_blocks through pl.pallas_call): _fused_kernel
// with k planes.  It computes the same three phases on the same packed
// streams as fused_spmv.cu, each slot's route, cell and value decoded once
// for every plane:
//
//   forward   prod[kk] = values[s, l] * X[col, kk],
//             col = (8 * tile_base[i, t] + cell(i1[s, j])) * 128 + j,
//             the Q sublanes of each chunk summed into scratch;
//   stage 1   (skipped when fin_direct) scratch2[f, l, kk] = sum_s
//             (c >= 0 ? scratch[c, j, kk] : 0), for fin1_cnt[i] tiles;
//   stage 2   out[8 * fin2_group[i, f] + s, l, kk] += (c >= 0 ? src[c, j,
//             kk] : 0) into the slab step_slab[i], for fin2_cnt[i] tiles;
//
// and, in the same launch, the spills: out[spill_pos[e], kk] +=
// spill_val[e] * X[spill_col[e], kk].  X is read unpadded: a row at or past
// n_x reads 0.  Layout: X is row-major (n_x, k), so the k values a slot
// gathers are contiguous (one 32-byte sector at k = 8); out is row-major
// (n_slabs * OBp * 128, k), so Y is a slice of it; the scratch planes are
// row-major too, [(row * 128 + lane) * k + kk].
//
// What bounds it on the card: the packed streams, read once for all k
// planes (6 B a forward slot, 2 B a live finish slot), X read once and the
// slab blocks written once, the one-pass bound.  Beside it, the gathers of
// X's rows: k * 4 B for every forward slot, from the L2, where the k planes
// stay resident (the wrapper routes past half the L2 to the classic
// k-plane route).
//
// Design: fused_spmv.cu's, with plane vectors.
//   * One block of 1024 threads a step, in groups of 128 (a thread a lane)
//     that stage their tiles' int8 metadata in a ring of shared memory by
//     bulk copies (an mbarrier a slot), the tile's values prefetched into
//     the L2 by the same copy and read once past L1; the group's forward
//     tiles, then its stage-1 and stage-2 tiles, in one sequence.
//   * Each thread decodes its 8 slots (x row, value) once, then sweeps the
//     planes kPlanes at a time in registers: a slot's X values are
//     gathered as W-float vectors (float4 where k and the buffers'
//     alignment allow, else float2 or float: csrc/vec.cuh), through L1.
//   * The chunk sums and stage-1 partials live in a global workspace, one
//     (T*P + F1S) x 128 x k plane a step, which the caller allocates for
//     each call on the call's stream; shared memory holds only the ring,
//     and L1 the X gathers.  (Measured on the card and dropped: the
//     scratch in shared memory, kg = 2 planes a block, 1.8-2.2x slower;
//     a thread a plane vector instead of a lane, no faster at W = 4 and
//     2, 1.3x slower at W = 1; PERF.md section 6.)
//   * Stage 2 and the spills add W-float vectors into the zeroed output
//     (vector reductions on sm_90).
//   * One launch a call: the C entry zeroes the output (cudaMemsetAsync)
//     and launches n_steps steps plus ceil(n_spills / 1024) spill blocks.
// Sums: each chunk and each stage-1 cell adds its terms in sublane order,
// as the TPU kernel does; the order in which steps and spills reach a
// shared output row is not fixed, so results differ from the plain
// PyTorch version in the order of adds only (compared at rtol 1e-5, atol
// 1e-5 * max(1, max|Y|)).  Every offset that can pass 2^31 is 64-bit.

#include "fused_common.cuh"
#include "vec.cuh"

namespace {

using namespace fused;

constexpr int kRing = 2;        // tiles in flight a group of 128 threads
constexpr int kPlanes = 8;      // planes a thread sums at once
using L = Layout<kRing>;

template <int W> using V = Vec<float, W>;

// W values at p, plain loads (the workspace, written by this block)
template <int W>
__device__ __forceinline__ V<W> load_ws(const float* p) {
  V<W> x;
  x.raw = *reinterpret_cast<const typename VecType<float, W>::type*>(p);
  return x;
}

template <int W> __device__ __forceinline__ V<W> zero() {
  V<W> x;
#pragma unroll
  for (int e = 0; e < W; ++e) x.v[e] = 0.f;
  return x;
}

// out[0:W] += x, one vector reduction (sm_90 adds float2 and float4)
template <int W>
__device__ __forceinline__ void add_into(float* p, const V<W>& x) {
  if constexpr (W == 1) {
    atomicAdd(p, x.v[0]);
  } else {
    atomicAdd(reinterpret_cast<typename VecType<float, W>::type*>(p),
              x.raw);
  }
}

// ws: the call's workspace, n_steps planes of (T*P + F1S) x 128 x k
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
fused_spmm_kernel(const FusedPlan p, const float* __restrict__ X, int n_x,
                  int k, float* out, float* ws) {
  constexpr int NV = kPlanes / W;   // plane vectors in registers
  const int tid = threadIdx.x;

  // ---- spill blocks, past the steps
  if (blockIdx.x >= (unsigned)p.n_steps) {
    const long long e = (long long)(blockIdx.x - p.n_steps) * kThreads + tid;
    if (e < p.n_spills && p.spill_col[e] < n_x) {
      const float v = static_cast<const float*>(p.spill_val)[e];
      const float* xr = X + p.spill_col[e] * k;
      float* o = out + p.spill_pos[e] * k;
      for (int kk = 0; kk < k; kk += W) {
        V<W> xv = load_vec<float, W>(xr + kk);
#pragma unroll
        for (int u = 0; u < W; ++u) xv.v[u] *= v;
        add_into<W>(o + kk, xv);
      }
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  const int g = tid / kLanes;
  const int l = tid % kLanes;
  const bool lead = l == 0;
  const long long i = blockIdx.x;
  int8_t* ring_meta = reinterpret_cast<int8_t*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars) + g * kRing;
  int32_t* tb = reinterpret_cast<int32_t*>(smem + L::tb);  // x row bases
  const int Q = kChunk / p.P;
  const float* values = static_cast<const float*>(p.values);

  const int cnt1 = p.fin_direct ? 0 : (p.fin1_cnt ? p.fin1_cnt[i] : p.F1_max);
  const int cnt2 = p.fin2_cnt ? p.fin2_cnt[i] : p.F2_max;
  // the chunk sums, then scratch2: the step's plane of the workspace
  const int SR = p.T * p.P;
  float* scratch = ws + i * (SR + p.F1S) * kLanes * k;
  float* scratch2 = scratch + (size_t)SR * kLanes * k;
  auto share = [&](int n) {
    return n > g ? (n - g + kGroups - 1) / kGroups : 0;
  };
  const int nf = share(p.T), e1 = nf + share(cnt1), e2 = e1 + share(cnt2);

  auto issue = [&](int q) {
    const int slot = q % kRing;
    uint64_t* bar = bars + slot;
    int8_t* mi1 = ring_meta + (size_t)(g * kRing + slot) * 2 * kSlots;
    const int8_t* si1;
    const int8_t* srt;
    if (q < nf) {
      const long long tile = i * p.T + g + (long long)q * kGroups;
      prefetch_l2(values + tile * kSlots, kSlots * sizeof(float));
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
    for (int s = 0; s < kRing; ++s) bar_init(bars + s);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (lead)
    for (int q = 0; q < min(kRing, e2); ++q) issue(q);

  auto consume = [&](int q, auto fn) {
    const int slot = q % kRing;
    bar_wait(bars + slot, (q / kRing) & 1);
    const size_t s = (size_t)(g * kRing + slot);
    fn(ring_meta + s * 2 * kSlots, ring_meta + s * 2 * kSlots + kSlots);
    group_sync(g);
    if (lead && q + kRing < e2) issue(q + kRing);
  };

  // ---- forward: the step's tiles -> per-chunk sums, k planes
  for (int q = 0; q < nf; ++q) {
    const int t = g + q * kGroups;
    // this lane's values, from the L2 (prefetched with the tile's
    // metadata), in flight while the group waits for the metadata
    const float* vg = values + (i * p.T + t) * kSlots + l;
    float v[kChunk];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) v[s] = load_once(vg + s * kLanes);
    consume(q, [&](const int8_t* i1, const int8_t* rt) {
      const int xrow = tb[t];
      int xa[kChunk];                 // the slot's X row, -1: reads 0
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const int j = rt[s * kLanes + l] & 127;
        const int c = i1[s * kLanes + j];
        const int xi = (xrow + cell(c, p.GLW)) * kLanes + j;
        xa[s] = (unsigned)xi < (unsigned)n_x ? xi : -1;
      }
      for (int kc = 0; kc < k; kc += kPlanes) {
        V<W> acc[NV];
#pragma unroll
        for (int u = 0; u < NV; ++u) acc[u] = zero<W>();
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {
          if (xa[s] >= 0) {
            const float* xr = X + (size_t)xa[s] * k + kc;
#pragma unroll
            for (int u = 0; u < NV; ++u) {
              if (kc + u * W < k) {
                const V<W> xv = load_vec<float, W>(xr + u * W);
#pragma unroll
                for (int e = 0; e < W; ++e) acc[u].v[e] += v[s] * xv.v[e];
              }
            }
          }
          if ((s + 1) % Q == 0) {
            float* dst =
                scratch + ((size_t)(t * p.P + s / Q) * kLanes + l) * k + kc;
#pragma unroll
            for (int u = 0; u < NV; ++u) {
              if (kc + u * W < k) store_vec(dst + u * W, acc[u]);
              acc[u] = zero<W>();
            }
          }
        }
      }
    });
  }

  if (!p.fin_direct) {
    // rows stage 1 does not write are never addressed by a valid pack;
    // keep them defined all the same
    for (long long e = tid; e < (long long)(p.F1S - cnt1) * kLanes * k;
         e += kThreads)
      scratch2[(long long)cnt1 * kLanes * k + e] = 0.f;
  }
  __syncthreads();

  // ---- finish stage 1: each row's chunk sums -> one partial in scratch2
  if (!p.fin_direct) {
    const int SG = SR / kChunk;
    for (int q = nf; q < e1; ++q) {
      const int f = g + (q - nf) * kGroups;
      consume(q, [&](const int8_t* i1, const int8_t* rt) {
        int a[kChunk];                // the chunk sum's row, -1: drained
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {
          const int j = rt[s * kLanes + l] & 127;
          const int c = i1[s * kLanes + j];
          a[s] = c >= 0 ? cell(c, SG) * kLanes + j : -1;
        }
        float* dst = scratch2 + ((size_t)f * kLanes + l) * k;
        for (int kc = 0; kc < k; kc += kPlanes) {
          V<W> acc[NV];
#pragma unroll
          for (int u = 0; u < NV; ++u) acc[u] = zero<W>();
#pragma unroll
          for (int s = 0; s < kChunk; ++s) {
            if (a[s] >= 0) {
              const float* src = scratch + (size_t)a[s] * k + kc;
#pragma unroll
              for (int u = 0; u < NV; ++u) {
                if (kc + u * W < k) {
                  const V<W> x = load_ws<W>(src + u * W);
#pragma unroll
                  for (int e = 0; e < W; ++e) acc[u].v[e] += x.v[e];
                }
              }
            }
          }
#pragma unroll
          for (int u = 0; u < NV; ++u)
            if (kc + u * W < k) store_vec(dst + kc + u * W, acc[u]);
        }
      });
    }
    __syncthreads();
  }

  // ---- finish stage 2: partials -> aligned (8, 128) groups of the slab
  const float* src = p.fin_direct ? scratch : scratch2;
  const int S2G = (p.fin_direct ? SR : p.F1S) / kChunk;
  float* block = out + (long long)p.step_slab[i] * p.OBp * kLanes * k;
  for (int q = e1; q < e2; ++q) {
    const int f = g + (q - e1) * kGroups;
    const int grp = p.fin2_group[i * p.F2_max + f];
    consume(q, [&](const int8_t* i1, const int8_t* rt) {
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const int j = rt[s * kLanes + l] & 127;
        const int c = i1[s * kLanes + j];
        if (c >= 0) {
          const float* a = src + (size_t)(cell(c, S2G) * kLanes + j) * k;
          float* o = block + ((size_t)(grp * kChunk + s) * kLanes + l) * k;
          for (int kk = 0; kk < k; kk += W)
            add_into<W>(o + kk, load_ws<W>(a + kk));
        }
      }
    });
  }
}

template <int W>
cudaError_t launch(const FusedPlan& p, const float* X, int n_x, int k,
                   float* out, float* ws, cudaStream_t stream) {
  const int blocks = p.n_steps + (p.n_spills + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  fused_spmm_kernel<W><<<blocks, kThreads, L::total, stream>>>(p, X, n_x, k,
                                                             out, ws);
  return cudaGetLastError();
}

template <int W>
cudaError_t set_carveout(int pct) {
  return cudaFuncSetAttribute(fused_spmm_kernel<W>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              pct);
}

}  // namespace

// Once a plan: set each instance's shared memory carve-out (the least
// that holds the ring: L1 keeps the rest for the X gathers).
extern "C" int fused_spmm_prepare(const FusedPlan* plan) {
  if (plan->f64 || plan->T < 1 || plan->T > kLanes)
    return (int)cudaErrorInvalidValue;
  const int pct = carveout(L::total);
  cudaError_t err = set_carveout<1>(pct);
  if (err == cudaSuccess) err = set_carveout<2>(pct);
  if (err == cudaSuccess) err = set_carveout<4>(pct);
  return (int)err;
}

// A call: zero the n_out x k slab blocks and launch one kernel, on `stream`
// of the plan's device.  X holds n_x rows of k floats, row-major; W (1, 2
// or 4) divides k and the alignment (in floats) of X, out and ws; ws, this
// call's own, n_steps * (T*P + F1S) * 128 * k floats.
extern "C" int fused_spmm_run(const FusedPlan* plan, const void* X,
                              long long n_x, int k, int W, void* out,
                              void* ws, void* stream) {
  if (plan->f64 || plan->T < 1 || plan->T > kLanes || n_x < 0 ||
      n_x > INT32_MAX || k < 1 || !(W == 1 || W == 2 || W == 4) || k % W)
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaGetDevice(&current);
  if (current != plan->device) cudaSetDevice(plan->device);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)plan->n_out * k * sizeof(float), st);
  const float* x = static_cast<const float*>(X);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  if (err == cudaSuccess)
    err = W == 4   ? launch<4>(*plan, x, (int)n_x, k, o, w, st)
          : W == 2 ? launch<2>(*plan, x, (int)n_x, k, o, w, st)
                   : launch<1>(*plan, x, (int)n_x, k, o, w, st);
  if (current != plan->device) cudaSetDevice(current);
  return (int)err;
}
