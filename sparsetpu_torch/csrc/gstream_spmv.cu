// Classic GStream forward for Hopper (sm_90a): per-chunk partial sums of
// y = A @ x over a GStream pack (sparsetpu_torch/pack/gather_stream.py).
//
// Replaces three TPU kernels, each launched through pl.pallas_call:
//   sparsetpu/kernels/spmv_pallas.py:_spmv_kernel     (GL = 0, launched by
//       _gstream_chunk_sums): each step gathers over the G groups of its x
//       window (every classic device, every F level);
//   sparsetpu/kernels/spmv_pallas.py:_spmv_kernel_v2  (GL > 0, the same
//       launcher): each tile gathers over GL groups at its own base
//       tile_base[k] inside the window;
//   sparsetpu/kernels/f64emu.py:_df64_spmv_kernel     (f64, launched by
//       _df64_chunk_sums): the window scheme on the f64 device's pack, whose
//       TPU kernel carries values, x and sums as (hi, lo) float pairs with
//       TwoProd products and double-float add trees.
// The first two are one template, gstream_spmv_kernel, on kTileBase and
// the value type V (f32; bf16 in the bf16 value mode, widened to f32 before
// the multiply); x, the sums and the output are f32.  The third is its own
// kernel, live_slots_kernel, below: native FP64 over the pack's live slots
// only (entry point live_slots_f64_launch).
//
// Slot (s, l) of tile k, in step i = k / T, with the int16 meta stream
// meta = cell << 7 | route:
//   j    = meta[s, l] & 127                  route (lane of x)
//   c    = (meta[s, j] & 0x7FFF) >> 7        cell, read at the routed lane
//   row  = 8G * step_window[i] (+ 8 * tile_base[k]) + c
//   x    = (c >> 3) < G (GL) ? x2[row, j] : 0   (the select chain's where)
//   out[k * P + p, l] = sum over the Q = 8 / P sublanes of plane p of
//                       value[s, l] * x
// The wrapper checks on the host that every staged window lies inside x2
// (step_window, tile_base), so every address stays in its buffer.
//
// What bounds it on the card: the packed stream, read once: 4 B (f32) or
// 2 B (bf16) of value plus 2 B of meta per slot, and 4 B per output chunk
// sum written.  The second meta read hits the same 256-byte row the warp
// just loaded (L1), and the x gathers stay inside one window of at most
// 32768 columns (128 KB), which L2 holds.
//
// Design, simple first: nothing carries from one step to the next (the
// TPU walks steps in order only to pipeline its DMA), so each thread owns
// one lane of one tile and walks its 8 sublanes: a warp reads 128
// contiguous bytes of values and 64 of meta per sublane, thousands of
// blocks fill the card at full size, and the output is written, not
// accumulated (no atomics).  Each chunk sums its Q terms in sublane order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 8;
constexpr int kThreads = 256;
constexpr int kTilesPerBlock = kThreads / kLanes;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename V, bool kTileBase>
__global__ void __launch_bounds__(kThreads)
gstream_spmv_kernel(const V* __restrict__ values,
                    const int16_t* __restrict__ meta,
                    const int32_t* __restrict__ step_window,
                    const int32_t* __restrict__ tile_base,
                    const float* __restrict__ x2,
                    float* __restrict__ out,
                    long long n_tiles, int T, int G, int GL, int P) {
  const long long k =
      (long long)blockIdx.x * kTilesPerBlock + threadIdx.x / kLanes;
  if (k >= n_tiles) return;
  const int l = threadIdx.x % kLanes;
  const int groups = kTileBase ? GL : G;
  long long xbase = (long long)kChunk * G * step_window[k / T];
  if (kTileBase) xbase += (long long)kChunk * tile_base[k];
  const int Q = kChunk / P;
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < kChunk; ++s) {
    const long long row = (k * kChunk + s) * kLanes;
    const int j = meta[row + l] & 127;
    const int c = (meta[row + j] & 0x7FFF) >> 7;
    const float xv = (c >> 3) < groups ? x2[(xbase + c) * kLanes + j] : 0.f;
    sum += widen(values[row + l]) * xv;
    if ((s + 1) % Q == 0) {
      out[(k * P + s / Q) * kLanes + l] = sum;
      sum = 0.f;
    }
  }
}

template <typename V, bool kTileBase>
int launch(const void* values, const void* meta, const void* step_window,
           const void* tile_base, const void* x2, void* out,
           long long n_tiles, int T, int G, int GL, int P,
           cudaStream_t stream) {
  const long long blocks = (n_tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  gstream_spmv_kernel<V, kTileBase><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(
      (const V*)values, (const int16_t*)meta, (const int32_t*)step_window,
      (const int32_t*)tile_base, (const float*)x2, (float*)out, n_tiles,
      T, G, GL, P);
  return (int)cudaGetLastError();
}

// The f64 forward over the pack's live slots (TPU kernel #11, f64emu.py:
// _df64_spmv_kernel).  The f64 classic pack pins Q = 8 with no lane
// shuffle, as the reference does, and fills about a tenth of its slots, so
// reading it whole (10 B a slot) moves mostly padding.  The wrapper builds,
// once at upload, a CSR over the chunk positions the finish reads
// (kernels/spmv_gstream.py:LiveSlots): pos[r] a position, its live slots
// (a nonzero value whose x index the select chain keeps) in sublane order
// at rowptr[r]..rowptr[r + 1], each as its x index col and its value val.
//   out[pos[r]] = sum over its live slots of val * x[col]   (0 if none)
// Positions no one reads are not written.  What bounds it: 16 B a read
// position (pos, rowptr, the sum written) and 12 B a live slot, read once,
// x read once; the x gathers (8 B a live slot) hit the L2.  A thread a
// read position, consecutive threads on consecutive positions and entries;
// each sums in sublane order, as the TPU-form plain version does.
__global__ void __launch_bounds__(kThreads)
live_slots_kernel(const int32_t* __restrict__ pos,
                  const int32_t* __restrict__ rowptr,
                  const int32_t* __restrict__ col,
                  const double* __restrict__ val,
                  const double* __restrict__ x, double* __restrict__ out,
                  int n_read) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_read) return;
  const int end = rowptr[r + 1];
  double sum = 0.0;
  for (int e = rowptr[r]; e < end; ++e) sum += val[e] * __ldg(x + col[e]);
  out[pos[r]] = sum;
}

}  // namespace

// value_bf16: 0 for f32 values, 1 for bf16; GL = 0 takes the window kernel
// (tile_base unused), GL > 0 the per-tile-base kernel.
extern "C" int gstream_spmv_launch(const void* values, int value_bf16,
                                   const void* meta, const void* step_window,
                                   const void* tile_base, const void* x2,
                                   void* out, long long n_tiles, int T, int G,
                                   int GL, int P, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_bf16) {
    return GL ? launch<__nv_bfloat16, true>(values, meta, step_window,
                                            tile_base, x2, out, n_tiles, T,
                                            G, GL, P, s)
              : launch<__nv_bfloat16, false>(values, meta, step_window,
                                             tile_base, x2, out, n_tiles, T,
                                             G, GL, P, s);
  }
  return GL ? launch<float, true>(values, meta, step_window, tile_base, x2,
                                  out, n_tiles, T, G, GL, P, s)
            : launch<float, false>(values, meta, step_window, tile_base, x2,
                                   out, n_tiles, T, G, GL, P, s);
}

// f64 over the live slots: n_read positions of the CSR (pos, rowptr, col,
// val), x read at col (the wrapper checks every col lies inside x), the
// sums written to out at pos.
extern "C" int live_slots_f64_launch(const void* pos, const void* rowptr,
                                     const void* col, const void* val,
                                     const void* x, void* out, int n_read,
                                     void* stream) {
  if (n_read <= 0) return n_read < 0 ? (int)cudaErrorInvalidValue : 0;
  const unsigned blocks = (unsigned)((n_read + kThreads - 1) / kThreads);
  live_slots_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pos, (const int32_t*)rowptr, (const int32_t*)col,
      (const double*)val, (const double*)x, (double*)out, n_read);
  return (int)cudaGetLastError();
}
