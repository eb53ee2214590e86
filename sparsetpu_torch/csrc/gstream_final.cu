// Final level of the classic GStream device for Hopper (sm_90a): the
// chunk partial sums (the position vector, x2 below) -> y, where output
// cell (r / 128, r % 128) IS y[r].
//
// Replaces three TPU kernels, each launched through pl.pallas_call:
//   sparsetpu/kernels/spmv_pallas.py:_final_kernel     (legacy, launched by
//       _final_gather_sums): per instance <= nw windows of 8G rows at
//       step-level bases;
//   sparsetpu/kernels/spmv_pallas.py:_final_kernel_v2  (flat, launched by
//       _final_gather_sums_v2): per instance and out tile, nwin sub-windows
//       of GL_f groups at per-(tile, window) bases inside staged blocks of
//       GS groups;
//   sparsetpu/kernels/f64emu.py:_df64_final_kernel     (f64 legacy,
//       launched by _df64_final_sums): the legacy scheme on (hi, lo) float
//       pairs with double-float adds across instances.
// One template covers all three: kV2, and the real type R of the
// positions, the sums and y (float; double for the f64 device, whose adds
// are then native FP64: entry point gstream_final_f64_launch, legacy
// scheme only, as the TPU's df64 final).  G below is G for the legacy scheme and
// GL_f for the flat one; nw is nw or nwin (already the doubled count).
//
// Slot (s, l) of out tile t in instance i, cell c = cells[s, j] (int16)
// read at the route j = route[s, l] (int8, its own stream here):
//   w    = (c >> 3) / G                     window of the cell
//   row  = legacy: 8G * step_meta[i, w] + 8 * ((c >> 3) % G) + (c & 7)
//          flat:   8 * GS * step_meta[i, w] + 8 * tile_bases[i, t*nw + w]
//                  + 8 * ((c >> 3) % G) + (c & 7)
//   a cell at or beyond nw * G (the drain), or below 0, reads 0;
//   part[t, l] = sum over the 8 sublanes of x2[row, j].
// y tile o * tps + t is the sum of part over the instances of out block o,
// in their order: the first writes, later ones add (the TPU keeps the out
// block resident across its consecutive instances).  The wrapper hands the
// instance range of each block (inst_start, from the sorted step_meta) and
// checks every window against x2's rows on the host.
//
// What bounds it on the card: the cell (2 B) and route (1 B) streams, 3 B
// per slot of every instance, read once, plus 4 B (8 B in f64) per y
// element written;
// the position-vector gathers land in windows the builder chose to be
// local, which L2 holds.
//
// Design, simple first: one thread per lane of one out tile loops over its
// block's instances, so the summation order is the TPU's, each y element is
// written once, and nothing needs atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 8;
constexpr int kThreads = 256;
constexpr int kTilesPerBlock = kThreads / kLanes;

template <bool kV2, typename R>
__global__ void __launch_bounds__(kThreads)
gstream_final_kernel(const int32_t* __restrict__ step_meta,
                     const int32_t* __restrict__ tile_bases,
                     const int32_t* __restrict__ inst_start,
                     const R* __restrict__ x2,
                     const int16_t* __restrict__ cells,
                     const int8_t* __restrict__ route,
                     R* __restrict__ out, long long nt_pad, int tps,
                     int G, int nw, int GS) {
  const long long ot =
      (long long)blockIdx.x * kTilesPerBlock + threadIdx.x / kLanes;
  if (ot >= nt_pad) return;
  const int l = threadIdx.x % kLanes;
  const long long o = ot / tps;
  const int t = (int)(ot % tps);
  const int first = inst_start[o];
  const int last = inst_start[o + 1];
  R total = 0;
  for (int i = first; i < last; ++i) {
    const int32_t* sm = step_meta + (long long)i * (nw + 2);
    const long long tile = (long long)i * tps + t;
    R part = 0;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const long long row = (tile * kChunk + s) * kLanes;
      const int j = route[row + l] & 127;
      const int c = cells[row + j];
      const int grp = c >> 3;
      const int w = grp / G;
      if (grp >= 0 && w < nw) {
        long long xrow = (long long)kChunk * (grp - w * G) + (c & 7);
        if (kV2)
          xrow += (long long)kChunk * GS * sm[w] +
                  (long long)kChunk * tile_bases[tile * nw + w];
        else
          xrow += (long long)kChunk * G * sm[w];
        part += x2[xrow * kLanes + j];
      }
    }
    total = i == first ? part : total + part;
  }
  out[ot * kLanes + l] = total;
}

}  // namespace

// v2: 0 for the legacy scheme (tile_bases unused, GS ignored), 1 for flat.
extern "C" int gstream_final_launch(int v2, const void* step_meta,
                                    const void* tile_bases,
                                    const void* inst_start, const void* x2,
                                    const void* cells, const void* route,
                                    void* out, long long nt_pad, int tps,
                                    int G, int nw, int GS, void* stream) {
  if (nt_pad == 0) return 0;
  const long long blocks = (nt_pad + kTilesPerBlock - 1) / kTilesPerBlock;
  cudaStream_t s = (cudaStream_t)stream;
  if (v2)
    gstream_final_kernel<true, float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)step_meta, (const int32_t*)tile_bases,
        (const int32_t*)inst_start, (const float*)x2, (const int16_t*)cells,
        (const int8_t*)route, (float*)out, nt_pad, tps, G, nw, GS);
  else
    gstream_final_kernel<false, float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)step_meta, (const int32_t*)tile_bases,
        (const int32_t*)inst_start, (const float*)x2, (const int16_t*)cells,
        (const int8_t*)route, (float*)out, nt_pad, tps, G, nw, GS);
  return (int)cudaGetLastError();
}

// f64: double positions and y, legacy scheme (step-level window bases).
extern "C" int gstream_final_f64_launch(const void* step_meta,
                                        const void* inst_start,
                                        const void* x2, const void* cells,
                                        const void* route, void* out,
                                        long long nt_pad, int tps, int G,
                                        int nw, void* stream) {
  if (nt_pad == 0) return 0;
  const long long blocks = (nt_pad + kTilesPerBlock - 1) / kTilesPerBlock;
  gstream_final_kernel<false, double>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const int32_t*)step_meta, nullptr, (const int32_t*)inst_start,
          (const double*)x2, (const int16_t*)cells, (const int8_t*)route,
          (double*)out, nt_pad, tps, G, nw, 0);
  return (int)cudaGetLastError();
}
