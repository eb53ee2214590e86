// The TPU's select-chain experiments for Hopper (sm_90a): one measurement
// kernel template, the function of every kernel of two TPU design
// experiments, launched through pl.pallas_call there:
//   scripts/exp_q.py:55 (chain@G,P), :89 (bigdual), :109 (k_base) and :164
//     (tilebase_variants), the forward's rate against (G, P) (-> :29, :135,
//     :203);
//   scripts/exp_r3.py:77 (chain16), :96 (tree16), :119 (hilo16), :182
//     (tb_res), :221 (tb_res2), :320 (tb_tree16), :341 (tb2_tree8) and
//     :403 (tb_tree16_i8), cheaper G = 16 select chains (-> :43, :160,
//     :206, :250, :305, :429).
//
// Over n_tiles (8, 128) f32 value tiles, a tile t, sublane s and lane l
// read the route j and the cell c at the routed lane (as take_along_axis
// twice reads them): fused int16 meta m = meta & 0x7FFF, j = m[8t+s, l] &
// 127, c = m[8t+s, j] >> 7; or split int8 meta, j = routes[8t+s, l] & 127,
// c = cells[8t+s, j] & 0xFF (the wrapper refuses a negative byte unless
// asked not to check).  With ``mod`` c becomes c % 8G (exp_q's i1 % 8G).
// The x row of the slot, read at lane j, is, for a window of G = 1 << lgG
// groups starting at row 8b:
//   kChain   G loads, group g at row 8b + 8g + (c & 7), each kept where c >>
//            3 == g, else 0: the TPU's select chain as the card pays for it;
//   kTree    the same G loads, merged in log2 G levels on the group's bits
//            (pair (2i, 2i + 1) of level k kept by bit k, streamed as a
//            binary counter): higher bits are ignored, so the row is 8b +
//            (c % 8G);
//   kDirect  one load at row 8b + c where c >> 3 < G, else 0: bigdual, the
//            G = 1 take and the single-group tile bases, the card's own
//            answer to the chain;
//   kHilo    x as int16 hi and lo planes (rows [0, 8G) and [8G, 16G) of
//            xw): over G/2 pairs of 16 rows two int16 loads a pair, each
//            kept where c >> 4 == pair, recombined as (hi << 16) | lo.
// b is 0 without bases, else a tile's base clamped into [0, x_rows/8 - G]
// (as Pallas clamps the window's dynamic slice).  With two bases a tile
// (base[2t], base[2t+1]) the range bit (c >> (3 + lgG)) != 0 picks the
// second window and c keeps its bits below it; kChain and kTree load both
// windows and select (the TPU's way), kDirect picks the base and loads once.
// out[tP + p, l] = sum over sublanes s in [pQ, (p+1)Q) of values[8t+s, l] *
// x, Q = 8 / P, added in sublane order.
//
// The loads of kChain, kTree and kHilo are volatile asm, so that nvcc
// neither merges them nor makes them conditional: their count is what the
// experiment asks about.
//
// What bounds it on the card: the streams, read once: 4 B of value a
// slot, 2 B of meta (two bytes split), 4 B a base, 4 B an output element,
// and the window (at most 512 KB, in L2 and L1).  The chains pay G L1
// reads a slot where kDirect pays one.  Design, simple first:
// micro_ladder.cu's map, 256 threads, a thread a lane, T tiles a block
// (the scripts' 128), two at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 8;
constexpr int kThreads = 256;
constexpr int kTilesPerPass = kThreads / kLanes;
constexpr int kMaxLgG = 5;
constexpr int kMaxG = 1 << kMaxLgG;

enum Form { kChain = 0, kTree = 1, kDirect = 2, kHilo = 3 };

__device__ __forceinline__ float load_f32(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned load_u16(const int16_t* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}

// x of cell c (in [0, 256)) at lane j, from the window of 1 << lgG groups
// whose first row is xrow, by the form's mechanism and with its reach
template <int kForm>
__device__ __forceinline__ float window_x(const void* xw, long long xrow,
                                          int c, int j, int lgG,
                                          int plane_rows) {
  const int G = 1 << lgG;
  const int grp = c >> 3;
  const int sub = c & 7;
  if constexpr (kForm == kDirect) {
    return grp < G ? __ldg((const float*)xw + (xrow + c) * kLanes + j)
                   : 0.f;
  } else if constexpr (kForm == kChain) {
    const float* x0 = (const float*)xw + (xrow + sub) * kLanes + j;
    float x = 0.f;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float part = load_f32(x0 + g * kChunk * kLanes);
      x = grp == g ? part : x;
    }
    return x;
  } else if constexpr (kForm == kTree) {
    // the TPU's level-by-level merge, streamed as a binary counter: part g
    // merges with the waiting left siblings of its trailing one bits, the
    // pair at level k kept by bit k of the group, so at most lgG + 1
    // values wait (wait[k]: a merged run of 2^k parts)
    const float* x0 = (const float*)xw + (xrow + sub) * kLanes + j;
    float wait[kMaxLgG + 1];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float v = load_f32(x0 + g * kChunk * kLanes);
      int k = 0;
#pragma unroll
      for (; k < kMaxLgG && ((g >> k) & 1); ++k)
        v = ((grp >> k) & 1) ? v : wait[k];
      wait[k] = v;
    }
    float x = wait[0];
#pragma unroll
    for (int k = 1; k <= kMaxLgG; ++k) x = k == lgG ? wait[k] : x;
    return x;
  } else {
    const int16_t* hi0 =
        (const int16_t*)xw + (long long)(c & 15) * kLanes + j;
    const int16_t* lo0 = hi0 + (long long)plane_rows * kLanes;
    const int pair = c >> 4;
    unsigned hi = 0, lo = 0;
#pragma unroll
    for (int p = 0; p < kMaxG / 2; ++p) {
      if (2 * p >= G) break;
      const unsigned h = load_u16(hi0 + p * 16 * kLanes);
      const unsigned w = load_u16(lo0 + p * 16 * kLanes);
      hi = pair == p ? h : hi;
      lo = pair == p ? w : lo;
    }
    return __uint_as_float((hi << 16) | lo);
  }
}

template <int kForm, bool kSplit>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ values,
              const int16_t* __restrict__ meta,
              const int8_t* __restrict__ cells,
              const int8_t* __restrict__ routes,
              const int32_t* __restrict__ base, const void* __restrict__ xw,
              float* __restrict__ out, long long n_tiles, int T, int lgG,
              int P, int n_bases, int mod, int top, int plane_rows) {
  const int span = kChunk << lgG;           // 8G: the cells of a window
  const int Q = kChunk / P;
  const int l = threadIdx.x % kLanes;
  const long long first = (long long)blockIdx.x * T;
  for (int tt = threadIdx.x / kLanes; tt < T; tt += kTilesPerPass) {
    const long long t = first + tt;
    if (t >= n_tiles) break;
    long long xrow0 = 0, xrow1 = 0;
    if (n_bases > 0)
      xrow0 = (long long)kChunk * min(max(base[t * n_bases], 0), top);
    if (n_bases > 1)
      xrow1 = (long long)kChunk * min(max(base[t * 2 + 1], 0), top);
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const long long row = (t * kChunk + s) * kLanes;
      int j, c;
      if constexpr (kSplit) {
        j = routes[row + l] & 127;
        c = cells[row + j] & 0xFF;
      } else {
        j = meta[row + l] & 0x7F;
        c = (meta[row + j] & 0x7FFF) >> 7;
      }
      if (mod) c &= span - 1;
      float x;
      if (n_bases < 2) {
        x = window_x<kForm>(xw, xrow0, c, j, lgG, plane_rows);
      } else {
        const bool far = (c >> (lgG + 3)) != 0;
        c &= span - 1;
        if constexpr (kForm == kDirect) {
          x = window_x<kForm>(xw, far ? xrow1 : xrow0, c, j, lgG,
                              plane_rows);
        } else {
          const float xa = window_x<kForm>(xw, xrow0, c, j, lgG, plane_rows);
          const float xb = window_x<kForm>(xw, xrow1, c, j, lgG, plane_rows);
          x = far ? xb : xa;
        }
      }
      sum += values[row + l] * x;
      if ((s + 1) % Q == 0) {
        out[(t * P + s / Q) * kLanes + l] = sum;
        sum = 0.f;
      }
    }
  }
}

template <int kForm, bool kSplit>
int launch(const void* values, const void* meta, const void* cells,
           const void* routes, const void* base, const void* xw, void* out,
           long long n_tiles, int T, int lgG, int P, int n_bases, int mod,
           int top, int plane_rows, cudaStream_t stream) {
  const long long blocks = (n_tiles + T - 1) / T;
  select_kernel<kForm, kSplit><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const float*)values, (const int16_t*)meta, (const int8_t*)cells,
      (const int8_t*)routes, (const int32_t*)base, xw, (float*)out, n_tiles,
      T, lgG, P, n_bases, mod, top, plane_rows);
  return (int)cudaGetLastError();
}

template <int kForm>
int launch_meta(int split, const void* values, const void* meta,
                const void* cells, const void* routes, const void* base,
                const void* xw, void* out, long long n_tiles, int T, int lgG,
                int P, int n_bases, int mod, int top, int plane_rows,
                cudaStream_t stream) {
  if (split)
    return launch<kForm, true>(values, meta, cells, routes, base, xw, out,
                               n_tiles, T, lgG, P, n_bases, mod, top,
                               plane_rows, stream);
  return launch<kForm, false>(values, meta, cells, routes, base, xw, out,
                              n_tiles, T, lgG, P, n_bases, mod, top,
                              plane_rows, stream);
}

}  // namespace

// form: 0 chain, 1 tree, 2 direct, 3 hilo; split: meta as two int8
// streams (cells, routes) rather than one int16 stream; G = 1 << lgG
// window groups; P output planes a tile; n_bases 0, 1 or 2 a tile; mod:
// c % 8G first; x_rows: xw's rows (for hilo its two int16 planes of 8G
// rows each).  The wrapper checks shapes and dtypes.
extern "C" int select_chains_launch(int form, int split, const void* values,
                                    const void* meta, const void* cells,
                                    const void* routes, const void* base,
                                    const void* xw, void* out,
                                    long long n_tiles, int T, int lgG, int P,
                                    int n_bases, int mod, int x_rows,
                                    void* stream) {
  const int G = 1 << lgG;
  if (lgG < 0 || lgG > kMaxLgG || T < 1 || n_bases < 0 || n_bases > 2 ||
      (P != 1 && P != 2 && P != 4 && P != 8) || x_rows % kChunk ||
      x_rows < kChunk * G)
    return (int)cudaErrorInvalidValue;
  if (form == kHilo && (lgG < 1 || n_bases || x_rows != 2 * kChunk * G))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const int top = x_rows / kChunk - G;
  const int plane_rows = x_rows / 2;
  cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case kChain:
      return launch_meta<kChain>(split, values, meta, cells, routes, base,
                                 xw, out, n_tiles, T, lgG, P, n_bases, mod,
                                 top, plane_rows, s);
    case kTree:
      return launch_meta<kTree>(split, values, meta, cells, routes, base, xw,
                                out, n_tiles, T, lgG, P, n_bases, mod, top,
                                plane_rows, s);
    case kDirect:
      return launch_meta<kDirect>(split, values, meta, cells, routes, base,
                                  xw, out, n_tiles, T, lgG, P, n_bases, mod,
                                  top, plane_rows, s);
    case kHilo:
      return launch_meta<kHilo>(split, values, meta, cells, routes, base, xw,
                                out, n_tiles, T, lgG, P, n_bases, mod, top,
                                plane_rows, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
