// W consecutive values of type R moved by one load or store: float4,
// float2 or float, and double2 or double (16, 8 or 4/8 bytes).  Shared by
// the k-plane kernels (gstream_spmm.cu, final_rows.cu), whose threads each
// own W of a row's k values.  The caller keeps every address a multiple of
// W values: the wrappers pick W from k and the buffers' alignment
// (kernels/_build.py:vector_width).
#pragma once

#include <cuda_runtime.h>

template <typename R, int W> struct VecType;
template <> struct VecType<float, 1> { using type = float; };
template <> struct VecType<float, 2> { using type = float2; };
template <> struct VecType<float, 4> { using type = float4; };
template <> struct VecType<double, 1> { using type = double; };
template <> struct VecType<double, 2> { using type = double2; };

template <typename R, int W>
union Vec {
  typename VecType<R, W>::type raw;
  R v[W];
};

// one load through the read-only path
template <typename R, int W>
__device__ __forceinline__ Vec<R, W> load_vec(const R* p) {
  Vec<R, W> x;
  x.raw = __ldg(reinterpret_cast<const typename VecType<R, W>::type*>(p));
  return x;
}

template <typename R, int W>
__device__ __forceinline__ void store_vec(R* p, const Vec<R, W>& x) {
  *reinterpret_cast<typename VecType<R, W>::type*>(p) = x.raw;
}
