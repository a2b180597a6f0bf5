// Device and host helpers shared by every kernel library of the port: dtype
// conversion, a fixed-order warp sum, and the dispatch from a runtime dtype
// code (0 = float32, 1 = bfloat16) and a 0/1 variant code (a buffer layout, a
// noise flag) to a kernel template's instantiation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace ffc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to T and back: a cast to the working dtype inside f32 code.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// Sum over the 32 lanes of a warp, in a fixed order; lane 0 gets the total.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(Tag<T>(), std::integral_constant<int, V>()) for the element type
// of dtype code `dtype` and a variant V in [0, n_variants), n_variants 1 or 2;
// returns what f returns (a cudaError_t), or cudaErrorInvalidValue for an
// unknown code.
template <int n_variants, typename F>
int dispatch(int dtype, int variant, F f) {
  static_assert(n_variants == 1 || n_variants == 2);
  auto by_variant = [&](auto tag) -> int {
    if (variant == 0) return f(tag, std::integral_constant<int, 0>());
    if constexpr (n_variants == 2) {
      if (variant == 1) return f(tag, std::integral_constant<int, 1>());
    }
    return cudaErrorInvalidValue;
  };
  if (dtype == 0) return by_variant(Tag<float>());
  if (dtype == 1) return by_variant(Tag<__nv_bfloat16>());
  return cudaErrorInvalidValue;
}

}  // namespace ffc
