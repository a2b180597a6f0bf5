// Device and host helpers shared by every kernel library of the port: dtype
// conversion, a fixed-order warp sum, the mean/variance epilogue of the batch
// reductions, a launch on a thread-block cluster, and the dispatch from a
// runtime dtype code (0 = float32, 1 = bfloat16) and a 0/1 variant code (a
// buffer layout, a noise flag) to a kernel template's instantiation.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace ffc {

namespace cg = cooperative_groups;

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

// The batch statistics from a sum s1 and a sum of squares s2 over n values:
// mean = s1 / n and the biased variance E[x^2] - mean^2 (no clamp at 0).
__device__ __forceinline__ void moments(float s1, float s2, float n, float* mean, float* var) {
  const float m = s1 / n;
  *mean = m;
  *var = s2 / n - m * m;
}

// Launches kernel<<<grid, kBlock, smem, stream>>>(args...) as clusters of
// `cluster` blocks along x (grid a multiple of it); returns the launch's
// cudaError_t, a refused cluster shape included, and clears it.
template <int kBlock = kThreads, typename... KernelArgs, typename... Args>
int launch_clustered(void (*kernel)(KernelArgs...), unsigned grid, unsigned cluster,
                     size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(kBlock);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&config, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

inline bool cluster_size_ok(int cluster) {
  return cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8;
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
