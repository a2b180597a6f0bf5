// Fused packed BatchNorm + tanh-GELU (+ StyleGAN noise) for Hopper (sm_90a):
// the training-mode forward and the coupled backward of the generator's
// packed-branch blocks (ops/bn_act.py).
//
// x is the packed (B, C, H, W) map, rows r = (b, h*w) and R = B*H*W rows. Per
// channel c, with T(.) a cast to x's dtype:
//   mean, var = E[x], E[x^2] - mean^2 over the rows (f32, biased, no clamp);
//   inv = rsqrt(var + 1e-5), isc = inv * scale, u = T((x - mean) * isc + bias);
//   out = T(gelu(u))                             (tanh form, in f32)
//   out = T(T(gelu(u)) + T(T(w) * n))            (noise fold: n = n_l for
//                                                  c < cl, n_g otherwise,
//                                                  (B, 1, H, W) maps);
// and in the backward, with g the cotangent of out, du = g * gelu'(u) and
// xhat = (x - mean) * inv:
//   S1 = sum du, S2 = sum du * xhat, S3 = sum g * n   (dbias, dscale, dw);
//   dx = T(isc * du + p + q * (x - mean)), p = (-isc * S1 + g_mean) / R,
//        q = (-isc * inv * S2 + 2 g_var) / R          (g_mean, g_var: the
//                                                  statistics' cotangents);
//   dn_l = T(sum_{c < cl} g * w), dn_g = T(sum_{c >= cl} g * w) per row.
//
// Replaces the Pallas kernels of fastfourierconvolution_tpu/ops/pallas/bn_act.py:
//   bn_stats_kernel        <- _stats_sums          (pallas_call at line 164)
//   bn_gelu_apply_kernel   <- _apply_bn_gelu       (197), _apply_bn_gelu_noise (406)
//   bn_bwd_reduce_kernel   <- _bwd_reduce          (241), _bwd_reduce_noise    (457)
//   bn_bwd_dx_kernel       <- _bwd_dx              (274), _bwd_dx_noise        (506)
// the noise variants by a compile-time flag. The TPU kernels carried their
// channel sums in VMEM across a sequential grid. Here the stats kernel sums
// each channel in one launch on a thread-block cluster (below); the reduce
// kernel writes one partial row per chunk of rows, and fu_reduce
// (fourier_unit_train.cu) sums them in a fixed order. Every launch gives the
// same bits (no float atomics).
//
// Layout: x, g, out, dx are NCHW, contiguous, float32 or bfloat16; n_l, n_g,
// dn_l, dn_g are (B, 1, H, W) in x's dtype; every per-channel vector is (C,)
// float32 (g_mean and g_var may be null for zero).
//
// Design of bn_stats (replaces _stats_sums, ops/pallas/bn_act.py:146-175).
// What bounds it on an H100 is bytes: one read of x (4.2-268 MB at the 128px
// generator's packed maps in bf16, 1.3-80 us at 3.35 TB/s) against 3
// operations per element. So one launch goes from x to (mean, var): one
// cluster of 1-8 blocks per channel (ops/bn_act.py, stats_design, a fixed
// rule: enough blocks to fill the card, at least 8192 elements each). Each
// block takes a contiguous range of the channel's (b, .) planes and reads
// them with 16-byte loads along h*w, several planes in flight per thread,
// with no division per element; where h*w*itemsize is no multiple of 16 or x
// is not 16-byte aligned it reads element by element. Sums in f32: per
// thread, then a warp-shuffle tree, the warps in order, and rank 0 adds the
// ranks' block sums over distributed shared memory in rank order and writes
// mean and var with fu_reduce's epilogue arithmetic.
//
// Reduce: one block per (chunk of kChunk rows, channel); each thread strides
// over the chunk's rows (coalesced within a (b, c) plane), then a
// warp-shuffle tree and a fixed-order sum over the warps give the block's
// partial. Apply and dx: one thread per row, looping over the
// channels of its half of the map (grid.y = 2: channels below `split`, and
// from `split` on; split = cl in the noise variants), so that neighbouring
// threads read neighbouring addresses of each plane, the row's noise value
// is loaded once and dn_l / dn_g stay in a register. The per-channel vectors
// (mean, isc, bias, p, q, w) sit in shared memory. The GELU and the apply's
// affine map are computed operation by operation with round-to-nearest
// intrinsics (no FMA contraction), in the plain version's order.
//
// What bounds them on an H100: bytes. At the 128px generator's packed maps
// in bf16 (64 x 512 x 8 x 8 up to 64 x 128 x 128 x 128, 4.2-268 MB) apply
// reads the map once and writes it, reduce reads x and g, dx
// reads x and g and writes dx: 1.3-160 us per launch at 3.35 TB/s, against
// about 20-40 operations per element (tanh included), far below 989 TFLOP/s.

#include "common.cuh"

namespace {

using namespace ffc;

constexpr float kEps = 1e-5f;
constexpr float kC1 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kC2 = 0.044715f;
constexpr int kChunk = 4096;  // rows per block of the stats and reduce kernels

// 0.5 u (1 + tanh(c1 (u + c2 u^3))), each operation rounded in the plain
// version's order.
__device__ __forceinline__ float gelu_tanh(float u) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(kC2, u), u), u);
  const float t = tanhf(__fmul_rn(kC1, __fadd_rn(u, cube)));
  return __fmul_rn(__fmul_rn(0.5f, u), __fadd_rn(1.f, t));
}

// d gelu_tanh / du in f32.
__device__ __forceinline__ float gelu_tanh_grad(float u) {
  const float t = tanhf(kC1 * (u + kC2 * u * u * u));
  return 0.5f * (1.f + t) + 0.5f * u * (1.f - t * t) * kC1 * (1.f + 3.f * kC2 * u * u);
}

// T((x - mean) * isc + bias) in f32.
template <typename T>
__device__ __forceinline__ float affine(float xv, float mean, float isc, float bias) {
  return round_to<T>(__fadd_rn(__fmul_rn(__fsub_rn(xv, mean), isc), bias));
}

// Offset of row r (= b * hw + p) of channel c.
__device__ __forceinline__ size_t at(long long r, int c, int C, int hw) {
  const long long b = r / hw;
  return static_cast<size_t>((b * C + c) * hw + (r - b * hw));
}

// Block-wide sums of N values in a fixed order; thread 0 gets the totals.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N]) {
  __shared__ float part[kWarps][N];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0)
    for (int i = 0; i < N; ++i) part[warp][i] = v[i];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < N; ++i) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += part[w][i];
      v[i] = s;
    }
}

__host__ __device__ long long chunks(long long rows) { return (rows + kChunk - 1) / kChunk; }

// Planes of a channel in flight per thread of bn_stats_kernel.
constexpr int kStatsUnroll = 4;

// The sum and the sum of squares of one unit of bn_stats_kernel's reads: the
// 16 bytes at p (kVec; 4 f32 or 8 bf16 values, summed pairwise) or the one
// value at p.
template <bool kVec>
__device__ __forceinline__ void unit_sums(const float* p, float& s, float& q) {
  if constexpr (kVec) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    s = (f.x + f.y) + (f.z + f.w);
    q = fmaf(f.x, f.x, f.y * f.y) + fmaf(f.z, f.z, f.w * f.w);
  } else {
    s = *p;
    q = s * s;
  }
}

template <bool kVec>
__device__ __forceinline__ void unit_sums(const __nv_bfloat16* p, float& s, float& q) {
  if constexpr (kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float2 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __bfloat1622float2(h[i]);
    s = ((v[0].x + v[0].y) + (v[1].x + v[1].y)) + ((v[2].x + v[2].y) + (v[3].x + v[3].y));
    float sq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sq[i] = fmaf(v[i].x, v[i].x, v[i].y * v[i].y);
    q = (sq[0] + sq[1]) + (sq[2] + sq[3]);
  } else {
    s = __bfloat162float(*p);
    q = s * s;
  }
}

// out: (2, C) f32, [mean | var]. Block blockIdx.x is rank (blockIdx.x mod
// cluster size) of channel blockIdx.x / cluster size. A thread reads unit
// j0, j0 + span, ... of planes first, first + step, ...; span is the least
// power of two that covers a plane's units (at most kThreads), so a warp
// reads consecutive 16-byte units of one or more planes.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ out, int B, int C, int hw) {
  constexpr int kPer = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;  // values per unit
  __shared__ float warp_part[kWarps][2];
  __shared__ float block_part[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / ranks;
  const int units = hw / kPer;
  int span = 1;
  while (span < units && span < kThreads) span <<= 1;
  const int step = kThreads / span;
  const int first = threadIdx.x / span, j0 = threadIdx.x % span;
  const int per_rank = (B + ranks - 1) / ranks;
  const int b0 = rank * per_rank;
  const int b1 = min(B, b0 + per_rank);
  const size_t stride = static_cast<size_t>(C) * hw;  // from plane (b, c) to (b + 1, c)
  const T* base = x + static_cast<size_t>(c) * hw;

  float s1 = 0.f, s2 = 0.f;
  for (int b = b0 + first; b < b1; b += step * kStatsUnroll) {
    for (int j = j0; j < units; j += span) {
      float s[kStatsUnroll], q[kStatsUnroll];
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        const int bu = b + u * step;
        s[u] = q[u] = 0.f;
        if (bu < b1) unit_sums<kVec>(base + bu * stride + static_cast<size_t>(j) * kPer, s[u], q[u]);
      }
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        s1 += s[u];
        s2 += q[u];
      }
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    warp_part[warp][0] = s1;
    warp_part[warp][1] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      t1 += warp_part[w][0];
      t2 += warp_part[w][1];
    }
    block_part[0] = t1;
    block_part[1] = t2;
  }
  cluster.sync();  // every rank's block sums are in its shared memory
  if (rank == 0 && threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < ranks; ++r) {
      const float* other = cluster.map_shared_rank(block_part, r);
      t1 += other[0];
      t2 += other[1];
    }
    moments(t1, t2, static_cast<float>(static_cast<long long>(B) * hw), out + c, out + C + c);
  }
  cluster.sync();  // no block leaves while rank 0 still reads its shared memory
}

template <typename T, bool kNoise>
__global__ void __launch_bounds__(kThreads)
bn_gelu_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                     const float* __restrict__ var, const float* __restrict__ scale,
                     const float* __restrict__ bias, const float* __restrict__ w,
                     const T* __restrict__ n_l, const T* __restrict__ n_g,
                     T* __restrict__ out, long long rows, int C, int hw, int split) {
  extern __shared__ float vec[];  // mean, isc, bias, T(w): 4C
  float *s_mean = vec, *s_isc = vec + C, *s_bias = vec + 2 * C, *s_w = vec + 3 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    s_mean[c] = mean[c];
    s_isc[c] = __fmul_rn(rsqrtf(__fadd_rn(var[c], kEps)), scale[c]);
    s_bias[c] = bias[c];
    if (kNoise) s_w[c] = round_to<T>(w[c]);
  }
  __syncthreads();
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  const bool upper = blockIdx.y == 1;
  const int c0 = upper ? split : 0, c1 = upper ? C : split;
  const float n = kNoise ? load_f32((upper ? n_g : n_l) + r) : 0.f;
  const size_t base = at(r, 0, C, hw);
  for (int c = c0; c < c1; ++c) {
    const size_t i = base + static_cast<size_t>(c) * hw;
    const float u = affine<T>(load_f32(x + i), s_mean[c], s_isc[c], s_bias[c]);
    float y = round_to<T>(gelu_tanh(u));
    if (kNoise) y = __fadd_rn(y, round_to<T>(__fmul_rn(s_w[c], n)));
    store_f32(out + i, y);
  }
}

// partial: (chunks, N*C), rows [S1 (C) | S2 (C) (| S3 (C))].
template <typename T, bool kNoise>
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ mean, const float* __restrict__ var,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const T* __restrict__ n_l, const T* __restrict__ n_g, int cl,
                     float* __restrict__ partial, long long rows, int C, int hw) {
  constexpr int N = kNoise ? 3 : 2;
  const int c = blockIdx.y;
  const float m = mean[c], inv = rsqrtf(__fadd_rn(var[c], kEps));
  const float isc = __fmul_rn(inv, scale[c]), b = bias[c];
  const T* n_sel = c >= cl ? n_g : n_l;
  const long long r0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long r1 = r0 + kChunk < rows ? r0 + kChunk : rows;
  float v[N] = {};
  for (long long r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const size_t i = at(r, c, C, hw);
    const float xv = load_f32(x + i), gv = load_f32(g + i);
    const float xm = __fsub_rn(xv, m);
    const float du = gv * gelu_tanh_grad(affine<T>(xv, m, isc, b));
    v[0] += du;
    v[1] = fmaf(du, xm * inv, v[1]);
    if constexpr (kNoise) v[2] = fmaf(gv, load_f32(n_sel + r), v[2]);
  }
  block_sum(v);
  if (threadIdx.x == 0) {
    float* row = partial + static_cast<size_t>(blockIdx.x) * N * C;
    for (int k = 0; k < N; ++k) row[k * C + c] = v[k];
  }
}

template <typename T, bool kNoise>
__global__ void __launch_bounds__(kThreads)
bn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ mean, const float* __restrict__ var,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 const float* __restrict__ s1, const float* __restrict__ s2,
                 const float* __restrict__ g_mean, const float* __restrict__ g_var,
                 const float* __restrict__ w, T* __restrict__ dx, T* __restrict__ dn_l,
                 T* __restrict__ dn_g, long long rows, int C, int hw, int split) {
  extern __shared__ float vec[];  // mean, isc, bias, p, q, w: 6C
  float *s_mean = vec, *s_isc = vec + C, *s_bias = vec + 2 * C, *s_p = vec + 3 * C,
        *s_q = vec + 4 * C, *s_w = vec + 5 * C;
  const float count = static_cast<float>(rows);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float inv = rsqrtf(__fadd_rn(var[c], kEps)), isc = __fmul_rn(inv, scale[c]);
    s_mean[c] = mean[c];
    s_isc[c] = isc;
    s_bias[c] = bias[c];
    s_p[c] = (-isc * s1[c] + (g_mean ? g_mean[c] : 0.f)) / count;
    s_q[c] = (-isc * inv * s2[c] + 2.f * (g_var ? g_var[c] : 0.f)) / count;
    if (kNoise) s_w[c] = w[c];
  }
  __syncthreads();
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  const bool upper = blockIdx.y == 1;
  const int c0 = upper ? split : 0, c1 = upper ? C : split;
  const size_t base = at(r, 0, C, hw);
  float dn = 0.f;
  for (int c = c0; c < c1; ++c) {
    const size_t i = base + static_cast<size_t>(c) * hw;
    const float xv = load_f32(x + i), gv = load_f32(g + i);
    const float xm = __fsub_rn(xv, s_mean[c]);
    const float du = gv * gelu_tanh_grad(affine<T>(xv, s_mean[c], s_isc[c], s_bias[c]));
    store_f32(dx + i, s_isc[c] * du + s_p[c] + s_q[c] * xm);
    if (kNoise) dn = fmaf(gv, s_w[c], dn);
  }
  if (kNoise) store_f32((upper ? dn_g : dn_l) + r, dn);
}

bool bad_dims(long long rows, int C, int hw, int split) {
  return rows <= 0 || C <= 0 || hw <= 0 || split < 0 || split > C;
}

dim3 row_grid(long long rows) { return dim3(static_cast<unsigned>((rows + kThreads - 1) / kThreads), 2); }

}  // namespace

extern "C" {

// Rows of the partial sums that ffc_bn_bwd_reduce writes.
long long ffc_bn_chunks(long long rows) { return chunks(rows); }

// dtype: 0 = float32, 1 = bfloat16. x: (B, C, hw); out: (2, C) float32, [mean
// | var]. vec: 1 for 16-byte loads (hw * itemsize a multiple of 16, x
// 16-byte aligned), 0 for loads of one value; cluster: the blocks of a
// channel's cluster, 1, 2, 4 or 8. Each entry point returns a cudaError_t (0
// on success), a refused cluster launch included.
int ffc_bn_stats(int dtype, const void* x, float* out, int B, int C, int hw, int vec,
                 int cluster, void* stream) {
  if (B <= 0 || C <= 0 || hw <= 0 || !cluster_size_ok(cluster)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<2>(dtype, vec, [&](auto tag, auto flag) {
    using T = typename decltype(tag)::type;
    constexpr bool kVec = decltype(flag)::value == 1;
    if (kVec && (static_cast<size_t>(hw) * sizeof(T) % 16 != 0 ||
                 reinterpret_cast<size_t>(x) % 16 != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_clustered(bn_stats_kernel<T, kVec>, static_cast<unsigned>(C) * cluster,
                            cluster, s, static_cast<const T*>(x), out, B, C, hw);
  });
}

// noise: 0 or 1 (then w, n_l and n_g are given and split = cl).
int ffc_bn_gelu_apply(int dtype, int noise, const void* x, const float* mean,
                      const float* var, const float* scale, const float* bias,
                      const float* w, const void* n_l, const void* n_g, void* out,
                      long long rows, int C, int hw, int split, void* stream) {
  if (bad_dims(rows, C, hw, split)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 4 * static_cast<size_t>(C) * sizeof(float);
  return dispatch<2>(dtype, noise, [&](auto tag, auto flag) {
    using T = typename decltype(tag)::type;
    bn_gelu_apply_kernel<T, decltype(flag)::value == 1><<<row_grid(rows), kThreads, smem, s>>>(
        static_cast<const T*>(x), mean, var, scale, bias, w, static_cast<const T*>(n_l),
        static_cast<const T*>(n_g), static_cast<T*>(out), rows, C, hw, split);
    return static_cast<int>(cudaGetLastError());
  });
}

// partial: (ffc_bn_chunks(rows), (2 + noise) * C) float32.
int ffc_bn_bwd_reduce(int dtype, int noise, const void* x, const void* g,
                      const float* mean, const float* var, const float* scale,
                      const float* bias, const void* n_l, const void* n_g, int cl,
                      float* partial, long long rows, int C, int hw, void* stream) {
  if (bad_dims(rows, C, hw, cl)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<2>(dtype, noise, [&](auto tag, auto flag) {
    using T = typename decltype(tag)::type;
    bn_bwd_reduce_kernel<T, decltype(flag)::value == 1>
        <<<dim3(static_cast<unsigned>(chunks(rows)), C), kThreads, 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(g), mean, var, scale, bias,
            static_cast<const T*>(n_l), static_cast<const T*>(n_g), cl, partial, rows, C,
            hw);
    return static_cast<int>(cudaGetLastError());
  });
}

// s1, s2: the reduced sums of ffc_bn_bwd_reduce; g_mean, g_var: (C,) or null
// for zero; with noise, w is given, split = cl and dn_l, dn_g are written.
int ffc_bn_bwd_dx(int dtype, int noise, const void* x, const void* g, const float* mean,
                  const float* var, const float* scale, const float* bias,
                  const float* s1, const float* s2, const float* g_mean,
                  const float* g_var, const float* w, void* dx, void* dn_l, void* dn_g,
                  long long rows, int C, int hw, int split, void* stream) {
  if (bad_dims(rows, C, hw, split)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 6 * static_cast<size_t>(C) * sizeof(float);
  return dispatch<2>(dtype, noise, [&](auto tag, auto flag) {
    using T = typename decltype(tag)::type;
    bn_bwd_dx_kernel<T, decltype(flag)::value == 1><<<row_grid(rows), kThreads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), mean, var, scale, bias, s1, s2,
        g_mean, g_var, w, static_cast<T*>(dx), static_cast<T*>(dn_l),
        static_cast<T*>(dn_g), rows, C, hw, split);
    return static_cast<int>(cudaGetLastError());
  });
}

const char* ffc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
