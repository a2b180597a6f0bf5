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
// channel sums in VMEM across a sequential grid. Here the stats and the
// backward reduce kernels sum each channel in one launch on a thread-block
// cluster (below) and write the final sums. Every launch gives the same bits
// (no float atomics).
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
// Design of bn_bwd_reduce (replaces _bwd_reduce and _bwd_reduce_noise,
// ops/pallas/bn_act.py:212-250, 417-466). It reads x and g (and the channel's
// noise map) once and writes (2 + noise) x C floats: 8.4-537 MB at the packed
// maps in bf16, 2.5-160 us at 3.35 TB/s. Once no division is left in the
// element loop, bytes bound it; the next cost is issue, about 45 instructions
// per element with tanhf's, which at the largest map comes close to the
// bytes' time on 132 SMs. The design is bn_stats's: one cluster of 1-8 blocks
// per channel (bwd_reduce_design: bn_stats's rule with half its elements per
// block, since each element brings two maps' bytes); each block reads a
// contiguous range of the channel's planes as 16-byte units of x and g, and
// with the noise fold the unit of n_sel (n_l below cl, n_g from cl on) at the
// same plane offset, two planes in flight per thread; the plane and the
// offset come from the loop, not from a division. S1, S2 (and S3) are summed
// in f32 in bn_stats's order and rank 0 writes them straight into the output:
// no partial rows, no second launch. Planes that are no multiple of 16 bytes,
// or an unaligned map, take loads of one value.
//
// Design of bn_gelu_apply (replaces _apply_bn_gelu and _apply_bn_gelu_noise,
// ops/pallas/bn_act.py:178-209, 372-415). Bytes bound it: one read of x and
// one write of out, 8.4-537 MB, 2.5-160 us, against about 40 instructions per
// element with tanhf's. The grid is over (tile of positions, group of
// channels): a thread owns one 16-byte unit of one item's positions (8 bf16
// or 4 f32 values of a plane), loads its noise unit once (n_l, n_g, or both
// where its group straddles cl) and walks its group's channels, each a
// 16-byte load of x and a 16-byte store of out, four channels' loads in
// flight. The block's per-channel mean, isc, bias and T(w) sit in shared
// memory. A fixed rule (apply_design) picks the block size, 32-256 threads,
// so that the grid holds at least one full wave of resident blocks, and then
// widens the groups while at least two waves remain. Planes that are no
// multiple of 16 bytes, or unaligned maps, take units of one value.
//
// dx: one thread per row, looping over the channels of its half of the map
// (grid.y = 2: channels below `split`, and from `split` on; split = cl in the
// noise variant), so that neighbouring threads read neighbouring addresses
// of each plane, the row's dn_l / dn_g stay in a register. The per-channel
// vectors (mean, isc, bias, p, q, w) sit in shared memory. Bytes bound it:
// it reads x and g and writes dx, 12.6-805 MB, 3.8-240 us.
//
// The GELU and the apply's affine map are computed operation by operation
// with round-to-nearest intrinsics (no FMA contraction), in the plain
// version's order.

#include <initializer_list>

#include "common.cuh"

namespace {

using namespace ffc;

constexpr float kEps = 1e-5f;
constexpr float kC1 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kC2 = 0.044715f;

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

__device__ __forceinline__ unsigned word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// kN consecutive values of a map: the 16 bytes of one load or store (kVec; 4
// f32 or 8 bf16) or one value.
template <typename T, bool kVec>
struct Unit {
  static constexpr int kN = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  using Raw = std::conditional_t<kVec, uint4, T>;
  Raw raw;

  __device__ __forceinline__ void load(const T* p) { raw = *reinterpret_cast<const Raw*>(p); }
  __device__ __forceinline__ void store(T* p) const { *reinterpret_cast<Raw*>(p) = raw; }

  // Value i in f32.
  __device__ __forceinline__ float get(int i) const {
    if constexpr (!kVec) {
      return load_f32(&raw);
    } else if constexpr (std::is_same_v<T, float>) {
      return __uint_as_float(word(raw, i));
    } else {
      const unsigned w = word(raw, i / 2);
      return __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
    }
  }

  // The unit of v, each value rounded to T.
  __device__ __forceinline__ void pack(const float (&v)[kN]) {
    if constexpr (!kVec) {
      store_f32(&raw, v[0]);
    } else if constexpr (std::is_same_v<T, float>) {
      raw = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                       __float_as_uint(v[3]));
    } else {
      unsigned w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const unsigned*>(&h);
      }
      raw = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

// A thread's share of one channel's B planes, each of `units` units, on a
// cluster of `ranks` blocks: rank r takes planes [b0, b1), a contiguous range;
// the thread reads unit j0, j0 + span, ... of planes first, first + step, ...
// span is the least power of two that covers a plane's units (at most
// kThreads), so a warp reads consecutive units of one or more planes.
struct PlaneWalk {
  int units, span, step, first, j0, b0, b1;

  __device__ __forceinline__ PlaneWalk(int B, int units_, int ranks, int rank) : units(units_) {
    span = 1;
    while (span < units && span < kThreads) span <<= 1;
    step = kThreads / span;
    first = threadIdx.x / span;
    j0 = threadIdx.x % span;
    const int per_rank = (B + ranks - 1) / ranks;
    b0 = rank * per_rank;
    b1 = min(B, b0 + per_rank);
  }
};

// Sums each of v's N values over the block (a warp-shuffle tree, then the
// warps in order) and over the cluster's blocks (rank 0 adds the blocks' sums
// over distributed shared memory in rank order). Every thread of the cluster
// calls it; it returns true on rank 0's thread 0, which holds the totals.
template <int N>
__device__ __forceinline__ bool cluster_sum(cg::cluster_group& cluster, float (&v)[N]) {
  __shared__ float warp_part[kWarps][N];
  __shared__ float block_part[N];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0)
    for (int i = 0; i < N; ++i) warp_part[warp][i] = v[i];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < N; ++i) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += warp_part[w][i];
      block_part[i] = s;
    }
  cluster.sync();  // every rank's block sums are in its shared memory
  const bool root = cluster.block_rank() == 0 && threadIdx.x == 0;
  if (root) {
    const int ranks = static_cast<int>(cluster.num_blocks());
    for (int i = 0; i < N; ++i) v[i] = 0.f;
    for (int r = 0; r < ranks; ++r) {
      const float* other = cluster.map_shared_rank(block_part, r);
      for (int i = 0; i < N; ++i) v[i] += other[i];
    }
  }
  cluster.sync();  // no block leaves while rank 0 still reads its shared memory
  return root;
}

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
// cluster size) of channel blockIdx.x / cluster size; its threads walk the
// channel's planes as PlaneWalk says.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ out, int B, int C, int hw) {
  constexpr int kPer = Unit<T, kVec>::kN;
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int c = blockIdx.x / ranks;
  const PlaneWalk walk(B, hw / kPer, ranks, static_cast<int>(cluster.block_rank()));
  const size_t stride = static_cast<size_t>(C) * hw;  // from plane (b, c) to (b + 1, c)
  const T* base = x + static_cast<size_t>(c) * hw;

  float v[2] = {0.f, 0.f};
  for (int b = walk.b0 + walk.first; b < walk.b1; b += walk.step * kStatsUnroll) {
    for (int j = walk.j0; j < walk.units; j += walk.span) {
      float s[kStatsUnroll], q[kStatsUnroll];
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        const int bu = b + u * walk.step;
        s[u] = q[u] = 0.f;
        if (bu < walk.b1)
          unit_sums<kVec>(base + bu * stride + static_cast<size_t>(j) * kPer, s[u], q[u]);
      }
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        v[0] += s[u];
        v[1] += q[u];
      }
    }
  }
  if (cluster_sum(cluster, v))
    moments(v[0], v[1], static_cast<float>(static_cast<long long>(B) * hw), out + c, out + C + c);
}

// Channels a thread of bn_gelu_apply_kernel walks, at most, and the channels
// whose loads it keeps in flight.
constexpr int kMaxGroup = 32;
constexpr int kApplyUnroll = 4;

// Grid (tiles of positions, groups of channels), blockDim.x threads a tile.
// Thread q = blockIdx.x * blockDim.x + threadIdx.x owns unit j of item b's
// planes, q = b * units + j (one division per thread), and walks the
// channels [c0, c1) of its block's group.
template <typename T, bool kVec, bool kNoise>
__global__ void __launch_bounds__(kThreads)
bn_gelu_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                     const float* __restrict__ var, const float* __restrict__ scale,
                     const float* __restrict__ bias, const float* __restrict__ w,
                     const T* __restrict__ n_l, const T* __restrict__ n_g,
                     T* __restrict__ out, int B, int C, int hw, int cl, int group) {
  using U = Unit<T, kVec>;
  __shared__ float s_mean[kMaxGroup], s_isc[kMaxGroup], s_bias[kMaxGroup], s_w[kMaxGroup];
  const int c0 = blockIdx.y * group, c1 = min(C, c0 + group);
  for (int k = threadIdx.x; k < c1 - c0; k += blockDim.x) {
    const int c = c0 + k;
    s_mean[k] = mean[c];
    s_isc[k] = __fmul_rn(rsqrtf(__fadd_rn(var[c], kEps)), scale[c]);
    s_bias[k] = bias[c];
    if (kNoise) s_w[k] = round_to<T>(w[c]);
  }
  __syncthreads();
  const unsigned units = static_cast<unsigned>(hw / U::kN);
  const unsigned q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= static_cast<unsigned>(B) * units) return;
  const unsigned b = q / units;
  const size_t pos = static_cast<size_t>(q - b * units) * U::kN;
  U n_lo, n_hi;  // the noise units of the channels below cl and from cl on
  if constexpr (kNoise) {
    if (c0 < cl) n_lo.load(n_l + static_cast<size_t>(b) * hw + pos);
    if (c1 > cl) n_hi.load(n_g + static_cast<size_t>(b) * hw + pos);
  }
  const size_t first = (static_cast<size_t>(b) * C + c0) * hw + pos;
  const T* xp = x + first;
  T* op = out + first;
  for (int k0 = 0; k0 < c1 - c0; k0 += kApplyUnroll) {
    U xu[kApplyUnroll];
#pragma unroll
    for (int k = 0; k < kApplyUnroll; ++k)
      if (k0 + k < c1 - c0) xu[k].load(xp + static_cast<size_t>(k0 + k) * hw);
#pragma unroll
    for (int k = 0; k < kApplyUnroll; ++k) {
      const int s = k0 + k;
      if (s >= c1 - c0) break;
      const bool lower = c0 + s < cl;
      float y[U::kN];
#pragma unroll
      for (int i = 0; i < U::kN; ++i) {
        const float u = affine<T>(xu[k].get(i), s_mean[s], s_isc[s], s_bias[s]);
        y[i] = round_to<T>(gelu_tanh(u));
        if constexpr (kNoise) {
          const float n = lower ? n_lo.get(i) : n_hi.get(i);
          y[i] = __fadd_rn(y[i], round_to<T>(__fmul_rn(s_w[s], n)));
        }
      }
      U o;
      o.pack(y);
      o.store(op + static_cast<size_t>(s) * hw);
    }
  }
}

// Planes of a channel in flight per thread of bn_bwd_reduce_kernel.
constexpr int kReduceUnroll = 2;

// out: (2 + noise, C) f32, [S1 | S2 (| S3)]. Blocks and threads as in
// bn_stats_kernel.
template <typename T, bool kVec, bool kNoise>
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ mean, const float* __restrict__ var,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const T* __restrict__ n_l, const T* __restrict__ n_g, int cl,
                     float* __restrict__ out, int B, int C, int hw) {
  using U = Unit<T, kVec>;
  constexpr int N = kNoise ? 3 : 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int c = blockIdx.x / ranks;
  const PlaneWalk walk(B, hw / U::kN, ranks, static_cast<int>(cluster.block_rank()));
  const float m = mean[c], inv = rsqrtf(__fadd_rn(var[c], kEps));
  const float isc = __fmul_rn(inv, scale[c]), bc = bias[c];
  const size_t stride = static_cast<size_t>(C) * hw;  // from plane (b, c) to (b + 1, c)
  const T* xc = x + static_cast<size_t>(c) * hw;
  const T* gc = g + static_cast<size_t>(c) * hw;
  const T* nc = c >= cl ? n_g : n_l;  // plane b at b * hw

  float v[N] = {};
  for (int b = walk.b0 + walk.first; b < walk.b1; b += walk.step * kReduceUnroll) {
    for (int j = walk.j0; j < walk.units; j += walk.span) {
      const size_t pos = static_cast<size_t>(j) * U::kN;
      U xu[kReduceUnroll], gu[kReduceUnroll], nu[kReduceUnroll];
#pragma unroll
      for (int k = 0; k < kReduceUnroll; ++k) {
        const int bk = b + k * walk.step;
        if (bk < walk.b1) {
          xu[k].load(xc + bk * stride + pos);
          gu[k].load(gc + bk * stride + pos);
          if constexpr (kNoise) nu[k].load(nc + static_cast<size_t>(bk) * hw + pos);
        }
      }
#pragma unroll
      for (int k = 0; k < kReduceUnroll; ++k) {
        if (b + k * walk.step >= walk.b1) break;
#pragma unroll
        for (int i = 0; i < U::kN; ++i) {
          const float xv = xu[k].get(i), gv = gu[k].get(i);
          const float xm = __fsub_rn(xv, m);
          const float du = gv * gelu_tanh_grad(affine<T>(xv, m, isc, bc));
          v[0] += du;
          v[1] = fmaf(du, xm * inv, v[1]);
          if constexpr (kNoise) v[2] = fmaf(gv, nu[k].get(i), v[2]);
        }
      }
    }
  }
  if (cluster_sum(cluster, v))
    for (int k = 0; k < N; ++k) out[k * C + c] = v[k];
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

// A (B, C, hw) map whose B * hw positions index with 32-bit integers.
bool bad_map(int B, int C, int hw, int cl) {
  return B <= 0 || hw <= 0 || static_cast<long long>(B) * hw > 0x7fffffffLL ||
         bad_dims(1, C, hw, cl);
}

// Whether every non-null map pointer is 16-byte aligned.
bool aligned16(std::initializer_list<const void*> maps) {
  for (const void* p : maps)
    if (reinterpret_cast<size_t>(p) % 16 != 0) return false;
  return true;
}

// Calls f(std::bool_constant<V>()) for vec = V (0 or 1); returns what f
// returns, or cudaErrorInvalidValue for another code.
template <typename F>
int with_vec(int vec, F f) {
  if (vec == 1) return f(std::true_type());
  if (vec == 0) return f(std::false_type());
  return cudaErrorInvalidValue;
}

dim3 row_grid(long long rows) { return dim3(static_cast<unsigned>((rows + kThreads - 1) / kThreads), 2); }

}  // namespace

extern "C" {

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
    if (kVec && (static_cast<size_t>(hw) * sizeof(T) % 16 != 0 || !aligned16({x})))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_clustered(bn_stats_kernel<T, kVec>, static_cast<unsigned>(C) * cluster,
                            cluster, 0, s, static_cast<const T*>(x), out, B, C, hw);
  });
}

// noise: 0 or 1 (then w, n_l and n_g are given); cl: the first channel of
// n_g. vec: 1 for units of 16 bytes (hw * itemsize a multiple of 16; x, out,
// n_l and n_g 16-byte aligned), 0 for units of one value. tile: threads per
// block, 32, 64, 128 or 256; group: channels per thread, 1 to 32.
int ffc_bn_gelu_apply(int dtype, int noise, const void* x, const float* mean,
                      const float* var, const float* scale, const float* bias,
                      const float* w, const void* n_l, const void* n_g, void* out, int B,
                      int C, int hw, int cl, int vec, int tile, int group, void* stream) {
  if (bad_map(B, C, hw, cl) || tile < 32 || tile > kThreads || (tile & (tile - 1)) != 0 ||
      group < 1 || group > kMaxGroup || (C + group - 1) / group > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<2>(dtype, noise, [&](auto tag, auto flag) {
    using T = typename decltype(tag)::type;
    constexpr bool kNoise = decltype(flag)::value == 1;
    return with_vec(vec, [&](auto vflag) {
      constexpr bool kVec = decltype(vflag)::value;
      if (kVec && (static_cast<size_t>(hw) * sizeof(T) % 16 != 0 ||
                   !aligned16({x, out}) || (kNoise && !aligned16({n_l, n_g}))))
        return static_cast<int>(cudaErrorInvalidValue);
      const long long units = static_cast<long long>(B) * (hw / Unit<T, kVec>::kN);
      const dim3 grid(static_cast<unsigned>((units + tile - 1) / tile),
                      static_cast<unsigned>((C + group - 1) / group));
      bn_gelu_apply_kernel<T, kVec, kNoise><<<grid, tile, 0, s>>>(
          static_cast<const T*>(x), mean, var, scale, bias, w, static_cast<const T*>(n_l),
          static_cast<const T*>(n_g), static_cast<T*>(out), B, C, hw, cl, group);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// Blocks of `tile` threads of the apply kernel that one SM holds at once
// (the occupancy calculator's answer for this build), or -1 on an error.
int ffc_bn_gelu_apply_blocks_per_sm(int dtype, int noise, int vec, int tile) {
  int blocks = -1;
  const int err = dispatch<2>(dtype, noise, [&](auto tag, auto flag) {
    using T = typename decltype(tag)::type;
    constexpr bool kNoise = decltype(flag)::value == 1;
    return with_vec(vec, [&](auto vflag) {
      constexpr bool kVec = decltype(vflag)::value;
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, bn_gelu_apply_kernel<T, kVec, kNoise>, tile, 0));
    });
  });
  return err == 0 ? blocks : -1;
}

// out: ((2 + noise), C) float32, [S1 | S2 (| S3)]. vec: as for the apply,
// over x, g, n_l and n_g; cluster: as for bn_stats.
int ffc_bn_bwd_reduce(int dtype, int noise, const void* x, const void* g,
                      const float* mean, const float* var, const float* scale,
                      const float* bias, const void* n_l, const void* n_g, int cl,
                      float* out, int B, int C, int hw, int vec, int cluster, void* stream) {
  if (bad_map(B, C, hw, cl) || !cluster_size_ok(cluster)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<2>(dtype, noise, [&](auto tag, auto flag) {
    using T = typename decltype(tag)::type;
    constexpr bool kNoise = decltype(flag)::value == 1;
    return with_vec(vec, [&](auto vflag) {
      constexpr bool kVec = decltype(vflag)::value;
      if (kVec && (static_cast<size_t>(hw) * sizeof(T) % 16 != 0 || !aligned16({x, g}) ||
                   (kNoise && !aligned16({n_l, n_g}))))
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_clustered(bn_bwd_reduce_kernel<T, kVec, kNoise>,
                              static_cast<unsigned>(C) * cluster, cluster, 0, s,
                              static_cast<const T*>(x), static_cast<const T*>(g), mean, var,
                              scale, bias, static_cast<const T*>(n_l),
                              static_cast<const T*>(n_g), cl, out, B, C, hw);
    });
  });
}

// s1, s2: the sums of ffc_bn_bwd_reduce; g_mean, g_var: (C,) or null for
// zero; with noise, w is given, split = cl and dn_l, dn_g are written.
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
