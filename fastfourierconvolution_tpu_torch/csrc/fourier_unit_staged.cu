// FourierUnit forward, batch statistics and backward for Hopper (sm_90a) on
// maps whose per-item buffers exceed a block's shared memory, as stages that
// fill the card: per (item, channel) plane for the transforms, per tile of
// spectral positions for the channel mix.
//
//   forward       : fu_spectrum (x -> z), fu_mix_apply (z -> r), fu_inverse (r -> y)
//   statistics    : fu_mix_stats (z -> per-run [sum m | sum m^2] rows), then
//                   fu_reduce (fourier_unit_train.cu) with count B*H*Wf
//   backward sums : fu_bwd_stats_mix (z, G -> per-run [sum gpre*n | sum gpre]
//                   rows), then fu_reduce
//   backward apply: fu_spectrum (x -> z and gy -> G in one launch),
//                   fu_bwd_mix (z, G -> gz in place of G, gK partials),
//                   fu_inverse (gz -> gx), and fu_reduce over the gK partials.
// fu_reduce sums the rows of partial sums in a fixed order. The training op
// computes each spectrum once per call and hands it to both mix stages that
// read it (ops/fourier_unit.py, _train_forward_staged and
// _train_backward_staged); fu_bwd_stats_mix has to run before fu_bwd_mix,
// which writes gz over G.
//
// Replaces, on those maps, the Pallas kernels of
// fastfourierconvolution_tpu/ops/pallas/fourier_unit.py:
//   _pallas_forward_{sep,sep2,kron}  -> apply_kernel (pallas_call at lines 657,
//                                       1124, 1405): the forward;
//   _pallas_forward_{sep,sep2,kron}  -> stats_kernel (lines 622, 1088, 1363):
//                                       fu_mix_stats, the batch statistics;
//   _pallas_backward_{sep,sep2,kron} -> stats_kernel (lines 753, 1222, 1500):
//                                       fu_bwd_stats_mix, the backward sums;
//   _pallas_backward_{sep,sep2,kron} -> apply_kernel (lines 806, 1275, 1562),
//                                       train mode: the backward apply.
// The per-item kernels of fourier_unit_fwd.cu and fourier_unit_train.cu keep
// the maps whose item fits a block's shared memory. Same functions, same
// layouts of x, y, gy, gx, K and the (2C,) vectors (see those files).
//
// The stages. With z = DFT(x) ([re | im], 2C channels, f32), m = z @ K,
// pre = (m - mean) * inv * scale + bias (inv = rsqrt(var + 1e-5)), c the
// half-spectrum weights (1 at DC and Nyquist, 2 elsewhere):
//   fu_spectrum  : per plane, the orthonormal rDFT over (H, W), written once as
//                  (n_maps, B, 2C, H, Wf) f32.
//   fu_mix_apply : per tile of 64 positions of an item, all 2C channels:
//                  r = c * ReLU(pre), (B, 2C, H, Wf) f32.
//   fu_inverse   : per plane, Re(eh . R . fw^T) (no weights), y in x's dtype.
//                  The adjoint of fu_spectrum's transform, so it also takes
//                  gz to gx.
//   fu_mix_stats : per tile, m = z @ K; the block's sums over its tiles of m
//                  and m^2 (no half-spectrum weights) into its own row of
//                  B * chunks rows of [2C | 2C]; fu_reduce turns them into the
//                  batch mean and the biased variance E[m^2] - E[m]^2.
//   fu_bwd_stats_mix: per tile, n = (m - mean) * inv, gpre = c * G * [pre > 0]
//                  (the arithmetic of fu_bwd_mix, so both take the same ReLU
//                  mask); the block's sums of gpre * n and gpre into its own
//                  row; fu_reduce gives gscale and gbias.
//   fu_bwd_mix   : per tile, gpre = c * G * [pre > 0], gn = gpre * scale,
//                  gm = inv * (gn - mean(gn) - n * mean(gn n)) with the batch
//                  means from gscale and gbias (the coupled-BN cotangent of
//                  fourier_unit_train.cu); gz = gm @ K^T into G's storage, and
//                  the block's sum over its tiles of z^T gm into its own row of
//                  the gK partials (B * chunks rows of (2C)^2; no atomics, so
//                  every launch gives the same bits).
//
// Design. Spectra stay f32 in device memory, as in the per-item kernels,
// and all arithmetic is f32 FMA on the CUDA cores (the f32 path must meet
// 1e-4 of the f64 plain version, which TF32 tensor cores do not). The
// transforms are radix-2 FFTs in shared memory on power-of-two planes: the
// W-stage rDFT packs a row's even and odd samples as one complex sequence of
// length W/2 (decimation in time, rows stored bit-reversed as they are
// loaded) and untangles it in place into the Wf = W/2 + 1 half-spectrum
// columns; the H-stage runs over those columns. The inverse mirrors it with
// decimation in frequency (natural input, bit-reversed output, undone as y
// is written), so each plane needs one buffer of H x Wf complex values
// (66.5 KB at 128 x 128) and its twiddles (double precision, rounded to
// f32). The mix stages keep K (row stride 2C + 1) and the tile (stride 65)
// in shared memory; a thread owns a (2C/16) x 4 block of outputs, and in
// fu_bwd_mix a (2C/16) x (2C/16) block of the gK sum, in registers. Each
// block of a mix stage walks a fixed run of tiles of one item (`chunks` runs
// per item, from the host), so K is loaded once per run. The two statistics
// stages write no map: a thread keeps its 2C/16 channels' two sums in
// registers across the run, then the 16 threads that share those channels
// add theirs with a fixed butterfly of shuffles (the same bits in every
// lane), and one of them writes the channels' entries of the block's row.
// Fixed runs, a fixed butterfly and fu_reduce's fixed row order give the
// same bits on every launch, without atomics.
//
// What bounds them on an H100: bytes. Each stage reads its inputs once and
// writes its outputs once. At (B, C, H, W) = (64, 32, 128, 128) in bf16 x
// is 67 MB and a spectrum (z, r, G or gz) 136 MB: the forward moves x, z
// twice, r twice and y, 0.68 GB, 0.20 ms at 3.35 TB/s; the backward apply x,
// gy, z and G written and read, gz written and read, and gx, 1.02 GB, 0.30 ms.
// At (64, 32, 64, 64) 0.05 and 0.08 ms, at (64, 32, 32, 32) 0.013 and 0.020
// ms, and the backward apply at (64, 64, 16, 16) 0.010 ms. The function
// itself (chip_smoke.fu_work) moves only x, y (and gy, gx): the spectra are
// what this design adds in exchange for filling the card; the radix-2 stages
// are bound by shared-memory traffic (about 10 accesses per butterfly), the
// mix stages by their shared-memory loads (0.5 per FMA). The statistics
// stages at (64, 32, 128, 128): fu_mix_stats reads z (136 MB, 0.041 ms) and
// does 2 (2C)^2 B H Wf = 4.4 GFLOP of f32 FMAs (0.065 ms at 67 TFLOP/s), so
// operations bound it; fu_bwd_stats_mix reads z and G (0.081 ms) and does
// the same FMAs, so bytes bound it.

#include "fourier_unit_common.cuh"

namespace {

using namespace ffc;

constexpr int kTile = 64;          // spectral positions per tile of a mix stage
constexpr int kTileP = kTile + 1;  // a tile's row stride in shared memory

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// The low `bits` bits of v in reverse order (bits >= 1).
__device__ __forceinline__ int bit_reverse(int v, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

// tw[k] = exp(-2 pi i k / n) for k < n / 2, in double rounded to f32 (no sync).
__device__ __forceinline__ void fill_twiddles(float2* tw, int n) {
  for (int k = threadIdx.x; k < n / 2; k += kThreads) {
    double s, c;
    sincospi(-2.0 * k / n, &s, &c);
    tw[k] = make_float2(static_cast<float>(c), static_cast<float>(s));
  }
}

// Radix-2 FFTs of length n = 2^log2n over `count` sequences of buf, in place,
// by the whole block; element e of sequence t is buf[t * seq_stride + e *
// elem_stride]. kDit: decimation in time (bit-reversed input, natural output);
// else decimation in frequency (natural input, bit-reversed output). The
// twiddle exp(-2 pi i j / n) is tw[j * tw_step], conjugated when kInverse.
// kRows: the threads walk one sequence's butterflies fastest (rows of buf);
// else the sequences (columns of buf). Every stage ends on a barrier.
template <bool kDit, bool kInverse, bool kRows>
__device__ void fft_pass(float2* buf, int count, int seq_stride, int elem_stride,
                         int log2n, const float2* tw, int tw_step) {
  const int half_n = 1 << (log2n - 1);
  const int total = count * half_n;
  for (int st = 0; st < log2n; ++st) {
    const int lh = kDit ? st : log2n - 1 - st;  // butterfly span 2^lh
    const int span = 1 << lh;
    const int tw_mul = (half_n >> lh) * tw_step;
    for (int idx = threadIdx.x; idx < total; idx += kThreads) {
      int t, b;
      if constexpr (kRows) {
        t = idx >> (log2n - 1);
        b = idx & (half_n - 1);
      } else {
        b = idx / count;
        t = idx - b * count;
      }
      const int pos = b & (span - 1);
      const int i = ((b >> lh) << (lh + 1)) + pos;
      float2* pi = buf + t * seq_stride + i * elem_stride;
      float2* pj = pi + span * elem_stride;
      float2 w = tw[pos * tw_mul];
      if constexpr (kInverse) w.y = -w.y;
      const float2 a = *pi, c = *pj;
      if constexpr (kDit) {
        const float2 wc = cmul(c, w);
        *pi = cadd(a, wc);
        *pj = csub(a, wc);
      } else {
        *pi = cadd(a, c);
        *pj = cmul(csub(a, c), w);
      }
    }
    __syncthreads();
  }
}

// One plane's buffers: H x Wf complex values (row stride Wf), then the W and
// H twiddles.
struct PlaneBufs {
  float2 *buf, *tw_w, *tw_h;
  __device__ PlaneBufs(float2* base, int H, int W)
      : buf(base), tw_w(base + H * (W / 2 + 1)), tw_h(base + H * (W / 2 + 1) + W / 2) {}
};

__host__ __device__ inline size_t plane_smem_bytes(int H, int W) {
  return (static_cast<size_t>(H) * (W / 2 + 1) + W / 2 + H / 2) * sizeof(float2);
}

// out[map] = [re | im] orthonormal rDFT of each plane of x_map, for the
// n_maps inputs x0 (and x1); grid n_maps * planes, planes = B * C.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fu_spectrum_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                   float* __restrict__ out, int planes, int C, int H, int W,
                   int log2h, int log2w) {
  extern __shared__ float4 smem_f4[];
  const PlaneBufs pb(reinterpret_cast<float2*>(smem_f4), H, W);
  const int n = W / 2, wf = n + 1, log2n = log2w - 1;
  const int map = blockIdx.x / planes, plane = blockIdx.x - map * planes;
  const T* src = (map == 0 ? x0 : x1) + static_cast<size_t>(plane) * H * W;

  fill_twiddles(pb.tw_w, W);
  fill_twiddles(pb.tw_h, H);
  // Row h's samples (2k, 2k+1) as complex k, at row bitrev(h), column
  // bitrev(k): the input order of both decimation-in-time passes.
  for (int i = threadIdx.x; i < H * n; i += kThreads) {
    const int h = i >> log2n, k = i & (n - 1);
    pb.buf[bit_reverse(h, log2h) * wf + bit_reverse(k, log2n)] =
        make_float2(load_f32(src + 2 * i), load_f32(src + 2 * i + 1));
  }
  __syncthreads();
  fft_pass<true, false, true>(pb.buf, H, wf, 1, log2n, pb.tw_w, 2);

  // Untangle each row's half-length transform Z into the rDFT X over W:
  // with E = (Z[k] + conj Z[n-k]) / 2 and O = (Z[k] - conj Z[n-k]) / 2i,
  // X[k] = E + w^k O and X[n-k] = conj(E - w^k O), w = exp(-2 pi i / W).
  const int pairs = n / 2 + 1;
  for (int i = threadIdx.x; i < H * pairs; i += kThreads) {
    const int r = i / pairs, k = i - r * pairs;
    float2* row = pb.buf + r * wf;
    const float2 zk = row[k], znk = row[(n - k) & (n - 1)];
    const float2 e = make_float2(0.5f * (zk.x + znk.x), 0.5f * (zk.y - znk.y));
    const float2 o = make_float2(0.5f * (zk.y + znk.y), -0.5f * (zk.x - znk.x));
    const float2 wo = cmul(pb.tw_w[k], o);
    row[k] = cadd(e, wo);
    row[n - k] = cconj(csub(e, wo));
  }
  __syncthreads();
  fft_pass<true, false, false>(pb.buf, wf, 1, wf, log2h, pb.tw_h, 1);

  const int b = plane / C, c = plane - b * C;
  const size_t S = static_cast<size_t>(H) * wf;
  float* o_re = out + (static_cast<size_t>(map) * planes * 2 +
                       static_cast<size_t>(b) * 2 * C + c) * S;
  float* o_im = o_re + C * S;
  const float ortho = static_cast<float>(1.0 / sqrt(static_cast<double>(H) * W));
  for (int i = threadIdx.x; i < H * wf; i += kThreads) {
    const float2 v = pb.buf[i];
    o_re[i] = v.x * ortho;
    o_im[i] = v.y * ortho;
  }
}

// y = Re(eh . R . fw^T) / sqrt(HW) per plane of the (B, 2C, H, Wf) spectrum
// spec (no half-spectrum weights); grid B * C.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fu_inverse_kernel(const float* __restrict__ spec, T* __restrict__ y, int C, int H,
                  int W, int log2h, int log2w) {
  extern __shared__ float4 smem_f4[];
  const PlaneBufs pb(reinterpret_cast<float2*>(smem_f4), H, W);
  const int n = W / 2, wf = n + 1, log2n = log2w - 1;
  const int plane = blockIdx.x, b = plane / C, d = plane - b * C;
  const size_t S = static_cast<size_t>(H) * wf;
  const float* s_re = spec + (static_cast<size_t>(b) * 2 * C + d) * S;
  const float* s_im = s_re + C * S;

  fill_twiddles(pb.tw_w, W);
  fill_twiddles(pb.tw_h, H);
  for (int i = threadIdx.x; i < H * wf; i += kThreads)
    pb.buf[i] = make_float2(s_re[i], s_im[i]);
  __syncthreads();
  // Inverse over H: row p of the result lands in row bitrev(p).
  fft_pass<false, true, false>(pb.buf, wf, 1, wf, log2h, pb.tw_h, 1);

  // Each row T[0..n] to the half-length sequence whose inverse transform
  // gives the real row: with X[0] = Re T[0], X[n] = Re T[n], X[v] = T[v] / 2
  // between (the Hermitian spectrum whose real inverse is the sum of
  // Re(T[v] exp(+2 pi i q v / W)) over v <= n), A = X[k] + conj X[n-k],
  // B = X[k] - conj X[n-k], u = exp(+2 pi i k / W):
  // Z[k] = A + i u B and Z[n-k] = conj(A - i u B).
  const int pairs = n / 2 + 1;
  for (int i = threadIdx.x; i < H * pairs; i += kThreads) {
    const int r = i / pairs, k = i - r * pairs;
    float2* row = pb.buf + r * wf;
    const float2 tk = row[k], tnk = row[n - k];
    const float2 xk = k == 0 ? make_float2(tk.x, 0.f) : cscale(tk, 0.5f);
    const float2 xnk = k == 0 ? make_float2(tnk.x, 0.f) : cscale(tnk, 0.5f);
    const float2 a = make_float2(xk.x + xnk.x, xk.y - xnk.y);
    const float2 bb = make_float2(xk.x - xnk.x, xk.y + xnk.y);
    const float2 ub = cmul(cconj(pb.tw_w[k]), bb);
    const float2 iub = make_float2(-ub.y, ub.x);
    row[k] = cadd(a, iub);
    if (k != 0) row[n - k] = cconj(csub(a, iub));
  }
  __syncthreads();
  fft_pass<false, true, true>(pb.buf, H, wf, 1, log2n, pb.tw_w, 2);

  T* out = y + static_cast<size_t>(plane) * H * W;
  const float ortho = static_cast<float>(1.0 / sqrt(static_cast<double>(H) * W));
  for (int i = threadIdx.x; i < H * n; i += kThreads) {
    const int p = i >> log2n, k = i & (n - 1);
    const float2 v = pb.buf[bit_reverse(p, log2h) * wf + bit_reverse(k, log2n)];
    store_f32(out + 2 * i, v.x * ortho);
    store_f32(out + 2 * i + 1, v.y * ortho);
  }
}

// The (2C, kTile) slice [s0, s0 + kTile) of a (2C, S) spectrum into a tile of
// row stride kTileP, zeros past S (no sync).
template <int C2>
__device__ __forceinline__ void load_tile(float* tile, const float* src, int S, int s0) {
  for (int i = threadIdx.x; i < C2 * kTile; i += kThreads) {
    const int j = i / kTile, s = i % kTile;
    tile[j * kTileP + s] = s0 + s < S ? src[static_cast<size_t>(j) * S + s0 + s] : 0.f;
  }
}

// acc[i][k] = sum_j K(j, d) t[j][s] over the 2C rows of the tile t, for the
// thread's outputs d = ty + 16 i, s = tx + 16 k. kTransposed: K(j, d) =
// ks[d][j] (gz = gm @ K^T); else ks[j][d] (m = z @ K). ks has row stride
// 2C + 1.
template <int RD, bool kTransposed>
__device__ __forceinline__ void mix_tile(float (&acc)[RD][4], const float* t,
                                         const float* ks) {
  constexpr int C2 = 16 * RD, KP = C2 + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RD; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
#pragma unroll 4
  for (int j = 0; j < C2; ++j) {
    float tv[4], kv[RD];
#pragma unroll
    for (int k = 0; k < 4; ++k) tv[k] = t[j * kTileP + tx + 16 * k];
#pragma unroll
    for (int i = 0; i < RD; ++i)
      kv[i] = kTransposed ? ks[(ty + 16 * i) * KP + j] : ks[j * KP + ty + 16 * i];
#pragma unroll
    for (int i = 0; i < RD; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(tv[k], kv[i], acc[i][k]);
  }
}

// K (2C, 2C) into ks with row stride 2C + 1 (no sync).
template <int C2, typename T>
__device__ __forceinline__ void load_k(float* ks, const T* kmix) {
  for (int i = threadIdx.x; i < C2 * C2; i += kThreads)
    ks[(i / C2) * (C2 + 1) + i % C2] = load_f32(kmix + i);
}

// The tiles [t0, t1) of block (chunk, item): `chunks` runs of equal length.
__device__ __forceinline__ void tile_run(int S, int chunks, int& t0, int& t1) {
  const int tiles = (S + kTile - 1) / kTile;
  const int per = (tiles + chunks - 1) / chunks;
  t0 = min(tiles, static_cast<int>(blockIdx.x) * per);
  t1 = min(tiles, t0 + per);
}

__device__ __forceinline__ float weight_of(int s, int wf) {
  const int v = s % wf;
  return (v == 0 || v == wf - 1) ? 1.f : 2.f;
}

// r = c * ReLU((z @ K - mean) * inv * scale + bias); grid (chunks, B).
template <typename T, int RD>
__global__ void __launch_bounds__(kThreads)
fu_mix_apply_kernel(const float* __restrict__ z, const T* __restrict__ kmix,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const float* __restrict__ mean, const float* __restrict__ var,
                    float* __restrict__ r, int H, int W, int chunks) {
  constexpr int C2 = 16 * RD;
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);  // K, row stride C2 + 1
  float* zt = ks + C2 * (C2 + 1);                 // the z tile
  float* v_mean = zt + C2 * kTileP;
  float* v_inv = v_mean + C2;
  float* v_scale = v_inv + C2;
  float* v_bias = v_scale + C2;
  const int wf = W / 2 + 1, S = H * wf;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t item = blockIdx.y;
  const float* zb = z + item * C2 * S;
  float* rb = r + item * C2 * S;
  int t0, t1;
  tile_run(S, chunks, t0, t1);

  load_k<C2>(ks, kmix);
  for (int d = threadIdx.x; d < C2; d += kThreads) {
    v_mean[d] = mean[d];
    v_inv[d] = rsqrtf(var[d] + kEps);
    v_scale[d] = scale[d];
    v_bias[d] = bias[d];
  }
  for (int t = t0; t < t1; ++t) {
    const int s0 = t * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_tile<C2>(zt, zb, S, s0);
    __syncthreads();
    float acc[RD][4];
    mix_tile<RD, false>(acc, zt, ks);
#pragma unroll
    for (int i = 0; i < RD; ++i) {
      const int d = ty + 16 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = s0 + tx + 16 * k;
        if (s < S) {
          const float pre = (acc[i][k] - v_mean[d]) * v_inv[d] * v_scale[d] + v_bias[d];
          rb[static_cast<size_t>(d) * S + s] = fmaxf(pre, 0.f) * weight_of(s, wf);
        }
      }
    }
  }
}

// The backward apply's mix stage (see the file's note); g holds G on entry
// and gz on exit; partial row item * chunks + chunk gets the block's gK sum.
// Grid (chunks, B).
template <typename T, int RD>
__global__ void __launch_bounds__(kThreads)
fu_bwd_mix_kernel(const float* __restrict__ z, float* __restrict__ g,
                  const T* __restrict__ kmix, const float* __restrict__ scale,
                  const float* __restrict__ bias, const float* __restrict__ mean,
                  const float* __restrict__ var, const float* __restrict__ gscale,
                  const float* __restrict__ gbias, float* __restrict__ partial, int H,
                  int W, int chunks) {
  constexpr int C2 = 16 * RD;
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);
  float* zt = ks + C2 * (C2 + 1);  // the z tile
  float* gt = zt + C2 * kTileP;    // the G tile, then gm
  float* v_mean = gt + C2 * kTileP;
  float* v_inv = v_mean + C2;
  float* v_scale = v_inv + C2;
  float* v_bias = v_scale + C2;
  float* v_mgn = v_bias + C2;
  float* v_mgnn = v_mgn + C2;
  const int wf = W / 2 + 1, S = H * wf;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t item = blockIdx.y;
  const float* zb = z + item * C2 * S;
  float* gb = g + item * C2 * S;
  const float count = static_cast<float>(gridDim.y) * S;
  int t0, t1;
  tile_run(S, chunks, t0, t1);

  load_k<C2>(ks, kmix);
  for (int d = threadIdx.x; d < C2; d += kThreads) {
    v_mean[d] = mean[d];
    v_inv[d] = rsqrtf(var[d] + kEps);
    v_scale[d] = scale[d];
    v_bias[d] = bias[d];
    v_mgn[d] = scale[d] * gbias[d] / count;
    v_mgnn[d] = scale[d] * gscale[d] / count;
  }
  float gk[RD][RD];  // gK[ty + 16 a][tx + 16 b] over the run's positions
#pragma unroll
  for (int a = 0; a < RD; ++a)
#pragma unroll
    for (int bb = 0; bb < RD; ++bb) gk[a][bb] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int s0 = t * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_tile<C2>(zt, zb, S, s0);
    load_tile<C2>(gt, gb, S, s0);
    __syncthreads();
    // gm in place of G: each thread reads and writes only its own entries.
    float acc[RD][4];
    mix_tile<RD, false>(acc, zt, ks);
#pragma unroll
    for (int i = 0; i < RD; ++i) {
      const int d = ty + 16 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int sl = tx + 16 * k, s = s0 + sl;
        float gm = 0.f;
        if (s < S) {
          const float n_hat = (acc[i][k] - v_mean[d]) * v_inv[d];
          const float pre = n_hat * v_scale[d] + v_bias[d];
          const float gpre = pre > 0.f ? weight_of(s, wf) * gt[d * kTileP + sl] : 0.f;
          const float gn = gpre * v_scale[d];
          gm = v_inv[d] * (gn - v_mgn[d] - n_hat * v_mgnn[d]);
        }
        gt[d * kTileP + sl] = gm;
      }
    }
    __syncthreads();
    // gK[j][e] += sum_s z[j][s] gm[e][s]
#pragma unroll 4
    for (int sl = 0; sl < kTile; ++sl) {
      float zv[RD], gv[RD];
#pragma unroll
      for (int a = 0; a < RD; ++a) zv[a] = zt[(ty + 16 * a) * kTileP + sl];
#pragma unroll
      for (int bb = 0; bb < RD; ++bb) gv[bb] = gt[(tx + 16 * bb) * kTileP + sl];
#pragma unroll
      for (int a = 0; a < RD; ++a)
#pragma unroll
        for (int bb = 0; bb < RD; ++bb) gk[a][bb] = fmaf(zv[a], gv[bb], gk[a][bb]);
    }
    // gz[j][s] = sum_e K[j][e] gm[e][s], into G's storage.
    mix_tile<RD, true>(acc, gt, ks);
#pragma unroll
    for (int i = 0; i < RD; ++i) {
      const int j = ty + 16 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = s0 + tx + 16 * k;
        if (s < S) gb[static_cast<size_t>(j) * S + s] = acc[i][k];
      }
    }
  }
  float* row = partial + (item * chunks + blockIdx.x) * C2 * C2;
#pragma unroll
  for (int a = 0; a < RD; ++a)
#pragma unroll
    for (int bb = 0; bb < RD; ++bb) row[(ty + 16 * a) * C2 + tx + 16 * bb] = gk[a][bb];
}

// v summed over the 16 threads of a half-warp (one ty, every tx) by a fixed
// butterfly; every lane gets the same bits (a + b == b + a).
__device__ __forceinline__ float tx_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// row[d] = the block's sum of a, row[2C + d] = of b, for the thread's
// channels d = ty + 16 i; every thread of the block takes part.
template <int RD>
__device__ __forceinline__ void write_sums(float* row, const float (&a)[RD],
                                           const float (&b)[RD]) {
  constexpr int C2 = 16 * RD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RD; ++i) {
    const float sa = tx_sum(a[i]), sb = tx_sum(b[i]);
    if (tx == 0) {
      row[ty + 16 * i] = sa;
      row[C2 + ty + 16 * i] = sb;
    }
  }
}

// Row item * chunks + chunk of `partial` gets [sum m | sum m^2] over the
// block's run of tiles, m = z @ K; grid (chunks, B). Positions past S sit in
// the tile as zeros, so their m is 0 and adds nothing.
template <typename T, int RD>
__global__ void __launch_bounds__(kThreads)
fu_mix_stats_kernel(const float* __restrict__ z, const T* __restrict__ kmix,
                    float* __restrict__ partial, int H, int W, int chunks) {
  constexpr int C2 = 16 * RD;
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);  // K, row stride C2 + 1
  float* zt = ks + C2 * (C2 + 1);                 // the z tile
  const int S = H * (W / 2 + 1);
  const size_t item = blockIdx.y;
  const float* zb = z + item * C2 * S;
  int t0, t1;
  tile_run(S, chunks, t0, t1);

  load_k<C2>(ks, kmix);
  float s1[RD], s2[RD];
#pragma unroll
  for (int i = 0; i < RD; ++i) s1[i] = s2[i] = 0.f;
  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<C2>(zt, zb, S, t * kTile);
    __syncthreads();
    float acc[RD][4];
    mix_tile<RD, false>(acc, zt, ks);
#pragma unroll
    for (int i = 0; i < RD; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s1[i] += acc[i][k];
        s2[i] = fmaf(acc[i][k], acc[i][k], s2[i]);
      }
  }
  write_sums<RD>(partial + (item * chunks + blockIdx.x) * 2 * C2, s1, s2);
}

// Row item * chunks + chunk of `partial` gets [sum gpre * n | sum gpre] over
// the block's run of tiles (see the file's note); grid (chunks, B).
template <typename T, int RD>
__global__ void __launch_bounds__(kThreads)
fu_bwd_stats_mix_kernel(const float* __restrict__ z, const float* __restrict__ g,
                        const T* __restrict__ kmix, const float* __restrict__ scale,
                        const float* __restrict__ bias, const float* __restrict__ mean,
                        const float* __restrict__ var, float* __restrict__ partial, int H,
                        int W, int chunks) {
  constexpr int C2 = 16 * RD;
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);
  float* zt = ks + C2 * (C2 + 1);  // the z tile
  float* gt = zt + C2 * kTileP;    // the G tile
  float* v_mean = gt + C2 * kTileP;
  float* v_inv = v_mean + C2;
  float* v_scale = v_inv + C2;
  float* v_bias = v_scale + C2;
  const int wf = W / 2 + 1, S = H * wf;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t item = blockIdx.y;
  const float* zb = z + item * C2 * S;
  const float* gb = g + item * C2 * S;
  int t0, t1;
  tile_run(S, chunks, t0, t1);

  load_k<C2>(ks, kmix);
  for (int d = threadIdx.x; d < C2; d += kThreads) {
    v_mean[d] = mean[d];
    v_inv[d] = rsqrtf(var[d] + kEps);
    v_scale[d] = scale[d];
    v_bias[d] = bias[d];
  }
  float s_gn[RD], s_g[RD];
#pragma unroll
  for (int i = 0; i < RD; ++i) s_gn[i] = s_g[i] = 0.f;
  for (int t = t0; t < t1; ++t) {
    const int s0 = t * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_tile<C2>(zt, zb, S, s0);
    load_tile<C2>(gt, gb, S, s0);
    __syncthreads();
    float acc[RD][4];
    mix_tile<RD, false>(acc, zt, ks);
#pragma unroll
    for (int i = 0; i < RD; ++i) {
      const int d = ty + 16 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int sl = tx + 16 * k, s = s0 + sl;
        if (s < S) {
          const float n_hat = (acc[i][k] - v_mean[d]) * v_inv[d];
          const float pre = n_hat * v_scale[d] + v_bias[d];
          const float gpre = pre > 0.f ? weight_of(s, wf) * gt[d * kTileP + sl] : 0.f;
          s_gn[i] = fmaf(gpre, n_hat, s_gn[i]);
          s_g[i] += gpre;
        }
      }
    }
  }
  write_sums<RD>(partial + (item * chunks + blockIdx.x) * 2 * C2, s_gn, s_g);
}

// Dynamic shared memory of a mix stage: K (row stride 2C + 1), `tiles`
// tiles of 2C x kTileP and `vectors` (2C,) vectors.
size_t mix_smem_bytes(int C2, int tiles, int vectors) {
  return (static_cast<size_t>(C2) * (C2 + 1) + static_cast<size_t>(tiles) * C2 * kTileP +
          static_cast<size_t>(vectors) * C2) * sizeof(float);
}

int log2_exact(int v) {
  if (v < 4 || (v & (v - 1)) != 0) return -1;
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// Calls f(std::integral_constant<int, RD>()) for 2C = 16 * RD, RD in
// {1, 2, 4, 8}; cudaErrorInvalidValue for another width.
template <typename F>
int by_width(int C2, F f) {
  switch (C2) {
    case 16: return f(std::integral_constant<int, 1>());
    case 32: return f(std::integral_constant<int, 2>());
    case 64: return f(std::integral_constant<int, 4>());
    case 128: return f(std::integral_constant<int, 8>());
    default: return cudaErrorInvalidValue;
  }
}

bool bad_plane(int B, int C, int H, int W) {
  return B <= 0 || C <= 0 || log2_exact(H) < 0 || log2_exact(W) < 0;
}

}  // namespace

extern "C" {

// Lets the dtype's staged kernels take up to `bytes` of dynamic shared
// memory on the current device. Returns a cudaError_t (0 on success).
int ffc_allow_smem(int dtype, int bytes) {
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    int e = cudaFuncSetAttribute(fu_spectrum_kernel<T>, attr, bytes);
    if (e == 0) e = cudaFuncSetAttribute(fu_inverse_kernel<T>, attr, bytes);
    for (int c2 = 16; c2 <= 128 && e == 0; c2 *= 2) {
      e = by_width(c2, [&](auto rd) {
        constexpr int RD = decltype(rd)::value;
        int err = cudaFuncSetAttribute(fu_mix_apply_kernel<T, RD>, attr, bytes);
        if (err == 0) err = cudaFuncSetAttribute(fu_bwd_mix_kernel<T, RD>, attr, bytes);
        if (err == 0) err = cudaFuncSetAttribute(fu_mix_stats_kernel<T, RD>, attr, bytes);
        if (err == 0)
          err = cudaFuncSetAttribute(fu_bwd_stats_mix_kernel<T, RD>, attr, bytes);
        return err;
      });
    }
    return e;
  });
}

// dtype: 0 = float32, 1 = bfloat16 (of x0, x1). out: (n_maps, B, 2C, H, Wf)
// float32, n_maps 1 (x1 unused) or 2. H and W powers of two, at least 4.
// Every entry point returns a cudaError_t (0 on success).
int ffc_fu_spectrum(int dtype, const void* x0, const void* x1, float* out, int n_maps,
                    int B, int C, int H, int W, void* stream) {
  if (bad_plane(B, C, H, W) || n_maps < 1 || n_maps > 2 || (n_maps == 2 && !x1))
    return cudaErrorInvalidValue;
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    fu_spectrum_kernel<T><<<n_maps * B * C, kThreads, plane_smem_bytes(H, W),
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x0), static_cast<const T*>(x1), out, B * C, C, H, W,
        log2_exact(H), log2_exact(W));
    return static_cast<int>(cudaGetLastError());
  });
}

// spec: (B, 2C, H, Wf) float32; y: (B, C, H, W) in dtype.
int ffc_fu_inverse(int dtype, const float* spec, void* y, int B, int C, int H, int W,
                   void* stream) {
  if (bad_plane(B, C, H, W)) return cudaErrorInvalidValue;
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    fu_inverse_kernel<T><<<B * C, kThreads, plane_smem_bytes(H, W),
                           static_cast<cudaStream_t>(stream)>>>(
        spec, static_cast<T*>(y), C, H, W, log2_exact(H), log2_exact(W));
    return static_cast<int>(cudaGetLastError());
  });
}

// dtype of K. z, r: (B, 2C, H, Wf) float32; chunks >= 1 runs of tiles per item.
int ffc_fu_mix_apply(int dtype, const float* z, const void* k, const float* scale,
                     const float* bias, const float* mean, const float* var, float* r,
                     int B, int C, int H, int W, int chunks, void* stream) {
  if (bad_plane(B, C, H, W) || chunks < 1) return cudaErrorInvalidValue;
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return by_width(2 * C, [&](auto rd) {
      constexpr int RD = decltype(rd)::value;
      fu_mix_apply_kernel<T, RD><<<dim3(chunks, B), kThreads, mix_smem_bytes(2 * C, 1, 4),
                                   static_cast<cudaStream_t>(stream)>>>(
          z, static_cast<const T*>(k), scale, bias, mean, var, r, H, W, chunks);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// dtype of K. z, g: (B, 2C, H, Wf) float32, g = DFT(gy) on entry and gz on
// exit; partial: (B * chunks, 4C^2) float32; gscale, gbias: the reduced
// backward sums.
int ffc_fu_bwd_mix(int dtype, const float* z, float* g, const void* k,
                   const float* scale, const float* bias, const float* mean,
                   const float* var, const float* gscale, const float* gbias,
                   float* partial, int B, int C, int H, int W, int chunks, void* stream) {
  if (bad_plane(B, C, H, W) || chunks < 1) return cudaErrorInvalidValue;
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return by_width(2 * C, [&](auto rd) {
      constexpr int RD = decltype(rd)::value;
      fu_bwd_mix_kernel<T, RD><<<dim3(chunks, B), kThreads, mix_smem_bytes(2 * C, 2, 6),
                                 static_cast<cudaStream_t>(stream)>>>(
          z, g, static_cast<const T*>(k), scale, bias, mean, var, gscale, gbias, partial,
          H, W, chunks);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// dtype of K. z: (B, 2C, H, Wf) float32; partial: (B * chunks, 4C) float32,
// rows of [sum m | sum m^2] for fu_reduce with count B * H * Wf.
int ffc_fu_mix_stats(int dtype, const float* z, const void* k, float* partial, int B,
                     int C, int H, int W, int chunks, void* stream) {
  if (bad_plane(B, C, H, W) || chunks < 1) return cudaErrorInvalidValue;
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return by_width(2 * C, [&](auto rd) {
      constexpr int RD = decltype(rd)::value;
      fu_mix_stats_kernel<T, RD><<<dim3(chunks, B), kThreads, mix_smem_bytes(2 * C, 1, 0),
                                   static_cast<cudaStream_t>(stream)>>>(
          z, static_cast<const T*>(k), partial, H, W, chunks);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// dtype of K. z, g: (B, 2C, H, Wf) float32, g = DFT(gy) (read only); mean,
// var: the batch statistics; partial: (B * chunks, 4C) float32, rows of
// [sum gpre * n | sum gpre] for fu_reduce (count 0): gscale and gbias.
int ffc_fu_bwd_stats_mix(int dtype, const float* z, const float* g, const void* k,
                         const float* scale, const float* bias, const float* mean,
                         const float* var, float* partial, int B, int C, int H, int W,
                         int chunks, void* stream) {
  if (bad_plane(B, C, H, W) || chunks < 1) return cudaErrorInvalidValue;
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return by_width(2 * C, [&](auto rd) {
      constexpr int RD = decltype(rd)::value;
      fu_bwd_stats_mix_kernel<T, RD><<<dim3(chunks, B), kThreads,
                                       mix_smem_bytes(2 * C, 2, 4),
                                       static_cast<cudaStream_t>(stream)>>>(
          z, g, static_cast<const T*>(k), scale, bias, mean, var, partial, H, W, chunks);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

const char* ffc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
