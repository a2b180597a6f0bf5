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
// transforms take two kinds of plane. Power-of-two planes (the 64px and
// 128px generators' maps) run radix-2 FFTs in shared memory: the
// W-stage rDFT packs a row's even and odd samples as one complex sequence of
// length W/2 (decimation in time, rows stored bit-reversed as they are
// loaded) and untangles it in place into the Wf = W/2 + 1 half-spectrum
// columns; the H-stage runs over those columns. The inverse mirrors it with
// decimation in frequency (natural input, bit-reversed output, undone as y
// is written), so each plane needs one buffer of H x Wf complex values
// (66.5 KB at 128 x 128) and its twiddles (double precision, rounded to
// f32). A power-of-two plane whose buffer exceeds a block's shared memory
// (the 256px generator's 256 x 256, 266,240 B) is split over H on a
// cluster of two blocks (fu_spectrum_split_kernel, fu_inverse_split_kernel,
// see "Split planes" below): each holds half the rows, 134,144 B at 256 x
// 256, and runs the same passes at half the column length; a plane whose
// half still exceeds it (512 x 512) no staged kernel takes. Other planes
// of an even W (the 96px generator's 96 x 96) run dense DFT stages:
// fu_spectrum_dense_kernel and fu_inverse_dense_kernel, one block of
// kItemThreads per plane, bring the plane and the plain version's
// factor tables (ops/fourier_unit.py, _item_tables: cw, dw, ah, bh) into
// shared memory with cp.async and run the clustered kernels' register-tiled
// stages of fourier_unit_item.cuh on a geometry of one channel on one rank
// (item_dft_w then item_dft_h<false>; the inverse item_dft_h<true> then
// item_idft_w, the tables' transposes). A plane takes two spectrum-pair
// buffers and the tables (DensePlan): 186,624 B at 96 x 96, one block per
// SM. The mix stages keep K (row stride 2C + 1) and the tile (stride 65)
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
// are bound by shared-memory traffic (about 10 accesses per butterfly; a
// split plane adds one exchange of half its values a rank over distributed
// shared memory, and still reads and writes each value of device memory
// once), the dense stages by their FMAs and the shared-memory loads that
// feed them (2.7 M FMAs a 96 x 96 plane, 0.4-0.75 loads per FMA in the
// tiles), the mix stages by their shared-memory loads (0.5 per FMA). The statistics
// stages at (64, 32, 128, 128): fu_mix_stats reads z (136 MB, 0.041 ms) and
// does 2 (2C)^2 B H Wf = 4.4 GFLOP of f32 FMAs (0.065 ms at 67 TFLOP/s), so
// operations bound it; fu_bwd_stats_mix reads z and G (0.081 ms) and does
// the same FMAs, so bytes bound it.

#include "fourier_unit_item.cuh"

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

// tw[k] = exp(-2 pi i k / n) for k < n / 2, in double rounded to f32 (no
// sync). The radix-2 helpers below take kBlock, the block's threads.
template <int kBlock = kThreads>
__device__ __forceinline__ void fill_twiddles(float2* tw, int n) {
  for (int k = threadIdx.x; k < n / 2; k += kBlock) {
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
template <bool kDit, bool kInverse, bool kRows, int kBlock = kThreads>
__device__ void fft_pass(float2* buf, int count, int seq_stride, int elem_stride,
                         int log2n, const float2* tw, int tw_step) {
  const int half_n = 1 << (log2n - 1);
  const int total = count * half_n;
  for (int st = 0; st < log2n; ++st) {
    const int lh = kDit ? st : log2n - 1 - st;  // butterfly span 2^lh
    const int span = 1 << lh;
    const int tw_mul = (half_n >> lh) * tw_step;
    for (int idx = threadIdx.x; idx < total; idx += kBlock) {
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

// The shared memory of a radix-2 plane on `ranks` blocks (1, or 2 on a
// split plane), per block: its H/ranks x Wf complex values (row stride Wf),
// then the W and the H twiddles. The host mirrors it (ops/fourier_unit.py,
// _radix2_plane_floats).
struct PlaneBufs {
  float2 *buf, *tw_w, *tw_h;
  __device__ PlaneBufs(float2* base, int rows, int W)
      : buf(base), tw_w(base + rows * (W / 2 + 1)), tw_h(base + rows * (W / 2 + 1) + W / 2) {}
};

__host__ __device__ inline size_t plane_smem_bytes(int H, int W, int ranks = 1) {
  return (static_cast<size_t>(H / ranks) * (W / 2 + 1) + W / 2 + H / 2) * sizeof(float2);
}

// Rows [0, rows) of a real map (row length W = 2n, row stride W) into buf:
// row h's samples (2k, 2k+1) as complex k, at row bitrev(h), column
// bitrev(k), the input order of both decimation-in-time passes (no sync).
template <int kBlock = kThreads, typename T>
__device__ __forceinline__ void load_rows(float2* buf, const T* src, int rows, int log2rows,
                                          int wf, int log2n) {
  const int n = 1 << log2n;
  for (int i = threadIdx.x; i < rows * n; i += kBlock) {
    const int h = i >> log2n, k = i & (n - 1);
    buf[bit_reverse(h, log2rows) * wf + bit_reverse(k, log2n)] =
        make_float2(load_f32(src + 2 * i), load_f32(src + 2 * i + 1));
  }
}

// The W-stage of the forward over the rows of buf that load_rows filled:
// each row's half-length transform Z, untangled in place into the rDFT X
// over W: with E = (Z[k] + conj Z[n-k]) / 2 and O = (Z[k] - conj Z[n-k]) /
// 2i, X[k] = E + w^k O and X[n-k] = conj(E - w^k O), w = exp(-2 pi i / W).
// kTwist: row r, which holds map row h = bitrev(r), also times tw_h[h] (the
// odd rank of a split plane). Ends on a barrier.
template <bool kTwist, int kBlock = kThreads>
__device__ __forceinline__ void rdft_rows(float2* buf, int rows, int log2rows, int wf,
                                          int log2n, const float2* tw_w, const float2* tw_h) {
  const int n = 1 << log2n;
  fft_pass<true, false, true, kBlock>(buf, rows, wf, 1, log2n, tw_w, 2);
  const int pairs = n / 2 + 1;
  for (int i = threadIdx.x; i < rows * pairs; i += kBlock) {
    const int r = i / pairs, k = i - r * pairs;
    float2* row = buf + r * wf;
    const float2 zk = row[k], znk = row[(n - k) & (n - 1)];
    const float2 e = make_float2(0.5f * (zk.x + znk.x), 0.5f * (zk.y - znk.y));
    const float2 o = make_float2(0.5f * (zk.y + znk.y), -0.5f * (zk.x - znk.x));
    const float2 wo = cmul(tw_w[k], o);
    float2 lo = cadd(e, wo), hi = cconj(csub(e, wo));
    if constexpr (kTwist) {
      const float2 t = tw_h[bit_reverse(r, log2rows)];
      lo = cmul(lo, t);
      hi = cmul(hi, t);
    }
    row[k] = lo;
    row[n - k] = hi;
  }
  __syncthreads();
}

// The W-stage of the inverse over the rows of buf: each row T[0..n] to the
// half-length sequence whose inverse transform gives the real row: with
// X[0] = Re T[0], X[n] = Re T[n], X[v] = T[v] / 2 between (the Hermitian
// spectrum whose real inverse is the sum of Re(T[v] exp(+2 pi i q v / W))
// over v <= n), A = X[k] + conj X[n-k], B = X[k] - conj X[n-k], u = exp(+2
// pi i k / W): Z[k] = A + i u B and Z[n-k] = conj(A - i u B); then the
// inverse transform, row q's sample (2k, 2k+1) landing at column bitrev(k).
// Ends on a barrier.
template <int kBlock = kThreads>
__device__ __forceinline__ void irdft_rows(float2* buf, int rows, int wf, int log2n,
                                           const float2* tw_w) {
  const int n = 1 << log2n, pairs = n / 2 + 1;
  for (int i = threadIdx.x; i < rows * pairs; i += kBlock) {
    const int r = i / pairs, k = i - r * pairs;
    float2* row = buf + r * wf;
    const float2 tk = row[k], tnk = row[n - k];
    const float2 xk = k == 0 ? make_float2(tk.x, 0.f) : cscale(tk, 0.5f);
    const float2 xnk = k == 0 ? make_float2(tnk.x, 0.f) : cscale(tnk, 0.5f);
    const float2 a = make_float2(xk.x + xnk.x, xk.y - xnk.y);
    const float2 bb = make_float2(xk.x - xnk.x, xk.y + xnk.y);
    const float2 ub = cmul(cconj(tw_w[k]), bb);
    const float2 iub = make_float2(-ub.y, ub.x);
    row[k] = cadd(a, iub);
    if (k != 0) row[n - k] = cconj(csub(a, iub));
  }
  __syncthreads();
  fft_pass<false, true, true, kBlock>(buf, rows, wf, 1, log2n, tw_w, 2);
}

// The rows of buf, scaled by `ortho`, as rows row0, row0 + kStep, ... of
// the [re | im] planes o_re and o_im (row stride wf; no sync). With kStep 1
// the rows are contiguous, and no element's row is worked out.
template <int kStep, int kBlock = kThreads>
__device__ __forceinline__ void store_spectrum(float* o_re, float* o_im, const float2* buf,
                                               int rows, int wf, int row0, float ortho) {
  for (int i = threadIdx.x; i < rows * wf; i += kBlock) {
    size_t at = static_cast<size_t>(row0) * wf + i;
    if constexpr (kStep != 1) {
      const int q = i / wf;
      at = static_cast<size_t>(row0 + kStep * q) * wf + (i - q * wf);
    }
    const float2 x = buf[i];
    o_re[at] = x.x * ortho;
    o_im[at] = x.y * ortho;
  }
}

// Row q of the result held at buf row bitrev(q), its sample pair k at
// column bitrev(k), scaled by `ortho`, as row row0 + kStep * q of the real
// map y (row length 2n; no sync).
template <int kStep, int kBlock = kThreads, typename T>
__device__ __forceinline__ void store_rows(T* y, const float2* buf, int rows, int log2rows,
                                           int wf, int log2n, int row0, float ortho) {
  const int n = 1 << log2n;
  for (int i = threadIdx.x; i < rows * n; i += kBlock) {
    const int q = i >> log2n, k = i & (n - 1);
    const float2 v = buf[bit_reverse(q, log2rows) * wf + bit_reverse(k, log2n)];
    T* out = y + static_cast<size_t>(row0) * 2 * n + 2 * i;
    if constexpr (kStep != 1) out = y + static_cast<size_t>(row0 + kStep * q) * 2 * n + 2 * k;
    store_f32(out, v.x * ortho);
    store_f32(out + 1, v.y * ortho);
  }
}

// The [re | im] planes of (map, plane) in the (n_maps, B, 2C, H, Wf) spectra.
__device__ __forceinline__ float* spectrum_planes(float* out, int map, int planes, int plane,
                                                  int C, size_t S) {
  const int b = plane / C, c = plane - b * C;
  return out + (static_cast<size_t>(map) * planes * 2 + static_cast<size_t>(b) * 2 * C + c) * S;
}

__device__ __forceinline__ float ortho_scale(int H, int W) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(H) * W));
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
  const int wf = W / 2 + 1, log2n = log2w - 1;
  const int map = blockIdx.x / planes, plane = blockIdx.x - map * planes;
  const T* src = (map == 0 ? x0 : x1) + static_cast<size_t>(plane) * H * W;

  fill_twiddles(pb.tw_w, W);
  fill_twiddles(pb.tw_h, H);
  load_rows(pb.buf, src, H, log2h, wf, log2n);
  __syncthreads();
  rdft_rows<false>(pb.buf, H, log2h, wf, log2n, pb.tw_w, nullptr);
  fft_pass<true, false, false>(pb.buf, wf, 1, wf, log2h, pb.tw_h, 1);

  const size_t S = static_cast<size_t>(H) * wf;
  float* o_re = spectrum_planes(out, map, planes, plane, C, S);
  store_spectrum<1>(o_re, o_re + C * S, pb.buf, H, wf, 0, ortho_scale(H, W));
}

// y = Re(eh . R . fw^T) / sqrt(HW) per plane of the (B, 2C, H, Wf) spectrum
// spec (no half-spectrum weights); grid B * C.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fu_inverse_kernel(const float* __restrict__ spec, T* __restrict__ y, int C, int H,
                  int W, int log2h, int log2w) {
  extern __shared__ float4 smem_f4[];
  const PlaneBufs pb(reinterpret_cast<float2*>(smem_f4), H, W);
  const int wf = W / 2 + 1, log2n = log2w - 1;
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
  irdft_rows(pb.buf, H, wf, log2n, pb.tw_w);
  store_rows<1>(y + static_cast<size_t>(plane) * H * W, pb.buf, H, log2h, wf, log2n, 0,
                ortho_scale(H, W));
}

// Split planes. Where one block cannot hold an H x Wf plane, the plane runs
// on a cluster of two blocks, each holding half of it: the first radix-2
// stage over H, taken out of the column transform. Forward (decimation in
// frequency over H), rows h < H/2: rank 0 transforms a[h] = x[h] + x[h+H/2]
// and gets the even output rows X[2q], rank 1 d[h] = x[h] - x[h+H/2], times
// exp(-2 pi i h / H) after its W-stage, and gets X[2q+1], each by the row
// rDFT and length-H/2 column transforms. Inverse: A[k] = X[k] + X[k+H/2] on
// rank 0 gives y rows 2q, B[k] = (X[k] - X[k+H/2]) exp(+2 pi i k / H) on
// rank 1 rows 2q+1, by length-H/2 inverse column transforms and the row
// pass. Each rank loads only its own half of the plane from device memory
// (rows [rank H/2, (rank+1) H/2)), with plain loads, since they scatter to
// bit-reversed or interleaved positions; after a cluster barrier each rank
// takes half of the positions and, for each, reads the value of both ranks
// (its partner's over distributed shared memory) and writes the two
// combinations back, one to each rank. Every position is read and written
// by one thread of the cluster, so no barrier separates the reads from the
// writes; a second cluster barrier ends the exchange, after which each rank
// works in its own shared memory, and no rank exits while its partner may
// still reach its buffer. A split block holds 134 KB at 256 x 256, so one
// runs per SM: it takes kSplitThreads threads, 32 warps, to cover the
// latencies of its shared-memory passes and barriers, which the one-block
// path's smaller planes cover with several blocks of kThreads per SM.
constexpr int kSplitThreads = 1024;

// Over positions i = rows * n or rows * wf of the two ranks' buffers b0 and
// b1 (the rank's half of them): (v0, v1) -> (v0 + v1, twist(i, v0 - v1)).
template <int kBlock, typename Pos, typename Twist>
__device__ __forceinline__ void exchange_halves(cg::cluster_group& cluster, float2* buf,
                                                int positions, Pos pos, Twist twist) {
  const int rank = static_cast<int>(cluster.block_rank());
  float2* peer = cluster.map_shared_rank(buf, rank ^ 1);
  float2* b0 = rank == 0 ? buf : peer;
  float2* b1 = rank == 0 ? peer : buf;
  const int half = positions / 2, first = rank * half;
  copy_in_flight<float4, kBlock>(
      rank == 0 ? half : positions - half,
      [=](int i) {
        const int p = pos(first + i);
        const float2 v0 = b0[p], v1 = b1[p];
        return make_float4(v0.x, v0.y, v1.x, v1.y);
      },
      [=](int i, float4 v) {
        const int j = first + i, p = pos(j);
        const float2 v0 = make_float2(v.x, v.y), v1 = make_float2(v.z, v.w);
        b0[p] = cadd(v0, v1);
        b1[p] = twist(j, csub(v0, v1));
      });
  cluster.sync();
}

// fu_spectrum_kernel on split planes: grid 2 * n_maps * planes, clusters of
// 2 along x, each cluster one plane.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
fu_spectrum_split_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                         float* __restrict__ out, int planes, int C, int H, int W,
                         int log2h, int log2w) {
  extern __shared__ float4 smem_f4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = H / 2, log2rows = log2h - 1;
  const PlaneBufs pb(reinterpret_cast<float2*>(smem_f4), rows, W);
  const int wf = W / 2 + 1, log2n = log2w - 1, n = W / 2;
  const int id = blockIdx.x / 2, map = id / planes, plane = id - map * planes;
  const T* src = (map == 0 ? x0 : x1) + static_cast<size_t>(plane) * H * W;

  fill_twiddles<kSplitThreads>(pb.tw_w, W);
  fill_twiddles<kSplitThreads>(pb.tw_h, H);
  load_rows<kSplitThreads>(pb.buf, src + static_cast<size_t>(rank) * rows * W, rows, log2rows,
                           wf, log2n);
  cluster.sync();
  // a on rank 0, d on rank 1, at the positions load_rows filled
  exchange_halves<kSplitThreads>(
      cluster, pb.buf, rows * n, [=](int i) { return (i >> log2n) * wf + (i & (n - 1)); },
      [](int, float2 v) { return v; });
  if (rank == 0) {
    rdft_rows<false, kSplitThreads>(pb.buf, rows, log2rows, wf, log2n, pb.tw_w, pb.tw_h);
  } else {
    rdft_rows<true, kSplitThreads>(pb.buf, rows, log2rows, wf, log2n, pb.tw_w, pb.tw_h);
  }
  fft_pass<true, false, false, kSplitThreads>(pb.buf, wf, 1, wf, log2rows, pb.tw_h, 2);

  const size_t S = static_cast<size_t>(H) * wf;
  float* o_re = spectrum_planes(out, map, planes, plane, C, S);
  store_spectrum<2, kSplitThreads>(o_re, o_re + C * S, pb.buf, rows, wf, rank,
                                   ortho_scale(H, W));
}

// fu_inverse_kernel on split planes: grid 2 * B * C, clusters of 2 along x.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
fu_inverse_split_kernel(const float* __restrict__ spec, T* __restrict__ y, int C, int H,
                        int W, int log2h, int log2w) {
  extern __shared__ float4 smem_f4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = H / 2, log2rows = log2h - 1;
  const PlaneBufs pb(reinterpret_cast<float2*>(smem_f4), rows, W);
  const int wf = W / 2 + 1, log2n = log2w - 1;
  const int plane = blockIdx.x / 2, b = plane / C, d = plane - b * C;
  const size_t S = static_cast<size_t>(H) * wf;
  const float* s_re = spec + (static_cast<size_t>(b) * 2 * C + d) * S + rank * rows * wf;
  const float* s_im = s_re + C * S;

  fill_twiddles<kSplitThreads>(pb.tw_w, W);
  fill_twiddles<kSplitThreads>(pb.tw_h, H);
  for (int i = threadIdx.x; i < rows * wf; i += kSplitThreads)
    pb.buf[i] = make_float2(s_re[i], s_im[i]);
  cluster.sync();
  // A on rank 0, B on rank 1 (row k times exp(+2 pi i k / H))
  const float2* tw_h = pb.tw_h;
  exchange_halves<kSplitThreads>(cluster, pb.buf, rows * wf, [](int i) { return i; },
                                 [=](int i, float2 v) { return cmul(cconj(tw_h[i / wf]), v); });
  fft_pass<false, true, false, kSplitThreads>(pb.buf, wf, 1, wf, log2rows, pb.tw_h, 2);
  irdft_rows<kSplitThreads>(pb.buf, rows, wf, log2n, pb.tw_w);
  store_rows<2, kSplitThreads>(y + static_cast<size_t>(plane) * H * W, pb.buf, rows, log2rows,
                               wf, log2n, rank, ortho_scale(H, W));
}

// The dense plane path's shared memory, in floats (16-byte aligned
// regions) of the geometry k of one channel on one rank: the host mirrors
// it (ops/fourier_unit.py, _dense_plane_floats).
struct DensePlan {
  int a, b, tab, total;
  __host__ __device__ explicit DensePlan(const ItemRank& k) {
    a = 0;                             // the plane in f32 (row stride wp), then z
    b = a + k.buf();                   // the plane as loaded, then the W-stage's output
    tab = b + k.buf();                 // cw, dw, ah, bh
    total = tab + round4(k.tables());  // 46,656 floats at 96 x 96
  }
};

// out[map] = [re | im] orthonormal rDFT of each plane of x_map, as
// fu_spectrum_kernel, by dense stages; grid n_maps * planes.
template <typename T>
__global__ void __launch_bounds__(kItemThreads)
fu_spectrum_dense_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                         const float* __restrict__ tables, float* __restrict__ out,
                         int planes, int C, int H, int W) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const ItemRank k(1, H, W, 1);
  const DensePlan pl(k);
  float* a = smem + pl.a;
  float* b = smem + pl.b;
  const ItemTables tab(smem + pl.tab, k);
  const int map = blockIdx.x / planes, plane = blockIdx.x - map * planes;
  const T* src = (map == 0 ? x0 : x1) + static_cast<size_t>(plane) * H * W;

  // The plane (as it is into b, asynchronously, where it is whole 16-byte
  // units) and the tables; then the plane in f32 into a.
  const int map_bytes = H * W * static_cast<int>(sizeof(T));
  const bool units = in_units(src, map_bytes);
  if (units) copy_async(b, src, map_bytes);
  copy_tables(smem + pl.tab, tables, k.tables());
  wait_async();
  __syncthreads();
  if (units) {
    unpack_planes(a, reinterpret_cast<const T*>(b), k);
  } else {
    load_planes(a, src, k);
  }
  __syncthreads();
  // rDFT over W into b, DFT over H into a: the plane's [re | im] spectrum.
  item_dft_w(a, b, tab, k);
  __syncthreads();
  item_dft_h<false>(b, a, tab, k);
  __syncthreads();

  const int bi = plane / C, c = plane - bi * C;
  const size_t S = k.hwf;
  float* o_re = out + (static_cast<size_t>(map) * planes * 2 +
                       static_cast<size_t>(bi) * 2 * C + c) * S;
  float* o_im = o_re + C * S;
  for (int i = threadIdx.x; i < k.hwf; i += kItemThreads) {
    o_re[i] = a[i];
    o_im[i] = a[k.ns + i];
  }
}

// y = Re(eh . R . fw^T) per plane of spec, as fu_inverse_kernel, by dense
// stages; grid B * C.
template <typename T>
__global__ void __launch_bounds__(kItemThreads)
fu_inverse_dense_kernel(const float* __restrict__ spec, const float* __restrict__ tables,
                        T* __restrict__ y, int C, int H, int W) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const ItemRank k(1, H, W, 1);
  const DensePlan pl(k);
  float* a = smem + pl.a;
  float* b = smem + pl.b;
  const ItemTables tab(smem + pl.tab, k);
  const int plane = blockIdx.x, bi = plane / C, d = plane - bi * C;
  const size_t S = k.hwf;
  const float* s_re = spec + (static_cast<size_t>(bi) * 2 * C + d) * S;
  const float* s_im = s_re + C * S;

  // The plane's [re | im] spectrum into a, and the tables.
  const int plane_bytes = k.hwf * static_cast<int>(sizeof(float));
  if (in_units(s_re, plane_bytes) && in_units(s_im, plane_bytes)) {
    copy_async(a, s_re, plane_bytes);
    copy_async(a + k.ns, s_im, plane_bytes);
  } else {
    for (int i = threadIdx.x; i < k.hwf; i += kItemThreads) {
      a[i] = s_re[i];
      a[k.ns + i] = s_im[i];
    }
  }
  copy_tables(smem + pl.tab, tables, k.tables());
  wait_async();
  __syncthreads();
  // Inverse DFT over H into b, then the inverse rDFT over W writes y.
  item_dft_h<true>(a, b, tab, k);
  __syncthreads();
  item_idft_w(b, y + static_cast<size_t>(plane) * H * W, tab, k);
}

size_t dense_smem_bytes(int H, int W) {
  return static_cast<size_t>(DensePlan(ItemRank(1, H, W, 1)).total) * sizeof(float);
}

// The (ROWS, kTile) slice [s0, s0 + kTile) of a (ROWS, S) spectrum into a tile
// of row stride kTileP, zeros past S (no sync).
template <int ROWS>
__device__ __forceinline__ void load_tile(float* tile, const float* src, int S, int s0) {
  for (int i = threadIdx.x; i < ROWS * kTile; i += kThreads) {
    const int j = i / kTile, s = i % kTile;
    tile[j * kTileP + s] = s0 + s < S ? src[static_cast<size_t>(j) * S + s0 + s] : 0.f;
  }
}

// Output o = ty + 16 i of a thread's tile row i, among `n` outputs: where n
// is a multiple of 16 every one is real; else (an out-width of 4 or 8 on an
// out-channel slice) the rows past n repeat the last, which the callers
// neither write nor sum.
template <int N>
__device__ __forceinline__ int out_row(int ty, int i) {
  if constexpr (N % 16 == 0) {
    return ty + 16 * i;
  } else {
    return min(ty + 16 * i, N - 1);
  }
}

// acc[i][k] = sum_j K(j, o) t[j][s] over the NSUM rows j of the tile t, for
// the thread's outputs o = out_row<NOUT>(ty, i) (i < R) and s = tx + 16 k.
// ks holds K (C2 x CO2, row stride CO2 + 1). kTransposed: K(j, o) = ks[o][j]
// (gz = gm @ K^T: NSUM = CO2, NOUT = C2); else ks[j][o] (m = z @ K: NSUM =
// C2, NOUT = CO2).
template <int R, int NSUM, int NOUT, int KP, bool kTransposed>
__device__ __forceinline__ void mix_tile(float (&acc)[R][4], const float* t, const float* ks) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int o[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    o[i] = out_row<NOUT>(ty, i);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
  }
#pragma unroll 4
  for (int j = 0; j < NSUM; ++j) {
    float tv[4], kv[R];
#pragma unroll
    for (int k = 0; k < 4; ++k) tv[k] = t[j * kTileP + tx + 16 * k];
#pragma unroll
    for (int i = 0; i < R; ++i) kv[i] = kTransposed ? ks[o[i] * KP + j] : ks[j * KP + o[i]];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(tv[k], kv[i], acc[i][k]);
  }
}

// K (C2, CO2) into ks with row stride CO2 + 1 (no sync).
template <int C2, int CO2, typename T>
__device__ __forceinline__ void load_k(float* ks, const T* kmix) {
  for (int i = threadIdx.x; i < C2 * CO2; i += kThreads)
    ks[(i / CO2) * (CO2 + 1) + i % CO2] = load_f32(kmix + i);
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

// The mix stages take z of C2 = 2C channels and K (C2, CO2): CO2 = 2Co is
// C2, or C2 / 2 or C2 / 4 on an out-channel slice (fourier_unit_item.cuh);
// a thread owns RO = ceil(CO2 / 16) rows of the CO2 outputs (RD = C2 / 16
// of the C2 rows of gz and of gK).
template <int C2, int CO2>
struct MixDims {
  static constexpr int RD = C2 / 16, RO = (CO2 + 15) / 16;
};

// r = c * ReLU((z @ K - mean) * inv * scale + bias), (B, CO2, H, Wf); grid
// (chunks, B).
template <typename T, int C2, int CO2>
__global__ void __launch_bounds__(kThreads)
fu_mix_apply_kernel(const float* __restrict__ z, const T* __restrict__ kmix,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const float* __restrict__ mean, const float* __restrict__ var,
                    float* __restrict__ r, int H, int W, int chunks) {
  constexpr int RO = MixDims<C2, CO2>::RO;
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);  // K, row stride CO2 + 1
  float* zt = ks + C2 * (CO2 + 1);                // the z tile
  float* v_mean = zt + C2 * kTileP;
  float* v_inv = v_mean + CO2;
  float* v_scale = v_inv + CO2;
  float* v_bias = v_scale + CO2;
  const int wf = W / 2 + 1, S = H * wf;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t item = blockIdx.y;
  const float* zb = z + item * C2 * S;
  float* rb = r + item * CO2 * S;
  int t0, t1;
  tile_run(S, chunks, t0, t1);

  load_k<C2, CO2>(ks, kmix);
  for (int d = threadIdx.x; d < CO2; d += kThreads) {
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
    float acc[RO][4];
    mix_tile<RO, C2, CO2, CO2 + 1, false>(acc, zt, ks);
#pragma unroll
    for (int i = 0; i < RO; ++i) {
      const int d = ty + 16 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = s0 + tx + 16 * k;
        if (s < S && d < CO2) {
          const float pre = (acc[i][k] - v_mean[d]) * v_inv[d] * v_scale[d] + v_bias[d];
          rb[static_cast<size_t>(d) * S + s] = fmaxf(pre, 0.f) * weight_of(s, wf);
        }
      }
    }
  }
}

// The backward apply's mix stage (see the file's note): g holds G (CO2
// channels), gz (C2 channels) gets gm @ K^T, over g itself where CO2 = C2;
// partial row item * chunks + chunk gets the block's gK sum (C2 x CO2).
// Grid (chunks, B).
template <typename T, int C2, int CO2>
__global__ void __launch_bounds__(kThreads)
fu_bwd_mix_kernel(const float* __restrict__ z, const float* g, float* gz,
                  const T* __restrict__ kmix, const float* __restrict__ scale,
                  const float* __restrict__ bias, const float* __restrict__ mean,
                  const float* __restrict__ var, const float* __restrict__ gscale,
                  const float* __restrict__ gbias, float* __restrict__ partial, int H,
                  int W, int chunks, float count) {
  constexpr int RD = MixDims<C2, CO2>::RD, RO = MixDims<C2, CO2>::RO;
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);
  float* zt = ks + C2 * (CO2 + 1);  // the z tile
  float* gt = zt + C2 * kTileP;     // the G tile, then gm
  float* v_mean = gt + CO2 * kTileP;
  float* v_inv = v_mean + CO2;
  float* v_scale = v_inv + CO2;
  float* v_bias = v_scale + CO2;
  float* v_mgn = v_bias + CO2;
  float* v_mgnn = v_mgn + CO2;
  const int wf = W / 2 + 1, S = H * wf;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t item = blockIdx.y;
  const float* zb = z + item * C2 * S;
  const float* gb = g + item * CO2 * S;
  float* gzb = gz + item * C2 * S;
  int t0, t1;
  tile_run(S, chunks, t0, t1);

  load_k<C2, CO2>(ks, kmix);
  for (int d = threadIdx.x; d < CO2; d += kThreads) {
    v_mean[d] = mean[d];
    v_inv[d] = rsqrtf(var[d] + kEps);
    v_scale[d] = scale[d];
    v_bias[d] = bias[d];
    v_mgn[d] = scale[d] * gbias[d] / count;
    v_mgnn[d] = scale[d] * gscale[d] / count;
  }
  float gk[RD][RO];  // gK[ty + 16 a][tx + 16 b] over the run's positions
#pragma unroll
  for (int a = 0; a < RD; ++a)
#pragma unroll
    for (int bb = 0; bb < RO; ++bb) gk[a][bb] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int s0 = t * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_tile<C2>(zt, zb, S, s0);
    load_tile<CO2>(gt, gb, S, s0);
    __syncthreads();
    // gm in place of G: each thread reads and writes only its own entries.
    float acc[RO][4];
    mix_tile<RO, C2, CO2, CO2 + 1, false>(acc, zt, ks);
#pragma unroll
    for (int i = 0; i < RO; ++i) {
      const int d = ty + 16 * i;
      if (d >= CO2) continue;
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
    int e[RO];
#pragma unroll
    for (int bb = 0; bb < RO; ++bb) e[bb] = out_row<CO2>(tx, bb);
#pragma unroll 4
    for (int sl = 0; sl < kTile; ++sl) {
      float zv[RD], gv[RO];
#pragma unroll
      for (int a = 0; a < RD; ++a) zv[a] = zt[(ty + 16 * a) * kTileP + sl];
#pragma unroll
      for (int bb = 0; bb < RO; ++bb) gv[bb] = gt[e[bb] * kTileP + sl];
#pragma unroll
      for (int a = 0; a < RD; ++a)
#pragma unroll
        for (int bb = 0; bb < RO; ++bb) gk[a][bb] = fmaf(zv[a], gv[bb], gk[a][bb]);
    }
    // gz[j][s] = sum_e K[j][e] gm[e][s] over the CO2 channels e. Where gz
    // is g's storage, every block has read its G tile and writes only its
    // own positions.
    float acz[RD][4];
    mix_tile<RD, CO2, C2, CO2 + 1, true>(acz, gt, ks);
#pragma unroll
    for (int i = 0; i < RD; ++i) {
      const int j = ty + 16 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = s0 + tx + 16 * k;
        if (s < S) gzb[static_cast<size_t>(j) * S + s] = acz[i][k];
      }
    }
  }
  float* row = partial + (item * chunks + blockIdx.x) * C2 * CO2;
#pragma unroll
  for (int a = 0; a < RD; ++a)
#pragma unroll
    for (int bb = 0; bb < RO; ++bb)
      if (tx + 16 * bb < CO2) row[(ty + 16 * a) * CO2 + tx + 16 * bb] = gk[a][bb];
}

// v summed over the 16 threads of a half-warp (one ty, every tx) by a fixed
// butterfly; every lane gets the same bits (a + b == b + a).
__device__ __forceinline__ float tx_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// row[d] = the block's sum of a, row[CO2 + d] = of b, for the thread's
// channels d = ty + 16 i < CO2; every thread of the block takes part.
template <int RO, int CO2>
__device__ __forceinline__ void write_sums(float* row, const float (&a)[RO],
                                           const float (&b)[RO]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RO; ++i) {
    const float sa = tx_sum(a[i]), sb = tx_sum(b[i]);
    if (tx == 0 && ty + 16 * i < CO2) {
      row[ty + 16 * i] = sa;
      row[CO2 + ty + 16 * i] = sb;
    }
  }
}

// Row item * chunks + chunk of `partial` gets [sum m | sum m^2] (CO2 each)
// over the block's run of tiles, m = z @ K; grid (chunks, B). Positions past
// S sit in the tile as zeros, so their m is 0 and adds nothing.
template <typename T, int C2, int CO2>
__global__ void __launch_bounds__(kThreads)
fu_mix_stats_kernel(const float* __restrict__ z, const T* __restrict__ kmix,
                    float* __restrict__ partial, int H, int W, int chunks) {
  constexpr int RO = MixDims<C2, CO2>::RO;
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);  // K, row stride CO2 + 1
  float* zt = ks + C2 * (CO2 + 1);                // the z tile
  const int S = H * (W / 2 + 1);
  const size_t item = blockIdx.y;
  const float* zb = z + item * C2 * S;
  int t0, t1;
  tile_run(S, chunks, t0, t1);

  load_k<C2, CO2>(ks, kmix);
  float s1[RO], s2[RO];
#pragma unroll
  for (int i = 0; i < RO; ++i) s1[i] = s2[i] = 0.f;
  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<C2>(zt, zb, S, t * kTile);
    __syncthreads();
    float acc[RO][4];
    mix_tile<RO, C2, CO2, CO2 + 1, false>(acc, zt, ks);
#pragma unroll
    for (int i = 0; i < RO; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s1[i] += acc[i][k];
        s2[i] = fmaf(acc[i][k], acc[i][k], s2[i]);
      }
  }
  write_sums<RO, CO2>(partial + (item * chunks + blockIdx.x) * 2 * CO2, s1, s2);
}

// Row item * chunks + chunk of `partial` gets [sum gpre * n | sum gpre] (CO2
// each) over the block's run of tiles (see the file's note); grid (chunks, B).
template <typename T, int C2, int CO2>
__global__ void __launch_bounds__(kThreads)
fu_bwd_stats_mix_kernel(const float* __restrict__ z, const float* __restrict__ g,
                        const T* __restrict__ kmix, const float* __restrict__ scale,
                        const float* __restrict__ bias, const float* __restrict__ mean,
                        const float* __restrict__ var, float* __restrict__ partial, int H,
                        int W, int chunks) {
  constexpr int RO = MixDims<C2, CO2>::RO;
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);
  float* zt = ks + C2 * (CO2 + 1);  // the z tile
  float* gt = zt + C2 * kTileP;     // the G tile
  float* v_mean = gt + CO2 * kTileP;
  float* v_inv = v_mean + CO2;
  float* v_scale = v_inv + CO2;
  float* v_bias = v_scale + CO2;
  const int wf = W / 2 + 1, S = H * wf;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t item = blockIdx.y;
  const float* zb = z + item * C2 * S;
  const float* gb = g + item * CO2 * S;
  int t0, t1;
  tile_run(S, chunks, t0, t1);

  load_k<C2, CO2>(ks, kmix);
  for (int d = threadIdx.x; d < CO2; d += kThreads) {
    v_mean[d] = mean[d];
    v_inv[d] = rsqrtf(var[d] + kEps);
    v_scale[d] = scale[d];
    v_bias[d] = bias[d];
  }
  float s_gn[RO], s_g[RO];
#pragma unroll
  for (int i = 0; i < RO; ++i) s_gn[i] = s_g[i] = 0.f;
  for (int t = t0; t < t1; ++t) {
    const int s0 = t * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_tile<C2>(zt, zb, S, s0);
    load_tile<CO2>(gt, gb, S, s0);
    __syncthreads();
    float acc[RO][4];
    mix_tile<RO, C2, CO2, CO2 + 1, false>(acc, zt, ks);
#pragma unroll
    for (int i = 0; i < RO; ++i) {
      const int d = out_row<CO2>(ty, i);
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
  write_sums<RO, CO2>(partial + (item * chunks + blockIdx.x) * 2 * CO2, s_gn, s_g);
}

// Dynamic shared memory of a mix stage: K (C2 rows of stride CO2 + 1), tiles
// of `tile_rows` rows of kTileP and `vectors` (CO2,) vectors.
size_t mix_smem_bytes(int C2, int CO2, int tile_rows, int vectors) {
  return (static_cast<size_t>(C2) * (CO2 + 1) + static_cast<size_t>(tile_rows) * kTileP +
          static_cast<size_t>(vectors) * CO2) * sizeof(float);
}

int log2_exact(int v) {
  if (v < 4 || (v & (v - 1)) != 0) return -1;
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// Calls f(std::integral_constant<int, C2>(), std::integral_constant<int,
// CO2>()) for C2 = 2C in {16, 32, 64, 128} and CO2 = 2Co = C2 / T, T in {1,
// 2, 4}; cudaErrorInvalidValue for other widths.
template <int C2, typename F>
int by_slice(int CO2, F f) {
  if (CO2 == C2) return f(std::integral_constant<int, C2>(), std::integral_constant<int, C2>());
  if (CO2 == C2 / 2)
    return f(std::integral_constant<int, C2>(), std::integral_constant<int, C2 / 2>());
  if (CO2 == C2 / 4)
    return f(std::integral_constant<int, C2>(), std::integral_constant<int, C2 / 4>());
  return cudaErrorInvalidValue;
}

template <typename F>
int by_width(int C2, int CO2, F f) {
  switch (C2) {
    case 16: return by_slice<16>(CO2, f);
    case 32: return by_slice<32>(CO2, f);
    case 64: return by_slice<64>(CO2, f);
    case 128: return by_slice<128>(CO2, f);
    default: return cudaErrorInvalidValue;
  }
}

// Whether the radix-2 transforms take the plane: H and W powers of two.
bool radix2_plane(int H, int W) { return log2_exact(H) >= 0 && log2_exact(W) >= 0; }

// Maps no stage takes: every stage needs an even W (the half spectrum's
// Nyquist column), the mix stages nothing more.
bool bad_map(int B, int C, int H, int W) {
  return B <= 0 || C <= 0 || H <= 0 || W < 2 || W % 2 != 0;
}

// Planes neither transform takes: the dense stages need the factor tables,
// 16-byte aligned; a split plane (ranks 2) is a power-of-two plane of H >= 8.
bool bad_plane(int B, int C, int H, int W, const float* tables, int ranks) {
  return bad_map(B, C, H, W) || (ranks != 1 && ranks != 2) ||
         (ranks == 2 && (!radix2_plane(H, W) || H < 8)) ||
         (!radix2_plane(H, W) && (tables == nullptr || reinterpret_cast<size_t>(tables) % 16));
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
    if (e == 0) e = cudaFuncSetAttribute(fu_spectrum_split_kernel<T>, attr, bytes);
    if (e == 0) e = cudaFuncSetAttribute(fu_inverse_split_kernel<T>, attr, bytes);
    if (e == 0) e = cudaFuncSetAttribute(fu_spectrum_dense_kernel<T>, attr, bytes);
    if (e == 0) e = cudaFuncSetAttribute(fu_inverse_dense_kernel<T>, attr, bytes);
    for (int c2 = 16; c2 <= 128 && e == 0; c2 *= 2) {
      for (int t = 1; t <= 4 && e == 0; t *= 2) {
        e = by_width(c2, c2 / t, [&](auto ci, auto co) {
          constexpr int C2 = decltype(ci)::value, CO2 = decltype(co)::value;
          int err = cudaFuncSetAttribute(fu_mix_apply_kernel<T, C2, CO2>, attr, bytes);
          if (err == 0) err = cudaFuncSetAttribute(fu_bwd_mix_kernel<T, C2, CO2>, attr, bytes);
          if (err == 0) err = cudaFuncSetAttribute(fu_mix_stats_kernel<T, C2, CO2>, attr, bytes);
          if (err == 0)
            err = cudaFuncSetAttribute(fu_bwd_stats_mix_kernel<T, C2, CO2>, attr, bytes);
          return err;
        });
      }
    }
    return e;
  });
}

// Floats of shared memory of the dense plane path at (H, W).
long long ffc_dense_plane_floats(int H, int W) {
  return DensePlan(ItemRank(1, H, W, 1)).total;
}

// Floats of shared memory a block of the radix-2 plane path takes at (H, W)
// on `ranks` blocks a plane (1, or 2 on a split plane).
long long ffc_radix2_plane_floats(int H, int W, int ranks) {
  return static_cast<long long>(plane_smem_bytes(H, W, ranks) / sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16 (of x0, x1). out: (n_maps, B, 2C, H, Wf)
// float32, n_maps 1 (x1 unused) or 2. H and W powers of two (at least 4):
// the radix-2 kernel, tables unused, each plane on one block (ranks 1) or,
// split over H, on a cluster of two (ranks 2, H at least 8),
// ffc_radix2_plane_floats(H, W, ranks) * 4 bytes of shared memory a block;
// else W even, ranks 1 and tables the plane's factor tables (16-byte
// aligned; ops/fourier_unit.py, _item_tables): the dense kernel,
// ffc_dense_plane_floats(H, W) * 4 bytes. Every entry point returns a
// cudaError_t (0 on success).
int ffc_fu_spectrum(int dtype, const void* x0, const void* x1, const float* tables, float* out,
                    int n_maps, int B, int C, int H, int W, int ranks, void* stream) {
  if (bad_plane(B, C, H, W, tables, ranks) || n_maps < 1 || n_maps > 2 || (n_maps == 2 && !x1))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    if (ranks == 2) {
      return launch_clustered<kSplitThreads>(fu_spectrum_split_kernel<T>, 2 * n_maps * B * C, 2,
                              plane_smem_bytes(H, W, 2), s, static_cast<const T*>(x0),
                              static_cast<const T*>(x1), out, B * C, C, H, W, log2_exact(H),
                              log2_exact(W));
    }
    if (radix2_plane(H, W)) {
      fu_spectrum_kernel<T><<<n_maps * B * C, kThreads, plane_smem_bytes(H, W), s>>>(
          static_cast<const T*>(x0), static_cast<const T*>(x1), out, B * C, C, H, W,
          log2_exact(H), log2_exact(W));
    } else {
      fu_spectrum_dense_kernel<T><<<n_maps * B * C, kItemThreads, dense_smem_bytes(H, W), s>>>(
          static_cast<const T*>(x0), static_cast<const T*>(x1), tables, out, B * C, C, H, W);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// spec: (B, 2C, H, Wf) float32; y: (B, C, H, W) in dtype; planes, ranks and
// tables as for ffc_fu_spectrum.
int ffc_fu_inverse(int dtype, const float* spec, const float* tables, void* y, int B, int C,
                   int H, int W, int ranks, void* stream) {
  if (bad_plane(B, C, H, W, tables, ranks)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    if (ranks == 2) {
      return launch_clustered<kSplitThreads>(fu_inverse_split_kernel<T>, 2 * B * C, 2,
                              plane_smem_bytes(H, W, 2), s, spec, static_cast<T*>(y), C, H, W,
                              log2_exact(H), log2_exact(W));
    }
    if (radix2_plane(H, W)) {
      fu_inverse_kernel<T><<<B * C, kThreads, plane_smem_bytes(H, W), s>>>(
          spec, static_cast<T*>(y), C, H, W, log2_exact(H), log2_exact(W));
    } else {
      fu_inverse_dense_kernel<T><<<B * C, kItemThreads, dense_smem_bytes(H, W), s>>>(
          spec, tables, static_cast<T*>(y), C, H, W);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// dtype of K. z: (B, 2C, H, Wf) float32; K: (2C, 2Co); r: (B, 2Co, H, Wf)
// float32 (Co = C, or C/2 or C/4 on an out-channel slice); chunks >= 1 runs
// of tiles per item.
int ffc_fu_mix_apply(int dtype, const float* z, const void* k, const float* scale,
                     const float* bias, const float* mean, const float* var, float* r,
                     int B, int C, int Co, int H, int W, int chunks, void* stream) {
  if (bad_map(B, C, H, W) || Co <= 0 || chunks < 1) return cudaErrorInvalidValue;
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return by_width(2 * C, 2 * Co, [&](auto ci, auto co) {
      constexpr int C2 = decltype(ci)::value, CO2 = decltype(co)::value;
      fu_mix_apply_kernel<T, C2, CO2><<<dim3(chunks, B), kThreads,
                                        mix_smem_bytes(C2, CO2, C2, 4),
                                        static_cast<cudaStream_t>(stream)>>>(
          z, static_cast<const T*>(k), scale, bias, mean, var, r, H, W, chunks);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// dtype of K. z: (B, 2C, H, Wf) float32; g = DFT(gy): (B, 2Co, H, Wf) float32;
// gz: (B, 2C, H, Wf) float32, g itself where Co = C; partial: (B * chunks,
// 4C Co) float32; gscale, gbias: the reduced backward sums over `count`
// positions (B * H * Wf, or the global batch's under data parallelism).
int ffc_fu_bwd_mix(int dtype, const float* z, const float* g, float* gz, const void* k,
                   const float* scale, const float* bias, const float* mean,
                   const float* var, const float* gscale, const float* gbias,
                   float* partial, int B, int C, int Co, int H, int W, int chunks,
                   long long count, void* stream) {
  if (bad_map(B, C, H, W) || Co <= 0 || chunks < 1 || count <= 0 || (Co != C && g == gz))
    return cudaErrorInvalidValue;
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return by_width(2 * C, 2 * Co, [&](auto ci, auto co) {
      constexpr int C2 = decltype(ci)::value, CO2 = decltype(co)::value;
      fu_bwd_mix_kernel<T, C2, CO2><<<dim3(chunks, B), kThreads,
                                      mix_smem_bytes(C2, CO2, C2 + CO2, 6),
                                      static_cast<cudaStream_t>(stream)>>>(
          z, g, gz, static_cast<const T*>(k), scale, bias, mean, var, gscale, gbias,
          partial, H, W, chunks, static_cast<float>(count));
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// dtype of K. z: (B, 2C, H, Wf) float32; partial: (B * chunks, 4Co) float32,
// rows of [sum m | sum m^2] for fu_reduce with count B * H * Wf.
int ffc_fu_mix_stats(int dtype, const float* z, const void* k, float* partial, int B,
                     int C, int Co, int H, int W, int chunks, void* stream) {
  if (bad_map(B, C, H, W) || Co <= 0 || chunks < 1) return cudaErrorInvalidValue;
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return by_width(2 * C, 2 * Co, [&](auto ci, auto co) {
      constexpr int C2 = decltype(ci)::value, CO2 = decltype(co)::value;
      fu_mix_stats_kernel<T, C2, CO2><<<dim3(chunks, B), kThreads,
                                        mix_smem_bytes(C2, CO2, C2, 0),
                                        static_cast<cudaStream_t>(stream)>>>(
          z, static_cast<const T*>(k), partial, H, W, chunks);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// dtype of K. z: (B, 2C, H, Wf), g = DFT(gy): (B, 2Co, H, Wf) float32 (read
// only); mean, var: the batch statistics; partial: (B * chunks, 4Co)
// float32, rows of [sum gpre * n | sum gpre] for fu_reduce (count 0): gscale
// and gbias.
int ffc_fu_bwd_stats_mix(int dtype, const float* z, const float* g, const void* k,
                         const float* scale, const float* bias, const float* mean,
                         const float* var, float* partial, int B, int C, int Co, int H, int W,
                         int chunks, void* stream) {
  if (bad_map(B, C, H, W) || Co <= 0 || chunks < 1) return cudaErrorInvalidValue;
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return by_width(2 * C, 2 * Co, [&](auto ci, auto co) {
      constexpr int C2 = decltype(ci)::value, CO2 = decltype(co)::value;
      fu_bwd_stats_mix_kernel<T, C2, CO2><<<dim3(chunks, B), kThreads,
                                            mix_smem_bytes(C2, CO2, C2 + CO2, 4),
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
