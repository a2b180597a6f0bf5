// Device code shared by the FourierUnit kernels (fourier_unit_fwd.cu,
// fourier_unit_train.cu) that run one item per block with the item's buffers
// in a device workspace (the workspace forward, statistics, backward sums and
// backward apply): the buffer layouts, the DFT factor tables and the four
// transform stages of one (C, H, W) item. The clustered per-item kernels
// have their own stages (fourier_unit_item.cuh).
//
// Spectra are stored as a pair of plane sets, [re | im], each [c][h][v] with
// v < Wf = W/2 + 1, so channel d of the 2C-channel spectrum starts at
// d * H * Wf. Every stage is a block-wide loop over its outputs; the caller
// puts __syncthreads() between stages.
//
// The stages and their adjoints (all orthonormal, no half-spectrum weights):
//   dft_w  : map -> W-stage rDFT        adjoint: idft_w
//   dft_h  : H-stage DFT                adjoint: idft_h
// and the inverse transform idft_h -> idft_w is the adjoint of dft_w -> dft_h,
// so the backward pass reuses the forward stages: the cotangent of the
// inverse's input is dft_h(dft_w(gy)) and the cotangent of x is
// idft_w(idft_h(gz)).
//
// Layout. A block works on one item, and every buffer of the item lives in
// the item's slice of an f32 device workspace that the wrapper allocates
// (item_slice), whose loads the L1 and L2 caches serve.

#pragma once

#include "common.cuh"

namespace ffc {

constexpr float kEps = 1e-5f;

// Block blockIdx.x's item: its slice of `item_floats` floats of the
// workspace.
__device__ __forceinline__ float* item_slice(float* ws, int item_floats) {
  return ws + static_cast<size_t>(blockIdx.x) * item_floats;
}

// Geometry of one item.
struct Dims {
  int C, H, W, wf, hwf, n_spec, n_map;
  __host__ __device__ Dims(int c, int h, int w)
      : C(c), H(h), W(w), wf(w / 2 + 1), hwf(h * (w / 2 + 1)),
        n_spec(c * h * (w / 2 + 1)), n_map(c * h * w) {}
  // Floats of a buffer that holds a spectrum pair or a map.
  __host__ __device__ int pair_or_map() const {
    return n_map > 2 * n_spec ? n_map : 2 * n_spec;
  }
  // Floats of the factor tables.
  __host__ __device__ int tables() const { return 2 * W * wf + 2 * H * H; }
};

struct Tables {
  float* cw;  // cos(2 pi q v / W)           [q][v]
  float* sw;  // sin(2 pi q v / W)           [q][v]
  float* ch;  // cos(2 pi u p / H)/sqrt(HW)  [u][p], symmetric
  float* sh;  // sin(2 pi u p / H)/sqrt(HW)  [u][p], symmetric
  __device__ Tables(float* base, const Dims& d)
      : cw(base), sw(base + d.W * d.wf), ch(base + 2 * d.W * d.wf),
        sh(base + 2 * d.W * d.wf + d.H * d.H) {}
};

// Fills the tables in double precision, rounded to f32 as the host factor
// matrices are.
__device__ __forceinline__ void fill_tables(const Tables& t, const Dims& d) {
  for (int i = threadIdx.x; i < d.W * d.wf; i += kThreads) {
    const int q = i / d.wf, v = i % d.wf;
    double s, c;
    sincospi(2.0 * ((q * v) % d.W) / d.W, &s, &c);
    t.cw[i] = static_cast<float>(c);
    t.sw[i] = static_cast<float>(s);
  }
  const double ortho = 1.0 / sqrt(static_cast<double>(d.H) * d.W);
  for (int i = threadIdx.x; i < d.H * d.H; i += kThreads) {
    const int u = i / d.H, p = i % d.H;
    double s, c;
    sincospi(2.0 * ((u * p) % d.H) / d.H, &s, &c);
    t.ch[i] = static_cast<float>(c * ortho);
    t.sh[i] = static_cast<float>(s * ortho);
  }
}

template <typename T>
__device__ __forceinline__ void load_map(float* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = load_f32(src + i);
}

// Half-spectrum weight of column v: 1 at DC and Nyquist, 2 elsewhere.
__device__ __forceinline__ float half_weight(int v, const Dims& d) {
  return (v == 0 || (d.W % 2 == 0 && v == d.wf - 1)) ? 1.f : 2.f;
}

// W-stage rDFT: out[c][h][v] = sum_q in[c][h][q] exp(-2 pi i q v / W).
__device__ __forceinline__ void dft_w(const float* in, float* out,
                                      const Tables& t, const Dims& d) {
  for (int o = threadIdx.x; o < d.n_spec; o += kThreads) {
    const int v = o % d.wf, row = o / d.wf;
    const float* xr = in + row * d.W;
    float re = 0.f, im = 0.f;
    for (int q = 0; q < d.W; ++q) {
      const float xv = xr[q];
      re = fmaf(xv, t.cw[q * d.wf + v], re);
      im = fmaf(xv, t.sw[q * d.wf + v], im);
    }
    out[o] = re;
    out[d.n_spec + o] = -im;
  }
}

// H-stage DFT: out[c][u][v] = sum_h (ch - i sh)[u][h] in[c][h][v].
__device__ __forceinline__ void dft_h(const float* in, float* out,
                                      const Tables& t, const Dims& d) {
  for (int o = threadIdx.x; o < d.n_spec; o += kThreads) {
    const int v = o % d.wf, cu = o / d.wf, u = cu % d.H, c = cu / d.H;
    const float* tr = in + c * d.hwf + v;
    const float* ti = tr + d.n_spec;
    float re = 0.f, im = 0.f;
    for (int h = 0; h < d.H; ++h) {
      const float cc = t.ch[u * d.H + h], ss = t.sh[u * d.H + h];
      const float a = tr[h * d.wf], b = ti[h * d.wf];
      re = fmaf(cc, a, fmaf(ss, b, re));
      im = fmaf(cc, b, fmaf(-ss, a, im));
    }
    out[o] = re;
    out[d.n_spec + o] = im;
  }
}

// Inverse H-stage: out[c][p][v] = sum_u (ch + i sh)[p][u] in[c][u][v].
__device__ __forceinline__ void idft_h(const float* in, float* out,
                                       const Tables& t, const Dims& d) {
  for (int o = threadIdx.x; o < d.n_spec; o += kThreads) {
    const int v = o % d.wf, cp = o / d.wf, p = cp % d.H, c = cp / d.H;
    const float* rr = in + c * d.hwf + v;
    const float* ri = rr + d.n_spec;
    float re = 0.f, im = 0.f;
    for (int u = 0; u < d.H; ++u) {
      const float cc = t.ch[p * d.H + u], ss = t.sh[p * d.H + u];
      const float a = rr[u * d.wf], b = ri[u * d.wf];
      re = fmaf(cc, a, fmaf(-ss, b, re));
      im = fmaf(cc, b, fmaf(ss, a, im));
    }
    out[o] = re;
    out[d.n_spec + o] = im;
  }
}

// Inverse W-stage, written to device memory:
// out[c][p][q] = sum_v Re(in[c][p][v] exp(+2 pi i q v / W)).
template <typename T>
__device__ __forceinline__ void idft_w(const float* in, T* out,
                                       const Tables& t, const Dims& d) {
  for (int o = threadIdx.x; o < d.n_map; o += kThreads) {
    const int q = o % d.W, row = o / d.W;
    const float* pr = in + row * d.wf;
    const float* pi = pr + d.n_spec;
    float acc = 0.f;
    for (int v = 0; v < d.wf; ++v)
      acc = fmaf(pr[v], t.cw[q * d.wf + v], fmaf(-pi[v], t.sw[q * d.wf + v], acc));
    store_f32(out + o, acc);
  }
}

// Channel mix at one spectral position: sum_j z[j][s] K[j][d] over the c2
// channels j, K's rows c2o long.
__device__ __forceinline__ float mix_at(const float* z, const float* kmix,
                                        int d, int s, int c2, int c2o, int hwf) {
  float m = 0.f;
  for (int j = 0; j < c2; ++j) m = fmaf(z[j * hwf + s], kmix[j * c2o + d], m);
  return m;
}

}  // namespace ffc
