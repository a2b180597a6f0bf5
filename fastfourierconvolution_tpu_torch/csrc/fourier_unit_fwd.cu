// FourierUnit eval forward for Hopper (sm_90a), one thread block per batch item.
//
//   y = iDFT(c * ReLU(BN_running(DFT(x) @ K)))
//
// DFT is the orthonormal real 2-D DFT over (H, W) with the half spectrum's
// real and imaginary parts stacked as 2C channels; K is the (2C, 2C) channel
// mix; BN uses the running statistics (eps 1e-5); c holds the half-spectrum
// duplication weights (1 at DC and Nyquist, 2 elsewhere); iDFT is
// Re(eh . R . fw^T), which is defined for the non-Hermitian spectrum that the
// ReLU leaves behind.
//
// Replaces the eval ("apply") Pallas kernels of
// fastfourierconvolution_tpu/ops/pallas/fourier_unit.py:
//   _pallas_forward_sep  -> apply_kernel (pallas_call at line 657),
//   _pallas_forward_sep2 -> apply_kernel (pallas_call at line 1124),
//   _pallas_forward_kron -> apply_kernel (pallas_call at line 1405).
// The three compute one function in three TPU layouts; this is not a copy of
// any of them.
//
// Layout: x and y are NCHW, contiguous, float32 or bfloat16; K is (2C, 2C) in
// x's dtype, [re; im] on both axes; scale/bias/mean/var are (2C,) float32.
//
// Design. A block loads its item's map into shared memory (converted to f32)
// and keeps every intermediate there: the W-stage rDFT, the H-stage DFT, the
// channel mix with BN, ReLU and the c weights, the inverse H-stage and the
// inverse W-stage, which writes y. All arithmetic is f32 FMA on the CUDA
// cores. The DFT factor tables are computed in the block (double precision,
// rounded to f32, as the host factor matrices are). Two spectrum-sized
// buffers ping-pong; x shares the second one. At the 32px generator's shapes
// a block needs 44 KB (16x16x16) or 81 KB (32x32x8) of shared memory.
//
// What bounds it on an H100: per launch it must move x and y once
// (B*C*H*W elements each; 1.05 MB at (64,16,16,16) and 2.10 MB at
// (64,32,32,8) in bf16: 0.31 and 0.63 us at 3.35 TB/s). The function needs
// far fewer operations than this kernel does (FFT-sized transforms and the
// mix, about 0.03 and 0.05 GFLOP), which take under 0.1 us at the 989
// TFLOP/s bf16 rate, so the bound is the bytes. This kernel is a simple
// design that is latency-class: one block per item gives 64 blocks on 132
// SMs at serving batch 64, its dense DFT stages do several times the
// function's operations as f32 FMAs on the CUDA cores, and each block's time
// is set by its shared-memory loads (about one per FMA), not by device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Shared-memory plan in floats; the host sizes the launch with the same plan.
struct Plan {
  int wf, n_spec, n_map, buf_b;
  int spec_a_off, buf_b_off, cw_off, sw_off, ch_off, sh_off, k_off, bn_off,
      cvec_off, total;
  __host__ __device__ Plan(int c, int h, int w) {
    wf = w / 2 + 1;
    n_spec = c * h * wf;  // one of the re / im plane sets
    n_map = c * h * w;
    buf_b = n_map > 2 * n_spec ? n_map : 2 * n_spec;
    spec_a_off = 0;
    buf_b_off = spec_a_off + 2 * n_spec;
    cw_off = buf_b_off + buf_b;
    sw_off = cw_off + w * wf;
    ch_off = sw_off + w * wf;
    sh_off = ch_off + h * h;
    k_off = sh_off + h * h;
    bn_off = k_off + 4 * c * c;
    cvec_off = bn_off + 4 * 2 * c;  // mean, inv, scale, bias
    total = cvec_off + wf;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fourier_unit_fwd_kernel(const T* __restrict__ x, const T* __restrict__ kmix_g,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const float* __restrict__ mean,
                        const float* __restrict__ var, T* __restrict__ y,
                        int C, int H, int W) {
  extern __shared__ float smem[];
  const Plan pl(C, H, W);
  const int wf = pl.wf, n_spec = pl.n_spec, n_map = pl.n_map;
  const int c2 = 2 * C, hwf = H * wf;
  float* spec_a = smem + pl.spec_a_off;  // [re|im][c][h][v]
  float* buf_b = smem + pl.buf_b_off;    // x [c][h][q], then a spectrum
  float* cw = smem + pl.cw_off;          // cos(2 pi q v / W)        [q][v]
  float* sw = smem + pl.sw_off;          // sin(2 pi q v / W)        [q][v]
  float* ch = smem + pl.ch_off;          // cos(2 pi u p / H)/sqrt(HW) [u][p]
  float* sh = smem + pl.sh_off;          // sin(2 pi u p / H)/sqrt(HW) [u][p]
  float* kmix = smem + pl.k_off;         // K [j][d]
  float* bn_mean = smem + pl.bn_off;
  float* bn_inv = bn_mean + c2;
  float* bn_scale = bn_inv + c2;
  float* bn_bias = bn_scale + c2;
  float* cvec = smem + pl.cvec_off;

  const int tid = threadIdx.x;
  const size_t item = blockIdx.x;
  const T* xb = x + item * static_cast<size_t>(n_map);
  T* yb = y + item * static_cast<size_t>(n_map);

  // 1. Load the item and the constants.
  for (int i = tid; i < n_map; i += kThreads) buf_b[i] = load_f32(xb + i);
  for (int i = tid; i < W * wf; i += kThreads) {
    const int q = i / wf, v = i % wf;
    double s, c;
    sincospi(2.0 * ((q * v) % W) / W, &s, &c);
    cw[i] = static_cast<float>(c);
    sw[i] = static_cast<float>(s);
  }
  const double ortho = 1.0 / sqrt(static_cast<double>(H) * W);
  for (int i = tid; i < H * H; i += kThreads) {
    const int u = i / H, p = i % H;
    double s, c;
    sincospi(2.0 * ((u * p) % H) / H, &s, &c);
    ch[i] = static_cast<float>(c * ortho);
    sh[i] = static_cast<float>(s * ortho);
  }
  for (int i = tid; i < c2 * c2; i += kThreads) kmix[i] = load_f32(kmix_g + i);
  for (int d = tid; d < c2; d += kThreads) {
    bn_mean[d] = mean[d];
    bn_inv[d] = rsqrtf(var[d] + kEps);
    bn_scale[d] = scale[d];
    bn_bias[d] = bias[d];
  }
  for (int v = tid; v < wf; v += kThreads)
    cvec[v] = (v == 0 || (W % 2 == 0 && v == wf - 1)) ? 1.f : 2.f;
  __syncthreads();

  // 2. W-stage rDFT: spec_a[c][h][v] = sum_q x[c][h][q] exp(-2 pi i q v / W).
  for (int o = tid; o < n_spec; o += kThreads) {
    const int v = o % wf, row = o / wf;
    const float* xr = buf_b + row * W;
    float re = 0.f, im = 0.f;
    for (int q = 0; q < W; ++q) {
      const float xv = xr[q];
      re = fmaf(xv, cw[q * wf + v], re);
      im = fmaf(xv, sw[q * wf + v], im);
    }
    spec_a[o] = re;
    spec_a[n_spec + o] = -im;
  }
  __syncthreads();

  // 3. H-stage DFT: buf_b[c][u][v] = sum_h (ch - i sh)[u][h] spec_a[c][h][v].
  for (int o = tid; o < n_spec; o += kThreads) {
    const int v = o % wf, cu = o / wf, u = cu % H, c = cu / H;
    const float* tr = spec_a + c * hwf + v;
    const float* ti = tr + n_spec;
    float re = 0.f, im = 0.f;
    for (int h = 0; h < H; ++h) {
      const float cc = ch[u * H + h], ss = sh[u * H + h];
      const float a = tr[h * wf], b = ti[h * wf];
      re = fmaf(cc, a, fmaf(ss, b, re));
      im = fmaf(cc, b, fmaf(-ss, a, im));
    }
    buf_b[o] = re;
    buf_b[n_spec + o] = im;
  }
  __syncthreads();

  // 4. Channel mix, BN with running stats, ReLU, half-spectrum weights:
  //    spec_a[d][s] = c[v] * relu(bn_d(sum_j buf_b[j][s] K[j][d])).
  for (int o = tid; o < 2 * n_spec; o += kThreads) {
    const int s = o % hwf, d = o / hwf;
    float m = 0.f;
    for (int j = 0; j < c2; ++j) m = fmaf(buf_b[j * hwf + s], kmix[j * c2 + d], m);
    const float pre = (m - bn_mean[d]) * bn_inv[d] * bn_scale[d] + bn_bias[d];
    spec_a[o] = fmaxf(pre, 0.f) * cvec[s % wf];
  }
  __syncthreads();

  // 5. Inverse H-stage: buf_b[c][p][v] = sum_u (ch + i sh)[p][u] spec_a[c][u][v].
  for (int o = tid; o < n_spec; o += kThreads) {
    const int v = o % wf, cp = o / wf, p = cp % H, c = cp / H;
    const float* rr = spec_a + c * hwf + v;
    const float* ri = rr + n_spec;
    float re = 0.f, im = 0.f;
    for (int u = 0; u < H; ++u) {
      const float cc = ch[p * H + u], ss = sh[p * H + u];
      const float a = rr[u * wf], b = ri[u * wf];
      re = fmaf(cc, a, fmaf(-ss, b, re));
      im = fmaf(cc, b, fmaf(ss, a, im));
    }
    buf_b[o] = re;
    buf_b[n_spec + o] = im;
  }
  __syncthreads();

  // 6. Inverse W-stage: y[c][p][q] = sum_v Re(P[c][p][v] exp(+2 pi i q v / W)).
  for (int o = tid; o < n_map; o += kThreads) {
    const int q = o % W, row = o / W;
    const float* pr = buf_b + row * wf;
    const float* pi = pr + n_spec;
    float acc = 0.f;
    for (int v = 0; v < wf; ++v)
      acc = fmaf(pr[v], cw[q * wf + v], fmaf(-pi[v], sw[q * wf + v], acc));
    store_f32(yb + o, acc);
  }
}

template <typename T>
int launch(const void* x, const void* k, const float* scale, const float* bias,
           const float* mean, const float* var, void* y, int B, int C, int H,
           int W, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Plan(C, H, W).total) * sizeof(float);
  fourier_unit_fwd_kernel<T><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), scale, bias, mean, var,
      static_cast<T*>(y), C, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for a (C, H, W) item.
long long ffc_fourier_unit_fwd_smem_bytes(int C, int H, int W) {
  return static_cast<long long>(Plan(C, H, W).total) * sizeof(float);
}

// Lets the dtype's kernel take up to `bytes` of dynamic shared memory on the
// current device; called once per device and dtype before the first launch.
// Returns a cudaError_t (0 on success).
int ffc_fourier_unit_fwd_allow_smem(int dtype, int bytes) {
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if (dtype == 0) return cudaFuncSetAttribute(fourier_unit_fwd_kernel<float>, attr, bytes);
  if (dtype == 1)
    return cudaFuncSetAttribute(fourier_unit_fwd_kernel<__nv_bfloat16>, attr, bytes);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. The caller has checked that a block's
// shared memory fits the limit set by ffc_fourier_unit_fwd_allow_smem.
// Returns a cudaError_t (0 on success).
int ffc_fourier_unit_fwd(int dtype, const void* x, const void* k,
                         const float* scale, const float* bias, const float* mean,
                         const float* var, void* y, int B, int C, int H, int W,
                         void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, k, scale, bias, mean, var, y, B, C, H, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, k, scale, bias, mean, var, y, B, C, H, W, s);
  return cudaErrorInvalidValue;
}

const char* ffc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
