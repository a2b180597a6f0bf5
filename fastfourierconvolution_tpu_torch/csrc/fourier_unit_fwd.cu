// FourierUnit forward for Hopper (sm_90a), one thread block per batch item.
//
//   y = iDFT(c * ReLU(BN(DFT(x) @ K)))
//
// DFT is the orthonormal real 2-D DFT over (H, W) with the half spectrum's
// real and imaginary parts stacked as 2C channels; K is the (2C, 2C) channel
// mix; BN takes the statistics it is given (eps 1e-5): the running statistics
// in eval, the batch statistics of fourier_unit_train.cu's stats kernel in
// training; c holds the half-spectrum duplication weights (1 at DC and
// Nyquist, 2 elsewhere); iDFT is
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
// Design. A block loads its item's map (converted to f32) and keeps every
// intermediate on chip where it fits: the W-stage rDFT, the H-stage DFT, the
// channel mix with BN, ReLU and the c weights, the inverse H-stage and the
// inverse W-stage, which writes y. All arithmetic is f32 FMA on the CUDA
// cores. The DFT factor tables are computed in the block (double precision,
// rounded to f32, as the host factor matrices are); the transform stages are
// shared with the training kernels (fourier_unit_common.cuh). Two
// spectrum-sized buffers ping-pong; x shares the second one. At the 32px
// generator's shapes a block needs 44 KB (16x16x16) or 81 KB (32x32x8) of
// shared memory, and 213 KB at the 128px generator's block1 (64x16x16, with
// its 64 KB K). The larger 128px maps (32x32x32, 32x64x64, 32x128x128) run
// as the staged kernels of fourier_unit_staged.cu (ops/fourier_unit.py,
// kernel_design); the workspace layout (fourier_unit_common.cuh) serves the
// maps that those do not take.
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
// In the workspace layout the stages load from the L1/L2-cached workspace
// instead: a simple, slower variant for maps of any size.

#include "fourier_unit_common.cuh"

namespace {

using namespace ffc;

// Buffer plan in floats; the host sizes the launch (shared memory or
// workspace) with the same plan.
struct Plan {
  int spec_a_off, buf_b_off, tab_off, k_off, bn_off, cvec_off, total;
  __host__ __device__ Plan(int c, int h, int w) {
    const Dims d(c, h, w);
    spec_a_off = 0;
    buf_b_off = spec_a_off + 2 * d.n_spec;
    tab_off = buf_b_off + d.pair_or_map();
    k_off = tab_off + d.tables();
    bn_off = k_off + 4 * c * c;
    cvec_off = bn_off + 4 * 2 * c;  // mean, inv, scale, bias
    total = cvec_off + d.wf;
  }
};

template <typename T, int kLayout>
__global__ void __launch_bounds__(kThreads)
fourier_unit_fwd_kernel(const T* __restrict__ x, const T* __restrict__ kmix_g,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const float* __restrict__ mean,
                        const float* __restrict__ var, T* __restrict__ y,
                        float* __restrict__ ws, int C, int H, int W) {
  extern __shared__ float smem[];
  const Plan pl(C, H, W);
  const Dims dm(C, H, W);
  const int c2 = 2 * C, hwf = dm.hwf;
  const size_t item = blockIdx.x;
  float* base = item_base<kLayout>(smem, ws, pl.total);
  float* spec_a = base + pl.spec_a_off;  // [re|im][c][h][v]
  float* buf_b = base + pl.buf_b_off;    // x [c][h][q], then a spectrum
  const Tables tab(base + pl.tab_off, dm);
  float* kmix = base + pl.k_off;         // K [j][d]
  float* bn_mean = base + pl.bn_off;
  float* bn_inv = bn_mean + c2;
  float* bn_scale = bn_inv + c2;
  float* bn_bias = bn_scale + c2;
  float* cvec = base + pl.cvec_off;

  const int tid = threadIdx.x;

  // 1. Load the item and the constants.
  load_map(buf_b, x + item * static_cast<size_t>(dm.n_map), dm.n_map);
  fill_tables(tab, dm);
  for (int i = tid; i < c2 * c2; i += kThreads) kmix[i] = load_f32(kmix_g + i);
  for (int d = tid; d < c2; d += kThreads) {
    bn_mean[d] = mean[d];
    bn_inv[d] = rsqrtf(var[d] + kEps);
    bn_scale[d] = scale[d];
    bn_bias[d] = bias[d];
  }
  for (int v = tid; v < dm.wf; v += kThreads) cvec[v] = half_weight(v, dm);
  __syncthreads();

  // 2-3. rDFT over W, then DFT over H: buf_b = z, the 2C-channel spectrum.
  dft_w(buf_b, spec_a, tab, dm);
  __syncthreads();
  dft_h(spec_a, buf_b, tab, dm);
  __syncthreads();

  // 4. Channel mix, BN, ReLU, half-spectrum weights:
  //    spec_a[d][s] = c[v] * relu(bn_d(sum_j buf_b[j][s] K[j][d])).
  for (int o = tid; o < 2 * dm.n_spec; o += kThreads) {
    const int s = o % hwf, d = o / hwf;
    const float m = mix_at(buf_b, kmix, d, s, c2, hwf);
    const float pre = (m - bn_mean[d]) * bn_inv[d] * bn_scale[d] + bn_bias[d];
    spec_a[o] = fmaxf(pre, 0.f) * cvec[s % dm.wf];
  }
  __syncthreads();

  // 5-6. Inverse DFT over H, then the inverse rDFT over W, which writes y.
  idft_h(spec_a, buf_b, tab, dm);
  __syncthreads();
  idft_w(buf_b, y + item * static_cast<size_t>(dm.n_map), tab, dm);
}

}  // namespace

extern "C" {

// Floats of the buffers of one (C, H, W) item: the bytes of dynamic shared
// memory a block needs in kShared (times 4), the workspace floats per item in
// kWorkspace.
long long ffc_item_floats(int C, int H, int W) { return Plan(C, H, W).total; }

// Lets the dtype's kShared kernel take up to `bytes` of dynamic shared memory
// on the current device; called once per device and dtype before the first
// launch. Returns a cudaError_t (0 on success).
int ffc_allow_smem(int dtype, int bytes) {
  return dispatch<1>(dtype, kShared, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return static_cast<int>(cudaFuncSetAttribute(
        fourier_unit_fwd_kernel<T, kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes));
  });
}

// dtype: 0 = float32, 1 = bfloat16; layout: kShared (ws null; the caller has
// checked the plan against the limit set by ffc_allow_smem) or kWorkspace (ws:
// B * ffc_item_floats(...) floats). Returns a cudaError_t (0 on success).
int ffc_fourier_unit_fwd(int dtype, int layout, const void* x, const void* k,
                         const float* scale, const float* bias, const float* mean,
                         const float* var, void* y, float* ws, int B, int C, int H,
                         int W, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  if (layout == kWorkspace && ws == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      layout == kShared ? static_cast<size_t>(Plan(C, H, W).total) * sizeof(float) : 0;
  return dispatch<kLayouts>(dtype, layout, [&](auto tag, auto lay) {
    using T = typename decltype(tag)::type;
    fourier_unit_fwd_kernel<T, decltype(lay)::value><<<B, kThreads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(k), scale, bias, mean, var,
        static_cast<T*>(y), ws, C, H, W);
    return static_cast<int>(cudaGetLastError());
  });
}

const char* ffc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
