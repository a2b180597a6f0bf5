// FourierUnit forward for Hopper (sm_90a).
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
// Two kernels; ops/fourier_unit.py (kernel_design) picks the one for a map,
// and the staged kernels of fourier_unit_staged.cu take the maps that neither
// serves well (the 128px generator's 32x32 to 128x128 maps).
//
// fu_item_fwd_kernel, wherever the item's plan fits shared memory, on one
// block or spread over a cluster's ranks (the 32px generator's (16,16,16) and
// (8,32,32), the 48px one's (16,24,24) and (8,48,48), the 128px eval forward's
// (64,16,16)). An item runs on a thread-block cluster of R ranks of 384
// threads (fourier_unit_item.cuh; R from ops/fourier_unit.py, item_design: the
// most ranks whose blocks make one wave, R = 2 at batch 64 and 8 at batch 1
// and 7), each rank on cr = C/R channels: it copies their planes and the DFT
// tables in with cp.async, takes the W-stage rDFT and the H-stage DFT of its
// planes in its shared memory, and after a cluster barrier gathers the item's
// whole spectrum from the ranks over distributed shared memory and computes
// its 2cr channels of m = z K over every position, with BN, ReLU and the c
// weights applied as each value leaves the registers; after a second barrier
// it takes the inverse H-stage and the inverse W-stage of its channels, which
// writes y. Every stage is a register-tiled small product; the DFT factor
// tables are the plain version's own, built once per (H, W) on the host.
// Shared memory per rank at batch 64 (R = 2): 41 KB at (16,16,16), 81 KB at
// (8,32,32), 180 KB at (64,16,16).
//
// fourier_unit_fwd_kernel, elsewhere (maps that are no power of two and
// exceed shared memory, e.g. the 96px generator's 96x96): one block per item
// with every buffer in the item's slice of a device workspace
// (fourier_unit_common.cuh), a simple, slower design whose stages load from
// the L1/L2-cached workspace.
//
// What bounds them on an H100: per launch the function must move x and y
// once (B*C*H*W elements each; 1.05 MB at (64,16,16,16) and 2.10 MB at
// (64,8,32,32) in bf16: 0.31 and 0.63 us at 3.35 TB/s), against about 0.03
// and 0.05 GFLOP of FFT-sized transforms and mix (under 0.1 us at the 989
// TFLOP/s bf16 rate), so the bound is the bytes. fu_item_fwd_kernel does
// dense DFT stages, several times the FFT's operations as f32 FMAs on the
// CUDA cores (0.6 M FMAs per (16,16,16) item, 1.8 M per (8,32,32) item; 1.1
// and 3.5 us at 67 TFLOP/s over a batch of 64). What sets its time is the
// issue of each rank's instructions on its SM, one block per SM: the FMAs
// and the shared-memory loads that feed them (0.4-0.75 per FMA in the
// tiles), and the load of the planes, the two cluster barriers and the
// gather: 0.012 ms at (64,16,16,16) and 0.020 ms at (64,8,32,32) on an
// H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md), far above the bytes,
// which it moves once.

#include "fourier_unit_item.cuh"

namespace {

using namespace ffc;

// Buffer plan in floats of the workspace kernel's item; the host sizes the
// workspace with the same plan.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
fourier_unit_fwd_kernel(const T* __restrict__ x, const T* __restrict__ kmix_g,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const float* __restrict__ mean,
                        const float* __restrict__ var, T* __restrict__ y,
                        float* __restrict__ ws, int C, int H, int W) {
  const Plan pl(C, H, W);
  const Dims dm(C, H, W);
  const int c2 = 2 * C, hwf = dm.hwf;
  const size_t item = blockIdx.x;
  float* base = item_slice(ws, pl.total);
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

// Buffer plan in floats of one rank of fu_item_fwd_kernel (16-byte aligned
// regions); the host mirrors it (ops/fourier_unit.py, _item_rank_floats).
struct ItemPlan {
  int a, b, full, tab, kc, vec, cvec, total;
  __host__ __device__ explicit ItemPlan(const ItemRank& k) {
    a = 0;                      // map, then z (read by every rank), then P
    b = a + k.buf();            // W-stage scratch, then r = c * ReLU(BN(m))
    full = b + k.buf();         // the item's z, gathered (R > 1)
    tab = full + k.full();      // cw, dw, ah, bh
    kc = tab + round4(k.tables());  // K[j][d] for the rank's d, [j][dl]
    vec = kc + k.kslice();      // mean, inv, scale, bias (2cr each)
    cvec = vec + round4(8 * k.cr);
    total = cvec + k.wf;
  }
};

template <typename T>
__global__ void __launch_bounds__(kItemThreads)
fu_item_fwd_kernel(const T* __restrict__ x, const T* __restrict__ kmix_g,
                   const float* __restrict__ tables, const float* __restrict__ scale,
                   const float* __restrict__ bias, const float* __restrict__ mean,
                   const float* __restrict__ var, T* __restrict__ y, int C, int H, int W) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const ItemRank k(C, H, W, static_cast<int>(cluster.num_blocks()));
  const ItemPlan pl(k);
  float* a = smem + pl.a;
  float* b = smem + pl.b;
  const ItemTables tab(smem + pl.tab, k);
  float* kc = smem + pl.kc;
  float* bn_mean = smem + pl.vec;
  float* bn_inv = bn_mean + 2 * k.cr;
  float* bn_scale = bn_inv + 2 * k.cr;
  float* bn_bias = bn_scale + 2 * k.cr;
  float* cvec = smem + pl.cvec;
  const size_t planes = (blockIdx.x / k.R * static_cast<size_t>(C) + rank * k.cr) * H * W;

  // 1. The rank's planes (as they are into b, asynchronously, where they
  //    are whole 16-byte units) and the tables, while its slice of K and
  //    its BN vectors load; then the planes in f32 into a.
  const int map_bytes = k.cr * H * W * static_cast<int>(sizeof(T));
  const bool units = in_units(x + planes, map_bytes);
  if (units) copy_async(b, x + planes, map_bytes);
  copy_tables(smem + pl.tab, tables, k.tables());
  // The BN vectors of the thread's first channel load before the slice of
  // K, so that their latencies overlap.
  const int d0 = k.channel(min(static_cast<int>(threadIdx.x), 2 * k.cr - 1), rank);
  const float v0[4] = {mean[d0], var[d0], scale[d0], bias[d0]};
  load_kslice<true>(kc, kmix_g, k, rank);
  for (int dl = threadIdx.x; dl < 2 * k.cr; dl += kItemThreads) {
    const int d = k.channel(dl, rank);
    const bool first = dl == static_cast<int>(threadIdx.x);
    bn_mean[dl] = first ? v0[0] : mean[d];
    bn_inv[dl] = rsqrtf((first ? v0[1] : var[d]) + kEps);
    bn_scale[dl] = first ? v0[2] : scale[d];
    bn_bias[dl] = first ? v0[3] : bias[d];
  }
  for (int v = threadIdx.x; v < k.wf; v += kItemThreads) cvec[v] = k.half_weight(v);
  wait_async();
  __syncthreads();
  if (units) {
    unpack_planes(a, reinterpret_cast<const T*>(b), k);
  } else {
    load_planes(a, x + planes, k);
  }
  __syncthreads();

  // 2-3. rDFT over W into b, DFT over H into a: the rank's z.
  item_dft_w(a, b, tab, k);
  __syncthreads();
  item_dft_h<false>(b, a, tab, k);
  cluster.sync();  // every rank's z is in its shared memory

  // 4. The item's z from every rank, then the rank's channels of m = z K
  //    over every position, BN, ReLU and the half-spectrum weights:
  //    b[dl][s] = c[v] * relu(bn_dl(m)).
  const float* z = cluster_gather(cluster, a, smem + pl.full, k);
  item_mix(z, kc, k, [=](int dl, int s, float m) {
    const float pre = (m - bn_mean[dl]) * bn_inv[dl] * bn_scale[dl] + bn_bias[dl];
    b[dl * k.hwf + s] = fmaxf(pre, 0.f) * cvec[s % k.wf];
  });
  cluster.sync();  // no rank reads a's z any more

  // 5-6. Inverse DFT over H into a, then the inverse rDFT over W writes y.
  item_dft_h<true>(b, a, tab, k);
  __syncthreads();
  item_idft_w(a, y + planes, tab, k);
}

}  // namespace

extern "C" {

// Floats of one (C, H, W) item's workspace (the workspace kernel's plan).
long long ffc_item_floats(int C, int H, int W) { return Plan(C, H, W).total; }

// Floats of shared memory one rank of fu_item_fwd_kernel takes on a cluster
// of R ranks (R dividing C).
long long ffc_item_rank_floats(int C, int H, int W, int R) {
  return ItemPlan(ItemRank(C, H, W, R)).total;
}

// Lets the dtype's clustered per-item kernel take up to `bytes` of dynamic
// shared memory on the current device; called once per device and dtype
// before the first launch. Returns a cudaError_t (0 on success).
int ffc_allow_smem(int dtype, int bytes) {
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return static_cast<int>(cudaFuncSetAttribute(
        fu_item_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  });
}

// The workspace kernel. dtype: 0 = float32, 1 = bfloat16; ws: B *
// ffc_item_floats(...) floats. Returns a cudaError_t (0 on success).
int ffc_fourier_unit_fwd(int dtype, const void* x, const void* k, const float* scale,
                         const float* bias, const float* mean, const float* var, void* y,
                         float* ws, int B, int C, int H, int W, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || ws == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    fourier_unit_fwd_kernel<T><<<B, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(k), scale, bias, mean, var,
        static_cast<T*>(y), ws, C, H, W);
    return static_cast<int>(cudaGetLastError());
  });
}

// The clustered per-item kernel: B clusters of `ranks` blocks (1, 2, 4 or 8,
// dividing C), each rank ffc_item_rank_floats(...) * 4 bytes of shared
// memory (the caller has checked them against the limit set by
// ffc_allow_smem); tables: the item's DFT factor tables (16-byte aligned,
// fourier_unit_item.cuh). A refused cluster launch returns its error.
int ffc_fu_item_fwd(int dtype, const void* x, const void* k, const float* tables,
                    const float* scale, const float* bias, const float* mean, const float* var,
                    void* y, int B, int C, int H, int W, int ranks, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || !cluster_size_ok(ranks) || C % ranks != 0 ||
      reinterpret_cast<size_t>(tables) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(ffc_item_rank_floats(C, H, W, ranks)) * sizeof(float);
  const unsigned grid = static_cast<unsigned>(B) * ranks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return launch_clustered<kItemThreads>(fu_item_fwd_kernel<T>, grid, ranks, smem, s,
                            static_cast<const T*>(x), static_cast<const T*>(k), tables, scale,
                            bias, mean, var, static_cast<T*>(y), C, H, W);
  });
}

const char* ffc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
