// FourierUnit training kernels for Hopper (sm_90a): the batch statistics of
// the forward and the two passes of the backward. Each per-item kernel
// writes its item's partial sums to an f32 scratch row that the wrapper
// allocates; fu_reduce_kernel then sums the rows
// over the batch in a fixed order, so every launch gives the same bits (no
// float atomics).
//
// With z = DFT(x) (2C channels [re | im]), m = z @ K, n = (m - mean) * inv,
// inv = rsqrt(var + 1e-5), pre = n * scale + bias, and gr = c * DFT(gy) the
// cotangent of the ReLU output (DFT(gy) is the adjoint of the inverse
// transform; c the half-spectrum weights):
//
//   fu_train_stats : per item, sum_s m and sum_s m^2 for each of the 2C
//                    channels (s over H x Wf). Reduced with count = B*H*Wf
//                    to the batch mean and the biased variance E[m^2]-E[m]^2.
//                    Replaces _pallas_forward_{sep,sep2,kron} -> stats_kernel
//                    (fastfourierconvolution_tpu/ops/pallas/fourier_unit.py,
//                    pallas_call at lines 622, 1088, 1363).
//   fu_bwd_stats   : per item, sum_s gpre * n and sum_s gpre, gpre = gr*[pre>0].
//                    Reduced, they are gscale and gbias; sum(gn) = scale*gbias
//                    and sum(gn * n) = scale*gscale follow. Replaces
//                    _pallas_backward_* -> stats_kernel (lines 753, 1222, 1500).
//   fu_bwd_apply   : gm = inv * (gn - mean(gn) - n * mean(gn n)), the batch-
//                    statistics BN cotangent, with gn = scale * gpre; the
//                    item's zT @ gm into the (2C, 2C) gK scratch, and
//                    gx = DFT^T(gm @ K^T). Replaces _pallas_backward_* ->
//                    apply_kernel (lines 806, 1275, 1562) in train mode.
//   fu_reduce      : the fixed-order sum over the batch rows (the TPU kernels
//                    carried these sums in VMEM scratch across their
//                    sequential grid, e.g. lines 609-620, 740-747, 789-797),
//                    for every partial-sum row of the port (the staged mix
//                    stages' too). It is bound by
//                    bytes, one read of the partial rows (0.26-12.6 MB on the
//                    128px step, under 4 us at 3.35 TB/s), and on narrow
//                    shapes by latency: column tiles of 128 floats read as
//                    float4 row segments fill the card where the rows are
//                    wide, and where they are not the rows of a tile are
//                    split over the blocks of a thread-block cluster, which
//                    add their partials over distributed shared memory.
//
// Layout: x, gy and gx are NCHW, contiguous, float32 or bfloat16; K is
// (2C, 2C) in x's dtype; scale, bias, mean, var, gscale and gbias are (2C,)
// float32; the scratch rows and gK are float32. On an out-channel slice
// (tensor parallelism, fourier_unit_item.cuh) K is (2C, 2Co), the vectors
// (2Co,), gy (B, Co, H, W), the rows [2Co | 2Co] and gK (2C, 2Co), and gx is
// the slice's part of the gradient (gz sums over the slice's 2Co channels):
// every kernel takes Co beside C, and with Co = C it is the whole
// FourierUnit's.
//
// Two designs per item; ops/fourier_unit.py (kernel_design) picks one for a
// map, and the staged kernels of fourier_unit_staged.cu take the maps that
// neither serves well (the 128px generator's).
//
// Clustered, wherever the item's plan fits shared memory, on one block or
// spread over a cluster's ranks (the 32px generator's (16,16,16) and
// (8,32,32), the 48px one's (16,24,24) and (8,48,48)): the
// statistics (fu_item_train_stats_kernel), the backward sums
// (fu_item_bwd_stats_kernel) and the backward apply
// (fu_item_bwd_apply_kernel). An item runs on a thread-block cluster of R
// ranks of 384 threads, as the forward's (fourier_unit_item.cuh; R from
// ops/fourier_unit.py, item_design: 2 at batch 64, 8 at batch 1 and 7), each
// rank on C/R channels: it copies the planes of x (and gy) and the tables
// in with cp.async and takes the W- and H-stage DFTs on its channels; after
// a cluster barrier it gathers the item's z from the ranks over distributed
// shared memory and computes its 2cr channels of m as a register-tiled mix.
// Then:
//   - the statistics keep m in shared memory and sum m and m^2 per channel;
//   - the backward sums turn DFT(gy) into gpre in place, keep n beside it
//     and sum gpre * n and gpre per channel;
//   - the backward apply turns DFT(gy) into gm in place; after a second
//     barrier it gathers the item's gm and computes its 2cr rows of this
//     item's gK = z^T gm as a register-tiled product over the positions
//     (each thread a tile of entries over positions s = p, p + P, ..., the
//     P partials then added in order) and its channels of gz = gm K^T;
//     after a third barrier, when no rank reads its gm any more, the
//     adjoint transform (inverse H- and W-stage) of its gz writes its
//     planes of gx.
// A channel sum is owned by one warp (item_channel_sums: lanes strided over
// the positions, then a shuffle tree), and each rank owns distinct
// channels, so no sum crosses ranks and the order is fixed. The statistics
// kernels end on a cluster barrier: no rank leaves while another still
// gathers from its shared memory. Shared memory per rank at batch 64 (R =
// 2): the statistics 41 KB at (16,16,16) and 81 KB at (8,32,32), the
// backward sums 50 KB and 98 KB, the backward apply 53 KB and 99 KB; at
// (8,48,48), where one block's plan exceeds 227 KB, 178 KB, 216 KB and
// 216 KB.
//
// Workspace, elsewhere (maps that no other design takes, e.g. (12,64,64),
// whose 2C is no staged width, or (32,512,512)): one 256-thread block per item holds its
// buffers in the item's slice of a device workspace
// (fourier_unit_common.cuh) and computes in f32 FMAs on the CUDA cores,
// recomputing the spectrum from x instead of reading any saved
// intermediate (the backward's residuals are x, the
// parameters and the batch statistics). Three spectrum-pair buffers: A
// (transform scratch), B (a map, then DFT(gy), then gm in place) and Z (z),
// plus the tables, K and the per-channel vectors; a channel sum or gK entry
// is owned by one warp. A simple, slower design whose stages load from
// L1/L2.
//
// What bounds them on an H100: bytes. Each must read x (and gy) once and
// write a few (2C,) vectors (fu_bwd_apply also gx and gK): 0.5-1.6 MB per
// launch at the 32px generator's shapes in bf16, 0.16-0.47 us at 3.35 TB/s,
// against under 0.1 GFLOP of FFT-sized work, well under 0.1 us at 989
// TFLOP/s. The clustered kernels do dense DFT stages, several times the
// FFT's operations as f32 FMAs (the backward apply 1.1 M per (16,16,16)
// item and 2.9 M per (8,32,32) item, 2.1 and 5.5 us at 67 TFLOP/s over a
// batch of 64), one block per SM; their time is set by the issue of each
// rank's FMAs and of the shared-memory loads that feed its register tiles
// (0.4-1 per FMA), and by the load phase, the cluster barriers and the
// gathers, far above the bytes, which they move once (PERF.md, rows 4, 7
// and 10, by chip_smoke.py).

#include "fourier_unit_item.cuh"

namespace {

using namespace ffc;

// Buffer plan in floats, one for the three workspace kernels; the host sizes
// the workspace with the same plan, and kernel_design reads it.
struct Plan {
  int a_off, b_off, z_off, tab_off, k_off, vec_off, cvec_off, total;
  __host__ __device__ Plan(int c, int co, int h, int w) {
    const Dims d(c, h, w);
    a_off = 0;
    b_off = a_off + 2 * d.n_spec;
    z_off = b_off + d.pair_or_map();
    tab_off = z_off + 2 * d.n_spec;
    k_off = tab_off + d.tables();
    vec_off = k_off + 4 * c * co;
    cvec_off = vec_off + 6 * 2 * co;  // mean, inv, scale, bias, mean_gn, mean_gnn
    total = cvec_off + d.wf;
  }
};

// The item's buffers in its slice of the workspace (do: the out-channels'
// geometry, whose (2Co,) vectors these are).
struct Buffers {
  float *a, *b, *z, *kmix, *mean, *inv, *scale, *bias, *mgn, *mgnn, *cvec;
  Tables tab;
  __device__ Buffers(float* base, const Plan& pl, const Dims& d, const Dims& dout)
      : a(base + pl.a_off), b(base + pl.b_off), z(base + pl.z_off),
        kmix(base + pl.k_off), mean(base + pl.vec_off), inv(mean + 2 * dout.C),
        scale(inv + 2 * dout.C), bias(scale + 2 * dout.C), mgn(bias + 2 * dout.C),
        mgnn(mgn + 2 * dout.C), cvec(base + pl.cvec_off),
        tab(base + pl.tab_off, d) {}
};

// Loads K (2C x 2Co), the tables and the half-spectrum weights (no sync).
template <typename T>
__device__ void load_constants(const Buffers& sm, const T* kmix_g, const Dims& d, int c2o) {
  const int c2 = 2 * d.C;
  for (int i = threadIdx.x; i < c2 * c2o; i += kThreads) sm.kmix[i] = load_f32(kmix_g + i);
  fill_tables(sm.tab, d);
  for (int v = threadIdx.x; v < d.wf; v += kThreads) sm.cvec[v] = half_weight(v, d);
}

// Loads the BN vectors (no sync).
__device__ void load_bn(const Buffers& sm, const float* scale, const float* bias,
                        const float* mean, const float* var, int c2) {
  for (int i = threadIdx.x; i < c2; i += kThreads) {
    sm.mean[i] = mean[i];
    sm.inv[i] = rsqrtf(var[i] + kEps);
    sm.scale[i] = scale[i];
    sm.bias[i] = bias[i];
  }
}

// out = DFT(map), with `map` loaded from device memory into B; A is scratch.
// Starts and ends on a block-wide barrier.
template <typename T>
__device__ void spectrum(const Buffers& sm, const T* map, float* out, const Dims& d) {
  load_map(sm.b, map, d.n_map);
  __syncthreads();
  dft_w(sm.b, sm.a, sm.tab, d);
  __syncthreads();
  dft_h(sm.a, out, sm.tab, d);
  __syncthreads();
}

// The workspace designs; the clustered kernels below serve the maps whose
// plan fits shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fu_train_stats_kernel(const T* __restrict__ x, const T* __restrict__ kmix_g,
                      float* __restrict__ partial, float* __restrict__ ws,
                      int C, int Co, int H, int W) {
  const Dims d(C, H, W), dout(Co, H, W);
  const Plan pl(C, Co, H, W);
  const Buffers sm(item_slice(ws, pl.total), pl, d, dout);
  const int c2 = 2 * C, c2o = 2 * Co, lane = threadIdx.x % 32;
  const size_t item = blockIdx.x;

  load_constants(sm, kmix_g, d, c2o);
  spectrum(sm, x + item * d.n_map, sm.z, d);

  // Row layout: [sum m (2Co) | sum m^2 (2Co)].
  float* row = partial + item * 2 * c2o;
  for (int ch = threadIdx.x / 32; ch < c2o; ch += kWarps) {
    float s1 = 0.f, s2 = 0.f;
    for (int s = lane; s < d.hwf; s += 32) {
      const float m = mix_at(sm.z, sm.kmix, ch, s, c2, c2o, d.hwf);
      s1 += m;
      s2 = fmaf(m, m, s2);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      row[ch] = s1;
      row[c2o + ch] = s2;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fu_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                    const T* __restrict__ kmix_g, const float* __restrict__ scale,
                    const float* __restrict__ bias, const float* __restrict__ mean,
                    const float* __restrict__ var, float* __restrict__ partial,
                    float* __restrict__ ws, int C, int Co, int H, int W) {
  const Dims d(C, H, W), dout(Co, H, W);
  const Plan pl(C, Co, H, W);
  const Buffers sm(item_slice(ws, pl.total), pl, d, dout);
  const int c2 = 2 * C, c2o = 2 * Co, lane = threadIdx.x % 32;
  const size_t item = blockIdx.x;

  load_constants(sm, kmix_g, d, c2o);
  load_bn(sm, scale, bias, mean, var, c2o);
  spectrum(sm, x + item * d.n_map, sm.z, d);
  // B = DFT(gy) of the Co out-channels; B holds the map first
  spectrum(sm, gy + item * dout.n_map, sm.b, dout);

  // Row layout: [sum gpre * n (2Co) | sum gpre (2Co)].
  float* row = partial + item * 2 * c2o;
  for (int ch = threadIdx.x / 32; ch < c2o; ch += kWarps) {
    float s_gn = 0.f, s_g = 0.f;
    for (int s = lane; s < d.hwf; s += 32) {
      const float m = mix_at(sm.z, sm.kmix, ch, s, c2, c2o, d.hwf);
      const float n_hat = (m - sm.mean[ch]) * sm.inv[ch];
      const float pre = n_hat * sm.scale[ch] + sm.bias[ch];
      const float gpre = pre > 0.f ? sm.cvec[s % d.wf] * sm.b[ch * d.hwf + s] : 0.f;
      s_gn = fmaf(gpre, n_hat, s_gn);
      s_g += gpre;
    }
    s_gn = warp_sum(s_gn);
    s_g = warp_sum(s_g);
    if (lane == 0) {
      row[ch] = s_gn;
      row[c2o + ch] = s_g;
    }
  }
}

// The workspace design; fu_item_bwd_apply_kernel below serves the maps whose
// plan fits shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fu_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                    const T* __restrict__ kmix_g, const float* __restrict__ scale,
                    const float* __restrict__ bias, const float* __restrict__ mean,
                    const float* __restrict__ var, const float* __restrict__ gscale,
                    const float* __restrict__ gbias, T* __restrict__ gx,
                    float* __restrict__ partial_gk, float* __restrict__ ws,
                    int C, int Co, int H, int W, float count) {
  const Dims d(C, H, W), dout(Co, H, W);
  const Plan pl(C, Co, H, W);
  const Buffers sm(item_slice(ws, pl.total), pl, d, dout);
  const int c2 = 2 * C, c2o = 2 * Co, hwf = d.hwf, lane = threadIdx.x % 32;
  const size_t item = blockIdx.x;

  load_constants(sm, kmix_g, d, c2o);
  load_bn(sm, scale, bias, mean, var, c2o);
  for (int i = threadIdx.x; i < c2o; i += kThreads) {
    sm.mgn[i] = scale[i] * gbias[i] / count;
    sm.mgnn[i] = scale[i] * gscale[i] / count;
  }
  spectrum(sm, x + item * d.n_map, sm.z, d);
  spectrum(sm, gy + item * dout.n_map, sm.b, dout);

  // gm, in place of DFT(gy) in B.
  for (int o = threadIdx.x; o < 2 * dout.n_spec; o += kThreads) {
    const int s = o % hwf, ch = o / hwf;
    const float m = mix_at(sm.z, sm.kmix, ch, s, c2, c2o, hwf);
    const float n_hat = (m - sm.mean[ch]) * sm.inv[ch];
    const float pre = n_hat * sm.scale[ch] + sm.bias[ch];
    const float gpre = pre > 0.f ? sm.cvec[s % d.wf] * sm.b[o] : 0.f;
    const float gn = gpre * sm.scale[ch];
    sm.b[o] = sm.inv[ch] * (gn - sm.mgn[ch] - n_hat * sm.mgnn[ch]);
  }
  __syncthreads();

  // This item's gK[j][e] = sum_s z[j][s] gm[e][s], one warp per entry.
  float* gk_row = partial_gk + item * c2 * c2o;
  for (int p = threadIdx.x / 32; p < c2 * c2o; p += kWarps) {
    const float* zj = sm.z + (p / c2o) * hwf;
    const float* ge = sm.b + (p % c2o) * hwf;
    float acc = 0.f;
    for (int s = lane; s < hwf; s += 32) acc = fmaf(zj[s], ge[s], acc);
    acc = warp_sum(acc);
    if (lane == 0) gk_row[p] = acc;
  }

  // gz[j][s] = sum_e gm[e][s] K[j][e] over the 2Co channels e, into A.
  for (int o = threadIdx.x; o < 2 * d.n_spec; o += kThreads) {
    const int s = o % hwf, j = o / hwf;
    const float* kj = sm.kmix + j * c2o;
    float acc = 0.f;
    for (int e = 0; e < c2o; ++e) acc = fmaf(sm.b[e * hwf + s], kj[e], acc);
    sm.a[o] = acc;
  }
  __syncthreads();

  // gx = adjoint of the forward DFT: inverse H-stage into Z, inverse W-stage out.
  idft_h(sm.a, sm.z, sm.tab, d);
  __syncthreads();
  idft_w(sm.z, gx + item * d.n_map, sm.tab, d);
}

// Buffer plans in floats of one rank of the clustered kernels (16-byte
// aligned regions); the host mirrors them (ops/fourier_unit.py,
// _item_rank_floats).
struct TrainStatsPlan {
  int a, b, full, tab, kc, total;
  __host__ __device__ TrainStatsPlan(const ItemRank& k, const ItemRank& ko) {
    a = 0;                      // map, then z (read by every rank)
    b = a + k.buf();            // W-stage scratch, then m
    full = b + k.buf();         // the item's z, gathered (R > 1)
    tab = full + k.full();      // cw, dw, ah, bh
    kc = tab + round4(k.tables());  // K[j][d] for the rank's d, [j][dl]
    total = kc + kcolumns(k, ko);
  }
};

struct BwdStatsPlan {
  int a, g, z, full, tab, kc, vec, cvec, total;
  __host__ __device__ BwdStatsPlan(const ItemRank& k, const ItemRank& ko) {
    a = 0;                      // maps, then DFT(gy) -> gpre in place
    g = a + k.buf();            // W-stage scratch, then n
    z = g + k.buf();            // z (read by every rank)
    full = z + k.buf();         // the item's z, gathered (R > 1)
    tab = full + k.full();      // cw, dw, ah, bh
    kc = tab + round4(k.tables());  // K[j][d] for the rank's d, [j][dl]
    vec = kc + kcolumns(k, ko);  // mean, inv, scale, bias (2Co/R each)
    cvec = vec + round4(8 * ko.cr);
    total = cvec + k.wf;
  }
};

// The rank's out-channels of one item's partial row [sums of a (2Co) | sums
// of b (2Co)], a and b the two sums of item_channel_sums (ko: the
// out-channels' geometry).
__device__ __forceinline__ void write_sums(float* row, const ItemRank& ko, int rank, int dl,
                                           float2 sums) {
  const int d = ko.channel(dl, rank);
  row[d] = sums.x;
  row[2 * ko.C + d] = sums.y;
}

// The batch statistics' partial sums of one item on a cluster of R ranks
// (fourier_unit_item.cuh): each rank transforms x on its channels; after a
// barrier it gathers the item's z, computes its channels of m into b and
// writes sum_s m and sum_s m^2 of each to the item's row [sum m (2C) | sum
// m^2 (2C)].
template <typename T>
__global__ void __launch_bounds__(kItemThreads)
fu_item_train_stats_kernel(const T* __restrict__ x, const T* __restrict__ kmix_g,
                           const float* __restrict__ tables, float* __restrict__ partial,
                           int C, int Co, int H, int W) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int R = static_cast<int>(cluster.num_blocks());
  const ItemRank k(C, H, W, R), ko(Co, H, W, R);
  const TrainStatsPlan pl(k, ko);
  float* a = smem + pl.a;
  float* b = smem + pl.b;
  const ItemTables tab(smem + pl.tab, k);
  float* kc = smem + pl.kc;
  const size_t item = blockIdx.x / k.R;
  const size_t planes = (item * C + rank * k.cr) * static_cast<size_t>(H) * W;

  // 1. The rank's planes (as they are into b, asynchronously, where they
  //    are whole 16-byte units) and the tables, while its slice of K loads;
  //    then the planes in f32 into a.
  const int map_bytes = k.cr * H * W * static_cast<int>(sizeof(T));
  const bool units = in_units(x + planes, map_bytes);
  if (units) copy_async(b, x + planes, map_bytes);
  copy_tables(smem + pl.tab, tables, k.tables());
  load_kslice<true>(kc, kmix_g, k, ko, rank);
  wait_async();
  __syncthreads();
  if (units) {
    unpack_planes(a, reinterpret_cast<const T*>(b), k);
  } else {
    load_planes(a, x + planes, k);
  }
  __syncthreads();

  // 2. rDFT over W into b, DFT over H into a: the rank's z.
  item_dft_w(a, b, tab, k);
  __syncthreads();
  item_dft_h<false>(b, a, tab, k);
  cluster.sync();  // every rank's z is in its shared memory

  // 3. The item's z from every rank, then the rank's channels of m = z K
  //    into b, and their sums.
  const float* z = cluster_gather(cluster, a, smem + pl.full, k);
  item_mix(z, kc, 2 * C, ko, [=](int dl, int s, float m) { b[dl * k.hwf + s] = m; });
  __syncthreads();
  float* row = partial + item * 4 * Co;
  item_channel_sums(
      ko,
      [=](float2& acc, int o) {
        const float m = b[o];
        acc.x += m;
        acc.y = fmaf(m, m, acc.y);
      },
      [=](int dl, float2 sums) { write_sums(row, ko, rank, dl, sums); });
  cluster.sync();  // no rank leaves while another still gathers from its a
}

// The backward sums' partials of one item on a cluster of R ranks: each
// rank transforms x and gy on its channels; after a barrier it gathers the
// item's z, computes its channels of m and, in place of DFT(gy) in a, gpre
// = c * DFT(gy) where pre > 0 (else 0), with n in g beside it, and writes
// sum_s gpre * n and sum_s gpre of each channel to the item's row [sum gpre
// * n (2C) | sum gpre (2C)]: stages 1-3 of fu_item_bwd_apply_kernel.
template <typename T>
__global__ void __launch_bounds__(kItemThreads)
fu_item_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                         const T* __restrict__ kmix_g, const float* __restrict__ tables,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         const float* __restrict__ mean, const float* __restrict__ var,
                         float* __restrict__ partial, int C, int Co, int H, int W) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int R = static_cast<int>(cluster.num_blocks());
  const ItemRank k(C, H, W, R), ko(Co, H, W, R);
  const BwdStatsPlan pl(k, ko);
  float* a = smem + pl.a;
  float* g = smem + pl.g;
  float* z = smem + pl.z;
  const ItemTables tab(smem + pl.tab, k);
  float* kc = smem + pl.kc;
  const int c2r = 2 * ko.cr;
  float* bn_mean = smem + pl.vec;
  float* bn_inv = bn_mean + c2r;
  float* bn_scale = bn_inv + c2r;
  float* bn_bias = bn_scale + c2r;
  float* cvec = smem + pl.cvec;
  const size_t item = blockIdx.x / k.R;
  const size_t planes = (item * C + rank * k.cr) * static_cast<size_t>(H) * W;

  // 1. x's planes (as they are into g, asynchronously, where they are whole
  //    16-byte units) and gy's (likewise into the gather buffer, which is
  //    free until the gather, where there is one) and the tables, while the
  //    slice of K and the vectors load; then x's planes in f32 into a.
  const size_t gplanes = (item * Co + rank * ko.cr) * static_cast<size_t>(H) * W;
  const int map_bytes = k.cr * H * W * static_cast<int>(sizeof(T));
  const int gy_bytes = ko.cr * H * W * static_cast<int>(sizeof(T));
  const bool units = in_units(x + planes, map_bytes) && in_units(gy + gplanes, gy_bytes);
  float* gy_raw = k.R > 1 && units ? smem + pl.full : nullptr;
  if (units) copy_async(g, x + planes, map_bytes);
  if (gy_raw) copy_async(gy_raw, gy + gplanes, gy_bytes);
  copy_tables(smem + pl.tab, tables, k.tables());
  // The vectors of the thread's first channel load before the slice of K,
  // so that their latencies overlap.
  const int d0 = ko.channel(min(static_cast<int>(threadIdx.x), c2r - 1), rank);
  const float v0[4] = {mean[d0], var[d0], scale[d0], bias[d0]};
  load_kslice<true>(kc, kmix_g, k, ko, rank);
  for (int dl = threadIdx.x; dl < c2r; dl += kItemThreads) {
    const int d = ko.channel(dl, rank);
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
    unpack_planes(a, reinterpret_cast<const T*>(g), k);
  } else {
    load_planes(a, x + planes, k);
  }
  __syncthreads();

  // 2. z = DFT(x) into z, then DFT(gy) into a.
  item_dft_w(a, g, tab, k);
  __syncthreads();
  item_dft_h<false>(g, z, tab, k);
  __syncthreads();
  if (gy_raw) {
    unpack_planes(a, reinterpret_cast<const T*>(gy_raw), ko);
  } else {
    load_planes(a, gy + gplanes, ko);
  }
  __syncthreads();
  item_dft_w(a, g, tab, ko);
  __syncthreads();
  item_dft_h<false>(g, a, tab, ko);
  cluster.sync();  // every rank's z is in its shared memory

  // 3. gpre of the rank's channels in place of DFT(gy) in a, n in g; m from
  //    the item's z, gathered. Then their sums.
  const float* zs = cluster_gather(cluster, z, smem + pl.full, k);
  item_mix(zs, kc, 2 * C, ko, [=](int dl, int s, float m) {
    const int o = dl * k.hwf + s;
    const float n_hat = (m - bn_mean[dl]) * bn_inv[dl];
    const float pre = n_hat * bn_scale[dl] + bn_bias[dl];
    a[o] = pre > 0.f ? cvec[s % k.wf] * a[o] : 0.f;
    g[o] = n_hat;
  });
  __syncthreads();
  float* row = partial + item * 4 * Co;
  item_channel_sums(
      ko,
      [=](float2& acc, int o) {
        const float gpre = a[o];
        acc.x = fmaf(gpre, g[o], acc.x);
        acc.y += gpre;
      },
      [=](int dl, float2 sums) { write_sums(row, ko, rank, dl, sums); });
  cluster.sync();  // no rank leaves while another still gathers from its z
}

// Buffer plan in floats of one rank of fu_item_bwd_apply_kernel.
struct ItemPlan {
  int a, g, z, full, tab, kc, kr, vec, cvec, total;
  __host__ __device__ ItemPlan(const ItemRank& k, const ItemRank& ko) {
    a = 0;                      // maps, then DFT(gy) -> gm in place (read by every rank), then P
    g = a + k.buf();            // W-stage scratch, then gK partials, then gz
    z = g + k.buf();            // z (read by every rank)
    full = z + k.buf();         // the item's z, then its gm, gathered (R > 1)
    tab = full + k.full();      // cw, dw, ah, bh
    kc = tab + round4(k.tables());  // K[j][d] for the rank's d, [j][dl]
    kr = kc + kcolumns(k, ko);  // K[j][e] for the rank's j, [e][jl]
    vec = kr + krows(k, ko);    // mean, inv, scale, bias, mean_gn, mean_gnn (2Co/R each)
    cvec = vec + round4(12 * ko.cr);
    total = cvec + k.wf;
  }
};

// The backward apply of one item on a cluster of R ranks
// (fourier_unit_item.cuh): each rank transforms x and gy on its channels;
// after a barrier it gathers the item's z and computes its channels of gm;
// after a second barrier it gathers the item's gm and computes its gK rows
// and its channels of gz = gm K^T; after a third, when no rank reads its gm
// any more, the adjoint transform of its gz writes its planes of gx.
template <typename T>
__global__ void __launch_bounds__(kItemThreads)
fu_item_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                         const T* __restrict__ kmix_g, const float* __restrict__ tables,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         const float* __restrict__ mean, const float* __restrict__ var,
                         const float* __restrict__ gscale, const float* __restrict__ gbias,
                         T* __restrict__ gx, float* __restrict__ partial_gk, int C, int Co,
                         int H, int W, float count) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int R = static_cast<int>(cluster.num_blocks());
  const ItemRank k(C, H, W, R), ko(Co, H, W, R);
  const ItemPlan pl(k, ko);
  float* a = smem + pl.a;
  float* g = smem + pl.g;
  float* z = smem + pl.z;
  const ItemTables tab(smem + pl.tab, k);
  float* kc = smem + pl.kc;
  float* kr = smem + pl.kr;
  const int c2r = 2 * ko.cr;
  float* bn_mean = smem + pl.vec;
  float* bn_inv = bn_mean + c2r;
  float* bn_scale = bn_inv + c2r;
  float* bn_bias = bn_scale + c2r;
  float* mgn = bn_bias + c2r;
  float* mgnn = mgn + c2r;
  float* cvec = smem + pl.cvec;
  const size_t item = blockIdx.x / k.R;
  const size_t planes = (item * C + rank * k.cr) * static_cast<size_t>(H) * W;

  // 1. x's planes (as they are into g, asynchronously, where they are whole
  //    16-byte units) and gy's (likewise into the gather buffer, which is
  //    free until the first gather, where there is one) and the tables,
  //    while the two slices of K and the vectors load; then x's planes in
  //    f32 into a.
  const size_t gplanes = (item * Co + rank * ko.cr) * static_cast<size_t>(H) * W;
  const int map_bytes = k.cr * H * W * static_cast<int>(sizeof(T));
  const int gy_bytes = ko.cr * H * W * static_cast<int>(sizeof(T));
  const bool units = in_units(x + planes, map_bytes) && in_units(gy + gplanes, gy_bytes);
  float* gy_raw = k.R > 1 && units ? smem + pl.full : nullptr;
  if (units) copy_async(g, x + planes, map_bytes);
  if (gy_raw) copy_async(gy_raw, gy + gplanes, gy_bytes);
  copy_tables(smem + pl.tab, tables, k.tables());
  // The vectors of the thread's first channel load before the slices of K,
  // so that their latencies overlap.
  const int d0 = ko.channel(min(static_cast<int>(threadIdx.x), c2r - 1), rank);
  const float v0[6] = {mean[d0], var[d0], scale[d0], bias[d0], gscale[d0], gbias[d0]};
  load_kslice<true>(kc, kmix_g, k, ko, rank);
  load_kslice<false>(kr, kmix_g, k, ko, rank);
  for (int dl = threadIdx.x; dl < c2r; dl += kItemThreads) {
    const int d = ko.channel(dl, rank);
    const bool first = dl == static_cast<int>(threadIdx.x);
    const float sc = first ? v0[2] : scale[d];
    bn_mean[dl] = first ? v0[0] : mean[d];
    bn_inv[dl] = rsqrtf((first ? v0[1] : var[d]) + kEps);
    bn_scale[dl] = sc;
    bn_bias[dl] = first ? v0[3] : bias[d];
    mgn[dl] = sc * (first ? v0[5] : gbias[d]) / count;
    mgnn[dl] = sc * (first ? v0[4] : gscale[d]) / count;
  }
  for (int v = threadIdx.x; v < k.wf; v += kItemThreads) cvec[v] = k.half_weight(v);
  wait_async();
  __syncthreads();
  if (units) {
    unpack_planes(a, reinterpret_cast<const T*>(g), k);
  } else {
    load_planes(a, x + planes, k);
  }
  __syncthreads();

  // 2. z = DFT(x) into z, then DFT(gy) into a.
  item_dft_w(a, g, tab, k);
  __syncthreads();
  item_dft_h<false>(g, z, tab, k);
  __syncthreads();
  if (gy_raw) {
    unpack_planes(a, reinterpret_cast<const T*>(gy_raw), ko);
  } else {
    load_planes(a, gy + gplanes, ko);
  }
  __syncthreads();
  item_dft_w(a, g, tab, ko);
  __syncthreads();
  item_dft_h<false>(g, a, tab, ko);
  cluster.sync();  // every rank's z is in its shared memory

  // 3. gm = inv * (gn - mean(gn) - n * mean(gn n)) of the rank's channels,
  //    in place of DFT(gy) in a; m from the item's z, gathered.
  const float* zs = cluster_gather(cluster, z, smem + pl.full, k);
  item_mix(zs, kc, 2 * C, ko, [=](int dl, int s, float m) {
    const int o = dl * k.hwf + s;
    const float n_hat = (m - bn_mean[dl]) * bn_inv[dl];
    const float pre = n_hat * bn_scale[dl] + bn_bias[dl];
    const float gpre = pre > 0.f ? cvec[s % k.wf] * a[o] : 0.f;
    const float gn = gpre * bn_scale[dl];
    a[o] = bn_inv[dl] * (gn - mgn[dl] - n_hat * mgnn[dl]);
  });
  cluster.sync();  // every rank's gm is in its shared memory

  // 4. The item's gm, gathered; the item's gK rows of the rank (partials in
  //    g), then the rank's channels of gz[j][s] = sum_e gm[e][s] K[j][e]
  //    (e over the 2Co out-channels) into g.
  const float* gm = cluster_gather(cluster, a, smem + pl.full, ko);
  item_gk(z, gm, g, partial_gk + item * 4 * C * Co, rank, k, ko);
  item_mix(gm, kr, 2 * Co, k, [=](int dl, int s, float v) { g[dl * k.hwf + s] = v; });
  cluster.sync();  // no rank reads a's gm any more

  // 5. gx = adjoint of the forward DFT: inverse H-stage into a, inverse
  //    W-stage out.
  item_dft_h<true>(g, a, tab, k);
  __syncthreads();
  item_idft_w(a, gx + planes, tab, k);
}

// fu_reduce: out[c] = sum over rows of partial[row][c]; or, kMoments, with
// rows of [sums (n) | sums of squares (n)], out = [mean (n) | E[m^2] -
// mean^2 (n)] over `count` values.
//
// Each block owns a tile of 32 * kVec consecutive columns (of each half with
// kMoments), so a warp reads whole row segments, float4 a lane where kVec is 4.
// The rows go to the blocks of a cluster in contiguous ranges (rank order),
// and within a block to its warps in a fixed pattern (warp w: rows w, w + 8,
// ...), kReduceUnroll independent rows in flight per lane. The warp partials
// are added in shared memory in warp order, then rank 0 adds the ranks'
// block partials through distributed shared memory in rank order and writes
// the tile. Which (kVec, cluster size) a shape takes is a fixed rule of the
// host (ops/fourier_unit.py, reduce_design). No atomics, no global scratch:
// every launch gives the same bits.
constexpr int kReduceUnroll = 4;

template <int kVec>
__device__ __forceinline__ void load_cols(float (&v)[kVec], const float* p) {
  if constexpr (kVec == 4) {
    const float4 f = p ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    v[0] = p ? *p : 0.f;
  }
}

template <int kVec, bool kMoments>
__global__ void __launch_bounds__(kThreads)
fu_reduce_kernel(const float* __restrict__ partial, int rows, int cols, long long count,
                 float* __restrict__ out) {
  constexpr int kTile = 32 * kVec;         // columns of a tile: one warp-wide segment
  constexpr int kSegs = kMoments ? 2 : 1;  // the halves a tile reads
  __shared__ float warp_part[kWarps][kSegs * kTile];
  __shared__ float block_part[kSegs * kTile];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / ranks;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = kMoments ? cols / 2 : cols;
  const int col = tile * kTile + lane * kVec;
  const int per_rank = (rows + ranks - 1) / ranks;
  const int r0 = rank * per_rank;
  const int r1 = min(rows, r0 + per_rank);

  float acc[kSegs][kVec] = {};
  for (int r = r0 + warp; r < r1; r += kWarps * kReduceUnroll) {
    float v[kReduceUnroll][kSegs][kVec];
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u) {
      const int row = r + u * kWarps;
      const float* p =
          col < n && row < r1 ? partial + static_cast<size_t>(row) * cols + col : nullptr;
#pragma unroll
      for (int s = 0; s < kSegs; ++s) load_cols<kVec>(v[u][s], p ? p + s * n : nullptr);
    }
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u)
#pragma unroll
      for (int s = 0; s < kSegs; ++s)
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[s][i] += v[u][s][i];
  }
#pragma unroll
  for (int s = 0; s < kSegs; ++s)
#pragma unroll
    for (int i = 0; i < kVec; ++i) warp_part[warp][s * kTile + lane * kVec + i] = acc[s][i];
  __syncthreads();
  for (int j = threadIdx.x; j < kSegs * kTile; j += kThreads) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += warp_part[w][j];
    block_part[j] = t;
  }
  cluster.sync();  // every rank's block partial is in its shared memory
  if (rank == 0) {
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const int c = tile * kTile + j;
      if (c >= n) continue;
      float s[kSegs] = {};
      for (int q = 0; q < ranks; ++q) {
        const float* other = cluster.map_shared_rank(block_part, q);
#pragma unroll
        for (int k = 0; k < kSegs; ++k) s[k] += other[k * kTile + j];
      }
      if constexpr (kMoments) {
        moments(s[0], s[1], static_cast<float>(count), out + c, out + n + c);
      } else {
        out[c] = s[0];
      }
    }
  }
  cluster.sync();  // no block leaves while rank 0 still reads its shared memory
}

bool bad_args(int B, int C, int Co, int H, int W, const float* ws) {
  return B <= 0 || C <= 0 || Co <= 0 || C % Co != 0 || H <= 0 || W <= 0 || ws == nullptr;
}

// The clustered kernels' launch: B clusters of `ranks` blocks (1, 2, 4 or 8,
// dividing C and Co); the tables 16-byte aligned.
bool bad_item_args(int B, int C, int Co, int H, int W, int ranks, const float* tables) {
  return B <= 0 || C <= 0 || Co <= 0 || C % Co != 0 || H <= 0 || W <= 0 ||
         !cluster_size_ok(ranks) || C % ranks != 0 || Co % ranks != 0 ||
         reinterpret_cast<size_t>(tables) % 16 != 0;
}

template <typename Plan_>
long long rank_floats(int C, int Co, int H, int W, int ranks) {
  return Plan_(ItemRank(C, H, W, ranks), ItemRank(Co, H, W, ranks)).total;
}

template <typename Plan_>
size_t rank_smem(int C, int Co, int H, int W, int ranks) {
  return static_cast<size_t>(rank_floats<Plan_>(C, Co, H, W, ranks)) * sizeof(float);
}

}  // namespace

extern "C" {

// Floats of the buffers of one (C, H, W) item in the workspace kernels: the
// workspace floats per item (and the plan kernel_design reads); _co: mixed
// into Co out-channels.
long long ffc_item_floats_co(int C, int Co, int H, int W) { return Plan(C, Co, H, W).total; }
long long ffc_item_floats(int C, int H, int W) { return ffc_item_floats_co(C, C, H, W); }

// Lets the dtype's clustered kernels take up to `bytes` of dynamic shared
// memory on the current device. Returns a cudaError_t (0 on success).
int ffc_allow_smem(int dtype, int bytes) {
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    int e = cudaFuncSetAttribute(fu_item_train_stats_kernel<T>, attr, bytes);
    if (e == 0) e = cudaFuncSetAttribute(fu_item_bwd_stats_kernel<T>, attr, bytes);
    if (e == 0) e = cudaFuncSetAttribute(fu_item_bwd_apply_kernel<T>, attr, bytes);
    return e;
  });
}

// The workspace statistics. dtype: 0 = float32, 1 = bfloat16; ws: B *
// ffc_item_floats(...) floats; partial: (B, 4C) float32. Each entry point
// returns a cudaError_t (0 on success).
int ffc_fu_train_stats(int dtype, const void* x, const void* k, float* partial, float* ws,
                       int B, int C, int Co, int H, int W, void* stream) {
  if (bad_args(B, C, Co, H, W, ws)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    fu_train_stats_kernel<T><<<B, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(k), partial, ws, C, Co, H, W);
    return static_cast<int>(cudaGetLastError());
  });
}

// The workspace backward sums; partial: (B, 4Co) float32.
int ffc_fu_bwd_stats(int dtype, const void* x, const void* gy, const void* k,
                     const float* scale, const float* bias, const float* mean, const float* var,
                     float* partial, float* ws, int B, int C, int Co, int H, int W,
                     void* stream) {
  if (bad_args(B, C, Co, H, W, ws)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    fu_bwd_stats_kernel<T><<<B, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(gy), static_cast<const T*>(k),
        scale, bias, mean, var, partial, ws, C, Co, H, W);
    return static_cast<int>(cudaGetLastError());
  });
}

// The workspace backward apply. gx: like x; partial_gk: (B, 2C, 2Co) float32;
// gscale and gbias are the reduced backward sums over `count` spectral
// positions (B * H * Wf, or the global batch's under data parallelism); ws:
// B * ffc_item_floats(...) floats.
int ffc_fu_bwd_apply(int dtype, const void* x, const void* gy, const void* k,
                     const float* scale, const float* bias, const float* mean,
                     const float* var, const float* gscale, const float* gbias, void* gx,
                     float* partial_gk, float* ws, int B, int C, int Co, int H, int W,
                     long long count, void* stream) {
  if (bad_args(B, C, Co, H, W, ws) || count <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    fu_bwd_apply_kernel<T><<<B, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(gy), static_cast<const T*>(k),
        scale, bias, mean, var, gscale, gbias, static_cast<T*>(gx), partial_gk, ws,
        C, Co, H, W, static_cast<float>(count));
    return static_cast<int>(cudaGetLastError());
  });
}

// Floats of shared memory one rank of each clustered kernel takes on a
// cluster of R ranks (R dividing C): the backward apply's, the statistics'
// and the backward sums'; _co: mixed into Co out-channels (R dividing Co).
long long ffc_item_rank_floats_co(int C, int Co, int H, int W, int R) {
  return rank_floats<ItemPlan>(C, Co, H, W, R);
}
long long ffc_item_train_stats_rank_floats_co(int C, int Co, int H, int W, int R) {
  return rank_floats<TrainStatsPlan>(C, Co, H, W, R);
}
long long ffc_item_bwd_stats_rank_floats_co(int C, int Co, int H, int W, int R) {
  return rank_floats<BwdStatsPlan>(C, Co, H, W, R);
}
long long ffc_item_rank_floats(int C, int H, int W, int R) {
  return ffc_item_rank_floats_co(C, C, H, W, R);
}
long long ffc_item_train_stats_rank_floats(int C, int H, int W, int R) {
  return ffc_item_train_stats_rank_floats_co(C, C, H, W, R);
}
long long ffc_item_bwd_stats_rank_floats(int C, int H, int W, int R) {
  return ffc_item_bwd_stats_rank_floats_co(C, C, H, W, R);
}

// The clustered kernels: B clusters of `ranks` blocks (1, 2, 4 or 8,
// dividing C), each rank its plan's floats * 4 bytes of shared memory
// (checked by the caller against the limit set by ffc_allow_smem); tables
// as for ffc_fu_item_fwd; outputs as for the workspace entry points. A
// refused cluster launch returns its error.
int ffc_fu_item_train_stats(int dtype, const void* x, const void* k, const float* tables,
                            float* partial, int B, int C, int Co, int H, int W, int ranks,
                            void* stream) {
  if (bad_item_args(B, C, Co, H, W, ranks, tables)) return cudaErrorInvalidValue;
  const size_t smem = rank_smem<TrainStatsPlan>(C, Co, H, W, ranks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return launch_clustered<kItemThreads>(fu_item_train_stats_kernel<T>, B * ranks, ranks, smem,
                                          s, static_cast<const T*>(x), static_cast<const T*>(k),
                                          tables, partial, C, Co, H, W);
  });
}

int ffc_fu_item_bwd_stats(int dtype, const void* x, const void* gy, const void* k,
                          const float* tables, const float* scale, const float* bias,
                          const float* mean, const float* var, float* partial, int B, int C,
                          int Co, int H, int W, int ranks, void* stream) {
  if (bad_item_args(B, C, Co, H, W, ranks, tables)) return cudaErrorInvalidValue;
  const size_t smem = rank_smem<BwdStatsPlan>(C, Co, H, W, ranks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return launch_clustered<kItemThreads>(fu_item_bwd_stats_kernel<T>, B * ranks, ranks, smem,
                                          s, static_cast<const T*>(x),
                                          static_cast<const T*>(gy), static_cast<const T*>(k),
                                          tables, scale, bias, mean, var, partial, C, Co, H,
                                          W);
  });
}

int ffc_fu_item_bwd_apply(int dtype, const void* x, const void* gy, const void* k,
                          const float* tables, const float* scale, const float* bias,
                          const float* mean, const float* var, const float* gscale,
                          const float* gbias, void* gx, float* partial_gk, int B, int C,
                          int Co, int H, int W, int ranks, long long count, void* stream) {
  if (bad_item_args(B, C, Co, H, W, ranks, tables) || count <= 0) return cudaErrorInvalidValue;
  const size_t smem = rank_smem<ItemPlan>(C, Co, H, W, ranks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<1>(dtype, 0, [&](auto tag, auto) {
    using T = typename decltype(tag)::type;
    return launch_clustered<kItemThreads>(fu_item_bwd_apply_kernel<T>, B * ranks, ranks, smem,
                                          s, static_cast<const T*>(x),
                                          static_cast<const T*>(gy), static_cast<const T*>(k),
                                          tables, scale, bias, mean, var, gscale, gbias,
                                          static_cast<T*>(gx), partial_gk, C, Co, H, W,
                                          static_cast<float>(count));
  });
}

// partial: (rows, cols) float32; out: (cols,) float32. count > 0 selects the
// mean/variance epilogue (cols even), count == 0 plain sums. vec: 4 (float4
// loads: the reduced width, cols or cols / 2, a multiple of 4 and partial
// 16-byte aligned) or 1; cluster: the blocks of a cluster that split the
// rows, 1, 2, 4 or 8. The launch takes (reduced width / (32 * vec), rounded
// up) x cluster blocks.
int ffc_fu_reduce(const float* partial, int rows, int cols, long long count, int vec,
                  int cluster, float* out, void* stream) {
  const bool moments = count > 0;
  const int n = moments ? cols / 2 : cols;
  if (rows <= 0 || cols <= 0 || count < 0 || (moments && cols % 2 != 0) ||
      (vec != 1 && vec != 4) || !cluster_size_ok(cluster) ||
      (vec == 4 && (n % 4 != 0 || reinterpret_cast<size_t>(partial) % 16 != 0)))
    return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>((n + 32 * vec - 1) / (32 * vec) * cluster);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) {
    return launch_clustered(kernel, grid, cluster, 0, s, partial, rows, cols, count, out);
  };
  if (vec == 4) return moments ? go(fu_reduce_kernel<4, true>) : go(fu_reduce_kernel<4, false>);
  return moments ? go(fu_reduce_kernel<1, true>) : go(fu_reduce_kernel<1, false>);
}

const char* ffc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
