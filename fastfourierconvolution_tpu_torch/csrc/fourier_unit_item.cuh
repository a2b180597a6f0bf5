// The per-item FourierUnit design on a thread-block cluster, for Hopper
// (sm_90a): the stages of fourier_unit_fwd.cu's forward kernel and of
// fourier_unit_train.cu's statistics, backward sums and backward apply
// kernels wherever the item's plan fits shared memory (ops/fourier_unit.py,
// kernel_design "shared").
//
// Ranks. An item (C, H, W) runs on a cluster of R blocks, its ranks (R in
// {1, 2, 4, 8}, R dividing C; ops/fourier_unit.py, item_design). Rank r owns
// the map channels [r*cr, (r+1)*cr), cr = C/R: it loads their planes,
// transforms them in its own shared memory and keeps their spectra there as
// [re planes | im planes] of its cr channels, plane dl (< 2cr) at dl*H*Wf, so
// its local spectral channel dl is the item's channel (dl / cr)*C + r*cr +
// dl % cr of the 2C-channel spectrum. The transforms are per channel, so each
// rank transforms only its own planes. The channel mixes (m = z K, gz = gm
// K^T) and the gK rows need every channel: after a cluster barrier each rank
// copies the other ranks' planes over distributed shared memory into its own
// (cluster_gather: 16-byte units, several in flight per thread, so the
// latency of the remote reads is paid about once), and then computes its
// channels from shared memory.
//
// Stages. Each is a small real product done as register tiles: a thread owns
// a tile of outputs (rows x columns), loads each operand value once per tile
// and step of the sum, and so feeds every loaded value into several FMAs (the
// tile sizes below). A tile's rows are consecutive; its columns are strided
// by the number of column tiles, so that the lanes of a warp, which take
// consecutive column tiles, read consecutive words. Every sum runs over its
// index in increasing order inside one thread (gK: over positions s = p,
// p + P, ... in one thread, then over p in order), so every launch gives the
// same bits; no float atomics.
//
// Tables. The DFT factors are the plain version's own f32 matrices
// (ops/fourier.py, forward_factors), built once per (H, W) and device on the
// host (ops/fourier_unit.py, _item_tables) as [cw (W x Wf) | dw (W x Wf) |
// ah (H x H) | bh (H x H)] with cw + i dw = exp(-2 pi i q v / W) and
// ah + i bh = exp(-2 pi i u p / H) / sqrt(HW); ah and bh are symmetric. Each
// block copies them into its shared memory with cp.async.
//
// Stage by stage (complex values as re/im pairs; the inverse stages and the
// adjoint of the forward transform are the same, as fourier_unit_common.cuh
// says):
//   item_dft_w       map rows x[row][q]        -> sum_q x (cw + i dw)[q][v]
//   item_dft_h<0>    T[c][h][v]               -> sum_h (ah + i bh)[u][h] T
//   item_dft_h<1>    R[c][u][v]               -> sum_u (ah - i bh)[p][u] R
//   item_idft_w      P[c][p][v] (f32)         -> y[c][p][q] = sum_v Pr cw + Pi dw
//   cluster_gather   the item's 2C planes from every rank, over distributed
//                    shared memory, into the rank's own shared memory
//   item_mix         out[dl][s] = sum_j full[j][s] kslice[j][dl] over the
//                    item's 2C channels j, for the rank's channels dl
//   item_gk          gK[j][e] = sum_s z[jl][s] gm[e][s] for the rank's rows j
//   item_channel_sums  per local channel, sums over the positions s (the
//                    statistics kernels' epilogue)

#pragma once

#include "fourier_unit_common.cuh"

namespace ffc {

// Threads of a block of the clustered kernels. A stage of a rank is bound
// by latency (about one block per SM at the 32px maps): its time is that of
// the thread with the most work, so a block has threads enough, and its
// tiles are as small as keep the stage within one task per thread.
constexpr int kItemThreads = 384;
// Tile sizes, rows x columns of the outputs a thread owns. A stage's tiles
// have kRowsSmall rows where that makes no more tasks than the block has
// threads, else kRowsLarge (a fixed rule, stage by stage: tile_rows).
constexpr int kRowsSmall = 2, kRowsLarge = 4;
constexpr int kWV = 2;           // item_dft_w: map rows x complex columns v
constexpr int kHV = 2;           // item_dft_h: rows u (or p) x complex columns v
constexpr int kIQ = 4;           // item_idft_w: map rows x real columns q
constexpr int kMS = 3;           // item_mix: local channels x positions
constexpr int kGJ = 2, kGE = 4;  // item_gk: rows j x columns e
// (Each stage's loop over its sum is unrolled 4 steps deep, so that the
// loads of 4 steps are in flight together.)
// Loads a thread keeps in flight while it copies (device memory, or other
// ranks' shared memory) into shared memory.
constexpr int kInFlight = 4;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Whether a stage that makes `tasks` tasks with tiles of kRowsSmall rows
// takes those tiles: where the tasks are no more than the block's threads.
__host__ __device__ inline bool small_rows(int tasks) { return tasks <= kItemThreads; }

// Geometry of one rank of an item on a cluster of R ranks.
struct ItemRank {
  int C, H, W, wf, hwf, R, cr;
  int wp;  // row stride of a map held in a buffer: odd, so rows fall on other banks
  int ns;  // floats of the rank's re (or im) planes: cr * H * Wf
  __host__ __device__ ItemRank(int c, int h, int w, int r)
      : C(c), H(h), W(w), wf(w / 2 + 1), hwf(h * (w / 2 + 1)), R(r), cr(c / r), wp(w | 1),
        ns(c / r * h * (w / 2 + 1)) {}
  // Floats of a buffer: the rank's spectrum pair, which also holds its map
  // planes at row stride wp (wp <= 2 Wf).
  __host__ __device__ int buf() const { return round4(2 * ns); }
  __host__ __device__ int tables() const { return 2 * W * wf + 2 * H * H; }
  // Floats of a (2C x 2cr) slice of K.
  __host__ __device__ int kslice() const { return round4(4 * C * cr); }
  // Floats of the item's whole 2C-plane spectrum, gathered from the ranks
  // (none on one rank, whose own buffer is the whole spectrum).
  __host__ __device__ int full() const { return R > 1 ? round4(2 * C * hwf) : 0; }
  // The item's spectral channel of local channel dl (< 2cr) on rank `rank`.
  __host__ __device__ int channel(int dl, int rank) const {
    const int im = dl >= cr;
    return im * C + rank * cr + dl - im * cr;
  }
  // Half-spectrum weight of column v: 1 at DC and Nyquist, 2 elsewhere.
  __host__ __device__ float half_weight(int v) const {
    return (v == 0 || (W % 2 == 0 && v == wf - 1)) ? 1.f : 2.f;
  }
  // item_gk's position chunks P: as many as fill the block's threads with
  // tiles, while P partial sums of the rank's 2cr x 2C entries fit one buffer
  // (P <= hwf / 2C); 1 (no partials) where they do not.
  __host__ __device__ int gk_chunks() const {
    const int tiles = ceil_div(2 * cr, kGJ) * ceil_div(2 * C, kGE);
    const int by_room = hwf / (2 * C), by_threads = kItemThreads / tiles;
    const int p = by_room < by_threads ? by_room : by_threads;
    return p > 1 ? p : 1;
  }
};

// i / d for 0 <= i < 2^21 and d > 0 without an integer division: the float
// quotient of i + 1/2 lies at least 1/(2d) from an integer, farther than its
// rounding error for such i (every index of a rank's shared memory).
struct Divider {
  int d;
  float inv;
  __device__ explicit Divider(int divisor) : d(divisor), inv(1.f / divisor) {}
  __device__ int quo(int i) const { return __float2int_rz((i + 0.5f) * inv); }
};

struct ItemTables {
  const float *cw, *dw, *ah, *bh;
  __device__ ItemTables(const float* base, const ItemRank& k)
      : cw(base), dw(base + k.W * k.wf), ah(base + 2 * k.W * k.wf),
        bh(base + 2 * k.W * k.wf + k.H * k.H) {}
};

// For i = threadIdx.x, threadIdx.x + kItemThreads, ... < n: put(i, get(i)),
// with kInFlight gets issued before their puts, so that their latencies
// overlap. No sync.
template <typename V, typename Get, typename Put>
__device__ __forceinline__ void copy_in_flight(int n, Get get, Put put) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kItemThreads * kInFlight) {
    V v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (i0 + u * kItemThreads < n) v[u] = get(i0 + u * kItemThreads);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (i0 + u * kItemThreads < n) put(i0 + u * kItemThreads, v[u]);
  }
}

// Starts asynchronous copies (cp.async, 16 bytes each) of n_bytes, a multiple
// of 16, from device memory to shared memory, both 16-byte aligned; they
// complete at wait_async.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int n_bytes) {
  for (int i = threadIdx.x; i < n_bytes / 16; i += kItemThreads) {
    char* to_generic = static_cast<char*>(dst) + 16 * i;
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(to_generic));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                 "l"(static_cast<const char*>(src) + 16 * i)
                 : "memory");
  }
}

__device__ __forceinline__ void wait_async() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Whether a map's planes can be copied as 16-byte units.
__device__ __forceinline__ bool in_units(const void* p, int n_bytes) {
  return reinterpret_cast<size_t>(p) % 16 == 0 && n_bytes % 16 == 0;
}

// The first n - n % 4 floats of the tables by copy_async, the rest here.
__device__ __forceinline__ void copy_tables(float* dst, const float* src, int n) {
  copy_async(dst, src, 4 * (n & ~3));
  for (int i = (n & ~3) + threadIdx.x; i < n; i += kItemThreads) dst[i] = __ldg(src + i);
}

// The f32 values of the 32-bit word w of a T array: one f32, or two bf16.
__device__ __forceinline__ void word_to_f32(float* out, unsigned w, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void word_to_f32(float* out, unsigned w, __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

// The rank's planes, copied as they are (T) into `raw` (16-byte aligned),
// into rows of stride wp in f32: 16 bytes a thread where a row is a
// multiple of them; no sync.
template <typename T>
__device__ __forceinline__ void unpack_planes(float* dst, const T* raw, const ItemRank& k) {
  constexpr int kPer = 16 / sizeof(T), kPerWord = 4 / sizeof(T);
  const int n = k.cr * k.H * k.W;
  const Divider by_w(k.W);
  if (k.W % kPer == 0) {
    for (int u = threadIdx.x; u < n / kPer; u += kItemThreads) {
      const int i = u * kPer, row = by_w.quo(i);
      float* out = dst + row * k.wp + i - row * k.W;
      const uint4 bits = reinterpret_cast<const uint4*>(raw)[u];
      word_to_f32(out, bits.x, T());
      word_to_f32(out + kPerWord, bits.y, T());
      word_to_f32(out + 2 * kPerWord, bits.z, T());
      word_to_f32(out + 3 * kPerWord, bits.w, T());
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kItemThreads) {
      const int row = by_w.quo(i);
      dst[row * k.wp + i - row * k.W] = load_f32(raw + i);
    }
  }
}

// The rank's cr planes of an NCHW item (src: its first plane) into rows of
// stride wp, in f32; no sync.
template <typename T>
__device__ __forceinline__ void load_planes(float* dst, const T* src, const ItemRank& k) {
  const Divider by_w(k.W);
  copy_in_flight<float>(
      k.cr * k.H * k.W, [=](int i) { return load_f32(src + i); },
      [=](int i, float v) {
        const int row = by_w.quo(i);
        dst[row * k.wp + i - row * k.W] = v;
      });
}

// Slice of K (2C x 2C, [j][d]) into shared memory, no sync: kColumns, K[j][d]
// for every j and the rank's channels d, as [j][dl]; else K[j][e] for the
// rank's rows j and every e, as [e][jl]. Either way the rank's 2cr values of
// one step of the sum are consecutive.
template <bool kColumns, typename T>
__device__ __forceinline__ void load_kslice(float* dst, const T* kmix, const ItemRank& k,
                                            int rank) {
  const int c2 = 2 * k.C, c2r = 2 * k.cr;
  const Divider by_c2r(c2r);
  copy_in_flight<float>(
      c2 * c2r,
      [=](int i) {
        const int outer = by_c2r.quo(i), local = k.channel(i - outer * c2r, rank);
        return load_f32(kmix + (kColumns ? outer * c2 + local : local * c2 + outer));
      },
      [=](int i, float v) { dst[i] = v; });
}

// The item's whole spectrum, plane j (the item's channel) at j * H * Wf, from
// the buffers `src` of every rank (each holding its re planes, then its im
// planes) into `full`, over distributed shared memory: 2R contiguous runs of
// cr planes, copied as 16-byte units where a run is a multiple of them.
// Returns `full`, or on one rank `src`, which then is the whole spectrum.
// The caller has passed a cluster barrier since every rank wrote its `src`.
// Ends on a block barrier.
__device__ __forceinline__ float* cluster_gather(cg::cluster_group& cluster, float* src,
                                                 float* full, const ItemRank& k) {
  if (k.R == 1) return src;
  // run r = half * R + q: rank q's planes of one half, to plane half*C + q*cr
  if (k.ns % 4 == 0) {
    const int run4 = k.ns / 4;
    const Divider by_run(run4);
    copy_in_flight<float4>(
        2 * k.R * run4,
        [=, &cluster](int i) {
          const int run = by_run.quo(i), half = run >= k.R;
          const float* from = cluster.map_shared_rank(src, run - half * k.R) + half * k.ns;
          return reinterpret_cast<const float4*>(from)[i - run * run4];
        },
        [=](int i, float4 v) { reinterpret_cast<float4*>(full)[i] = v; });
  } else {
    const Divider by_run(k.ns);
    copy_in_flight<float>(
        2 * k.R * k.ns,
        [=, &cluster](int i) {
          const int run = by_run.quo(i), half = run >= k.R;
          return cluster.map_shared_rank(src, run - half * k.R)[half * k.ns + i - run * k.ns];
        },
        [=](int i, float v) { full[i] = v; });
  }
  __syncthreads();
  return full;
}

// v = p[0 .. N-1] (N 2 or 4): one 8- or 16-byte load where kVec (p then
// aligned to it), else N. The rows of a thread's tile in item_dft_h and
// item_mix are consecutive words of a table or of K that most lanes of a
// warp share, so one wide load brings N of them in one shared-memory
// wavefront.
template <int N, bool kVec>
__device__ __forceinline__ void loadn(float (&v)[N], const float* p) {
  if constexpr (kVec && N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else if constexpr (kVec && N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// W-stage rDFT of the rank's map rows (stride wp) into its spectrum pair.
template <int kR>
__device__ __forceinline__ void item_dft_w_tiles(const float* map, float* spec,
                                                 const ItemTables& t, const ItemRank& k) {
  const int rows = k.cr * k.H, nv = ceil_div(k.wf, kWV), tasks = nv * ceil_div(rows, kR);
  for (int task = threadIdx.x; task < tasks; task += kItemThreads) {
    const int vt = task % nv, r0 = task / nv * kR;
    int v[kWV];
    const float* x[kR];
#pragma unroll
    for (int b = 0; b < kWV; ++b) v[b] = min(vt + b * nv, k.wf - 1);
#pragma unroll
    for (int a = 0; a < kR; ++a) x[a] = map + min(r0 + a, rows - 1) * k.wp;
    float re[kR][kWV] = {}, im[kR][kWV] = {};
    const float* cw = t.cw;
    const float* dw = t.dw;
#pragma unroll 4
    for (int q = 0; q < k.W; ++q, cw += k.wf, dw += k.wf) {
      float xv[kR], cv[kWV], dv[kWV];
#pragma unroll
      for (int a = 0; a < kR; ++a) xv[a] = x[a][q];
#pragma unroll
      for (int b = 0; b < kWV; ++b) {
        cv[b] = cw[v[b]];
        dv[b] = dw[v[b]];
      }
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int b = 0; b < kWV; ++b) {
          re[a][b] = fmaf(xv[a], cv[b], re[a][b]);
          im[a][b] = fmaf(xv[a], dv[b], im[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int b = 0; b < kWV; ++b) {
        const int r = r0 + a, c = vt + b * nv;
        if (r < rows && c < k.wf) {
          spec[r * k.wf + c] = re[a][b];
          spec[k.ns + r * k.wf + c] = im[a][b];
        }
      }
  }
}

__device__ __forceinline__ void item_dft_w(const float* map, float* spec, const ItemTables& t,
                                           const ItemRank& k) {
  if (small_rows(ceil_div(k.wf, kWV) * ceil_div(k.cr * k.H, kRowsSmall))) {
    item_dft_w_tiles<kRowsSmall>(map, spec, t, k);
  } else {
    item_dft_w_tiles<kRowsLarge>(map, spec, t, k);
  }
}

// H-stage DFT of the rank's spectrum pair, per channel: kInverse false,
// out = (ah + i bh) in; true, out = (ah - i bh) in (the inverse, and the
// adjoint of the forward H-stage). The tables are read as [h][u], which
// their symmetry allows, so the lanes read consecutive words.
template <bool kInverse, int kR, bool kVec>
__device__ __forceinline__ void item_dft_h_tiles(const float* in, float* out,
                                                 const ItemTables& t, const ItemRank& k) {
  const int nv = ceil_div(k.wf, kHV), nu = ceil_div(k.H, kR), tasks = nv * nu * k.cr;
  for (int task = threadIdx.x; task < tasks; task += kItemThreads) {
    const int vt = task % nv, rest = task / nv, u0 = rest % nu * kR, c = rest / nu;
    int v[kHV], u[kR];
#pragma unroll
    for (int b = 0; b < kHV; ++b) v[b] = min(vt + b * nv, k.wf - 1);
#pragma unroll
    for (int a = 0; a < kR; ++a) u[a] = min(u0 + a, k.H - 1);
    const float* xr = in + c * k.hwf;
    const float* xi = xr + k.ns;
    float re[kR][kHV] = {}, im[kR][kHV] = {};
#pragma unroll 4
    for (int h = 0; h < k.H; ++h) {
      float ca[kR], sb[kR], pr[kHV], pi[kHV];
      if constexpr (kVec) {
        loadn<kR, true>(ca, t.ah + h * k.H + u0);
        loadn<kR, true>(sb, t.bh + h * k.H + u0);
      } else {
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          ca[a] = t.ah[h * k.H + u[a]];
          sb[a] = t.bh[h * k.H + u[a]];
        }
      }
      if constexpr (kInverse) {
#pragma unroll
        for (int a = 0; a < kR; ++a) sb[a] = -sb[a];
      }
#pragma unroll
      for (int b = 0; b < kHV; ++b) {
        pr[b] = xr[h * k.wf + v[b]];
        pi[b] = xi[h * k.wf + v[b]];
      }
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int b = 0; b < kHV; ++b) {
          re[a][b] = fmaf(ca[a], pr[b], fmaf(-sb[a], pi[b], re[a][b]));
          im[a][b] = fmaf(ca[a], pi[b], fmaf(sb[a], pr[b], im[a][b]));
        }
    }
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int b = 0; b < kHV; ++b) {
        const int uu = u0 + a, vv = vt + b * nv;
        if (uu < k.H && vv < k.wf) {
          const int o = c * k.hwf + uu * k.wf + vv;
          out[o] = re[a][b];
          out[k.ns + o] = im[a][b];
        }
      }
  }
}

template <bool kInverse>
__device__ __forceinline__ void item_dft_h(const float* in, float* out, const ItemTables& t,
                                           const ItemRank& k) {
  // wide table loads where every tile's rows are whole (H a multiple of
  // the tile's rows) and the tables' rows start on 16-byte boundaries
  const bool aligned = k.H % 4 == 0 && 2 * k.W * k.wf % 4 == 0;
  if (small_rows(ceil_div(k.wf, kHV) * ceil_div(k.H, kRowsSmall) * k.cr)) {
    if (aligned) {
      item_dft_h_tiles<kInverse, kRowsSmall, true>(in, out, t, k);
    } else {
      item_dft_h_tiles<kInverse, kRowsSmall, false>(in, out, t, k);
    }
  } else if (aligned) {
    item_dft_h_tiles<kInverse, kRowsLarge, true>(in, out, t, k);
  } else {
    item_dft_h_tiles<kInverse, kRowsLarge, false>(in, out, t, k);
  }
}

// Inverse W-stage of the rank's spectrum pair into its planes of the NCHW
// output (dst: its first plane): y[row][q] = sum_v Pr cw[q][v] + Pi dw[q][v].
template <int kR, typename T>
__device__ __forceinline__ void item_idft_w_tiles(const float* spec, T* dst,
                                                  const ItemTables& t, const ItemRank& k) {
  const int rows = k.cr * k.H, nq = ceil_div(k.W, kIQ), tasks = nq * ceil_div(rows, kR);
  for (int task = threadIdx.x; task < tasks; task += kItemThreads) {
    const int qt = task % nq, r0 = task / nq * kR;
    const float* cw[kIQ];
    const float* dw[kIQ];
    const float* p[kR];
#pragma unroll
    for (int b = 0; b < kIQ; ++b) {
      const int q = min(qt + b * nq, k.W - 1);
      cw[b] = t.cw + q * k.wf;
      dw[b] = t.dw + q * k.wf;
    }
#pragma unroll
    for (int a = 0; a < kR; ++a) p[a] = spec + min(r0 + a, rows - 1) * k.wf;
    float acc[kR][kIQ] = {};
#pragma unroll 4
    for (int v = 0; v < k.wf; ++v) {
      float pr[kR], pi[kR], cv[kIQ], dv[kIQ];
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        pr[a] = p[a][v];
        pi[a] = p[a][k.ns + v];
      }
#pragma unroll
      for (int b = 0; b < kIQ; ++b) {
        cv[b] = cw[b][v];
        dv[b] = dw[b][v];
      }
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int b = 0; b < kIQ; ++b) acc[a][b] = fmaf(pr[a], cv[b], fmaf(pi[a], dv[b], acc[a][b]));
    }
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int b = 0; b < kIQ; ++b) {
        const int r = r0 + a, q = qt + b * nq;
        if (r < rows && q < k.W) store_f32(dst + r * k.W + q, acc[a][b]);
      }
  }
}

template <typename T>
__device__ __forceinline__ void item_idft_w(const float* spec, T* dst, const ItemTables& t,
                                            const ItemRank& k) {
  if (small_rows(ceil_div(k.W, kIQ) * ceil_div(k.cr * k.H, kRowsSmall))) {
    item_idft_w_tiles<kRowsSmall>(spec, dst, t, k);
  } else {
    item_idft_w_tiles<kRowsLarge>(spec, dst, t, k);
  }
}

// For the rank's 2cr local channels dl and every position s:
//   epi(dl, s, sum_j full[j * H * Wf + s] * kslice[j * 2cr + dl]),
// j = 0 .. 2C-1 in order, over the item's whole spectrum `full` (from
// cluster_gather).
template <int kR, bool kVec, typename Epi>
__device__ __forceinline__ void item_mix_tiles(const float* full, const float* kslice,
                                               const ItemRank& k, Epi epi) {
  const int c2r = 2 * k.cr, nst = ceil_div(k.hwf, kMS), tasks = nst * ceil_div(c2r, kR);
  for (int task = threadIdx.x; task < tasks; task += kItemThreads) {
    const int st = task % nst, d0 = task / nst * kR;
    int s[kMS], dl[kR];
#pragma unroll
    for (int b = 0; b < kMS; ++b) s[b] = min(st + b * nst, k.hwf - 1);
#pragma unroll
    for (int a = 0; a < kR; ++a) dl[a] = min(d0 + a, c2r - 1);
    float acc[kR][kMS] = {};
    const float* zj = full;
    const float* kj = kslice;
#pragma unroll 4
    for (int j = 0; j < 2 * k.C; ++j, zj += k.hwf, kj += c2r) {
      float zv[kMS], kv[kR];
#pragma unroll
      for (int b = 0; b < kMS; ++b) zv[b] = zj[s[b]];
      if constexpr (kVec) {
        loadn<kR, true>(kv, kj + d0);
      } else {
#pragma unroll
        for (int a = 0; a < kR; ++a) kv[a] = kj[dl[a]];
      }
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int b = 0; b < kMS; ++b) acc[a][b] = fmaf(zv[b], kv[a], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int b = 0; b < kMS; ++b)
        if (d0 + a < c2r && st + b * nst < k.hwf) epi(d0 + a, st + b * nst, acc[a][b]);
  }
}

template <typename Epi>
__device__ __forceinline__ void item_mix(const float* full, const float* kslice,
                                         const ItemRank& k, Epi epi) {
  // wide loads of K where the rank's channels are whole tiles, so that
  // every row of the slice starts on a boundary of the load (2cr is even)
  if (small_rows(ceil_div(k.hwf, kMS) * k.cr)) {
    item_mix_tiles<kRowsSmall, true>(full, kslice, k, epi);
  } else if (2 * k.cr % kRowsLarge == 0) {
    item_mix_tiles<kRowsLarge, true>(full, kslice, k, epi);
  } else {
    item_mix_tiles<kRowsLarge, false>(full, kslice, k, epi);
  }
}

// For each of the rank's 2cr local channels dl: out(dl, acc), acc the pair
// of sums that add(acc, dl * H * Wf + s) builds over the positions s. One
// warp per channel: its lanes stride over s, then warp_sum adds them, so
// the order is fixed. The caller has synced since the terms were written.
template <typename Add, typename Out>
__device__ __forceinline__ void item_channel_sums(const ItemRank& k, Add add, Out out) {
  const int lane = threadIdx.x % 32;
  for (int dl = threadIdx.x / 32; dl < 2 * k.cr; dl += kItemThreads / 32) {
    float2 acc = make_float2(0.f, 0.f);
    for (int s = lane; s < k.hwf; s += 32) add(acc, dl * k.hwf + s);
    acc.x = warp_sum(acc.x);
    acc.y = warp_sum(acc.y);
    if (lane == 0) out(dl, acc);
  }
}

// This item's gK rows of the rank, gK[j][e] = sum_s z[jl][s] gm[e][s] (j the
// item's channel of local jl, e over the 2C planes of the whole gm from
// cluster_gather), into gk (the item's 2C x 2C row-major f32 scratch row). A
// task sums one tile of entries over positions s = p, p + P, ...; with P > 1
// the P partials go to `part` (P * 2cr * 2C floats) and are then added in
// order p = 0 .. P-1. Ends on a block barrier.
__device__ __forceinline__ void item_gk(const float* z, const float* gm, float* part, float* gk,
                                        int rank, const ItemRank& k) {
  const int c2 = 2 * k.C, c2r = 2 * k.cr, ne = ceil_div(c2, kGE), P = k.gk_chunks();
  const int tasks = P * ne * ceil_div(c2r, kGJ);
  for (int task = threadIdx.x; task < tasks; task += kItemThreads) {
    const int p = task % P, rest = task / P, e0 = rest % ne * kGE, j0 = rest / ne * kGJ;
    const float* zr[kGJ];
    const float* gr[kGE];
#pragma unroll
    for (int a = 0; a < kGJ; ++a) zr[a] = z + min(j0 + a, c2r - 1) * k.hwf;
#pragma unroll
    for (int b = 0; b < kGE; ++b) gr[b] = gm + min(e0 + b, c2 - 1) * k.hwf;
    float acc[kGJ][kGE] = {};
#pragma unroll 4
    for (int s = p; s < k.hwf; s += P) {
      float zv[kGJ], gv[kGE];
#pragma unroll
      for (int a = 0; a < kGJ; ++a) zv[a] = zr[a][s];
#pragma unroll
      for (int b = 0; b < kGE; ++b) gv[b] = gr[b][s];
#pragma unroll
      for (int a = 0; a < kGJ; ++a)
#pragma unroll
        for (int b = 0; b < kGE; ++b) acc[a][b] = fmaf(zv[a], gv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < kGJ; ++a)
#pragma unroll
      for (int b = 0; b < kGE; ++b) {
        const int jl = j0 + a, e = e0 + b;
        if (jl >= c2r || e >= c2) continue;
        if (P == 1) {
          gk[k.channel(jl, rank) * c2 + e] = acc[a][b];
        } else {
          part[(jl * c2 + e) * P + p] = acc[a][b];
        }
      }
  }
  __syncthreads();
  if (P == 1) return;
  for (int i = threadIdx.x; i < c2r * c2; i += kItemThreads) {
    float sum = 0.f;
    for (int p = 0; p < P; ++p) sum += part[i * P + p];
    gk[k.channel(i / c2, rank) * c2 + i % c2] = sum;
  }
  __syncthreads();
}

}  // namespace ffc
