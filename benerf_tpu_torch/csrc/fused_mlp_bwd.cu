// K2: fused NeRF MLP backward (rematerialized forward + VJP to every
// weight, to the points and to the per-point view directions).
//
// Replaces: benerf_tpu/ops/pallas_mlp_t.py `_bwd_kernel_t` (through
// `_bwd_call`, `_encode_bwd_T` and the `_core` custom_vjp).
//
// Bound on an H100: operations. Per point it redoes the forward (1x the
// forward's 1,186,816 FLOP), forms the data gradients (1x) and the weight
// gradients (1x); the bytes it must move (inputs, cotangent, dpts/dvd and
// the 2.4 MB of weight gradients) are two orders of magnitude below what
// HBM could move in that time.
//
// Design: on the TPU the grid runs in order and every grid step adds its
// tile's weight gradients into one VMEM-resident output. Hopper blocks run
// concurrently, so the work is split in two passes, both deterministic:
//  (a) `tile_kernel`: one block per 64-point tile (K1's one-buffer layout,
//      two blocks per SM) rematerializes K1 in shared memory, runs the chain
//      rule back through heads, trunk and the sin/cos encodings, writes dpts
//      and per-point dvd, and stores every activation (X) and every
//      pre-activation gradient (D) of the tile to a feature-major scratch in
//      HBM ([feature][point], n padded to 64);
//  (b) each weight gradient dW = X_rows D_rows^T (a sum over all points)
//      as a split-K product, the point axis cut into `splits` fixed chunks,
//      one partial per chunk: `wgrad_gemm_kernel` takes the 12 matrix
//      products in one launch (128x128 output tiles, two blocks per SM),
//      `wgrad_thin_kernel`
//      the biases and the 1- and C-column heads (a warp per element); then
//      `reduce_kernel` sums the partials in chunk order. No atomics: the
//      result is the same from run to run, and tile size and split count
//      change it only by the rounding of a reordered sum.
// Padded points carry a zero cotangent, so they add nothing to any sum and
// the last partial tile's gradients are kept (not dropped). fp32 throughout.

#include "fused_mlp_common.cuh"

namespace fmlp {

// rows of the activation scratch X
constexpr int X_PE = 0;
constexpr int X_H = X_PE + PE_PAD;            // h0..h7
constexpr int X_F = X_H + DEPTH * WIDTH;
constexpr int X_VPE = X_F + WIDTH;
constexpr int X_HV = X_VPE + VPE_PAD;
constexpr int X_ROWS = X_HV + HEAD;           // 2528
// rows of the gradient scratch D
constexpr int D_PRE = 0;                      // d pre-activation, layers 0..7
constexpr int D_F = D_PRE + DEPTH * WIDTH;
constexpr int D_HV = D_F + WIDTH;
constexpr int D_G = D_HV + HEAD;              // cotangent rows (rgb..., alpha)
constexpr int D_ROWS = D_G + G_PAD;           // 2440

// acc *= (mask > 0) where mask is a feature-major global tile (row r0)
template <int OT>
__device__ __forceinline__ void relu_mask_global(float (&acc)[OT][PT],
                                                 const float* X, int64_t ld,
                                                 int r0, int64_t col0, int og,
                                                 int pg) {
#pragma unroll
  for (int k = 0; k < OT; ++k) {
    const float* m = X + (int64_t)(r0 + og + 32 * k) * ld + col0 + pg * PT;
    const float4 m0 = *reinterpret_cast<const float4*>(m);
    const float4 m1 = *reinterpret_cast<const float4*>(m + 4);
    const float mv[PT] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[k][j] = mv[j] > 0.f ? acc[k][j] : 0.f;
  }
}

// copy `rows` shared-memory rows to the feature-major global scratch
__device__ __forceinline__ void copy_rows(const float* src, int rows, float* G,
                                          int64_t ld, int64_t col0) {
  for (int e = threadIdx.x; e < rows * TP; e += THREADS) {
    const int r = e / TP, c = e % TP;
    G[(int64_t)r * ld + col0 + c] = src[r * LDA + c];
  }
}

// VJP of the encoding for one point: d_enc rows (weighted by band) back to
// the 3 input coordinates
__device__ __forceinline__ void encode_bwd(const float* denc, int c, int L,
                                           const float* __restrict__ band,
                                           const float* x3, float* dx) {
  for (int m = 0; m < 3; ++m) {
    const float x = __ldg(x3 + m);
    float s = denc[m * LDA + c];
    for (int k = 0; k < L; ++k) {
      const float f = (float)(1 << k);
      const float b = x * f;
      const float w = __ldg(band + k);
      const float ds = denc[(3 + 6 * k + m) * LDA + c] * w;
      const float dc = denc[(6 + 6 * k + m) * LDA + c] * w;
      s += f * (cosf(b) * ds - sinf(b) * dc);
    }
    dx[m] = s;
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
tile_kernel(const float* __restrict__ pts, const float* __restrict__ vd,
            int64_t n, int S, const float* __restrict__ P,
            const float* __restrict__ PTr, const float* __restrict__ band,
            const float* __restrict__ g, int C, int64_t n_pad,
            float* __restrict__ X, float* __restrict__ D,
            float* __restrict__ dpts, float* __restrict__ dvd) {
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* PE = H + WIDTH * LDA;
  float* VPE = PE + PE_PAD * LDA;
  float* G = VPE + VPE_PAD * LDA;
  const Offsets o = offsets(C);
  const TOffsets to = toffsets(C);
  const int og = threadIdx.x % 32, pg = threadIdx.x / 32;
  const int64_t p0 = (int64_t)blockIdx.x * TP;

  // inputs: encodings and the cotangent tile (zero past n)
  encode_tile(pts, vd, n, S, band, p0, PE, VPE);
  for (int e = threadIdx.x; e < G_PAD * TP; e += THREADS) {
    const int r = e / TP, c = e % TP;
    const int64_t p = p0 + c;
    G[r * LDA + c] = (r <= C && p < n) ? __ldg(g + p * (C + 1) + r) : 0.f;
  }
  __syncthreads();
  copy_rows(PE, PE_PAD, X + (int64_t)X_PE * n_pad, n_pad, p0);
  copy_rows(VPE, VPE_PAD, X + (int64_t)X_VPE * n_pad, n_pad, p0);
  copy_rows(G, G_PAD, D + (int64_t)D_G * n_pad, n_pad, p0);

  // forward, keeping every activation in X
  trunk_forward(P, o, PE, H, X, n_pad, X_H, p0);          // h7 in H
  feature_layer(P, o, H, X, n_pad, X_F, p0);              // f in H
  __syncthreads();
  views_layer(P, o, H, VPE, X, n_pad, X_HV, p0);          // hv in H rows 0..127
  __syncthreads();

  // Backward, one buffer as in the forward: each step reads H into
  // registers, waits for every thread, then overwrites H. PE and VPE take
  // d pe and d vpe; only the owning thread reads or writes those elements.
  // rgb head: dhv = wrgb g_rgb, masked by hv > 0 (the thread's own elements)
  {
    float acc[4][PT];
    zero_acc(acc);
    mm_acc<4>(acc, PTr + to.wrgbT, HEAD, C, G, og, pg);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < PT; ++j)
        if (H[(og + 32 * k) * LDA + pg * PT + j] <= 0.f) acc[k][j] = 0.f;
    store_smem<4>(H, acc, og, pg);
    store_global<4>(D + (int64_t)D_HV * n_pad, n_pad, p0, acc, og, pg);
  }
  __syncthreads();
  // view encoding: dvpe = wvpe dhv -> VPE; feature: df = wfv dhv -> H
  {
    float acc[1][PT];
    zero_acc(acc);
    mm_acc<1>(acc, PTr + to.wvpeT, VPE_PAD, HEAD, H, og, pg);
    store_smem<1>(VPE, acc, og, pg);
  }
  {
    float acc[8][PT];
    zero_acc(acc);
    mm_acc<8>(acc, PTr + to.wfvT, WIDTH, HEAD, H, og, pg);
    __syncthreads();
    store_smem<8>(H, acc, og, pg);
    store_global<8>(D + (int64_t)D_F * n_pad, n_pad, p0, acc, og, pg);
  }
  __syncthreads();
  // h7: dh = wf df + wa g_alpha, masked by h7 > 0 -> H
  {
    float acc[8][PT];
    zero_acc(acc);
    mm_acc<8>(acc, PTr + to.wfT, WIDTH, WIDTH, H, og, pg);
    mm_acc<8>(acc, PTr + to.waT, WIDTH, 1, G + C * LDA, og, pg);
    relu_mask_global<8>(acc, X, n_pad, X_H + (DEPTH - 1) * WIDTH, p0, og, pg);
    __syncthreads();
    store_smem<8>(H, acc, og, pg);
    store_global<8>(D + (int64_t)(D_PRE + (DEPTH - 1) * WIDTH) * n_pad, n_pad,
                    p0, acc, og, pg);
  }
  __syncthreads();
  // trunk: dpre_{l-1} = (wh_l dpre_l) * (h_{l-1} > 0); dpe from layer SKIP
  for (int l = DEPTH - 1; l >= 1; --l) {
    if (l == SKIP) {
      float acc[2][PT];
      zero_acc(acc);
      mm_acc<2>(acc, PTr + to.w5peT, PE_PAD, WIDTH, H, og, pg);
      store_smem<2>(PE, acc, og, pg);
    }
    float acc[8][PT];
    zero_acc(acc);
    mm_acc<8>(acc, PTr + to.whT + (int64_t)(l - 1) * WIDTH * WIDTH, WIDTH,
              WIDTH, H, og, pg);
    relu_mask_global<8>(acc, X, n_pad, X_H + (l - 1) * WIDTH, p0, og, pg);
    __syncthreads();
    store_smem<8>(H, acc, og, pg);
    store_global<8>(D + (int64_t)(D_PRE + (l - 1) * WIDTH) * n_pad, n_pad, p0,
                    acc, og, pg);
    __syncthreads();
  }
  // layer 0: dpe += w0 dpre0 (dpre0 in H); each thread owns its PE entries
  {
    float acc[2][PT];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < PT; ++j) acc[k][j] = PE[(og + 32 * k) * LDA + pg * PT + j];
    mm_acc<2>(acc, PTr + to.w0T, PE_PAD, WIDTH, H, og, pg);
    store_smem<2>(PE, acc, og, pg);
  }
  __syncthreads();
  // through sin/cos back to the inputs
  if (threadIdx.x < 2 * TP) {
    const bool views = threadIdx.x >= TP;
    const int c = threadIdx.x % TP;
    const int64_t p = p0 + c;
    if (p < n) {
      float dx[3];
      if (views)
        encode_bwd(VPE, c, L_VIEWS, band + L_PTS, vd + (p / S) * 3, dx);
      else
        encode_bwd(PE, c, L_PTS, band, pts + p * 3, dx);
      float* dst = (views ? dvd : dpts) + p * 3;
      dst[0] = dx[0];
      dst[1] = dx[1];
      dst[2] = dx[2];
    }
  }
}

// ---- pass (b): weight gradients as split-K products ----------------------
//
// dW[i][o] = sum_p X[x_row0 + i][p] * D[d_row0 + o][p] over the points p of
// one chunk z, written to part[z][out_off + i * O + o]. Both operands are
// feature-major, so the contraction runs along contiguous memory.

constexpr int GT = 128;    // output tile of the product kernel (I and O)
constexpr int GK = 16;     // points per shared-memory stage
constexpr int MAX_JOBS = 16;

struct GemmJob {
  int x_row0, I, d_row0, O, tiles_o, tile0;
  int64_t out_off;
};
struct GemmJobs {
  int count;
  GemmJob j[MAX_JOBS];
};

// One block per (128x128 output tile of any job, chunk). 256 threads, each
// an 8x8 register tile: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
// likewise with tx, so a warp's shared-memory reads are broadcasts (X) or
// 16 consecutive float4 (D). Stages of GK points are double-buffered
// through registers: one barrier per stage.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
wgrad_gemm_kernel(const float* __restrict__ X, const float* __restrict__ D,
                  int64_t ld, int64_t chunk, float* __restrict__ part,
                  int64_t Ptot, const GemmJobs jobs) {
  __shared__ __align__(16) float Xs[2][GK][GT + 4];
  __shared__ __align__(16) float Ds[2][GK][GT + 4];
  int q = 0;
  while (q + 1 < jobs.count && (int)blockIdx.x >= jobs.j[q + 1].tile0) ++q;
  const GemmJob J = jobs.j[q];
  const int t = blockIdx.x - J.tile0;
  const int i0 = (t / J.tiles_o) * GT, o0 = (t % J.tiles_o) * GT;
  const int64_t k_begin = (int64_t)blockIdx.y * chunk;
  const int64_t k_end = k_begin + chunk < ld ? k_begin + chunk : ld;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float4 xr[2], dr[2];
  auto load = [&](int64_t k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = threadIdx.x + h * THREADS;  // 512 float4 per operand
      const int r = e >> 2, c4 = e & 3;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      xr[h] = (i0 + r < J.I) ? __ldg(reinterpret_cast<const float4*>(
                  X + (int64_t)(J.x_row0 + i0 + r) * ld + k) + c4) : z;
      dr[h] = (o0 + r < J.O) ? __ldg(reinterpret_cast<const float4*>(
                  D + (int64_t)(J.d_row0 + o0 + r) * ld + k) + c4) : z;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = threadIdx.x + h * THREADS;
      const int r = e >> 2, c = 4 * (e & 3);
      Xs[buf][c][r] = xr[h].x; Xs[buf][c + 1][r] = xr[h].y;
      Xs[buf][c + 2][r] = xr[h].z; Xs[buf][c + 3][r] = xr[h].w;
      Ds[buf][c][r] = dr[h].x; Ds[buf][c + 1][r] = dr[h].y;
      Ds[buf][c + 2][r] = dr[h].z; Ds[buf][c + 3][r] = dr[h].w;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  if (k_begin < k_end) {
    load(k_begin);
    store(0);
  }
  __syncthreads();
  int buf = 0;
  for (int64_t k = k_begin; k < k_end; k += GK) {
    const bool more = k + GK < k_end;
    if (more) load(k + GK);
#pragma unroll
    for (int c = 0; c < GK; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[buf][c][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Xs[buf][c][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ds[buf][c][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ds[buf][c][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  // every product's matrix has interleaved columns in the packed layout:
  // column o at (o % 32) * (O / 32) + o / 32
  float* dst = part + (int64_t)blockIdx.y * Ptot + J.out_off;
  const int ot = J.O / 32;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? ty * 4 + a : 64 + ty * 4 + a - 4);
    if (i >= J.I) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int o = o0 + (b < 4 ? tx * 4 + b : 64 + tx * 4 + b - 4);
      if (o < J.O) dst[(int64_t)i * J.O + (o % 32) * ot + o / 32] = acc[a][b];
    }
  }
}

struct ThinJob {
  int x_row0, I, d_row0, O, out0;  // x_row0 < 0: X is a row of ones (bias)
  int64_t out_off;
};
struct ThinJobs {
  int count, total;
  ThinJob j[MAX_JOBS];
};

// The biases and the 1- and C-column heads: one warp per output element
// (i, o) and chunk, float4 loads along the points, a fixed-order shuffle
// reduction.
__global__ void __launch_bounds__(THREADS)
wgrad_thin_kernel(const float* __restrict__ X, const float* __restrict__ D,
                  int64_t ld, int64_t chunk, float* __restrict__ part,
                  int64_t Ptot, const ThinJobs jobs) {
  const int w = (int)((blockIdx.x * blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (w >= jobs.total) return;
  int q = 0;
  while (q + 1 < jobs.count && w >= jobs.j[q + 1].out0) ++q;
  const ThinJob J = jobs.j[q];
  const int i = (w - J.out0) / J.O, o = (w - J.out0) % J.O;
  const int64_t k_begin = (int64_t)blockIdx.y * chunk;
  const int64_t k_end = k_begin + chunk < ld ? k_begin + chunk : ld;
  const float4* dr = reinterpret_cast<const float4*>(D + (int64_t)(J.d_row0 + o) * ld);
  const float4* xr = J.x_row0 < 0 ? nullptr
      : reinterpret_cast<const float4*>(X + (int64_t)(J.x_row0 + i) * ld);
  float s = 0.f;
  for (int64_t p = k_begin / 4 + lane; p < k_end / 4; p += 32) {
    const float4 d = __ldg(dr + p);
    if (xr) {
      const float4 x = __ldg(xr + p);
      s = fmaf(x.x, d.x, s); s = fmaf(x.y, d.y, s);
      s = fmaf(x.z, d.z, s); s = fmaf(x.w, d.w, s);
    } else {
      s += (d.x + d.y) + (d.z + d.w);
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0)
    part[(int64_t)blockIdx.y * Ptot + J.out_off + (int64_t)i * J.O + o] = s;
}

// out[q] = sum_z part[z][q], z in order
__global__ void reduce_kernel(const float* __restrict__ part, int splits,
                              int64_t Ptot, float* __restrict__ out) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Ptot) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(int64_t)z * Ptot + q];
  out[q] = s;
}

// The jobs that together cover the packed gradient vector: the 12 matrix
// products, then the biases (b, bf, bv are contiguous in both the packed
// vector and D), the alpha head, its bias, the rgb head and its bias.
inline void make_jobs(int C, GemmJobs* g, ThinJobs* t) {
  const Offsets o = offsets(C);
  const int64_t WW = (int64_t)WIDTH * WIDTH;
  GemmJob gj[] = {
      {X_PE, PE_ROWS, D_PRE, WIDTH, 0, 0, o.w0},
      {X_H + 0 * WIDTH, WIDTH, D_PRE + 1 * WIDTH, WIDTH, 0, 0, o.wh + 0 * WW},
      {X_H + 1 * WIDTH, WIDTH, D_PRE + 2 * WIDTH, WIDTH, 0, 0, o.wh + 1 * WW},
      {X_H + 2 * WIDTH, WIDTH, D_PRE + 3 * WIDTH, WIDTH, 0, 0, o.wh + 2 * WW},
      {X_H + 3 * WIDTH, WIDTH, D_PRE + 4 * WIDTH, WIDTH, 0, 0, o.wh + 3 * WW},
      {X_H + 4 * WIDTH, WIDTH, D_PRE + 5 * WIDTH, WIDTH, 0, 0, o.wh + 4 * WW},
      {X_H + 5 * WIDTH, WIDTH, D_PRE + 6 * WIDTH, WIDTH, 0, 0, o.wh + 5 * WW},
      {X_H + 6 * WIDTH, WIDTH, D_PRE + 7 * WIDTH, WIDTH, 0, 0, o.wh + 6 * WW},
      {X_PE, PE_ROWS, D_PRE + SKIP * WIDTH, WIDTH, 0, 0, o.w5pe},
      {X_H + (DEPTH - 1) * WIDTH, WIDTH, D_F, WIDTH, 0, 0, o.wf},
      {X_F, WIDTH, D_HV, HEAD, 0, 0, o.wfv},
      {X_VPE, VPE_ROWS, D_HV, HEAD, 0, 0, o.wvpe},
  };
  g->count = 0;
  int tiles = 0;
  for (const GemmJob& j : gj) {
    GemmJob k = j;
    k.tiles_o = (j.O + GT - 1) / GT;
    k.tile0 = tiles;
    tiles += ((j.I + GT - 1) / GT) * k.tiles_o;
    g->j[g->count++] = k;
  }
  ThinJob tj[] = {
      {-1, 1, D_PRE, DEPTH * WIDTH + WIDTH + HEAD, 0, o.b},  // b, bf, bv
      {X_H + (DEPTH - 1) * WIDTH, WIDTH, D_G + C, 1, 0, o.wa},
      {-1, 1, D_G + C, 1, 0, o.ba},
      {X_HV, HEAD, D_G, C, 0, o.wrgb},
      {-1, 1, D_G, C, 0, o.brgb},
  };
  t->count = 0;
  t->total = 0;
  for (const ThinJob& j : tj) {
    ThinJob k = j;
    k.out0 = t->total;
    t->total += j.I * j.O;
    t->j[t->count++] = k;
  }
}

inline int gemm_tiles(const GemmJobs& g) {
  const GemmJob& l = g.j[g.count - 1];
  return l.tile0 + ((l.I + GT - 1) / GT) * l.tiles_o;
}

}  // namespace fmlp

extern "C" {

// scratch sizes in floats for n_pad points: X, D (feature-major)
void fused_mlp_bwd_scratch(int64_t n_pad, int64_t* out) {
  out[0] = (int64_t)fmlp::X_ROWS * n_pad;
  out[1] = (int64_t)fmlp::D_ROWS * n_pad;
}

// 9 offsets of the transposed weight vector, in the order of fmlp::TOffsets
void fused_mlp_tlayout(int C, int64_t* out) {
  const fmlp::TOffsets o = fmlp::toffsets(C);
  const int64_t v[9] = {o.whT, o.w0T, o.w5peT, o.wfT, o.wfvT,
                        o.wvpeT, o.waT, o.wrgbT, o.total};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// g (n, C+1) cotangent -> dP (packed layout), dpts (n, 3), dvd (n, 3) per
// point. n_pad = n rounded up to 64; X, D scratch as sized above; part
// holds splits * (packed size) partial sums.
int fused_mlp_bwd(const float* pts, const float* vd, int64_t n, int S,
                  const float* P, const float* PTr, const float* band,
                  const float* g, int C, int64_t n_pad, float* X, float* D,
                  float* dpts, float* dvd, float* part, int splits, float* dP,
                  cudaStream_t stream) {
  cudaFuncSetAttribute(fmlp::tile_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)fmlp::SMEM_BYTES);
  fmlp::tile_kernel<<<(unsigned)(n_pad / fmlp::TP), fmlp::THREADS,
                      fmlp::SMEM_BYTES, stream>>>(
      pts, vd, n, S, P, PTr, band, g, C, n_pad, X, D, dpts, dvd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t Ptot = fmlp::offsets(C).total;
  int64_t chunk = (n_pad + splits - 1) / splits;
  chunk = (chunk + fmlp::GK - 1) / fmlp::GK * fmlp::GK;
  fmlp::GemmJobs gj;
  fmlp::ThinJobs tj;
  fmlp::make_jobs(C, &gj, &tj);
  fmlp::wgrad_gemm_kernel<<<dim3(fmlp::gemm_tiles(gj), splits), fmlp::THREADS, 0,
                            stream>>>(X, D, n_pad, chunk, part, Ptot, gj);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int thin_blocks = (tj.total * 32 + fmlp::THREADS - 1) / fmlp::THREADS;
  fmlp::wgrad_thin_kernel<<<dim3(thin_blocks, splits), fmlp::THREADS, 0, stream>>>(
      X, D, n_pad, chunk, part, Ptot, tj);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fmlp::reduce_kernel<<<(unsigned)((Ptot + 255) / 256), 256, 0, stream>>>(
      part, splits, Ptot, dP);
  return (int)cudaGetLastError();
}

}  // extern "C"
