// Device code shared by the backward kernels K2 (fused_mlp_bwd.cu) and K4
// (staged_mlp_bwd.cu): pass (a), the tile pass, one template over the view
// input (K2's view encoding in the block, K4's per-ray bias), and pass (b),
// the weight gradients as deterministic split-K products over a
// feature-major scratch of activations X and pre-activation gradients D
// (see fused_mlp_bwd.cu); every layer product of both runs on wgmma.
//
// The scratch's format follows the operand mode. TF32X3: X and D in fp32,
// every row of Scratch, [row][point] (19,872 B a point for K2: the split
// needs the fp32 value). BF16: what each reader consumes, 11,384 B a point
// for K2 (-43%). K2's X rows, h7 and hv rows and ReLU sign words (272 B a
// point more) are K1's, which keeps its forward when autograd will need it
// (10,384 B a point in TF32X3, 6,608 in BF16); the backward writes the
// rest. The BF16 format:
//  - X's first X_HV rows and D's first D_G rows (every row a matrix product
//    reads), as the bf16 (rn) operands the products read; tile-blocked,
//    [tile][row][64 points]: a tile's 64 points of a row are 128 B, its
//    rows follow each other, so a TMA box of 128 rows is 16 KB of
//    contiguous memory;
//  - fp32 rows for what reads fp32 (Side): h7, hv and the cotangent for the
//    thin jobs (K2: the cotangent in an array of its own), and K4's d vb
//    per point, which the wrapper sums per ray;
//  - the biases' sums of D's rows from the fp32 values: one partial a
//    64-point tile and row, [tile][BIAS_ROWS], read back from the layer's
//    tile in shared memory after its epilogue (wl::tile_sums: ~1% of the
//    tile pass, where a shuffle tree over the accumulators cost ~6%),
//    which the weight-gradient pass adds chunk by chunk.
#pragma once

#include "fused_mlp_wg.cuh"
#include "wgrad_wgmma.cuh"

namespace fmlp {

// The scratch's rows (Scratch, Side) and the ReLU sign words (MASK_WORDS,
// SIGN_WORDS) are fused_mlp_wg.cuh's, where K1 keeps K2's X rows and signs.
constexpr int BIAS_ROWS = Scratch<true>::D_G;        // 2432
static_assert(BIAS_ROWS == wg::BIAS_ROWS && Scratch<false>::D_G == BIAS_ROWS,
              "the pass reads the tile sums as the tile pass writes them");

// VJP of the encoding for one point: d_enc (the point's row of a
// point-major tile, weighted by band; all ones when band is null) back to
// the 3 input coordinates
__device__ __forceinline__ void encode_bwd(const float* denc, int L,
                                           const float* __restrict__ band,
                                           const float* x3, float* dx) {
  for (int m = 0; m < 3; ++m) {
    const float x = __ldg(x3 + m);
    float s = denc[m];
    for (int k = 0; k < L; ++k) {
      const float f = (float)(1 << k);
      const float b = x * f;
      const float w = band ? __ldg(band + k) : 1.f;
      const float ds = denc[3 + 6 * k + m] * w;
      const float dc = denc[6 + 6 * k + m] * w;
      s += f * (cosf(b) * ds - sinf(b) * dc);
    }
    dx[m] = s;
  }
}

// Where the tile pass writes D's row d_row of its tile (rows of width N):
// TF32X3: to D in fp32 (row stride ld = n_pad, column col0 = p0). BF16: to
// the tile's block of D as bf16 (ld 64, col0 0); once the rows sit in the
// shared tile (H), `d_sums` adds them to the tile's sums bsum[d_row..].
struct DOut {
  float* D;
  int64_t ld, col0;
  float* bsum;  // BF16: this tile's row of [tile][BIAS_ROWS]
};

template <tc::Mode MODE, int N>
__device__ __forceinline__ void d_put(const float (&acc)[N / 4], const DOut& o,
                                      int d_row) {
  if constexpr (MODE == tc::BF16)
    wl::store_global_bf16<N>(reinterpret_cast<__nv_bfloat16*>(o.D) + (int64_t)d_row * o.ld,
                             o.ld, o.col0, acc);
  else
    wl::store_global<N>(o.D + (int64_t)d_row * o.ld, o.ld, o.col0, acc);
}

template <tc::Mode MODE, int N>
__device__ __forceinline__ void d_sums(const float* H, int ldh, const DOut& o,
                                       int d_row) {
  if constexpr (MODE == tc::BF16) wl::tile_sums<N>(H, ldh, o.bsum + d_row);
}

// epilogue of a data-gradient product for d h_l: mask by h_l > 0, store
// d pre_l to D (row d_row) and, once every consumer has read H, to H (row
// stride ldh); BF16: then its tile sums from H
template <tc::Mode MODE, int N>
__device__ __forceinline__ void dgrad_out(float (&acc)[N / 4],
                                          const uint32_t* masks, const DOut& o,
                                          int d_row, float* H, int ldh) {
  wl::apply_signs(acc, masks);
  d_put<MODE, N>(acc, o, d_row);
  wg::consumers_sync();
  wl::store_act<N>(H, ldh, acc);
  wg::consumers_sync();
  d_sums<MODE, N>(H, ldh, o, d_row);
}

// ---- pass (a): the tile pass ----------------------------------------------
//
// One block per 64-point tile (one block of two consumer warpgroups and a
// producer warp per SM) runs the chain rule back through heads, trunk and
// the sin/cos encodings with the data-gradient products B[i][o] = W[i][o]
// (the W copies of the prepared buffer, which the forward launch wrote),
// masking each layer by the ReLU signs of its forward, writes d pts (and
// K2's per-point d viewdir), and stores every pre-activation gradient (D)
// of the tile to the scratch from the accumulators, in the mode's format
// (see the top). Where the forward comes from:
//  - K2 (VIEW_PE): K1 kept it (fused_mlp_wg.cuh `store_kept`): its
//    activations sit in X for pass (b), its sign words in global memory,
//    which one bulk copy brings into shared memory; the pass starts at the
//    backward, its ring streams the data-gradient stages alone;
//  - K4: the pass runs K3's forward again on wgmma (fused_mlp_wg.cuh)
//    first, keeping the signs as bits in shared memory and every
//    activation in X; its ring streams the forward's stages, then the data
//    gradients'. K4's d vb per point is D's rows D_HV (BF16: Side::DHV),
//    which the wrapper sums per ray.
//
// Shared memory (227 KB a block): the ring (96 KB: three TF32X3 or six
// BF16 stages), H (64 points, row stride Ld<MODE>::H), PE (Ld::P) and the
// sign bits (17 words a consumer thread, 17,408 B) are common; the backward
// gathers d pe in PE (and K2's d vpe in VPE). K2 adds VPE (Ld::V), its cotangent tile G (8 rows, C + 1 <= 8,
// [row][point]) and the sign copy's mbarrier:
// 212,024 B in TF32X3, 215,144 in BF16. K4's C + 1
// goes to 128; it loads its cotangent after the forward into H's columns
// 128..255, which hold nothing once hv sits in columns 0..127 (every
// consumer has read f), and copies the alpha column, which the backward
// reads after the feature product has overwritten H, into a row of its own
// (GA): 201,008 / 203,104 B for any C.
template <tc::Mode MODE>
using TileRing = wl::Ring<MODE, 96 * 1024 / wl::Cfg<MODE>::SLOT_BYTES>;

template <tc::Mode MODE, bool VIEW_PE>
constexpr size_t TILE_FLOATS =
    TP * (wl::Ld<MODE>::H + wl::Ld<MODE>::P) +
    (VIEW_PE ? TP * wl::Ld<MODE>::V + G_PAD * TP + 2 : TP) +
    MASK_WORDS * wl::CONSUMERS;
template <tc::Mode MODE, bool VIEW_PE>
constexpr size_t tile_smem_bytes() {
  return wl::smem_bytes<TileRing<MODE>>(TILE_FLOATS<MODE, VIEW_PE>);
}

// wmap / sched: the prepared weights' map and the tile pass's schedule
// (wl::make_sched: K2 the data gradients', K4 the forward's too); view:
// K2's viewdirs vd (n / S, 3) or K4's per-ray bias vb (n / S, 128); band:
// K2's band weights (14,), null for K4 (no BARF); dvd: K2's d viewdir per
// point (n, 3), null for K4; X: K4's X rows of the scratch to write (BF16:
// the bf16 array), unused by K2; D: the scratch's D rows; side, bsum:
// BF16's fp32 rows (K2: its cotangent rows alone) and tile sums (unused in
// TF32X3); signs: K2's, the sign words K1 kept (SIGN_WORDS a tile), null
// for K4. smem: tile_smem_bytes<MODE, VIEW_PE>() bytes.
template <tc::Mode MODE, bool VIEW_PE>
__device__ __forceinline__ void tile_pass(
    const CUtensorMap* wmap, const wl::Sched& sched,
    const float* __restrict__ pts, const float* __restrict__ view, int64_t n,
    int S, const float* __restrict__ P, const float* __restrict__ band,
    const float* __restrict__ g, int C, int64_t n_pad, float* __restrict__ X,
    float* __restrict__ D, float* __restrict__ dpts, float* __restrict__ dvd,
    float* __restrict__ side, float* __restrict__ bsum,
    const uint32_t* __restrict__ signs, uint8_t* smem) {
  using R = Scratch<VIEW_PE>;
  using SR = Side<VIEW_PE>;
  constexpr bool B = MODE == tc::BF16;
  using F128 = wl::Frag<HEAD>;
  using F256 = wl::Frag<WIDTH>;
  using L = wl::Ld<MODE>;
  TileRing<MODE> ring;
  float* H = wl::carve(smem, TILE_FLOATS<MODE, VIEW_PE>, ring);
  float* PE = H + TP * L::H;
  float* VPE = PE + TP * L::P;                            // K2
  float* G = VIEW_PE ? VPE + TP * L::V : nullptr;         // K2: [row][point]
  float* GA = VIEW_PE ? G + C * TP : PE + TP * L::P;      // the alpha row
  uint32_t* masks = reinterpret_cast<uint32_t*>(VIEW_PE ? G + G_PAD * TP : GA + TP);
  // K2: the mbarrier of the sign words' bulk copy, after them
  const uint32_t sign_bar = tc::smem_addr(masks + MASK_WORDS * wl::CONSUMERS);
  if (threadIdx.x == 0) {
    if constexpr (VIEW_PE) wg::mbar_init(sign_bar, 1);
    ring.init();
  }
  __syncthreads();
  if (wl::producer(ring, wmap, sched)) return;
  const int w = wl::warpgroup();
  const Offsets o = offsets(C, VIEW_PE);
  const int64_t p0 = (int64_t)blockIdx.x * TP;
  // BF16: this tile's blocks of the bf16 X and D (rows of 64 points)
  float* Xt = B ? reinterpret_cast<float*>(reinterpret_cast<__nv_bfloat16*>(X) +
                                           (int64_t)blockIdx.x * R::X_HV * TP)
                : X;
  float* Dt = B ? reinterpret_cast<float*>(reinterpret_cast<__nv_bfloat16*>(D) +
                                           (int64_t)blockIdx.x * R::D_G * TP)
                : D;
  const int64_t ldt = B ? TP : n_pad, colt = B ? 0 : p0;
  const DOut dout{Dt, ldt, colt, B ? bsum + (int64_t)blockIdx.x * BIAS_ROWS : nullptr};
  // the cotangent tile (zero past n): K2 into G, K4 into H's columns
  // 128.. and its alpha row into GA; and to D's rows (BF16: Side's)
  auto load_g = [&](int rows) {
    for (int e = threadIdx.x; e < rows * TP; e += wl::CONSUMERS) {
      const int r = e / TP, c = e % TP;
      const int64_t p = p0 + c;
      const float v = (r <= C && p < n) ? __ldg(g + p * (C + 1) + r) : 0.f;
      if (VIEW_PE) {
        G[r * TP + c] = v;
      } else {
        H[c * L::H + HEAD + r] = v;
        if (r == C) GA[c] = v;
      }
      if constexpr (B)
        side[(int64_t)(SR::G + r) * n_pad + p0 + c] = v;
      else
        D[(int64_t)(R::D_G + r) * n_pad + p0 + c] = v;
    }
  };
  // cotangent row k at point p
  auto gval = [&](int k, int p) {
    return VIEW_PE ? G[k * TP + p] : H[p * L::H + HEAD + k];
  };

  if constexpr (VIEW_PE) {
    // the tile's sign words, as K1 left them, while the cotangent loads
    constexpr uint32_t bytes = SIGN_WORDS * sizeof(uint32_t);
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(sign_bar, bytes);
      wg::bulk_load(tc::smem_addr(masks), signs + (int64_t)blockIdx.x * SIGN_WORDS,
                    bytes, sign_bar);
    }
    load_g(G_PAD);
    wg::mbar_wait(sign_bar, 0);
    wg::consumers_sync();
  } else {
    encode_pm(pts, nullptr, n, S, band, p0, PE, L::P, VPE, L::V);
    wg::consumers_sync();
    if constexpr (B)
      copy_cols_bf16(PE, L::P, PE_PAD,
                     reinterpret_cast<__nv_bfloat16*>(Xt) + (int64_t)R::X_PE * TP, TP, 0);
    else
      copy_cols(PE, L::P, PE_PAD, X + (int64_t)R::X_PE * n_pad, n_pad, p0);

    // forward, keeping every activation in X and every ReLU sign in masks
    const Keep keep{Xt, ldt, colt, R::X_H, R::X_F, R::X_HV, masks,
                    side, n_pad, p0, SR::H7, SR::HV};
    forward_wg<MODE>(P, o, PE, ViewBias{view, n, p0, S}, H, ring, &keep,
                     [](const float*) {}, w);
    load_g(C + 1);  // into H columns 128.. (see above)
    wg::consumers_sync();
  }

  // rgb head on CUDA cores, at the views layer's accumulator positions:
  // dhv = wrgb g_rgb, masked by hv > 0 -> D_HV and H columns 0..127 (hv,
  // which nothing reads again)
  {
    float acc[32];
    wl::zero(acc);
    const float* wr = P + o.wrgb + F128::feat(0) * C;
    for (int k = 0; k < C; ++k) {
      const float g0 = gval(k, F128::point(0)), g1 = gval(k, F128::point(2));
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int f = F128::feat(i) - F128::feat(0);
        acc[i] = fmaf(__ldg(wr + f * C + k), (i >> 1) & 1 ? g1 : g0, acc[i]);
      }
    }
    wl::apply_signs(acc, masks + DEPTH * 2 * wl::CONSUMERS);
    d_put<MODE, HEAD>(acc, dout, R::D_HV);
    if constexpr (B && !VIEW_PE)  // K4's d vb per point, summed per ray in fp32
      wl::store_global<HEAD>(side + (int64_t)SR::DHV * n_pad, n_pad, p0, acc);
    wl::store_act<HEAD>(H, L::H, acc);
    wg::consumers_sync();
    d_sums<MODE, HEAD>(H, L::H, dout, R::D_HV);
  }
  if constexpr (VIEW_PE) {
    // view encoding: dvpe = wvpe dhv -> VPE (columns 27..31 come out 0)
    float acc[8];
    wl::zero(acc);
    wl::product<MODE, VPE_PAD>(acc, H, L::H, HEAD, ring, w);
    wl::store_act<VPE_PAD>(VPE, L::V, acc);
  }
  float acc[64];
  // feature: df = wfv dhv -> D_F, H
  wl::zero(acc);
  wl::product<MODE, WIDTH>(acc, H, L::H, HEAD, ring, w);
  d_put<MODE, WIDTH>(acc, dout, R::D_F);
  wg::consumers_sync();
  wl::store_act<WIDTH>(H, L::H, acc);
  wg::consumers_sync();
  d_sums<MODE, WIDTH>(H, L::H, dout, R::D_F);
  // h7: dh = wf df + wa g_alpha, masked by h7 > 0 -> D_PRE + 7, H
  wl::zero(acc);
  wl::product<MODE, WIDTH>(acc, H, L::H, WIDTH, ring, w);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    acc[i] = fmaf(__ldg(P + o.wa + F256::feat(i)), GA[F256::point(i)], acc[i]);
  dgrad_out<MODE, WIDTH>(acc, masks + (DEPTH - 1) * 2 * wl::CONSUMERS, dout,
                         R::D_PRE + (DEPTH - 1) * WIDTH, H, L::H);
  // trunk: dpre_{l-1} = (wh_l dpre_l) * (h_{l-1} > 0); dpe from layer SKIP
  // (kept in PE, whose encoding X already holds) and layer 0
  float dpe[16];
  for (int l = DEPTH - 1; l >= 1; --l) {
    if (l == SKIP) {
      wl::zero(dpe);
      wl::product<MODE, PE_PAD>(dpe, H, L::H, WIDTH, ring, w);
      wl::store_act<PE_PAD>(PE, L::P, dpe);
    }
    wl::zero(acc);
    wl::product<MODE, WIDTH>(acc, H, L::H, WIDTH, ring, w);
    dgrad_out<MODE, WIDTH>(acc, masks + (l - 1) * 2 * wl::CONSUMERS, dout,
                           R::D_PRE + (l - 1) * WIDTH, H, L::H);
  }
  // layer 0: dpe += w0 dpre0 -> PE (each thread adds to its own elements)
  wl::zero(dpe);
  wl::product<MODE, PE_PAD>(dpe, H, L::H, WIDTH, ring, w);
  wl::add_act<PE_PAD>(PE, L::P, dpe);
  wg::consumers_sync();
  // through sin/cos back to the inputs (K2: the points and the viewdirs)
  if (threadIdx.x < (VIEW_PE ? 2 : 1) * TP) {
    const bool views = threadIdx.x >= TP;
    const int c = threadIdx.x % TP;
    const int64_t p = p0 + c;
    if (p < n) {
      float dx[3];
      if (views)
        encode_bwd(VPE + c * L::V, L_VIEWS, band + L_PTS, view + (p / S) * 3, dx);
      else
        encode_bwd(PE + c * L::P, L_PTS, band, pts + p * 3, dx);
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
// one chunk z, written to part[z][out_off + i * O + o] (natural column
// order). Both operands are feature-major, so the contraction runs along
// contiguous memory: the matrix products are wgrad_wgmma.cuh's TMA + wgmma
// kernel.

struct ThinJob {
  int x_row0, I, d_row0, O, out0;  // x_row0 < 0: X is a row of ones (bias)
  int64_t out_off;
};
struct ThinJobs {
  int count, total;
  ThinJob j[MAX_JOBS];
};

// The 1- and C-column heads and their biases: one warp per output element
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

// Fill in each job's tile numbering (GemmJob.tiles_o, .tile0) and each thin
// job's first warp (ThinJob.out0).
inline void number_jobs(GemmJobs* g, ThinJobs* t) {
  int tiles = 0;
  for (int q = 0; q < g->count; ++q) {
    GemmJob& k = g->j[q];
    k.tiles_o = (k.O + wg::TILE - 1) / wg::TILE;
    k.tile0 = tiles;
    tiles += ((k.I + wg::TILE - 1) / wg::TILE) * k.tiles_o;
  }
  t->total = 0;
  for (int q = 0; q < t->count; ++q) {
    t->j[q].out0 = t->total;
    t->total += t->j[q].I * t->j[q].O;
  }
}

// The jobs that together cover the packed gradient vector: the matrix
// products (K2's 12; K4 has no wvpe, the last, and takes the first 11),
// which also sum their D rows into the biases b (layer by layer), bf and
// K2's bv, then the alpha head, its bias, the rgb head and its bias. The
// thin jobs' rows are the fp32 scratch's (TF32X3) or Side's (BF16: X and D
// there are both fp32 rows; K2's cotangent rows are an array of their own).
template <bool VIEW_PE>
inline void make_jobs(int C, GemmJobs* g, ThinJobs* t, int mode) {
  using R = Scratch<VIEW_PE>;
  using SR = Side<VIEW_PE>;
  const bool bf = mode == tc::BF16;
  const int h7 = bf ? SR::H7 : R::X_H + (DEPTH - 1) * WIDTH;
  const int hv = bf ? SR::HV : R::X_HV;
  const int dg = bf ? SR::G : R::D_G;
  const Offsets o = offsets(C, VIEW_PE);
  const int64_t WW = (int64_t)WIDTH * WIDTH;
  const int64_t b = o.b;
  *g = GemmJobs{VIEW_PE ? 12 : 11, {
      {R::X_PE, PE_ROWS, R::D_PRE, WIDTH, 0, 0, o.w0, b},
      {R::X_H + 0 * WIDTH, WIDTH, R::D_PRE + 1 * WIDTH, WIDTH, 0, 0, o.wh + 0 * WW, b + 1 * WIDTH},
      {R::X_H + 1 * WIDTH, WIDTH, R::D_PRE + 2 * WIDTH, WIDTH, 0, 0, o.wh + 1 * WW, b + 2 * WIDTH},
      {R::X_H + 2 * WIDTH, WIDTH, R::D_PRE + 3 * WIDTH, WIDTH, 0, 0, o.wh + 2 * WW, b + 3 * WIDTH},
      {R::X_H + 3 * WIDTH, WIDTH, R::D_PRE + 4 * WIDTH, WIDTH, 0, 0, o.wh + 3 * WW, b + 4 * WIDTH},
      {R::X_H + 4 * WIDTH, WIDTH, R::D_PRE + 5 * WIDTH, WIDTH, 0, 0, o.wh + 4 * WW, b + 5 * WIDTH},
      {R::X_H + 5 * WIDTH, WIDTH, R::D_PRE + 6 * WIDTH, WIDTH, 0, 0, o.wh + 5 * WW, b + 6 * WIDTH},
      {R::X_H + 6 * WIDTH, WIDTH, R::D_PRE + 7 * WIDTH, WIDTH, 0, 0, o.wh + 6 * WW, b + 7 * WIDTH},
      {R::X_PE, PE_ROWS, R::D_PRE + SKIP * WIDTH, WIDTH, 0, 0, o.w5pe, -1},
      {R::X_H + (DEPTH - 1) * WIDTH, WIDTH, R::D_F, WIDTH, 0, 0, o.wf, o.bf},
      {R::X_F, WIDTH, R::D_HV, HEAD, 0, 0, o.wfv, VIEW_PE ? o.bv : -1},
      {R::X_VPE, VPE_ROWS, R::D_HV, HEAD, 0, 0, o.wvpe, -1},
  }};
  *t = ThinJobs{4, 0, {
      {h7, WIDTH, dg + C, 1, 0, o.wa},
      {-1, 1, dg + C, 1, 0, o.ba},
      {hv, HEAD, dg, C, 0, o.wrgb},
      {-1, 1, dg, C, 0, o.brgb},
  }};
  number_jobs(g, t);
}

// The job table as rows of (x_row0, I, d_row0, O, out_off, bias_off), the
// matrix products first, then the thin jobs (x_row0 = -1: a row of ones;
// bias_off -1), 16 rows (K4: 15); returns the row count.
template <bool VIEW_PE>
inline int job_rows(int C, int mode, int64_t* out, int cap) {
  GemmJobs g;
  ThinJobs t;
  make_jobs<VIEW_PE>(C, &g, &t, mode);
  if (g.count + t.count > cap) return g.count + t.count;  // write nothing
  int n = 0;
  for (int q = 0; q < g.count; ++q, ++n) {
    const GemmJob& k = g.j[q];
    const int64_t row[6] = {k.x_row0, k.I, k.d_row0, k.O, k.out_off, k.bias_off};
    for (int c = 0; c < 6; ++c) out[6 * n + c] = row[c];
  }
  for (int q = 0; q < t.count; ++q, ++n) {
    const ThinJob& k = t.j[q];
    const int64_t row[6] = {k.x_row0, k.I, k.d_row0, k.O, k.out_off, -1};
    for (int c = 0; c < 6; ++c) out[6 * n + c] = row[c];
  }
  return n;
}

inline int gemm_tiles(const GemmJobs& g) {
  const GemmJob& l = g.j[g.count - 1];
  return l.tile0 + ((l.I + wg::TILE - 1) / wg::TILE) * l.tiles_o;
}

// Pass (b): every weight gradient dP (Ptot floats, packed layout) from the
// scratch (row stride n_pad) through `splits` partials `part`, the matrix
// products in `mode` (tc::TF32X3 or tc::BF16), the thin jobs fp32: TF32X3
// X, D fp32; BF16 X, D the tile-blocked bf16 arrays of xr and dr rows a
// tile, bsum as the tile pass wrote it, and the fp32 rows that the thin
// jobs read, by make_jobs's table in that mode, as X rows from xside and as
// D rows from dside (K2: K1's h7 and hv, its backward's cotangent; K4: one
// array, both). Returns the first launch error.
inline int weight_gradients(const void* X, const void* D, const float* xside,
                            const float* dside, const float* bsum, int64_t n_pad,
                            int xr, int dr, int splits, int64_t Ptot,
                            const GemmJobs& gj, const ThinJobs& tj, float* part,
                            float* dP, int mode, cudaStream_t stream) {
  const int ks = mode == tc::BF16 ? wg::B_KS : wg::KS;  // a stage's points
  int64_t chunk = (n_pad + splits - 1) / splits;
  chunk = (chunk + ks - 1) / ks * ks;
  int err = launch_wgmma(X, D, bsum, n_pad, xr, dr, chunk, splits, gj,
                         gemm_tiles(gj), part, Ptot, mode, stream);
  if (err) return err;
  const float* tx = mode == tc::BF16 ? xside : static_cast<const float*>(X);
  const float* td = mode == tc::BF16 ? dside : static_cast<const float*>(D);
  const int thin_blocks = (tj.total * 32 + THREADS - 1) / THREADS;
  wgrad_thin_kernel<<<dim3(thin_blocks, splits), THREADS, 0, stream>>>(
      tx, td, n_pad, chunk, part, Ptot, tj);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_kernel<<<(unsigned)((Ptot + 255) / 256), 256, 0, stream>>>(
      part, splits, Ptot, dP);
  return (int)cudaGetLastError();
}

}  // namespace fmlp
