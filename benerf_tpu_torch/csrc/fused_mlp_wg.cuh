// The NeRF network of K1-K4 on the Hopper layer product (wgmma_layer.cuh):
// a 64-point tile's activations point-major in shared memory, the in-block
// positional encodings, the CUDA-core heads, and the forward through trunk,
// feature and views layers.
#pragma once

#include "fused_mlp_common.cuh"
#include "wgmma_layer.cuh"

namespace fmlp {

// Positional encodings of the block's points into PE (point-major, row
// stride ldp, 64 columns) and VPE (ldv, 32 columns), column order [x,
// sin(f0 x), cos(f0 x), sin(f1 x), ...] with fk = 2^k, band columns times
// band[k] (BARF weights; all ones when band is null), pad columns and
// points past n zero. pts (n, 3); vd (n / S, 3): a point's view direction
// is its ray's. With vd null only PE is written. The consumer threads.
__device__ __forceinline__ void encode_pm(const float* __restrict__ pts,
                                          const float* __restrict__ vd,
                                          int64_t n, int S,
                                          const float* __restrict__ band,
                                          int64_t p0, float* PE, int ldp,
                                          float* VPE, int ldv) {
  const int cols = vd ? PE_PAD + VPE_PAD : PE_PAD;
  for (int e = threadIdx.x; e < cols * TP; e += wl::CONSUMERS) {
    const int col = e % cols, c = e / cols;
    const int64_t p = p0 + c;
    const bool views = col >= PE_PAD;
    const int r = views ? col - PE_PAD : col;
    const int rows = views ? VPE_ROWS : PE_ROWS;
    float v = 0.f;
    if (p < n && r < rows) {
      const float* src = views ? vd + (p / S) * 3 : pts + p * 3;
      if (r < 3) {
        v = __ldg(src + r);
      } else {
        const int k = (r - 3) / 6, m = (r - 3) % 6;
        const float x = __ldg(src + (m % 3)) * (float)(1 << k);
        v = m < 3 ? sinf(x) : cosf(x);
        if (band) v *= __ldg(band + (views ? L_PTS : 0) + k);
      }
    }
    if (views)
      VPE[c * ldv + r] = v;
    else
      PE[c * ldp + r] = v;
  }
}

// raw head outputs: out[p][c_out] = bias + sum_i w[i * ldw + col] a[p][i]
// (a = h7 for alpha, hv for rgb; point-major, row stride ld); 4 consumer
// threads a point split the contraction. fp32 on the CUDA cores.
__device__ __forceinline__ void head_pm(const float* __restrict__ w, int ldw,
                                        int col, int I, const float* a, int ld,
                                        float bias, float* out, int64_t n,
                                        int64_t p0, int C, int c_out) {
  const int c = threadIdx.x / 4, part = threadIdx.x % 4;
  const float* ar = a + c * ld;
  float s = 0.f;
  for (int i = part; i < I; i += 4) s = fmaf(__ldg(w + i * ldw + col), ar[i], s);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  const int64_t p = p0 + c;
  if (part == 0 && p < n) out[p * (C + 1) + c_out] = s + bias;
}

// rows [0, rows) of a point-major tile (row stride ld: a column per row of
// the scratch) to the feature-major global scratch G (row stride ldg) at
// column col0
__device__ __forceinline__ void copy_cols(const float* src, int ld, int rows,
                                          float* G, int64_t ldg, int64_t col0) {
  for (int e = threadIdx.x; e < rows * TP; e += wl::CONSUMERS) {
    const int r = e / TP, c = e % TP;
    G[(int64_t)r * ldg + col0 + c] = src[c * ld + r];
  }
}

// the same to a bf16 scratch, rounded (rn), two points a 32-bit word
__device__ __forceinline__ void copy_cols_bf16(const float* src, int ld, int rows,
                                               __nv_bfloat16* G, int64_t ldg,
                                               int64_t col0) {
  for (int e = threadIdx.x; e < rows * TP / 2; e += wl::CONSUMERS) {
    const int r = e / (TP / 2), c = 2 * (e % (TP / 2));
    *reinterpret_cast<uint32_t*>(G + (int64_t)r * ldg + col0 + c) =
        tc::bf16x2(src[c * ld + r], src[(c + 1) * ld + r]);
  }
}

// The views layer's second input, a compile-time choice:
//  - ViewPE (K1/K2): the view encoding in the block, VPE:
//    hv = relu(wfv^T f + wvpe^T vpe + bv);
//  - ViewBias (K3/K4): the per-ray bias vb (n / S, 128) = vpe @ w_pe + b
//    made outside and read from L2: hv = relu(wfv^T f + vb[p / S]) for
//    point p. A ray's samples may straddle tiles, so the ray is looked up
//    per point; points past n read ray 0 (their outputs are never
//    written, their cotangent is zero).
struct ViewPE {
  static constexpr bool kEncoded = true;
  const float* VPE;
};
struct ViewBias {
  static constexpr bool kEncoded = false;
  const float* vb;
  int64_t n, p0;
  int S;
};

// acc += vb[ray of the point][feature], then ReLU (a 128-wide product;
// a thread's accumulators hold two points, rows 0 and 8 of its warp's)
__device__ __forceinline__ void ray_bias_relu(float (&acc)[32], const ViewBias& v) {
  using F = wl::Frag<HEAD>;
  const int64_t p = v.p0 + F::point(0);
  const float* vb0 = v.vb + (p < v.n ? p / v.S : 0) * HEAD + F::feat(0);
  const float* vb1 = v.vb + (p + 8 < v.n ? (p + 8) / v.S : 0) * HEAD + F::feat(0);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int f = F::feat(i) - F::feat(0);
    acc[i] = fmaxf(acc[i] + __ldg(((i >> 1) & 1 ? vb1 : vb0) + f), 0.f);
  }
}

// Rows of the backward's scratch, [row][point] with row stride n_pad
// (fused_mlp_bwd_common.cuh has its formats). VIEW_PE: K2's (the view
// encoding VPE among the activations), else K4's. The X rows and the ReLU
// signs are the forward's: K1 writes K2's when autograd will need them
// (`store_kept`), K4's tile pass runs K3's forward again to write its own.
template <bool VIEW_PE>
struct Scratch {
  static constexpr int X_PE = 0;
  static constexpr int X_H = X_PE + PE_PAD;          // h0..h7
  static constexpr int X_F = X_H + DEPTH * WIDTH;
  static constexpr int X_VPE = X_F + WIDTH;          // K2 only
  static constexpr int X_HV = X_VPE + (VIEW_PE ? VPE_PAD : 0);
  static constexpr int X_ROWS = X_HV + HEAD;         // 2528 (K2), 2496 (K4)
  static constexpr int D_PRE = 0;                    // d pre-activation, layers 0..7
  static constexpr int D_F = D_PRE + DEPTH * WIDTH;
  static constexpr int D_HV = D_F + WIDTH;           // K4: d vb per point
  static constexpr int D_G = D_HV + HEAD;            // cotangent rows (rgb..., alpha)
};

// BF16: the fp32 rows (row stride n_pad). h7 and hv are the forward's; K4
// keeps them, its d vb per point and the cotangent in one array, K2 the
// cotangent in an array of its backward's own (from row 0) beside the h7
// and hv rows that K1 kept.
template <bool VIEW_PE>
struct Side {
  static constexpr int H7 = 0;                       // h7 (wa's gradient)
  static constexpr int HV = H7 + WIDTH;              // hv (wrgb's)
  static constexpr int KEPT = HV + HEAD;             // K2: K1's rows
  static constexpr int DHV = KEPT;                   // K4: d vb per point
  static constexpr int G = VIEW_PE ? 0 : DHV + HEAD;  // cotangent rows
};

// ReLU sign words of a consumer thread: h0..h7 (two each) and hv. A tile's
// are word-major, [word][consumer thread] (wl::save_signs): in shared
// memory where the tile pass keeps them, in global memory, tile after
// tile, where K1 keeps them for K2 (SIGN_WORDS a tile, 272 B a point).
constexpr int MASK_WORDS = DEPTH * 2 + 1;
constexpr int SIGN_WORDS = MASK_WORDS * wl::CONSUMERS;

// How forward_wg keeps its forward, a compile-time choice by the type of
// its `keep`:
//  - Keep (K4's tile pass, which keeps K3's forward for its own backward):
//    the consumers store every activation from their accumulators, in the
//    epilogue of its layer;
//  - KeptSigns (K1 keeping its forward for K2, fwd_kernel<MODE, true>): the
//    consumers store only the ReLU sign words; the storer copies each
//    activation out of H while the consumers run the next layer's products
//    (store_kept);
//  - nullptr (K1 without grad, K3): nothing is kept.
// Keep: every activation is written to the feature-major scratch X (row
// stride ldx, column col0) at rows x_h + 256 l (trunk), x_f (feature),
// x_hv (views), and the ReLU signs of h0..h7 and hv to `masks`
// (MASK_WORDS words a consumer thread). BF16 (fused_mlp_bwd_common.cuh): X
// is the tile's block of the bf16 scratch (ldx 64, col0 0) and holds the
// trunk and the feature; h7 also goes to the fp32 rows `side` + s_h7 (row
// stride lds, column cols), hv only to `side` + s_hv.
struct Keep {
  static constexpr bool kStorer = false;
  float* X;
  int64_t ldx, col0;
  int x_h, x_f, x_hv;
  uint32_t* masks;
  float* side;
  int64_t lds, cols;
  int s_h7, s_hv;
};

// K1's: the tile's sign words (SIGN_WORDS, as Keep's masks)
struct KeptSigns {
  static constexpr bool kStorer = true;
  uint32_t* masks;
};

// ---- K1's storer ---------------------------------------------------------------
//
// Warps 1-3 of the producer warpgroup (96 threads; warp 0's first thread
// streams the ring, wl::producer). The consumers hand it each activation
// tile once H holds it (barrier HANDED: the consumers sync, the storer
// waits), and before they overwrite H they wait until the storer has
// copied the last one (barrier COPIED: the storer arrives, the consumers
// sync). A tile's hand-overs: PE and VPE, h0..h7, f, hv; the consumers'
// HANDED and COPIED take the places of the two consumers_sync around each
// store_act, so the copies cost the products nothing while one takes less
// time than the next layer's products.
constexpr int STORER = 96;
constexpr int STORER0 = wl::CONSUMERS + 32;  // the storer's first thread
constexpr int HANDED = 2, COPIED = 3;         // bar 1: wg::consumers_sync

__device__ __forceinline__ void storer_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(wl::CONSUMERS + STORER) : "memory");
}
__device__ __forceinline__ void storer_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(wl::CONSUMERS + STORER) : "memory");
}

// The barriers around a store_act of forward_wg: before it every consumer
// has read H (with the storer: and the storer has copied it), after it H
// holds the new tile (with the storer: handed to it).
template <bool STORE>
__device__ __forceinline__ void tile_read() {
  if constexpr (STORE)
    storer_sync(COPIED);
  else
    wg::consumers_sync();
}
template <bool STORE>
__device__ __forceinline__ void tile_written() {
  if constexpr (STORE)
    storer_sync(HANDED);
  else
    wg::consumers_sync();
}

// rows [0, rows) (a multiple of 4) of a point-major tile in shared memory
// (row stride ld, 16-byte aligned) to the fp32 rows G (row stride ldg) at
// column col0, by the storer: a warp takes 32 points of 4 rows a step, a
// thread one 16-byte load of its point (no bank conflict where ld is 4
// mod 32: TF32X3) and 4 stores, each of the warp's a whole 128-byte line.
__device__ __forceinline__ void store_rows(const float* src, int ld, int rows,
                                          float* G, int64_t ldg, int64_t col0) {
  const int t = threadIdx.x - STORER0, c0 = t % 32;
#pragma unroll 1
  for (int s = t / 32; s < rows / 2; s += STORER / 32) {
    const int r = 4 * (s >> 1), c = 32 * (s & 1) + c0;
    const float4 v = *reinterpret_cast<const float4*>(src + c * ld + r);
    float* g = G + (int64_t)r * ldg + col0 + c;
    __stcs(g, v.x);
    __stcs(g + ldg, v.y);
    __stcs(g + 2 * ldg, v.z);
    __stcs(g + 3 * ldg, v.w);
  }
}

// The same to the tile-blocked bf16 rows G (64 points a row), rounded as
// copy_cols_bf16 and wl::store_global_bf16 round: a warp takes 16 points of
// 16 rows a step, a thread the 16-byte loads of two neighbouring points
// (no bank conflict where ld is 8 mod 32: BF16) and 4 stores of a 32-bit
// word (the two points), each of the warp's four full 32-byte sectors.
__device__ __forceinline__ void store_rows_bf16(const float* src, int ld, int rows,
                                               __nv_bfloat16* G) {
  const int t = threadIdx.x - STORER0, lane = t % 32;
  const int r0 = 4 * (lane & 3), c0 = 2 * ((lane >> 2) & 1) + 4 * (lane >> 3);
#pragma unroll 1
  for (int s = t / 32; s < rows / 4; s += STORER / 32) {
    const int r = 16 * (s >> 2) + r0, c = 16 * (s & 3) + c0;
    const float4 a = *reinterpret_cast<const float4*>(src + c * ld + r);
    const float4 b = *reinterpret_cast<const float4*>(src + (c + 1) * ld + r);
    uint32_t* g = reinterpret_cast<uint32_t*>(G + r * TP + c);
    __stcs(g, tc::bf16x2(a.x, b.x));
    __stcs(g + TP / 2, tc::bf16x2(a.y, b.y));
    __stcs(g + TP, tc::bf16x2(a.z, b.z));
    __stcs(g + 3 * TP / 2, tc::bf16x2(a.w, b.w));
  }
}

// The storer's part of K1 keeping tile `tile` for K2: every hand-over of
// the consumers' forward_wg copied to K2's rows in the mode's format. PE,
// VPE, H: the block's tiles (row strides Ld<MODE>); X: TF32X3 the fp32
// rows (row stride n_pad), BF16 the tile-blocked bf16 rows; side: BF16's
// fp32 rows h7 and hv (Side::KEPT rows). Returns once hv is copied.
template <tc::Mode MODE>
__device__ __forceinline__ void store_kept(const float* PE, const float* VPE,
                                           const float* H, float* X, float* side,
                                           int64_t n_pad, int64_t tile) {
  using L = wl::Ld<MODE>;
  using R = Scratch<true>;
  using SR = Side<true>;
  constexpr bool B = MODE == tc::BF16;
  const int64_t p0 = tile * TP;
  __nv_bfloat16* Xt = reinterpret_cast<__nv_bfloat16*>(X) + tile * R::X_HV * TP;
  auto put = [&](const float* src, int ld, int rows, int row) {
    if constexpr (B)
      store_rows_bf16(src, ld, rows, Xt + row * TP);
    else
      store_rows(src, ld, rows, X + row * n_pad, n_pad, p0);
  };
  storer_sync(HANDED);
  put(PE, L::P, PE_PAD, R::X_PE);
  put(VPE, L::V, VPE_PAD, R::X_VPE);
#pragma unroll 1
  for (int l = 0; l <= DEPTH; ++l) {  // h0..h7, then f (X_F = X_H + 8 x 256)
    storer_arrive(COPIED);
    storer_sync(HANDED);
    put(H, L::H, WIDTH, R::X_H + l * WIDTH);
    if (B && l == DEPTH - 1) store_rows(H, L::H, WIDTH, side + SR::H7 * n_pad, n_pad, p0);
  }
  storer_arrive(COPIED);
  storer_sync(HANDED);
  if constexpr (B)
    store_rows(H, L::H, HEAD, side + SR::HV * n_pad, n_pad, p0);
  else
    put(H, L::H, HEAD, R::X_HV);
}

// The forward on one tile whose point encoding is in PE (the ring's
// schedule starts with it). Leaves hv in H columns 0..127 (every consumer
// has written its part; the caller syncs, tile_written<STORE>, before
// reading). Calls alpha(H) on h7 before f overwrites it (the alpha head of
// K1/K3). w: this thread's consumer warpgroup. keep: what the forward
// keeps and who stores it, by caller (`Keep` above): K4's tile pass a Keep,
// stored from the accumulators in each layer's epilogue; K1 keeping its
// forward a KeptSigns (named as KeepT), each activation tile handed to the
// storer; K1 without grad and K3 nullptr.
template <typename T>
struct NoDeduce {  // keeps a parameter's type out of template deduction
  using type = T;
};
template <tc::Mode MODE, typename KeepT = Keep, typename View, typename Alpha,
          typename RingT>
__device__ __forceinline__ void forward_wg(const float* __restrict__ P,
                                           const Offsets& o, const float* PE,
                                           const View& view, float* H,
                                           RingT& ring,
                                           const typename NoDeduce<KeepT>::type* keep,
                                           Alpha alpha, int w) {
  using L = wl::Ld<MODE>;
  constexpr bool STORE = KeepT::kStorer;
  {
    float acc[64];
    for (int l = 0; l < DEPTH; ++l) {
      wl::zero(acc);
      if (l == 0)
        wl::product<MODE, WIDTH>(acc, PE, L::P, PE_PAD, ring, w);
      else
        wl::product<MODE, WIDTH>(acc, H, L::H, WIDTH, ring, w);
      if (l == SKIP) wl::product<MODE, WIDTH>(acc, PE, L::P, PE_PAD, ring, w);
      wl::bias_act<WIDTH>(acc, P + o.b + l * WIDTH, true);
      if constexpr (STORE) {
        wl::save_signs(keep->masks + l * 2 * wl::CONSUMERS, acc);
      } else if (keep) {
        if constexpr (MODE == tc::BF16) {
          wl::store_global_bf16<WIDTH>(
              reinterpret_cast<__nv_bfloat16*>(keep->X) +
                  (int64_t)(keep->x_h + l * WIDTH) * keep->ldx,
              keep->ldx, keep->col0, acc);
          if (l == DEPTH - 1)
            wl::store_global<WIDTH>(keep->side + (int64_t)keep->s_h7 * keep->lds,
                                    keep->lds, keep->cols, acc);
        } else {
          wl::store_global<WIDTH>(keep->X + (int64_t)(keep->x_h + l * WIDTH) * keep->ldx,
                                  keep->ldx, keep->col0, acc);
        }
        wl::save_signs(keep->masks + l * 2 * wl::CONSUMERS, acc);
      }
      tile_read<STORE>();  // every consumer has read h_{l-1}
      wl::store_act<WIDTH>(H, L::H, acc);
      tile_written<STORE>();  // h_l is written
    }
    alpha(H);  // reads h7; the feature product's barrier orders it before f
    // f = wf^T h7 + bf
    wl::zero(acc);
    wl::product<MODE, WIDTH>(acc, H, L::H, WIDTH, ring, w);
    wl::bias_act<WIDTH>(acc, P + o.bf, false);
    if constexpr (!STORE) {
      if (keep) {
        if constexpr (MODE == tc::BF16)
          wl::store_global_bf16<WIDTH>(
              reinterpret_cast<__nv_bfloat16*>(keep->X) + (int64_t)keep->x_f * keep->ldx,
              keep->ldx, keep->col0, acc);
        else
          wl::store_global<WIDTH>(keep->X + (int64_t)keep->x_f * keep->ldx,
                                  keep->ldx, keep->col0, acc);
      }
    }
    tile_read<STORE>();
    wl::store_act<WIDTH>(H, L::H, acc);
    tile_written<STORE>();
  }
  // hv = relu(wfv^T f + the view input)
  float acc[32];
  wl::zero(acc);
  wl::product<MODE, HEAD>(acc, H, L::H, WIDTH, ring, w);
  if constexpr (View::kEncoded) {
    wl::product<MODE, HEAD>(acc, view.VPE, L::V, VPE_PAD, ring, w);
    wl::bias_act<HEAD>(acc, P + o.bv, true);
  } else {
    ray_bias_relu(acc, view);
  }
  if constexpr (STORE) {
    wl::save_signs(keep->masks + DEPTH * 2 * wl::CONSUMERS, acc);
  } else if (keep) {
    if constexpr (MODE == tc::BF16)
      wl::store_global<HEAD>(keep->side + (int64_t)keep->s_hv * keep->lds,
                             keep->lds, keep->cols, acc);
    else
      wl::store_global<HEAD>(keep->X + (int64_t)keep->x_hv * keep->ldx,
                             keep->ldx, keep->col0, acc);
    wl::save_signs(keep->masks + DEPTH * 2 * wl::CONSUMERS, acc);
  }
  tile_read<STORE>();  // every consumer has read f
  wl::store_act<HEAD>(H, L::H, acc);
}

}  // namespace fmlp
