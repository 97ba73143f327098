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

// Outputs of the forward kept for K2/K4: with X non-null every activation
// is written to the feature-major scratch X (row stride ldx, column col0)
// at rows x_h + 256 l (trunk), x_f (feature), x_hv (views), and the ReLU
// signs of h0..h7 and hv to `masks` (DEPTH * 2 + 1 words a consumer
// thread).
struct Keep {
  float* X;
  int64_t ldx, col0;
  int x_h, x_f, x_hv;
  uint32_t* masks;
};

// The forward on one tile whose point encoding is in PE (the ring's
// schedule starts with it). Leaves hv in H columns 0..127 (every consumer
// has written its part; the caller syncs before reading). Calls alpha(H)
// on h7 before f overwrites it (the alpha head of K1/K3). w: this
// thread's consumer warpgroup.
template <tc::Mode MODE, typename View, typename Alpha, typename RingT>
__device__ __forceinline__ void forward_wg(const float* __restrict__ P,
                                           const Offsets& o, const float* PE,
                                           const View& view, float* H,
                                           RingT& ring, const Keep* keep,
                                           Alpha alpha, int w) {
  using L = wl::Ld<MODE>;
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
      if (keep) {
        wl::store_global<WIDTH>(keep->X + (int64_t)(keep->x_h + l * WIDTH) * keep->ldx,
                                keep->ldx, keep->col0, acc);
        wl::save_signs(keep->masks + l * 2 * wl::CONSUMERS, acc);
      }
      wg::consumers_sync();  // every consumer has read h_{l-1}
      wl::store_act<WIDTH>(H, L::H, acc);
      wg::consumers_sync();  // h_l is written
    }
    alpha(H);  // reads h7; the feature product's barrier orders it before f
    // f = wf^T h7 + bf
    wl::zero(acc);
    wl::product<MODE, WIDTH>(acc, H, L::H, WIDTH, ring, w);
    wl::bias_act<WIDTH>(acc, P + o.bf, false);
    if (keep)
      wl::store_global<WIDTH>(keep->X + (int64_t)keep->x_f * keep->ldx,
                              keep->ldx, keep->col0, acc);
    wg::consumers_sync();
    wl::store_act<WIDTH>(H, L::H, acc);
    wg::consumers_sync();
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
  if (keep) {
    wl::store_global<HEAD>(keep->X + (int64_t)keep->x_hv * keep->ldx,
                           keep->ldx, keep->col0, acc);
    wl::save_signs(keep->masks + DEPTH * 2 * wl::CONSUMERS, acc);
  }
  wg::consumers_sync();  // every consumer has read f
  wl::store_act<HEAD>(H, L::H, acc);
}

}  // namespace fmlp
