// The NeRF network of K1-K4 on the tensor cores (mma_layer.cuh): the
// weight sources in the packed layout (fmlp::Offsets, natural column
// order) and the forward through trunk, feature and views layers on one
// 64-point tile.
#pragma once

#include "fused_mlp_common.cuh"
#include "mma_layer.cuh"

namespace fmlp {

// forward products read W (I, O) as A[o][i]; data gradients as A[i][o]
__device__ __forceinline__ tc::WSrc fwd_src(const float* W, int I, int O) {
  return {W, I, O, false};
}
__device__ __forceinline__ tc::WSrc bwd_src(const float* W, int I, int O) {
  return {W, I, O, true};
}

__device__ __forceinline__ const float* wh_ptr(const float* P, const Offsets& o,
                                               int l) {  // trunk layer l >= 1
  return P + o.wh + (int64_t)(l - 1) * WIDTH * WIDTH;
}

// The views layer's second input, a compile-time choice:
//  - ViewPE (K1/K2): the view encoding in the block, VPE (VPE_PAD rows of
//    shared memory): hv = relu(wfv^T f + wvpe^T vpe + bv);
//  - ViewBias (K3/K4): the per-ray bias vb (n / S, 128) = vpe @ w_pe + b
//    made outside and read from L2: hv = relu(wfv^T f + vb[p / S]) for
//    point p. A ray's samples may straddle tiles, so the ray is looked up
//    per point column; points past n read ray 0 (their outputs are never
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

// acc += vb[ray of the column][row], then ReLU, at a thread's fragment
// positions (Tiling<128, 2>)
template <int MT, int NT>
__device__ __forceinline__ void ray_bias_relu(float (&acc)[MT][NT][4],
                                              const ViewBias& v) {
  using T = tc::Tiling<HEAD, MT>;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t p = v.p0 + T::col(nt, h);
      const float* vb = v.vb + (p < v.n ? p / v.S : 0) * HEAD;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = h; r < 4; r += 2)
          acc[mt][nt][r] = fmaxf(acc[mt][nt][r] + __ldg(vb + T::row(mt, r)), 0.f);
    }
}

// Activation rows of K1's tile in shared memory (row stride tc::LDA): H
// (256 rows), PE (64), VPE (32); K2 adds G (8). K3 has no VPE.
constexpr int TC_FWD_ROWS = WIDTH + PE_PAD + VPE_PAD;

// Outputs of the forward kept for K2/K4: with X non-null every activation
// is written to the feature-major scratch X (row stride ldx, column col0)
// at rows x_h + 256 l (trunk), x_f (feature), x_hv (views), and the ReLU
// signs of h0..h7 and hv to `masks` (DEPTH * 2 + 1 words a thread).
struct Keep {
  float* X;
  int64_t ldx, col0;
  int x_h, x_f, x_hv;
  uint32_t* masks;
};

// The forward on one tile whose point encoding is in PE (slice 0 of w0
// already issued into the pipe). Leaves hv in H rows 0..127. Calls
// alpha(H) on h7 before f overwrites it (the alpha head of K1/K3); `after`
// is the product that follows the views layer (the backward's first
// product in K2/K4), or null.
template <tc::Mode MODE, typename View, typename Alpha>
__device__ __forceinline__ void forward_tc(const float* __restrict__ P,
                                           const Offsets& o, const float* PE,
                                           const View& view, float* H,
                                           tc::Pipe& pipe, const Keep* keep,
                                           Alpha alpha, const tc::WSrc* after) {
  using T256 = tc::Tiling<256, 4>;
  using T128 = tc::Tiling<128, 2>;
  const tc::WSrc w5pe = fwd_src(P + o.w5pe, PE_ROWS, WIDTH);
  const tc::WSrc wf = fwd_src(P + o.wf, WIDTH, WIDTH);
  const tc::WSrc wfv = fwd_src(P + o.wfv, WIDTH, HEAD);
  const tc::WSrc wvpe = fwd_src(P + o.wvpe, VPE_ROWS, HEAD);
  {
    float acc[4][T256::NT][4];
    for (int l = 0; l < DEPTH; ++l) {
      tc::zero(acc);
      const tc::WSrc cur = l == 0 ? fwd_src(P + o.w0, PE_ROWS, WIDTH)
                                  : fwd_src(wh_ptr(P, o, l), WIDTH, WIDTH);
      const tc::WSrc next =
          l + 1 < DEPTH ? fwd_src(wh_ptr(P, o, l + 1), WIDTH, WIDTH) : wf;
      if (l == SKIP) {
        tc::product<MODE, 256, 4>(acc, cur, H, pipe, &w5pe);
        tc::product<MODE, 256, 4>(acc, w5pe, PE, pipe, &next);
      } else {
        tc::product<MODE, 256, 4>(acc, cur, l == 0 ? PE : H, pipe, &next);
      }
      tc::bias_act<256>(acc, P + o.b + l * WIDTH, true);
      if (keep) {
        tc::store_tile_global<256>(keep->X + (int64_t)(keep->x_h + l * WIDTH) * keep->ldx,
                                   keep->ldx, keep->col0, acc);
        tc::save_signs(keep->masks + l * 2 * tc::THREADS, acc);
      }
      tc::store_tile<256>(H, acc);  // every thread has read h_{l-1}
    }
    __syncthreads();
    alpha(H);  // reads h7; feature's trailing barrier orders it before f
    // f = wf^T h7 + bf
    tc::zero(acc);
    tc::product<MODE, 256, 4>(acc, wf, H, pipe, &wfv);
    tc::bias_act<256>(acc, P + o.bf, false);
    if (keep)
      tc::store_tile_global<256>(keep->X + (int64_t)keep->x_f * keep->ldx,
                                 keep->ldx, keep->col0, acc);
    tc::store_tile<256>(H, acc);
  }
  // hv = relu(wfv^T f + the view input)
  float acc[2][T128::NT][4];
  tc::zero(acc);
  if constexpr (View::kEncoded) {
    tc::product<MODE, 128, 2>(acc, wfv, H, pipe, &wvpe);
    tc::product<MODE, 128, 2>(acc, wvpe, view.VPE, pipe, after);
    tc::bias_act<128>(acc, P + o.bv, true);
  } else {
    tc::product<MODE, 128, 2>(acc, wfv, H, pipe, after);
    ray_bias_relu(acc, view);
  }
  if (keep) {
    tc::store_tile_global<128>(keep->X + (int64_t)keep->x_hv * keep->ldx,
                               keep->ldx, keep->col0, acc);
    tc::save_signs(keep->masks + DEPTH * 2 * tc::THREADS, acc);
  }
  tc::store_tile<128>(H, acc);
}

}  // namespace fmlp
