// K4: staged NeRF MLP backward (rematerialized K3 + VJP to every weight,
// to the points and to the per-point view bias).
//
// Replaces: benerf_tpu/ops/pallas_mlp.py `_bwd_kernel` (through `_bwd_call`
// and the `_core` custom_vjp).
//
// Bound on an H100: operations. Per point it redoes K3's forward (1,179,904
// FLOP), forms the data gradients (1x) and the weight gradients (1x); the
// bytes it must move (pts, cotangent, d pts, the per-ray bias and its
// gradient, and the weights and their gradients) are two orders of
// magnitude below what HBM could move in that time.
//
// Design: K2's two deterministic passes (fused_mlp_bwd.cu), reshaped for
// what K3 takes.
//  (a) `staged_tile_kernel`: one block per 64-point tile rematerializes K3
//      in shared memory (activation buffer, encoding, and the cotangent's
//      C+1 rows, any C < 128: 88,128 B at C = 3, two blocks per SM), runs
//      the chain rule back through heads, trunk and the sin/cos encoding
//      (L = 10, no BARF) to d pts, and stores every activation (X) and
//      pre-activation gradient (D) of the tile to a feature-major scratch.
//      The TPU kernel writes a per-point d vb (n, 128) that the autodiff of
//      its broadcast sums per ray; here d vb per point is D's rows D_HV
//      (the views layer's pre-activation gradient, needed for wfv's
//      gradient anyway), and the wrapper sums them over each ray's S
//      samples, which may straddle tiles.
//  (b) `weight_gradients` (fused_mlp_bwd_common.cuh): every weight gradient
//      as a split-K product over fixed point chunks (K2's tensor-core pass
//      in TF32X3 mode, writing K4's interleaved columns) and an in-order
//      sum of the partials. The TPU kernel adds each grid step's tile into one
//      VMEM output in grid order; Hopper blocks run concurrently, so no
//      block adds into another's result and no atomics are used: split
//      count changes the result only by the rounding of a reordered sum.
// Padded points carry a zero cotangent, so they add nothing to any sum and
// the last partial tile's gradients are kept. The tile pass is fp32 on
// CUDA cores.

#include "fused_mlp_bwd_common.cuh"

namespace fmlp {

// rows of the activation scratch X
constexpr int SX_PE = 0;
constexpr int SX_H = SX_PE + PE_PAD;          // h0..h7
constexpr int SX_F = SX_H + DEPTH * WIDTH;
constexpr int SX_HV = SX_F + WIDTH;
constexpr int SX_ROWS = SX_HV + HEAD;         // 2496
// rows of the gradient scratch D: then C + 1 cotangent rows (rgb..., alpha)
constexpr int SD_PRE = 0;                     // d pre-activation, layers 0..7
constexpr int SD_F = SD_PRE + DEPTH * WIDTH;
constexpr int SD_HV = SD_F + WIDTH;           // d vb per point
constexpr int SD_G = SD_HV + HEAD;

inline size_t staged_tile_smem(int C) {
  return (size_t)(WIDTH + PE_PAD + C + 1) * LDA * sizeof(float);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
staged_tile_kernel(const float* __restrict__ pts, const float* __restrict__ vb,
                   int64_t n, int S, const float* __restrict__ P,
                   const float* __restrict__ PTr, const float* __restrict__ g,
                   int C, int64_t n_pad, float* __restrict__ X,
                   float* __restrict__ D, float* __restrict__ dpts) {
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* PE = H + WIDTH * LDA;
  float* G = PE + PE_PAD * LDA;
  const Offsets o = offsets(C, false);
  const TOffsets to = toffsets(C, false);
  const int og = threadIdx.x % 32, pg = threadIdx.x / 32;
  const int64_t p0 = (int64_t)blockIdx.x * TP;

  // inputs: the encoding and the cotangent tile (zero past n)
  encode_tile(pts, nullptr, n, S, nullptr, p0, PE, nullptr);
  for (int e = threadIdx.x; e < (C + 1) * TP; e += THREADS) {
    const int r = e / TP, c = e % TP;
    const int64_t p = p0 + c;
    G[r * LDA + c] = p < n ? __ldg(g + p * (C + 1) + r) : 0.f;
  }
  __syncthreads();
  copy_rows(PE, PE_PAD, X + (int64_t)SX_PE * n_pad, n_pad, p0);
  copy_rows(G, C + 1, D + (int64_t)SD_G * n_pad, n_pad, p0);

  // forward, keeping every activation in X
  trunk_forward(P, o, PE, H, X, n_pad, SX_H, p0);            // h7 in H
  feature_layer(P, o, H, X, n_pad, SX_F, p0);                // f in H
  __syncthreads();
  views_layer_vb(P, o, H, vb, n, S, p0, X, n_pad, SX_HV);    // hv in H rows 0..127
  __syncthreads();

  // Backward, one buffer as in the forward: each step reads H into
  // registers, waits for every thread, then overwrites H. PE takes d pe;
  // only the owning thread reads or writes those elements.
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
    store_global<4>(D + (int64_t)SD_HV * n_pad, n_pad, p0, acc, og, pg);
  }
  __syncthreads();
  // feature: df = wfv dhv -> H
  {
    float acc[8][PT];
    zero_acc(acc);
    mm_acc<8>(acc, PTr + to.wfvT, WIDTH, HEAD, H, og, pg);
    __syncthreads();
    store_smem<8>(H, acc, og, pg);
    store_global<8>(D + (int64_t)SD_F * n_pad, n_pad, p0, acc, og, pg);
  }
  __syncthreads();
  // h7: dh = wf df + wa g_alpha, masked by h7 > 0 -> H
  {
    float acc[8][PT];
    zero_acc(acc);
    mm_acc<8>(acc, PTr + to.wfT, WIDTH, WIDTH, H, og, pg);
    mm_acc<8>(acc, PTr + to.waT, WIDTH, 1, G + C * LDA, og, pg);
    relu_mask_global<8>(acc, X, n_pad, SX_H + (DEPTH - 1) * WIDTH, p0, og, pg);
    __syncthreads();
    store_smem<8>(H, acc, og, pg);
    store_global<8>(D + (int64_t)(SD_PRE + (DEPTH - 1) * WIDTH) * n_pad, n_pad,
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
    relu_mask_global<8>(acc, X, n_pad, SX_H + (l - 1) * WIDTH, p0, og, pg);
    __syncthreads();
    store_smem<8>(H, acc, og, pg);
    store_global<8>(D + (int64_t)(SD_PRE + (l - 1) * WIDTH) * n_pad, n_pad, p0,
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
  // through sin/cos back to the points
  if (threadIdx.x < TP) {
    const int64_t p = p0 + threadIdx.x;
    if (p < n) {
      float dx[3];
      encode_bwd(PE, threadIdx.x, L_PTS, nullptr, pts + p * 3, dx);
      dpts[p * 3] = dx[0];
      dpts[p * 3 + 1] = dx[1];
      dpts[p * 3 + 2] = dx[2];
    }
  }
}

// The jobs that together cover K3/K4's packed gradient vector: the 11
// matrix products, then the biases (b, bf are contiguous in both the packed
// vector and D), the alpha head, its bias, the rgb head and its bias.
inline void make_staged_jobs(int C, GemmJobs* g, ThinJobs* t) {
  const Offsets o = offsets(C, false);
  const int64_t WW = (int64_t)WIDTH * WIDTH;
  *g = GemmJobs{11, {
      {SX_PE, PE_ROWS, SD_PRE, WIDTH, 0, 0, o.w0, 1},
      {SX_H + 0 * WIDTH, WIDTH, SD_PRE + 1 * WIDTH, WIDTH, 0, 0, o.wh + 0 * WW, 1},
      {SX_H + 1 * WIDTH, WIDTH, SD_PRE + 2 * WIDTH, WIDTH, 0, 0, o.wh + 1 * WW, 1},
      {SX_H + 2 * WIDTH, WIDTH, SD_PRE + 3 * WIDTH, WIDTH, 0, 0, o.wh + 2 * WW, 1},
      {SX_H + 3 * WIDTH, WIDTH, SD_PRE + 4 * WIDTH, WIDTH, 0, 0, o.wh + 3 * WW, 1},
      {SX_H + 4 * WIDTH, WIDTH, SD_PRE + 5 * WIDTH, WIDTH, 0, 0, o.wh + 4 * WW, 1},
      {SX_H + 5 * WIDTH, WIDTH, SD_PRE + 6 * WIDTH, WIDTH, 0, 0, o.wh + 5 * WW, 1},
      {SX_H + 6 * WIDTH, WIDTH, SD_PRE + 7 * WIDTH, WIDTH, 0, 0, o.wh + 6 * WW, 1},
      {SX_PE, PE_ROWS, SD_PRE + SKIP * WIDTH, WIDTH, 0, 0, o.w5pe, 1},
      {SX_H + (DEPTH - 1) * WIDTH, WIDTH, SD_F, WIDTH, 0, 0, o.wf, 1},
      {SX_F, WIDTH, SD_HV, HEAD, 0, 0, o.wfv, 1},
  }};
  *t = ThinJobs{5, 0, {
      {-1, 1, SD_PRE, DEPTH * WIDTH + WIDTH, 0, o.b},  // b, bf
      {SX_H + (DEPTH - 1) * WIDTH, WIDTH, SD_G + C, 1, 0, o.wa},
      {-1, 1, SD_G + C, 1, 0, o.ba},
      {SX_HV, HEAD, SD_G, C, 0, o.wrgb},
      {-1, 1, SD_G, C, 0, o.brgb},
  }};
  number_jobs(g, t);
}

}  // namespace fmlp

extern "C" {

// for n_pad points and C channels: scratch sizes in floats of X and D
// (feature-major, row stride n_pad), and the first row of D holding d vb
// per point (128 rows)
void staged_mlp_bwd_scratch(int64_t n_pad, int C, int64_t* out) {
  out[0] = (int64_t)fmlp::SX_ROWS * n_pad;
  out[1] = (int64_t)(fmlp::SD_G + C + 1) * n_pad;
  out[2] = fmlp::SD_HV;
}

// 9 offsets of K4's transposed weight vector, in the order of
// fmlp::TOffsets (wvpeT empty)
void staged_mlp_tlayout(int C, int64_t* out) {
  const fmlp::TOffsets o = fmlp::toffsets(C, false);
  const int64_t v[9] = {o.whT, o.w0T, o.w5peT, o.wfT, o.wfvT,
                        o.wvpeT, o.waT, o.wrgbT, o.total};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// g (n, C+1) cotangent -> dP (packed layout), dpts (n, 3); d vb per point
// is left in D's rows staged_mlp_bwd_scratch()[2] ..+128. n_pad = n rounded
// up to 64; X, D scratch as sized above; part holds splits * (packed size)
// partial sums.
int staged_mlp_bwd(const float* pts, const float* vb, int64_t n, int S,
                   const float* P, const float* PTr, const float* g, int C,
                   int64_t n_pad, float* X, float* D, float* dpts, float* part,
                   int splits, float* dP, cudaStream_t stream) {
  const size_t smem = fmlp::staged_tile_smem(C);
  cudaFuncSetAttribute(fmlp::staged_tile_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  fmlp::staged_tile_kernel<<<(unsigned)(n_pad / fmlp::TP), fmlp::THREADS, smem,
                             stream>>>(pts, vb, n, S, P, PTr, g, C, n_pad, X, D,
                                       dpts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  fmlp::GemmJobs gj;
  fmlp::ThinJobs tj;
  fmlp::make_staged_jobs(C, &gj, &tj);
  return fmlp::weight_gradients(X, D, n_pad, splits,
                                fmlp::offsets(C, false).total, gj, tj, part,
                                dP, tc::TF32X3, stream);
}

}  // extern "C"
