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
// Pass (b) and the tile pass's helpers live in fused_mlp_bwd_common.cuh,
// shared with K4 (staged_mlp_bwd.cu).

#include "fused_mlp_bwd_common.cuh"

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

// The jobs that together cover the packed gradient vector: the 12 matrix
// products, then the biases (b, bf, bv are contiguous in both the packed
// vector and D), the alpha head, its bias, the rgb head and its bias.
inline void make_jobs(int C, GemmJobs* g, ThinJobs* t) {
  const Offsets o = offsets(C);
  const int64_t WW = (int64_t)WIDTH * WIDTH;
  *g = GemmJobs{12, {
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
  }};
  *t = ThinJobs{5, 0, {
      {-1, 1, D_PRE, DEPTH * WIDTH + WIDTH + HEAD, 0, o.b},  // b, bf, bv
      {X_H + (DEPTH - 1) * WIDTH, WIDTH, D_G + C, 1, 0, o.wa},
      {-1, 1, D_G + C, 1, 0, o.ba},
      {X_HV, HEAD, D_G, C, 0, o.wrgb},
      {-1, 1, D_G, C, 0, o.brgb},
  }};
  number_jobs(g, t);
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

  fmlp::GemmJobs gj;
  fmlp::ThinJobs tj;
  fmlp::make_jobs(C, &gj, &tj);
  return fmlp::weight_gradients(X, D, n_pad, splits, fmlp::offsets(C).total,
                                gj, tj, part, dP, stream);
}

}  // extern "C"
