// K2: fused NeRF MLP backward (rematerialized forward + VJP to every
// weight, to the points and to the per-point view directions).
//
// Replaces: benerf_tpu/ops/pallas_mlp_t.py `_bwd_kernel_t` (through
// `_bwd_call`, `_encode_bwd_T` and the `_core` custom_vjp).
//
// Bound on an H100: operations in TF32X3. Per point it redoes the forward
// (1x the forward's 1,186,816 FLOP), forms the data gradients (1x) and the
// weight gradients (1x): 3 x 1,186,816 FLOP at 495 / 3 TFLOP/s. It must
// also move its fp32 scratch (below), 19,872 B a point each way, which
// bounds it in BF16 mode, where the products run at 989 TFLOP/s.
//
// Design: on the TPU the grid runs in order and every grid step adds its
// tile's weight gradients into one VMEM-resident output. Hopper blocks run
// concurrently, so the work is split in two passes, both deterministic:
//  (a) `tile_kernel`: one block per 64-point tile (one block of 8 warps per
//      SM) rematerializes K1 on the tensor cores (fused_mlp_tc.cuh), keeps
//      the ReLU signs of every layer as bits in shared memory, runs the
//      chain rule back through heads, trunk and the sin/cos encodings with
//      the data-gradient products A[i][o] = W[i][o] read from the same
//      packed weights (mma_layer.cuh, no transposed copy), writes dpts and
//      per-point dvd, and stores every activation (X) and every
//      pre-activation gradient (D) of the tile to a feature-major fp32
//      scratch in HBM ([feature][point], n padded to 64);
//  (b) each weight gradient dW = X_rows D_rows^T (a sum over all points)
//      as a split-K product, the point axis cut into `splits` fixed chunks,
//      one partial per chunk: `wgrad_gemm_kernel` takes the 12 matrix
//      products in one launch (128x128 output tiles on the tensor cores),
//      `wgrad_thin_kernel` the biases and the 1- and C-column heads (a warp
//      per element); then `reduce_kernel` sums the partials in chunk order.
//      No atomics: the result is the same from run to run, and tile size
//      and split count change it only by the rounding of a reordered sum.
// Padded points carry a zero cotangent, so they add nothing to any sum and
// the last partial tile's gradients are kept (not dropped). The heads' data
// gradients are fp32 on CUDA cores. Pass (b) and the tile pass's helpers
// live in fused_mlp_bwd_common.cuh, shared with K4 (staged_mlp_bwd.cu).

#include "fused_mlp_bwd_common.cuh"
#include "fused_mlp_tc.cuh"

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

constexpr int MASK_WORDS = DEPTH * 2 + 1;     // ReLU sign words a thread
constexpr size_t TILE_SMEM_BYTES =
    (TC_FWD_ROWS + G_PAD) * tc::LDA * sizeof(float) + tc::STAGES_BYTES +
    MASK_WORDS * tc::THREADS * sizeof(uint32_t);  // 231,680

// epilogue of a data-gradient product for d h_l: mask by h_l > 0, store
// d pre_l to D (row d_row) and to H
template <int M, int MT, int NT>
__device__ __forceinline__ void dgrad_out(float (&acc)[MT][NT][4],
                                          const uint32_t* masks, float* D,
                                          int d_row, int64_t n_pad, int64_t p0,
                                          float* H) {
  tc::apply_signs(acc, masks);
  tc::store_tile_global<M>(D + (int64_t)d_row * n_pad, n_pad, p0, acc);
  tc::store_tile<M>(H, acc);
}

template <tc::Mode MODE>
__global__ void __launch_bounds__(tc::THREADS, 1)
tile_kernel(const float* __restrict__ pts, const float* __restrict__ vd,
            int64_t n, int S, const float* __restrict__ P,
            const float* __restrict__ band, const float* __restrict__ g,
            int C, int64_t n_pad, float* __restrict__ X,
            float* __restrict__ D, float* __restrict__ dpts,
            float* __restrict__ dvd) {
  using T256 = tc::Tiling<256, 4>;
  using T128 = tc::Tiling<128, 2>;
  using T64 = tc::Tiling<64, 1>;
  using T32 = tc::Tiling<32, 1>;
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* PE = H + WIDTH * tc::LDA;
  float* VPE = PE + PE_PAD * tc::LDA;
  float* G = VPE + VPE_PAD * tc::LDA;
  tc::Pipe pipe{G + G_PAD * tc::LDA, 0};
  uint32_t* masks =
      reinterpret_cast<uint32_t*>(pipe.buf + tc::NSTAGES * tc::STAGE_FLOATS);
  const Offsets o = offsets(C);
  const int64_t p0 = (int64_t)blockIdx.x * TP;

  pipe.start(fwd_src(P + o.w0, PE_ROWS, WIDTH));
  // inputs: encodings and the cotangent tile (zero past n)
  encode_tile<tc::LDA>(pts, vd, n, S, band, p0, PE, VPE);
  for (int e = threadIdx.x; e < G_PAD * TP; e += tc::THREADS) {
    const int r = e / TP, c = e % TP;
    const int64_t p = p0 + c;
    G[r * tc::LDA + c] = (r <= C && p < n) ? __ldg(g + p * (C + 1) + r) : 0.f;
  }
  __syncthreads();
  copy_rows<tc::LDA>(PE, PE_PAD, X + (int64_t)X_PE * n_pad, n_pad, p0);
  copy_rows<tc::LDA>(VPE, VPE_PAD, X + (int64_t)X_VPE * n_pad, n_pad, p0);
  copy_rows<tc::LDA>(G, G_PAD, D + (int64_t)D_G * n_pad, n_pad, p0);

  // forward, keeping every activation in X and every ReLU sign in masks
  const tc::WSrc wvpeT = bwd_src(P + o.wvpe, VPE_ROWS, HEAD);
  const Keep keep{X, n_pad, p0, X_H, X_F, X_HV, masks};
  forward_tc<MODE>(P, o, PE, VPE, H, pipe, &keep, [](const float*) {}, &wvpeT);

  // rgb head on CUDA cores, at the views layer's fragment positions:
  // dhv = wrgb g_rgb, masked by hv > 0 -> D_HV and H rows 0..127 (each
  // thread overwrites only the hv elements it wrote itself)
  {
    float acc[2][T128::NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < T128::NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = T128::row(mt, r), c = T128::col(nt, r);
          float s = 0.f;
          for (int k = 0; k < C; ++k)
            s = fmaf(__ldg(P + o.wrgb + i * C + k), G[k * tc::LDA + c], s);
          acc[mt][nt][r] = s;
        }
    dgrad_out<128>(acc, masks + DEPTH * 2 * tc::THREADS, D, D_HV, n_pad, p0, H);
  }
  // view encoding: dvpe = wvpe dhv -> VPE (rows 27..31 stay 0)
  const tc::WSrc wfvT = bwd_src(P + o.wfv, WIDTH, HEAD);
  {
    float acc[1][T32::NT][4];
    tc::zero(acc);
    tc::product<MODE, 32, 1>(acc, wvpeT, H, pipe, &wfvT);
    tc::store_tile<32>(VPE, acc);
  }
  float acc[4][T256::NT][4];
  // feature: df = wfv dhv -> D_F, H
  const tc::WSrc wfT = bwd_src(P + o.wf, WIDTH, WIDTH);
  tc::zero(acc);
  tc::product<MODE, 256, 4>(acc, wfvT, H, pipe, &wfT);
  tc::store_tile_global<256>(D + (int64_t)D_F * n_pad, n_pad, p0, acc);
  tc::store_tile<256>(H, acc);
  // h7: dh = wf df + wa g_alpha, masked by h7 > 0 -> D_PRE + 7, H
  const tc::WSrc wh7T = bwd_src(wh_ptr(P, o, DEPTH - 1), WIDTH, WIDTH);
  tc::zero(acc);
  tc::product<MODE, 256, 4>(acc, wfT, H, pipe, &wh7T);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < T256::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[mt][nt][r] = fmaf(__ldg(P + o.wa + T256::row(mt, r)),
                              G[C * tc::LDA + T256::col(nt, r)], acc[mt][nt][r]);
  dgrad_out<256>(acc, masks + (DEPTH - 1) * 2 * tc::THREADS, D,
                 D_PRE + (DEPTH - 1) * WIDTH, n_pad, p0, H);
  // trunk: dpre_{l-1} = (wh_l dpre_l) * (h_{l-1} > 0); dpe from layer SKIP
  // (kept in PE, whose encoding X already holds) and layer 0
  const tc::WSrc w5peT = bwd_src(P + o.w5pe, PE_ROWS, WIDTH);
  const tc::WSrc w0T = bwd_src(P + o.w0, PE_ROWS, WIDTH);
  float dpe[1][T64::NT][4];
  for (int l = DEPTH - 1; l >= 1; --l) {
    const tc::WSrc whT = bwd_src(wh_ptr(P, o, l), WIDTH, WIDTH);
    const tc::WSrc after = l - 1 == SKIP ? w5peT
                         : l - 1 >= 1    ? bwd_src(wh_ptr(P, o, l - 1), WIDTH, WIDTH)
                                         : w0T;
    if (l == SKIP) {
      tc::zero(dpe);
      tc::product<MODE, 64, 1>(dpe, w5peT, H, pipe, &whT);
      tc::store_tile<64>(PE, dpe);
    }
    tc::zero(acc);
    tc::product<MODE, 256, 4>(acc, whT, H, pipe, &after);
    dgrad_out<256>(acc, masks + (l - 1) * 2 * tc::THREADS, D,
                   D_PRE + (l - 1) * WIDTH, n_pad, p0, H);
  }
  // layer 0: dpe += w0 dpre0 -> PE (each thread adds to its own elements)
  tc::zero(dpe);
  tc::product<MODE, 64, 1>(dpe, w0T, H, pipe, nullptr);
  tc::add_tile<64>(PE, dpe);
  __syncthreads();
  // through sin/cos back to the inputs
  if (threadIdx.x < 2 * TP) {
    const bool views = threadIdx.x >= TP;
    const int c = threadIdx.x % TP;
    const int64_t p = p0 + c;
    if (p < n) {
      float dx[3];
      if (views)
        encode_bwd<tc::LDA>(VPE, c, L_VIEWS, band + L_PTS, vd + (p / S) * 3, dx);
      else
        encode_bwd<tc::LDA>(PE, c, L_PTS, band, pts + p * 3, dx);
      float* dst = (views ? dvd : dpts) + p * 3;
      dst[0] = dx[0];
      dst[1] = dx[1];
      dst[2] = dx[2];
    }
  }
}

// The jobs that together cover the packed gradient vector (natural column
// order): the 12 matrix products, then the biases (b, bf, bv are contiguous
// in both the packed vector and D), the alpha head, its bias, the rgb head
// and its bias.
inline void make_jobs(int C, GemmJobs* g, ThinJobs* t) {
  const Offsets o = offsets(C);
  const int64_t WW = (int64_t)WIDTH * WIDTH;
  *g = GemmJobs{12, {
      {X_PE, PE_ROWS, D_PRE, WIDTH, 0, 0, o.w0, 0},
      {X_H + 0 * WIDTH, WIDTH, D_PRE + 1 * WIDTH, WIDTH, 0, 0, o.wh + 0 * WW, 0},
      {X_H + 1 * WIDTH, WIDTH, D_PRE + 2 * WIDTH, WIDTH, 0, 0, o.wh + 1 * WW, 0},
      {X_H + 2 * WIDTH, WIDTH, D_PRE + 3 * WIDTH, WIDTH, 0, 0, o.wh + 2 * WW, 0},
      {X_H + 3 * WIDTH, WIDTH, D_PRE + 4 * WIDTH, WIDTH, 0, 0, o.wh + 3 * WW, 0},
      {X_H + 4 * WIDTH, WIDTH, D_PRE + 5 * WIDTH, WIDTH, 0, 0, o.wh + 4 * WW, 0},
      {X_H + 5 * WIDTH, WIDTH, D_PRE + 6 * WIDTH, WIDTH, 0, 0, o.wh + 5 * WW, 0},
      {X_H + 6 * WIDTH, WIDTH, D_PRE + 7 * WIDTH, WIDTH, 0, 0, o.wh + 6 * WW, 0},
      {X_PE, PE_ROWS, D_PRE + SKIP * WIDTH, WIDTH, 0, 0, o.w5pe, 0},
      {X_H + (DEPTH - 1) * WIDTH, WIDTH, D_F, WIDTH, 0, 0, o.wf, 0},
      {X_F, WIDTH, D_HV, HEAD, 0, 0, o.wfv, 0},
      {X_VPE, VPE_ROWS, D_HV, HEAD, 0, 0, o.wvpe, 0},
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

// Pass (b) alone, on a scratch that pass (a) filled: for timing it apart.
int fused_mlp_wgrad(const float* X, const float* D, int64_t n_pad, int C,
                    float* part, int splits, float* dP, int mode,
                    cudaStream_t stream) {
  fmlp::GemmJobs gj;
  fmlp::ThinJobs tj;
  fmlp::make_jobs(C, &gj, &tj);
  return fmlp::weight_gradients(X, D, n_pad, splits, fmlp::offsets(C).total,
                                gj, tj, part, dP, mode, stream);
}

// g (n, C+1) cotangent -> dP (packed layout), dpts (n, 3), dvd (n, 3) per
// point. n_pad = n rounded up to 64; X, D scratch as sized above; part
// holds splits * (packed size) partial sums; mode: 0 TF32X3, 1 BF16.
int fused_mlp_bwd(const float* pts, const float* vd, int64_t n, int S,
                  const float* P, const float* band, const float* g, int C,
                  int64_t n_pad, float* X, float* D, float* dpts, float* dvd,
                  float* part, int splits, float* dP, int mode,
                  cudaStream_t stream) {
  const int smem = (int)fmlp::TILE_SMEM_BYTES;
  const unsigned blocks = (unsigned)(n_pad / fmlp::TP);
  if (mode == tc::TF32X3) {
    cudaFuncSetAttribute(fmlp::tile_kernel<tc::TF32X3>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fmlp::tile_kernel<tc::TF32X3><<<blocks, tc::THREADS, smem, stream>>>(
        pts, vd, n, S, P, band, g, C, n_pad, X, D, dpts, dvd);
  } else {
    cudaFuncSetAttribute(fmlp::tile_kernel<tc::BF16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fmlp::tile_kernel<tc::BF16><<<blocks, tc::THREADS, smem, stream>>>(
        pts, vd, n, S, P, band, g, C, n_pad, X, D, dpts, dvd);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return fused_mlp_wgrad(X, D, n_pad, C, part, splits, dP, mode, stream);
}

}  // extern "C"
