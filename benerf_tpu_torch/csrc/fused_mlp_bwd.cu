// K2: fused NeRF MLP backward (VJP to every weight, to the points and to
// the per-point view directions, from the forward that K1 kept).
//
// Replaces: benerf_tpu/ops/pallas_mlp_t.py `_bwd_kernel_t` (through
// `_bwd_call`, `_encode_bwd_T` and the `_core` custom_vjp).
//
// Bound on an H100: operations in TF32X3. Per point it forms the data
// gradients (1x the forward's 1,186,816 FLOP) and the weight gradients
// (1x): 2 x 1,186,816 FLOP at 495 / 3 TFLOP/s. The TPU kernel runs the
// forward again first (3x); here K1 keeps what that forward would give
// when autograd will need the backward (fused_mlp_fwd.cu). K2 must also
// move its scratch (below), which bounds it in BF16 mode, where the
// products run at 989 TFLOP/s: fp32 in TF32X3, 19,872 B a point and the
// 272 B of sign words; in BF16 stored as its readers consume it
// (fused_mlp_bwd_common.cuh): the products' operands as bf16, fp32 rows
// for the thin jobs, a tile sum of each D row for the biases, 11,384 B a
// point at C = 3 (4.45 GB at the fine call's 391,040 points, 1.33 ms each
// way at 3.35 TB/s).
//
// Design: on the TPU the grid runs in order and every grid step adds its
// tile's weight gradients into one VMEM-resident output. Hopper blocks run
// concurrently, so the work is split in two passes, both deterministic:
//  (a) `tile_kernel`: one block per 64-point tile (one block of two
//      consumer warpgroups and a producer warp per SM) brings in the
//      tile's ReLU sign words that K1 kept (one bulk copy), runs the chain
//      rule back through heads, trunk and the sin/cos encodings on wgmma
//      (wgmma_layer.cuh: the data-gradient products B[i][o] = W[i][o], the
//      W copies of the buffer K1's launch prepared, by TMA, a producer
//      thread and two consumer warpgroups), writes dpts and per-point dvd,
//      and stores every pre-activation gradient (D) of the tile to a
//      feature-major scratch in HBM ([feature][point], n padded to 64)
//      straight from the accumulators (BF16: as bf16, with the cotangent's
//      fp32 rows and the tile sums beside them). The activations (X) are
//      K1's kept rows;
//  (b) each weight gradient dW = X_rows D_rows^T (a sum over all points)
//      as a split-K product, the point axis cut into `splits` fixed chunks,
//      one partial per chunk: `wgrad_wgmma_kernel` takes the 12 matrix
//      products and the biases of their D rows in one launch (persistent
//      blocks, TMA stages and wgmma on 128x128 output tiles,
//      wgrad_wgmma.cuh; BF16: the biases from the tile sums),
//      `wgrad_thin_kernel` the 1- and C-column heads and their biases (a
//      warp per element); then `reduce_kernel` sums the partials in chunk
//      order.
//      No atomics: the result is the same from run to run, and tile size
//      and split count change it only by the rounding of a reordered sum.
// Padded points carry a zero cotangent, so they add nothing to any sum and
// the last partial tile's gradients are kept (not dropped). The heads' data
// gradients are fp32 on CUDA cores. Both passes live in
// fused_mlp_bwd_common.cuh, shared with K4 (staged_mlp_bwd.cu), whose tile
// pass still runs its forward again.

#include "fused_mlp_bwd_common.cuh"

namespace fmlp {

using K2Rows = Scratch<true>;
constexpr int D_ROWS = K2Rows::D_G + G_PAD;    // 2440
constexpr int GSIDE_ROWS = Side<true>::G + G_PAD;  // BF16: the cotangent's 8

template <tc::Mode MODE>
__global__ void __launch_bounds__(wl::THREADS, 1)
tile_kernel(const __grid_constant__ CUtensorMap wmap, const wl::Sched sched,
            const float* __restrict__ pts, const float* __restrict__ vd,
            int64_t n, int S, const float* __restrict__ P,
            const float* __restrict__ band, const float* __restrict__ g,
            int C, int64_t n_pad, float* __restrict__ D,
            float* __restrict__ dpts, float* __restrict__ dvd,
            float* __restrict__ gside, float* __restrict__ bsum,
            const uint32_t* __restrict__ signs) {
  extern __shared__ uint8_t tsmem[];
  tile_pass<MODE, true>(&wmap, sched, pts, vd, n, S, P, band, g, C, n_pad,
                        nullptr, D, dpts, dvd, gside, bsum, signs, tsmem);
}

template <tc::Mode MODE>
int launch_tile(const float* pts, const float* vd, int64_t n, int S,
                const float* P, const void* prep, const float* band,
                const float* g, int C, int64_t n_pad, const uint32_t* signs,
                float* D, float* gside, float* bsum, float* dpts, float* dvd,
                cudaStream_t stream) {
  const Offsets o = offsets(C);
  CUtensorMap map;
  int err = wl::encode_prep_map(&map, prep, wl::prep_table<MODE>(o, true).rows);
  if (err) return err;
  const int smem = (int)tile_smem_bytes<MODE, true>();
  cudaFuncSetAttribute(tile_kernel<MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  tile_kernel<MODE><<<(unsigned)(n_pad / TP), wl::THREADS, smem, stream>>>(
      map, wl::make_sched<MODE>(o, true, false, true), pts, vd, n, S, P, band, g,
      C, n_pad, D, dpts, dvd, gside, bsum, signs);
  return (int)cudaGetLastError();
}

}  // namespace fmlp

extern "C" {

// the backward's own part of the scratch of n_pad points in `mode`
// (fused_mlp_bwd_common.cuh), in elements: D (feature-major; fp32 in
// TF32X3, tile-blocked bf16 in BF16), and in BF16 the cotangent's fp32 rows
// (gside) and the tile sums of D (bsum; 0 in TF32X3). X, BF16's h7 and hv
// rows and the sign words are K1's (fused_mlp_kept).
void fused_mlp_bwd_scratch(int64_t n_pad, int mode, int64_t* out) {
  const bool b = mode == tc::BF16;
  out[0] = (int64_t)(b ? fmlp::K2Rows::D_G : fmlp::D_ROWS) * n_pad;
  out[1] = b ? (int64_t)fmlp::GSIDE_ROWS * n_pad : 0;
  out[2] = b ? n_pad / fmlp::TP * fmlp::BIAS_ROWS : 0;
}

// pass (b)'s job table in `mode` (fmlp::job_rows), 16 rows of 6, into out
// with room for cap rows (nothing written when the table is longer)
int fused_mlp_wgrad_jobs(int C, int mode, int64_t* out, int cap) {
  return fmlp::job_rows<true>(C, mode, out, cap);
}

// Pass (b) alone, on X, side (K1's) and D, bsum, gside (pass (a)'s): for
// timing it apart.
int fused_mlp_wgrad(const void* X, const void* D, const float* side,
                    const float* bsum, const float* gside, int64_t n_pad, int C,
                    float* part, int splits, float* dP, int mode,
                    cudaStream_t stream) {
  fmlp::GemmJobs gj;
  fmlp::ThinJobs tj;
  fmlp::make_jobs<true>(C, &gj, &tj, mode);
  return fmlp::weight_gradients(X, D, side, gside, bsum, n_pad, fmlp::K2Rows::X_HV,
                                fmlp::K2Rows::D_G, splits, fmlp::offsets(C).total,
                                gj, tj, part, dP, mode, stream);
}

// Pass (a) alone: the tile pass on the sign words K1 kept, filling D (BF16
// also gside and bsum), dpts and dvd (for timing it apart; fused_mlp_bwd
// runs it then pass (b)). X and side, K1's kept rows, are pass (b)'s.
int fused_mlp_tile(const float* pts, const float* vd, int64_t n, int S,
                   const float* P, const void* prep, const float* band,
                   const float* g, int C, int64_t n_pad, const void* X, void* D,
                   const float* side, float* bsum, const uint32_t* signs,
                   float* gside, float* dpts, float* dvd, int mode,
                   cudaStream_t stream) {
  float* d = static_cast<float*>(D);
  return mode == tc::TF32X3
             ? fmlp::launch_tile<tc::TF32X3>(pts, vd, n, S, P, prep, band, g,
                                             C, n_pad, signs, d, nullptr,
                                             nullptr, dpts, dvd, stream)
             : fmlp::launch_tile<tc::BF16>(pts, vd, n, S, P, prep, band, g, C,
                                           n_pad, signs, d, gside, bsum, dpts,
                                           dvd, stream);
}

// g (n, C+1) cotangent -> dP (packed layout), dpts (n, 3), dvd (n, 3) per
// point, from the weights' wgmma copies prep that K1's launch wrote in the
// same mode and the forward it kept (X, side, signs; fused_mlp_kept).
// n_pad = n rounded up to 64; D, bsum, gside: the backward's scratch in
// `mode` as sized above; part holds splits * (packed size) partial sums;
// mode: 0 TF32X3, 1 BF16.
int fused_mlp_bwd(const float* pts, const float* vd, int64_t n, int S,
                  const float* P, const void* prep, const float* band,
                  const float* g, int C, int64_t n_pad, const void* X, void* D,
                  const float* side, float* bsum, const uint32_t* signs,
                  float* gside, float* dpts, float* dvd, float* part, int splits,
                  float* dP, int mode, cudaStream_t stream) {
  const int err = fused_mlp_tile(pts, vd, n, S, P, prep, band, g, C, n_pad, X, D,
                                 side, bsum, signs, gside, dpts, dvd, mode, stream);
  if (err) return err;
  return fused_mlp_wgrad(X, D, side, bsum, gside, n_pad, C, part, splits, dP,
                         mode, stream);
}

}  // extern "C"
