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
//  (a) `tile_kernel`: one block per 64-point tile (one block of two
//      consumer warpgroups and a producer warp per SM) rematerializes K1 on wgmma (fused_mlp_wg.cuh,
//      wgmma_layer.cuh: weights by TMA from the buffer K1's launch
//      prepared, a producer thread and two consumer warpgroups), keeps the
//      ReLU signs of every layer as bits in shared memory, runs the chain
//      rule back through heads, trunk and the sin/cos encodings with the
//      data-gradient products B[i][o] = W[i][o] (the same buffer's W
//      copies), writes dpts and per-point dvd, and stores every activation
//      (X) and every pre-activation gradient (D) of the tile to a
//      feature-major fp32 scratch in HBM ([feature][point], n padded to 64)
//      straight from the accumulators;
//  (b) each weight gradient dW = X_rows D_rows^T (a sum over all points)
//      as a split-K product, the point axis cut into `splits` fixed chunks,
//      one partial per chunk: `wgrad_wgmma_kernel` takes the 12 matrix
//      products and the biases of their D rows in one launch (persistent
//      blocks, TMA stages and wgmma on 128x128 output tiles,
//      wgrad_wgmma.cuh), `wgrad_thin_kernel` the 1- and C-column heads and
//      their biases (a warp per element); then `reduce_kernel` sums the
//      partials in chunk order.
//      No atomics: the result is the same from run to run, and tile size
//      and split count change it only by the rounding of a reordered sum.
// Padded points carry a zero cotangent, so they add nothing to any sum and
// the last partial tile's gradients are kept (not dropped). The heads' data
// gradients are fp32 on CUDA cores. Both passes live in
// fused_mlp_bwd_common.cuh, shared with K4 (staged_mlp_bwd.cu).

#include "fused_mlp_bwd_common.cuh"

namespace fmlp {

using K2Rows = Scratch<true>;
constexpr int D_ROWS = K2Rows::D_G + G_PAD;    // 2440

template <tc::Mode MODE>
__global__ void __launch_bounds__(wl::THREADS, 1)
tile_kernel(const __grid_constant__ CUtensorMap wmap, const wl::Sched sched,
            const float* __restrict__ pts, const float* __restrict__ vd,
            int64_t n, int S, const float* __restrict__ P,
            const float* __restrict__ band, const float* __restrict__ g,
            int C, int64_t n_pad, float* __restrict__ X,
            float* __restrict__ D, float* __restrict__ dpts,
            float* __restrict__ dvd) {
  extern __shared__ uint8_t tsmem[];
  tile_pass<MODE, true>(&wmap, sched, pts, vd, n, S, P, band, g, C, n_pad, X,
                        D, dpts, dvd, tsmem);
}

template <tc::Mode MODE>
int launch_tile(const float* pts, const float* vd, int64_t n, int S,
                const float* P, const void* prep, const float* band,
                const float* g, int C, int64_t n_pad, float* X, float* D,
                float* dpts, float* dvd, cudaStream_t stream) {
  const Offsets o = offsets(C);
  CUtensorMap map;
  int err = wl::encode_prep_map(&map, prep, wl::prep_table<MODE>(o, true).rows);
  if (err) return err;
  const int smem = (int)tile_smem_bytes<MODE, true>();
  cudaFuncSetAttribute(tile_kernel<MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  tile_kernel<MODE><<<(unsigned)(n_pad / TP), wl::THREADS, smem, stream>>>(
      map, wl::make_sched<MODE>(o, true, true), pts, vd, n, S, P, band, g, C,
      n_pad, X, D, dpts, dvd);
  return (int)cudaGetLastError();
}

}  // namespace fmlp

extern "C" {

// scratch sizes in floats for n_pad points: X, D (feature-major)
void fused_mlp_bwd_scratch(int64_t n_pad, int64_t* out) {
  out[0] = (int64_t)fmlp::K2Rows::X_ROWS * n_pad;
  out[1] = (int64_t)fmlp::D_ROWS * n_pad;
}

// pass (b)'s job table (fmlp::job_rows), 16 rows of 6, into out with room
// for cap rows (nothing written when the table is longer)
int fused_mlp_wgrad_jobs(int C, int64_t* out, int cap) {
  return fmlp::job_rows<true>(C, out, cap);
}

// Pass (b) alone, on a scratch that pass (a) filled: for timing it apart.
int fused_mlp_wgrad(const float* X, const float* D, int64_t n_pad, int C,
                    float* part, int splits, float* dP, int mode,
                    cudaStream_t stream) {
  fmlp::GemmJobs gj;
  fmlp::ThinJobs tj;
  fmlp::make_jobs<true>(C, &gj, &tj);
  return fmlp::weight_gradients(X, D, n_pad, splits, fmlp::offsets(C).total,
                                gj, tj, part, dP, mode, stream);
}

// Pass (a) alone: the tile pass, filling X, D, dpts and dvd (for timing it
// apart; fused_mlp_bwd runs it then pass (b)).
int fused_mlp_tile(const float* pts, const float* vd, int64_t n, int S,
                   const float* P, const void* prep, const float* band,
                   const float* g, int C, int64_t n_pad, float* X, float* D,
                   float* dpts, float* dvd, int mode, cudaStream_t stream) {
  return mode == tc::TF32X3
             ? fmlp::launch_tile<tc::TF32X3>(pts, vd, n, S, P, prep, band, g,
                                             C, n_pad, X, D, dpts, dvd, stream)
             : fmlp::launch_tile<tc::BF16>(pts, vd, n, S, P, prep, band, g, C,
                                           n_pad, X, D, dpts, dvd, stream);
}

// g (n, C+1) cotangent -> dP (packed layout), dpts (n, 3), dvd (n, 3) per
// point, from the weights' wgmma copies prep that K1's launch wrote in the
// same mode. n_pad = n rounded up to 64; X, D scratch as sized above; part
// holds splits * (packed size) partial sums; mode: 0 TF32X3, 1 BF16.
int fused_mlp_bwd(const float* pts, const float* vd, int64_t n, int S,
                  const float* P, const void* prep, const float* band,
                  const float* g, int C, int64_t n_pad, float* X, float* D,
                  float* dpts, float* dvd, float* part, int splits, float* dP,
                  int mode, cudaStream_t stream) {
  const int err = fused_mlp_tile(pts, vd, n, S, P, prep, band, g, C, n_pad, X,
                                 D, dpts, dvd, mode, stream);
  if (err) return err;
  return fused_mlp_wgrad(X, D, n_pad, C, part, splits, dP, mode, stream);
}

}  // extern "C"
