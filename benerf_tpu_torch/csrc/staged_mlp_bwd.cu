// K4: staged NeRF MLP backward (rematerialized K3 + VJP to every weight,
// to the points and to the per-point view bias).
//
// Replaces: benerf_tpu/ops/pallas_mlp.py `_bwd_kernel` (through `_bwd_call`
// and the `_core` custom_vjp).
//
// Bound on an H100: operations. Per point it redoes K3's forward (1,179,904
// FLOP), forms the data gradients (1x) and the weight gradients (1x):
// 3 x 1,179,904 FLOP at 495 / 3 TFLOP/s in TF32X3, at 989 in BF16. The
// bytes the function must move (pts, cotangent, d pts, the per-ray bias and
// its gradient, the weights and their gradients) are two orders of
// magnitude below what HBM could move in that time; the fp32 scratch below
// (2,496 + 2,436 rows of 4 B a point each way at C = 3) is a cost of the
// two-pass design, reported apart as K2's is.
//
// Design: K2's two deterministic passes (fused_mlp_bwd.cu), on the same
// template (fused_mlp_bwd_common.cuh) with the view input swapped:
//  (a) `staged_tile_kernel`: `tile_pass<MODE, false>`, one block per
//      64-point tile on wgmma in the mode of compute_dtype, TF32X3 or BF16
//      (operands rounded to bf16 at the fragment load, fp32 in shared
//      memory and in the scratch, heads fp32 on the CUDA cores, as K2),
//      the weights by TMA from the buffer K3's launch prepared. It rematerializes K3 with the ReLU signs kept as bits, runs
//      the chain rule back through heads, trunk and the sin/cos encoding
//      (L = 10, no BARF) to d pts, and stores every activation (X) and
//      pre-activation gradient (D) of the tile to a feature-major scratch.
//      The TPU kernel writes a per-point d vb (n, 128) that the autodiff of
//      its broadcast sums per ray; here d vb per point is D's rows D_HV
//      (the views layer's pre-activation gradient, needed for wfv's
//      gradient anyway), and the wrapper sums them over each ray's S
//      samples, which may straddle tiles.
//      Shared memory: the cotangent has C + 1 rows, up to 128, where K2's
//      has at most 8. Rather than drop a weight stage or build a second
//      instantiation for large C, K4 loads its cotangent after the forward
//      into columns 128..255 of the activation tile H, which hold nothing
//      once hv sits in columns 0..127, and keeps the alpha column, which
//      the backward reads after the feature product has overwritten H, in
//      one row of its own: 201,008 B (BF16 203,104) for every C, one block of two
//      consumer warpgroups and a producer warp per SM.
//  (b) `weight_gradients`: every weight gradient as a split-K product over
//      fixed point chunks (K2's TMA + wgmma kernel in the same mode,
//      wgrad_wgmma.cuh, natural column order) and an in-order sum of the
//      partials. The TPU
//      kernel adds each grid step's tile into one VMEM output in grid
//      order; Hopper blocks run concurrently, so no block adds into
//      another's result and no atomics are used: split count changes the
//      result only by the rounding of a reordered sum.
// Padded points carry a zero cotangent, so they add nothing to any sum and
// the last partial tile's gradients are kept.

#include "fused_mlp_bwd_common.cuh"

namespace fmlp {

using K4Rows = Scratch<false>;

template <tc::Mode MODE>
__global__ void __launch_bounds__(wl::THREADS, 1)
staged_tile_kernel(const __grid_constant__ CUtensorMap wmap,
                   const wl::Sched sched, const float* __restrict__ pts,
                   const float* __restrict__ vb, int64_t n, int S,
                   const float* __restrict__ P, const float* __restrict__ g,
                   int C, int64_t n_pad, float* __restrict__ X,
                   float* __restrict__ D, float* __restrict__ dpts) {
  extern __shared__ uint8_t tsmem[];
  tile_pass<MODE, false>(&wmap, sched, pts, vb, n, S, P, nullptr, g, C, n_pad,
                         X, D, dpts, nullptr, tsmem);
}

template <tc::Mode MODE>
int launch_staged_tile(const float* pts, const float* vb, int64_t n, int S,
                       const float* P, const void* prep, const float* g, int C,
                       int64_t n_pad, float* X, float* D, float* dpts,
                       cudaStream_t stream) {
  const Offsets o = offsets(C, false);
  CUtensorMap map;
  int err = wl::encode_prep_map(&map, prep, wl::prep_table<MODE>(o, false).rows);
  if (err) return err;
  const int smem = (int)tile_smem_bytes<MODE, false>();
  cudaFuncSetAttribute(staged_tile_kernel<MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  staged_tile_kernel<MODE><<<(unsigned)(n_pad / TP), wl::THREADS, smem, stream>>>(
      map, wl::make_sched<MODE>(o, false, true), pts, vb, n, S, P, g, C, n_pad,
      X, D, dpts);
  return (int)cudaGetLastError();
}

}  // namespace fmlp

extern "C" {

// for n_pad points and C channels: scratch sizes in floats of X and D
// (feature-major, row stride n_pad), and the first row of D holding d vb
// per point (128 rows)
void staged_mlp_bwd_scratch(int64_t n_pad, int C, int64_t* out) {
  out[0] = (int64_t)fmlp::K4Rows::X_ROWS * n_pad;
  out[1] = (int64_t)(fmlp::K4Rows::D_G + C + 1) * n_pad;
  out[2] = fmlp::K4Rows::D_HV;
}

// pass (b)'s job table (fmlp::job_rows), 15 rows of 6, into out with room
// for cap rows (nothing written when the table is longer)
int staged_mlp_wgrad_jobs(int C, int64_t* out, int cap) {
  return fmlp::job_rows<false>(C, out, cap);
}

// Pass (b) alone, on a scratch that pass (a) filled: for timing it apart.
int staged_mlp_wgrad(const float* X, const float* D, int64_t n_pad, int C,
                     float* part, int splits, float* dP, int mode,
                     cudaStream_t stream) {
  fmlp::GemmJobs gj;
  fmlp::ThinJobs tj;
  fmlp::make_jobs<false>(C, &gj, &tj);
  return fmlp::weight_gradients(X, D, n_pad, splits,
                                fmlp::offsets(C, false).total, gj, tj, part,
                                dP, mode, stream);
}

// Pass (a) alone: the tile pass, filling X, D and dpts (for timing it
// apart; staged_mlp_bwd runs it then pass (b)).
int staged_mlp_tile(const float* pts, const float* vb, int64_t n, int S,
                    const float* P, const void* prep, const float* g, int C,
                    int64_t n_pad, float* X, float* D, float* dpts, int mode,
                    cudaStream_t stream) {
  return mode == tc::TF32X3
             ? fmlp::launch_staged_tile<tc::TF32X3>(pts, vb, n, S, P, prep, g,
                                                    C, n_pad, X, D, dpts, stream)
             : fmlp::launch_staged_tile<tc::BF16>(pts, vb, n, S, P, prep, g, C,
                                                  n_pad, X, D, dpts, stream);
}

// g (n, C+1) cotangent -> dP (packed layout, natural column order), dpts
// (n, 3), from the weights' wgmma copies prep that K3's launch wrote in the
// same mode; d vb per point is left in D's rows staged_mlp_bwd_scratch()[2]
// ..+128. n_pad = n rounded up to 64; X, D scratch as sized above; part
// holds splits * (packed size) partial sums; mode: 0 TF32X3, 1 BF16.
int staged_mlp_bwd(const float* pts, const float* vb, int64_t n, int S,
                   const float* P, const void* prep, const float* g, int C,
                   int64_t n_pad, float* X, float* D, float* dpts, float* part,
                   int splits, float* dP, int mode, cudaStream_t stream) {
  const int err = staged_mlp_tile(pts, vb, n, S, P, prep, g, C, n_pad, X, D,
                                  dpts, mode, stream);
  if (err) return err;
  return staged_mlp_wgrad(X, D, n_pad, C, part, splits, dP, mode, stream);
}

}  // extern "C"
