// K1: fused NeRF MLP forward (positional encoding + 8x256 trunk + heads).
//
// Replaces: benerf_tpu/ops/pallas_mlp_t.py `_fwd_kernel_t` (through
// `_fwd_call` / `_trunk_forward_t`), the TPU kernel of every MLP call on the
// training path.
//
// Bound on an H100: operations. One point costs 1,186,816 FLOP of matrix
// products and moves 28 bytes in and 16 bytes out (pts, its ray's viewdir,
// C+1 outputs; the 2.4 MB of weights are read once per call and stay in the
// 50 MB L2). On the tensor cores that is 7.2 us per 1,000 points in TF32X3
// (three TF32 products at 495 TFLOP/s) and 1.2 us in BF16 (989 TFLOP/s),
// still far above the 13 ns of HBM traffic.
//
// Design: the TPU kernel pins all weights and (256, 1024) activation slabs
// in VMEM; a Hopper block has 227 KB of shared memory, so here a block owns
// a 64-point tile, keeps that tile's activations in shared memory
// (point-major) and streams the weights through a ring of TMA stages
// (wgmma_layer.cuh): one producer thread keeps the ring full while two
// consumer warpgroups run every layer product as wgmma.mma_async, A (the
// activations) from registers, B (the weights) from the ring, in the mode
// of compute_dtype: TF32X3 ("float32", fp32-level accuracy from three TF32
// products) or BF16 ("bfloat16", the JAX kernel's bf16 mode). The launch
// first writes the weights' wgmma copies (prep_kernel: W^T for this
// kernel, W for K2's data gradients, split or rounded for the mode) into a
// buffer the caller keeps for K2. Encodings are computed in the block;
// nothing but the inputs, that buffer and the (n, C+1) result touches HBM,
// unless autograd will need the call's backward: then the KEEP
// instantiation also writes what K2's tile pass would otherwise compute
// again, every activation as a row of K2's scratch X in the mode's format
// (TF32X3: fp32, row stride n_pad; BF16: tile-blocked bf16 rows and the
// fp32 rows h7 and hv) and the ReLU sign words of every layer: 10,384 B
// a point in TF32X3 (1.2 ms of HBM time at 391,040 points), 6,608 in BF16
// (0.8 ms). The consumers store only the sign words (in their fragment
// order, 2 KB a layer); the activations go out through the storer, the
// producer warpgroup's three idle warps (fused_mlp_wg.cuh `store_kept`):
// once the consumers have written a layer into H it copies the tile to X
// in coalesced streaming stores while they run the next layer's products,
// on two named barriers, and they overwrite H only once it is copied.
// Stored from the consumers' epilogues, where all SMs reached each layer
// boundary together, the rows took a keeping launch ~1.3 ms (TF32X3) and
// ~1.2 ms (BF16) past K1 alone at that size; through the storer ~0.7 ms
// and ~0.66 ms, which the consumers hardly spend waiting for it: their
// sign words and the stores' drag on the products they overlap (PERF.md
// §6). The
// 1- and C-column heads are fp32 on CUDA cores. Points past n (the ragged
// last tile) are encoded as zeros and not written to the result; KEEP
// writes their rows too (K2's cotangent is zero there).

#include "fused_mlp_wg.cuh"

namespace fmlp {

template <tc::Mode MODE>
using FwdRing = wl::Ring<MODE, 128 * 1024 / wl::Cfg<MODE>::SLOT_BYTES>;
template <tc::Mode MODE>
constexpr size_t FWD_FLOATS =
    TP * (wl::Ld<MODE>::H + wl::Ld<MODE>::P + wl::Ld<MODE>::V);

// KEEP: X, side (BF16) and signs receive K2's kept rows and sign words
// for the grid's n_pad = gridDim.x x 64 points; without it they are unread.
template <tc::Mode MODE, bool KEEP>
__global__ void __launch_bounds__(wl::THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap wmap, const wl::Sched sched,
           const float* __restrict__ pts, const float* __restrict__ vd,
           int64_t n, int S, const float* __restrict__ P,
           const float* __restrict__ band, int C, float* __restrict__ out,
           float* __restrict__ X, float* __restrict__ side,
           uint32_t* __restrict__ signs) {
  using L = wl::Ld<MODE>;
  extern __shared__ uint8_t fsmem[];
  FwdRing<MODE> ring;
  float* H = wl::carve(fsmem, FWD_FLOATS<MODE>, ring);
  float* PE = H + TP * L::H;
  float* VPE = PE + TP * L::P;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if constexpr (KEEP) {
    if (wl::producer(ring, &wmap, sched, [&] {
          store_kept<MODE>(PE, VPE, H, X, side, (int64_t)gridDim.x * TP, blockIdx.x);
        }))
      return;
  } else if (wl::producer(ring, &wmap, sched)) {
    return;
  }
  const int w = wl::warpgroup();
  const Offsets o = offsets(C);
  const int64_t p0 = (int64_t)blockIdx.x * TP;
  encode_pm(pts, vd, n, S, band, p0, PE, L::P, VPE, L::V);
  tile_written<KEEP>();  // KEEP: PE and VPE handed to the storer
  auto alpha = [&](const float* h7) {
    head_pm(P + o.wa, 1, 0, WIDTH, h7, L::H, __ldg(P + o.ba), out, n, p0, C, C);
  };
  if constexpr (KEEP) {
    const KeptSigns keep{signs + (int64_t)blockIdx.x * SIGN_WORDS};
    forward_wg<MODE, KeptSigns>(P, o, PE, ViewPE{VPE}, H, ring, &keep, alpha, w);
  } else {
    forward_wg<MODE>(P, o, PE, ViewPE{VPE}, H, ring, nullptr, alpha, w);
  }
  tile_written<KEEP>();  // hv in H columns 0..127
  for (int c = 0; c < C; ++c)
    head_pm(P + o.wrgb, C, c, HEAD, H, L::H, __ldg(P + o.brgb + c), out, n, p0,
            C, c);
}

// The weights' wgmma copies (prep_kernel) from P into prep, then the
// forward kernel, keeping its forward into X, side and signs when X is not
// null. view_pe: K1's table; the staged forward (K3) has its own kernel and
// calls launch_prep itself.
template <tc::Mode MODE>
int launch_fwd(const float* pts, const float* vd, int64_t n, int S,
               const float* P, void* prep, const float* band, int C,
               float* out, float* X, float* side, uint32_t* signs,
               cudaStream_t stream) {
  const Offsets o = offsets(C);
  const wl::PrepTable t = wl::prep_table<MODE>(o, true);
  int err = wl::launch_prep<MODE>(P, t, prep, stream);
  CUtensorMap map;
  if (!err) err = wl::encode_prep_map(&map, prep, t.rows);
  if (err) return err;
  const int smem = (int)wl::smem_bytes<FwdRing<MODE>>(FWD_FLOATS<MODE>);
  const auto kernel = X ? fwd_kernel<MODE, true> : fwd_kernel<MODE, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const unsigned blocks = (unsigned)((n + TP - 1) / TP);
  kernel<<<blocks, wl::THREADS, smem, stream>>>(
      map, wl::make_sched<MODE>(o, true, true, false), pts, vd, n, S, P, band, C,
      out, X, side, signs);
  return (int)cudaGetLastError();
}

}  // namespace fmlp

extern "C" {

// 14 offsets (floats) of the packed weight vector for C channels, in the
// order of fmlp::Offsets; the Python side checks its layout against this.
void fused_mlp_layout(int C, int64_t* out) {
  const fmlp::Offsets o = fmlp::offsets(C);
  const int64_t v[14] = {o.w0, o.wh, o.w5pe, o.wf, o.wfv, o.wvpe, o.b,
                         o.bf, o.bv, o.wa, o.ba, o.wrgb, o.brgb, o.total};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
}

// The prepared buffer's table (wl::prep_rows: rows of row0, N, K, src, I,
// O, forward copies then data-gradient copies) for K1/K2 (view_pe 1) or
// K3/K4 (0) in mode (0 TF32X3, 1 BF16) into out, which has room for cap
// rows; returns the row count and writes nothing when it exceeds cap. The
// table does not depend on C.
int fused_mlp_prep_table(int view_pe, int mode, int64_t* out, int cap) {
  const fmlp::Offsets o = fmlp::offsets(1, view_pe != 0);
  return mode == tc::TF32X3
             ? wl::prep_rows<tc::TF32X3>(o, view_pe != 0, out, cap)
             : wl::prep_rows<tc::BF16>(o, view_pe != 0, out, cap);
}

// The prepared buffer alone from packed weights P (C channels): for
// checking it against its plain version (the forward launches make it).
int fused_mlp_prep(const float* P, int C, int view_pe, void* prep, int mode,
                   cudaStream_t stream) {
  const fmlp::Offsets o = fmlp::offsets(C, view_pe != 0);
  if (mode == tc::TF32X3)
    return wl::launch_prep<tc::TF32X3>(
        P, wl::prep_table<tc::TF32X3>(o, view_pe != 0), prep, stream);
  return wl::launch_prep<tc::BF16>(P, wl::prep_table<tc::BF16>(o, view_pe != 0),
                                   prep, stream);
}

// What K1 keeps for K2 of n_pad points in `mode`, in elements: X's rows
// (fp32 in TF32X3, tile-blocked bf16 in BF16), BF16's fp32 rows h7 and hv
// (0 in TF32X3), the ReLU sign words (32-bit)
void fused_mlp_kept(int64_t n_pad, int mode, int64_t* out) {
  using R = fmlp::Scratch<true>;
  const bool b = mode == tc::BF16;
  out[0] = (int64_t)(b ? R::X_HV : R::X_ROWS) * n_pad;
  out[1] = b ? (int64_t)fmlp::Side<true>::KEPT * n_pad : 0;
  out[2] = n_pad / fmlp::TP * fmlp::SIGN_WORDS;
}

// pts (n, 3), vd (n / S, 3), packed weights P (natural column order), band
// (14,) -> out (n, C+1), and the weights' wgmma copies into prep (its
// table's rows x 64 B), which K2 reads. With X not null the launch also
// keeps its forward for K2 into X, side (BF16) and signs, sized by
// fused_mlp_kept for n rounded up to 64. mode: 0 TF32X3, 1 BF16.
int fused_mlp_fwd(const float* pts, const float* vd, int64_t n, int S,
                  const float* P, void* prep, const float* band, int C,
                  float* out, void* X, float* side, uint32_t* signs, int mode,
                  cudaStream_t stream) {
  float* x = static_cast<float*>(X);
  return mode == tc::TF32X3
             ? fmlp::launch_fwd<tc::TF32X3>(pts, vd, n, S, P, prep, band, C,
                                            out, x, side, signs, stream)
             : fmlp::launch_fwd<tc::BF16>(pts, vd, n, S, P, prep, band, C, out,
                                          x, side, signs, stream);
}

}  // extern "C"
