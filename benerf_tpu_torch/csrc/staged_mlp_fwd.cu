// K3: staged NeRF MLP forward (8x256 trunk + heads, the view encoding's
// product taken outside as a per-ray bias).
//
// Replaces: benerf_tpu/ops/pallas_mlp.py `_fwd_kernel` (through `_fwd_call`
// and the `_core` custom_vjp), the TPU kernel of the standard trunk when the
// view encoding is not L = 4 or C + 1 > 8 (BARF off).
//
// Bound on an H100: operations. One point costs 1,179,904 FLOP of matrix
// products (K1's count without the 27x128 view-encoding product, which runs
// outside) and moves 12 bytes in and 4 (C+1) bytes out; the per-ray bias
// (512 B per ray of S points) and the 2.4 MB of weights are read once per
// call and stay in the 50 MB L2. On the tensor cores that is 7.2 us per
// 1,000 points in TF32X3 (165 TFLOP/s) and 1.2 us in BF16 (989 TFLOP/s),
// far above the ~10 ns of HBM traffic.
//
// Design: K1's block (fused_mlp_fwd.cu, fused_mlp_wg.cuh) with the view
// input swapped. The TPU kernel streams the encoding pe (n, 64) and a
// per-point copy of the view bias vb (n, 128), made outside, because a
// Mosaic block needs at least 8 sublanes; at the fine call that copy is
// 200 MB written and read back. Here the block encodes its points itself
// (L = 10, no BARF) and its views layer adds vb[p / S] per point from L2
// (fused_mlp_wg.cuh ViewBias) where K1 runs its view-encoding product.
// Every layer product runs as K1's, on wgmma with the weights brought in by
// TMA (wgmma_layer.cuh), in the mode of compute_dtype: TF32X3 ("float32")
// or BF16 ("bfloat16": operands rounded to bf16, fp32 accumulation, as
// K1). In BF16 mode the JAX function also rounds pe and vb to bf16: pe is a
// product operand, so the fragment load rounds it; vb is a bias, made
// outside with the mode's operands (ops/staged_mlp.py) and added in fp32,
// as K1 adds bv. The launch first writes the weights' wgmma copies (K3's
// table: no view-encoding weights) into a buffer the caller keeps for K4.
// The C + 1 output heads take any C < 128 (the TPU kernel's head space),
// fp32 dot products on the CUDA cores with plain loads; at C = 127 the rgb
// head is ~3% of the trunk's FLOP but, on the CUDA cores, most of K3's time
// (PERF.md). Shared memory: the ring (128 KB), H
// (256 columns) and PE (64), one block of two consumer
// warpgroups and a producer warp per SM. Points
// past n (the ragged last tile) are encoded as zeros and not written.

#include "fused_mlp_wg.cuh"

namespace fmlp {

template <tc::Mode MODE>
using StagedRing = wl::Ring<MODE, 128 * 1024 / wl::Cfg<MODE>::SLOT_BYTES>;
template <tc::Mode MODE>
constexpr size_t STAGED_FWD_FLOATS = TP * (wl::Ld<MODE>::H + wl::Ld<MODE>::P);

template <tc::Mode MODE>
__global__ void __launch_bounds__(wl::THREADS, 1)
staged_fwd_kernel(const __grid_constant__ CUtensorMap wmap, const wl::Sched sched,
                  const float* __restrict__ pts, const float* __restrict__ vb,
                  int64_t n, int S, const float* __restrict__ P, int C,
                  float* __restrict__ out) {
  using L = wl::Ld<MODE>;
  extern __shared__ uint8_t ssmem[];
  StagedRing<MODE> ring;
  float* H = wl::carve(ssmem, STAGED_FWD_FLOATS<MODE>, ring);
  float* PE = H + TP * L::H;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (wl::producer(ring, &wmap, sched)) return;
  const int w = wl::warpgroup();
  const Offsets o = offsets(C, false);
  const int64_t p0 = (int64_t)blockIdx.x * TP;
  encode_pm(pts, nullptr, n, S, nullptr, p0, PE, L::P, nullptr, 0);
  wg::consumers_sync();
  auto alpha = [&](const float* h7) {
    head_pm(P + o.wa, 1, 0, WIDTH, h7, L::H, __ldg(P + o.ba), out, n, p0, C, C);
  };
  forward_wg<MODE>(P, o, PE, ViewBias{vb, n, p0, S}, H, ring, nullptr, alpha, w);
  wg::consumers_sync();  // hv in H columns 0..127
  for (int c = 0; c < C; ++c)
    head_pm(P + o.wrgb, C, c, HEAD, H, L::H, __ldg(P + o.brgb + c), out, n, p0,
            C, c);
}

template <tc::Mode MODE>
int launch_staged_fwd(const float* pts, const float* vb, int64_t n, int S,
                      const float* P, void* prep, int C, float* out,
                      cudaStream_t stream) {
  const Offsets o = offsets(C, false);
  const wl::PrepTable t = wl::prep_table<MODE>(o, false);
  int err = wl::launch_prep<MODE>(P, t, prep, stream);
  CUtensorMap map;
  if (!err) err = wl::encode_prep_map(&map, prep, t.rows);
  if (err) return err;
  const int smem =
      (int)wl::smem_bytes<StagedRing<MODE>>(STAGED_FWD_FLOATS<MODE>);
  cudaFuncSetAttribute(staged_fwd_kernel<MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const unsigned blocks = (unsigned)((n + TP - 1) / TP);
  staged_fwd_kernel<MODE><<<blocks, wl::THREADS, smem, stream>>>(
      map, wl::make_sched<MODE>(o, false, false), pts, vb, n, S, P, C, out);
  return (int)cudaGetLastError();
}

}  // namespace fmlp

extern "C" {

// 14 offsets (floats) of K3/K4's packed weight vector for C channels, in
// the order of fmlp::Offsets (wvpe and bv empty)
void staged_mlp_layout(int C, int64_t* out) {
  const fmlp::Offsets o = fmlp::offsets(C, false);
  const int64_t v[14] = {o.w0, o.wh, o.w5pe, o.wf, o.wfv, o.wvpe, o.b,
                         o.bf, o.bv, o.wa, o.ba, o.wrgb, o.brgb, o.total};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
}

// pts (n, 3), per-ray view bias vb (n / S, 128), packed weights P (natural
// column order) -> out (n, C+1): columns 0..C-1 rgb, C alpha; and the
// weights' wgmma copies into prep (K3's table), which K4 reads; mode: 0
// TF32X3, 1 BF16
int staged_mlp_fwd(const float* pts, const float* vb, int64_t n, int S,
                   const float* P, void* prep, int C, float* out, int mode,
                   cudaStream_t stream) {
  return mode == tc::TF32X3
             ? fmlp::launch_staged_fwd<tc::TF32X3>(pts, vb, n, S, P, prep, C,
                                                   out, stream)
             : fmlp::launch_staged_fwd<tc::BF16>(pts, vb, n, S, P, prep, C, out,
                                                 stream);
}

}  // extern "C"
