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
// Design: K1's block (fused_mlp_fwd.cu, fused_mlp_tc.cuh) with the view
// input swapped. The TPU kernel streams the encoding pe (n, 64) and a
// per-point copy of the view bias vb (n, 128), made outside, because a
// Mosaic block needs at least 8 sublanes; at the fine call that copy is
// 200 MB written and read back. Here the block encodes its points itself
// (L = 10, no BARF) and its views layer adds vb[p / S] per point column
// from L2 (fused_mlp_tc.cuh ViewBias) where K1 runs its view-encoding
// product. Every layer product runs on mma.sync in the mode of
// compute_dtype: TF32X3 ("float32") or BF16 ("bfloat16": operands rounded
// to bf16 at the fragment load, fp32 accumulation, as K1). In BF16 mode the
// JAX function also rounds pe and vb to bf16: pe is a product operand, so
// the fragment load rounds it; vb is a bias, made outside with the mode's
// operands (ops/staged_mlp.py) and added in fp32, as K1 adds bv. The C + 1
// output heads take any C < 128 (the TPU kernel's head space), fp32
// dot products on the CUDA cores with plain loads (wrgb starts at an odd
// offset, which cp.async cannot stage); at C = 127 the rgb head is ~3% of
// the trunk's FLOP. Shared memory: H (256 rows), PE (64) and three weight
// stages, 202,752 B, one block of 8 warps per SM. Points past n (the
// ragged last tile) are encoded as zeros and not written.

#include "fused_mlp_tc.cuh"

namespace fmlp {

constexpr size_t STAGED_FWD_SMEM =
    (WIDTH + PE_PAD) * LDA * sizeof(float) + tc::STAGES_BYTES;  // 202,752

template <tc::Mode MODE>
__global__ void __launch_bounds__(THREADS, 1)
staged_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ vb,
                  int64_t n, int S, const float* __restrict__ P, int C,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* PE = H + WIDTH * LDA;
  tc::Pipe pipe{PE + PE_PAD * LDA, 0};
  const Offsets o = offsets(C, false);
  const int64_t p0 = (int64_t)blockIdx.x * TP;

  pipe.start(fwd_src(P + o.w0, PE_ROWS, WIDTH));  // in flight while encoding
  encode_tile(pts, nullptr, n, S, nullptr, p0, PE, nullptr);
  auto alpha = [&](const float* h7) {
    head(P + o.wa, 1, 0, WIDTH, h7, __ldg(P + o.ba), out, n, p0, C, C);
  };
  forward_tc<MODE>(P, o, PE, ViewBias{vb, n, p0, S}, H, pipe, nullptr, alpha,
                   nullptr);
  __syncthreads();  // hv in H rows 0..127
  for (int c = 0; c < C; ++c)
    head(P + o.wrgb, C, c, HEAD, H, __ldg(P + o.brgb + c), out, n, p0, C, c);
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
// column order) -> out (n, C+1): columns 0..C-1 rgb, C alpha; mode: 0
// TF32X3, 1 BF16
int staged_mlp_fwd(const float* pts, const float* vb, int64_t n, int S,
                   const float* P, int C, float* out, int mode,
                   cudaStream_t stream) {
  const int64_t blocks = (n + fmlp::TP - 1) / fmlp::TP;
  const int smem = (int)fmlp::STAGED_FWD_SMEM;
  if (mode == tc::TF32X3) {
    cudaFuncSetAttribute(fmlp::staged_fwd_kernel<tc::TF32X3>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fmlp::staged_fwd_kernel<tc::TF32X3><<<(unsigned)blocks, fmlp::THREADS, smem,
                                          stream>>>(pts, vb, n, S, P, C, out);
  } else {
    cudaFuncSetAttribute(fmlp::staged_fwd_kernel<tc::BF16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fmlp::staged_fwd_kernel<tc::BF16><<<(unsigned)blocks, fmlp::THREADS, smem,
                                        stream>>>(pts, vb, n, S, P, C, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
