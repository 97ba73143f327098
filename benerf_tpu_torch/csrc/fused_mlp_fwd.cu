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
// a 64-point tile, keeps that tile's activations in shared memory and
// streams the weights through a ring of three cp.async stages
// (mma_layer.cuh; one block of 8 warps per SM). Every layer product runs on mma.sync: TF32X3
// (compute_dtype "float32", fp32-level accuracy from three TF32 products)
// or BF16 (compute_dtype "bfloat16", the JAX kernel's bf16 mode). Encodings
// are computed in the block; nothing but the inputs and the (n, C+1) result
// touches HBM. The 1- and C-column heads are fp32 on CUDA cores. Points
// past n (the ragged last tile) are encoded as zeros and not written.

#include "fused_mlp_tc.cuh"

namespace fmlp {

constexpr size_t FWD_SMEM_BYTES =
    TC_FWD_ROWS * tc::LDA * sizeof(float) + tc::STAGES_BYTES;  // 211,968

template <tc::Mode MODE>
__global__ void __launch_bounds__(tc::THREADS, 1)
fwd_kernel(const float* __restrict__ pts, const float* __restrict__ vd,
           int64_t n, int S, const float* __restrict__ P,
           const float* __restrict__ band, int C, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* PE = H + WIDTH * tc::LDA;
  float* VPE = PE + PE_PAD * tc::LDA;
  tc::Pipe pipe{VPE + VPE_PAD * tc::LDA, 0};
  const Offsets o = offsets(C);
  const int64_t p0 = (int64_t)blockIdx.x * TP;

  pipe.start(fwd_src(P + o.w0, PE_ROWS, WIDTH));  // in flight while encoding
  encode_tile(pts, vd, n, S, band, p0, PE, VPE);
  auto alpha = [&](const float* h7) {
    head(P + o.wa, 1, 0, WIDTH, h7, __ldg(P + o.ba), out, n, p0, C, C);
  };
  forward_tc<MODE>(P, o, PE, ViewPE{VPE}, H, pipe, nullptr, alpha, nullptr);
  __syncthreads();  // hv in H rows 0..127
  for (int c = 0; c < C; ++c)
    head(P + o.wrgb, C, c, HEAD, H, __ldg(P + o.brgb + c), out, n, p0, C, c);
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

// pts (n, 3), vd (n / S, 3), packed weights P (natural column order), band
// (14,) -> out (n, C+1); mode: 0 TF32X3, 1 BF16
int fused_mlp_fwd(const float* pts, const float* vd, int64_t n, int S,
                  const float* P, const float* band, int C, float* out,
                  int mode, cudaStream_t stream) {
  const int64_t blocks = (n + fmlp::TP - 1) / fmlp::TP;
  const int smem = (int)fmlp::FWD_SMEM_BYTES;
  if (mode == tc::TF32X3) {
    cudaFuncSetAttribute(fmlp::fwd_kernel<tc::TF32X3>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fmlp::fwd_kernel<tc::TF32X3><<<(unsigned)blocks, tc::THREADS, smem, stream>>>(
        pts, vd, n, S, P, band, C, out);
  } else {
    cudaFuncSetAttribute(fmlp::fwd_kernel<tc::BF16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fmlp::fwd_kernel<tc::BF16><<<(unsigned)blocks, tc::THREADS, smem, stream>>>(
        pts, vd, n, S, P, band, C, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
