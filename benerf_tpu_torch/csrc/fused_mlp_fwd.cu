// K1: fused NeRF MLP forward (positional encoding + 8x256 trunk + heads).
//
// Replaces: benerf_tpu/ops/pallas_mlp_t.py `_fwd_kernel_t` (through
// `_fwd_call` / `_trunk_forward_t`), the TPU kernel of every MLP call on the
// training path.
//
// Bound on an H100: operations. One point costs 1,186,816 FLOP of matrix
// products and moves 28 bytes in and 16 bytes out (pts, its ray's viewdir,
// C+1 outputs; the 2.4 MB of weights are read once per call and stay in the
// 50 MB L2), so a call is bound by the fp32 CUDA-core rate by two orders of
// magnitude over HBM bandwidth.
//
// Design: the TPU kernel pins all weights and (256, 1024) activation slabs
// in VMEM; a Hopper block has 227 KB of shared memory, so here a block owns
// a 64-point tile, keeps that tile's activations in shared memory (one
// 256-row buffer plus the encodings, 97,920 bytes: two blocks per SM) and
// streams every weight matrix from L2 layer by layer. Encodings are
// computed in the block; nothing but the inputs and the (n, C+1) result
// touches HBM. Each thread keeps an 8x8 register tile of outputs so each
// weight and activation load feeds 8 FMAs. fp32 throughout (no TF32, no
// tensor cores). Points past n (the ragged last tile) are encoded as zeros
// and not written.

#include "fused_mlp_common.cuh"

namespace fmlp {

// raw head outputs: out[p][c] for c < C from hv (rows 0..127 of `hv`),
// out[p][C] from h7; 4 threads per point split the contraction
__device__ __forceinline__ void head(const float* __restrict__ w, int ldw,
                                     int col, int I, const float* a,
                                     float bias, float* out, int64_t n,
                                     int64_t p0, int C, int c_out) {
  const int c = threadIdx.x / 4, part = threadIdx.x % 4;
  float s = 0.f;
  for (int i = part; i < I; i += 4) s = fmaf(__ldg(w + i * ldw + col), a[i * LDA + c], s);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  const int64_t p = p0 + c;
  if (part == 0 && p < n) out[p * (C + 1) + c_out] = s + bias;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
fwd_kernel(const float* __restrict__ pts, const float* __restrict__ vd,
           int64_t n, int S, const float* __restrict__ P,
           const float* __restrict__ band, int C, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* PE = H + WIDTH * LDA;
  float* VPE = PE + PE_PAD * LDA;
  const Offsets o = offsets(C);
  const int64_t p0 = (int64_t)blockIdx.x * TP;

  encode_tile(pts, vd, n, S, band, p0, PE, VPE);
  __syncthreads();
  trunk_forward(P, o, PE, H, nullptr, 0, 0, 0);  // h7 in H
  // the alpha head reads h7 before feature_layer's barrier lets f overwrite it
  head(P + o.wa, 1, 0, WIDTH, H, __ldg(P + o.ba), out, n, p0, C, C);
  feature_layer(P, o, H, nullptr, 0, 0, 0);      // f in H
  __syncthreads();
  views_layer(P, o, H, VPE, nullptr, 0, 0, 0);   // hv in H rows 0..127
  __syncthreads();
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

// pts (n, 3), vd (n / S, 3), packed weights P, band (14,) -> out (n, C+1)
int fused_mlp_fwd(const float* pts, const float* vd, int64_t n, int S,
                  const float* P, const float* band, int C, float* out,
                  cudaStream_t stream) {
  cudaFuncSetAttribute(fmlp::fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)fmlp::SMEM_BYTES);
  const int64_t blocks = (n + fmlp::TP - 1) / fmlp::TP;
  fmlp::fwd_kernel<<<(unsigned)blocks, fmlp::THREADS, fmlp::SMEM_BYTES, stream>>>(
      pts, vd, n, S, P, band, C, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
