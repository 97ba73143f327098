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
// call and stay in the 50 MB L2. fp32 CUDA-core rate bounds it by two
// orders of magnitude over HBM bandwidth.
//
// Design: K1's block (fused_mlp_fwd.cu) with two changes. The TPU kernel
// streams the encoding pe (n, 64) and a per-point copy of the view bias
// vb (n, 128), made outside, because a Mosaic block needs at least 8
// sublanes; at the fine call that copy is 200 MB written and read back.
// Here the block encodes its points itself (L = 10, as K1 does, no BARF)
// and its views layer reads vb per ray, vb[p / S], from L2. The C + 1
// output heads take any C < 128 (the TPU kernel's head space), one
// 4-thread dot product per point and column. Shared memory: the 256-row
// activation buffer and the encoding, 87,040 bytes, two blocks per SM.

#include "fused_mlp_common.cuh"

namespace fmlp {

constexpr size_t STAGED_FWD_SMEM = (WIDTH + PE_PAD) * LDA * sizeof(float);

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
staged_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ vb,
                  int64_t n, int S, const float* __restrict__ P, int C,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* PE = H + WIDTH * LDA;
  const Offsets o = offsets(C, false);
  const int64_t p0 = (int64_t)blockIdx.x * TP;

  encode_tile(pts, nullptr, n, S, nullptr, p0, PE, nullptr);
  __syncthreads();
  trunk_forward(P, o, PE, H, nullptr, 0, 0, 0);  // h7 in H
  // the alpha head reads h7 before feature_layer's barrier lets f overwrite it
  head(P + o.wa, 1, 0, WIDTH, H, __ldg(P + o.ba), out, n, p0, C, C);
  feature_layer(P, o, H, nullptr, 0, 0, 0);      // f in H
  __syncthreads();
  views_layer_vb(P, o, H, vb, n, S, p0, nullptr, 0, 0);  // hv in H rows 0..127
  __syncthreads();
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

// pts (n, 3), per-ray view bias vb (n / S, 128), packed weights P -> out
// (n, C+1): columns 0..C-1 rgb, C alpha
int staged_mlp_fwd(const float* pts, const float* vb, int64_t n, int S,
                   const float* P, int C, float* out, cudaStream_t stream) {
  cudaFuncSetAttribute(fmlp::staged_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)fmlp::STAGED_FWD_SMEM);
  const int64_t blocks = (n + fmlp::TP - 1) / fmlp::TP;
  fmlp::staged_fwd_kernel<<<(unsigned)blocks, fmlp::THREADS,
                            fmlp::STAGED_FWD_SMEM, stream>>>(
      pts, vb, n, S, P, C, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
