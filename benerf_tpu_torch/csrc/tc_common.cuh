// What the tensor-core code of K1-K4 shares: the two operand modes and the
// conversions both engines use (the layer products, wgmma_layer.cuh; the
// weight-gradient pass, wgrad_wgmma.cuh).
//  - TF32X3: each fp32 operand x splits into big, x rounded to TF32 as
//    cvt.rna does, and small = x - big (which the tensor core reads as
//    TF32, its low 13 bits dropped); a product sums small*big + big*small +
//    big*big in fp32 (small*small dropped), which keeps fp32-level accuracy
//    (~1e-6 relative) at three TF32 products per step;
//  - BF16: operands rounded to bf16 (cvt.rn), fp32 accumulation, as the
//    JAX kernel's compute_dtype="bfloat16" and the TPU's MXU.
// Both modes keep fp32 in shared memory; only the operands the tensor core
// reads differ, and so does the backward's scratch, which BF16 stores as
// the bf16 operands its products read (fused_mlp_bwd_common.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

enum Mode { TF32X3 = 0, BF16 = 1 };

constexpr int TP = 64;              // points per tile
constexpr int THREADS = 256;        // CUDA-core helper kernels' block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The TF32X3 split on integer and fp32 pipes (cvt runs on the narrowest):
// big: the bits of cvt.rna.tf32.f32 (round half away, low 13 bits zero);
// small: an fp32 bit pattern whose top 19 bits the tensor core reads
// (|small| <= 2^-11 |x|, so what it drops is below 2^-21 |x|).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tc
