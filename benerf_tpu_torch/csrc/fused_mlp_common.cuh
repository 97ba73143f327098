// Device code shared by K1/K2 (fused_mlp_fwd.cu, fused_mlp_bwd.cu) and
// K3/K4 (staged_mlp_fwd.cu, staged_mlp_bwd.cu): the packed weight layout,
// the in-block positional encoding and the CUDA-core heads, on a tile's
// activations in shared memory, feature-major [feature][point] with the row
// stride of the tensor-core layout (mma_layer.cuh's tc::LDA).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_layer.cuh"

namespace fmlp {

constexpr int WIDTH = 256;
constexpr int HEAD = 128;
constexpr int DEPTH = 8;
constexpr int SKIP = 5;        // layer that adds w5pe^T pe
constexpr int L_PTS = 10;
constexpr int L_VIEWS = 4;
constexpr int PE_ROWS = 63;    // 3 * (2 * L_PTS + 1)
constexpr int PE_PAD = 64;
constexpr int VPE_ROWS = 27;   // 3 * (2 * L_VIEWS + 1)
constexpr int VPE_PAD = 32;
constexpr int G_PAD = 8;       // K2's cotangent rows (C + 1 <= 8)
using tc::LDA;
using tc::THREADS;
using tc::TP;

// Offsets (floats) into the packed weight vector: every matrix in its
// (fan_in, fan_out) row-major orientation with its columns in natural
// order, matrices first so each starts 16-byte aligned (cp.async). Mirrored
// by ops/fused_mlp.py `_layout`, checked against fused_mlp_layout() /
// staged_mlp_layout() when the library loads. view_pe = false is the
// layout of K3/K4, whose views layer adds a per-ray bias computed outside
// (vb = vpe @ w_pe + b): the view-encoding weights wvpe and their bias bv
// are then empty. wrgb starts at the odd offset ba + 1: only the CUDA-core
// heads read it, with plain loads.
struct Offsets {
  int64_t w0, wh, w5pe, wf, wfv, wvpe, b, bf, bv, wa, ba, wrgb, brgb, total;
};

__host__ __device__ inline Offsets offsets(int C, bool view_pe = true) {
  Offsets o;
  o.w0 = 0;
  o.wh = o.w0 + PE_ROWS * WIDTH;
  o.w5pe = o.wh + (int64_t)(DEPTH - 1) * WIDTH * WIDTH;
  o.wf = o.w5pe + PE_ROWS * WIDTH;
  o.wfv = o.wf + WIDTH * WIDTH;
  o.wvpe = o.wfv + WIDTH * HEAD;
  o.b = o.wvpe + (view_pe ? VPE_ROWS * HEAD : 0);
  o.bf = o.b + DEPTH * WIDTH;
  o.bv = o.bf + WIDTH;
  o.wa = o.bv + (view_pe ? HEAD : 0);
  o.ba = o.wa + WIDTH;
  o.wrgb = o.ba + 1;
  o.brgb = o.wrgb + HEAD * C;
  o.total = o.brgb + C;
  return o;
}

// Positional encodings of the block's points into PE (64 rows) and VPE
// (32 rows), row order [x, sin(f0 x), cos(f0 x), sin(f1 x), ...] with
// fk = 2^k, band rows times band[k] (BARF weights; all ones when band is
// null), pad rows and points past n zero. pts (n, 3); vd (n / S, 3): a
// point's view direction is its ray's. With vd null only PE is written.
__device__ __forceinline__ void encode_tile(const float* __restrict__ pts,
                                            const float* __restrict__ vd,
                                            int64_t n, int S,
                                            const float* __restrict__ band,
                                            int64_t p0, float* PE, float* VPE) {
  const int all_rows = vd ? PE_PAD + VPE_PAD : PE_PAD;
  for (int e = threadIdx.x; e < all_rows * TP; e += THREADS) {
    const int row = e / TP, c = e % TP;
    const int64_t p = p0 + c;
    const bool views = row >= PE_PAD;
    const int r = views ? row - PE_PAD : row;
    const int rows = views ? VPE_ROWS : PE_ROWS;
    float v = 0.f;
    if (p < n && r < rows) {
      const float* src = views ? vd + (p / S) * 3 : pts + p * 3;
      if (r < 3) {
        v = __ldg(src + r);
      } else {
        const int k = (r - 3) / 6, m = (r - 3) % 6;
        const float x = __ldg(src + (m % 3)) * (float)(1 << k);
        v = m < 3 ? sinf(x) : cosf(x);
        if (band) v *= __ldg(band + (views ? L_PTS : 0) + k);
      }
    }
    (views ? VPE : PE)[r * LDA + c] = v;
  }
}

// raw head outputs: out[p][c_out] = bias + sum_i w[i * ldw + col] a[i][p]
// (a = h7 for alpha, hv for rgb); 4 threads per point split the
// contraction. fp32 on the CUDA cores in both modes.
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

}  // namespace fmlp
