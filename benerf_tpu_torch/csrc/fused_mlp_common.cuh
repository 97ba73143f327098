// Device code shared by K1/K2 (fused_mlp_fwd.cu, fused_mlp_bwd.cu) and
// K3/K4 (staged_mlp_fwd.cu, staged_mlp_bwd.cu): the network's shape and
// the packed weight layout.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

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
using tc::THREADS;
using tc::TP;

// Offsets (floats) into the packed weight vector: every matrix in its
// (fan_in, fan_out) row-major orientation with its columns in natural
// order, matrices first so each starts 16-byte aligned. Mirrored
// by ops/fused_mlp.py `_layout`, checked against fused_mlp_layout() /
// staged_mlp_layout() when the library loads. view_pe = false is the
// layout of K3/K4, whose views layer adds a per-ray bias computed outside
// (vb = vpe @ w_pe + b): the view-encoding weights wvpe and their bias bv
// are then empty. wrgb starts at the odd offset ba + 1: only the CUDA-core
// heads read it, with plain loads. The layer products read the weights'
// wgmma copies (wgmma_layer.cuh prep_kernel), not this vector.
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

}  // namespace fmlp
