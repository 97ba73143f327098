// Device code shared by K1/K2 (fused_mlp_fwd.cu, fused_mlp_bwd.cu) and
// K3/K4 (staged_mlp_fwd.cu, staged_mlp_bwd.cu): the packed weight layout,
// the in-block positional encoding, and the register-blocked layer product
// all four kernels are built from.
//
// Layout of a block's tile: TP = 64 points. Activations live in shared
// memory feature-major, [feature][point], one row per feature with a row
// stride of LDA = TP + 4 floats, in ONE buffer H: a layer keeps its outputs
// in registers until every thread has read its inputs (a barrier), then
// overwrites them, so a block needs 97,920 B and two blocks fit on an SM.
// A layer product out[o][p] = sum_i W[i][o] * a[i][p] is computed by 256
// threads: thread t owns outputs o = og + 32*k (og = t % 32, k < OT) for
// points pg*8 .. pg*8+7 (pg = t / 32). A warp therefore reads one
// contiguous 1 KB run of weights per input row (coalesced, from L2) and one
// broadcast float4 pair of activations; the +4 row padding makes its float4
// stores of 8 consecutive rows conflict-free.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int G_PAD = 8;       // cotangent rows (C + 1 <= 8)
constexpr int TP = 64;         // points per block
constexpr int LDA = TP + 4;    // shared-memory row stride (floats)
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;  // __launch_bounds__ of K1, K2's passes
constexpr int PT = 8;          // points per thread in a layer product
constexpr int BANDS = L_PTS + L_VIEWS;

// shared memory of one block: H (256 rows), PE (64), VPE (32), G (8);
// 97,920 bytes
constexpr int SMEM_FLOATS = (WIDTH + PE_PAD + VPE_PAD + G_PAD) * LDA;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

// Offsets (floats) into the packed weight vector: every matrix in its
// (fan_in, fan_out) row-major orientation, matrices first so each starts
// 16-byte aligned; the six matrices mm_acc reads (w0, wh, w5pe, wf, wfv,
// wvpe) have interleaved columns (see mm_acc). Mirrored by ops/fused_mlp.py
// `_layout`, checked against fused_mlp_layout() / staged_mlp_layout() when
// the library loads. view_pe = false is the layout of K3/K4, whose views
// layer adds a per-ray bias computed outside (vb = vpe @ w_pe + b): the
// view-encoding weights wvpe and their bias bv are then empty.
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

// Offsets into the transposed weight vector K2 and K4 use for their
// data-gradient products: matrix (I, O) stored as (O, I_pad), I padded to a
// multiple of 4, columns interleaved. view_pe as for `offsets`.
struct TOffsets {
  int64_t whT, w0T, w5peT, wfT, wfvT, wvpeT, waT, wrgbT, total;
};

__host__ __device__ inline TOffsets toffsets(int C, bool view_pe = true) {
  TOffsets o;
  o.whT = 0;
  o.w0T = o.whT + (int64_t)(DEPTH - 1) * WIDTH * WIDTH;
  o.w5peT = o.w0T + WIDTH * PE_PAD;
  o.wfT = o.w5peT + WIDTH * PE_PAD;
  o.wfvT = o.wfT + WIDTH * WIDTH;
  o.wvpeT = o.wfvT + HEAD * WIDTH;
  o.waT = o.wvpeT + (view_pe ? HEAD * VPE_PAD : 0);
  o.wrgbT = o.waT + WIDTH;
  o.total = o.wrgbT + HEAD * C;
  return o;
}

template <int OT>
__device__ __forceinline__ void zero_acc(float (&acc)[OT][PT]) {
#pragma unroll
  for (int k = 0; k < OT; ++k)
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[k][j] = 0.f;
}

// Input rows of a layer product unrolled together (weight loads in
// flight). 16 measured fastest on an H100 (tools/torch_unroll_sweep.py,
// PERF.md), though it makes K1 spill 32 B at 128 registers.
#ifndef FMLP_UNROLL
#define FMLP_UNROLL 16
#endif
constexpr int MM_UNROLL = FMLP_UNROLL;

// acc[k][j] += sum_{i < I} W[i][og + 32 k] * a[i * LDA + pg * PT + j]
// W in global memory (L2-resident) with interleaved columns: W[i][og + 32 k]
// sits at W[i * ldw + og * OT + k], so a thread's OT weights of a row load
// as float4s (float2 / float for OT = 2 / 1). a in shared memory.
template <int OT>
__device__ __forceinline__ void mm_acc(float (&acc)[OT][PT],
                                       const float* __restrict__ W, int ldw,
                                       int I, const float* a, int og, int pg) {
  const float* wp = W + og * OT;
  const float* ap = a + pg * PT;
#pragma unroll MM_UNROLL
  for (int i = 0; i < I; ++i) {
    float w[OT];
    const float* wr = wp + (int64_t)i * ldw;
    if constexpr (OT % 4 == 0) {
#pragma unroll
      for (int q = 0; q < OT / 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(wr) + q);
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
      }
    } else if constexpr (OT == 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(wr));
      w[0] = v.x; w[1] = v.y;
    } else {
#pragma unroll
      for (int k = 0; k < OT; ++k) w[k] = __ldg(wr + k);
    }
    const float4 a0 = *reinterpret_cast<const float4*>(ap + i * LDA);
    const float4 a1 = *reinterpret_cast<const float4*>(ap + i * LDA + 4);
    const float av[PT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int k = 0; k < OT; ++k)
#pragma unroll
      for (int j = 0; j < PT; ++j) acc[k][j] = fmaf(w[k], av[j], acc[k][j]);
  }
}

// rows og + 32 k, columns pg*8 .. pg*8+7 of a shared-memory buffer
template <int OT>
__device__ __forceinline__ void store_smem(float* dst, const float (&v)[OT][PT],
                                           int og, int pg) {
#pragma unroll
  for (int k = 0; k < OT; ++k) {
    float* d = dst + (og + 32 * k) * LDA + pg * PT;
    *reinterpret_cast<float4*>(d) = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
    *reinterpret_cast<float4*>(d + 4) = make_float4(v[k][4], v[k][5], v[k][6], v[k][7]);
  }
}

// the same tile into a feature-major global array G[row][ld] at column col0
template <int OT>
__device__ __forceinline__ void store_global(float* G, int64_t ld, int64_t col0,
                                             const float (&v)[OT][PT], int og,
                                             int pg) {
#pragma unroll
  for (int k = 0; k < OT; ++k) {
    float* d = G + (int64_t)(og + 32 * k) * ld + col0 + pg * PT;
    *reinterpret_cast<float4*>(d) = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
    *reinterpret_cast<float4*>(d + 4) = make_float4(v[k][4], v[k][5], v[k][6], v[k][7]);
  }
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

// The 8-layer ReLU trunk on one tile: h0 = relu(w0^T pe + b0), then
// h_l = relu(wh_l^T h_{l-1} + b_l), each into H; layer SKIP adds w5pe^T pe.
// h7 ends in H. With X non-null, layer l is also written to rows
// x_h + 256 l of the feature-major scratch X (row stride ldx, column col0).
__device__ __forceinline__ void trunk_forward(const float* __restrict__ P,
                                              const Offsets& o, const float* PE,
                                              float* H, float* X, int64_t ldx,
                                              int x_h, int64_t col0) {
  const int og = threadIdx.x % 32, pg = threadIdx.x / 32;
  float acc[8][PT];
  for (int l = 0; l < DEPTH; ++l) {
    zero_acc(acc);
    if (l == 0)
      mm_acc<8>(acc, P + o.w0, WIDTH, PE_ROWS, PE, og, pg);
    else
      mm_acc<8>(acc, P + o.wh + (int64_t)(l - 1) * WIDTH * WIDTH, WIDTH, WIDTH,
                H, og, pg);
    if (l == SKIP) mm_acc<8>(acc, P + o.w5pe, WIDTH, PE_ROWS, PE, og, pg);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float bias = __ldg(P + o.b + l * WIDTH + og + 32 * k);
#pragma unroll
      for (int j = 0; j < PT; ++j) acc[k][j] = fmaxf(acc[k][j] + bias, 0.f);
    }
    if (l > 0) __syncthreads();  // every thread has read h_{l-1}
    store_smem<8>(H, acc, og, pg);
    if (X) store_global<8>(X + (int64_t)(x_h + l * WIDTH) * ldx, ldx, col0, acc, og, pg);
    __syncthreads();
  }
}

// f = wf^T h + bf (no activation): reads h from H, then overwrites H with f
// (the caller synchronizes before reading f)
__device__ __forceinline__ void feature_layer(const float* __restrict__ P,
                                              const Offsets& o, float* H,
                                              float* X, int64_t ldx, int x_f,
                                              int64_t col0) {
  const int og = threadIdx.x % 32, pg = threadIdx.x / 32;
  float acc[8][PT];
  zero_acc(acc);
  mm_acc<8>(acc, P + o.wf, WIDTH, WIDTH, H, og, pg);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float bias = __ldg(P + o.bf + og + 32 * k);
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[k][j] += bias;
  }
  __syncthreads();
  store_smem<8>(H, acc, og, pg);
  if (X) store_global<8>(X + (int64_t)x_f * ldx, ldx, col0, acc, og, pg);
}

// hv = relu(wfv^T f + wvpe^T vpe + bv): reads f from H, then overwrites
// rows 0..127 of H with hv (the caller synchronizes before reading hv)
__device__ __forceinline__ void views_layer(const float* __restrict__ P,
                                            const Offsets& o, float* H,
                                            const float* VPE, float* X,
                                            int64_t ldx, int x_hv,
                                            int64_t col0) {
  const int og = threadIdx.x % 32, pg = threadIdx.x / 32;
  float acc[4][PT];
  zero_acc(acc);
  mm_acc<4>(acc, P + o.wfv, HEAD, WIDTH, H, og, pg);
  mm_acc<4>(acc, P + o.wvpe, HEAD, VPE_ROWS, VPE, og, pg);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float bias = __ldg(P + o.bv + og + 32 * k);
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[k][j] = fmaxf(acc[k][j] + bias, 0.f);
  }
  __syncthreads();
  store_smem<4>(H, acc, og, pg);
  if (X) store_global<4>(X + (int64_t)x_hv * ldx, ldx, col0, acc, og, pg);
}

// K3/K4's views layer: hv = relu(wfv^T f + vb[ray]), with the per-ray view
// bias vb (n / S, 128) = vpe @ w_pe + b computed outside the kernel. Reads
// f from H, then overwrites rows 0..127 of H with hv (the caller
// synchronizes before reading hv). Points past n read ray 0's bias; their
// outputs are never written and their cotangent is zero.
__device__ __forceinline__ void views_layer_vb(const float* __restrict__ P,
                                               const Offsets& o, float* H,
                                               const float* __restrict__ vb,
                                               int64_t n, int S, int64_t p0,
                                               float* X, int64_t ldx,
                                               int x_hv) {
  const int og = threadIdx.x % 32, pg = threadIdx.x / 32;
  float acc[4][PT];
  zero_acc(acc);
  mm_acc<4>(acc, P + o.wfv, HEAD, WIDTH, H, og, pg);
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int64_t p = p0 + pg * PT + j;
    const float* v = vb + (p < n ? p / S : 0) * HEAD + og;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k][j] = fmaxf(acc[k][j] + __ldg(v + 32 * k), 0.f);
  }
  __syncthreads();
  store_smem<4>(H, acc, og, pg);
  if (X) store_global<4>(X + (int64_t)x_hv * ldx, ldx, p0, acc, og, pg);
}

// raw head outputs: out[p][c_out] = bias + sum_i w[i * ldw + col] a[i][p]
// (a = h7 for alpha, hv for rgb); 4 threads per point split the contraction
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
