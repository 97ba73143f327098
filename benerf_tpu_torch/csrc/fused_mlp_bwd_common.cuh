// Device code shared by the backward kernels K2 (fused_mlp_bwd.cu) and K4
// (staged_mlp_bwd.cu): helpers of the tile pass, and pass (b), the weight
// gradients as deterministic split-K products over a feature-major scratch
// of activations X and pre-activation gradients D (see fused_mlp_bwd.cu).
#pragma once

#include "fused_mlp_common.cuh"

namespace fmlp {

// acc *= (mask > 0) where mask is a feature-major global tile (row r0)
template <int OT>
__device__ __forceinline__ void relu_mask_global(float (&acc)[OT][PT],
                                                 const float* X, int64_t ld,
                                                 int r0, int64_t col0, int og,
                                                 int pg) {
#pragma unroll
  for (int k = 0; k < OT; ++k) {
    const float* m = X + (int64_t)(r0 + og + 32 * k) * ld + col0 + pg * PT;
    const float4 m0 = *reinterpret_cast<const float4*>(m);
    const float4 m1 = *reinterpret_cast<const float4*>(m + 4);
    const float mv[PT] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[k][j] = mv[j] > 0.f ? acc[k][j] : 0.f;
  }
}

// copy `rows` shared-memory rows to the feature-major global scratch
__device__ __forceinline__ void copy_rows(const float* src, int rows, float* G,
                                          int64_t ld, int64_t col0) {
  for (int e = threadIdx.x; e < rows * TP; e += THREADS) {
    const int r = e / TP, c = e % TP;
    G[(int64_t)r * ld + col0 + c] = src[r * LDA + c];
  }
}

// VJP of the encoding for one point: d_enc rows (weighted by band; all ones
// when band is null) back to the 3 input coordinates
__device__ __forceinline__ void encode_bwd(const float* denc, int c, int L,
                                           const float* __restrict__ band,
                                           const float* x3, float* dx) {
  for (int m = 0; m < 3; ++m) {
    const float x = __ldg(x3 + m);
    float s = denc[m * LDA + c];
    for (int k = 0; k < L; ++k) {
      const float f = (float)(1 << k);
      const float b = x * f;
      const float w = band ? __ldg(band + k) : 1.f;
      const float ds = denc[(3 + 6 * k + m) * LDA + c] * w;
      const float dc = denc[(6 + 6 * k + m) * LDA + c] * w;
      s += f * (cosf(b) * ds - sinf(b) * dc);
    }
    dx[m] = s;
  }
}

// ---- pass (b): weight gradients as split-K products ----------------------
//
// dW[i][o] = sum_p X[x_row0 + i][p] * D[d_row0 + o][p] over the points p of
// one chunk z, written to part[z][out_off + i * O + o]. Both operands are
// feature-major, so the contraction runs along contiguous memory.

constexpr int GT = 128;    // output tile of the product kernel (I and O)
constexpr int GK = 16;     // points per shared-memory stage
constexpr int MAX_JOBS = 16;

struct GemmJob {
  int x_row0, I, d_row0, O, tiles_o, tile0;
  int64_t out_off;
};
struct GemmJobs {
  int count;
  GemmJob j[MAX_JOBS];
};

// One block per (128x128 output tile of any job, chunk). 256 threads, each
// an 8x8 register tile: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
// likewise with tx, so a warp's shared-memory reads are broadcasts (X) or
// 16 consecutive float4 (D). Stages of GK points are double-buffered
// through registers: one barrier per stage.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
wgrad_gemm_kernel(const float* __restrict__ X, const float* __restrict__ D,
                  int64_t ld, int64_t chunk, float* __restrict__ part,
                  int64_t Ptot, const GemmJobs jobs) {
  __shared__ __align__(16) float Xs[2][GK][GT + 4];
  __shared__ __align__(16) float Ds[2][GK][GT + 4];
  int q = 0;
  while (q + 1 < jobs.count && (int)blockIdx.x >= jobs.j[q + 1].tile0) ++q;
  const GemmJob J = jobs.j[q];
  const int t = blockIdx.x - J.tile0;
  const int i0 = (t / J.tiles_o) * GT, o0 = (t % J.tiles_o) * GT;
  const int64_t k_begin = (int64_t)blockIdx.y * chunk;
  const int64_t k_end = k_begin + chunk < ld ? k_begin + chunk : ld;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float4 xr[2], dr[2];
  auto load = [&](int64_t k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = threadIdx.x + h * THREADS;  // 512 float4 per operand
      const int r = e >> 2, c4 = e & 3;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      xr[h] = (i0 + r < J.I) ? __ldg(reinterpret_cast<const float4*>(
                  X + (int64_t)(J.x_row0 + i0 + r) * ld + k) + c4) : z;
      dr[h] = (o0 + r < J.O) ? __ldg(reinterpret_cast<const float4*>(
                  D + (int64_t)(J.d_row0 + o0 + r) * ld + k) + c4) : z;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = threadIdx.x + h * THREADS;
      const int r = e >> 2, c = 4 * (e & 3);
      Xs[buf][c][r] = xr[h].x; Xs[buf][c + 1][r] = xr[h].y;
      Xs[buf][c + 2][r] = xr[h].z; Xs[buf][c + 3][r] = xr[h].w;
      Ds[buf][c][r] = dr[h].x; Ds[buf][c + 1][r] = dr[h].y;
      Ds[buf][c + 2][r] = dr[h].z; Ds[buf][c + 3][r] = dr[h].w;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  if (k_begin < k_end) {
    load(k_begin);
    store(0);
  }
  __syncthreads();
  int buf = 0;
  for (int64_t k = k_begin; k < k_end; k += GK) {
    const bool more = k + GK < k_end;
    if (more) load(k + GK);
#pragma unroll
    for (int c = 0; c < GK; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[buf][c][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Xs[buf][c][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ds[buf][c][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ds[buf][c][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  // every product's matrix has interleaved columns in the packed layout:
  // column o at (o % 32) * (O / 32) + o / 32
  float* dst = part + (int64_t)blockIdx.y * Ptot + J.out_off;
  const int ot = J.O / 32;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? ty * 4 + a : 64 + ty * 4 + a - 4);
    if (i >= J.I) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int o = o0 + (b < 4 ? tx * 4 + b : 64 + tx * 4 + b - 4);
      if (o < J.O) dst[(int64_t)i * J.O + (o % 32) * ot + o / 32] = acc[a][b];
    }
  }
}

struct ThinJob {
  int x_row0, I, d_row0, O, out0;  // x_row0 < 0: X is a row of ones (bias)
  int64_t out_off;
};
struct ThinJobs {
  int count, total;
  ThinJob j[MAX_JOBS];
};

// The biases and the 1- and C-column heads: one warp per output element
// (i, o) and chunk, float4 loads along the points, a fixed-order shuffle
// reduction.
__global__ void __launch_bounds__(THREADS)
wgrad_thin_kernel(const float* __restrict__ X, const float* __restrict__ D,
                  int64_t ld, int64_t chunk, float* __restrict__ part,
                  int64_t Ptot, const ThinJobs jobs) {
  const int w = (int)((blockIdx.x * blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (w >= jobs.total) return;
  int q = 0;
  while (q + 1 < jobs.count && w >= jobs.j[q + 1].out0) ++q;
  const ThinJob J = jobs.j[q];
  const int i = (w - J.out0) / J.O, o = (w - J.out0) % J.O;
  const int64_t k_begin = (int64_t)blockIdx.y * chunk;
  const int64_t k_end = k_begin + chunk < ld ? k_begin + chunk : ld;
  const float4* dr = reinterpret_cast<const float4*>(D + (int64_t)(J.d_row0 + o) * ld);
  const float4* xr = J.x_row0 < 0 ? nullptr
      : reinterpret_cast<const float4*>(X + (int64_t)(J.x_row0 + i) * ld);
  float s = 0.f;
  for (int64_t p = k_begin / 4 + lane; p < k_end / 4; p += 32) {
    const float4 d = __ldg(dr + p);
    if (xr) {
      const float4 x = __ldg(xr + p);
      s = fmaf(x.x, d.x, s); s = fmaf(x.y, d.y, s);
      s = fmaf(x.z, d.z, s); s = fmaf(x.w, d.w, s);
    } else {
      s += (d.x + d.y) + (d.z + d.w);
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0)
    part[(int64_t)blockIdx.y * Ptot + J.out_off + (int64_t)i * J.O + o] = s;
}

// out[q] = sum_z part[z][q], z in order
__global__ void reduce_kernel(const float* __restrict__ part, int splits,
                              int64_t Ptot, float* __restrict__ out) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Ptot) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(int64_t)z * Ptot + q];
  out[q] = s;
}

// Fill in each job's tile numbering (GemmJob.tiles_o, .tile0) and each thin
// job's first warp (ThinJob.out0).
inline void number_jobs(GemmJobs* g, ThinJobs* t) {
  int tiles = 0;
  for (int q = 0; q < g->count; ++q) {
    GemmJob& k = g->j[q];
    k.tiles_o = (k.O + GT - 1) / GT;
    k.tile0 = tiles;
    tiles += ((k.I + GT - 1) / GT) * k.tiles_o;
  }
  t->total = 0;
  for (int q = 0; q < t->count; ++q) {
    t->j[q].out0 = t->total;
    t->total += t->j[q].I * t->j[q].O;
  }
}

inline int gemm_tiles(const GemmJobs& g) {
  const GemmJob& l = g.j[g.count - 1];
  return l.tile0 + ((l.I + GT - 1) / GT) * l.tiles_o;
}

// Pass (b): every weight gradient dP (Ptot floats, packed layout) from the
// scratch X, D (row stride n_pad) through `splits` partials `part`.
// Returns the first launch error.
inline int weight_gradients(const float* X, const float* D, int64_t n_pad,
                            int splits, int64_t Ptot, const GemmJobs& gj,
                            const ThinJobs& tj, float* part, float* dP,
                            cudaStream_t stream) {
  int64_t chunk = (n_pad + splits - 1) / splits;
  chunk = (chunk + GK - 1) / GK * GK;
  wgrad_gemm_kernel<<<dim3(gemm_tiles(gj), splits), THREADS, 0, stream>>>(
      X, D, n_pad, chunk, part, Ptot, gj);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int thin_blocks = (tj.total * 32 + THREADS - 1) / THREADS;
  wgrad_thin_kernel<<<dim3(thin_blocks, splits), THREADS, 0, stream>>>(
      X, D, n_pad, chunk, part, Ptot, tj);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(unsigned)((Ptot + 255) / 256), 256, 0, stream>>>(
      part, splits, Ptot, dP);
  return (int)cudaGetLastError();
}

}  // namespace fmlp
