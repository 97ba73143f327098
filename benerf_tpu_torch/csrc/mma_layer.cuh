// Tensor-core layer product for K1-K4 (fused_mlp_{fwd,bwd}.cu,
// staged_mlp_{fwd,bwd}.cu). The weight-gradient pass of K2/K4 has its own
// TMA + wgmma kernel (wgrad_wgmma.cuh).
//
// out[m][p] = sum_k A[m][k] B[k][p] over a block's 64-point tile, on
// mma.sync.aligned m16n8k8 (TF32) or m16n8k16 (BF16) with fp32 accumulators:
//  - A is a weight matrix W (I, O), row-major in the packed vector with its
//    columns in natural order: the forward reads A[m][k] = W[k][m] (m an
//    output feature), the data-gradient products of K2/K4 A[m][k] = W[m][k]
//    (m an input feature, k an output feature: no transposed copy needed);
//  - B is an activation tile in shared memory, feature-major [k][point]
//    with row stride LDA.
// Operand modes (template parameter):
//  - TF32X3: each fp32 operand x splits into big, x rounded to TF32 as
//    cvt.rna does, and small = x - big (which the tensor core reads as
//    TF32, its low 13 bits dropped); the product sums small*big + big*small + big*big in fp32
//    (small*small dropped), which keeps fp32-level accuracy (~1e-6
//    relative) at three TF32 products per step;
//  - BF16: operands rounded to bf16 (cvt.rn) at the fragment load, fp32
//    accumulation, as the JAX kernel's compute_dtype="bfloat16" and the
//    TPU's MXU.
// Both modes keep fp32 in shared memory and in the scratch; only the
// fragments differ.
//
// Weights are staged into shared memory by cp.async (16-byte copies, L2
// only) in a ring of three K-slices of KS = 32 rows (forward, [k][m] with
// row stride LDW) or 32 columns (data gradients, [m][k] with row stride
// LDT); slice s+1 (or the next product's slice 0) is in flight while slice
// s is multiplied. Both strides make every fragment load of a warp hit 32
// distinct banks.
//
// Budget (227 KB = 232,448 B of shared memory a block): a 64-point tile's
// activations (K2: 256 + 64 + 32 + 8 rows x LDA = 103,680 B) plus three
// weight stages (3 x 36,864 B) plus K2's ReLU sign bits (17,408 B) is
// 231,680 B: one block of 8 warps per SM. A 128-point tile would need 207 KB of
// activations alone; 64 points keep the weight stream from L2 at 2.4 MB a
// tile (K1: 15 GB at the fine call, ~3 ms of L2 bandwidth).
//
// Warp tiling of an M x 64 product: WM x WN warps, each MT m-tiles of 16
// features by NT n-tiles of 8 points; M = 256: 4 x 2 warps, 4 x 4 tiles
// (64 accumulators a thread). A thread owns, for tile (mt, nt) and
// register r, feature row(mt, r) and point col(nt, r) below: the forward
// layer l and the backward product for d h_l use the same (M = 256 or 128)
// configuration, so the ReLU signs kept in the forward sit at the very
// positions the backward needs them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

enum Mode { TF32X3 = 0, BF16 = 1 };

constexpr int TP = 64;              // points per tile
constexpr int LDA = TP + 8;         // activation row stride (floats)
constexpr int THREADS = 256;
constexpr int KS = 32;              // weight rows (or columns) per stage
constexpr int LDW = 256 + 8;        // forward stage row stride: [k][m]
constexpr int LDT = KS + 4;         // data-gradient stage row stride: [m][k]
constexpr int STAGE_FLOATS = 256 * LDT;  // >= KS * LDW
constexpr int NSTAGES = 3;
constexpr size_t STAGES_BYTES = NSTAGES * STAGE_FLOATS * sizeof(float);

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; bytes = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>  // at most N groups still in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The TF32X3 split, on full-rate integer and fp32 pipes: TF32X3 is bound by
// instruction issue, and the conversion pipe that cvt runs on is the
// narrowest (each cvt this split dropped made K1 ~8% faster, PERF.md).
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

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- one warp's k-step over its MT x NT tiles -----------------------------
//
// A(m, k) and B(k, n) are functors returning fp32 from shared memory (m, n
// relative to the warp's tile origin, k to the step's). TF32 (k = 8):
// a = {A(g, t), A(g+8, t), A(g, t+4), A(g+8, t+4)}, b = {B(t, g),
// B(t+4, g)}; BF16 (k = 16): a = {A(g, 2t..2t+1), A(g+8, 2t..),
// A(g, 2t+8..), A(g+8, 2t+8..)}, b = {B(2t..2t+1, g), B(2t+8..2t+9, g)};
// g = lane / 4, t = lane % 4.
template <Mode MODE>
struct Step {
  static constexpr int K = MODE == TF32X3 ? 8 : 16;
};

// The B fragments of the step are loaded first, then one m-tile's A
// fragment at a time (fewer live registers).
template <Mode MODE, int MT, int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_step(float (&acc)[MT][NT][4], FA A, FB B,
                                          int g, int t) {
  if constexpr (MODE == TF32X3) {
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      split(B(t, nt * 8 + g), bb[nt][0], bs[nt][0]);
      split(B(t + 4, nt * 8 + g), bb[nt][1], bs[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t ab[4], as[4];
      split(A(mt * 16 + g, t), ab[0], as[0]);
      split(A(mt * 16 + g + 8, t), ab[1], as[1]);
      split(A(mt * 16 + g, t + 4), ab[2], as[2]);
      split(A(mt * 16 + g + 8, t + 4), ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(acc[mt][nt], as, bb[nt]);
        mma_tf32(acc[mt][nt], ab, bs[nt]);
        mma_tf32(acc[mt][nt], ab, bb[nt]);
      }
    }
  } else {
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g;
      b[nt][0] = bf16x2(B(2 * t, n), B(2 * t + 1, n));
      b[nt][1] = bf16x2(B(2 * t + 8, n), B(2 * t + 9, n));
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = mt * 16 + g;
      const uint32_t a[4] = {bf16x2(A(m, 2 * t), A(m, 2 * t + 1)),
                             bf16x2(A(m + 8, 2 * t), A(m + 8, 2 * t + 1)),
                             bf16x2(A(m, 2 * t + 8), A(m, 2 * t + 9)),
                             bf16x2(A(m + 8, 2 * t + 8), A(m + 8, 2 * t + 9))};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
    }
  }
}

// ---- the tile product --------------------------------------------------------

// Warp tiling of an M x TP product with MT m-tiles a warp.
template <int M, int MT>
struct Tiling {
  static constexpr int WM = M / (16 * MT);     // warps along features
  static constexpr int WN = (THREADS / 32) / WM;
  static constexpr int NT = TP / (8 * WN);     // n-tiles a warp
  static_assert(WM * WN == THREADS / 32 && NT * 8 * WN == TP, "tiling");
  // feature row / point column of acc[mt][nt][r] for this thread
  __device__ static int row(int mt, int r) {
    const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4;
    return (w % WM) * MT * 16 + mt * 16 + g + (r >= 2 ? 8 : 0);
  }
  __device__ static int col(int nt, int r) {
    const int w = threadIdx.x / 32, t = threadIdx.x % 4;
    return (w / WM) * NT * 8 + nt * 8 + 2 * t + (r & 1);
  }
};

// A weight matrix as one product reads it: W (I, O) row-major in global
// memory (16-byte aligned, O a multiple of 4). trans = false: the forward,
// A[m][k] = W[k][m], K = I (rows past I read as 0); trans = true: a data
// gradient, A[m][k] = W[m][k], K = O, M = the padded I (rows past I read
// as 0).
struct WSrc {
  const float* W;
  int I, O;
  bool trans;
  __device__ int k_len() const { return trans ? O : I; }
};

// Issue the cp.async copies of slice s of w into stage buffer dst.
__device__ __forceinline__ void issue_slice(const WSrc& w, int s, float* dst) {
  const int k0 = s * KS;
  if (!w.trans) {
    const int sh = 31 - __clz(w.O / 4);  // 16-byte chunks a row: O / 4, a power of 2
    for (int e = threadIdx.x; e < (KS << sh); e += THREADS) {
      const int r = e >> sh, c = (e & ((1 << sh) - 1)) * 4;
      const bool in = k0 + r < w.I;
      cp_async16(dst + r * LDW + c, in ? w.W + (int64_t)(k0 + r) * w.O + c : w.W,
                 in ? 16 : 0);
    }
  } else {
    const int rows = (w.I + 15) / 16 * 16;
    for (int e = threadIdx.x; e < rows * (KS / 4); e += THREADS) {
      const int r = e / (KS / 4), c = (e % (KS / 4)) * 4;
      const bool in = r < w.I && k0 + c < w.O;
      cp_async16(dst + r * LDT + c, in ? w.W + (int64_t)r * w.O + k0 + c : w.W,
                 in ? 16 : 0);
    }
  }
}

// The weight stream: a ring of NSTAGES stage buffers in shared memory and
// the count of slices consumed. Invariant between products: slice 0 of the
// next product has been issued into cur(). Slice s + 1 is issued into the
// buffer slice s - 2 was read from, which every warp has left once it has
// passed slice s - 1's barrier: one barrier a slice.
struct Pipe {
  float* buf;
  int stage;
  __device__ float* cur() const { return buf + (stage % NSTAGES) * STAGE_FLOATS; }
  __device__ float* other() const {
    return buf + ((stage + 1) % NSTAGES) * STAGE_FLOATS;
  }
  __device__ void start(const WSrc& first) {
    issue_slice(first, 0, cur());
    cp_async_commit();
  }
};

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][b][r] = 0.f;
}

// acc += part, in fp32 on the CUDA cores. The tensor cores' own fp32
// accumulation keeps fewer bits than an IEEE add (its error grows with the
// number of mma a sum goes through: K1's outputs ~4e-6 x scale off float64
// when a 256-deep sum stays in the tensor cores, ~4e-7 in a plain torch
// emulation with IEEE adds), so every product sums one stage (32 deep) in
// a fresh accumulator and adds it here.
template <int MT, int NT>
__device__ __forceinline__ void promote(float (&acc)[MT][NT][4],
                                        const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][b][r] += part[a][b][r];
}

// one stage's KS rows of the product (ws: the stage, bs: B at the stage's
// first row and the warp's first point), promoted into acc
template <Mode MODE, bool TRANS, int MT, int NT>
__device__ __forceinline__ void stage_mma(float (&acc)[MT][NT][4],
                                          const float* ws, const float* bs,
                                          int m0, int g, int t) {
  float part[MT][NT][4];
  zero(part);
#pragma unroll
  for (int kk = 0; kk < KS; kk += Step<MODE>::K) {
    auto B = [&](int k, int n) { return bs[(kk + k) * LDA + n]; };
    auto A = [&](int m, int k) {
      return TRANS ? ws[(m0 + m) * LDT + kk + k] : ws[(kk + k) * LDW + m0 + m];
    };
    warp_step<MODE>(part, A, B, g, t);
  }
  promote(acc, part);
}

// acc (+)= A B for the M x TP tile; `act` is B ([k][point], row stride
// LDA, at least the slices' rows), `next` the product that follows (its
// slice 0 is issued during the last slice), or null. Ends with a barrier:
// every thread has read `act`, so the caller may overwrite it.
template <Mode MODE, int M, int MT>
__device__ __forceinline__ void product(float (&acc)[MT][Tiling<M, MT>::NT][4],
                                        const WSrc& w, const float* act,
                                        Pipe& pipe, const WSrc* next) {
  using T = Tiling<M, MT>;
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = (wid % T::WM) * MT * 16, n0 = (wid / T::WM) * T::NT * 8;
  const int ns = (w.k_len() + KS - 1) / KS;
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns)
      issue_slice(w, s + 1, pipe.other());
    else if (next)
      issue_slice(*next, 0, pipe.other());
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* bs = act + (s * KS) * LDA + n0;
    if (w.trans)
      stage_mma<MODE, true>(acc, pipe.cur(), bs, m0, g, t);
    else
      stage_mma<MODE, false>(acc, pipe.cur(), bs, m0, g, t);
    ++pipe.stage;
  }
  __syncthreads();
}

// Epilogue helpers over a thread's fragment elements (feature rows < M).

// acc += bias[row]; with relu, acc = max(acc, 0)
template <int M, int MT, int NT>
__device__ __forceinline__ void bias_act(float (&acc)[MT][NT][4],
                                         const float* __restrict__ bias,
                                         bool relu) {
  using T = Tiling<M, MT>;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float b0 = __ldg(bias + T::row(mt, 0)), b1 = __ldg(bias + T::row(mt, 2));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = acc[mt][nt][r] + (r < 2 ? b0 : b1);
        acc[mt][nt][r] = relu ? fmaxf(v, 0.f) : v;
      }
  }
}

// rows [0, rows) of the tile to shared memory (row stride LDA)
template <int M, int MT, int NT>
__device__ __forceinline__ void store_tile(float* dst, const float (&acc)[MT][NT][4],
                                           int rows = M) {
  using T = Tiling<M, MT>;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = T::row(mt, 2 * h);
        if (r < rows)
          *reinterpret_cast<float2*>(dst + r * LDA + T::col(nt, 0)) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

// dst += the tile, at the positions store_tile<M> writes (the thread's own)
template <int M, int MT, int NT>
__device__ __forceinline__ void add_tile(float* dst, const float (&acc)[MT][NT][4]) {
  using T = Tiling<M, MT>;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* d = reinterpret_cast<float2*>(dst + T::row(mt, 2 * h) * LDA +
                                              T::col(nt, 0));
        const float2 v = *d;
        *d = make_float2(v.x + acc[mt][nt][2 * h], v.y + acc[mt][nt][2 * h + 1]);
      }
}

// the same tile into a feature-major global array G[row][ld] at column col0
template <int M, int MT, int NT>
__device__ __forceinline__ void store_tile_global(float* G, int64_t ld,
                                                  int64_t col0,
                                                  const float (&acc)[MT][NT][4]) {
  using T = Tiling<M, MT>;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(G + (int64_t)T::row(mt, 2 * h) * ld + col0 +
                                   T::col(nt, 0)) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// ReLU signs of a tile's fragments as bits, one word per 32 elements, kept
// in shared memory word-major ([word][thread]: conflict-free)
template <int MT, int NT>
__device__ __forceinline__ void save_signs(uint32_t* masks,
                                           const float (&acc)[MT][NT][4]) {
  constexpr int MW = (MT * NT * 4 + 31) / 32;
  uint32_t w[MW] = {};
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = (mt * NT + nt) * 4 + r;
        if (acc[mt][nt][r] > 0.f) w[i / 32] |= 1u << (i % 32);
      }
#pragma unroll
  for (int q = 0; q < MW; ++q) masks[q * THREADS + threadIdx.x] = w[q];
}

// acc *= (saved sign > 0)
template <int MT, int NT>
__device__ __forceinline__ void apply_signs(float (&acc)[MT][NT][4],
                                            const uint32_t* masks) {
  constexpr int MW = (MT * NT * 4 + 31) / 32;
  uint32_t w[MW];
#pragma unroll
  for (int q = 0; q < MW; ++q) w[q] = masks[q * THREADS + threadIdx.x];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = (mt * NT + nt) * 4 + r;
        if (!((w[i / 32] >> (i % 32)) & 1u)) acc[mt][nt][r] = 0.f;
      }
}

}  // namespace tc
