// The matrix products of the weight-gradient pass of K2 and K4 (pass (b),
// fused_mlp_bwd_common.cuh): dW[i][o] = sum_p X[x_row0 + i][p] D[d_row0 + o][p]
// over the points p of one chunk, for every job of the table (K2's 12
// products, K4's 11), one partial per (job, chunk).
//
// Replaces, with the pass: the weight-gradient accumulation of
// benerf_tpu/ops/pallas_mlp_t.py `_bwd_kernel_t` (`outer`, summed in the
// kernel body over the grid) and benerf_tpu/ops/pallas_mlp.py `_bwd_kernel`
// (`mm_tn`).
//
// Bound on an H100: in TF32X3 the operations (592,768 multiply-adds a point
// for K2's 12 products, each done as three TF32 products at 495 TFLOP/s);
// in BF16 the bytes (the fp32 scratch, 19,872 B a point, read once at 3.35
// TB/s).
//
// Design, for Hopper:
//  - both operands are contiguous along the contracted point axis (K-major,
//    the one layout TF32 wgmma takes), so each stage is two plain 2-D TMA
//    boxes of 128 rows x 32 points (128 B a row, 128-byte swizzle) of X and
//    of D, completed on a full mbarrier;
//  - one producer thread keeps a ring of NST stages in flight and two consumer
//    warpgroups (64 output rows each, a 128 x 128 output tile a block) run
//    wgmma.mma_async m64n128 on the stages that have arrived, then free them
//    on an empty mbarrier;
//  - blocks are persistent (one per SM) and walk the (chunk, job tile) work
//    items chunk-major with the o-tiles of one i-tile adjacent, so the
//    blocks that share an X (or a D) tile load it at the same time and all
//    but the first read it from L2;
//  - TF32X3: every fp32 element of a stage is split once, by one consumer
//    thread: big = x rounded to TF32 (cvt.rna, written back in place) and
//    small = x - big (into a buffer beside it, which the tensor core reads
//    with its low 13 bits dropped); each k8 step issues small*big,
//    big*small and big*big into one accumulator. BF16: each element is
//    rounded to bf16 (rn) once into a 64-byte-swizzled tile, one wgmma a
//    k16 step. The split of stage s + 1 runs while stage s's wgmma run
//    (three split buffers);
//  - the tensor core's fp32 accumulation keeps fewer bits than an IEEE add
//    over long sums (PR 3's finding for K1), and a chunk is ~12,000 points
//    deep: every 32-point stage goes into a fresh accumulator (scale-d 0)
//    that the CUDA cores add to an fp32 running sum (64 + 64 registers a
//    thread);
//  - the bias gradients are the sums of D's rows: the thread that splits
//    (or converts) an element of D adds it to its row's fp32 sum, so D is
//    read once for both (a separate pass reading all of D again took ~1.4
//    ms at the fine call);
//  - deterministic: one partial per (job tile, chunk), summed in chunk
//    order by reduce_kernel; no atomics.
// The tensor maps are built on the host with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint (encode_2d, which the layer products of
// wgmma_layer.cuh share): the library links only cudart.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver function is linked
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace fmlp {

constexpr int MAX_JOBS = 16;

// bias_off >= 0: the job's tiles at i0 = 0 also write the sums of its D
// rows over the chunk (a bias gradient) to [bias_off, bias_off + O)
struct GemmJob {
  int x_row0, I, d_row0, O, tiles_o, tile0;
  int64_t out_off, bias_off;
};
struct GemmJobs {
  int count;
  GemmJob j[MAX_JOBS];
};

namespace wg {

constexpr int TILE = 128;                       // output tile, I and O
constexpr int KS = 32;                          // points a stage (128 B of fp32)
constexpr int NST = 4;                          // stages in the TMA ring
constexpr int NAUX = 3;                         // split / bf16 buffers
constexpr int CONSUMERS = 256;                  // two warpgroups
constexpr int THREADS = CONSUMERS + 128;        // and the producer warpgroup
constexpr int OPER_BYTES = TILE * KS * 4;       // one operand of a stage
constexpr int STAGE_BYTES = 2 * OPER_BYTES;     // X rows, then D rows
constexpr size_t SMEM_BYTES =
    1024 + NST * STAGE_BYTES + NAUX * STAGE_BYTES + 2 * NST * 8;  // 230,464

// ---- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// the same where `pred` is nonzero, predicated rather than branched (a
// branch near wgmma in flight serializes them, ptxas C7518)
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, int pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(pred)
      : "memory");
}
// until the phase of parity `parity` has completed. The spin loop stays
// inside the asm: a loop the compiler sees is a divergent path, and wgmma
// in flight across one are serialized (ptxas C7518).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching the accumulators while wgmma own them
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand: rows of the swizzle
// width (128 B: layout 1, 64 B: layout 2), 8-row groups `sbo` bytes apart;
// the leading offset is unused for swizzled K-major layouts.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo,
                                         uint64_t layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)1 << 16 |
         (uint64_t)(sbo >> 4) << 32 | layout << 62;
}

#define WG_R8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D64                                                                 \
  WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40), WG_R8(48), \
      WG_R8(56)
#define WG_REGS                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A B^T for a 64 x 128 tile, A and B K-major in shared memory; d is
// overwritten when scale_d is 0. Thread t of the warpgroup holds
// d[4j + r] at row (t / 32) * 16 + (t % 32) / 4 + 8 (r / 2), column
// 8j + 2 (t % 4) + r % 2.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_REGS
      ", %64, %65, p, 1, 1;\n}\n"
      : WG_D64
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D64
      : "l"(a), "l"(b), "r"(scale_d));
}
#undef WG_REGS
#undef WG_D64
#undef WG_R8

// ---- one stage ---------------------------------------------------------------
//
// Stage layout (TMA, 128-byte swizzle): 256 rows of 128 B, X's 128 then
// D's 128; the 16-byte chunk c of row r sits at r * 128 + (c ^ (r % 8)) * 16.

// TF32X3: big = cvt.rna(x) in place, small = x - big at the same offset of
// `aux`. The split is elementwise, so it keeps the swizzled layout. rs[q]
// sums D row ct / 8 + 32 q (the 8 threads ct / 8 shares split it).
__device__ __forceinline__ void split_stage(float4* st, float4* aux, int ct,
                                            float (&rs)[4]) {
#pragma unroll
  for (int j = 0; j < STAGE_BYTES / 16 / CONSUMERS; ++j) {
    const int e = ct + j * CONSUMERS;
    float4 x = st[e], s;
    if (j >= 4) rs[j - 4] += (x.x + x.y) + (x.z + x.w);
    uint32_t b;
    b = (__float_as_uint(x.x) + 0x1000u) & 0xffffe000u;
    s.x = x.x - __uint_as_float(b); x.x = __uint_as_float(b);
    b = (__float_as_uint(x.y) + 0x1000u) & 0xffffe000u;
    s.y = x.y - __uint_as_float(b); x.y = __uint_as_float(b);
    b = (__float_as_uint(x.z) + 0x1000u) & 0xffffe000u;
    s.z = x.z - __uint_as_float(b); x.z = __uint_as_float(b);
    b = (__float_as_uint(x.w) + 0x1000u) & 0xffffe000u;
    s.w = x.w - __uint_as_float(b); x.w = __uint_as_float(b);
    st[e] = x;
    aux[e] = s;
  }
}

// BF16: the stage rounded to bf16 (rn) into `aux` as 256 rows of 64 B with
// the 64-byte swizzle (chunk c of row r at r * 64 + (c ^ (r / 2 % 4)) * 16):
// each thread converts 8 points of a row at a time. rs[q] sums D row
// ct / 4 + 64 q (the 4 threads ct / 4 shares convert it).
__device__ __forceinline__ void bf16_stage(const float4* st, uint4* aux, int ct,
                                           float (&rs)[4]) {
#pragma unroll
  for (int j = 0; j < 2 * TILE * (KS / 8) / CONSUMERS; ++j) {
    const int e = ct + j * CONSUMERS;
    const int r = e / (KS / 8), q = e % (KS / 8);
    const float4 lo = st[r * 8 + ((2 * q) ^ (r % 8))];
    const float4 hi = st[r * 8 + ((2 * q + 1) ^ (r % 8))];
    if (j >= 2)
      rs[j - 2] += ((lo.x + lo.y) + (lo.z + lo.w)) + ((hi.x + hi.y) + (hi.z + hi.w));
    aux[r * 4 + (q ^ ((r / 2) % 4))] =
        make_uint4(tc::bf16x2(lo.x, lo.y), tc::bf16x2(lo.z, lo.w),
                   tc::bf16x2(hi.x, hi.y), tc::bf16x2(hi.z, hi.w));
  }
}

// the products of one stage for warpgroup `w` (rows w * 64.. of X) into d
template <tc::Mode MODE>
__device__ __forceinline__ void stage_mma(float (&d)[64], uint32_t st,
                                          uint32_t aux, int w) {
  if constexpr (MODE == tc::TF32X3) {
    const uint32_t xa = w * 64 * 128, db = OPER_BYTES;
#pragma unroll
    for (int k = 0; k < KS / 8; ++k) {
      const uint64_t xb = desc(st + xa + k * 32, 1024, 1);
      const uint64_t xs = desc(aux + xa + k * 32, 1024, 1);
      const uint64_t dbig = desc(st + db + k * 32, 1024, 1);
      const uint64_t ds = desc(aux + db + k * 32, 1024, 1);
      wgmma_tf32(d, xs, dbig, k > 0);
      wgmma_tf32(d, xb, ds, 1);
      wgmma_tf32(d, xb, dbig, 1);
    }
  } else {
    const uint32_t xa = w * 64 * 64, db = TILE * 64;
#pragma unroll
    for (int k = 0; k < KS / 16; ++k)
      wgmma_bf16(d, desc(aux + xa + k * 32, 512, 2),
                 desc(aux + db + k * 32, 512, 2), k > 0);
  }
}

// Work item w -> its job, output tile origin, first point and stage count.
struct Item {
  GemmJob J;
  int i0, o0, z, ns;
  int64_t k0;
};
__device__ __forceinline__ Item item(const GemmJobs& jobs, int tiles, int w,
                                     int64_t chunk, int64_t n_pad) {
  Item it;
  it.z = w / tiles;
  const int t = w % tiles;
  int q = 0;
  while (q + 1 < jobs.count && t >= jobs.j[q + 1].tile0) ++q;
  it.J = jobs.j[q];
  it.i0 = ((t - it.J.tile0) / it.J.tiles_o) * TILE;
  it.o0 = ((t - it.J.tile0) % it.J.tiles_o) * TILE;
  it.k0 = (int64_t)it.z * chunk;
  const int64_t k1 = it.k0 + chunk < n_pad ? it.k0 + chunk : n_pad;
  it.ns = k1 > it.k0 ? (int)((k1 - it.k0) / KS) : 0;
  return it;
}

}  // namespace wg

// One persistent block an SM over `tiles` x `splits` work items; the
// partial of item (tile of job J, chunk z) goes to part[z][J.out_off + i O
// + o]. smem: wg::SMEM_BYTES. Chunk ends are multiples of wg::KS.
template <tc::Mode MODE>
__global__ void __launch_bounds__(wg::THREADS, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap dmap, int64_t n_pad,
                   int64_t chunk, int tiles, int splits,
                   float* __restrict__ part, int64_t Ptot, const GemmJobs jobs) {
  using namespace wg;
  extern __shared__ uint8_t wsmem[];
  const uint32_t raw = tc::smem_addr(wsmem);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;  // swizzle atoms: 1 KB
  uint8_t* gring = wsmem + pad;
  uint8_t* gaux = gring + NST * STAGE_BYTES;
  const uint32_t ring = raw + pad, aux = ring + NST * STAGE_BYTES;
  const uint32_t bars = aux + NAUX * STAGE_BYTES;
  auto full = [&](uint32_t s) { return bars + 8 * s; };
  auto empty = [&](uint32_t s) { return bars + 8 * (NST + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int items = tiles * splits;
  // the role, warp-uniform as the compiler can see (a shuffle from lane 0):
  // wgmma under a branch it takes for divergent are serialized (C7518)
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup: one thread issues
    // its registers go to the consumers (168 a thread at launch; 128 x 128
    // given up = 256 x 64 taken: setmaxnreg.inc takes only what dec gave)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != CONSUMERS) return;
    uint32_t it = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const Item m = item(jobs, tiles, w, chunk, n_pad);
      for (int s = 0; s < m.ns; ++s, ++it) {
        const uint32_t slot = it % NST;
        mbar_wait(empty(slot), ((it / NST) & 1) ^ 1);
        mbar_expect_tx(full(slot), STAGE_BYTES);
        const int k = (int)(m.k0 + (int64_t)s * KS);
        const uint32_t dst = ring + slot * STAGE_BYTES;
        tma_load_2d(dst, &xmap, full(slot), k, m.J.x_row0 + m.i0);
        tma_load_2d(dst + OPER_BYTES, &dmap, full(slot), k, m.J.d_row0 + m.o0);
      }
    }
    return;
  }

  // consumers: warpgroup w takes output rows w * 64 .. w * 64 + 63, with
  // the registers the producer gave up
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x, w = ct / 128;
  const int row = (ct % 128) / 32 * 16 + (ct % 32) / 4, col = 2 * (ct % 4);
  uint32_t it = 0;
  for (int item_w = blockIdx.x; item_w < items; item_w += gridDim.x) {
    const Item m = item(jobs, tiles, item_w, chunk, n_pad);
    // both warpgroups multiply whatever their rows hold (rows past J.I are
    // other rows of the scratch, or TMA's zeros, and are not stored): a
    // branch on the warpgroup here would serialize the wgmma (ptxas C7518)
    float acc[64], d[64], rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;
    for (int s = 0; s < m.ns; ++s, ++it) {
      const uint32_t slot = it % NST, ax = it % NAUX;
      mbar_wait(full(slot), (it / NST) & 1);
      if constexpr (MODE == tc::TF32X3) {
        split_stage(reinterpret_cast<float4*>(gring + slot * STAGE_BYTES),
                    reinterpret_cast<float4*>(gaux + ax * STAGE_BYTES), ct, rs);
      } else {
        bf16_stage(reinterpret_cast<const float4*>(gring + slot * STAGE_BYTES),
                   reinterpret_cast<uint4*>(gaux + ax * STAGE_BYTES), ct, rs);
        mbar_arrive(empty(slot));  // wgmma read only the bf16 copy
      }
      fence_proxy_async();  // the generic writes, before wgmma reads them
      consumers_sync();     // every thread's part of the stage is written
      // the previous stage's products (none, d = 0, at s = 0) into acc;
      // no branch on s: see mbar_arrive_if
      wgmma_wait0();
      fence_regs(d);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += d[i];
      if (MODE == tc::TF32X3) mbar_arrive_if(empty((it + NST - 1) % NST), s);
      wgmma_fence();
      stage_mma<MODE>(d, ring + slot * STAGE_BYTES, aux + ax * STAGE_BYTES, w);
      wgmma_commit();
      fence_regs(d);
    }
    wgmma_wait0();
    fence_regs(d);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
    if (MODE == tc::TF32X3) mbar_arrive_if(empty((it + NST - 1) % NST), m.ns);
    float* dst = part + (int64_t)m.z * Ptot + m.J.out_off;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = m.i0 + w * 64 + row + 8 * ((i / 2) % 2);
      const int c = m.o0 + 8 * (i / 4) + col + i % 2;
      if (r < m.J.I && c < m.J.O) dst[(int64_t)r * m.J.O + c] = acc[i];
    }
    // the bias sums: each D row's partials from the lanes that shared it
    constexpr int LANES = MODE == tc::TF32X3 ? 8 : 4;
#pragma unroll
    for (int q = 0; q < LANES / 2; ++q) {  // 128 D rows over 256 / LANES
      float v = rs[q];
#pragma unroll
      for (int l = 1; l < LANES; l <<= 1) v += __shfl_xor_sync(0xffffffffu, v, l);
      const int o = m.o0 + ct / LANES + (CONSUMERS / LANES) * q;
      if (m.J.bias_off >= 0 && m.i0 == 0 && ct % LANES == 0 && o < m.J.O)
        part[(int64_t)m.z * Ptot + m.J.bias_off + o] = v;
    }
  }
}

// ---- host side -----------------------------------------------------------------

// A 2-D tensor map over `rows` rows of `inner` 4-byte elements (row stride
// inner * 4 B, a multiple of 16), box box_inner x box_rows, zero fill past
// the edges. cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint. Returns 0 or a nonzero error.
inline int encode_2d(CUtensorMap* map, const void* base, int64_t inner,
                     int64_t rows, int box_rows, int box_inner,
                     CUtensorMapSwizzle swizzle) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess || !fn)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The scratch's map: `rows` rows of n_pad fp32, box wg::TILE rows x wg::KS
// points, 128-byte swizzle.
inline int encode_map(CUtensorMap* map, const float* base, int64_t n_pad,
                      int64_t rows) {
  return encode_2d(map, base, n_pad, rows, wg::TILE, wg::KS,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// The products of `gj` (tiles numbered, rows within the maps' extents) over
// `splits` chunks of `chunk` points into part; returns the first error.
inline int launch_wgmma(const float* X, const float* D, int64_t n_pad,
                        int64_t chunk, int splits, const GemmJobs& gj,
                        int tiles, float* part, int64_t Ptot, int mode,
                        cudaStream_t stream) {
  int64_t xrows = 0, drows = 0;
  for (int q = 0; q < gj.count; ++q) {
    const GemmJob& k = gj.j[q];
    xrows = xrows > k.x_row0 + k.I ? xrows : k.x_row0 + k.I;
    drows = drows > k.d_row0 + k.O ? drows : k.d_row0 + k.O;
  }
  CUtensorMap xmap, dmap;
  int err = encode_map(&xmap, X, n_pad, xrows);
  if (!err) err = encode_map(&dmap, D, n_pad, drows);
  if (err) return err;
  const int items = tiles * splits;
  const int grid = items < sm_count() ? items : sm_count();
  const int smem = (int)wg::SMEM_BYTES;
  if (mode == tc::TF32X3) {
    cudaFuncSetAttribute(wgrad_wgmma_kernel<tc::TF32X3>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    wgrad_wgmma_kernel<tc::TF32X3><<<grid, wg::THREADS, smem, stream>>>(
        xmap, dmap, n_pad, chunk, tiles, splits, part, Ptot, gj);
  } else {
    cudaFuncSetAttribute(wgrad_wgmma_kernel<tc::BF16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    wgrad_wgmma_kernel<tc::BF16><<<grid, wg::THREADS, smem, stream>>>(
        xmap, dmap, n_pad, chunk, tiles, splits, part, Ptot, gj);
  }
  return (int)cudaGetLastError();
}

}  // namespace fmlp
