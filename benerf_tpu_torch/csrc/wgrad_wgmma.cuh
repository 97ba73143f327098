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
// in BF16 the bytes: the scratch's bf16 product rows (K2: 2,400 X + 2,432 D
// rows, 9,664 B a point), the fp32 rows the thin jobs read (392 at C = 3,
// 1,568 B) and the tile sums of D (152 B), 11,384 B a point read once at
// 3.35 TB/s (an fp32 scratch would be 19,872 B). Each X tile is read by
// two jobs' o-tiles and each D tile by two i-tiles, from L2 when their
// blocks run close together; with every product on the same rows (all L2)
// the pass ran 1.6x faster at the fine call.
//
// Design, for Hopper:
//  - both operands are contiguous along the contracted point axis (K-major,
//    the one layout TF32 wgmma takes), so each stage is TMA boxes of 128
//    rows x 128 B of points of X and of D (128-byte swizzle), completed on
//    a full mbarrier: TF32X3 two 2-D boxes of 32 fp32 points from rows
//    n_pad apart; BF16 (B_KS / 64) x two 3-D boxes of one tile's 64 bf16
//    points, each 16 KB contiguous in the tile-blocked scratch (64-point
//    rows 782 KB apart, at the fine call, ran the pass at ~1.5 TB/s);
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
//    big*small and big*big into one accumulator. The split of stage s + 1
//    runs while stage s's wgmma run (three split buffers). BF16: the tile
//    pass rounded each element to bf16 (rn) as it stored it, so wgmma read
//    the stage as TMA left it, one wgmma a k16 step: no conversion, no
//    buffers beside the ring (three stages of 128 points, 66 KB each);
//  - the tensor core's fp32 accumulation keeps fewer bits than an IEEE add
//    over long sums (PR 3's finding for K1), and a chunk is ~12,000 points
//    deep: every stage (TF32X3 32 points, BF16 128, whose products of bf16
//    operands are exact in fp32) goes into a fresh accumulator (scale-d 0)
//    that the CUDA cores add to an fp32 running sum (64 + 64 registers a
//    thread);
//  - the bias gradients are the sums of D's rows: TF32X3: the thread that
//    splits an element of D adds it to its row's fp32 sum, so D is read
//    once for both (a separate pass reading all of D again took ~1.4 ms at
//    the fine call). BF16: the tile pass summed each row's fp32 values a
//    64-point tile, and a bias job's stages bring those of their tiles
//    (one bulk copy of 512 B a tile, on the stage's full barrier), which a
//    consumer thread of the first warpgroup adds in tile order from shared
//    memory (loaded from global memory into registers, they held every
//    stage at its wgmma fence: +32% on the pass);
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
constexpr int KS = 32;                          // points a stage
constexpr int NST = 4;                          // stages in the TMA ring
constexpr int NAUX = 3;                         // TF32X3's split buffers
constexpr int CONSUMERS = 256;                  // two warpgroups
constexpr int THREADS = CONSUMERS + 128;        // and the producer warpgroup
constexpr int OPER_BYTES = TILE * KS * 4;       // one operand of a stage
constexpr int STAGE_BYTES = 2 * OPER_BYTES;     // X rows, then D rows
constexpr size_t SMEM_BYTES =
    1024 + NST * STAGE_BYTES + NAUX * STAGE_BYTES + 2 * NST * 8;  // 230,464
// BF16: stages of B_KS points of the scratch's bf16 rows, a TMA box a tile
// of the tile pass (B_BOX points, 128 B a row, the 128-byte swizzle), X's
// boxes then D's, then a bias job's tile sums of the stage's tiles (TILE
// floats a tile)
constexpr int B_KS = 128;
constexpr int B_BOX = tc::TP;
constexpr int B_BOX_BYTES = TILE * B_BOX * 2;
constexpr int B_OPER_BYTES = TILE * B_KS * 2;
constexpr int B_TILES = B_KS / B_BOX;          // tiles a stage
constexpr int B_SUM_BYTES = TILE * 4;          // a tile's sums of 128 D rows
constexpr int B_STAGE_BYTES = 2 * B_OPER_BYTES + B_TILES * B_SUM_BYTES;
constexpr int B_NST = 3;
constexpr size_t B_SMEM_BYTES = 1024 + B_NST * B_STAGE_BYTES + 2 * B_NST * 8;  // 200,752
constexpr int BIAS_ROWS = 2432;                 // D rows with a tile sum

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
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// `bytes` (a multiple of 16) from global src to shared dst, completed on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

// the products of one stage for warpgroup `w` (rows w * 64.. of X) into d;
// BF16 reads the stage at `aux` (st unused)
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
  } else {  // the stage's boxes, 128-byte rows: 8-row groups 1 KB apart
    const uint32_t xa = w * 64 * 128;
#pragma unroll
    for (int b = 0; b < B_KS / B_BOX; ++b)
#pragma unroll
      for (int k = 0; k < B_BOX / 16; ++k)
        wgmma_bf16(d, desc(aux + b * B_BOX_BYTES + xa + k * 32, 1024, 1),
                   desc(aux + B_OPER_BYTES + b * B_BOX_BYTES + k * 32, 1024, 1),
                   b + k > 0);
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

// An item's stages in BF16, of B_KS points: the last may pass n_pad (TMA
// fills zeros)
__device__ __forceinline__ int b_stages(const Item& m) {
  return (m.ns * KS + B_KS - 1) / B_KS;
}

}  // namespace wg

// One persistent block an SM over `tiles` x `splits` work items; the
// partial of item (tile of job J, chunk z) goes to part[z][J.out_off + i O
// + o]. smem: wg::SMEM_BYTES (BF16: wg::B_SMEM_BYTES). Chunk ends are
// multiples of wg::KS (BF16: wg::B_KS). bsum: BF16's tile sums of D
// ([tile][BIAS_ROWS]); unused in TF32X3.
template <tc::Mode MODE>
__global__ void __launch_bounds__(wg::THREADS, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap dmap, int64_t n_pad,
                   int64_t chunk, int tiles, int splits,
                   float* __restrict__ part, int64_t Ptot, const GemmJobs jobs,
                   const float* __restrict__ bsum) {
  using namespace wg;
  constexpr bool B = MODE == tc::BF16;
  constexpr int NS = B ? B_NST : NST;                 // ring stages
  constexpr int SB = B ? B_STAGE_BYTES : STAGE_BYTES;  // a stage's bytes
  extern __shared__ uint8_t wsmem[];
  const uint32_t raw = tc::smem_addr(wsmem);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;  // swizzle atoms: 1 KB
  uint8_t* gring = wsmem + pad;
  uint8_t* gaux = gring + NS * SB;
  const uint32_t ring = raw + pad, aux = ring + NS * SB;
  const uint32_t bars = aux + (B ? 0 : NAUX * STAGE_BYTES);
  auto full = [&](uint32_t s) { return bars + 8 * s; };
  auto empty = [&](uint32_t s) { return bars + 8 * (NS + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
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
      const int ns = B ? b_stages(m) : m.ns;
      const bool bias = m.J.bias_off >= 0 && m.i0 == 0;
      for (int s = 0; s < ns; ++s, ++it) {
        const uint32_t slot = it % NS;
        mbar_wait(empty(slot), ((it / NS) & 1) ^ 1);
        if constexpr (B) {  // a box a tile of the tile-blocked scratch
          const uint32_t dst = ring + slot * SB;
          const int t = (int)((m.k0 + (int64_t)s * B_KS) / B_BOX);
          int sums = 0;  // the stage's tiles (before n_pad) of a bias job
          for (int q = 0; bias && q < B_TILES; ++q)
            sums += (int64_t)(t + q) * B_BOX < n_pad;
          mbar_expect_tx(full(slot), 2 * B_OPER_BYTES + sums * B_SUM_BYTES);
          for (int b = 0; b < B_KS / B_BOX; ++b) {
            tma_load_3d(dst + b * B_BOX_BYTES, &xmap, full(slot), 0,
                        m.J.x_row0 + m.i0, t + b);
            tma_load_3d(dst + B_OPER_BYTES + b * B_BOX_BYTES, &dmap, full(slot), 0,
                        m.J.d_row0 + m.o0, t + b);
          }
          for (int q = 0; q < sums; ++q)
            bulk_load(dst + 2 * B_OPER_BYTES + q * B_SUM_BYTES,
                      bsum + (int64_t)(t + q) * wg::BIAS_ROWS + m.J.d_row0 + m.o0,
                      B_SUM_BYTES, full(slot));
        } else {
          mbar_expect_tx(full(slot), SB);
          const int k = (int)(m.k0 + (int64_t)s * KS);
          const uint32_t dst = ring + slot * SB;
          tma_load_2d(dst, &xmap, full(slot), k, m.J.x_row0 + m.i0);
          tma_load_2d(dst + OPER_BYTES, &dmap, full(slot), k, m.J.d_row0 + m.o0);
        }
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
    // BF16: a bias job's first i-tile adds its D rows' tile sums, which
    // came with each stage, in tile order (the first warpgroup's threads;
    // the others add and drop them)
    const bool bias = m.J.bias_off >= 0 && m.i0 == 0;
    const bool brow = bias && ct < TILE && m.o0 + ct < m.J.O;
    if constexpr (B) {
      for (int s = 0; s < b_stages(m); ++s, ++it) {
        const uint32_t slot = it % NS;
        mbar_wait(full(slot), (it / NS) & 1);
        // the previous stage's products (none, d = 0, at s = 0) into acc,
        // then its slot back to the producer; no branch on s: see
        // mbar_arrive_if
        wgmma_wait0();
        fence_regs(d);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += d[i];
        mbar_arrive_if(empty((it + NS - 1) % NS), s);
        if (bias) {  // no wgmma in flight here: a branch is free
          const float* sums = reinterpret_cast<const float*>(
              gring + slot * SB + 2 * B_OPER_BYTES) + ct % TILE;
          const int64_t t = (m.k0 + (int64_t)s * B_KS) / B_BOX;
          for (int q = 0; q < B_TILES && (t + q) * B_BOX < n_pad; ++q)
            rs[0] += sums[q * TILE];
        }
        wgmma_fence();
        stage_mma<MODE>(d, 0, ring + slot * SB, w);
        wgmma_commit();
        fence_regs(d);
      }
    } else {
      for (int s = 0; s < m.ns; ++s, ++it) {
        const uint32_t slot = it % NST, ax = it % NAUX;
        mbar_wait(full(slot), (it / NST) & 1);
        split_stage(reinterpret_cast<float4*>(gring + slot * STAGE_BYTES),
                    reinterpret_cast<float4*>(gaux + ax * STAGE_BYTES), ct, rs);
        fence_proxy_async();  // the generic writes, before wgmma reads them
        consumers_sync();     // every thread's part of the stage is written
        // the previous stage's products (none, d = 0, at s = 0) into acc;
        // no branch on s: see mbar_arrive_if
        wgmma_wait0();
        fence_regs(d);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += d[i];
        mbar_arrive_if(empty((it + NST - 1) % NST), s);
        wgmma_fence();
        stage_mma<MODE>(d, ring + slot * STAGE_BYTES, aux + ax * STAGE_BYTES, w);
        wgmma_commit();
        fence_regs(d);
      }
    }
    wgmma_wait0();
    fence_regs(d);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
    mbar_arrive_if(empty((it + NS - 1) % NS), B ? b_stages(m) : m.ns);
    float* dst = part + (int64_t)m.z * Ptot + m.J.out_off;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = m.i0 + w * 64 + row + 8 * ((i / 2) % 2);
      const int c = m.o0 + 8 * (i / 4) + col + i % 2;
      if (r < m.J.I && c < m.J.O) dst[(int64_t)r * m.J.O + c] = acc[i];
    }
    if constexpr (B) {
      if (brow) part[(int64_t)m.z * Ptot + m.J.bias_off + m.o0 + ct] = rs[0];
    } else {  // the bias sums: each D row's partials from the lanes that shared it
      constexpr int LANES = 8;
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
}

// ---- host side -----------------------------------------------------------------

// A tensor map of `rank` dimensions (dims, strides of dimensions 1.. in
// bytes, box), zero fill past the edges, through cuTensorMapEncodeTiled,
// which cudaGetDriverEntryPoint reaches. Returns 0 or a nonzero error.
inline int encode_tiled(CUtensorMap* map, CUtensorMapDataType type, int rank,
                        const void* base, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box,
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
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, type, rank, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 2-D map over `rows` rows of `inner` 4-byte elements (row stride inner *
// 4 B, a multiple of 16), box box_inner x box_rows.
inline int encode_2d(CUtensorMap* map, const void* base, int64_t inner,
                     int64_t rows, int box_rows, int box_inner,
                     CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims,
                      strides, box, swizzle);
}

// The scratch's map. TF32X3: `rows` rows of n_pad fp32 points, box wg::TILE
// rows x wg::KS points. BF16: the tile-blocked bf16 array [tile][rows][64
// points] (fused_mlp_bwd_common.cuh) as 3-D (point, row, tile), box 64
// points x wg::TILE rows of one tile, 16 KB contiguous in memory. Both 128 B
// a box row, 128-byte swizzle.
inline int encode_map(CUtensorMap* map, const void* base, int64_t n_pad,
                      int64_t rows, int mode) {
  if (mode == tc::TF32X3)
    return encode_2d(map, base, n_pad, rows, wg::TILE, wg::KS,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t dims[3] = {(cuuint64_t)tc::TP, (cuuint64_t)rows,
                              (cuuint64_t)(n_pad / tc::TP)};
  const cuuint64_t strides[2] = {(cuuint64_t)tc::TP * 2,
                                 (cuuint64_t)(rows * tc::TP * 2)};
  const cuuint32_t box[3] = {(cuuint32_t)tc::TP, (cuuint32_t)wg::TILE, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
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
// `splits` chunks of `chunk` points into part; X, D fp32 (TF32X3) or the
// tile-blocked bf16 arrays of xr and dr rows a tile (BF16, with bsum its
// tile sums of D); returns the first error.
inline int launch_wgmma(const void* X, const void* D, const float* bsum,
                        int64_t n_pad, int xr, int dr, int64_t chunk,
                        int splits, const GemmJobs& gj, int tiles, float* part,
                        int64_t Ptot, int mode, cudaStream_t stream) {
  int64_t xrows = 0, drows = 0;
  for (int q = 0; q < gj.count; ++q) {
    const GemmJob& k = gj.j[q];
    xrows = xrows > k.x_row0 + k.I ? xrows : k.x_row0 + k.I;
    drows = drows > k.d_row0 + k.O ? drows : k.d_row0 + k.O;
  }
  if (mode == tc::BF16) xrows = xr, drows = dr;  // a tile's stride
  CUtensorMap xmap, dmap;
  int err = encode_map(&xmap, X, n_pad, xrows, mode);
  if (!err) err = encode_map(&dmap, D, n_pad, drows, mode);
  if (err) return err;
  const int items = tiles * splits;
  const int grid = items < sm_count() ? items : sm_count();
  if (mode == tc::TF32X3) {
    const int smem = (int)wg::SMEM_BYTES;
    cudaFuncSetAttribute(wgrad_wgmma_kernel<tc::TF32X3>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    wgrad_wgmma_kernel<tc::TF32X3><<<grid, wg::THREADS, smem, stream>>>(
        xmap, dmap, n_pad, chunk, tiles, splits, part, Ptot, gj, nullptr);
  } else {
    const int smem = (int)wg::B_SMEM_BYTES;
    cudaFuncSetAttribute(wgrad_wgmma_kernel<tc::BF16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    wgrad_wgmma_kernel<tc::BF16><<<grid, wg::THREADS, smem, stream>>>(
        xmap, dmap, n_pad, chunk, tiles, splits, part, Ptot, gj, bsum);
  }
  return (int)cudaGetLastError();
}

}  // namespace fmlp
