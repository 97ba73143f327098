// Hopper layer product for K1-K4 (fused_mlp_{fwd,bwd}.cu,
// staged_mlp_{fwd,bwd}.cu): wgmma.mma_async on weights that TMA brings into
// shared memory, with warp specialisation. Used by the NeRF forward
// (fused_mlp_wg.cuh `forward_wg`, K1 and K3, and K4's tile pass) and by the
// backward tile pass (fused_mlp_bwd_common.cuh `tile_pass`, K2 and K4).
//
// out[p][m] = sum_k act[p][k] B[m][k] over a block's 64-point tile p:
//  - A = the activations, fp32 in shared memory, point-major [point][feature]
//    with a row stride (Ld<MODE>) of 4 mod 32 floats for TF32X3's 4-byte
//    fragment loads and 8 mod 32 for BF16's 8-byte ones, which keeps
//    either conflict-free (a BF16 stride of 4 mod 32 cost ~120 cycles a
//    stage in 2-way conflicts, PERF.md): each consumer
//    thread loads its fragment of a k-step (m64 x k8 TF32, m64 x k16 BF16;
//    the mma.sync A layout stacked over the four warps) and runs
//    wgmma with A from registers. TF32 wgmma reads a shared-memory A only
//    K-major, which for a point-major tile would mean a second, split copy
//    of the activations; from registers the TF32X3 split of A costs four
//    integer ops a k-step and no shared memory;
//  - B = a weight matrix, K-major in shared memory: the forward reads
//    B[o][i] = W[i][o] (a W^T copy), the data gradients B[i][o] = W[i][o]
//    (W itself). Both copies are made once per MLP call by `prep_kernel`
//    (TF32X3: big = cvt.rna(x) and small = x - big, the rows of a stage's
//    big part then its small part; BF16: bf16 (rn) values), cut into
//    stages of KS contraction rows, each stage a run of 64-byte rows that
//    one TMA box (64 rows, 64-byte swizzle) after another brings into a
//    slot of a ring in shared memory (boxes of 256 rows: two TMA
//    instructions a 256-wide TF32X3 stage, one otherwise);
//  - one producer thread (warpgroup 2, which gives its registers to the
//    consumers: setmaxnreg 40 / 232; ptxas sizes a wgmma kernel by whole
//    warpgroups, so a producer warp alone would leave 168 registers a
//    thread, too few for the tile pass) walks the kernel's product
//    schedule (`Sched`) and keeps the ring full, completing each slot on
//    its full mbarrier; the two consumer warpgroups each take half the
//    output features (m64 x n128 for a 256-wide layer) and release a slot
//    on its empty mbarrier once their wgmma have read it;
//  - the tensor core's fp32 accumulation keeps fewer bits than an IEEE add
//    over long sums (K1's 256-deep sums lost bits): every 16 contraction rows in TF32X3
//    (one ring stage) and 64 in BF16 (two; bf16 operands lose far more than
//    a 64-deep sum) go into a fresh accumulator (scale-d 0) that the CUDA
//    cores add to an fp32 running sum;
//  - TF32X3 runs small*big, big*small and big*big a k8 step into that
//    accumulator (small*small dropped); BF16 one k16 product;
//  - the accumulator layout (thread t of warpgroup w holds d[4j + r] at
//    point (t / 32) 16 + (t % 32) / 4 + 8 (r / 2) and output feature
//    w N / 2 + 8 j + 2 (t % 4) + r % 2) is the same for a forward layer and
//    the backward product for its input gradient, so the ReLU signs a
//    thread keeps in the forward sit where it needs them in the backward.
// Activations come from registers (generic loads), so only B goes through
// the async proxy, whose completion the mbarrier carries: no proxy fence
// is needed between an epilogue's stores and the next product.
#pragma once

#include "wgrad_wgmma.cuh"  // PTX wrappers (mbarrier, TMA, descriptors)

namespace wl {

using tc::Mode;
using tc::TF32X3;
using tc::BF16;
namespace wg = fmlp::wg;

constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int THREADS = CONSUMERS + 128;    // and the producer warpgroup
constexpr int ROW_BYTES = 64;               // a prepared weight row
constexpr int BOX_ROWS = 256;               // rows of one TMA box

// Activation row strides (floats): H (256 features), PE (64), VPE (32)
template <Mode MODE>
struct Ld {
  static constexpr int PAD = MODE == TF32X3 ? 4 : 8;
  static constexpr int H = 256 + PAD, P = 64 + PAD, V = 32 + PAD;
};

template <Mode MODE>
struct Cfg {
  static constexpr int KS = MODE == TF32X3 ? 16 : 32;    // contraction a stage
  static constexpr int PARTS = MODE == TF32X3 ? 2 : 1;   // big, small
  static constexpr int GROUP = MODE == TF32X3 ? 1 : 2;   // stages a wait
  static constexpr int SLOT_BYTES = 256 * PARTS * ROW_BYTES;
};

// ---- the weight matrices and their prepared copies ---------------------------

// The matrices of the layer products, in the order of each section of the
// prepared buffer: w0, wh1..wh7, w5pe, wf, wfv, then wvpe (K1/K2 only).
enum Mat { W0 = 0, WH1 = 1, W5PE = 8, WF = 9, WFV = 10, WVPE = 11, NMAT = 12 };
enum Orient { FWD = 0, BWD = 1 };

// One (matrix, orientation) of the prepared buffer: B is N x K (K-major),
// stored as K / KS blocks of PARTS * N rows of 64 bytes from row row0.
// FWD: B[o][i] = W[i][o], N = O, K = I rounded up to 32; BWD: B[i][o] =
// W[i][o], N = I rounded up to 32, K = O. W (I, O) is row-major at src in
// the packed vector; B's entries past I are 0.
struct PrepMat {
  int64_t src, row0;
  int I, O, N, K;
};
struct PrepTable {
  int count;  // 2 x the matrices
  int64_t rows;
  PrepMat m[2 * NMAT];
  __host__ __device__ const PrepMat& at(int mat, int orient) const {
    return m[orient * (count / 2) + mat];
  }
};

__host__ __device__ inline int pad32(int x) { return (x + 31) / 32 * 32; }

template <Mode MODE>
__host__ __device__ inline PrepTable prep_table(const fmlp::Offsets& o,
                                                bool view_pe) {
  using C = Cfg<MODE>;
  const int nm = view_pe ? NMAT : NMAT - 1;
  PrepTable t;
  t.count = 2 * nm;
  int64_t row = 0;
  for (int orient = 0; orient < 2; ++orient)
    for (int mat = 0; mat < nm; ++mat) {
      PrepMat& e = t.m[orient * nm + mat];
      const int W = fmlp::WIDTH;
      if (mat == W0 || mat == W5PE) {
        e.src = mat == W0 ? o.w0 : o.w5pe;
        e.I = fmlp::PE_ROWS;
        e.O = W;
      } else if (mat < W5PE) {
        e.src = o.wh + (int64_t)(mat - 1) * W * W;
        e.I = e.O = W;
      } else if (mat == WF) {
        e.src = o.wf;
        e.I = e.O = W;
      } else if (mat == WFV) {
        e.src = o.wfv;
        e.I = W;
        e.O = fmlp::HEAD;
      } else {
        e.src = o.wvpe;
        e.I = fmlp::VPE_ROWS;
        e.O = fmlp::HEAD;
      }
      e.N = orient == FWD ? e.O : pad32(e.I);
      e.K = orient == FWD ? pad32(e.I) : e.O;
      e.row0 = row;
      row += (int64_t)(e.K / C::KS) * C::PARTS * e.N;
    }
  t.rows = row;
  return t;
}

// The weight stream of one kernel: the products in the order its consumers
// run them, each as (first row, rows a stage, stages).
constexpr int MAX_PROD = 2 * NMAT;
struct Sched {
  int count;
  int row0[MAX_PROD], rows[MAX_PROD], stages[MAX_PROD];
};

// With `forward` the forward's products (K1: with view_pe; K3 without),
// then with `backward` the tile pass's data-gradient products: K1 and K3
// stream the first, K4's tile pass both (it runs K3's forward again), K2's
// the second alone (K1 kept its forward).
template <Mode MODE>
inline Sched make_sched(const fmlp::Offsets& o, bool view_pe, bool forward,
                        bool backward) {
  using C = Cfg<MODE>;
  const PrepTable t = prep_table<MODE>(o, view_pe);
  Sched s;
  s.count = 0;
  auto add = [&](int mat, int orient) {
    const PrepMat& e = t.at(mat, orient);
    s.row0[s.count] = (int)e.row0;
    s.rows[s.count] = C::PARTS * e.N;
    s.stages[s.count] = e.K / C::KS;
    ++s.count;
  };
  const int fwd[] = {W0, WH1, WH1 + 1, WH1 + 2, WH1 + 3, WH1 + 4, W5PE,
                     WH1 + 5, WH1 + 6, WF, WFV, WVPE};
  if (forward)
    for (int mat : fwd)
      if (mat != WVPE || view_pe) add(mat, FWD);
  if (backward) {
    const int bwd[] = {WVPE, WFV, WF, WH1 + 6, WH1 + 5, W5PE, WH1 + 4,
                       WH1 + 3, WH1 + 2, WH1 + 1, WH1, W0};
    for (int mat : bwd)
      if (mat != WVPE || view_pe) add(mat, BWD);
  }
  return s;
}

// The prepared buffer from the packed weights P: one thread a 4-byte word
// (TF32X3: a big or small fp32; BF16: two bf16 of consecutive k). Rows of
// 16 words; `out` holds t.rows rows.
template <Mode MODE>
__global__ void prep_kernel(const float* __restrict__ P, const PrepTable t,
                            uint32_t* __restrict__ out) {
  using C = Cfg<MODE>;
  const int64_t word = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (word >= t.rows * 16) return;
  const int64_t row = word / 16;
  const int c = (int)(word % 16);
  int q = 0;
  while (q + 1 < t.count && row >= t.m[q + 1].row0) ++q;
  const PrepMat& e = t.m[q];
  const bool fwd = q < t.count / 2;
  const int64_t r = row - e.row0;
  const int s = (int)(r / (C::PARTS * e.N));
  const int rr = (int)(r % (C::PARTS * e.N));
  const int n = rr % e.N;
  auto w = [&](int k) {  // B[n][k]
    const int i = fwd ? k : n, o = fwd ? n : k;
    return i < e.I ? __ldg(P + e.src + (int64_t)i * e.O + o) : 0.f;
  };
  if constexpr (MODE == TF32X3) {
    const float x = w(s * C::KS + c);
    const uint32_t big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    out[word] = rr < e.N ? big : __float_as_uint(x - __uint_as_float(big));
  } else {
    const int k = s * C::KS + 2 * c;
    out[word] = tc::bf16x2(w(k), w(k + 1));
  }
}

template <Mode MODE>
inline int launch_prep(const float* P, const PrepTable& t, void* out,
                       cudaStream_t stream) {
  const int64_t words = t.rows * 16;
  prep_kernel<MODE><<<(unsigned)((words + 255) / 256), 256, 0, stream>>>(
      P, t, reinterpret_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// The table as rows of (row0, N, K, src, I, O), FWD then BWD; returns the
// row count. The Python side checks its own layout against this.
template <Mode MODE>
inline int prep_rows(const fmlp::Offsets& o, bool view_pe, int64_t* out,
                     int cap) {
  const PrepTable t = prep_table<MODE>(o, view_pe);
  if (t.count > cap) return t.count;  // no room: write nothing
  for (int q = 0; q < t.count; ++q) {
    const PrepMat& e = t.m[q];
    const int64_t v[6] = {e.row0, e.N, e.K, e.src, e.I, e.O};
    for (int c = 0; c < 6; ++c) out[6 * q + c] = v[c];
  }
  return t.count;
}

// A 2-D tensor map over the prepared buffer: rows of 16 4-byte words, a box
// of BOX_ROWS rows, 64-byte swizzle (the layout wgmma's descriptor reads).
inline int encode_prep_map(CUtensorMap* map, const void* base, int64_t rows) {
  return fmlp::encode_2d(map, base, 16, rows, BOX_ROWS, 16,
                         CU_TENSOR_MAP_SWIZZLE_64B);
}

// ---- register-sourced wgmma ----------------------------------------------------

// d (+)= A B^T for a 64 x NW tile: A from registers (this thread's fragment
// a), B K-major in shared memory (descriptor b); d is overwritten when
// scale_d is 0.
template <Mode MODE, int NW>
__device__ __forceinline__ void wgmma_rs(float (&d)[NW / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

#define WL_R8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WL_D8 WL_R8(0)
#define WL_D16 WL_R8(0), WL_R8(8)
#define WL_D32 WL_R8(0), WL_R8(8), WL_R8(16), WL_R8(24)
#define WL_D64 WL_D32, WL_R8(32), WL_R8(40), WL_R8(48), WL_R8(56)
#define WL_OUT8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WL_OUT16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WL_OUT32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WL_OUT64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
// R accumulators: A at %R..%R+3, B at %R+4, scale-d at %R+5
#define WL_RS(MODE_, NW_, R_, OUT_, D_, SHAPE_, A_, B_, S_, IMM_)            \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_rs<MODE_, NW_>(                     \
      float(&d)[R_], const uint32_t(&a)[4], uint64_t b, int scale_d) {      \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " S_ ", 0;\n"         \
                 " wgmma.mma_async.sync.aligned." SHAPE_ " " OUT_ ", " A_  \
                 ", " B_ ", p, " IMM_ ";\n}\n"                              \
                 : D_                                                       \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),     \
                   "r"(scale_d));                                           \
  }
WL_RS(TF32X3, 128, 64, WL_OUT64, WL_D64, "m64n128k8.f32.tf32.tf32",
      "{%64, %65, %66, %67}", "%68", "%69", "1, 1")
WL_RS(TF32X3, 64, 32, WL_OUT32, WL_D32, "m64n64k8.f32.tf32.tf32",
      "{%32, %33, %34, %35}", "%36", "%37", "1, 1")
WL_RS(TF32X3, 32, 16, WL_OUT16, WL_D16, "m64n32k8.f32.tf32.tf32",
      "{%16, %17, %18, %19}", "%20", "%21", "1, 1")
WL_RS(TF32X3, 16, 8, WL_OUT8, WL_D8, "m64n16k8.f32.tf32.tf32",
      "{%8, %9, %10, %11}", "%12", "%13", "1, 1")
WL_RS(BF16, 128, 64, WL_OUT64, WL_D64, "m64n128k16.f32.bf16.bf16",
      "{%64, %65, %66, %67}", "%68", "%69", "1, 1, 0")
WL_RS(BF16, 64, 32, WL_OUT32, WL_D32, "m64n64k16.f32.bf16.bf16",
      "{%32, %33, %34, %35}", "%36", "%37", "1, 1, 0")
WL_RS(BF16, 32, 16, WL_OUT16, WL_D16, "m64n32k16.f32.bf16.bf16",
      "{%16, %17, %18, %19}", "%20", "%21", "1, 1, 0")
WL_RS(BF16, 16, 8, WL_OUT8, WL_D8, "m64n16k16.f32.bf16.bf16",
      "{%8, %9, %10, %11}", "%12", "%13", "1, 1, 0")
#undef WL_RS
#undef WL_OUT64
#undef WL_OUT32
#undef WL_OUT16
#undef WL_OUT8
#undef WL_D64
#undef WL_D32
#undef WL_D16
#undef WL_D8
#undef WL_R8

// keep the compiler from touching registers that wgmma own
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- the ring ------------------------------------------------------------------

// NSLOT slots of Cfg<MODE>::SLOT_BYTES at `base` (1024-aligned), their full
// and empty mbarriers at `bars`, and the count of stages consumed.
template <Mode MODE, int NSLOT>
struct Ring {
  static constexpr int kSlots = NSLOT;
  static constexpr size_t kBytes = (size_t)NSLOT * Cfg<MODE>::SLOT_BYTES;
  uint32_t base, bars, it;
  __device__ uint32_t slot(uint32_t s) const {
    return base + s * Cfg<MODE>::SLOT_BYTES;
  }
  __device__ uint32_t full(uint32_t s) const { return bars + 8 * s; }
  __device__ uint32_t empty(uint32_t s) const { return bars + 8 * (NSLOT + s); }
  // by one thread, before any other touches the barriers
  __device__ void init() const {
    for (int s = 0; s < NSLOT; ++s) {
      wg::mbar_init(full(s), 1);
      wg::mbar_init(empty(s), 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the producer thread: every stage of the schedule, in order
  __device__ void produce(const CUtensorMap* map, const Sched& sc) const {
    uint32_t k = 0;
    for (int p = 0; p < sc.count; ++p) {
      const int boxes = (sc.rows[p] + BOX_ROWS - 1) / BOX_ROWS;
      for (int b = 0; b < sc.stages[p]; ++b, ++k) {
        const uint32_t s = k % NSLOT;
        wg::mbar_wait(empty(s), ((k / NSLOT) & 1) ^ 1);
        wg::mbar_expect_tx(full(s), boxes * BOX_ROWS * ROW_BYTES);
        for (int x = 0; x < boxes; ++x)
          wg::tma_load_2d(slot(s) + x * BOX_ROWS * ROW_BYTES, map, full(s), 0,
                          sc.row0[p] + b * sc.rows[p] + x * BOX_ROWS);
      }
    }
  }
};

// ---- the product -------------------------------------------------------------

// This consumer thread's accumulator positions for an N-wide product
// (N / 2 outputs a warpgroup, N / 4 accumulators a thread).
template <int N>
struct Frag {
  static constexpr int NW = N / 2, R = N / 4;
  __device__ static int point(int i) {
    const int t = threadIdx.x;
    return (t % 128) / 32 * 16 + (t % 32) / 4 + 8 * ((i >> 1) & 1);
  }
  __device__ static int feat(int i) {
    const int t = threadIdx.x;
    return (t / 128) * NW + 8 * (i >> 2) + 2 * (t % 4) + (i & 1);
  }
};

// This thread's A fragments of one ring stage (KS columns of `act` from
// k0, rows a0 and a1 = a0 + 8 rows): TF32X3 big and small parts
// (tc::split), BF16 values (as unused); [k-step][4].
template <Mode MODE>
__device__ __forceinline__ void load_frags(const float* a0, const float* a1, int q,
                                           int k0, uint32_t (&ab)[2][4],
                                           uint32_t (&as)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (MODE == TF32X3) {
      const int k = k0 + 8 * h + q;
      tc::split(a0[k], ab[h][0], as[h][0]);
      tc::split(a1[k], ab[h][1], as[h][1]);
      tc::split(a0[k + 4], ab[h][2], as[h][2]);
      tc::split(a1[k + 4], ab[h][3], as[h][3]);
    } else {
      const int k = k0 + 16 * h + 2 * q;
      const float2 x0 = *reinterpret_cast<const float2*>(a0 + k);
      const float2 x1 = *reinterpret_cast<const float2*>(a1 + k);
      const float2 x2 = *reinterpret_cast<const float2*>(a0 + k + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(a1 + k + 8);
      ab[h][0] = tc::bf16x2(x0.x, x0.y);
      ab[h][1] = tc::bf16x2(x1.x, x1.y);
      ab[h][2] = tc::bf16x2(x2.x, x2.y);
      ab[h][3] = tc::bf16x2(x3.x, x3.y);
    }
  }
}

// The wgmma of one ring stage into d (B at `b`, this warpgroup's rows;
// TF32X3's small part N rows further): TF32X3 small*big, big*small and
// big*big a k8 step, BF16 one product a k16 step; `first`: d is
// overwritten.
template <Mode MODE, int N>
__device__ __forceinline__ void stage_mma(float (&d)[N / 4], const uint32_t (&ab)[2][4],
                                          const uint32_t (&as)[2][4], uint32_t b,
                                          bool first) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint64_t bb = wg::desc(b + 32 * h, 512, 2);
    if constexpr (MODE == TF32X3) {
      const uint64_t bs = wg::desc(b + N * ROW_BYTES + 32 * h, 512, 2);
      wgmma_rs<MODE, N / 2>(d, as[h], bb, !first || h);
      wgmma_rs<MODE, N / 2>(d, ab[h], bs, 1);
      wgmma_rs<MODE, N / 2>(d, ab[h], bb, 1);
    } else {
      wgmma_rs<MODE, N / 2>(d, ab[h], bb, !first || h);
    }
  }
}

// G ring stages from stage `s` of the product into part (overwritten),
// then acc += part: A fragments, the stages' full waits, the wgmma, one
// wait, the stages released, the add on the CUDA cores.
template <Mode MODE, int N, int G, typename RingT>
__device__ __forceinline__ void group(float (&acc)[N / 4], float (&part)[N / 4],
                                      const float* a0, const float* a1, int q,
                                      int s, RingT& ring, uint32_t boff) {
  using C = Cfg<MODE>;
  constexpr int NS = RingT::kSlots;
  uint32_t ab[G][2][4], as[G][2][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_frags<MODE>(a0, a1, q, (s + g) * C::KS, ab[g], as[g]);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint32_t it = ring.it + s + g;
    wg::mbar_wait(ring.full(it % NS), (it / NS) & 1);
    if (g == 0) wg::wgmma_fence();
    stage_mma<MODE, N>(part, ab[g], as[g], ring.slot(it % NS) + boff, g == 0);
  }
  wg::wgmma_commit();
  wg::wgmma_wait0();
  fence_regs(part);
#pragma unroll
  for (int g = 0; g < G; ++g)
    wg::mbar_arrive_if(ring.empty((ring.it + s + g) % NS), threadIdx.x % 128 == 0);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) acc[i] += part[i];
}

// acc += act B^T over K (a multiple of KS) columns of `act` (point-major,
// row stride ld), B the next K / KS stages of the ring: N outputs, this
// warpgroup's (w) half of them. Every consumer thread calls it. Each
// group of Cfg::GROUP ring stages (TF32X3 one, 16 deep; BF16 two, 64 deep;
// a last odd BF16 stage alone) goes into a fresh accumulator that the CUDA
// cores add to acc once its wgmma are done: one wait a group. (Two TF32X3
// stages a group, two accumulators in turn, or the stage loop unrolled
// measured slower: registers or code size; PERF.md.)
template <Mode MODE, int N, typename RingT>
__device__ __forceinline__ void product(float (&acc)[N / 4], const float* act,
                                        int ld, int K, RingT& ring, int w) {
  using C = Cfg<MODE>;
  float part[N / 4];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) part[i] = 0.f;
  const int lane = threadIdx.x % 32;
  const float* a0 = act + ((threadIdx.x % 128) / 32 * 16 + lane / 4) * ld;
  const float* a1 = a0 + 8 * ld;
  const int q = lane % 4;
  const uint32_t boff = w * (N / 2) * ROW_BYTES;  // this warpgroup's B rows
  const int ns = K / C::KS, full = ns / C::GROUP * C::GROUP;
#pragma unroll 1
  for (int s = 0; s < full; s += C::GROUP)
    group<MODE, N, C::GROUP>(acc, part, a0, a1, q, s, ring, boff);
  if (C::GROUP > 1 && full < ns)  // BF16's wvpe forward, K = 32
    group<MODE, N, 1>(acc, part, a0, a1, q, full, ring, boff);
  ring.it += ns;
}

// ---- epilogue helpers (a thread's accumulator positions) ---------------------

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
}

// acc += bias[feature]; with relu, acc = max(acc, 0)
template <int N>
__device__ __forceinline__ void bias_act(float (&acc)[N / 4],
                                         const float* __restrict__ bias,
                                         bool relu) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float v = acc[i] + __ldg(bias + Frag<N>::feat(i));
    acc[i] = relu ? fmaxf(v, 0.f) : v;
  }
}

// to a point-major shared-memory tile (row stride ld), at column col0
template <int N>
__device__ __forceinline__ void store_act(float* act, int ld,
                                          const float (&acc)[N / 4],
                                          int col0 = 0) {
#pragma unroll
  for (int i = 0; i < N / 4; i += 2)
    *reinterpret_cast<float2*>(act + Frag<N>::point(i) * ld + col0 +
                               Frag<N>::feat(i)) = make_float2(acc[i], acc[i + 1]);
}

// act += the tile, at the positions store_act<N> writes (the thread's own)
template <int N>
__device__ __forceinline__ void add_act(float* act, int ld,
                                        const float (&acc)[N / 4]) {
#pragma unroll
  for (int i = 0; i < N / 4; i += 2) {
    float2* d = reinterpret_cast<float2*>(act + Frag<N>::point(i) * ld +
                                          Frag<N>::feat(i));
    const float2 v = *d;
    *d = make_float2(v.x + acc[i], v.y + acc[i + 1]);
  }
}

// to a feature-major global array G[row][ld] (row = feature), column col0;
// one running pointer (a thread's elements lie 8 rows and 8 columns apart).
// Cache-streaming stores (st.global.cs): the tile pass's scratch is read
// once, by the weight-gradient pass, and left in L2 it evicts the weight
// stream (-4% / -15% on K2's tile pass in TF32X3 / BF16, PERF.md).
template <int N>
__device__ __forceinline__ void store_global(float* G, int64_t ld, int64_t col0,
                                             const float (&acc)[N / 4]) {
  float* g = G + (int64_t)Frag<N>::feat(0) * ld + col0 + Frag<N>::point(0);
#pragma unroll
  for (int j = 0; j < N / 16; ++j, g += 8 * ld) {
    __stcs(g, acc[4 * j]);
    __stcs(g + ld, acc[4 * j + 1]);
    __stcs(g + 8, acc[4 * j + 2]);
    __stcs(g + ld + 8, acc[4 * j + 3]);
  }
}

// The same as bf16 (rn) to a feature-major bf16 array: lanes l and l ^ 4
// hold the same features at neighbouring points (2m, 2m + 1), so each
// trades one value of every feature pair with the other (one shuffle) and
// stores one 32-bit word, two points of one feature (the even point's
// thread feature f, the odd point's f + 1): half the bytes of store_global
// in half its store instructions.
__device__ __forceinline__ int thread_index() {  // read anew at each use
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

template <int N>
__device__ __forceinline__ void store_global_bf16(__nv_bfloat16* G, int64_t ld,
                                                  int64_t col0,
                                                  const float (&acc)[N / 4]) {
  // this thread's first word, Frag<N>'s position from a fresh read of its
  // index: kept across the tile pass's ~20 stores, the offset spilled
  const int t = thread_index();
  const int odd = (t >> 2) & 1;
  const int feat = (t / 128) * (N / 2) + 2 * (t % 4) + odd;
  const int point = (t % 128) / 32 * 16 + (t % 32) / 4 - odd;
  uint32_t* g = reinterpret_cast<uint32_t*>(G + (int64_t)feat * ld + col0 + point);
#pragma unroll
  for (int j = 0; j < N / 16; ++j, g += 4 * ld) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // points p and p + 8
      const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
      const float r = __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 4);
      __stcs(g + 4 * h, odd ? tc::bf16x2(r, a1) : tc::bf16x2(a0, r));
    }
  }
}

// Each of the first N features' fp32 sum over a point-major tile of TP
// points in shared memory (row stride ld), to dst[feature]: the thread of
// a feature adds the points in four interleaved sums, then those in order
// (fixed order, no atomics; consecutive threads read consecutive words).
// Every consumer thread calls it; the tile must stay unwritten until every
// thread has passed a barrier after the call.
template <int N>
__device__ __forceinline__ void tile_sums(const float* act, int ld, float* dst) {
  const int t = threadIdx.x;
  if (t < N) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
    for (int p = 0; p < tc::TP; p += 4) {
      s0 += act[p * ld + t];
      s1 += act[(p + 1) * ld + t];
      s2 += act[(p + 2) * ld + t];
      s3 += act[(p + 3) * ld + t];
    }
    __stcs(dst + t, (s0 + s1) + (s2 + s3));
  }
}

// ReLU signs as bits, one word per 32 accumulators, word-major in shared
// memory ([word][consumer thread]: conflict-free)
template <int R>
__device__ __forceinline__ void save_signs(uint32_t* masks, const float (&acc)[R]) {
  constexpr int MW = (R + 31) / 32;
  uint32_t w[MW] = {};
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (acc[i] > 0.f) w[i / 32] |= 1u << (i % 32);
#pragma unroll
  for (int q = 0; q < MW; ++q) masks[q * CONSUMERS + threadIdx.x] = w[q];
}

// acc *= (saved sign > 0)
template <int R>
__device__ __forceinline__ void apply_signs(float (&acc)[R], const uint32_t* masks) {
  constexpr int MW = (R + 31) / 32;
  uint32_t w[MW];
#pragma unroll
  for (int q = 0; q < MW; ++q) w[q] = masks[q * CONSUMERS + threadIdx.x];
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (!((w[i / 32] >> (i % 32)) & 1u)) acc[i] = 0.f;
}

// ---- the block ---------------------------------------------------------------

// Shared memory of a kernel on the engine: the ring (1024-aligned), then
// `floats` floats of activations, then the ring's barriers; 1 KB of slack
// for the alignment.
template <typename RingT>
constexpr size_t smem_bytes(size_t floats) {
  return 1024 + RingT::kBytes + floats * sizeof(float) + 2 * RingT::kSlots * 8;
}

// Lay the ring out in the dynamic shared memory; returns the first float
// after it.
template <typename RingT>
__device__ __forceinline__ float* carve(uint8_t* smem, size_t floats, RingT& ring) {
  const uint32_t raw = tc::smem_addr(smem);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  ring.base = raw + pad;
  ring.bars = raw + pad + (uint32_t)(RingT::kBytes + floats * sizeof(float));
  ring.it = 0;
  return reinterpret_cast<float*>(smem + pad + RingT::kBytes);
}

// The warpgroup of this thread, warp-uniform as the compiler can see (a
// branch it takes for divergent serializes wgmma, ptxas C7518).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

// The producer warpgroup's part of a kernel: gives up its registers, one
// thread streams the schedule. Returns true in the producer warpgroup (the
// caller returns), false in the consumers, which take the registers
// (168 x 384 at launch; 128 x 128 given up = 256 x 64 taken).
template <typename RingT>
__device__ __forceinline__ bool producer(const RingT& ring, const CUtensorMap* map,
                                         const Sched& sc) {
  if (warpgroup() == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS) ring.produce(map, sc);
    return true;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  return false;
}

}  // namespace wl
