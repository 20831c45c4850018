// Input projection of the GRU and LSTM classifiers' projected route, the
// Hopper design (sm_90a): tsc_rnn_projection_wgmma.
//
// Replaces the hoisted input projection in the body of the TPU kernel
// tpu_speech_commands/ops/pallas_rnn.py::make_fused_rnn_classifier
// (:158-166, one matmul a gate over all T frames), with the contract of
// csrc/rnn_projection.cu (its first design, `_mma_sync=True`):
//
//   XW = X (B T x D) @ W (D x G U_p) + b                 float32
//
// W's columns in the tile kernels' padded gate order, XW in the layout the
// recurrence copies (ops/rnn_projection.py::to_tiles): tiles of 16 windows,
// [B / 16][T][N / 8][lane] x float4, a lane's mma C fragment of an n-tile
// (rows g and g + 8, columns 2t and 2t + 1) in one 16-byte word.  m-tile q
// is window tile q / T's 16 windows at step q % T.
//
// Bound at B 8192, T 23, D 300, a 48-unit GRU (N 144): f32 mode, 16.28
// GFLOP at the 3xTF32 rate (165 TFLOP/s), 0.0987 ms, against 226.1 MB of
// features and 108.5 MB of XW at 3.35 TB/s, 0.0999 ms; bf16 mode the bytes,
// 113.0 MB of features and XW, 0.0661 ms.
//
// Design (plan, pack, CPU emulation: ops/rnn_projection.py, "wgmma").
// - wgmma in both modes.  f32: 3xTF32, wgmma.mma_async m64nNk8 .tf32, A
//   from registers, each row element read from shared memory once and
//   split by cvt.rna into hi and lo (as csrc/cepstrum_wgmma.cu splits its
//   rows), B from shared memory: W's hi and lo tables, K-major and split
//   on the host; hi.hi + hi.lo + lo.hi into the same f32 accumulators, one
//   group a k8 step, the next step's fragment split while it runs.  bf16:
//   m64nNk16, bf16 products, f32 accumulation.  N = G U_p (48 .. 256, a
//   multiple of 16) is the wgmma width, one instantiation each.
// - A block: two consumer warpgroups and a producer warpgroup, persistent
//   (one an SM), walking tiles of BM rows: two m64 tiles a consumer
//   warpgroup up to N = TSC_PJW_WIDE_N (BM 256), one above it (BM 128;
//   the accumulators, N / 2 floats a thread an m64 tile, take the rest of
//   the registers).  The consumers start each tile's accumulators from the
//   bias and store XW from them as they stand: each warp's m64 rows are
//   one m-tile, 512 contiguous bytes an n-tile, and the stores overlap the
//   next tile's loads.
// - The ring: K in slices of 128 bytes (32 floats, 64 bf16: one row of
//   the 128-byte swizzle) through 2 .. TSC_PJW_MAX_STAGES stages, a full
//   and an empty mbarrier each.  The producer warpgroup fills a stage: one
//   thread W's slices by TMA, every thread some of the rows' by 16-byte
//   cp.async.  A row's slice comes as its window, the 9 aligned chunks from
//   the one at or below its first element (a bf16 row of 300 features is
//   600 bytes, which no tensor map describes), read by the consumers at the
//   row's shift into it; each copy takes only the row's own bytes (the
//   rest of a chunk zero-filled), so the k past D multiplies zeros.
// - W's L2 stream.  Streamed, W's slices are shared by the two blocks of a
//   cluster (TSC_PJW_CLUSTER): each loads half the slice's rows by TMA
//   multicast into both, and a stage is refilled only when both blocks'
//   consumers have released it.  At D 300, N 144, f32: 736 tiles of 256
//   rows, 368,640 bytes of hi and lo a tile, 135.7 MB from L2 in all (the
//   first design's 128-row blocks: 543 MB).  In bf16 mode, where W and a
//   ring of TSC_PJW_RESIDENT_STAGES stages of rows fit, W is loaded once
//   by each block and stays (92,160 bytes at D 300, N 144); the ring then
//   holds rows only.
// x is in the mode's type (the wrapper converts it), at any element
// boundary: a row's shift into its window is taken from its address.
//
// A compile-time switch for dev/projection_ablation.py --parts cuts (the
// shipped kernel takes the default; a cut's output is not the function):
// TSC_PJW_CUT 1: no products (the consumers wait for each stage and
// release it); 2: no XW stores; 3: no W stream (the stages' W slices keep
// what they hold); 4: no row copies.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_ring.cuh"

// The plan (ops/rnn_projection.py mirrors these; tests/test_torch_rnn_wide.py
// holds the two together)
#define TSC_PJW_THREADS 384         // two consumer warpgroups and a producer one
#define TSC_PJW_APITCH 144          // bytes a staged row: its window of 9 chunks
#define TSC_PJW_MAX_STAGES 6        // the ring's most stages
#define TSC_PJW_WIDE_N 144          // the widest N with two m64 tiles a warpgroup
#define TSC_PJW_RESIDENT_STAGES 3   // bf16: W resident beside this many stages
#ifndef TSC_PJW_CLUSTER
#define TSC_PJW_CLUSTER 2           // blocks sharing a streamed W slice
#endif
#ifndef TSC_PJW_CUT
#define TSC_PJW_CUT 0
#endif

namespace {

using namespace tsc_ring;

constexpr int kThreads = TSC_PJW_THREADS;
constexpr int kConsumers = 256;
constexpr int kProducers = kThreads - kConsumers;
constexpr int kAPitch = TSC_PJW_APITCH;
constexpr int kChunks = kAPitch / 16;
constexpr int kMaxStages = TSC_PJW_MAX_STAGES;
constexpr int kWideN = TSC_PJW_WIDE_N;
constexpr int kResidentStages = TSC_PJW_RESIDENT_STAGES;
constexpr int kCluster = TSC_PJW_CLUSTER;
constexpr int kCut = TSC_PJW_CUT;
constexpr bool kProducts = kCut != 1;
constexpr bool kStores = kCut != 2;
constexpr bool kWStream = kCut != 3;
constexpr bool kRowCopies = kCut != 4;
// a block's opt-in shared memory on an H100
constexpr int kSmemOptin = 232448;
// registers a thread after setmaxnreg: the consumers take what the
// producer warpgroup gives up (128 x 40 + 256 x 232 <= 65536)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// m-tile rows a skipped row's table entry (past the m-tiles) and a zero
// row's (a window past the batch: XW there is the bias)
constexpr int kSkipRow = -2, kZeroRow = -1;
static_assert(kCluster == 1 || kCluster == 2, "a cluster of 1 or 2 blocks");
static_assert(kChunks * 16 == kAPitch && kChunks == 9, "a staged row is its window");

// the plan, one-return functions (ops/rnn_projection.py's wgmma_plan)
__host__ __device__ constexpr int k_slice(bool bf16) { return bf16 ? 64 : 32; }
__host__ __device__ constexpr int k_pad(int D, bool bf16) {
  return (D + k_slice(bf16) - 1) / k_slice(bf16) * k_slice(bf16);
}
__host__ __device__ constexpr int m64_tiles(int N) { return N <= kWideN ? 2 : 1; }
__host__ __device__ constexpr int tile_rows(int N) { return 128 * m64_tiles(N); }
__host__ __device__ constexpr int w_slice_bytes(int N) { return N * 128; }
__host__ __device__ constexpr int w_stage_bytes(bool bf16, bool resident, int N) {
  return resident ? 0 : (bf16 ? 1 : 2) * w_slice_bytes(N);
}
__host__ __device__ constexpr int stage_bytes(bool bf16, bool resident, int N) {
  return w_stage_bytes(bf16, resident, N) + tile_rows(N) * kAPitch;
}
__host__ __device__ constexpr int resident_bytes(bool bf16, bool resident, int kp, int N) {
  return resident ? kp / k_slice(bf16) * w_slice_bytes(N) : 0;
}
// alignment slack, the bias, the producer's row table, the barriers (a
// full and an empty one a stage, and resident W's)
__host__ __device__ constexpr int fixed_bytes(int N, int stages) {
  return 1024 + 4 * N + 4 * tile_rows(N) + 16 * stages + 8;
}
__host__ __device__ constexpr int smem_bytes(bool bf16, bool resident, int kp, int N,
                                             int stages) {
  return resident_bytes(bf16, resident, kp, N) + stages * stage_bytes(bf16, resident, N) +
         fixed_bytes(N, stages);
}

// the ring's depth: as many stages as fit, at most kMaxStages (0: none fit)
int ring_stages(bool bf16, bool resident, int kp, int N) {
  int s = kMaxStages;
  while (s > 0 && smem_bytes(bf16, resident, kp, N, s) > kSmemOptin) --s;
  return s;
}

struct ProjArgs {
  const void* x;  // (batch, T, D), on an element boundary
  const float* bias;
  float4* xw;
  int batch, T, D, q_total, n_tiles, k_steps, stages;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared `dst` of which the first `n` come from `src` (16-byte
// aligned), the rest zero
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n)
               : "memory");
}

// an arrive on `bar` when this thread's cp.async copies so far have landed,
// counted as one of the barrier's expected arrivals
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// arrive on the barrier at the same offset in block `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// the producer warpgroup's own barrier
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kProducers) : "memory");
}

// the box at (k, row) of W's table into `dst`, completing `bar`'s
// transaction bytes; with MC, into the same offset of both blocks of the
// cluster, completing each one's `bar`
template <bool MC>
__device__ __forceinline__ void tma_load_w(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int k, int row) {
  const uint64_t desc = reinterpret_cast<uint64_t>(map);
  if constexpr (MC) {
    const uint16_t mask = 3;
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
        "l"(desc), "r"(bar), "r"(k), "r"(row), "h"(mask)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(desc), "r"(bar), "r"(k), "r"(row)
        : "memory");
  }
}

// x = hi + lo + (about 2^-22 x): hi = tf32(x), lo = tf32(x - hi), both
// rounded to nearest (ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// bf16 elements e and e + 1 of a staged row (its 32-bit words `w`) as one
// word, e at any parity
__device__ __forceinline__ uint32_t bf16_pair(const uint32_t* w, int e) {
  const uint32_t first = w[e >> 1];
  return (e & 1) ? __byte_perm(first, w[(e >> 1) + 1], 0x5432) : first;
}

// The wgmma operand lists: n8 blocks of accumulators, then A and B
#define PJW_ACC_1 "%0, %1, %2, %3"
#define PJW_D_1(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define PJW_ACC_2 PJW_ACC_1 ", %4, %5, %6, %7"
#define PJW_D_2(d) PJW_D_1(d), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define PJW_ACC_3 PJW_ACC_2 ", %8, %9, %10, %11"
#define PJW_D_3(d) PJW_D_2(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
#define PJW_ACC_4 PJW_ACC_3 ", %12, %13, %14, %15"
#define PJW_D_4(d) PJW_D_3(d), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define PJW_ACC_5 PJW_ACC_4 ", %16, %17, %18, %19"
#define PJW_D_5(d) PJW_D_4(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
#define PJW_ACC_6 PJW_ACC_5 ", %20, %21, %22, %23"
#define PJW_D_6(d) PJW_D_5(d), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
#define PJW_ACC_7 PJW_ACC_6 ", %24, %25, %26, %27"
#define PJW_D_7(d) PJW_D_6(d), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
#define PJW_ACC_8 PJW_ACC_7 ", %28, %29, %30, %31"
#define PJW_D_8(d) PJW_D_7(d), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define PJW_ACC_9 PJW_ACC_8 ", %32, %33, %34, %35"
#define PJW_D_9(d) PJW_D_8(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
#define PJW_ACC_10 PJW_ACC_9 ", %36, %37, %38, %39"
#define PJW_D_10(d) PJW_D_9(d), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define PJW_ACC_11 PJW_ACC_10 ", %40, %41, %42, %43"
#define PJW_D_11(d) PJW_D_10(d), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
#define PJW_ACC_12 PJW_ACC_11 ", %44, %45, %46, %47"
#define PJW_D_12(d) PJW_D_11(d), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
#define PJW_ACC_13 PJW_ACC_12 ", %48, %49, %50, %51"
#define PJW_D_13(d) PJW_D_12(d), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
#define PJW_ACC_14 PJW_ACC_13 ", %52, %53, %54, %55"
#define PJW_D_14(d) PJW_D_13(d), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
#define PJW_ACC_15 PJW_ACC_14 ", %56, %57, %58, %59"
#define PJW_D_15(d) PJW_D_14(d), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
#define PJW_ACC_16 PJW_ACC_15 ", %60, %61, %62, %63"
#define PJW_D_16(d) PJW_D_15(d), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PJW_ACC_17 PJW_ACC_16 ", %64, %65, %66, %67"
#define PJW_D_17(d) PJW_D_16(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
#define PJW_ACC_18 PJW_ACC_17 ", %68, %69, %70, %71"
#define PJW_D_18(d) PJW_D_17(d), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
#define PJW_ACC_19 PJW_ACC_18 ", %72, %73, %74, %75"
#define PJW_D_19(d) PJW_D_18(d), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
#define PJW_ACC_20 PJW_ACC_19 ", %76, %77, %78, %79"
#define PJW_D_20(d) PJW_D_19(d), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
#define PJW_ACC_21 PJW_ACC_20 ", %80, %81, %82, %83"
#define PJW_D_21(d) PJW_D_20(d), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83])
#define PJW_ACC_22 PJW_ACC_21 ", %84, %85, %86, %87"
#define PJW_D_22(d) PJW_D_21(d), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
#define PJW_ACC_23 PJW_ACC_22 ", %88, %89, %90, %91"
#define PJW_D_23(d) PJW_D_22(d), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91])
#define PJW_ACC_24 PJW_ACC_23 ", %92, %93, %94, %95"
#define PJW_D_24(d) PJW_D_23(d), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
#define PJW_ACC_25 PJW_ACC_24 ", %96, %97, %98, %99"
#define PJW_D_25(d) PJW_D_24(d), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
#define PJW_ACC_26 PJW_ACC_25 ", %100, %101, %102, %103"
#define PJW_D_26(d) PJW_D_25(d), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
#define PJW_ACC_27 PJW_ACC_26 ", %104, %105, %106, %107"
#define PJW_D_27(d) PJW_D_26(d), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107])
#define PJW_ACC_28 PJW_ACC_27 ", %108, %109, %110, %111"
#define PJW_D_28(d) PJW_D_27(d), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
#define PJW_ACC_29 PJW_ACC_28 ", %112, %113, %114, %115"
#define PJW_D_29(d) PJW_D_28(d), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115])
#define PJW_ACC_30 PJW_ACC_29 ", %116, %117, %118, %119"
#define PJW_D_30(d) PJW_D_29(d), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
#define PJW_ACC_31 PJW_ACC_30 ", %120, %121, %122, %123"
#define PJW_D_31(d) PJW_D_30(d), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123])
#define PJW_ACC_32 PJW_ACC_31 ", %124, %125, %126, %127"
#define PJW_D_32(d) PJW_D_31(d), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define PJW_AB_6 "{%24, %25, %26, %27}, %28"
#define PJW_AB_8 "{%32, %33, %34, %35}, %36"
#define PJW_AB_12 "{%48, %49, %50, %51}, %52"
#define PJW_AB_16 "{%64, %65, %66, %67}, %68"
#define PJW_AB_18 "{%72, %73, %74, %75}, %76"
#define PJW_AB_24 "{%96, %97, %98, %99}, %100"
#define PJW_AB_32 "{%128, %129, %130, %131}, %132"

// d[0 .. N / 2) (64 x N f32: the m64nN accumulator fragment) += a (64 x 8
// tf32 or 64 x 16 bf16: registers, the mma.m16n8k8 / m16n8k16 A layout a
// warp) * b (K-major in shared memory, 128-byte swizzle, descriptor `desc`)
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc);
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc);

#define PJW_WGMMA(n8, N)                                                              \
  template <>                                                                         \
  __device__ __forceinline__ void wgmma_tf32<N>(float(&d)[4 * n8], const uint32_t(&a)[4], \
                                                uint64_t desc) {                      \
    asm volatile(                                                                     \
        "{\n"                                                                         \
        ".reg .pred p;\n"                                                             \
        ".reg .b32 one;\n"                                                            \
        "mov.b32 one, 1;\n"                                                           \
        "setp.ne.b32 p, one, 0;\n"                                                    \
        "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" PJW_ACC_##n8      \
        "}, " PJW_AB_##n8 ", p, 1, 1;\n"                                              \
        "}\n"                                                                         \
        : PJW_D_##n8(d)                                                               \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));                     \
  }                                                                                   \
  template <>                                                                         \
  __device__ __forceinline__ void wgmma_bf16<N>(float(&d)[4 * n8], const uint32_t(&a)[4], \
                                                uint64_t desc) {                      \
    asm volatile(                                                                     \
        "{\n"                                                                         \
        ".reg .pred p;\n"                                                             \
        ".reg .b32 one;\n"                                                            \
        "mov.b32 one, 1;\n"                                                           \
        "setp.ne.b32 p, one, 0;\n"                                                    \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" PJW_ACC_##n8     \
        "}, " PJW_AB_##n8 ", p, 1, 1, 0;\n"                                           \
        "}\n"                                                                         \
        : PJW_D_##n8(d)                                                               \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));                     \
  }

PJW_WGMMA(6, 48)
PJW_WGMMA(8, 64)
PJW_WGMMA(12, 96)
PJW_WGMMA(16, 128)
PJW_WGMMA(18, 144)
PJW_WGMMA(24, 192)
PJW_WGMMA(32, 256)

// The x row of a tile's row r (0 .. BM - 1): the row index b T + t of
// m-tile q = tile BM / 16 + r / 16 (window tile q / T's window r % 16 at
// step q % T); kZeroRow for a window past the batch, kSkipRow past the
// m-tiles
__device__ __forceinline__ int tile_row(const ProjArgs& a, int tile, int bm, int r) {
  const int q = tile * (bm / 16) + r / 16;
  if (q >= a.q_total) return kSkipRow;
  const int wt = q / a.T, t = q - wt * a.T;
  const int b = 16 * wt + (r & 15);
  return b < a.batch ? b * a.T + t : kZeroRow;
}

// S: x's type and the mode's (float: 3xTF32; bf16); N = G U_p; kResident:
// W loaded once into shared memory (no cluster), else streamed with the
// rows.  map_hi / map_lo: W's hi and lo tables (N, k_pad) f32, or its
// (N, k_pad) bf16 table (map_lo unused); boxes of one K slice and N /
// cluster rows (all N resident).
template <typename S, int N, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    projection_wgmma_kernel(const ProjArgs a, const __grid_constant__ CUtensorMap map_hi,
                            const __grid_constant__ CUtensorMap map_lo) {
  constexpr bool kBf16 = std::is_same<S, __nv_bfloat16>::value;
  constexpr int MW = m64_tiles(N), BM = tile_rows(N);
  constexpr int kCl = kResident ? 1 : kCluster;
  constexpr int kSlice = w_slice_bytes(N);
  constexpr int kWBytes = w_stage_bytes(kBf16, kResident, N);
  constexpr int kStageBytes = stage_bytes(kBf16, kResident, N);
  constexpr int kBK = k_slice(kBf16);
  constexpr int kPitch = kAPitch / (int)sizeof(S);  // elements a staged row
  constexpr int NT = N / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stages = a.stages;
  const uint32_t w_res = smem_addr(base);
  uint8_t* ring_p = base + (kResident ? a.k_steps * kSlice : 0);
  const uint32_t ring = smem_addr(ring_p);
  float* s_bias = reinterpret_cast<float*>(ring_p + stages * kStageBytes);
  int* s_rows = reinterpret_cast<int*>(s_bias + N);
  const uint32_t full0 = smem_addr(s_rows + BM);  // stages full barriers
  const uint32_t empty0 = full0 + 8 * stages;     // then as many empty ones
  const uint32_t w_full = empty0 + 8 * stages;    // resident W's

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // the producer's threads' copies, and the TMA thread's arrive
      mbar_init(full0 + 8 * s, kProducers + 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32 * kCl);  // each consumer warp
    }
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < N; i += kThreads) s_bias[i] = a.bias[i];
  __syncthreads();
  if constexpr (kCl > 1) cluster_sync();  // both blocks' barriers are set up

  // this block's tiles: the cluster's pairs p, p + clusters, ..., of which
  // rank r takes tile kCl p + r (one past the tiles: computed, not stored)
  const int rank = kCl > 1 ? (int)cluster_rank() : 0;
  const int cid = blockIdx.x / kCl, clusters = gridDim.x / kCl;
  const int pairs = (a.n_tiles + kCl - 1) / kCl;

  if (warp >= kConsumers / 32) {
    // ---- the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    const int pt = tid - kConsumers;
    if (kResident && pt == 0) {
      mbar_expect_tx(w_full, a.k_steps * kSlice);
      for (int kt = 0; kt < a.k_steps; ++kt)
        tma_load_w<false>(w_res + kt * kSlice, &map_hi, w_full, kt * kBK, 0);
    }
    const uint8_t* xb = static_cast<const uint8_t*>(a.x);
    // a zero-filled chunk's source: the 16-byte boundary at or below x
    const uint8_t* x0 = reinterpret_cast<const uint8_t*>(
        reinterpret_cast<uintptr_t>(xb) & ~uintptr_t(15));
    const long long row_bytes = (long long)a.D * sizeof(S);
    int stage = 0;
    uint32_t phase = 0;
    for (int p = cid; p < pairs; p += clusters) {
      const int tile = kCl * p + rank;
      producers_sync();  // every producer thread is past the last tile's copies
      for (int r = pt; r < BM; r += kProducers) s_rows[r] = tile_row(a, tile, BM, r);
      producers_sync();
      for (int kt = 0; kt < a.k_steps; ++kt) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t st = ring + stage * kStageBytes;
        const uint32_t full = full0 + 8 * stage;
        if (pt == 0) {
          if constexpr (kResident || !kWStream) {
            mbar_arrive(full);
          } else {
            // this block's half of the slice's rows, into both blocks
            constexpr int kHalf = N / kCl;
            mbar_expect_tx(full, kWBytes);
            tma_load_w<(kCl > 1)>(st + rank * kHalf * 128, &map_hi, full, kt * kBK,
                                  rank * kHalf);
            if constexpr (!kBf16)
              tma_load_w<(kCl > 1)>(st + kSlice + rank * kHalf * 128, &map_lo, full,
                                    kt * kBK, rank * kHalf);
          }
        }
        // the rows' windows: chunk c of row r at 16 c into its staged row,
        // consecutive threads on consecutive chunks
        const uint32_t dst = st + kWBytes;
        for (int i = pt; i < (kRowCopies ? BM * kChunks : 0); i += kProducers) {
          const int r = i / kChunks, c = i - r * kChunks;
          const int row = s_rows[r];
          if (row == kSkipRow) continue;
          int n = 0;
          const uint8_t* src = x0;
          if (row != kZeroRow) {
            const uint8_t* p0 = xb + (long long)row * row_bytes;
            src = reinterpret_cast<const uint8_t*>(
                      reinterpret_cast<uintptr_t>(p0 + kt * 128) & ~uintptr_t(15)) +
                  16 * c;
            const long long left = p0 + row_bytes - src;
            n = left <= 0 ? 0 : left >= 16 ? 16 : (int)left;
            if (!n) src = x0;
          }
          cp_async16_zfill(dst + r * kAPitch + 16 * c, src, n);
        }
        cp_async_arrive_noinc(full);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- the consumers: warpgroup wg takes m64 tiles wg MW .. wg MW + MW
    // - 1 of the tile, warp w4 of it the m-tile of rows 16 w4 .. 16 w4 +
    // 15 of each; this thread rows g and g + 8 of it, and in the
    // accumulators' n8 block j columns 8 j + 2 t and + 1
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
    // a row's first byte past a 16-byte boundary: x's own, plus the row's
    // offset (mod 16, so 32-bit products do)
    const uint32_t x_mis = (uint32_t)reinterpret_cast<uintptr_t>(a.x) & 15u;
    const uint32_t row_bytes = (uint32_t)a.D * (uint32_t)sizeof(S);
    if constexpr (kResident) mbar_wait(w_full, 0);
    // the first stage's products release the stage before in every block
    // of the cluster (lane r signals block r)
    auto release = [&](int s) {
      if constexpr (kCl > 1) {
        if (lane < kCl) mbar_arrive_cluster(empty0 + 8 * s, lane);
      } else {
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
    };
    int stage = 0;
    uint32_t phase = 0;
    for (int p = cid; p < pairs; p += clusters) {
      const int tile = kCl * p + rank;
      float acc[MW][N / 2];
      int off[MW][2];  // rows g, g + 8: offset into a stage's rows, elements
#pragma unroll
      for (int m = 0; m < MW; ++m) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 bb = *reinterpret_cast<const float2*>(s_bias + 8 * j + 2 * t);
          acc[m][4 * j] = acc[m][4 * j + 2] = bb.x;
          acc[m][4 * j + 1] = acc[m][4 * j + 3] = bb.y;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * (wg * MW + m) + 16 * w4 + g + 8 * h;
          const int row = tile_row(a, tile, BM, r);
          const int shift =
              row >= 0 ? (int)(((x_mis + (uint32_t)row * row_bytes) & 15u) / sizeof(S)) : 0;
          off[m][h] = r * kPitch + shift;
        }
      }
      uint32_t fh[2][MW][4], fl[2][MW][4];  // the k steps' fragments, double-buffered
      int last = -1;                         // the stage of the step before
      for (int kt = 0; kt < a.k_steps; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t st = ring + stage * kStageBytes;
        const uint8_t* rows = ring_p + stage * kStageBytes + kWBytes;
        const uint32_t wb = kResident ? w_res + kt * kSlice : st;
        if constexpr (kProducts) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // step j's fragments: rows g, g + 8 at k and k + 4 (tf32) or
            // pairs at k and k + 8 (bf16); their buffer's last products
            // (two steps back) are done
#pragma unroll
            for (int m = 0; m < MW; ++m) {
              if constexpr (kBf16) {
                const uint32_t* w = reinterpret_cast<const uint32_t*>(rows);
                const int k = 16 * j + 2 * t;
                fh[j & 1][m][0] = bf16_pair(w, off[m][0] + k);
                fh[j & 1][m][1] = bf16_pair(w, off[m][1] + k);
                fh[j & 1][m][2] = bf16_pair(w, off[m][0] + k + 8);
                fh[j & 1][m][3] = bf16_pair(w, off[m][1] + k + 8);
              } else {
                const float* f = reinterpret_cast<const float*>(rows);
                const int k = 8 * j + t;
                split_tf32(f[off[m][0] + k], fh[j & 1][m][0], fl[j & 1][m][0]);
                split_tf32(f[off[m][1] + k], fh[j & 1][m][1], fl[j & 1][m][1]);
                split_tf32(f[off[m][0] + k + 4], fh[j & 1][m][2], fl[j & 1][m][2]);
                split_tf32(f[off[m][1] + k + 4], fh[j & 1][m][3], fl[j & 1][m][3]);
              }
            }
            wgmma_fence();
#pragma unroll
            for (int m = 0; m < MW; ++m) fence_regs(acc[m]);
            const uint64_t d_hi = b_desc(wb + 32 * j);
#pragma unroll
            for (int m = 0; m < MW; ++m) {
              if constexpr (kBf16) {
                wgmma_bf16<N>(acc[m], fh[j & 1][m], d_hi);
              } else {
                const uint64_t d_lo = b_desc(wb + kSlice + 32 * j);
                wgmma_tf32<N>(acc[m], fh[j & 1][m], d_hi);
                wgmma_tf32<N>(acc[m], fh[j & 1][m], d_lo);
                wgmma_tf32<N>(acc[m], fl[j & 1][m], d_hi);
              }
            }
            wgmma_commit();
#pragma unroll
            for (int m = 0; m < MW; ++m) fence_regs(acc[m]);
            wgmma_wait<1>();
            // the stage before: its last step's products are done
            if (j == 0 && last >= 0) release(last);
          }
          last = stage;
        } else {
          release(stage);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MW; ++m) fence_regs(acc[m]);
      if (last >= 0) release(last);

      // XW from the accumulators as they stand: this warp's m-tile of each
      // m64 tile, a 16-byte word a lane an n-tile
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        const int q = tile * (BM / 16) + 4 * (wg * MW + m) + w4;
        if (!kStores || q >= a.q_total) continue;
        float4* out = a.xw + (size_t)q * NT * 32 + lane;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          out[j * 32] = make_float4(acc[m][4 * j], acc[m][4 * j + 1], acc[m][4 * j + 2],
                                    acc[m][4 * j + 3]);
      }
    }
  }
  // no block leaves while the other may still signal its barriers or
  // write its stages
  __syncwarp();
  if constexpr (kCl > 1) cluster_sync();
}

// a (n, k_pad) table's map: boxes of one K slice (128 bytes) x `rows` rows,
// 128-byte swizzle
bool encode_table(CUtensorMap* map, const void* table, bool bf16, int kp, int n, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const size_t elem = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)kp * elem};
  const cuuint32_t box[2] = {(cuuint32_t)k_slice(bf16), (cuuint32_t)rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(table), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename S, int N, bool kResident>
cudaError_t launch(const ProjArgs& a, const void* w_hi, const void* w_lo, int kp,
                   cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<S, __nv_bfloat16>::value;
  constexpr int kCl = kResident ? 1 : kCluster;
  auto kernel = projection_wgmma_kernel<S, N, kResident>;
  const int smem = smem_bytes(kBf16, kResident, kp, N, a.stages);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap hi, lo;
  const int box_rows = N / kCl;
  if (!encode_table(&hi, w_hi, kBf16, kp, N, box_rows) ||
      !encode_table(&lo, kBf16 ? w_hi : w_lo, kBf16, kp, N, box_rows))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // one block an SM: as many clusters as are resident at once
  int clusters = sms / kCl;
  if (kCl > 1) {
    static int active = 0;  // the same on every card of a host
    if (!active) {
      cfg.gridDim = dim3(kCl * clusters);
      if ((err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg)) != cudaSuccess)
        return err;
    }
    if (active > 0 && active < clusters) clusters = active;
  }
  const int pairs = (a.n_tiles + kCl - 1) / kCl;
  cfg.gridDim = dim3(kCl * (clusters < pairs ? clusters : pairs));
  err = cudaLaunchKernelEx(&cfg, kernel, a, hi, lo);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// N = G U_p: the GRU's 48 .. 192 and the LSTM's 64 .. 256
#define TSC_PJW_WIDTHS(X) X(48) X(64) X(96) X(128) X(144) X(192) X(256)

template <typename S, bool kResident>
cudaError_t dispatch(int n, const ProjArgs& a, const void* w_hi, const void* w_lo, int kp,
                     cudaStream_t stream) {
#define TSC_PJW_CASE(w) \
  if (n == w) return launch<S, w, kResident>(a, w_hi, w_lo, kp, stream);
  TSC_PJW_WIDTHS(TSC_PJW_CASE)
#undef TSC_PJW_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x (batch, T, D) f32 (bf16_math 0) or bf16 (1), in the mode's type, on
// an element boundary; w_hi, w_lo W's hi and lo tables (N, k_pad) f32, or
// w_hi its (N, k_pad) bf16 table (w_lo unused), k_pad = D up to a K slice
// (ops/rnn_projection.py::pack_wgmma); bias (N,) f32; N = G U_p columns;
// writes xw ((batch + 15) / 16, T, N / 8, 32, 4) f32.  Returns the
// launch's cudaError_t; cudaErrorInvalidValue for an argument out of range
// or an N without an instantiation.
extern "C" int tsc_rnn_projection_wgmma(const void* x, int x_bf16, int batch, int T, int D,
                                        int N, const void* w_hi, const void* w_lo,
                                        int kp, const void* bias, void* xw, int bf16_math,
                                        void* stream) {
  const bool bf16 = bf16_math != 0;
  if (!x || !w_hi || (!bf16 && !w_lo) || !bias || !xw || batch <= 0 || T <= 0 ||
      D <= 0 || N <= 0 || N % 16 || x_bf16 != bf16_math || kp != k_pad(D, bf16) ||
      reinterpret_cast<uintptr_t>(x) % (bf16 ? 2 : 4) ||
      reinterpret_cast<uintptr_t>(w_hi) % 16 ||
      (!bf16 && reinterpret_cast<uintptr_t>(w_lo) % 16))
    return cudaErrorInvalidValue;
  const long long q_total = (long long)((batch + 15) / 16) * T;
  if (q_total > (1ll << 30) || (long long)batch * T > 0x7fffffffLL) return cudaErrorInvalidValue;
  ProjArgs a;
  a.x = x;
  a.bias = static_cast<const float*>(bias);
  a.xw = static_cast<float4*>(xw);
  a.batch = batch;
  a.T = T;
  a.D = D;
  a.q_total = (int)q_total;
  a.n_tiles = (int)((q_total + tile_rows(N) / 16 - 1) / (tile_rows(N) / 16));
  a.k_steps = kp / k_slice(bf16);
  const int resident = bf16 ? ring_stages(true, true, kp, N) : 0;
  const bool keep = resident >= kResidentStages;
  a.stages = keep ? resident : ring_stages(bf16, false, kp, N);
  if (a.stages < 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!bf16)
    err = dispatch<float, false>(N, a, w_hi, w_lo, kp, s);
  else if (keep)
    err = dispatch<__nv_bfloat16, true>(N, a, w_hi, w_lo, kp, s);
  else
    err = dispatch<__nv_bfloat16, false>(N, a, w_hi, w_lo, kp, s);
  return static_cast<int>(err);
}
