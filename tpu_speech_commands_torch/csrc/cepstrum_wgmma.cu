// The cepstrum kernel: the end of the MFCC / bark frontend's contract for the
// configs whose DCT columns leave the FFT body's block too little room,
// hand-written for Hopper (sm_90a) on the tensor cores.
//
// Replaces, for those configs, the epilogue of the TPU kernel
// tpu_speech_commands/ops/pallas_frontend.py::_make_ct_frontend (pallas_call
// at :745): the DCT product of the log-mel rows (:711), the energy column
// (:713), the deltas (`_kernel_deltas`, :716) and the store.  The register
// or wide FFT body (csrc/register_fft.cuh) runs in log-mel mode before it
// and writes each kept frame's n_filt log-mel values and its log energy to
// a (B, T, n_filt + 1) f32 buffer on the device; this kernel finishes:
//
//   logmel (B, T, n_filt + 1) f32  ->  (B, T, F) or (T, B, F), f32 | bf16
//   c[t, 0] = logmel[t, n_filt]                        (the log energy)
//   c[t, i] = sum_m logmel[t, m] * dct_t[m, i],   0 < i < n_mfcc
//   optional deltas c[t] - c[t-1] (zero for the first kept frame); F =
//   n_mfcc or 2 n_mfcc
//
// What bounds it on this card: the operations, 2 B T n_filt (n_mfcc - 1),
// at the 3xTF32 rate (three TF32 products for each: 495 / 3 = 165
// TFLOP/s).  At n_fft 4352 with 600 filters and coefficients, B = 8192
// windows of 23 frames: 135.4 GFLOP, 0.8206 ms, above the 0.2702 ms of its
// bytes (the rows read once, 453 MB; the features written once, 452 MB).
// At n_fft 1024 with 240 filters and 20 coefficients (30 frames) the bytes
// bind: 2.24 GFLOP take 0.0136 ms, the 256.6 MB 0.0766 ms.
//
// Design (ops/cepstrum_plan.py holds its tile, its tables and a numpy
// emulation of its maps and its split).  The GEMM is the rows against the
// DCT's columns extended by the energy (ext[m][i] = dct_t[m][i] for 0 < i <
// n_mfcc, ext[n_filt][0] = 1), so every output column comes from one
// product.
// - 3xTF32: each f32 operand x is split into hi = tf32(x) and lo = tf32(x -
//   hi), both rounded to nearest by cvt.rna (wgmma reads only the top 19
//   bits of a TF32 operand: an unsplit f32 would be truncated), and each
//   product is hi.hi + hi.lo + lo.hi in f32 accumulators (the dropped lo.lo
//   is about 2^-22 of it).  The table is split once on the host, into two
//   (n_pad, k_pad) tables, K-major as TF32 wgmma reads B.  The rows are
//   split in registers: A comes from registers (each warp of a wgmma holds
//   16 rows in the mma.m16n8k8 TF32 fragment), so each element is read from
//   shared memory once, by the thread that holds it, and split by two cvt
//   and a subtract: no second copy of the rows in shared memory, and no
//   proxy fence between a split and its products.
// - A block: two consumer warpgroups of 64 rows and a producer warpgroup.
//   It computes a 128 x BN tile of whole windows, wpb = max(1, 128 / T) of
//   them (5 x 23 frames, 4 x 30), so that a delta's row before lies in the
//   tile; a window longer than 128 frames runs in chunks of 128 rows, the
//   last row of each carried to the next.  The N tiles of one M tile are
//   consecutive blocks, which share its rows through the L2.
// - The column tile BN is a multiple of 8 sized to the coefficients
//   (cepstrum_plan.n_tile: 24 at 20 coefficients, 3 x 200 at 600), one
//   instantiation each from 8 to TSC_CEPW_MAX_BN; two blocks an SM up to
//   TSC_CEPW_TWO_BLOCK_BN, else one with the consumers' registers raised by
//   setmaxnreg.
// - The ring: K in slices of 32 floats (128 bytes: one row of the 128-byte
//   swizzle) through as many stages as the block's shared memory holds (3
//   .. 8), each with a full and an empty mbarrier.  The producer warpgroup
//   fills a stage: one thread the two tables' slices by TMA, every thread
//   some of the rows' by 16-byte cp.async.  A row of n_filt + 1 floats is
//   not 16-byte aligned, so TMA cannot take the rows; each row's slice
//   comes as its window, the 9 aligned 16-byte chunks from the one at or
//   below its first element (36 floats, the stage's row), and the
//   consumers read it from its shift into the window (the same for all of
//   a row's slices).  Past the rows' buffer a chunk is zero-filled; the
//   floats past a row's K are the next row's, met by the table's zero rows;
//   rows past the block's are left as they are (a row's products touch
//   only its own outputs).  Each thread's copies complete on the full
//   barrier (cp.async.mbarrier.arrive.noinc).
// - The consumers, for each k8 step: the fragment's split, then three
//   wgmma.mma_async m64nBNk8 .tf32 into the same accumulators, committed as
//   one group; the next step's fragment is split while the group runs (two
//   fragment buffers, wait_group 1), and a stage is released when its last
//   group is done.
// - The epilogue stages the accumulators in shared memory over the ring
//   (the row before lies in another thread's fragment; a pitch of BN + 4
//   floats), then stores a warp a row, columns on consecutive lanes, batch-
//   or time-major, f32 or bf16, with the deltas.  The producer starts a
//   window's next chunk only when the epilogue has freed the ring.
// - The ring's first version, with the rows by 4-byte copies (a warp a row)
//   and the store an element a thread, took 2.13 ms at 600 x 600 on an H100
//   against 1.48 (dev/cepstrum_ablation.py --parts alone).
//
// A compile-time switch for dev/cepstrum_ablation.py --parts cuts (the
// shipped kernel takes the default; a cut's output is not the function):
// TSC_CEPW_CUT 1: one product a k8 step (hi.hi) in place of three; 2: no
// row copies (the rows' stages keep what they hold); 3: no stores; 4: all
// three.
//
// csrc/cepstrum.cu, the first design (FFMA on the SIMT cores), computes the
// same function; `_simt=True` runs it for the A/B.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dft_common.cuh"
#include "hopper_ring.cuh"

// The tile (ops/cepstrum_plan.py mirrors these; tests/test_torch_cepstrum.py
// holds the two together)
#define TSC_CEPW_BM 128          // rows (frames) a tile: two warpgroups of 64
#define TSC_CEPW_BK 32           // the K slice a stage (floats)
#define TSC_CEPW_MAX_BN 224      // the widest column tile
#define TSC_CEPW_APITCH 36       // floats a row of the rows' stage: its window
#define TSC_CEPW_THREADS 384     // two consumer warpgroups and a producer one
#define TSC_CEPW_MAX_STAGES 8    // the ring's most stages
#define TSC_CEPW_TWO_BLOCK_BN 32 // the widest tile run two blocks an SM

#ifndef TSC_CEPW_CUT
#define TSC_CEPW_CUT 0
#endif

namespace {

using namespace tsc_dft;
using namespace tsc_ring;

constexpr int kBM = TSC_CEPW_BM, kBK = TSC_CEPW_BK, kMaxBN = TSC_CEPW_MAX_BN;
constexpr int kAPitch = TSC_CEPW_APITCH;
constexpr int kThreads = TSC_CEPW_THREADS;
constexpr int kConsumers = 256;  // the two consumer warpgroups
constexpr int kProducers = kThreads - kConsumers;
constexpr int kCut = TSC_CEPW_CUT;
constexpr bool kAllProducts = kCut != 1 && kCut != 4;
constexpr bool kRowCopies = kCut != 2 && kCut != 4;
constexpr bool kStores = kCut != 3 && kCut != 4;
// shared memory on an H100: a block's opt-in limit, an SM's, and what the
// runtime reserves a block (ops/fft_plan.py's SMEM_*)
constexpr int kSmemOptin = 232448, kSmemPerSm = 233472, kSmemReserved = 1024;
// registers a thread after setmaxnreg (one block an SM): the consumers take
// what the producer warpgroup gives up (128 x 40 + 256 x 232 <= 65536)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// a row's window in the rows' stage: the 16-byte chunks that cover its K
// slice of 32 floats from the one at or below its first element
constexpr int kChunks = (kBK + 4) / 4;
static_assert(kAPitch == 4 * kChunks, "a row of the rows' stage is its window");

// A column tile's ring: a stage holds the tables' K slices (hi, then lo;
// BN rows of 128 bytes each, in the 128-byte swizzle) and the rows' slice
// (kBM rows at kAPitch); after each chunk's K loop the staged tile
// (kBM rows of kPitch floats) lies over it.  Then the carried row and the
// barriers: a full and an empty one a stage, and the tile's.
// ops/cepstrum_plan.py's stage_bytes / ring_stages / wgmma_smem_bytes
// mirror these.
template <int BN>
struct Tile {
  static constexpr int kBlocks = BN <= TSC_CEPW_TWO_BLOCK_BN ? 2 : 1;
  static constexpr int kTableBytes = BN * kBK * 4;
  static constexpr int kStageBytes = 2 * kTableBytes + kBM * kAPitch * 4;
  static constexpr int kPitch = BN + 4;
  static constexpr int fixed(int stages) { return 1024 + 4 * BN + 8 * (2 * stages + 1); }
  static constexpr int stages() {
    const int per_sm = kSmemPerSm / kBlocks - kSmemReserved;
    const int budget = per_sm < kSmemOptin ? per_sm : kSmemOptin;
    int s = TSC_CEPW_MAX_STAGES;
    while (s > 0 && fixed(s) + s * kStageBytes > budget) --s;
    return s;
  }
  static constexpr int kStages = stages();
  static constexpr int kSmemBytes = kStages * kStageBytes + fixed(kStages);
  static_assert(BN % 8 == 0 && BN <= kMaxBN, "a wgmma width");
  static_assert(kStages >= 3, "a ring of three stages or more");
  static_assert(kTableBytes % 1024 == 0 && kStageBytes % 1024 == 0,
                "every table slice on a 1024-byte boundary (the swizzle)");
  static_assert(kBM * kPitch * 4 <= kStages * kStageBytes, "the tile fits the ring");
};

struct CepArgs {
  const float* logmel;  // (batch, n_features, n_filt + 1)
  void* out;
  int batch, n_features, n_filt, n_mfcc, n_tiles, wpb, k_steps;
  int emit_deltas, time_major, out_bf16;
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

// the 16-byte chunk at src (16-byte aligned) into dst, its floats outside
// [lo, hi) zero: one 16-byte copy, or, at the ends of the rows' buffer,
// four 4-byte ones
__device__ __forceinline__ void copy_chunk(uint32_t dst, const float* src, const float* lo,
                                           const float* hi) {
  if (src >= lo && src + 4 <= hi) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = src + e >= lo && src + e < hi;
      cp_async4(dst + 4 * e, in ? src + e : lo, in);
    }
  }
}

// a row's window offset: its K slices start `window_shift` floats into
// their windows (a slice starts a multiple of 32 floats into the row)
__device__ __forceinline__ int window_shift(const float* row) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
}

// an arrive on `bar` when this thread's cp.async copies so far have landed,
// counted as one of the barrier's expected arrivals
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

// the box at (c0, c1) of a 2-D tensor map into `dst`, completing `bar`'s
// transaction bytes
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// x = hi + lo + (about 2^-22 x): hi = tf32(x), lo = tf32(x - hi), both
// rounded to nearest (ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

#define TSC_ACC_1 "%0, %1, %2, %3"
#define TSC_D_1(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define TSC_AB_1 "{%4, %5, %6, %7}, %8"
#define TSC_ACC_2 TSC_ACC_1 ", %4, %5, %6, %7"
#define TSC_D_2(d) \
  TSC_D_1(d), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define TSC_AB_2 "{%8, %9, %10, %11}, %12"
#define TSC_ACC_3 TSC_ACC_2 ", %8, %9, %10, %11"
#define TSC_D_3(d) \
  TSC_D_2(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
#define TSC_AB_3 "{%12, %13, %14, %15}, %16"
#define TSC_ACC_4 TSC_ACC_3 ", %12, %13, %14, %15"
#define TSC_D_4(d) \
  TSC_D_3(d), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define TSC_AB_4 "{%16, %17, %18, %19}, %20"
#define TSC_ACC_5 TSC_ACC_4 ", %16, %17, %18, %19"
#define TSC_D_5(d) \
  TSC_D_4(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
#define TSC_AB_5 "{%20, %21, %22, %23}, %24"
#define TSC_ACC_6 TSC_ACC_5 ", %20, %21, %22, %23"
#define TSC_D_6(d) \
  TSC_D_5(d), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
#define TSC_AB_6 "{%24, %25, %26, %27}, %28"
#define TSC_ACC_7 TSC_ACC_6 ", %24, %25, %26, %27"
#define TSC_D_7(d) \
  TSC_D_6(d), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
#define TSC_AB_7 "{%28, %29, %30, %31}, %32"
#define TSC_ACC_8 TSC_ACC_7 ", %28, %29, %30, %31"
#define TSC_D_8(d) \
  TSC_D_7(d), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define TSC_AB_8 "{%32, %33, %34, %35}, %36"
#define TSC_ACC_9 TSC_ACC_8 ", %32, %33, %34, %35"
#define TSC_D_9(d) \
  TSC_D_8(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
#define TSC_AB_9 "{%36, %37, %38, %39}, %40"
#define TSC_ACC_10 TSC_ACC_9 ", %36, %37, %38, %39"
#define TSC_D_10(d) \
  TSC_D_9(d), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define TSC_AB_10 "{%40, %41, %42, %43}, %44"
#define TSC_ACC_11 TSC_ACC_10 ", %40, %41, %42, %43"
#define TSC_D_11(d) \
  TSC_D_10(d), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
#define TSC_AB_11 "{%44, %45, %46, %47}, %48"
#define TSC_ACC_12 TSC_ACC_11 ", %44, %45, %46, %47"
#define TSC_D_12(d) \
  TSC_D_11(d), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
#define TSC_AB_12 "{%48, %49, %50, %51}, %52"
#define TSC_ACC_13 TSC_ACC_12 ", %48, %49, %50, %51"
#define TSC_D_13(d) \
  TSC_D_12(d), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
#define TSC_AB_13 "{%52, %53, %54, %55}, %56"
#define TSC_ACC_14 TSC_ACC_13 ", %52, %53, %54, %55"
#define TSC_D_14(d) \
  TSC_D_13(d), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
#define TSC_AB_14 "{%56, %57, %58, %59}, %60"
#define TSC_ACC_15 TSC_ACC_14 ", %56, %57, %58, %59"
#define TSC_D_15(d) \
  TSC_D_14(d), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
#define TSC_AB_15 "{%60, %61, %62, %63}, %64"
#define TSC_ACC_16 TSC_ACC_15 ", %60, %61, %62, %63"
#define TSC_D_16(d) \
  TSC_D_15(d), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define TSC_AB_16 "{%64, %65, %66, %67}, %68"
#define TSC_ACC_17 TSC_ACC_16 ", %64, %65, %66, %67"
#define TSC_D_17(d) \
  TSC_D_16(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
#define TSC_AB_17 "{%68, %69, %70, %71}, %72"
#define TSC_ACC_18 TSC_ACC_17 ", %68, %69, %70, %71"
#define TSC_D_18(d) \
  TSC_D_17(d), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
#define TSC_AB_18 "{%72, %73, %74, %75}, %76"
#define TSC_ACC_19 TSC_ACC_18 ", %72, %73, %74, %75"
#define TSC_D_19(d) \
  TSC_D_18(d), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
#define TSC_AB_19 "{%76, %77, %78, %79}, %80"
#define TSC_ACC_20 TSC_ACC_19 ", %76, %77, %78, %79"
#define TSC_D_20(d) \
  TSC_D_19(d), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
#define TSC_AB_20 "{%80, %81, %82, %83}, %84"
#define TSC_ACC_21 TSC_ACC_20 ", %80, %81, %82, %83"
#define TSC_D_21(d) \
  TSC_D_20(d), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83])
#define TSC_AB_21 "{%84, %85, %86, %87}, %88"
#define TSC_ACC_22 TSC_ACC_21 ", %84, %85, %86, %87"
#define TSC_D_22(d) \
  TSC_D_21(d), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
#define TSC_AB_22 "{%88, %89, %90, %91}, %92"
#define TSC_ACC_23 TSC_ACC_22 ", %88, %89, %90, %91"
#define TSC_D_23(d) \
  TSC_D_22(d), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91])
#define TSC_AB_23 "{%92, %93, %94, %95}, %96"
#define TSC_ACC_24 TSC_ACC_23 ", %92, %93, %94, %95"
#define TSC_D_24(d) \
  TSC_D_23(d), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
#define TSC_AB_24 "{%96, %97, %98, %99}, %100"
#define TSC_ACC_25 TSC_ACC_24 ", %96, %97, %98, %99"
#define TSC_D_25(d) \
  TSC_D_24(d), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
#define TSC_AB_25 "{%100, %101, %102, %103}, %104"
#define TSC_ACC_26 TSC_ACC_25 ", %100, %101, %102, %103"
#define TSC_D_26(d) \
  TSC_D_25(d), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
#define TSC_AB_26 "{%104, %105, %106, %107}, %108"
#define TSC_ACC_27 TSC_ACC_26 ", %104, %105, %106, %107"
#define TSC_D_27(d) \
  TSC_D_26(d), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107])
#define TSC_AB_27 "{%108, %109, %110, %111}, %112"
#define TSC_ACC_28 TSC_ACC_27 ", %108, %109, %110, %111"
#define TSC_D_28(d) \
  TSC_D_27(d), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
#define TSC_AB_28 "{%112, %113, %114, %115}, %116"

// d[0 .. BN / 2) (64 x BN f32: the m64nBN accumulator fragment) += a (64 x 8
// tf32: registers, the mma.m16n8k8 TF32 A layout a warp) * b (8 x BN tf32:
// shared memory, K-major in the 128-byte swizzle, descriptor `desc`).
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t desc);

#define TSC_WGMMA_TF32(n8, N)                                                       \
  template <>                                                                       \
  __device__ __forceinline__ void wgmma_tf32<N>(                                    \
      float(&d)[4 * n8], const uint32_t(&a)[4], uint64_t desc) {                    \
    asm volatile(                                                                   \
        "{\n"                                                                       \
        ".reg .pred p;\n"                                                           \
        ".reg .b32 one;\n"                                                          \
        "mov.b32 one, 1;\n"                                                         \
        "setp.ne.b32 p, one, 0;\n"                                                  \
        "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" TSC_ACC_##n8  \
        "}, " TSC_AB_##n8 ", p, 1, 1;\n"                                            \
        "}\n"                                                                       \
        : TSC_D_##n8(d)                                                             \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));                   \
  }

TSC_WGMMA_TF32(1, 8)
TSC_WGMMA_TF32(2, 16)
TSC_WGMMA_TF32(3, 24)
TSC_WGMMA_TF32(4, 32)
TSC_WGMMA_TF32(5, 40)
TSC_WGMMA_TF32(6, 48)
TSC_WGMMA_TF32(7, 56)
TSC_WGMMA_TF32(8, 64)
TSC_WGMMA_TF32(9, 72)
TSC_WGMMA_TF32(10, 80)
TSC_WGMMA_TF32(11, 88)
TSC_WGMMA_TF32(12, 96)
TSC_WGMMA_TF32(13, 104)
TSC_WGMMA_TF32(14, 112)
TSC_WGMMA_TF32(15, 120)
TSC_WGMMA_TF32(16, 128)
TSC_WGMMA_TF32(17, 136)
TSC_WGMMA_TF32(18, 144)
TSC_WGMMA_TF32(19, 152)
TSC_WGMMA_TF32(20, 160)
TSC_WGMMA_TF32(21, 168)
TSC_WGMMA_TF32(22, 176)
TSC_WGMMA_TF32(23, 184)
TSC_WGMMA_TF32(24, 192)
TSC_WGMMA_TF32(25, 200)
TSC_WGMMA_TF32(26, 208)
TSC_WGMMA_TF32(27, 216)
TSC_WGMMA_TF32(28, 224)

// The staged tile's rows c0 .. c0 + n_rows - 1 of the block's to out, a warp
// a row (consumer warp w the rows w, w + 8, ...), the columns n0 .. n0 +
// n_cols - 1 on consecutive lanes, batch- or time-major, with the deltas
// from the row before (the carried row for the chunk's first)
template <typename OutT>
__device__ __forceinline__ void store_rows(OutT* out, const CepArgs& a, const float* tile,
                                           const float* carry, int pitch, int c0, int n_rows,
                                           int w0, int n0, int n_cols, int F, int warp,
                                           int lane) {
  const int T = a.n_features;
  for (int r = warp; r < n_rows; r += kConsumers / 32) {
    const int g = c0 + r;  // the block's row: window w0 + g / T, frame g % T
    const int b = w0 + g / T, tt = g % T;
    const size_t row = a.time_major ? (size_t)tt * a.batch + b : (size_t)b * T + tt;
    OutT* o = out + row * F + n0;
    const float* v = tile + r * pitch;
    const float* prev = r ? v - pitch : carry;
    for (int c = lane; c < n_cols; c += 32) {
      store_out(o + c, v[c]);
      if (a.emit_deltas) store_out(o + a.n_mfcc + c, tt ? v[c] - prev[c] : 0.0f);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(TSC_CEPW_THREADS, Tile<BN>::kBlocks)
    cepstrum_wgmma_kernel(const CepArgs a, const __grid_constant__ CUtensorMap map_hi,
                          const __grid_constant__ CUtensorMap map_lo) {
  using TL = Tile<BN>;
  constexpr int kStages = TL::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_addr(base);
  float* tile = reinterpret_cast<float*>(base);  // over the ring, after a K loop
  float* carry = reinterpret_cast<float*>(base + kStages * TL::kStageBytes);
  const uint32_t full0 = smem_addr(carry + BN);  // kStages full barriers
  const uint32_t empty0 = full0 + 8 * kStages;   // then as many empty ones
  const uint32_t tile_free = empty0 + 8 * kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = (blockIdx.x % a.n_tiles) * BN;
  const int w0 = (blockIdx.x / a.n_tiles) * a.wpb;
  const int T = a.n_features, K = a.n_filt + 1;
  const int rows = min(a.wpb, a.batch - w0) * T;  // the block's rows

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the producer's threads' copies, and the TMA thread's arrive with
      // its byte count
      mbar_init(full0 + 8 * s, kProducers + 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // each consumer warp
    }
    mbar_init(tile_free, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ---- the producer warpgroup: a stage's rows by 16-byte copies, each
    // row's window of kChunks chunks (consecutive threads on consecutive
    // chunks), and the tables' slices by TMA
    if constexpr (TL::kBlocks == 1) setmaxnreg_dec<kProducerRegs>();
    const int pt = tid - kConsumers;
    const float* end = a.logmel + (size_t)a.batch * T * K;
    int stage = 0;
    uint32_t phase = 0;
    for (int c0 = 0, chunk = 0; c0 < rows; c0 += kBM, ++chunk) {
      if (chunk) mbar_wait(tile_free, (chunk - 1) & 1);  // the epilogue is done
      const int m_hi = min(kBM, rows - c0);
      const float* A = a.logmel + ((size_t)w0 * T + c0) * K;
      for (int kt = 0; kt < a.k_steps; ++kt) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t st = ring + stage * TL::kStageBytes;
        const uint32_t full = full0 + 8 * stage;
        if (pt == 0) {
          mbar_expect_tx(full, 2 * TL::kTableBytes);
          tma_load_2d(st, &map_hi, full, kt * kBK, n0);
          tma_load_2d(st + TL::kTableBytes, &map_lo, full, kt * kBK, n0);
        }
        // rows past m_hi are left as they are: a row's products touch only
        // its own outputs, which are not stored
        const uint32_t dst = st + 2 * TL::kTableBytes;
        for (int i = pt; i < (kRowCopies ? m_hi * kChunks : 0); i += kProducers) {
          const int m = i / kChunks;
          const float* slice = A + (size_t)m * K + kt * kBK;
          const float* window = reinterpret_cast<const float*>(
              reinterpret_cast<uintptr_t>(slice) & ~uintptr_t(15));
          copy_chunk(dst + 16 * i, window + 4 * (i - m * kChunks), a.logmel, end);
        }
        cp_async_arrive_noinc(full);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63, warp
    // wq of it 16 of them; this thread rows r0 and r0 + 8, and in the
    // accumulators' n8 block j columns 8 j + 2 t and + 1
    if constexpr (TL::kBlocks == 1) setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2, wq = warp & 3;
    const int t = lane & 3;
    const int r0 = 64 * wg + 16 * wq + (lane >> 2);
    const int F = a.emit_deltas ? 2 * a.n_mfcc : a.n_mfcc;
    const int n_cols = min(BN, a.n_mfcc - n0);
    constexpr int kPitch = TL::kPitch;
    int stage = 0;
    uint32_t phase = 0;
    for (int c0 = 0; c0 < rows; c0 += kBM) {
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      uint32_t hi[2][4], lo[2][4];  // the k8 steps' fragments, double-buffered
      int last = 0;                 // the stage of the step before
      // each of this thread's rows starts its window's shift into it
      const float* row0 = a.logmel + ((size_t)w0 * T + c0 + r0) * K;
      const int sh0 = r0 * kAPitch + window_shift(row0) + t;
      const int sh1 = (r0 + 8) * kAPitch + window_shift(row0 + 8 * (size_t)K) + t;
      for (int kt = 0; kt < a.k_steps; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t st = ring + stage * TL::kStageBytes;
        const float* as = reinterpret_cast<const float*>(
            base + stage * TL::kStageBytes + 2 * TL::kTableBytes);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          // the fragment: (r0, k), (r0 + 8, k), (r0, k + 4), (r0 + 8, k + 4)
          // at k = 8 j + t; its buffer's last products (two steps back) are
          // done
          uint32_t(&h)[4] = hi[j & 1];
          uint32_t(&l)[4] = lo[j & 1];
          split_tf32(as[sh0 + 8 * j], h[0], l[0]);
          split_tf32(as[sh1 + 8 * j], h[1], l[1]);
          split_tf32(as[sh0 + 8 * j + 4], h[2], l[2]);
          split_tf32(as[sh1 + 8 * j + 4], h[3], l[3]);
          const uint64_t d_hi = b_desc(st + 32 * j);
          const uint64_t d_lo = b_desc(st + TL::kTableBytes + 32 * j);
          wgmma_fence();
          fence_regs(acc);
          wgmma_tf32<BN>(acc, h, d_hi);
          if constexpr (kAllProducts) {
            wgmma_tf32<BN>(acc, h, d_lo);
            wgmma_tf32<BN>(acc, l, d_hi);
          }
          wgmma_commit();
          fence_regs(acc);
          wgmma_wait<1>();
          // the stage before: its last step's products are done
          if (j == 0 && kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * last);
        }
        last = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * last);
      consumers_sync();  // every consumer's products are done: the tile over the ring

#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(tile + r0 * kPitch + c) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(tile + (r0 + 8) * kPitch + c) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      consumers_sync();
      const int n_rows = min(kBM, rows - c0);
      if constexpr (kStores) {
        if (a.out_bf16)
          store_rows(static_cast<__nv_bfloat16*>(a.out), a, tile, carry, kPitch, c0, n_rows,
                     w0, n0, n_cols, F, warp, lane);
        else
          store_rows(static_cast<float*>(a.out), a, tile, carry, kPitch, c0, n_rows, w0,
                     n0, n_cols, F, warp, lane);
      }
      if (c0 + kBM < rows) {  // a window of more than kBM frames: its next chunk
        consumers_sync();
        for (int c = tid; c < BN; c += kConsumers) carry[c] = tile[(kBM - 1) * kPitch + c];
        // the tile's reads before the producer's copies land over it
        fence_proxy_async();
        mbar_arrive(tile_free);
      }
    }
  }
}

template <int BN>
cudaError_t launch(const CepArgs& a, const CUtensorMap& hi, const CUtensorMap& lo,
                   unsigned blocks, cudaStream_t stream) {
  auto kernel = cepstrum_wgmma_kernel<BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, Tile<BN>::kSmemBytes, stream>>>(a, hi, lo);
  return cudaGetLastError();
}

// the instantiation of column tile `bn` (a multiple of 8 up to kMaxBN)
template <int BN>
cudaError_t launch_tile(int bn, const CepArgs& a, const CUtensorMap& hi,
                        const CUtensorMap& lo, unsigned blocks, cudaStream_t stream) {
  if (bn == BN) return launch<BN>(a, hi, lo, blocks, stream);
  if constexpr (BN + 8 <= kMaxBN) {
    return launch_tile<BN + 8>(bn, a, hi, lo, blocks, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

// a (n_pad, k_pad) f32 table's map: boxes of 32 k x bn rows, 128-byte swizzle
bool encode_table(CUtensorMap* map, const void* table, int k_pad, int n_pad, int bn) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k_pad, (cuuint64_t)n_pad};
  const cuuint64_t strides[1] = {(cuuint64_t)k_pad * sizeof(float)};
  const cuuint32_t box[2] = {kBK, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(table), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// logmel (batch, n_features, n_filt + 1) f32 on the device (the FFT body's
// log-mel mode); table_hi, table_lo (n_pad, k_pad) f32, 16-byte aligned,
// ops/cepstrum_plan.py::split_tables (k_pad >= n_filt + 1 a multiple of
// TSC_CEPW_BK; n_pad >= n_mfcc whole tiles of n_tile, a multiple of 8 up to
// TSC_CEPW_MAX_BN, the last holding a column below n_mfcc);
// windows_per_block max(1, TSC_CEPW_BM / n_features); out (batch,
// n_features, F) or, time_major, (n_features, batch, F), F = n_mfcc or 2
// n_mfcc with emit_deltas, f32 or bf16.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for an argument out of range).
extern "C" int tsc_cepstrum(const void* logmel, int batch, int n_features, int n_filt,
                            int n_mfcc, const void* table_hi, const void* table_lo,
                            int k_pad, int n_pad, int n_tile, int windows_per_block,
                            int emit_deltas, int time_major, void* out, int out_bf16,
                            void* stream) {
  if (!logmel || !table_hi || !table_lo || !out || batch <= 0 || n_features <= 0 ||
      n_filt <= 0 || n_mfcc <= 0 || n_mfcc > n_filt || k_pad < n_filt + 1 ||
      k_pad % kBK || n_tile < 8 || n_tile > kMaxBN || n_tile % 8 || n_pad < n_mfcc ||
      n_pad % n_tile || n_pad - n_tile >= n_mfcc ||
      reinterpret_cast<uintptr_t>(table_hi) % 16 || reinterpret_cast<uintptr_t>(table_lo) % 16)
    return cudaErrorInvalidValue;
  const int wpb = kBM / n_features > 1 ? kBM / n_features : 1;
  const long long blocks = (long long)((batch + wpb - 1) / wpb) * (n_pad / n_tile);
  if (windows_per_block != wpb || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap map_hi, map_lo;
  if (!encode_table(&map_hi, table_hi, k_pad, n_pad, n_tile) ||
      !encode_table(&map_lo, table_lo, k_pad, n_pad, n_tile))
    return cudaErrorInvalidValue;
  CepArgs a;
  a.logmel = static_cast<const float*>(logmel);
  a.out = out;
  a.batch = batch;
  a.n_features = n_features;
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.n_tiles = n_pad / n_tile;
  a.wpb = wpb;
  a.k_steps = k_pad / kBK;
  a.emit_deltas = emit_deltas;
  a.time_major = time_major;
  a.out_bf16 = out_bf16;
  const cudaError_t err = launch_tile<8>(n_tile, a, map_hi, map_lo, (unsigned)blocks,
                                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
