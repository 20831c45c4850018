// MFCC / bark frontend with the DFT on Hopper's warpgroup tensor-core
// products (the fast_math contract), hand-written for sm_90a: wgmma on a
// TMA-fed ring of the DFT matrix, the filterbank taken from the
// accumulators.
//
// Replaces the TPU kernel tpu_speech_commands/ops/pallas_frontend.py::
// make_fused_frontend (pallas_call at :340) with fast_math=True and
// dft_mode='dense', and tools/dev/pallas_experiments.py::make_bf16_kernel
// (pallas_call at :128), which computes the same contract; the same
// function as csrc/dft_frontend.cu, its first design (mma.sync), which stays
// as the A/B baseline:
//
//   x      = int16 ? pcm * (gain / 32768) : audio * gain          (f32)
//   frames = bf16(x[t*hop : t*hop + K])       K = min(window, n_fft)
//   re, im = frames @ bf16(cos), frames @ bf16(sin)    f32 accumulation
//   power  = (re^2 + im^2) / n_fft
//   mel[m] = safe_log(sum_k power[k] * filt_t[m, k])               (f32)
//   c[0]   = safe_log(sum_k power[k]),  c[i] = sum_m mel[m] dct_t[m, i]
//   optional deltas c[t] - c[t-1] (zero for the first kept frame)
//
// What bounds it on this card: the tensor cores.  At the serving shape (B
// 8192, 30 kept frames of K 1024, 513 bins) the DFT is a GEMM of 245,760 x
// 1,026 x 1,024, 516 GFLOP, 0.52 ms at the dense bf16 rate, against 520 MB
// of audio (0.16 ms).  Before that floor come, in this kernel: the DFT
// matrix (2.1 MB) streamed from L2 once a block, 4.4 TB a call at 2048
// blocks, through a ring that the staged audio (129 KB of the 227) leaves
// 64-80 KB, so the stream is bound by its latency; the audio staging,
// which nothing overlaps (one block an SM); the epilogue on the CUDA cores.
// dev/dft_ablation.py measures each (PERF.md).
//
// Design (ops/dft_plan.py mirrors each map and emulates it on the CPU):
// - A block owns wpb whole windows (4 at the serving shape: 120 of its 128
//   GEMM rows).  Its audio is decoded, gained, rounded to bf16 and staged
//   once in shared memory as hop segments seg_pitch apart (the layout of
//   csrc/dft_frontend.cu, ops/frontend_kernel.py::dft_layout): the frames
//   are never materialised.  Where its rows are 16-byte aligned the audio
//   comes in by bulk copies through the ring's two halves (the ring is
//   idle until the stream starts), converted from there; else by loads.
// - Warp specialisation: warps 0-7 are two consumer warpgroups of 64 rows
//   each, warps 8-11 the producer warpgroup, which gives its registers to
//   the consumers (setmaxnreg).  One lane of the producer keeps a ring of
//   4 or 5 B stages (as many as fit) full with TMA: a stage is a 64-deep
//   K-slice of a 128-column chunk of the DFT matrix, 16 KB in the 128-byte
//   swizzle, with a full and an empty mbarrier.
// - No cluster: each block streams the whole matrix from L2 (the stream
//   alone takes about 0.5 ms a call).  TSC_DFT_CLUSTER=2 shares each stage
//   between two blocks by TMA multicast, half the L2 stream, but couples
//   the pair stage by stage and measured slower.
// - Consumers: A from registers (ldmatrix from the staged audio, the
//   mma.m16n8k16 A layout each warp of a wgmma takes), B from the stage by
//   its descriptor; wgmma.mma_async m64n128k16, bf16 in, f32 accumulators
//   (64 a thread: one chunk).  The last chunk's 16 columns (every n_fft
//   2^k) run m64n16k16; any other part chunk runs the full width on zero
//   rows.  Slice s + 1's products are issued before slice s's are waited
//   for; its stage is then released.  K is padded to 128, two slices, so
//   the slices come in pairs (the A fragments' double buffer) with no
//   branch around a wgmma.
// - The epilogue from the accumulators: the matrix's columns hold cos and
//   sin of one bin side by side, so re and im of a bin sit in one thread
//   (the accumulator layout) and |X|^2 / n_fft is formed in registers.  The
//   host orders the bins so that each lane of a quad walks one run of
//   consecutive bins over all chunks (chunk_bin).  Each bin meets at most kSlots
//   consecutive filters (2 for mel, 4 for bark): slot l holds the filter
//   f = l (mod kSlots) of the bin's window, so a thread keeps one running
//   sum a slot and a row, adds a product a bin, and adds the sum into the
//   shared filter sums (an atomic add) only where the slot's filter
//   changes.  No power tile, no block barrier.  The slots (a key and
//   kSlots weights a bin) sit in shared memory where they fit, else in the
//   device's copy.
// - The two warpgroups run on without waiting for each other: one's
//   epilogue overlaps the other's products as far as the ring lets one run
//   ahead (a stage is refilled when both have released it).
// - After the last chunk: log, the DCT, the energy swap, deltas, and the
//   (B, T, F) store in f32 or bf16 (csrc/dft_common.cuh).  The block keeps
//   only the DCT columns the output uses, 1 .. n_mfcc - 1 (column 0 is the
//   log energy), and filter sums for its windows' rows only, not for all
//   kBM GEMM rows (the padding rows' sums are dropped where they would be
//   added): at many filters those two regions decide how many windows a
//   block holds.
// - Or, in log-mel mode (the runtime flag `logmel`; ops/frontend_kernel.py::
//   dft_cepstrum chooses it from the config, as fft_plan.cepstrum_mode
//   does for the FFT bodies), the block stops after the log: each row's
//   n_filt log filter sums and its log energy go, f32, to a (B, T, n_filt
//   + 1) buffer, and csrc/cepstrum_wgmma.cu finishes the contract (the
//   DCT, deltas, the store); the block then holds no DCT at all.  A filter
//   whose bins all lie in one quad lane's walk is whole in that lane's
//   running sum when its slot releases it, and leaves the block from the
//   registers (kDirect): the lane stores its two rows' sums to their rows
//   of the output as they stand, and after the walk the block takes the
//   safe_log of its rows in place in one coalesced pass (kFinish 0), so
//   no log runs in the walk, where a lane logging the filters it releases
//   keeps the other three of its quad waiting (they release theirs at
//   other bins) on a chain of dependent instructions.  The host marks
//   each filter's home (ops/dft_plan.py::filter_homes): the owner lane, or
//   one of the few boundary filters that several walks weigh (those
//   straddling the runs' three seams or reaching the last chunk's bins),
//   which alone meet in shared memory (n_bnd floats a row, whatever
//   n_filt is), or a filter no bin weighs.  The energy meets across the
//   quad by two shuffles.
//   The block's tail writes the boundary filters and the weightless ones.
//   So the block keeps 4 windows at every filter count (at n_fft 1024).
//   The first log-mel design (the host's `shared_sums`: every filter
//   summed in shared memory, then logged and stored in one coalesced span
//   a block) stays as the A/B; its filter sums cost the block windows.
//
// Compile-time switches for dev/dft_ablation.py (each undoes one choice;
// the shipped kernel takes the defaults): TSC_DFT_CLUSTER (2: TMA
// multicast), TSC_DFT_STAGES (a fixed ring depth), TSC_DFT_POWER_TILE (the
// epilogue through a shared power tile and the packed filterbank, at 3
// stages), TSC_DFT_SERIAL_EPILOGUE (both warpgroups meet at a barrier
// after each chunk's epilogue), TSC_DFT_EARLY_RELEASE (each stage released
// right after its own products) and TSC_DFT_CUT (1: the B stream alone,
// no staging, products or epilogue; 2: no epilogue, where ptxas then
// drops the products too, their accumulators unread; 3: the epilogue
// without its shared-memory adds and, in log-mel mode, without its stores
// from the registers; 4: the audio staging and the tail alone; 5: all but
// the audio staging; 6: log-mel mode's finished filters stored without
// their log, the raw sums) and TSC_DFT_LOGMEL_FINISH, where log-mel mode
// logs its finished filters (0: in the pass after the walk; 1: the owner
// lane where its slot releases them, logf; 2: the same with the SFU's
// __logf; 3: the owner lane appends them to its warp's ring in shared
// memory, 64 entries placed by a ballot, and each time 32 are there the
// warp's 32 lanes log and store one each).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dft_common.cuh"
#include "hopper_ring.cuh"

#ifndef TSC_DFT_CLUSTER
#define TSC_DFT_CLUSTER 1
#endif
#ifndef TSC_DFT_POWER_TILE
#define TSC_DFT_POWER_TILE 0
#endif
#ifndef TSC_DFT_STAGES
#define TSC_DFT_STAGES (TSC_DFT_POWER_TILE ? 3 : 0)
#endif
#ifndef TSC_DFT_SERIAL_EPILOGUE
#define TSC_DFT_SERIAL_EPILOGUE 0
#endif
#ifndef TSC_DFT_CUT
#define TSC_DFT_CUT 0
#endif
#ifndef TSC_DFT_EARLY_RELEASE
#define TSC_DFT_EARLY_RELEASE 0
#endif
#ifndef TSC_DFT_LOGMEL_FINISH
#define TSC_DFT_LOGMEL_FINISH 0
#endif

namespace {

using namespace tsc_dft;
using namespace tsc_ring;

constexpr int kBM = 128;       // GEMM rows (frames) a block: 2 warpgroups x 64
constexpr int kBN = 128;       // DFT columns a chunk (64 bins), the wgmma N
constexpr int kBK = 64;        // K-slice: 128 bytes of bf16, one swizzle row
constexpr int kStages = TSC_DFT_STAGES;  // > 0: every launch's ring depth
constexpr int kMaxStages = 5;
constexpr int kCluster = TSC_DFT_CLUSTER;
constexpr int kStageBytes = kBN * kBK * 2;  // 16 KB
constexpr int kKSteps = kBK / 16;           // k16 products a stage
constexpr int kBoxRows = kBN / kCluster;    // B rows each block of a cluster loads
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// registers a thread after setmaxnreg: the consumers take what the
// producer warpgroup gives up (128 x 40 + 256 x 232 <= 65536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kPPitch = 65;                 // the power tile's pitch (ablation)
constexpr bool kPowerTile = TSC_DFT_POWER_TILE != 0;
// log-mel mode's home codes (ops/dft_plan.py::filter_homes): 0 .. 3 the
// quad lane whose walk alone weighs the filter, from kHomeShared the
// boundary sum code - kHomeShared, kHomeNone a filter no bin weighs
constexpr int kHomeShared = 4;
constexpr int kHomeNone = 255;
// where log-mel mode logs its finished filters (TSC_DFT_LOGMEL_FINISH)
constexpr int kFinish = TSC_DFT_LOGMEL_FINISH;
constexpr bool kStaged = kFinish == 3;  // the ablation's rings a warp
constexpr int kStageCap = 64;  // entries a warp's ring: (v0, v1, g << 16 | f)
static_assert(kFinish >= 0 && kFinish <= 3, "TSC_DFT_LOGMEL_FINISH 0 .. 3");
constexpr int kCut = TSC_DFT_CUT;
static_assert(kCluster == 1 || kCluster == 2, "a cluster of 1 or 2 blocks");
static_assert(kStages == 0 || (kStages >= 2 && kStages <= kMaxStages),
              "a ring of two to five stages");

struct WgArgs {
  const void* audio;
  const float* gain;
  float in_scale;
  int batch, n_samples, hop, first_frame, n_features;
  int wpb, n_seg, seg_pitch, win_pitch;  // the audio layout in shared memory
  int k_pad, n_pad;                      // the DFT matrix (n_pad, k_pad)
  float inv_fft;
  const int* bin_key;    // (n_pad / 2,): the first filter of each bin's slots
  const float* bin_w;    // (n_pad / 2, slots): the weight of each slot's filter
  int table_smem;        // 1: both staged in shared memory (where they fit)
  int stages;            // the ring's depth
  int bulk_stage;        // 1: the audio comes in by bulk copies (aligned rows)
  const float* filt_packed;  // the power-tile ablation: each filter's nonzero
  const int* filt_range;     // bins back to back; (n_filt, 3) lo, hi, offset
  const float* dct_t;    // (n_filt, n_mfcc - 1): the DCT columns 1 .. n_mfcc - 1
  int n_filt, n_mfcc, emit_deltas, vec_loads;
  int logmel;            // 1: (B, T, n_filt + 1) f32 log-mel rows to out
  const uint8_t* filt_home;  // log-mel mode: (n_filt,) each filter's home
  const int* tail_filt;  // (n_tail,) the filters the tail writes: n_bnd
  int n_bnd, n_tail;     // boundary filters, then those no bin weighs
  int in_int16, out_bf16;  // the audio's and the output's types
  void* out;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }
__host__ __device__ inline size_t align1024(size_t v) {
  return (v + 1023) & ~size_t(1023);
}

// The ring of `stages` B stages, reused for the coefficients (kBM x n_mfcc
// f32) after the last chunk
__host__ __device__ inline size_t ring_bytes(int n_mfcc, int stages) {
  const size_t ring = (size_t)stages * kStageBytes;
  const size_t coeffs = sizeof(float) * (size_t)kBM * n_mfcc;
  return align1024(ring > coeffs ? ring : coeffs);
}

// Shared memory, in order from a 1024-byte boundary (the base is aligned
// up, hence the 1024 of slack): the ring, the power tile (ablation only),
// the audio (wpb x win_pitch bf16), the shared sums (mel_rows x sums_pitch
// f32), the k-offset table, the DCT's (n_filt, dct_cols) columns, the
// filter slots (where they fit: `table`, else 0 and read from the device's
// copy), log-mel mode's home codes (and an ablation's rings of finished
// filters), the ring's full and empty mbarriers and the audio staging's
// two pairs.  ops/dft_plan.py::wgmma_smem_bytes mirrors this sum to choose
// wpb.
__host__ __device__ inline size_t table_bytes(int n_pad, int slots) {
  return align16(sizeof(int) * (size_t)(n_pad / 2)) +
         align16(sizeof(float) * (size_t)(n_pad / 2) * slots);
}

// The rows whose filter sums a block keeps: its windows' (the power-tile
// ablation adds into all kBM)
__host__ __device__ inline int mel_rows(int wpb, int n_features) {
  return kPowerTile ? kBM : wpb * n_features;
}

// The DCT columns a block keeps: 1 .. n_mfcc - 1, none in log-mel mode
__host__ __device__ inline int dct_cols(int n_mfcc, int logmel) {
  return logmel ? 0 : n_mfcc - 1;
}

// The floats a row of the shared sums: every filter's and the energy
// (fused, and the first log-mel design), or log-mel mode's n_bnd boundary
// sums (`direct`); odd, so that a quad's rows fall in distinct banks
__host__ __device__ inline int sums_pitch(int n_filt, int n_bnd, int direct) {
  return direct ? (n_bnd | 1) : mel_pitch(n_filt);
}

// log-mel mode's home codes, a byte a filter
__host__ __device__ inline size_t home_bytes(int n_filt, int direct) {
  return direct ? align16((size_t)n_filt) : 0;
}

// log-mel mode's rings of finished filters, one a consumer warp
__host__ __device__ inline size_t staging_bytes(int direct) {
  return direct && kStaged ? align16((size_t)(kConsumers / 32) * kStageCap * 12) : 0;
}

__host__ __device__ inline size_t smem_bytes(int wpb, int win_pitch, int n_filt,
                                             int n_mfcc, int k_pad, size_t table,
                                             int stages, int n_features, int logmel,
                                             int direct, int n_bnd) {
  return 1024 + ring_bytes(n_mfcc, stages) +
         (kPowerTile ? align16(sizeof(float) * kBM * kPPitch) : 0) +
         align16(sizeof(__nv_bfloat16) * (size_t)wpb * win_pitch) +
         align16(sizeof(float) * (size_t)mel_rows(wpb, n_features) *
                 sums_pitch(n_filt, n_bnd, direct)) +
         align16(sizeof(int) * (size_t)(k_pad / 8)) +
         align16(sizeof(float) * (size_t)n_filt * dct_cols(n_mfcc, logmel)) + table +
         home_bytes(n_filt, direct) + staging_bytes(direct) +
         sizeof(uint64_t) * (2 * stages + 4);
}

// ---- clusters, TMA, wgmma (PTX; the ring's common pieces: hopper_ring.cuh) --

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

// the consumer warpgroups' barrier (the producer warpgroup never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// B rows [row, row + kBoxRows) x K columns [k, k + kBK) of the DFT matrix
// into `dst`, completing `bar`'s transaction bytes; with a cluster, into
// the same offset of every block of it, completing each one's `bar`
__device__ __forceinline__ void tma_load_b(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int k, int row) {
  const uint64_t desc = reinterpret_cast<uint64_t>(map);
  if constexpr (kCluster > 1) {
    const uint16_t mask = (1u << kCluster) - 1;
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

// `bytes` (a multiple of 16) from global `src` (16-byte aligned) to shared
// `dst`, completing `bar`'s transaction bytes
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// d[0 .. N / 2) (64 x N f32: the m64nNk16 accumulator fragment) +=
// a (64 x 16 bf16: registers, the mma.m16n8k16 A layout a warp) * b (16 x N
// bf16: shared memory, K-major, descriptor `desc`); d is zeroed first when
// `accumulate` is 0.  One for each chunk width the kernel runs (128, 16).
__device__ __forceinline__ void wgmma_m64n128(float (&d)[kBN / 2], const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n16(float (&d)[kBN / 2], const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[kBN / 2], const uint32_t (&a)[4],
                                      uint64_t desc, int accumulate) {
  if constexpr (N == 128) wgmma_m64n128(d, a, desc, accumulate);
  if constexpr (N == 16) wgmma_m64n16(d, a, desc, accumulate);
}

// log-mel mode's value of a finished sum where it is stored: as it stands
// where the block's pass after the walk logs it (kFinish 0) and in the
// cut 6, else its safe_log (the SFU's log with kFinish 2)
__device__ __forceinline__ float finish_log(float x) {
  if constexpr (kCut == 6 || kFinish == 0) {
    return x;
  } else if constexpr (kFinish == 2) {
    return __logf(fmaxf(x, kLogEps));
  } else {
    return safe_log(x);
  }
}

// *p += v on a shared-memory float, atomically with the quad's other lanes
__device__ __forceinline__ void red_shared_add(float* p, float v) {
  asm volatile("red.shared.add.f32 [%0], %1;\n" ::"r"(smem_addr(p)), "f"(v));
}

// Where one thread's filter sums go: the shared sums of its rows r0, r0 +
// 8 (null: a padding row), and in log-mel mode (kDirect) its quad lane,
// the home codes and the two rows of the output (null past the block's
// rows); with kStaged its warp's ring (values of the first and second
// row, g << 16 | f) and what its drain needs: the block's rows of the
// output, their width, how many there are and the warp's first
struct Sums {
  float *mel0, *mel1;
  float *out0, *out1;
  const uint8_t* home;
  int t;
  float *qv0, *qv1;
  int* qfg;
  float* rows_out;
  int width, rows, rbase, lane;
};

// The running filter sums of one thread: for each of its two rows and
// each slot, the sum over its bins so far of the slot's current filter,
// flushed when the slot's filter changes: added into the shared filter
// sums, or in log-mel mode (kDirect) by the filter's home: stored to the
// output rows by the lane that owns it (`finish_log`), added into the
// shared boundary sums, or dropped (a lane whose walk does not weigh it
// holds exactly 0).
template <int S, bool kDirect>
struct FilterRuns {
  int cur[S];
  float run0[S], run1[S];
  float e0, e1;
  int head, count;  // the warp's ring (kStaged): the same in all its lanes

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int l = 0; l < S; ++l) {
      cur[l] = -1;
      run0[l] = run1[l] = 0.0f;
    }
    e0 = e1 = 0.0f;
    head = count = 0;
  }
  // slot l releases its filter where `release` (every lane of the warp
  // calls this together): added into the shared sums, or in log-mel mode
  // by the filter's home: a boundary filter into the shared boundary sums;
  // the owner lane's (kStaged) appended to the warp's ring, in lane order
  // after its `count` entries, or (else) stored to its rows
  __device__ __forceinline__ void flush(int l, bool release, const Sums& s, int n_filt) {
    const int f = cur[l];
    bool own = false;
    if (release && f >= 0 && f < n_filt) {
      if constexpr (kCut == 3) {  // the cut: sums kept, no adds, no stores
        e0 += 0.0f * run0[l];
        e1 += 0.0f * run1[l];
      } else if constexpr (kDirect) {
        const int code = s.home[f];
        if (code == s.t) {
          if constexpr (kStaged) {
            own = s.out0 != nullptr;
          } else {
            if (s.out0) s.out0[f] = finish_log(run0[l]);
            if (s.out1) s.out1[f] = finish_log(run1[l]);
          }
        } else if (code >= kHomeShared && code != kHomeNone) {
          if (s.mel0) red_shared_add(s.mel0 + (code - kHomeShared), run0[l]);
          if (s.mel1) red_shared_add(s.mel1 + (code - kHomeShared), run1[l]);
        }
      } else {
        if (s.mel0) red_shared_add(s.mel0 + f, run0[l]);
        if (s.mel1) red_shared_add(s.mel1 + f, run1[l]);
      }
    }
    if constexpr (kDirect && kStaged && kCut != 3) {
      const unsigned m = __ballot_sync(0xffffffffu, own);
      if (own) {
        const int at =
            (head + count + __popc(m & ((1u << s.lane) - 1u))) & (kStageCap - 1);
        s.qv0[at] = run0[l];
        s.qv1[at] = run1[l];
        s.qfg[at] = (s.lane >> 2) << 16 | f;
      }
      count += __popc(m);
      if (count >= 32) drain(s, 32);
    }
    if (release) run0[l] = run1[l] = 0.0f;
  }
  // the warp stores its ring's first n (<= 32) entries, lane i the i-th:
  // its two rows (the second only where it is a row of the block; an
  // entry's first always is)
  __device__ __forceinline__ void drain(const Sums& s, int n) {
    __syncwarp();
    if (s.lane < n) {
      const int at = (head + s.lane) & (kStageCap - 1);
      const int fg = s.qfg[at];
      const int r = s.rbase + (fg >> 16);
      float* dst = s.rows_out + (size_t)r * s.width + (fg & 0xffff);
      const float v0 = s.qv0[at], v1 = s.qv1[at];
      *dst = finish_log(v0);
      if (r + 8 < s.rows) dst[(size_t)8 * s.width] = finish_log(v1);
    }
    __syncwarp();
    head = (head + n) & (kStageCap - 1);
    count -= n;
  }
  // one bin: powers p0, p1 of the two rows, its slots' first filter and
  // weights (the energy is summed apart, where the powers are formed)
  __device__ __forceinline__ void add(float p0, float p1, int key, const float (&w)[S],
                                      const Sums& s, int n_filt) {
#pragma unroll
    for (int l = 0; l < S; ++l) {
      const int f = key + ((l - key) & (S - 1));
      const bool release = f != cur[l];
      if constexpr (kDirect && kStaged) {
        flush(l, release, s, n_filt);  // the ring's ballot: the whole warp
      } else if (release) {
        flush(l, true, s, n_filt);
      }
      if (release) cur[l] = f;
      run0[l] = fmaf(p0, w[l], run0[l]);
      run1[l] = fmaf(p1, w[l], run1[l]);
    }
  }
  // the last flushes and the energy: into the shared sums, or in log-mel
  // mode across the quad by two shuffles (every consumer lane takes part),
  // stored by lane 0; with kStaged the ring drained first
  __device__ __forceinline__ void finish(const Sums& s, int n_filt) {
#pragma unroll
    for (int l = 0; l < S; ++l) flush(l, true, s, n_filt);
    if constexpr (kDirect && kStaged && kCut != 3) {
      if (count > 0) drain(s, count);
    }
    if constexpr (kDirect) {
      e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
      e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
      e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
      e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
      if (s.t == 0) {
        if (s.out0) s.out0[n_filt] = finish_log(e0);
        if (s.out1) s.out1[n_filt] = finish_log(e1);
      }
    } else {
      if (s.mel0) red_shared_add(s.mel0 + n_filt, e0);
      if (s.mel1) red_shared_add(s.mel1 + n_filt, e1);
    }
  }
};

template <int S>
__device__ __forceinline__ void load_slots(const float* p, float (&w)[S]) {
  if constexpr (S == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    w[0] = v.x; w[1] = v.y;
  }
}

// The ring's state as a consumer walks it: the first stage's shared
// address, the full and empty barriers, the next stage and its parity
struct Ring {
  uint32_t base, full0, empty0;
  int stages, stage;
  uint32_t phase;

  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // this consumer warp is done with stage `st`: arrive on its empty barrier
  // in every block of the cluster (lane r signals block r)
  __device__ __forceinline__ void release(int st, int lane) const {
    if constexpr (kCluster > 1) {
      if (lane < kCluster) mbar_arrive_cluster(empty0 + 8 * st, lane);
    } else {
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
  }
};

// The block's audio, decoded, gained, rounded to bf16 and staged in hop
// segments (ops/frontend_kernel.py::dft_layout): kItems segments a warp a
// round, kV four-sample vectors a lane each, all loads issued before the
// first conversion (64 KB in flight)
template <typename InT>
__device__ __forceinline__ void stage_audio(const WgArgs& a, __nv_bfloat16* sa, int b0,
                                          int nb, int warp, int lane) {
  const InT* audio = static_cast<const InT*>(a.audio);
  const float scale = __ldg(a.gain) * a.in_scale;
  const int items = nb * a.n_seg;  // (window, hop segment) pairs
  constexpr int kV = 4;
  constexpr int kItems = 4;
  for (int i0 = kItems * warp; i0 < items; i0 += kItems * (kConsumers / 32)) {
    for (int j0 = 0; j0 < a.hop; j0 += 128 * kV) {
      float4 x[kItems][kV];
#pragma unroll
      for (int h = 0; h < kItems; ++h) {
        const int item = i0 + h;
        const int lw = item / a.n_seg;
        const int seg = item - lw * a.n_seg;
        const InT* src = audio + (size_t)(b0 + lw) * a.n_samples;
        const int g0 = (a.first_frame + seg) * a.hop;
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const int j = j0 + 4 * lane + 128 * v;
          const int g = g0 + j;
          if (item < items && j < a.hop) {
            if (a.vec_loads && g + 4 <= a.n_samples) {
              load4(src + g, x[h][v]);
            } else {  // past the row: zeros, read only against zero K-padding
              x[h][v].x = g < a.n_samples ? load_sample(src + g) : 0.0f;
              x[h][v].y = g + 1 < a.n_samples ? load_sample(src + g + 1) : 0.0f;
              x[h][v].z = g + 2 < a.n_samples ? load_sample(src + g + 2) : 0.0f;
              x[h][v].w = g + 3 < a.n_samples ? load_sample(src + g + 3) : 0.0f;
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < kItems; ++h) {
        const int item = i0 + h;
        const int lw = item / a.n_seg;
        const int seg = item - lw * a.n_seg;
        __nv_bfloat16* dst =
            sa + (size_t)lw * a.win_pitch + (size_t)seg * a.seg_pitch;
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const int j = j0 + 4 * lane + 128 * v;
          if (item < items && j < a.hop) {
            const float4 q = x[h][v];
            __nv_bfloat162 lo = __floats2bfloat162_rn(q.x * scale, q.y * scale);
            __nv_bfloat162 hi = __floats2bfloat162_rn(q.z * scale, q.w * scale);
            uint2 packed;
            packed.x = *reinterpret_cast<uint32_t*>(&lo);
            packed.y = *reinterpret_cast<uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(dst + j) = packed;
          }
        }
      }
    }
  }
}

// The audio staging by bulk copies, where every row is 16-byte aligned:
// each window's span of samples from its row, cut into pieces of half the
// ring (the ring is free until the B stream starts), lands in one half and
// is converted from there, while the other half fills.  `fn(i, lw, off,
// n)` for piece i: n samples from sample `off` of window lw's span.
template <typename Fn>
__device__ __forceinline__ void for_each_piece(const WgArgs& a, int nb, int piece, Fn fn) {
  const int span = a.n_seg * a.hop;
  const int valid = max(0, min(span, a.n_samples - a.first_frame * a.hop));
  int i = 0;
  for (int lw = 0; lw < nb; ++lw)
    for (int off = 0; off < valid; off += piece, ++i) fn(i, lw, off, min(piece, valid - off));
}

// the consumers' side: convert each piece from the ring into the segments,
// the samples past a row as zeros
template <typename InT>
__device__ __forceinline__ void stage_audio_bulk(const WgArgs& a, __nv_bfloat16* sa,
                                                 const uint8_t* land, int half, int nb,
                                                 uint32_t stg_full, uint32_t stg_empty,
                                                 int tid, int lane) {
  const float scale = __ldg(a.gain) * a.in_scale;
  for_each_piece(a, nb, half / (int)sizeof(InT), [&](int i, int lw, int off, int n) {
    const int h = i & 1;
    mbar_wait(stg_full + 8 * h, (i >> 1) & 1);
    const InT* src = reinterpret_cast<const InT*>(land + h * half);
    __nv_bfloat16* dst = sa + (size_t)lw * a.win_pitch;
    for (int q = tid; q < n / 4; q += kConsumers) {
      const int e = off + 4 * q;
      const int seg = e / a.hop;
      float x0, x1, x2, x3;
      if constexpr (sizeof(InT) == 4) {
        const float4 v = reinterpret_cast<const float4*>(src)[q];
        x0 = v.x; x1 = v.y; x2 = v.z; x3 = v.w;
      } else {
        const short4 v = reinterpret_cast<const short4*>(src)[q];
        x0 = v.x; x1 = v.y; x2 = v.z; x3 = v.w;
      }
      __nv_bfloat162 lo = __floats2bfloat162_rn(x0 * scale, x1 * scale);
      __nv_bfloat162 hi = __floats2bfloat162_rn(x2 * scale, x3 * scale);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst + (size_t)seg * a.seg_pitch + (e - seg * a.hop)) = packed;
    }
    fence_proxy_async();  // these reads before the next copy into this half
    __syncwarp();
    if (lane == 0) mbar_arrive(stg_empty + 8 * h);
  });
  // past the row: zeros, read only against the DFT's zero K-padding
  const int span = a.n_seg * a.hop;
  const int valid = max(0, min(span, a.n_samples - a.first_frame * a.hop));
  for (int idx = tid; idx < nb * (span - valid); idx += kConsumers) {
    const int lw = idx / (span - valid);
    const int e = valid + idx - lw * (span - valid);
    const int seg = e / a.hop;
    sa[(size_t)lw * a.win_pitch + (size_t)seg * a.seg_pitch + (e - seg * a.hop)] =
        __float2bfloat16(0.0f);
  }
}

// The bin whose re and im are n8 block j's columns 2 t, 2 t + 1 of chunk c
// (ops/dft_plan.py::chunk_bin): in the n_full full chunks, t 16 n_full +
// 16 c + j, so that each lane of a quad walks one run of consecutive bins
// over all of them (long runs of one filter, few shared-memory adds,
// seldom two lanes at one address); in a last chunk of 16 columns, the
// bins after them in order, n_full 64 + 4 j + t (the host builds the
// matrix's columns in this order)
template <int N>
__device__ __forceinline__ int chunk_bin(int c, int j, int t, int n_full) {
  return N == kBN ? 16 * (t * n_full + c) + j : n_full * (kBN / 2) + 4 * j + t;
}

// log-mel mode's pass after the walk (kFinish 0): the safe_log of n floats
// from dst in place, by the kConsumers threads; in 16-byte pieces from the
// first 16-byte boundary, kPassLoads of them a thread loaded before any is
// logged (the pass would wait on one load at a time)
constexpr int kPassLoads = 4;

__device__ __forceinline__ float4 safe_log4(float4 v) {
  return make_float4(safe_log(v.x), safe_log(v.y), safe_log(v.z), safe_log(v.w));
}

__device__ __forceinline__ void log_pass(float* dst, int n, int tid) {
  const int head =
      min(n, (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4);
  if (tid < head) dst[tid] = safe_log(dst[tid]);
  float4* body = reinterpret_cast<float4*>(dst + head);
  const int n4 = (n - head) / 4;
  for (int i0 = tid; i0 < n4; i0 += kPassLoads * kConsumers) {
    float4 v[kPassLoads];
#pragma unroll
    for (int u = 0; u < kPassLoads; ++u)
      if (i0 + u * kConsumers < n4) v[u] = body[i0 + u * kConsumers];
#pragma unroll
    for (int u = 0; u < kPassLoads; ++u)
      if (i0 + u * kConsumers < n4) body[i0 + u * kConsumers] = safe_log4(v[u]);
  }
  const int tail = head + 4 * n4;
  if (tail + tid < n) dst[tail + tid] = safe_log(dst[tail + tid]);
}

// One consumer thread: its warpgroup's rows, its ldmatrix address, its two
// accumulator rows, where their filter sums go and the filter slots it
// reads
template <int S, bool kDirect>
struct Consumer {
  const WgArgs& a;
  Ring ring;
  int lane;
  uint32_t a_row;   // its ldmatrix row address
  int a_khalf;      // and k-half
  const int* skoff;
  Sums sums;        // rows r0 and r0 + 8
  float* ptile;
  float* smel;
  const int* tkey;   // the filter slots: in shared memory where they fit,
  const float* tw;   // else the device's copy
  int tid, wg, r0, t, mp, n_ks;
  int n_full;        // full chunks (the bins' order, chunk_bin)
  int pending;       // the stage whose products are issued and not yet done
  FilterRuns<S, kDirect> runs;

  // K-slice ks of the chunk in the ring's next stage: its products into
  // the first N / 2 accumulators (zeroed at ks 0); then the stage of the
  // slice before, whose products are done, released
  template <int N>
  __device__ __forceinline__ void slice(float (&acc)[kBN / 2], int ks) {
    uint32_t af[kKSteps][4];
    mbar_wait(ring.full0 + 8 * ring.stage, ring.phase);
    if constexpr (kCut != 1) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const int koff = skoff[((ks * kBK + 16 * kk) >> 3) + a_khalf];
        ldmatrix_x4(a_row + 2u * koff, af[kk][0], af[kk][1], af[kk][2], af[kk][3]);
      }
      fence_regs(acc);
      wgmma_fence();
      const uint32_t sb = ring.base + ring.stage * kStageBytes;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        wgmma<N>(acc, af[kk], b_desc(sb + 32 * kk), ks | kk);
      wgmma_commit();
      if constexpr (TSC_DFT_EARLY_RELEASE) {  // this slice's products done
        wgmma_wait<0>();
        fence_regs(acc);
        ring.release(ring.stage, lane);
      } else {
        wgmma_wait<1>();  // the slice before is done
        fence_regs(acc);
        if (pending >= 0) ring.release(pending, lane);
        pending = ring.stage;
      }
    } else {
      ring.release(ring.stage, lane);  // the B-stream cut: consume nothing
    }
    ring.advance();
  }

  // chunk c's epilogue (acc's first N / 2, `width` columns): from n8 block
  // j of rows r0, r0 + 8 the power |X|^2 / n_fft of bin chunk_bin<N>(c, j,
  // t, n_full), into the energy and the filter runs
  template <int N>
  __device__ __forceinline__ void epilogue(const float (&acc)[kBN / 2], int c, int width) {
    if constexpr (kCut == 2) {  // the cut keeps the products alive, no more
      if (a.n_filt < 0) runs.e0 += acc[0];
      return;
    }
    if constexpr (kPowerTile) {
      power_tile<N>(acc, c, width);
      return;
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if (8 * j < width) {
        const float p0 =
            (acc[4 * j] * acc[4 * j] + acc[4 * j + 1] * acc[4 * j + 1]) * a.inv_fft;
        const float p1 =
            (acc[4 * j + 2] * acc[4 * j + 2] + acc[4 * j + 3] * acc[4 * j + 3]) *
            a.inv_fft;
        runs.e0 += p0;
        runs.e1 += p1;
        const int b = chunk_bin<N>(c, j, t, n_full);
        float w[S];
#pragma unroll
        for (int l = 0; l < S; ++l) w[l] = tw[b * S + l];
        runs.add(p0, p1, tkey[b], w, sums, a.n_filt);
      }
    }
  }

  // the ablation's epilogue: the chunk's powers into the warpgroup's 64
  // rows of the tile, then one thread a (row, filter) over the packed
  // filterbank, as csrc/dft_frontend.cu does
  template <int N>
  __device__ __forceinline__ void power_tile(const float (&acc)[kBN / 2], int c,
                                             int width) {
#pragma unroll
    // the tile's column 16 t + j (a full chunk) or 4 j + t (the last): the
    // chunk's bins as runs of consecutive ones, each beside its first bin
    constexpr int kRuns = N == kBN ? 4 : 1;
    constexpr int kRun = N == kBN ? 16 : N / 2;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = N == kBN ? 16 * t + j : 4 * j + t;
      ptile[r0 * kPPitch + col] =
          (acc[4 * j] * acc[4 * j] + acc[4 * j + 1] * acc[4 * j + 1]) * a.inv_fft;
      ptile[(r0 + 8) * kPPitch + col] =
          (acc[4 * j + 2] * acc[4 * j + 2] + acc[4 * j + 3] * acc[4 * j + 3]) *
          a.inv_fft;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    const int r = 64 * wg + (tid & 63);
    for (int m = (tid >> 6) & 1; m <= a.n_filt; m += 2) {
      float s = 0.0f;
      for (int run = 0; run < kRuns; ++run) {
        const float* p = ptile + r * kPPitch + run * kRun;
        const int bin0 = chunk_bin<N>(c, 0, run, n_full);
        const int bin_end = min(bin0 + min(kRun, width / 2), a.n_pad / 2);
        if (m < a.n_filt) {
          const int f_lo = __ldg(&a.filt_range[3 * m]);
          const float* fw = a.filt_packed + __ldg(&a.filt_range[3 * m + 2]);
          const int lo = max(bin0, f_lo);
          const int hi = min(bin_end, __ldg(&a.filt_range[3 * m + 1]));
          for (int k = lo; k < hi; ++k) s += p[k - bin0] * __ldg(&fw[k - f_lo]);
        } else {
          for (int k = bin0; k < bin_end; ++k) s += p[k - bin0];
        }
      }
      smel[r * mp + m] += s;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  }

  // chunk c (`width` <= N of its columns): its products into acc's first
  // N / 2, slice by slice, then its epilogue (TSC_DFT_SERIAL_EPILOGUE: and
  // both warpgroups meet)
  template <int N>
  __device__ __forceinline__ void chunk(float (&acc)[kBN / 2], int c, int width) {
    for (int ks = 0; ks < n_ks; ks += 2) {  // two slices: the A fragments'
      slice<N>(acc, ks);                    // double buffer
      slice<N>(acc, ks + 1);
    }
    if constexpr (kCut != 1 && !TSC_DFT_EARLY_RELEASE) {
      wgmma_wait<0>();
      fence_regs(acc);
      ring.release(pending, lane);
      pending = -1;
    }
    epilogue<N>(acc, c, width);
    if constexpr (TSC_DFT_SERIAL_EPILOGUE) consumers_sync();
  }

  // every chunk: n_full of kBN columns, then `tail` more (<= NT) if any
  template <int NT>
  __device__ __forceinline__ void run(int n_full, int tail) {
    float acc[kBN / 2];
    for (int c = 0; c < n_full; ++c) chunk<kBN>(acc, c, kBN);
    if (tail) chunk<NT>(acc, n_full, tail);
  }
};

template <int S, bool kDirect>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    dft_wgmma_kernel(const WgArgs a, const __grid_constant__ CUtensorMap map) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring_base = smem_addr(base);
  const uint8_t* base_ring = base;
  float* coeffs = reinterpret_cast<float*>(base);  // the ring, after the last chunk
  base += ring_bytes(a.n_mfcc, a.stages);
  float* ptile = reinterpret_cast<float*>(base);
  if constexpr (kPowerTile) base += align16(sizeof(float) * kBM * kPPitch);
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(base);
  base += align16(sizeof(__nv_bfloat16) * (size_t)a.wpb * a.win_pitch);
  float* smel = reinterpret_cast<float*>(base);
  const int n_mel_rows = mel_rows(a.wpb, a.n_features);
  const int mp = sums_pitch(a.n_filt, a.n_bnd, kDirect);
  base += align16(sizeof(float) * (size_t)n_mel_rows * mp);
  int* skoff = reinterpret_cast<int*>(base);
  base += align16(sizeof(int) * (size_t)(a.k_pad / 8));
  float* sdct = reinterpret_cast<float*>(base);
  const int n_dct = a.n_filt * dct_cols(a.n_mfcc, a.logmel);
  base += align16(sizeof(float) * (size_t)n_dct);
  int* stkey = reinterpret_cast<int*>(base);
  float* stw = reinterpret_cast<float*>(base + align16(sizeof(int) * (size_t)(a.n_pad / 2)));
  if (a.table_smem) base += table_bytes(a.n_pad, S);
  uint8_t* shome = base;
  base += home_bytes(a.n_filt, kDirect);
  uint8_t* sstage = base;  // (kStaged) a ring a consumer warp: v0, v1, fg
  base += staging_bytes(kDirect);
  const int stages = a.stages;
  const uint32_t full0 = smem_addr(base);            // `stages` full barriers
  const uint32_t empty0 = full0 + 8 * stages;        // then as many empty ones
  const uint32_t stg_full = empty0 + 8 * stages;     // the staging's two pairs
  const uint32_t stg_empty = stg_full + 16;
  const int half = stages * kStageBytes / 2;         // the staging's landing halves

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * a.wpb;
  const int nb = max(0, min(a.wpb, a.batch - b0));  // 0: a cluster's padding block
  const int rows = nb * a.n_features;
  const int n_ks = a.k_pad / kBK;
  const int n_chunks = (a.n_pad + kBN - 1) / kBN;
  const int total = kCut == 4 ? 0 : n_chunks * n_ks;  // the staging cut: none

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);  // the producer's arrive with its byte count
      mbar_init(empty0 + 8 * s, 8 * kCluster);  // each consumer warp of the cluster
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(stg_full + 8 * h, 1);
      mbar_init(stg_empty + 8 * h, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (kCluster > 1) cluster_sync();  // every block's barriers are set up

  if (warp >= kConsumers / 32) {
    // ---- the producer: one lane keeps the ring full, then waits until
    // every consumer of the cluster has released every stage, so that no
    // block leaves while another may still signal its barriers
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      if (a.bulk_stage && kCut != 1 && kCut != 5) {
        // the audio first, through the ring's two halves; the B stream
        // starts when the consumers are done with both
        const size_t elem = a.in_int16 ? 2 : 4;
        const uint8_t* audio = static_cast<const uint8_t*>(a.audio);
        int pieces = 0;
        for_each_piece(a, nb, half / (int)elem, [&](int i, int lw, int off, int n) {
          const int h = i & 1;
          if (i >= 2) mbar_wait(stg_empty + 8 * h, ((i >> 1) - 1) & 1);
          mbar_expect_tx(stg_full + 8 * h, n * elem);
          bulk_load(ring_base + h * half,
                    audio + elem * ((size_t)(b0 + lw) * a.n_samples +
                                    (size_t)a.first_frame * a.hop + off),
                    n * elem, stg_full + 8 * h);
          pieces = i + 1;
        });
        for (int i = max(0, pieces - 2); i < pieces; ++i)
          mbar_wait(stg_empty + 8 * (i & 1), (i >> 1) & 1);
      }
      const int rank = kCluster > 1 ? (int)cluster_rank() : 0;
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < total + stages; ++it) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if (it < total) {
          mbar_expect_tx(full0 + 8 * stage, kStageBytes);
          const int c = it / n_ks;
          const int ks = it - c * n_ks;
          tma_load_b(ring_base + stage * kStageBytes + rank * (kBoxRows * kBK * 2),
                     &map, full0 + 8 * stage, ks * kBK, c * kBN + rank * kBoxRows);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    // ---- the consumers: stage the audio and the tables
    if constexpr (kCut != 1 && kCut != 5) {
      const uint8_t* land = base_ring;
      if (a.bulk_stage && a.in_int16)
        stage_audio_bulk<int16_t>(a, sa, land, half, nb, stg_full, stg_empty, tid, lane);
      else if (a.bulk_stage)
        stage_audio_bulk<float>(a, sa, land, half, nb, stg_full, stg_empty, tid, lane);
      else if (a.in_int16)
        stage_audio<int16_t>(a, sa, b0, nb, warp, lane);
      else
        stage_audio<float>(a, sa, b0, nb, warp, lane);
    }
    const int gap = a.seg_pitch - a.hop;
    for (int i = tid; i < a.k_pad / 8; i += kConsumers)
      skoff[i] = i * 8 + (i * 8 / a.hop) * gap;
    for (int i = tid; i < n_mel_rows * mp; i += kConsumers) smel[i] = 0.0f;
    for (int i = tid; i < n_dct; i += kConsumers) sdct[i] = __ldg(&a.dct_t[i]);
    if constexpr (kDirect)
      for (int i = tid; i < a.n_filt; i += kConsumers) shome[i] = __ldg(&a.filt_home[i]);
    const int* tkey = a.bin_key;
    const float* tw = a.bin_w;
    if (a.table_smem) {
      for (int i = tid; i < a.n_pad / 2; i += kConsumers) stkey[i] = __ldg(&a.bin_key[i]);
      for (int i = tid; i < a.n_pad / 2 * S; i += kConsumers) stw[i] = __ldg(&a.bin_w[i]);
      tkey = stkey;
      tw = stw;
    }
    consumers_sync();

    const int wg = warp >> 2;  // warpgroup: rows 64 wg .. 64 wg + 63
    const int wq = warp & 3;   // warp in it: its 16 rows
    // ldmatrix row addresses: lane l addresses row (l & 7) + 8 ((l >> 3) & 1)
    // of the warp's 16 at k-half l >> 4
    uint32_t a_row;
    {
      const int r = 64 * wg + 16 * wq + (lane & 7) + ((lane >> 3) & 1) * 8;
      int lw = r / a.n_features;
      int f = r - lw * a.n_features;
      if (r >= rows) lw = f = 0;  // padding rows: any valid address, discarded
      a_row = smem_addr(sa + (size_t)lw * a.win_pitch + (size_t)f * a.seg_pitch);
    }
    const int a_khalf = lane >> 4;
    // the accumulator layout: this thread's rows r0, r0 + 8 and, in n8
    // block j of a chunk, columns 8 j + 2 t (re) and + 1 (im) of bin 4 j + t
    const int r0 = 64 * wg + 16 * wq + (lane >> 2);
    const int t = lane & 3;
    // a padding row past the block's filter sums adds into none, and one
    // past its rows stores nothing
    Sums sums{r0 < n_mel_rows ? smel + r0 * mp : nullptr,
              r0 + 8 < n_mel_rows ? smel + (r0 + 8) * mp : nullptr,
              nullptr, nullptr, shome, t, nullptr, nullptr, nullptr, nullptr,
              a.n_filt + 1, rows, 64 * wg + 16 * wq, lane};
    if constexpr (kDirect) {
      sums.rows_out = static_cast<float*>(a.out) + (size_t)b0 * a.n_features * sums.width;
      if (r0 < rows) sums.out0 = sums.rows_out + (size_t)r0 * sums.width;
      if (r0 + 8 < rows) sums.out1 = sums.rows_out + (size_t)(r0 + 8) * sums.width;
      float* ring = reinterpret_cast<float*>(sstage) + warp * 3 * kStageCap;
      sums.qv0 = ring;
      sums.qv1 = ring + kStageCap;
      sums.qfg = reinterpret_cast<int*>(ring + 2 * kStageCap);
    }

    Consumer<S, kDirect> cons{a,     Ring{ring_base, full0, empty0, stages, 0, 0}, lane,
                              a_row, a_khalf, skoff, sums, ptile, smel, tkey, tw, tid,
                              wg,    r0,      t,     mp,   n_ks,  a.n_pad / kBN, -1};
    cons.runs.init();
    // the last chunk's 16 columns (every n_fft 2^k) run m64n16; any other
    // part chunk runs the full width on the matrix's zero rows
    const int n_full = a.n_pad / kBN;
    const int tail = a.n_pad - n_full * kBN;  // a multiple of 16
    if constexpr (kCut == 4) {
      // the staging cut: no products, the tail on zero sums
    } else if (tail > 16) {
      cons.template run<kBN>(n_full, tail);
    } else {
      cons.template run<16>(n_full, tail);
    }
    FilterRuns<S, kDirect>& runs = cons.runs;
    if constexpr (kCut != 1) {
      if constexpr (!kPowerTile && kCut != 2) runs.finish(sums, a.n_filt);
      consumers_sync();
      const int dc = dct_cols(a.n_mfcc, a.logmel);
      if constexpr (kDirect) {
        // log-mel mode: the rest of each row left from the registers; the
        // tail writes the boundary filters' sums and 0 for the filters no
        // bin weighs, then (kFinish 0) takes the safe_log of the block's
        // rows in place, one coalesced span (their stores are visible
        // after the barrier)
        const int width = a.n_filt + 1;
        float* dst = static_cast<float*>(a.out) + (size_t)b0 * a.n_features * width;
        for (int i = tid; i < rows * a.n_tail; i += kConsumers) {
          const int r = i / a.n_tail;
          const int k = i - r * a.n_tail;
          const float v = k < a.n_bnd ? smel[r * mp + k] : 0.0f;
          dst[(size_t)r * width + __ldg(&a.tail_filt[k])] = finish_log(v);
        }
        if constexpr (kFinish == 0 && kCut != 6) {
          consumers_sync();
          log_pass(dst, rows * width, tid);
        }
      } else if (a.logmel) {
        // the first log-mel design: the block's rows are one span of the
        // (B, T, n_filt + 1) buffer, stored in order, the log energy last in
        // each row
        const int width = a.n_filt + 1;
        float* dst = static_cast<float*>(a.out) + (size_t)b0 * a.n_features * width;
        for (int i = tid; i < rows * width; i += kConsumers) {
          const int r = i / width;
          dst[i] = safe_log(smel[r * mp + (i - r * width)]);
        }
      } else {
        // log of the filter sums and the energy, the DCT, deltas and the store
        const size_t at = (size_t)b0 * a.n_features * (a.emit_deltas ? 2 : 1) * a.n_mfcc;
        if (a.out_bf16)
          cepstrum_tail<kConsumers, kBM>(
              tid, rows, a.n_features, a.n_filt, a.n_mfcc, a.emit_deltas, smel, sdct, dc,
              coeffs, static_cast<__nv_bfloat16*>(a.out) + at, [] { consumers_sync(); });
        else
          cepstrum_tail<kConsumers, kBM>(
              tid, rows, a.n_features, a.n_filt, a.n_mfcc, a.emit_deltas, smel, sdct, dc,
              coeffs, static_cast<float*>(a.out) + at, [] { consumers_sync(); });
      }
    }
  }
}

template <int S, bool kDirect>
cudaError_t launch(const WgArgs& a, const CUtensorMap& map, size_t smem,
                   cudaStream_t stream) {
  auto kernel = dft_wgmma_kernel<S, kDirect>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = (a.batch + a.wpb - 1) / a.wpb;
  blocks = (blocks + kCluster - 1) / kCluster * kCluster;  // whole clusters
  kernel<<<blocks, kThreads, smem, stream>>>(a, map);
  return cudaGetLastError();
}

}  // namespace

// audio (batch, n_samples) f32 or int16; gain (1,) f32 on the device.
// Frames first_frame .. first_frame + n_features - 1 (hop apart) are
// computed.  Layout (ops/frontend_kernel.py::dft_layout): wpb windows a
// block, each staged as n_seg hop segments of seg_pitch bf16 elements in a
// window pitch of win_pitch.  dft (n_pad, k_pad) bf16 with columns cos|sin
// of each bin interleaved, 16-byte aligned; bin_key (n_pad / 2,) int32 and
// bin_w (n_pad / 2, slots) f32, slots 2 or 4 (ops/dft_plan.py::
// filter_slots), staged in shared memory when table_smem; filt_packed and filt_range as for tsc_dft_frontend_bf16
// (read by the power-tile ablation only); dct_t (n_filt, n_mfcc - 1) f32,
// the DCT's columns 1 .. n_mfcc - 1 (none read in log-mel mode).  out
// (batch, n_features, n_mfcc or 2 n_mfcc) f32 or bf16, or with logmel
// (batch, n_features, n_filt + 1) f32 log-mel rows, the log energy last,
// for csrc/cepstrum_wgmma.cu: finished filters from the registers by
// filt_home (n_filt,) uint8 and the tail's tail_filt (n_tail,) int32, n_bnd
// of them boundary filters (ops/dft_plan.py::filter_homes), or with
// shared_sums every filter summed in shared memory (the first design).
// Returns the launch's cudaError_t.
extern "C" int tsc_dft_frontend_wgmma(
    const void* audio, int audio_int16, const void* gain, int batch,
    int n_samples, int hop, int first_frame, int n_features, int wpb,
    int n_seg, int seg_pitch, int win_pitch, const void* dft, int k_pad,
    int n_pad, int n_fft, const void* bin_key, const void* bin_w, int slots,
    int table_smem, int stages, const void* filt_packed,
    const void* filt_range, const void* dct_t, int n_filt, int n_mfcc,
    int emit_deltas, int logmel, int shared_sums, const void* filt_home,
    const void* tail_filt, int n_bnd, int n_tail, void* out, int out_bf16,
    void* stream) {
  const int direct = logmel && !shared_sums;
  if (batch <= 0 || hop <= 0 || hop % 8 != 0 || seg_pitch < hop ||
      seg_pitch % 8 != 0 || win_pitch % 8 != 0 || win_pitch < n_seg * seg_pitch ||
      k_pad <= 0 || k_pad % (2 * kBK) != 0 || n_pad <= 0 || n_pad % 16 != 0 ||
      n_features <= 0 || wpb <= 0 || wpb * n_features > kBM || n_mfcc > n_filt ||
      n_mfcc <= 0 || n_fft <= 0 || (slots != 2 && slots != 4) ||
      reinterpret_cast<uintptr_t>(dft) % 16 != 0 || (logmel && out_bf16) ||
      (!logmel && n_mfcc > 1 && !dct_t) ||
      (direct && (!filt_home || (n_tail > 0 && !tail_filt) || n_bnd < 0 ||
                  n_tail < n_bnd || n_tail > n_filt || n_bnd > kHomeNone - kHomeShared ||
                  kPowerTile)))
    return cudaErrorInvalidValue;
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (kStages > 0) stages = kStages;  // an ablation's fixed ring
  if (stages < 2 || stages > kMaxStages) return cudaErrorInvalidValue;
  size_t smem = smem_bytes(wpb, win_pitch, n_filt, n_mfcc, k_pad,
                           table_smem ? table_bytes(n_pad, slots) : 0, stages,
                           n_features, logmel, direct, n_bnd);
  if (smem > (size_t)smem_max && table_smem) {  // an ablation's power tile
    table_smem = 0;
    smem = smem_bytes(wpb, win_pitch, n_filt, n_mfcc, k_pad, 0, stages, n_features,
                      logmel, direct, n_bnd);
  }
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)k_pad, (cuuint64_t)n_pad};
  const cuuint64_t strides[1] = {(cuuint64_t)k_pad * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {kBK, kBoxRows};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(dft), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  WgArgs a;
  a.audio = audio;
  a.gain = static_cast<const float*>(gain);
  a.in_scale = audio_int16 ? 1.0f / 32768.0f : 1.0f;
  a.batch = batch;
  a.n_samples = n_samples;
  a.hop = hop;
  a.first_frame = first_frame;
  a.n_features = n_features;
  a.wpb = wpb;
  a.n_seg = n_seg;
  a.seg_pitch = seg_pitch;
  a.win_pitch = win_pitch;
  a.k_pad = k_pad;
  a.n_pad = n_pad;
  a.inv_fft = 1.0f / static_cast<float>(n_fft);
  a.bin_key = static_cast<const int*>(bin_key);
  a.bin_w = static_cast<const float*>(bin_w);
  a.table_smem = table_smem;
  a.stages = stages;
  a.filt_packed = static_cast<const float*>(filt_packed);
  a.filt_range = static_cast<const int*>(filt_range);
  a.dct_t = static_cast<const float*>(dct_t);
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.emit_deltas = emit_deltas;
  a.logmel = logmel ? 1 : 0;
  a.filt_home = static_cast<const uint8_t*>(filt_home);
  a.tail_filt = static_cast<const int*>(tail_filt);
  a.n_bnd = direct ? n_bnd : 0;
  a.n_tail = direct ? n_tail : 0;
  const size_t align = audio_int16 ? 8 : 16;
  a.vec_loads = n_samples % 4 == 0 && reinterpret_cast<uintptr_t>(audio) % align == 0;
  // (with a cluster the other block's stream may reach the ring while this
  // one still lands audio there: plain loads then)
  a.bulk_stage = kCluster == 1 && n_samples % (audio_int16 ? 8 : 4) == 0 &&
                 reinterpret_cast<uintptr_t>(audio) % 16 == 0;
  a.in_int16 = audio_int16;
  a.out_bf16 = out_bf16;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (direct)
    err = slots == 4 ? launch<4, true>(a, map, smem, s) : launch<2, true>(a, map, smem, s);
  else
    err = slots == 4 ? launch<4, false>(a, map, smem, s) : launch<2, false>(a, map, smem, s);
  return static_cast<int>(err);
}
