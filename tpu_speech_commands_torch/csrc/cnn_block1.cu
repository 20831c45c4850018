// The CNN's fused block 1, hand-written for Hopper (sm_90a): a persistent,
// bandwidth-bound kernel fed by a TMA input ring, a lane computing all 16
// channels of each of its pooled positions.
//
// tsc_cnn_block1 replaces tpu_speech_commands/ops/pallas_cnn.py::
// make_fused_conv_block1 (pallas_call at :156), on the constants of
// ops/cnn_lowering.py::lower_block1 (BatchNorm folded):
//
//   x (B, H, W) f32 or bf16 features
//   z = conv3x3(x, w) with TF-SAME padding (1 each side, stride 1)
//   out = relu6(maxpool2x2(z) + bias)      (B, H // 2, W // 2, 16) f32 NHWC
//
// (the VALID pool drops an odd last row or column; the pool commutes with
// the monotone +bias, relu6, so they run after it).  bf16 mode: the input
// and the weights are rounded to bf16, the products are exact in f32 and
// the sums f32 (the TPU kernel's contract).  The first design, the SIMT
// stage routine, stays in csrc/cnn_classifier.cu as tsc_cnn_block1_simt.
//
// What bounds it on this card: bytes.  At B = 8192 and 30 x 20 with f32
// features a call reads 19.66 MB and writes 78.64 MB (the output is 80% of
// it): 0.0293 ms at 3.35 TB/s.  Its 1.4156 GFLOP of f32 FMAs take 0.0211
// ms at the 67 TFLOP/s peak, 72% of the byte time, so the FMA pipes must
// stay nearly full while the copies stream: every instruction that is not
// an FMA shows in the time.
//
// Design (ops/block1_plan.py mirrors each map and emulates it on the CPU):
// - Persistent: a grid of (blocks an SM that fit) x SMs.  Block b takes the
//   windows [b B / grid, (b + 1) B / grid), the batch split as evenly as
//   whole windows allow, in tiles of up to kMaxTile windows; a tile's
//   windows are contiguous in x.
// - A producer warp (one lane) keeps a ring of kStages stages full: a tile's
//   bytes, f32 or bf16 as they lie in x, by one 1-D bulk copy
//   (cp.async.bulk global -> shared) of the tile's 16-byte-aligned interior,
//   completing on the stage's full mbarrier; the few elements before and
//   after it (a window of 29 x 21 f32 is 2436 bytes) by plain loads, before
//   the lane's arrive.  A stage is refilled when every consumer warp has
//   arrived on its empty mbarrier.  Every wait traps after ~2 s of clocks:
//   a stuck ring is a launch error, not a hang.
// - Eight consumer warps take the tiles' chunks of 64 items (an item is a
//   pooled position; lane l takes items l and l + 32) in turn, warp w the
//   block's chunks w, w + 8, ... over all its tiles, so a warp runs on into
//   the next tile (its stage full) while others finish the last: no block
//   barrier after set-up.
// - The weights (9 taps x 16 channels, the bf16 values as f32 in bf16 mode)
//   and the bias are read once a block into shared memory; a tap's four
//   channels are one 16-byte load, used for both of a lane's items.
// - A lane reads each of its pooled positions' 4 x 4 input patch once
//   (converted, and rounded to bf16 in bf16 mode, at the read; SAME padding
//   by a predicate on the outer rows and columns), then for each group of
//   four channels runs 4 quads x 9 taps x 4 FMAs an item, the pool max,
//   +bias and relu6: 16 outputs, 64 contiguous bytes, an item.  No run-time
//   division: an item's (window, oy, ox) come from multiplications by
//   host-made reciprocals.
// - Stores: a lane writes each group's float4 into its warp's 4 KB buffer in
//   shared memory (groups in a lane-rotated order, so the 8 lanes of a
//   phase hit distinct banks), and the warp writes the buffer out as 16-byte
//   streaming stores, 512 contiguous bytes an instruction.
// - bf16 stays on the CUDA cores: mma.sync (TSC_B1_MMA, below) measured
//   slower (dev/block1_ablation.py, PERF.md).
//
// Compile-time switches for dev/block1_ablation.py (each undoes one choice;
// the shipped kernel takes the defaults): TSC_B1_STAGES (the ring's depth;
// 1: no ring, a tile is loaded when the last one is released),
// TSC_B1_STORE (0: 16 scalar stores an item; 1: 4 vector stores an item at
// a 64-byte stride; 2: through the warp's buffer, the default; 3: the warp's
// buffer written by a bulk copy, shared -> global, two buffers a warp),
// TSC_B1_ITEMS (1: a lane a pooled position), TSC_B1_MMA (bf16 on the
// tensor cores: mma.sync m16n8k16, K = the 9 taps padded to 16, N = 16
// channels in two n8 tiles; a tile's 16 rows are 4 pooled positions'
// quads, rows g and g + 8 of a lane the quad's two rows, so the pool is one
// register max and one shuffle), TSC_B1_TILE (windows a tile at most, and
// 2560 bytes a window of the stage's budget), TSC_B1_BLOCKS (the launch
// bounds' blocks an SM) and TSC_B1_CUT (1: the loads and stores alone, each
// item's output the sum of its patch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef TSC_B1_STAGES
#define TSC_B1_STAGES 3
#endif
#ifndef TSC_B1_TILE
#define TSC_B1_TILE 8
#endif
#ifndef TSC_B1_BLOCKS
#define TSC_B1_BLOCKS 2
#endif
#ifndef TSC_B1_STORE
#define TSC_B1_STORE 2
#endif
#ifndef TSC_B1_MMA
#define TSC_B1_MMA 0
#endif
#ifndef TSC_B1_ITEMS
#define TSC_B1_ITEMS 2
#endif
#ifndef TSC_B1_CUT
#define TSC_B1_CUT 0
#endif

namespace {

constexpr int kCout = 16;
constexpr int kTaps = 9;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // and the producer warp
constexpr int kStages = TSC_B1_STAGES;
constexpr int kMaxTile = TSC_B1_TILE;
constexpr int kStageBudget = kMaxTile * 2560;  // bytes of windows a stage aims at
constexpr int kBlocksPerSm = TSC_B1_BLOCKS;
constexpr int kStore = TSC_B1_STORE;
constexpr bool kMma = TSC_B1_MMA != 0;
constexpr int kCut = TSC_B1_CUT;
constexpr int kItems = TSC_B1_ITEMS;            // items a lane takes at once
constexpr int kChunk = 32 * kItems;              // items a warp takes at once
constexpr int kChunkBytes = kChunk * kCout * 4;  // their output
constexpr int kOutBuffers = kStore == 3 ? 2 : 1;  // a warp's output buffers
constexpr int kSlack = 32;        // a stage's bytes beyond its windows'
constexpr int kWeightBytes = (kTaps + 1) * kCout * 4;  // weights, then bias
constexpr int kBarrierOff = kWeightBytes;
constexpr int kRingOff = (kBarrierOff + 16 * kStages + 127) / 128 * 128;
constexpr size_t kSmemLimit = 232448;  // a block's opt-in shared memory
static_assert(kStages >= 1 && kStages <= 8, "a ring of one to eight stages");
static_assert(kStore >= 0 && kStore <= 3, "a store mode of 0 .. 3");
static_assert(kItems == 1 || kItems == 2, "one or two items a lane");

__host__ __device__ inline size_t stage_bytes(int tile, uint32_t window_bytes) {
  return ((size_t)tile * window_bytes + 15) / 16 * 16 + kSlack;
}

__host__ __device__ inline size_t staging_off(int tile, uint32_t window_bytes) {
  return kRingOff + kStages * stage_bytes(tile, window_bytes);
}

// the dynamic shared memory a block takes; ops/block1_plan.py::smem_bytes
// mirrors it
__host__ __device__ inline size_t smem_bytes(int tile, uint32_t window_bytes) {
  return staging_off(tile, window_bytes) +
         (kStore >= 2 ? (size_t)kConsumerWarps * kOutBuffers * kChunkBytes : 0);
}

// windows a tile: as many as the stage's budget holds, at least one
inline int tile_windows(uint32_t window_bytes) {
  const int t = (int)(kStageBudget / window_bytes);
  return t < 1 ? 1 : (t > kMaxTile ? kMaxTile : t);
}

// floor(n / d) as (n * magic) >> 32 with magic = ceil(2^32 / d): exact for
// n * d < 2^32 (ops/block1_plan.py::fast_div checks the range)
__host__ inline uint64_t div_magic(uint32_t d) {
  return ((1ull << 32) + d - 1) / d;
}
__device__ __forceinline__ int fast_div(int n, uint64_t magic) {
  return (int)(((uint64_t)(uint32_t)n * magic) >> 32);
}

struct B1Args {
  const void* x;
  float* out;
  const void* w;        // (3, 3, 1, 16) in the compute type
  const float* bias;    // (16,)
  int batch, h, w_in, wp, n_pos, hw, tile;
  uint32_t window_bytes;
  uint64_t magic_pos, magic_wp;  // fast_div by n_pos and by wp
};

// ---- mbarriers and bulk copies (PTX) -----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// arrive (release) and expect `bytes` more of transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed; a wait of more
// than ~2 s of clocks traps, so that a stuck ring is a launch error and not
// a hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - start > (1ll << 32)) __trap();
}

// the generic proxy's accesses of shared memory before the async proxy's
// (a bulk copy into or out of the same bytes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned), completing `bar`'s transaction bytes
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from shared `src` to global `dst`, one bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// until at most N bulk groups still read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- values ---------------------------------------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool kRound>
__device__ __forceinline__ float rnd(float v) {
  if (kRound) return __bfloat162float(__float2bfloat16(v));
  return v;
}

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.0f), 6.0f); }

__device__ __forceinline__ float weight(const void* w, int i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i])
              : static_cast<const float*>(w)[i];
}

// bytes [lo, hi) of global memory into shared `dst`, element by element
template <typename InT>
__device__ __forceinline__ void copy_elements(unsigned char* dst, uintptr_t lo,
                                              uintptr_t hi) {
  using U = typename std::conditional<sizeof(InT) == 4, uint32_t, uint16_t>::type;
  for (uintptr_t p = lo; p < hi; p += sizeof(U))
    *reinterpret_cast<U*>(dst + (p - lo)) = *reinterpret_cast<const U*>(p);
}

// ---- the producer ----------------------------------------------------------

// Block b takes windows [block_end(b - 1), block_end(b)), the batch split as
// evenly as whole windows allow, in tiles of up to a.tile windows
__device__ __forceinline__ int block_end(const B1Args& a, int b) {
  return (int)((int64_t)(b + 1) * a.batch / gridDim.x);
}

template <typename InT>
__device__ __forceinline__ void produce(const B1Args& a, unsigned char* ring, size_t sbytes,
                        uint32_t full0, uint32_t empty0) {
  int s = 0;
  uint32_t phase = 0;
  const int w1 = block_end(a, (int)blockIdx.x);
  for (int fw = block_end(a, (int)blockIdx.x - 1), k = 0; fw < w1; fw += a.tile, ++k) {
    if (k >= kStages) mbar_wait(empty0 + 8 * s, phase ^ 1);
    fence_proxy_async();
    const int nb = min(a.tile, w1 - fw);
    const uintptr_t begin = reinterpret_cast<uintptr_t>(a.x) +
                            (size_t)fw * a.window_bytes;
    const uintptr_t end = begin + (size_t)nb * a.window_bytes;
    const uintptr_t base = begin & ~(uintptr_t)15;
    const uintptr_t a0 = (begin + 15) & ~(uintptr_t)15, a1 = end & ~(uintptr_t)15;
    unsigned char* stage = ring + s * sbytes;
    uint32_t bytes = 0;
    if (a1 <= a0) {
      copy_elements<InT>(stage + (begin - base), begin, end);
    } else {
      copy_elements<InT>(stage + (begin - base), begin, a0);
      copy_elements<InT>(stage + (a1 - base), a1, end);
      bytes = (uint32_t)(a1 - a0);
    }
    // the arrive releases the plain stores above with the phase
    mbar_expect_tx(full0 + 8 * s, bytes);
    if (bytes)
      bulk_load(smem_addr(stage + (a0 - base)), reinterpret_cast<const void*>(a0),
                bytes, full0 + 8 * s);
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
}

// ---- the consumers -----------------------------------------------------------

struct Tile {
  int n_items, n_chunks, shift;  // shift: bytes from the stage's start to x's
  size_t first_item;             // the tile's first item in the output
};

// the tile of nb windows from window fw
__device__ __forceinline__ Tile tile_of(const B1Args& a, int fw, int nb) {
  Tile ti;
  ti.n_items = nb * a.n_pos;
  ti.n_chunks = (ti.n_items + kChunk - 1) / kChunk;
  ti.shift = (int)((reinterpret_cast<uintptr_t>(a.x) +
                    (size_t)fw * a.window_bytes) & 15);
  ti.first_item = (size_t)fw * a.n_pos;
  return ti;
}

// The CUDA-core chunk: a lane's kItems items (item0 + lane, + 32, ...), each
// one's patch, then 4 channel groups, the weights of a group read once for
// all of a lane's items.
template <typename InT, bool kBf16>
__device__ __forceinline__ void chunk_simt(const B1Args& a, const InT* in,
                                           const float4* w4, const float4* bias4,
                                           float4* buf, float* out, int item0,
                                           int n_items, int lane) {
  constexpr bool kRound = kBf16 && sizeof(InT) == 4;
  float v[kItems][4][4];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int item = min(item0 + 32 * it + lane, n_items - 1);
    const int win = fast_div(item, a.magic_pos);
    const int pos = item - win * a.n_pos;
    const int oy = fast_div(pos, a.magic_wp);
    const int ox = pos - oy * a.wp;
    // the patch: input rows 2 oy - 1 .. 2 oy + 2, columns 2 ox - 1 ..
    // 2 ox + 2; only the outer ones can fall in the padding
    const int origin = win * a.hw + (2 * oy - 1) * a.w_in + 2 * ox - 1;
    const bool row_ok[4] = {oy > 0, true, true, 2 * oy + 2 < a.h};
    const bool col_ok[4] = {ox > 0, true, true, 2 * ox + 2 < a.w_in};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[it][r][c] = row_ok[r] && col_ok[c]
                          ? rnd<kRound>(to_float(in[origin + r * a.w_in + c]))
                          : 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // the channel group: rotated by lane where the lanes store into the
    // warp's buffer (a phase of 8 lanes then hits 8 distinct bank quads)
    const int g = kStore >= 2 ? ((kk + (lane >> 1)) & 3) : kk;
    float4 r[kItems];
    const float4 b = bias4[g];
    if (kCut == 1) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        float sum = 0.0f;
#pragma unroll
        for (int y = 0; y < 4; ++y)
#pragma unroll
          for (int x = 0; x < 4; ++x) sum += v[it][y][x];
        r[it] = make_float4(sum + b.x, sum + b.y, sum + b.z, sum + b.w);
      }
    } else {
      float acc[kItems][4][4];
#pragma unroll
      for (int it = 0; it < kItems; ++it)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[it][q][j] = 0.0f;
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        const float4 wv = w4[tap * 4 + g];
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int it = 0; it < kItems; ++it)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float xv = v[it][(q >> 1) + dy][(q & 1) + dx];
            acc[it][q][0] = fmaf(xv, wv.x, acc[it][q][0]);
            acc[it][q][1] = fmaf(xv, wv.y, acc[it][q][1]);
            acc[it][q][2] = fmaf(xv, wv.z, acc[it][q][2]);
            acc[it][q][3] = fmaf(xv, wv.w, acc[it][q][3]);
          }
      }
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        float (&c)[4][4] = acc[it];
        r[it].x = relu6(fmaxf(fmaxf(c[0][0], c[1][0]), fmaxf(c[2][0], c[3][0])) + b.x);
        r[it].y = relu6(fmaxf(fmaxf(c[0][1], c[1][1]), fmaxf(c[2][1], c[3][1])) + b.y);
        r[it].z = relu6(fmaxf(fmaxf(c[0][2], c[1][2]), fmaxf(c[2][2], c[3][2])) + b.z);
        r[it].w = relu6(fmaxf(fmaxf(c[0][3], c[1][3]), fmaxf(c[2][3], c[3][3])) + b.w);
      }
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int item = item0 + 32 * it + lane;
      if (kStore >= 2) {
        buf[(32 * it + lane) * 4 + g] = r[it];
      } else if (item < n_items) {
        float* const o = out + (size_t)item * kCout + 4 * g;
        if (kStore == 1) {
          __stcs(reinterpret_cast<float4*>(o), r[it]);
        } else {
          o[0] = r[it].x;
          o[1] = r[it].y;
          o[2] = r[it].z;
          o[3] = r[it].w;
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A lane's fixed part of the tensor-core chunk: its A columns (taps) and B
// fragments.  Lane (g, t): rows g and g + 8 of each 16-row tile are the two
// quads (qy 0 and 1) at qx = g & 1 of pooled position g >> 1; its A columns
// are taps 2t, 2t + 1 and (t = 0 only) tap 8.
struct MmaLane {
  int qx, pp;             // the lane's quad column, and pooled position (0..3)
  int dy[3], dx[3];       // taps 2t, 2t + 1 and 8 (the last only for t = 0)
  uint32_t b[2][2];       // B fragments of n-tiles 0 and 1
  float bias[2];          // the two channels the lane stores
  int ch;                 // the first of them
};

__device__ __forceinline__ MmaLane mma_lane(const float* ws, const float* bias,
                                            int lane) {
  MmaLane m;
  const int g = lane >> 2, t = lane & 3;
  m.qx = g & 1;
  m.pp = g >> 1;
  const int taps[3] = {2 * t, 2 * t + 1, 8};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m.dy[i] = taps[i] / 3;
    m.dx[i] = taps[i] % 3;
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int c = 8 * n + g;  // B column g of n-tile n: channel 8 n + g
    m.b[n][0] = pack_bf16(ws[(2 * t) * kCout + c], ws[(2 * t + 1) * kCout + c]);
    m.b[n][1] = pack_bf16(t == 0 ? ws[8 * kCout + c] : 0.0f, 0.0f);
  }
  // after the pool, even g stores n-tile 0's columns 2t, 2t + 1, odd g
  // n-tile 1's
  m.ch = 8 * (g & 1) + 2 * t;
  m.bias[0] = bias[m.ch];
  m.bias[1] = bias[m.ch + 1];
  return m;
}

// The tensor-core chunk (bf16 mode): 8 tiles of 4 pooled positions.
template <typename InT>
__device__ __forceinline__ void chunk_mma(const B1Args& a, const InT* in,
                                          const MmaLane& m, float* out, int item0,
                                          int n_items, int lane) {
  const int t = lane & 3;
#pragma unroll 2
  for (int j = 0; j < kChunk / 4; ++j) {
    const int slot = item0 + 4 * j + m.pp;
    const int item = min(slot, n_items - 1);
    const int win = fast_div(item, a.magic_pos);
    const int pos = item - win * a.n_pos;
    const int oy = fast_div(pos, a.magic_wp);
    const int ox = pos - oy * a.wp;
    const int origin = win * a.hw + (2 * oy - 1) * a.w_in + 2 * ox - 1;
    float x[2][3];  // (qy, tap)
#pragma unroll
    for (int qy = 0; qy < 2; ++qy)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int r = qy + m.dy[i], c = m.qx + m.dx[i];  // patch row, column
        const bool ok = (r != 0 || oy > 0) && (r != 3 || 2 * oy + 2 < a.h) &&
                        (c != 0 || ox > 0) && (c != 3 || 2 * ox + 2 < a.w_in) &&
                        (i < 2 || t == 0);
        x[qy][i] = ok ? to_float(in[origin + r * a.w_in + c]) : 0.0f;
      }
    const uint32_t af[4] = {pack_bf16(x[0][0], x[0][1]), pack_bf16(x[1][0], x[1][1]),
                            pack_bf16(x[0][2], 0.0f), pack_bf16(x[1][2], 0.0f)};
    float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(d0, af, m.b[0][0], m.b[0][1]);
    mma_bf16(d1, af, m.b[1][0], m.b[1][1]);
    // the pool: rows g and g + 8 in registers, qx by the lane 4 apart
    float p[4] = {fmaxf(d0[0], d0[2]), fmaxf(d0[1], d0[3]), fmaxf(d1[0], d1[2]),
                  fmaxf(d1[1], d1[3])};
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = fmaxf(p[i], __shfl_xor_sync(0xffffffffu, p[i], 4));
    const bool odd = (lane >> 2) & 1;
    const float2 r = make_float2(relu6((odd ? p[2] : p[0]) + m.bias[0]),
                                 relu6((odd ? p[3] : p[1]) + m.bias[1]));
    if (slot < n_items)
      __stcs(reinterpret_cast<float2*>(out + (size_t)slot * kCout + m.ch), r);
  }
}

template <typename InT, bool kBf16>
__device__ __forceinline__ void consume(const B1Args& a, const unsigned char* ring, size_t sbytes,
                        const float* ws, const float* bias, float4* staging,
                        uint32_t full0, uint32_t empty0, int warp, int lane) {
  constexpr bool kTensor = kMma && kBf16;
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  const float4* bias4 = reinterpret_cast<const float4*>(bias);
  MmaLane m;
  if (kTensor) m = mma_lane(ws, bias, lane);
  float4* buf = staging + (size_t)warp * kOutBuffers * (kChunkBytes / 16);
  int which = 0;  // the buffer this chunk fills (two with bulk stores)
  const int w1 = block_end(a, (int)blockIdx.x);
  int fw = block_end(a, (int)blockIdx.x - 1), c = warp, s = 0;
  uint32_t phase = 0;
  Tile ti = tile_of(a, fw, min(a.tile, w1 - fw));
  mbar_wait(full0, 0);
  while (true) {
    if (c >= ti.n_chunks) {  // done with this tile: release its stage
      c -= ti.n_chunks;
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
      fw += a.tile;
      if (fw >= w1) break;
      ti = tile_of(a, fw, min(a.tile, w1 - fw));
      mbar_wait(full0 + 8 * s, phase);
      continue;
    }
    const InT* in = reinterpret_cast<const InT*>(ring + s * sbytes + ti.shift);
    float* out = a.out + ti.first_item * kCout;
    const int item0 = c * kChunk;
    if (kTensor) {
      chunk_mma<InT>(a, in, m, out, item0, ti.n_items, lane);
    } else {
      float4* b = buf + which * (kChunkBytes / 16);
      if (kStore == 3) {  // the bulk copy that read this buffer last is done
        if (lane == 0) bulk_wait_read<kOutBuffers - 1>();
        __syncwarp();
      }
      chunk_simt<InT, kBf16>(a, in, w4, bias4, b, out, item0, ti.n_items, lane);
      const int n_valid = min(kChunk, ti.n_items - item0);
      float4* dst = reinterpret_cast<float4*>(out + (size_t)item0 * kCout);
      if (kStore == 2) {  // 16-byte streaming stores, 512 bytes a warp
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4 * kItems; ++i) {
          const int f = i * 32 + lane;
          if (f < 4 * n_valid) __stcs(dst + f, b[f]);
        }
        __syncwarp();
      } else if (kStore == 3) {
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) bulk_store(dst, smem_addr(b), (uint32_t)n_valid * 64);
        which ^= kOutBuffers - 1;
      }
    }
    c += kConsumerWarps;
  }
  if (kStore == 3 && !kTensor && lane == 0) bulk_wait_all();
}

template <typename InT, bool kBf16>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    cnn_block1_kernel(const __grid_constant__ B1Args args) {
  extern __shared__ __align__(128) unsigned char b1_smem[];
  const B1Args a = args;
  float* ws = reinterpret_cast<float*>(b1_smem);  // [tap][channel]
  float* bias = ws + kTaps * kCout;
  const uint32_t full0 = smem_addr(b1_smem + kBarrierOff);
  const uint32_t empty0 = full0 + 8 * kStages;
  const size_t sbytes = stage_bytes(a.tile, a.window_bytes);
  unsigned char* ring = b1_smem + kRingOff;
  float4* staging = reinterpret_cast<float4*>(b1_smem + staging_off(a.tile, a.window_bytes));

  for (int i = threadIdx.x; i < kTaps * kCout; i += kThreads)
    ws[i] = weight(a.w, i, kBf16);
  if (threadIdx.x < kCout) bias[threadIdx.x] = a.bias[threadIdx.x];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kConsumerWarps) {
    if (lane == 0) produce<InT>(a, ring, sbytes, full0, empty0);
    return;
  }
  consume<InT, kBf16>(a, ring, sbytes, ws, bias, staging, full0, empty0, warp, lane);
}

template <typename InT, bool kBf16>
cudaError_t launch(const B1Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = cnn_block1_kernel<InT, kBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // every block at least one window
  const int grid = a.batch < per_sm * sms ? a.batch : per_sm * sms;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (batch, H, W) f32 or bf16 -> out (batch, H / 2, W / 2, 16) f32 NHWC: the
// conv with BatchNorm folded into w (3, 3, 1, 16) and bias (16,), then the
// 2x2 pool, +bias and relu6.  dims: h_in, w_in, cin, cout, stride, pool,
// pad_h, pad_w; the stage must be block 1's (cin 1, cout 16, stride 1, the
// pool, SAME padding).  w is bf16 when bf16_math is set; out 16-byte
// aligned.  cudaErrorInvalidValue for what the kernel does not take, among
// it a window whose ring does not fit a block's shared memory
// (ops/block1_plan.py::kernel_for sends those to tsc_cnn_block1_simt before
// any launch).  Returns the launch's cudaError_t.
extern "C" int tsc_cnn_block1(const void* x, int x_bf16, int batch, const void* w,
                              const void* bias, const int* dims, void* out,
                              int bf16_math, void* stream) {
  if (batch <= 0 || !x || !out || !w || !bias || !dims) return cudaErrorInvalidValue;
  const int h = dims[0], wi = dims[1];
  if (h < 2 || wi < 2 || dims[2] != 1 || dims[3] != kCout || dims[4] != 1 ||
      dims[5] != 1 || dims[6] != 1 || dims[7] != 1)
    return cudaErrorInvalidValue;
  const size_t elem = x_bf16 ? 2 : 4;
  if (reinterpret_cast<uintptr_t>(x) % elem || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  B1Args a;
  a.x = x;
  a.out = static_cast<float*>(out);
  a.w = w;
  a.bias = static_cast<const float*>(bias);
  a.batch = batch;
  a.h = h;
  a.w_in = wi;
  a.wp = wi / 2;
  a.n_pos = (h / 2) * a.wp;
  a.hw = h * wi;
  a.window_bytes = (uint32_t)(a.hw * elem);
  a.tile = tile_windows(a.window_bytes);
  a.magic_pos = div_magic((uint32_t)a.n_pos);
  a.magic_wp = div_magic((uint32_t)a.wp);
  // fast_div's range: a tile's items times the divisor below 2^32
  if ((uint64_t)a.tile * a.n_pos * a.n_pos >= (1ull << 32)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.tile, a.window_bytes);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    err = bf16_math ? launch<bf16, true>(a, smem, s) : launch<bf16, false>(a, smem, s);
  else
    err = bf16_math ? launch<float, true>(a, smem, s) : launch<float, false>(a, smem, s);
  return static_cast<int>(err);
}
