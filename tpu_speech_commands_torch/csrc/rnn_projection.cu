// Input projection of the GRU and LSTM classifiers' projected route,
// hand-written for Hopper (sm_90a): tsc_rnn_projection.
//
// Replaces the hoisted input projection in the body of the TPU kernel
// tpu_speech_commands/ops/pallas_rnn.py::make_fused_rnn_classifier
// (:158-166, one matmul a gate over all T frames):
//
//   XW = X (B T x D) @ W (D x G U_p) + b                 float32
//
// for a layer whose input is wider than the tile kernels take (D_p > 64):
// csrc/gru_classifier.cu and csrc/lstm_classifier.cu then run only h @ U a
// step, their accumulators started from XW_t.  W's columns are in the tile
// kernels' padded gate order (gate g's unit u in column g U_p + u); b is
// the GRU's b_in of all three gates or the LSTM's bias.  Plan, pack,
// layout, plain version and CPU emulation: ops/rnn_projection.py.
//
// XW's layout is the order in which the recurrence copies it: tiles of 16
// windows, [B / 16][T][n-tile][lane] x float4, a lane's C fragment of an
// mma n-tile (rows g and g + 8, columns 2t and 2t + 1) in one 16-byte word.
// The GEMM's m-tile q is tile q / T's 16 windows at step q % T, so a warp
// stores its accumulators as they stand, 512 contiguous bytes an n-tile.
//
// Bound at B 8192, T 23, D 300, a 48-unit GRU (N 144): 16.28 GFLOP at the
// 3xTF32 rate of 165 TFLOP/s, 0.0987 ms, in f32 mode; in bf16 mode the
// bytes, 113.0 MB of bf16 features and 108.5 MB of XW at 3.35 TB/s.
//
// Design: mma.sync on the tensor cores in both modes.  A block of kWarps =
// 8 warps owns kTilesM = 8 m-tiles (128 rows) and all N columns: warp w
// takes m-tiles 2 (w % 4) and 2 (w % 4) + 1 and half the n-tiles (NTW), so
// X is read from memory once.  K runs in stages of BK columns.  Where x is
// in the mode's type with its rows on 4-byte boundaries (f32 features in
// f32 mode, bf16 ones of even D in bf16 mode: the scorers' cases), the
// rows come by cp.async of the widest of 16, 8 and 4 bytes that the rows'
// alignment allows (coalesced along a row) through a ring of 3 (bf16) or 4
// (f32) stages, all but one in flight while one stage's products run; in
// f32 mode up to 12 n-tiles a warp (N 192) two blocks an SM instead, on a
// ring of 2 (24% faster at N 144 than one block on 4, in turns).  Otherwise each thread loads its share of the
// next stage into registers and converts and stores it after this stage's
// products (a ring of two; converting at the load would wait on it before
// the products: 3x slower in bf16).  The stage's B fragments, packed once
// on the host in fragment order, come by 16-byte cp.async either way.
//  - bf16 mode: mma.m16n8k16 bf16, f32 accumulation; x rounded to bf16
//    where it is staged.
//  - f32 mode: 3xTF32 on mma.m16n8k8 tf32: x split in registers into hi =
//    tf32(x) and lo = tf32(x - hi) (split_tf32, as csrc/cepstrum_wgmma.cu
//    splits its rows), W split on the host; lo hi + hi lo + hi hi into f32
//    accumulators, about 2^-22 of each product lost.  FFMA would take
//    0.33 ms at the f32 peak for the 16.3 GFLOP above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rnn_tile.cuh"

namespace {

// ops/rnn_projection.py's constants (tests/test_torch_rnn_wide.py holds the
// two together)
constexpr int kWarps = 8;     // warps a block: 4 m-tile pairs x 2 column halves
constexpr int kTilesM = 8;    // m-tiles (16 rows each) a block
constexpr int kKPad = 64;     // the pack's k rows: a multiple of this
constexpr int kBK32 = 16;     // f32 mode: k a stage (two m16n8k8 steps)
constexpr int kBK16 = 64;     // bf16 mode: k a stage (four m16n8k16 steps)
constexpr int kPitch32 = 20;  // floats a staged row: conflict-free fragments
constexpr int kPitch16 = 72;  // bf16 a staged row
constexpr int kStages = 2;    // the ring of registers-staged rows
constexpr int kAsyncStages32 = 4;  // the cp.async ring, f32 mode
constexpr int kAsyncStages16 = 3;  // bf16 mode
// f32 mode's cp.async ring up to kTwoBlockNtw n-tiles a warp: two blocks an
// SM (its accumulators fit 128 registers) on a ring of kTwoBlockStages32
constexpr int kTwoBlockNtw = 12;
constexpr int kTwoBlockStages32 = 2;

// the pack's rows end on a stage boundary in both modes
static_assert(kKPad % kBK32 == 0 && kKPad % kBK16 == 0, "stages past the pack");

__host__ __device__ constexpr int a_stage_bytes(bool bf16) {
  return 16 * kTilesM * (bf16 ? 2 * kPitch16 : 4 * kPitch32);
}
// a stage's B fragments: BK / 16 k-blocks (bf16) or BK / 8 (f32) of NT
// n-tiles, 8 or 16 bytes a lane
__host__ __device__ constexpr int b_stage_bytes(bool bf16, int NT) {
  return (bf16 ? kBK16 / 16 * 8 : kBK32 / 8 * 16) * NT * 32;
}
__host__ __device__ constexpr bool two_blocks(bool bf16, bool async_rows, int ntw) {
  return !bf16 && async_rows && ntw <= kTwoBlockNtw;
}
__host__ __device__ constexpr int ring_stages(bool bf16, bool async_rows, int ntw) {
  return two_blocks(bf16, async_rows, ntw) ? kTwoBlockStages32
         : async_rows                      ? (bf16 ? kAsyncStages16 : kAsyncStages32)
                                           : kStages;
}
constexpr size_t proj_smem(bool bf16, bool async_rows, int NT) {
  return ring_stages(bf16, async_rows, NT / 2) *
         (size_t)(a_stage_bytes(bf16) + b_stage_bytes(bf16, NT));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S> __device__ __forceinline__ S staged(float v);
template <> __device__ __forceinline__ float staged<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 staged<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC (4, 8 or 16) bytes from global to shared memory, asynchronously
// (16 through L2 only, fewer through L1: cp.async.cg takes only 16)
template <int VEC>
__device__ __forceinline__ void cp_async_vec(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(VEC)
                 : "memory");
}

// VEC zero bytes into shared memory
template <int VEC>
__device__ __forceinline__ void zero_vec(void* dst) {
  if constexpr (VEC == 16)
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  else if constexpr (VEC == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  else
    *reinterpret_cast<uint32_t*>(dst) = 0u;
}

// x = hi + lo + (about 2^-22 x): hi = tf32(x), lo = tf32(x - hi), both
// rounded to nearest (ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c += a b, a 16 x 8 tf32 (row), b 8 x 8 tf32 (col), c 16 x 8 f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage's products into a warp's accumulators (m-tiles 2 wm, 2 wm + 1;
// n-tiles wn NTW ..): `rows` the stage's 128 staged rows, `frags` its B
// fragments
template <bool kBf16, int NTW>
__device__ __forceinline__ void stage_products(float (&acc)[2][NTW][4],
                                               const unsigned char* rows,
                                               const uint4* frags, int wm,
                                               int wn, int lane) {
  constexpr int NT = 2 * NTW;
  const int g = lane >> 2, t4 = lane & 3;
  if constexpr (kBf16) {
    constexpr int P = kPitch16 / 2;  // 32-bit words a staged row
    const uint32_t* a = reinterpret_cast<const uint32_t*>(rows);
    const uint2* b = reinterpret_cast<const uint2*>(frags) + lane;
#pragma unroll
    for (int kk = 0; kk < kBK16 / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* ar = a + ((2 * wm + mt) * 16 + g) * P + 8 * kk + t4;
        af[mt][0] = ar[0];          // row g, columns 2t, 2t + 1
        af[mt][1] = ar[8 * P];      // row g + 8
        af[mt][2] = ar[4];          // row g, columns 2t + 8, 2t + 9
        af[mt][3] = ar[8 * P + 4];  // row g + 8
      }
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const uint2 w = b[(kk * NT + wn * NTW + n) * 32];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma(acc[mt][n], af[mt], w);
      }
    }
  } else {
    constexpr int P = kPitch32;
    const float* a = reinterpret_cast<const float*>(rows);
    const uint4* b = frags + lane;
#pragma unroll
    for (int kk = 0; kk < kBK32 / 8; ++kk) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ar = a + ((2 * wm + mt) * 16 + g) * P + 8 * kk + t4;
        split_tf32(ar[0], ah[mt][0], al[mt][0]);          // (g, t)
        split_tf32(ar[8 * P], ah[mt][1], al[mt][1]);      // (g + 8, t)
        split_tf32(ar[4], ah[mt][2], al[mt][2]);          // (g, t + 4)
        split_tf32(ar[8 * P + 4], ah[mt][3], al[mt][3]);  // (g + 8, t + 4)
      }
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const uint4 w = b[(kk * NT + wn * NTW + n) * 32];  // hi b0, b1, lo b0, b1
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][n], al[mt], w.x, w.y);
          mma_tf32(acc[mt][n], ah[mt], w.z, w.w);
          mma_tf32(acc[mt][n], ah[mt], w.x, w.y);
        }
      }
    }
  }
}

// x (batch, T, D) f32 or bf16; wpack the pack's B fragments (bf16: [K /
// 16][NT][lane] x 4 bf16; f32: [K / 8][NT][lane] x {hi b0, hi b1, lo b0, lo
// b1}), K = D rounded up to kKPad; bias (NT 8,) f32; xw q_total m-tiles of
// NT x 32 float4.  An m-tile past q_total, or a window past the batch,
// loads zeros and (past q_total) stores nothing.
//
// kVec 4, 8 or 16 (x already in the mode's type, its rows on kVec-byte
// boundaries, as `copy_bytes` picks): the rows come by kVec-byte cp.async
// through a ring of ring_stages stages, ring_stages - 1 of them in flight
// while one's products run; no register holds them.  kVec 0 (x converted,
// or bf16 rows at odd offsets): each thread loads its share of the next
// stage into registers while this one's products run, and converts and
// stores it after them (a ring of two).
template <typename InT, bool kBf16, int NTW, int kVec>
__global__ void __launch_bounds__(kWarps * 32, two_blocks(kBf16, kVec > 0, NTW) ? 2 : 1)
projection_kernel(const InT* __restrict__ x, int batch, int T, int D,
                  int q_total, const void* __restrict__ wpack,
                  const float* __restrict__ bias, float4* __restrict__ xw) {
  constexpr int NT = 2 * NTW;
  constexpr int BK = kBf16 ? kBK16 : kBK32;
  constexpr int P = kBf16 ? kPitch16 : kPitch32;  // staged elements a row
  constexpr bool kAsync = kVec > 0;
  constexpr int STAGES = ring_stages(kBf16, kAsync, NTW);
  // a thread's copies: kVec bytes (EPW elements each) of a row, or single
  // elements
  constexpr int EPW = kAsync ? kVec / (int)sizeof(InT) : 1;
  constexpr int STEP = kWarps * 32 / (BK / EPW);  // rows between a thread's
  constexpr int PER = 16 * kTilesM / STEP;        // a thread's rows a stage
  constexpr int A_BYTES = a_stage_bytes(kBf16);
  constexpr int B_WORDS = b_stage_bytes(kBf16, NT) / 16;
  using S = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  static_assert(!kAsync || sizeof(InT) == sizeof(S), "kAsync stages x as it is");
  extern __shared__ __align__(16) unsigned char proj_smem_bytes[];
  uint4* s_b = reinterpret_cast<uint4*>(proj_smem_bytes + STAGES * A_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int q0 = blockIdx.x * kTilesM;

  // this thread's staged rows r0 + STEP i and columns kc .. kc + EPW - 1
  // of every stage
  const int kc = tid % (BK / EPW) * EPW, r0 = tid / (BK / EPW);
  const InT* src[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = r0 + STEP * i;
    const int q = q0 + r / 16;
    const int tile = q / T, t = q - tile * T;
    const int b = 16 * tile + r % 16;
    src[i] = q < q_total && b < batch ? x + ((size_t)b * T + t) * D : nullptr;
  }
  const int chunks = (D + BK - 1) / BK;

  float acc[2][NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(
        bias + 8 * (wn * NTW + n) + 2 * t4));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      acc[mt][n][0] = acc[mt][n][2] = bb.x;
      acc[mt][n][1] = acc[mt][n][3] = bb.y;
    }
  }

  // stage c's B fragments into ring slot `slot`
  auto fetch_frags = [&](int c, int slot) {
    const uint4* from = reinterpret_cast<const uint4*>(wpack) + (size_t)c * B_WORDS;
    for (int i = tid; i < B_WORDS; i += kWarps * 32)
      cp_async16(s_b + slot * B_WORDS + i, from + i);
  };

  if constexpr (kAsync) {
    // stage c's rows into ring slot `slot`, zeros past the batch and past D
    auto fetch_rows = [&](int c, int slot) {
      const int k = c * BK + kc;
      S* a = reinterpret_cast<S*>(proj_smem_bytes + slot * A_BYTES);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        S* dst = a + (r0 + STEP * i) * P + kc;
        if (src[i] && k < D)
          cp_async_vec<kVec>(dst, src[i] + k);
        else
          zero_vec<kVec>(dst);
      }
    };
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) {
      if (c < chunks) {
        fetch_rows(c, c);
        fetch_frags(c, c);
      }
      cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<STAGES - 2>();  // stage c (this thread's copies)
      __syncthreads();  // everyone's; and everyone is past stage c - 1
      const int next = c + STAGES - 1;
      if (next < chunks) {
        fetch_rows(next, next % STAGES);
        fetch_frags(next, next % STAGES);
      }
      cp_async_commit();
      const int slot = c % STAGES;
      stage_products<kBf16, NTW>(acc, proj_smem_bytes + slot * A_BYTES,
                                 s_b + slot * B_WORDS, wm, wn, lane);
    }
  } else {
    InT held[PER];  // raw: converted only when staged, after the products
    // stage c's rows into registers (predicated loads, nothing reads them
    // before the stage's products are done)
    auto fetch_rows = [&](int c) {
      const int k = c * BK + kc;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        held[i] = zero<InT>();
        if (src[i] && k < D) held[i] = __ldg(src[i] + k);
      }
    };
    auto stage_rows = [&](int slot) {
      S* a = reinterpret_cast<S*>(proj_smem_bytes + slot * A_BYTES);
#pragma unroll
      for (int i = 0; i < PER; ++i) a[(r0 + STEP * i) * P + kc] = staged<S>(to_float(held[i]));
    };
    fetch_rows(0);
    fetch_frags(0, 0);
    cp_async_commit();
    stage_rows(0);
    for (int c = 0; c < chunks; ++c) {
      const int slot = c & 1;
      if (c + 1 < chunks) {
        fetch_rows(c + 1);
        fetch_frags(c + 1, slot ^ 1);
      }
      cp_async_commit();
      cp_async_wait<1>();  // stage c's B fragments (this thread's copies)
      __syncthreads();     // everyone's: rows and fragments of stage c
      stage_products<kBf16, NTW>(acc, proj_smem_bytes + slot * A_BYTES,
                                 s_b + slot * B_WORDS, wm, wn, lane);
      __syncthreads();  // everyone has read stage c before its slot refills
      if (c + 1 < chunks) stage_rows(slot ^ 1);
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int q = q0 + 2 * wm + mt;
    if (q >= q_total) continue;
    float4* out = xw + (size_t)q * NT * 32 + lane;
#pragma unroll
    for (int n = 0; n < NTW; ++n)
      out[(wn * NTW + n) * 32] =
          make_float4(acc[mt][n][0], acc[mt][n][1], acc[mt][n][2], acc[mt][n][3]);
  }
}

template <typename InT, bool kBf16, int NTW, int kVec>
cudaError_t launch(const void* x, int batch, int T, int D, const void* w,
                   const float* bias, float* xw, cudaStream_t stream) {
  const size_t smem = proj_smem(kBf16, kVec > 0, 2 * NTW);
  auto kernel = projection_kernel<InT, kBf16, NTW, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long q_total = (long long)((batch + 15) / 16) * T;
  if (q_total > (1ll << 30)) return cudaErrorInvalidValue;
  const int blocks = (int)((q_total + kTilesM - 1) / kTilesM);
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const InT*>(x), batch, T, D, (int)q_total, w, bias,
      reinterpret_cast<float4*>(xw));
  return cudaGetLastError();
}

// The n-tiles a warp takes: N / 16 for N = G U_p, the GRU's 48 .. 192 and
// the LSTM's 64 .. 256
#define TSC_PROJECTION_WIDTHS(X) X(3) X(4) X(6) X(8) X(9) X(12) X(16)

template <typename InT, bool kBf16, int kVec>
cudaError_t dispatch(int ntw, const void* x, int batch, int T, int D,
                     const void* w, const float* bias, float* xw,
                     cudaStream_t stream) {
#define TSC_PROJECTION_CASE(n) \
  if (ntw == n) return launch<InT, kBf16, n, kVec>(x, batch, T, D, w, bias, xw, stream);
  TSC_PROJECTION_WIDTHS(TSC_PROJECTION_CASE)
#undef TSC_PROJECTION_CASE
  return cudaErrorInvalidValue;
}

// The widest cp.async (16, 8 or 4 bytes) that every row segment of a stage
// starts on, for rows of D elements of `elem` bytes from x; 0 where even 4
// bytes do not (bf16 rows of odd D, or x itself at an odd offset).  A
// copy's first element is a multiple of its elements along the row, so
// only the row's bytes and x's own address decide.
int copy_bytes(const void* x, int elem, int D) {
  const uintptr_t row = (uintptr_t)D * elem, at = reinterpret_cast<uintptr_t>(x);
  for (int vec = 16; vec >= 4; vec /= 2)
    if (row % vec == 0 && at % vec == 0) return vec;
  return 0;
}

}  // namespace

// x (batch, T, D) f32 or bf16; wpack and bias as ops/rnn_projection.py::
// pack_projection packs them for bf16_math (16-byte aligned), N = G U_p
// columns; writes xw ((batch + 15) / 16, T, N / 8, 32, 4) f32.  Returns the
// launch's cudaError_t; cudaErrorInvalidValue for an N without an
// instantiation.
extern "C" int tsc_rnn_projection(const void* x, int x_bf16, int batch, int T,
                                  int D, int N, const void* wpack,
                                  const void* bias, void* xw, int bf16_math,
                                  void* stream) {
  if (batch <= 0 || T <= 0 || D <= 0 || N <= 0 || N % 16) return cudaErrorInvalidValue;
  const int ntw = N / 16;
  const float* fb = static_cast<const float*>(bias);
  float* out = static_cast<float*>(xw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the cp.async ring where x is in the mode's type, by the widest copy
  // its rows' alignment allows (copy_bytes)
  const int vec = copy_bytes(x, x_bf16 ? 2 : 4, D);
  cudaError_t err;
  if (x_bf16 && bf16_math)
    err = vec == 16  ? dispatch<__nv_bfloat16, true, 16>(ntw, x, batch, T, D, wpack, fb, out, s)
          : vec == 8 ? dispatch<__nv_bfloat16, true, 8>(ntw, x, batch, T, D, wpack, fb, out, s)
          : vec == 4 ? dispatch<__nv_bfloat16, true, 4>(ntw, x, batch, T, D, wpack, fb, out, s)
                     : dispatch<__nv_bfloat16, true, 0>(ntw, x, batch, T, D, wpack, fb, out, s);
  else if (!x_bf16 && !bf16_math)
    err = vec == 16 ? dispatch<float, false, 16>(ntw, x, batch, T, D, wpack, fb, out, s)
                    : dispatch<float, false, 4>(ntw, x, batch, T, D, wpack, fb, out, s);
  else if (x_bf16)
    err = dispatch<__nv_bfloat16, false, 0>(ntw, x, batch, T, D, wpack, fb, out, s);
  else
    err = dispatch<float, true, 0>(ntw, x, batch, T, D, wpack, fb, out, s);
  return static_cast<int>(err);
}
