// The cepstrum kernel's first design: the DCT, energy column, deltas and
// store after the FFT body's log-mel mode as an FFMA GEMM on the SIMT
// cores, hand-written for Hopper (sm_90a).  csrc/cepstrum_wgmma.cu, the
// kernel the frontends launch, computes the same function on the tensor
// cores (3xTF32 wgmma); this one stays for the A/B (`_simt=True`,
// `tsc_cepstrum_simt`).
//
// Replaces, for the configs whose DCT columns leave the FFT body's block
// too little room, the epilogue of the TPU kernel
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
// What bounds this design: its products run on the FFMA units, 2 B T
// n_filt (n_mfcc - 1) operations at the f32 peak of 67 TFLOP/s.  At n_fft
// 4352 with 600 filters and coefficients, B = 8192 windows of 23 frames:
// 135.4 GFLOP, 2.02 ms, above the 0.27 ms of its bytes (the rows read
// once, 453 MB; the features written once, 452 MB).  The function's own
// bound is lower: the same products at f32 accuracy run on the tensor
// cores as three TF32 products each (cepstrum_wgmma.cu, 0.82 ms there).
//
// Design: a register-tiled f32 GEMM (ops/cepstrum_plan.py holds its tile,
// its table and a numpy emulation of its maps, `emulate_simt`).  The rows
// are the (B T, n_filt + 1) log-mel rows, the table the DCT's columns
// extended by the energy:
// ext[m][i] = dct_t[m][i] for 0 < i < n_mfcc, ext[n_filt][0] = 1 and zero
// elsewhere, padded with zeros to (k_pad, n_pad), multiples of TSC_CEP_BK
// and TSC_CEP_BN; column 0 of the product is then the log energy itself
// (each other term is 0 times a finite log), so every output column comes
// from one product, summed in the fused epilogue's order (m = 0, 1, ...).
// - A block computes a TSC_CEP_BM x TSC_CEP_BN tile of whole windows, wpb =
//   max(1, BM / T) of them (5 x 23 frames, 4 x 30), so that a delta's
//   previous frame lies in the tile; a window longer than BM frames runs in
//   chunks of BM rows, the last row of each kept for the next chunk's first
//   delta.  The N tiles of one M tile are consecutive blocks, which share
//   its rows through the L2.
// - 256 threads, 8 x 8 results each (rows ty 4 + {0..3} and 64 + ty 4 +
//   {0..3}, columns likewise by tx: float4 reads of shared memory, one
//   wavefront for the rows, two for the columns).  K in slices of BK = 8
//   through a ring of two shared-memory stages filled by cp.async: a
//   slice of the rows, 4-byte copies (a row is n_filt + 1 floats, not
//   16-byte aligned), stored k-major with a pad of 4 floats so that the
//   copies of a warp (8 k x 4 rows) hit 32 banks; a slice of the table,
//   one 16-byte copy a thread.  Rows and k past the end are zero-filled.
// - The epilogue stages the tile in shared memory (over the ring) and
//   stores it row by row, columns on consecutive threads, batch- or
//   time-major, with the deltas from the staged row before.

#include "register_fft.cuh"

// The tile (ops/cepstrum_plan.py mirrors these; tests/test_torch_cepstrum.py
// holds the two together)
#define TSC_CEP_BM 128      // rows (frames) a tile
#define TSC_CEP_BN 128      // output columns a tile
#define TSC_CEP_BK 8        // the K slice a stage
#define TSC_CEP_THREADS 256  // 16 x 16 threads, 8 x 8 results each
#define TSC_CEP_APAD 4      // floats past a k-row of the rows' stage

namespace {

constexpr int kBM = TSC_CEP_BM, kBN = TSC_CEP_BN, kBK = TSC_CEP_BK;
constexpr int kCepThreads = TSC_CEP_THREADS;
constexpr int kAPitch = kBM + TSC_CEP_APAD;  // floats a k-row of a rows stage
constexpr int kCPitch = kBN + 1;             // floats a row of the staged tile
constexpr int kRingFloats = 2 * kBK * kAPitch + 2 * kBK * kBN;
constexpr int kTileFloats = kBM * kCPitch;
constexpr int kMainFloats = kRingFloats > kTileFloats ? kRingFloats : kTileFloats;
// the ring (or, after the K loop, the staged tile), then one carried row
constexpr size_t kCepSmemBytes = sizeof(float) * (kMainFloats + kBN);
static_assert(kCepThreads == 256 && kBM == 128 && kBN == 128,
              "16 x 16 threads of 8 x 8 results");
static_assert(kBM * kBK == 4 * kCepThreads && kBN * kBK == 4 * kCepThreads,
              "4 row copies and one 16-byte table copy a thread a stage");

struct CepArgs {
  const float* logmel;  // (batch, n_features, n_filt + 1)
  const float* table;   // (k_pad, n_pad), the extended DCT
  void* out;
  int batch, n_features, n_filt, n_mfcc, k_pad, n_pad, wpb, emit_deltas, time_major;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename OutT>
__global__ void __launch_bounds__(TSC_CEP_THREADS, 2) cepstrum_kernel(CepArgs a) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* as_ring = smem;                      // [2][kBK][kAPitch]
  float* bs_ring = smem + 2 * kBK * kAPitch;  // [2][kBK][kBN]
  float* tile = smem;                         // [kBM][kCPitch], after the K loop
  float* carry = smem + kMainFloats;          // [kBN]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_tiles = a.n_pad / kBN;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int w0 = (blockIdx.x / n_tiles) * a.wpb;
  const int T = a.n_features, K = a.n_filt + 1;
  const int rows = min(a.wpb, a.batch - w0) * T;  // the block's rows
  const float* A = a.logmel + (size_t)w0 * T * K;
  const float* B = a.table + n0;
  const int n_cols = min(kBN, a.n_mfcc - n0);
  const int F = a.emit_deltas ? 2 * a.n_mfcc : a.n_mfcc;
  const int n_k = a.k_pad / kBK;
  // a thread's copies: rows am + 32 j at k = ak; the table's k-row bk at bn
  const int ak = tid & 7, am = tid >> 3;
  const int bk = tid >> 5, bn = (tid & 31) * 4;

  for (int c0 = 0; c0 < rows; c0 += kBM) {
    auto fill = [&](int stage, int k0) {
      float* as = as_ring + stage * kBK * kAPitch + ak * kAPitch;
      const int k = k0 + ak;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = am + 32 * j;
        const bool full = c0 + m < rows && k < K;
        cp_async4(as + m, full ? A + (size_t)(c0 + m) * K + k : A, full);
      }
      cp_async16(bs_ring + stage * kBK * kBN + bk * kBN + bn,
                 B + (size_t)(k0 + bk) * a.n_pad + bn);
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    fill(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < n_k; ++kt) {
      if (kt + 1 < n_k) fill((kt + 1) & 1, (kt + 1) * kBK);
      cp_async_commit();  // (empty after the last slice: the count stays)
      cp_async_wait_one();
      __syncthreads();
      const float* as = as_ring + (kt & 1) * kBK * kAPitch;
      const float* bs = bs_ring + (kt & 1) * kBK * kBN;
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(as + k * kAPitch + 4 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(as + k * kAPitch + 64 + 4 * ty);
        const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kBN + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + k * kBN + 64 + 4 * tx);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();  // the stage is refilled two slices on
    }

    // the tile into shared memory, over the ring the loop's last barrier freed
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tile[r * kCPitch + (j < 4 ? 0 : 64) + 4 * tx + (j & 3)] = acc[i][j];
    }
    __syncthreads();
    const int n_rows = min(kBM, rows - c0);
    for (int i = tid; i < n_rows * n_cols; i += kCepThreads) {
      const int r = i / n_cols, c = i - r * n_cols;
      const int g = c0 + r;  // the block's row: window w0 + g / T, frame g % T
      const int b = w0 + g / T, t = g % T;
      const float v = tile[r * kCPitch + c];
      const size_t row = a.time_major ? (size_t)t * a.batch + b : (size_t)b * T + t;
      OutT* o = static_cast<OutT*>(a.out) + row * F + n0 + c;
      store_out(o, v);
      if (a.emit_deltas) {
        const float prev = r ? tile[(r - 1) * kCPitch + c] : carry[c];
        store_out(o + a.n_mfcc, t ? v - prev : 0.0f);
      }
    }
    if (c0 + kBM < rows) {  // a window of more than BM frames: its next chunk
      __syncthreads();
      for (int c = tid; c < kBN; c += kCepThreads)
        carry[c] = tile[(kBM - 1) * kCPitch + c];
    }
    __syncthreads();  // the next chunk refills the ring over the tile
  }
}

template <typename OutT>
cudaError_t launch_cepstrum(const CepArgs& a, cudaStream_t stream) {
  static int limit[kMaxDevices] = {};
  auto kernel = cepstrum_kernel<OutT>;
  const cudaError_t err = opt_in(kernel, limit, kCepSmemBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((a.batch + a.wpb - 1) / a.wpb) * (a.n_pad / kBN);
  kernel<<<static_cast<unsigned>(blocks), kCepThreads, kCepSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// logmel (batch, n_features, n_filt + 1) f32 on the device (the FFT body's
// log-mel mode); table (k_pad, n_pad) f32, ops/cepstrum_plan.py::
// extended_table (k_pad >= n_filt + 1 a multiple of TSC_CEP_BK, n_pad >=
// n_mfcc a multiple of TSC_CEP_BN); windows_per_block max(1, TSC_CEP_BM /
// n_features); out (batch, n_features, F) or, time_major, (n_features,
// batch, F), F = n_mfcc or 2 n_mfcc with emit_deltas, f32 or bf16.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for an argument
// out of range).
extern "C" int tsc_cepstrum_simt(const void* logmel, int batch, int n_features,
                                 int n_filt, int n_mfcc, const void* table, int k_pad,
                                 int n_pad, int windows_per_block, int emit_deltas,
                                 int time_major, void* out, int out_bf16,
                                 void* stream) {
  const int wpb = kBM / n_features > 1 ? kBM / n_features : 1;
  if (!logmel || !table || !out || batch <= 0 || n_features <= 0 || n_filt <= 0 ||
      n_mfcc <= 0 || n_mfcc > n_filt || k_pad < n_filt + 1 || k_pad % kBK ||
      n_pad < n_mfcc || n_pad % kBN || windows_per_block != wpb ||
      (long long)((batch + wpb - 1) / wpb) * (n_pad / kBN) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  CepArgs a;
  a.logmel = static_cast<const float*>(logmel);
  a.table = static_cast<const float*>(table);
  a.out = out;
  a.batch = batch;
  a.n_features = n_features;
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.k_pad = k_pad;
  a.n_pad = n_pad;
  a.wpb = wpb;
  a.emit_deltas = emit_deltas;
  a.time_major = time_major;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = out_bf16 ? launch_cepstrum<__nv_bfloat16>(a, s)
                                   : launch_cepstrum<float>(a, s);
  return static_cast<int>(err);
}
