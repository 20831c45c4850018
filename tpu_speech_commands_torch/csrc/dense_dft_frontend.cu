// The f32 dense-DFT MFCC frontend of the JAX package's measurement script,
// hand-written for Hopper (sm_90a).  Two entry points share one GEMM main
// loop and one epilogue:
//
// - tsc_dense_dft_combined replaces tools/dev/pallas_experiments.py::
//   make_combined_kernel (pallas_call at :76): the frames times cos|sin as
//   ONE (W, 2 bins) matrix;
// - tsc_dense_dft_halves replaces make_reshape_kernel (pallas_call at :188),
//   for window == 2 hop: the frames are pairs of adjacent hop blocks, and
//   the DFT is two half-window products, X(t) = blk(t) @ M[:hop] +
//   blk(t + 1) @ M[hop:].
//
// Both compute, from (B, S) f32 audio and a device gain g:
//
//   frames  t = first_frame .. first_frame + n_frames - 1 (the JAX kernels:
//           gain 1, first_frame 0 and every frame, 1 + (S - W) / hop)
//   re, im  = frames @ cos, frames @ sin                          (f32)
//   power   = g^2 (re^2 + im^2) / n_fft      (|g X|^2, up to rounding)
//   mel[m]  = safe_log(sum_k power[k] filt[k, m]),  c = mel @ dct_t
//   out     = [safe_log(sum_k power[k]), c[1:n_mfcc]]   (B, n_frames, n_mfcc)
//
// With the gain and first_frame = all frames - n_features, the combined
// kernel computes the f32 contract of the JAX package's dense frontend
// (make_fused_frontend(dft_mode="dense"), K2's f32 branch): the frames of the
// production frontend, measured by dev/r4_mxu_stage1.py's dense line.
//
// What bounds it on this card: operations.  At B 8192 and the default
// config the DFT is 245,760 frames x 1,024 samples x 1,026 columns x 2 = 516
// GFLOP, on the CUDA cores in f32 (no tensor cores: the contract is f32):
// 7.7 ms at the 67 TFLOP/s f32 peak, against 524 MB of audio (0.16 ms of
// bytes).  The filterbank (sparse ranges), log and DCT are under 1%.  The
// radix-2 FFT kernel (csrc/mfcc_frontend.cu) does ~30x fewer operations, so
// this kernel is a measurement, not a faster frontend.
//
// Design: a register-blocked SGEMM whose A operand is read out of the audio.
// - A block owns a tile of 128 GEMM rows: the frames (combined) or hop
//   blocks (halves) of wpb whole windows, or of a run of frames of one
//   window when a window has more than 128.  Row r is (window r / R, frame
//   or block f0 + r % R), and its k-th sample is audio[b, (f0 + i) hop + k]
//   for both kernels: no frame is materialised.
// - The DFT matrix is (k_pad, n_chunks x 128) row-major, its columns in
//   pairs: (cos 0, cos n_fft/2) and then (cos p, sin p) for p = 1 .. n_fft/2
//   - 1.  The Nyquist bin's sin column is zero, so 2 x 513 columns pack into
//   1,024: eight chunks of 128 with none wasted.  For halves each chunk holds
//   64 columns of M[:hop] then the same 64 columns of M[hop:].
// - The K-slices (16 deep) of A (4-byte cp.async, a warp instruction
//   reading 4 rows x 8 consecutive samples, zeros past K) and B (16-byte
//   cp.async) stream through a 3-stage ring in shared memory.
//   256 threads, 16 x 16; a thread keeps an 8 x 8 accumulator block, rows
//   {4 ty .. 4 ty + 3, 64 + 4 ty ..} and columns {4 tx .., 64 + 4 tx ..}, and
//   reads each k's 8 + 8 operands with four 16-byte shared loads (A
//   broadcast, B conflict-free): 64 FMAs for 4 loads.  __launch_bounds__
//   (256, 2): two blocks an SM.
// - After each chunk the accumulators become |X|^2 / n_fft in a shared
//   tile (halves: first the block-(t + 1) half goes through shared memory
//   and is added to block t's), and one thread per (row, filter) adds the
//   chunk's bins within the filter's nonzero range (host-packed) into its
//   filter sum; the energy is one more such sum.  The Nyquist bin's power
//   waits in its own slot until the end.
// - After the last chunk: log, the DCT, the energy swap and the store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // GEMM rows a block
constexpr int kBN = 128;  // matrix columns a chunk
constexpr int kBK = 16;   // K-slice
constexpr int kAP = kBM + 4;  // A-stage pitch: the slice loads' stores hit 32 banks
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kEP = kBN / 2 + 1;  // epilogue tile pitch (odd)

// float64 eps, the reference's safe_log clamp; a normal float32 value
constexpr float kLogEps = 2.220446049250313e-16f;

__device__ __forceinline__ float safe_log(float x) {
  return logf(fmaxf(x, kLogEps));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes, or zeros when `bytes` is 0 (src is not read then)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct DenseArgs {
  const float* audio;
  const float* gain;  // (1,), on the device
  int first_frame;    // the first frame computed
  int batch, n_samples, hop, n_frames;
  int rows_per_win;  // R: GEMM rows of one window in a tile
  int wpb;           // windows a tile
  const float* mat;  // (k_pad, n_chunks * kBN), column pairs
  int k_valid, k_pad, n_chunks;
  int n_pairs;       // DFT column pairs; bins 0 .. n_pairs - 1 come from them
  int nyquist;       // 1: pair 0's second column is the Nyquist bin n_pairs
  float inv_fft;
  const float* filt_packed;  // each filter's nonzero bins, back to back
  const int* filt_range;     // (n_filt, 3): bins [lo, hi), offset in filt_packed
  const float* dct_t;        // (n_filt, n_filt)
  int n_packed, n_filt, n_mfcc;
  float* out;                // (batch, n_frames, n_mfcc)
};

__host__ __device__ inline int mel_pitch(int n_filt) { return (n_filt + 1) | 1; }

// Shared memory, in floats: the A and B rings, the epilogue tile, the rows'
// audio offsets (int64), the filter sums, the Nyquist powers, the packed
// filterbank, the DCT, the ranges (tsc_dense_dft_smem_bytes reports it).
__host__ __device__ inline size_t smem_floats(int n_filt, int n_packed) {
  return (size_t)kStages * kBK * (kAP + kBN) + (size_t)kBM * kEP + 2 * kBM +
         (size_t)kBM * mel_pitch(n_filt) + kBM + n_packed +
         (size_t)n_filt * n_filt + 3 * (size_t)n_filt;
}

template <bool kHalves>
__global__ void __launch_bounds__(kThreads, 2)
    dense_dft_kernel(const DenseArgs a) {
  extern __shared__ float4 smem_raw[];
  float* sa = reinterpret_cast<float*>(smem_raw);  // kStages x (kBK, kAP)
  float* sb = sa + kStages * kBK * kAP;            // kStages x (kBK, kBN)
  float* se = sb + kStages * kBK * kBN;            // (kBM, kEP)
  long long* srow = reinterpret_cast<long long*>(se + kBM * kEP);  // (kBM,)
  const int mp = mel_pitch(a.n_filt);
  float* smel = reinterpret_cast<float*>(srow + kBM);  // (kBM, mp)
  float* snyq = smel + kBM * mp;                   // (kBM,)
  float* sfilt = snyq + kBM;
  float* sdct = sfilt + a.n_packed;
  int* srange = reinterpret_cast<int*>(sdct + a.n_filt * a.n_filt);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int R = a.rows_per_win;
  const int frames_per_win = kHalves ? R - 1 : R;  // frames a window in a tile
  const int b0 = blockIdx.x * a.wpb;
  const int nb = min(a.wpb, a.batch - b0);
  const int f0 = blockIdx.y * frames_per_win;
  const int row_limit = kHalves ? a.n_frames + 1 : a.n_frames;  // blocks | frames
  const int n_ks = a.k_pad / kBK;
  const int total = a.n_chunks * n_ks;
  const int ldb = a.n_chunks * kBN;

  // is GEMM row r a frame of the output
  auto frame_row = [&](int r) {
    const int lw = r / R;
    const int i = r - lw * R;
    return lw < nb && i < frames_per_win && f0 + i < a.n_frames;
  };

  // each row's audio offset, or -1 for a padding row
  for (int r = tid; r < kBM; r += kThreads) {
    const int lw = r / R;
    const int j = f0 + r - lw * R;
    srow[r] = lw < nb && j < row_limit
                  ? (long long)(b0 + lw) * a.n_samples +
                        (long long)(a.first_frame + j) * a.hop
                  : -1;
  }
  __syncthreads();

  // A slice loads: a warp instruction reads 4 rows x 8 consecutive samples
  // (four 32-byte sectors); this thread's k is fixed, its rows step by 4
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kq = (warp >> 2) * 8 + (lane & 7);          // k within the slice
  const int rq = (warp & 3) * 32 + (lane >> 3);        // first row, then +4
  auto load_slice = [&](int it, int st) {
    const int nc = it / n_ks;
    const int k0 = (it - nc * n_ks) * kBK;
    const int k = k0 + kq;
    float* da = sa + st * kBK * kAP + kq * kAP;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int r = rq + 4 * jj;
      const long long off = srow[r];
      const bool ok = off >= 0 && k < a.k_valid;
      cp_async4(smem_addr(da + r), ok ? a.audio + off + k : a.audio, ok ? 4 : 0);
    }
    float* db = sb + st * kBK * kBN;
#pragma unroll
    for (int idx = tid; idx < kBK * kBN / 4; idx += kThreads) {
      const int kr = idx / (kBN / 4);
      const int c4 = idx - kr * (kBN / 4);
      cp_async16(smem_addr(db + kr * kBN + c4 * 4),
                 a.mat + (size_t)(k0 + kr) * ldb + nc * kBN + c4 * 4);
    }
  };
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < total) load_slice(st, st);
    cp_async_commit();
  }

  for (int i = tid; i < kBM * mp; i += kThreads) smel[i] = 0.0f;
  for (int i = tid; i < kBM; i += kThreads) snyq[i] = 0.0f;
  for (int i = tid; i < a.n_packed; i += kThreads) sfilt[i] = __ldg(&a.filt_packed[i]);
  for (int i = tid; i < a.n_filt * a.n_filt; i += kThreads) sdct[i] = __ldg(&a.dct_t[i]);
  for (int i = tid; i < 3 * a.n_filt; i += kThreads) srange[i] = __ldg(&a.filt_range[i]);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // the accumulator block's rows: i < 4 -> 4 ty + i, else 64 + 4 ty + i - 4
  auto acc_row = [&](int i) { return (i < 4 ? 0 : kBM / 2 - 4) + 4 * ty + i; };

  const float g = __ldg(a.gain);
  const float pscale = g * g * a.inv_fft;  // |g X|^2 / n_fft
  const int r_own = tid & (kBM - 1);  // filterbank: this thread's row
  const int m_first = tid / kBM;      // and its first filter
  constexpr int kMStep = kThreads / kBM;
  constexpr int kPairsPerChunk = kHalves ? kBN / 4 : kBN / 2;

  for (int it = 0; it < total; ++it) {
    const int nc = it / n_ks;
    const int ks = it - nc * n_ks;
    cp_async_wait<kStages - 2>();
    // slice `it` is in place, and every thread is done with the stage that
    // slice it + kStages - 1 reuses
    __syncthreads();
    if (it + kStages - 1 < total) load_slice(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();

    const float* ta = sa + (it % kStages) * kBK * kAP;
    const float* tb = sb + (it % kStages) * kBK * kBN;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(ta + k * kAP + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(ta + k * kAP + kBM / 2 + 4 * ty);
      const float4 v0 = *reinterpret_cast<const float4*>(tb + k * kBN + 4 * tx);
      const float4 v1 = *reinterpret_cast<const float4*>(tb + k * kBN + kBN / 2 + 4 * tx);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (ks != n_ks - 1) continue;

    // ---- chunk epilogue: accumulators -> power tile se (row, pair) ----
    // A pair's power is (re^2 + im^2) / n_fft, except pair 0 = (cos 0,
    // cos n_fft/2): bin 0's power re^2, the Nyquist bin's im^2 (kept aside).
    const int pair0 = nc * kPairsPerChunk;
    auto power = [&](int r, int pl, float re, float im) {
      if (pair0 + pl != 0) return (re * re + im * im) * pscale;
      snyq[r] = a.nyquist ? im * im * pscale : 0.0f;
      return re * re * pscale;
    };
    if (kHalves) {
      // columns 4 tx + 0..3 of the chunk's pairs: acc[i][0..3] the
      // first-half product of block r, acc[i][4..7] the second-half one;
      // frame r is first(r) + second(r + 1)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) se[acc_row(i) * kEP + 4 * tx + q] = acc[i][4 + q];
      __syncthreads();
      float pw[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = acc_row(i);
        // the last row of a tile is never a frame: any row will do
        const float* nxt = se + (r + 1 < kBM ? r + 1 : r) * kEP + 4 * tx;
#pragma unroll
        for (int q = 0; q < 2; ++q)
          pw[i][q] = power(r, 2 * tx + q, acc[i][2 * q] + nxt[2 * q],
                           acc[i][2 * q + 1] + nxt[2 * q + 1]);
      }
      __syncthreads();  // every thread has read the second halves
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q) se[acc_row(i) * kEP + 2 * tx + q] = pw[i][q];
    } else {
      // columns 4 tx + 0..3 and 64 + 4 tx + 0..3: pairs 2 tx, 2 tx + 1,
      // 32 + 2 tx, 33 + 2 tx
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = acc_row(i);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int pl = (q < 2 ? 0 : kBN / 4 - 2) + 2 * tx + q;
          se[r * kEP + pl] = power(r, pl, acc[i][2 * q], acc[i][2 * q + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    __syncthreads();

    // filter sums over the chunk's bins; m == n_filt is the energy
    const int bin_end = min(pair0 + kPairsPerChunk, a.n_pairs);
    if (frame_row(r_own)) {
      const float* pwr = se + r_own * kEP;
      for (int m = m_first; m <= a.n_filt; m += kMStep) {
        float s = 0.0f;
        if (m < a.n_filt) {
          const int f_lo = srange[3 * m];
          const float* fw = sfilt + srange[3 * m + 2];
          const int lo = max(pair0, f_lo);
          const int hi = min(bin_end, srange[3 * m + 1]);
          for (int k = lo; k < hi; ++k) s += pwr[k - pair0] * fw[k - f_lo];
        } else {
          for (int k = pair0; k < bin_end; ++k) s += pwr[k - pair0];
        }
        smel[r_own * mp + m] += s;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the Nyquist bin, then the log of the filter sums and the energy
  if (frame_row(r_own)) {
    const float pn = snyq[r_own];
    for (int m = m_first; m <= a.n_filt; m += kMStep) {
      float s = smel[r_own * mp + m];
      if (m == a.n_filt) {
        s += pn;
      } else if (a.nyquist) {
        const int f_lo = srange[3 * m];
        if (f_lo <= a.n_pairs && a.n_pairs < srange[3 * m + 1])
          s += pn * sfilt[srange[3 * m + 2] + a.n_pairs - f_lo];
      }
      smel[r_own * mp + m] = safe_log(s);
    }
  }
  __syncthreads();
  // the DCT and the energy swap, into se (row, coefficient)
  if (frame_row(r_own)) {
    const float* mel = smel + r_own * mp;
    for (int i = m_first; i < a.n_mfcc; i += kMStep) {
      float v;
      if (i == 0) {
        v = mel[a.n_filt];
      } else {
        v = 0.0f;
        for (int m = 0; m < a.n_filt; ++m) v += mel[m] * sdct[m * a.n_filt + i];
      }
      se[r_own * kEP + i] = v;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nb * R * a.n_mfcc; idx += kThreads) {
    const int r = idx / a.n_mfcc;
    const int c = idx - r * a.n_mfcc;
    if (!frame_row(r)) continue;
    const int lw = r / R;
    const int t = f0 + r - lw * R;
    a.out[((size_t)(b0 + lw) * a.n_frames + t) * a.n_mfcc + c] = se[r * kEP + c];
  }
}

template <bool kHalves>
cudaError_t launch(const DenseArgs& a, int n_tiles, cudaStream_t stream) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * smem_floats(a.n_filt, a.n_packed);
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  auto kernel = dense_dft_kernel<kHalves>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.batch + a.wpb - 1) / a.wpb, n_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int run(bool halves, const void* audio, const void* gain, int first_frame,
        int batch, int n_samples, int hop, int n_frames, int rows_per_win,
        int wpb, int n_tiles, const void* mat, int k_valid, int k_pad,
        int n_chunks, int n_pairs, int nyquist, int n_fft,
        const void* filt_packed, int n_packed, const void* filt_range,
        const void* dct_t, int n_filt, int n_mfcc, void* out, void* stream) {
  if (batch <= 0 || n_samples <= 0 || hop <= 0 || n_frames <= 0 ||
      first_frame < 0 || rows_per_win <= (halves ? 1 : 0) || wpb <= 0 ||
      wpb * rows_per_win > kBM || n_tiles <= 0 || k_valid <= 0 ||
      k_pad < k_valid || k_pad % kBK != 0 || n_chunks <= 0 || n_pairs <= 0 ||
      n_fft <= 0 || n_packed < 0 || n_filt <= 0 || n_mfcc <= 0 || n_mfcc > n_filt || n_mfcc > kEP)
    return cudaErrorInvalidValue;
  DenseArgs a;
  a.audio = static_cast<const float*>(audio);
  a.gain = static_cast<const float*>(gain);
  a.first_frame = first_frame;
  a.batch = batch;
  a.n_samples = n_samples;
  a.hop = hop;
  a.n_frames = n_frames;
  a.rows_per_win = rows_per_win;
  a.wpb = wpb;
  a.mat = static_cast<const float*>(mat);
  a.k_valid = k_valid;
  a.k_pad = k_pad;
  a.n_chunks = n_chunks;
  a.n_pairs = n_pairs;
  a.nyquist = nyquist;
  a.inv_fft = 1.0f / static_cast<float>(n_fft);
  a.filt_packed = static_cast<const float*>(filt_packed);
  a.filt_range = static_cast<const int*>(filt_range);
  a.dct_t = static_cast<const float*>(dct_t);
  a.n_packed = n_packed;
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.out = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(halves ? launch<true>(a, n_tiles, s)
                                 : launch<false>(a, n_tiles, s));
}

}  // namespace

// audio (batch, n_samples) f32 and gain (1,) f32 on the device.  Row i of
// window b's tile (rows_per_win rows a window, wpb windows a tile, n_tiles
// tiles down a window) is output frame f0 + i, its samples audio[b,
// (first_frame + f0 + i) hop + k] for k < k_valid.  mat (k_pad, n_chunks x
// 128) f32, the column pairs of ops/dense_dft_kernel.py::combined_matrix;
// filt_packed / filt_range the packed filterbank
// (ops/frontend_kernel.py::pack_filterbank); dct_t (n_filt, n_filt).  out (batch, n_frames, n_mfcc) f32.  Returns the
// launch's cudaError_t.
extern "C" int tsc_dense_dft_combined(
    const void* audio, const void* gain, int first_frame, int batch,
    int n_samples, int hop, int n_frames, int rows_per_win, int wpb,
    int n_tiles, const void* mat, int k_valid,
    int k_pad, int n_chunks, int n_pairs, int nyquist, int n_fft,
    const void* filt_packed, int n_packed, const void* filt_range,
    const void* dct_t, int n_filt, int n_mfcc, void* out, void* stream) {
  return run(false, audio, gain, first_frame, batch, n_samples, hop, n_frames,
             rows_per_win, wpb, n_tiles, mat, k_valid, k_pad, n_chunks,
             n_pairs, nyquist, n_fft, filt_packed, n_packed, filt_range, dct_t,
             n_filt, n_mfcc, out, stream);
}

// The same for window == 2 hop: row i of a window's tile is hop block
// f0 + i (k_valid = hop samples), rows_per_win - 1 frames a tile; mat holds,
// for each chunk, 64 columns of the first-half matrix then the same 64 of
// the second half (ops/dense_dft_kernel.py::halves_matrix).
extern "C" int tsc_dense_dft_halves(
    const void* audio, const void* gain, int first_frame, int batch,
    int n_samples, int hop, int n_frames, int rows_per_win, int wpb,
    int n_tiles, const void* mat, int k_valid,
    int k_pad, int n_chunks, int n_pairs, int nyquist, int n_fft,
    const void* filt_packed, int n_packed, const void* filt_range,
    const void* dct_t, int n_filt, int n_mfcc, void* out, void* stream) {
  return run(true, audio, gain, first_frame, batch, n_samples, hop, n_frames,
             rows_per_win, wpb, n_tiles, mat, k_valid, k_pad, n_chunks,
             n_pairs, nyquist, n_fft, filt_packed, n_packed, filt_range, dct_t,
             n_filt, n_mfcc, out, stream);
}

// Dynamic shared memory a block of either kernel takes, in bytes.  A launch
// whose need exceeds the card's opt-in limit returns cudaErrorInvalidValue.
extern "C" int tsc_dense_dft_smem_bytes(int n_filt, int n_packed) {
  return static_cast<int>(sizeof(float) * smem_floats(n_filt, n_packed));
}
