// MFCC / bark frontend with the DFT on the tensor cores (the fast_math
// contract), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_speech_commands/ops/pallas_frontend.py::
// make_fused_frontend (pallas_call at :340) with fast_math=True and
// dft_mode='dense', and tools/dev/pallas_experiments.py::make_bf16_kernel
// (pallas_call at :128), which computes the same contract:
//
//   x      = int16 ? pcm * (gain / 32768) : audio * gain          (f32)
//   frames = bf16(x[t*hop : t*hop + K])       K = min(window, n_fft)
//   re, im = frames @ bf16(cos), frames @ bf16(sin)    f32 accumulation
//   power  = (re^2 + im^2) / n_fft
//   mel[m] = safe_log(sum_k power[k] * filt_t[m, k])               (f32)
//   c[0]   = safe_log(sum_k power[k]),  c[i] = sum_m mel[m] dct_t[m, i]
//   optional deltas c[t] - c[t-1] (zero for the first kept frame)
//
// What bounds it on this card.  At the serving shape (B 8192, 30 kept
// frames of K 1024, 513 bins) the DFT is a GEMM of 245,760 x 1,026 x 1,024:
// 516 GFLOP (558 with this kernel's padding), against 524 MB of f32 audio
// read.  That is ~1,000 FLOP per byte, far above the bf16 ridge (~295), so
// it is bound by the tensor cores; at the dense bf16 rate the floor is
// ~0.55 ms.  The filterbank (sparse ranges), log and DCT are a few percent
// of that on the CUDA cores.
//
// Design.  The TPU kernel framed each tile of windows into a (T*TB, W)
// matrix and ran two MXU matmuls.  Here a block owns a tile of whole windows
// (wpb, 4 at the serving shape: 120 of the block's 128 GEMM rows), so the
// deltas and the tail trim stay in the block:
// - The windows' audio is decoded, gained, rounded to bf16 and staged once
//   in shared memory.  Frames overlap, so the audio is stored, not the
//   frames: half the bytes at 50% overlap.  The audio is cut into segments
//   of one hop, each followed by `pad` unused elements, chosen so that
//   (hop + pad) / 8 is odd: the 8 rows of an ldmatrix (8 consecutive
//   frames) then start in 8 distinct 16-byte bank groups.  A frame starts
//   at a segment boundary; skoff[k / 8] maps a frame offset k to its
//   address offset.  The host refuses hop % 8 != 0, which would split an
//   8-element ldmatrix row across a segment gap.
// - The DFT matrix is bf16, (n_pad, k_pad) row-major, its columns cos and
//   sin of one bin side by side (2k, 2k + 1), so an mma accumulator
//   fragment holds re and im of the same bin in one thread.  It is small
//   (2.1 MB) and stays in L2; K-slices of 128 columns x 64 stream through a
//   cp.async double buffer.
// - 8 warps, 4 (rows) x 2 (columns); a warp computes 32 rows x 64 columns
//   with mma.sync.m16n8k16 (bf16 in, f32 accumulators), operands from
//   ldmatrix.  wgmma and TMA are later work.
// - After each 128-column chunk the accumulators become |X|^2 / n_fft in a
//   shared tile, and one thread per (row, filter) adds the chunk's bins
//   within the filter's nonzero range (host-computed) into its filter sum;
//   the energy is one more such sum over all bins.
// - After the last chunk: log, the DCT, the energy swap, deltas, and the
//   (B, T, F) store in f32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dft_common.cuh"

namespace {

using namespace tsc_dft;

constexpr int kBM = 128;  // GEMM rows (frames) a block
constexpr int kBN = 128;  // DFT columns a chunk (64 bins)
constexpr int kBK = 64;   // K-slice
constexpr int kBKP = kBK + 8;  // B-stage row pitch: 144 B, ldmatrix conflict-free
constexpr int kStages = 2;  // cp.async ring of B K-slices
constexpr int kWarpsM = kBM / 32;          // warps over the 128 rows (32 each)
constexpr int kWarpsN = 4;                 // warps over the 128 columns
constexpr int kWarpCols = kBN / kWarpsN;   // columns a warp
constexpr int kNT = kWarpCols / 8;         // n8 tiles a warp
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kPPitch = kBN / 2 + 1;  // power tile pitch (odd)

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

struct DftArgs {
  const void* audio;
  const float* gain;
  float in_scale;
  int batch, n_samples, hop, first_frame, n_features;
  int wpb, n_seg, seg_pitch, win_pitch;  // the audio layout in shared memory
  const __nv_bfloat16* dft;              // (n_pad, k_pad), cos|sin interleaved
  int k_pad, n_pad, n_bins;
  float inv_fft;
  const float* filt_packed;  // each filter's nonzero bins, back to back
  const int* filt_range;     // (n_filt, 3): bins [lo, hi), offset in filt_packed
  const float* dct_t;        // (n_filt, n_filt)
  int n_packed, n_filt, n_mfcc, emit_deltas;
  void* out;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }
__host__ __device__ inline int p_floats(int n_mfcc) {
  return kBM * (n_mfcc > kPPitch ? n_mfcc : kPPitch);
}

// Shared memory, in order: audio (wpb x win_pitch bf16), the ring of B
// K-slices, the power tile (reused for the coefficients), the filter sums
// (kBM x mel_pitch f32), the k-offset table, the packed filterbank, its
// ranges and the DCT.  ops/frontend_kernel.py mirrors this sum to choose
// wpb.
__host__ __device__ inline size_t smem_bytes(int wpb, int win_pitch, int n_filt,
                                             int n_mfcc, int k_pad,
                                             int n_packed) {
  return align16(sizeof(__nv_bfloat16) * (size_t)wpb * win_pitch) +
         align16(sizeof(__nv_bfloat16) * kStages * kBN * kBKP) +
         align16(sizeof(float) * (size_t)p_floats(n_mfcc)) +
         align16(sizeof(float) * (size_t)kBM * mel_pitch(n_filt)) +
         align16(sizeof(int) * (size_t)(k_pad / 8)) +
         align16(sizeof(float) * (size_t)n_packed) +
         align16(sizeof(int) * 3 * (size_t)n_filt) +
         align16(sizeof(float) * (size_t)n_filt * n_filt);
}

template <typename InT, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    dft_frontend_kernel(const DftArgs a) {
  extern __shared__ float4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(base);
  base += align16(sizeof(__nv_bfloat16) * (size_t)a.wpb * a.win_pitch);
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(base);
  base += align16(sizeof(__nv_bfloat16) * kStages * kBN * kBKP);
  float* sp = reinterpret_cast<float*>(base);
  base += align16(sizeof(float) * (size_t)p_floats(a.n_mfcc));
  float* smel = reinterpret_cast<float*>(base);
  base += align16(sizeof(float) * (size_t)kBM * mel_pitch(a.n_filt));
  int* skoff = reinterpret_cast<int*>(base);
  base += align16(sizeof(int) * (size_t)(a.k_pad / 8));
  float* sfilt = reinterpret_cast<float*>(base);
  base += align16(sizeof(float) * (size_t)a.n_packed);
  int* srange = reinterpret_cast<int*>(base);
  base += align16(sizeof(int) * 3 * (size_t)a.n_filt);
  float* sdct = reinterpret_cast<float*>(base);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * a.wpb;
  const int nb = min(a.wpb, a.batch - b0);
  const int rows = nb * a.n_features;
  const int n_ks = a.k_pad / kBK;
  const int n_chunks = (a.n_pad + kBN - 1) / kBN;
  const int total = n_chunks * n_ks;
  const int mp = mel_pitch(a.n_filt);

  // B K-slice `it` (chunk it / n_ks, slice it % n_ks) into stage buffer `st`
  auto load_b = [&](int it, int st) {
    const int nc = it / n_ks;
    const int ks = it - nc * n_ks;
    __nv_bfloat16* dst = sb + st * kBN * kBKP;
    for (int i = tid; i < kBN * (kBK / 8); i += kThreads) {
      const int n = i / (kBK / 8);
      const int c = i % (kBK / 8);
      const int ng = nc * kBN + n;
      if (ng < a.n_pad)
        cp_async16(smem_addr(dst + n * kBKP + c * 8),
                   a.dft + (size_t)ng * a.k_pad + ks * kBK + c * 8);
    }
  };
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < total) load_b(st, st);
    cp_async_commit();
  }

  // stage the tile's audio: one warp a (window, hop segment), bf16, four
  // samples a lane per load where the segment lies inside an aligned row
  const InT* audio = static_cast<const InT*>(a.audio);
  const float scale = __ldg(a.gain) * a.in_scale;
  for (int ws = warp; ws < nb * a.n_seg; ws += kThreads / 32) {
    const int lw = ws / a.n_seg;
    const int seg = ws - lw * a.n_seg;
    const InT* src = audio + (size_t)(b0 + lw) * a.n_samples;
    __nv_bfloat16* dst = sa + (size_t)lw * a.win_pitch + (size_t)seg * a.seg_pitch;
    const int g0 = (a.first_frame + seg) * a.hop;
    const bool vec = g0 + a.hop <= a.n_samples &&
                     reinterpret_cast<uintptr_t>(src + g0) % (4 * sizeof(InT)) == 0;
    if (vec) {
#pragma unroll 4
      for (int j = 4 * lane; j < a.hop; j += 128) {
        float4 x;
        load4(src + g0 + j, x);
        __nv_bfloat162 lo = __floats2bfloat162_rn(x.x * scale, x.y * scale);
        __nv_bfloat162 hi = __floats2bfloat162_rn(x.z * scale, x.w * scale);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo);
        packed.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(dst + j) = packed;
      }
    } else {
      for (int j = lane; j < a.hop; j += 32) {
        const int g = g0 + j;
        // past the row: zeros, read only against the DFT's zero K-padding
        const float x = g < a.n_samples ? load_sample(src + g) * scale : 0.0f;
        dst[j] = __float2bfloat16(x);
      }
    }
  }
  const int gap = a.seg_pitch - a.hop;
  for (int i = tid; i < a.k_pad / 8; i += kThreads)
    skoff[i] = i * 8 + (i * 8 / a.hop) * gap;
  for (int i = tid; i < kBM * mp; i += kThreads) smel[i] = 0.0f;
  for (int i = tid; i < a.n_packed; i += kThreads) sfilt[i] = __ldg(&a.filt_packed[i]);
  for (int i = tid; i < 3 * a.n_filt; i += kThreads) srange[i] = __ldg(&a.filt_range[i]);
  for (int i = tid; i < a.n_filt * a.n_filt; i += kThreads) sdct[i] = __ldg(&a.dct_t[i]);

  // ldmatrix row addresses of the warp's two 16-row m-tiles: lane l
  // addresses row (l & 7) + 8 ((l >> 3) & 1) at k-half l >> 4
  const int warp_m = warp / kWarpsN;
  const int warp_n = warp - warp_m * kWarpsN;
  uint32_t a_row[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = warp_m * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    int lw = r / a.n_features;
    int f = r - lw * a.n_features;
    if (r >= rows) lw = f = 0;  // padding rows: any valid address, discarded
    a_row[mt] = smem_addr(sa + (size_t)lw * a.win_pitch + (size_t)f * a.seg_pitch);
  }
  const int a_khalf = lane >> 4;
  // B ldmatrix: lane l addresses column (l & 7) + 8 (l >> 4) at k-half (l >> 3) & 1
  const int b_col = warp_n * kWarpCols + (lane & 7) + (lane >> 4) * 8;
  const int b_k = ((lane >> 3) & 1) * 8;

  float acc[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  const int r_own = tid & (kBM - 1);       // filterbank: this thread's row
  const int m_first = tid / kBM;           // and its first filter
  constexpr int kMStep = kThreads / kBM;

  for (int it = 0; it < total; ++it) {
    const int nc = it / n_ks;
    const int ks = it - nc * n_ks;
    cp_async_wait<kStages - 2>();
    // slice `it` (and, at it 0, the audio and tables) is in place, and
    // every warp is done with the stage that slice it + kStages - 1 reuses
    __syncthreads();
    if (it + kStages - 1 < total)
      load_b(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const __nv_bfloat16* stage = sb + (it % kStages) * kBN * kBKP;
    const int n_valid = a.n_pad - nc * kBN - warp_n * kWarpCols;  // warp's columns
    // fragments of k-step s + 1 load while the mmas of step s run
    uint32_t af[2][2][4], bf[2][kNT / 2][4];
    auto load_frags = [&](int kk, int buf) {
      const int koff = skoff[((ks * kBK + kk) >> 3) + a_khalf];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a_row[mt] + 2u * koff, af[buf][mt][0], af[buf][mt][1],
                    af[buf][mt][2], af[buf][mt][3]);
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p)
        if (p * 16 < n_valid)
          ldmatrix_x4(smem_addr(stage + (b_col + p * 16) * kBKP + kk + b_k),
                      bf[buf][p][0], bf[buf][p][1], bf[buf][p][2], bf[buf][p][3]);
    };
    load_frags(0, 0);
#pragma unroll
    for (int step = 0; step < kBK / 16; ++step) {
      const int cur = step & 1;
      if (step + 1 < kBK / 16) load_frags((step + 1) * 16, cur ^ 1);
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        if (p * 16 < n_valid) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * p], af[cur][mt], bf[cur][p][0], bf[cur][p][1]);
            mma_bf16(acc[mt][2 * p + 1], af[cur][mt], bf[cur][p][2], bf[cur][p][3]);
          }
        }
      }
    }
    if (ks == n_ks - 1) {
      // accumulators (re, im of one bin side by side) -> power tile
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = warp_m * 32 + mt * 16 + (lane >> 2);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if (nt * 8 < n_valid) {
            const int bin = warp_n * (kWarpCols / 2) + nt * 4 + (lane & 3);
            const float* c = acc[mt][nt];
            sp[r * kPPitch + bin] = (c[0] * c[0] + c[1] * c[1]) * a.inv_fft;
            sp[(r + 8) * kPPitch + bin] = (c[2] * c[2] + c[3] * c[3]) * a.inv_fft;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
        }
      }
      __syncthreads();
      // filter sums over the chunk's bins; m == n_filt is the energy
      const int bin0 = nc * (kBN / 2);
      const int bin_end = min(bin0 + kBN / 2, a.n_bins);
      if (r_own < rows) {
        const float* pw = sp + r_own * kPPitch;
        for (int m = m_first; m <= a.n_filt; m += kMStep) {
          float s = 0.0f;
          if (m < a.n_filt) {
            const int f_lo = srange[3 * m];
            const float* fw = sfilt + srange[3 * m + 2];
            const int lo = max(bin0, f_lo);
            const int hi = min(bin_end, srange[3 * m + 1]);
            for (int k = lo; k < hi; ++k) s += pw[k - bin0] * fw[k - f_lo];
          } else {
            for (int k = bin0; k < bin_end; ++k) s += pw[k - bin0];
          }
          smel[r_own * mp + m] += s;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // log of the filter sums and the energy, the DCT, deltas and the store
  const int n_out = a.emit_deltas ? 2 * a.n_mfcc : a.n_mfcc;
  cepstrum_tail<kThreads, kBM>(
      tid, rows, a.n_features, a.n_filt, a.n_mfcc, a.emit_deltas, smel, sdct,
      sp, static_cast<OutT*>(a.out) + (size_t)b0 * a.n_features * n_out,
      [] { __syncthreads(); });
}

template <typename InT, typename OutT>
cudaError_t launch(const DftArgs& a, cudaStream_t stream) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(a.wpb, a.win_pitch, a.n_filt, a.n_mfcc,
                                 a.k_pad, a.n_packed);
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  auto kernel = dft_frontend_kernel<InT, OutT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.batch + a.wpb - 1) / a.wpb;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// audio (batch, n_samples) f32 or int16; gain (1,) f32 on the device.
// Frames first_frame .. first_frame + n_features - 1 (hop apart) are
// computed.  Layout (ops/frontend_kernel.py::dft_layout): wpb windows a
// block, each staged as n_seg hop segments of seg_pitch bf16 elements in a
// window pitch of win_pitch.  dft (n_pad, k_pad) bf16 with columns cos|sin
// of each bin interleaved; filt_packed (n_packed,) f32, the nonzero bins of
// each filter back to back; filt_range (n_filt, 3) int32: each filter's
// bins [lo, hi) and its offset in filt_packed; dct_t (n_filt, n_filt) f32.
// out (batch, n_features, n_mfcc or 2 n_mfcc) f32 or bf16.  Returns the
// launch's cudaError_t.
extern "C" int tsc_dft_frontend_bf16(
    const void* audio, int audio_int16, const void* gain, int batch,
    int n_samples, int hop, int first_frame, int n_features, int wpb,
    int n_seg, int seg_pitch, int win_pitch, const void* dft, int k_pad,
    int n_pad, int n_bins, int n_fft, const void* filt_packed, int n_packed,
    const void* filt_range, const void* dct_t, int n_filt, int n_mfcc,
    int emit_deltas, void* out, int out_bf16, void* stream) {
  if (batch <= 0 || hop <= 0 || hop % 8 != 0 || seg_pitch < hop ||
      seg_pitch % 8 != 0 || win_pitch % 8 != 0 || win_pitch < n_seg * seg_pitch ||
      k_pad <= 0 || k_pad % kBK != 0 || n_pad <= 0 || n_pad % 16 != 0 ||
      2 * n_bins > n_pad || n_features <= 0 || wpb <= 0 ||
      wpb * n_features > kBM || n_mfcc > n_filt || n_mfcc <= 0 || n_fft <= 0 ||
      n_packed < 0)
    return cudaErrorInvalidValue;
  DftArgs a;
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
  a.dft = static_cast<const __nv_bfloat16*>(dft);
  a.k_pad = k_pad;
  a.n_pad = n_pad;
  a.n_bins = n_bins;
  a.inv_fft = 1.0f / static_cast<float>(n_fft);
  a.filt_packed = static_cast<const float*>(filt_packed);
  a.n_packed = n_packed;
  a.filt_range = static_cast<const int*>(filt_range);
  a.dct_t = static_cast<const float*>(dct_t);
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.emit_deltas = emit_deltas;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (audio_int16)
    err = out_bf16 ? launch<int16_t, __nv_bfloat16>(a, s) : launch<int16_t, float>(a, s);
  else
    err = out_bf16 ? launch<float, __nv_bfloat16>(a, s) : launch<float, float>(a, s);
  return static_cast<int>(err);
}
