// Cooley-Tukey (CT) split MFCC / bark frontend, hand-written for Hopper
// (sm_90a).
//
// Computes what the JAX package's CT kernel computes:
// tpu_speech_commands/ops/pallas_frontend.py::_make_ct_frontend (pallas_call
// at :745) and its K8 variants, tools/dev/r3_frontend_variants.py (:171),
// tools/dev/r3_stage2.py (:182) and tools/dev/r3_widecell.py (:169), with the
// scorer's contract:
//
//   audio (B, S) f32 | int16, gain (1,) f32  ->  (B, T, F) or (T, B, F)
//   x = int16 ? pcm * (gain / 32768) : audio * gain
//   per kept frame, n = 128 a + b (a < n2 = n_fft / 128, b < 128):
//     stage 1  T[s, b] = sum_a x[128 a + b] W_n2^(s a),  s = 0 .. n2 / 2
//     stage 2  per residue s: [Xr | Xi] = T_re[s'] @ E2a[s] +- T_im[s'] @ E2b[s]
//              (s' = min(s, n2 - s); E pre-scaled by 1 / sqrt(n_fft)), the
//              64 bins n2 j + s; Nyquist = sum_b (-1)^b T[0, b] / sqrt(n_fft)
//     power    |X|^2, permuted (row s * 64 + j), filterbank with an energy
//              column, safe_log, DCT; coefficient 0 is the log energy
//   optional deltas c[t] - c[t-1] (zero for the first kept frame), f32 | bf16
//
// Two compile-time switches, four instantiations (ops/ct_kernel.py::VARIANTS):
// - PAIRED: the conjugate residues s and n2 - s share one read of the T rows:
//   one product of 256 columns, [E2a[s] E2a[n2-s]; E2b[s] -E2b[n2-s]],
//   instead of two of 128 (r3_stage2.py's paired);
// - PER_PIECE_MEL: the filterbank runs on each residue's unfolded squares
//   Xr^2 and Xi^2 against duplicated rows (r3_frontend_variants.py's
//   mel='dup', r3_stage2.py's ppmel): no 513-wide power row is kept, at
//   twice the filterbank's operations.  Without it, each residue's fold
//   |X|^2 = Xr^2 + Xi^2 lands in a shared (rows, n_fft / 2 + 1) power tile
//   and one filterbank pass follows the last residue.
// The TPU variants that differ only in their vreg and lane layouts (framing
// concat / reshape, r3_widecell's lane-packed butterfly, batch_tile) are the
// same function computed the same way here.
//
// What bounds the function: its bytes, 0.16 ms for the audio read and the
// feature write at B 8192 and the default config, as for the FFT kernel
// (csrc/mfcc_frontend.cu), which computes the same features with ~15x fewer
// operations.  This algorithm's own floor is higher: stage 2 is 14 products
// of 128 x 128 x 2 a frame, 112.7 GFLOP, 1.68 ms on the CUDA cores in f32 at
// 67 TFLOP/s.  The kernel exists for the n_fft that are not powers of two
// and for the TPU variants' measurements.
//
// Design, simple first.  A block owns BM frame rows (the frames of whole
// windows, or a run of one long window's frames led by a halo row for the
// deltas) and loops over the residues s' = 0 .. n2 / 2:
// - stage 1: threads run along b, so the reads of x[row][128 a + b]
//   coalesce; each thread forms T_re[s'] and T_im[s'] of its b for its rows
//   (the radix-2 butterfly of _dft8_real for n2 = 8, the stage-1 tables
//   otherwise) and stores them k-major in shared memory (2 x 128 x BM: one
//   residue's T, the A operand of stage 2).  The frames stay in device
//   memory; the passes after the first read them from L2;
// - stage 2: a register-blocked product, 256 threads as 16 x 16, a thread
//   holding BM / 16 rows and the columns 4 tx .. 4 tx + 3 and 64 + 4 tx ..
//   of each 128-column residue block, so that Xr and Xi of one bin sit in
//   one thread and the fold is in registers.  The stage-2 matrices (1 MB,
//   resident in L2) stream through a 3-stage cp.async ring of 8-deep K-slices;
// - the filterbank: one thread a (row, filter), over each residue's range
//   of nonzero weights (host-computed), the residue's weights staged in
//   the idle K-slice ring; the energy, the power's sum, is a shuffle
//   reduction over the threads that hold a row's power;
// - after the last residue: the Nyquist bin, log, DCT, deltas, the store.
// Shared memory at BM 64 and the default config: 214 KiB (unpaired) or 226
// KiB (paired) without PER_PIECE_MEL (the power tile is 128 KiB of it), 118
// or 162 KiB with it: one block an SM.  tsc_ct_frontend takes the largest BM
// (64, then 32) that fits the card's opt-in shared memory and cuts the
// frames to it; it refuses a config where neither fits (without
// PER_PIECE_MEL, from n_fft 2816 up at 20 filters on an H100).  After the
// last residue the DCT's coefficients take the idle T, ring and power
// space, or a region of their own where they outnumber it (coef_floats), so
// they never limit the block.
//
// A third switch, STOP, cuts the (F, F) kernel after one stage for the
// stage-omission profile of tools/dev/r3_omission.py (pallas_call :164,
// ops/omission_kernel.py): load, framing, butterfly (stage 1), power (stage
// 2 and the fold into the power row), mel, log or full.  A cut runs what the
// shipped kernel runs up to its stage, with the same launch and shared
// memory, then sums each window's per-frame row into a (B, 128) f32 output
// instead of the deltas and the store.  The shipped instantiations take the
// default, kShipped, and every cut is an `if constexpr`, so they compile as
// before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kLanes = 128;   // b: the split's inner length
constexpr int kJ = 64;        // bins of a residue block: [Xr 64 | Xi 64]
constexpr int kThreads = 256;
constexpr int kBK = 8;        // K-slice of the stage-2 matrices
constexpr int kStages = 3;    // the K-slice ring

// float64 eps, the reference's safe_log clamp; a normal float32 value
constexpr float kLogEps = 2.220446049250313e-16f;

// STOP: the stage a cut ends after (ops/omission_kernel.py::STAGES), or the
// whole shipped kernel
enum Stop : int { kLoad, kFraming, kButterfly, kPower, kMel, kLog, kFull, kShipped };

__device__ __forceinline__ float safe_log(float x) {
  return logf(fmaxf(x, kLogEps));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

struct CtArgs {
  const void* audio;
  int audio_int16;
  const float* gain;
  int batch, n_samples, hop, n_fft, n2;
  int first_frame, n_features;  // kept frames first_frame + o, o < n_features
  int rows_per_win, wpb, n_tiles, halo;
  const float* stage1;    // (2, n2, n2): cos(2 pi s a / n2), -sin(...)
  const float* e2;        // stage-2 packs (ops/ct_constants.py::stage2_pack)
  const float* filt;      // (n_fft / 2, n_filt + 1), row s * 64 + j <-> bin n2 j + s
  const float* filt_nyq;  // (n_filt + 1,)
  const int* jrange;      // (n_filt + 1, n2, 2): nonzero j range of each piece
  const float* dct_t;     // (n_filt, n_filt)
  float nyq_scale;        // 1 / sqrt(n_fft)
  int n_filt, n_mfcc, emit_deltas, time_major, out_bf16;
  void* out;
  int src_mod;  // a cut's window b reads audio row b % src_mod (0: row b)
};

__host__ __device__ inline int mel_pitch(int n_filt) { return (n_filt + 1) | 1; }

// the folded power rows (pitch n_fft / 2 + 1), or one group's unfolded
// squares (pitch 128 or 256, + 1: the filterbank threads run down the rows)
__host__ __device__ inline int sq_pitch(bool ppmel, bool paired, int n_fft) {
  return ppmel ? (paired ? 2 : 1) * kLanes + 1 : n_fft / 2 + 1;
}

// After the last residue the DCT's (BM, n_mfcc) coefficients go where one
// residue's T, the K-slice ring and the power rows or squares were (one
// run of shared memory, all idle by then); where they outnumber that run
// (more than 513 at BM 32 with PER_PIECE_MEL), they get a region of their
// own at the end, and the block grows by this many floats.
__host__ __device__ inline size_t coef_floats(int bm, int n_fft, int n_mfcc,
                                              bool paired, bool ppmel) {
  const size_t c = (size_t)bm * n_mfcc;
  const size_t room = 2 * (size_t)kLanes * (bm + 4) +
                      (size_t)kStages * kBK * (paired ? 2 : 1) * kLanes +
                      (size_t)bm * sq_pitch(ppmel, paired, n_fft);
  return c <= room ? 0 : c;
}

// Shared memory, in floats: the rows' audio offsets (int64), one residue's
// T k-major (2 x 128, pitch BM + 4), the K-slice ring, the power rows or
// squares, the filter sums, the Nyquist powers, and the coefficients where
// they have a region of their own (coef_floats).
__host__ __device__ inline size_t smem_floats(int bm, int n_fft, int n_filt,
                                              int n_mfcc, bool paired,
                                              bool ppmel) {
  const int nc = (paired ? 2 : 1) * kLanes;
  return 2 * (size_t)bm + 2 * (size_t)kLanes * (bm + 4) +
         (size_t)kStages * kBK * nc + (size_t)bm * sq_pitch(ppmel, paired, n_fft) +
         (size_t)bm * mel_pitch(n_filt) + bm +
         coef_floats(bm, n_fft, n_mfcc, paired, ppmel);
}

// How a block of bm frame rows covers (batch, n_features): wpb whole windows
// of rows_per_win frames, or, for a window of more than bm frames, n_tiles
// blocks down it, each led by a halo row (the frame before its first) when
// deltas are on.
void set_tiling(CtArgs& a, int bm) {
  if (a.n_features <= bm) {
    a.rows_per_win = a.n_features;
    a.wpb = bm / a.n_features;
    a.n_tiles = 1;
    a.halo = 0;
  } else {
    a.rows_per_win = bm;
    a.wpb = 1;
    a.halo = a.emit_deltas ? 1 : 0;
    a.n_tiles = (a.n_features + bm - a.halo - 1) / (bm - a.halo);
  }
}

__device__ __forceinline__ float load_x(const CtArgs& a, long long i, float scale) {
  return a.audio_int16
             ? static_cast<float>(__ldg(static_cast<const int16_t*>(a.audio) + i)) * scale
             : __ldg(static_cast<const float*>(a.audio) + i) * scale;
}

// Stage 1 of n2 = 8 from the frame's 8 samples at lane b:
// tpu_speech_commands/ops/pallas_frontend.py::_dft8_real, in its order
__device__ __forceinline__ void dft8(const float (&x)[8], int sr, float& tre,
                                     float& tim) {
  const float ev_a = x[0] + x[4], ev_s = x[0] - x[4];
  const float ev_b = x[2] + x[6], ev_t = x[2] - x[6];
  const float od_a = x[1] + x[5], od_s = x[1] - x[5];
  const float od_b = x[3] + x[7], od_t = x[3] - x[7];
  const float ev0 = ev_a + ev_b, ev2 = ev_a - ev_b;
  const float od0 = od_a + od_b, od2 = od_a - od_b;
  const float kappa = 0.70710678118654752f;
  const float u = (od_s - od_t) * kappa;
  const float v = (od_s + od_t) * kappa;
  switch (sr) {
    case 0: tre = ev0 + od0; tim = 0.0f; break;
    case 1: tre = ev_s + u; tim = -ev_t - v; break;
    case 2: tre = ev2; tim = -od2; break;
    case 3: tre = ev_s - u; tim = ev_t - v; break;
    default: tre = ev0 - od0; tim = 0.0f; break;
  }
}

// Stage 1 of any even n2 at lane b (p = the frame's first sample) from the
// stage-1 tables: T_re[sr], T_im[sr]
__device__ __forceinline__ void stage1_tables(const CtArgs& a, long long p,
                                              int sr, float scale, float& tre,
                                              float& tim) {
  const float* cs = a.stage1 + sr * a.n2;
  const float* sn = a.stage1 + (a.n2 + sr) * a.n2;
  tre = 0.0f;
  tim = 0.0f;
  for (int i = 0; i < a.n2; ++i) {
    const float xi = load_x(a, p + (long long)i * kLanes, scale);
    tre = fmaf(xi, __ldg(&cs[i]), tre);
    tim = fmaf(xi, __ldg(&sn[i]), tim);
  }
}

// The audio row a cut's window b reads: b, or b % src_mod for the
// constant-block profile (every block of the TPU grid reads block 0)
__device__ __forceinline__ int src_window(const CtArgs& a, int b) {
  return a.src_mod ? b % a.src_mod : b;
}

// The sum of n4 4-sample vectors V (float4 or short4) at p: the block's
// threads read neighbouring vectors, 16 a thread issued before the first is
// added, so the read runs at the memory's rate and not at its latency
template <typename V>
__device__ __forceinline__ float window_sum(const V* p, int n4) {
  constexpr int kBatch = 16;
  float total = 0.0f;
  for (int i0 = threadIdx.x; i0 < n4; i0 += kBatch * kThreads) {
    V v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = i < n4 ? __ldg(p + i) : V{};
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      total += (static_cast<float>(v[u].x) + static_cast<float>(v[u].y)) +
               (static_cast<float>(v[u].z) + static_cast<float>(v[u].w));
  }
  return total;
}

// The load cut: every sample of the block's windows is read, as the TPU
// kernel's BlockSpec copies the whole (16, S) block, and out[l] = x[l] +
// x[S - 128 + l].  The block's sum of all it read enters the output times
// 0, so no read can be dropped and the output of finite audio does not
// change.  S is a multiple of 4 (tsc_ct_truncated).
__device__ void load_cut(const CtArgs& a, int b0, int nb, float scale, float* sred) {
  const int tid = threadIdx.x;
  float total = 0.0f;
  for (int lw = 0; lw < nb; ++lw) {
    const long long base = (long long)src_window(a, b0 + lw) * a.n_samples;
    total += a.audio_int16
                 ? window_sum(reinterpret_cast<const short4*>(
                                  static_cast<const int16_t*>(a.audio) + base),
                              a.n_samples / 4)
                 : window_sum(reinterpret_cast<const float4*>(
                                  static_cast<const float*>(a.audio) + base),
                              a.n_samples / 4);
  }
  total *= scale;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
  if ((tid & 31) == 0) sred[tid >> 5] = total;
  __syncthreads();
  float all = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) all += sred[w];
  float* out = static_cast<float*>(a.out);
  for (int idx = tid; idx < nb * kLanes; idx += kThreads) {
    const int lw = idx / kLanes;
    const int l = idx - lw * kLanes;
    const long long base = (long long)src_window(a, b0 + lw) * a.n_samples;
    out[(size_t)(b0 + lw) * kLanes + l] = load_x(a, base + l, scale) +
                                          load_x(a, base + a.n_samples - kLanes + l, scale) +
                                          0.0f * all;
  }
}

// acc (BM / 16 rows x NB 128-column blocks) = T (k_rows) @ mat (k_rows x
// NB * 128, row pitch LD), mat streamed through the ring `se`
template <int BM, int NB, int LD>
__device__ __forceinline__ void stage2_product(const float* __restrict__ mat,
                                               int k_rows, const float* ts,
                                               float* se,
                                               float (&acc)[BM / 16][8 * NB]) {
  constexpr int RM = BM / 16;
  constexpr int TP = BM + 4;
  constexpr int NC4 = NB * kLanes / 4;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j) acc[i][j] = 0.0f;
  auto load = [&](int ks, int st) {
    float* dst = se + st * kBK * LD;
    for (int idx = tid; idx < kBK * NC4; idx += kThreads) {
      const int kr = idx / NC4;
      const int c4 = idx - kr * NC4;
      cp_async16(smem_addr(dst + kr * LD + 4 * c4),
                 mat + (size_t)(ks * kBK + kr) * LD + 4 * c4);
    }
  };
  __syncthreads();  // every thread is done with the ring and with T's stores
  const int n_ks = k_rows / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_ks) load(st, st);
    cp_async_commit();
  }
  for (int ks = 0; ks < n_ks; ++ks) {
    cp_async_wait<kStages - 2>();
    // slice ks is in place, and every thread is done with slice ks - 1,
    // whose stage slice ks + kStages - 1 reuses
    __syncthreads();
    if (ks + kStages - 1 < n_ks) load(ks + kStages - 1, (ks + kStages - 1) % kStages);
    cp_async_commit();
    const float* tb = se + (ks % kStages) * kBK * LD;
    const float* ta = ts + ks * kBK * TP + RM * ty;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float ar[RM];
      if constexpr (RM == 4) {
        const float4 v = *reinterpret_cast<const float4*>(ta + k * TP);
        ar[0] = v.x; ar[1] = v.y; ar[2] = v.z; ar[3] = v.w;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(ta + k * TP);
        ar[0] = v.x; ar[1] = v.y;
      }
      float br[8 * NB];
#pragma unroll
      for (int h = 0; h < 2 * NB; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(tb + k * LD + h * kJ + 4 * tx);
        br[4 * h] = v.x;
        br[4 * h + 1] = v.y;
        br[4 * h + 2] = v.z;
        br[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8 * NB; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

template <int BM, bool PAIRED, bool PPMEL, int STOP = kShipped>
__global__ void __launch_bounds__(kThreads, 1) ct_frontend_kernel(const CtArgs a) {
  constexpr int RM = BM / 16;
  constexpr int TP = BM + 4;
  constexpr int NB = PAIRED ? 2 : 1;
  constexpr int LD = NB * kLanes;  // row pitch of the stage-2 packs
  extern __shared__ float4 smem_raw[];
  long long* srow = reinterpret_cast<long long*>(smem_raw);  // (BM,)
  float* ts = reinterpret_cast<float*>(srow + BM);            // (2 x 128, TP)
  float* se = ts + 2 * kLanes * TP;                           // kStages x (kBK, LD)
  float* sq = se + kStages * kBK * LD;                        // (BM, pq)
  const int pq = sq_pitch(PPMEL, PAIRED, a.n_fft);
  const int mp = mel_pitch(a.n_filt);
  float* smel = sq + BM * pq;                                 // (BM, mp)
  float* snyq = smel + BM * mp;                               // (BM,)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int R = a.rows_per_win;
  const int b0 = blockIdx.x * a.wpb;
  const int nb = min(a.wpb, a.batch - b0);
  const int o0 = blockIdx.y * (R - a.halo) - a.halo;  // kept frame of row 0
  const int nf1 = a.n_filt + 1;
  const int n2 = a.n2;
  const int half = n2 / 2;
  if constexpr (STOP == kLoad) {
    load_cut(a, b0, nb, __ldg(a.gain) * (a.audio_int16 ? 1.0f / 32768.0f : 1.0f),
             reinterpret_cast<float*>(smem_raw));
    return;
  }

  // each row's first sample, or -1 for a row that is no kept frame
  for (int r = tid; r < BM; r += kThreads) {
    const int lw = r / R;
    const int o = o0 + r - lw * R;
    int win = b0 + lw;
    if constexpr (STOP != kShipped) win = src_window(a, win);
    srow[r] = lw < nb && o >= 0 && o < a.n_features
                  ? (long long)win * a.n_samples +
                        (long long)(a.first_frame + o) * a.hop
                  : -1;
  }
  for (int i = tid; i < BM * mp; i += kThreads) smel[i] = 0.0f;
  const float scale = __ldg(a.gain) * (a.audio_int16 ? 1.0f / 32768.0f : 1.0f);
  __syncthreads();

  // the filterbank over one residue's 64 bins, for every (row, filter):
  // folded (power row, weights of bin j) or unfolded (squares j and j + 64,
  // the duplicated rows); the energy column is summed in `emit`.  The
  // residue's 64 filterbank rows are first copied into the idle K-slice
  // ring where they fit (n_filt < 48), else read from L2.
  const bool stage_weights = kJ * nf1 <= kStages * kBK * LD;
  auto filter_sums = [&](const float* base, int s, bool unfolded) {
    const float* w0 = a.filt + (size_t)s * kJ * nf1;
    if (stage_weights) {
      __syncthreads();  // every thread is done with the ring
      for (int i = tid; i < kJ * nf1; i += kThreads) se[i] = __ldg(&w0[i]);
      __syncthreads();
      w0 = se;
    }
    for (int idx = tid; idx < BM * a.n_filt; idx += kThreads) {
      const int r = idx % BM;
      const int m = idx / BM;
      if (srow[r] < 0) continue;
      const int2 jr = __ldg(reinterpret_cast<const int2*>(a.jrange) + m * n2 + s);
      const float* row = base + r * pq;
      const float* w = w0 + m;
      float acc = 0.0f;
#pragma unroll 4
      for (int j = jr.x; j < jr.y; ++j) {
        const float wj = w[j * nf1];
        acc = fmaf(row[j], wj, acc);
        if (unfolded) acc = fmaf(row[kJ + j], wj, acc);
      }
      smel[r * mp + m] += acc;
    }
  };

  float acc[RM][8 * NB];
  for (int sr = 0; sr <= half; ++sr) {
    const bool single = sr == 0 || sr == half;
    // ---- stage 1: T_re[sr] (k < 128) and T_im[sr] (k >= 128), k-major
    {
      const int b = tid & (kLanes - 1);
      constexpr int kStep = kThreads / kLanes;  // rows a pass of the block
      if (n2 == 8) {
        // 4 rows a thread at once: 32 loads in flight before the butterflies
        constexpr int kRows = 4;
        for (int r0 = tid >> 7; r0 < BM; r0 += kStep * kRows) {
          float x[kRows][8];
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const long long off = srow[r0 + kStep * q];
            const long long p = (off >= 0 ? off : 0) + b;  // row 0: any valid address
#pragma unroll
            for (int i = 0; i < 8; ++i) x[q][i] = load_x(a, p + i * kLanes, scale);
          }
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const int r = r0 + kStep * q;
            if constexpr (STOP == kFraming) {  // the frame's 8 planes at lane b
              float y = x[q][0];
#pragma unroll
              for (int i = 1; i < 8; ++i) y += x[q][i];
              sq[r * pq + b] = y;
              continue;
            }
            float tre, tim;
            dft8(x[q], sr, tre, tim);
            const bool ok = srow[r] >= 0;
            ts[b * TP + r] = ok ? tre : 0.0f;
            ts[(kLanes + b) * TP + r] = ok ? tim : 0.0f;
            if constexpr (STOP == kButterfly)  // T_re + T_im over the residues
              sq[r * pq + b] = (sr == 0 ? 0.0f : sq[r * pq + b]) + tre + tim;
          }
        }
      } else {
        for (int r = tid >> 7; r < BM; r += kStep) {
          const long long off = srow[r];
          float tre = 0.0f, tim = 0.0f;
          if (off >= 0) stage1_tables(a, off + b, sr, scale, tre, tim);
          ts[b * TP + r] = tre;
          ts[(kLanes + b) * TP + r] = tim;
        }
      }
    }
    if constexpr (STOP == kFraming) break;     // one pass: the frames' planes
    if constexpr (STOP == kButterfly) continue;  // stage 1 alone, every residue
    if (sr == 0) {
      __syncthreads();
      // the Nyquist bin's power, from T[0] (the power cut keeps its signed
      // amplitude)
      for (int r = tid; r < BM; r += kThreads) {
        float x = 0.0f;
        for (int b = 0; b < kLanes; ++b)
          x += ts[b * TP + r] * ((b & 1) ? -a.nyq_scale : a.nyq_scale);
        if constexpr (STOP == kPower)
          snyq[r] = x;
        else
          snyq[r] = x * x;
      }
    }
    const int k_rows = single ? kLanes : 2 * kLanes;

    // ---- stage 2 and the power of residue s, from block `blk` of `c`; the
    // energy column, the sum of the row's power, reduced over the 16 tx
    // lanes of the row's half-warp and added by its tx == 0 thread
    auto emit = [&](const auto& c, int s, int blk) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = RM * ty + i;
        float e = 0.0f;
        if constexpr (PPMEL) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float v = c[i][8 * blk + 4 * h + q];
              sq[r * pq + blk * kLanes + h * kJ + 4 * tx + q] = v * v;
              e += v * v;
            }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float re = c[i][8 * blk + q];
            const float im = c[i][8 * blk + 4 + q];
            const float pw = re * re + im * im;
            sq[r * pq + s * kJ + 4 * tx + q] = pw;
            e += pw;
          }
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
        if (tx == 0) smel[r * mp + a.n_filt] += e;
      }
    };
    if constexpr (PAIRED) {
      const float* mat = a.e2 + (size_t)sr * (2 * kLanes) * LD;
      if (single) {  // residue 0 or n2 / 2: the first 128 columns
        float c1[RM][8];
        stage2_product<BM, 1, LD>(mat, k_rows, ts, se, c1);
        emit(c1, sr, 0);
        if constexpr (PPMEL) {
          __syncthreads();  // the squares are in place
          filter_sums(sq, sr, true);
        }
      } else {
        stage2_product<BM, 2, LD>(mat, k_rows, ts, se, acc);
        emit(acc, sr, 0);
        emit(acc, n2 - sr, 1);
        if constexpr (PPMEL) {
          __syncthreads();
          filter_sums(sq, sr, true);
          filter_sums(sq + kLanes, n2 - sr, true);
        }
      }
    } else {
      for (int g = 0; g < (single ? 1 : 2); ++g) {
        const int s = g == 0 ? sr : n2 - sr;
        stage2_product<BM, 1, LD>(a.e2 + (size_t)s * (2 * kLanes) * LD, k_rows,
                                  ts, se, acc);
        emit(acc, s, 0);
        if constexpr (PPMEL) {
          __syncthreads();
          filter_sums(sq, s, true);
        }
      }
    }
    __syncthreads();  // the next residue's stage 1 overwrites T and the squares
  }

  // ---- the filterbank over the folded power rows (no PER_PIECE_MEL)
  if constexpr (STOP >= kMel) {
    if (!PPMEL) {
      for (int s = 0; s < n2; ++s) filter_sums(sq + s * kJ, s, false);
      __syncthreads();
    }
  }
  // ---- Nyquist, log
  if constexpr (STOP >= kLog) {
    for (int idx = tid; idx < BM * nf1; idx += kThreads) {
      const int r = idx % BM;
      const int m = idx / BM;
      if (srow[r] < 0) continue;
      smel[r * mp + m] = safe_log(smel[r * mp + m] + snyq[r] * __ldg(&a.filt_nyq[m]));
    }
    __syncthreads();
  }
  // ---- DCT and the energy swap, into ts on (row, coefficient), or into
  // the coefficients' own region after snyq
  float* sc = coef_floats(BM, a.n_fft, a.n_mfcc, PAIRED, PPMEL) ? snyq + BM : ts;
  if constexpr (STOP >= kFull) {
    for (int idx = tid; idx < BM * a.n_mfcc; idx += kThreads) {
      const int r = idx / a.n_mfcc;
      const int i = idx - r * a.n_mfcc;
      if (srow[r] < 0) continue;
      const float* mel = smel + r * mp;
      float v;
      if (i == 0) {
        v = mel[a.n_filt];
      } else {
        v = 0.0f;
        for (int m = 0; m < a.n_filt; ++m)
          v = fmaf(mel[m], __ldg(&a.dct_t[m * a.n_filt + i]), v);
      }
      sc[idx] = v;
    }
    __syncthreads();
  }
  if constexpr (STOP != kShipped) {
    // ---- a cut's fold: the per-frame row y(r, l) of its last stage, summed
    // over each window's frames (one tile of rows_per_win rows a window)
    __syncthreads();  // the framing and butterfly cuts leave the loop without one
    float* out = static_cast<float*>(a.out);
    for (int idx = tid; idx < nb * kLanes; idx += kThreads) {
      const int lw = idx / kLanes;
      const int l = idx - lw * kLanes;
      float sum = 0.0f;
      for (int i = 0; i < R; ++i) {
        const int r = lw * R + i;
        const float* row = sq + r * pq;
        float y;
        if constexpr (STOP <= kButterfly) {
          y = row[l];
        } else if constexpr (STOP == kPower) {  // the permuted power row's 128-lane chunks
          y = snyq[r];
          for (int c = 0; c < a.n_fft / 2; c += kLanes) y += row[c + l];
        } else if constexpr (STOP == kMel) {
          y = l < nf1 ? smel[r * mp + l] + snyq[r] * __ldg(&a.filt_nyq[l]) : 0.0f;
        } else if constexpr (STOP == kLog) {  // log of the zero-padded lanes too
          y = l < nf1 ? smel[r * mp + l] : safe_log(0.0f);
        } else {
          y = l < a.n_mfcc ? sc[r * a.n_mfcc + l] : 0.0f;
        }
        sum += y;
      }
      out[(size_t)(b0 + lw) * kLanes + l] = sum;
    }
    return;
  }
  // ---- deltas and the store: rows past the halo that are kept frames
  const int n_out = a.emit_deltas ? 2 * a.n_mfcc : a.n_mfcc;
  for (int idx = tid; idx < BM * n_out; idx += kThreads) {
    const int r = idx / n_out;
    const int c = idx - r * n_out;
    const int lw = r / R;
    const int i = r - lw * R;
    if (srow[r] < 0 || i < a.halo) continue;
    const int o = o0 + i;
    float v;
    if (c < a.n_mfcc) {
      v = sc[r * a.n_mfcc + c];
    } else {
      const int cc = c - a.n_mfcc;
      v = o == 0 ? 0.0f : sc[r * a.n_mfcc + cc] - sc[(r - 1) * a.n_mfcc + cc];
    }
    const size_t dst = a.time_major
                           ? ((size_t)o * a.batch + b0 + lw) * n_out + c
                           : ((size_t)(b0 + lw) * a.n_features + o) * n_out + c;
    if (a.out_bf16)
      static_cast<__nv_bfloat16*>(a.out)[dst] = __float2bfloat16(v);
    else
      static_cast<float*>(a.out)[dst] = v;
  }
}

template <int BM, bool PAIRED, bool PPMEL, int STOP = kShipped>
cudaError_t launch(const CtArgs& a, size_t smem, cudaStream_t stream) {
  auto kernel = ct_frontend_kernel<BM, PAIRED, PPMEL, STOP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.batch + a.wpb - 1) / a.wpb, a.n_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bm(const CtArgs& a, bool paired, bool ppmel, size_t smem,
                      cudaStream_t s) {
  if (paired)
    return ppmel ? launch<BM, true, true>(a, smem, s) : launch<BM, true, false>(a, smem, s);
  return ppmel ? launch<BM, false, true>(a, smem, s) : launch<BM, false, false>(a, smem, s);
}

}  // namespace

// audio (batch, n_samples) f32 or int16; gain (1,) f32 on the device.  Kept
// frame o < n_features starts at sample (first_frame + o) hop and is n_fft
// samples long (window == n_fft).  A block takes bm frame rows, the largest
// of 64 and 32 whose shared memory fits the card's opt-in limit, cut as
// set_tiling says.  stage1, e2, filt, filt_nyq, jrange and dct_t as
// ops/ct_constants.py builds them (e2 the paired or unpaired pack).  out
// (batch, n_features, F) or, with time_major, (n_features, batch, F), F =
// n_mfcc or 2 n_mfcc with emit_deltas; f32 or bf16.  Returns the launch's
// cudaError_t: cudaErrorInvalidValue for an argument out of range or a
// config whose block fits in no shared memory the card offers.
extern "C" int tsc_ct_frontend(
    const void* audio, int audio_int16, const void* gain, int batch,
    int n_samples, int hop, int n_fft, int first_frame, int n_features,
    int paired, int per_piece_mel, const void* stage1, const void* e2,
    const void* filt, const void* filt_nyq, const void* jrange,
    const void* dct_t, int n_filt, int n_mfcc, int emit_deltas, int time_major,
    void* out, int out_bf16, void* stream) {
  const int n2 = n_fft / kLanes;
  if (batch <= 0 || n_samples <= 0 || hop <= 0 || n_fft % kLanes != 0 ||
      n2 < 2 || n2 % 2 != 0 || first_frame < 0 || n_features <= 0 ||
      (long long)(first_frame + n_features - 1) * hop + n_fft > n_samples ||
      n_filt <= 0 || n_mfcc <= 0 || n_mfcc > n_filt)
    return cudaErrorInvalidValue;
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBms[] = {64, 32};
  int bm = 0;
  size_t smem = 0;
  for (const int cand : kBms) {
    smem = sizeof(float) *
           smem_floats(cand, n_fft, n_filt, n_mfcc, paired, per_piece_mel);
    if (smem <= (size_t)smem_max) {
      bm = cand;
      break;
    }
  }
  if (bm == 0) return cudaErrorInvalidValue;
  CtArgs a;
  a.audio = audio;
  a.audio_int16 = audio_int16;
  a.gain = static_cast<const float*>(gain);
  a.batch = batch;
  a.n_samples = n_samples;
  a.hop = hop;
  a.n_fft = n_fft;
  a.n2 = n2;
  a.first_frame = first_frame;
  a.n_features = n_features;
  a.emit_deltas = emit_deltas;
  set_tiling(a, bm);
  a.stage1 = static_cast<const float*>(stage1);
  a.e2 = static_cast<const float*>(e2);
  a.filt = static_cast<const float*>(filt);
  a.filt_nyq = static_cast<const float*>(filt_nyq);
  a.jrange = static_cast<const int*>(jrange);
  a.dct_t = static_cast<const float*>(dct_t);
  a.nyq_scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(n_fft)));
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.time_major = time_major;
  a.out_bf16 = out_bf16;
  a.out = out;
  a.src_mod = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bm == 64 ? launch_bm<64>(a, paired, per_piece_mel, smem, s)
                 : launch_bm<32>(a, paired, per_piece_mel, smem, s);
  return static_cast<int>(err);
}

// The (F, F) kernel cut after stage `stop` (0 load, 1 framing, 2 butterfly,
// 3 power, 4 mel, 5 log, 6 full; ops/omission_kernel.py::STAGES), at the one
// config tools/dev/r3_omission.py takes: n_fft = 1024 (n2 = 8), hop =
// n_fft / 2, frames 0 .. n_frames - 1 of every window, n_samples a multiple
// of 4, 64 block rows.  out
// (batch, 128) f32: each window's per-frame rows of the stage summed over its
// frames; window b reads audio row b % src_mod when src_mod > 0 (the
// constant-block profile), else row b.  Constants as for tsc_ct_frontend
// (e2 the unpaired pack).  Returns cudaErrorInvalidValue for any other
// config, or where the block's shared memory does not fit.
extern "C" int tsc_ct_truncated(
    const void* audio, int audio_int16, const void* gain, int batch,
    int n_samples, int hop, int n_fft, int n_frames, int stop, int src_mod,
    const void* stage1, const void* e2, const void* filt, const void* filt_nyq,
    const void* jrange, const void* dct_t, int n_filt, int n_mfcc, void* out,
    void* stream) {
  constexpr int kBm = 64;
  if (batch <= 0 || n_fft != 8 * kLanes || 2 * hop != n_fft || n_frames <= 0 ||
      n_frames > kBm || (long long)(n_frames - 1) * hop + n_fft > n_samples ||
      n_samples % 4 != 0 || n_filt <= 0 || n_filt + 1 > kLanes || n_mfcc <= 0 ||
      n_mfcc > n_filt || stop < kLoad || stop > kFull || src_mod < 0)
    return cudaErrorInvalidValue;
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      sizeof(float) * smem_floats(kBm, n_fft, n_filt, n_mfcc, false, false);
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  CtArgs a;
  a.audio = audio;
  a.audio_int16 = audio_int16;
  a.gain = static_cast<const float*>(gain);
  a.batch = batch;
  a.n_samples = n_samples;
  a.hop = hop;
  a.n_fft = n_fft;
  a.n2 = n_fft / kLanes;
  a.first_frame = 0;
  a.n_features = n_frames;
  a.emit_deltas = 0;
  set_tiling(a, kBm);
  a.stage1 = static_cast<const float*>(stage1);
  a.e2 = static_cast<const float*>(e2);
  a.filt = static_cast<const float*>(filt);
  a.filt_nyq = static_cast<const float*>(filt_nyq);
  a.jrange = static_cast<const int*>(jrange);
  a.dct_t = static_cast<const float*>(dct_t);
  a.nyq_scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(n_fft)));
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.time_major = 0;
  a.out_bf16 = 0;
  a.out = out;
  a.src_mod = src_mod;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stop) {
    case kLoad: err = launch<kBm, false, false, kLoad>(a, smem, s); break;
    case kFraming: err = launch<kBm, false, false, kFraming>(a, smem, s); break;
    case kButterfly: err = launch<kBm, false, false, kButterfly>(a, smem, s); break;
    case kPower: err = launch<kBm, false, false, kPower>(a, smem, s); break;
    case kMel: err = launch<kBm, false, false, kMel>(a, smem, s); break;
    case kLog: err = launch<kBm, false, false, kLog>(a, smem, s); break;
    default: err = launch<kBm, false, false, kFull>(a, smem, s); break;
  }
  return static_cast<int>(err);
}
