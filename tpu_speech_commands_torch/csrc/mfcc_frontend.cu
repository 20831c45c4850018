// MFCC / bark feature frontend, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_speech_commands/ops/pallas_frontend.py::
// _make_ct_frontend (pallas_call at :745), and takes the contract of the
// dense branch of make_fused_frontend (:340) as well: one kernel for every
// config with n_fft a power of two.  A window shorter than n_fft is
// zero-padded, a longer one cut to its first n_fft samples, as
// np.fft.rfft(frame, n=n_fft) does; the frame count comes from the window.
//
//   audio (B, S) f32 | int16, gain (1,) f32  ->  features (B, T, F) f32 | bf16
//   x = int16 ? pcm * (gain / 32768) : audio * gain
//   per kept frame t:  X = FFT_n_fft(x[t*hop : t*hop + min(window, n_fft)],
//                                zero-padded)
//                      power[k] = |X[k]|^2 / n_fft,   k = 0 .. n_fft/2
//                      mel[m]   = safe_log(sum_k power[k] * filt_t[m, k])
//                      c[0]     = safe_log(sum_k power[k])      (energy)
//                      c[i]     = sum_m mel[m] * dct_t[m, i],   0 < i < n_mfcc
//   optional deltas c[t] - c[t-1] (zero for the first kept frame)
//
// What bounds it on this card.  At the serving shape (1 s of 16 kHz audio,
// n_fft 1024, hop 512, 30 frames) a window is 64 KB of f32 audio read once
// and 2.4 KB of features written; the work a frame needs is a real-input
// FFT (2.5 n_fft log2 n_fft = 25.6 kFLOP), 2 x 927 FLOP of packed
// filterbank and a 20 x 20 DCT: about 14 FLOP per f32 byte read, under the
// H100's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte).  So the
// function is bound by the audio read (0.16 ms for 8192 f32 windows).  A
// kernel meets that only if its SM work hides behind the read.  This one
// does not: it is bound on the SM, by its instruction slots and shared-memory
// wavefronts a frame (about 0.68 ms for 8192 windows on an H100; the stage
// cuts put a quarter of it in the audio read, a third in the FFT, a quarter
// in the filterbank, PERF.md).  What the design does about it: the FFT
// keeps a frame in registers and moves it through shared memory twice, at
// the least wavefronts an access; it transforms n_fft / 2 complex points,
// not n_fft; the filterbank touches only the nonzero weights.
//
// Three bodies, chosen from the config (ops/frontend_kernel.py::fft_body);
// the third, the wide body at n_fft 8192 and 16384 (the register body with
// a frame over four warps), is its own build unit, csrc/mfcc_wide_frontend.cu.
//
// The register body, n_fft 128 .. 4096 (N = n_fft / 2): csrc/register_fft.cuh's
// register_fft_kernel on the plans of ops/fft_plan.py::fft_plan (`Plan`
// below), 8 warps a block, passes of radix 16, 16 and N / 256.  Shared memory at
// n_fft 1024 is 49,568 bytes (ops/fft_plan.py::fft_layout mirrors
// smem_layout; the DCT region holds the 19 columns the output uses): with
// the launch bounds' 64 registers, 4 blocks, 32 warps an SM.  A config whose
// DCT columns leave the block too little room runs the body in log-mel mode
// and csrc/cepstrum_wgmma.cu after it (register_fft.cuh).  The dynamic
// shared-memory attribute is set once an instantiation and device.
//
// The radix-2 body, n_fft below 128 and every config whose register- or
// wide-body shared memory exceeds a block's even in log-mel mode (and,
// through the entry's `radix2` argument, any of them: the A/B of the
// bodies; it reads the whole n_filt x n_filt DCT): one warp a frame,
// the frame loaded bit-reversed into a per-warp shared buffer of n_fft
// float2, an in-place radix-2 DIT FFT with __syncwarp between stages, the
// dense filterbank.  It is the design the register body replaced.
//
// A compile-time STOP cuts the register body after one stage for the
// stage-omission profile (ops/omission_kernel.py, the counterpart of
// tools/dev/r3_omission.py; n_fft 1024 only): load (every sample of the
// window read), framing (the frame loads), power (the FFT, the untangle and
// the power row), mel (the filterbank, before its log), log, full (the
// DCT).  A cut then sums its per-frame row over the window's frames into a
// (B, 128) f32 output instead of the deltas and the store, in the CT split
// kernel's lane order (csrc/ct_frontend.cu), so that both kernels' cuts
// compute one function.  The shipped kernel takes the default, kShipped,
// and every cut is an `if constexpr`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "register_fft.cuh"

namespace {

// The register body's plan of N complex points (ops/fft_plan.py::fft_plan):
// V = max(16, N / 32) values a lane; passes of radix 16, 16 and N / 256 (16
// and N / 16 for N <= 256); launch bounds of 4, 2 or 1 blocks an SM at V =
// 16, 32, 64.
template <int N, int V = (N / 32 > 16 ? N / 32 : 16),
          int B = (V == 16 ? 4 : (V == 32 ? 2 : 1))>
using Plan = std::conditional_t<(N > 256), RegisterPlan<N, V, B, 16, 16, N / 256>,
                                RegisterPlan<N, V, B, 16, N / 16>>;

// 8 warps unless the frame buffers do not fit the card's opt-in shared
// memory; then 4, 2, 1.
template <typename InT, typename OutT, int N, int STOP = kShipped>
cudaError_t launch_fft(const FftArgs& a, cudaStream_t stream) {
  static int limit[kMaxDevices] = {};
  auto kernel = register_fft_kernel<InT, OutT, Plan<N>, STOP>;
  int n_warps = kMaxThreads / 32;
  SmemLayout lay;
  cudaError_t err;
  for (;; n_warps >>= 1) {
    lay = args_layout<Plan<N>>(a, n_warps);
    err = opt_in(kernel, limit, lay.total);
    if (err != cudaErrorInvalidValue || n_warps == 1) break;
  }
  if (err != cudaSuccess) return err;
  kernel<<<a.batch, n_warps * 32, lay.total, stream>>>(a);
  return cudaGetLastError();
}

template <typename InT, typename OutT>
cudaError_t launch_fft_n(int n_fft, const FftArgs& a, cudaStream_t s) {
  switch (n_fft) {
    case 128: return launch_fft<InT, OutT, 64>(a, s);
    case 256: return launch_fft<InT, OutT, 128>(a, s);
    case 512: return launch_fft<InT, OutT, 256>(a, s);
    case 1024: return launch_fft<InT, OutT, 512>(a, s);
    case 2048: return launch_fft<InT, OutT, 1024>(a, s);
    case 4096: return launch_fft<InT, OutT, 2048>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename InT>
cudaError_t launch_cut(int stop, const FftArgs& a, cudaStream_t s) {
  switch (stop) {
    case kLoad: return launch_fft<InT, float, 512, kLoad>(a, s);
    case kFraming: return launch_fft<InT, float, 512, kFraming>(a, s);
    case kPower: return launch_fft<InT, float, 512, kPower>(a, s);
    case kMel: return launch_fft<InT, float, 512, kMel>(a, s);
    case kLog: return launch_fft<InT, float, 512, kLog>(a, s);
    default: return launch_fft<InT, float, 512, kFull>(a, s);
  }
}

// ---------------------------------------------------------------------------
// The radix-2 body

// Shared memory: n_warps FFT buffers of n_fft float2, then n_warps x n_filt
// log-mel scratch, then the block's (n_features, n_mfcc) coefficients.
size_t radix2_smem_bytes(int n_warps, int n_fft, int n_filt, int n_features,
                         int n_mfcc) {
  return sizeof(float2) * (size_t)n_warps * n_fft +
         sizeof(float) * ((size_t)n_warps * n_filt + (size_t)n_features * n_mfcc);
}

template <typename InT, typename OutT>
__global__ void radix2_frontend_kernel(
    const InT* __restrict__ audio, const float* __restrict__ gain,
    float in_scale, int n_samples, int window, int hop, int n_fft,
    int log2_fft, int first_frame, int n_features,
    const float2* __restrict__ twiddle, const float* __restrict__ filt_t,
    const float* __restrict__ dct_t, int n_filt, int n_mfcc, int emit_deltas,
    OutT* __restrict__ out) {
  extern __shared__ float4 smem_raw[];
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float2* buf = reinterpret_cast<float2*>(smem_raw) + (size_t)warp * n_fft;
  float* mels_all = reinterpret_cast<float*>(
      reinterpret_cast<float2*>(smem_raw) + (size_t)n_warps * n_fft);
  float* mels = mels_all + warp * n_filt;
  float* feats = mels_all + n_warps * n_filt;

  const int half = n_fft >> 1;
  const int n_bins = half + 1;
  const float inv_fft = 1.0f / static_cast<float>(n_fft);
  const float scale = __ldg(gain) * in_scale;
  const InT* row = audio + (size_t)blockIdx.x * n_samples;

  for (int f = warp; f < n_features; f += n_warps) {
    const InT* frame = row + (size_t)(first_frame + f) * hop;
    // bit-reversed load; samples past the window are the FFT's zero padding
    for (int n = lane; n < n_fft; n += 32) {
      const float x = n < window ? load_sample(frame + n) * scale : 0.0f;
      buf[__brev(n) >> (32 - log2_fft)] = make_float2(x, 0.0f);
    }
    __syncwarp();
    for (int span = 1; span < n_fft; span <<= 1) {
      const int tw_step = half / span;
      for (int j = lane; j < half; j += 32) {
        const int pos = j & (span - 1);
        const int i0 = ((j - pos) << 1) + pos;
        const int i1 = i0 + span;
        const float2 w = __ldg(&twiddle[pos * tw_step]);
        const float2 a = buf[i0];
        const float2 c = buf[i1];
        const float tr = w.x * c.x - w.y * c.y;
        const float ti = w.x * c.y + w.y * c.x;
        buf[i0] = make_float2(a.x + tr, a.y + ti);
        buf[i1] = make_float2(a.x - tr, a.y - ti);
      }
      __syncwarp();
    }
    // power spectrum in place (the .x of bins 0 .. n_fft/2), and its sum
    float energy = 0.0f;
    for (int k = lane; k < n_bins; k += 32) {
      const float2 c = buf[k];
      const float p = (c.x * c.x + c.y * c.y) * inv_fft;
      buf[k].x = p;
      energy += p;
    }
    energy = warp_sum(energy);
    __syncwarp();
    for (int m = 0; m < n_filt; ++m) {
      const float* fr = filt_t + (size_t)m * n_bins;
      float acc = 0.0f;
      for (int k = lane; k < n_bins; k += 32) acc += buf[k].x * __ldg(&fr[k]);
      acc = warp_sum(acc);
      if (lane == 0) mels[m] = safe_log(acc);
    }
    __syncwarp();
    for (int c = lane; c < n_mfcc; c += 32) {
      float v;
      if (c == 0) {
        v = safe_log(energy);
      } else {
        v = 0.0f;
        for (int m = 0; m < n_filt; ++m) v += mels[m] * __ldg(&dct_t[m * n_filt + c]);
      }
      feats[f * n_mfcc + c] = v;
    }
    __syncwarp();  // the next frame reuses buf and mels
  }
  __syncthreads();
  store_window(feats, n_features, n_mfcc, emit_deltas, 0, 0, out);
}

template <typename InT, typename OutT>
cudaError_t launch_radix2(const void* audio, float in_scale, const float* gain,
                          int batch, int n_samples, int window, int hop,
                          int n_fft, int first_frame, int n_features,
                          const float2* twiddle, const float* filt_t,
                          const float* dct_t, int n_filt, int n_mfcc,
                          int emit_deltas, void* out, cudaStream_t stream) {
  static int limit[kMaxDevices] = {};
  auto kernel = radix2_frontend_kernel<InT, OutT>;
  const int log2_fft = __builtin_ctz(static_cast<unsigned>(n_fft));
  // 8 warps (8 frames in flight) unless the FFT buffers do not fit
  int n_warps = 8;
  size_t smem;
  cudaError_t err;
  for (;; n_warps >>= 1) {
    smem = radix2_smem_bytes(n_warps, n_fft, n_filt, n_features, n_mfcc);
    err = opt_in(kernel, limit, smem);
    if (err != cudaErrorInvalidValue || n_warps == 1) break;
  }
  if (err != cudaSuccess) return err;
  kernel<<<batch, n_warps * 32, smem, stream>>>(
      static_cast<const InT*>(audio), gain, in_scale, n_samples, window, hop,
      n_fft, log2_fft, first_frame, n_features, twiddle, filt_t, dct_t, n_filt,
      n_mfcc, emit_deltas, static_cast<OutT*>(out));
  return cudaGetLastError();
}

bool takes_register_fft(int n_fft) {
  return n_fft >= 128 && n_fft <= 4096 && (n_fft & (n_fft - 1)) == 0;
}

}  // namespace

// audio (batch, n_samples) f32 or int16; gain (1,) f32 on the device;
// dct_t (n_filt, dct_cols) f32, the DCT's columns 1 .. n_mfcc - 1 (dct_cols
// = n_mfcc - 1) or the whole table (dct_cols = n_filt; the radix-2 body
// takes only that); out (batch, n_features, n_mfcc or 2 n_mfcc) f32 or
// bf16, or with logmel (the register body only; 1 its tail, 2 its first
// tail, register_fft.cuh's Logmel, on the log-mel or the fused filterbank
// plan) (batch, n_features, n_filt + 1) f32 log-mel rows, 16-byte aligned,
// for csrc/cepstrum_wgmma.cu.  Frames first_frame ..
// first_frame + n_features - 1 are computed.  The register body (radix2 = 0,
// n_fft 128 .. 4096) reads plan_twiddle (ops/fft_plan.py::fft_plan(n_fft).
// twiddle, f32 rows), filt_packed (n_packed,) f32 and fb_table (int32,
// filterbank_plan's table with n_seg segments); the radix-2 body (radix2 =
// 1, any power of two) reads twiddle (n_fft/2,) complex64 exp(-2 pi i k /
// n_fft) and filt_t (n_filt, n_fft/2 + 1) f32.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a config the chosen body cannot
// take).
extern "C" int tsc_mfcc_frontend(const void* audio, int audio_int16,
                                 const void* gain, int batch, int n_samples,
                                 int window, int hop, int n_fft,
                                 int first_frame, int n_features,
                                 const void* twiddle, const void* filt_t,
                                 const void* dct_t, int dct_cols, int n_filt,
                                 int n_mfcc, int emit_deltas, void* out, int out_bf16,
                                 const void* plan_twiddle, const void* filt_packed,
                                 const void* fb_table, int n_packed, int n_seg,
                                 int radix2, int logmel, void* stream) {
  if (batch <= 0 || n_fft < 2 || (n_fft & (n_fft - 1)) != 0 || n_mfcc > n_filt ||
      (radix2 && (logmel || dct_cols != n_filt)) || logmel < kFused ||
      logmel > kLogmelPartial ||
      (logmel ? out_bf16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0
              : (dct_cols && !dct_t) || (dct_cols != n_mfcc - 1 && dct_cols != n_filt)))
    return cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gain);
  const float* dc = static_cast<const float*>(dct_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float in_scale = audio_int16 ? 1.0f / 32768.0f : 1.0f;
  cudaError_t err;
  if (radix2) {
    const float2* tw = static_cast<const float2*>(twiddle);
    const float* fb = static_cast<const float*>(filt_t);
#define TSC_LAUNCH(IN, OUT)                                                          \
  launch_radix2<IN, OUT>(audio, in_scale, g, batch, n_samples, window, hop, n_fft, \
                         first_frame, n_features, tw, fb, dc, n_filt, n_mfcc,     \
                         emit_deltas, out, s)
    if (audio_int16)
      err = out_bf16 ? TSC_LAUNCH(int16_t, __nv_bfloat16) : TSC_LAUNCH(int16_t, float);
    else
      err = out_bf16 ? TSC_LAUNCH(float, __nv_bfloat16) : TSC_LAUNCH(float, float);
#undef TSC_LAUNCH
    return static_cast<int>(err);
  }
  if (!takes_register_fft(n_fft) || !plan_twiddle || !fb_table || n_packed < 0 ||
      n_seg < 0)
    return cudaErrorInvalidValue;
  const size_t pair = audio_int16 ? 2 * sizeof(int16_t) : 2 * sizeof(float);
  FftArgs a;
  a.audio = audio;
  a.gain = g;
  a.in_scale = in_scale;
  a.batch = batch;
  a.n_samples = n_samples;
  a.window = window;
  a.hop = hop;
  a.first_frame = first_frame;
  a.n_features = n_features;
  a.vec_rows = reinterpret_cast<uintptr_t>(audio) % pair == 0 && n_samples % 2 == 0;
  a.twiddle = static_cast<const float2*>(plan_twiddle);
  a.packed = static_cast<const float*>(filt_packed);
  a.table = static_cast<const int*>(fb_table);
  a.dct_t = dc;
  a.n_packed = n_packed;
  a.n_seg = n_seg;
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.dct_cols = logmel ? 0 : dct_cols;
  a.emit_deltas = emit_deltas;
  a.time_major = 0;
  a.logmel = logmel;
  a.out = out;
  a.src_mod = 0;
  if (audio_int16)
    err = out_bf16 ? launch_fft_n<int16_t, __nv_bfloat16>(n_fft, a, s)
                   : launch_fft_n<int16_t, float>(n_fft, a, s);
  else
    err = out_bf16 ? launch_fft_n<float, __nv_bfloat16>(n_fft, a, s)
                   : launch_fft_n<float, float>(n_fft, a, s);
  return static_cast<int>(err);
}

// The register body cut after stage `stop` (0 load, 1 framing, 3 power, 4
// mel, 5 log, 6 full; ops/omission_kernel.py::FFT_STAGES), at the config
// tools/dev/r3_omission.py takes: frames of n_fft = 1024 samples (n2 = 8),
// hop n_fft / 2, frames 0 .. n_frames - 1, n_samples a multiple of 4.  out
// (batch, 128) f32: each window's per-frame rows of the stage, in the CT
// split's lane order, summed over its frames; window b reads audio row b %
// src_mod when src_mod > 0 (the constant-block profile).  Constants as for
// tsc_mfcc_frontend's register body, dct_t the whole (n_filt, n_filt)
// table.  Returns cudaErrorInvalidValue for any other config or stage.
extern "C" int tsc_mfcc_truncated(const void* audio, int audio_int16,
                                  const void* gain, int batch, int n_samples,
                                  int hop, int n_fft, int n_frames, int stop,
                                  int src_mod, const void* plan_twiddle,
                                  const void* filt_packed, const void* fb_table,
                                  int n_packed, int n_seg, const void* dct_t,
                                  int n_filt, int n_mfcc, void* out,
                                  void* stream) {
  if (batch <= 0 || n_fft != 8 * kLanes || 2 * hop != n_fft || n_frames <= 0 ||
      (long long)(n_frames - 1) * hop + n_fft > n_samples || n_samples % 4 != 0 ||
      n_filt <= 0 || n_filt + 1 > kLanes || n_mfcc <= 0 || n_mfcc > n_filt ||
      stop < kLoad || stop > kFull || stop == kButterfly || src_mod < 0 ||
      n_packed < 0 || n_seg < 0)
    return cudaErrorInvalidValue;
  FftArgs a;
  a.audio = audio;
  a.gain = static_cast<const float*>(gain);
  a.in_scale = audio_int16 ? 1.0f / 32768.0f : 1.0f;
  a.batch = batch;
  a.n_samples = n_samples;
  a.window = n_fft;
  a.hop = hop;
  a.first_frame = 0;
  a.n_features = n_frames;
  a.vec_rows = 1;  // n_samples % 4 == 0, and the wrapper checks the alignment
  a.twiddle = static_cast<const float2*>(plan_twiddle);
  a.packed = static_cast<const float*>(filt_packed);
  a.table = static_cast<const int*>(fb_table);
  a.dct_t = static_cast<const float*>(dct_t);
  a.n_packed = n_packed;
  a.n_seg = n_seg;
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.dct_cols = n_filt;
  a.emit_deltas = 0;
  a.time_major = 0;
  a.logmel = 0;
  a.out = out;
  a.src_mod = src_mod;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = audio_int16 ? launch_cut<int16_t>(stop, a, s)
                                      : launch_cut<float>(stop, a, s);
  return static_cast<int>(err);
}

extern "C" const char* tsc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
