// MFCC / bark feature frontend for n_fft that are not powers of two, as a
// mixed-radix register-resident FFT, hand-written for Hopper (sm_90a).
//
// Route ct's kernel (ops/ct_kernel.py): the JAX package's CT kernel,
// tpu_speech_commands/ops/pallas_frontend.py::_make_ct_frontend (pallas_call
// at :745), for the configs it takes whose n_fft is not a power of two and
// at most 4096: n_fft = window = 256 m, m in 3 .. 15 not a power of two
// (768, 1280, 1536, 1792, 2304, 2560, 2816, 3072, 3328, 3584, 3840).  The
// contract is the CT split kernel's (csrc/ct_frontend.cu), which stays as
// the A/B baseline and for larger n_fft:
//
//   audio (B, S) f32 | int16, gain (1,) f32  ->  (B, T, F) or (T, B, F)
//   x = int16 ? pcm * (gain / 32768) : audio * gain
//   per kept frame t:  X = DFT_n_fft(x[t*hop : t*hop + n_fft])   (exact f32)
//                      power[k] = |X[k]|^2 / n_fft,   k = 0 .. n_fft/2
//                      mel[m]   = safe_log(sum_k power[k] * filt_t[m, k])
//                      c[0]     = safe_log(sum_k power[k])      (energy)
//                      c[i]     = sum_m mel[m] * dct_t[m, i],   0 < i < n_mfcc
//   optional deltas c[t] - c[t-1] (zero for the first kept frame), f32 | bf16
//
// What bounds it: the bytes, as for the FFT kernel (csrc/mfcc_frontend.cu):
// 0.16 ms for B = 8192 windows of f32 audio at n_fft 768; the real FFT is
// 2.5 n log2 n operations a frame, and at hop 256 from n_fft 1536 up the
// operations bind instead (0.33 ms at 1536).  The CT split's stage 2 is a
// dense 128-point DFT a residue, a floor of 1.68 ms of f32 at n_fft 1024 on
// its own; this kernel does no dense product, so like the register body it
// is bound on the SM by its instruction slots and shared-memory wavefronts
// a frame, not by that floor.
//
// Design: the FFT kernel's register body (csrc/register_fft.cuh's
// register_fft_kernel) on mixed-radix plans: power-of-two radices up to 16
// first, then one pass for each odd prime factor of m (3, 5, 7, 11, 13), so
// that the odd radices' strides come after the power-of-two passes, where
// their swizzled writes are consecutive.  The plans are
// ops/fft_plan.py::mixed_plan (MIXED_PLANS, mirrored by TSC_MIXED_PLANS
// below; tests/test_torch_mixed_fft.py holds the two together and emulates
// the passes in numpy).  One block a window, the plan's warps (2, 4 or 8),
// chosen by the caller (fft_plan.fft_layout); the store writes (B, T, F) or,
// for time_major, (T, B, F).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "register_fft.cuh"

namespace {

// (n_fft / 2, values a lane, the launch bounds' blocks an SM, the passes'
// radices): ops/fft_plan.py's MIXED_PLANS, n_fft -> (values, radices,
// blocks, warps); the warps a block are the launch's argument
#define TSC_MIXED_PLANS(X)          \
  X(384, 48, 2, 16, 8, 3)           \
  X(640, 40, 2, 8, 2, 8, 5)         \
  X(768, 48, 2, 16, 16, 3)          \
  X(896, 56, 1, 8, 2, 8, 7)         \
  X(1152, 36, 2, 2, 4, 4, 4, 3, 3)  \
  X(1280, 40, 2, 4, 8, 8, 5)        \
  X(1408, 44, 1, 2, 4, 4, 4, 11)    \
  X(1536, 48, 1, 4, 16, 8, 3)       \
  X(1664, 52, 1, 2, 4, 4, 4, 13)    \
  X(1792, 56, 1, 4, 8, 8, 7)        \
  X(1920, 60, 1, 2, 4, 4, 4, 3, 5)

template <typename InT, typename OutT, typename P>
cudaError_t launch(const FftArgs& a, int n_warps, cudaStream_t stream) {
  static int limit[kMaxDevices] = {};
  auto kernel = register_fft_kernel<InT, OutT, P>;
  const SmemLayout lay = smem_layout<P>(n_warps, a.n_packed, a.n_seg, a.n_filt,
                                        a.n_mfcc, a.n_features);
  const cudaError_t err = opt_in(kernel, limit, lay.total);
  if (err != cudaSuccess) return err;
  kernel<<<a.batch, n_warps * 32, lay.total, stream>>>(a);
  return cudaGetLastError();
}

template <typename InT, typename OutT>
cudaError_t launch_n(int n_fft, const FftArgs& a, int n_warps, cudaStream_t s) {
  switch (n_fft) {
#define TSC_CASE(N, V, ...) \
  case 2 * N:               \
    return launch<InT, OutT, RegisterPlan<N, V, __VA_ARGS__>>(a, n_warps, s);
    TSC_MIXED_PLANS(TSC_CASE)
#undef TSC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// audio (batch, n_samples) f32 or int16; gain (1,) f32 on the device;
// plan_twiddle (ops/fft_plan.py::mixed_plan(n_fft).twiddle as f32 rows),
// filt_packed (n_packed,) f32 and fb_table (int32, filterbank_plan's table
// over the plan's lanes, n_seg segments); dct_t (n_filt, n_filt) f32; out
// (batch, n_features, F) or, time_major, (n_features, batch, F), F = n_mfcc
// or 2 n_mfcc, f32 or bf16.  Frames first_frame .. first_frame + n_features
// - 1, each n_fft samples (window = n_fft), are computed; n_warps (1, 2, 4
// or 8) a block, ops/fft_plan.py::fft_layout's for the plan.  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for an n_fft without a plan,
// an argument out of range, or shared memory above the card's opt-in
// limit).
extern "C" int tsc_mixed_fft_frontend(
    const void* audio, int audio_int16, const void* gain, int batch,
    int n_samples, int hop, int n_fft, int first_frame, int n_features,
    const void* plan_twiddle, const void* filt_packed, const void* fb_table,
    int n_packed, int n_seg, const void* dct_t, int n_filt, int n_mfcc,
    int emit_deltas, int time_major, int n_warps, void* out, int out_bf16,
    void* stream) {
  if (batch <= 0 || n_samples <= 0 || hop <= 0 || first_frame < 0 ||
      n_features <= 0 ||
      (long long)(first_frame + n_features - 1) * hop + n_fft > n_samples ||
      n_filt <= 0 || n_mfcc <= 0 || n_mfcc > n_filt || n_packed < 0 || n_seg < 0 ||
      (n_warps != 1 && n_warps != 2 && n_warps != 4 && n_warps != 8) ||
      !plan_twiddle || !fb_table || !dct_t)
    return cudaErrorInvalidValue;
  const size_t pair = audio_int16 ? 2 * sizeof(int16_t) : 2 * sizeof(float);
  FftArgs a;
  a.audio = audio;
  a.gain = static_cast<const float*>(gain);
  a.in_scale = audio_int16 ? 1.0f / 32768.0f : 1.0f;
  a.batch = batch;
  a.n_samples = n_samples;
  a.window = n_fft;
  a.hop = hop;
  a.first_frame = first_frame;
  a.n_features = n_features;
  a.vec_rows = reinterpret_cast<uintptr_t>(audio) % pair == 0 && n_samples % 2 == 0;
  a.twiddle = static_cast<const float2*>(plan_twiddle);
  a.packed = static_cast<const float*>(filt_packed);
  a.table = static_cast<const int*>(fb_table);
  a.dct_t = static_cast<const float*>(dct_t);
  a.n_packed = n_packed;
  a.n_seg = n_seg;
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.emit_deltas = emit_deltas;
  a.time_major = time_major;
  a.out = out;
  a.src_mod = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (audio_int16)
    err = out_bf16 ? launch_n<int16_t, __nv_bfloat16>(n_fft, a, n_warps, s)
                   : launch_n<int16_t, float>(n_fft, a, n_warps, s);
  else
    err = out_bf16 ? launch_n<float, __nv_bfloat16>(n_fft, a, n_warps, s)
                   : launch_n<float, float>(n_fft, a, n_warps, s);
  return static_cast<int>(err);
}
