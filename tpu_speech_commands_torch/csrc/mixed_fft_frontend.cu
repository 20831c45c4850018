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

#include "register_fft.cuh"

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

// tsc_mixed_fft_frontend: register_fft.cuh's TSC_REGISTER_ENTRY on these
// plans (its argument list and errors there)
TSC_REGISTER_ENTRY(tsc_mixed_fft_frontend, TSC_MIXED_PLANS)
