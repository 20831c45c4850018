// The FFT kernel's wide body: the MFCC / bark feature frontend for n_fft
// 8192 and 16384 (route fft, n_fft a power of two above the register
// body's 4096), hand-written for Hopper (sm_90a).
//
// Replaces, at these sizes, the TPU kernel tpu_speech_commands/ops/
// pallas_frontend.py::_make_ct_frontend (pallas_call at :745), in the FFT
// kernel's contract (csrc/mfcc_frontend.cu): any window, zero-padded where
// it is shorter than n_fft and cut to its first n_fft samples where it is
// longer, as np.fft.rfft(frame, n=n_fft) does; batch-major output.
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
// What bounds it: the operations.  The real FFT is 2.5 n log2 n a frame: at
// n_fft = window = 8192 (hop 512, 16 frames) 0.58 ms for B = 8192 windows at
// the f32 peak, above the 0.16 ms of the kept frames' bytes; at 16384
// (window 12800, 7 frames) 0.55 ms.  The radix-2 body (csrc/mfcc_frontend.cu),
// which served these sizes before and stays the A/B baseline, keeps one warp
// a frame in a shared buffer of n_fft float2 (64 KB at 8192: 2 warps an SM),
// runs 13 or 14 radix-2 stages through it and walks the dense filterbank:
// 203x that bound at 8192.
//
// Design: csrc/register_fft.cuh's register body with a frame over four
// warps, as route ct's wide kernel (csrc/wide_fft.cuh) runs it: N = n_fft /
// 2 complex points on L = 128 lanes, V = N / L values a lane (32 at 8192,
// 64 at 16384), passes of radix 16 (16, 16, 16 at N = 4096; 16, 8, 8, 8 at
// N = 8192), each exchange ending in a named barrier of the frame's warps,
// the twiddles and the packed weights read through the cache; a window
// shorter than n_fft takes the guarded loads of its lanes' last pairs (its
// zero padding).  A block is 4 warps, one frame.  The plans are
// ops/fft_plan.py::FFT_WIDE_PLANS (mirrored by TSC_FFT_WIDE_PLANS below;
// tests/test_torch_fft_wide_body.py holds the two together and emulates the
// passes in numpy), each the fastest in dev/wide_ablation.py --route fft on
// an H100: at 8192 V = 32 at 4 blocks an SM (128 registers, no spill), 1.26x
// faster than V = 64 on 64 lanes (two frames a block) at its best, 3
// blocks; at 16384 V = 64 at 3 blocks (168 registers, 240 bytes of spill),
// 1.08x faster than at 2 (255 registers, none).

#include "register_fft.cuh"

// (n_fft / 2, values a lane, the launch bounds' blocks an SM, the passes'
// radices): FFT_WIDE_PLANS' n_fft -> (values, radices, blocks, warps); the
// warps a block are the launch's argument
#define TSC_FFT_WIDE_PLANS(X)      \
  X(4096, 32, 4, 16, 16, 16)       \
  X(8192, 64, 3, 16, 8, 8, 8)

TSC_REGISTER_PLANS(tsc_mfcc_wide_frontend, TSC_FFT_WIDE_PLANS)

// audio (batch, n_samples) f32 or int16; gain (1,) f32 on the device;
// plan_twiddle (ops/fft_plan.py::fft_wide_plan(n_fft).twiddle, f32 rows),
// filt_packed (n_packed,) f32 and fb_table (int32, filterbank_plan's table
// over the plan's lanes, n_seg segments); dct_t (n_filt, dct_cols) f32, the
// DCT's columns 1 .. n_mfcc - 1 (dct_cols = n_mfcc - 1) or the whole table
// (dct_cols = n_filt); out (batch, n_features, n_mfcc or 2 n_mfcc) f32 or
// bf16, or with logmel (1 its tail, 2 its first tail, register_fft.cuh's
// Logmel, on the log-mel or the fused filterbank plan) (batch, n_features,
// n_filt + 1) f32 log-mel rows, 16-byte aligned (csrc/cepstrum_wgmma.cu
// finishes them).  Frames first_frame
// .. first_frame + n_features - 1 are computed, each the first min(window,
// n_fft) samples from its start, zero-padded to n_fft; n_warps a block,
// ops/fft_plan.py::fft_layout's for the plan.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for an n_fft the table has no plan
// for, an argument out of range, or shared memory above the card's opt-in
// limit).
extern "C" int tsc_mfcc_wide_frontend(
    const void* audio, int audio_int16, const void* gain, int batch, int n_samples,
    int window, int hop, int n_fft, int first_frame, int n_features,
    const void* plan_twiddle, const void* filt_packed, const void* fb_table,
    int n_packed, int n_seg, const void* dct_t, int dct_cols, int n_filt, int n_mfcc,
    int emit_deltas, int n_warps, void* out, int out_bf16, int logmel, void* stream) {
  return register_entry<tsc_mfcc_wide_frontend_plans>(
      audio, audio_int16, gain, batch, n_samples, window, hop, n_fft, first_frame,
      n_features, plan_twiddle, filt_packed, fb_table, n_packed, n_seg, dct_t, dct_cols,
      n_filt, n_mfcc, emit_deltas, 0, n_warps, out, out_bf16, logmel, stream);
}
