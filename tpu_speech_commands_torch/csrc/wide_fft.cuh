// Route ct's wide register FFT: the MFCC / bark feature frontend for n_fft
// = window = 256 m, m in 17 .. 62 but 32 (4352 .. 15872), hand-written for
// Hopper (sm_90a); each csrc/wide_fft_frontend_<u>.cu instantiates a share of
// the plans (ops/fft_plan.py::WIDE_PLANS, the index in sorted order modulo
// WIDE_UNITS) and defines its entry point with register_fft.cuh's
// TSC_REGISTER_ENTRY, so that the shares build in parallel.
//
// The JAX package's CT kernel, tpu_speech_commands/ops/pallas_frontend.py::
// _make_ct_frontend (pallas_call at :745), takes every n_fft = 128 n2 with
// n2 even and window == n_fft (its _ct_eligible has no upper limit); on the
// card route ct runs it as the mixed-radix register FFT up to 3840
// (csrc/mixed_fft_frontend.cu) and as this kernel above.  The contract is
// the CT split kernel's (csrc/ct_frontend.cu), whose per-piece-mel (F, T)
// instantiation ("split-dup") served these sizes before and stays the A/B
// baseline and the body of a config this kernel's block does not fit:
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
// What bounds it: the operations.  The real FFT is 2.5 n log2 n a frame, at
// n_fft 4352 and hop 512 0.42 ms for B = 8192 windows at the f32 peak, above
// the 0.16 ms of the kept frames' bytes.  The split's stage 2 is a dense
// 128-point DFT a residue: 128 complex products a bin, 94x that bound.
//
// Design: csrc/register_fft.cuh's register body with a frame over two or
// four warps (L = N / V = 64 or 128 lanes, V <= 64 values a lane): the
// power-of-two radices up to 16 in the fewest passes, then one direct DFT
// pass for each odd prime factor of m (3 .. 61), each exchange ending in a
// named barrier of the frame's warps; the twiddles and the packed weights
// are read through the cache (every block of an SM reads the same tables),
// not staged in shared memory.  A block is 4 warps: two frames of 64 lanes
// or one of 128 (fewer where the window has fewer frames), its frames in
// rounds over the window's; the launch bounds ask for 2, 3 or 4 blocks an
// SM (255, 168 or 128 registers a thread), a plan's fastest on an H100
// (dev/wide_ablation.py): at 3 the plans whose V reaches 50-64 spill 100-580
// bytes, the primes 59 and 61 about 1 KB, which 2 blocks avoid.

#pragma once

#include "register_fft.cuh"
