// The register-resident real-input FFT frontend that the FFT kernel
// (csrc/mfcc_frontend.cu, n_fft a power of two) and route ct's mixed-radix
// kernels (csrc/mixed_fft_frontend.cu, n_fft = 256 m, m 3 .. 15 not a
// power of two; csrc/wide_fft_frontend_*.cu, m 17 .. 62 but 32) all
// instantiate: one kernel body, `register_fft_kernel`, on a plan type
// `RegisterPlan<N, V, B, R0, RS...>` (N = n_fft / 2 complex points, V values
// a lane, launch bounds of B blocks an SM, the passes' radices).  Each .cu
// file instantiates its own plans, so they build in parallel.  The plans
// are ops/fft_plan.py's (`fft_plan`, `mixed_plan`, `wide_plan`), which
// builds their tables; tests/test_torch_fft_plan.py,
// tests/test_torch_mixed_fft.py and tests/test_torch_wide_fft.py emulate
// them in numpy.
//
// One block a window; a frame of N complex points z[n] = x[2n] + i x[2n+1]
// is held by L = N / V lanes, V values a lane in registers (V <= 64):
// - L <= 32 (up to n_fft 4096; blocks of up to 8 warps): the lanes of one
//   warp (several frames a warp where L < 32), V a multiple of every radix,
//   so that a lane holds whole butterflies of every pass; every exchange
//   ends in __syncwarp, and the block stages the twiddles and the packed
//   weights in shared memory;
// - L = 64 or 128 (the wide plans, above 4096; blocks of 4 warps, two
//   frames of 64 lanes or one of 128): a frame over two or four warps, each
//   exchange ending in a named barrier of that frame's warps only (bar.sync
//   1 + the frame's slot, L threads); a pass of a radix R that does not
//   divide V gives ceil(V / R) butterflies to a lane, the last only where
//   it is < N / R; the twiddles and the packed weights are read through the
//   cache, not staged (a block holds one or two frames, too few to repay a
//   staged table of 100 KB at n_fft 15872), and the energy's warp sums
//   meet in shared memory.  The frames of a block run in rounds, one frame
//   a slot; a slot past the window's last frame leaves the loop.
// For both:
// - pass 0 reads the audio itself: lanes on consecutive pairs, one 8-byte
//   (f32) or 4-byte (int16) load a pair, with no window test where the
//   lane's last pair lies inside the window (a window shorter than n_fft is
//   zero-padded); a frame start or row pitch not aligned for the pair load
//   takes two scalar loads instead;
// - Stockham passes: each reads its inputs at stride N / R in natural
//   order, multiplies by the float64-built inter-pass twiddles staged once a
//   block in shared memory, runs a DFT-R in registers (radix-2 decimation
//   for a power of two up to 16; for an odd prime 3 .. 61 a direct DFT on
//   the pairs x_r +- x_{R-r} with compile-time cos and sin) and writes once,
//   through a per-frame buffer XOR-swizzled before the last pass and linear
//   after it (ops/fft_plan.py::swizzle);
// - the untangle: one lane takes the bins k and N - k of a pair, X[k] = E +
//   W^k O and X[N - k] = conj(E - W^k O), and writes both powers and its
//   part of the energy;
// - the packed filterbank: each lane steps through one run of consecutive
//   packed weights against their bins, writing a partial sum where a filter
//   ends (ops/fft_plan.py::filterbank_plan), and lane m adds filter m's
//   partial sums in order (the fused epilogue);
// - log and DCT per frame into the block's (T, n_mfcc) coefficients in
//   shared memory; deltas and a coalesced store, batch- or time-major, once
//   the window is done.  The DCT region holds only the columns the output
//   uses, 1 .. n_mfcc - 1 (column 0 is the log energy), dct_cols = n_mfcc -
//   1 of them; the whole n_filt x n_filt table (dct_cols = n_filt) is the
//   A/B of that trim;
// - or, in log-mel mode (a uniform runtime flag, `logmel`), the body stops
//   after the log: each kept frame's n_filt log-mel values and its log
//   energy go, f32, to a (B, T, n_filt + 1) buffer on the device, and
//   csrc/cepstrum_wgmma.cu finishes the contract (the DCT as a GEMM, deltas, the
//   store); the block then holds no DCT and no coefficients.  It serves the
//   configs whose DCT columns leave the fused block too little room
//   (ops/fft_plan.py::cepstrum_mode).  Its tail (kLogmelRows) finishes
//   filters where the walk ends them: a lane's run of packed weights is
//   consecutive filters, so each filter that starts and ends in the run
//   has its whole sum in the lane at its last weight, and goes straight
//   to the slot's row stage; only a filter split over lanes' runs leaves
//   its earlier parts in those lanes' carries (one a lane: its last
//   segment), added in order by the lane where it ends once the frame's
//   lanes meet.  The walk reads no segment bound: one step descriptor a
//   lane and step (the bin, and where a segment ends its kind and filter;
//   ops/fft_plan.py::logmel_steps on logmel_filterbank's plan, in which
//   every filter, an empty one too, ends in some run) and one weight, both
//   lane-interleaved so that a step's lanes read consecutive words, the
//   descriptors from the table's tail through the cache; every lane steps
//   the plan's run length with no exit inside the loop, so that the
//   frame's lanes meet again after each step (the first tail's walk,
//   which leaves at each lane's own end and loads the next segment's
//   bounds at each segment's end, loses them to one another at many
//   filters).  Each row is staged at its shift
//   from a 16-byte boundary (a block's rows are consecutive in the
//   buffer, but a row of n_filt + 1 floats starts wherever the one before
//   ended), then logged and stored in 16-byte stores with a scalar head
//   and tail.  The first design of the tail (kLogmelPartial, the A/B):
//   the fused epilogue's partial sums and per-filter pass, a 4-byte store
//   a filter.
// A compile-time STOP cuts the body after one stage for the stage-omission
// profile (ops/omission_kernel.py; csrc/mfcc_frontend.cu instantiates the
// cuts at n_fft 1024 only); the shipped kernels take kShipped and every cut
// is an `if constexpr`.  TSC_LOGMEL_STOP (a -D switch of the dev builds of
// dev/logmel_ablation.py, never the shipped library) cuts log-mel mode's
// tail the same way: after the power row (kPower), the filterbank walk
// (kMel) or the filter sums and their logs (kLog), each frame then writing
// its log energy alone.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float64 eps, the reference's safe_log clamp; a normal float32 value
constexpr float kLogEps = 2.220446049250313e-16f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float safe_log(float x) {
  return logf(fmaxf(x, kLogEps));
}

__device__ __forceinline__ float load_sample(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_sample(const int16_t* p) {
  return static_cast<float>(__ldg(p));
}

// two adjacent samples, 8 (f32) or 4 (int16) bytes aligned
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_pair(const int16_t* p) {
  const short2 s = __ldg(reinterpret_cast<const short2*>(p));
  return make_float2(static_cast<float>(s.x), static_cast<float>(s.y));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Set a kernel's dynamic shared-memory limit to the card's opt-in maximum
// once per device (`limit` is the instantiation's own table); refuse a size
// above it.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int (&limit)[kMaxDevices], size_t smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (limit[device] == 0) {
    int smem_max = 0;
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_max);
    if (err != cudaSuccess) return err;
    limit[device] = smem_max;
  }
  return smem <= static_cast<size_t>(limit[device]) ? cudaSuccess
                                                    : cudaErrorInvalidValue;
}

// complex helpers (float2 = re, im)
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// W_16^k = exp(-2 pi i k / 16), k < 8, from the float64 values; a
// compile-time constant once the DFT's loops are unrolled
__device__ __forceinline__ float2 w16(int k) {
  constexpr float c[8] = {1.0f, 0.92387953251128674f, 0.70710678118654757f,
                          0.38268343236508978f, 0.0f, -0.38268343236508978f,
                          -0.70710678118654757f, -0.92387953251128674f};
  constexpr float s[8] = {0.0f, 0.38268343236508978f, 0.70710678118654757f,
                          0.92387953251128674f, 1.0f, 0.92387953251128674f,
                          0.70710678118654757f, 0.38268343236508978f};
  return make_float2(c[k], -s[k]);
}

// v * W_R^k, k < R / 2 <= 8
template <int R>
__device__ __forceinline__ float2 rotate(float2 v, int k) {
  const int k16 = k * (16 / R);
  if (k16 == 0) return v;
  if (k16 == 4) return make_float2(v.y, -v.x);  // times -i
  return cmul(v, w16(k16));
}

// In-register DFT of R <= 16 points, natural order in and out (radix-2
// decimation in time, every index a compile-time constant).
template <int R>
struct Dft {
  static __device__ __forceinline__ void run(float2 (&v)[R]) {
    float2 e[R / 2], o[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      e[i] = v[2 * i];
      o[i] = v[2 * i + 1];
    }
    Dft<R / 2>::run(e);
    Dft<R / 2>::run(o);
#pragma unroll
    for (int k = 0; k < R / 2; ++k) {
      const float2 t = rotate<R>(o[k], k);
      v[k] = make_float2(e[k].x + t.x, e[k].y + t.y);
      v[k + R / 2] = make_float2(e[k].x - t.x, e[k].y - t.y);
    }
  }
};
template <>
struct Dft<1> {
  static __device__ __forceinline__ void run(float2 (&)[1]) {}
};

// the float2 slot of point i in a swizzled exchange
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 15); }

constexpr int kMaxThreads = 256;  // 8 warps, the largest block
constexpr int kWideThreads = 128;  // a wide plan's block: 4 warps
constexpr int kLanes = 128;       // a cut's output row, and the CT split's lane

// STOP: the stage a cut ends after (ops/omission_kernel.py::STAGES; this
// body has no butterfly stage), or the whole shipped kernel
enum Stop : int { kLoad, kFraming, kButterfly, kPower, kMel, kLog, kFull, kShipped };

#ifndef TSC_LOGMEL_STOP
#define TSC_LOGMEL_STOP kShipped
#endif
// the stage log-mel mode's tail ends after (a dev build's cut), or all of it
constexpr int kLogmelStop = TSC_LOGMEL_STOP;
static_assert(kLogmelStop == kPower || kLogmelStop == kMel || kLogmelStop == kLog ||
                  kLogmelStop == kShipped,
              "a log-mel cut ends after the power row, the walk or the logs");

// The epilogue a launch runs (FftArgs::logmel): fused, log-mel mode's tail,
// or log-mel mode's first tail (partial sums, the A/B)
enum Logmel : int { kFused = 0, kLogmelRows = 1, kLogmelPartial = 2 };

// log-mel mode's tail: a step descriptor (ops/fft_plan.py::logmel_steps)
// holds the bin (bits 0-13), the kind of segment end (bits 14-15) and its
// filter (bits 16-27)
constexpr int kStepBin = (1 << 14) - 1;
constexpr int kStepKindShift = 14;
constexpr int kStepFiltShift = 16;
enum StepKind : int { kStepFinish = 1, kStepCarry = 2, kStepHead = 3 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// cos and sin of 2 pi k / R, k <= R / 2, for the odd primes 17 .. 61 of the
// wide plans: the float32 values of the float64 ones (shortest decimals)
template <int R>
struct HalfCosSin;
template <>
struct HalfCosSin<17> {
  static __device__ __forceinline__ float2 at(int k) {
    constexpr float c[9] = {1.0f, 0.9324722f, 0.7390089f, 0.44573835f,
                            0.09226836f, -0.27366298f, -0.6026346f,
                            -0.85021716f, -0.9829731f};
    constexpr float s[9] = {0.0f, 0.36124167f, 0.6736956f, 0.8951633f,
                            0.99573416f, 0.96182567f, 0.7980172f, 0.52643216f,
                            0.18374951f};
    return make_float2(c[k], s[k]);
  }
};
template <>
struct HalfCosSin<19> {
  static __device__ __forceinline__ float2 at(int k) {
    constexpr float c[10] = {1.0f, 0.94581723f, 0.7891405f, 0.54694813f,
                             0.24548548f, -0.082579345f, -0.40169543f,
                             -0.67728156f, -0.87947375f, -0.9863613f};
    constexpr float s[10] = {0.0f, 0.32469946f, 0.6142127f, 0.8371665f,
                             0.9694003f, 0.9965845f, 0.91577333f, 0.7357239f,
                             0.47594738f, 0.16459459f};
    return make_float2(c[k], s[k]);
  }
};
template <>
struct HalfCosSin<23> {
  static __device__ __forceinline__ float2 at(int k) {
    constexpr float c[12] = {1.0f, 0.96291727f, 0.8544194f, 0.6825532f,
                             0.46006504f, 0.20345601f, -0.068242416f,
                             -0.3348796f, -0.5766803f, -0.7757113f,
                             -0.9172113f, -0.99068594f};
    constexpr float s[12] = {0.0f, 0.26979676f, 0.51958394f, 0.730836f,
                             0.8878852f, 0.9790841f, 0.99766874f, 0.9422609f,
                             0.8169699f, 0.63108796f, 0.39840108f, 0.13616665f};
    return make_float2(c[k], s[k]);
  }
};
template <>
struct HalfCosSin<29> {
  static __device__ __forceinline__ float2 at(int k) {
    constexpr float c[15] = {1.0f, 0.97662055f, 0.9075754f, 0.79609305f,
                             0.6473863f, 0.46840844f, 0.26752833f, 0.05413891f,
                             -0.161782f, -0.37013817f, -0.5611871f,
                             -0.7259955f, -0.8568572f, -0.9476532f,
                             -0.99413794f};
    constexpr float s[15] = {0.0f, 0.21497044f, 0.4198891f, 0.60517424f,
                             0.762162f, 0.883512f, 0.96355f, 0.9985334f,
                             0.98682654f, 0.9289767f, 0.827689f, 0.68769944f,
                             0.51555383f, 0.31930152f, 0.10811902f};
    return make_float2(c[k], s[k]);
  }
};
template <>
struct HalfCosSin<31> {
  static __device__ __forceinline__ float2 at(int k) {
    constexpr float c[16] = {1.0f, 0.9795299f, 0.9189578f, 0.82076347f,
                             0.68896693f, 0.528964f, 0.34730524f, 0.15142778f,
                             -0.05064917f, -0.25065252f, -0.44039416f,
                             -0.61210597f, -0.7587581f, -0.8743466f,
                             -0.95413923f, -0.99486935f};
    constexpr float s[16] = {0.0f, 0.20129852f, 0.39435586f, 0.5712682f,
                             0.7247928f, 0.84864426f, 0.9377521f, 0.98846835f,
                             0.99871653f, 0.9680771f, 0.89780456f, 0.7907757f,
                             0.6513725f, 0.48530197f, 0.29936314f, 0.10116832f};
    return make_float2(c[k], s[k]);
  }
};
template <>
struct HalfCosSin<37> {
  static __device__ __forceinline__ float2 at(int k) {
    constexpr float c[19] = {1.0f, 0.9856159f, 0.9428775f, 0.8730141f,
                             0.77803576f, 0.66067475f, 0.5243073f, 0.37285647f,
                             0.21067926f, 0.042441204f, -0.12701783f,
                             -0.29282278f, -0.45020375f, -0.59463316f,
                             -0.7219561f, -0.8285096f, -0.9112285f,
                             -0.96773297f, -0.9963975f};
    constexpr float s[19] = {0.0f, 0.16900082f, 0.3331398f, 0.48769495f,
                             0.62822f, 0.7506723f, 0.8515291f, 0.92788905f,
                             0.9775552f, 0.99909896f, 0.99190044f, 0.95616674f,
                             0.89292586f, 0.80399716f, 0.6919389f, 0.5599748f,
                             0.41190124f, 0.25197807f, 0.08480593f};
    return make_float2(c[k], s[k]);
  }
};
template <>
struct HalfCosSin<41> {
  static __device__ __forceinline__ float2 at(int k) {
    constexpr float c[21] = {1.0f, 0.9882804f, 0.9533964f, 0.89616555f,
                             0.8179294f, 0.72052157f, 0.60622543f, 0.4777198f,
                             0.33801687f, 0.19039111f, 0.038302734f,
                             -0.11468343f, -0.2649815f, -0.40906864f,
                             -0.54356754f, -0.6653257f, -0.7714892f,
                             -0.8595696f, -0.92750245f, -0.9736954f,
                             -0.9970658f};
    constexpr float s[21] = {0.0f, 0.15264928f, 0.3017206f, 0.44371983f,
                             0.57531863f, 0.6934325f, 0.79529285f, 0.87851226f,
                             0.94114006f, 0.98170835f, 0.9992662f, 0.99340206f,
                             0.9642535f, 0.9125036f, 0.8393654f, 0.74655324f,
                             0.63624245f, 0.5110187f, 0.3738171f, 0.2278535f,
                             0.076549254f};
    return make_float2(c[k], s[k]);
  }
};
template <>
struct HalfCosSin<43> {
  static __device__ __forceinline__ float2 at(int k) {
    constexpr float c[22] = {1.0f, 0.98934335f, 0.9576006f, 0.90544826f,
                             0.83399785f, 0.7447722f, 0.639673f, 0.52094036f,
                             0.39110473f, 0.25293338f, 0.10937121f,
                             -0.036522023f, -0.18163686f, -0.32288042f,
                             -0.4572423f, -0.58185893f, -0.6940742f,
                             -0.7914965f, -0.8720494f, -0.9340161f,
                             -0.9760759f, -0.9973323f};
    constexpr float s[22] = {0.0f, 0.14560117f, 0.2880991f, 0.4244567f,
                             0.55176777f, 0.6673188f, 0.76864713f, 0.8535931f,
                             0.9203462f, 0.9674837f, 0.994001f, 0.99933285f,
                             0.98336565f, 0.9464398f, 0.8893421f, 0.81328976f,
                             0.71990347f, 0.6111737f, 0.48941785f, 0.3572309f,
                             0.21743017f, 0.07299531f};
    return make_float2(c[k], s[k]);
  }
};
template <>
struct HalfCosSin<47> {
  static __device__ __forceinline__ float2 at(int k) {
    constexpr float c[24] = {1.0f, 0.9910775f, 0.9644692f, 0.9206499f,
                             0.8604016f, 0.7847994f, 0.69519246f, 0.59317976f,
                             0.48058176f, 0.35940778f, 0.23182015f,
                             0.10009569f, -0.03341498f, -0.16632935f,
                             -0.2962756f, -0.42093477f, -0.53808236f,
                             -0.64562786f, -0.74165213f, -0.82444155f,
                             -0.8925188f, -0.94466907f, -0.9799617f,
                             -0.99776685f};
    constexpr float s[24] = {0.0f, 0.13328695f, 0.2641954f, 0.39038926f,
                             0.5096166f, 0.6197499f, 0.7188237f, 0.80507004f,
                             0.8769499f, 0.93318063f, 0.97275865f, 0.99497783f,
                             0.99944156f, 0.9860703f, 0.9551025f, 0.9070909f,
                             0.8428923f, 0.7636522f, 0.6707847f, 0.5659471f,
                             0.4510101f, 0.32802486f, 0.19918598f, 0.06679264f};
    return make_float2(c[k], s[k]);
  }
};
template <>
struct HalfCosSin<53> {
  static __device__ __forceinline__ float2 at(int k) {
    constexpr float c[27] = {1.0f, 0.9929811f, 0.9720229f, 0.93741965f,
                             0.8896571f, 0.82940567f, 0.75751126f, 0.674983f,
                             0.5829795f, 0.4827922f, 0.37582758f, 0.26358718f,
                             0.14764656f, 0.029633328f, -0.08879589f,
                             -0.20597862f, -0.32026985f, -0.4300652f,
                             -0.5338234f, -0.63008785f, -0.71750724f,
                             -0.79485446f, -0.86104363f, -0.91514564f,
                             -0.956401f, -0.9842306f, -0.99824375f};
    constexpr float s[27] = {0.0f, 0.11827317f, 0.23488605f, 0.34820163f,
                             0.45662925f, 0.55864674f, 0.65282214f,
                             0.73783326f, 0.8124869f, 0.8757349f, 0.9266896f,
                             0.9646356f, 0.9890402f, 0.99956083f, 0.9960498f,
                             0.9785565f, 0.94732636f, 0.9027978f, 0.845596f,
                             0.7765239f, 0.696551f, 0.60680014f, 0.5085311f,
                             0.40312344f, 0.29205677f, 0.17689027f,
                             0.059240628f};
    return make_float2(c[k], s[k]);
  }
};
template <>
struct HalfCosSin<59> {
  static __device__ __forceinline__ float2 at(int k) {
    constexpr float c[30] = {1.0f, 0.9943348f, 0.9774034f, 0.9493976f,
                             0.91063476f, 0.8615541f, 0.80271167f, 0.7347742f,
                             0.6585114f, 0.57478744f, 0.48455086f, 0.38882416f,
                             0.28869194f, 0.18528873f, 0.07978611f,
                             -0.026620522f, -0.13272552f, -0.2373267f,
                             -0.33923885f, -0.43730733f, -0.5304209f,
                             -0.6175246f, -0.69763154f, -0.769834f,
                             -0.83331394f, -0.88735205f, -0.93133616f,
                             -0.9647679f, -0.9872683f, -0.9985827f};
    constexpr float s[30] = {0.0f, 0.106293485f, 0.21138263f, 0.31407672f,
                             0.41321218f, 0.5076658f, 0.59636736f, 0.6783118f,
                             0.75257075f, 0.81830275f, 0.8747631f, 0.921312f,
                             0.957422f, 0.98268414f, 0.996812f, 0.9996456f,
                             0.9911528f, 0.9714299f, 0.9407003f, 0.89931214f,
                             0.84773445f, 0.78655154f, 0.7164567f, 0.6382442f,
                             0.55280006f, 0.4610925f, 0.36416057f, 0.26310256f,
                             0.1590635f, 0.053222176f};
    return make_float2(c[k], s[k]);
  }
};
template <>
struct HalfCosSin<61> {
  static __device__ __forceinline__ float2 at(int k) {
    constexpr float c[31] = {1.0f, 0.9946999f, 0.97885567f, 0.9526354f,
                             0.9163169f, 0.8702852f, 0.8150283f, 0.75113195f,
                             0.67927337f, 0.6002143f, 0.5147928f, 0.4239144f,
                             0.32854238f, 0.22968774f, 0.12839836f,
                             0.025747914f, -0.07717546f, -0.17928076f,
                             -0.27948564f, -0.37672788f, -0.46997675f,
                             -0.55824375f, -0.6405932f, -0.7161522f,
                             -0.7841198f, -0.8437756f, -0.8944871f,
                             -0.9357168f, -0.9670277f, -0.9880879f,
                             -0.9986741f};
    constexpr float s[31] = {0.0f, 0.102821f, 0.20455207f, 0.30411482f,
                             0.4004539f, 0.49254808f, 0.5794211f, 0.66015214f,
                             0.73388535f, 0.79983926f, 0.85731465f,
                             0.90570223f, 0.94448924f, 0.9732644f, 0.9917227f,
                             0.9996685f, 0.9970175f, 0.98379797f, 0.9601499f,
                             0.92632395f, 0.8826788f, 0.829677f, 0.76788044f,
                             0.69794416f, 0.62060946f, 0.5366962f, 0.44709378f,
                             0.3527521f, 0.25467113f, 0.15389058f,
                             0.051478755f};
    return make_float2(c[k], s[k]);
  }
};

// cos and sin of 2 pi k / R, k < R, from the float64 values (R > 13: the
// half table, k > R / 2 by symmetry); compile-time constants once the DFT's
// loops are unrolled
template <int R>
__device__ __forceinline__ float2 cos_sin(int k) {
  static_assert(R % 2 == 1 && R >= 3 && R <= 61, "odd radix");
  if constexpr (R > 13) {
    const float2 h = HalfCosSin<R>::at(k <= R / 2 ? k : R - k);
    return make_float2(h.x, k <= R / 2 ? h.y : -h.y);
  } else if constexpr (R == 3) {
    constexpr float c[3] = {1.0f, -0.49999999999999978f, -0.50000000000000044f};
    constexpr float s[3] = {0.0f, 0.86602540378443871f, -0.86602540378443837f};
    return make_float2(c[k], s[k]);
  } else if constexpr (R == 5) {
    constexpr float c[5] = {1.0f, 0.30901699437494745f, -0.80901699437494734f,
                            -0.80901699437494756f, 0.30901699437494723f};
    constexpr float s[5] = {0.0f, 0.95105651629515353f, 0.58778525229247325f,
                            -0.58778525229247303f, -0.95105651629515364f};
    return make_float2(c[k], s[k]);
  } else if constexpr (R == 7) {
    constexpr float c[7] = {1.0f, 0.62348980185873359f, -0.22252093395631434f,
                            -0.90096886790241903f, -0.90096886790241915f,
                            -0.22252093395631459f, 0.62348980185873337f};
    constexpr float s[7] = {0.0f, 0.7818314824680298f, 0.97492791218182362f,
                            0.43388373911755823f, -0.43388373911755801f,
                            -0.97492791218182362f, -0.78183148246802991f};
    return make_float2(c[k], s[k]);
  } else if constexpr (R == 11) {
    constexpr float c[11] = {1.0f, 0.84125353283118121f, 0.41541501300188644f,
                             -0.142314838273285f, -0.65486073394528499f,
                             -0.95949297361449737f, -0.95949297361449748f,
                             -0.65486073394528521f, -0.14231483827328523f,
                             0.41541501300188605f, 0.84125353283118121f};
    constexpr float s[11] = {0.0f, 0.54064081745559756f, 0.90963199535451833f,
                             0.9898214418809328f, 0.75574957435425827f,
                             0.28173255684142967f, -0.28173255684142939f,
                             -0.75574957435425816f, -0.98982144188093268f,
                             -0.90963199535451855f, -0.54064081745559744f};
    return make_float2(c[k], s[k]);
  } else {
    constexpr float c[13] = {1.0f, 0.88545602565320991f, 0.56806474673115592f,
                             0.12053668025532301f, -0.35460488704253545f,
                             -0.74851074817110119f, -0.97094181742605201f,
                             -0.97094181742605212f, -0.7485107481711013f,
                             -0.3546048870425359f, 0.1205366802553232f,
                             0.56806474673115481f, 0.88545602565321002f};
    constexpr float s[13] = {0.0f, 0.46472317204376851f, 0.82298386589365635f,
                             0.99270887409805397f, 0.93501624268541483f,
                             0.66312265824079519f, 0.23931566428755768f,
                             -0.23931566428755743f, -0.66312265824079497f,
                             -0.93501624268541472f, -0.99270887409805397f,
                             -0.82298386589365702f, -0.4647231720437684f};
    return make_float2(c[k], s[k]);
  }
}

// In-register DFT of an odd prime R, natural order in and out: with p_r =
// x_r + x_{R-r} and q_r = x_r - x_{R-r} (r = 1 .. R/2), y_0 = x_0 + sum p_r
// and, for k = 1 .. R/2, a = x_0 + sum cos(2 pi r k / R) p_r, b = sum
// sin(2 pi r k / R) q_r, y_k = a - i b, y_{R-k} = a + i b.
template <int R>
struct OddDft {
  static __device__ __forceinline__ void run(float2 (&v)[R]) {
    constexpr int H = R / 2;
    float2 p[H], q[H];
    float2 y0 = v[0];
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      p[r - 1] = make_float2(v[r].x + v[R - r].x, v[r].y + v[R - r].y);
      q[r - 1] = make_float2(v[r].x - v[R - r].x, v[r].y - v[R - r].y);
      y0 = make_float2(y0.x + p[r - 1].x, y0.y + p[r - 1].y);
    }
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      float2 a = v[0], b = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const float2 w = cos_sin<R>((r * k) % R);
        a = make_float2(fmaf(w.x, p[r - 1].x, a.x), fmaf(w.x, p[r - 1].y, a.y));
        b = make_float2(fmaf(w.y, q[r - 1].x, b.x), fmaf(w.y, q[r - 1].y, b.y));
      }
      v[k] = make_float2(a.x + b.y, a.y - b.x);
      v[R - k] = make_float2(a.x - b.y, a.y + b.x);
    }
    v[0] = y0;
  }
};

template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R % 2)
    OddDft<R>::run(v);
  else
    Dft<R>::run(v);
}

// twiddle rows of the passes after pass 0, the first of stride NS: (R - 1)
// NS rows a pass (ops/fft_plan.py::build_plan)
template <int NS, int R, int... REST>
__host__ __device__ constexpr int twiddle_rows() {
  if constexpr (sizeof...(REST) == 0)
    return (R - 1) * NS;
  else
    return (R - 1) * NS + twiddle_rows<NS * R, REST...>();
}

// The launch's arguments, both kernels' (the cuts' src_mod only the FFT
// kernel's; the window is n_fft on route ct)
struct FftArgs {
  const void* audio;
  const float* gain;
  float in_scale;
  int batch, n_samples, window, hop, first_frame, n_features;
  int vec_rows;  // rows start aligned for a pair load and have even pitch
  const float2* twiddle;  // the plan's kNtw rows
  const float* packed;    // n_packed weights
  const int* table;       // lane_seg (L + 1), filt_seg (n_filt + 1), segments
  // (n_filt, dct_cols): the DCT's columns 1 .. n_mfcc - 1 (dct_cols = n_mfcc
  // - 1), or all n_filt of them (dct_cols = n_filt, the A/B)
  const float* dct_t;
  int n_packed, n_seg, n_filt, n_mfcc, dct_cols, emit_deltas, time_major;
  // kFused, or (B, n_features, n_filt + 1) f32 log-mel rows to out by
  // kLogmelRows or kLogmelPartial (`Logmel`)
  int logmel;
  void* out;
  int src_mod;  // a cut's constant block: window b reads row b % src_mod
};

// Shared memory, region by region, each 16-byte aligned (mirrored by
// ops/fft_plan.py::fft_layout): the twiddles and the packed weights (none
// where the plan does not stage them), the filterbank table (`table_ints`),
// the DCT's (n_filt, dct_cols) columns, one buffer of kPitch float2 a frame
// slot, one scratch row of `slot_floats` a slot, and the window's
// (n_features, feat_cols) coefficients.  Log-mel mode keeps neither the
// DCT nor the coefficients (`args_layout`).
struct SmemLayout {
  size_t twiddle, packed, table, dct, frames, scratch, feats, total;
};

template <typename P>
__host__ __device__ SmemLayout smem_layout(int n_warps, int n_packed, int n_table,
                                           int n_filt, int dct_cols, int feat_cols,
                                           int n_features, int slot_len) {
  const size_t slots = static_cast<size_t>(n_warps) * P::kFpw / P::kWpf;
  SmemLayout s;
  s.twiddle = 0;
  s.packed = s.twiddle + (P::kStaged ? align16(sizeof(float2) * P::kNtw) : 0);
  s.table = s.packed + (P::kStaged ? align16(sizeof(float) * n_packed) : 0);
  s.dct = s.table + align16(sizeof(int) * n_table);
  s.frames = s.dct + align16(sizeof(float) * n_filt * dct_cols);
  s.scratch = s.frames + align16(sizeof(float2) * slots * P::kPitch);
  s.feats = s.scratch + align16(sizeof(float) * slots * slot_len);
  s.total = s.feats + align16(sizeof(float) * n_features * feat_cols);
  return s;
}

// Floats of a slot's row stage in log-mel mode's tail: a frame's n_filt + 1
// values at its row's shift from a 16-byte boundary (0 .. 3), whole float4s
__host__ __device__ inline int row_stage(int n_filt) { return (n_filt + 7) & ~3; }

// The filterbank table's ints a block stages: lane_seg, filt_seg, the
// segments' rows and, for log-mel mode's tail, each segment's filter (its
// step descriptors follow in the table, read through the cache)
template <typename P>
__host__ __device__ inline int table_ints(int n_seg, int n_filt, int logmel) {
  return P::kL + 1 + n_filt + 1 + (logmel == kLogmelRows ? 4 : 3) * n_seg;
}

// A slot's scratch floats: log-mel mode's tail keeps its row stage, a carry
// a lane and kWpf energy parts (whole float4s); the fused epilogue and the
// first tail the partial sums, n_filt log-mel values and the energy parts
template <typename P>
__host__ __device__ inline int slot_floats(int n_seg, int n_filt, int logmel) {
  return logmel == kLogmelRows ? row_stage(n_filt) + ((P::kL + P::kWpf + 3) & ~3)
                               : n_seg + n_filt + P::kWpf;
}

// A launch's layout: the fused epilogue's, or log-mel mode's (no DCT, no
// coefficients)
template <typename P>
__host__ __device__ SmemLayout args_layout(const FftArgs& a, int n_warps) {
  return smem_layout<P>(n_warps, a.n_packed, table_ints<P>(a.n_seg, a.n_filt, a.logmel),
                        a.n_filt, a.logmel ? 0 : a.dct_cols, a.logmel ? 0 : a.n_mfcc,
                        a.n_features, slot_floats<P>(a.n_seg, a.n_filt, a.logmel));
}

// The end of an exchange among a frame's lanes: its warp's, or, where a
// frame spans warps, a named barrier of the frame's L threads (id 1 + its
// slot in the block; 0 is __syncthreads')
template <typename P>
__device__ __forceinline__ void frame_sync(int slot) {
  if constexpr (P::kWpf == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(P::kL) : "memory");
}

// Whether butterfly b of lane l exists in a pass of radix R: every one where
// R divides V, else the last (b = ceil(V / R) - 1) only below N / R
template <typename P, int R>
__device__ __forceinline__ bool butterfly_exists(int b, int l) {
  constexpr int NB = (P::kV + R - 1) / R;
  return P::kV % R == 0 || b + 1 < NB || l + P::kL * b < P::N / R;
}

// One Stockham pass of radix R after passes of stride NS: each of the lane's
// butterflies j = l + L b reads z[j + r N / R] (the swizzled exchange the
// pass before wrote), multiplies input r by W_{NS R}^{r (j mod NS)} (row
// (r - 1) NS + j mod NS of `tw`), runs a DFT-R and writes output s to
// (j - c) R + c + s NS, swizzled unless LAST.  Every read comes before any
// write: the frame lives in registers in between.
template <typename P, int R, int NS, bool LAST>
__device__ __forceinline__ void stockham_pass(float2* buf, float2 (&v)[P::kVR],
                                              const float2* tw, int l, int slot) {
  constexpr int N = P::N, L = P::kL, NB = (P::kV + R - 1) / R;
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (butterfly_exists<P, R>(b, l))
#pragma unroll
      for (int r = 0; r < R; ++r) v[b * R + r] = buf[swz(l + L * b + r * (N / R))];
  frame_sync<P>(slot);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (!butterfly_exists<P, R>(b, l)) continue;
    const int j = l + L * b;
    const int c = (NS & (NS - 1)) == 0 ? j & (NS - 1) : j % NS;
    float2 u[R];
    u[0] = v[b * R];
#pragma unroll
    for (int r = 1; r < R; ++r) u[r] = cmul(v[b * R + r], tw[(r - 1) * NS + c]);
    dft<R>(u);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int o = (j - c) * R + c + s * NS;
      buf[LAST ? o : swz(o)] = u[s];
    }
  }
  frame_sync<P>(slot);
}

// The passes after pass 0, radices R, REST... in order: the first of
// stride NS, its twiddle rows from row TW of `tw`
template <typename P, int NS, int TW, int R, int... REST>
__device__ __forceinline__ void later_passes(float2* buf, float2 (&v)[P::kVR],
                                             const float2* tw, int l, int slot) {
  stockham_pass<P, R, NS, sizeof...(REST) == 0>(buf, v, tw + TW, l, slot);
  if constexpr (sizeof...(REST) > 0)
    later_passes<P, NS * R, TW + (R - 1) * NS, REST...>(buf, v, tw, l, slot);
}

// the most values a lane holds in any pass: ceil(V / R) butterflies of R
template <int V, int R, int... REST>
__host__ __device__ constexpr int lane_slots() {
  constexpr int here = (V + R - 1) / R * R;
  if constexpr (sizeof...(REST) == 0)
    return here;
  else
    return here > lane_slots<V, REST...>() ? here : lane_slots<V, REST...>();
}

// The plan of N complex points, V values a lane, launch bounds of B blocks
// an SM, passes of radix R0, RS... (ops/fft_plan.py::build_plan)
template <int N_, int V_, int B_, int R0_, int... RS>
struct RegisterPlan {
  static constexpr int N = N_;
  static constexpr int kV = V_;                          // values a lane
  static constexpr int kL = N / kV;                      // lanes a frame
  static constexpr int kR0 = R0_;                        // pass 0's radix
  static constexpr int kFpw = kL < 32 ? 32 / kL : 1;     // frames a warp
  static constexpr int kWpf = kL > 32 ? kL / 32 : 1;     // warps a frame
  // the twiddles and packed weights in shared memory (frames of one warp)
  static constexpr bool kStaged = kL <= 32;
  static constexpr int kBoundThreads = kStaged ? kMaxThreads : kWideThreads;
  static constexpr int kPitch = N + (kL < 16 ? kL : 0);  // float2 a frame slot
  static constexpr int kVR = lane_slots<kV, R0_, RS...>();  // values held
  static constexpr int kTwU = twiddle_rows<R0_, RS...>();  // untangle's row
  static constexpr int kNtw = kTwU + N / 2 + 1;
  static constexpr int kMinBlocks = B_;
  static constexpr bool kPow2 = (N & (N - 1)) == 0;
  static_assert(sizeof...(RS) > 0 && R0_ * (RS * ... * 1) == N, "radices multiply to N");
  static_assert(kV <= 64 && (!kStaged || (kV % 2 == 0 && kV % R0_ == 0 &&
                                          ((kV % RS == 0) && ...))),
                "a lane of one warp's frame holds whole butterflies of every pass");
  static_assert(kL * kV == N && kL <= 128 && (kL & (kL - 1)) == 0, "L = 1 .. 128");
  static_assert(N % 16 == 0, "the swizzle stays inside the frame");

  // the passes after pass 0
  static __device__ __forceinline__ void run_passes(float2* buf, float2 (&v)[kVR],
                                                    const float2* tw, int l,
                                                    int slot) {
    later_passes<RegisterPlan, R0_, 0, RS...>(buf, v, tw, l, slot);
  }
};


// the 4-sample vector a load cut reads the audio in
template <typename InT>
struct Vec4;
template <>
struct Vec4<float> {
  using T = float4;
};
template <>
struct Vec4<int16_t> {
  using T = short4;
};

// The (T, n_mfcc) coefficients of window blockIdx.x to row (b, t) of out or,
// time-major, (t, b): deltas c[t] - c[t-1] after them (zero for the first
// frame) when emit_deltas.
template <typename OutT>
__device__ __forceinline__ void store_window(const float* feats, int n_features,
                                             int n_mfcc, int emit_deltas,
                                             int time_major, int batch, OutT* out) {
  const int n_out = emit_deltas ? 2 * n_mfcc : n_mfcc;
  for (int i = threadIdx.x; i < n_features * n_out; i += blockDim.x) {
    const int t = i / n_out;
    const int c = i - t * n_out;
    float y;
    if (c < n_mfcc) {
      y = feats[t * n_mfcc + c];
    } else {
      const int cc = c - n_mfcc;
      y = t == 0 ? 0.0f : feats[t * n_mfcc + cc] - feats[(t - 1) * n_mfcc + cc];
    }
    const size_t r = time_major ? (size_t)t * batch + blockIdx.x
                                : (size_t)blockIdx.x * n_features + t;
    store_out(out + r * n_out + c, y);
  }
}

template <typename InT, typename OutT, typename P, int STOP = kShipped>
__global__ void __launch_bounds__(P::kBoundThreads, P::kMinBlocks)
    register_fft_kernel(FftArgs a) {
  constexpr int N = P::N, V = P::kV, L = P::kL, R0 = P::kR0;
  extern __shared__ float4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  const int n_warps = blockDim.x >> 5;
  const SmemLayout lay = args_layout<P>(a, n_warps);
  // a wide plan reads the twiddles and the packed weights where they lie
  const float2* s_tw =
      P::kStaged ? reinterpret_cast<const float2*>(base + lay.twiddle) : a.twiddle;
  const float* s_w = P::kStaged ? reinterpret_cast<const float*>(base + lay.packed) : a.packed;
  int* s_table = reinterpret_cast<int*>(base + lay.table);
  float* s_dct = reinterpret_cast<float*>(base + lay.dct);
  float2* s_frames = reinterpret_cast<float2*>(base + lay.frames);
  float* s_scratch = reinterpret_cast<float*>(base + lay.scratch);
  float* feats = reinterpret_cast<float*>(base + lay.feats);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float scale = __ldg(a.gain) * a.in_scale;
  const InT* row = static_cast<const InT*>(a.audio) + (size_t)blockIdx.x * a.n_samples;
  if constexpr (STOP != kShipped) {  // the constant-block profile: row b % src_mod
    if (a.src_mod)
      row = static_cast<const InT*>(a.audio) + (size_t)(blockIdx.x % a.src_mod) * a.n_samples;
  }
  float* cut_out = static_cast<float*>(a.out) + (size_t)blockIdx.x * kLanes;

  if constexpr (STOP == kLoad) {
    // every sample of the window, read as 4-sample vectors (S a multiple of
    // 4), 16 a thread issued before the first is added, and out[l] = x[l] +
    // x[S - 128 + l]; the sum of all that was read enters the output times
    // 0, so no read can be dropped and finite audio's output does not change
    using Vt = typename Vec4<InT>::T;
    const Vt* row4 = reinterpret_cast<const Vt*>(row);
    constexpr int kBatch = 16;
    const int n4 = a.n_samples / 4;
    float total = 0.0f;
    for (int i0 = threadIdx.x; i0 < n4; i0 += kBatch * blockDim.x) {
      Vt q[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        q[u] = i < n4 ? __ldg(row4 + i) : Vt{};
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        total += (static_cast<float>(q[u].x) + static_cast<float>(q[u].y)) +
                 (static_cast<float>(q[u].z) + static_cast<float>(q[u].w));
    }
    total = warp_sum(total * scale);
    float* part = reinterpret_cast<float*>(s_frames);
    if (lane == 0) part[warp] = total;
    __syncthreads();
    float all = 0.0f;
    for (int w = 0; w < n_warps; ++w) all += part[w];
    for (int l = threadIdx.x; l < kLanes; l += blockDim.x)
      cut_out[l] = load_sample(row + l) * scale +
                   load_sample(row + a.n_samples - kLanes + l) * scale + 0.0f * all;
    return;
  }

  // the constants, once a block
  if constexpr (P::kStaged) {
    float2* tw = reinterpret_cast<float2*>(base + lay.twiddle);
    float* w = reinterpret_cast<float*>(base + lay.packed);
    for (int i = threadIdx.x; i < P::kNtw; i += blockDim.x) tw[i] = __ldg(a.twiddle + i);
    for (int i = threadIdx.x; i < a.n_packed; i += blockDim.x) w[i] = __ldg(a.packed + i);
  }
  const int table_len = table_ints<P>(a.n_seg, a.n_filt, a.logmel);
  for (int i = threadIdx.x; i < table_len; i += blockDim.x) s_table[i] = __ldg(a.table + i);
  // log-mel mode stages no DCT; the trimmed table's column c is c - 1
  const int dct_len = a.logmel ? 0 : a.n_filt * a.dct_cols;
  const int dct_first = a.dct_cols < a.n_filt;
  for (int i = threadIdx.x; i < dct_len; i += blockDim.x) s_dct[i] = __ldg(a.dct_t + i);
  __syncthreads();
  const int* lane_seg = s_table;
  const int* filt_seg = s_table + L + 1;
  const int* segs = filt_seg + a.n_filt + 1;

  const int l = threadIdx.x & (L - 1);  // the lane in its frame
  const int slot = threadIdx.x / L;
  const int n_slots = blockDim.x / L;
  float2* buf = s_frames + (size_t)slot * P::kPitch;
  float* prow = reinterpret_cast<float*>(buf);  // the power row, after the FFT
  float* partial = s_scratch + (size_t)slot * slot_floats<P>(a.n_seg, a.n_filt, a.logmel);
  float* mel = partial + a.n_seg;
  // log-mel mode's tail: the slot's row stage, then a carry a lane
  float* stage = partial;
  float* carry = partial + row_stage(a.n_filt);
  // a frame's warps' sums (kWpf > 1)
  float* energy_parts = a.logmel == kLogmelRows ? carry + L : mel + a.n_filt;
  const int w_eff = min(a.window, 2 * N);
  const int* seg_filt = segs + 3 * a.n_seg;  // log-mel mode's tail only

  // a cut's per-frame rows summed over the slot's frames, slot k at lane
  // lane + 32 k (framing: see there); a slot past the last frame adds none
  float fold[kLanes / 32] = {0.0f, 0.0f, 0.0f, 0.0f};
  // the slots of a warp run the same rounds, so that every __syncwarp sees
  // all 32 lanes; a slot past the last frame computes on zeros, stores
  // nothing (a slot of whole warps leaves the loop: its barrier is its own)
  for (int f0 = 0; f0 < a.n_features; f0 += n_slots) {
    const int f = f0 + slot;
    const bool active = f < a.n_features;
    if constexpr (P::kWpf > 1)
      if (!active) break;
    const long long start = (long long)(a.first_frame + (active ? f : 0)) * a.hop;
    const InT* frame = row + start;
    const bool vec = a.vec_rows && (start & 1) == 0;

    // pass 0: butterfly j = l + L b reads z[j + r N / R0] straight from the
    // audio, a DFT-R0, swizzled writes; the lane's pairs take unguarded pair
    // loads where its last one lies inside the window (every pair at the
    // default config and on route ct, whose window is n_fft: there a wide
    // plan's extra butterfly, when it exists, lies inside it too)
    constexpr int NB0 = (V + R0 - 1) / R0;
    float2 v[P::kVR];
    if (active && vec && 2 * (l + L * (V / R0 - 1) + (R0 - 1) * (N / R0)) + 1 < w_eff) {
#pragma unroll
      for (int b = 0; b < NB0; ++b)
        if (butterfly_exists<P, R0>(b, l))
#pragma unroll
          for (int r = 0; r < R0; ++r) {
            const float2 x = load_pair(frame + 2 * (l + L * b + r * (N / R0)));
            v[b * R0 + r] = make_float2(x.x * scale, x.y * scale);
          }
    } else {
#pragma unroll
      for (int b = 0; b < NB0; ++b)
        if (butterfly_exists<P, R0>(b, l))
#pragma unroll
          for (int r = 0; r < R0; ++r) {
            const int m = 2 * (l + L * b + r * (N / R0));
            float2 x = make_float2(0.0f, 0.0f);
            if (active) {
              if (vec && m + 1 < w_eff) {
                x = load_pair(frame + m);
              } else {
                if (m < w_eff) x.x = load_sample(frame + m);
                if (m + 1 < w_eff) x.y = load_sample(frame + m + 1);
              }
            }
            v[b * R0 + r] = make_float2(x.x * scale, x.y * scale);
          }
    }
    if constexpr (STOP == kFraming) {
      // n_fft = 1024 (L = 32): lane l holds samples 2l + 64 r (+ 1) = 128 a
      // + 2l + 64 (r & 1) (+ 1), so its slots are the output lanes 2l,
      // 2l + 1, 2l + 64, 2l + 65 (their store below)
      if (active)
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          fold[2 * (r & 1)] += v[r].x;
          fold[2 * (r & 1) + 1] += v[r].y;
        }
      continue;
    }
#pragma unroll
    for (int b = 0; b < NB0; ++b) {
      if (!butterfly_exists<P, R0>(b, l)) continue;
      float2 u[R0];
#pragma unroll
      for (int r = 0; r < R0; ++r) u[r] = v[b * R0 + r];
      dft<R0>(u);
      const int j = l + L * b;
#pragma unroll
      for (int s = 0; s < R0; ++s) buf[swz(j * R0 + s)] = u[s];
    }
    frame_sync<P>(slot);
    P::run_passes(buf, v, s_tw, l, slot);

    // the untangle: lane l takes the pairs k = l + L i < N / 2, i <
    // ceil(V / 2), and lane 0 also k = N / 2; X[k] = E + W^k O, X[N - k] =
    // conj(E - W^k O) with E = (Z[k] + conj Z[N-k]) / 2, O = -i (Z[k] -
    // conj Z[N-k]) / 2
    constexpr int NU = (V + 1) / 2;
    float2 za[NU], zb[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int k = l + L * i;
      if (V % 2 == 0 || k < N / 2) {
        za[i] = buf[k];
        zb[i] = buf[P::kPow2 ? (N - k) & (N - 1) : (k ? N - k : 0)];
      }
    }
    const float2 zm = buf[N / 2];
    frame_sync<P>(slot);
    const float inv_fft = 1.0f / static_cast<float>(2 * N);
    const float2* tw_u = s_tw + P::kTwU;
    float energy = 0.0f, xnyq = 0.0f;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int k = l + L * i;
      if (V % 2 == 1 && k >= N / 2) continue;
      const float2 A = za[i], B = zb[i];
      const float2 e = make_float2(0.5f * (A.x + B.x), 0.5f * (A.y - B.y));
      const float2 o = make_float2(0.5f * (A.y + B.y), -0.5f * (A.x - B.x));
      const float2 wo = cmul(tw_u[k], o);
      const float2 x1 = make_float2(e.x + wo.x, e.y + wo.y);
      const float2 x2 = make_float2(e.x - wo.x, e.y - wo.y);
      const float p1 = (x1.x * x1.x + x1.y * x1.y) * inv_fft;
      const float p2 = (x2.x * x2.x + x2.y * x2.y) * inv_fft;
      prow[k] = p1;
      prow[N - k] = p2;  // k = 0: bin N, the Nyquist bin
      energy += p1 + p2;
      if constexpr (STOP == kPower)
        if (k == 0) xnyq = x2.x * sqrtf(inv_fft);  // X[N], real and signed
    }
    if (l == 0) {  // bin N / 2: A = B = Z[N/2], W^{N/2} = -i
      const float2 e = make_float2(zm.x, 0.0f);
      const float2 o = make_float2(zm.y, 0.0f);
      const float2 wo = cmul(tw_u[N / 2], o);
      const float px = ((e.x + wo.x) * (e.x + wo.x) + wo.y * wo.y) * inv_fft;
      prow[N / 2] = px;
      energy += px;
    }
#pragma unroll
    for (int off = (L < 32 ? L : 32) / 2; off > 0; off >>= 1)
      energy += __shfl_xor_sync(0xffffffffu, energy, off);
    if constexpr (P::kWpf > 1)
      if (lane == 0) energy_parts[l >> 5] = energy;
    frame_sync<P>(slot);

    if constexpr (STOP == kPower) {
      // the power row in the CT split's order (n_fft = 1024, n2 = 8): column
      // s 64 + j is bin 8 j + s, so output lane l's columns l + 128 c are
      // the bins 8 (l % 64) + l / 64 + {0, 2, 4, 6}.  Slot k < 2 reads bins
      // 8 j .. 8 j + 7 of j = lane + 32 k whole (16-byte reads): the even
      // ones are lane j's (slot k), the odd ones lane 64 + j's (slot k +
      // 2).  Each lane adds the Nyquist amplitude; the energy is kept,
      // times 0.
      xnyq = __shfl_sync(0xffffffffu, xnyq, 0);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float4* g = reinterpret_cast<const float4*>(prow + 8 * (lane + 32 * k));
        float even = xnyq + 0.0f * energy, odd = xnyq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float4 q = g[i];
          even += q.x + q.z;
          odd += q.y + q.w;
        }
        if (active) {
          fold[k] += even;
          fold[k + 2] += odd;
        }
      }
      __syncwarp();
      continue;
    }

    if (STOP == kShipped && a.logmel) {
      float total = energy;  // the frame's energy
      if constexpr (P::kWpf > 1) {
        total = 0.0f;
#pragma unroll
        for (int w = 0; w < P::kWpf; ++w) total += energy_parts[w];
      }
      // the frame's row of the (B, T, n_filt + 1) buffer, the log energy last
      const size_t row0 =
          ((size_t)blockIdx.x * a.n_features + (active ? f : 0)) * (a.n_filt + 1);
      float* lm = static_cast<float*>(a.out) + row0;
      if constexpr (kLogmelStop == kPower) {  // a dev build's cut
        if (l == 0 && active) lm[a.n_filt] = safe_log(total);
        continue;
      }
      if (a.logmel == kLogmelRows) {
        // the lane's run is segments ls0 .. ls_end - 1: `back` earlier
        // segments (one a lane, in the lanes before) belong to its first
        // segment's filter f0, and its last segment's filter goes on in the
        // next lane's run where `last_open` (these live only in log-mel
        // mode: the fused epilogue's registers are not touched)
        const int ls0 = lane_seg[l], ls_end = lane_seg[l + 1];
        const bool run = ls0 < ls_end;
        const int f0 = run ? seg_filt[ls0] : 0;
        const int back = run ? ls0 - filt_seg[f0] : 0;
        const bool last_open = run && filt_seg[seg_filt[ls_end - 1] + 1] > ls_end;
        // the walk: `chunk` steps in every lane (the step tables'; a step
        // past the lane's run weighs 0 and ends nothing), step i of lane l
        // at i L + l in the weights and the step descriptors, which a
        // step's lanes read in consecutive words; a step ending a segment
        // writes its sum as the finished filter's (into the stage, whose
        // element e of the row is at shift + e), the carry or the head.
        // No bound is loaded in the loop, and no lane leaves it early: the
        // frame's lanes meet again after every step
        const int* steps = a.table + table_len;
        const int chunk = a.n_packed / L;
        const int shift = static_cast<int>(row0 & 3);
        float* st = stage + shift;
        float head = 0.0f, tail = 0.0f, acc = 0.0f;
#pragma unroll 4
        for (int i = 0; i < chunk; ++i) {
          const int d = __ldg(steps + i * L + l);
          acc = fmaf(prow[d & kStepBin], s_w[i * L + l], acc);
          const int kind = (d >> kStepKindShift) & 3;
          if (kind) {
            if (kind == kStepFinish)
              st[d >> kStepFiltShift] = acc;
            else if (kind == kStepCarry)
              tail = acc;
            else
              head = acc;
            acc = 0.0f;
          }
        }
        if (last_open) carry[l] = tail;
        if (l == 0) st[a.n_filt] = total;
        frame_sync<P>(slot);
        if constexpr (kLogmelStop == kMel) {  // a dev build's cut
          if (l == 0 && active) lm[a.n_filt] = safe_log(total);
          continue;
        }
        // a split filter ends here: its earlier lanes' carries in order,
        // then its first segment here (the fused epilogue's order)
        if (back && !(ls0 == ls_end - 1 && last_open)) {
          float sum = 0.0f;
          for (int j = back; j > 0; --j) sum += carry[l - j];
          st[f0] = sum + head;
        }
        frame_sync<P>(slot);
        // the row, logged: float4 q of the stage is elements 4 q - shift ..
        // of the row, whose start less the shift is 16-byte aligned
        const int n_row = a.n_filt + 1;
        const int n_q = (shift + n_row + 3) >> 2;
        float* dst = lm - shift;
        float keep = 0.0f;
        for (int q = l; q < n_q; q += L) {
          const float4 x = reinterpret_cast<const float4*>(stage)[q];
          const float4 y = make_float4(safe_log(x.x), safe_log(x.y), safe_log(x.z),
                                       safe_log(x.w));
          if constexpr (kLogmelStop == kLog) {  // a dev build's cut: no stores
            keep += (y.x + y.y) + (y.z + y.w);
            continue;
          }
          const int e = 4 * q;
          if (!active) continue;
          if (e >= shift && e + 4 <= shift + n_row) {
            *reinterpret_cast<float4*>(dst + e) = y;
          } else {  // the row's head or tail
            if (e >= shift && e < shift + n_row) dst[e] = y.x;
            if (e + 1 >= shift && e + 1 < shift + n_row) dst[e + 1] = y.y;
            if (e + 2 >= shift && e + 2 < shift + n_row) dst[e + 2] = y.z;
            if (e + 3 >= shift && e + 3 < shift + n_row) dst[e + 3] = y.w;
          }
        }
        if constexpr (kLogmelStop == kLog)
          if (active && keep == -1.0f) lm[a.n_filt] = safe_log(total);
        continue;
      }
    }
    // the packed filterbank: the lane's run of weights, one step a weight
    // (its segments are back to back in the packed order, so the warp steps
    // as often as the longest run, not once a segment), a partial sum
    // written where a segment ends; then filter m's partial sums added in
    // order by lane m
    {
      int s = lane_seg[l];
      const int s_end = lane_seg[l + 1];
      if (s < s_end) {
        int k = segs[3 * s], o = segs[3 * s + 1], left = segs[3 * s + 2];
        float acc = 0.0f;
        for (;;) {
          acc = fmaf(prow[k++], s_w[o++], acc);
          if (--left == 0) {
            partial[s] = acc;
            acc = 0.0f;
            if (++s == s_end) break;
            k = segs[3 * s];
            left = segs[3 * s + 2];
          }
        }
      }
    }
    frame_sync<P>(slot);
    if (STOP == kShipped && a.logmel) {
      // log-mel mode's first tail: the frame's row of the (B, T, n_filt + 1)
      // buffer, the log energy last; the cepstrum kernel takes it from here
      // (the frame buffer and the partial sums are free again: the next
      // frame's exchanges end in frame_syncs before it writes either)
      float* lm = static_cast<float*>(a.out) +
                  ((size_t)blockIdx.x * a.n_features + (active ? f : 0)) * (a.n_filt + 1);
      if (l == 0 && active) {
        if constexpr (P::kWpf > 1) {
          energy = 0.0f;
#pragma unroll
          for (int w = 0; w < P::kWpf; ++w) energy += energy_parts[w];
        }
        lm[a.n_filt] = safe_log(energy);
      }
      if constexpr (kLogmelStop == kMel) continue;  // a dev build's cut
      float keep = 0.0f;
      for (int m = l; m < a.n_filt; m += L) {
        float acc = 0.0f;
        for (int s = filt_seg[m]; s < filt_seg[m + 1]; ++s) acc += partial[s];
        if constexpr (kLogmelStop == kLog)  // a dev build's cut: no stores
          keep += safe_log(acc);
        else if (active)
          lm[m] = safe_log(acc);
      }
      if constexpr (kLogmelStop == kLog)
        if (active && keep == -1.0f) lm[l] = keep;
      continue;
    }
    for (int m = l; m < a.n_filt; m += L) {
      float acc = 0.0f;
      for (int s = filt_seg[m]; s < filt_seg[m + 1]; ++s) acc += partial[s];
      mel[m] = STOP == kMel ? acc : safe_log(acc);
    }
    frame_sync<P>(slot);
    if constexpr (STOP == kMel || STOP == kLog) {
      // lanes: the filters, the energy, then zeros (their log for the log cut)
#pragma unroll
      for (int k = 0; k < kLanes / 32; ++k) {
        const int c = lane + 32 * k;
        float y;
        if (c < a.n_filt)
          y = mel[c];
        else if (c == a.n_filt)
          y = STOP == kLog ? safe_log(energy) : energy;
        else
          y = STOP == kLog ? safe_log(0.0f) : 0.0f;
        if (active) fold[k] += y;
      }
      __syncwarp();
      continue;
    }
    for (int c = l; c < a.n_mfcc; c += L) {
      float y;
      if (c == 0) {
        if constexpr (P::kWpf > 1) {
          energy = 0.0f;
#pragma unroll
          for (int w = 0; w < P::kWpf; ++w) energy += energy_parts[w];
        }
        y = safe_log(energy);
      } else {
        y = 0.0f;
        const float* col = s_dct + (c - dct_first);
        for (int m = 0; m < a.n_filt; ++m) y += mel[m] * col[m * a.dct_cols];
      }
      if (active) feats[f * a.n_mfcc + c] = y;
    }
    frame_sync<P>(slot);  // the next frame reuses mel
  }
  __syncthreads();

  if constexpr (STOP == kFull) {  // the coefficients summed over the frames
    for (int c = threadIdx.x; c < kLanes; c += blockDim.x) {
      float sum = 0.0f;
      if (c < a.n_mfcc)
        for (int f = 0; f < a.n_features; ++f) sum += feats[f * a.n_mfcc + c];
      cut_out[c] = sum;
    }
    return;
  } else if constexpr (STOP != kShipped) {  // the warps' sums, added
    float* part = reinterpret_cast<float*>(s_frames);  // the idle frame buffers
#pragma unroll
    for (int k = 0; k < kLanes / 32; ++k) {
      const int c = STOP == kFraming ? 2 * lane + (k & 1) + 64 * (k >> 1) : lane + 32 * k;
      part[warp * kLanes + c] = fold[k];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kLanes; c += blockDim.x) {
      float sum = 0.0f;
      for (int w = 0; w < n_warps; ++w) sum += part[w * kLanes + c];
      cut_out[c] = sum;
    }
    return;
  }
  if (a.logmel) return;  // the rows are out already
  store_window(feats, a.n_features, a.n_mfcc, a.emit_deltas, a.time_major, a.batch,
               static_cast<OutT*>(a.out));
}

}  // namespace

namespace {

template <typename InT, typename OutT, typename P>
cudaError_t launch_register(const FftArgs& a, int n_warps, cudaStream_t stream) {
  static int limit[kMaxDevices] = {};
  auto kernel = register_fft_kernel<InT, OutT, P>;
  const SmemLayout lay = args_layout<P>(a, n_warps);
  const cudaError_t err = opt_in(kernel, limit, lay.total);
  if (err != cudaSuccess) return err;
  kernel<<<a.batch, n_warps * 32, lay.total, stream>>>(a);
  return cudaGetLastError();
}

// the launch of n_fft's plan in a table of RegisterPlan rows (N, V, B,
// radices...): cudaErrorInvalidValue for warps that are not whole frames
// of the plan within its launch bounds' block
#define TSC_REGISTER_CASE(N, V, B, ...)                                         \
  case 2 * N: {                                                                 \
    using P = RegisterPlan<N, V, B, __VA_ARGS__>;                               \
    if (n_warps % P::kWpf || n_warps > P::kBoundThreads / 32)                   \
      return cudaErrorInvalidValue;                                             \
    return launch_register<InT, OutT, P>(a, n_warps, s);                        \
  }

// A table of plans as a type: NAME##_plans::launch<InT, OutT>(n_fft, args,
// n_warps, stream) launches n_fft's plan, cudaErrorInvalidValue for an
// n_fft the table has no plan for
#define TSC_REGISTER_PLANS(NAME, PLANS)                                         \
  namespace {                                                                   \
  struct NAME##_plans {                                                         \
    template <typename InT, typename OutT>                                      \
    static cudaError_t launch(int n_fft, const FftArgs& a, int n_warps,         \
                              cudaStream_t s) {                                 \
      switch (n_fft) {                                                          \
        PLANS(TSC_REGISTER_CASE)                                                \
        default:                                                                \
          return cudaErrorInvalidValue;                                         \
      }                                                                         \
    }                                                                           \
  };                                                                            \
  }

// An entry point's checks and launch on the table `Plans`: frames
// first_frame .. first_frame + n_features - 1, each the first min(window,
// n_fft) samples from its start, zero-padded to n_fft (the arguments:
// TSC_REGISTER_ENTRY's, and the window)
template <typename Plans>
int register_entry(const void* audio, int audio_int16, const void* gain, int batch,
                   int n_samples, int window, int hop, int n_fft, int first_frame,
                   int n_features, const void* plan_twiddle, const void* filt_packed,
                   const void* fb_table, int n_packed, int n_seg, const void* dct_t,
                   int dct_cols, int n_filt, int n_mfcc, int emit_deltas,
                   int time_major, int n_warps, void* out, int out_bf16, int logmel,
                   void* stream) {
  const int span = window < n_fft ? window : n_fft;
  if (batch <= 0 || n_samples <= 0 || window <= 0 || hop <= 0 || first_frame < 0 ||
      n_features <= 0 ||
      (long long)(first_frame + n_features - 1) * hop + span > n_samples ||
      n_filt <= 0 || n_mfcc <= 0 || n_mfcc > n_filt || n_packed < 0 || n_seg < 0 ||
      n_warps <= 0 || !plan_twiddle || !filt_packed || !fb_table || logmel < kFused ||
      logmel > kLogmelPartial ||
      (logmel ? out_bf16 || time_major || reinterpret_cast<uintptr_t>(out) % 16
              : (dct_cols != n_mfcc - 1 && dct_cols != n_filt) || (dct_cols && !dct_t)))
    return cudaErrorInvalidValue;
  const size_t pair = audio_int16 ? 2 * sizeof(int16_t) : 2 * sizeof(float);
  FftArgs a;
  a.audio = audio;
  a.gain = static_cast<const float*>(gain);
  a.in_scale = audio_int16 ? 1.0f / 32768.0f : 1.0f;
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
  a.dct_t = static_cast<const float*>(dct_t);
  a.n_packed = n_packed;
  a.n_seg = n_seg;
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.dct_cols = logmel ? 0 : dct_cols;
  a.emit_deltas = emit_deltas;
  a.time_major = time_major;
  a.logmel = logmel;
  a.out = out;
  a.src_mod = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (audio_int16)
    err = out_bf16 ? Plans::template launch<int16_t, __nv_bfloat16>(n_fft, a, n_warps, s)
                   : Plans::template launch<int16_t, float>(n_fft, a, n_warps, s);
  else
    err = out_bf16 ? Plans::template launch<float, __nv_bfloat16>(n_fft, a, n_warps, s)
                   : Plans::template launch<float, float>(n_fft, a, n_warps, s);
  return static_cast<int>(err);
}

}  // namespace

// Route ct's register FFT entry points (csrc/mixed_fft_frontend.cu, each
// csrc/wide_fft_frontend_<u>.cu), one a table of plans:
// NAME(audio, audio_int16, gain, batch, n_samples, hop, n_fft, first_frame,
//   n_features, plan_twiddle, filt_packed, fb_table, n_packed, n_seg, dct_t,
//   dct_cols, n_filt, n_mfcc, emit_deltas, time_major, n_warps, out,
//   out_bf16, logmel, stream): audio (batch, n_samples) f32 or int16; gain
// (1,) f32 on the device; plan_twiddle (ops/fft_plan.py's plan of n_fft, its
// twiddle as f32 rows), filt_packed (n_packed,) f32 and fb_table (int32,
// filterbank_plan's table over the plan's lanes, n_seg segments); dct_t
// (n_filt, dct_cols) f32, the DCT's columns 1 .. n_mfcc - 1 (dct_cols =
// n_mfcc - 1) or the whole table (dct_cols = n_filt); out (batch,
// n_features, F) or, time_major, (n_features, batch, F), F = n_mfcc or 2
// n_mfcc, f32 or bf16; or, with logmel (kLogmelRows, or kLogmelPartial for
// the first tail; fb_table then the log-mel or the fused plan's), (batch,
// n_features, n_filt + 1) f32 log-mel rows, the log energy last (no DCT is
// read: batch-major f32 only, out 16-byte aligned).
// Frames first_frame .. first_frame + n_features - 1, each n_fft samples
// (window = n_fft), are computed; n_warps a block, ops/fft_plan.py::
// fft_layout's for the plan.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for an n_fft the table has no plan for, an
// argument out of range, or shared memory above the card's opt-in limit).
#define TSC_REGISTER_ENTRY(NAME, PLANS)                                         \
  TSC_REGISTER_PLANS(NAME, PLANS)                                               \
  extern "C" int NAME(                                                          \
      const void* audio, int audio_int16, const void* gain, int batch,          \
      int n_samples, int hop, int n_fft, int first_frame, int n_features,       \
      const void* plan_twiddle, const void* filt_packed, const void* fb_table,  \
      int n_packed, int n_seg, const void* dct_t, int dct_cols, int n_filt,     \
      int n_mfcc, int emit_deltas, int time_major, int n_warps, void* out,      \
      int out_bf16, int logmel, void* stream) {                                 \
    return register_entry<NAME##_plans>(                                        \
        audio, audio_int16, gain, batch, n_samples, n_fft, hop, n_fft,          \
        first_frame, n_features, plan_twiddle, filt_packed, fb_table, n_packed, \
        n_seg, dct_t, dct_cols, n_filt, n_mfcc, emit_deltas, time_major,        \
        n_warps, out, out_bf16, logmel, stream);                                \
  }
