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
// n_fft 1024, hop 512, 30 frames) a window is 64 KB of f32 audio (32 KB of
// int16) read once, 2.4 KB of features written, and ~30 x 5 n_fft log2(n_fft)
// = 1.5 MFLOP of FFT plus 30 x 2 x 513 x 20 = 0.6 MFLOP of filterbank: about
// 33 FLOP per f32 byte read (66 per int16 byte).  The H100's f32 ridge is
// 67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte, so even a perfect kernel is
// bound by CUDA-core arithmetic, not by the audio read (~0.16 ms for 8192
// f32 windows).  This simple kernel is bound before that by shared-memory
// traffic and the per-stage __syncwarp of the radix-2 FFT.
//
// Design.  The TPU kernel ran the DFT as matmuls (an 8 x 128 Cooley-Tukey
// split, lane-packed for the MXU).  Here one block owns one window and each
// warp owns one frame at a time: the frame is loaded bit-reversed into a
// per-warp shared buffer and transformed by an in-place radix-2 DIT complex
// FFT with __syncwarp between stages and no block-wide barrier; the
// twiddles come from a float64-built table.  Power, the energy sum and the
// filterbank dot products are lane-strided over the bins and reduced with
// shuffles.  The kept frames' coefficients stay in shared memory until the
// block has all of them, so deltas are one subtract and the (T, F) output
// tile is written with coalesced stores.  Frames dropped by the tail trim
// are never computed.  Nothing but the audio read and the feature write
// touches device memory.
//
// A compile-time STOP cuts the kernel after one stage for the
// stage-omission profile (ops/omission_kernel.py, the counterpart of
// tools/dev/r3_omission.py): load (every sample of the window read),
// framing (the bit-reversed frame loads), power (the radix-2 stages and the
// power loop), mel (the filterbank, before its log), log, full (the DCT).  A
// cut then sums its per-frame row over the window's frames into a (B, 128)
// f32 output instead of the deltas and the store, in the CT split kernel's
// lane order (csrc/ct_frontend.cu), so that both kernels' cuts compute one
// function.  The shipped kernel takes the default, kShipped, and every cut
// is an `if constexpr`, so it compiles as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float64 eps, the reference's safe_log clamp; a normal float32 value
constexpr float kLogEps = 2.220446049250313e-16f;

// STOP: the stage a cut ends after (ops/omission_kernel.py::STAGES; this
// kernel has no butterfly stage), or the whole shipped kernel
enum Stop : int { kLoad, kFraming, kButterfly, kPower, kMel, kLog, kFull, kShipped };
constexpr int kLanes = 128;  // a cut's output row, and the CT split's lane

__device__ __forceinline__ float safe_log(float x) {
  return logf(fmaxf(x, kLogEps));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float load_sample(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_sample(const int16_t* p) {
  return static_cast<float>(__ldg(p));
}

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

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory: n_warps FFT buffers of n_fft float2, then n_warps x n_filt
// log-mel scratch, then the block's (n_features, n_mfcc) coefficients.
size_t smem_bytes(int n_warps, int n_fft, int n_filt, int n_features,
                  int n_mfcc) {
  return sizeof(float2) * (size_t)n_warps * n_fft +
         sizeof(float) * ((size_t)n_warps * n_filt + (size_t)n_features * n_mfcc);
}

template <typename InT, typename OutT, int STOP = kShipped>
__global__ void mfcc_frontend_kernel(
    const InT* __restrict__ audio, const float* __restrict__ gain,
    float in_scale, int n_samples, int window, int hop, int n_fft,
    int log2_fft, int first_frame, int n_features,
    const float2* __restrict__ twiddle, const float* __restrict__ filt_t,
    const float* __restrict__ dct_t, int n_filt, int n_mfcc, int emit_deltas,
    OutT* __restrict__ out, int src_mod) {
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
  if constexpr (STOP != kShipped) {  // the constant-block profile: row b % src_mod
    if (src_mod) row = audio + (size_t)(blockIdx.x % src_mod) * n_samples;
  }
  OutT* cut_out = out + (size_t)blockIdx.x * kLanes;  // a cut's (B, 128) row

  if constexpr (STOP == kLoad) {
    // every sample of the window, read as 4-sample vectors (S a multiple of
    // 4), 16 a thread issued before the first is added, and out[l] = x[l] +
    // x[S - 128 + l]; the sum of all that was read enters the output times
    // 0, so no read can be dropped and finite audio's output does not change
    using V = typename Vec4<InT>::T;
    const V* row4 = reinterpret_cast<const V*>(row);
    constexpr int kBatch = 16;
    float total = 0.0f;
    for (int i0 = threadIdx.x; i0 < n_samples / 4; i0 += kBatch * blockDim.x) {
      V v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        v[u] = i < n_samples / 4 ? __ldg(row4 + i) : V{};
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        total += (static_cast<float>(v[u].x) + static_cast<float>(v[u].y)) +
                 (static_cast<float>(v[u].z) + static_cast<float>(v[u].w));
    }
    total = warp_sum(total * scale);
    if (lane == 0) mels_all[warp] = total;
    __syncthreads();
    float all = 0.0f;
    for (int w = 0; w < n_warps; ++w) all += mels_all[w];
    for (int l = threadIdx.x; l < kLanes; l += blockDim.x)
      store_out(cut_out + l, load_sample(row + l) * scale +
                                 load_sample(row + n_samples - kLanes + l) * scale +
                                 0.0f * all);
    return;
  }

  // a cut's per-frame rows summed over the warp's frames, slot k at lane
  // lane + 32 k (framing: see there)
  float fold[kLanes / 32] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int f = warp; f < n_features; f += n_warps) {
    const InT* frame = row + (size_t)(first_frame + f) * hop;
    // bit-reversed load; samples past the window are the FFT's zero padding
    for (int n = lane; n < n_fft; n += 32) {
      const float x = n < window ? load_sample(frame + n) * scale : 0.0f;
      buf[__brev(n) >> (32 - log2_fft)] = make_float2(x, 0.0f);
    }
    __syncwarp();
    if constexpr (STOP == kFraming) {
      // lane l's 8 planes, frame[128 a + l] (n_fft = 1024): the bit-reversed
      // load put them side by side at buf[8 rev7(l) + rev3(a)], so slot k
      // reads group m = lane + 32 k whole (16-byte reads, no bank conflict)
      // and holds lane rev7(m) (the fold's store below)
#pragma unroll
      for (int k = 0; k < kLanes / 32; ++k) {
        const float4* g = reinterpret_cast<const float4*>(buf + 8 * (lane + 32 * k));
        float y = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = g[i];
          y += v.x + v.z;
        }
        fold[k] += y;
      }
      __syncwarp();
      continue;
    }
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
    float xnyq = 0.0f;
    if constexpr (STOP == kPower) {  // the Nyquist bin's signed amplitude
      xnyq = buf[half].x * sqrtf(inv_fft);
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
    if constexpr (STOP == kPower) {
      // the power row in the CT split's order (n_fft = 1024, n2 = 8): column
      // s 64 + j is bin 8 j + s, so lane l's columns l + 128 c are the bins
      // 8 (l % 64) + l / 64 + {0, 2, 4, 6}.  Slot k < 2 reads bins 8 j ..
      // 8 j + 7 of j = lane + 32 k whole (16-byte reads, no bank conflict):
      // the even ones are lane j's (slot k), the odd ones lane 64 + j's
      // (slot k + 2).  Each lane adds the Nyquist amplitude; the energy is
      // kept, times 0.
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float4* g = reinterpret_cast<const float4*>(buf + 8 * (lane + 32 * k));
        float even = xnyq + 0.0f * energy, odd = xnyq;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = g[i];
          even += v.x;
          odd += v.z;
        }
        fold[k] += even;
        fold[k + 2] += odd;
      }
      __syncwarp();
      continue;
    }
    for (int m = 0; m < n_filt; ++m) {
      const float* fr = filt_t + (size_t)m * n_bins;
      float acc = 0.0f;
      for (int k = lane; k < n_bins; k += 32) acc += buf[k].x * __ldg(&fr[k]);
      acc = warp_sum(acc);
      if (lane == 0) {
        if constexpr (STOP == kMel)
          mels[m] = acc;
        else
          mels[m] = safe_log(acc);
      }
    }
    __syncwarp();
    if constexpr (STOP == kMel || STOP == kLog) {
      // lanes: the filters, the energy, then zeros (their log for the log cut)
#pragma unroll
      for (int k = 0; k < kLanes / 32; ++k) {
        const int l = lane + 32 * k;
        float y;
        if (l < n_filt)
          y = mels[l];
        else if (l == n_filt)
          y = STOP == kLog ? safe_log(energy) : energy;
        else
          y = STOP == kLog ? safe_log(0.0f) : 0.0f;
        fold[k] += y;
      }
      __syncwarp();
      continue;
    }
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

  if constexpr (STOP == kFull) {  // the coefficients summed over the frames
    for (int l = threadIdx.x; l < kLanes; l += blockDim.x) {
      float sum = 0.0f;
      if (l < n_mfcc)
        for (int f = 0; f < n_features; ++f) sum += feats[f * n_mfcc + l];
      store_out(cut_out + l, sum);
    }
    return;
  } else if constexpr (STOP != kShipped) {  // the warps' sums, added
    float* part = reinterpret_cast<float*>(smem_raw);  // the idle FFT buffers
#pragma unroll
    for (int k = 0; k < kLanes / 32; ++k) {
      const int m = lane + 32 * k;  // slot k's lane: m, or rev7(m) for framing
      part[warp * kLanes + (STOP == kFraming ? __brev(m) >> 25 : m)] = fold[k];
    }
    __syncthreads();
    for (int l = threadIdx.x; l < kLanes; l += blockDim.x) {
      float sum = 0.0f;
      for (int w = 0; w < n_warps; ++w) sum += part[w * kLanes + l];
      store_out(cut_out + l, sum);
    }
    return;
  }

  const int n_out = emit_deltas ? 2 * n_mfcc : n_mfcc;
  OutT* dst = out + (size_t)blockIdx.x * n_features * n_out;
  for (int i = threadIdx.x; i < n_features * n_out; i += blockDim.x) {
    const int f = i / n_out;
    const int c = i - f * n_out;
    float v;
    if (c < n_mfcc) {
      v = feats[f * n_mfcc + c];
    } else {
      const int cc = c - n_mfcc;
      v = f == 0 ? 0.0f : feats[f * n_mfcc + cc] - feats[(f - 1) * n_mfcc + cc];
    }
    store_out(dst + i, v);
  }
}

template <typename InT, typename OutT, int STOP = kShipped>
cudaError_t launch(const void* audio, float in_scale, const float* gain,
                   int batch, int n_samples, int window, int hop, int n_fft,
                   int log2_fft, int first_frame, int n_features,
                   const float2* twiddle, const float* filt_t,
                   const float* dct_t, int n_filt, int n_mfcc,
                   int emit_deltas, void* out, cudaStream_t stream,
                   int src_mod = 0) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  // 8 warps (8 frames in flight) unless the FFT buffers do not fit
  int n_warps = 8;
  while (n_warps > 1 &&
         smem_bytes(n_warps, n_fft, n_filt, n_features, n_mfcc) > (size_t)smem_max)
    n_warps >>= 1;
  const size_t smem = smem_bytes(n_warps, n_fft, n_filt, n_features, n_mfcc);
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  auto kernel = mfcc_frontend_kernel<InT, OutT, STOP>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch, n_warps * 32, smem, stream>>>(
      static_cast<const InT*>(audio), gain, in_scale, n_samples, window, hop,
      n_fft, log2_fft, first_frame, n_features, twiddle, filt_t, dct_t, n_filt,
      n_mfcc, emit_deltas, static_cast<OutT*>(out), src_mod);
  return cudaGetLastError();
}

template <typename InT>
cudaError_t launch_cut(int stop, const void* audio, float in_scale,
                       const float* gain, int batch, int n_samples, int n_fft,
                       int log2_fft, int hop, int n_frames, const float2* twiddle,
                       const float* filt_t, const float* dct_t, int n_filt,
                       int n_mfcc, void* out, cudaStream_t s, int src_mod) {
#define TSC_CUT(STOP)                                                              \
  launch<InT, float, STOP>(audio, in_scale, gain, batch, n_samples, n_fft, hop,   \
                           n_fft, log2_fft, 0, n_frames, twiddle, filt_t, dct_t,  \
                           n_filt, n_mfcc, 0, out, s, src_mod)
  switch (stop) {
    case kLoad: return TSC_CUT(kLoad);
    case kFraming: return TSC_CUT(kFraming);
    case kPower: return TSC_CUT(kPower);
    case kMel: return TSC_CUT(kMel);
    case kLog: return TSC_CUT(kLog);
    default: return TSC_CUT(kFull);
  }
#undef TSC_CUT
}

}  // namespace

// audio (batch, n_samples) f32 or int16; gain (1,) f32 on the device;
// twiddle (n_fft/2,) complex64 exp(-2 pi i k / n_fft); filt_t (n_filt,
// n_fft/2 + 1) f32; dct_t (n_filt, n_filt) f32; out (batch, n_features,
// n_mfcc or 2 n_mfcc) f32 or bf16.  Frames first_frame .. first_frame +
// n_features - 1 are computed.  Returns the launch's cudaError_t.
extern "C" int tsc_mfcc_frontend(const void* audio, int audio_int16,
                                 const void* gain, int batch, int n_samples,
                                 int window, int hop, int n_fft,
                                 int first_frame, int n_features,
                                 const void* twiddle, const void* filt_t,
                                 const void* dct_t, int n_filt, int n_mfcc,
                                 int emit_deltas, void* out, int out_bf16,
                                 void* stream) {
  if (batch <= 0 || n_fft < 2 || (n_fft & (n_fft - 1)) != 0 || n_mfcc > n_filt)
    return cudaErrorInvalidValue;
  const int log2_fft = __builtin_ctz(static_cast<unsigned>(n_fft));
  const float* g = static_cast<const float*>(gain);
  const float2* tw = static_cast<const float2*>(twiddle);
  const float* fb = static_cast<const float*>(filt_t);
  const float* dc = static_cast<const float*>(dct_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float in_scale = audio_int16 ? 1.0f / 32768.0f : 1.0f;
#define TSC_LAUNCH(IN, OUT)                                                     \
  launch<IN, OUT>(audio, in_scale, g, batch, n_samples, window, hop, n_fft,     \
                  log2_fft, first_frame, n_features, tw, fb, dc, n_filt, n_mfcc, \
                  emit_deltas, out, s)
  cudaError_t err;
  if (audio_int16)
    err = out_bf16 ? TSC_LAUNCH(int16_t, __nv_bfloat16) : TSC_LAUNCH(int16_t, float);
  else
    err = out_bf16 ? TSC_LAUNCH(float, __nv_bfloat16) : TSC_LAUNCH(float, float);
#undef TSC_LAUNCH
  return static_cast<int>(err);
}

// The kernel cut after stage `stop` (0 load, 1 framing, 3 power, 4 mel, 5
// log, 6 full; ops/omission_kernel.py::FFT_STAGES), at the config
// tools/dev/r3_omission.py takes: frames of n_fft = 1024 samples (n2 = 8),
// hop n_fft / 2, frames 0 .. n_frames - 1, n_samples a multiple of 4.  out
// (batch, 128) f32: each
// window's per-frame rows of the stage, in the CT split's lane order,
// summed over its frames; window b reads audio row b % src_mod when src_mod
// > 0 (the constant-block profile).  Constants as for tsc_mfcc_frontend.
// Returns cudaErrorInvalidValue for any other config or stage.
extern "C" int tsc_mfcc_truncated(const void* audio, int audio_int16,
                                  const void* gain, int batch, int n_samples,
                                  int hop, int n_fft, int n_frames, int stop,
                                  int src_mod, const void* twiddle,
                                  const void* filt_t, const void* dct_t,
                                  int n_filt, int n_mfcc, void* out,
                                  void* stream) {
  if (batch <= 0 || n_fft != 8 * kLanes || 2 * hop != n_fft || n_frames <= 0 ||
      (long long)(n_frames - 1) * hop + n_fft > n_samples || n_samples % 4 != 0 ||
      n_filt <= 0 ||
      n_filt + 1 > kLanes || n_mfcc <= 0 || n_mfcc > n_filt || stop < kLoad ||
      stop > kFull || stop == kButterfly || src_mod < 0)
    return cudaErrorInvalidValue;
  const int log2_fft = __builtin_ctz(static_cast<unsigned>(n_fft));
  const float* g = static_cast<const float*>(gain);
  const float2* tw = static_cast<const float2*>(twiddle);
  const float* fb = static_cast<const float*>(filt_t);
  const float* dc = static_cast<const float*>(dct_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      audio_int16 ? launch_cut<int16_t>(stop, audio, 1.0f / 32768.0f, g, batch, n_samples,
                                        n_fft, log2_fft, hop, n_frames, tw, fb, dc,
                                        n_filt, n_mfcc, out, s, src_mod)
                  : launch_cut<float>(stop, audio, 1.0f, g, batch, n_samples, n_fft,
                                      log2_fft, hop, n_frames, tw, fb, dc, n_filt,
                                      n_mfcc, out, s, src_mod);
  return static_cast<int>(err);
}

extern "C" const char* tsc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
