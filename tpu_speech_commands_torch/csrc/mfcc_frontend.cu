// MFCC / bark feature frontend, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_speech_commands/ops/pallas_frontend.py::
// _make_ct_frontend (pallas_call at :745), and takes the contract of the
// dense branch of make_fused_frontend (:340) as well: one kernel for every
// config with n_fft a power of two and window <= n_fft (zero-padded FFT).
//
//   audio (B, S) f32 | int16, gain (1,) f32  ->  features (B, T, F) f32 | bf16
//   x = int16 ? pcm * (gain / 32768) : audio * gain
//   per kept frame t:  X = FFT_n_fft(x[t*hop : t*hop + window], zero-padded)
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float64 eps, the reference's safe_log clamp; a normal float32 value
constexpr float kLogEps = 2.220446049250313e-16f;

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

template <typename InT, typename OutT>
__global__ void mfcc_frontend_kernel(
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

template <typename InT, typename OutT>
cudaError_t launch(const void* audio, float in_scale, const float* gain,
                   int batch, int n_samples, int window, int hop, int n_fft,
                   int log2_fft, int first_frame, int n_features,
                   const float2* twiddle, const float* filt_t,
                   const float* dct_t, int n_filt, int n_mfcc,
                   int emit_deltas, void* out, cudaStream_t stream) {
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
  auto kernel = mfcc_frontend_kernel<InT, OutT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch, n_warps * 32, smem, stream>>>(
      static_cast<const InT*>(audio), gain, in_scale, n_samples, window, hop,
      n_fft, log2_fft, first_frame, n_features, twiddle, filt_t, dct_t, n_filt,
      n_mfcc, emit_deltas, static_cast<OutT*>(out));
  return cudaGetLastError();
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
  if (batch <= 0 || n_fft < 2 || (n_fft & (n_fft - 1)) != 0 || window > n_fft ||
      n_mfcc > n_filt)
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

extern "C" const char* tsc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
