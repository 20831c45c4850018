// The audio-read floor: a kernel that reads the (B, S) f32 audio once and
// writes as little as it can, hand-written for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package's measurement scripts:
// - tools/dev/r3_experiments.py::make_load_only (pallas_call at :52):
//   out (B, 1) = sum(audio * gain, axis=1);
// - tools/dev/r4_mxu_stage1.py::main's load_kernel (pallas_call at :129):
//   the same row sum, broadcast to out (B, out_cols), out_cols =
//   n_features * n_mfcc (600 at the default config), the shape of the
//   frontend's output.
//
// What bounds it on this card: bytes.  At B 8192 it reads 524.3 MB of audio
// and writes 32.8 KB (rowsum) or 19.7 MB (broadcast): 0.157 / 0.162 ms at
// 3.35 TB/s.  One add and one multiply a sample (16.4 MFLOP a call) are
// nothing beside that.  It is the bandwidth bound of every frontend kernel:
// each of them reads the same audio once.
//
// Design: one block of 256 threads a row.  Each thread reads 16-byte
// (float4) pieces of the row, neighbouring threads on neighbouring
// addresses, four loads in flight, and keeps a partial sum of gain * x; a
// warp-shuffle reduction and one pass through shared memory give the row
// sum, which thread 0 stores, or which the block stores out_cols times.  A
// row whose length or address is not a multiple of 16 bytes is read one
// float at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    audio_load_kernel(const float* __restrict__ audio, const float* gain,
                      int n_samples, float* __restrict__ out, int out_cols) {
  __shared__ float warp_sums[kWarps];
  __shared__ float row_sum;
  const int tid = threadIdx.x;
  const float* row = audio + (size_t)blockIdx.x * n_samples;
  const float g = __ldg(gain);
  float s = 0.0f;
  if (n_samples % 4 == 0 && reinterpret_cast<uintptr_t>(row) % 16 == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int n4 = n_samples / 4;
#pragma unroll 4
    for (int i = tid; i < n4; i += kThreads) {
      const float4 x = __ldcs(row4 + i);  // streamed: read once
      s += x.x * g;
      s += x.y * g;
      s += x.z * g;
      s += x.w * g;
    }
  } else {
    for (int i = tid; i < n_samples; i += kThreads) s += __ldcs(row + i) * g;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = s;
  __syncthreads();
  if (tid < 32) {
    float w = tid < kWarps ? warp_sums[tid] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) w += __shfl_xor_sync(0xffffffffu, w, off);
    if (tid == 0) row_sum = w;
  }
  __syncthreads();
  float* dst = out + (size_t)blockIdx.x * out_cols;
  for (int j = tid; j < out_cols; j += kThreads) dst[j] = row_sum;
}

int launch(const void* audio, const void* gain, int batch, int n_samples,
           void* out, int out_cols, void* stream) {
  if (batch <= 0 || n_samples <= 0 || out_cols <= 0) return cudaErrorInvalidValue;
  audio_load_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(gain),
      n_samples, static_cast<float*>(out), out_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// audio (batch, n_samples) f32, gain (1,) f32, both on the device; out
// (batch, 1) f32 = sum(audio * gain, axis=1).  Returns the launch's
// cudaError_t.
extern "C" int tsc_load_rowsum(const void* audio, const void* gain, int batch,
                               int n_samples, void* out, void* stream) {
  return launch(audio, gain, batch, n_samples, out, 1, stream);
}

// The same row sum, written to every column of out (batch, out_cols) f32.
extern "C" int tsc_load_broadcast(const void* audio, const void* gain,
                                  int batch, int n_samples, void* out,
                                  int out_cols, void* stream) {
  return launch(audio, gain, batch, n_samples, out, out_cols, stream);
}
