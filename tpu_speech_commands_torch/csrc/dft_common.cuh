// Pieces both fast_math DFT frontend kernels share (csrc/dft_frontend.cu,
// the mma.sync kernel, and csrc/dft_wgmma.cu, the wgmma kernel): sample
// loads and output stores, ldmatrix, and the tail after the filter sums
// (log, DCT, the energy coefficient, deltas, the (B, T, F) store).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tsc_dft {

// float64 eps, the reference's safe_log clamp; a normal float32 value
constexpr float kLogEps = 2.220446049250313e-16f;

__device__ __forceinline__ float safe_log(float x) {
  return logf(fmaxf(x, kLogEps));
}

__device__ __forceinline__ float load_sample(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_sample(const int16_t* p) {
  return static_cast<float>(__ldg(p));
}

__device__ __forceinline__ void load4(const float* p, float4& x) {
  x = __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void load4(const int16_t* p, float4& x) {
  const short4 v = __ldg(reinterpret_cast<const short4*>(p));
  x = make_float4(v.x, v.y, v.z, v.w);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__host__ __device__ inline int mel_pitch(int n_filt) { return (n_filt + 1) | 1; }

// The tail, by kThreads threads (tid < kThreads) that `sync()` joins:
// smel (kBM rows x mel_pitch, the filter sums, column n_filt the energy)
// -> safe_log in place -> feats (rows x n_mfcc: the energy, then DCT
// coefficients 1 ..) -> out (rows x n_mfcc, or 2 n_mfcc with the deltas,
// zero on each window's first frame).  kBM is a multiple of kThreads or
// kThreads a multiple of kBM.
template <int kThreads, int kBM, typename OutT, typename Sync>
__device__ __forceinline__ void cepstrum_tail(
    int tid, int rows, int n_features, int n_filt, int n_mfcc,
    int emit_deltas, float* smel, const float* sdct, float* feats, OutT* dst,
    Sync sync) {
  constexpr int kMStep = kThreads >= kBM ? kThreads / kBM : 1;
  const int mp = mel_pitch(n_filt);
  const int r_own = tid % kBM;
  const int m_first = tid / kBM;
  if (r_own < rows)
    for (int m = m_first; m <= n_filt; m += kMStep)
      smel[r_own * mp + m] = safe_log(smel[r_own * mp + m]);
  sync();
  if (r_own < rows) {
    const float* mel = smel + r_own * mp;
    for (int i = m_first; i < n_mfcc; i += kMStep) {
      float v;
      if (i == 0) {
        v = mel[n_filt];
      } else {
        v = 0.0f;
        for (int m = 0; m < n_filt; ++m) v += mel[m] * sdct[m * n_filt + i];
      }
      feats[r_own * n_mfcc + i] = v;
    }
  }
  sync();
  const int n_out = emit_deltas ? 2 * n_mfcc : n_mfcc;
  for (int i = tid; i < rows * n_out; i += kThreads) {
    const int row = i / n_out;
    const int c = i - row * n_out;
    float v;
    if (c < n_mfcc) {
      v = feats[row * n_mfcc + c];
    } else {
      const int cc = c - n_mfcc;
      v = row % n_features == 0
              ? 0.0f
              : feats[row * n_mfcc + cc] - feats[(row - 1) * n_mfcc + cc];
    }
    store_out(dst + i, v);
  }
}

}  // namespace tsc_dft
