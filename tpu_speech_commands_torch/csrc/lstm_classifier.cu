// LSTM classifier (one Keras LSTM layer per launch, dense head fused into the
// last), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_speech_commands/ops/pallas_rnn.py::
// make_fused_rnn_classifier (pallas_call at :223) for cell_type='lstm':
//
//   for t in 0 .. T-1:                     gates side by side [i | f | c | o]
//     g = x_t @ W + h @ U + b                 (W: D x 4U, U: U x 4U, b: 4U)
//     c = sigmoid(g_f) * c + sigmoid(g_i) * tanh(g_c)
//     h = sigmoid(g_o) * tanh(c)
//   logits = h_T @ head_w + head_b             (last layer only)
//
// The single Keras bias is added once, as the TPU kernel folds it into the
// input projection (pallas_rnn.py:99-102).  bf16 mode: x, h and the
// weights are rounded to bf16 where they enter a product, products
// accumulate in f32; c, the biases and all gate math stay f32 (the TPU
// kernel's bf16 mode).  tanhf and expf are the full-precision forms.  A
// stacked model runs one launch per layer, the f32 sequence of layer l in
// device memory as layer l+1's input.
//
// What bounds it on this card.  At the serving shape (T 30, D 20, U 48,
// C 5) a window costs 30 x 2 x (20 + 48) x 192 = 0.78 MFLOP against 2.4 KB
// of f32 features read: ~330 FLOP per byte, far above any ridge, and the 30
// steps are serial.  So it is bound by arithmetic and by the latency of one
// step (68 dependent FMAs per gate, then a barrier).
//
// Design: the GRU kernel's (csrc/gru_classifier.cu).  A block owns a tile
// of windows and one thread owns one (window, unit) pair, with its h and c
// in registers.  W, U and the bias (rounded to bf16 there in bf16 mode) and
// the tile's whole feature sequence are staged once in shared memory; at
// U 48 and 10 windows a tile that is ~81 KB for 480 threads.  Threads of a
// window read h of the previous step from a shared double buffer, so a
// step needs a single __syncthreads.  The ragged last tile is masked:
// threads past the batch skip loads and stores but keep to the barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  if (kBf16) return __bfloat162float(__float2bfloat16(v));
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// Shared memory: W (D x 4U), U (U x 4U), b (4U), the tile's inputs
// (tile x T x D) and the h double buffer (2 x tile x U).
size_t smem_floats(int T, int D, int U, int tile) {
  const size_t G = 4 * (size_t)U;
  return (size_t)D * G + (size_t)U * G + G + (size_t)tile * T * D +
         2 * (size_t)tile * U;
}

template <typename InT, bool kBf16>
__global__ void lstm_layer_kernel(
    const InT* __restrict__ x, int batch, int T, int D, int U, int tile,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ bias, const float* __restrict__ head_w,
    const float* __restrict__ head_b, int C, float* __restrict__ seq_out,
    float* __restrict__ logits) {
  extern __shared__ float smem[];
  const int G = 4 * U;
  float* sw = smem;
  float* su = sw + (size_t)D * G;
  float* sb = su + (size_t)U * G;
  float* sx = sb + G;
  float* sh = sx + (size_t)tile * T * D;

  const int b0 = blockIdx.x * tile;
  const int nb = min(tile, batch - b0);
  for (int i = threadIdx.x; i < D * G; i += blockDim.x) sw[i] = rnd<kBf16>(w[i]);
  for (int i = threadIdx.x; i < U * G; i += blockDim.x) su[i] = rnd<kBf16>(u[i]);
  for (int i = threadIdx.x; i < G; i += blockDim.x) sb[i] = bias[i];
  const InT* xt = x + (size_t)b0 * T * D;  // the tile's rows are contiguous
  for (int i = threadIdx.x; i < nb * T * D; i += blockDim.x)
    sx[i] = rnd<kBf16>(to_float(xt[i]));
  for (int i = threadIdx.x; i < 2 * tile * U; i += blockDim.x) sh[i] = 0.0f;
  __syncthreads();

  const int lb = threadIdx.x / U;  // window within the tile
  const int j = threadIdx.x - lb * U;  // unit
  const bool active = lb < nb;
  float h = 0.0f, c = 0.0f;
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    if (active) {
      const float* hp = sh + (size_t)cur * tile * U + (size_t)lb * U;
      const float* xv = sx + ((size_t)lb * T + t) * D;
      float gi = 0.0f, gf = 0.0f, gc = 0.0f, go = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float xd = xv[d];
        const float* wr = sw + (size_t)d * G;
        gi += xd * wr[j];
        gf += xd * wr[U + j];
        gc += xd * wr[2 * U + j];
        go += xd * wr[3 * U + j];
      }
      for (int k = 0; k < U; ++k) {
        const float hk = hp[k];
        const float* ur = su + (size_t)k * G;
        gi += hk * ur[j];
        gf += hk * ur[U + j];
        gc += hk * ur[2 * U + j];
        go += hk * ur[3 * U + j];
      }
      gi += sb[j];
      gf += sb[U + j];
      gc += sb[2 * U + j];
      go += sb[3 * U + j];
      c = sigmoid(gf) * c + sigmoid(gi) * tanhf(gc);
      h = sigmoid(go) * tanhf(c);
      sh[(size_t)(cur ^ 1) * tile * U + (size_t)lb * U + j] = rnd<kBf16>(h);
      if (seq_out) seq_out[((size_t)(b0 + lb) * T + t) * U + j] = h;
    }
    __syncthreads();
    cur ^= 1;
  }
  if (logits && active) {
    const float* hl = sh + (size_t)cur * tile * U + (size_t)lb * U;
    for (int k = j; k < C; k += U) {
      float acc = 0.0f;
      for (int q = 0; q < U; ++q) acc += hl[q] * rnd<kBf16>(__ldg(&head_w[q * C + k]));
      logits[(size_t)(b0 + lb) * C + k] = acc + __ldg(&head_b[k]);
    }
  }
}

template <typename InT, bool kBf16>
cudaError_t launch(const void* x, int batch, int T, int D, int U,
                   const float* w, const float* u, const float* bias,
                   const float* head_w, const float* head_b, int C,
                   float* seq_out, float* logits, cudaStream_t stream) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  // ~512 threads a block; fewer windows per tile if shared memory is short
  int tile = U >= 512 ? 1 : 512 / U;
  while (tile > 1 && smem_floats(T, D, U, tile) * sizeof(float) > (size_t)smem_max)
    --tile;
  const size_t smem = smem_floats(T, D, U, tile) * sizeof(float);
  if (smem > (size_t)smem_max || tile * U > 1024) return cudaErrorInvalidValue;
  auto kernel = lstm_layer_kernel<InT, kBf16>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (batch + tile - 1) / tile;
  kernel<<<blocks, tile * U, smem, stream>>>(
      static_cast<const InT*>(x), batch, T, D, U, tile, w, u, bias, head_w,
      head_b, C, seq_out, logits);
  return cudaGetLastError();
}

}  // namespace

// x (batch, T, D) f32 or bf16; w (D, 4U), u (U, 4U), bias (4U,) f32.
// Writes seq_out (batch, T, U) f32 when it is not null (a layer that feeds
// another), and logits (batch, C) f32 through head_w (U, C) and head_b
// (C,) when logits is not null (the last layer).  bf16_math selects bf16
// products with f32 accumulation.  Returns the launch's cudaError_t.
extern "C" int tsc_lstm_layer(const void* x, int x_bf16, int batch, int T,
                              int D, int U, const void* w, const void* u,
                              const void* bias, const void* head_w,
                              const void* head_b, int C, void* seq_out,
                              void* logits, int bf16_math, void* stream) {
  if (batch <= 0 || T <= 0 || D <= 0 || U <= 0 || U > 1024 ||
      (logits && C <= 0))
    return cudaErrorInvalidValue;
  const float* fw = static_cast<const float*>(w);
  const float* fu = static_cast<const float*>(u);
  const float* fb = static_cast<const float*>(bias);
  const float* hw = static_cast<const float*>(head_w);
  const float* hb = static_cast<const float*>(head_b);
  float* so = static_cast<float*>(seq_out);
  float* lo = static_cast<float*>(logits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16)
    err = bf16_math
              ? launch<__nv_bfloat16, true>(x, batch, T, D, U, fw, fu, fb, hw, hb, C, so, lo, s)
              : launch<__nv_bfloat16, false>(x, batch, T, D, U, fw, fu, fb, hw, hb, C, so, lo, s);
  else
    err = bf16_math
              ? launch<float, true>(x, batch, T, D, U, fw, fu, fb, hw, hb, C, so, lo, s)
              : launch<float, false>(x, batch, T, D, U, fw, fu, fb, hw, hb, C, so, lo, s);
  return static_cast<int>(err);
}
