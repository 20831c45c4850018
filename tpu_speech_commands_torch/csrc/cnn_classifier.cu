// CNN classifier (SimpleCNN / SimpleCNNLite, features -> logits in one
// launch) and the fused CNN block 1, hand-written for Hopper (sm_90a).
//
// tsc_cnn_classifier replaces the TPU kernel tpu_speech_commands/ops/
// pallas_classifier.py::make_fused_cnn_classifier (pallas_call at :363).
// tsc_cnn_block1 replaces tpu_speech_commands/ops/pallas_cnn.py::
// make_fused_conv_block1 (pallas_call at :156).  Both run the same stage
// code, on constants lowered on the host (ops/cnn_lowering.py):
//
//   per stage, 3x3 conv over TF-SAME padding (low side pad_h / pad_w, the
//   extra unit high), stride 1 or 2, then
//     no inline relu:  out = relu6(pool2x2(conv(x, w_folded)) + bias)
//     inline relu:     out = pool2x2(relu6(relu(conv(x, w) + pre_bias)
//                                          * mult + shift))
//   (the pool is optional; VALID, so an odd dimension drops its last row)
//   flat = NHWC (y, x, c) flatten of the last stage
//   logits = relu6(flat @ dense_w + dense_b) @ head_w + head_b
//
// bf16 mode: the weights arrive in bf16 (rounded on the host after BatchNorm
// folding and the separable composition), every conv and dense input
// activation is rounded to bf16 where it is stored, products accumulate in
// f32, and every epilogue constant stays f32 (the TPU kernels' bf16 mode).
// The block-1 kernel rounds its input and weights and writes f32.
//
// What bounds it on this card.  simple_cnn at 30 x 20 costs ~3.83 MFLOP a
// window against 2.4 KB of f32 features read and 20 B of logits written:
// ~1,600 FLOP per byte, far above the ridge, so it is bound by arithmetic.
// The conv weights (130 K values, 521 KB in f32) do not fit in a block's
// shared memory but stay in the 50 MB L2; the live activations of a window
// are ~15 KB.
//
// Design.  The TPU kernel turned each conv into one matrix-unit product
// against a host-built Toeplitz matrix, with frame-major layouts to keep its
// shuffles cheap.  Here a block owns a tile of windows whose activations
// stay in shared memory, NHWC, in two ping-pong buffers; no activation goes
// to device memory.  Per stage, threads stride over (window, output
// position, group of 4 output channels), channel groups fastest: a thread
// keeps the 1 or 4 pre-pool conv sums of its position for 4 channels in
// registers (16 FMAs per 4-wide weight load and 4 activation loads), and
// neighbouring threads read neighbouring weights through the read-only
// path, from the (dy, dx, cin, cout) layout.  Each pixel's channels are
// padded to an odd pitch in shared memory so that the positions a warp reads
// fall in different banks.  The dense layer and the head run in the same
// block; there a thread owns one hidden unit and one slice of the flatten
// for every window of the tile, so each dense weight is read once a block.
// The ragged last tile is masked; no tile multiple of the batch is needed.
// What this design leaves on the table: the conv weights are read from L2
// once per (window, position) warp, and the FMAs run on CUDA cores; an
// implicit-GEMM on the tensor cores with staged weights is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxStages = 4;
constexpr int kThreads = 512;
constexpr int kMaxTile = 16;  // windows a classifier block takes at most
// shared memory a classifier block aims at: 4 windows at 30 x 20.  The
// tile, the thread count, the unrolled channel loop and 2 blocks an SM (at
// most 64 registers a thread) were picked by timing variants on an H100
// (the times are in PERF.md).
constexpr size_t kClassifierSmemTarget = 64 * 1024;
constexpr size_t kBlock1SmemTarget = 32 * 1024;

struct StageArgs {
  const void* w;          // (3, 3, cin, cout) HWIO in the compute type
  const float* bias;      // (cout,) folded bias, or the BatchNorm shift
  const float* pre_bias;  // (cout,) inline relu only: conv bias before it
  const float* mult;      // (cout,) inline relu only: BatchNorm scale after it
  int h_in, w_in, cin, cout, stride, pool, pad_h, pad_w, h_out, w_out;
  int in_cp, out_cp;      // floats from one pixel to the next, in and out
};

struct NetArgs {
  StageArgs st[kMaxStages];
  int n_stages;
  const void* dense_w;    // (flat, hidden) in the compute type
  const float* dense_b;
  const void* head_w;     // (hidden, classes) in the compute type
  const float* head_b;
  int hidden, classes, tile;
  int dense_slices;       // slices of the flatten the dense layer splits into
  int pitch[2];           // floats a window takes in each ping-pong buffer
};

template <bool kRound>
__device__ __forceinline__ float rnd(float v) {
  if (kRound) return __bfloat162float(__float2bfloat16(v));
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// four consecutive weights (16-byte aligned in f32, 8-byte in bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.0f), 6.0f); }

// One conv stage over the nb windows of a tile.  `in` and `out` hold one
// window every in_pitch / out_pitch floats, pixels every in_cp / out_cp.
// NQ = 4 computes the 2x2 pre-pool sums of a pooled position, NQ = 1 one
// conv position.  kRound rounds the stored result to bf16 (it is the next
// stage's input).  The stage's description is taken by value: read through
// a reference to the kernel parameter in the inner loop, it cost block 4
// over a third of its time on an H100.
template <typename WT, int NQ, bool kRound>
__device__ void conv_stage(const StageArgs s, const float* __restrict__ in,
                           int in_pitch, float* __restrict__ out, int out_pitch,
                           int nb) {
  const WT* __restrict__ w = static_cast<const WT*>(s.w);
  const int groups = s.cout >> 2;
  const int n_pos = s.h_out * s.w_out;
  const int items = nb * n_pos * groups;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int g = it % groups;
    const int rest = it / groups;
    const int p = rest % n_pos;
    const int win = rest / n_pos;
    const int oy = p / s.w_out;
    const int ox = p - oy * s.w_out;
    const float* a = in + (size_t)win * in_pitch;
    float acc[NQ][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][j] = 0.0f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * (tap / 3);
      int off[NQ];
      bool any = false;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int cy = NQ == 4 ? 2 * oy + (q >> 1) : oy;
        const int cx = NQ == 4 ? 2 * ox + (q & 1) : ox;
        const int iy = cy * s.stride + dy - s.pad_h;
        const int ix = cx * s.stride + dx - s.pad_w;
        const bool ok = iy >= 0 && iy < s.h_in && ix >= 0 && ix < s.w_in;
        off[q] = ok ? (iy * s.w_in + ix) * s.in_cp : -1;
        any |= ok;
      }
      if (!any) continue;
      const WT* wt = w + (size_t)tap * s.cin * s.cout + 4 * g;
#pragma unroll 4
      for (int ci = 0; ci < s.cin; ++ci) {
        const float4 wv = load4(wt + (size_t)ci * s.cout);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float v = off[q] >= 0 ? a[off[q] + ci] : 0.0f;
          acc[q][0] = fmaf(v, wv.x, acc[q][0]);
          acc[q][1] = fmaf(v, wv.y, acc[q][1]);
          acc[q][2] = fmaf(v, wv.z, acc[q][2]);
          acc[q][3] = fmaf(v, wv.w, acc[q][3]);
        }
      }
    }
    float* o = out + (size_t)win * out_pitch + (size_t)p * s.out_cp + 4 * g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * g + j;
      float m;
      if (s.mult) {  // relu, BatchNorm and relu6 before the pool
        const float pb = __ldg(s.pre_bias + c), mu = __ldg(s.mult + c),
                    sh = __ldg(s.bias + c);
        m = relu6(fmaxf(acc[0][j] + pb, 0.0f) * mu + sh);
#pragma unroll
        for (int q = 1; q < NQ; ++q)
          m = fmaxf(m, relu6(fmaxf(acc[q][j] + pb, 0.0f) * mu + sh));
      } else {  // the pool commutes with the monotone +bias, relu6
        m = acc[0][j];
#pragma unroll
        for (int q = 1; q < NQ; ++q) m = fmaxf(m, acc[q][j]);
        m = relu6(m + __ldg(s.bias + c));
      }
      o[j] = rnd<kRound>(m);
    }
  }
}

template <typename InT, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
    cnn_classifier_kernel(const InT* __restrict__ x, int batch,
                          const __grid_constant__ NetArgs net,
                          float* __restrict__ logits) {
  using WT = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  extern __shared__ float smem[];
  float* const buf1 = smem + (size_t)net.tile * net.pitch[0];
  const int b0 = blockIdx.x * net.tile;
  const int nb = min(net.tile, batch - b0);

  const int n_in = net.st[0].h_in * net.st[0].w_in;  // one input channel
  const InT* xt = x + (size_t)b0 * n_in;  // the tile's rows are contiguous
  for (int i = threadIdx.x; i < nb * n_in; i += blockDim.x) {
    const int win = i / n_in;
    smem[(size_t)win * net.pitch[0] + (i - win * n_in)] = rnd<kBf16>(to_float(xt[i]));
  }
  __syncthreads();

  // stage k reads buffer k % 2 and writes the other one
  float* in = smem;
  float* out = buf1;
  int in_pitch = net.pitch[0], out_pitch = net.pitch[1];
  for (int k = 0; k < net.n_stages; ++k) {
    const StageArgs& s = net.st[k];
    if (s.pool)
      conv_stage<WT, 4, kBf16>(s, in, in_pitch, out, out_pitch, nb);
    else
      conv_stage<WT, 1, kBf16>(s, in, in_pitch, out, out_pitch, nb);
    __syncthreads();
    float* const t = in;
    in = out;
    out = t;
    const int tp = in_pitch;
    in_pitch = out_pitch;
    out_pitch = tp;
  }

  // dense + relu6 over the (y, x, c) flatten.  Thread (slice, h) reads each
  // of its weights once for all windows of the tile, over one slice of the
  // flatten (the dense weights are the largest read after block 4's); the
  // slices' partial sums meet in the free buffer, which then holds the
  // hidden layer.
  const StageArgs& sl = net.st[net.n_stages - 1];
  const int flat = sl.h_out * sl.w_out * sl.cout;
  const int slices = net.dense_slices;
  const WT* __restrict__ dw = static_cast<const WT*>(net.dense_w);
  for (int it = threadIdx.x; it < slices * net.hidden; it += blockDim.x) {
    const int h = it % net.hidden;
    const int slice = it / net.hidden;
    const int f0 = flat * slice / slices, f1 = flat * (slice + 1) / slices;
    float acc[kMaxTile];
#pragma unroll
    for (int w = 0; w < kMaxTile; ++w) acc[w] = 0.0f;
    int pix = f0 / sl.cout, c = f0 - pix * sl.cout;
    for (int f = f0; f < f1; ++f) {
      const float wv = load1(dw + (size_t)f * net.hidden + h);
      const float* ap = in + pix * sl.out_cp + c;
#pragma unroll
      for (int w = 0; w < kMaxTile; ++w)
        if (w < nb) acc[w] = fmaf(ap[(size_t)w * in_pitch], wv, acc[w]);
      if (++c == sl.cout) {
        c = 0;
        ++pix;
      }
    }
#pragma unroll
    for (int w = 0; w < kMaxTile; ++w)
      if (w < nb) out[((size_t)slice * net.tile + w) * net.hidden + h] = acc[w];
  }
  __syncthreads();
  for (int it = threadIdx.x; it < nb * net.hidden; it += blockDim.x) {
    const int w = it / net.hidden;
    const int h = it - w * net.hidden;
    float v = 0.0f;
    for (int slice = 0; slice < slices; ++slice)
      v += out[((size_t)slice * net.tile + w) * net.hidden + h];
    out[(size_t)w * net.hidden + h] = rnd<kBf16>(relu6(v + __ldg(net.dense_b + h)));
  }
  __syncthreads();

  const WT* __restrict__ hw = static_cast<const WT*>(net.head_w);
  for (int it = threadIdx.x; it < nb * net.classes; it += blockDim.x) {
    const int w = it / net.classes;
    const int c = it - w * net.classes;
    const float* hv = out + (size_t)w * net.hidden;
    float acc = 0.0f;
    for (int k = 0; k < net.hidden; ++k)
      acc = fmaf(hv[k], load1(hw + (size_t)k * net.classes + c), acc);
    logits[(size_t)(b0 + w) * net.classes + c] = acc + __ldg(net.head_b + c);
  }
}

template <typename InT, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    cnn_block1_kernel(const InT* __restrict__ x, int batch,
                      const __grid_constant__ StageArgs s, int tile,
                      float* __restrict__ out) {
  using WT = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * tile;
  const int nb = min(tile, batch - b0);
  const int n_in = s.h_in * s.w_in;
  const InT* xt = x + (size_t)b0 * n_in;
  for (int i = threadIdx.x; i < nb * n_in; i += blockDim.x)
    smem[i] = rnd<kBf16>(to_float(xt[i]));
  __syncthreads();
  const int n_out = s.h_out * s.w_out * s.cout;
  conv_stage<WT, 4, false>(s, smem, n_in, out + (size_t)b0 * n_out, n_out, nb);
}

// Floats from one pixel to the next in shared memory: an odd pitch, so the
// pixels that one warp reads at a stride of 2 sit in different banks.
int smem_pitch(int c) { return c == 1 ? 1 : c + 1; }

// dims: h_in, w_in, cin, cout, stride, pool, pad_h, pad_w
bool fill_stage(StageArgs& s, const void* w, const void* bias,
                const void* pre_bias, const void* mult, const int* dims) {
  s.w = w;
  s.bias = static_cast<const float*>(bias);
  s.pre_bias = static_cast<const float*>(pre_bias);
  s.mult = static_cast<const float*>(mult);
  s.h_in = dims[0];
  s.w_in = dims[1];
  s.cin = dims[2];
  s.cout = dims[3];
  s.stride = dims[4];
  s.pool = dims[5];
  s.pad_h = dims[6];
  s.pad_w = dims[7];
  if (!w || !bias || (!pre_bias) != (!mult)) return false;
  if (s.h_in < 1 || s.w_in < 1 || s.cin < 1 || s.cout < 4 || s.cout % 4 ||
      (s.stride != 1 && s.stride != 2) || (s.pool != 0 && s.pool != 1) ||
      s.pad_h < 0 || s.pad_h > 2 || s.pad_w < 0 || s.pad_w > 2)
    return false;
  const int hc = (s.h_in + s.stride - 1) / s.stride;
  const int wc = (s.w_in + s.stride - 1) / s.stride;
  s.h_out = s.pool ? hc / 2 : hc;
  s.w_out = s.pool ? wc / 2 : wc;
  return s.h_out >= 1 && s.w_out >= 1;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename InT, bool kBf16>
cudaError_t launch_classifier(const void* x, int batch, const NetArgs& net,
                              float* logits, cudaStream_t stream) {
  const size_t smem = (size_t)net.tile * (net.pitch[0] + net.pitch[1]) * sizeof(float);
  auto kernel = cnn_classifier_kernel<InT, kBf16>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (batch + net.tile - 1) / net.tile;
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const InT*>(x), batch,
                                              net, logits);
  return cudaGetLastError();
}

template <typename InT, bool kBf16>
cudaError_t launch_block1(const void* x, int batch, const StageArgs& s,
                          float* out, cudaStream_t stream) {
  const size_t per_window = (size_t)s.h_in * s.w_in * sizeof(float);
  int tile = (int)(kBlock1SmemTarget / per_window);
  tile = tile < 1 ? 1 : (tile > 32 ? 32 : tile);
  const size_t smem = (size_t)tile * per_window;
  auto kernel = cnn_block1_kernel<InT, kBf16>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (batch + tile - 1) / tile;
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const InT*>(x), batch,
                                              s, tile, out);
  return cudaGetLastError();
}

}  // namespace

// x (batch, H, W) f32 or bf16.  stage_ptrs holds 4 pointers a stage (w,
// bias, pre_bias, mult; the last two null without the inline relu), and
// stage_dims 8 ints a stage (h_in, w_in, cin, cout, stride, pool, pad_h,
// pad_w), stage 0 with cin 1 and each next stage taking the last one's
// output.  w, dense_w and head_w are f32, or bf16 when bf16_math is set;
// every other constant is f32.  Writes logits (batch, classes) f32.
// Returns the launch's cudaError_t.
extern "C" int tsc_cnn_classifier(const void* x, int x_bf16, int batch,
                                  int n_stages, const void* const* stage_ptrs,
                                  const int* stage_dims, const void* dense_w,
                                  const void* dense_b, const void* head_w,
                                  const void* head_b, int hidden, int classes,
                                  void* logits, int bf16_math, void* stream) {
  if (batch <= 0 || n_stages < 1 || n_stages > kMaxStages || hidden < 1 ||
      classes < 1 || !x || !dense_w || !dense_b || !head_w || !head_b || !logits)
    return cudaErrorInvalidValue;
  NetArgs net = {};
  net.n_stages = n_stages;
  int sizes[2] = {0, 0};
  for (int k = 0; k < n_stages; ++k) {
    StageArgs& s = net.st[k];
    const void* const* p = stage_ptrs + 4 * k;
    if (!fill_stage(s, p[0], p[1], p[2], p[3], stage_dims + 8 * k))
      return cudaErrorInvalidValue;
    if (k == 0) {
      if (s.cin != 1) return cudaErrorInvalidValue;
      s.in_cp = 1;
      sizes[0] = s.h_in * s.w_in;
    } else {
      const StageArgs& prev = net.st[k - 1];
      if (s.h_in != prev.h_out || s.w_in != prev.w_out || s.cin != prev.cout)
        return cudaErrorInvalidValue;
      s.in_cp = prev.out_cp;
    }
    s.out_cp = smem_pitch(s.cout);
    int& size = sizes[(k + 1) & 1];
    const int need = s.h_out * s.w_out * s.out_cp;
    size = need > size ? need : size;
  }
  // the dense layer's partial sums: dense_slices x tile x hidden floats
  net.dense_slices = kThreads / hidden > 1 ? kThreads / hidden : 1;
  int& hidden_size = sizes[(n_stages & 1) ^ 1];
  const int partials = net.dense_slices * hidden;
  hidden_size = partials > hidden_size ? partials : hidden_size;
  net.dense_w = dense_w;
  net.dense_b = static_cast<const float*>(dense_b);
  net.head_w = head_w;
  net.head_b = static_cast<const float*>(head_b);
  net.hidden = hidden;
  net.classes = classes;
  net.pitch[0] = sizes[0];
  net.pitch[1] = sizes[1];
  const size_t per_window = (size_t)(sizes[0] + sizes[1]) * sizeof(float);
  int tile = (int)(kClassifierSmemTarget / per_window);
  net.tile = tile < 1 ? 1 : (tile > kMaxTile ? kMaxTile : tile);

  float* out = static_cast<float*>(logits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16)
    err = bf16_math ? launch_classifier<__nv_bfloat16, true>(x, batch, net, out, s)
                    : launch_classifier<__nv_bfloat16, false>(x, batch, net, out, s);
  else
    err = bf16_math ? launch_classifier<float, true>(x, batch, net, out, s)
                    : launch_classifier<float, false>(x, batch, net, out, s);
  return static_cast<int>(err);
}

// x (batch, H, W) f32 or bf16 -> out (batch, H2, W2, cout) f32 NHWC: the
// conv with BatchNorm folded into w (3, 3, 1, cout) and bias (cout,), then
// the 2x2 pool, +bias and relu6.  dims as for tsc_cnn_classifier; the stage
// must have cin 1 and pool.  w is bf16 when bf16_math is set.  Returns the
// launch's cudaError_t.
extern "C" int tsc_cnn_block1(const void* x, int x_bf16, int batch,
                              const void* w, const void* bias, const int* dims,
                              void* out, int bf16_math, void* stream) {
  if (batch <= 0 || !x || !out) return cudaErrorInvalidValue;
  StageArgs st = {};
  if (!fill_stage(st, w, bias, nullptr, nullptr, dims) || st.cin != 1 || !st.pool)
    return cudaErrorInvalidValue;
  st.in_cp = 1;
  st.out_cp = st.cout;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16)
    err = bf16_math ? launch_block1<__nv_bfloat16, true>(x, batch, st, o, s)
                    : launch_block1<__nv_bfloat16, false>(x, batch, st, o, s);
  else
    err = bf16_math ? launch_block1<float, true>(x, batch, st, o, s)
                    : launch_block1<float, false>(x, batch, st, o, s);
  return static_cast<int>(err);
}
