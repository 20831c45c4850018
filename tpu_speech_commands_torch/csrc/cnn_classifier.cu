// CNN classifier (SimpleCNN / SimpleCNNLite, features -> logits in one
// launch) and the fused CNN block 1, hand-written for Hopper (sm_90a).
//
// tsc_cnn_classifier replaces the TPU kernel tpu_speech_commands/ops/
// pallas_classifier.py::make_fused_cnn_classifier (pallas_call at :363);
// tsc_cnn_classifier_simt computes the same function by the first design.
// tsc_cnn_block1_simt computes the fused block 1 of tpu_speech_commands/
// ops/pallas_cnn.py::make_fused_conv_block1 (pallas_call at :156) by the
// SIMT stage routine: the first design, kept as the A/B baseline of
// csrc/cnn_block1.cu (tsc_cnn_block1) and for windows whose ring does not
// fit there.  All run on constants lowered on the host
// (ops/cnn_lowering.py):
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
// What bounds it on this card.  simple_cnn at 30 x 20 needs 3.15 MFLOP a
// window (each conv at the positions the VALID pool keeps) against 2.4 KB of
// f32 features read and 20 B of logits written: ~1,300 FLOP per byte, far
// above the ridge, so it is bound by arithmetic: 0.3854 ms of f32 or 0.0261
// ms of bf16 tensor-core work at B = 8192.  The conv weights (130 K values,
// 521 KB in f32) do not fit in a block's shared memory but stay in the 50 MB
// L2; the live activations of a window are ~10 KB in bf16.
//
// tsc_cnn_classifier, the tiled implicit GEMM (the plan, its layout and its
// CPU emulation are ops/cnn_plan.py's).  A block owns a tile of windows (16
// in bf16, 8 in f32 at 30 x 20) whose activations stay in shared memory,
// NHWC in the compute type, in two buffers; no activation goes to device
// memory.  (A window too large for the usual 6 or 3 weight slots beside it
// takes unpadded pixels and 2 slots, so every input shape the SIMT kernel
// took still fits.)  Stage 1 (cin 1, K = 9) runs on the CUDA cores: a thread a pooled
// position's 4 x 4 input patch x 8 channels.  Stages 2-4 and the dense
// layer are products with rows (window, output position, 2 x 2 quad), quad
// fastest, columns cout and depth (tap, cin): a row of A is an input
// pixel's channel run, a padding tap reads a zero row.  Their weights stream
// through a ring of shared-memory slots in K-chunks by cp.async, one stream
// for all four products, so a chunk is read from L2 once a tile (once a
// round where a product's weights take several chunks).  bf16: a warp takes
// a 16 x 16/32/64 tile a round, mma.sync m16n8k16 on ldmatrix fragments
// (the next step's loaded while this step's multiply), the pool a max over
// the quad's lanes by shuffle.  f32: a thread takes 4 rows (a position's
// quads) x 8 or 4 columns in registers, fed by broadcast float4 loads.  The
// epilogue (pool, bias / relu6 or the inline relu, mult, shift, relu6, the
// bf16 rounding at the store) runs on the accumulators; the head (N =
// classes) on the CUDA cores, a warp a window.  The ragged last tile is
// masked.  What it leaves on the table: occupancy (16 warps an SM, 128
// registers a thread), the epilogues' cost (hoisting their row offsets out
// of the column loop saved a fifth of the bf16 time, dev/cnn_ablation.py)
// and wgmma; f32 stays off the tensor cores.
//
// tsc_cnn_classifier_simt, the first design, kept for the A/B: threads
// stride over (window, output position, group of 4 output channels),
// channel groups fastest, a tile of 4 windows a block; a thread keeps the 1
// or 4 pre-pool conv sums of its position for 4 channels in registers and
// reads the (dy, dx, cin, cout) weights through the read-only path, once
// per (window, position) warp.  Each pixel's channels sit at an odd pitch
// in shared memory.  tsc_cnn_block1_simt runs its stage routine.

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

// ---------------------------------------------------------------------------
// tsc_cnn_classifier: the tiled implicit GEMM.  Its layout and work split
// are ops/cnn_plan.py's, handed over as ints (the header, then 9 a product):
// the plan and this code change together.

constexpr int kGemmThreads = 512;
constexpr int kGemmWarps = kGemmThreads / 32;
// weight slots in flight (cnn_plan.RING): the bf16 products compute a slot
// in less time than an L2 read takes, so their ring is deeper.  A window too
// large for that ring beside it takes kFallbackRing slots (cnn_plan.
// FALLBACK_RING).  The depth is a template argument, as the slot modulo
// and cp.async.wait_group's immediate want it (a depth read at run time
// was slower in bf16, PERF.md).
template <typename CT>
__host__ __device__ constexpr int ring_depth() {
  return sizeof(CT) == 2 ? 6 : 3;
}
constexpr int kFallbackRing = 2;
constexpr int kProducts = 4;   // stages 2-4 and the dense layer
constexpr int kPlanHeader = 10;
constexpr int kPlanProduct = 9;

struct Product {
  const void* w;          // (k, n) row-major in the compute type
  const float* bias;      // (n,) folded bias, BatchNorm shift or dense bias
  const float* pre_bias;  // inline relu only
  const float* mult;      // inline relu only
  // the plan's
  int in_pitch, out_pitch, k, kc, chunks, rounds, unit, rows, cols;
  // the geometry: a row of A is an input pixel's run of cin channels; the
  // dense layer reads "pixel" k / cin of its window's last stage output
  int n, cin, h_in, w_in, stride, pad_h, pad_w, w_out, quads, positions;
};

struct GemmArgs {
  Product pr[kProducts];
  StageArgs st1;          // stage 1: w (3, 3, 1, cout), rows tap
  const void* head_w;     // (hidden, classes) in the compute type
  const float* head_b;
  int classes, tile;
  int ring, ring_off, slot_bytes, a_off, b_off, a_wpitch, b_wpitch;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(const void* p, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(const void* p, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the epilogue of one conv sum of column c (before the pool)
__device__ __forceinline__ float epilogue(const Product& P, float acc, int c) {
  if (P.mult)
    return relu6(fmaxf(acc + __ldg(P.pre_bias + c), 0.0f) * __ldg(P.mult + c) +
                 __ldg(P.bias + c));
  return relu6(acc + __ldg(P.bias + c));
}

// The weight stream: every chunk of the four products in order, kDepth - 1
// ahead of the one being read.  A product whose weights are one chunk keeps
// it for all its rounds; one of more chunks streams them again each round.
template <int kDepth>
struct Ring {
  static constexpr int depth = kDepth;  // slots
  char* base;
  int slot_bytes;
  int g;             // steps taken
  int lp, lr, lc;    // the next chunk to load: product, round, chunk
};

template <typename CT, typename R>
__device__ void issue_next(const GemmArgs& a, R& r, int slot) {
  if (r.lp < kProducts) {
    const Product& P = a.pr[r.lp];
    constexpr int kV = 16 / sizeof(CT);  // elements a 16-byte copy
    const int k0 = r.lc * P.kc;
    const int rows = min(P.kc, P.k - k0);
    const int vec = P.n / kV;
    const int pn = P.n + kV;  // the slot's row pitch
    const CT* src = static_cast<const CT*>(P.w) + (size_t)k0 * P.n;
    CT* dst = reinterpret_cast<CT*>(r.base + slot * r.slot_bytes);
    for (int i = threadIdx.x; i < rows * vec; i += kGemmThreads) {
      const int row = i / vec, v = i - row * vec;
      cp_async16(dst + row * pn + v * kV, src + (size_t)row * P.n + v * kV);
    }
    if (++r.lc == P.chunks) {
      r.lc = 0;
      if (P.chunks == 1 || ++r.lr == P.rounds) {
        r.lr = 0;
        ++r.lp;
      }
    }
  }
  cp_async_commit();  // an empty group past the end keeps the count
}

// Wait for the next chunk, issue the one depth - 1 ahead into the slot the
// last step read (every thread is past it after the barrier), return the
// chunk.  The barrier also orders a product's reads after the last one's
// epilogue.  Every thread of the block takes every step.
template <typename CT, typename R>
__device__ const CT* ring_step(const GemmArgs& a, R& r) {
  cp_async_wait<R::depth - 2>();
  __syncthreads();
  issue_next<CT>(a, r, (r.g + R::depth - 1) % R::depth);
  const CT* slot = reinterpret_cast<const CT*>(r.base + (r.g % R::depth) * r.slot_bytes);
  ++r.g;
  return slot;
}

// A row of a product: the offset from the input buffer of its window's
// pixel that tap 0 reads (for the dense layer, of its window), and the taps
// that fall inside the input, bit `tap`; none for a row past the tile's
// last window.  A tap outside reads the zero row instead, whose offset from
// the input buffer the caller passes (the zero row holds the largest cin,
// so a channel offset stays inside it).
struct RowRef {
  int base;
  unsigned taps;
};

__device__ __forceinline__ RowRef row_ref(const Product& P, bool dense, int m,
                                          bool ok, int in_wp) {
  RowRef r = {0, 0u};
  if (!ok) return r;
  const int win = m / P.rows;
  r.base = win * in_wp;
  if (dense) {
    r.taps = 1u;
    return r;
  }
  const int rr = m - win * P.rows;
  const int p = rr / P.quads, q = rr - p * P.quads;
  const int py = p / P.w_out, px = p - py * P.w_out;
  const int cy = P.quads == 4 ? 2 * py + (q >> 1) : py;
  const int cx = P.quads == 4 ? 2 * px + (q & 1) : px;
  const int by = cy * P.stride - P.pad_h, bx = cx * P.stride - P.pad_w;
  r.base += (by * P.w_in + bx) * P.in_pitch;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int iy = by + t / 3, ix = bx + t % 3;
    if (iy >= 0 && iy < P.h_in && ix >= 0 && ix < P.w_in) r.taps |= 1u << t;
  }
  return r;
}

__device__ __forceinline__ int tap_off(const Product& P, bool dense, RowRef r,
                                       int tap, int zero_off) {
  if (dense) return r.taps ? r.base + tap * P.in_pitch : zero_off;
  if (!((r.taps >> tap) & 1u)) return zero_off;
  const int dy = tap / 3;
  return r.base + (dy * P.w_in + tap - 3 * dy) * P.in_pitch;
}

// One 16-deep step of a warp's 16 x WN tile: the A fragment from the rows'
// channel runs, WN / 16 B fragment pairs from the slot; then its mmas.
template <int WN>
__device__ __forceinline__ void load_frags(const __nv_bfloat16* a,
                                           const __nv_bfloat16* b,
                                           uint32_t* af, uint32_t (*bf)[4]) {
  ldmatrix_x4(a, af);
#pragma unroll
  for (int jn = 0; jn < WN / 16; ++jn) ldmatrix_x4_trans(b + 16 * jn, bf[jn]);
}

template <int WN>
__device__ __forceinline__ void mma_frags(float (*acc)[4], const uint32_t* af,
                                          const uint32_t (*bf)[4]) {
#pragma unroll
  for (int jn = 0; jn < WN / 16; ++jn) {
    mma_bf16(acc[2 * jn], af, bf[jn][0], bf[jn][1]);
    mma_bf16(acc[2 * jn + 1], af, bf[jn][2], bf[jn][3]);
  }
}

// bf16 mode: a warp takes a 16 x WN tile of C a round.  A fragments by
// ldmatrix from the rows' channel runs (one 16-byte run a lane), B by
// ldmatrix.trans from the slot; the pool is a max over the quad's four
// rows, held by lanes 4 and 8 apart.
template <int kP, int WN, typename R>
__device__ void product_mma(const GemmArgs& a, R& ring,
                            const __nv_bfloat16* in, int in_wp,
                            __nv_bfloat16* out, int out_wp,
                            const __nv_bfloat16* zero, int nb) {
  using bf16 = __nv_bfloat16;
  const Product& P = a.pr[kP];  // a constant index: read in place
  constexpr bool dense = kP == kProducts - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m_valid = nb * P.rows;
  const int ntiles = P.n / WN;
  const int items = (m_valid + 15) / 16 * ntiles;
  const int pn = P.n + 8;
  const int zero_off = static_cast<int>(zero - in);
  const bf16* a_lane = in + (lane >> 4) * 8;
  const bf16* slot = nullptr;
  if (P.chunks == 1) slot = ring_step<bf16>(a, ring);
#pragma unroll 1
  for (int r = 0; r < P.rounds; ++r) {
    const int item = r * kGemmWarps + warp;
    const bool active = item < items;
    const int mt = active ? item / ntiles : 0;
    const int n0 = active ? (item - mt * ntiles) * WN : 0;
    const int m = mt * 16 + (lane & 15);
    const RowRef row = row_ref(P, dense, m, active && m < m_valid, in_wp);
    float acc[WN / 8][4];
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < P.chunks; ++c) {
      if (P.chunks > 1) slot = ring_step<bf16>(a, ring);
      if (!active) continue;
      const int k0 = c * P.kc;
      const int steps = (min(k0 + P.kc, P.k) - k0) / 16;
      const bf16* brow = slot + ((lane & 7) + ((lane >> 3) & 1) * 8) * pn + n0 +
                         (lane >> 4) * 8;
      int tap = k0 / P.cin, ci = k0 - tap * P.cin;
      const bf16* src = a_lane + tap_off(P, dense, row, tap, zero_off);
      auto next = [&]() {  // the next 16 of K: the tap's next channels
        ci += 16;
        if (ci == P.cin) {
          ci = 0;
          src = a_lane + tap_off(P, dense, row, ++tap, zero_off);
        }
      };
      // the fragments of step s + 1 load while the mmas of step s run
      uint32_t af[2][4], bfr[2][WN / 16][4];
      load_frags<WN>(src + ci, brow, af[0], bfr[0]);
#pragma unroll 1
      for (int st = 0; st < steps; st += 2) {
        next();
        if (st + 1 < steps)
          load_frags<WN>(src + ci, brow + (st + 1) * 16 * pn, af[1], bfr[1]);
        mma_frags<WN>(acc, af[0], bfr[0]);
        if (st + 1 < steps) {
          next();
          if (st + 2 < steps)
            load_frags<WN>(src + ci, brow + (st + 2) * 16 * pn, af[0], bfr[0]);
          mma_frags<WN>(acc, af[1], bfr[1]);
        }
      }
    }
    if (!active) continue;  // warp-uniform: the shuffles below see all lanes
    // the epilogue: with the inline relu before the pool; without it after
    // (the pool commutes with the monotone +bias, relu6, exactly).  A lane
    // holds rows g and g + 8 of the tile: their output pixels first
    const int g = lane >> 2, t = lane & 3;
    bool keep[2];
    int dst[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row_m = mt * 16 + g + 8 * h;
      keep[h] = row_m < m_valid && (P.quads == 1 || (g & 3) == 0);
      const int op = row_m / P.quads;  // the output position over the tile
      const int w = op / P.positions;
      dst[h] = w * out_wp + (op - w * P.positions) * P.out_pitch;
    }
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      const float b0 = __ldg(P.bias + col), b1 = __ldg(P.bias + col + 1);
      float pb0 = 0.0f, pb1 = 0.0f, mu0 = 0.0f, mu1 = 0.0f;
      if (P.mult) {
        pb0 = __ldg(P.pre_bias + col), pb1 = __ldg(P.pre_bias + col + 1);
        mu0 = __ldg(P.mult + col), mu1 = __ldg(P.mult + col + 1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
        if (P.mult) {
          v0 = relu6(fmaxf(v0 + pb0, 0.0f) * mu0 + b0);
          v1 = relu6(fmaxf(v1 + pb1, 0.0f) * mu1 + b1);
        }
        if (P.quads == 4) {  // all lanes shuffle; the quad's first stores
          v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
          v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
          v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 8));
          v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 8));
        }
        if (!P.mult) {
          v0 = relu6(v0 + b0);
          v1 = relu6(v1 + b1);
        }
        if (keep[h])
          *reinterpret_cast<__nv_bfloat162*>(out + dst[h] + col) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// f32 mode: a thread takes RM rows (with a pool, a position's 4 quads;
// without, 1, 2 or 4 rows) x CN columns (CN 8: 4 at 4 cg and 4 at n / 2 +
// 4 cg; CN 4: 4 at 4 cg) a round, on the CUDA cores.  Neighbouring threads
// take neighbouring columns of the same rows, so a warp's row loads are
// broadcasts and its weight loads one run of the slot; per 4 K a float4 of
// each row and CN / 4 float4 weight loads a K feed 4 RM CN FMAs.
template <int kP, int RM, int CN, typename R>
__device__ void product_f32(const GemmArgs& a, R& ring, const float* in,
                            int in_wp, float* out, int out_wp,
                            const float* zero, int nb) {
  constexpr int NG = CN / 4;  // float4 column groups a thread
  const Product& P = a.pr[kP];  // a constant index: read in place
  constexpr bool dense = kP == kProducts - 1;
  const int m_valid = nb * P.rows;
  const int groups = (m_valid + RM - 1) / RM;
  const int cgs = P.n / CN;
  const int items = groups * cgs;
  const int pn = P.n + 4;
  const int zero_off = static_cast<int>(zero - in);
  const float* slot = nullptr;
  if (P.chunks == 1) slot = ring_step<float>(a, ring);
#pragma unroll 1
  for (int r = 0; r < P.rounds; ++r) {
    const int item = r * kGemmThreads + threadIdx.x;
    const bool active = item < items;
    const int cg = item % cgs, rg = item / cgs;
    int c0[NG];  // the first column of each float4 group
#pragma unroll
    for (int g = 0; g < NG; ++g) c0[g] = g * (P.n / 2) + 4 * cg;
    RowRef row[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = RM * rg + i;
      row[i] = row_ref(P, dense, m, active && m < m_valid, in_wp);
    }
    float acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < P.chunks; ++c) {
      if (P.chunks > 1) slot = ring_step<float>(a, ring);
      if (!active) continue;
      const int k0 = c * P.kc, kend = min(k0 + P.kc, P.k);
#pragma unroll 1
      for (int k = k0; k < kend;) {  // a tap's run of channels at a time
        const int tap = k / P.cin, ci = k - tap * P.cin;
        const int run = min(P.cin - ci, kend - k);
        const float* src[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          src[i] = in + tap_off(P, dense, row[i], tap, zero_off) + ci;
        const float* wk = slot + (k - k0) * pn;
#pragma unroll 1
        for (int j = 0; j < run; j += 4) {
          float av[RM][4];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(src[i] + j);
            av[i][0] = v.x, av[i][1] = v.y, av[i][2] = v.z, av[i][3] = v.w;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* wq = wk + (j + q) * pn;
#pragma unroll
            for (int g = 0; g < NG; ++g) {
              const float4 w = *reinterpret_cast<const float4*>(wq + c0[g]);
#pragma unroll
              for (int i = 0; i < RM; ++i) {
                const float v = av[i][q];
                acc[i][4 * g] = fmaf(v, w.x, acc[i][4 * g]);
                acc[i][4 * g + 1] = fmaf(v, w.y, acc[i][4 * g + 1]);
                acc[i][4 * g + 2] = fmaf(v, w.z, acc[i][4 * g + 2]);
                acc[i][4 * g + 3] = fmaf(v, w.w, acc[i][4 * g + 3]);
              }
            }
          }
        }
        k += run;
      }
    }
    if (!active) continue;
    // the epilogue: with the inline relu before the pool; without it after
    // (the pool commutes with the monotone +bias, relu6, exactly)
    const bool pool = RM == 4 && P.quads == 4;
    float v[RM][CN];
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int col = c0[j / 4] + j % 4;
#pragma unroll
      for (int i = 0; i < RM; ++i)
        v[i][j] = P.mult || !pool ? epilogue(P, acc[i][j], col) : acc[i][j];
    }
    bool pooled = false;
    if constexpr (RM == 4) {
      if (pool) {  // the rows are output position rg's quads
        const int w = rg / P.positions, pos = rg - w * P.positions;
        float* o = out + (size_t)w * out_wp + pos * P.out_pitch;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float m[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int jj = 4 * g + j;
            m[j] = fmaxf(fmaxf(v[0][jj], v[1][jj]), fmaxf(v[2][jj], v[3][jj]));
            if (!P.mult) m[j] = epilogue(P, m[j], c0[g] + j);
          }
          *reinterpret_cast<float4*>(o + c0[g]) = make_float4(m[0], m[1], m[2], m[3]);
        }
        pooled = true;
      }
    }
    if (!pooled) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row_m = RM * rg + i;
        if (row_m >= m_valid) continue;
        const int w = row_m / P.positions, pos = row_m - w * P.positions;
        float* o = out + (size_t)w * out_wp + pos * P.out_pitch;
#pragma unroll
        for (int g = 0; g < NG; ++g)
          *reinterpret_cast<float4*>(o + c0[g]) =
              make_float4(v[i][4 * g], v[i][4 * g + 1], v[i][4 * g + 2],
                          v[i][4 * g + 3]);
      }
    }
  }
}

// Stage 1 (cin 1, K = 9, stride 1) on the CUDA cores in both modes: a
// thread takes a pooled position's 2 x 2 conv positions x 8 channels from
// the 4 x 4 input patch they read, held in registers; a tap's 8 weights
// come through the read-only path as one or two 16-byte broadcast loads.
__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  const float4 v = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  w[4] = v.x, w[5] = v.y, w[6] = v.z, w[7] = v.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* w) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t r[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(r[i] << 16);
    w[2 * i + 1] = __uint_as_float(r[i] & 0xffff0000u);
  }
}

template <typename CT>
__device__ void stage1(const GemmArgs& a, const CT* in, CT* out, int nb) {
  const StageArgs& s = a.st1;
  const int positions = s.h_out * s.w_out;
  const int cgs = s.cout / 8;
  const int items = nb * positions * cgs;
  const CT* w = static_cast<const CT*>(s.w);
  Product P = {};
  P.bias = s.bias;
  P.pre_bias = s.pre_bias;
  P.mult = s.mult;
#pragma unroll 1
  for (int it = threadIdx.x; it < items; it += kGemmThreads) {
    const int cg = it % cgs;
    const int rest = it / cgs;
    const int p = rest % positions;
    const int win = rest / positions;
    const int py = p / s.w_out, px = p - py * s.w_out;
    const int y0 = 2 * py - s.pad_h, x0 = 2 * px - s.pad_w;
    const CT* x = in + (size_t)win * a.a_wpitch;
    float patch[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int iy = y0 + r, ix = x0 + c;
        const bool ok = iy >= 0 && iy < s.h_in && ix >= 0 && ix < s.w_in;
        patch[r][c] = ok ? to_float(x[iy * s.w_in + ix]) : 0.0f;
      }
    float acc[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[q][j] = 0.0f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      float wv[8];
      load8(w + tap * s.cout + 8 * cg, wv);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = patch[(q >> 1) + tap / 3][(q & 1) + tap % 3];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[q][j] = fmaf(v, wv[j], acc[q][j]);
      }
    }
    CT* o = out + (size_t)win * a.b_wpitch + p * s.out_cp + 8 * cg;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * cg + j;
      float m = epilogue(P, acc[0][j], c);
#pragma unroll
      for (int q = 1; q < 4; ++q) m = fmaxf(m, epilogue(P, acc[q][j], c));
      store(o + j, m);
    }
  }
}

// Product kP of the chain: stage 2 reads B and writes A, stage 3 A -> B,
// stage 4 B -> A, the dense layer A -> B.
template <int kP, typename CT, typename R>
__device__ __forceinline__ void run_product(const GemmArgs& a, R& ring, CT* A,
                                            CT* B, const CT* zero, int nb) {
  constexpr bool kFromB = kP % 2 == 0;
  const CT* in = kFromB ? B : A;
  CT* out = kFromB ? A : B;
  const int in_wp = kFromB ? a.b_wpitch : a.a_wpitch;
  const int out_wp = kFromB ? a.a_wpitch : a.b_wpitch;
  const int unit = a.pr[kP].unit;
  if constexpr (std::is_same<CT, __nv_bfloat16>::value) {
    if (unit == 64)
      product_mma<kP, 64>(a, ring, in, in_wp, out, out_wp, zero, nb);
    else if (unit == 32)
      product_mma<kP, 32>(a, ring, in, in_wp, out, out_wp, zero, nb);
    else
      product_mma<kP, 16>(a, ring, in, in_wp, out, out_wp, zero, nb);
  } else {
    const bool wide = a.pr[kP].cols == 8;
    if (unit == 4 && wide)
      product_f32<kP, 4, 8>(a, ring, in, in_wp, out, out_wp, zero, nb);
    else if (unit == 4)
      product_f32<kP, 4, 4>(a, ring, in, in_wp, out, out_wp, zero, nb);
    else if (unit == 2 && wide)
      product_f32<kP, 2, 8>(a, ring, in, in_wp, out, out_wp, zero, nb);
    else if (unit == 2)
      product_f32<kP, 2, 4>(a, ring, in, in_wp, out, out_wp, zero, nb);
    else if (wide)
      product_f32<kP, 1, 8>(a, ring, in, in_wp, out, out_wp, zero, nb);
    else
      product_f32<kP, 1, 4>(a, ring, in, in_wp, out, out_wp, zero, nb);
  }
}

template <typename InT, typename CT, int kRing>
__global__ void __launch_bounds__(kGemmThreads, 1)
    cnn_gemm_kernel(const InT* __restrict__ x, int batch,
                    const __grid_constant__ GemmArgs a,
                    float* __restrict__ logits) {
  extern __shared__ __align__(16) char gemm_smem[];
  char* const smem = gemm_smem;
  const CT* const zero = reinterpret_cast<const CT*>(smem);
  CT* const A = reinterpret_cast<CT*>(smem + a.a_off);
  CT* const B = reinterpret_cast<CT*>(smem + a.b_off);
  const int b0 = blockIdx.x * a.tile;
  const int nb = min(a.tile, batch - b0);

  // the first chunks of the weight stream load while stage 1 runs
  Ring<kRing> ring = {smem + a.ring_off, a.slot_bytes, 0, 0, 0, 0};
  for (int i = 0; i < kRing - 1; ++i) issue_next<CT>(a, ring, i);

  for (int i = threadIdx.x; i < a.ring_off / 4; i += kGemmThreads)
    reinterpret_cast<uint32_t*>(smem)[i] = 0u;  // the zero row
  // the tile's input rows are contiguous: a window's pixels a warp at a time
  const int n_in = a.st1.h_in * a.st1.w_in;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int win = warp; win < nb; win += kGemmWarps) {
    const InT* xw = x + (size_t)(b0 + win) * n_in;
    CT* aw = A + (size_t)win * a.a_wpitch;
#pragma unroll 4
    for (int i = lane; i < n_in; i += 32) store(aw + i, to_float(xw[i]));
  }
  __syncthreads();
  stage1<CT>(a, A, B, nb);

  run_product<0>(a, ring, A, B, zero, nb);  // stage 2
  run_product<1>(a, ring, A, B, zero, nb);  // stage 3
  run_product<2>(a, ring, A, B, zero, nb);  // stage 4
  run_product<3>(a, ring, A, B, zero, nb);  // the dense layer
  cp_async_wait<0>();
  __syncthreads();

  // the head on the CUDA cores, from the hidden layer in B: a warp a
  // window, the lanes over the hidden units, a shuffle sum a class
  const int hidden = a.pr[kProducts - 1].n;
  const CT* __restrict__ hw = static_cast<const CT*>(a.head_w);
  for (int w = warp; w < nb; w += kGemmWarps) {
    const CT* hv = B + (size_t)w * a.b_wpitch;
    for (int c = 0; c < a.classes; ++c) {
      float acc = 0.0f;
      for (int k = lane; k < hidden; k += 32)
        acc = fmaf(to_float(hv[k]), load1(hw + (size_t)k * a.classes + c), acc);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, d);
      if (lane == 0)
        logits[(size_t)(b0 + w) * a.classes + c] = acc + __ldg(a.head_b + c);
    }
  }
}

template <typename InT, typename CT>
cudaError_t launch_gemm(const void* x, int batch, const GemmArgs& a,
                        size_t smem, float* logits, cudaStream_t stream) {
  auto kernel = a.ring == kFallbackRing ? cnn_gemm_kernel<InT, CT, kFallbackRing>
                                        : cnn_gemm_kernel<InT, CT, ring_depth<CT>()>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (batch + a.tile - 1) / a.tile;
  kernel<<<blocks, kGemmThreads, smem, stream>>>(static_cast<const InT*>(x),
                                                  batch, a, logits);
  return cudaGetLastError();
}

// The plan's numbers against the stages' shapes; false where the kernel
// would read or write outside what it was given.
bool fill_product(Product& P, const int* ints, int elem, int slot_bytes,
                  bool bf16) {
  P.in_pitch = ints[0];
  P.out_pitch = ints[1];
  P.k = ints[2];
  P.kc = ints[3];
  P.chunks = ints[4];
  P.rounds = ints[5];
  P.unit = ints[6];
  P.rows = ints[7];
  P.cols = ints[8];
  const int vec = 16 / elem;
  const int k_step = bf16 ? 16 : 4;  // an mma's depth; a float4 of each row
  if (P.n < 16 || P.n % 16 || P.cin < 16 || P.cin % 16 || P.k % 16 ||
      P.kc < k_step || P.kc % k_step || P.rounds < 1 ||
      P.chunks != (P.k + P.kc - 1) / P.kc || P.in_pitch < P.cin ||
      P.in_pitch % vec || P.out_pitch < P.n || P.out_pitch % vec ||
      P.rows != P.positions * P.quads ||
      (size_t)P.kc * (P.n + vec) * elem > (size_t)slot_bytes)
    return false;
  if (bf16)
    return (P.unit == 16 || P.unit == 32 || P.unit == 64) && P.n % P.unit == 0;
  // f32: a thread's rows (with a pool, the position's 4 quads) and columns
  return (P.unit == 1 || P.unit == 2 || P.unit == 4) &&
         (P.quads == 1 || P.unit == 4) && (P.cols == 4 || P.cols == 8);
}

}  // namespace

// x (batch, H, W) f32 or bf16.  stage_ptrs holds 4 pointers a stage (w,
// bias, pre_bias, mult; the last two null without the inline relu), and
// stage_dims 8 ints a stage (h_in, w_in, cin, cout, stride, pool, pad_h,
// pad_w), stage 0 with cin 1 and each next stage taking the last one's
// output.  w, dense_w and head_w are f32, or bf16 when bf16_math is set;
// every other constant is f32.  Writes logits (batch, classes) f32.
// Returns the launch's cudaError_t.
extern "C" int tsc_cnn_classifier_simt(const void* x, int x_bf16, int batch,
                                       int n_stages,
                                       const void* const* stage_ptrs,
                                       const int* stage_dims, const void* dense_w,
                                       const void* dense_b, const void* head_w,
                                       const void* head_b, int hidden,
                                       int classes, void* logits, int bf16_math,
                                       void* stream) {
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

// The tiled implicit-GEMM classifier (ops/cnn_plan.py).  x, stage_ptrs and
// stage_dims as for tsc_cnn_classifier_simt, with 4 stages; each stage's w,
// (3, 3, cin, cout) HWIO, is read as the (9 cin, cout) K-major matrix
// (for stages 2-4, whose cin is a multiple of 16, unpadded).  plan holds
// the plan's ints: 10 of the header (tile, ring, ring_off, slot_bytes,
// a_off, b_off, a_wpitch, b_wpitch, smem_bytes, out_pitch1), then 9 for
// each of stages 2-4 and the dense layer (in_pitch, out_pitch, k, kc,
// chunks, rounds, unit, rows, cols); the zero row sits at offset 0.  Returns
// the launch's cudaError_t: cudaErrorInvalidValue where the plan does not
// fit the stages or the card's shared memory.
extern "C" int tsc_cnn_classifier(const void* x, int x_bf16, int batch,
                                  const void* const* stage_ptrs,
                                  const int* stage_dims, const int* plan,
                                  const void* dense_w, const void* dense_b,
                                  const void* head_w, const void* head_b,
                                  int hidden, int classes, void* logits,
                                  int bf16_math, void* stream) {
  if (batch <= 0 || hidden < 16 || classes < 1 || !x || !plan || !dense_w ||
      !dense_b || !head_w || !head_b || !logits)
    return cudaErrorInvalidValue;
  const int elem = bf16_math ? 2 : 4;
  const int deep = bf16_math ? ring_depth<__nv_bfloat16>() : ring_depth<float>();
  StageArgs st[kMaxStages];
  for (int k = 0; k < kMaxStages; ++k) {
    const void* const* p = stage_ptrs + 4 * k;
    if (!fill_stage(st[k], p[0], p[1], p[2], p[3], stage_dims + 8 * k))
      return cudaErrorInvalidValue;
    if (k > 0 && (st[k].h_in != st[k - 1].h_out || st[k].w_in != st[k - 1].w_out ||
                  st[k].cin != st[k - 1].cout))
      return cudaErrorInvalidValue;
  }
  if (st[0].cin != 1 || !st[0].pool || st[0].stride != 1 || st[0].cout % 8)
    return cudaErrorInvalidValue;
  GemmArgs a = {};
  a.tile = plan[0];
  a.ring = plan[1];
  a.ring_off = plan[2];
  a.slot_bytes = plan[3];
  a.a_off = plan[4];
  a.b_off = plan[5];
  a.a_wpitch = plan[6];
  a.b_wpitch = plan[7];
  const int smem = plan[8];
  a.st1 = st[0];
  a.st1.in_cp = 1;
  a.st1.out_cp = plan[9];
  a.head_w = head_w;
  a.head_b = static_cast<const float*>(head_b);
  a.classes = classes;
  for (int k = 0; k < kProducts; ++k) {
    Product& P = a.pr[k];
    if (k < kProducts - 1) {
      const StageArgs& s = st[k + 1];
      P.w = s.w;
      P.bias = s.bias;
      P.pre_bias = s.pre_bias;
      P.mult = s.mult;
      P.n = s.cout;
      P.cin = s.cin;
      P.h_in = s.h_in;
      P.w_in = s.w_in;
      P.stride = s.stride;
      P.pad_h = s.pad_h;
      P.pad_w = s.pad_w;
      P.w_out = s.w_out;
      P.quads = s.pool ? 4 : 1;
      P.positions = s.h_out * s.w_out;
    } else {  // the dense layer: its "pixels" are stage 4's output positions
      const StageArgs& s = st[kMaxStages - 1];
      P.w = dense_w;
      P.bias = static_cast<const float*>(dense_b);
      P.n = hidden;
      P.cin = s.cout;
      P.h_in = s.h_out;
      P.w_in = s.w_out;
      P.w_out = 1;
      P.quads = 1;
      P.positions = 1;
    }
    if (!fill_product(P, plan + kPlanHeader + kPlanProduct * k, elem,
                      a.slot_bytes, bf16_math != 0))
      return cudaErrorInvalidValue;
    const int k_need = k < kProducts - 1 ? 9 * P.cin : P.h_in * P.w_in * P.cin;
    if (P.k != k_need) return cudaErrorInvalidValue;
  }
  // the buffers: A holds the input and stages 2 and 4, B stages 1 and 3 and
  // the hidden layer; both inside the block's shared memory
  const StageArgs& s0 = st[0];
  const int s1_out = s0.h_out * s0.w_out * a.st1.out_cp;
  const int need_a = s0.h_in * s0.w_in > a.pr[0].positions * a.pr[0].out_pitch
                         ? s0.h_in * s0.w_in
                         : a.pr[0].positions * a.pr[0].out_pitch;
  const int need_b = s1_out > a.pr[1].positions * a.pr[1].out_pitch
                         ? s1_out
                         : a.pr[1].positions * a.pr[1].out_pitch;
  if (a.tile < 1 || (a.ring != deep && a.ring != kFallbackRing) ||
      a.st1.out_cp < s0.cout ||
      a.st1.out_cp % (16 / elem) || a.slot_bytes % 16 ||
      a.ring_off % 16 || a.ring_off < a.pr[1].cin * elem ||
      a.ring_off < a.pr[2].cin * elem || a.ring_off < a.pr[0].cin * elem ||
      a.a_off != a.ring_off + a.ring * a.slot_bytes || a.a_off % 16 ||
      a.b_off != a.a_off + a.tile * a.a_wpitch * elem || a.b_off % 16 ||
      smem != a.b_off + a.tile * a.b_wpitch * elem || a.a_wpitch % 8 ||
      a.b_wpitch % 8 || a.a_wpitch < need_a ||
      a.a_wpitch < a.pr[2].positions * a.pr[2].out_pitch ||
      a.b_wpitch < need_b || a.b_wpitch < hidden ||
      a.pr[3].out_pitch != hidden || a.pr[3].in_pitch != a.pr[2].out_pitch ||
      a.pr[0].in_pitch != a.st1.out_cp ||
      a.pr[1].in_pitch != a.pr[0].out_pitch ||
      a.pr[2].in_pitch != a.pr[1].out_pitch)
    return cudaErrorInvalidValue;

  float* out = static_cast<float*>(logits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    err = bf16_math ? launch_gemm<bf16, bf16>(x, batch, a, smem, out, s)
                    : launch_gemm<bf16, float>(x, batch, a, smem, out, s);
  else
    err = bf16_math ? launch_gemm<float, bf16>(x, batch, a, smem, out, s)
                    : launch_gemm<float, float>(x, batch, a, smem, out, s);
  return static_cast<int>(err);
}

// x (batch, H, W) f32 or bf16 -> out (batch, H2, W2, cout) f32 NHWC: the
// conv with BatchNorm folded into w (3, 3, 1, cout) and bias (cout,), then
// the 2x2 pool, +bias and relu6.  dims as for tsc_cnn_classifier; the stage
// must have cin 1 and pool.  w is bf16 when bf16_math is set.  Returns the
// launch's cudaError_t.
extern "C" int tsc_cnn_block1_simt(const void* x, int x_bf16, int batch,
                                   const void* w, const void* bias,
                                   const int* dims, void* out, int bf16_math,
                                   void* stream) {
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
