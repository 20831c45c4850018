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
// n_fft 1024, hop 512, 30 frames) a window is 64 KB of f32 audio read once
// and 2.4 KB of features written; the work a frame needs is a real-input
// FFT (2.5 n_fft log2 n_fft = 25.6 kFLOP), 2 x 927 FLOP of packed
// filterbank and a 20 x 20 DCT: about 14 FLOP per f32 byte read, under the
// H100's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte).  So the
// function is bound by the audio read (0.16 ms for 8192 f32 windows).  A
// kernel meets that only if its SM work hides behind the read.  This one
// does not: it is bound on the SM, by its instruction slots and shared-memory
// wavefronts a frame (about 0.68 ms for 8192 windows on an H100; the stage
// cuts put a quarter of it in the audio read, a third in the FFT, a quarter
// in the filterbank, PERF.md).  What the design does about it: the FFT
// keeps a frame in registers and moves it through shared memory twice, at
// the least wavefronts an access; it transforms n_fft / 2 complex points,
// not n_fft; the filterbank touches only the nonzero weights.
//
// Two bodies, chosen from the config (ops/frontend_kernel.py::fft_body).
//
// The register body, n_fft 128 .. 4096 (template N = n_fft / 2).  The plan
// is ops/fft_plan.py's, which builds its tables; tests/test_torch_fft_plan.py
// emulates it in numpy.  One block a window, 8 warps; a frame is held by L
// = N / V lanes of one warp (several frames a warp below N = 512), V =
// max(16, N / 32) complex values a lane, in registers:
// - a real frame is the N-point complex sequence z[n] = x[2n] + i x[2n+1],
//   read from device memory as one 8-byte (f32) or 4-byte (int16) load a
//   pair, lanes on consecutive pairs, with no window test where the lane's
//   last pair lies inside the window; a frame start or row pitch that is
//   not aligned for the pair load takes two scalar loads instead;
// - the complex FFT runs as Stockham passes of radix 16, 16 and N / 256
//   (16 and N / 16 for N <= 256): each pass reads its inputs at stride N /
//   R in natural order, multiplies by the inter-pass twiddles (float64-built
//   tables, staged once a block in shared memory), runs a DFT-R in
//   registers and writes its outputs once: two exchanges through a per-frame
//   buffer of N float2 (4 KB at n_fft 1024), not ten, and no bit-reversed
//   scatter.  The exchange before a pass is XOR-swizzled (float2 slot i ^
//   ((i >> 4) & 15)), the one after the last pass linear, so that the
//   strided writes, the natural-order reads and the untangle's reversed
//   reads all take the least wavefronts (ops/fft_plan.py, checked there);
// - the untangle: one lane takes the bins k and N - k of a pair (k < N/2),
//   X[k] = E + W^k O and X[N - k] = conj(E - W^k O), from Z[k] and
//   Z[N - k], and writes both powers and its part of the energy;
// - the packed filterbank (only its 927 nonzero weights at n_fft 1024):
//   each lane steps through one run of consecutive packed weights against
//   their bins, writing a partial sum where a filter ends (the segments of
//   fft_plan.filterbank_plan), and lane m adds filter m's partial sums in
//   order: no dense 20 x 513 loop, no atomics;
// - log and DCT per frame into the block's (T, n_mfcc) coefficients in
//   shared memory; deltas and a coalesced store once the window is done.
// Shared memory at n_fft 1024 is 49,648 bytes (ops/fft_plan.py::fft_layout
// mirrors smem_layout below): with the launch bounds' 64 registers, 4
// blocks, 32 warps an SM.  The dynamic shared-memory attribute is set once
// an instantiation and device.
//
// The radix-2 body, every other power of two and every config whose
// register-body shared memory exceeds a block's (and, through the entry's
// `radix2` argument, any of them: the A/B of the two): one warp a frame,
// the frame loaded bit-reversed into a per-warp shared buffer of n_fft
// float2, an in-place radix-2 DIT FFT with __syncwarp between stages, the
// dense filterbank.  It is the design the register body replaced.
//
// A compile-time STOP cuts the register body after one stage for the
// stage-omission profile (ops/omission_kernel.py, the counterpart of
// tools/dev/r3_omission.py; n_fft 1024 only): load (every sample of the
// window read), framing (the frame loads), power (the FFT, the untangle and
// the power row), mel (the filterbank, before its log), log, full (the
// DCT).  A cut then sums its per-frame row over the window's frames into a
// (B, 128) f32 output instead of the deltas and the store, in the CT split
// kernel's lane order (csrc/ct_frontend.cu), so that both kernels' cuts
// compute one function.  The shipped kernel takes the default, kShipped,
// and every cut is an `if constexpr`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float64 eps, the reference's safe_log clamp; a normal float32 value
constexpr float kLogEps = 2.220446049250313e-16f;
constexpr int kThreads = 256;   // 8 warps a block, one window
constexpr int kMaxDevices = 64;

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

// two adjacent samples, 8 (f32) or 4 (int16) bytes aligned
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_pair(const int16_t* p) {
  const short2 s = __ldg(reinterpret_cast<const short2*>(p));
  return make_float2(static_cast<float>(s.x), static_cast<float>(s.y));
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

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// The (T, n_mfcc) coefficients of a window to the output: deltas
// c[t] - c[t-1] after them (zero for the first frame) when emit_deltas.
template <typename OutT>
__device__ __forceinline__ void store_window(const float* feats, int n_features,
                                             int n_mfcc, int emit_deltas,
                                             OutT* dst) {
  const int n_out = emit_deltas ? 2 * n_mfcc : n_mfcc;
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

// ---------------------------------------------------------------------------
// The register body

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

// The plan of N complex points (ops/fft_plan.py::fft_plan).
template <int N>
struct Plan {
  static constexpr int kV = N / 32 > 16 ? N / 32 : 16;  // values a lane
  static constexpr int kL = N / kV;                     // lanes a frame
  static constexpr int kFpw = kL < 32 ? 32 / kL : 1;    // frames a warp
  static constexpr int kPitch = N + (kL < 16 ? kL : 0);  // float2 a frame slot
  static constexpr int kR2 = N / 16 < 16 ? N / 16 : 16;  // pass 1's radix
  static constexpr int kR3 = N > 256 ? N / 256 : 1;      // pass 2's (1: none)
  static constexpr int kTw3 = (kR2 - 1) * 16;            // pass 2's twiddle row
  static constexpr int kTwU = kTw3 + (kR3 > 1 ? (kR3 - 1) * 256 : 0);  // untangle
  static constexpr int kNtw = kTwU + N / 2 + 1;
  static constexpr int kMinBlocks = kV == 16 ? 4 : (kV == 32 ? 2 : 1);
  static_assert(N >= 64 && N <= 2048 && (N & (N - 1)) == 0, "N = 64 .. 2048");
};

// the float2 slot of point i in a swizzled exchange
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 15); }

struct FftArgs {
  const void* audio;
  const float* gain;
  float in_scale;
  int n_samples, window, hop, first_frame, n_features;
  int vec_rows;  // rows start aligned for a pair load and have even pitch
  const float2* twiddle;  // Plan<N>::kNtw rows
  const float* packed;    // n_packed weights
  const int* table;       // lane_seg (L + 1), filt_seg (n_filt + 1), segments
  const float* dct_t;     // (n_filt, n_filt)
  int n_packed, n_seg, n_filt, n_mfcc, emit_deltas;
  void* out;
  int src_mod;  // a cut's constant block: window b reads row b % src_mod
};

// Shared memory, region by region, each 16-byte aligned (mirrored by
// ops/fft_plan.py::fft_layout): the twiddles, the packed weights, the
// filterbank table, the DCT, one buffer of kPitch float2 a frame slot, one
// scratch row a slot (its partial sums, then n_filt + 1 log-mel values),
// and the window's (n_features, n_mfcc) coefficients.
struct SmemLayout {
  size_t twiddle, packed, table, dct, frames, scratch, feats, total;
};

template <int N>
__host__ __device__ SmemLayout smem_layout(int n_warps, int n_packed, int n_seg,
                                           int n_filt, int n_mfcc, int n_features) {
  using P = Plan<N>;
  const size_t slots = static_cast<size_t>(n_warps) * P::kFpw;
  SmemLayout s;
  s.twiddle = 0;
  s.packed = s.twiddle + align16(sizeof(float2) * P::kNtw);
  s.table = s.packed + align16(sizeof(float) * n_packed);
  s.dct = s.table + align16(sizeof(int) * (P::kL + 1 + n_filt + 1 + 3 * n_seg));
  s.frames = s.dct + align16(sizeof(float) * n_filt * n_filt);
  s.scratch = s.frames + align16(sizeof(float2) * slots * P::kPitch);
  s.feats = s.scratch + align16(sizeof(float) * slots * (n_seg + n_filt + 1));
  s.total = s.feats + align16(sizeof(float) * n_features * n_mfcc);
  return s;
}

// One Stockham pass of radix R after a pass of stride NS: each of the lane's
// butterflies j = l + L b reads z[j + r N / R] (the swizzled exchange the
// pass before wrote), multiplies input r by W_{NS R}^{r (j mod NS)} (row
// (r - 1) NS + j mod NS of `tw`), runs a DFT-R and writes output s to
// (j - c) R + c + s NS, swizzled unless LAST.  Every read comes before any
// write: the frame lives in registers in between.
template <int N, int R, int NS, bool LAST>
__device__ __forceinline__ void fft_pass(float2* buf, float2 (&v)[Plan<N>::kV],
                                         const float2* tw, int l) {
  constexpr int V = Plan<N>::kV, L = Plan<N>::kL, NB = V / R;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) v[b * R + r] = buf[swz(l + L * b + r * (N / R))];
  __syncwarp();
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = l + L * b;
    const int c = j & (NS - 1);
    float2 u[R];
    u[0] = v[b * R];
#pragma unroll
    for (int r = 1; r < R; ++r) u[r] = cmul(v[b * R + r], tw[(r - 1) * NS + c]);
    Dft<R>::run(u);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int o = (j - c) * R + c + s * NS;
      buf[LAST ? o : swz(o)] = u[s];
    }
  }
  __syncwarp();
}

template <typename InT, typename OutT, int N, int STOP = kShipped>
__global__ void __launch_bounds__(kThreads, Plan<N>::kMinBlocks)
    fft_frontend_kernel(FftArgs a) {
  using P = Plan<N>;
  constexpr int V = P::kV, L = P::kL;
  extern __shared__ float4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  const int n_warps = blockDim.x >> 5;
  const SmemLayout lay = smem_layout<N>(n_warps, a.n_packed, a.n_seg, a.n_filt,
                                        a.n_mfcc, a.n_features);
  float2* s_tw = reinterpret_cast<float2*>(base + lay.twiddle);
  float* s_w = reinterpret_cast<float*>(base + lay.packed);
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
  for (int i = threadIdx.x; i < P::kNtw; i += blockDim.x) s_tw[i] = __ldg(a.twiddle + i);
  for (int i = threadIdx.x; i < a.n_packed; i += blockDim.x) s_w[i] = __ldg(a.packed + i);
  const int table_len = L + 1 + a.n_filt + 1 + 3 * a.n_seg;
  for (int i = threadIdx.x; i < table_len; i += blockDim.x) s_table[i] = __ldg(a.table + i);
  for (int i = threadIdx.x; i < a.n_filt * a.n_filt; i += blockDim.x)
    s_dct[i] = __ldg(a.dct_t + i);
  __syncthreads();
  const int* lane_seg = s_table;
  const int* filt_seg = s_table + L + 1;
  const int* segs = filt_seg + a.n_filt + 1;

  const int l = lane & (L - 1);  // the lane in its frame
  const int slot = warp * P::kFpw + lane / L;
  const int n_slots = n_warps * P::kFpw;
  float2* buf = s_frames + (size_t)slot * P::kPitch;
  float* prow = reinterpret_cast<float*>(buf);  // the power row, after the FFT
  float* partial = s_scratch + (size_t)slot * (a.n_seg + a.n_filt + 1);
  float* mel = partial + a.n_seg;
  const int w_eff = min(a.window, 2 * N);

  // a cut's per-frame rows summed over the slot's frames, slot k at lane
  // lane + 32 k (framing: see there); a slot past the last frame adds none
  float fold[kLanes / 32] = {0.0f, 0.0f, 0.0f, 0.0f};
  // the slots of a warp run the same rounds, so that every __syncwarp sees
  // all 32 lanes; a slot past the last frame computes on zeros, stores nothing
  for (int f0 = 0; f0 < a.n_features; f0 += n_slots) {
    const int f = f0 + slot;
    const bool active = f < a.n_features;
    const long long start = (long long)(a.first_frame + (active ? f : 0)) * a.hop;
    const InT* frame = row + start;
    const bool vec = a.vec_rows && (start & 1) == 0;

    // pass 0: z[j + 16 r] ... straight from the audio, a DFT-16, swizzled
    // writes; the lane's pairs take unguarded pair loads where its last one
    // lies inside the window (every pair at the default config)
    float2 v[V];
    if (active && vec && 2 * (l + L * (V / 16 - 1) + 15 * (N / 16)) + 1 < w_eff) {
#pragma unroll
      for (int b = 0; b < V / 16; ++b)
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float2 x = load_pair(frame + 2 * (l + L * b + r * (N / 16)));
          v[b * 16 + r] = make_float2(x.x * scale, x.y * scale);
        }
    } else {
#pragma unroll
      for (int b = 0; b < V / 16; ++b)
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const int m = 2 * (l + L * b + r * (N / 16));
          float2 x = make_float2(0.0f, 0.0f);
          if (active) {
            if (vec && m + 1 < w_eff) {
              x = load_pair(frame + m);
            } else {
              if (m < w_eff) x.x = load_sample(frame + m);
              if (m + 1 < w_eff) x.y = load_sample(frame + m + 1);
            }
          }
          v[b * 16 + r] = make_float2(x.x * scale, x.y * scale);
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
    for (int b = 0; b < V / 16; ++b) {
      float2 u[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) u[r] = v[b * 16 + r];
      Dft<16>::run(u);
      const int j = l + L * b;
#pragma unroll
      for (int s = 0; s < 16; ++s) buf[swz(j * 16 + s)] = u[s];
    }
    __syncwarp();
    fft_pass<N, P::kR2, 16, P::kR3 == 1>(buf, v, s_tw, l);
    if constexpr (P::kR3 > 1) fft_pass<N, P::kR3, 256, true>(buf, v, s_tw + P::kTw3, l);

    // the untangle: lane l takes the pairs k = l + L i, i < V / 2, and lane
    // 0 also k = N / 2; X[k] = E + W^k O, X[N - k] = conj(E - W^k O) with
    // E = (Z[k] + conj Z[N-k]) / 2, O = -i (Z[k] - conj Z[N-k]) / 2
    float2 za[V / 2], zb[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const int k = l + L * i;
      za[i] = buf[k];
      zb[i] = buf[(N - k) & (N - 1)];
    }
    const float2 zm = buf[N / 2];
    __syncwarp();
    const float inv_fft = 1.0f / static_cast<float>(2 * N);
    const float2* tw_u = s_tw + P::kTwU;
    float energy = 0.0f, xnyq = 0.0f;
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const int k = l + L * i;
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
    for (int off = L / 2; off > 0; off >>= 1)
      energy += __shfl_xor_sync(0xffffffffu, energy, off);
    __syncwarp();

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
    __syncwarp();
    for (int m = l; m < a.n_filt; m += L) {
      float acc = 0.0f;
      for (int s = filt_seg[m]; s < filt_seg[m + 1]; ++s) acc += partial[s];
      mel[m] = STOP == kMel ? acc : safe_log(acc);
    }
    __syncwarp();
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
        y = safe_log(energy);
      } else {
        y = 0.0f;
        for (int m = 0; m < a.n_filt; ++m) y += mel[m] * s_dct[m * a.n_filt + c];
      }
      if (active) feats[f * a.n_mfcc + c] = y;
    }
    __syncwarp();  // the next frame reuses mel
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
  store_window(feats, a.n_features, a.n_mfcc, a.emit_deltas,
               static_cast<OutT*>(a.out) + (size_t)blockIdx.x * a.n_features *
                                               (a.emit_deltas ? 2 : 1) * a.n_mfcc);
}

// 8 warps unless the frame buffers do not fit the card's opt-in shared
// memory; then 4, 2, 1.
template <typename InT, typename OutT, int N, int STOP = kShipped>
cudaError_t launch_fft(const FftArgs& a, int batch, cudaStream_t stream) {
  static int limit[kMaxDevices] = {};
  auto kernel = fft_frontend_kernel<InT, OutT, N, STOP>;
  int n_warps = kThreads / 32;
  SmemLayout lay;
  cudaError_t err;
  for (;; n_warps >>= 1) {
    lay = smem_layout<N>(n_warps, a.n_packed, a.n_seg, a.n_filt, a.n_mfcc,
                         a.n_features);
    err = opt_in(kernel, limit, lay.total);
    if (err != cudaErrorInvalidValue || n_warps == 1) break;
  }
  if (err != cudaSuccess) return err;
  kernel<<<batch, n_warps * 32, lay.total, stream>>>(a);
  return cudaGetLastError();
}

template <typename InT, typename OutT>
cudaError_t launch_fft_n(int n_fft, const FftArgs& a, int batch, cudaStream_t s) {
  switch (n_fft) {
    case 128: return launch_fft<InT, OutT, 64>(a, batch, s);
    case 256: return launch_fft<InT, OutT, 128>(a, batch, s);
    case 512: return launch_fft<InT, OutT, 256>(a, batch, s);
    case 1024: return launch_fft<InT, OutT, 512>(a, batch, s);
    case 2048: return launch_fft<InT, OutT, 1024>(a, batch, s);
    case 4096: return launch_fft<InT, OutT, 2048>(a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename InT>
cudaError_t launch_cut(int stop, const FftArgs& a, int batch, cudaStream_t s) {
  switch (stop) {
    case kLoad: return launch_fft<InT, float, 512, kLoad>(a, batch, s);
    case kFraming: return launch_fft<InT, float, 512, kFraming>(a, batch, s);
    case kPower: return launch_fft<InT, float, 512, kPower>(a, batch, s);
    case kMel: return launch_fft<InT, float, 512, kMel>(a, batch, s);
    case kLog: return launch_fft<InT, float, 512, kLog>(a, batch, s);
    default: return launch_fft<InT, float, 512, kFull>(a, batch, s);
  }
}

// ---------------------------------------------------------------------------
// The radix-2 body

// Shared memory: n_warps FFT buffers of n_fft float2, then n_warps x n_filt
// log-mel scratch, then the block's (n_features, n_mfcc) coefficients.
size_t radix2_smem_bytes(int n_warps, int n_fft, int n_filt, int n_features,
                         int n_mfcc) {
  return sizeof(float2) * (size_t)n_warps * n_fft +
         sizeof(float) * ((size_t)n_warps * n_filt + (size_t)n_features * n_mfcc);
}

template <typename InT, typename OutT>
__global__ void radix2_frontend_kernel(
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
  store_window(feats, n_features, n_mfcc, emit_deltas,
               out + (size_t)blockIdx.x * n_features * (emit_deltas ? 2 : 1) * n_mfcc);
}

template <typename InT, typename OutT>
cudaError_t launch_radix2(const void* audio, float in_scale, const float* gain,
                          int batch, int n_samples, int window, int hop,
                          int n_fft, int first_frame, int n_features,
                          const float2* twiddle, const float* filt_t,
                          const float* dct_t, int n_filt, int n_mfcc,
                          int emit_deltas, void* out, cudaStream_t stream) {
  static int limit[kMaxDevices] = {};
  auto kernel = radix2_frontend_kernel<InT, OutT>;
  const int log2_fft = __builtin_ctz(static_cast<unsigned>(n_fft));
  // 8 warps (8 frames in flight) unless the FFT buffers do not fit
  int n_warps = 8;
  size_t smem;
  cudaError_t err;
  for (;; n_warps >>= 1) {
    smem = radix2_smem_bytes(n_warps, n_fft, n_filt, n_features, n_mfcc);
    err = opt_in(kernel, limit, smem);
    if (err != cudaErrorInvalidValue || n_warps == 1) break;
  }
  if (err != cudaSuccess) return err;
  kernel<<<batch, n_warps * 32, smem, stream>>>(
      static_cast<const InT*>(audio), gain, in_scale, n_samples, window, hop,
      n_fft, log2_fft, first_frame, n_features, twiddle, filt_t, dct_t, n_filt,
      n_mfcc, emit_deltas, static_cast<OutT*>(out));
  return cudaGetLastError();
}

bool takes_register_fft(int n_fft) {
  return n_fft >= 128 && n_fft <= 4096 && (n_fft & (n_fft - 1)) == 0;
}

}  // namespace

// audio (batch, n_samples) f32 or int16; gain (1,) f32 on the device;
// dct_t (n_filt, n_filt) f32; out (batch, n_features, n_mfcc or 2 n_mfcc)
// f32 or bf16.  Frames first_frame .. first_frame + n_features - 1 are
// computed.  The register body (radix2 = 0, n_fft 128 .. 4096) reads
// plan_twiddle (ops/fft_plan.py::fft_plan(n_fft).twiddle, f32 rows),
// filt_packed (n_packed,) f32 and fb_table (int32, filterbank_plan's
// table with n_seg segments); the radix-2 body (radix2 = 1, any power of
// two) reads twiddle (n_fft/2,) complex64 exp(-2 pi i k / n_fft) and filt_t
// (n_filt, n_fft/2 + 1) f32.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a config the chosen body cannot take).
extern "C" int tsc_mfcc_frontend(const void* audio, int audio_int16,
                                 const void* gain, int batch, int n_samples,
                                 int window, int hop, int n_fft,
                                 int first_frame, int n_features,
                                 const void* twiddle, const void* filt_t,
                                 const void* dct_t, int n_filt, int n_mfcc,
                                 int emit_deltas, void* out, int out_bf16,
                                 const void* plan_twiddle, const void* filt_packed,
                                 const void* fb_table, int n_packed, int n_seg,
                                 int radix2, void* stream) {
  if (batch <= 0 || n_fft < 2 || (n_fft & (n_fft - 1)) != 0 || n_mfcc > n_filt)
    return cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gain);
  const float* dc = static_cast<const float*>(dct_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float in_scale = audio_int16 ? 1.0f / 32768.0f : 1.0f;
  cudaError_t err;
  if (radix2) {
    const float2* tw = static_cast<const float2*>(twiddle);
    const float* fb = static_cast<const float*>(filt_t);
#define TSC_LAUNCH(IN, OUT)                                                          \
  launch_radix2<IN, OUT>(audio, in_scale, g, batch, n_samples, window, hop, n_fft, \
                         first_frame, n_features, tw, fb, dc, n_filt, n_mfcc,     \
                         emit_deltas, out, s)
    if (audio_int16)
      err = out_bf16 ? TSC_LAUNCH(int16_t, __nv_bfloat16) : TSC_LAUNCH(int16_t, float);
    else
      err = out_bf16 ? TSC_LAUNCH(float, __nv_bfloat16) : TSC_LAUNCH(float, float);
#undef TSC_LAUNCH
    return static_cast<int>(err);
  }
  if (!takes_register_fft(n_fft) || !plan_twiddle || !fb_table || n_packed < 0 ||
      n_seg < 0)
    return cudaErrorInvalidValue;
  const size_t pair = audio_int16 ? 2 * sizeof(int16_t) : 2 * sizeof(float);
  FftArgs a;
  a.audio = audio;
  a.gain = g;
  a.in_scale = in_scale;
  a.n_samples = n_samples;
  a.window = window;
  a.hop = hop;
  a.first_frame = first_frame;
  a.n_features = n_features;
  a.vec_rows = reinterpret_cast<uintptr_t>(audio) % pair == 0 && n_samples % 2 == 0;
  a.twiddle = static_cast<const float2*>(plan_twiddle);
  a.packed = static_cast<const float*>(filt_packed);
  a.table = static_cast<const int*>(fb_table);
  a.dct_t = dc;
  a.n_packed = n_packed;
  a.n_seg = n_seg;
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.emit_deltas = emit_deltas;
  a.out = out;
  a.src_mod = 0;
  if (audio_int16)
    err = out_bf16 ? launch_fft_n<int16_t, __nv_bfloat16>(n_fft, a, batch, s)
                   : launch_fft_n<int16_t, float>(n_fft, a, batch, s);
  else
    err = out_bf16 ? launch_fft_n<float, __nv_bfloat16>(n_fft, a, batch, s)
                   : launch_fft_n<float, float>(n_fft, a, batch, s);
  return static_cast<int>(err);
}

// The register body cut after stage `stop` (0 load, 1 framing, 3 power, 4
// mel, 5 log, 6 full; ops/omission_kernel.py::FFT_STAGES), at the config
// tools/dev/r3_omission.py takes: frames of n_fft = 1024 samples (n2 = 8),
// hop n_fft / 2, frames 0 .. n_frames - 1, n_samples a multiple of 4.  out
// (batch, 128) f32: each window's per-frame rows of the stage, in the CT
// split's lane order, summed over its frames; window b reads audio row b %
// src_mod when src_mod > 0 (the constant-block profile).  Constants as for
// tsc_mfcc_frontend's register body.  Returns cudaErrorInvalidValue for any
// other config or stage.
extern "C" int tsc_mfcc_truncated(const void* audio, int audio_int16,
                                  const void* gain, int batch, int n_samples,
                                  int hop, int n_fft, int n_frames, int stop,
                                  int src_mod, const void* plan_twiddle,
                                  const void* filt_packed, const void* fb_table,
                                  int n_packed, int n_seg, const void* dct_t,
                                  int n_filt, int n_mfcc, void* out,
                                  void* stream) {
  if (batch <= 0 || n_fft != 8 * kLanes || 2 * hop != n_fft || n_frames <= 0 ||
      (long long)(n_frames - 1) * hop + n_fft > n_samples || n_samples % 4 != 0 ||
      n_filt <= 0 || n_filt + 1 > kLanes || n_mfcc <= 0 || n_mfcc > n_filt ||
      stop < kLoad || stop > kFull || stop == kButterfly || src_mod < 0 ||
      n_packed < 0 || n_seg < 0)
    return cudaErrorInvalidValue;
  FftArgs a;
  a.audio = audio;
  a.gain = static_cast<const float*>(gain);
  a.in_scale = audio_int16 ? 1.0f / 32768.0f : 1.0f;
  a.n_samples = n_samples;
  a.window = n_fft;
  a.hop = hop;
  a.first_frame = 0;
  a.n_features = n_frames;
  a.vec_rows = 1;  // n_samples % 4 == 0, and the wrapper checks the alignment
  a.twiddle = static_cast<const float2*>(plan_twiddle);
  a.packed = static_cast<const float*>(filt_packed);
  a.table = static_cast<const int*>(fb_table);
  a.dct_t = static_cast<const float*>(dct_t);
  a.n_packed = n_packed;
  a.n_seg = n_seg;
  a.n_filt = n_filt;
  a.n_mfcc = n_mfcc;
  a.emit_deltas = 0;
  a.out = out;
  a.src_mod = src_mod;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = audio_int16 ? launch_cut<int16_t>(stop, a, batch, s)
                                      : launch_cut<float>(stop, a, batch, s);
  return static_cast<int>(err);
}

extern "C" const char* tsc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
