// The register-resident real-input FFT frontend that the FFT kernel
// (csrc/mfcc_frontend.cu, n_fft a power of two) and route ct's mixed-radix
// kernel (csrc/mixed_fft_frontend.cu, n_fft = 256 m, m not a power of two)
// both instantiate: one kernel body, `register_fft_kernel`, on a plan type
// `RegisterPlan<N, V, B, R0, RS...>` (N = n_fft / 2 complex points, V values
// a lane, launch bounds of B blocks an SM, the passes' radices).  Each .cu
// file instantiates its own plans, so the two build in parallel.  The plans
// are ops/fft_plan.py's (`fft_plan`, `mixed_plan`), which builds their
// tables; tests/test_torch_fft_plan.py and tests/test_torch_mixed_fft.py
// emulate them in numpy.
//
// One block a window, up to 8 warps; a frame of N complex points z[n] =
// x[2n] + i x[2n+1] is held by L = N / V lanes of one warp (several frames
// a warp where L < 32), V values a lane in registers (V <= 64, a multiple of
// every radix, so that a lane holds whole butterflies of every pass):
// - pass 0 reads the audio itself: lanes on consecutive pairs, one 8-byte
//   (f32) or 4-byte (int16) load a pair, with no window test where the
//   lane's last pair lies inside the window (a window shorter than n_fft is
//   zero-padded); a frame start or row pitch not aligned for the pair load
//   takes two scalar loads instead;
// - Stockham passes: each reads its inputs at stride N / R in natural
//   order, multiplies by the float64-built inter-pass twiddles staged once a
//   block in shared memory, runs a DFT-R in registers (radix-2 decimation
//   for a power of two up to 16; for an odd prime 3 .. 13 a direct DFT on
//   the pairs x_r +- x_{R-r} with compile-time cos and sin) and writes once,
//   through a per-frame buffer XOR-swizzled before the last pass and linear
//   after it (ops/fft_plan.py::swizzle);
// - the untangle: one lane takes the bins k and N - k of a pair, X[k] = E +
//   W^k O and X[N - k] = conj(E - W^k O), and writes both powers and its
//   part of the energy;
// - the packed filterbank: each lane steps through one run of consecutive
//   packed weights against their bins, writing a partial sum where a filter
//   ends (ops/fft_plan.py::filterbank_plan), and lane m adds filter m's
//   partial sums in order;
// - log and DCT per frame into the block's (T, n_mfcc) coefficients in
//   shared memory; deltas and a coalesced store, batch- or time-major, once
//   the window is done.
// A compile-time STOP cuts the body after one stage for the stage-omission
// profile (ops/omission_kernel.py; csrc/mfcc_frontend.cu instantiates the
// cuts at n_fft 1024 only); the shipped kernels take kShipped and every cut
// is an `if constexpr`.

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
constexpr int kLanes = 128;       // a cut's output row, and the CT split's lane

// STOP: the stage a cut ends after (ops/omission_kernel.py::STAGES; this
// body has no butterfly stage), or the whole shipped kernel
enum Stop : int { kLoad, kFraming, kButterfly, kPower, kMel, kLog, kFull, kShipped };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// cos and sin of 2 pi k / R, k < R, from the float64 values; compile-time
// constants once the DFT's loops are unrolled
template <int R>
__device__ __forceinline__ float2 cos_sin(int k) {
  static_assert(R == 3 || R == 5 || R == 7 || R == 11 || R == 13, "odd radix");
  if constexpr (R == 3) {
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
  const float* dct_t;     // (n_filt, n_filt)
  int n_packed, n_seg, n_filt, n_mfcc, emit_deltas, time_major;
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

template <typename P>
__host__ __device__ SmemLayout smem_layout(int n_warps, int n_packed, int n_seg,
                                           int n_filt, int n_mfcc, int n_features) {
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

// One Stockham pass of radix R after passes of stride NS: each of the lane's
// butterflies j = l + L b reads z[j + r N / R] (the swizzled exchange the
// pass before wrote), multiplies input r by W_{NS R}^{r (j mod NS)} (row
// (r - 1) NS + j mod NS of `tw`), runs a DFT-R and writes output s to
// (j - c) R + c + s NS, swizzled unless LAST.  Every read comes before any
// write: the frame lives in registers in between.
template <typename P, int R, int NS, bool LAST>
__device__ __forceinline__ void stockham_pass(float2* buf, float2 (&v)[P::kV],
                                              const float2* tw, int l) {
  constexpr int N = P::N, L = P::kL, NB = P::kV / R;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) v[b * R + r] = buf[swz(l + L * b + r * (N / R))];
  __syncwarp();
#pragma unroll
  for (int b = 0; b < NB; ++b) {
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
  __syncwarp();
}

// The passes after pass 0, radices R, REST... in order: the first of
// stride NS, its twiddle rows from row TW of `tw`
template <typename P, int NS, int TW, int R, int... REST>
__device__ __forceinline__ void later_passes(float2* buf, float2 (&v)[P::kV],
                                             const float2* tw, int l) {
  stockham_pass<P, R, NS, sizeof...(REST) == 0>(buf, v, tw + TW, l);
  if constexpr (sizeof...(REST) > 0)
    later_passes<P, NS * R, TW + (R - 1) * NS, REST...>(buf, v, tw, l);
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
  static constexpr int kPitch = N + (kL < 16 ? kL : 0);  // float2 a frame slot
  static constexpr int kTwU = twiddle_rows<R0_, RS...>();  // untangle's row
  static constexpr int kNtw = kTwU + N / 2 + 1;
  static constexpr int kMinBlocks = B_;
  static constexpr bool kPow2 = (N & (N - 1)) == 0;
  static_assert(sizeof...(RS) > 0 && R0_ * (RS * ... * 1) == N, "radices multiply to N");
  static_assert(kV <= 64 && kV % 2 == 0 && kV % R0_ == 0 && ((kV % RS == 0) && ...),
                "a lane holds whole butterflies of every pass");
  static_assert(kL * kV == N && kL <= 32 && (kL & (kL - 1)) == 0, "L = 1 .. 32");
  static_assert(N % 16 == 0, "the swizzle stays inside the frame");

  // the passes after pass 0
  static __device__ __forceinline__ void run_passes(float2* buf, float2 (&v)[kV],
                                                    const float2* tw, int l) {
    later_passes<RegisterPlan, R0_, 0, RS...>(buf, v, tw, l);
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
__global__ void __launch_bounds__(kMaxThreads, P::kMinBlocks)
    register_fft_kernel(FftArgs a) {
  constexpr int N = P::N, V = P::kV, L = P::kL, R0 = P::kR0;
  extern __shared__ float4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  const int n_warps = blockDim.x >> 5;
  const SmemLayout lay = smem_layout<P>(n_warps, a.n_packed, a.n_seg, a.n_filt,
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

    // pass 0: butterfly j = l + L b reads z[j + r N / R0] straight from the
    // audio, a DFT-R0, swizzled writes; the lane's pairs take unguarded pair
    // loads where its last one lies inside the window (every pair at the
    // default config and on route ct)
    float2 v[V];
    if (active && vec && 2 * (l + L * (V / R0 - 1) + (R0 - 1) * (N / R0)) + 1 < w_eff) {
#pragma unroll
      for (int b = 0; b < V / R0; ++b)
#pragma unroll
        for (int r = 0; r < R0; ++r) {
          const float2 x = load_pair(frame + 2 * (l + L * b + r * (N / R0)));
          v[b * R0 + r] = make_float2(x.x * scale, x.y * scale);
        }
    } else {
#pragma unroll
      for (int b = 0; b < V / R0; ++b)
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
    for (int b = 0; b < V / R0; ++b) {
      float2 u[R0];
#pragma unroll
      for (int r = 0; r < R0; ++r) u[r] = v[b * R0 + r];
      dft<R0>(u);
      const int j = l + L * b;
#pragma unroll
      for (int s = 0; s < R0; ++s) buf[swz(j * R0 + s)] = u[s];
    }
    __syncwarp();
    P::run_passes(buf, v, s_tw, l);

    // the untangle: lane l takes the pairs k = l + L i, i < V / 2, and lane
    // 0 also k = N / 2; X[k] = E + W^k O, X[N - k] = conj(E - W^k O) with
    // E = (Z[k] + conj Z[N-k]) / 2, O = -i (Z[k] - conj Z[N-k]) / 2
    float2 za[V / 2], zb[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const int k = l + L * i;
      za[i] = buf[k];
      zb[i] = buf[P::kPow2 ? (N - k) & (N - 1) : (k ? N - k : 0)];
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
  store_window(feats, a.n_features, a.n_mfcc, a.emit_deltas, a.time_major, a.batch,
               static_cast<OutT*>(a.out));
}

}  // namespace
