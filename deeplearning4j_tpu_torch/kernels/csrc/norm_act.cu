// LayerNorm + affine + activation, one warp per row (one block per row past
// a warp's reach); BatchNorm apply + affine + activation over [rows, C] with
// per-channel vectors.
//
// Replaces the TPU kernel `_ln_kernel` (deeplearning4j_tpu/kernels/norm_act.py:101,
// reached through `layernorm_norm_act` :164): per-row mean and variance, then
// (x - mu) * rsqrt(var + eps) * gamma + beta, then identity/relu/tanh/sigmoid.
//
// Bound on the H100: bytes. The work is ~8 flops per element against 4 bytes
// moved per bf16 element, far below the ~295 flop/byte ridge, so the least time
// is rows*F*2 bytes read + rows*F*2 written over 3.35 TB/s. At the serving
// widths (F = 512, rows = 4 per decode step or one prefill bucket <= 1024) that
// is under a microsecond and the launch itself dominates.
//
// Design: each row is read from device memory exactly once, 16 bytes per
// thread (8 bf16 / 4 f32), and held in registers for both reduction passes, so
// the two-pass variance of `layernorm_xla` (mean((x-mu)^2), not E[x^2]-E[x]^2)
// costs no second read. Mean and variance accumulate in f32 through warp
// shuffles; nothing touches shared memory and no block-level barrier exists.
// The output is rounded to the input dtype once, at the store. f16 (the
// mixed_float16 and float16 policies) is the same template at `__half`, 8
// values a vector as bf16; its statistics stay in f32, so f16's narrow range
// matters only at the store. Any F: where F or an address is no multiple of
// the 16-byte vector, a warp takes the row in single elements (F <= 256,
// `c < F` masking the tail); a row past a warp's 8 loads a lane (F > 2048 in
// bf16 / f16, > 1024 in f32, or a ragged F > 256) takes a block of 256
// threads, staged once in shared memory (read from device memory again only
// where it does not fit), with the same two-pass variance in f32.
//
// BatchNorm apply replaces the TPU kernel `_bn_kernel`
// (deeplearning4j_tpu/kernels/norm_act.py:96, reached through
// `batchnorm_norm_act` :140): act(gamma * (x - mean) / sqrt(var + eps) + beta)
// over [rows, C] with the statistics given. Bound: bytes. Per element it
// reads and writes one value of x's dtype (4 bytes a bf16 element) against a
// subtraction, a division, an FMA and the activation; the [C] vectors are
// 4*C values against rows*C. At ResNet-50's widest BatchNorms in training
// (B=256: 112x112x64 and 56x56x256, 205 M elements) the least time is 0.82
// GB over 3.35 TB/s = 0.245 ms in bf16 / f16, 0.49 ms in f32.
//
// Design, so that the threads move x and y and do little else:
// - Per-channel work once per block. A block covers whole rows of one tile
//   of channels: it reads mean, var, gamma and beta for the tile once, at
//   their own dtypes (f32, bf16 or f16, a 0-d tensor, or a float passed by
//   value: the `lock_gamma_beta` constants), rounds them as the Pallas
//   path's `_vec` does (to bf16 for a bf16 x; f32 and f16 x keep them in
//   f32), and keeps m, s = sqrt(v + eps), g and b in f32 in shared memory;
//   each thread then holds its fixed V channels' four values in registers.
//   No modulo per element, no vector reload, no sqrt per element, and no
//   cast kernel before the launch: one launch a call.
// - Bytes in flight: each thread issues 6 independent 16-byte row loads
//   before it uses the first, at 3 blocks of 256 an SM (the register cap
//   that allows), one group of rows a block: the grid walks the rows in
//   order, each block's loads close to its neighbours'. On the card that
//   beat a persistent grid of one wave (whose blocks drift apart over the
//   tensor), 4 loads at 3 blocks and 8 loads at 2 (`chip_smoke.py`'s
//   resnet_kernels rows give this form's times).
// - Any C: V is the widest load (16 bytes down to one element) that C and
//   x's and y's addresses allow, so a channel count such as 3, 10 or 1000 in
//   bf16 takes narrower loads instead of a refusal; rows past the end and
//   channels past C (C/V > 256 takes several tiles) are masked.
// - The arithmetic is the earlier kernel's, operation for operation: a true
//   division (x - m) / sqrt(v + eps) (`__fdiv_rn`, `__fsqrt_rn`), then
//   `__fmaf_rn(g, xhat, b)` and the activation, in f32, y rounded once at
//   the store. So y is bit for bit what the kernel that recomputed all of
//   it per element gave (the Pallas body computes at x's dtype, so in bf16
//   the two differ by bf16 rounding). The division is most of a bf16
//   element's arithmetic, and what keeps the bf16 form a few per cent
//   further from its bound than the f32 form.

//
// The float64 forms (`dl4j_layernorm_norm_act_f64`, `dl4j_batchnorm_norm_act_f64`)
// compute in double from end to end, for the gradient checks of float64 nets:
// the LayerNorm one warp a row (rows of up to 512 values held in registers,
// two doubles a 16-byte load), one block a row past that (the row read from
// device memory in each pass); the BatchNorm one thread per pair of channels
// (or one channel where C or an address is odd), which keeps its channels'
// m, sqrt(v + eps), g and b in registers and walks the rows, with the plain
// version's roundings (a true division and square root, then g * xhat and
// + b rounded apart, never one FMA). eps arrives as a double. The f32, bf16
// and f16 forms above are untouched by them.

#include "common.cuh"

#include <cstdint>

namespace {

using dl4j::activate;

// V consecutive elements of T as one aligned load or store of 16, 8, 4 or 2
// bytes.
template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> { using type = uint4; };
template <>
struct RawOf<8> { using type = uint2; };
template <>
struct RawOf<4> { using type = unsigned; };
template <>
struct RawOf<2> { using type = unsigned short; };
template <typename T, int V>
using Raw = typename RawOf<V * static_cast<int>(sizeof(T))>::type;

// The widest load, in elements (at most 16 bytes), that a row of `feats`
// and every address in `addr` (or-ed) allow.
template <typename T>
int load_width(long long feats, uintptr_t addr) {
  int v = 16 / sizeof(T);
  while (v > 1 && (feats % v || addr % (v * sizeof(T)))) v /= 2;
  return v;
}

constexpr int kRowsPerBlock = 8;  // 8 warps, 256 threads
constexpr int kMaxVectors = 8;    // loads a lane, one warp a row

// NV loads of V elements per lane: F <= 32 * NV * V.
template <typename T, int V, int NV>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layernorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                 const T* __restrict__ beta, T* __restrict__ y, int rows,
                 int feats, float eps, int act) {
  using R = Raw<T, V>;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * feats;
  T* yr = y + static_cast<size_t>(row) * feats;

  float v[NV][V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < feats) {
      const R raw = *reinterpret_cast<const R*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[i][j] = dl4j::to_f32(e[j]);
        sum += v[i][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[i][j] = 0.f;
    }
  }
  const float mu = dl4j::warp_sum(sum) / feats;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if ((i * 32 + lane) * V < feats) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[i][j] - mu;
        sq += d * d;
      }
    }
  }
  const float inv = rsqrtf(dl4j::warp_sum(sq) / feats + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < feats) {
      const R graw = *reinterpret_cast<const R*>(gamma + c);
      const R braw = *reinterpret_cast<const R*>(beta + c);
      const T* g = reinterpret_cast<const T*>(&graw);
      const T* b = reinterpret_cast<const T*>(&braw);
      R out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float n = (v[i][j] - mu) * inv;
        o[j] = dl4j::from_f32<T>(
            activate(n * dl4j::to_f32(g[j]) + dl4j::to_f32(b[j]), act));
      }
      *reinterpret_cast<R*>(yr + c) = out;
    }
  }
}

template <typename T, int V>
int launch_warp(const T* x, const T* g, const T* b, T* y, int rows, int feats,
                float eps, int act, cudaStream_t stream) {
  const int nv = (feats + 32 * V - 1) / (32 * V);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(32 * kRowsPerBlock);
  if (nv <= 1)
    layernorm_kernel<T, V, 1><<<grid, block, 0, stream>>>(x, g, b, y, rows, feats, eps, act);
  else if (nv <= 2)
    layernorm_kernel<T, V, 2><<<grid, block, 0, stream>>>(x, g, b, y, rows, feats, eps, act);
  else if (nv <= 4)
    layernorm_kernel<T, V, 4><<<grid, block, 0, stream>>>(x, g, b, y, rows, feats, eps, act);
  else if (nv <= kMaxVectors)
    layernorm_kernel<T, V, kMaxVectors><<<grid, block, 0, stream>>>(x, g, b, y, rows, feats, eps, act);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kRowThreads = 256;

// The sum of `v` over the block, the same value in every thread (each sums
// the warps' partials in one order).
__device__ __forceinline__ float block_sum(float v, float* part) {
  v = dl4j::warp_sum(v);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kRowThreads / 32; ++w) t += part[w];
  __syncthreads();  // `part` is written again by the next sum
  return t;
}

// One block a row of any width: the row (F / V loads of V elements) is read
// once from device memory into shared memory (`stage`; else read again from
// device memory), then the two-pass statistics in f32 and the output.
template <typename T, int V>
__global__ void __launch_bounds__(kRowThreads)
layernorm_row_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                     const T* __restrict__ beta, T* __restrict__ y, int feats,
                     float eps, int act, int stage) {
  using R = Raw<T, V>;
  extern __shared__ __align__(16) unsigned char staged[];
  __shared__ float part[kRowThreads / 32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * feats;
  T* yr = y + static_cast<size_t>(blockIdx.x) * feats;
  const R* src = stage ? reinterpret_cast<const R*>(staged)
                       : reinterpret_cast<const R*>(xr);
  const int n = feats / V;

  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += kRowThreads) {
    const R raw = reinterpret_cast<const R*>(xr)[i];
    if (stage) reinterpret_cast<R*>(staged)[i] = raw;  // read back by this thread only
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) sum += dl4j::to_f32(e[j]);
  }
  const float mu = block_sum(sum, part) / feats;

  float sq = 0.f;
  for (int i = threadIdx.x; i < n; i += kRowThreads) {
    const R raw = src[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = dl4j::to_f32(e[j]) - mu;
      sq += d * d;
    }
  }
  const float inv = rsqrtf(block_sum(sq, part) / feats + eps);

  for (int i = threadIdx.x; i < n; i += kRowThreads) {
    const R raw = src[i];
    const R graw = reinterpret_cast<const R*>(gamma)[i];
    const R braw = reinterpret_cast<const R*>(beta)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    const T* g = reinterpret_cast<const T*>(&graw);
    const T* b = reinterpret_cast<const T*>(&braw);
    R out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float nrm = (dl4j::to_f32(e[j]) - mu) * inv;
      o[j] = dl4j::from_f32<T>(
          activate(nrm * dl4j::to_f32(g[j]) + dl4j::to_f32(b[j]), act));
    }
    reinterpret_cast<R*>(yr)[i] = out;
  }
}

template <typename T, int V>
int launch_row(const T* x, const T* g, const T* b, T* y, int rows, int feats,
               float eps, int act, cudaStream_t stream) {
  const auto kernel = layernorm_row_kernel<T, V>;
  const size_t bytes = static_cast<size_t>(feats) * sizeof(T);
  int stage = bytes <= 48 * 1024;
  if (!stage) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    // The static partials take a few bytes of the same budget.
    stage = bytes + 1024 <= static_cast<size_t>(optin);
    if (stage) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  kernel<<<rows, kRowThreads, stage ? bytes : 0, stream>>>(x, g, b, y, feats,
                                                           eps, act, stage);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* g, const void* b, void* y, int rows,
           int feats, float eps, int act, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  const int v = load_width<T>(
      feats, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                 reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(y));
  if (v == VEC && feats <= 32 * kMaxVectors * VEC)
    return launch_warp<T, VEC>(xp, gp, bp, yp, rows, feats, eps, act, stream);
  if (v < VEC && feats <= 32 * kMaxVectors)
    return launch_warp<T, 1>(xp, gp, bp, yp, rows, feats, eps, act, stream);
  if (v == VEC)
    return launch_row<T, VEC>(xp, gp, bp, yp, rows, feats, eps, act, stream);
  if constexpr (VEC == 8) {
    if (v == 4)
      return launch_row<T, 4>(xp, gp, bp, yp, rows, feats, eps, act, stream);
  }
  if (v == 2)
    return launch_row<T, 2>(xp, gp, bp, yp, rows, feats, eps, act, stream);
  return launch_row<T, 1>(xp, gp, bp, yp, rows, feats, eps, act, stream);
}

// ---------------------------------------------------------------- BatchNorm

constexpr int kBnThreads = 256;

// Row loads a thread has in flight (96 bytes of x), at 3 blocks an SM
// (`__launch_bounds__`: at most 85 registers a thread).
constexpr int kBnLoads = 6;
constexpr int kBnBlocksPerSm = 3;

// How each of mean, var, gamma and beta comes (4 bits each in `kinds`,
// kernels/norm_act.py `_vector_arg`): a [C] tensor of dtype code 0 (f32),
// 1 (bf16) or 3 (f16); that code + kBroadcast for a 0-d tensor; kByValue
// for a float passed by value (its pointer then is any valid address).
constexpr int kBroadcast = 4;
constexpr int kByValue = 8;

struct BnVectors {
  const void* ptr[4];  // mean, var, gamma, beta
  float value[4];
  int kinds;
};

// A vector value as the kernel uses it beside an x of T: rounded to bf16
// for a bf16 x (the Pallas path's `_vec`), kept in f32 for f32 and f16 x.
template <typename T>
__device__ __forceinline__ float as_vector_of(float v) { return v; }
template <>
__device__ __forceinline__ float as_vector_of<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// One vector value from its two 16-bit halves (an f32's low and high half;
// a bf16 or f16 value and itself again), as f32.
__device__ __forceinline__ float decode(unsigned short lo, unsigned short hi,
                                        int kind, float value) {
  const unsigned bits = (kind & 3) == dl4j::kFloat32
                            ? (static_cast<unsigned>(hi) << 16) | lo
                            : static_cast<unsigned>(lo) << 16;  // bf16
  const float v = (kind & 3) == dl4j::kFloat16
                      ? __half2float(__ushort_as_half(lo))
                      : __uint_as_float(bits);
  return kind == kByValue ? value : v;
}

// y's value from x's, the channel's m, s = sqrt(v + eps), g and b.
template <int ACT>
__device__ __forceinline__ float bn_apply(float x, float m, float s, float g,
                                          float b) {
  return activate(__fmaf_rn(g, __fdiv_rn(x - m, s), b), ACT);
}

// The two 16-bit values of a 32-bit word as f32, and two f32 rounded to
// nearest into one word, for T = bf16 or f16 (one conversion a pair, no
// 16-bit registers: the 16-byte forms fit 3 blocks an SM without spills).
template <typename T>
struct Pairs;
template <>
struct Pairs<__nv_bfloat16> {
  static __device__ __forceinline__ float lo(unsigned w) {
    return __uint_as_float(w << 16);
  }
  static __device__ __forceinline__ float hi(unsigned w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ unsigned pack(float a, float b) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&p);
  }
};
template <>
struct Pairs<__half> {
  static __device__ __forceinline__ float lo(unsigned w) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
  }
  static __device__ __forceinline__ float hi(unsigned w) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
  }
  static __device__ __forceinline__ unsigned pack(float a, float b) {
    const __half2 p = __floats2half2_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&p);
  }
};

// x, y: [rows, chunks * V]. Block (bx, by) takes chunk tile by (chunks
// by * tx_n .. + tx_n) over the bx-th group of ty_n * kBnLoads rows. Its
// threads first read the tile's mean, var, gamma and beta into shared
// memory once, as m, sqrt(v + eps), g and b in f32 (the four vectors'
// loads in flight together, whatever their dtypes: no branch on a kind);
// then thread (ty, tx) keeps chunk tx's V channels in registers and issues
// its kBnLoads rows' loads (rows ty, ty + ty_n, ...) before it uses the
// first.
template <typename T, int V, int ACT>
__global__ void __launch_bounds__(kBnThreads, kBnBlocksPerSm)
batchnorm_kernel(const T* __restrict__ x, T* __restrict__ y, BnVectors vecs,
                 long long rows, int chunks, int tx_n, float eps) {
  using R = Raw<T, V>;
  __shared__ float per_channel[4][kBnThreads * V];  // m, s, g, b
  const int first = blockIdx.y * tx_n;  // the tile's first chunk
  const int tile = min(tx_n, chunks - first) * V;  // its channels
  {
    const unsigned short* p[4];
    long long step[4];  // 16-bit halves from one channel to the next
    int hi[4], kind[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      kind[w] = (vecs.kinds >> (4 * w)) & 15;
      p[w] = static_cast<const unsigned short*>(vecs.ptr[w]);
      const int halves =
          (kind[w] & 3) == dl4j::kFloat32 && kind[w] != kByValue ? 2 : 1;
      step[w] = kind[w] & (kBroadcast | kByValue) ? 0 : halves;
      hi[w] = halves - 1;
    }
    const long long c0 = static_cast<long long>(first) * V;
#pragma unroll 2
    for (int c = threadIdx.x; c < tile; c += kBnThreads) {
      unsigned short lo[4], up[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const unsigned short* q = p[w] + (c0 + c) * step[w];
        lo[w] = q[0];
        up[w] = q[hi[w]];
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float v = as_vector_of<T>(decode(lo[w], up[w], kind[w],
                                               vecs.value[w]));
        per_channel[w][c] = w == 1 ? __fsqrt_rn(v + eps) : v;
      }
    }
  }
  __syncthreads();

  const int ty_n = kBnThreads / tx_n;
  const int ty = threadIdx.x / tx_n;
  const int tx = threadIdx.x - ty * tx_n;
  if (ty >= ty_n || tx * V >= tile) return;
  float m[V], s[V], g[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = per_channel[0][tx * V + j];
    s[j] = per_channel[1][tx * V + j];
    g[j] = per_channel[2][tx * V + j];
    b[j] = per_channel[3][tx * V + j];
  }
  const long long feats = static_cast<long long>(chunks) * V;
  const long long row_step = feats * ty_n;  // elements between a thread's rows
  const long long r0 =
      static_cast<long long>(blockIdx.x) * ty_n * kBnLoads + ty;
  const T* xp = x + r0 * feats + static_cast<long long>(first + tx) * V;
  T* yp = y + (xp - x);
  R in[kBnLoads];
#pragma unroll
  for (int k = 0; k < kBnLoads; ++k)
    if (r0 + k * ty_n < rows)
      in[k] = *reinterpret_cast<const R*>(xp + k * row_step);
#pragma unroll
  for (int k = 0; k < kBnLoads; ++k) {
    if (r0 + k * ty_n < rows) {
      R out;
      if constexpr (sizeof(T) == 2 && V % 2 == 0) {
        const unsigned* wi = reinterpret_cast<const unsigned*>(&in[k]);
        unsigned* wo = reinterpret_cast<unsigned*>(&out);
#pragma unroll
        for (int j = 0; j < V / 2; ++j) {
          const int c = 2 * j;
          wo[j] = Pairs<T>::pack(
              bn_apply<ACT>(Pairs<T>::lo(wi[j]), m[c], s[c], g[c], b[c]),
              bn_apply<ACT>(Pairs<T>::hi(wi[j]), m[c + 1], s[c + 1],
                            g[c + 1], b[c + 1]));
        }
      } else {
        const T* e = reinterpret_cast<const T*>(&in[k]);
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j)
          o[j] = dl4j::from_f32<T>(
              bn_apply<ACT>(dl4j::to_f32(e[j]), m[j], s[j], g[j], b[j]));
      }
      *reinterpret_cast<R*>(yp + k * row_step) = out;
    }
  }
}

template <typename T, int V, int ACT>
int launch_bn_v(const T* x, T* y, const BnVectors& vecs, long long rows,
                int feats, float eps, cudaStream_t stream) {
  const int chunks = feats / V;
  const int tx_n = chunks < kBnThreads ? chunks : kBnThreads;
  const int tiles = (chunks + tx_n - 1) / tx_n;
  const long long group_rows =
      static_cast<long long>(kBnThreads / tx_n) * kBnLoads;
  const long long groups = (rows + group_rows - 1) / group_rows;
  if (tiles > 65535 || groups > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  batchnorm_kernel<T, V, ACT>
      <<<dim3(static_cast<unsigned>(groups), tiles), kBnThreads, 0, stream>>>(
          x, y, vecs, rows, chunks, tx_n, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_bn_act(const T* x, T* y, const BnVectors& vecs, long long rows,
                  int feats, float eps, int act, cudaStream_t stream) {
  switch (act) {
    case dl4j::kIdentity:
      return launch_bn_v<T, V, dl4j::kIdentity>(x, y, vecs, rows, feats, eps, stream);
    case dl4j::kRelu:
      return launch_bn_v<T, V, dl4j::kRelu>(x, y, vecs, rows, feats, eps, stream);
    case dl4j::kTanh:
      return launch_bn_v<T, V, dl4j::kTanh>(x, y, vecs, rows, feats, eps, stream);
    case dl4j::kSigmoid:
      return launch_bn_v<T, V, dl4j::kSigmoid>(x, y, vecs, rows, feats, eps, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_bn(const void* x, void* y, const BnVectors& vecs, long long rows,
              int feats, float eps, int act, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const int v = load_width<T>(
      feats, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y));
  if (v == VEC)
    return launch_bn_act<T, VEC>(xp, yp, vecs, rows, feats, eps, act, stream);
  if constexpr (VEC == 8) {
    if (v == 4)
      return launch_bn_act<T, 4>(xp, yp, vecs, rows, feats, eps, act, stream);
  }
  if (v == 2)
    return launch_bn_act<T, 2>(xp, yp, vecs, rows, feats, eps, act, stream);
  return launch_bn_act<T, 1>(xp, yp, vecs, rows, feats, eps, act, stream);
}

// ----------------------------------------------------------------- float64

__device__ __forceinline__ double activate_f64(double v, int act) {
  switch (act) {
    case dl4j::kRelu: return fmax(v, 0.0);
    case dl4j::kTanh: return tanh(v);
    case dl4j::kSigmoid: return 1.0 / (1.0 + exp(-v));
    default: return v;
  }
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (x - mu) * rsqrt(var + eps), then * gamma + beta, then the activation: the
// plain version's order, each step rounded apart.
__device__ __forceinline__ double ln_out_f64(double x, double mu, double inv,
                                             double g, double b, int act) {
  return activate_f64(__dadd_rn(__dmul_rn(__dmul_rn(x - mu, inv), g), b), act);
}

template <int V, int NV>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layernorm_f64_kernel(const double* __restrict__ x,
                     const double* __restrict__ gamma,
                     const double* __restrict__ beta, double* __restrict__ y,
                     int rows, int feats, double eps, int act) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const double* xr = x + static_cast<size_t>(row) * feats;
  double* yr = y + static_cast<size_t>(row) * feats;
  double v[NV][V];
  double sum = 0.0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) v[i][j] = 0.0;
    if (c < feats) {
      if constexpr (V == 2) {
        const double2 d = *reinterpret_cast<const double2*>(xr + c);
        v[i][0] = d.x;
        v[i][1] = d.y;
      } else {
        v[i][0] = xr[c];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) sum += v[i][j];
    }
  }
  const double mu = warp_sum_f64(sum) / feats;
  double sq = 0.0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if ((i * 32 + lane) * V < feats) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const double d = v[i][j] - mu;
        sq += d * d;
      }
    }
  }
  const double inv = 1.0 / sqrt(warp_sum_f64(sq) / feats + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < feats) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        yr[c + j] = ln_out_f64(v[i][j], mu, inv, gamma[c + j], beta[c + j], act);
    }
  }
}

__device__ __forceinline__ double block_sum_f64(double v, double* part) {
  v = warp_sum_f64(v);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < kRowThreads / 32; ++w) t += part[w];
  __syncthreads();
  return t;
}

__global__ void __launch_bounds__(kRowThreads)
layernorm_f64_row_kernel(const double* __restrict__ x,
                         const double* __restrict__ gamma,
                         const double* __restrict__ beta,
                         double* __restrict__ y, int feats, double eps,
                         int act) {
  __shared__ double part[kRowThreads / 32];
  const double* xr = x + static_cast<size_t>(blockIdx.x) * feats;
  double* yr = y + static_cast<size_t>(blockIdx.x) * feats;
  double sum = 0.0;
  for (int i = threadIdx.x; i < feats; i += kRowThreads) sum += xr[i];
  const double mu = block_sum_f64(sum, part) / feats;
  double sq = 0.0;
  for (int i = threadIdx.x; i < feats; i += kRowThreads) {
    const double d = xr[i] - mu;
    sq += d * d;
  }
  const double inv = 1.0 / sqrt(block_sum_f64(sq, part) / feats + eps);
  for (int i = threadIdx.x; i < feats; i += kRowThreads)
    yr[i] = ln_out_f64(xr[i], mu, inv, gamma[i], beta[i], act);
}

template <int V>
int launch_ln_f64_warp(const double* x, const double* g, const double* b,
                       double* y, int rows, int feats, double eps, int act,
                       cudaStream_t stream) {
  const int nv = (feats + 32 * V - 1) / (32 * V);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(32 * kRowsPerBlock);
  if (nv <= 1)
    layernorm_f64_kernel<V, 1><<<grid, block, 0, stream>>>(x, g, b, y, rows, feats, eps, act);
  else if (nv <= 2)
    layernorm_f64_kernel<V, 2><<<grid, block, 0, stream>>>(x, g, b, y, rows, feats, eps, act);
  else if (nv <= 4)
    layernorm_f64_kernel<V, 4><<<grid, block, 0, stream>>>(x, g, b, y, rows, feats, eps, act);
  else
    layernorm_f64_kernel<V, kMaxVectors><<<grid, block, 0, stream>>>(x, g, b, y, rows, feats, eps, act);
  return static_cast<int>(cudaGetLastError());
}

struct BnF64 {
  const double* ptr[4];  // mean, var, gamma, beta
  double value[4];
  int kinds;             // 4 bits each: 0 a [C] tensor, kBroadcast, kByValue
};

__device__ __forceinline__ double bn_vec_f64(const BnF64& v, int w, int c) {
  const int kind = (v.kinds >> (4 * w)) & 15;
  if (kind == kByValue) return v.value[w];
  return v.ptr[w][kind == kBroadcast ? 0 : c];
}

template <int ACT, int V>
__global__ void __launch_bounds__(kBnThreads)
batchnorm_f64_kernel(const double* __restrict__ x, double* __restrict__ y,
                     BnF64 vecs, long long rows, int feats, int tx_n,
                     double eps) {
  const int ty_n = kBnThreads / tx_n;
  const int ty = threadIdx.x / tx_n, tx = threadIdx.x - ty * tx_n;
  const int c0 = (blockIdx.y * tx_n + tx) * V;
  if (ty >= ty_n || c0 >= feats) return;
  double m[V], s[V], g[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = bn_vec_f64(vecs, 0, c0 + j);
    s[j] = __dsqrt_rn(bn_vec_f64(vecs, 1, c0 + j) + eps);
    g[j] = bn_vec_f64(vecs, 2, c0 + j);
    b[j] = bn_vec_f64(vecs, 3, c0 + j);
  }
  const long long step = static_cast<long long>(gridDim.x) * ty_n;
  for (long long r = static_cast<long long>(blockIdx.x) * ty_n + ty; r < rows;
       r += step) {
    const double* xp = x + r * feats + c0;
    double* yp = y + r * feats + c0;
    double in[V], out[V];
    if constexpr (V == 2) {
      const double2 d = *reinterpret_cast<const double2*>(xp);
      in[0] = d.x;
      in[1] = d.y;
    } else {
      in[0] = xp[0];
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      out[j] = activate_f64(
          __dadd_rn(__dmul_rn(g[j], __ddiv_rn(in[j] - m[j], s[j])), b[j]), ACT);
    if constexpr (V == 2)
      *reinterpret_cast<double2*>(yp) = make_double2(out[0], out[1]);
    else
      yp[0] = out[0];
  }
}

template <int V>
int launch_bn_f64_v(const double* x, double* y, const BnF64& vecs,
                    long long rows, int feats, double eps, int act,
                    cudaStream_t stream) {
  const int chunks = feats / V;
  const int tx_n = chunks < kBnThreads ? chunks : kBnThreads;
  const int tiles = (chunks + tx_n - 1) / tx_n;
  const int ty_n = kBnThreads / tx_n;
  long long groups = (rows + ty_n - 1) / ty_n;
  const long long cap = 132LL * 16;  // a few waves; the rows are walked
  if (groups > cap) groups = cap;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(groups), tiles);
  switch (act) {
    case dl4j::kIdentity:
      batchnorm_f64_kernel<dl4j::kIdentity, V><<<grid, kBnThreads, 0, stream>>>(x, y, vecs, rows, feats, tx_n, eps);
      break;
    case dl4j::kRelu:
      batchnorm_f64_kernel<dl4j::kRelu, V><<<grid, kBnThreads, 0, stream>>>(x, y, vecs, rows, feats, tx_n, eps);
      break;
    case dl4j::kTanh:
      batchnorm_f64_kernel<dl4j::kTanh, V><<<grid, kBnThreads, 0, stream>>>(x, y, vecs, rows, feats, tx_n, eps);
      break;
    case dl4j::kSigmoid:
      batchnorm_f64_kernel<dl4j::kSigmoid, V><<<grid, kBnThreads, 0, stream>>>(x, y, vecs, rows, feats, tx_n, eps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float64 LayerNorm: x, y: [rows, feats] contiguous, gamma, beta:
// [feats] contiguous, all double; eps a double.
extern "C" int dl4j_layernorm_norm_act_f64(const void* x, const void* gamma,
                                           const void* beta, void* y,
                                           int rows, int feats, double eps,
                                           int act, void* stream) {
  if (rows <= 0 || feats <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* xp = static_cast<const double*>(x);
  const double* gp = static_cast<const double*>(gamma);
  const double* bp = static_cast<const double*>(beta);
  double* yp = static_cast<double*>(y);
  const int v = load_width<double>(
      feats, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y));
  if (v == 2 && feats <= 32 * kMaxVectors * 2)
    return launch_ln_f64_warp<2>(xp, gp, bp, yp, rows, feats, eps, act, s);
  if (feats <= 32 * kMaxVectors)
    return launch_ln_f64_warp<1>(xp, gp, bp, yp, rows, feats, eps, act, s);
  layernorm_f64_row_kernel<<<rows, kRowThreads, 0, s>>>(xp, gp, bp, yp, feats,
                                                         eps, act);
  return static_cast<int>(cudaGetLastError());
}

// The float64 BatchNorm apply: x, y: [rows, feats] contiguous double; mean,
// var, gamma, beta: each a [feats] double tensor (kind 0), a 0-d double
// tensor (kBroadcast) or a double by value (kByValue), 4 bits each in
// `kinds`.
extern "C" int dl4j_batchnorm_norm_act_f64(
    const void* x, const void* mean, const void* var, const void* gamma,
    const void* beta, void* y, long long rows, int feats, double eps, int act,
    int kinds, double mean_value, double var_value, double gamma_value,
    double beta_value, void* stream) {
  if (rows <= 0 || feats <= 0) return 0;
  BnF64 vecs{{static_cast<const double*>(mean), static_cast<const double*>(var),
              static_cast<const double*>(gamma),
              static_cast<const double*>(beta)},
             {mean_value, var_value, gamma_value, beta_value},
             kinds};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* xp = static_cast<const double*>(x);
  double* yp = static_cast<double*>(y);
  const int v = load_width<double>(
      feats, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y));
  if (v == 2)
    return launch_bn_f64_v<2>(xp, yp, vecs, rows, feats, eps, act, s);
  return launch_bn_f64_v<1>(xp, yp, vecs, rows, feats, eps, act, s);
}

// x, y: [rows, feats] contiguous; gamma, beta: [feats] contiguous; all of
// `dtype` (checked by the Python wrapper). Any feats >= 1 and any address
// aligned to the element.
extern "C" int dl4j_layernorm_norm_act(const void* x, const void* gamma,
                                       const void* beta, void* y, int rows,
                                       int feats, float eps, int act,
                                       int dtype, void* stream) {
  if (rows <= 0 || feats <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return launch<float>(x, gamma, beta, y, rows, feats, eps, act, s);
  if (dtype == dl4j::kBFloat16)
    return launch<__nv_bfloat16>(x, gamma, beta, y, rows, feats, eps, act, s);
  if (dtype == dl4j::kFloat16)
    return launch<__half>(x, gamma, beta, y, rows, feats, eps, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, y: [rows, feats] contiguous of `dtype` (f32, bf16 or f16), any feats
// >= 1 and any address aligned to the element. mean, var, gamma, beta: each
// a pointer and a 4-bit kind in `kinds` (bits 4i..4i+3 for the i-th; see
// kBroadcast, kByValue), or the float beside it where the kind is kByValue.
// One kernel launch, nothing allocated.
extern "C" int dl4j_batchnorm_norm_act(
    const void* x, const void* mean, const void* var, const void* gamma,
    const void* beta, void* y, long long rows, int feats, float eps, int act,
    int dtype, int kinds, float mean_value, float var_value,
    float gamma_value, float beta_value, void* stream) {
  if (rows <= 0 || feats <= 0) return 0;
  BnVectors vecs{{mean, var, gamma, beta},
                 {mean_value, var_value, gamma_value, beta_value},
                 kinds};
  for (int w = 0; w < 4; ++w)  // read, never used: any valid address
    if (((kinds >> (4 * w)) & 15) == kByValue) vecs.ptr[w] = x;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return launch_bn<float>(x, y, vecs, rows, feats, eps, act, s);
  if (dtype == dl4j::kBFloat16)
    return launch_bn<__nv_bfloat16>(x, y, vecs, rows, feats, eps, act, s);
  if (dtype == dl4j::kFloat16)
    return launch_bn<__half>(x, y, vecs, rows, feats, eps, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
