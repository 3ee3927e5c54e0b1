// LayerNorm + affine + activation, one warp per row; BatchNorm apply +
// affine + activation, elementwise with per-channel vectors.
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
// The output is rounded to the input dtype once, at the store.
//
// BatchNorm apply replaces the TPU kernel `_bn_kernel`
// (deeplearning4j_tpu/kernels/norm_act.py:96, reached through
// `batchnorm_norm_act` :140): act(gamma * (x - mean) / sqrt(var + eps) + beta)
// over [rows, C] with the statistics given. Bound: bytes, as LayerNorm's: ~6
// flops per element against 4 bytes per bf16 element read and written. At
// ResNet-50's widest BatchNorm in training (B=256, 112x112x64: 205 M
// elements) the least time is 0.82 GB over 3.35 TB/s = 0.245 ms. Design: one
// 16-byte vector of x per thread step (8 bf16 / 4 f32 channels of one row, C
// a multiple of the vector), a grid-stride loop over the flat tensor; the
// four [C] vectors are 16-byte loads that stay in L1/L2 (4*C elements
// against rows*C). The math runs in f32 in the reference's order ((x - mean)
// / sqrt(var + eps), then gamma * . + beta) and rounds once at the store;
// the Pallas body computes at x's dtype, so in bf16 the two differ by bf16
// rounding.

#include "common.cuh"

namespace {

using dl4j::activate;

constexpr int kRowsPerBlock = 8;  // 8 warps, 256 threads

// NV 16-byte vectors per lane: F <= 32 * NV * (16 / sizeof(T)).
template <typename T, int NV>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layernorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                 const T* __restrict__ beta, T* __restrict__ y, int rows,
                 int feats, float eps, int act) {
  constexpr int VEC = 16 / sizeof(T);
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * feats;
  T* yr = y + static_cast<size_t>(row) * feats;

  float v[NV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * VEC;
    if (c < feats) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[i][j] = dl4j::to_f32(e[j]);
        sum += v[i][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] = 0.f;
    }
  }
  const float mu = dl4j::warp_sum(sum) / feats;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if ((i * 32 + lane) * VEC < feats) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[i][j] - mu;
        sq += d * d;
      }
    }
  }
  const float inv = rsqrtf(dl4j::warp_sum(sq) / feats + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * VEC;
    if (c < feats) {
      const uint4 graw = *reinterpret_cast<const uint4*>(gamma + c);
      const uint4 braw = *reinterpret_cast<const uint4*>(beta + c);
      const T* g = reinterpret_cast<const T*>(&graw);
      const T* b = reinterpret_cast<const T*>(&braw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float n = (v[i][j] - mu) * inv;
        o[j] = dl4j::from_f32<T>(
            activate(n * dl4j::to_f32(g[j]) + dl4j::to_f32(b[j]), act));
      }
      *reinterpret_cast<uint4*>(yr + c) = out;
    }
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* b, void* y, int rows,
           int feats, float eps, int act, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = (feats + 32 * VEC - 1) / (32 * VEC);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(32 * kRowsPerBlock);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if (nv <= 1)
    layernorm_kernel<T, 1><<<grid, block, 0, stream>>>(xp, gp, bp, yp, rows, feats, eps, act);
  else if (nv <= 2)
    layernorm_kernel<T, 2><<<grid, block, 0, stream>>>(xp, gp, bp, yp, rows, feats, eps, act);
  else if (nv <= 4)
    layernorm_kernel<T, 4><<<grid, block, 0, stream>>>(xp, gp, bp, yp, rows, feats, eps, act);
  else if (nv <= 8)
    layernorm_kernel<T, 8><<<grid, block, 0, stream>>>(xp, gp, bp, yp, rows, feats, eps, act);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBnThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kBnThreads)
batchnorm_kernel(const T* __restrict__ x, const T* __restrict__ mean,
                 const T* __restrict__ var, const T* __restrict__ gamma,
                 const T* __restrict__ beta, T* __restrict__ y,
                 size_t n_vec, int feats, float eps, int act) {
  constexpr int VEC = 16 / sizeof(T);
  for (size_t i = static_cast<size_t>(blockIdx.x) * kBnThreads + threadIdx.x;
       i < n_vec; i += static_cast<size_t>(gridDim.x) * kBnThreads) {
    const size_t e = i * VEC;
    const int c = static_cast<int>(e % feats);
    const uint4 xr = *reinterpret_cast<const uint4*>(x + e);
    const uint4 mr = *reinterpret_cast<const uint4*>(mean + c);
    const uint4 vr = *reinterpret_cast<const uint4*>(var + c);
    const uint4 gr = *reinterpret_cast<const uint4*>(gamma + c);
    const uint4 br = *reinterpret_cast<const uint4*>(beta + c);
    const T* xv = reinterpret_cast<const T*>(&xr);
    const T* mv = reinterpret_cast<const T*>(&mr);
    const T* vv = reinterpret_cast<const T*>(&vr);
    const T* gv = reinterpret_cast<const T*>(&gr);
    const T* bv = reinterpret_cast<const T*>(&br);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xhat = (dl4j::to_f32(xv[j]) - dl4j::to_f32(mv[j])) /
                         sqrtf(dl4j::to_f32(vv[j]) + eps);
      o[j] = dl4j::from_f32<T>(activate(
          dl4j::to_f32(gv[j]) * xhat + dl4j::to_f32(bv[j]), act));
    }
    *reinterpret_cast<uint4*>(y + e) = out;
  }
}

template <typename T>
int launch_bn(const void* x, const void* m, const void* v, const void* g,
              const void* b, void* y, int rows, int feats, float eps, int act,
              cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t n_vec = static_cast<size_t>(rows) * feats / VEC;
  // Enough blocks to fill the card several times over; the loop strides.
  const size_t want = (n_vec + kBnThreads - 1) / kBnThreads;
  const int grid = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  batchnorm_kernel<T><<<grid, kBnThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(m),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y), n_vec, feats, eps, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [rows, feats] contiguous; gamma, beta: [feats]; all of `dtype`, all
// 16-byte aligned, feats a multiple of 16 / sizeof(dtype) and at most
// 256 * 16 / sizeof(dtype) (checked by the Python wrapper).
extern "C" int dl4j_layernorm_norm_act(const void* x, const void* gamma,
                                       const void* beta, void* y, int rows,
                                       int feats, float eps, int act,
                                       int dtype, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return launch<float>(x, gamma, beta, y, rows, feats, eps, act, s);
  if (dtype == dl4j::kBFloat16)
    return launch<__nv_bfloat16>(x, gamma, beta, y, rows, feats, eps, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, y: [rows, feats] contiguous; mean, var, gamma, beta: [feats]; all of
// `dtype`, all 16-byte aligned, feats a multiple of 16 / sizeof(dtype)
// (checked by the Python wrapper).
extern "C" int dl4j_batchnorm_norm_act(const void* x, const void* mean,
                                       const void* var, const void* gamma,
                                       const void* beta, void* y, int rows,
                                       int feats, float eps, int act,
                                       int dtype, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return launch_bn<float>(x, mean, var, gamma, beta, y, rows, feats, eps,
                            act, s);
  if (dtype == dl4j::kBFloat16)
    return launch_bn<__nv_bfloat16>(x, mean, var, gamma, beta, y, rows, feats,
                                    eps, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
