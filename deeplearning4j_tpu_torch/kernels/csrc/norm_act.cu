// LayerNorm + affine + activation, one warp per row.
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

#include "common.cuh"

namespace {

constexpr int kIdentity = 0;
constexpr int kRelu = 1;
constexpr int kTanh = 2;
constexpr int kSigmoid = 3;

constexpr int kRowsPerBlock = 8;  // 8 warps, 256 threads

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kTanh: return tanhf(v);
    case kSigmoid: return 1.f / (1.f + expf(-v));
    default: return v;
  }
}

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
