// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel exposes one `extern "C"` entry that launches on the stream it
// is given, allocates nothing, and returns `cudaGetLastError()` so the Python
// wrapper (ctypes) can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace dl4j {

// dtype codes shared with kernels/_build.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;  // quantized weights (bottleneck_block.cu)
constexpr int kFloat16 = 3;
constexpr int kFloat64 = 4;  // the float64 forms (norm_act.cu, lstm_cell.cu)

// The JAX package's finite mask value (kernels/flash_attention.py `_NEG`).
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);  // round to nearest even, as XLA's convert
}

// The accumulation type of a kernel templated on its element type T: f32
// for f32, bf16 and f16, double for double (the float64 forms of the flash
// and paged attention kernels and of the bottleneck block, whose sums would
// not reach 1e-12 in f32). `to_acc` widens an element, `from_acc<T>`
// narrows a sum; `ex`, `lg`, `fmx`, `root`, `fmadd` are expf / logf / fmaxf
// / sqrtf / fmaf in f32 and exp / log / fmax / sqrt / fma in double, so an
// f32 instantiation makes the calls it made before the type was a
// parameter. `neg<A>()` is the JAX package's -1e30 mask and `tiny<A>()` the
// 1e-30 floor of a softmax normalizer, each written as a literal of A.
template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};
template <typename T>
using acc_t = typename AccOf<T>::type;

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_acc(__half x) { return __half2float(x); }
__device__ __forceinline__ double to_acc(double x) { return x; }

template <typename T>
__device__ __forceinline__ T from_acc(acc_t<T> x) {
  return from_f32<T>(x);
}
template <>
__device__ __forceinline__ double from_acc<double>(double x) { return x; }

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float fmx(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmx(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename A>
__host__ __device__ constexpr A neg();
template <>
__host__ __device__ constexpr float neg<float>() { return kNeg; }
template <>
__host__ __device__ constexpr double neg<double>() { return -1e30; }
template <typename A>
__host__ __device__ constexpr A tiny();
template <>
__host__ __device__ constexpr float tiny<float>() { return 1e-30f; }
template <>
__host__ __device__ constexpr double tiny<double>() { return 1e-30; }

// Activation codes shared with kernels/norm_act.py `_ACT_CODES`.
constexpr int kIdentity = 0;
constexpr int kRelu = 1;
constexpr int kTanh = 2;
constexpr int kSigmoid = 3;

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kTanh: return tanhf(v);
    case kSigmoid: return 1.f / (1.f + expf(-v));
    default: return v;
  }
}

__device__ __forceinline__ double activate(double v, int act) {
  switch (act) {
    case kRelu: return fmax(v, 0.0);
    case kTanh: return tanh(v);
    case kSigmoid: return 1.0 / (1.0 + exp(-v));
    default: return v;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// cp.async (sm_80+): BYTES (4, 8 or 16) from global to shared memory without
// a register on the way; `src_bytes` < BYTES fills the rest with zeros (0:
// nothing is read, `src` need only be a valid address). Each thread's copies
// since its last commit form one group; `cp_async_wait<N>` returns when at
// most N of its groups are still in flight.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes = BYTES) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace dl4j
