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
