// Fused optimizer update: one elementwise pass over one layer's f32 state and
// gradients, for Adam, Nesterov momentum and RMSProp.
//
// Replaces the TPU kernels `_adam_kernel`, `_nesterovs_kernel` and
// `_rmsprop_kernel` (deeplearning4j_tpu/kernels/fused_update.py:109,121,129,
// built by `_flat_call` :137 and run by `pallas_update` :170 from `dispatch`
// :192, which `ops/updaters.py` calls once per layer vertex). The TPU version
// ravels the layer's grads and state into flat vectors padded to (8, 128)
// tiles; here the kernel takes the layer's tensors as they lie (up to
// kMaxTensors pointers per launch, passed by value), so nothing is raveled,
// padded or copied, and the state is updated IN PLACE.
//
// Bound on the H100: bytes. Adam reads m, v, g and writes m, v and the delta,
// 24 bytes per f32 element for ~15 flops: at the transformer_lm training
// step (21.5 M params over 24 layer vertices) that is ~516 MB, ~154 us at
// 3.35 TB/s, summed over the 24 launches. Nesterovs and RMSProp move 16.
//
// Design: a 1-D grid whose blocks are dealt out to the launch's tensors in
// proportion to their sizes (the per-tensor first block is passed in), so a
// 256-element bias and a 4 M-element weight each get just the blocks they
// need; each thread handles kPerThread elements at a block-wide stride,
// neighbouring threads on neighbouring addresses (coalesced). The scalars lr,
// bc1 = 1 - b1^t and bc2 = 1 - b2^t arrive computed in f32 on the host, as
// `_scalars` :159 computes them, and each body keeps the reference's operation
// order; nvcc may contract a*b + c into an FMA, which moves f32 rounding by an
// ulp against the plain version (tolerance rtol 1e-5). sqrtf and division
// stay IEEE (no fast math).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxTensors = 16;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kBlockElems = kThreads * kPerThread;

constexpr int kAdam = 0;
constexpr int kNesterovs = 1;
constexpr int kRmsprop = 2;

struct Tensors {
  float* s0[kMaxTensors];      // adam m, nesterovs v, rmsprop g2
  float* s1[kMaxTensors];      // adam v (unused otherwise)
  const float* g[kMaxTensors];
  float* d[kMaxTensors];       // the delta the caller subtracts
  int64_t n[kMaxTensors];
  int first_block[kMaxTensors + 1];
  int count;
};

// Scalars: [0] lr, [1] bc1, [2] bc2, then the kind's constants (see below).
struct Scalars {
  float v[8];
};

template <int KIND>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(Tensors ts, Scalars sc) {
  int t = 0;
  while (t + 1 < ts.count && static_cast<int>(blockIdx.x) >= ts.first_block[t + 1]) ++t;
  const int64_t n = ts.n[t];
  int64_t i = static_cast<int64_t>(blockIdx.x - ts.first_block[t]) * kBlockElems +
              threadIdx.x;
  float* s0 = ts.s0[t];
  float* s1 = ts.s1[t];
  const float* g = ts.g[t];
  float* d = ts.d[t];
  const float lr = sc.v[0];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r, i += kThreads) {
    if (i >= n) break;
    const float gi = g[i];
    if (KIND == kAdam) {
      // v[3..6] = beta1, 1 - beta1, beta2, 1 - beta2; v[7] = eps
      const float m = sc.v[3] * s0[i] + sc.v[4] * gi;
      const float vv = sc.v[5] * s1[i] + sc.v[6] * gi * gi;
      s0[i] = m;
      s1[i] = vv;
      d[i] = lr * (m / sc.v[1]) / (sqrtf(vv / sc.v[2]) + sc.v[7]);
    } else if (KIND == kNesterovs) {
      // v[3] = momentum, v[4] = 1 + momentum
      const float v0 = s0[i];
      const float vv = sc.v[3] * v0 - lr * gi;
      s0[i] = vv;
      d[i] = sc.v[3] * v0 - sc.v[4] * vv;
    } else {
      // v[3] = decay, v[4] = 1 - decay, v[5] = eps
      const float a = sc.v[3] * s0[i] + sc.v[4] * gi * gi;
      s0[i] = a;
      d[i] = lr * gi / sqrtf(a + sc.v[5]);
    }
  }
}

}  // namespace

// One launch over `count` (<= 16) f32 tensors: s0[i], s1[i] (null unless
// Adam), g[i] and d[i] are device pointers to n[i] contiguous floats;
// `ptrs` and `sizes` are host arrays of 4 * count pointers (s0, s1, g, d,
// each block of `count`) and count sizes; `scalars` a host array of 8 floats.
extern "C" int dl4j_fused_update(int kind, int count, const void* ptrs,
                                 const void* sizes, const void* scalars,
                                 void* stream) {
  if (count <= 0) return 0;
  if (count > kMaxTensors || kind < kAdam || kind > kRmsprop)
    return static_cast<int>(cudaErrorInvalidValue);
  void* const* p = static_cast<void* const*>(ptrs);
  const int64_t* n = static_cast<const int64_t*>(sizes);
  Tensors ts{};
  ts.count = count;
  int blocks = 0;
  for (int i = 0; i < count; ++i) {
    ts.s0[i] = static_cast<float*>(p[i]);
    ts.s1[i] = static_cast<float*>(p[count + i]);
    ts.g[i] = static_cast<const float*>(p[2 * count + i]);
    ts.d[i] = static_cast<float*>(p[3 * count + i]);
    ts.n[i] = n[i];
    ts.first_block[i] = blocks;
    const int64_t nb = (n[i] + kBlockElems - 1) / kBlockElems;
    if (blocks + nb > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    blocks += static_cast<int>(nb);
  }
  ts.first_block[count] = blocks;
  if (blocks == 0) return 0;
  Scalars sc;
  const float* f = static_cast<const float*>(scalars);
  for (int i = 0; i < 8; ++i) sc.v[i] = f[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kAdam)
    fused_update_kernel<kAdam><<<blocks, kThreads, 0, s>>>(ts, sc);
  else if (kind == kNesterovs)
    fused_update_kernel<kNesterovs><<<blocks, kThreads, 0, s>>>(ts, sc);
  else
    fused_update_kernel<kRmsprop><<<blocks, kThreads, 0, s>>>(ts, sc);
  return static_cast<int>(cudaGetLastError());
}
