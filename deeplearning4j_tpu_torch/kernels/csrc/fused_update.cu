// Fused optimizer update: one elementwise pass over every f32 param, state
// and gradient tensor of a training step that shares one updater kind and
// hyperparameter tuple, for Adam, Nesterov momentum and RMSProp.
//
// Replaces the TPU kernels `_adam_kernel`, `_nesterovs_kernel` and
// `_rmsprop_kernel` (deeplearning4j_tpu/kernels/fused_update.py:109,121,129,
// built by `_flat_call` :137 and run by `pallas_update` :170 from `dispatch`
// :190). The TPU version ravels one layer's grads and state into flat
// vectors padded to (8, 128) tiles and returns the deltas; the reference
// then subtracts them inside the same jitted step. Here the kernel takes the
// tensors as they lie, so nothing is raveled, padded or copied, and it has
// two modes (a template flag):
//
// - apply (kSub / kAdd): the step's entry (`fused_update.apply_step`). Per
//   element d = body(g, state), d *= factor where factor != 1 (the bias-rate
//   factor), p -= d (kSub, minimize) or p += d (kAdd); state and params are
//   written IN PLACE and no delta is stored. One launch takes every tensor of
//   the step, up to kMaxTensors.
// - deltas (kDeltas): the per-layer seam (`fused_update.dispatch`), which
//   writes d to a delta tensor and the state in place, as the reference's
//   `dispatch` returns (new_state, deltas).
//
// Both modes call one body (`adam_body`, `nesterovs_body`, `rmsprop_body`),
// whose roundings are pinned with __fmul_rn / __fmaf_rn / __fdiv_rn /
// __fsqrt_rn so that nvcc cannot contract it differently in the two modes;
// the apply mode's `* factor` and `p -/+ d` are __fmul_rn and __fsub_rn /
// __fadd_rn, never one FMA. So the apply mode is bit-identical to the deltas
// mode followed by PyTorch's `d * factor` and `p.sub_(d)`, and both to the
// per-layer kernel this one replaced (see the bodies). The scalars arrive
// computed in f32 on the host, as the reference's `_scalars` :159 computes
// them: each tensor's scheduled lr, and bc1 = 1 - b1^t, bc2 = 1 - b2^t.
// Against the plain PyTorch bodies the pinned FMAs move f32 rounding by an ulp
// (tolerance rtol 1e-5).
//
// Bound on the H100: bytes. Adam reads p, g, m, v and writes p, m, v: 28
// bytes per f32 element for ~15 flops. At the transformer_lm training step
// (21,529,600 params in 66 tensors) that is 602.8 MB, 0.1800 ms at 3.35
// TB/s. Nesterovs and RMSProp move 20 bytes per element.
//
// Design, for a pure byte stream:
// - The tensor table is one kernel parameter (`Table`, 13.4 KB at
//   kMaxTensors = 256): CUDA 12.1+ takes kernel parameters up to 32,764
//   bytes, so the launch carries it and no device table or upload exists.
//   It is `__grid_constant__`, read in place, never copied per thread.
//   256 tensors hold one launch over the LM step (66) and ResNet-50's step
//   (161); past that the host launches again over the next 256.
// - Each tensor is cut into chunks of kChunk elements; `first_chunk` is the
//   prefix of the tensors' chunk counts. A grid of (SMs x kBlocksPerSm)
//   blocks walks the chunks grid-stride, and each block finds a chunk's
//   tensor by binary search over `first_chunk` (log2 of the tensor count,
//   once per chunk), so the cost does not grow with the count of tensors.
// - A tensor whose pointers are all 16-byte aligned moves as float4: each
//   thread issues the loads of kUnroll vectors of every operand before any
//   arithmetic, then stores. A chunk starts at a multiple of kChunk
//   elements, so its vectors stay aligned; the last chunk's numel % 4 tail
//   runs scalar. A tensor with a misaligned pointer (a view) runs the scalar
//   loop, in the kernel: never the plain version.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxTensors = 256;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kChunk = 8192;  // elements; a multiple of 4 * kThreads
constexpr int kUnroll = 2;    // float4s of each operand in flight a thread

constexpr int kAdam = 0;
constexpr int kNesterovs = 1;
constexpr int kRmsprop = 2;

constexpr int kDeltas = 0;  // d -> out (dispatch)
constexpr int kSub = 1;     // out -= d (apply_step, minimize)
constexpr int kAdd = 2;     // out += d (apply_step, maximize)

struct Table {
  float* out[kMaxTensors];     // params (apply) or deltas (kDeltas)
  const float* g[kMaxTensors];
  float* s0[kMaxTensors];      // adam m, nesterovs v, rmsprop g2
  float* s1[kMaxTensors];      // adam v (null otherwise)
  int64_t n[kMaxTensors];
  float lr[kMaxTensors];       // the tensor's layer's scheduled lr, in f32
  float factor[kMaxTensors];   // bias-rate factor, 1 for most tensors
  int first_chunk[kMaxTensors + 1];
  int count;
  // c[0] bc1, c[1] bc2, then the kind's constants:
  //   adam      c[2..6] = beta1, 1 - beta1, beta2, 1 - beta2, eps
  //   nesterovs c[2..3] = momentum, 1 + momentum
  //   rmsprop   c[2..4] = decay, 1 - decay, eps
  float c[8];
};

// The bodies: state in/out by reference, the delta returned. Each keeps the
// reference's operation order (fused_update.py:77-103), with its roundings
// pinned (see the note above) to what nvcc made of the plain expressions in
// the per-layer kernel this one replaced, as its SASS and a bitwise
// comparison on the card show: Adam's and Nesterovs' a*b + c*d as
// fma(c, d, a*b), RMSProp's decay * g2 + (1 - decay) * g * g as
// fma(decay, g2, ((1 - decay) * g) * g). The other forms differ by an ulp
// in up to a quarter of the elements, and ResNet-50's first Nesterovs steps
// at lr 0.1 (chip_smoke's T1) are sensitive enough to such ulps to rise
// instead of fall.
__device__ __forceinline__ float adam_body(float g, float& m, float& v,
                                           float lr, const float* c) {
  m = __fmaf_rn(c[3], g, __fmul_rn(c[2], m));
  v = __fmaf_rn(__fmul_rn(c[5], g), g, __fmul_rn(c[4], v));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c[1])), c[6]);
  return __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m, c[0])), den);
}

__device__ __forceinline__ float nesterovs_body(float g, float& v, float lr,
                                                const float* c) {
  const float v0 = v;
  v = __fmaf_rn(-lr, g, __fmul_rn(c[2], v0));
  // ND4J: the applied update is -(mu * vPrev) + (1 + mu) * v, negated
  // because the caller subtracts.
  return __fmaf_rn(-c[3], v, __fmul_rn(c[2], v0));
}

__device__ __forceinline__ float rmsprop_body(float g, float& s, float lr,
                                              const float* c) {
  s = __fmaf_rn(c[2], s, __fmul_rn(__fmul_rn(c[3], g), g));
  return __fdiv_rn(__fmul_rn(lr, g), __fsqrt_rn(__fadd_rn(s, c[4])));
}

template <int KIND, int MODE>
__device__ __forceinline__ float update(float g, float& a, float& b, float p,
                                        float lr, float factor,
                                        const float* c) {
  float d;
  if (KIND == kAdam) d = adam_body(g, a, b, lr, c);
  else if (KIND == kNesterovs) d = nesterovs_body(g, a, lr, c);
  else d = rmsprop_body(g, a, lr, c);
  if (MODE == kDeltas) return d;
  if (factor != 1.f) d = __fmul_rn(d, factor);
  return MODE == kSub ? __fsub_rn(p, d) : __fadd_rn(p, d);
}

template <int KIND, int MODE>
__device__ __forceinline__ void update4(const float4& g, float4& a, float4& b,
                                        float4& p, float lr, float factor,
                                        const float* c) {
  p.x = update<KIND, MODE>(g.x, a.x, b.x, p.x, lr, factor, c);
  p.y = update<KIND, MODE>(g.y, a.y, b.y, p.y, lr, factor, c);
  p.z = update<KIND, MODE>(g.z, a.z, b.z, p.z, lr, factor, c);
  p.w = update<KIND, MODE>(g.w, a.w, b.w, p.w, lr, factor, c);
}

template <int KIND, int MODE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fused_update_kernel(const __grid_constant__ Table t) {
  constexpr bool kTwo = KIND == kAdam;  // a second state tensor
  constexpr bool kReadOut = MODE != kDeltas;
  const int chunks = t.first_chunk[t.count];
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    int lo = 0, hi = t.count - 1;  // the last i with first_chunk[i] <= chunk
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.first_chunk[mid] <= chunk) lo = mid; else hi = mid - 1;
    }
    const int i = lo;
    const int64_t start = static_cast<int64_t>(chunk - t.first_chunk[i]) * kChunk;
    const int64_t len = min(t.n[i] - start, static_cast<int64_t>(kChunk));
    float* out = t.out[i] + start;
    const float* g = t.g[i] + start;
    float* s0 = t.s0[i] + start;
    float* s1 = kTwo ? t.s1[i] + start : nullptr;
    const float lr = t.lr[i];
    const float factor = t.factor[i];
    const uintptr_t bits = reinterpret_cast<uintptr_t>(out) |
                           reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(s0) |
                           reinterpret_cast<uintptr_t>(s1);
    int64_t scalar_from = 0;
    if ((bits & 15) == 0) {
      const int nv = static_cast<int>(len >> 2);
      float4* out4 = reinterpret_cast<float4*>(out);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* a4 = reinterpret_cast<float4*>(s0);
      float4* b4 = reinterpret_cast<float4*>(s1);
      for (int base = threadIdx.x; base < nv; base += kThreads * kUnroll) {
        float4 gv[kUnroll], av[kUnroll], bv[kUnroll], pv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {  // every load first
          const int j = base + u * kThreads;
          if (j < nv) {
            gv[u] = g4[j];
            av[u] = a4[j];
            bv[u] = kTwo ? b4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
            pv[u] = kReadOut ? out4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = base + u * kThreads;
          if (j < nv) {
            update4<KIND, MODE>(gv[u], av[u], bv[u], pv[u], lr, factor, t.c);
            a4[j] = av[u];
            if (kTwo) b4[j] = bv[u];
            out4[j] = pv[u];
          }
        }
      }
      scalar_from = static_cast<int64_t>(nv) << 2;
    }
    for (int64_t j = scalar_from + threadIdx.x; j < len; j += kThreads) {
      float a = s0[j];
      float b = kTwo ? s1[j] : 0.f;
      const float p = kReadOut ? out[j] : 0.f;
      const float r = update<KIND, MODE>(g[j], a, b, p, lr, factor, t.c);
      s0[j] = a;
      if (kTwo) s1[j] = b;
      out[j] = r;
    }
  }
}

template <int KIND>
cudaError_t launch_kind(int mode, int blocks, const Table& t, cudaStream_t s) {
  if (mode == kDeltas)
    fused_update_kernel<KIND, kDeltas><<<blocks, kThreads, 0, s>>>(t);
  else if (mode == kSub)
    fused_update_kernel<KIND, kSub><<<blocks, kThreads, 0, s>>>(t);
  else
    fused_update_kernel<KIND, kAdd><<<blocks, kThreads, 0, s>>>(t);
  return cudaGetLastError();
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!cached[dev] &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return cached[dev];
}

}  // namespace

extern "C" int dl4j_fused_update_capacity() { return kMaxTensors; }

// One launch over `count` (<= kMaxTensors) f32 tensors. `ptrs` is a host
// array of 4 * count device pointers in blocks of `count`: out (params, or
// deltas in kDeltas mode), g, s0, s1 (null unless Adam); `sizes` count
// int64 element counts; `lrs` and `factors` count floats; `scalars` 8
// floats, Table::c. `mode`: 0 deltas, 1 p -= d, 2 p += d.
extern "C" int dl4j_fused_update(int kind, int mode, int count,
                                 const void* ptrs, const void* sizes,
                                 const void* lrs, const void* factors,
                                 const void* scalars, void* stream) {
  if (count <= 0) return 0;
  if (count > kMaxTensors || kind < kAdam || kind > kRmsprop ||
      mode < kDeltas || mode > kAdd)
    return static_cast<int>(cudaErrorInvalidValue);
  void* const* p = static_cast<void* const*>(ptrs);
  const int64_t* n = static_cast<const int64_t*>(sizes);
  const float* lr = static_cast<const float*>(lrs);
  const float* fa = static_cast<const float*>(factors);
  static thread_local Table t;  // 13.4 KB: off the caller's stack
  t.count = count;
  int64_t chunks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    t.out[i] = static_cast<float*>(p[i]);
    t.g[i] = static_cast<const float*>(p[count + i]);
    t.s0[i] = static_cast<float*>(p[2 * count + i]);
    t.s1[i] = static_cast<float*>(p[3 * count + i]);
    t.n[i] = n[i];
    t.lr[i] = lr[i];
    t.factor[i] = fa[i];
    t.first_chunk[i] = static_cast<int>(chunks);
    chunks += (n[i] + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.first_chunk[count] = static_cast<int>(chunks);
  const float* c = static_cast<const float*>(scalars);
  for (int i = 0; i < 8; ++i) t.c[i] = c[i];
  const int blocks = static_cast<int>(
      chunks < static_cast<int64_t>(sm_count()) * kBlocksPerSm
          ? chunks : static_cast<int64_t>(sm_count()) * kBlocksPerSm);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kAdam) return static_cast<int>(launch_kind<kAdam>(mode, blocks, t, s));
  if (kind == kNesterovs)
    return static_cast<int>(launch_kind<kNesterovs>(mode, blocks, t, s));
  return static_cast<int>(launch_kind<kRmsprop>(mode, blocks, t, s));
}
