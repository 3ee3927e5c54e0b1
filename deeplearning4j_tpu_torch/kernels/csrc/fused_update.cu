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
// Two additions serve the precision policies (nn/engine.py):
// - A skip flag: a pointer to one device int. Where it is set, the launch
//   writes nothing, so params, masters and state keep their old bits, as
//   the reference's `jnp.where(finite, new, old)` keeps them when a
//   loss-scaled step's gradients are not finite. A null pointer is no flag.
//   Every block reads the flag before it loads anything; the host never
//   reads it, so the skip costs no sync.
// - Low-precision params (template LP, apply modes only): each entry may
//   carry the stored bf16 or f16 param beside its f32 master (`out`). The
//   kernel updates the master in f32 exactly as without it and writes both
//   the master and its round-to-nearest-even cast (the cast PyTorch's
//   `copy_` and XLA's convert make).
// With no flag and LP = 0 the arithmetic and the stores are what they were.
//
// A third addition serves a captured CUDA graph (nn/superstep.py), whose
// launches keep the parameters they were captured with: the device-scalar
// form (template DEV) reads the 8 shared floats and each tensor's lr from a
// device buffer (`dsc`: c[0..7], then lr[i] at 8 + i) that the host fills
// before each replay, instead of from the table. The values, and so the
// arithmetic, are the host form's.
//
// Bound on the H100: bytes. Adam reads p, g, m, v and writes p, m, v: 28
// bytes per f32 element for ~15 flops. At the transformer_lm training step
// (21,529,600 params in 66 tensors) that is 602.8 MB, 0.1800 ms at 3.35
// TB/s. Nesterovs and RMSProp move 20 bytes per element. With a bf16 or f16
// copy written too, Adam moves 30 bytes per element (0.1928 ms at the LM).
//
// The float64 form (dtype kFloat64, a float64 policy's step) is the same
// kernel over a table of doubles (`Table<double>`): params, grads and state
// are f64, and so are the per-tensor lrs and factors and the 8 shared
// scalars, which the host hands over as doubles: bc1 and bc2 as the
// reference's f32 `_scalars` computes them, widened exactly, and the kind's
// constants (1 - beta1, ...) in double as the reference's Python floats are.
// Its bodies are the reference's expressions in double as written (the
// plain version is held to them at 1e-12 relative, not bit for bit); it has
// no low-precision copy and runs the scalar loop. Both modes, the skip flag
// and the device-scalar form (doubles: c[0..7], then lr[i] at 8 + i) are
// the f32 form's. Bound: bytes, 56 per element for Adam, 40 for Nesterovs
// and RMSProp; the LM's step at f64 moves 1.206 GB, 0.36 ms at 3.35 TB/s.
//
// Design, for a pure byte stream:
// - The tensor table is one kernel parameter (`Table`, 15.5 KB in f32
//   and 17.5 KB in f64 at kMaxTensors = 256): CUDA 12.1+ takes kernel parameters up to 32,764
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

#include <cuda_fp16.h>

#include <cstdint>
#include <type_traits>

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

// The stored copy's type (dl4j dtype codes): none, bf16, f16.
constexpr int kLpNone = 0;
constexpr int kLpBf16 = dl4j::kBFloat16;
constexpr int kLpF16 = dl4j::kFloat16;

// One tensor table, in f32 (A = float) or, for the float64 form, in double:
// the tensors, lrs, factors and shared scalars all of A.
template <typename A>
struct Table {
  A* out[kMaxTensors];         // params (apply) or deltas (kDeltas)
  const A* g[kMaxTensors];
  A* s0[kMaxTensors];          // adam m, nesterovs v, rmsprop g2
  A* s1[kMaxTensors];          // adam v (null otherwise)
  uint16_t* lp[kMaxTensors];   // the stored bf16/f16 params (LP != 0)
  int64_t n[kMaxTensors];
  A lr[kMaxTensors];           // the tensor's layer's scheduled lr
  A factor[kMaxTensors];       // bias-rate factor, 1 for most tensors
  int first_chunk[kMaxTensors + 1];
  int count;
  const int* skip;             // the skip flag, or null
  const A* dsc;                // the device scalars (DEV), or null
  // c[0] bc1, c[1] bc2, then the kind's constants:
  //   adam      c[2..6] = beta1, 1 - beta1, beta2, 1 - beta2, eps
  //   nesterovs c[2..3] = momentum, 1 + momentum
  //   rmsprop   c[2..4] = decay, 1 - decay, eps
  A c[8];
};

// The bodies: state in/out by reference, the delta returned. Each keeps the
// reference's operation order (fused_update.py:77-103). In f32 the roundings
// are pinned (see the note above) to what nvcc made of the plain expressions
// in the per-layer kernel this one replaced, as its SASS and a bitwise
// comparison on the card show: Adam's and Nesterovs' a*b + c*d as
// fma(c, d, a*b), RMSProp's decay * g2 + (1 - decay) * g * g as
// fma(decay, g2, ((1 - decay) * g) * g). The other forms differ by an ulp
// in up to a quarter of the elements, and ResNet-50's first Nesterovs steps
// at lr 0.1 (chip_smoke's T1) are sensitive enough to such ulps to rise
// instead of fall. In double the bodies are the reference's expressions as
// written.
__device__ __forceinline__ float adam_body(float g, float& m, float& v,
                                           float lr, const float* c) {
  m = __fmaf_rn(c[3], g, __fmul_rn(c[2], m));
  v = __fmaf_rn(__fmul_rn(c[5], g), g, __fmul_rn(c[4], v));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c[1])), c[6]);
  return __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m, c[0])), den);
}

__device__ __forceinline__ double adam_body(double g, double& m, double& v,
                                            double lr, const double* c) {
  m = c[2] * m + c[3] * g;
  v = c[4] * v + c[5] * g * g;
  return lr * (m / c[0]) / (sqrt(v / c[1]) + c[6]);
}

__device__ __forceinline__ float nesterovs_body(float g, float& v, float lr,
                                                const float* c) {
  const float v0 = v;
  v = __fmaf_rn(-lr, g, __fmul_rn(c[2], v0));
  // ND4J: the applied update is -(mu * vPrev) + (1 + mu) * v, negated
  // because the caller subtracts.
  return __fmaf_rn(-c[3], v, __fmul_rn(c[2], v0));
}

__device__ __forceinline__ double nesterovs_body(double g, double& v,
                                                 double lr, const double* c) {
  const double v0 = v;
  v = c[2] * v0 - lr * g;
  return c[2] * v0 - c[3] * v;
}

__device__ __forceinline__ float rmsprop_body(float g, float& s, float lr,
                                              const float* c) {
  s = __fmaf_rn(c[2], s, __fmul_rn(__fmul_rn(c[3], g), g));
  return __fdiv_rn(__fmul_rn(lr, g), __fsqrt_rn(__fadd_rn(s, c[4])));
}

__device__ __forceinline__ double rmsprop_body(double g, double& s, double lr,
                                               const double* c) {
  s = c[2] * s + c[3] * g * g;
  return lr * g / sqrt(s + c[4]);
}

// `* factor` and `p -/+ d`, each rounded once (never one FMA).
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <int KIND, int MODE, typename A>
__device__ __forceinline__ A update(A g, A& a, A& b, A p, A lr, A factor,
                                    const A* c) {
  A d;
  if (KIND == kAdam) d = adam_body(g, a, b, lr, c);
  else if (KIND == kNesterovs) d = nesterovs_body(g, a, lr, c);
  else d = rmsprop_body(g, a, lr, c);
  if (MODE == kDeltas) return d;
  if (factor != A(1)) d = mul_rn(d, factor);
  return MODE == kSub ? sub_rn(p, d) : add_rn(p, d);
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

// The bits of x's round-to-nearest-even cast to the stored type.
template <int LP>
__device__ __forceinline__ uint32_t lp_bits(float x) {
  if constexpr (LP == kLpBf16) return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  else return __half_as_ushort(__float2half_rn(x));
}

// An f32 chunk whose pointers are all 16-byte aligned moves as float4 (see
// the note above); everything else, and every f64 chunk, runs the scalar
// loop.
template <typename A, int KIND, int MODE, int LP, bool DEV>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fused_update_kernel(const __grid_constant__ Table<A> t) {
  constexpr bool kTwo = KIND == kAdam;  // a second state tensor
  constexpr bool kReadOut = MODE != kDeltas;
  if (t.skip != nullptr && *t.skip != 0) return;  // a skipped step
  A dc[8];  // the device scalars (DEV)
  if constexpr (DEV) {
#pragma unroll
    for (int k = 0; k < 8; ++k) dc[k] = t.dsc[k];
  }
  const A* c = DEV ? dc : t.c;
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
    A* out = t.out[i] + start;
    const A* g = t.g[i] + start;
    A* s0 = t.s0[i] + start;
    A* s1 = kTwo ? t.s1[i] + start : nullptr;
    uint16_t* lp = LP != kLpNone ? t.lp[i] + start : nullptr;
    const A lr = DEV ? t.dsc[8 + i] : t.lr[i];
    const A factor = t.factor[i];
    int64_t scalar_from = 0;
    if constexpr (std::is_same<A, float>::value) {
      const uintptr_t bits = reinterpret_cast<uintptr_t>(out) |
                             reinterpret_cast<uintptr_t>(g) |
                             reinterpret_cast<uintptr_t>(s0) |
                             reinterpret_cast<uintptr_t>(s1) |
                             reinterpret_cast<uintptr_t>(lp);
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
              update4<KIND, MODE>(gv[u], av[u], bv[u], pv[u], lr, factor, c);
              a4[j] = av[u];
              if (kTwo) b4[j] = bv[u];
              out4[j] = pv[u];
              if constexpr (LP != kLpNone)
                reinterpret_cast<uint2*>(lp)[j] = make_uint2(
                    lp_bits<LP>(pv[u].x) | lp_bits<LP>(pv[u].y) << 16,
                    lp_bits<LP>(pv[u].z) | lp_bits<LP>(pv[u].w) << 16);
            }
          }
        }
        scalar_from = static_cast<int64_t>(nv) << 2;
      }
    }
    for (int64_t j = scalar_from + threadIdx.x; j < len; j += kThreads) {
      A a = s0[j];
      A b = kTwo ? s1[j] : A(0);
      const A p = kReadOut ? out[j] : A(0);
      const A r = update<KIND, MODE>(g[j], a, b, p, lr, factor, c);
      s0[j] = a;
      if (kTwo) s1[j] = b;
      out[j] = r;
      if constexpr (LP != kLpNone) lp[j] = static_cast<uint16_t>(lp_bits<LP>(r));
    }
  }
}

template <typename A, int KIND, int MODE, bool DEV>
void launch_lp(int lp, int blocks, const Table<A>& t, cudaStream_t s) {
  if constexpr (std::is_same<A, float>::value) {
    if (lp == kLpBf16) {
      fused_update_kernel<A, KIND, MODE, kLpBf16, DEV><<<blocks, kThreads, 0, s>>>(t);
      return;
    }
    if (lp == kLpF16) {
      fused_update_kernel<A, KIND, MODE, kLpF16, DEV><<<blocks, kThreads, 0, s>>>(t);
      return;
    }
  }
  fused_update_kernel<A, KIND, MODE, kLpNone, DEV><<<blocks, kThreads, 0, s>>>(t);
}

template <typename A, int KIND, bool DEV>
cudaError_t launch_kind(int mode, int lp, int blocks, const Table<A>& t,
                        cudaStream_t s) {
  if (mode == kDeltas)
    fused_update_kernel<A, KIND, kDeltas, kLpNone, DEV><<<blocks, kThreads, 0, s>>>(t);
  else if (mode == kSub)
    launch_lp<A, KIND, kSub, DEV>(lp, blocks, t, s);
  else
    launch_lp<A, KIND, kAdd, DEV>(lp, blocks, t, s);
  return cudaGetLastError();
}

template <typename A, int KIND>
cudaError_t launch_form(int mode, int lp, int blocks, const Table<A>& t,
                        cudaStream_t s) {
  if (t.dsc != nullptr) return launch_kind<A, KIND, true>(mode, lp, blocks, t, s);
  return launch_kind<A, KIND, false>(mode, lp, blocks, t, s);
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

template <typename A>
int run(int kind, int mode, int count, const void* ptrs, const void* sizes,
        const void* lrs, const void* factors, const void* scalars,
        int lp_dtype, const void* skip, const void* dev_scalars,
        cudaStream_t s) {
  void* const* p = static_cast<void* const*>(ptrs);
  const int64_t* n = static_cast<const int64_t*>(sizes);
  const A* lr = static_cast<const A*>(lrs);
  const A* fa = static_cast<const A*>(factors);
  static thread_local Table<A> t;  // 15.5 KB in f32: off the caller's stack
  t.count = count;
  int64_t chunks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    t.out[i] = static_cast<A*>(p[i]);
    t.g[i] = static_cast<const A*>(p[count + i]);
    t.s0[i] = static_cast<A*>(p[2 * count + i]);
    t.s1[i] = static_cast<A*>(p[3 * count + i]);
    t.lp[i] = static_cast<uint16_t*>(p[4 * count + i]);
    if (lp_dtype != kLpNone && t.lp[i] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    t.n[i] = n[i];
    t.lr[i] = lr[i];
    t.factor[i] = fa[i];
    t.first_chunk[i] = static_cast<int>(chunks);
    chunks += (n[i] + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.first_chunk[count] = static_cast<int>(chunks);
  t.skip = static_cast<const int*>(skip);
  t.dsc = static_cast<const A*>(dev_scalars);
  const A* c = static_cast<const A*>(scalars);
  for (int i = 0; i < 8; ++i) t.c[i] = c[i];
  const int blocks = static_cast<int>(
      chunks < static_cast<int64_t>(sm_count()) * kBlocksPerSm
          ? chunks : static_cast<int64_t>(sm_count()) * kBlocksPerSm);
  if (kind == kAdam)
    return static_cast<int>(launch_form<A, kAdam>(mode, lp_dtype, blocks, t, s));
  if (kind == kNesterovs)
    return static_cast<int>(
        launch_form<A, kNesterovs>(mode, lp_dtype, blocks, t, s));
  return static_cast<int>(launch_form<A, kRmsprop>(mode, lp_dtype, blocks, t, s));
}

}  // namespace

extern "C" int dl4j_fused_update_capacity() { return kMaxTensors; }

// One launch over `count` (<= kMaxTensors) tensors of `dtype` (f32 or f64).
// `ptrs` is a host array of 5 * count device pointers in blocks of `count`:
// out (params or f32 masters, or deltas in kDeltas mode), g, s0, s1 (null
// unless Adam), lp (the stored bf16/f16 params; null unless `lp_dtype`
// names one); `sizes` count int64 element counts; `lrs` and `factors` count
// values of `dtype`; `scalars` 8 of them, Table::c. `mode`: 0 deltas,
// 1 p -= d, 2 p += d. `lp_dtype`: 0 none, else the dtype code of the stored
// copies (f32 apply modes only). `skip`: a device int (nonzero: write
// nothing), or null. `dev_scalars`: null, or the device buffer of the
// device-scalar form (8 values as `scalars`, then `count` lrs, of `dtype`),
// read in place of `scalars` and `lrs`.
extern "C" int dl4j_fused_update(int kind, int mode, int count,
                                 const void* ptrs, const void* sizes,
                                 const void* lrs, const void* factors,
                                 const void* scalars, int dtype, int lp_dtype,
                                 const void* skip, const void* dev_scalars,
                                 void* stream) {
  if (count <= 0) return 0;
  if (count > kMaxTensors || kind < kAdam || kind > kRmsprop ||
      mode < kDeltas || mode > kAdd ||
      (lp_dtype != kLpNone &&
       (mode == kDeltas || dtype != dl4j::kFloat32 ||
        (lp_dtype != kLpBf16 && lp_dtype != kLpF16))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return run<float>(kind, mode, count, ptrs, sizes, lrs, factors, scalars,
                      lp_dtype, skip, dev_scalars, s);
  if (dtype == dl4j::kFloat64)
    return run<double>(kind, mode, count, ptrs, sizes, lrs, factors, scalars,
                       lp_dtype, skip, dev_scalars, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
