// Flash attention backward: dq over q tiles, dk/dv over k tiles, p recomputed
// from the forward's lse.
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
// (deeplearning4j_tpu/kernels/flash_attention.py:386,426, launched by
// `_flash_bwd_bhtd` :499 from the custom_vjp's `_bwd` :324). As there, the
// backward never holds a [T, T] matrix: both kernels recompute
// s = q k^T * scale and p = exp(s - lse) tile by tile, with
// D = rowsum(do * o) computed beforehand by the caller (a torch op, as JAX
// computes it in XLA at :502):
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - D),
//   dq = ds k * scale,  dk = ds^T q * scale.
//
// Bound on the H100 at the training step (B*H = 128, T = 1024, D = 64, bf16,
// causal): the two kernels do 7 products of T^2 * D over the causal half (dq:
// s, dp, dq; dk/dv: s, dp, dv, dk), ~60 GFLOP, 61 us at 989 TFLOP/s, against
// ~100-230 MB of reads and writes (q, k, v, o, do, lse, D in; dq, dk, dv
// out), ~30-70 us: operations bound it on tensor cores.
//
// Design: two forms of each kernel, picked by the wrapper by dtype and head
// width alone (kernels/flash_attention.py `resident_variant`, one rule for
// both):
// - bf16 at D = 64 or 128, the training step's case: row 7's tensor-core
//   tile kernels, `stream_dq_wgmma_kernel` and `stream_dkv_wgmma_kernel`
//   (csrc/flash_attention_stream.cu, reached through flash_wgmma.cuh),
//   over their rows schedule: one warpgroup per (batch*head, 64-row tile),
//   the longest causal runs issued first. dq holds its q tile's Q and dO in
//   128-byte-swizzled shared memory and streams (K, V) from tile 0 to the
//   diagonal; dk/dv holds K and V and streams (Q, dO) from the diagonal to
//   the last tile; the streamed pair comes by TMA through a 3-stage (D =
//   64) or 2-stage (D = 128) mbarrier ring. Every product (s, dp, ds k;
//   s^T, dp^T, p^T do, ds^T q) is a wgmma m64n64k16, p and ds rounded to
//   bf16 as register A; p = exp2 of the scaled scores less lse in f32
//   registers, set to 0 by the kernel for keys or queries at or past T and
//   for key > query when causal. A block is its whole run: dq, or dk and
//   dv, go out from registers, with no workspace and no sum kernel, one
//   launch per call, and no atomics. That takes the ~60 GFLOP of the
//   training shape to the tensor cores (61 us at 989 TFLOP/s).
// - f32, and bf16 at any other D: the CUDA-core kernels below, which follow
//   the forward's layout (csrc/flash_attention.cu): one block per
//   (batch*head, 64-row tile), a row owned by G threads (G = next power of
//   two >= D/16), each holding 16 of its dims in f32 registers, interleaved
//   so the G threads of a row read consecutive shared-memory words; row
//   dot products reduce with warp shuffles. dq holds its 64 query rows (q,
//   do, dq, lse, D in registers) and streams 64-key K/V tiles through
//   shared memory up to the causal diagonal; dk/dv holds its 64 key rows
//   (k, v, dk, dv in registers) and streams 64-row Q/dO tiles (with their
//   lse and D) from the diagonal on, so the upper triangle is neither read
//   nor computed.
// f16 (the mixed_float16 and float16 policies) takes both forms too, the
// tensor-core kernels at `__half`. There f16's range (largest value 65,504)
// is the hazard the reference's f32 bodies do not have: the CUDA-core kernel
// keeps ds in f32 registers, but the tensor-core form rounds each dS tile to
// the element type as register A, and under a loss scale of 2^15 a dS tile
// can pass 65,504 where the f32 one does not. So in f16 each row of each dS
// tile is first multiplied by a power of two that puts its largest value
// below 2^14, and the f32 accumulator row it adds into is held at the same
// power and brought back at the store (`f16_row_scale`, csrc/
// flash_attention_stream.cu). Powers of two are exact, so this costs no
// precision, and it keeps 11 bits of each value relative to its row's
// largest, where bf16's tiles keep 8 at any magnitude; dS staying in f32 on
// the CUDA cores instead would give up the tensor cores for the ds products.
//
// f64 runs the CUDA-core kernels instantiated at double: the staged tiles,
// the registers, lse and D (float64 [B, H, T], as the f64 forward writes
// lse) and the scale are double (`dl4j::acc_t`), so the recomputed p and
// every sum carry double rounding only. The dk/dv tiles then take 66.5 KB
// of dynamic shared memory at D = 64. Bound at [16, 1024, 8, 64] causal:
// dq and dk/dv do 7 products of T^2 * D over the causal half, ~6e10 FLOP,
// 0.9 ms at the 67 TFLOP/s FP64 tensor-core peak: operations.
//
// In both, each output element is owned by one thread and written once: no
// atomics, so runs are deterministic. Sums are f32; dq, dk and dv are
// rounded to the input dtype once, at the store. Any T is taken (the ragged
// edge is masked).

#include "common.cuh"
#include "flash_wgmma.cuh"

namespace {

constexpr int kBR = 64;     // rows (queries or keys) per block
constexpr int kBT = 64;     // rows per streamed shared-memory tile
constexpr int kDPT = 16;    // head dims per thread

template <int G, typename A>
__device__ __forceinline__ A row_sum(A part) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

template <typename T, int G>
__device__ __forceinline__ void load_row(const T* __restrict__ src, size_t off,
                                         bool valid, int g, int dim,
                                         dl4j::acc_t<T> (&r)[kDPT]) {
  using A = dl4j::acc_t<T>;
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int d = g + G * i;
    r[i] = (valid && d < dim) ? dl4j::to_acc(src[off + d]) : A(0);
  }
}

template <typename T, int G>
__device__ __forceinline__ void store_row(T* __restrict__ dst, size_t off,
                                          int g, int dim, dl4j::acc_t<T> mul,
                                          const dl4j::acc_t<T> (&r)[kDPT]) {
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int d = g + G * i;
    if (d < dim) dst[off + d] = dl4j::from_acc<T>(r[i] * mul);
  }
}

template <typename T, int G>
__device__ __forceinline__ void stage_tile(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           dl4j::acc_t<T>* as,
                                           dl4j::acc_t<T>* bs, size_t base,
                                           size_t stride, int r0, int seq,
                                           int dim) {
  using A = dl4j::acc_t<T>;
  constexpr int DP = G * kDPT;
  for (int e = threadIdx.x; e < kBT * DP; e += kBR * G) {
    const int j = e / DP, d = e % DP;
    const int r = r0 + j;
    A av = A(0), bv = A(0);
    if (r < seq && d < dim) {
      const size_t off = base + r * stride + d;
      av = dl4j::to_acc(a[off]);
      bv = dl4j::to_acc(b[off]);
    }
    as[e] = av;
    bs[e] = bv;
  }
}

// Both kernels: A = dl4j::acc_t<T> (f32, double for the f64 form) for the
// staged tiles, the registers, lse, D and the scale.
template <typename T, int G>
__global__ void __launch_bounds__(kBR * G)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const dl4j::acc_t<T>* __restrict__ lse,
                    const dl4j::acc_t<T>* __restrict__ drow,
                    T* __restrict__ dq, int seq, int heads, int dim,
                    int causal, dl4j::acc_t<T> scale) {
  using A = dl4j::acc_t<T>;
  constexpr int DP = G * kDPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* ks = reinterpret_cast<A*>(smem_raw);  // [kBT][DP]
  A* vs = ks + kBT * DP;                   // [kBT][DP]

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBR;
  const int g = threadIdx.x % G;
  const int qpos = q0 + threadIdx.x / G;
  const bool valid = qpos < seq;
  const size_t stride = static_cast<size_t>(heads) * dim;
  const size_t base = static_cast<size_t>(b) * seq * stride +
                      static_cast<size_t>(h) * dim;
  const size_t row = base + static_cast<size_t>(qpos) * stride;

  A qr[kDPT], dor[kDPT], acc[kDPT];
  load_row<T, G>(q, row, valid, g, dim, qr);
  load_row<T, G>(dout, row, valid, g, dim, dor);
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc[i] = A(0);
  const size_t srow = static_cast<size_t>(blockIdx.y) * seq + qpos;
  const A l = valid ? lse[srow] : A(0);
  const A dr = valid ? drow[srow] : A(0);

  const int q_last = min(q0 + kBR, seq) - 1;
  const int k_end = causal ? q_last + 1 : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBT) {
    __syncthreads();  // the previous tile is fully consumed
    stage_tile<T, G>(k, v, ks, vs, base, stride, k0, seq, dim);
    __syncthreads();
    const int jn = min(kBT, k_end - k0);
    for (int j = 0; j < jn; ++j) {
      const A* kr = ks + j * DP + g;
      const A* vr = vs + j * DP + g;
      A s = A(0), dp = A(0);
#pragma unroll
      for (int i = 0; i < kDPT; ++i) {
        s += qr[i] * kr[G * i];
        dp += dor[i] * vr[G * i];
      }
      s = row_sum<G>(s);
      dp = row_sum<G>(dp);
      const int kp = k0 + j;
      const bool live = valid && kp < seq && !(causal && kp > qpos);
      const A p = live ? dl4j::ex(s * scale - l) : A(0);
      const A ds = p * (dp - dr);
#pragma unroll
      for (int i = 0; i < kDPT; ++i) acc[i] += ds * kr[G * i];
    }
  }
  if (valid) store_row<T, G>(dq, row, g, dim, scale, acc);
}

template <typename T, int G>
__global__ void __launch_bounds__(kBR * G)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const dl4j::acc_t<T>* __restrict__ lse,
                     const dl4j::acc_t<T>* __restrict__ drow,
                     T* __restrict__ dk, T* __restrict__ dv, int seq,
                     int heads, int dim, int causal, dl4j::acc_t<T> scale) {
  using A = dl4j::acc_t<T>;
  constexpr int DP = G * kDPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* qs = reinterpret_cast<A*>(smem_raw);  // [kBT][DP]
  A* ds_ = qs + kBT * DP;                  // [kBT][DP] (do)
  A* ls = qs + 2 * kBT * DP;               // [kBT] lse
  A* dsr = ls + kBT;                       // [kBT] D

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int k0 = blockIdx.x * kBR;
  const int g = threadIdx.x % G;
  const int kpos = k0 + threadIdx.x / G;
  const bool valid = kpos < seq;
  const size_t stride = static_cast<size_t>(heads) * dim;
  const size_t base = static_cast<size_t>(b) * seq * stride +
                      static_cast<size_t>(h) * dim;
  const size_t row = base + static_cast<size_t>(kpos) * stride;
  const size_t srow0 = static_cast<size_t>(blockIdx.y) * seq;

  A kr[kDPT], vr[kDPT], dka[kDPT], dva[kDPT];
  load_row<T, G>(k, row, valid, g, dim, kr);
  load_row<T, G>(v, row, valid, g, dim, vr);
#pragma unroll
  for (int i = 0; i < kDPT; ++i) dka[i] = dva[i] = A(0);

  // Causal: queries before this tile's first key see none of its keys.
  const int i_begin = causal ? k0 : 0;
  for (int r0 = i_begin; r0 < seq; r0 += kBT) {
    __syncthreads();
    stage_tile<T, G>(q, dout, qs, ds_, base, stride, r0, seq, dim);
    for (int e = threadIdx.x; e < kBT; e += kBR * G) {
      const int r = r0 + e;
      ls[e] = r < seq ? lse[srow0 + r] : A(0);
      dsr[e] = r < seq ? drow[srow0 + r] : A(0);
    }
    __syncthreads();
    const int jn = min(kBT, seq - r0);
    for (int j = 0; j < jn; ++j) {
      const A* qr = qs + j * DP + g;
      const A* dor = ds_ + j * DP + g;
      A s = A(0), dp = A(0);
#pragma unroll
      for (int i = 0; i < kDPT; ++i) {
        s += qr[G * i] * kr[i];
        dp += dor[G * i] * vr[i];
      }
      s = row_sum<G>(s);
      dp = row_sum<G>(dp);
      const int qp = r0 + j;
      const bool live = valid && !(causal && kpos > qp);
      const A p = live ? dl4j::ex(s * scale - ls[j]) : A(0);
      const A dsv = p * (dp - dsr[j]);
#pragma unroll
      for (int i = 0; i < kDPT; ++i) {
        dva[i] += p * dor[G * i];
        dka[i] += dsv * qr[G * i];
      }
    }
  }
  if (valid) {
    store_row<T, G>(dk, row, g, dim, scale, dka);
    store_row<T, G>(dv, row, g, dim, A(1), dva);
  }
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <typename T, int G>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* drow, void* dq, int batch,
              int seq, int heads, int dim, int causal, double scale,
              cudaStream_t stream) {
  using A = dl4j::acc_t<T>;
  constexpr int DP = G * kDPT;
  const int smem = 2 * kBT * DP * static_cast<int>(sizeof(A));
  auto kernel = flash_bwd_dq_kernel<T, G>;
  if (const int e = prepare(kernel, smem)) return e;
  const dim3 grid((seq + kBR - 1) / kBR, batch * heads);
  kernel<<<grid, kBR * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const A*>(lse), static_cast<const A*>(drow),
      static_cast<T*>(dq), seq, heads, dim, causal, static_cast<A>(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* drow, void* dk, void* dv,
               int batch, int seq, int heads, int dim, int causal,
               double scale, cudaStream_t stream) {
  using A = dl4j::acc_t<T>;
  constexpr int DP = G * kDPT;
  const int smem = (2 * kBT * DP + 2 * kBT) * static_cast<int>(sizeof(A));
  auto kernel = flash_bwd_dkv_kernel<T, G>;
  if (const int e = prepare(kernel, smem)) return e;
  const dim3 grid((seq + kBR - 1) / kBR, batch * heads);
  kernel<<<grid, kBR * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const A*>(lse), static_cast<const A*>(drow),
      static_cast<T*>(dk), static_cast<T*>(dv), seq, heads, dim, causal,
      static_cast<A>(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* o,
                const void* l, const void* d, void* dq, int b, int t, int h,
                int dim, int c, double sc, cudaStream_t s) {
  if (dim <= 16) return launch_dq<T, 1>(q, k, v, o, l, d, dq, b, t, h, dim, c, sc, s);
  if (dim <= 32) return launch_dq<T, 2>(q, k, v, o, l, d, dq, b, t, h, dim, c, sc, s);
  if (dim <= 64) return launch_dq<T, 4>(q, k, v, o, l, d, dq, b, t, h, dim, c, sc, s);
  if (dim <= 128) return launch_dq<T, 8>(q, k, v, o, l, d, dq, b, t, h, dim, c, sc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* o,
                 const void* l, const void* d, void* dk, void* dv, int b,
                 int t, int h, int dim, int c, double sc, cudaStream_t s) {
  if (dim <= 16) return launch_dkv<T, 1>(q, k, v, o, l, d, dk, dv, b, t, h, dim, c, sc, s);
  if (dim <= 32) return launch_dkv<T, 2>(q, k, v, o, l, d, dk, dv, b, t, h, dim, c, sc, s);
  if (dim <= 64) return launch_dkv<T, 4>(q, k, v, o, l, d, dk, dv, b, t, h, dim, c, sc, s);
  if (dim <= 128) return launch_dkv<T, 8>(q, k, v, o, l, d, dk, dv, b, t, h, dim, c, sc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// lse, drow: [batch, heads, seq], float32 (float64 for the f64 form);
// `scale` a double, rounded to f32 for every form but the f64 one.
extern "C" int dl4j_flash_attention_bwd_dq(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* drow,
                                           void* dq, int batch, int seq,
                                           int heads, int dim, int causal,
                                           double scale, int dtype,
                                           int variant, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  if (variant == 1) {
    return dl4j::flash::rows_dq_wgmma(
        q, k, v, dout, static_cast<const float*>(lse),
        static_cast<const float*>(drow), dq, batch, seq, heads, dim, causal,
        static_cast<float>(scale), dtype, stream);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void *l = lse, *d = drow;
  if (dtype == dl4j::kFloat32)
    return dispatch_dq<float>(q, k, v, dout, l, d, dq, batch, seq, heads, dim, causal, scale, s);
  if (dtype == dl4j::kBFloat16)
    return dispatch_dq<__nv_bfloat16>(q, k, v, dout, l, d, dq, batch, seq, heads, dim, causal, scale, s);
  if (dtype == dl4j::kFloat16)
    return dispatch_dq<__half>(q, k, v, dout, l, d, dq, batch, seq, heads, dim, causal, scale, s);
  if (dtype == dl4j::kFloat64)
    return dispatch_dq<double>(q, k, v, dout, l, d, dq, batch, seq, heads, dim, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dl4j_flash_attention_bwd_dkv(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse, const void* drow,
                                            void* dk, void* dv, int batch,
                                            int seq, int heads, int dim,
                                            int causal, double scale,
                                            int dtype, int variant,
                                            void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  if (variant == 1) {
    return dl4j::flash::rows_dkv_wgmma(
        q, k, v, dout, static_cast<const float*>(lse),
        static_cast<const float*>(drow), dk, dv, batch, seq, heads, dim,
        causal, static_cast<float>(scale), dtype, stream);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void *l = lse, *d = drow;
  if (dtype == dl4j::kFloat32)
    return dispatch_dkv<float>(q, k, v, dout, l, d, dk, dv, batch, seq, heads, dim, causal, scale, s);
  if (dtype == dl4j::kBFloat16)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, l, d, dk, dv, batch, seq, heads, dim, causal, scale, s);
  if (dtype == dl4j::kFloat16)
    return dispatch_dkv<__half>(q, k, v, dout, l, d, dk, dv, batch, seq, heads, dim, causal, scale, s);
  if (dtype == dl4j::kFloat64)
    return dispatch_dkv<double>(q, k, v, dout, l, d, dk, dv, batch, seq, heads, dim, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
