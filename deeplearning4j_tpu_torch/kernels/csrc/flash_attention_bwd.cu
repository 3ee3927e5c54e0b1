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

template <int G>
__device__ __forceinline__ float row_sum(float part) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

template <typename T, int G>
__device__ __forceinline__ void load_row(const T* __restrict__ src, size_t off,
                                         bool valid, int g, int dim,
                                         float (&r)[kDPT]) {
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int d = g + G * i;
    r[i] = (valid && d < dim) ? dl4j::to_f32(src[off + d]) : 0.f;
  }
}

template <typename T, int G>
__device__ __forceinline__ void store_row(T* __restrict__ dst, size_t off,
                                          int g, int dim, float mul,
                                          const float (&r)[kDPT]) {
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int d = g + G * i;
    if (d < dim) dst[off + d] = dl4j::from_f32<T>(r[i] * mul);
  }
}

// Stage rows [r0, r0 + kBT) of two [B, T, H, D] tensors into shared memory
// as f32 ([kBT][DP] each), zero past `seq` and past `dim`.
template <typename T, int G>
__device__ __forceinline__ void stage_tile(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           float* as, float* bs, size_t base,
                                           size_t stride, int r0, int seq,
                                           int dim) {
  constexpr int DP = G * kDPT;
  for (int e = threadIdx.x; e < kBT * DP; e += kBR * G) {
    const int j = e / DP, d = e % DP;
    const int r = r0 + j;
    float av = 0.f, bv = 0.f;
    if (r < seq && d < dim) {
      const size_t off = base + r * stride + d;
      av = dl4j::to_f32(a[off]);
      bv = dl4j::to_f32(b[off]);
    }
    as[e] = av;
    bs[e] = bv;
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kBR * G)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ drow, T* __restrict__ dq,
                    int seq, int heads, int dim, int causal, float scale) {
  constexpr int DP = G * kDPT;
  extern __shared__ float smem[];
  float* ks = smem;             // [kBT][DP]
  float* vs = smem + kBT * DP;  // [kBT][DP]

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

  float qr[kDPT], dor[kDPT], acc[kDPT];
  load_row<T, G>(q, row, valid, g, dim, qr);
  load_row<T, G>(dout, row, valid, g, dim, dor);
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc[i] = 0.f;
  const size_t srow = static_cast<size_t>(blockIdx.y) * seq + qpos;
  const float l = valid ? lse[srow] : 0.f;
  const float dr = valid ? drow[srow] : 0.f;

  const int q_last = min(q0 + kBR, seq) - 1;
  const int k_end = causal ? q_last + 1 : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBT) {
    __syncthreads();  // the previous tile is fully consumed
    stage_tile<T, G>(k, v, ks, vs, base, stride, k0, seq, dim);
    __syncthreads();
    const int jn = min(kBT, k_end - k0);
    for (int j = 0; j < jn; ++j) {
      const float* kr = ks + j * DP + g;
      const float* vr = vs + j * DP + g;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kDPT; ++i) {
        s += qr[i] * kr[G * i];
        dp += dor[i] * vr[G * i];
      }
      s = row_sum<G>(s);
      dp = row_sum<G>(dp);
      const int kp = k0 + j;
      const bool live = valid && kp < seq && !(causal && kp > qpos);
      const float p = live ? expf(s * scale - l) : 0.f;
      const float ds = p * (dp - dr);
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
                     const float* __restrict__ lse,
                     const float* __restrict__ drow, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int heads, int dim,
                     int causal, float scale) {
  constexpr int DP = G * kDPT;
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBT][DP]
  float* ds_ = smem + kBT * DP;       // [kBT][DP] (do)
  float* ls = smem + 2 * kBT * DP;    // [kBT] lse
  float* dsr = ls + kBT;              // [kBT] D

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

  float kr[kDPT], vr[kDPT], dka[kDPT], dva[kDPT];
  load_row<T, G>(k, row, valid, g, dim, kr);
  load_row<T, G>(v, row, valid, g, dim, vr);
#pragma unroll
  for (int i = 0; i < kDPT; ++i) dka[i] = dva[i] = 0.f;

  // Causal: queries before this tile's first key see none of its keys.
  const int i_begin = causal ? k0 : 0;
  for (int r0 = i_begin; r0 < seq; r0 += kBT) {
    __syncthreads();
    stage_tile<T, G>(q, dout, qs, ds_, base, stride, r0, seq, dim);
    for (int e = threadIdx.x; e < kBT; e += kBR * G) {
      const int r = r0 + e;
      ls[e] = r < seq ? lse[srow0 + r] : 0.f;
      dsr[e] = r < seq ? drow[srow0 + r] : 0.f;
    }
    __syncthreads();
    const int jn = min(kBT, seq - r0);
    for (int j = 0; j < jn; ++j) {
      const float* qr = qs + j * DP + g;
      const float* dor = ds_ + j * DP + g;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kDPT; ++i) {
        s += qr[G * i] * kr[i];
        dp += dor[G * i] * vr[i];
      }
      s = row_sum<G>(s);
      dp = row_sum<G>(dp);
      const int qp = r0 + j;
      const bool live = valid && !(causal && kpos > qp);
      const float p = live ? expf(s * scale - ls[j]) : 0.f;
      const float dsv = p * (dp - dsr[j]);
#pragma unroll
      for (int i = 0; i < kDPT; ++i) {
        dva[i] += p * dor[G * i];
        dka[i] += dsv * qr[G * i];
      }
    }
  }
  if (valid) {
    store_row<T, G>(dk, row, g, dim, scale, dka);
    store_row<T, G>(dv, row, g, dim, 1.f, dva);
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
              const float* lse, const float* drow, void* dq, int batch,
              int seq, int heads, int dim, int causal, float scale,
              cudaStream_t stream) {
  constexpr int DP = G * kDPT;
  const int smem = 2 * kBT * DP * static_cast<int>(sizeof(float));
  auto kernel = flash_bwd_dq_kernel<T, G>;
  if (const int e = prepare(kernel, smem)) return e;
  const dim3 grid((seq + kBR - 1) / kBR, batch * heads);
  kernel<<<grid, kBR * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, drow,
      static_cast<T*>(dq), seq, heads, dim, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* drow, void* dk, void* dv,
               int batch, int seq, int heads, int dim, int causal, float scale,
               cudaStream_t stream) {
  constexpr int DP = G * kDPT;
  const int smem = (2 * kBT * DP + 2 * kBT) * static_cast<int>(sizeof(float));
  auto kernel = flash_bwd_dkv_kernel<T, G>;
  if (const int e = prepare(kernel, smem)) return e;
  const dim3 grid((seq + kBR - 1) / kBR, batch * heads);
  kernel<<<grid, kBR * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, drow,
      static_cast<T*>(dk), static_cast<T*>(dv), seq, heads, dim, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* o,
                const float* l, const float* d, void* dq, int b, int t, int h,
                int dim, int c, float sc, cudaStream_t s) {
  if (dim <= 16) return launch_dq<T, 1>(q, k, v, o, l, d, dq, b, t, h, dim, c, sc, s);
  if (dim <= 32) return launch_dq<T, 2>(q, k, v, o, l, d, dq, b, t, h, dim, c, sc, s);
  if (dim <= 64) return launch_dq<T, 4>(q, k, v, o, l, d, dq, b, t, h, dim, c, sc, s);
  if (dim <= 128) return launch_dq<T, 8>(q, k, v, o, l, d, dq, b, t, h, dim, c, sc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* o,
                 const float* l, const float* d, void* dk, void* dv, int b,
                 int t, int h, int dim, int c, float sc, cudaStream_t s) {
  if (dim <= 16) return launch_dkv<T, 1>(q, k, v, o, l, d, dk, dv, b, t, h, dim, c, sc, s);
  if (dim <= 32) return launch_dkv<T, 2>(q, k, v, o, l, d, dk, dv, b, t, h, dim, c, sc, s);
  if (dim <= 64) return launch_dkv<T, 4>(q, k, v, o, l, d, dk, dv, b, t, h, dim, c, sc, s);
  if (dim <= 128) return launch_dkv<T, 8>(q, k, v, o, l, d, dk, dv, b, t, h, dim, c, sc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, dout, dq: [batch, seq, heads, dim] contiguous, all of `dtype`;
// lse, drow: [batch, heads, seq] float32; dim <= 128. `variant`: 1 launches
// the tensor-core form (bf16, dim 64 or 128, q/k/v/dout 16-byte aligned;
// any other input is refused, never rerouted), 0 the CUDA-core kernel.
extern "C" int dl4j_flash_attention_bwd_dq(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* drow,
                                           void* dq, int batch, int seq,
                                           int heads, int dim, int causal,
                                           float scale, int dtype,
                                           int variant, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(drow);
  if (variant == 1) {
    if (dtype != dl4j::kBFloat16)
      return static_cast<int>(cudaErrorInvalidValue);
    return dl4j::flash::rows_dq_wgmma(q, k, v, dout, l, d, dq, batch, seq,
                                      heads, dim, causal, scale, stream);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dispatch_dq<float>(q, k, v, dout, l, d, dq, batch, seq, heads, dim, causal, scale, s);
  if (dtype == dl4j::kBFloat16)
    return dispatch_dq<__nv_bfloat16>(q, k, v, dout, l, d, dq, batch, seq, heads, dim, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above; writes dk and dv ([batch, seq, heads, dim], of `dtype`).
extern "C" int dl4j_flash_attention_bwd_dkv(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse, const void* drow,
                                            void* dk, void* dv, int batch,
                                            int seq, int heads, int dim,
                                            int causal, float scale, int dtype,
                                            int variant, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(drow);
  if (variant == 1) {
    if (dtype != dl4j::kBFloat16)
      return static_cast<int>(cudaErrorInvalidValue);
    return dl4j::flash::rows_dkv_wgmma(q, k, v, dout, l, d, dk, dv, batch,
                                       seq, heads, dim, causal, scale, stream);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dispatch_dkv<float>(q, k, v, dout, l, d, dk, dv, batch, seq, heads, dim, causal, scale, s);
  if (dtype == dl4j::kBFloat16)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, l, d, dk, dv, batch, seq, heads, dim, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
