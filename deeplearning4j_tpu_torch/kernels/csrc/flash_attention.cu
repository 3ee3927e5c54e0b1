// Causal (or full) multi-head attention forward with an online f32 softmax.
//
// Two C entries share one kernel, in both of its forms (below):
// - `dl4j_flash_attention_fwd` replaces the TPU kernel `_flash_kernel_resident`
//   with its `_resident_softmax_loop` (deeplearning4j_tpu/kernels/
//   flash_attention.py:99,55, launched by `_flash_fwd_bhtd` :241 under
//   `flash_attention` :289) while the K/V of one (batch, head) fit the
//   JAX package's resident limit; past it the streamed `_flash_stream_kernel`
//   (:137) has its own kernel, csrc/flash_attention_stream.cu;
// - `dl4j_flash_attention_fwd_lse` replaces the training forward
//   `_flash_fwd_lse_kernel` (:376, launched by `_flash_fwd_lse_bhtd` :476
//   from the custom_vjp's `_fwd` :305): the same pass, plus one f32 store of
//   lse = m + log(l) per row ([B, H, T]) for the backward
//   (csrc/flash_attention_bwd.cu).
//
// Bound on the H100 at the serving prefill (T = 1024, 8 heads, D = 64, bf16,
// causal): ~1.07 GFLOP over 989 TFLOP/s is ~1.1 us and q, k, v, o are ~4.2 MB
// over 3.35 TB/s is ~1.3 us, so bytes bound it, barely; the ridge is near.
// At the training step (B*H = 128, T = 1024, D = 64, bf16, causal) the lse
// forward is ~17 GFLOP (17 us at 989 TFLOP/s) against ~67 MB (20 us): bytes
// again, by a hair. The lse store adds 4 bytes per row, 0.5 MB in all.
//
// Design: two forms of the same math, picked by the wrapper by dtype and
// head width alone (kernels/flash_attention.py `resident_variant`):
// - bf16 at D = 64 or 128, every main path's case: row 4's tensor-core
//   tile kernel, `stream_fwd_wgmma_kernel` (csrc/flash_attention_stream.cu,
//   reached through flash_wgmma.cuh), over its rows schedule: one
//   warpgroup per (batch*head, 64-row q tile), the longest (causal) rows
//   issued first; Q held in 128-byte-swizzled shared memory; K/V brought in
//   by TMA through a 3-stage (D = 64) or 2-stage (D = 128) mbarrier ring
//   from a 4-D map (D, H, T, B) that keeps the batches apart; s = q k^T and
//   o += p v on wgmma (m64n64k16; p v m64n128k16 at D = 128), p rounded to
//   bf16 as register A; the
//   online softmax in f32 registers with exp2f; keys at or past T, and key
//   > query when causal, set to -1e30 by the kernel (TMA's zero rows would
//   score 0). A block is its whole row: o and lse go out from registers,
//   with no workspace and no merge, one launch per call, and no atomics.
//   That moves the products from the CUDA cores to the tensor cores, where
//   the ~17 GFLOP of the training shape take ~17 us, and overlaps the K/V
//   loads with the products; K and V are read once per q tile, from L2
//   (33.5 MB of them at the training shape, under its 50 MB).
// - f32, and bf16 at any other D: `flash_fwd_kernel` below, on the CUDA
//   cores. Each query row is owned by G threads (G = next power of two >=
//   D/16), each holding 16 of the row's dims in registers, interleaved
//   (thread g owns dims g, g+G, ...) so that the G threads of a row read
//   consecutive shared-memory words. K/V tiles of 64 keys are staged in
//   shared memory as f32 and reused by all 64 rows of the tile; the loop
//   over key tiles stops at the causal diagonal, so the upper triangle is
//   neither read nor computed. Scores are reduced across a row's G threads
//   with warp shuffles; softmax statistics and the accumulator stay in f32
//   registers, with the JAX package's -1e30 mask.
// Both forms take any T: rows and keys beyond T are masked, so every
// prefill bucket (T = 8 .. 1024) runs them.

#include "common.cuh"
#include "flash_wgmma.cuh"

namespace {

constexpr int kBQ = 64;     // query rows per block
constexpr int kBK = 64;     // keys per shared-memory tile
constexpr int kChunk = 16;  // keys per online-softmax update
constexpr int kDPT = 16;    // head dims per thread

template <typename T, int G>
__global__ void __launch_bounds__(kBQ * G)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq, int heads, int dim,
                 int causal, float scale) {
  constexpr int DP = G * kDPT;  // padded head width in shared memory
  extern __shared__ float smem[];
  float* ks = smem;             // [kBK][DP]
  float* vs = smem + kBK * DP;  // [kBK][DP]

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int g = tid % G;
  const int qpos = q0 + tid / G;
  const size_t stride = static_cast<size_t>(heads) * dim;  // between positions
  const size_t base = static_cast<size_t>(b) * seq * stride +
                      static_cast<size_t>(h) * dim;

  float qr[kDPT], acc[kDPT];
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int d = g + G * i;
    qr[i] = (qpos < seq && d < dim)
                ? dl4j::to_f32(q[base + qpos * stride + d]) * scale
                : 0.f;
    acc[i] = 0.f;
  }
  float m = dl4j::kNeg, l = 0.f;

  const int q_last = min(q0 + kBQ, seq) - 1;
  const int k_end = causal ? q_last + 1 : seq;  // keys [0, k_end) matter
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < kBK * DP; e += kBQ * G) {
      const int j = e / DP, d = e % DP;
      const int kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < seq && d < dim) {
        const size_t off = base + kp * stride + d;
        kv = dl4j::to_f32(k[off]);
        vv = dl4j::to_f32(v[off]);
      }
      ks[e] = kv;
      vs[e] = vv;
    }
    __syncthreads();
    const int jn = min(kBK, k_end - k0);
    for (int c = 0; c < jn; c += kChunk) {
      float s[kChunk];
      float mx = dl4j::kNeg;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* kr = ks + (c + jj) * DP + g;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kDPT; ++i) part += qr[i] * kr[G * i];
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        const int kp = k0 + c + jj;
        if (kp >= seq || (causal && kp > qpos)) part = dl4j::kNeg;
        s[jj] = part;
        mx = fmaxf(mx, part);
      }
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < kDPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - m_new);
        const float* vr = vs + (c + jj) * DP + g;
        l += p;
#pragma unroll
        for (int i = 0; i < kDPT; ++i) acc[i] += p * vr[G * i];
      }
      m = m_new;
    }
  }

  if (qpos < seq) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDPT; ++i) {
      const int d = g + G * i;
      if (d < dim) o[base + qpos * stride + d] = dl4j::from_f32<T>(acc[i] / lc);
    }
    // lse rows are [B*H, T]: blockIdx.y is b * heads + h.
    if (lse != nullptr && g == 0)
      lse[static_cast<size_t>(blockIdx.y) * seq + qpos] = m + logf(lc);
  }
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int seq, int heads, int dim, int causal, float scale,
           cudaStream_t stream) {
  constexpr int DP = G * kDPT;
  const int smem = 2 * kBK * DP * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<T, G>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * heads);
  kernel<<<grid, kBQ * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seq, heads, dim,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int batch, int seq, int heads, int dim, int causal, float scale,
             cudaStream_t s) {
  if (dim <= 16) return launch<T, 1>(q, k, v, o, lse, batch, seq, heads, dim, causal, scale, s);
  if (dim <= 32) return launch<T, 2>(q, k, v, o, lse, batch, seq, heads, dim, causal, scale, s);
  if (dim <= 64) return launch<T, 4>(q, k, v, o, lse, batch, seq, heads, dim, causal, scale, s);
  if (dim <= 128) return launch<T, 8>(q, k, v, o, lse, batch, seq, heads, dim, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int batch, int seq, int heads, int dim, int causal, float scale,
        int dtype, int variant, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  if (variant == 1) {
    if (dtype != dl4j::kBFloat16)
      return static_cast<int>(cudaErrorInvalidValue);
    return dl4j::flash::rows_fwd_wgmma(q, k, v, o, lse, batch, seq, heads,
                                       dim, causal, scale, stream);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dispatch<float>(q, k, v, o, lse, batch, seq, heads, dim, causal, scale, s);
  if (dtype == dl4j::kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, batch, seq, heads, dim, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: [batch, seq, heads, dim] contiguous, all of `dtype`; dim <= 128.
// `variant`: 1 launches the tensor-core form (bf16, dim 64 or 128, q/k/v
// 16-byte aligned; any other input is refused, never rerouted), 0 the
// CUDA-core kernel.
extern "C" int dl4j_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, int batch,
                                        int seq, int heads, int dim,
                                        int causal, float scale, int dtype,
                                        int variant, void* stream) {
  return run(q, k, v, o, nullptr, batch, seq, heads, dim, causal, scale,
             dtype, variant, stream);
}

// As above, plus lse: [batch, heads, seq] float32, m + log(l) of each row's
// scaled scores (the softmax normalizer the backward recomputes p from).
extern "C" int dl4j_flash_attention_fwd_lse(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int batch, int seq, int heads,
                                            int dim, int causal, float scale,
                                            int dtype, int variant,
                                            void* stream) {
  return run(q, k, v, o, static_cast<float*>(lse), batch, seq, heads, dim,
             causal, scale, dtype, variant, stream);
}
