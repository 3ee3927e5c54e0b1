// Decode-step attention through a paged KV pool.
//
// Replaces the TPU kernel `_paged_flash_kernel`
// (deeplearning4j_tpu/kernels/flash_attention.py:733, launched by
// `_paged_flash` :779 under `paged_decode_attention` :815). q: [B, T, H, D]
// (the new positions, globally at [pos, pos+T) per row); k/v pools:
// [P, page, H, D]; page table: [B, NP] int32 (entry 0 = the zero page);
// pos: [B] int32. Causal: query t sees keys < pos + 1 + t; else < pos + T.
//
// Bound on the H100: bytes. Each key row is used by T (1 at a decode step)
// queries, so the kernel reads sum_b (pos_b + T) * H * D * 2 values of K and V
// for ~4 flops each: ~1 flop/byte, far below the ridge. At full depth
// (4 slots x 1024 keys x 8 heads x 64 dims, bf16) that is 8.4 MB per layer,
// ~2.5 us at 3.35 TB/s.
//
// Design: one block of 4 warps per (slot, head). The block reads its own page
// ids from the table and visits only the logical pages below its row's key
// limit: pages beyond it contribute exactly 0 in the TPU kernel (their softmax
// weight underflows to 0), so skipping them gives the same output while
// reading only the bytes the bound counts. A warp takes every 4th key; its
// lanes split the head dims, so one key row is one coalesced read per warp and
// the q.k dot is a warp-shuffle sum. Each warp keeps an online f32 softmax per
// query; the four partial (max, sum, acc) states merge through shared memory
// at the end. Grid width is slots*heads (32 blocks at the serving shape), so a
// split over the key axis (flash-decoding) is the next step for occupancy.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxQ = 8;   // query positions per slot (T); speculative verify widths
constexpr int kDPL = 4;    // head dims per lane: D <= 128

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ table,
                    const int* __restrict__ pos, T* __restrict__ o, int nq,
                    int heads, int dim, int page, int n_pages, int causal,
                    float scale) {
  __shared__ float m_s[kWarps][kMaxQ];
  __shared__ float l_s[kWarps][kMaxQ];
  __shared__ float acc_s[kWarps][kMaxQ][32 * kDPL];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p0 = pos[b];

  float qr[kMaxQ][kDPL], acc[kMaxQ][kDPL], m[kMaxQ], l[kMaxQ];
#pragma unroll
  for (int t = 0; t < kMaxQ; ++t) {
    m[t] = dl4j::kNeg;
    l[t] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      qr[t][i] = (t < nq && d < dim)
                     ? dl4j::to_f32(q[((static_cast<size_t>(b) * nq + t) * heads + h) * dim + d]) * scale
                     : 0.f;
      acc[t][i] = 0.f;
    }
  }

  const int n_keys = min(p0 + nq, n_pages * page);  // keys [0, n_keys)
  for (int key = w; key < n_keys; key += kWarps) {
    const int phys = table[b * n_pages + key / page];
    const size_t row =
        ((static_cast<size_t>(phys) * page + key % page) * heads + h) * dim;
    float kr[kDPL], vr[kDPL];
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      kr[i] = d < dim ? dl4j::to_f32(kpool[row + d]) : 0.f;
      vr[i] = d < dim ? dl4j::to_f32(vpool[row + d]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kMaxQ; ++t) {
      const int limit = causal ? p0 + 1 + t : p0 + nq;
      if (t < nq && key < limit) {  // uniform across the warp
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kDPL; ++i) s += qr[t][i] * kr[i];
        s = dl4j::warp_sum(s);
        const float m_new = fmaxf(m[t], s);
        const float corr = expf(m[t] - m_new);
        const float p = expf(s - m_new);
        l[t] = l[t] * corr + p;
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[t][i] = acc[t][i] * corr + p * vr[i];
        m[t] = m_new;
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kMaxQ; ++t) {
    if (lane == 0) {
      m_s[w][t] = m[t];
      l_s[w][t] = l[t];
    }
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc_s[w][t][lane + 32 * i] = acc[t][i];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nq * dim; e += 32 * kWarps) {
    const int t = e / dim, d = e % dim;
    float mx = dl4j::kNeg;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) mx = fmaxf(mx, m_s[ww][t]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float f = expf(m_s[ww][t] - mx);
      sum += l_s[ww][t] * f;
      a += acc_s[ww][t][d] * f;
    }
    o[((static_cast<size_t>(b) * nq + t) * heads + h) * dim + d] =
        dl4j::from_f32<T>(a / fmaxf(sum, 1e-30f));
  }
}

}  // namespace

// q, o: [batch, nq, heads, dim]; k_pages, v_pages: [P, page, heads, dim], all
// of `dtype`; table: [batch, n_pages] int32; pos: [batch] int32.
// nq <= 8, dim <= 128 (checked by the Python wrapper).
extern "C" int dl4j_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* table,
    const void* pos, void* o, int batch, int nq, int heads, int dim, int page,
    int n_pages, int causal, float scale, int dtype, void* stream) {
  if (batch <= 0 || nq <= 0 || heads <= 0) return 0;
  if (nq > kMaxQ || dim > 32 * kDPL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(heads, batch);
  const int* tp = static_cast<const int*>(table);
  const int* pp = static_cast<const int*>(pos);
  if (dtype == dl4j::kFloat32) {
    paged_decode_kernel<float><<<grid, 32 * kWarps, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages), tp, pp, static_cast<float*>(o), nq,
        heads, dim, page, n_pages, causal, scale);
  } else if (dtype == dl4j::kBFloat16) {
    paged_decode_kernel<__nv_bfloat16><<<grid, 32 * kWarps, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages), tp, pp,
        static_cast<__nv_bfloat16*>(o), nq, heads, dim, page, n_pages, causal,
        scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dl4j_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
