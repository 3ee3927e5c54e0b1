// Streamed flash attention past the resident K/V limit: the forward
// (o, lse) and the backward (dq; dk, dv), each walking a visit list of
// (q tile, k tile) pairs cut into units of equal work.
//
// Replaces the TPU kernels
// - `_flash_stream_kernel` (deeplearning4j_tpu/kernels/flash_attention.py:137,
//   launched by `_flash_fwd_stream_bhtd` :201 from `_flash_fwd_bhtd` :259 and
//   the custom_vjp's `_fwd` :317), and so `bench.py:1045 stream_sum`, which
//   runs it over a triangular and a rectangular list;
// - `_flash_bwd_dq_stream_kernel` (:551) and `_flash_bwd_dkv_stream_kernel`
//   (:595), launched by `_flash_bwd_stream_bhtd` (:641) from `_bwd` :337.
// The math is the resident kernels' (csrc/flash_attention.cu,
// csrc/flash_attention_bwd.cu): online f32 softmax with the JAX package's
// -1e30 mask, lse = m + log(l); p recomputed from lse in the backward,
// ds = p * (do v^T - D), dq = ds k * scale, dk = ds^T q * scale, dv = p^T do.
//
// Bound on the H100 at the long-context slice (B*H = 8, T = 32,768, D = 64,
// bf16, causal): the forward is 2 products of T^2/2 * D per head, ~1.1e12
// operations (1.1 ms at 989 TFLOP/s) against ~134 MB (0.04 ms); dq ~1.65e12
// and dk/dv ~2.2e12: operations bound all three, by 30-50x.
//
// What the schedule is about. On the TPU the grid runs in order on one core
// and scratch (acc, m, l) is carried along a row of the list. Here blocks run
// at once and carry nothing, and the causal rows differ in length from 1 tile
// to T/64 (512 at T = 32,768): a block per row, as the resident kernels
// launch, leaves the last wave to the longest rows. So the wrapper
// (kernels/flash_attention.py `stream_schedule`) cuts each run of the list
// into units of at most 64 tiles, near-equal in length and ordered longest
// first, and each block takes one unit of one (batch, head) (split-K over
// the triangle, as flash-decoding splits a cache). A block reads its unit
// (first pair, pair count, partial slot) and then the pair list itself, as
// the TPU kernel reads its scalar-prefetched `i_idx` / `j_idx`. A unit that
// is a whole run writes its output; the units of a longer run write partial
// (acc, m, l) or partial sums, f32, to a workspace the wrapper allocates, and
// one small kernel per entry point combines each run's partials in slot
// order: log-sum-exp weights for the forward, plain sums for the backward.
// No atomics: a run is deterministic. For a causal (triangular) list, tiles
// above the diagonal are neither read nor computed; the rectangular list
// computes them under the mask, and a unit that lies wholly above the
// diagonal ends with m = -1e30, whose merge weight exp(-1e30 - m_row) is
// exactly 0 (every row's first unit holds key 0, so m_row is finite).
//
// Inside a unit the layout is the resident kernels': 64 rows a block, a row
// owned by G threads (G = next power of two >= D/16) holding 16 dims each in
// f32 registers, interleaved so the G threads of a row read consecutive
// shared-memory words; the streamed 64-row tiles are staged in shared memory
// as f32, row dot products reduce with warp shuffles. Any T is taken: rows
// and keys past T are masked. The products run on the CUDA cores; mma/wgmma
// and TMA are later work, as for the resident kernels.

#include "common.cuh"

namespace {

constexpr int kTile = 64;   // q rows and keys per tile (flash_attention.py _TILE)
constexpr int kChunk = 16;  // keys per online-softmax update
constexpr int kDPT = 16;    // head dims per thread

// One unit of the visit list: units[3 * u + {0, 1, 2}] = first pair, pair
// count, partial slot (-1: the unit is its run and writes the output).
struct Unit {
  int first, count, slot;
};

__device__ __forceinline__ Unit load_unit(const int* __restrict__ units) {
  const int* u = units + 3 * blockIdx.x;
  return {u[0], u[1], u[2]};
}

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
                                         float mul, float (&r)[kDPT]) {
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int d = g + G * i;
    r[i] = (valid && d < dim) ? dl4j::to_f32(src[off + d]) * mul : 0.f;
  }
}

// Rows [r0, r0 + kTile) of two [B, T, H, D] tensors into shared memory as f32
// ([kTile][DP] each), zero past `seq` and past `dim`.
template <typename T, int G>
__device__ __forceinline__ void stage_tile(const T* __restrict__ a,
                                           const T* __restrict__ b, float* as,
                                           float* bs, size_t base,
                                           size_t stride, int r0, int seq,
                                           int dim) {
  constexpr int DP = G * kDPT;
  for (int e = threadIdx.x; e < kTile * DP; e += kTile * G) {
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

// Where row r of partial slot `slot` of (batch*head) bh starts in a [BH,
// n_slots, kTile, dim] workspace.
__device__ __forceinline__ size_t part_row(int bh, int n_slots, int slot,
                                           int r, int dim) {
  return ((static_cast<size_t>(bh) * n_slots + slot) * kTile + r) * dim;
}

template <int G>
__device__ __forceinline__ void store_part(float* __restrict__ part,
                                           size_t off, int g, int dim,
                                           const float (&r)[kDPT]) {
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int d = g + G * i;
    if (d < dim) part[off + d] = r[i];
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

// ---------------------------------------------------------------- forward

template <typename T, int G>
__global__ void __launch_bounds__(kTile * G)
stream_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, const int* __restrict__ pair_i,
                  const int* __restrict__ pair_j,
                  const int* __restrict__ units, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int n_slots, int seq,
                  int heads, int dim, int causal, float scale) {
  constexpr int DP = G * kDPT;
  extern __shared__ float smem[];
  float* ks = smem;               // [kTile][DP]
  float* vs = smem + kTile * DP;  // [kTile][DP]

  const Unit u = load_unit(units);
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int r = threadIdx.x / G, g = threadIdx.x % G;
  const int qpos = pair_i[u.first] * kTile + r;
  const size_t stride = static_cast<size_t>(heads) * dim;
  const size_t base = static_cast<size_t>(b) * seq * stride +
                      static_cast<size_t>(h) * dim;

  float qr[kDPT], acc[kDPT];
  load_row<T, G>(q, base + static_cast<size_t>(qpos) * stride, qpos < seq, g,
                 dim, scale, qr);
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc[i] = 0.f;
  float m = dl4j::kNeg, l = 0.f;

  for (int p = u.first; p < u.first + u.count; ++p) {
    const int k0 = pair_j[p] * kTile;
    __syncthreads();  // the previous tile is fully consumed
    stage_tile<T, G>(k, v, ks, vs, base, stride, k0, seq, dim);
    __syncthreads();
    const int jn = min(kTile, seq - k0);
    for (int c = 0; c < jn; c += kChunk) {
      float s[kChunk];
      float mx = dl4j::kNeg;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* kr = ks + (c + jj) * DP + g;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kDPT; ++i) part += qr[i] * kr[G * i];
        part = row_sum<G>(part);
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
        const float pw = expf(s[jj] - m_new);
        const float* vr = vs + (c + jj) * DP + g;
        l += pw;
#pragma unroll
        for (int i = 0; i < kDPT; ++i) acc[i] += pw * vr[G * i];
      }
      m = m_new;
    }
  }

  if (qpos >= seq) return;
  if (u.slot < 0) {
    const float lc = fmaxf(l, 1e-30f);
    store_row<T, G>(o, base + static_cast<size_t>(qpos) * stride, g, dim,
                    1.f / lc, acc);
    if (lse != nullptr && g == 0)
      lse[static_cast<size_t>(bh) * seq + qpos] = m + logf(lc);
    return;
  }
  store_part<G>(part_acc, part_row(bh, n_slots, u.slot, r, dim), g, dim, acc);
  if (g == 0) {
    float* ml = part_ml + (static_cast<size_t>(bh) * n_slots + u.slot) * 2 *
                              kTile;
    ml[r] = m;
    ml[kTile + r] = l;
  }
}

// One block per run of several units (merges[3 * x] = q tile, first slot,
// slots): o = sum_u w_u acc_u / sum_u w_u l_u with w_u = exp(m_u - max m),
// lse = max m + log(sum_u w_u l_u).
template <typename T, int G>
__global__ void __launch_bounds__(kTile * G)
stream_merge_kernel(T* __restrict__ o, float* __restrict__ lse,
                    const int* __restrict__ merges,
                    const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml, int n_slots, int seq,
                    int heads, int dim) {
  const int* mg = merges + 3 * blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int r = threadIdx.x / G, g = threadIdx.x % G;
  const int qpos = mg[0] * kTile + r;
  if (qpos >= seq) return;
  const int slot0 = mg[1], n = mg[2];
  const float* ml = part_ml + (static_cast<size_t>(bh) * n_slots + slot0) *
                                  2 * kTile;
  float mx = dl4j::kNeg;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, ml[s * 2 * kTile + r]);
  float acc[kDPT], l = 0.f;
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc[i] = 0.f;
  for (int s = 0; s < n; ++s) {
    const float w = expf(ml[s * 2 * kTile + r] - mx);
    l += w * ml[s * 2 * kTile + kTile + r];
    const float* pa = part_acc + part_row(bh, n_slots, slot0 + s, r, dim);
#pragma unroll
    for (int i = 0; i < kDPT; ++i) {
      const int d = g + G * i;
      if (d < dim) acc[i] += w * pa[d];
    }
  }
  const float lc = fmaxf(l, 1e-30f);
  const size_t stride = static_cast<size_t>(heads) * dim;
  store_row<T, G>(o, static_cast<size_t>(b) * seq * stride +
                         static_cast<size_t>(qpos) * stride +
                         static_cast<size_t>(h) * dim,
                  g, dim, 1.f / lc, acc);
  if (lse != nullptr && g == 0)
    lse[static_cast<size_t>(bh) * seq + qpos] = mx + logf(lc);
}

// --------------------------------------------------------------- backward

// dq over the row-major list: a block holds 64 query rows (q, do, lse, D and
// the dq sum in registers) and streams its unit's K/V tiles.
template <typename T, int G>
__global__ void __launch_bounds__(kTile * G)
stream_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ drow, T* __restrict__ dq,
                 const int* __restrict__ pair_i,
                 const int* __restrict__ pair_j,
                 const int* __restrict__ units, float* __restrict__ part,
                 int n_slots, int seq, int heads, int dim, int causal,
                 float scale) {
  constexpr int DP = G * kDPT;
  extern __shared__ float smem[];
  float* ks = smem;               // [kTile][DP]
  float* vs = smem + kTile * DP;  // [kTile][DP]

  const Unit u = load_unit(units);
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int r = threadIdx.x / G, g = threadIdx.x % G;
  const int qpos = pair_i[u.first] * kTile + r;
  const bool valid = qpos < seq;
  const size_t stride = static_cast<size_t>(heads) * dim;
  const size_t base = static_cast<size_t>(b) * seq * stride +
                      static_cast<size_t>(h) * dim;
  const size_t row = base + static_cast<size_t>(qpos) * stride;

  float qr[kDPT], dor[kDPT], acc[kDPT];
  load_row<T, G>(q, row, valid, g, dim, 1.f, qr);
  load_row<T, G>(dout, row, valid, g, dim, 1.f, dor);
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc[i] = 0.f;
  const size_t srow = static_cast<size_t>(bh) * seq + qpos;
  const float lr = valid ? lse[srow] : 0.f;
  const float dr = valid ? drow[srow] : 0.f;

  for (int p = u.first; p < u.first + u.count; ++p) {
    const int k0 = pair_j[p] * kTile;
    __syncthreads();
    stage_tile<T, G>(k, v, ks, vs, base, stride, k0, seq, dim);
    __syncthreads();
    const int jn = min(kTile, seq - k0);
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
      const bool live = valid && !(causal && k0 + j > qpos);
      const float pw = live ? expf(s * scale - lr) : 0.f;
      const float ds = pw * (dp - dr);
#pragma unroll
      for (int i = 0; i < kDPT; ++i) acc[i] += ds * kr[G * i];
    }
  }
  if (!valid) return;
  if (u.slot < 0)
    store_row<T, G>(dq, row, g, dim, scale, acc);
  else
    store_part<G>(part, part_row(bh, n_slots, u.slot, r, dim), g, dim, acc);
}

// dk/dv over the column-major list: a block holds 64 key rows (k, v and the
// dk, dv sums in registers) and streams its unit's Q/dO tiles with their lse
// and D.
template <typename T, int G>
__global__ void __launch_bounds__(kTile * G)
stream_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ drow, T* __restrict__ dk,
                  T* __restrict__ dv, const int* __restrict__ pair_i,
                  const int* __restrict__ pair_j,
                  const int* __restrict__ units,
                  float* __restrict__ part_dk, float* __restrict__ part_dv,
                  int n_slots, int seq, int heads, int dim, int causal,
                  float scale) {
  constexpr int DP = G * kDPT;
  extern __shared__ float smem[];
  float* qs = smem;                    // [kTile][DP]
  float* dos = smem + kTile * DP;      // [kTile][DP]
  float* ls = smem + 2 * kTile * DP;   // [kTile] lse
  float* dsr = ls + kTile;             // [kTile] D

  const Unit u = load_unit(units);
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int r = threadIdx.x / G, g = threadIdx.x % G;
  const int kpos = pair_j[u.first] * kTile + r;
  const bool valid = kpos < seq;
  const size_t stride = static_cast<size_t>(heads) * dim;
  const size_t base = static_cast<size_t>(b) * seq * stride +
                      static_cast<size_t>(h) * dim;
  const size_t row = base + static_cast<size_t>(kpos) * stride;
  const size_t srow0 = static_cast<size_t>(bh) * seq;

  float kr[kDPT], vr[kDPT], dka[kDPT], dva[kDPT];
  load_row<T, G>(k, row, valid, g, dim, 1.f, kr);
  load_row<T, G>(v, row, valid, g, dim, 1.f, vr);
#pragma unroll
  for (int i = 0; i < kDPT; ++i) dka[i] = dva[i] = 0.f;

  for (int p = u.first; p < u.first + u.count; ++p) {
    const int r0 = pair_i[p] * kTile;
    __syncthreads();
    stage_tile<T, G>(q, dout, qs, dos, base, stride, r0, seq, dim);
    for (int e = threadIdx.x; e < kTile; e += kTile * G) {
      const int rr = r0 + e;
      ls[e] = rr < seq ? lse[srow0 + rr] : 0.f;
      dsr[e] = rr < seq ? drow[srow0 + rr] : 0.f;
    }
    __syncthreads();
    const int jn = min(kTile, seq - r0);
    for (int j = 0; j < jn; ++j) {
      const float* qrow = qs + j * DP + g;
      const float* dorow = dos + j * DP + g;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kDPT; ++i) {
        s += qrow[G * i] * kr[i];
        dp += dorow[G * i] * vr[i];
      }
      s = row_sum<G>(s);
      dp = row_sum<G>(dp);
      const bool live = valid && !(causal && kpos > r0 + j);
      const float pw = live ? expf(s * scale - ls[j]) : 0.f;
      const float ds = pw * (dp - dsr[j]);
#pragma unroll
      for (int i = 0; i < kDPT; ++i) {
        dva[i] += pw * dorow[G * i];
        dka[i] += ds * qrow[G * i];
      }
    }
  }
  if (!valid) return;
  if (u.slot < 0) {
    store_row<T, G>(dk, row, g, dim, scale, dka);
    store_row<T, G>(dv, row, g, dim, 1.f, dva);
  } else {
    store_part<G>(part_dk, part_row(bh, n_slots, u.slot, r, dim), g, dim, dka);
    store_part<G>(part_dv, part_row(bh, n_slots, u.slot, r, dim), g, dim, dva);
  }
}

// One block per run of several units: out = mul * sum of the run's partial
// sums, in slot order.
template <typename T, int G>
__global__ void __launch_bounds__(kTile * G)
stream_sum_kernel(T* __restrict__ out, const int* __restrict__ merges,
                  const float* __restrict__ part, int n_slots, int seq,
                  int heads, int dim, float mul) {
  const int* mg = merges + 3 * blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int r = threadIdx.x / G, g = threadIdx.x % G;
  const int pos = mg[0] * kTile + r;
  if (pos >= seq) return;
  float acc[kDPT];
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc[i] = 0.f;
  for (int s = 0; s < mg[2]; ++s) {
    const float* pa = part + part_row(bh, n_slots, mg[1] + s, r, dim);
#pragma unroll
    for (int i = 0; i < kDPT; ++i) {
      const int d = g + G * i;
      if (d < dim) acc[i] += pa[d];
    }
  }
  const size_t stride = static_cast<size_t>(heads) * dim;
  store_row<T, G>(out, static_cast<size_t>(b) * seq * stride +
                           static_cast<size_t>(pos) * stride +
                           static_cast<size_t>(h) * dim,
                  g, dim, mul, acc);
}

// ----------------------------------------------------------------- launch

// The arguments every entry shares.
struct Args {
  const int* pair_i;
  const int* pair_j;
  const int* units;
  int n_units;
  const int* merges;
  int n_merges;
  int n_slots, batch, seq, heads, dim, causal;
  float scale;
  cudaStream_t stream;
};

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
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, float* part_acc, float* part_ml, const Args& a) {
  constexpr int DP = G * kDPT;
  const int smem = 2 * kTile * DP * static_cast<int>(sizeof(float));
  auto kernel = stream_fwd_kernel<T, G>;
  if (const int e = prepare(kernel, smem)) return e;
  const int bh = a.batch * a.heads;
  kernel<<<dim3(a.n_units, bh), kTile * G, smem, a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, a.pair_i, a.pair_j,
      a.units, part_acc, part_ml, a.n_slots, a.seq, a.heads, a.dim, a.causal,
      a.scale);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (a.n_merges > 0)
    stream_merge_kernel<T, G><<<dim3(a.n_merges, bh), kTile * G, 0,
                                a.stream>>>(
        static_cast<T*>(o), lse, a.merges, part_acc, part_ml, a.n_slots,
        a.seq, a.heads, a.dim);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_sum(void* out, const float* part, float mul, const Args& a) {
  if (a.n_merges > 0)
    stream_sum_kernel<T, G><<<dim3(a.n_merges, a.batch * a.heads), kTile * G,
                              0, a.stream>>>(
        static_cast<T*>(out), a.merges, part, a.n_slots, a.seq, a.heads,
        a.dim, mul);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* drow, void* dq, float* part,
              const Args& a) {
  constexpr int DP = G * kDPT;
  const int smem = 2 * kTile * DP * static_cast<int>(sizeof(float));
  auto kernel = stream_dq_kernel<T, G>;
  if (const int e = prepare(kernel, smem)) return e;
  kernel<<<dim3(a.n_units, a.batch * a.heads), kTile * G, smem, a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, drow,
      static_cast<T*>(dq), a.pair_i, a.pair_j, a.units, part, a.n_slots,
      a.seq, a.heads, a.dim, a.causal, a.scale);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  return launch_sum<T, G>(dq, part, a.scale, a);
}

template <typename T, int G>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* drow, void* dk, void* dv,
               float* part_dk, float* part_dv, const Args& a) {
  constexpr int DP = G * kDPT;
  const int smem =
      (2 * kTile * DP + 2 * kTile) * static_cast<int>(sizeof(float));
  auto kernel = stream_dkv_kernel<T, G>;
  if (const int e = prepare(kernel, smem)) return e;
  kernel<<<dim3(a.n_units, a.batch * a.heads), kTile * G, smem, a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, drow,
      static_cast<T*>(dk), static_cast<T*>(dv), a.pair_i, a.pair_j, a.units,
      part_dk, part_dv, a.n_slots, a.seq, a.heads, a.dim, a.causal, a.scale);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (const int e = launch_sum<T, G>(dk, part_dk, a.scale, a)) return e;
  return launch_sum<T, G>(dv, part_dv, 1.f, a);
}

// Calls `f.template run<T, G>()` for the dtype code and head width.
template <typename F>
int dispatch(int dtype, int dim, const F& f) {
  if (dtype == dl4j::kFloat32) {
    if (dim <= 16) return f.template run<float, 1>();
    if (dim <= 32) return f.template run<float, 2>();
    if (dim <= 64) return f.template run<float, 4>();
    if (dim <= 128) return f.template run<float, 8>();
  } else if (dtype == dl4j::kBFloat16) {
    if (dim <= 16) return f.template run<__nv_bfloat16, 1>();
    if (dim <= 32) return f.template run<__nv_bfloat16, 2>();
    if (dim <= 64) return f.template run<__nv_bfloat16, 4>();
    if (dim <= 128) return f.template run<__nv_bfloat16, 8>();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Fwd {
  const void *q, *k, *v;
  void* o;
  float *lse, *part_acc, *part_ml;
  const Args& a;
  template <typename T, int G>
  int run() const {
    return launch_fwd<T, G>(q, k, v, o, lse, part_acc, part_ml, a);
  }
};

struct Dq {
  const void *q, *k, *v, *dout;
  const float *lse, *drow;
  void* dq;
  float* part;
  const Args& a;
  template <typename T, int G>
  int run() const {
    return launch_dq<T, G>(q, k, v, dout, lse, drow, dq, part, a);
  }
};

struct Dkv {
  const void *q, *k, *v, *dout;
  const float *lse, *drow;
  void *dk, *dv;
  float *part_dk, *part_dv;
  const Args& a;
  template <typename T, int G>
  int run() const {
    return launch_dkv<T, G>(q, k, v, dout, lse, drow, dk, dv, part_dk,
                            part_dv, a);
  }
};

Args make_args(const void* pair_i, const void* pair_j, const void* units,
               int n_units, const void* merges, int n_merges, int n_slots,
               int batch, int seq, int heads, int dim, int causal,
               float scale, void* stream) {
  return {static_cast<const int*>(pair_i), static_cast<const int*>(pair_j),
          static_cast<const int*>(units),  n_units,
          static_cast<const int*>(merges), n_merges,
          n_slots, batch, seq, heads, dim, causal, scale,
          static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q, k, v, o: [batch, seq, heads, dim] contiguous, all of `dtype`; dim <= 128.
// lse: [batch, heads, seq] float32, or null (the no-grad forward). The visit
// list: pair_i, pair_j (q tile, k tile of each visit); units [n_units, 3];
// merges [n_merges, 3]. part_acc [batch*heads, n_slots, 64, dim] and part_ml
// [batch*heads, n_slots, 2, 64], float32 scratch.
extern "C" int dl4j_flash_attention_stream_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* pair_i, const void* pair_j, const void* units, int n_units,
    const void* merges, int n_merges, void* part_acc, void* part_ml,
    int n_slots, int batch, int seq, int heads, int dim, int causal,
    float scale, int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || n_units <= 0) return 0;
  const Args a = make_args(pair_i, pair_j, units, n_units, merges, n_merges,
                           n_slots, batch, seq, heads, dim, causal, scale,
                           stream);
  return dispatch(dtype, dim,
                  Fwd{q, k, v, o, static_cast<float*>(lse),
                      static_cast<float*>(part_acc),
                      static_cast<float*>(part_ml), a});
}

// q, k, v, dout, dq as the forward's q; lse, drow: [batch, heads, seq]
// float32; the row-major visit list; part [batch*heads, n_slots, 64, dim]
// float32 scratch.
extern "C" int dl4j_flash_attention_stream_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* drow, void* dq, const void* pair_i,
    const void* pair_j, const void* units, int n_units, const void* merges,
    int n_merges, void* part, int n_slots, int batch, int seq, int heads,
    int dim, int causal, float scale, int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || n_units <= 0) return 0;
  const Args a = make_args(pair_i, pair_j, units, n_units, merges, n_merges,
                           n_slots, batch, seq, heads, dim, causal, scale,
                           stream);
  return dispatch(dtype, dim,
                  Dq{q, k, v, dout, static_cast<const float*>(lse),
                     static_cast<const float*>(drow), dq,
                     static_cast<float*>(part), a});
}

// As the dq entry, over the column-major visit list; writes dk and dv, with
// part_dk, part_dv [batch*heads, n_slots, 64, dim] float32 scratch.
extern "C" int dl4j_flash_attention_stream_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* drow, void* dk, void* dv,
    const void* pair_i, const void* pair_j, const void* units, int n_units,
    const void* merges, int n_merges, void* part_dk, void* part_dv,
    int n_slots, int batch, int seq, int heads, int dim, int causal,
    float scale, int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || n_units <= 0) return 0;
  const Args a = make_args(pair_i, pair_j, units, n_units, merges, n_merges,
                           n_slots, batch, seq, heads, dim, causal, scale,
                           stream);
  return dispatch(dtype, dim,
                  Dkv{q, k, v, dout, static_cast<const float*>(lse),
                      static_cast<const float*>(drow), dk, dv,
                      static_cast<float*>(part_dk),
                      static_cast<float*>(part_dv), a});
}
