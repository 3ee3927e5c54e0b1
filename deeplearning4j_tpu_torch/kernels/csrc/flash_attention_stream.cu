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
// (1.67 ms) and dk/dv ~2.2e12 (2.22 ms): operations bound all three, by
// 30-50x, which is why their bf16 forms run on the tensor cores.
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
// Inside a unit, two forms of the same math, picked by the wrapper by dtype
// and head width alone (kernels/flash_attention.py `stream_fwd_variant`,
// `stream_bwd_variant`):
// - bf16 at D = 64 or 128, the slice's case: `stream_fwd_wgmma_kernel`,
//   `stream_dq_wgmma_kernel` and `stream_dkv_wgmma_kernel`, every product
//   on the tensor cores (see their notes below);
// - f32, and bf16 at any other D: `stream_fwd_kernel`, `stream_dq_kernel`
//   and `stream_dkv_kernel`, the resident kernels' CUDA-core layout: 64
//   rows a block, a row owned by G threads (G = next power of two >= D/16)
//   holding 16 dims each in f32 registers, interleaved so the G threads of
//   a row read consecutive shared-memory words; the streamed 64-row tiles
//   staged in shared memory as f32, row dot products reduced with warp
//   shuffles.
// Both forms write the same outputs and the same partials, which the same
// merge and sum kernels combine. Any T is taken: rows and keys past T are
// masked.
//
// The three tensor-core kernels also run the resident rows 3, 5 and 6
// (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu, through
// flash_wgmma.cuh) in bf16 at D = 64 or 128: the same tile loops over a
// second schedule, picked at compile time (`block_work`'s kRows): a block
// per whole run (q tile or k tile), longest first, writing its output from
// registers; no list, no partials, no merge or sum kernel. Rows 4 and 7
// instantiate the list schedule, whose code is what it was before the rows
// schedule was added.

#include <cstdio>

#include "common.cuh"
#include "flash_wgmma.cuh"
#include "hopper.cuh"

namespace {

namespace hopper = dl4j::hopper;

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

// A tensor-core block's share of the work: its (batch, head), the 64-row
// tile it holds (q rows for the forward and dq, keys for dk/dv), where its
// streamed tiles start and how many there are, and where its output goes
// (a partial slot, or -1: the output itself).
struct Work {
  int bh, held, first, count, slot;
};

// The two schedules of the tensor-core kernels (template flag kRows).
// - List (rows 4, 7): unit blockIdx.x of the visit list of (batch, head)
//   blockIdx.y; the held tile is held_of[first] (pair_i of a row-major
//   list, pair_j of a column-major one), streamed tile i streamed_of[first
//   + i] (`step_tile`).
// - Rows (rows 3, 5, 6; csrc/flash_attention.cu, csrc/flash_attention_bwd.cu):
//   no list, no partials. Block (x, y) is the whole run of rank y of (batch,
//   head) x, rank 0 the longest; blocks issue x fastest, so every (batch,
//   head)'s longest run starts before any shorter one. A row (forward, dq:
//   kColumns false) is q tile n - 1 - y over k tiles 0 .. its diagonal, all
//   n when not causal; a column (dk/dv) is k tile y over q tiles from its
//   diagonal (0 when not causal) to n - 1. The tile and the count are fixed
//   here, before any loop.
template <bool kRows, bool kColumns>
__device__ __forceinline__ Work block_work(const int* __restrict__ units,
                                           const int* __restrict__ held_of,
                                           int seq, int causal) {
  if constexpr (kRows) {
    const int n = (seq + kTile - 1) / kTile;
    const int rank = blockIdx.y;
    const int bh = blockIdx.x;
    if constexpr (kColumns) {
      const int first = causal ? rank : 0;
      return {bh, rank, first, n - first, -1};
    } else {
      const int held = n - 1 - rank;
      return {bh, held, 0, causal ? held + 1 : n, -1};
    }
  } else {
    const Unit u = load_unit(units);
    const int bh = blockIdx.y;
    return {bh, held_of[u.first], u.first, u.count, u.slot};
  }
}

// The tile that step i of a block streams in.
template <bool kRows>
__device__ __forceinline__ int step_tile(const int* __restrict__ streamed_of,
                                         const Work& w, int i) {
  if constexpr (kRows)
    return w.first + i;
  else
    return streamed_of[w.first + i];
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

// ------------------------------------------------ forward on tensor cores
//
// `stream_fwd_wgmma_kernel`: the unit kernel above for bf16 at D = 64 or
// 128, with both products on Hopper's tensor cores. It replaces the same
// TPU kernel (`_flash_stream_kernel`, deeplearning4j_tpu/kernels/
// flash_attention.py:137) and computes what `stream_fwd_kernel` computes,
// writing the same outputs and the same partials (`part_row` layout), which
// the same `stream_merge_kernel` combines; grid (units, batch * heads).
// Over the rows schedule (kRows) it is rows 3 and 5 on the tensor cores:
// grid (batch * heads, q tiles), a block per whole q-tile row, o and lse
// (or o alone) written directly.
//
// Bound at the slice's shape ([1, 32768, 8, 64] bf16, causal): the two
// products over the causal half, ~1.1e12 operations, 1.112 ms at 989
// TFLOP/s (bf16 dense), against ~134 MB of traffic (0.04 ms): operations.
// The CUDA-core kernel reached ~14 TFLOP/s there on an H100 (78.40 ms).
//
// Design (one consumer warpgroup, no warp specialisation):
// - A block is one warpgroup (128 threads) and one 64-row q tile: wgmma
//   takes 64 rows. Thread 0 issues every TMA load; several blocks per SM
//   hide each other's latency.
// - K and V come in by TMA through a ring of kStages (K, V) stages, one
//   mbarrier each (arrive.expect_tx, try_wait.parity); Q once per unit.
//   Each load is a box {64 dims, 1 head, 64 rows, 1 batch} of a 4-D tensor
//   map over [B, T, H, D] with the 128-byte swizzle (two boxes per tile at
//   D = 128): rows at or past T within a batch come in as zeros, and the
//   kernel still masks those keys (a zero key scores 0, not -1e30).
// - s = q k^T: wgmma m64n64k16, A (Q) and B (K, [64 keys][D], K-major)
//   from shared memory, D / 16 k-steps, f32 accumulators (32 a thread);
//   the scale is applied to s in f32 after the product.
// - The online softmax runs in registers: a thread holds two rows of s,
//   row maxima reduce over the 4 threads of a quad; m and l are f32, l sums
//   the f32 p; masked scores are the JAX package's finite -1e30, so a unit
//   wholly above the diagonal ends at m = -1e30 and weighs 0 in the merge.
// - o += p v: wgmma m64nDk16 with A = p rounded to bf16 in registers (the
//   s accumulator layout is the A fragment layout, 16 columns at a time)
//   and B = the V tile, MN-major for this product (the transpose bit).
// - A stage is refilled (tile i + kStages) once every thread has waited
//   for the p v product that read it and passed a block barrier.
//
// ptxas (-Xptxas -v, sm_90a): 96 registers at D = 64, 128 at D = 128, no
// spills, no stack, over either schedule; shared memory is all dynamic,
// `WgTile`'s kSmem: 58,400 bytes at D = 64 (3 stages), 82,968 at D = 128
// (2 stages). chip_smoke.py prints the ptxas lines in its build phase.
// Later work: a producer warp with setmaxnreg, two consumer warpgroups in
// ping-pong so softmax overlaps the other's products, and K/V stages
// released per product instead of per tile (FlashAttention-3's schedule).

constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kBoxBytes = kTile * 64 * 2;   // one TMA box: 64 rows x 128 B
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgTile {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kBytes = kBoxBytes * (D / 64);  // a Q, K or V tile
  // Slack to align the tiles to 1024 bytes (the swizzle atom), the tiles,
  // then one barrier per stage and one for Q.
  static constexpr int kSmem =
      1024 + kBytes * (1 + 2 * kStages) + 8 * (kStages + 1);
};

// Rows [t0, t0 + 64) of (batch b, head h): D / 64 boxes of 64 x 64.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int t0, int h,
                                          int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    hopper::tma_load_4d(dst + c * kBoxBytes, map, bar, c * 64, h, t0, b);
}

// d = A B^T for two 64-row tiles of D dims in shared memory, both read
// K-major: D / 16 wgmma k-steps (k-step kk at byte 32 * (kk % 4) of box
// kk / 4), the first overwriting d.
template <int D>
__device__ __forceinline__ void wg_dot_rows(float (&d)[32], const uint8_t* a,
                                            const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss(d, hopper::sw128_desc(a + off, 16, 1024),
                               hopper::sw128_desc(b + off, 16, 1024),
                               kk > 0);
  }
}

// The 64 columns of an m64n64 f32 accumulator rounded to bf16 A fragments,
// one per k16 step (the layout in hopper.cuh).
__device__ __forceinline__ void pack_a(const float (&s)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = hopper::pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// acc += P B: P [64 x 64] as bf16 A fragments from registers, B a 64-row
// tile of D dims read MN-major (the transpose bit; LBO one box between the
// 64-wide halves at D = 128, SBO 1024, a k-step of 16 rows 2048 bytes).
template <int D>
__device__ __forceinline__ void wg_acc_tile(float (&acc)[D / 2],
                                            const uint32_t (&pa)[4][4],
                                            const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc =
        hopper::sw128_desc(b + kk * 16 * 128, kBoxBytes, 1024);
    if constexpr (D == 64)
      hopper::wgmma_m64n64k16_rs_tb(acc, pa[kk], desc);
    else
      hopper::wgmma_m64n128k16_rs_tb(acc, pa[kk], desc);
  }
}

template <int D, bool kRows>
__global__ void __launch_bounds__(kWgThreads)
stream_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse,
                        const int* __restrict__ pair_i,
                        const int* __restrict__ pair_j,
                        const int* __restrict__ units,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int n_slots, int seq,
                        int heads, int causal, float scale) {
  constexpr int S = WgTile<D>::kStages, TB = WgTile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hopper::align_1024(smem_raw);
  uint8_t* ks = qs + TB;      // [S] K tiles
  uint8_t* vs = ks + S * TB;  // [S] V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + S * TB);  // [S], Q

  const Work u = block_work<kRows, false>(units, pair_i, seq, causal);
  const int bh = u.bh;
  const int b = bh / heads, h = bh % heads;
  const int q0 = u.held * kTile;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i <= S; ++i) hopper::mbar_init(full + i, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(full + S, TB);
    load_tile<D>(qs, &tq, full + S, q0, h, b);
    for (int i = 0; i < S && i < u.count; ++i) {
      const int k0 = step_tile<kRows>(pair_j, u, i) * kTile;
      hopper::mbar_expect_tx(full + i, 2 * TB);
      load_tile<D>(ks + i * TB, &tk, full + i, k0, h, b);
      load_tile<D>(vs + i * TB, &tv, full + i, k0, h, b);
    }
  }

  // This thread's rows of every accumulator (see hopper.cuh): row0 and
  // row0 + 8; its columns 8 j + cq + {0, 1}.
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qp[2] = {q0 + row0, q0 + row0 + 8};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {dl4j::kNeg, dl4j::kNeg}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(full + S, 0);

  for (int i = 0; i < u.count; ++i) {
    const int st = i % S;
    const int k0 = step_tile<kRows>(pair_j, u, i) * kTile;
    const uint8_t* kt = ks + st * TB;
    const uint8_t* vt = vs + st * TB;
    hopper::mbar_wait(full + st, (i / S) & 1);

    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    hopper::fence_regs(s);
    hopper::wgmma_fence();
    wg_dot_rows<D>(s, qs, kt);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);

    // Scale and mask in f32; only a tile that crosses the diagonal or T
    // needs the mask.
    const bool edge = k0 + kTile > seq || (causal && k0 + kTile - 1 > q0);
    float mx[2] = {dl4j::kNeg, dl4j::kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * r + c] * scale;
          if (edge) {
            const int kp = k0 + 8 * j + cq + c;
            if (kp >= seq || (causal && kp > qp[r])) x = dl4j::kNeg;
          }
          s[4 * j + 2 * r + c] = x;
          mx[r] = fmaxf(mx[r], x);
        }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f((s[4 * j + 2 * r + c] - m[r]) * kLog2e);
          s[4 * j + 2 * r + c] = p;
          l[r] += p;  // this thread's columns; the quad sums at the end
        }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * j + 2 * r] *= corr[r];
        acc[4 * j + 2 * r + 1] *= corr[r];
      }
    uint32_t pa[4][4];
    pack_a(s, pa);

    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    wg_acc_tile<D>(acc, pa, vt);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);

    __syncthreads();  // every thread is done with stage st
    if (tid == 0 && i + S < u.count) {
      const int kn = step_tile<kRows>(pair_j, u, i + S) * kTile;
      hopper::mbar_expect_tx(full + st, 2 * TB);
      load_tile<D>(ks + st * TB, &tk, full + st, kn, h, b);
      load_tile<D>(vs + st * TB, &tv, full + st, kn, h, b);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t stride = static_cast<size_t>(heads) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qp[r] >= seq) continue;
    if (u.slot < 0) {
      const float lc = fmaxf(l[r], 1e-30f), inv = 1.f / lc;
      __nv_bfloat16* orow = o + (static_cast<size_t>(b) * seq + qp[r]) *
                                    stride + static_cast<size_t>(h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                  acc[4 * j + 2 * r + 1] * inv);
      if (lse != nullptr && cq == 0)
        lse[static_cast<size_t>(bh) * seq + qp[r]] = m[r] + logf(lc);
      continue;
    }
    float* prow = part_acc + part_row(bh, n_slots, u.slot, row0 + 8 * r, D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(prow + 8 * j + cq) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    if (cq == 0) {
      float* ml = part_ml + (static_cast<size_t>(bh) * n_slots + u.slot) *
                                2 * kTile;
      ml[row0 + 8 * r] = m[r];
      ml[kTile + row0 + 8 * r] = l[r];
    }
  }
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

// ----------------------------------------------- backward on tensor cores
//
// `stream_dq_wgmma_kernel` and `stream_dkv_wgmma_kernel`: the two unit
// kernels above for bf16 at D = 64 or 128 (`stream_bwd_variant`), every
// product on Hopper's tensor cores. They replace the same
// TPU kernels (`_flash_bwd_dq_stream_kernel`, `_flash_bwd_dkv_stream_kernel`,
// deeplearning4j_tpu/kernels/flash_attention.py:551, :595), compute what
// `stream_dq_kernel` and `stream_dkv_kernel` compute over the same units,
// and write the same outputs and the same f32 partials (`part_row`
// layout), which the same `stream_sum_kernel` adds up; grid (units, batch *
// heads). Over the rows schedule (kRows) they are row 6 on the tensor
// cores: grid (batch * heads, tiles), a block per whole q-tile row (dq) or
// k-tile column (dk/dv), written directly.
//
// Bound at the slice's shape ([1, 32768, 8, 64] bf16, causal): dq is three
// products over the causal half (s, dp, ds k), ~1.65e12 operations, 1.668
// ms at 989 TFLOP/s; dk/dv four (s^T, dp^T, p^T do, ds^T q), ~2.2e12, 2.224
// ms; against ~170 MB of traffic (0.05 ms): operations. The CUDA-core
// kernels reached 17-21 TFLOP/s there on an H100 (94.41 and 104.66 ms).
//
// Design: `stream_fwd_wgmma_kernel`'s, with two tiles held per unit.
// - A block is one warpgroup and one 64-row tile of the unit's outer side:
//   q rows for dq (Q and dO held), keys for dk/dv (K and V held), brought
//   in once by TMA on their own barrier. The streamed side comes through a
//   ring of kStages stages, each a pair of tiles on one mbarrier: (K, V)
//   for dq, (Q, dO) for dk/dv. Boxes, map and swizzle as the forward's.
// - dq, per tile: s = q k^T and dp = do v^T (SS, both K-major), one commit
//   group; then in f32 registers p = exp2((s * scale - lse) * log2 e) and
//   ds = p * (dp - D); then dq += ds k with ds rounded to bf16 as register
//   A and the K tile read MN-major (the transpose bit), as the forward's
//   p v. lse and D of the thread's two rows are loaded once per unit.
// - dk/dv, per tile: s^T = k q^T (SS), then p^T; dv += p^T do (register A,
//   the dO tile MN-major) in one commit group with dp^T = v do^T (SS);
//   then ds^T = p^T * (dp^T - D) from the f32 p^T; then dk += ds^T q (the
//   Q tile MN-major). Three commit groups: dp^T is not live while the lse
//   of the tile is, and no group waits on more than two products. lse and
//   D are indexed by column: each
//   thread loads its 16 columns' values with plain loads (all warps read
//   the same 64, from L1) at the top of the tile, before it waits for the
//   stage.
// - Masks: keys at or past T, queries at or past T, and key > query when
//   causal give p = 0 exactly, as the CUDA-core kernels' `live` does; the
//   test runs only on a tile that crosses the diagonal or T. TMA's zero
//   rows past T are not relied on: a zero row scores 0, not a masked value.
// - Every product sits between fence_regs / wgmma_fence and commit / wait,
//   so the elementwise passes stay out of the asynchronous window. A stage
//   is refilled (tile i + kStages) once every thread has waited for the
//   last product that read it (ds k; ds^T q) and passed a block barrier.
// - No atomics: dq, dk and dv come from registers of one block, or from
//   partials summed in slot order; a run is bit-identical on a repeat.
//
// ptxas (-Xptxas -v, sm_90a, nvcc 12.9): dq
// 122 registers at D = 64, 154 at D = 128, over either schedule; dk/dv 176
// and 240 over the list, 176 and 244 over the rows; no spills, no stack.
// Shared memory is all dynamic, `WgBwdTile`'s kSmem: 66,592
// bytes at D = 64 (3 stages), 99,352 at D = 128 (2 stages). chip_smoke.py
// prints the ptxas lines in its build phase.

template <int D>
struct WgBwdTile {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kBytes = kBoxBytes * (D / 64);  // one 64-row tile
  // Slack to align the tiles to 1024 bytes, the two held tiles, kStages
  // pairs of streamed tiles, one barrier per stage and one for the held.
  static constexpr int kSmem =
      1024 + kBytes * (2 + 2 * kStages) + 8 * (kStages + 1);
};

// This thread's two rows (t0 + row0 + 8 r) of an m64nD accumulator: times
// `mul` as bf16 rows of a [B, T, H, D] tensor when the unit is its run
// (slot < 0), else unscaled as f32 rows of partial slot `slot`; rows at or
// past T are skipped.
template <int D>
__device__ __forceinline__ void store_acc(
    const float (&acc)[D / 2], float mul, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int slot, int n_slots, int bh, int b, int h,
    int heads, int seq, int t0, int row0, int cq) {
  const size_t stride = static_cast<size_t>(heads) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + row0 + 8 * r;
    if (t >= seq) continue;
    if (slot < 0) {
      __nv_bfloat16* row = out + (static_cast<size_t>(b) * seq + t) * stride +
                           static_cast<size_t>(h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + cq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul,
                                  acc[4 * j + 2 * r + 1] * mul);
      continue;
    }
    float* prow = part + part_row(bh, n_slots, slot, row0 + 8 * r, D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(prow + 8 * j + cq) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int D, bool kRows>
__global__ void __launch_bounds__(kWgThreads)
stream_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ drow,
                       __nv_bfloat16* __restrict__ dq,
                       const int* __restrict__ pair_i,
                       const int* __restrict__ pair_j,
                       const int* __restrict__ units,
                       float* __restrict__ part, int n_slots, int seq,
                       int heads, int causal, float scale) {
  constexpr int S = WgBwdTile<D>::kStages, TB = WgBwdTile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hopper::align_1024(smem_raw);
  uint8_t* dos = qs + TB;
  uint8_t* ks = dos + TB;     // [S] K tiles
  uint8_t* vs = ks + S * TB;  // [S] V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + S * TB);  // [S], Q+dO

  const Work u = block_work<kRows, false>(units, pair_i, seq, causal);
  const int bh = u.bh;
  const int b = bh / heads, h = bh % heads;
  const int q0 = u.held * kTile;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i <= S; ++i) hopper::mbar_init(full + i, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(full + S, 2 * TB);
    load_tile<D>(qs, &tq, full + S, q0, h, b);
    load_tile<D>(dos, &tdo, full + S, q0, h, b);
    for (int i = 0; i < S && i < u.count; ++i) {
      const int k0 = step_tile<kRows>(pair_j, u, i) * kTile;
      hopper::mbar_expect_tx(full + i, 2 * TB);
      load_tile<D>(ks + i * TB, &tk, full + i, k0, h, b);
      load_tile<D>(vs + i * TB, &tv, full + i, k0, h, b);
    }
  }

  // This thread's rows (row0, row0 + 8) and columns (8 j + cq + {0, 1}) of
  // every accumulator (hopper.cuh).
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qp[2] = {q0 + row0, q0 + row0 + 8};
  const float sl2 = scale * kLog2e;
  float l2[2], dr[2];  // lse * log2 e and D of the two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = qp[r] < seq;
    const size_t at = static_cast<size_t>(bh) * seq + qp[r];
    l2[r] = valid ? lse[at] * kLog2e : 0.f;
    dr[r] = valid ? drow[at] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  hopper::mbar_wait(full + S, 0);

  for (int i = 0; i < u.count; ++i) {
    const int st = i % S;
    const int k0 = step_tile<kRows>(pair_j, u, i) * kTile;
    const uint8_t* kt = ks + st * TB;
    const uint8_t* vt = vs + st * TB;
    hopper::mbar_wait(full + st, (i / S) & 1);

    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    wg_dot_rows<D>(s, qs, kt);
    wg_dot_rows<D>(dp, dos, vt);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // ds = p * (dp - D) in f32, into s; only a tile that crosses the
    // diagonal or T needs the mask.
    const bool edge = k0 + kTile > seq || q0 + kTile > seq ||
                      (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * r + c;
          float p = exp2f(s[e] * sl2 - l2[r]);
          if (edge) {
            const int kp = k0 + 8 * j + cq + c;
            if (kp >= seq || qp[r] >= seq || (causal && kp > qp[r])) p = 0.f;
          }
          s[e] = p * (dp[e] - dr[r]);
        }
    uint32_t da[4][4];
    pack_a(s, da);

    hopper::fence_frags(da);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    wg_acc_tile<D>(acc, da, kt);  // dq += ds k
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::fence_frags(da);

    __syncthreads();  // every thread is done with stage st
    if (tid == 0 && i + S < u.count) {
      const int kn = step_tile<kRows>(pair_j, u, i + S) * kTile;
      hopper::mbar_expect_tx(full + st, 2 * TB);
      load_tile<D>(ks + st * TB, &tk, full + st, kn, h, b);
      load_tile<D>(vs + st * TB, &tv, full + st, kn, h, b);
    }
  }

  store_acc<D>(acc, scale, dq, part, u.slot, n_slots, bh, b, h, heads, seq,
               q0, row0, cq);
}

template <int D, bool kRows>
__global__ void __launch_bounds__(kWgThreads)
stream_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ drow,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv,
                        const int* __restrict__ pair_i,
                        const int* __restrict__ pair_j,
                        const int* __restrict__ units,
                        float* __restrict__ part_dk,
                        float* __restrict__ part_dv, int n_slots, int seq,
                        int heads, int causal, float scale) {
  constexpr int S = WgBwdTile<D>::kStages, TB = WgBwdTile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = hopper::align_1024(smem_raw);
  uint8_t* vs = ks + TB;
  uint8_t* qs = vs + TB;        // [S] Q tiles
  uint8_t* dos = qs + S * TB;   // [S] dO tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(dos + S * TB);  // [S], K+V

  const Work u = block_work<kRows, true>(units, pair_j, seq, causal);
  const int bh = u.bh;
  const int b = bh / heads, h = bh % heads;
  const int k0 = u.held * kTile;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i <= S; ++i) hopper::mbar_init(full + i, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(full + S, 2 * TB);
    load_tile<D>(ks, &tk, full + S, k0, h, b);
    load_tile<D>(vs, &tv, full + S, k0, h, b);
    for (int i = 0; i < S && i < u.count; ++i) {
      const int r0 = step_tile<kRows>(pair_i, u, i) * kTile;
      hopper::mbar_expect_tx(full + i, 2 * TB);
      load_tile<D>(qs + i * TB, &tq, full + i, r0, h, b);
      load_tile<D>(dos + i * TB, &tdo, full + i, r0, h, b);
    }
  }

  // Rows are keys (k0 + row0 + 8 r), columns queries (r0 + 8 j + cq + c).
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int kp[2] = {k0 + row0, k0 + row0 + 8};
  const float sl2 = scale * kLog2e;
  const float* lse_bh = lse + static_cast<size_t>(bh) * seq;
  const float* drow_bh = drow + static_cast<size_t>(bh) * seq;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  hopper::mbar_wait(full + S, 0);

  for (int i = 0; i < u.count; ++i) {
    const int st = i % S;
    const int r0 = step_tile<kRows>(pair_i, u, i) * kTile;
    const uint8_t* qt = qs + st * TB;
    const uint8_t* dot = dos + st * TB;
    float l2[16], dd[16];  // lse * log2 e and D of this thread's columns
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = r0 + 8 * j + cq + c;
        l2[2 * j + c] = qc < seq ? lse_bh[qc] * kLog2e : 0.f;
        dd[2 * j + c] = qc < seq ? drow_bh[qc] : 0.f;
      }
    hopper::mbar_wait(full + st, (i / S) & 1);

    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    hopper::fence_regs(s);
    hopper::wgmma_fence();
    wg_dot_rows<D>(s, ks, qt);  // s^T = k q^T
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);

    const bool edge = r0 + kTile > seq || k0 + kTile > seq ||
                      (causal && k0 + kTile - 1 > r0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * r + c;
          float p = exp2f(s[e] * sl2 - l2[2 * j + c]);
          if (edge) {
            const int qc = r0 + 8 * j + cq + c;
            if (qc >= seq || kp[r] >= seq || (causal && kp[r] > qc)) p = 0.f;
          }
          s[e] = p;
        }
    uint32_t pa[4][4];
    pack_a(s, pa);

    float dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = 0.f;
    hopper::fence_frags(pa);
    hopper::fence_regs(dp);
    hopper::fence_regs(dva);
    hopper::wgmma_fence();
    wg_acc_tile<D>(dva, pa, dot);  // dv += p^T do
    wg_dot_rows<D>(dp, vs, dot);   // dp^T = v do^T
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(dp);
    hopper::fence_regs(dva);
    hopper::fence_frags(pa);

    // ds^T = p^T * (dp^T - D), with p^T f32 still in s.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * r + c;
          dp[e] = s[e] * (dp[e] - dd[2 * j + c]);
        }
    uint32_t da[4][4];
    pack_a(dp, da);

    hopper::fence_frags(da);
    hopper::fence_regs(dka);
    hopper::wgmma_fence();
    wg_acc_tile<D>(dka, da, qt);  // dk += ds^T q
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(dka);
    hopper::fence_frags(da);

    __syncthreads();  // every thread is done with stage st
    if (tid == 0 && i + S < u.count) {
      const int rn = step_tile<kRows>(pair_i, u, i + S) * kTile;
      hopper::mbar_expect_tx(full + st, 2 * TB);
      load_tile<D>(qs + st * TB, &tq, full + st, rn, h, b);
      load_tile<D>(dos + st * TB, &tdo, full + st, rn, h, b);
    }
  }

  store_acc<D>(dka, scale, dk, part_dk, u.slot, n_slots, bh, b, h, heads,
               seq, k0, row0, cq);
  store_acc<D>(dva, 1.f, dv, part_dv, u.slot, n_slots, bh, b, h, heads, seq,
               k0, row0, cq);
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
int launch_merge(void* o, float* lse, float* part_acc, float* part_ml,
                 const Args& a) {
  if (a.n_merges > 0)
    stream_merge_kernel<T, G><<<dim3(a.n_merges, a.batch * a.heads),
                                kTile * G, 0, a.stream>>>(
        static_cast<T*>(o), lse, a.merges, part_acc, part_ml, a.n_slots,
        a.seq, a.heads, a.dim);
  return static_cast<int>(cudaGetLastError());
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
  return launch_merge<T, G>(o, lse, part_acc, part_ml, a);
}

// The tensor-core unit kernel (bf16, D = 64 or 128).

// A 4-D map over a contiguous bf16 [batch, seq, heads, dim] tensor: dims
// innermost first, boxes of {64 dims, 1 head, 64 rows, 1 batch}, 128-byte
// swizzle, zeros past each bound (rows >= seq within a batch too).
int tile_map(CUtensorMap* map, const void* ptr, const Args& a) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t row = static_cast<cuuint64_t>(a.heads) * a.dim * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.dim),
                              static_cast<cuuint64_t>(a.heads),
                              static_cast<cuuint64_t>(a.seq),
                              static_cast<cuuint64_t>(a.batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(a.dim) * 2, row,
                                 row * a.seq};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    std::fprintf(stderr, "cuTensorMapEncodeTiled failed: CUresult %d\n",
                 static_cast<int>(r));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// The grid of a tensor-core kernel: (units, batch * heads) over the list,
// (batch * heads, tiles) over the rows (`block_work`).
template <bool kRows>
dim3 wg_grid(const Args& a) {
  if constexpr (kRows)
    return dim3(a.batch * a.heads, (a.seq + kTile - 1) / kTile);
  else
    return dim3(a.n_units, a.batch * a.heads);
}

template <int D, bool kRows>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                     float* lse, float* part_acc, float* part_ml,
                     const Args& a) {
  CUtensorMap tq, tk, tv;
  if (const int e = tile_map(&tq, q, a)) return e;
  if (const int e = tile_map(&tk, k, a)) return e;
  if (const int e = tile_map(&tv, v, a)) return e;
  constexpr int smem = WgTile<D>::kSmem;
  auto kernel = stream_fwd_wgmma_kernel<D, kRows>;
  if (const int e = prepare(kernel, smem)) return e;
  kernel<<<wg_grid<kRows>(a), kWgThreads, smem,
           a.stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse,
                       a.pair_i, a.pair_j, a.units, part_acc, part_ml,
                       a.n_slots, a.seq, a.heads, a.causal, a.scale);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  return launch_merge<__nv_bfloat16, D / 16>(o, lse, part_acc, part_ml, a);
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

// The tensor-core unit kernels of the backward (bf16, D = 64 or 128), each
// followed by the same sum kernels as the CUDA-core ones.

int bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k,
             const void* v, const void* dout, const Args& a) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (const int e = tile_map(&m[i], ptrs[i], a)) return e;
  return 0;
}

template <int D, bool kRows>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* drow,
                    void* dq, float* part, const Args& a) {
  CUtensorMap m[4];
  if (const int e = bwd_maps(m, q, k, v, dout, a)) return e;
  constexpr int smem = WgBwdTile<D>::kSmem;
  auto kernel = stream_dq_wgmma_kernel<D, kRows>;
  if (const int e = prepare(kernel, smem)) return e;
  kernel<<<wg_grid<kRows>(a), kWgThreads, smem,
           a.stream>>>(m[0], m[1], m[2], m[3], lse, drow,
                       static_cast<__nv_bfloat16*>(dq), a.pair_i, a.pair_j,
                       a.units, part, a.n_slots, a.seq, a.heads, a.causal,
                       a.scale);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  return launch_sum<__nv_bfloat16, D / 16>(dq, part, a.scale, a);
}

template <int D, bool kRows>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* drow,
                     void* dk, void* dv, float* part_dk, float* part_dv,
                     const Args& a) {
  CUtensorMap m[4];
  if (const int e = bwd_maps(m, q, k, v, dout, a)) return e;
  constexpr int smem = WgBwdTile<D>::kSmem;
  auto kernel = stream_dkv_wgmma_kernel<D, kRows>;
  if (const int e = prepare(kernel, smem)) return e;
  kernel<<<wg_grid<kRows>(a), kWgThreads, smem,
           a.stream>>>(m[0], m[1], m[2], m[3], lse, drow,
                       static_cast<__nv_bfloat16*>(dk),
                       static_cast<__nv_bfloat16*>(dv), a.pair_i, a.pair_j,
                       a.units, part_dk, part_dv, a.n_slots, a.seq, a.heads,
                       a.causal, a.scale);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  using T = __nv_bfloat16;
  if (const int e = launch_sum<T, D / 16>(dk, part_dk, a.scale, a)) return e;
  return launch_sum<T, D / 16>(dv, part_dv, 1.f, a);
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

// The rows schedule's arguments: no list, no partials.
Args rows_args(int batch, int seq, int heads, int dim, int causal,
               float scale, void* stream) {
  return make_args(nullptr, nullptr, nullptr, 0, nullptr, 0, 0, batch, seq,
                   heads, dim, causal, scale, stream);
}

// The rows grid's y is the rank: at most 65,535 tiles (T < 4,194,304).
bool rows_fit(const Args& a) { return (a.seq + kTile - 1) / kTile <= 65535; }

}  // namespace

// The tensor-core forms of the resident rows 3, 5 and 6 (flash_wgmma.cuh):
// the kernels above over the rows schedule, one launch each.
namespace dl4j {
namespace flash {

int rows_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int seq, int heads, int dim,
                   int causal, float scale, void* stream) {
  const Args a = rows_args(batch, seq, heads, dim, causal, scale, stream);
  if (!rows_fit(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (dim == 64)
    return launch_fwd_wgmma<64, true>(q, k, v, o, lse, nullptr, nullptr, a);
  if (dim == 128)
    return launch_fwd_wgmma<128, true>(q, k, v, o, lse, nullptr, nullptr, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

int rows_dq_wgmma(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* drow,
                  void* dq, int batch, int seq, int heads, int dim,
                  int causal, float scale, void* stream) {
  const Args a = rows_args(batch, seq, heads, dim, causal, scale, stream);
  if (!rows_fit(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (dim == 64)
    return launch_dq_wgmma<64, true>(q, k, v, dout, lse, drow, dq, nullptr,
                                     a);
  if (dim == 128)
    return launch_dq_wgmma<128, true>(q, k, v, dout, lse, drow, dq, nullptr,
                                      a);
  return static_cast<int>(cudaErrorInvalidValue);
}

int rows_dkv_wgmma(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* drow,
                   void* dk, void* dv, int batch, int seq, int heads,
                   int dim, int causal, float scale, void* stream) {
  const Args a = rows_args(batch, seq, heads, dim, causal, scale, stream);
  if (!rows_fit(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (dim == 64)
    return launch_dkv_wgmma<64, true>(q, k, v, dout, lse, drow, dk, dv,
                                      nullptr, nullptr, a);
  if (dim == 128)
    return launch_dkv_wgmma<128, true>(q, k, v, dout, lse, drow, dk, dv,
                                       nullptr, nullptr, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
}  // namespace dl4j

// q, k, v, o: [batch, seq, heads, dim] contiguous, all of `dtype`; dim <= 128.
// lse: [batch, heads, seq] float32, or null (the no-grad forward). The visit
// list: pair_i, pair_j (q tile, k tile of each visit); units [n_units, 3];
// merges [n_merges, 3]. part_acc [batch*heads, n_slots, 64, dim] and part_ml
// [batch*heads, n_slots, 2, 64], float32 scratch. `variant`: 1 launches the
// tensor-core unit kernel (bf16, dim 64 or 128, q/k/v 16-byte aligned; any
// other input is refused, never rerouted), 0 the CUDA-core one.
extern "C" int dl4j_flash_attention_stream_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* pair_i, const void* pair_j, const void* units, int n_units,
    const void* merges, int n_merges, void* part_acc, void* part_ml,
    int n_slots, int batch, int seq, int heads, int dim, int causal,
    float scale, int dtype, int variant, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || n_units <= 0) return 0;
  const Args a = make_args(pair_i, pair_j, units, n_units, merges, n_merges,
                           n_slots, batch, seq, heads, dim, causal, scale,
                           stream);
  if (variant == 1) {
    float *l = static_cast<float*>(lse), *pa = static_cast<float*>(part_acc),
          *pm = static_cast<float*>(part_ml);
    if (dtype != dl4j::kBFloat16)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dim == 64)
      return launch_fwd_wgmma<64, false>(q, k, v, o, l, pa, pm, a);
    if (dim == 128)
      return launch_fwd_wgmma<128, false>(q, k, v, o, l, pa, pm, a);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, dim,
                  Fwd{q, k, v, o, static_cast<float*>(lse),
                      static_cast<float*>(part_acc),
                      static_cast<float*>(part_ml), a});
}

// q, k, v, dout, dq as the forward's q; lse, drow: [batch, heads, seq]
// float32; the row-major visit list; part [batch*heads, n_slots, 64, dim]
// float32 scratch. `variant` as the forward's: 1 launches the tensor-core
// unit kernel (bf16, dim 64 or 128, q/k/v/dout 16-byte aligned; any other
// input is refused, never rerouted), 0 the CUDA-core one.
extern "C" int dl4j_flash_attention_stream_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* drow, void* dq, const void* pair_i,
    const void* pair_j, const void* units, int n_units, const void* merges,
    int n_merges, void* part, int n_slots, int batch, int seq, int heads,
    int dim, int causal, float scale, int dtype, int variant, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || n_units <= 0) return 0;
  const Args a = make_args(pair_i, pair_j, units, n_units, merges, n_merges,
                           n_slots, batch, seq, heads, dim, causal, scale,
                           stream);
  const float *l = static_cast<const float*>(lse),
              *dr = static_cast<const float*>(drow);
  float* pt = static_cast<float*>(part);
  if (variant == 1) {
    if (dtype != dl4j::kBFloat16)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dim == 64)
      return launch_dq_wgmma<64, false>(q, k, v, dout, l, dr, dq, pt, a);
    if (dim == 128)
      return launch_dq_wgmma<128, false>(q, k, v, dout, l, dr, dq, pt, a);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, dim, Dq{q, k, v, dout, l, dr, dq, pt, a});
}

// As the dq entry, over the column-major visit list; writes dk and dv, with
// part_dk, part_dv [batch*heads, n_slots, 64, dim] float32 scratch.
extern "C" int dl4j_flash_attention_stream_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* drow, void* dk, void* dv,
    const void* pair_i, const void* pair_j, const void* units, int n_units,
    const void* merges, int n_merges, void* part_dk, void* part_dv,
    int n_slots, int batch, int seq, int heads, int dim, int causal,
    float scale, int dtype, int variant, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || n_units <= 0) return 0;
  const Args a = make_args(pair_i, pair_j, units, n_units, merges, n_merges,
                           n_slots, batch, seq, heads, dim, causal, scale,
                           stream);
  const float *l = static_cast<const float*>(lse),
              *dr = static_cast<const float*>(drow);
  float *pk = static_cast<float*>(part_dk), *pv = static_cast<float*>(part_dv);
  if (variant == 1) {
    if (dtype != dl4j::kBFloat16)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dim == 64)
      return launch_dkv_wgmma<64, false>(q, k, v, dout, l, dr, dk, dv, pk, pv,
                                         a);
    if (dim == 128)
      return launch_dkv_wgmma<128, false>(q, k, v, dout, l, dr, dk, dv, pk,
                                          pv, a);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, dim, Dkv{q, k, v, dout, l, dr, dk, dv, pk, pv, a});
}
