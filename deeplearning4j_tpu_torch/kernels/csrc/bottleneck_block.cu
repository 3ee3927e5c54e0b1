// The ResNet bottleneck block: conv1x1 (stride s) -> BN + act -> conv3x3 SAME
// -> BN + act -> conv1x1 -> BN, plus the input or a conv1x1 (stride s) + BN
// shortcut, then act.
//
// Replaces the TPU kernels `_train_body` (batch statistics, emitted as f32
// side outputs) and `_infer_body` (running statistics, optional int8 weights
// with a per-output-channel scale) of deeplearning4j_tpu/kernels/
// bottleneck_block.py:229 and :261, reached through `bottleneck_forward`
// (:363). The Python wrapper (kernels/bottleneck_block.py) runs one block as a
// short sequence of the kernels below:
//
//   train, projecting: conv a, stats a, conv b, stats b, conv c, stats c,
//                      conv proj, stats proj, tail        (9 launches)
//   train, identity:   the same without the projection    (7 launches)
//   inference:         conv a, conv b, conv c, [conv proj], tail (5 or 4)
//
// The convolutions are this file's own implicit GEMMs: out[m, n] =
// sum_k A[m, k] * W[k, n] with m = (b, ho, wo), k = (dy, dx, ci) and W the
// HWIO kernel as it lies ([kh*kw*Cin, F], row-major). A 1x1 conv with stride
// s reads the rows x[:, ::s, ::s] (SAME with k = 1 pads nothing, :208-209); the
// 3x3 reads its nine taps with the zero padding as a bounds check. The
// previous branch's BatchNorm + act is applied to A as it is loaded
// (`pro_*`), so the normalized a and h are never stored: only the raw conv
// outputs are, in f32, as the TPU body keeps its intermediates f32
// (:180-183). Only y is stored at x's dtype. Each conv has two forms, picked
// by the wrapper (kernels/bottleneck_block.py `bottleneck_variant`) from the
// dtypes and widths alone, never as a fallback: a launch of either form that
// fails, or an operand it cannot take, is an error.
//
// Bound on the H100. Row 12 at I1's widest-M identity block (B=32, H=14,
// Cin=1024, F1=256) is 13.97 GFLOP: 0.0141 ms at the 989 TFLOP/s bf16
// tensor-core peak, over 0.031 ms to move its 104.8 MB once the f32
// intermediates count; T2's 16 blocks (B=32, 64x64 images) are 19.5 GFLOP
// for ~105 MB. Operations bound the block at full width, so its bf16 form
// multiplies on the tensor cores:
//
// - `conv_wgmma_kernel` (bf16 x and weights; Cin, F1 and F3 multiples of
//   64; every ResNet-50 block): one warpgroup owns 64 output rows and BN =
//   64 or 128 output channels, and K advances in chunks of 64 channels of
//   one tap (C % 64 == 0: a chunk never straddles two taps).
//   * B, the weights: a 2-D TMA tensor map over W [K, N] with the 128-byte
//     swizzle fills a ring of kStages 64-row tiles on mbarriers, read by
//     wgmma MN-major (the transpose bit), as the flash kernels read V.
//   * A, the activations, from registers: each thread loads the elements of
//     its m64nNk16 A fragment (2 rows x 16 channels a chunk) straight from
//     device memory (x in bf16 for convs a and proj; the raw f32 a or h for
//     convs b and c), applies the previous branch's BatchNorm + act in f32
//     (`norm4`'s expression with 1 / sqrt(var + eps) * gamma folded into
//     one scale per channel, in a shared-memory table), then zeroes the
//     SAME padding and the rows past M (after the prologue: act(BN(0)) is
//     not 0), rounds to bf16 (as the MXU rounds at default precision) and
//     packs. While the current chunk's four wgmma run, the next chunk is
//     converted into a second fragment set, and the chunk three on is
//     loaded (two raw sets in turn: a load has two steps to land). The
//     sets take turns and are never copied into each other (a move into a
//     register that an asynchronous product still reads corrupts it: seen
//     on the card as NaN once blocks share an SM).
//   * Epilogue: the raw f32 conv output, and in training the 64-row column
//     sums and sums of squares, reduced over the fragment's 8 lanes by
//     shuffles and over the 4 warps through shared memory in a fixed order.
//   * Parallelism at small M is accepted: T2's stages 3 and 4 (M = 512 and
//     128) give 8-32 blocks on 132 SMs. Split-K is later work.
// - `conv_gemm_kernel` (f32, int8 weights, other widths): the CUDA cores in
//   f32 (bf16 inputs widened at the load, as the TPU body's `_f32`), so its
//   ceiling is the 67 TFLOP/s f32 rate. Tiles: 64x64 outputs per block of
//   256 threads, each thread 4x4, K in steps of 16 through shared memory.
//
// Batch statistics (train) are single-pass in f32, mean(v) and mean(v^2) -
// mean^2 with no clamp (:223-226), reduced in two stages with no atomics:
// each conv block writes the column sums and sums of squares of its 64 rows
// into its own slot of a [row blocks, F] scratch, then `stats_kernel` sums
// the slots of each column in order. Repeated runs are bitwise equal.

#include <cstdint>
#include <cstdio>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hopper = dl4j::hopper;

constexpr int kBM = 64;       // output rows per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 16;       // K step through shared memory
constexpr int kThreads = 256;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void load4(const int8_t* p, float (&v)[4]) {
  const int r = *reinterpret_cast<const int*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = static_cast<float>(e[j]);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 r;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint2*>(p) = r;
}

// The TPU body's `_in_kernel_norm`: (v - mean) / sqrt(var + eps), then
// gamma * . + beta, then the activation; all f32.
__device__ __forceinline__ void norm4(float (&v)[4], const float* mean,
                                      const float* var, const float* gamma,
                                      const float* beta, float eps, int act) {
  float m[4], s[4], g[4], b[4];
  load4(mean, m);
  load4(var, s);
  load4(gamma, g);
  load4(beta, b);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = dl4j::activate(g[j] * ((v[j] - m[j]) / sqrtf(s[j] + eps)) + b[j],
                          act);
}

struct ConvParams {
  const void* in;  // NHWC [B, H, W, C]
  int B, H, W, C, Ho, Wo, ks, sh, sw, pad;
  // Prologue: the previous branch's BatchNorm + act on each loaded input
  // channel (f32 [C] vectors; pm == nullptr: none).
  const float* pm;
  const float* pv;
  const float* pg;
  const float* pb;
  int pact;
  float eps;
  const void* w;        // [K, N], K = ks * ks * C
  const float* wscale;  // [N] int8 dequant scale, or nullptr
  int N, M, K;
  float* out;   // [M, N]
  float* psum;  // [ceil(M / kBM), N] column sums per row block, or nullptr
  float* psq;   // the same for the squares
};

template <typename TIn, typename TW>
__global__ void __launch_bounds__(kThreads) conv_gemm_kernel(const ConvParams p) {
  __shared__ __align__(16) float As[kBK][kBM + 4];  // A transposed: [k][m]
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  __shared__ float red[2][kThreads / 16][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const TIn* in = static_cast<const TIn*>(p.in);
  const TW* w = static_cast<const TW*>(p.w);

  // The A row this thread loads (fixed over K) and its 4-channel group.
  const int a_row = tid / 4, a_k = (tid % 4) * 4;
  const int am = m0 + a_row;
  const bool a_ok = am < p.M;
  int ab = 0, aho = 0, awo = 0;
  if (a_ok) {
    awo = am % p.Wo;
    const int t = am / p.Wo;
    aho = t % p.Ho;
    ab = t / p.Ho;
  }
  // The B row and 4-column group this thread loads.
  const int b_k = tid / 16, b_n = (tid % 16) * 4;
  const int bn = n0 + b_n;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    float av[4] = {0.f, 0.f, 0.f, 0.f};
    const int k = k0 + a_k;
    if (a_ok && k < p.K) {
      // C % 4 == 0, so a 4-channel group never straddles two taps.
      const int tap = k / p.C, ci = k - tap * p.C;
      const int hi = aho * p.sh + tap / p.ks - p.pad;
      const int wi = awo * p.sw + tap % p.ks - p.pad;
      if (hi >= 0 && hi < p.H && wi >= 0 && wi < p.W) {
        load4(in + ((static_cast<size_t>(ab) * p.H + hi) * p.W + wi) * p.C + ci,
              av);
        if (p.pm != nullptr)
          norm4(av, p.pm + ci, p.pv + ci, p.pg + ci, p.pb + ci, p.eps, p.pact);
      }  // else: the SAME zero padding of the normalized activation
    }
    float bv[4] = {0.f, 0.f, 0.f, 0.f};
    const int kb = k0 + b_k;
    if (kb < p.K && bn < p.N) {
      load4(w + static_cast<size_t>(kb) * p.N + bn, bv);
      if (p.wscale != nullptr) {
        float s[4];
        load4(p.wscale + bn, s);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] *= s[j];
      }
    }
    __syncthreads();  // the previous step's tiles are read
#pragma unroll
    for (int j = 0; j < 4; ++j) As[a_k + j][a_row] = av[j];
    store4(&Bs[b_k][b_n], bv);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
      load4(&As[kk][ty * 4], a);
      load4(&Bs[kk][tx * 4], b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  const int n = n0 + tx * 4;
  float cs[4] = {0.f, 0.f, 0.f, 0.f}, cq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < p.M && n < p.N) {
      store4(p.out + static_cast<size_t>(m) * p.N + n, acc[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cs[j] += acc[i][j];
        cq[j] += acc[i][j] * acc[i][j];
      }
    }
  }
  if (p.psum != nullptr) {  // the same for every thread of the launch
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][ty][tx * 4 + j] = cs[j];
      red[1][ty][tx * 4 + j] = cq[j];
    }
    __syncthreads();
    if (tid < kBN && n0 + tid < p.N) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int t = 0; t < kThreads / 16; ++t) {  // in order: deterministic
        s += red[0][t][tid];
        q += red[1][t][tid];
      }
      const size_t slot = static_cast<size_t>(blockIdx.x) * p.N + n0 + tid;
      p.psum[slot] = s;
      p.psq[slot] = q;
    }
  }
}

// ------------------------------------------------ the tensor-core form

constexpr int kWgThreads = 128;            // one warpgroup
constexpr int kChunk = 64;                 // K per stage: 64 channels, one tap
constexpr int kBoxBytes = kChunk * 128;    // one TMA box: 64 K rows x 128 B
constexpr int kStages = 3;                 // the W ring

// Dynamic shared memory of `conv_wgmma_kernel<., BN>` at input width C:
// slack to align the ring to 1024 bytes (the swizzle atom), the ring, its
// barriers, the statistics' cross-warp sums [2][4][BN], and the prologue
// table [3][C] (mean, scale, beta; convs b and c only).
template <int BN>
constexpr int wg_smem(int c, bool pro) {
  return 1024 + kStages * kBoxBytes * (BN / 64) + 8 * kStages +
         2 * 4 * BN * 4 + (pro ? 3 * c * 4 : 0);
}

// W rows [k0, k0 + 64) x columns [n0, n0 + BN): BN / 64 boxes of 64 x 64.
template <int BN>
__device__ __forceinline__ void load_w(uint8_t* dst, const CUtensorMap* map,
                                       uint64_t* bar, int n0, int k0) {
#pragma unroll
  for (int c = 0; c < BN / 64; ++c)
    hopper::tma_load_2d(dst + c * kBoxBytes, map, bar, n0 + 64 * c, k0);
}

// A thread's A elements of one chunk, as loaded: rows r0 and r0 + 8 of the
// tile (r = 0, 1), channel pairs 8 j + 2 (lane % 4) + {0, 1} (j = 0..7),
// and whether each row's tap lies inside the image (and the row inside M).
// bf16 pairs stay packed (uint32_t); f32 pairs are float2.
template <typename TIn>
struct RawA {
  using Pair = typename std::conditional<std::is_same<TIn, float>::value,
                                         float2, uint32_t>::type;
  Pair v[2][8];
  bool ok[2];
};

struct RowA {
  const void* img;  // the row's image in `in`
  int hb, wb;       // its top-left input position (ho * sh - pad, ...)
  bool valid;       // m < M
};

template <typename TIn>
__device__ __forceinline__ void load_a(RawA<TIn>& raw, const RowA (&rows)[2],
                                       const ConvParams& p, int chunk,
                                       int q) {
  const int per_tap = p.C / kChunk;
  const int tap = chunk / per_tap;
  const int c0 = (chunk - tap * per_tap) * kChunk + 2 * q;
  const int dy = tap / p.ks, dx = tap - dy * p.ks;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hi = rows[r].hb + dy, wi = rows[r].wb + dx;
    raw.ok[r] = rows[r].valid && hi >= 0 && hi < p.H && wi >= 0 && wi < p.W;
    const TIn* src =
        static_cast<const TIn*>(rows[r].img) +
        (static_cast<size_t>(raw.ok[r] ? hi : 0) * p.W + (raw.ok[r] ? wi : 0)) *
            p.C +
        c0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (std::is_same<TIn, float>::value)
        raw.v[r][j] = raw.ok[r] ? *reinterpret_cast<const float2*>(src + 8 * j)
                                : make_float2(0.f, 0.f);
      else
        raw.v[r][j] = raw.ok[r] ? *reinterpret_cast<const uint32_t*>(src + 8 * j)
                                : 0u;
    }
  }
}

// The chunk as the four k16 A fragments (hopper.cuh's layout: fragment kk,
// register 2 h + r holds row r, channels 16 kk + 8 h + 2 q + {0, 1}, so
// pair j = 2 kk + h). bf16 x goes as it is (a zero stands for a tap outside
// the image); f32 a or h first takes the BatchNorm + act of the previous
// branch, then the padding and the rows past M are zeroed, then it is
// rounded to bf16. ACT is the activation's code (a template parameter: a
// switch on a runtime code, expanded for each of the 32 elements, made the
// loop too large for the instruction cache).
template <typename TIn, int ACT>
__device__ __forceinline__ void to_frags(const RawA<TIn>& raw,
                                         uint32_t (&pa)[4][4],
                                         const float* pro, const ConvParams& p,
                                         int chunk, int q) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (std::is_same<TIn, float>::value) {
        const int per_tap = p.C / kChunk;
        const int c = (chunk % per_tap) * kChunk + 8 * j + 2 * q;
        const float2 mu = *reinterpret_cast<const float2*>(pro + c);
        const float2 sc = *reinterpret_cast<const float2*>(pro + p.C + c);
        const float2 be = *reinterpret_cast<const float2*>(pro + 2 * p.C + c);
        const float2 v = raw.v[r][j];
        const float lo = dl4j::activate(fmaf(v.x - mu.x, sc.x, be.x), ACT);
        const float hi = dl4j::activate(fmaf(v.y - mu.y, sc.y, be.y), ACT);
        pa[j / 2][2 * (j % 2) + r] =
            raw.ok[r] ? hopper::pack_bf16(lo, hi) : 0u;
      } else {
        pa[j / 2][2 * (j % 2) + r] = raw.v[r][j];
      }
    }
}

// acc += A B for one chunk: A the four register fragments, B the stage's
// 64 x BN W tile read MN-major (LBO one box between 64-wide column blocks,
// SBO 1024, a k16 step 16 rows = 2048 bytes on).
template <int BN>
__device__ __forceinline__ void wg_chunk(float (&acc)[BN / 2],
                                         const uint32_t (&pa)[4][4],
                                         const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc =
        hopper::sw128_desc(b + kk * 16 * 128, kBoxBytes, 1024);
    if constexpr (BN == 64)
      hopper::wgmma_m64n64k16_rs_tb(acc, pa[kk], desc);
    else
      hopper::wgmma_m64n128k16_rs_tb(acc, pa[kk], desc);
  }
}

// One convolution on the tensor cores. TIn = bf16: x, no prologue (convs a
// and proj); TIn = float: the raw a or h with the prologue (convs b and c)
// and its activation ACT. Block i: column tile i % (N / BN), row tile
// i / (N / BN), so the column tiles of one row tile run side by side and
// share its A in the L2.
template <typename TIn, int BN, int ACT>
__global__ void __launch_bounds__(kWgThreads)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tw, const ConvParams p) {
  constexpr bool kPro = std::is_same<TIn, float>::value;
  constexpr int SB = kBoxBytes * (BN / 64);  // one stage of the ring
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * SB);
  float* red = reinterpret_cast<float*>(full + kStages);  // [2][4][BN]
  float* pro = red + 2 * 4 * BN;                          // [3][C]

  const int tid = threadIdx.x;
  const int n_tiles = p.N / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int mt = blockIdx.x / n_tiles, m0 = mt * 64;
  const int chunks = p.K / kChunk;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) hopper::mbar_init(full + i, 1);
    hopper::mbar_init_fence();
  }
  if constexpr (kPro) {
    for (int c = tid; c < p.C; c += kWgThreads) {
      pro[c] = p.pm[c];
      pro[p.C + c] = p.pg[c] / sqrtf(p.pv[c] + p.eps);
      pro[2 * p.C + c] = p.pb[c];
    }
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < kStages && i < chunks; ++i) {
      hopper::mbar_expect_tx(full + i, SB);
      load_w<BN>(ring + i * SB, &tw, full + i, n0, i * kChunk);
    }
  }

  // This thread's rows of the tile (the accumulator layout in hopper.cuh):
  // r0 = 16 w + l / 4 and r0 + 8; its columns 8 j + 2 q + {0, 1}.
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  RowA rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + 16 * warp + lane / 4 + 8 * r;
    rows[r].valid = m < p.M;
    const int mm = rows[r].valid ? m : 0;
    const int wo = mm % p.Wo, t = mm / p.Wo;
    const int ho = t % p.Ho, b = t / p.Ho;
    rows[r].hb = ho * p.sh - p.pad;
    rows[r].wb = wo * p.sw - p.pad;
    rows[r].img = static_cast<const TIn*>(p.in) +
                  static_cast<size_t>(b) * p.H * p.W * p.C;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // Two fragment sets in turn, never copied into each other: a register
  // that a product still reads is never the target of a move. Two raw sets
  // in turn as well, so a chunk's loads are issued two steps before its
  // conversion: ra holds the odd chunks, rb the even ones from chunk 2.
  RawA<TIn> ra, rb;
  uint32_t fa[4][4], fb[4][4];
  load_a(ra, rows, p, 0, q);
  to_frags<TIn, ACT>(ra, fa, pro, p, 0, q);
  if (chunks > 1) load_a(ra, rows, p, 1, q);
  if (chunks > 2) load_a(rb, rows, p, 2, q);

  // Chunk i: its products from `cur`; under them, chunk i + 1 from `raw`
  // to `next` and chunk i + 3 loaded into `raw`; then stage i % kStages
  // refilled.
  auto step = [&](int i, uint32_t(&cur)[4][4], uint32_t(&next)[4][4],
                  RawA<TIn>& raw) {
    const int st = i % kStages;
    hopper::mbar_wait(full + st, (i / kStages) & 1);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    wg_chunk<BN>(acc, cur, ring + st * SB);
    hopper::wgmma_commit();
    if (i + 1 < chunks) {
      to_frags<TIn, ACT>(raw, next, pro, p, i + 1, q);
      if (i + 3 < chunks) load_a(raw, rows, p, i + 3, q);
    }
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::fence_frags(cur);
    __syncthreads();  // every thread is done with stage st
    if (tid == 0 && i + kStages < chunks) {
      hopper::mbar_expect_tx(full + st, SB);
      load_w<BN>(ring + st * SB, &tw, full + st, n0, (i + kStages) * kChunk);
    }
  };
  for (int i = 0; i < chunks; i += 2) {
    step(i, fa, fb, ra);
    if (i + 1 < chunks) step(i + 1, fb, fa, rb);
  }

  // The raw conv output, f32: acc[4 j + 2 r + c] is row r0 + 8 r, column
  // n0 + 8 j + 2 q + c.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rows[r].valid) continue;
    float* orow = p.out +
                  static_cast<size_t>(m0 + 16 * warp + lane / 4 + 8 * r) * p.N +
                  n0 + 2 * q;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
  if (p.psum == nullptr) return;  // the same for every thread of the launch
  // Column sums of the tile's rows inside M: the thread's two rows, then
  // the 8 lanes that share q (shuffles), then the 4 warps (shared memory),
  // each in a fixed order.
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s = 0.f, sq = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r].valid) {
          const float v = acc[4 * j + 2 * r + c];
          s += v;
          sq += v * v;
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      }
      if (lane < 4) {
        red[warp * BN + 8 * j + 2 * q + c] = s;
        red[(4 + warp) * BN + 8 * j + 2 * q + c] = sq;
      }
    }
  __syncthreads();
  for (int col = tid; col < BN; col += kWgThreads) {
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s += red[w * BN + col];
      sq += red[(4 + w) * BN + col];
    }
    const size_t slot = static_cast<size_t>(mt) * p.N + n0 + col;
    p.psum[slot] = s;
    p.psq[slot] = sq;
  }
}

// Second stage of the batch statistics: one thread per channel sums its
// row-block slots in order; mean = sum / M, var = sumsq / M - mean^2.
__global__ void stats_kernel(const float* __restrict__ psum,
                             const float* __restrict__ psq, int rblocks,
                             int n_ch, int rows, float* __restrict__ mean,
                             float* __restrict__ var) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_ch) return;
  float s = 0.f, q = 0.f;
  for (int r = 0; r < rblocks; ++r) {
    s += psum[static_cast<size_t>(r) * n_ch + n];
    q += psq[static_cast<size_t>(r) * n_ch + n];
  }
  const float mu = s / static_cast<float>(rows);
  mean[n] = mu;
  var[n] = q / static_cast<float>(rows) - mu * mu;
}

struct TailParams {
  const float* c;  // [M, N] raw conv c
  const float* mc;
  const float* vc;
  const float* gc;
  const float* bc;
  const float* p;  // [M, N] raw projection conv, or nullptr: x is the shortcut
  const float* mp;
  const float* vp;
  const float* gp;
  const float* bp;
  const void* x;  // [M, N] at TX (identity shortcut)
  void* y;        // [M, N] at TX
  size_t n_vec;   // M * N / 4
  int N;
  float eps;
  int act;
};

// y = act(BN_c(c) + shortcut), shortcut = x or BN_proj(p); BN without act.
template <typename TX>
__global__ void __launch_bounds__(kThreads) tail_kernel(const TailParams t) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < t.n_vec; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t e = i * 4;
    const int n = static_cast<int>(e % t.N);
    float c[4], s[4];
    load4(t.c + e, c);
    norm4(c, t.mc + n, t.vc + n, t.gc + n, t.bc + n, t.eps, dl4j::kIdentity);
    if (t.p != nullptr) {
      load4(t.p + e, s);
      norm4(s, t.mp + n, t.vp + n, t.gp + n, t.bp + n, t.eps, dl4j::kIdentity);
    } else {
      load4(static_cast<const TX*>(t.x) + e, s);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = dl4j::activate(c[j] + s[j], t.act);
    store4(static_cast<TX*>(t.y) + e, c);
  }
}

template <typename TIn, typename TW>
int run_conv(const ConvParams& p, cudaStream_t stream) {
  const dim3 grid((p.M + kBM - 1) / kBM, (p.N + kBN - 1) / kBN);
  conv_gemm_kernel<TIn, TW><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int run_conv_w(const ConvParams& p, int w_dtype, cudaStream_t stream) {
  if (w_dtype == dl4j::kFloat32) return run_conv<TIn, float>(p, stream);
  if (w_dtype == dl4j::kBFloat16) return run_conv<TIn, __nv_bfloat16>(p, stream);
  if (w_dtype == dl4j::kInt8) return run_conv<TIn, int8_t>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A 2-D map over W [K, N] bf16 (row pitch N * 2 bytes): boxes of 64
// columns (128 bytes) x 64 rows, 128-byte swizzle.
int w_map(CUtensorMap* map, const ConvParams& p) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.N),
                              static_cast<cuuint64_t>(p.K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.N) * 2};
  const cuuint32_t box[2] = {64, kChunk};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p.w), dims,
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

template <typename TIn, int BN, int ACT = dl4j::kIdentity>
int run_conv_wgmma(const ConvParams& p, int m_tiles, cudaStream_t stream) {
  CUtensorMap tw;
  if (const int e = w_map(&tw, p)) return e;
  const int smem = wg_smem<BN>(p.C, std::is_same<TIn, float>::value);
  auto kernel = conv_wgmma_kernel<TIn, BN, ACT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<m_tiles * (p.N / BN), kWgThreads, smem, stream>>>(tw, p);
  return static_cast<int>(cudaGetLastError());
}

// Convs b and c: the prologue's activation as a template argument.
template <int BN>
int run_conv_wgmma_pro(const ConvParams& p, int m_tiles,
                       cudaStream_t stream) {
  switch (p.pact) {
    case dl4j::kIdentity:
      return run_conv_wgmma<float, BN, dl4j::kIdentity>(p, m_tiles, stream);
    case dl4j::kRelu:
      return run_conv_wgmma<float, BN, dl4j::kRelu>(p, m_tiles, stream);
    case dl4j::kTanh:
      return run_conv_wgmma<float, BN, dl4j::kTanh>(p, m_tiles, stream);
    case dl4j::kSigmoid:
      return run_conv_wgmma<float, BN, dl4j::kSigmoid>(p, m_tiles, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The tensor-core form takes bf16 x without a prologue (convs a, proj) or
// the raw f32 conv output with one (convs b, c), bf16 weights, C and N
// multiples of 64 and 16-byte-aligned operands; anything else is refused.
// N tiles of 128 (half the re-reads of A) where that still gives a block
// to every SM, else of 64.
int run_wgmma(const ConvParams& p, int in_dtype, int w_dtype,
              cudaStream_t stream) {
  const bool pro = p.pm != nullptr;
  if (w_dtype != dl4j::kBFloat16 || p.wscale != nullptr || p.C % kChunk ||
      p.N % 64 || (pro ? in_dtype != dl4j::kFloat32
                       : in_dtype != dl4j::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {p.in, p.w, p.out, p.psum, p.psq,
                        p.pm, p.pv, p.pg, p.pb};
  for (const void* ptr : ptrs)
    if (!aligned16(ptr)) return static_cast<int>(cudaErrorMisalignedAddress);
  int dev = 0, sms = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  if (const cudaError_t e = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev))
    return static_cast<int>(e);
  const int m_tiles = (p.M + 63) / 64;
  const bool wide = p.N % 128 == 0 && m_tiles * (p.N / 128) >= sms;
  if (pro)
    return wide ? run_conv_wgmma_pro<128>(p, m_tiles, stream)
                : run_conv_wgmma_pro<64>(p, m_tiles, stream);
  return wide ? run_conv_wgmma<__nv_bfloat16, 128>(p, m_tiles, stream)
              : run_conv_wgmma<__nv_bfloat16, 64>(p, m_tiles, stream);
}

}  // namespace

// One implicit-GEMM convolution of the block (see the header). `in`: NHWC
// [B, H, W, C] of `in_dtype` (f32 or bf16); `w`: [ks*ks*C, N] of `w_dtype`
// (f32, bf16, or int8 with `wscale` [N] f32); `out`: [B*Ho*Wo, N] f32;
// pro_*: f32 [C] or all null; psum/psq: f32 [ceil(M/64), N] or null. C and N
// multiples of 4, every pointer 16-byte aligned (checked by the wrapper).
// `variant` 1: the tensor-core form (`run_wgmma` says what it takes); 0: the
// CUDA-core form; anything else is refused.
extern "C" int dl4j_bottleneck_conv(
    const void* in, int in_dtype, int B, int H, int W, int C, int Ho, int Wo,
    int ks, int sh, int sw, int pad, const void* pro_mean, const void* pro_var,
    const void* pro_gamma, const void* pro_beta, int pro_act, float eps,
    const void* w, int w_dtype, const void* wscale, int N, void* out,
    void* psum, void* psq, int variant, void* stream) {
  ConvParams p;
  p.in = in;
  p.B = B; p.H = H; p.W = W; p.C = C; p.Ho = Ho; p.Wo = Wo;
  p.ks = ks; p.sh = sh; p.sw = sw; p.pad = pad;
  p.pm = static_cast<const float*>(pro_mean);
  p.pv = static_cast<const float*>(pro_var);
  p.pg = static_cast<const float*>(pro_gamma);
  p.pb = static_cast<const float*>(pro_beta);
  p.pact = pro_act;
  p.eps = eps;
  p.w = w;
  p.wscale = static_cast<const float*>(wscale);
  p.N = N;
  p.M = B * Ho * Wo;
  p.K = ks * ks * C;
  p.out = static_cast<float*>(out);
  p.psum = static_cast<float*>(psum);
  p.psq = static_cast<float*>(psq);
  if (p.M <= 0 || N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) return run_wgmma(p, in_dtype, w_dtype, s);
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == dl4j::kFloat32) return run_conv_w<float>(p, w_dtype, s);
  if (in_dtype == dl4j::kBFloat16)
    return run_conv_w<__nv_bfloat16>(p, w_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// psum, psq: f32 [rblocks, n_ch] from dl4j_bottleneck_conv; mean, var: f32
// [n_ch].
extern "C" int dl4j_bottleneck_stats(const void* psum, const void* psq,
                                     int rblocks, int n_ch, int rows,
                                     void* mean, void* var, void* stream) {
  if (n_ch <= 0) return 0;
  stats_kernel<<<(n_ch + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq), rblocks,
      n_ch, rows, static_cast<float*>(mean), static_cast<float*>(var));
  return static_cast<int>(cudaGetLastError());
}

// c, p: f32 [M, N] (p null: the identity shortcut x, [M, N] of x_dtype); the
// eight BatchNorm vectors f32 [N]; y: [M, N] of x_dtype. N a multiple of 4.
extern "C" int dl4j_bottleneck_tail(
    const void* c, const void* mc, const void* vc, const void* gc,
    const void* bc, const void* p, const void* mp, const void* vp,
    const void* gp, const void* bp, const void* x, int x_dtype, int M, int N,
    float eps, int act, void* y, void* stream) {
  TailParams t;
  t.c = static_cast<const float*>(c);
  t.mc = static_cast<const float*>(mc);
  t.vc = static_cast<const float*>(vc);
  t.gc = static_cast<const float*>(gc);
  t.bc = static_cast<const float*>(bc);
  t.p = static_cast<const float*>(p);
  t.mp = static_cast<const float*>(mp);
  t.vp = static_cast<const float*>(vp);
  t.gp = static_cast<const float*>(gp);
  t.bp = static_cast<const float*>(bp);
  t.x = x;
  t.y = y;
  t.n_vec = static_cast<size_t>(M) * N / 4;
  t.N = N;
  t.eps = eps;
  t.act = act;
  if (t.n_vec == 0) return 0;
  const size_t want = (t.n_vec + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == dl4j::kFloat32)
    tail_kernel<float><<<grid, kThreads, 0, s>>>(t);
  else if (x_dtype == dl4j::kBFloat16)
    tail_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(t);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
