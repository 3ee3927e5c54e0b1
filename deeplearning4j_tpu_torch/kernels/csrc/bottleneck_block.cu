// The ResNet bottleneck block: conv1x1 (stride s) -> BN + act -> conv3x3 SAME
// -> BN + act -> conv1x1 -> BN, plus the input or a conv1x1 (stride s) + BN
// shortcut, then act.
//
// Replaces the TPU kernels `_train_body` (batch statistics, emitted as f32
// side outputs) and `_infer_body` (running statistics, optional int8 weights
// with a per-output-channel scale) of deeplearning4j_tpu/kernels/
// bottleneck_block.py:229 and :261, reached through `bottleneck_forward`
// (:363). The Python wrapper (kernels/bottleneck_block.py) runs one block as a
// short sequence of the three kernels below:
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
// (:180-183). Only y is stored at x's dtype.
//
// Bound on the H100. T2's 16 blocks (B=32, 64x64 images) are 19.5 GFLOP
// forward for ~105 MB of input, weights and output in bf16: operations bound
// by the tensor-core peak (~0.02 ms), and bytes bound (~0.03 ms) once the f32
// intermediates count. This first kernel multiplies on the CUDA cores in f32
// (bf16 inputs are widened at the load, as the TPU body's `_f32`), so its
// real ceiling is the 67 TFLOP/s f32 rate. Tiles: 64x64 outputs per block of
// 256 threads, each thread 4x4, K in steps of 16 through shared memory. A
// tensor-core version (mma/wgmma on bf16 tiles) is later work.
//
// Batch statistics (train) are single-pass in f32, mean(v) and mean(v^2) -
// mean^2 with no clamp (:223-226), reduced in two stages with no atomics:
// each conv block writes the column sums and sums of squares of its 64 rows
// into its own slot of a [row blocks, F] scratch, then `stats_kernel` sums
// the slots of each column in order. Repeated runs are bitwise equal.

#include <cstdint>

#include "common.cuh"

namespace {

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

}  // namespace

// One implicit-GEMM convolution of the block (see the header). `in`: NHWC
// [B, H, W, C] of `in_dtype` (f32 or bf16); `w`: [ks*ks*C, N] of `w_dtype`
// (f32, bf16, or int8 with `wscale` [N] f32); `out`: [B*Ho*Wo, N] f32;
// pro_*: f32 [C] or all null; psum/psq: f32 [ceil(M/64), N] or null. C and N
// multiples of 4, every pointer 16-byte aligned (checked by the wrapper).
extern "C" int dl4j_bottleneck_conv(
    const void* in, int in_dtype, int B, int H, int W, int C, int Ho, int Wo,
    int ks, int sh, int sw, int pad, const void* pro_mean, const void* pro_var,
    const void* pro_gamma, const void* pro_beta, int pro_act, float eps,
    const void* w, int w_dtype, const void* wscale, int N, void* out,
    void* psum, void* psq, void* stream) {
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
