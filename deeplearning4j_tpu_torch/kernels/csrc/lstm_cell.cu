// One LSTM time step: the recurrent product h_prev @ RW, the four gates, the
// Graves peepholes, the cell update and the optional step mask, in one launch.
//
// Replaces the TPU kernel `_cell_kernel` (deeplearning4j_tpu/kernels/
// lstm_cell.py:119, built by `_pallas_call` :168 and reached through
// `pallas_cell` :182 from `resolve_cell` :199, once per time step of
// `nn/layers/recurrent.py::_lstm_scan`). What it computes, per row r and
// hidden unit j, gate order i, f, o, g (columns j, n+j, 2n+j, 3n+j of RW):
//
//   z   = xw_t + h_prev @ RW                 (f32 accumulation)
//   zi += c_prev * p_i ; zf += c_prev * p_f  (peephole variants)
//   c   = gate(zf) * c_prev + gate(zi) * act(zg)
//   zo += c * p_o                            (the new c: Graves)
//   h   = gate(zo) * act(c)
//   masked: h = m h + (1-m) h_prev ; c = m c + (1-m) c_prev ; out = m h
//
// `gate` and `act` are any of the 16 elementwise activations of
// nn/activations.py (`cell_act` below, the formulas of its registry; the
// TPU kernel takes sigmoid gates and four cell activations and sends the
// rest to XLA). Softmax reduces across the hidden units, which this kernel
// spreads over its blocks; a softmax cell takes two launches: this kernel
// in its "z out" form, which stops after the product and the input-side
// peepholes (zi += c_prev p_i, zf += c_prev p_f) and writes z to a
// workspace [b, 4n] (f32; f64 for the f64 form), then `lstm_rows_kernel`
// below, one block a row, which does the gate math with each softmax
// reduced over its gate's n units in shared memory, in the order the
// peepholes force: i, f and g, then c, then o (zo += c p_o), then act(c).
// A cell whose activation is the user's callable runs the "z out" form and
// its gate math as torch ops (kernels/lstm_cell.py).
//
// The f64 form (T = double) is the same kernel with every sum, product and
// activation in double (`cell_act(double)`, fma), a chunk of kKC = 64 of
// the recurrent dimension (two stages of 20.5 KB in static shared memory)
// and 16-byte loads of two doubles: the gradient checks run it.
//
// h, c and out are written in the operand dtype (f32, bf16 or f16), so under
// a bf16 or f16 policy the carried c is rounded to it every step, as the TPU
// body's `co[...] = c.astype(co.dtype)` does; z never goes to device memory.
// Without a mask out is h, and the wrapper returns h for it (as the plain
// version does): only a masked step writes out.
//
// Bound on the H100: bytes. At the char-RNN's training shape (b=32, n=256,
// f32) one step reads RW (1 MiB), xw_t, h_prev, c_prev and pW and writes h,
// c and out: ~1.34 MB, 0.4 us at 3.35 TB/s, against 2*b*n*4n = 16.8 MFLOP
// (0.25 us at the f32 rate). A step is that small, so what it costs is
// latency: how soon every SM has its share of RW in flight, and how little
// waits after it lands.
//
// Design: a block owns kUnits (2) hidden units with all four gates of each,
// so the gate math stays in the block, and up to kRows (32) batch rows (more
// rows, more row tiles in grid.y): at n = 256 that is 128 blocks, each
// reading its RW slice (n x 8 columns, 8 KB f32) once, so RW is read once
// in all. The block stages its RW slice and h_prev's rows through shared
// memory in chunks of kKC (128) of the recurrent dimension, two chunks in
// flight as cp.async copies issued before any math (at n <= 256 every load
// of the block is issued at once; a row that is no multiple of 16 bytes, or
// an operand at an address that is not, is copied element by element). The
// recurrent dimension of each chunk is split across the block's 8 warps; a
// lane holds one RW column (of the 8) for 8 rows, reading 4 values of h at
// a time (h rows padded by 16 bytes, so the 4 rows a load touches fall in
// other banks). The 8 warps' partial sums are added through shared memory
// in warp order, so the result is bitwise repeatable, and one thread per
// (row, unit) runs the gate math in registers on operands it loaded before
// the product. f32 FMAs on the CUDA cores (no TF32); every bounds check is
// explicit, so any n and any b (b = 1 when sampling) are taken.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kUnits = 2;              // hidden units a block
constexpr int kCols = 4 * kUnits;      // RW columns a block: gate g, unit u at g * kUnits + u
constexpr int kRows = 32;              // batch rows a block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerLane = kRows / 4;  // lane rows rq, rq + 4, ...
constexpr int kSoftmax = 16;           // `lstm_rows_kernel`'s code past the 16

// The accumulation type and the recurrent-dimension chunk a stage: f32 and
// 128 for f32, bf16 and f16; f64 and 64 for the f64 form.
template <typename T>
struct Form {
  using A = float;
  static constexpr int kKC = 128;
};
template <>
struct Form<double> {
  using A = double;
  static constexpr int kKC = 64;
};

template <typename T>
__device__ __forceinline__ float to_acc(T x) { return dl4j::to_f32(x); }
__device__ __forceinline__ double to_acc(double x) { return x; }

template <typename T>
struct Store {
  static __device__ __forceinline__ T of(float x) { return dl4j::from_f32<T>(x); }
};
template <>
struct Store<double> {
  static __device__ __forceinline__ double of(double x) { return x; }
};

__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_acc(double a, double b, double c) {
  return fma(a, b, c);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ double sigmoid(double v) {
  return 1.0 / (1.0 + exp(-v));
}

// The elementwise activations by code (kernels/lstm_cell.py `ACT_CODES`),
// each the formula of nn/activations.py's registry: leakyrelu's slope 0.01,
// elu's alpha 1, softplus linear past 20 (torch's threshold), ND4J's
// rationaltanh, hardsigmoid clamp(0.2 x + 0.5, 0, 1), selu's constants and
// gelu's tanh approximation.
__device__ __forceinline__ float cell_act(float v, int code) {
  switch (code) {
    case 1: return fmaxf(v, 0.f);                            // relu
    case 2: return tanhf(v);                                 // tanh
    case 3: return sigmoid(v);                               // sigmoid
    case 4: return v > 0.f ? v : 0.01f * v;                  // leakyrelu
    case 5: return v > 0.f ? v : expm1f(v);                  // elu
    case 6: return v * v * v;                                // cube
    case 7: return v > 20.f ? v : log1pf(expf(v));           // softplus
    case 8: return v / (1.f + fabsf(v));                     // softsign
    case 9: {                                                // rationaltanh
      const float y = 2.f * v / 3.f, a = fabsf(y), y2 = y * y;
      const float r = 1.f - 1.f / (1.f + a + y2 + 1.41645f * (y2 * y2));
      return 1.7159f * copysignf(r, y);
    }
    case 10: return fmaxf(tanhf(v), 0.f);                    // rectifiedtanh
    case 11: return fminf(fmaxf(0.2f * v + 0.5f, 0.f), 1.f);  // hardsigmoid
    case 12: return fminf(fmaxf(v, -1.f), 1.f);              // hardtanh
    case 13:                                                 // selu
      return 1.0507009873554805f *
             (v > 0.f ? v : 1.6732632423543772f * expm1f(v));
    case 14: {                                               // gelu (tanh)
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
    }
    case 15: return v * sigmoid(v);                          // swish
    default: return v;                                       // identity
  }
}

// The same activations in double (the f64 form).
__device__ __forceinline__ double cell_act(double v, int code) {
  switch (code) {
    case 1: return fmax(v, 0.0);                                  // relu
    case 2: return tanh(v);                                       // tanh
    case 3: return sigmoid(v);                                    // sigmoid
    case 4: return v > 0.0 ? v : 0.01 * v;                        // leakyrelu
    case 5: return v > 0.0 ? v : expm1(v);                        // elu
    case 6: return v * v * v;                                     // cube
    case 7: return v > 20.0 ? v : log1p(exp(v));                  // softplus
    case 8: return v / (1.0 + fabs(v));                           // softsign
    case 9: {                                                     // rationaltanh
      const double y = 2.0 * v / 3.0, a = fabs(y), y2 = y * y;
      const double r = 1.0 - 1.0 / (1.0 + a + y2 + 1.41645 * (y2 * y2));
      return 1.7159 * copysign(r, y);
    }
    case 10: return fmax(tanh(v), 0.0);                           // rectifiedtanh
    case 11: return fmin(fmax(0.2 * v + 0.5, 0.0), 1.0);          // hardsigmoid
    case 12: return fmin(fmax(v, -1.0), 1.0);                     // hardtanh
    case 13:                                                      // selu
      return 1.0507009873554805 *
             (v > 0.0 ? v : 1.6732632423543772 * expm1(v));
    case 14: {                                                    // gelu (tanh)
      const double k = 0.7978845608028654;  // sqrt(2 / pi)
      return 0.5 * v * (1.0 + tanh(k * (v + 0.044715 * v * v * v)));
    }
    case 15: return v * sigmoid(v);                               // swish
    default: return v;                                            // identity
  }
}

// Four consecutive values of a shared-memory row as floats (as doubles for
// the f64 form).
__device__ __forceinline__ void load4(const double* p, double (&f)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load4(const __half* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __half2* h2 = reinterpret_cast<const __half2*>(&v);
  const float2 a = __half22float2(h2[0]), b = __half22float2(h2[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

template <typename T>
struct Stage {
  static constexpr int kKC = Form<T>::kKC;
  static constexpr int kPad = 16 / sizeof(T);  // a 16-byte pad a row
  static constexpr int kHS = kKC + kPad;       // h row stride, elements
  T h[kRows][kHS];
  T w[kKC][kCols];
};

// ZOUT: the "z out" form (no mask then): `out` is the [b, 4n] workspace of
// A, and h_out and c_out are not written.
template <typename T, bool PEEP, bool MASKED, bool ZOUT>
__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const T* __restrict__ xw, long long xw_stride,
                 const T* __restrict__ h_prev, const T* __restrict__ c_prev,
                 const T* __restrict__ rw, const T* __restrict__ pw,
                 const T* __restrict__ mask, T* __restrict__ h_out,
                 T* __restrict__ c_out, T* __restrict__ out, int b, int n,
                 int act, int gate, int vec) {
  using A = typename Form<T>::A;
  constexpr int kKC = Form<T>::kKC;    // recurrent-dimension chunk a stage
  constexpr int kKW = kKC / kWarps;    // of it, a warp's share
  constexpr int kChunk = 16 / sizeof(T);  // h elements in 16 bytes
  __shared__ __align__(16) unsigned char raw[2 * sizeof(Stage<T>)];
  Stage<T>* stage = reinterpret_cast<Stage<T>*>(raw);
  static_assert(2 * sizeof(Stage<T>) >= kWarps * kRows * kCols * sizeof(A),
                "the warps' partial sums reuse the stages");

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kUnits, r0 = blockIdx.y * kRows;
  const int rows = min(kRows, b - r0);
  const size_t ld = 4 * static_cast<size_t>(n);  // RW's row length

  auto load = [&](int s, int k0) {
    Stage<T>& st = stage[s];
    // h_prev rows [r0, r0 + rows), columns [k0, k0 + kKC).
    constexpr int kPieces = kKC / kChunk;
    for (int e = tid; e < rows * kPieces; e += kThreads) {
      const int r = e / kPieces, k = (e % kPieces) * kChunk;
      const T* src = h_prev + static_cast<size_t>(r0 + r) * n + k0 + k;
      if (vec) {
        dl4j::cp_async<16>(&st.h[r][k], k0 + k < n ? src : h_prev,
                           k0 + k < n ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          st.h[r][k + i] = k0 + k + i < n ? src[i] : Store<T>::of(0.f);
      }
    }
    // RW rows [k0, k0 + kKC), the block's kUnits columns of each gate.
    for (int e = tid; e < kKC * 4; e += kThreads) {
      const int k = e / 4, g = e % 4;
      const T* src = rw + static_cast<size_t>(k0 + k) * ld +
                     static_cast<size_t>(g) * n + j0;
      T* dst = &st.w[k][g * kUnits];
      if (vec) {
        dl4j::cp_async<kUnits * sizeof(T)>(dst, k0 + k < n ? src : rw,
                                           k0 + k < n ? kUnits * sizeof(T)
                                                      : 0);
      } else {
#pragma unroll
        for (int u = 0; u < kUnits; ++u)
          dst[u] = k0 + k < n && j0 + u < n ? src[u]
                                            : Store<T>::of(0.f);
      }
    }
    dl4j::cp_async_commit();
  };
  const int n_chunks = (n + kKC - 1) / kKC;
  load(0, 0);
  if (n_chunks > 1)
    load(1, kKC);
  else
    dl4j::cp_async_commit();

  // The gate math's own operands, loaded while the product runs: one
  // thread per (row, unit).
  const int er = tid / kUnits, eu = tid % kUnits, j = j0 + eu;
  const bool epi = er < rows && j < n;
  A xg[4] = {A(0), A(0), A(0), A(0)}, cp = A(0), hp = A(0), mk = A(1);
  A pi = A(0), pf = A(0), po = A(0);
  if (epi) {
    const T* x = xw + static_cast<size_t>(r0 + er) * xw_stride;
#pragma unroll
    for (int g = 0; g < 4; ++g) xg[g] = to_acc(x[g * n + j]);
    const size_t at = static_cast<size_t>(r0 + er) * n + j;
    cp = to_acc(c_prev[at]);
    if (PEEP) {
      pi = to_acc(pw[j]);
      pf = to_acc(pw[n + j]);
      po = to_acc(pw[2 * n + j]);
    }
    if (MASKED) {
      mk = to_acc(mask[r0 + er]);
      hp = to_acc(h_prev[at]);
    }
  }

  const int w = tid / 32, lane = tid % 32;
  const int c = lane % kCols, rq = lane / kCols;
  const int nri = (rows - rq + 3) / 4;  // this lane's rows below `rows`
  A acc[kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) acc[i] = A(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    dl4j::cp_async_wait<1>();
    __syncthreads();
    const Stage<T>& st = stage[ch & 1];
#pragma unroll
    for (int k4 = 0; k4 < kKW; k4 += 4) {
      const int kk = w * kKW + k4;
      A wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q] = to_acc(st.w[kk + q][c]);
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        if (i < nri) {
          A hv[4];
          load4(&st.h[rq + 4 * i][kk], hv);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i] = fma_acc(hv[q], wv[q], acc[i]);
        }
      }
    }
    __syncthreads();  // this stage is free again
    if (ch + 2 < n_chunks)
      load(ch & 1, (ch + 2) * kKC);
    else
      dl4j::cp_async_commit();
  }
  dl4j::cp_async_wait<0>();
  __syncthreads();

  // The warps' partial sums [warp][row][column], added in warp order.
  A* red = reinterpret_cast<A*>(raw);
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i)
    if (i < nri) red[(w * kRows + rq + 4 * i) * kCols + c] = acc[i];
  __syncthreads();
  if (!epi) return;
  A z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    A s = A(0);
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww)
      s += red[(ww * kRows + er) * kCols + g * kUnits + eu];
    z[g] = xg[g] + s;
  }
  A zi = z[0], zf = z[1], zo = z[2];
  const A zg = z[3];
  if (PEEP) {
    zi += cp * pi;
    zf += cp * pf;
  }
  if constexpr (ZOUT) {
    A* ws = reinterpret_cast<A*>(out) + static_cast<size_t>(r0 + er) * 4 * n;
    ws[j] = zi;
    ws[n + j] = zf;
    ws[2 * n + j] = zo;
    ws[3 * n + j] = zg;
    return;
  }
  const A i = cell_act(zi, gate), f = cell_act(zf, gate);
  const A g = cell_act(zg, act);
  A cn = f * cp + i * g;
  if (PEEP) zo += cn * po;
  A h = cell_act(zo, gate) * cell_act(cn, act);
  const size_t at = static_cast<size_t>(r0 + er) * n + j;
  if (MASKED) {
    h = mk * h + (A(1) - mk) * hp;
    cn = mk * cn + (A(1) - mk) * cp;
    out[at] = Store<T>::of(mk * h);
  }
  h_out[at] = Store<T>::of(h);
  c_out[at] = Store<T>::of(cn);
}

constexpr int kRowThreads = 256;

// The sum (MAX: the max) of `v` over the block, the same in every thread
// (the warps' partials combined in warp order).
template <bool MAX, typename A>
__device__ __forceinline__ A block_reduce(A v, A* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const A o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? (o > v ? o : v) : v + o;
  }
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  A t = part[0];
#pragma unroll
  for (int w = 1; w < kRowThreads / 32; ++w)
    t = MAX ? (part[w] > t ? part[w] : t) : t + part[w];
  __syncthreads();  // `part` is written again by the next reduction
  return t;
}

// v[0..n) <- act(v) in place: elementwise by code, or softmax over the n
// (exp(v - max) / sum, as torch.softmax).
template <typename A>
__device__ __forceinline__ void act_row(A* v, int n, int code, A* part) {
  if (code != kSoftmax) {
    for (int j = threadIdx.x; j < n; j += kRowThreads) v[j] = cell_act(v[j], code);
    __syncthreads();
    return;
  }
  A m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kRowThreads) m = v[j] > m ? v[j] : m;
  m = block_reduce<true>(m, part);
  A s = A(0);
  for (int j = threadIdx.x; j < n; j += kRowThreads) {
    const A e = exp(v[j] - m);
    v[j] = e;
    s += e;
  }
  s = block_reduce<false>(s, part);
  for (int j = threadIdx.x; j < n; j += kRowThreads) v[j] = v[j] / s;
  __syncthreads();
}

// The gate math of one row from the "z out" workspace (z: [b, 4n] of A,
// gate order i, f, o, g, input-side peepholes added): one block a row, the
// row's z and its new c in dynamic shared memory (5n values of A).
template <typename T, bool PEEP, bool MASKED>
__global__ void __launch_bounds__(kRowThreads)
lstm_rows_kernel(const typename Form<T>::A* __restrict__ ws,
                 const T* __restrict__ h_prev, const T* __restrict__ c_prev,
                 const T* __restrict__ pw, const T* __restrict__ mask,
                 T* __restrict__ h_out, T* __restrict__ c_out,
                 T* __restrict__ out, int n, int act, int gate) {
  using A = typename Form<T>::A;
  extern __shared__ __align__(16) unsigned char rows_raw[];
  __shared__ A part[kRowThreads / 32];
  A* zs = reinterpret_cast<A*>(rows_raw);  // [4n]: i, f, o, g
  A* cs = zs + 4 * n;                       // [n]: the new c
  const size_t row = blockIdx.x;
  const A* z = ws + row * 4 * n;
  for (int e = threadIdx.x; e < 4 * n; e += kRowThreads) zs[e] = z[e];
  __syncthreads();
  act_row(zs, n, gate, part);          // i
  act_row(zs + n, n, gate, part);      // f
  act_row(zs + 3 * n, n, act, part);   // g
  for (int j = threadIdx.x; j < n; j += kRowThreads) {
    const A c = zs[n + j] * to_acc(c_prev[row * n + j]) + zs[j] * zs[3 * n + j];
    cs[j] = c;
    if (PEEP) zs[2 * n + j] += c * to_acc(pw[2 * n + j]);
    zs[3 * n + j] = c;  // g is spent: act(c) is made in its place
  }
  __syncthreads();
  act_row(zs + 2 * n, n, gate, part);  // o
  act_row(zs + 3 * n, n, act, part);   // act(c)
  const A mk = MASKED ? to_acc(mask[row]) : A(1);
  for (int j = threadIdx.x; j < n; j += kRowThreads) {
    const size_t at = row * n + j;
    A h = zs[2 * n + j] * zs[3 * n + j];
    A c = cs[j];
    if (MASKED) {
      h = mk * h + (A(1) - mk) * to_acc(h_prev[at]);
      c = mk * c + (A(1) - mk) * to_acc(c_prev[at]);
      out[at] = Store<T>::of(mk * h);
    }
    h_out[at] = Store<T>::of(h);
    c_out[at] = Store<T>::of(c);
  }
}

template <typename T>
int launch(const void* xw, long long xw_stride, const void* h, const void* c,
           const void* rw, const void* pw, const void* m, void* h_out,
           void* c_out, void* out, int b, int n, int act, int gate, int zout,
           cudaStream_t stream) {
  constexpr int kChunk = 16 / sizeof(T);
  const int vec = n % kChunk == 0 &&
                  reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(rw) % (kUnits * sizeof(T)) == 0;
  const dim3 grid((n + kUnits - 1) / kUnits, (b + kRows - 1) / kRows);
  const T* xp = static_cast<const T*>(xw);
  const T* hp = static_cast<const T*>(h);
  const T* cp = static_cast<const T*>(c);
  const T* rp = static_cast<const T*>(rw);
  const T* pp = static_cast<const T*>(pw);
  const T* mp = static_cast<const T*>(m);
  T* ho = static_cast<T*>(h_out);
  T* co = static_cast<T*>(c_out);
  T* oo = static_cast<T*>(out);
#define DL4J_LSTM_LAUNCH(PEEP, MASKED)                                      \
  lstm_cell_kernel<T, PEEP, MASKED, false><<<grid, kThreads, 0, stream>>>(  \
      xp, xw_stride, hp, cp, rp, pp, mp, ho, co, oo, b, n, act, gate, vec)
  if (zout && pw)
    lstm_cell_kernel<T, true, false, true><<<grid, kThreads, 0, stream>>>(
        xp, xw_stride, hp, cp, rp, pp, nullptr, nullptr, nullptr, oo, b, n,
        0, 0, vec);
  else if (zout)
    lstm_cell_kernel<T, false, false, true><<<grid, kThreads, 0, stream>>>(
        xp, xw_stride, hp, cp, rp, nullptr, nullptr, nullptr, nullptr, oo, b,
        n, 0, 0, vec);
  else if (pw && m)
    DL4J_LSTM_LAUNCH(true, true);
  else if (pw)
    DL4J_LSTM_LAUNCH(true, false);
  else if (m)
    DL4J_LSTM_LAUNCH(false, true);
  else
    DL4J_LSTM_LAUNCH(false, false);
#undef DL4J_LSTM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* ws, const void* h, const void* c, const void* pw,
                const void* m, void* h_out, void* c_out, void* out, int b,
                int n, int act, int gate, cudaStream_t stream) {
  using A = typename Form<T>::A;
  const size_t bytes = static_cast<size_t>(5) * n * sizeof(A);
  const A* wp = static_cast<const A*>(ws);
  const T* hp = static_cast<const T*>(h);
  const T* cp = static_cast<const T*>(c);
  const T* pp = static_cast<const T*>(pw);
  const T* mp = static_cast<const T*>(m);
  T* ho = static_cast<T*>(h_out);
  T* co = static_cast<T*>(c_out);
  T* oo = static_cast<T*>(out);
#define DL4J_ROWS_LAUNCH(PEEP, MASKED)                                        \
  do {                                                                        \
    const auto kernel = lstm_rows_kernel<T, PEEP, MASKED>;                    \
    if (bytes > 48 * 1024) {                                                  \
      const cudaError_t err = cudaFuncSetAttribute(                           \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,                \
          static_cast<int>(bytes));                                           \
      if (err != cudaSuccess) return static_cast<int>(err);                   \
    }                                                                         \
    kernel<<<b, kRowThreads, bytes, stream>>>(wp, hp, cp, pp, mp, ho, co, oo, \
                                              n, act, gate);                  \
  } while (0)
  if (pw && m)
    DL4J_ROWS_LAUNCH(true, true);
  else if (pw)
    DL4J_ROWS_LAUNCH(true, false);
  else if (m)
    DL4J_ROWS_LAUNCH(false, true);
  else
    DL4J_ROWS_LAUNCH(false, false);
#undef DL4J_ROWS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch's scalars, one block the wrapper builds once per shape
// (`lstm_cell._CellParams`, the same fields in the same order). `zout`:
// the "z out" form, whose workspace comes as `out` (act and gate unused).
struct CellParams {
  long long xw_stride;
  int b, n, act, gate, dtype, zout;
};

// xw: [b, 4n] rows `xw_stride` elements apart (a time step of [b, t, 4n]);
// h, c, h_out, c_out, out: [b, n] contiguous (out read only with m); rw:
// [n, 4n] contiguous; pw: [3n] (p_i, p_f, p_o) or null; m: [b] or null;
// all of `dtype` (f32, bf16, f16 or f64). `act` and `gate` are the cell and
// gate activations' codes (`cell_act`). `params` (host memory) holds
// xw_stride, b, n, act, gate, dtype and zout; with zout, `out` is the [b,
// 4n] workspace (f32, f64 for f64) and m, h_out and c_out are unused.
// Shapes and dtypes are checked by the Python wrapper.
extern "C" int dl4j_lstm_cell(const void* xw, const void* h, const void* c,
                              const void* rw, const void* pw, const void* m,
                              void* h_out, void* c_out, void* out,
                              const void* params, void* stream) {
  const CellParams& p = *static_cast<const CellParams*>(params);
  if (p.b <= 0 || p.n <= 0) return 0;
  if ((p.b + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.act < 0 || p.act > 15 || p.gate < 0 || p.gate > 15)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.dtype == dl4j::kFloat32)
    return launch<float>(xw, p.xw_stride, h, c, rw, pw, m, h_out, c_out, out,
                         p.b, p.n, p.act, p.gate, p.zout, s);
  if (p.dtype == dl4j::kBFloat16)
    return launch<__nv_bfloat16>(xw, p.xw_stride, h, c, rw, pw, m, h_out,
                                 c_out, out, p.b, p.n, p.act, p.gate, p.zout,
                                 s);
  if (p.dtype == dl4j::kFloat16)
    return launch<__half>(xw, p.xw_stride, h, c, rw, pw, m, h_out, c_out,
                          out, p.b, p.n, p.act, p.gate, p.zout, s);
  if (p.dtype == dl4j::kFloat64)
    return launch<double>(xw, p.xw_stride, h, c, rw, pw, m, h_out, c_out,
                          out, p.b, p.n, p.act, p.gate, p.zout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gate math of a cell whose gate or cell activation is softmax (code
// 16; the others by their `cell_act` code), from the "z out" workspace ws
// ([b, 4n], f32, f64 for f64); h, c, pw, m, h_out, c_out and out as for
// `dl4j_lstm_cell`. `params`: the same block (xw_stride and zout unused).
extern "C" int dl4j_lstm_cell_rows(const void* ws, const void* h,
                                   const void* c, const void* pw,
                                   const void* m, void* h_out, void* c_out,
                                   void* out, const void* params,
                                   void* stream) {
  const CellParams& p = *static_cast<const CellParams*>(params);
  if (p.b <= 0 || p.n <= 0) return 0;
  if (p.act < 0 || p.act > kSoftmax || p.gate < 0 || p.gate > kSoftmax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dtype == dl4j::kFloat32)
    return launch_rows<float>(ws, h, c, pw, m, h_out, c_out, out, p.b, p.n,
                              p.act, p.gate, s);
  if (p.dtype == dl4j::kBFloat16)
    return launch_rows<__nv_bfloat16>(ws, h, c, pw, m, h_out, c_out, out,
                                      p.b, p.n, p.act, p.gate, s);
  if (p.dtype == dl4j::kFloat16)
    return launch_rows<__half>(ws, h, c, pw, m, h_out, c_out, out, p.b, p.n,
                               p.act, p.gate, s);
  if (p.dtype == dl4j::kFloat64)
    return launch_rows<double>(ws, h, c, pw, m, h_out, c_out, out, p.b, p.n,
                               p.act, p.gate, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
