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
//   c   = sigmoid(zf) * c_prev + sigmoid(zi) * act(zg)
//   zo += c * p_o                            (the new c: Graves)
//   h   = sigmoid(zo) * act(c)
//   masked: h = m h + (1-m) h_prev ; c = m c + (1-m) c_prev ; out = m h
//
// h, c and out are written in the operand dtype, so under a bf16 policy the
// carried c is rounded to bf16 every step, as the TPU body's
// `co[...] = c.astype(co.dtype)` does; z never goes to device memory.
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
constexpr int kKC = 128;               // recurrent-dimension chunk a stage
constexpr int kKW = kKC / kWarps;      // of it, a warp's share
constexpr int kRowsPerLane = kRows / 4;  // lane rows rq, rq + 4, ...

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// Four consecutive values of a shared-memory row as floats.
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
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
  static constexpr int kPad = 16 / sizeof(T);  // a 16-byte pad a row
  static constexpr int kHS = kKC + kPad;       // h row stride, elements
  T h[kRows][kHS];
  T w[kKC][kCols];
};

template <typename T, bool PEEP, bool MASKED>
__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const T* __restrict__ xw, long long xw_stride,
                 const T* __restrict__ h_prev, const T* __restrict__ c_prev,
                 const T* __restrict__ rw, const T* __restrict__ pw,
                 const T* __restrict__ mask, T* __restrict__ h_out,
                 T* __restrict__ c_out, T* __restrict__ out, int b, int n,
                 int act, int vec) {
  constexpr int kChunk = 16 / sizeof(T);  // h elements in 16 bytes
  __shared__ __align__(16) unsigned char raw[2 * sizeof(Stage<T>)];
  Stage<T>* stage = reinterpret_cast<Stage<T>*>(raw);
  static_assert(sizeof(Stage<T>) >= kWarps * kRows * kCols * sizeof(float),
                "the warps' partial sums reuse stage 0");

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
          st.h[r][k + i] = k0 + k + i < n ? src[i] : dl4j::from_f32<T>(0.f);
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
                                            : dl4j::from_f32<T>(0.f);
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
  float xg[4] = {0.f, 0.f, 0.f, 0.f}, cp = 0.f, hp = 0.f, mk = 1.f;
  float pi = 0.f, pf = 0.f, po = 0.f;
  if (epi) {
    const T* x = xw + static_cast<size_t>(r0 + er) * xw_stride;
#pragma unroll
    for (int g = 0; g < 4; ++g) xg[g] = dl4j::to_f32(x[g * n + j]);
    const size_t at = static_cast<size_t>(r0 + er) * n + j;
    cp = dl4j::to_f32(c_prev[at]);
    if (PEEP) {
      pi = dl4j::to_f32(pw[j]);
      pf = dl4j::to_f32(pw[n + j]);
      po = dl4j::to_f32(pw[2 * n + j]);
    }
    if (MASKED) {
      mk = dl4j::to_f32(mask[r0 + er]);
      hp = dl4j::to_f32(h_prev[at]);
    }
  }

  const int w = tid / 32, lane = tid % 32;
  const int c = lane % kCols, rq = lane / kCols;
  const int nri = (rows - rq + 3) / 4;  // this lane's rows below `rows`
  float acc[kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) acc[i] = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    dl4j::cp_async_wait<1>();
    __syncthreads();
    const Stage<T>& st = stage[ch & 1];
#pragma unroll
    for (int k4 = 0; k4 < kKW; k4 += 4) {
      const int kk = w * kKW + k4;
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q] = dl4j::to_f32(st.w[kk + q][c]);
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        if (i < nri) {
          float hv[4];
          load4(&st.h[rq + 4 * i][kk], hv);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i] = fmaf(hv[q], wv[q], acc[i]);
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
  float* red = reinterpret_cast<float*>(raw);
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i)
    if (i < nri) red[(w * kRows + rq + 4 * i) * kCols + c] = acc[i];
  __syncthreads();
  if (!epi) return;
  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww)
      s += red[(ww * kRows + er) * kCols + g * kUnits + eu];
    z[g] = xg[g] + s;
  }
  float zi = z[0], zf = z[1], zo = z[2];
  const float zg = z[3];
  if (PEEP) {
    zi += cp * pi;
    zf += cp * pf;
  }
  const float i = sigmoid(zi), f = sigmoid(zf);
  const float g = dl4j::activate(zg, act);
  float cn = f * cp + i * g;
  if (PEEP) zo += cn * po;
  float h = sigmoid(zo) * dl4j::activate(cn, act);
  const size_t at = static_cast<size_t>(r0 + er) * n + j;
  if (MASKED) {
    h = mk * h + (1.f - mk) * hp;
    cn = mk * cn + (1.f - mk) * cp;
    out[at] = dl4j::from_f32<T>(mk * h);
  }
  h_out[at] = dl4j::from_f32<T>(h);
  c_out[at] = dl4j::from_f32<T>(cn);
}

template <typename T>
int launch(const void* xw, long long xw_stride, const void* h, const void* c,
           const void* rw, const void* pw, const void* m, void* h_out,
           void* c_out, void* out, int b, int n, int act,
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
  lstm_cell_kernel<T, PEEP, MASKED><<<grid, kThreads, 0, stream>>>(         \
      xp, xw_stride, hp, cp, rp, pp, mp, ho, co, oo, b, n, act, vec)
  if (pw && m)
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

}  // namespace

// The launch's scalars, one block the wrapper builds once per shape
// (`lstm_cell._CellParams`, the same fields in the same order).
struct CellParams {
  long long xw_stride;
  int b, n, act, dtype;
};

// xw: [b, 4n] rows `xw_stride` elements apart (a time step of [b, t, 4n]);
// h, c, h_out, c_out, out: [b, n] contiguous (out read only with m); rw:
// [n, 4n] contiguous; pw: [3n] (p_i, p_f, p_o) or null; m: [b] or null;
// all of `dtype`. `act` is the
// cell activation's code (common.cuh); the gates are sigmoid. `params`
// (host memory) holds xw_stride, b, n, act and dtype. Shapes and dtypes are
// checked by the Python wrapper.
extern "C" int dl4j_lstm_cell(const void* xw, const void* h, const void* c,
                              const void* rw, const void* pw, const void* m,
                              void* h_out, void* c_out, void* out,
                              const void* params, void* stream) {
  const CellParams& p = *static_cast<const CellParams*>(params);
  if (p.b <= 0 || p.n <= 0) return 0;
  if ((p.b + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dtype == dl4j::kFloat32)
    return launch<float>(xw, p.xw_stride, h, c, rw, pw, m, h_out, c_out, out,
                         p.b, p.n, p.act, s);
  if (p.dtype == dl4j::kBFloat16)
    return launch<__nv_bfloat16>(xw, p.xw_stride, h, c, rw, pw, m, h_out,
                                 c_out, out, p.b, p.n, p.act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
