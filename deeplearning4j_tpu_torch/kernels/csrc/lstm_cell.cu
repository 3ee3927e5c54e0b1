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
//
// Bound on the H100: bytes. At the char-RNN's training shape (b=32, n=256,
// f32) one step reads RW (1 MiB), xw_t, h_prev, c_prev and pW and writes h,
// c and out: ~1.34 MB, 0.4 us at 3.35 TB/s, against 2*b*n*4n = 16.8 MFLOP
// (0.25 us at the f32 rate). Either way a step is far below a launch's own
// cost: what bounds it in practice is the launch and, in the whole scan, the
// host that issues one launch per step and layer.
//
// Design, simple first: a block owns a tile of kTJ hidden units and kTB
// batch rows (one thread per (row, unit), four f32 accumulators each, one
// per gate). It walks the recurrent dimension in steps of kKT: h_prev's
// [kTB, kKT] tile and RW's [kKT, 4, kTJ] column groups are staged through
// shared memory (bf16 widened to f32 at the load; neighbouring threads read
// neighbouring columns, so the loads coalesce and the reads from shared
// memory are broadcasts or conflict-free), then each thread accumulates its
// four dot products. The gate math runs in registers and every bounds check
// is explicit, so any n and any b (b = 1 when sampling) are taken. A
// persistent kernel that keeps RW in the SMs' shared memory across the time
// steps is later work.

#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kTJ = 32;  // hidden units per block (threadIdx.x)
constexpr int kTB = 8;   // batch rows per block (threadIdx.y)
constexpr int kKT = 32;  // recurrent-dimension step through shared memory
constexpr int kThreads = kTJ * kTB;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

template <typename T, bool PEEP, bool MASKED>
__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const T* __restrict__ xw, long long xw_stride,
                 const T* __restrict__ h_prev, const T* __restrict__ c_prev,
                 const T* __restrict__ rw, const T* __restrict__ pw,
                 const T* __restrict__ mask, T* __restrict__ h_out,
                 T* __restrict__ c_out, T* __restrict__ out, int b, int n,
                 int act) {
  __shared__ float hs[kTB][kKT];
  __shared__ float rws[kKT][4][kTJ];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTJ + tx;
  const int j0 = blockIdx.x * kTJ, r0 = blockIdx.y * kTB;
  const size_t ld = 4 * static_cast<size_t>(n);  // RW's row length

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < n; k0 += kKT) {
    {  // h_prev tile: kTB * kKT == kThreads elements, one each
      const int r = tid / kKT, kk = tid % kKT;
      const int row = r0 + r, k = k0 + kk;
      hs[r][kk] = (row < b && k < n)
                      ? dl4j::to_f32(h_prev[static_cast<size_t>(row) * n + k])
                      : 0.f;
    }
    for (int e = tid; e < kKT * 4 * kTJ; e += kThreads) {
      const int kk = e / (4 * kTJ), g = (e / kTJ) % 4, jj = e % kTJ;
      const int k = k0 + kk, col = j0 + jj;
      rws[kk][g][jj] =
          (k < n && col < n)
              ? dl4j::to_f32(rw[static_cast<size_t>(k) * ld +
                                static_cast<size_t>(g) * n + col])
              : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKT; ++kk) {
      const float hv = hs[ty][kk];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g] = fmaf(hv, rws[kk][g][tx], acc[g]);
    }
    __syncthreads();
  }

  const int row = r0 + ty, j = j0 + tx;
  if (row >= b || j >= n) return;
  const T* x = xw + static_cast<size_t>(row) * xw_stride;
  const size_t at = static_cast<size_t>(row) * n + j;
  const float cp = dl4j::to_f32(c_prev[at]);
  float zi = dl4j::to_f32(x[j]) + acc[0];
  float zf = dl4j::to_f32(x[n + j]) + acc[1];
  float zo = dl4j::to_f32(x[2 * n + j]) + acc[2];
  const float zg = dl4j::to_f32(x[3 * n + j]) + acc[3];
  if (PEEP) {
    zi += cp * dl4j::to_f32(pw[j]);
    zf += cp * dl4j::to_f32(pw[n + j]);
  }
  const float i = sigmoid(zi), f = sigmoid(zf);
  const float g = dl4j::activate(zg, act);
  float c = f * cp + i * g;
  if (PEEP) zo += c * dl4j::to_f32(pw[2 * n + j]);
  float h = sigmoid(zo) * dl4j::activate(c, act);
  float o = h;
  if (MASKED) {
    const float m = dl4j::to_f32(mask[row]);
    h = m * h + (1.f - m) * dl4j::to_f32(h_prev[at]);
    c = m * c + (1.f - m) * cp;
    o = m * h;
  }
  h_out[at] = dl4j::from_f32<T>(h);
  c_out[at] = dl4j::from_f32<T>(c);
  out[at] = dl4j::from_f32<T>(o);
}

template <typename T>
int launch(const void* xw, long long xw_stride, const void* h, const void* c,
           const void* rw, const void* pw, const void* m, void* h_out,
           void* c_out, void* out, int b, int n, int act,
           cudaStream_t stream) {
  const dim3 grid((n + kTJ - 1) / kTJ, (b + kTB - 1) / kTB);
  const dim3 block(kTJ, kTB);
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
  lstm_cell_kernel<T, PEEP, MASKED><<<grid, block, 0, stream>>>(            \
      xp, xw_stride, hp, cp, rp, pp, mp, ho, co, oo, b, n, act)
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

// xw: [b, 4n] rows `xw_stride` elements apart (a time step of [b, t, 4n]);
// h, c, h_out, c_out, out: [b, n] contiguous; rw: [n, 4n] contiguous; pw:
// [3n] (p_i, p_f, p_o) or null; m: [b] or null; all of `dtype`. `act` is the
// cell activation's code (common.cuh); the gates are sigmoid. Shapes and
// dtypes are checked by the Python wrapper.
extern "C" int dl4j_lstm_cell(const void* xw, long long xw_stride,
                              const void* h, const void* c, const void* rw,
                              const void* pw, const void* m, void* h_out,
                              void* c_out, void* out, int b, int n, int act,
                              int dtype, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return launch<float>(xw, xw_stride, h, c, rw, pw, m, h_out, c_out, out, b,
                         n, act, s);
  if (dtype == dl4j::kBFloat16)
    return launch<__nv_bfloat16>(xw, xw_stride, h, c, rw, pw, m, h_out, c_out,
                                 out, b, n, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
