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
// ~2.5 us at 3.35 TB/s. So the whole read has to be in flight within about
// one DRAM round trip, and no block may wait on one row before asking for
// the next.
//
// Design (split-KV, flash-decoding). The grid is (splits, heads, slots); a
// split is a run of whole logical pages, cut by a static plan that the
// wrapper computes from B, H, the table width, the page, the head width and
// the SM count alone (`paged_split_plan`), never from pos: reading pos on the
// host would synchronize every decode step. At the serving shape (4 slots x
// 8 heads, 16 pages of 64 keys) that is one page a split, 512 blocks. A block
// reads its row's cursor on the card and returns at once when its pages lie
// beyond the row's key limit: their softmax weight is exactly 0 in the TPU
// kernel, so the output is the same and only the bytes the bound counts are
// read. A block asks for its split's K and V rows of its head before any
// math: 16-byte cp.async copies into shared memory, tiles of up to 64 rows,
// two tiles in flight (a row whose width is no multiple of 16 bytes, or a
// pool at an address that is not, is copied element by element). Per tile:
// the scores with one thread per key (q.k over the head dims from shared
// memory, rows padded by 16 bytes so that neighbouring keys fall in other
// banks), then one max and one sum per query over the tile (a warp per
// query), then P.V with one thread per (query, dim); f32 throughout. Each
// split writes (m, l, acc) in f32 to a workspace the wrapper keeps; the last
// block of a (slot, head) to finish, elected by an integer counter that it
// resets to 0, merges the splits in split order, so two launches on the
// same inputs give the same bits (one pass, each split rescaling the running
// sums to the larger max). A split in which a query sees no key holds m =
// -1e30, l = 0, acc = 0 for it and merges with weight exp(-1e30 - M) = 0
// (split 0 always holds key 0, so M is a real score from the first split
// on). A row whose visible keys lie in one split writes o directly.
//
// f32, bf16 and f16 pools (the f16 one a mixed_float16 LM's KV cache) are
// instantiations of one template: the pages are read at their type and
// widened at the load, and the softmax and the merge stay in f32. The f64
// pools of a float64 LM are the same template at double, whose accumulation
// type (`dl4j::acc_t`) is double: q, the scores, the softmax, the merge,
// the workspace and the scale are double, 16-byte copies carry two values,
// and a tile holds 16 rows at D = 64 (`paged_tile_rows`), 38 KB of shared
// memory at one query; past 48 KB (D = 128) the launch opts into dynamic
// shared memory. Bound at the f64 decode (4 slots, 8 heads, 1,024 keys,
// D = 64): 33.6 MB of K and V, 10 us at 3.35 TB/s: bytes, as in f32.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 8;      // query positions per slot (T); speculative verify widths
constexpr int kMaxDim = 128;
constexpr int kMaxTile = 64;  // key rows per tile
constexpr int kOuts = kMaxQ * kMaxDim / kThreads;  // (query, dim) outputs a thread
constexpr int kMaxSmem = 227 * 1024;  // the most a block can take on an H100

// Shared memory: q [nq][dr] in the accumulation type (scaled, zero past
// D), the tile's scores
// then probabilities [kMaxQ][kMaxTile], the running max, sum and the tile's
// correction [kMaxQ] each, the merge flag (padded to 16 bytes); then two
// stages of K and V tiles [tile][dr + one 16-byte pad] in the operand dtype.
// dr (D rounded up to 16 bytes) spans a multiple of 16 bytes in either
// accumulation type, so every part starts at
// a multiple of 16 bytes.
template <typename A>
__host__ __device__ constexpr int header_bytes(int nq, int dr) {
  return (nq * dr + kMaxQ * kMaxTile + 3 * kMaxQ) *
             static_cast<int>(sizeof(A)) + 16;
}

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

__device__ __forceinline__ void load_chunk(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load_chunk(const double* p, double (&f)[2]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  f[0] = v.x;
  f[1] = v.y;
}

__device__ __forceinline__ void load_chunk(const __half* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __half2* h2 = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __half22float2(h2[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h2[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                   const T* __restrict__ vpool, const int* __restrict__ table,
                   const int* __restrict__ pos, T* __restrict__ o,
                   dl4j::acc_t<T>* __restrict__ part,
                   int* __restrict__ counter, int nq, int heads, int dim,
                   int page, int n_pages, int split_keys, int n_splits,
                   int tile, int causal, int vec, dl4j::acc_t<T> scale) {
  using A = dl4j::acc_t<T>;
  constexpr int kChunk = 16 / sizeof(T);  // elements in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int k_begin = split * split_keys;
  // The split's first page id is read beside the cursor, not after it.
  const int* row_table = table + static_cast<size_t>(b) * n_pages;
  const int first_page = k_begin / page;
  const int phys_first = row_table[first_page];
  const int p0 = pos[b];
  const int n_keys = min(p0 + nq, n_pages * page);  // keys [0, n_keys)
  const int n_active = (n_keys + split_keys - 1) / split_keys;
  if (split >= n_active) return;  // no key of this split is visible
  const int k_end = min(k_begin + split_keys, n_keys);
  const int dr = (dim + kChunk - 1) / kChunk * kChunk;
  const int stride = dr + kChunk;
  const int cpr = dr / kChunk;  // 16-byte chunks a row

  A* qs = reinterpret_cast<A*>(smem);
  A* ss = qs + nq * dr;
  A* m_run = ss + kMaxQ * kMaxTile;
  A* l_run = m_run + kMaxQ;
  A* corr = l_run + kMaxQ;
  int* flag = reinterpret_cast<int*>(corr + kMaxQ);
  T* kv = reinterpret_cast<T*>(smem + header_bytes<A>(nq, dr));

  // One tile's K and V rows [key0, key0 + rows) into `stage`, one commit.
  // A thread keeps one 16-byte column of the rows (lc) and steps rows by
  // lstep, so the only division a row is its logical page.
  const int lc = tid % cpr, lstep = kThreads / cpr;
  const int lr0 = tid < lstep * cpr ? tid / cpr : kMaxTile;  // else idle
  auto load = [&](int stage, int key0, int rows) {
    T* kdst = kv + static_cast<size_t>(stage) * 2 * tile * stride + lc * kChunk;
    T* vdst = kdst + tile * stride;
    for (int r = lr0; r < rows; r += lstep) {
      const int key = key0 + r;
      const int lp = key / page;
      const int phys = lp == first_page ? phys_first : row_table[lp];
      const size_t off =
          ((static_cast<size_t>(phys) * page + (key - lp * page)) * heads +
           h) * dim + lc * kChunk;
      if (vec) {
        dl4j::cp_async<16>(kdst + r * stride, kpool + off);
        dl4j::cp_async<16>(vdst + r * stride, vpool + off);
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const bool in = lc * kChunk + i < dim;
          kdst[r * stride + i] = in ? kpool[off + i] : dl4j::from_acc<T>(A(0));
          vdst[r * stride + i] = in ? vpool[off + i] : dl4j::from_acc<T>(A(0));
        }
      }
    }
    dl4j::cp_async_commit();
  };
  const int n_tiles = (k_end - k_begin + tile - 1) / tile;
  auto tile_rows = [&](int it) {
    return min(tile, k_end - k_begin - it * tile);
  };
  load(0, k_begin, tile_rows(0));
  if (n_tiles > 1)
    load(1, k_begin + tile, tile_rows(1));
  else
    dl4j::cp_async_commit();

  for (int e = tid; e < nq * dr; e += kThreads) {
    const int t = e / dr, d = e - t * dr;
    qs[e] = d < dim ? dl4j::to_acc(q[((static_cast<size_t>(b) * nq + t) *
                                          heads + h) * dim + d]) * scale
                    : A(0);
  }
  if (tid < kMaxQ) {
    m_run[tid] = dl4j::neg<A>();
    l_run[tid] = A(0);
  }
  A acc[kOuts];
#pragma unroll
  for (int i = 0; i < kOuts; ++i) acc[i] = A(0);

  const int groups = kThreads / tile;
  const int w = tid / 32, lane = tid % 32;
  for (int it = 0; it < n_tiles; ++it) {
    const int key0 = k_begin + it * tile, rows = tile_rows(it);
    dl4j::cp_async_wait<1>();
    __syncthreads();
    const T* ks = kv + static_cast<size_t>(it & 1) * 2 * tile * stride;
    const T* vs = ks + tile * stride;
    {  // scores: thread r of its group takes key r, queries g, g + groups..
      const int r = tid % tile, g = tid / tile;
      if (r < rows) {
        const T* krow = ks + r * stride;
        for (int t = g; t < nq; t += groups) {
          const A* qt = qs + t * dr;
          A s = A(0);
          for (int c = 0; c < dr; c += kChunk) {
            A kf[kChunk];
            load_chunk(krow + c, kf);
            if constexpr (sizeof(A) == 4) {
#pragma unroll
              for (int i = 0; i < kChunk; i += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(qt + c + i);
                s = fmaf(qv.x, kf[i], s);
                s = fmaf(qv.y, kf[i + 1], s);
                s = fmaf(qv.z, kf[i + 2], s);
                s = fmaf(qv.w, kf[i + 3], s);
              }
            } else {
              const double2 qv = *reinterpret_cast<const double2*>(qt + c);
              s = fma(qv.x, kf[0], s);
              s = fma(qv.y, kf[1], s);
            }
          }
          ss[t * kMaxTile + r] = s;
        }
      }
    }
    __syncthreads();
    // One max and one sum per query over the tile; keys at or past the
    // query's limit weigh exactly 0.
    for (int t = w; t < nq; t += kWarps) {
      const int limit = causal ? p0 + 1 + t : p0 + nq;
      const int vis = min(rows, limit - key0);
      A* st = ss + t * kMaxTile;
      const A m_old = m_run[t];
      A mx = dl4j::neg<A>();
      for (int r = lane; r < vis; r += 32) mx = dl4j::fmx(mx, st[r]);
      const A m_new = dl4j::fmx(m_old, dl4j::warp_max(mx));
      A sum = A(0);
      for (int r = lane; r < rows; r += 32) {
        const A p = r < vis ? dl4j::ex(st[r] - m_new) : A(0);
        st[r] = p;
        sum += p;
      }
      sum = dl4j::warp_sum(sum);
      if (lane == 0) {
        const A cr = dl4j::ex(m_old - m_new);
        corr[t] = cr;
        l_run[t] = l_run[t] * cr + sum;
        m_run[t] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kOuts; ++i) {  // P.V: one thread per (query, dim)
      const int e = tid + i * kThreads;
      if (e < nq * dim) {
        const int t = e / dim, d = e - t * dim;
        const A* pt = ss + t * kMaxTile;
        A a = acc[i] * corr[t];
#pragma unroll 8
        for (int r = 0; r < rows; ++r)
          a = fmadd(pt[r], dl4j::to_acc(vs[r * stride + d]), a);
        acc[i] = a;
      }
    }
    __syncthreads();  // this stage and the scores are free again
    if (it + 2 < n_tiles)
      load(it & 1, k_begin + (it + 2) * tile, tile_rows(it + 2));
    else
      dl4j::cp_async_commit();
  }

  const size_t out_row = static_cast<size_t>(b) * nq;
  if (n_active == 1) {  // the row's only split: no merge
#pragma unroll
    for (int i = 0; i < kOuts; ++i) {
      const int e = tid + i * kThreads;
      if (e < nq * dim) {
        const int t = e / dim, d = e - t * dim;
        o[((out_row + t) * heads + h) * dim + d] =
            dl4j::from_acc<T>(acc[i] / dl4j::fmx(l_run[t], dl4j::tiny<A>()));
      }
    }
    return;
  }

  // Partials: per split m [nq], l [nq], acc [nq][dim].
  const int ps = nq * (dim + 2);
  A* row_part =
      part + (static_cast<size_t>(b) * heads + h) * n_splits * ps;
  A* mine = row_part + static_cast<size_t>(split) * ps;
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    const int e = tid + i * kThreads;
    if (e < nq * dim) mine[2 * nq + e] = acc[i];
  }
  if (tid < nq) {
    mine[tid] = m_run[tid];
    mine[nq + tid] = l_run[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counter + static_cast<size_t>(b) * heads + h;
    const int last = atomicAdd(cnt, 1) == n_active - 1;
    if (last) atomicExch(cnt, 0);  // ready for the next launch
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // The last block merges the row's splits in split order.
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    const int e = tid + i * kThreads;
    if (e < nq * dim) {
      const int t = e / dim, d = e - t * dim;
      A mx = dl4j::neg<A>(), l = A(0), a = A(0);
#pragma unroll 4
      for (int s = 0; s < n_active; ++s) {
        const A* sp = row_part + static_cast<size_t>(s) * ps;
        const A ms = __ldcg(sp + t), ls = __ldcg(sp + nq + t);
        const A as = __ldcg(sp + 2 * nq + e);
        const A m_new = dl4j::fmx(mx, ms);
        const A c_old = dl4j::ex(mx - m_new), c_s = dl4j::ex(ms - m_new);
        l = l * c_old + ls * c_s;
        a = a * c_old + as * c_s;
        mx = m_new;
      }
      o[((out_row + t) * heads + h) * dim + d] =
          dl4j::from_acc<T>(a / dl4j::fmx(l, dl4j::tiny<A>()));
    }
  }
}

// The launch's scalars, one block the wrapper builds once per shape
// (`flash_attention._PagedParams`, the same fields in the same order).
struct PagedParams {
  int batch, nq, heads, dim, page, n_pages, pages_per_split, n_splits, tile,
      causal, dtype;
  double scale;  // rounded to f32 for every form but the f64 one
};

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* table, const int* pos, void* o, void* part, int* cnt,
           const PagedParams& p, cudaStream_t stream) {
  using A = dl4j::acc_t<T>;
  constexpr int kChunk = 16 / sizeof(T);
  const int dr = (p.dim + kChunk - 1) / kChunk * kChunk;
  const int smem = header_bytes<A>(p.nq, dr) +
                   4 * p.tile * (dr + kChunk) * static_cast<int>(sizeof(T));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec = p.dim % kChunk == 0 &&
                  reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  const dim3 grid(p.n_splits, p.heads, p.batch);
  paged_split_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), table, pos, static_cast<T*>(o),
      static_cast<A*>(part), cnt, p.nq, p.heads, p.dim, p.page, p.n_pages,
      p.pages_per_split * p.page, p.n_splits, p.tile, p.causal, vec,
      static_cast<A>(p.scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [batch, nq, heads, dim]; k_pages, v_pages: [P, page, heads, dim], all
// of `dtype`; table: [batch, n_pages] int32; pos: [batch] int32. partials:
// batch * heads * n_splits * nq * (dim + 2) f32; counters: batch * heads
// int32, 0 before the launch and 0 again after it. `params` (host memory)
// holds the shape, the split plan (`pages_per_split`, `n_splits`, `tile`
// key rows a tile, from the Python wrapper's `paged_split_plan`), the mask,
// the dtype and the scale. nq <= 8, dim <= 128.
extern "C" int dl4j_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* table,
    const void* pos, void* o, void* partials, void* counters,
    const void* params, void* stream) {
  const PagedParams& p = *static_cast<const PagedParams*>(params);
  if (p.batch <= 0 || p.nq <= 0 || p.heads <= 0) return 0;
  if (p.nq > kMaxQ || p.dim <= 0 || p.dim > kMaxDim || p.page <= 0 ||
      p.n_pages <= 0 || p.pages_per_split <= 0 ||
      p.n_splits != (p.n_pages + p.pages_per_split - 1) / p.pages_per_split ||
      (p.tile != 8 && p.tile != 16 && p.tile != 32 && p.tile != kMaxTile) ||
      p.heads > 65535 || p.batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tp = static_cast<const int*>(table);
  const int* pp = static_cast<const int*>(pos);
  void* part = partials;
  int* cnt = static_cast<int*>(counters);
  if (p.dtype == dl4j::kFloat32)
    return launch<float>(q, k_pages, v_pages, tp, pp, o, part, cnt, p, s);
  if (p.dtype == dl4j::kBFloat16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tp, pp, o, part, cnt,
                                 p, s);
  if (p.dtype == dl4j::kFloat16)
    return launch<__half>(q, k_pages, v_pages, tp, pp, o, part, cnt, p, s);
  if (p.dtype == dl4j::kFloat64)
    return launch<double>(q, k_pages, v_pages, tp, pp, o, part, cnt, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* dl4j_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
