// Hopper building blocks for the port's tensor-core kernels: TMA tile loads
// completing on an mbarrier, the wgmma shared-memory descriptor of a tile
// that TMA wrote with the 128-byte swizzle, and the wgmma products the flash
// tiles and the bottleneck convolutions need, in bf16 (the default element
// type E) or f16 (E = __half: the same m64nNk16 shapes, `.f32.f16.f16`). Every device helper is
// one PTX instruction or a fixed group of them (PTX ISA 8.0, sm_90a); the
// layouts they assume are stated where they are defined. On the host,
// `encode_tiled` finds the driver's tensor-map encoder.
#pragma once

#include <cuda.h>  // CUtensorMap (the type only: nothing here links libcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace dl4j {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-aligned byte (the swizzle atom) of dynamic shared memory.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// ------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA

// One box of a 4-D tensor map into shared memory at `dst`, completing on
// `bar`; c0 is the innermost coordinate.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// One box of a 2-D tensor map into shared memory at `dst`, completing on
// `bar`; c0 is the innermost coordinate.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library needs no -lcuda; nullptr where the driver has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// ---------------------------------------------------------------- wgmma

// The descriptor of a bf16 operand in shared memory written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B: rows of 128 bytes (64 elements), 16-byte
// chunks XOR-ed with the row index mod 8, each 8-row group (1024 bytes,
// the swizzle atom) 1024-aligned. `sbo` is the byte step between 8-row
// groups; `lbo` the byte step between 64-element atoms along M or N of an
// MN-major operand (a K-major operand within one atom ignores it).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;  // layout type 1: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait (it does not know the asynchronous product
// owns them in between).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for the bf16 A fragments of register-A products, which the
// products read asynchronously until their wait: fenced after the wait,
// they stay live (and unclobbered) through the whole window.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Two floats as the bf16 pair of one A-fragment register (lo: the lower
// column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The same pair in the element type E (bf16 or f16), rounded to nearest
// even.
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<E, __half>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// The m64nNk16 f32 accumulator layout, for thread t of the warpgroup (warp
// w = t / 32, lane l): d[4 * j + 2 * i + c] holds row 16 * w + l / 4 + 8 * i,
// column 8 * j + 2 * (l % 4) + c. Columns 16 * kk .. 16 * kk + 15 of it,
// packed as d[8kk + {0,1}], d[8kk + {2,3}], d[8kk + {4,5}], d[8kk + {6,7}],
// are the register A fragment of a k16 step.

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory (K-major).
// One asm statement for operand type TY ("bf16" or "f16"); the function
// picks TY by its element type E.
#define DL4J_WGMMA_M64N64K16_SS(TY) \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                       \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                                \
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                        \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                        \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                    \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                    \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                    \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                     \
      : "l"(a), "l"(b), "r"(accumulate))

template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t a, uint64_t b,
                                                   int accumulate) {
  if constexpr (std::is_same_v<E, __half>)
    DL4J_WGMMA_M64N64K16_SS("f16");
  else
    DL4J_WGMMA_M64N64K16_SS("bf16");
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the m64nNk16
// accumulator layout of 16 columns, as E pairs), B in shared memory
// MN-major (transposed).
// One asm statement for operand type TY ("bf16" or "f16"); the function
// picks TY by its element type E.
#define DL4J_WGMMA_M64N64K16_RS_TB(TY) \
  asm volatile(                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "   \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                            \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                       \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                     \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                   \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t b) {
  if constexpr (std::is_same_v<E, __half>)
    DL4J_WGMMA_M64N64K16_RS_TB("f16");
  else
    DL4J_WGMMA_M64N64K16_RS_TB("bf16");
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (the m64nNk16
// accumulator layout of 16 columns, as E pairs), B in shared memory
// MN-major (transposed).
// One asm statement for operand type TY ("bf16" or "f16"); the function
// picks TY by its element type E.
#define DL4J_WGMMA_M64N128K16_RS_TB(TY) \
  asm volatile(                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                            \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                       \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                     \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                     \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                     \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                     \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                     \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                   \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),         \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),         \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),         \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64],
                                                      const uint32_t (&a)[4],
                                                      uint64_t b) {
  if constexpr (std::is_same_v<E, __half>)
    DL4J_WGMMA_M64N128K16_RS_TB("f16");
  else
    DL4J_WGMMA_M64N128K16_RS_TB("bf16");
}

#undef DL4J_WGMMA_M64N64K16_SS
#undef DL4J_WGMMA_M64N64K16_RS_TB
#undef DL4J_WGMMA_M64N128K16_RS_TB

}  // namespace hopper
}  // namespace dl4j
