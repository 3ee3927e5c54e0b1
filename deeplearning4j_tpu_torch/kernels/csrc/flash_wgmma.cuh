// The tensor-core forms of the resident flash rows 3, 5 and 6, defined in
// csrc/flash_attention_stream.cu and called by the C entries of
// csrc/flash_attention.cu (rows 3, 5) and csrc/flash_attention_bwd.cu
// (row 6) for bf16 at dim 64 or 128: the tile kernels of rows 4 and 7
// (`stream_fwd_wgmma_kernel`, `stream_dq_wgmma_kernel`,
// `stream_dkv_wgmma_kernel`) over their rows schedule, one launch each, no
// visit list and no workspace. Tensors as those entries take them:
// [batch, seq, heads, dim] bf16, contiguous and 16-byte aligned (TMA);
// lse, drow [batch, heads, seq] float32 (lse may be null in the forward).
// Each returns a cudaError_t as an int; any other dim is refused.
#pragma once

namespace dl4j {
namespace flash {

int rows_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int seq, int heads, int dim,
                   int causal, float scale, void* stream);

int rows_dq_wgmma(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* drow,
                  void* dq, int batch, int seq, int heads, int dim,
                  int causal, float scale, void* stream);

int rows_dkv_wgmma(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* drow,
                   void* dk, void* dv, int batch, int seq, int heads,
                   int dim, int causal, float scale, void* stream);

}  // namespace flash
}  // namespace dl4j
