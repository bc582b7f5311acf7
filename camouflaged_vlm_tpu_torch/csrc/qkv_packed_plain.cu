// qkv_packed_plain: per head, o = softmax((q*scale) . k^T) . v, no bias,
// read straight from the packed qkv projection, written d-major.
//
// Replaces flash_qkv_packed_plain of camouflaged_vlm_tpu/ops/flash_attention.py
// (_qkv_packed_plain_kernel): CLIP vision attention. Input qkv (B, S, 3*H*d)
// with the last axis laid out [q heads | k heads | v heads]; output
// (B, H*d, S), the d-major layout proj_rows reads.
//
// Shapes on the main path (bf16): S = 577 + 4 VPT = 581, 16 heads, d = 64.
// The kernel is attn_rows.cuh's whole-score-row kernel without a bias: one
// block owns 32 queries of one head and holds their score rows (32 x 640
// fp32) in shared memory, so the softmax is the exact two-pass one of the
// JAX reference (max-subtracted, divided by the row sum, the normalised
// probabilities rounded to bf16 before P.V, flash_attention.py:901); q*scale
// is rounded to bf16 first (flash_attention.py:858). The TPU kernel's
// constant-shift softmax is not carried over.
//
// What bounds it on the H100: ~0.6 GFLOP per image at 16 heads, spread over
// 19 x 16 x B blocks of 4 warps; the score matrix round trip through shared
// memory and the per-tile synchronisation dominate, not the tensor cores.
// An online-softmax (flash) version with wgmma is later work.
#include "attn_rows.cuh"

// qkv (B, S, 3*heads*d), out (B, heads*d, S): bf16. d in {16, 32, 64, 80,
// 128}; the wrapper checks d and the shared-memory size. Returns
// cudaGetLastError().
extern "C" int cvlm_qkv_packed_plain(const void* qkv, void* out, int B, int S,
                                     int heads, int d, float scale, void* stream) {
  using namespace cvlm;
  const RowsBias none{nullptr, 0, 0, nullptr, nullptr, nullptr, 0, 1};
  return dispatch_attn_rows<ROWS_PLAIN>(qkv, out, B, S, heads, d, scale, none,
                                        static_cast<cudaStream_t>(stream));
}
