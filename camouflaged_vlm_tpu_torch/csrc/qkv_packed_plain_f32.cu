// qkv_packed_plain_f32: per head, o = softmax((q*scale) . k^T) . v, no bias,
// all in float32, read straight from the packed qkv projection, written
// d-major.
//
// Replaces flash_qkv_packed_plain of camouflaged_vlm_tpu/ops/flash_attention.py
// (_qkv_packed_plain_kernel, TPU kernel #16) where the JAX package runs it
// in float32: the Alpha-CLIP ViT-L/14@336 vision attention in MaPLe prompt
// training. Input qkv (B, S, 3*H*d), the last axis laid out [q heads | k
// heads | v heads]; output (B, H*d, S) with row stride ldo, the d-major
// layout proj_rows reads (proj_rows_f32.cu reads it as it lies).
//
// Shapes on that path: B = 8, S = 577 + 4 MaPLe prompts = 581, 16 heads, d
// = 64; 24 calls a step. What bounds it on the H100 is the float32 rate of
// the CUDA cores (the tensor cores have no float32 mode): 4 B H S^2 d = 11.1
// GFLOP, 0.166 ms at 67 TFLOP/s, against 57 MB of qkv and 19 MB of output
// (0.023 ms at 3.35 TB/s).
//
// Design: attn_f32.cuh's flash loop with no bias (BIAS_NONE): one block per
// (b * heads + h, query tile of the plan's 128 or 64 rows), 64-key tiles
// through a cp.async ring with the online softmax in fp32, the d-major
// output staged in each warp's q rows and stored along the queries. Dynamic
// shared memory at d = 64: 131,072 B at 128 rows (one block an SM), 81,920
// B at 64 rows with 32-deep k stages (two).
#include "attn_f32.cuh"

// qkv (B, S, 3*heads*d), out (B, heads*d, S) with row stride ldo >= S: fp32.
// d = 64 (CLIP ViT-L/14's) or 80, any S; `tile` the loop's (attn_f32.cuh,
// ops/flash_attention.py f32_attn_plan). Returns a cudaError_t code.
extern "C" int cvlm_qkv_packed_plain_f32(const void* qkv, void* out, int B, int S, int ldo,
                                         int heads, int d, float scale, int tile, void* stream) {
  using namespace cvlm::f32attn;
  AttnArgs a{};
  a.S = S;
  a.heads = heads;
  set_packed(a, static_cast<const float*>(qkv), a.S, heads, d);
  set_dmajor(a, static_cast<float*>(out), heads, d, ldo);
  a.scale = scale;
  return dispatch_attn<BIAS_NONE>(a, d, B, tile, static_cast<cudaStream_t>(stream));
}
