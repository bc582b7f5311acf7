// attn_fullk_f32: softmax(q' . k'^T) . v per problem in float32, over split
// q', k' (BB, N, d_qk) and v (BB, N, dv), written (BB, N, dv).
//
// Replaces flash_attention_fullk of camouflaged_vlm_tpu/ops/flash_attention.py
// (_fullk_kernel, TPU kernel #20) where the JAX package runs it in float32
// (--dtype float32): SAM's 'aug_flash' global blocks, whose rel-pos bias
// rides the augmented features (ops/aug_attention.py: q' = [q * scale |
// rel_h | rel_w], k' = [k | onehot(k // W) | onehot(k % W)], zero-padded to
// a multiple of 16), so q' arrives scaled (scale 1 here). At ViT-H's 1024 px
// BB = 16 heads x B, N = 4096, d_qk = 80 + 64 + 64 = 208, dv = 80; the small
// 'aug_flash' cascade of chip_smoke.py's [f32_train_small] runs d_qk = 64 +
// 32 + 32 = 128, dv = 64. No other width is instantiated.
//
// What bounds it on the H100: the float32 rate of the CUDA cores (the
// tensor cores have no float32 mode): 2 BB N^2 (d_qk + dv) = 309 GFLOP at
// batch 2, 4.61 ms at 67 TFLOP/s, against 302 MB of q', k', v and output
// (0.090 ms at 3.35 TB/s).
//
// Design: attn_f32.cuh's flash loop with no bias (BIAS_NONE), the score
// product over DQK = d_qk columns and P . V over DV = dv, rows out. At 208
// the plan's tile is 128 q' rows (8 warps) with k' streamed through a
// 3-stage ring of 32-deep stages (7 steps a key tile, the last 16 deep):
// 128 x 208 + 3 x 64 x 32 + 2 x 64 x 80 + 128 x 64 floats = 204,800 B, one
// block an SM (cvlm_attn_f32_smem reports every instance's).
#include "attn_f32.cuh"

using namespace cvlm::f32attn;

// q', k' (P, S, dqk), v (P, S, dv), out (P, S, dv) at the element strides of
// `layout` (attn_f32.cuh AttnArgs; ops/flash_attention.py f32_split_layout):
// fp32; (dqk, dv) = (208, 80) or (128, 64); `tile` the loop's. Returns a
// cudaError_t code.
extern "C" int cvlm_attn_fullk_f32(const void* q, const void* k, const void* v, void* out,
                                   const long long* layout, int P, int S, int dqk, int dv,
                                   int tile, void* stream) {
  AttnArgs a{};
  set_layout(a, layout);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.S = S;
  a.heads = 1;
  a.scale = 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dqk == 208 && dv == 80) return launch_attn<208, 80, BIAS_NONE, OUT_ROWS>(a, P, tile, st);
  if (dqk == 128 && dv == 64) return launch_attn<128, 64, BIAS_NONE, OUT_ROWS>(a, P, tile, st);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory (bytes) of a block of attn_f32.cuh's loop at
// (dqk, dv), bias mode (0 none, 1 separable, 2 edge), tile and rel lanes,
// as the launches size it; -1 where no tile or depth takes them.
extern "C" long long cvlm_attn_f32_smem(int dqk, int dv, int bias, int tile, int lanes) {
  return smem_bytes(dqk, dv, bias, tile, lanes);
}
