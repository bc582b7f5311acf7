// qkv_packed_global_f32: SAM's global attention in float32, per (image,
// head), o = softmax((q*scale) . k^T + rel_h[q, k // W] + rel_w[q, k % W]) .
// v over all H * W tokens, read straight from the packed qkv projection and
// written d-major.
//
// Replaces flash_qkv_packed_global of camouflaged_vlm_tpu/ops/flash_attention.py
// (_qkv_packed_global_kernel, TPU kernel #17) where the JAX package runs it
// in float32 (--dtype float32): the 4 global ViT-H blocks of the reference
// configuration. qkv (B, 4096, 3840) on the 64 x 64 grid, rel (4096, B, 16,
// 128) position-major [rel_h | rel_w], out (B, 1280, 4096) with the row
// stride proj_rows_f32 reads.
//
// What bounds it on the H100: the float32 rate of the CUDA cores (the
// tensor cores have no float32 mode): 4 B heads N^2 d = 85.9 GFLOP a block
// an image, 1.28 ms at 67 TFLOP/s, against 117 MB of qkv, rel and output
// (0.035 ms at 3.35 TB/s).
//
// Design: attn_f32.cuh's flash loop with the separable bias (BIAS_SEP): keys
// streamed in 64-key tiles with the online softmax, the query tile's H + W
// rel lanes held in shared memory (128 (H + W) floats at 128 rows: 64 KB at
// H + W = 128, 221,184 B a block) and each score's two lanes gathered from
// there. The shared memory bounds H + W: at most MAX_LANES, which the
// smallest tile (64 rows, 32-deep k stages: 92 KB beside the rel rows at d
// = 80) holds within the 227 KB a block can have.
#include "attn_f32.cuh"

namespace {
constexpr int MAX_LANES = 512;  // ops/flash_attention.py F32_GLOBAL_MAX_LANES
}

// qkv (B, N, 3*heads*d), rel (N, B, heads, H+W), out (B, heads*d, N) with
// row stride ldo >= N: fp32; N = H * W, H + W <= 512, d in {64, 80}.
// `tile` the loop's. Returns a cudaError_t code.
extern "C" int cvlm_qkv_packed_global_f32(const void* qkv, const void* rel, void* out, int B,
                                          int N, int ldo, int H, int W, int heads, int d,
                                          float scale, int tile, void* stream) {
  using namespace cvlm::f32attn;
  if (H < 1 || W < 1 || H * W != N || H + W > MAX_LANES) return (int)cudaErrorInvalidValue;
  AttnArgs a{};
  a.S = N;
  a.heads = heads;
  set_packed(a, static_cast<const float*>(qkv), a.S, heads, d);
  set_dmajor(a, static_cast<float*>(out), heads, d, ldo);
  a.scale = scale;
  a.rel = static_cast<const float*>(rel);
  a.lph = H + W;
  a.rp = (long long)heads * (H + W);
  a.rq = (long long)B * a.rp;
  a.H = H;
  a.W = W;
  return dispatch_attn<BIAS_SEP>(a, d, B, tile, static_cast<cudaStream_t>(stream));
}
