// qkv_relpos_f32: SAM's attention with the decomposed rel-pos bias of H + W
// lanes a head in float32, per (problem, head)
//   o = softmax((q*scale) . k^T + rel[q, k / W] + rel[q, H + k % W]) . v,
// over the packed qkv rows or over split q, k and v, written in rows.
//
// Replaces three TPU kernels of camouflaged_vlm_tpu/ops/flash_attention.py
// where the JAX package runs them in float32 (--dtype float32):
//   flash_attention_relpos (_relpos_kernel, #10) -- SAM's unfused 'flash'
//     attention (num_heads % 8 != 0: ViT-B's 12 heads x 64): q, k, v (BB,
//     N, d) apart, q pre-scaled (scale 1 here), rel (BB, N, H + W), out (BB,
//     N, d); at batch 2 the windowed blocks' BB = 600 (25 padded 14 x 14
//     windows x 12 heads x 2 images, 28 lanes) and the global blocks' BB =
//     24 over the 64 x 64 grid (128 lanes);
//   flash_qkv_relpos_windows (_qkv_relpos_windows_kernel, #11) -- fused
//     'flash' windows whose H + W exceeds 32 lanes (the padded carry at a
//     window of 17 or more, and global blocks of <= 512 tokens with H + W >
//     32): at ViT-H with window 17 qkv (B, 16, 289, 48, 80), rel (B, 16, 289,
//     16, 34), out head-leading (B, 16, 16, 289, 80), which proj_rows_f32.cu's
//     cvlm_proj_from_heads_f32 reads;
//   flash_qkv_relpos_global (_qkv_relpos_global_kernel, #19) -- #11 over one
//     window (nwin = 1), which no path of either package calls: at ViT-H's 64
//     x 64 grid qkv (B, 4096, 48, 80), rel (B, 4096, 16, 128), out (B, 16,
//     4096, 80).
//
// What bounds it on the H100: the float32 rate of the CUDA cores (the
// tensor cores have no float32 mode), 4 problems heads N^2 d FLOP at 67
// TFLOP/s. At batch 2: #10's global blocks 103 GFLOP (1.54 ms), its windows
// 5.9 GFLOP (0.088 ms); #11 13.7 GFLOP (0.204 ms); #19 172 GFLOP (2.56 ms).
// The bytes (qkv, rel, out once: 210 MB at window 17) take 0.063 ms at
// 3.35 TB/s.
//
// Design: attn_f32.cuh's flash loop with the separable bias (BIAS_SEP), the
// query tile's H + W rel lanes (34 at window 17: head h 8 bytes off a
// 16-byte boundary, so read one float at a time) in shared memory, each
// score's two lanes gathered from there; 64-key tiles with the online
// softmax (289 = 4 x 64 + 33 and 196 = 3 x 64 + 4: the ragged last tile's
// keys masked to -inf). The three front ends differ only in the strides the
// wrapper hands in (`layout`, ops/flash_attention.py f32_split_layout and
// f32_packed_layout): split rows with one head a problem, or the packed
// qkv rows with the (batch, window) pairs as problems; the output is stored
// from the registers in rows. Dynamic shared memory at d = 80, 128 query
// rows: 152 KB of tiles, plus 128 (H + W) floats of rel rows (17 KB at
// window 17, 64 KB at H + W = 128).
#include "attn_f32.cuh"

namespace {
constexpr int MAX_LANES = 512;  // ops/flash_attention.py F32_GLOBAL_MAX_LANES
}

// q, k, v (P problems of heads heads, S = H * W tokens, d), rel (P, S,
// heads, H + W) or its strides, out in rows, at the element strides of
// `layout` (attn_f32.cuh AttnArgs): fp32; H + W <= 512, d in {64, 80};
// `tile` the loop's. Returns a cudaError_t code.
extern "C" int cvlm_attn_relpos_f32(const void* q, const void* k, const void* v,
                                    const void* rel, void* out, const long long* layout, int P,
                                    int heads, int H, int W, int d, float scale, int tile,
                                    void* stream) {
  using namespace cvlm::f32attn;
  if (H < 1 || W < 1 || H + W > MAX_LANES) return (int)cudaErrorInvalidValue;
  AttnArgs a{};
  set_layout(a, layout);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.S = H * W;
  a.heads = heads;
  a.scale = scale;
  a.rel = static_cast<const float*>(rel);
  a.H = H;
  a.W = W;
  return dispatch_attn<BIAS_SEP, OUT_ROWS>(a, d, P, tile, static_cast<cudaStream_t>(stream));
}
