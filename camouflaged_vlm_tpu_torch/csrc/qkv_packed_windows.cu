// qkv_packed_windows: SAM's windowed attention on the padded carry, per
// window and head
//   o = softmax((q*scale) . k^T + rel_h[q, kh] + rel_w[q, kw]) . v,
// read straight from the packed qkv projection, written d-major.
//
// Replaces flash_qkv_packed_windows of camouflaged_vlm_tpu/ops/flash_attention.py
// (_qkv_packed_windows_kernel, #12): the padded window carry (windows of 15
// or 16, which the compact layout cannot take) and the global blocks of at
// most 512 tokens with H + W <= 32: qkv (B, 16, 256, 3840), rel (B, 16, 256,
// 16*32) window-major, out (B, 16, 1280, 256) at ViT-H with window 16; pad
// tokens are ordinary keys (their q/k/v are the qkv bias: LN1's output is
// masked before the projection), as in the JAX kernel. It is attn_rows.cuh's
// whole-score-row kernel (its header says how the bias is built by indexing
// and where it rounds). (The compact carry's interior and edge windows, #13
// and #15, are qkv_packed_windows_s.cu.)
//
// What bounds it on the H100: 256 keys per row make short WMMA pipelines;
// the block's time goes to the shared-memory score round trip and the
// softmax, ~0.2 GFLOP per window-batch of one image (see PERF.md). 256 keys
// take ~68 KB of shared memory per block, three blocks per SM.
#include "attn_rows.cuh"

// qkv (BW, win*win, 3*heads*d), rel (BW, win*win, heads*32) window-major,
// out (BW, heads*d, win*win) with row stride ldo >= win*win: bf16; 2 * win
// <= 32. Returns cudaGetLastError().
extern "C" int cvlm_qkv_packed_windows(const void* qkv, const void* rel, void* out, int BW,
                                       int win, int heads, int d, float scale, int ldo,
                                       void* stream) {
  using namespace cvlm;
  const int S = win * win;
  if (ldo < S) return (int)cudaErrorInvalidValue;
  return dispatch_attn_rows(qkv, rel, out, BW, S, ldo, win, heads, d, scale,
                            static_cast<cudaStream_t>(stream));
}
