// qkv_packed_windows / qkv_packed_edge: SAM's windowed attention on the
// padded carry and the compact carry's edge windows, per window and head
//   o = softmax((q*scale) . k^T + rel_h[q, kh] + rel_w[q, kw]) . v,
// read straight from the packed qkv projection, written d-major.
//
// Replaces two TPU kernels of camouflaged_vlm_tpu/ops/flash_attention.py:
//   flash_qkv_packed_windows (_qkv_packed_windows_kernel) -- the padded
//     window carry (windows of 15 or 16, which the compact layout cannot
//     take) and the global blocks of at most 512 tokens with H + W <= 32:
//     qkv (B, 16, 256, 3840), rel (B, 16, 256, 16*32) window-major, out
//     (B, 16, 1280, 256) at ViT-H with window 16; pad tokens are ordinary
//     keys (their q/k/v are the qkv bias: LN1's output is masked before the
//     projection), as in the JAX kernel;
//   flash_qkv_packed_edge (_qkv_packed_edge_kernel) -- the 9 edge windows
//     (4 right of 14 x 8 tokens, 4 bottom of 8 x 14, the corner of 8 x 8
//     with 48 dummy rows): qkv (B, 9, 112, 3840), rel (B, 9, 112, 16*32)
//     with the virtual pad key's logit in lane 28, vb (16, 80), kmask
//     (9, 1, 112), out (B, 9, 1280, 112).
// Both are attn_rows.cuh's whole-score-row kernel (its header says how the
// bias is built by indexing and where it rounds). The windows take each
// key's (kh, kw) from the window side; the edges take them from their
// window's column of `sel`, so a key's kh/kw follow its group's (nr, nc)
// grid, and add the 0 / -1e30 of `kmask`, as the JAX `ref` does
// (flash_attention.py:781-807). The virtual pad key joins the row max and
// the row sum and adds (pp / l) * vb in fp32. (The compact carry's interior
// windows, #13, are qkv_packed_windows_s.cu.)
//
// What bounds it on the H100: 256 (112) keys per row make short WMMA
// pipelines; the block's time goes to the shared-memory score round trip and
// the softmax, ~0.2 GFLOP per window-batch of one image (see PERF.md). 256
// keys take ~68 KB of shared memory per block, three blocks per SM.
#include "attn_rows.cuh"

// qkv (BW, win*win, 3*heads*d), rel (BW, win*win, heads*32) window-major,
// out (BW, heads*d, win*win): bf16; 2 * win <= 32. Returns
// cudaGetLastError().
extern "C" int cvlm_qkv_packed_windows(const void* qkv, const void* rel, void* out, int BW,
                                       int win, int heads, int d, float scale, void* stream) {
  using namespace cvlm;
  const int S = win * win;
  const size_t lanes = (size_t)heads * REL_LANES;
  const RowsBias rb{static_cast<const bf16*>(rel), lanes, (size_t)S * lanes, nullptr, nullptr,
                    nullptr, win, 1};
  return dispatch_attn_rows<ROWS_WINDOWS>(qkv, out, BW, S, heads, d, scale, rb,
                                          static_cast<cudaStream_t>(stream));
}

// qkv (B, n, R, 3*heads*d), rel (B, n, R, heads*32), sel (n, 32, R), vb
// (heads, d), out (B, n, heads*d, R): bf16; kmask (n, 1, R) fp32. Returns
// cudaGetLastError().
extern "C" int cvlm_qkv_packed_edge(const void* qkv, const void* rel, const void* sel,
                                    const void* vb, const void* kmask, void* out, int B,
                                    int n, int R, int heads, int d, float scale,
                                    void* stream) {
  using namespace cvlm;
  const size_t lanes = (size_t)heads * REL_LANES;
  const RowsBias rb{static_cast<const bf16*>(rel), lanes, (size_t)R * lanes,
                    static_cast<const bf16*>(sel), static_cast<const bf16*>(vb),
                    static_cast<const float*>(kmask), 0, n};
  return dispatch_attn_rows<ROWS_EDGE>(qkv, out, B * n, R, heads, d, scale, rb,
                                       static_cast<cudaStream_t>(stream));
}
