// qkv_relpos: per window and head, o = softmax((q*scale) . k^T + rel_h[q, k / W]
// + rel_w[q, H + k % W]) . v, read in place from the packed qkv projection,
// written head-leading.
//
// Replaces two TPU kernels of camouflaged_vlm_tpu/ops/flash_attention.py:
//   flash_qkv_relpos_windows (_qkv_relpos_windows_kernel, #11) -- SAM's
//     fused 'flash' windows whose H + W exceeds the 32 rel lanes of the
//     packed kernels (a window of 17 or more, in the padded window carry),
//     and the global blocks of at most 512 tokens with H + W > 32: at ViT-H
//     with window 17, qkv (B, 16, 289, 48, 80), rel (B, 16, 289, 16, 34),
//     out (B, 16, 16, 289, 80);
//   flash_qkv_relpos_global (_qkv_relpos_global_kernel, #19) -- the same
//     function over one window of N tokens (nwin = 1, queries tiled): qkv
//     (B, N, 3*heads, d), rel (B, N, heads, H+W), out (B, heads, N, d). No
//     path of either package calls it; its JAX test does.
// The head-leading output is what proj_from_heads (proj_rows.cu) reads.
//
// The kernel is attn_split.cuh's two-pass one (see its note on rounding):
// one problem per (b, window, head), its q, k and v rows strided views of the
// packed rows (stride 3*heads*d, head offset h*d), q scaled and rounded to
// bf16 at its tile load. 289 keys are five 64-key tiles, the last ragged.
//
// What bounds it on the H100: at window 17 and batch 2, ~14 GFLOP and ~105 MB
// (bytes-bound, ~31 us at 3.35 TB/s); the kernel recomputes the scores in
// its second pass and stages tiles through shared memory without pipelining.
#include "attn_split.cuh"

// qkv (B, nwin, N, 3*heads*d), rel (B, nwin, N, heads*(H+W)), out (B, heads,
// nwin, N, d): bf16; N == H * W; d in {64, 80}. Returns cudaGetLastError().
extern "C" int cvlm_qkv_relpos(const void* qkv, const void* rel, void* out, int B, int nwin,
                               int H, int W, int heads, int d, float scale, void* stream) {
  using namespace cvlm;
  const int N = H * W, hw = H + W;
  const size_t C3 = (size_t)3 * heads * d;
  const bf16* base = static_cast<const bf16*>(qkv);
  SplitArgs a{};
  a.q = base;
  a.k = base + (size_t)heads * d;
  a.v = base + (size_t)2 * heads * d;
  a.rel = static_cast<const bf16*>(rel);
  a.out = static_cast<bf16*>(out);
  a.qk = {(size_t)nwin * N * C3, (size_t)N * C3, (size_t)d, C3};
  a.vs = a.qk;
  a.rs = {(size_t)nwin * N * heads * hw, (size_t)N * heads * hw, (size_t)hw,
          (size_t)heads * hw};
  a.os = {(size_t)heads * nwin * N * d, (size_t)N * d, (size_t)nwin * N * d, (size_t)d};
  a.heads = heads;
  a.nwin = nwin;
  a.N = N;
  a.H = H;
  a.W = W;
  a.dqk = d;
  a.scale = scale;
  return dispatch_split<true>(a, B * nwin * heads, d, static_cast<cudaStream_t>(stream));
}
