// qkv_windows_f32: SAM's windowed attention in float32, per (window, head),
// read straight from the packed qkv projection and written d-major:
//   interior  o = softmax((q*scale) . k^T + rel[q, k / win]
//                          + rel[q, win + k % win]) . v
//   edge      the same with each key's bias rel @ sel from its window's 0/1
//             column of `sel`, the dummy keys' -1e30 of `kmask`, and a
//             virtual pad key of logit rel[q, 28] and value vb.
//
// Replaces two TPU kernels of camouflaged_vlm_tpu/ops/flash_attention.py
// where the JAX package runs them in float32 (--dtype float32, the
// reference's own numerics):
//   flash_qkv_packed_windows_s (_qkv_packed_windows_s_kernel, #13): the 28
//     windowed ViT-H blocks' 16 interior 14 x 14 windows an image: qkv
//     (BW, 196, 3840) with BW = 16 B, rel_s (196, BW, 16 * 32)
//     position-major, lanes [rel_h(14) | rel_w(14) | 0], out (BW, 1280,
//     196).
//   flash_qkv_packed_edge (_qkv_packed_edge_kernel, #15): the same blocks'
//     9 edge windows of R = 112 uniform rows an image: qkv (B, 9, 112,
//     3840), rel (B, 9, 112, 16 * 32) window-major with the pad key's logit
//     in lane 28, sel (9, 32, 112), kmask (9, 1, 112), vb (16, 80), out (B,
//     9, 1280, 112).
// and a third where the JAX package runs it in float32:
//   flash_qkv_packed_windows (_qkv_packed_windows_kernel, #12): the padded
//     window carry of fused 'flash' at windows 15 and 16 (ViT-H at window 16:
//     28 blocks, 16 windows of 256 tokens an image, pad tokens ordinary
//     keys, as SAM's reference attends to the zero pad) and global blocks of
//     <= 512 tokens with H + W <= 32: qkv (B, nwin, 256, 3840), rel (B, nwin,
//     256, 16 * 32) window-major, out (B, nwin, 1280, 256).
// The outputs go to proj_rows_f32 with the row stride the wrapper gives.
//
// What bounds it on the H100: the float32 rate of the CUDA cores (the
// tensor cores have no float32 mode). #13: 4 BW heads 196^2 80 = 3.1 GFLOP
// an image, 0.047 ms at 67 TFLOP/s, against 70 MB of qkv, rel and output
// (0.021 ms at 3.35 TB/s); #15: 4 B 9 heads 112^2 80 = 0.58 GFLOP an image,
// and 0.12 more for its bias, the depth-32 product rel @ sel; #12 at window
// 16: 4 B nwin heads 256^2 80 = 5.4 GFLOP an image, 0.080 ms.
//
// Design: attn_f32.cuh's flash loop at the plan's tile, 64-key tiles (win
// 14: 196 = 3 x 64 + 4 keys, the last tile ragged; 128 or 64 query rows a
// block). #13 takes the separable bias
// (BIAS_SEP, H = W = win): each query tile's 2 win rel lanes in shared
// memory, each score's two lanes gathered from there. #15 (BIAS_EDGE)
// extends the score product by the 32 rel lanes of the query against the
// key's column of sel (so S = q k^T + rel @ sel in one fp32 chain), adds
// kmask, and starts each row's running max, sum and output at the pad key
// (m = its logit, l = 1, o = vb), as the JAX ref takes it into the max
// before any exp. #12 is #13's instance with rel's window-major strides and
// the loop's strides handed in by the wrapper (`layout`). Dynamic shared
// memory at d = 80 (attn_f32.cuh's table): 169,984 B (#13 at win 14, 128 rows)
// and 188,416 B (#15, 128 rows), less at 64 rows.
#include "attn_f32.cuh"

// qkv (BW, win^2, 3*heads*d), rel (win^2, BW, heads*32) position-major, out
// (BW, heads*d, win^2) with row stride ldo: fp32; 2 win <= 32, d in {64,
// 80}; `tile` the loop's. Returns a cudaError_t code.
extern "C" int cvlm_qkv_packed_windows_s_f32(const void* qkv, const void* rel, void* out, int BW,
                                             int win, int heads, int d, float scale, int ldo,
                                             int tile, void* stream) {
  using namespace cvlm::f32attn;
  if (win < 1 || 2 * win > EDGE_LANES) return (int)cudaErrorInvalidValue;
  AttnArgs a{};
  a.S = win * win;
  a.heads = heads;
  set_packed(a, static_cast<const float*>(qkv), a.S, heads, d);
  set_dmajor(a, static_cast<float*>(out), heads, d, ldo);
  a.scale = scale;
  a.rel = static_cast<const float*>(rel);
  a.lph = EDGE_LANES;
  a.rp = (long long)heads * EDGE_LANES;
  a.rq = (long long)BW * a.rp;
  a.H = a.W = win;
  return dispatch_attn<BIAS_SEP>(a, d, BW, tile, static_cast<cudaStream_t>(stream));
}

// qkv (B, n, R, 3*heads*d), rel (B, n, R, heads*32) window-major, sel (n,
// 32, R), vb (heads, d), kmask (n, 1, R), out (B, n, heads*d, R) with row
// stride ldo >= R: fp32; d in {64, 80}, any R; `tile` the loop's. Returns a
// cudaError_t code.
extern "C" int cvlm_qkv_packed_edge_f32(const void* qkv, const void* rel, const void* sel,
                                        const void* vb, const void* kmask, void* out, int B,
                                        int n, int R, int heads, int d, float scale, int ldo,
                                        int tile, void* stream) {
  using namespace cvlm::f32attn;
  if (n < 1) return (int)cudaErrorInvalidValue;
  AttnArgs a{};
  a.S = R;
  a.heads = heads;
  set_packed(a, static_cast<const float*>(qkv), a.S, heads, d);
  set_dmajor(a, static_cast<float*>(out), heads, d, ldo);
  a.scale = scale;
  a.rel = static_cast<const float*>(rel);
  a.lph = EDGE_LANES;
  a.rq = (long long)heads * EDGE_LANES;
  a.rp = (long long)R * a.rq;
  a.sel = static_cast<const float*>(sel);
  a.kmask = static_cast<const float*>(kmask);
  a.vb = static_cast<const float*>(vb);
  a.n = n;
  return dispatch_attn<BIAS_EDGE>(a, d, B * n, tile, static_cast<cudaStream_t>(stream));
}

// q, k, v (P problems of heads heads, win^2 tokens, d), rel (win^2 lanes of
// 32 a head, window-major), out d-major, at the element strides of `layout`
// (attn_f32.cuh AttnArgs; ops/flash_attention.py f32_packed_layout): fp32;
// 2 win <= 32, d in {64, 80}; `tile` the loop's. Returns a cudaError_t code.
extern "C" int cvlm_qkv_packed_windows_f32(const void* q, const void* k, const void* v,
                                           const void* rel, void* out, const long long* layout,
                                           int P, int heads, int win, int d, float scale,
                                           int tile, void* stream) {
  using namespace cvlm::f32attn;
  if (win < 1 || 2 * win > EDGE_LANES) return (int)cudaErrorInvalidValue;
  AttnArgs a{};
  set_layout(a, layout);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.S = win * win;
  a.heads = heads;
  a.scale = scale;
  a.rel = static_cast<const float*>(rel);
  a.H = a.W = win;
  return dispatch_attn<BIAS_SEP>(a, d, P, tile, static_cast<cudaStream_t>(stream));
}
