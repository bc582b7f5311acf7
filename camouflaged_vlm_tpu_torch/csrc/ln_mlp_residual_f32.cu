// ln_mlp_residual_f32: out = x + act(LN(x) . W1^T + b1) . W2^T + b2, all in
// float32.
//
// Replaces ln_mlp_residual_bt of camouflaged_vlm_tpu/ops/linear.py (the
// hidden-grid TPU kernel #4 and the single-chunk one #5, which compute the
// same function) where the JAX package runs it in float32: the CLIP text
// tower of `precompute_text_bank` (`AlphaClipConfig.vit_l_14_336()`, whose
// dtype is float32). At float32 the TPU kernel has no rounding point: its
// LN rows and hidden are float32 (linear.py:346-364), so neither is here.
//
// Shapes on that path: x (prompts * 77, 768) per class (camoprompts 6
// prompts: 462 rows; imagenet80: 6160), H 3072, quick_gelu, eps 1e-5. What
// bounds it on the H100 is the float32 rate of the CUDA cores (67 TFLOP/s,
// the tensor cores have no float32 mode; TF32 keeps ~3 digits and is not
// used): at 462 rows 4.36 GFLOP, 0.065 ms, against 23 MB of input, weights
// and output (0.007 ms at 3.35 TB/s).
//
// Design: on the caller's stream, on one of two paths (the wrapper's plans,
// ops/linear.py f32_mlp_plans), per row panel:
//   path 0 (K-major fragments):
//     1. ln_rows_f32_kernel, one warp per row: two-pass statistics (mean,
//        then the mean of squared deviations, the JAX formulation), xn =
//        (x - mu) * rstd * gamma + beta into an fp32 scratch (rows, K);
//     2. fc1, sgemm_kernel<K_MAJOR, K_MAJOR, EPI_ACT>: h = act(xn . W1^T +
//        b1) into an fp32 hidden scratch (rows, H);
//     3. fc2, sgemm_kernel<K_MAJOR, K_MAJOR, EPI_RES>: out = h . W2^T + b2 + x;
//   path 1 (MN fragments): W1^T and W2^T into a scratch once a call
//     (transpose_f32_kernel), then per panel the same three with both
//     scratches MN-major, ld = rows rounded up to 4: ln_rows_t_f32_kernel
//     writes xn (K, ld); fc1, sgemm_kernel<MN_MAJOR, MN_MAJOR, EPI_ACT_T>,
//     writes h (H, ld), four rows of a column in one 16-byte store; fc2,
//     sgemm_kernel<MN_MAJOR, MN_MAJOR, EPI_RES>, reads it as its A.
// `rows` is the wrapper's row panel (ops/linear.py mlp_panel_rows, as for
// the bf16 kernel), each product's tile from its plan (t1, t2). Both paths
// sum each output over k in order: they are bit-equal. Ragged M and N are
// zero-filled; K % 4 == 0 and N % 4 == 0 (16-byte loads and stores, the
// wrapper checks).
#include "sgemm_f32.cuh"

// x/out (M, K), w1 (H, K), b1 (H,), w2 (K, H), b2 (K,), gamma/beta (K,): all
// fp32; xn and h fp32 scratch of rows K and rows H floats (path 0) or K
// mn_ld(rows) and H mn_ld(rows) (path 1); wt one of 2 H K floats (path 1,
// W1^T then W2^T; else null); K % 4 == 0 and H % 4 == 0; residual 1 adds x
// in fc2's epilogue, 0 not (a tensor-parallel rank's partial); t1, s1, n1 and t2,
// s2, n2 the two GEMMs' tiles, k slices and split tails (sgemm_f32.cuh
// Plan), ws their split-K scratch (the larger's) or null, path their
// layouts. Returns a cudaError_t code.
extern "C" int cvlm_ln_mlp_residual_f32(const void* x, const void* gamma, const void* beta,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* b2, void* out, void* xn, void* h, void* ws,
                                        void* wt, int M, int K, int H, int rows, float eps,
                                        int act, int residual, int t1, int s1, int n1, int t2,
                                        int s2, int n2, int path, void* stream) {
  using namespace cvlm::f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || rows < 1 || K < 4 || K % 4 != 0 || H % 4 != 0 || path < 0 || path > 1 ||
      (path == 1 && wt == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  const auto* b1p = static_cast<const float*>(b1);
  const auto* b2p = static_cast<const float*>(b2);
  const auto* w1p = static_cast<const float*>(w1);
  const auto* w2p = static_cast<const float*>(w2);
  auto* op = static_cast<float*>(out);
  auto* xnp = static_cast<float*>(xn);
  auto* hp = static_cast<float*>(h);
  auto* w1t = static_cast<float*>(wt);
  auto* w2t = w1t + (size_t)H * K;
  const Plan p1{t1, s1, n1, static_cast<float*>(ws)}, p2{t2, s2, n2, static_cast<float*>(ws)};
  const int ld = mn_ld(rows);
  if (path == 1) {
    int err = launch_transpose(w1p, w1t, H, K, s);
    if (!err) err = launch_transpose(w2p, w2t, K, H, s);
    if (err) return err;
  }
  for (int r0 = 0; r0 < M; r0 += rows) {
    const int m = M - r0 < rows ? M - r0 : rows;
    const float* xr = xp + (size_t)r0 * K;
    const float* res = residual ? xr : nullptr;  // EPI_RES adds a null res as 0
    float* orow = op + (size_t)r0 * K;
    int err;
    if (path == 0) {
      err = launch_ln_rows(xr, g, be, xnp, nullptr, m, K, eps, s);
      if (!err)
        err = launch_sgemm<K_MAJOR, K_MAJOR, EPI_ACT>(xnp, K, 0, w1p, K, b1p, nullptr, hp,
                                                      nullptr, m, H, K, act, p1, 1, s);
      if (!err)
        err = launch_sgemm<K_MAJOR, K_MAJOR, EPI_RES>(hp, H, 0, w2p, H, b2p, res, orow, nullptr,
                                                      m, K, H, cvlm::ACT_NONE, p2, 1, s);
    } else {  // the panel's scratches at the full panel's ld
      err = launch_ln_rows_t(xr, g, be, xnp, nullptr, m, K, ld, eps, s);
      if (!err)
        err = launch_sgemm<MN_MAJOR, MN_MAJOR, EPI_ACT_T>(xnp, ld, 0, w1t, H, b1p, nullptr, hp,
                                                          nullptr, m, H, K, act, p1, 1, s, 0, 0,
                                                          ld);
      if (!err)
        err = launch_sgemm<MN_MAJOR, MN_MAJOR, EPI_RES>(hp, ld, 0, w2t, K, b2p, res, orow,
                                                        nullptr, m, K, H, cvlm::ACT_NONE, p2, 1,
                                                        s);
    }
    if (err) return err;
  }
  return 0;
}
