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
// Design: three launches per row panel on the caller's stream.
//   1. ln_rows_f32_kernel, one warp per row: two-pass statistics (mean,
//      then the mean of squared deviations, the JAX formulation), xn =
//      (x - mu) * rstd * gamma + beta into an fp32 scratch;
//   2. fc1, sgemm_kernel<..., EPI_ACT>: h = act(xn . W1^T + b1) into an fp32
//      hidden scratch of `rows` rows (the wrapper's row panels,
//      ops/linear.py mlp_panel_rows, as for the bf16 kernel);
//   3. fc2, sgemm_kernel<..., EPI_RES>: out = h . W2^T + b2 + x.
// The row pass and the GEMM are sgemm_f32.cuh's (both operands K_MAJOR,
// copied as they lie into its 3-stage cp.async ring of 32-deep k tiles),
// each product's tile from the wrapper's ops/linear.py f32_gemm_plan (t1,
// t2). Ragged M and N are zero-filled; K % 4 == 0 and N % 4 == 0 (16-byte
// loads and stores, the wrapper checks).
#include "sgemm_f32.cuh"

// x/out (M, K), w1 (H, K), b1 (H,), w2 (K, H), b2 (K,), gamma/beta (K,): all
// fp32; xn (rows, K) and h (rows, H) fp32 scratch; K % 4 == 0 and H % 4 ==
// 0; t1, s1, n1 and t2, s2, n2 the two GEMMs' tiles, k slices and split
// tails (sgemm_f32.cuh Plan), ws their split-K scratch (the larger's) or
// null. Returns a cudaError_t code.
extern "C" int cvlm_ln_mlp_residual_f32(const void* x, const void* gamma, const void* beta,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* b2, void* out, void* xn, void* h, void* ws,
                                        int M, int K, int H, int rows, float eps, int act, int t1,
                                        int s1, int n1, int t2, int s2, int n2,
                                        void* stream) {
  using namespace cvlm::f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || rows < 1 || K < 4 || K % 4 != 0 || H % 4 != 0) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  auto* op = static_cast<float*>(out);
  auto* xnp = static_cast<float*>(xn);
  auto* hp = static_cast<float*>(h);
  auto* wsp = static_cast<float*>(ws);
  const Plan p1{t1, s1, n1, wsp}, p2{t2, s2, n2, wsp};
  for (int r0 = 0; r0 < M; r0 += rows) {
    const int m = M - r0 < rows ? M - r0 : rows;
    const float* xr = xp + (size_t)r0 * K;
    int err = launch_ln_rows(xr, static_cast<const float*>(gamma),
                             static_cast<const float*>(beta), xnp, nullptr, m, K, eps, s);
    if (!err)
      err = launch_sgemm<K_MAJOR, K_MAJOR, EPI_ACT>(xnp, K, 0, static_cast<const float*>(w1), K,
                                                    static_cast<const float*>(b1), nullptr, hp,
                                                    nullptr, m, H, K, act, p1, 1, s);
    if (!err)
      err = launch_sgemm<K_MAJOR, K_MAJOR, EPI_RES>(hp, H, 0, static_cast<const float*>(w2), H,
                                                    static_cast<const float*>(b2), xr,
                                                    op + (size_t)r0 * K, nullptr, m, K, H,
                                                    cvlm::ACT_NONE, p2, 1, s);
    if (err) return err;
  }
  return 0;
}
