// ln_mlp_residual_bwd_f32: the backward of out = x + act(LN(x) . W1^T + b1)
// . W2^T + b2 at the upstream gradient g, all in float32.
//
// Replaces _ln_mlp_residual_bwd_kernel of camouflaged_vlm_tpu/ops/linear.py
// (the custom_vjp backward of ln_mlp_residual_bt, TPU kernel #6) where the
// JAX package runs it in float32: MaPLe prompt training, whose gradient
// reaches the learned prompts through every Alpha-CLIP block of both
// towers: the vision MLPs, x and g (8, 581, 1024), H 4096, and the text
// MLPs, (14 classes, 77, 768), H 3072; quick_gelu, eps 1e-5; 36 calls a
// step, none with weight gradients (CLIP is frozen).
//
// What it computes, as the bf16 kernel (ln_mlp_residual_bwd.cu) does, with no
// rounding point: xn = LN(x) with each row's (mean, rstd); pre1 = xn . W1^T
// + b1 and dh_pre = g . W2; dh = act'(pre1) * dh_pre; dxn = dh . W1; dx =
// rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) + g with dxhat =
// dxn * gamma.
//
// What bounds it on the H100: three GEMMs of 2 M H K FLOP each on the CUDA
// cores (the tensor cores have no float32 mode): 117 GFLOP at the vision
// site, 1.75 ms at 67 TFLOP/s; 15 GFLOP, 0.23 ms at the text site. The
// fp32 dh reaches device memory (76 MB at the vision site, written twice
// and read twice: ~0.09 ms at 3.35 TB/s), per row panel of ops/linear.py
// mlp_panel_rows as in the forward. Per panel, five launches on
// sgemm_f32.cuh's pieces (its cp.async ring of 32-deep k tiles; W1 and W2
// read MN-major as they lie), each product's tile from ops/linear.py
// f32_gemm_plan:
//   1. ln_rows_f32_kernel: xn (fp32) and each row's (mean, rstd);
//   2. dh_pre = g . W2 (sgemm_kernel<K_MAJOR, MN_MAJOR, EPI_ACT>, W2 (K, H)
//      read as it lies) into the dh scratch;
//   3. pre1 = xn . W1^T + b1 (sgemm_kernel<K_MAJOR, K_MAJOR, EPI_DACT>),
//      whose epilogue reads dh_pre and writes dh = act'(pre1) * dh_pre in
//      its place: the bf16 kernel's dual GEMM as two products, so that
//      neither holds two accumulators (a 128 x 128 tile's are 128 registers
//      a thread);
//   4. dxn = dh . W1 (sgemm_kernel<K_MAJOR, MN_MAJOR, EPI_ACT>, W1 (H, K)
//      read as it lies) into an fp32 (rows, K) scratch;
//   5. ln_bwd_rows_f32_kernel: dx per row from dxn, x, the row's statistics
//      and g.
// Only when a weight, bias or LN parameter needs its gradient, the passes
// keep xn, dh, dxn and the statistics for every row and pass 3 also writes
// act(pre1) (M, H); the wrapper forms the weight side from them with torch
// (dw1 = dh^T . xn, dw2 = g^T . act(pre1) and the column sums, as the JAX
// wrapper leaves its weight products to XLA). No atomics: two runs are
// bit-equal. K % 4 == 0 and H % 4 == 0; the wrapper checks.
#include "sgemm_f32.cuh"

// x/g/dx (M, K), w1 (H, K), b1 (H,), w2 (K, H), gamma/beta (K,): fp32.
// Scratch: xn (R, K), dh (R, H), stats (R,) float2, dxn (R, K), with R = M
// when hact (M, H) is given (the weight side) and R = rows (the panel) when
// not; t1, s1, n1 the tile, k slices and split tail of the H-wide products
// (2, 3), t2, s2, n2 of the K-wide one (4), ws their split-K scratch (the
// larger's) or null.
// Queues five launches per panel (and a split product's second pass);
// returns a cudaError_t code.
extern "C" int cvlm_ln_mlp_residual_bwd_f32(const void* x, const void* gamma, const void* beta,
                                            const void* w1, const void* b1, const void* w2,
                                            const void* g, void* dx, void* xn, void* dh,
                                            void* stats, void* dxn, void* hact, void* ws, int M,
                                            int K, int H, int rows, float eps, int act, int t1,
                                            int s1, int n1, int t2, int s2, int n2,
                                            void* stream) {
  using namespace cvlm::f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || rows < 1 || K < 4 || K % 4 != 0 || H < 4 || H % 4 != 0 ||
      act < cvlm::ACT_NONE || act > cvlm::ACT_QUICK_GELU)
    return (int)cudaErrorInvalidValue;
  const bool weights = hact != nullptr;
  const auto* xp = static_cast<const float*>(x);
  const auto* gp = static_cast<const float*>(g);
  const auto* ga = static_cast<const float*>(gamma);
  const auto* w1p = static_cast<const float*>(w1);
  const auto* w2p = static_cast<const float*>(w2);
  auto* wsp = static_cast<float*>(ws);
  const Plan p1{t1, s1, n1, wsp}, p2{t2, s2, n2, wsp};
  for (int r0 = 0; r0 < M; r0 += rows) {
    const int m = M - r0 < rows ? M - r0 : rows;
    const size_t rw = weights ? r0 : 0;  // the scratch row that holds the panel's first
    float* xnp = static_cast<float*>(xn) + rw * K;
    float* dhp = static_cast<float*>(dh) + rw * H;
    float* dxnp = static_cast<float*>(dxn) + rw * K;
    float2* st = static_cast<float2*>(stats) + rw;
    float* hp = weights ? static_cast<float*>(hact) + (size_t)r0 * H : nullptr;
    const float* xr = xp + (size_t)r0 * K;
    const float* gr = gp + (size_t)r0 * K;
    int err = launch_ln_rows(xr, ga, static_cast<const float*>(beta), xnp, st, m, K, eps, s);
    if (!err)  // dh_pre = g . W2
      err = launch_sgemm<K_MAJOR, MN_MAJOR, EPI_ACT>(gr, K, 0, w2p, H, nullptr, nullptr, dhp,
                                                     nullptr, m, H, K, cvlm::ACT_NONE, p1, 1,
                                                     s);
    if (!err)  // dh = act'(xn . W1^T + b1) * dh_pre, in place
      err = launch_sgemm<K_MAJOR, K_MAJOR, EPI_DACT>(xnp, K, 0, w1p, K,
                                                     static_cast<const float*>(b1), dhp, dhp, hp,
                                                     m, H, K, act, p1, 1, s);
    if (!err)  // dxn = dh . W1
      err = launch_sgemm<K_MAJOR, MN_MAJOR, EPI_ACT>(dhp, H, 0, w1p, K, nullptr, nullptr, dxnp,
                                                     nullptr, m, K, H, cvlm::ACT_NONE, p2, 1,
                                                     s);
    if (!err)
      err = launch_ln_bwd_rows(xr, gr, ga, st, dxnp, static_cast<float*>(dx) + (size_t)r0 * K, m,
                               K, s);
    if (err) return err;
  }
  return 0;
}
