// ln_mlp_residual_bwd_f32: the backward of out = x + act(LN(x) . W1^T + b1)
// . W2^T + b2 at the upstream gradient g, all in float32.
//
// Replaces _ln_mlp_residual_bwd_kernel of camouflaged_vlm_tpu/ops/linear.py
// (the custom_vjp backward of ln_mlp_residual_bt, TPU kernel #6) where the
// JAX package runs it in float32: MaPLe prompt training, whose gradient
// reaches the learned prompts through every Alpha-CLIP block of both
// towers: the vision MLPs, x and g (8, 581, 1024), H 4096, and the text
// MLPs, (14 classes, 77, 768), H 3072; quick_gelu, eps 1e-5; 36 calls a
// step, none with weight gradients (CLIP is frozen); and SAM's MLPs in the
// cascade's fp32 train step (K 1280, H 5120, gelu_tanh), dx only.
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
// mlp_panel_rows as in the forward. Per panel, on sgemm_f32.cuh's pieces
// (its cp.async ring of 32-deep k tiles), each product's tile from the
// wrapper's plans (ops/linear.py f32_mlp_bwd_plans), on one of two paths:
//   path 0 (K-major fragments; W1 and W2 read MN-major as they lie):
//     1. ln_rows_f32_kernel: xn (rows, K) and each row's (mean, rstd);
//     2. dh_pre = g . W2 (sgemm_kernel<K_MAJOR, MN_MAJOR, EPI_ACT>, W2 (K, H)
//        as it lies) into the dh scratch (rows, H);
//     3. pre1 = xn . W1^T + b1 (sgemm_kernel<K_MAJOR, K_MAJOR, EPI_DACT>),
//        whose epilogue reads dh_pre and writes dh = act'(pre1) * dh_pre in
//        its place: the bf16 kernel's dual GEMM as two products, so that
//        neither holds two accumulators (a 128 x 128 tile's are 128
//        registers a thread);
//     4. dxn = dh . W1 (sgemm_kernel<K_MAJOR, MN_MAJOR, EPI_ACT>, W1 (H, K)
//        as it lies) into an fp32 (rows, K) scratch;
//     5. ln_bwd_rows_f32_kernel: dx per row from dxn, x, the row's
//        statistics and g;
//   path 1 (the MN path: both operands MN-major, 128 x 128 at two blocks
//     an SM): W1^T (K, H) into a scratch once a call (transpose_f32_kernel,
//     the one weight that is K-major as it lies), then per panel, ld = rows
//     rounded up to 4:
//     1. ln_rows_t_f32_kernel: xn^T (K, ld) and the same (mean, rstd);
//     2. transpose_f32_kernel: g^T (K, ld);
//     3. dh_pre^T = (g . W2)^T (sgemm_kernel<MN_MAJOR, MN_MAJOR, EPI_ACT_T>:
//        A g^T, B W2 as it lies) into the dh scratch (H, ld);
//     4. dh^T = (act'(xn . W1^T + b1) * dh_pre)^T in its place
//        (sgemm_kernel<MN_MAJOR, MN_MAJOR, EPI_DACT_T>: A xn^T, B W1^T);
//     5. dxn = dh . W1 (sgemm_kernel<MN_MAJOR, MN_MAJOR, EPI_ACT>: A dh^T, B
//        W1 as it lies), rows out;
//     6. ln_bwd_rows_f32_kernel as on path 0.
// Both paths sum each output over k in order and the statistics in the
// same order: at one split they are bit-equal. Only when a weight, bias or
// LN parameter needs its gradient (path 0 only: the weight side reads the
// row-major scratches), the passes keep xn, dh, dxn and the statistics for
// every row and pass 3 also writes act(pre1) (M, H); the wrapper forms the
// weight side from them with torch (dw1 = dh^T . xn, dw2 = g^T . act(pre1)
// and the column sums, as the JAX wrapper leaves its weight products to
// XLA). No atomics: two runs are bit-equal. K % 4 == 0 and H % 4 == 0; the
// wrapper checks.
#include "sgemm_f32.cuh"

// x/g/dx (M, K), w1 (H, K), b1 (H,), w2 (K, H), gamma/beta (K,): fp32.
// Scratch: xn (R, K), dh (R, H), stats (R,) float2, dxn (R, K), with R = M
// when hact (M, H) is given (the weight side, path 0) and R = rows (the
// panel) when not; on path 1 xn and gt (K, mn_ld(rows)), dh (H,
// mn_ld(rows)), wt W1^T's H K floats (else gt and wt null); t1, s1, n1 the
// tile, k slices and split tail of the H-wide products (2 and 3 on path 0,
// 3 and 4 on path 1), t2, s2, n2 of the K-wide one, ws their split-K
// scratch (the larger's) or null. Queues five launches per panel on path
// 0, six and one per call on path 1 (and a split product's second pass);
// returns a cudaError_t code.
extern "C" int cvlm_ln_mlp_residual_bwd_f32(const void* x, const void* gamma, const void* beta,
                                            const void* w1, const void* b1, const void* w2,
                                            const void* g, void* dx, void* xn, void* dh,
                                            void* stats, void* dxn, void* hact, void* ws,
                                            void* gt, void* wt, int M, int K, int H, int rows,
                                            float eps, int act, int residual, int t1, int s1,
                                            int n1, int t2, int s2, int n2, int path,
                                            void* stream) {
  using namespace cvlm::f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || rows < 1 || K < 4 || K % 4 != 0 || H < 4 || H % 4 != 0 ||
      act < cvlm::ACT_NONE || act > cvlm::ACT_QUICK_GELU || path < 0 || path > 1 ||
      (path == 1 && (gt == nullptr || wt == nullptr || hact != nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool weights = hact != nullptr;
  const auto* xp = static_cast<const float*>(x);
  const auto* gp = static_cast<const float*>(g);
  const auto* ga = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  const auto* b1p = static_cast<const float*>(b1);
  const auto* w1p = static_cast<const float*>(w1);
  const auto* w2p = static_cast<const float*>(w2);
  auto* gtp = static_cast<float*>(gt);
  auto* w1t = static_cast<float*>(wt);
  auto* wsp = static_cast<float*>(ws);
  const Plan p1{t1, s1, n1, wsp}, p2{t2, s2, n2, wsp};
  const int ld = mn_ld(rows);
  if (path == 1) {
    const int err = launch_transpose(w1p, w1t, H, K, s);
    if (err) return err;
  }
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
    int err;
    if (path == 0) {
      err = launch_ln_rows(xr, ga, be, xnp, st, m, K, eps, s);
      if (!err)  // dh_pre = g . W2
        err = launch_sgemm<K_MAJOR, MN_MAJOR, EPI_ACT>(gr, K, 0, w2p, H, nullptr, nullptr, dhp,
                                                       nullptr, m, H, K, cvlm::ACT_NONE, p1, 1,
                                                       s);
      if (!err)  // dh = act'(xn . W1^T + b1) * dh_pre, in place
        err = launch_sgemm<K_MAJOR, K_MAJOR, EPI_DACT>(xnp, K, 0, w1p, K, b1p, dhp, dhp, hp, m,
                                                       H, K, act, p1, 1, s);
      if (!err)  // dxn = dh . W1
        err = launch_sgemm<K_MAJOR, MN_MAJOR, EPI_ACT>(dhp, H, 0, w1p, K, nullptr, nullptr, dxnp,
                                                       nullptr, m, K, H, cvlm::ACT_NONE, p2, 1,
                                                       s);
    } else {  // the panel's MN-major scratches at the full panel's ld
      err = launch_ln_rows_t(xr, ga, be, xnp, st, m, K, ld, eps, s);
      if (!err) err = launch_transpose(gr, gtp, m, K, s, ld);
      if (!err)  // dh_pre^T = (g . W2)^T
        err = launch_sgemm<MN_MAJOR, MN_MAJOR, EPI_ACT_T>(gtp, ld, 0, w2p, H, nullptr, nullptr,
                                                          dhp, nullptr, m, H, K, cvlm::ACT_NONE,
                                                          p1, 1, s, 0, 0, ld);
      if (!err)  // dh^T = (act'(xn . W1^T + b1) * dh_pre)^T, in place
        err = launch_sgemm<MN_MAJOR, MN_MAJOR, EPI_DACT_T>(xnp, ld, 0, w1t, H, b1p, dhp, dhp,
                                                           nullptr, m, H, K, act, p1, 1, s, 0, 0,
                                                           ld);
      if (!err)  // dxn = dh . W1
        err = launch_sgemm<MN_MAJOR, MN_MAJOR, EPI_ACT>(dhp, ld, 0, w1p, K, nullptr, nullptr,
                                                        dxnp, nullptr, m, K, H, cvlm::ACT_NONE,
                                                        p2, 1, s);
    }
    if (!err)
      err = launch_ln_bwd_rows(xr, residual ? gr : nullptr, ga, st, dxnp,
                               static_cast<float*>(dx) + (size_t)r0 * K, m,
                               K, s);
    if (err) return err;
  }
  return 0;
}
