// ln_linear_f32: out = act(LN(x) . W^T + b), and the same with a row mask
// on LN(x), all in float32.
//
// Replaces two TPU kernels of camouflaged_vlm_tpu/ops/linear.py where the
// JAX package runs them in float32; at float32 neither has a rounding
// point: its LN rows are float32, so they are here.
//   ln_linear_act_bt (#2): LN1 + qkv of the Alpha-CLIP ViT-L/14@336 vision
//     blocks in MaPLe prompt training (cli/train_maple.py) and in the
//     cascade at --dtype float32, and of SAM's compact-carry windows there.
//     At MaPLe's batch 8: x (8, 581, 1024), W (3072, 1024), no activation,
//     eps 1e-5; 24 calls a step. 2 M K N = 29.2 GFLOP, 0.44 ms at 67
//     TFLOP/s, against 19 + 12.6 + 57 MB of x, W and out (0.026 ms at 3.35
//     TB/s).
//   ln_mask_linear_bt (#3): LN1, the pad-row re-zeroing and the qkv
//     projection of SAM ViT-H's 4 global blocks at --dtype float32: x (B,
//     4096, 1280) with the mask (1, 4096, 1) of ones, W (3840, 1280); 40.3
//     GFLOP an image, 0.60 ms at 67 TFLOP/s, against 21 + 20 + 63 MB (0.031
//     ms).
// What bounds both on the H100 is the float32 rate of the CUDA cores (the
// tensor cores have no float32 mode).
//
// Design: on the caller's stream, sgemm_f32.cuh's pieces, on one of two
// paths (the wrapper's plan, ops/linear.py f32_gemm_plan):
//   path 0 (K-major fragments):
//     1. ln_rows_f32_kernel: xn = LN(x) * gamma + beta (times the row mask:
//        row b' reads mask[b' % nwin]) into an fp32 scratch (M, K);
//     2. sgemm_kernel<K_MAJOR, K_MAJOR, EPI_ACT>: out = act(xn . W^T + b);
//   path 1 (MN fragments):
//     1. transpose_f32_kernel: W^T (K, N) into a scratch;
//     2. ln_rows_t_f32_kernel: the LN rows written MN-major, (K, ld) with ld
//        = M rounded up to 4, through 32 x 32 tiles in shared memory;
//     3. sgemm_kernel<MN_MAJOR, MN_MAJOR, EPI_ACT>: each thread's 8 + 8
//        values of one k read while the previous k's 64 FFMAs run.
// Both sum each output over k in order: the paths are bit-equal.
// K % 4 == 0 and N % 4 == 0 (16-byte loads and stores; the wrapper checks).
#include "sgemm_f32.cuh"

namespace {

// The LN rows (masked when `mask` is given) and the product on `path`.
int ln_linear(const float* x, const float* gamma, const float* beta, const float* mask,
              const float* w, const float* b, float* out, float* xn, float* wt, int M, int K,
              int N, int S, int nwin, float eps, int act, cvlm::f32::Plan plan, int path,
              cudaStream_t s) {
  using namespace cvlm::f32;
  if (path == 0) {
    const int err = launch_ln_rows(x, gamma, beta, xn, nullptr, M, K, eps, s, mask, S, nwin);
    if (err) return err;
    return launch_sgemm<K_MAJOR, K_MAJOR, EPI_ACT>(xn, K, 0, w, K, b, nullptr, out, nullptr, M,
                                                   N, K, act, plan, 1, s);
  }
  if (path != 1 || wt == nullptr) return (int)cudaErrorInvalidValue;
  int err = launch_transpose(w, wt, N, K, s);
  if (!err)
    err = launch_ln_rows_t(x, gamma, beta, xn, nullptr, M, K, mn_ld(M), eps, s, mask, S, nwin);
  if (err) return err;
  return launch_sgemm<MN_MAJOR, MN_MAJOR, EPI_ACT>(xn, mn_ld(M), 0, wt, N, b, nullptr, out,
                                                   nullptr, M, N, K, act, plan, 1, s);
}

}  // namespace

// x (M, K), w (N, K), b (N,), out (M, N), gamma/beta (K,): fp32; xn a
// scratch of M K floats (path 0) or K mn_ld(M) (path 1), wt one of N K
// floats (path 1; else null); tile, splits, tail, ws and path the product's
// plan (sgemm_f32.cuh Plan). Returns a cudaError_t code.
extern "C" int cvlm_ln_linear_f32(const void* x, const void* gamma, const void* beta,
                                  const void* w, const void* b, void* out, void* xn, void* ws,
                                  void* wt, int M, int K, int N, float eps, int act, int tile,
                                  int splits, int tail, int path, void* stream) {
  if (M < 1 || K < 4 || K % 4 != 0 || N % 4 != 0) return (int)cudaErrorInvalidValue;
  return ln_linear(static_cast<const float*>(x), static_cast<const float*>(gamma),
                   static_cast<const float*>(beta), nullptr, static_cast<const float*>(w),
                   static_cast<const float*>(b), static_cast<float*>(out),
                   static_cast<float*>(xn), static_cast<float*>(wt), M, K, N, 1, 1, eps, act,
                   cvlm::f32::Plan{tile, splits, tail, static_cast<float*>(ws)}, path,
                   static_cast<cudaStream_t>(stream));
}

// x (M, K) as nwin-cycling sequences of S rows, mask (nwin, S, 1), w (N, K),
// b (N,), out (M, N), gamma/beta (K,): fp32; xn and wt scratch as above;
// tile, splits, tail, ws and path the product's plan. Returns a cudaError_t
// code.
extern "C" int cvlm_ln_mask_linear_f32(const void* x, const void* gamma, const void* beta,
                                       const void* mask, const void* w, const void* b, void* out,
                                       void* xn, void* ws, void* wt, int M, int K, int N, int S,
                                       int nwin, float eps, int tile, int splits, int tail,
                                       int path, void* stream) {
  if (M < 1 || K < 4 || K % 4 != 0 || N % 4 != 0 || S < 1 || nwin < 1 || M % S != 0)
    return (int)cudaErrorInvalidValue;
  return ln_linear(static_cast<const float*>(x), static_cast<const float*>(gamma),
                   static_cast<const float*>(beta), static_cast<const float*>(mask),
                   static_cast<const float*>(w), static_cast<const float*>(b),
                   static_cast<float*>(out), static_cast<float*>(xn), static_cast<float*>(wt), M,
                   K, N, S, nwin, eps, cvlm::ACT_NONE,
                   cvlm::f32::Plan{tile, splits, tail, static_cast<float*>(ws)}, path,
                   static_cast<cudaStream_t>(stream));
}
