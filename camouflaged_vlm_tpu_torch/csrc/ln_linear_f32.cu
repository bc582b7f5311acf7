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
// Design: two launches on the caller's stream, sgemm_f32.cuh's pieces:
//   1. ln_rows_f32_kernel: xn = LN(x) * gamma + beta (times the row mask:
//      row b' reads mask[b' % nwin]) into an fp32 scratch (M, K) that the
//      wrapper allocates;
//   2. sgemm_kernel<K_MAJOR, K_MAJOR, EPI_ACT>: out = act(xn . W^T + b),
//      sgemm_f32.cuh's cp.async ring of 32-deep k tiles, the tile from the
//      wrapper's ops/linear.py f32_gemm_plan.
// K % 4 == 0 and N % 4 == 0 (16-byte loads and stores; the wrapper checks).
#include "sgemm_f32.cuh"

// x (M, K), w (N, K), b (N,), out (M, N), xn (M, K) scratch, gamma/beta
// (K,): fp32; tile, splits, tail and ws the product's plan (sgemm_f32.cuh
// Plan).
// Returns a cudaError_t code.
extern "C" int cvlm_ln_linear_f32(const void* x, const void* gamma, const void* beta,
                                  const void* w, const void* b, void* out, void* xn, void* ws,
                                  int M, int K, int N, float eps, int act, int tile, int splits,
                                  int tail, void* stream) {
  using namespace cvlm::f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 4 || K % 4 != 0 || N % 4 != 0) return (int)cudaErrorInvalidValue;
  auto* xnp = static_cast<float*>(xn);
  int err = launch_ln_rows(static_cast<const float*>(x), static_cast<const float*>(gamma),
                           static_cast<const float*>(beta), xnp, nullptr, M, K, eps, s);
  if (err) return err;
  return launch_sgemm<K_MAJOR, K_MAJOR, EPI_ACT>(xnp, K, 0, static_cast<const float*>(w), K,
                                                 static_cast<const float*>(b), nullptr,
                                                 static_cast<float*>(out), nullptr, M, N, K, act,
                                                 Plan{tile, splits, tail, static_cast<float*>(ws)},
                                                 1, s);
}

// x (M, K) as nwin-cycling sequences of S rows, mask (nwin, S, 1), w (N, K),
// b (N,), out (M, N), xn (M, K) scratch, gamma/beta (K,): fp32; tile,
// splits, tail and ws the product's plan. Returns a cudaError_t code.
extern "C" int cvlm_ln_mask_linear_f32(const void* x, const void* gamma, const void* beta,
                                       const void* mask, const void* w, const void* b, void* out,
                                       void* xn, void* ws, int M, int K, int N, int S, int nwin,
                                       float eps, int tile, int splits, int tail,
                                       void* stream) {
  using namespace cvlm::f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 4 || K % 4 != 0 || N % 4 != 0 || S < 1 || nwin < 1 || M % S != 0)
    return (int)cudaErrorInvalidValue;
  auto* xnp = static_cast<float*>(xn);
  int err = launch_ln_rows(static_cast<const float*>(x), static_cast<const float*>(gamma),
                           static_cast<const float*>(beta), xnp, nullptr, M, K, eps, s,
                           static_cast<const float*>(mask), S, nwin);
  if (err) return err;
  return launch_sgemm<K_MAJOR, K_MAJOR, EPI_ACT>(xnp, K, 0, static_cast<const float*>(w), K,
                                                 static_cast<const float*>(b), nullptr,
                                                 static_cast<float*>(out), nullptr, M, N, K,
                                                 cvlm::ACT_NONE,
                                                 Plan{tile, splits, tail, static_cast<float*>(ws)},
                                                 1, s);
}
