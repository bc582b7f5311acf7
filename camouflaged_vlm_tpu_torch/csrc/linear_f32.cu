// linear_f32: out = act(x . W^T + b), all in float32.
//
// Replaces linear_pallas of camouflaged_vlm_tpu/ops/linear.py (TPU kernel
// #1) where the JAX package runs it in float32 (--dtype float32): SAM
// ViT-H's patch embed, the 16 x 16 x 3 patches of a 1024-px image as rows,
// x (B 4096, 768), W (1280, 768), and the EVP adapter's embed of the
// high-passed image, W (40, 768); two calls an image. At float32 the TPU
// kernel has no rounding point.
//
// What bounds it on the H100 is the float32 rate of the CUDA cores (the
// tensor cores have no float32 mode): the patch embed is 2 M K N = 8.05
// GFLOP an image, 0.12 ms at 67 TFLOP/s, against 12.6 + 3.9 + 21 MB of x, W
// and out (0.011 ms at 3.35 TB/s).
//
// Design: sgemm_f32.cuh's tiled FFMA product sgemm_kernel<K_MAJOR, K_MAJOR,
// EPI_ACT> with the bias and activation in its epilogue: x and W copied as
// they lie by cp.async into a 3-stage ring of 32-deep k tiles, 8 x 8
// outputs a thread. What held the first design (16-deep tiles staged
// through registers with transposing stores, 139 registers: one block of 8
// warps an SM) was its in-wave rate and the last wave: 320 tiles of
// 128 x 128 at batch 1 fill 2.4 rounds of 132 SMs. The wrapper's plan
// (ops/linear.py f32_gemm_plan) takes 64 x 128 tiles there (two an SM) and
// cuts the last row tiles' K in two (a second launch, then the slices'
// sum). K % 4 == 0 and N % 4 == 0 (16-byte loads and stores; the wrapper
// checks).
#include "sgemm_f32.cuh"

// x (M, K), w (N, K), b (N,), out (M, N): fp32; tile, splits, tail and ws
// the product's plan (sgemm_f32.cuh Plan). Returns a cudaError_t code.
extern "C" int cvlm_linear_f32(const void* x, const void* w, const void* b, void* out, void* ws,
                               int M, int K, int N, int act, int tile, int splits,
                               int tail, void* stream) {
  using namespace cvlm::f32;
  if (K % 4 != 0) return (int)cudaErrorInvalidValue;
  return launch_sgemm<K_MAJOR, K_MAJOR, EPI_ACT>(
      static_cast<const float*>(x), K, 0, static_cast<const float*>(w), K,
      static_cast<const float*>(b), nullptr, static_cast<float*>(out), nullptr, M, N, K, act,
      Plan{tile, splits, tail, static_cast<float*>(ws)}, 1, static_cast<cudaStream_t>(stream));
}
