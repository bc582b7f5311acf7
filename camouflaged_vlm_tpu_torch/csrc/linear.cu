// linear: out = act(x . W^T + b), the plain product with a bias and an
// activation epilogue.
//
// Replaces linear_pallas of camouflaged_vlm_tpu/ops/linear.py
// (_linear_kernel): SAM's patch embed, x (B*4096, 768) . W (1280, 768), and
// the EVP prompt generator's. Bias and activation are applied in fp32 on the
// accumulator, then rounded to bf16 once, as the TPU kernel does.
//
// What bounds it on the H100: at the patch embed's shape (B = 2: 16.1 GFLOP,
// 16.6 MB) the tensor-core rate, 0.0163 ms at 989 TFLOP/s. Every operand
// fits the 50 MB L2, but each output tile streams its A rows and W columns
// through it once more: M N K 2 B (1/BN + 1/BM) of L2 reads, 252 MB for
// 128 x 128 tiles (128 x 256 tiles, 189 MB, measured slower in PR 6: 2.4
// tiles per SM leave the last round 40% full). The design is the
// persistent TMA + wgmma GEMM of gemm_sm90.cuh (gemm_tma_kernel, its
// bias + activation epilogue), whose mainloop was this file's in PR 6; the
// wrapper picks 128- or 256-wide tiles (ops/linear.py gemm_tile_n).
#include "common.cuh"
#include "gemm_sm90.cuh"

// x (M, K), w (N, K) [nn.Linear layout], bias (N,), out (M, N): bf16, every
// base 16-byte aligned; K % 8 == 0; bn 128 or 256. Returns a cudaError_t code.
extern "C" int cvlm_linear(const void* x, const void* w, const void* bias, void* out, int M,
                           int K, int N, int act, int bn, void* stream) {
  return cvlm::launch_gemm<cvlm::EPI_BIAS_ACT>(x, w, bias, nullptr, out, M, N, K, act, bn,
                                               static_cast<cudaStream_t>(stream));
}
