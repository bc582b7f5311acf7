// ln_mlp_residual: out = x + act(LN(x) . W1^T + b1) . W2^T + b2.
//
// Replaces ln_mlp_residual_bt of camouflaged_vlm_tpu/ops/linear.py: the
// hidden-grid TPU kernel (_ln_mlp_residual_hgrid_kernel, CLIP vision and
// text MLPs) and the single-chunk one (_ln_mlp_residual_bt_kernel, SAM),
// which compute the same function; `hidden_grid` is a TPU tiling knob.
//
// Shapes on the main path (bf16): CLIP vision x (B*581, 1024), H 4096;
// CLIP text x (61*77, 768), H 3072; quick_gelu. SAM ViT-H x (B*16*196,
// 1280) (interior windows), (B*1008, 1280) (edge windows), (B*4096, 1280)
// (global blocks), H 5120, gelu_tanh. What bounds it on the H100 is the
// tensor-core rate: at SAM's windows, batch 2, 164 GFLOP, 0.166 ms at 989
// TFLOP/s, against ~30 MB of input, weights and output (0.009 ms at 3.35
// TB/s).
//
// Design: three launches on the caller's stream per row panel.
//   1. the LN row pass of ln_linear.cu: xn = bf16(LN(x)), the TPU kernel's
//      first rounding point (linear.py:319);
//   2. fc1 on the persistent TMA + wgmma GEMM (gemm_sm90.cuh), epilogue
//      h = bf16(act(xn . W1^T + b1)) into a scratch buffer: the TPU
//      kernel's second rounding point (linear.py:323);
//   3. fc2 on the same GEMM with the residual epilogue: acc = h . W2^T + b2
//      + x in fp32, x read at the accumulator fragment's rows, rounded once.
//      Without `residual` (a tensor-parallel rank's partial, summed over its
//      model group by the caller, which adds b2 and, after the sum, the
//      residual) fc2 writes its accumulator unrounded: h . W2^T in fp32.
// The TPU kernel kept the hidden in VMEM; here it reaches device memory: at
// SAM's windows, batch 2, h is 64 MB written and read again, ~0.04 ms at the
// HBM rate against the 0.166-ms FLOP bound, and fc2's row-panel-first tile
// walk reads it about once. The wrapper bounds the scratch: it passes a
// panel of `rows` rows (ops/linear.py mlp_panel_rows) and the passes repeat
// per panel. A single launch that exchanges the hidden across a cluster's
// distributed shared memory is later work.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace cvlm {
// defined in ln_linear.cu
int launch_ln_rows(const void* x, const void* gamma, const void* beta, const void* mask,
                   void* xn, int M, int K, int S, int nwin, float eps, cudaStream_t stream,
                   float2* stats);
}  // namespace cvlm

// x/out (M, K), w1 (H, K), b1 (H,), w2 (K, H), b2 (K,): bf16; gamma/beta
// (K,) fp32; xn (rows, K) and h (rows, H) bf16 scratch; K % 8 == 0 and
// H % 8 == 0 (the wrapper checks); residual 1: out bf16 with the bias and
// the residual x in fc2's epilogue; 0: out fp32 (M, K), fc2's product alone;
// bn1/bn2 the two GEMMs' tile widths (128 or 256). Returns a cudaError_t
// code.
extern "C" int cvlm_ln_mlp_residual(const void* x, const void* gamma, const void* beta,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, void* out, void* xn, void* h, int M, int K,
                                    int H, int rows, float eps, int act, int residual, int bn1,
                                    int bn2, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || rows < 1 || K % 8 != 0 || H % 8 != 0) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const bf16*>(x);
  auto* op = static_cast<bf16*>(out);
  for (int r0 = 0; r0 < M; r0 += rows) {
    const int m = M - r0 < rows ? M - r0 : rows;
    const bf16* xr = xp + (size_t)r0 * K;
    int err = launch_ln_rows(xr, gamma, beta, nullptr, xn, m, K, 1, 1, eps, s, nullptr);
    if (!err) err = launch_gemm<EPI_BIAS_ACT>(xn, w1, b1, nullptr, h, m, H, K, act, bn1, s);
    if (!err && residual)
      err = launch_gemm<EPI_BIAS_RESIDUAL>(h, w2, b2, xr, op + (size_t)r0 * K, m, K, H,
                                           ACT_NONE, bn2, s);
    else if (!err)
      err = launch_gemm<EPI_F32>(h, w2, nullptr, nullptr, static_cast<float*>(out) + (size_t)r0 * K,
                                 m, K, H, ACT_NONE, bn2, s);
    if (err) return err;
  }
  return 0;
}
