// proj_rows: out[g, s, :] = x[g, :, s]^T . W^T + b (+ res[g, s, :]).
// proj_from_heads: out[b, t, s, :] = sum_h x[b, h, t, s, :] . W[:, h*d:(h+1)*d]^T
// + b (+ res[b, t, s, :]).
//
// Replaces three TPU kernels of camouflaged_vlm_tpu/ops/linear.py:
//   proj_rows (_proj_rows_kernel and _proj_rows_res_kernel, #7): the
//     attention out-projection that reads the packed attention kernels'
//     d-major (heads*d, S) output and writes row-major rows, with the block's
//     residual added in the epilogue;
//   proj_from_heads_res (_proj_res_kernel, #8) and proj_from_heads
//     (_proj_kernel, #9): the same product over the head-leading (B, heads,
//     T, S, d) output of flash_qkv_relpos_windows (qkv_relpos.cu), with and
//     without the residual; the head -> feature relayout never reaches
//     device memory.
//
// #7 on the main path (bf16, batch 2, K = N): SAM ViT-H's interior windows
// x (2, 16, 1280, 196), its edge windows (2, 9, 1280, 112) and global blocks
// (2, 1, 1280, 4096), CLIP vision (2, 1, 1024, 581), each with the residual;
// bound by the tensor-core rate (20.6 GFLOP at SAM's windows, 0.0208 ms at
// 989 TFLOP/s). It runs on the persistent TMA + wgmma GEMM of gemm_sm90.cuh
// (gemm_tma_kernel with an MN-major A): x is read as it lies, s contiguous,
// by TMA boxes of 64 s x 64 k with the 128-byte swizzle, which wgmma takes
// as a transposed A; a row tile holds the rows of one group (b, t), masked
// at S; the bias + residual epilogue is #4/#5's fc2's. TMA needs x's row
// stride (the attention kernels write it rounded up to a multiple of 8
// elements, ops/flash_attention.py) and group stride in multiples of 16
// bytes; the wrapper refuses any other x.
//
// #8/#9 (fused 'flash' at windows of 17 and more, bf16, batch 2): x (2, 16,
// 16, 289, 80), W (1280, 1280), res (2, 16, 289, 1280); 30.3 GFLOP, bound by
// the tensor cores (0.0306 ms at 989 TFLOP/s). They run on the same template
// with the head-leading A (A_HEADS): for one image b the rows r = t S + s are
// uniform at a stride of d, and within a head k = h d + j is contiguous in
// j, so x is a K-major A whose K axis is strided by head: one rank-3 TMA map
// (j, r, b heads + h); a group is an image's T S rows, row tiles never
// straddle two images; the K walk takes each head's first 64 columns as a
// 128-byte-swizzled tile, then the 16 heads' last 16 as k16 slices with the
// 32-byte swizzle, four heads a k step (W's slices through a map (j, h, n)).
// The residual and bias are added to the fp32 accumulator and rounded once,
// as the TPU kernels do (linear.py:653, :748).
#include "common.cuh"
#include "gemm_sm90.cuh"

// x (G, K, S) with s contiguous and row stride ldk, group stride ldg (in
// elements, multiples of 8; ldk >= S), w (N, K) [nn.Linear layout], bias
// (N,), res (G, S, N) or NULL, out (G, S, N): bf16, bases 16-byte aligned;
// K % 8 == 0 and N % 8 == 0 with res; f32out 1: out fp32, the product alone
// (no bias, no res; N % 8 == 0), a tensor-parallel rank's partial; bn the
// tile width (128 or 256). Returns a cudaError_t code.
extern "C" int cvlm_proj_rows(const void* x, const void* w, const void* bias,
                              const void* res, void* out, int G, int S, long long ldk,
                              long long ldg, int K, int N, int f32out, int bn, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32out)  // a tensor-parallel partial: the product alone, fp32, no bias
    return res == nullptr && N % 8 == 0
               ? launch_gemm_mn<EPI_F32>(x, ldk, ldg, w, nullptr, nullptr, out, G, S, N, K,
                                         ACT_NONE, bn, s)
               : (int)cudaErrorInvalidValue;
  if (res != nullptr)
    return launch_gemm_mn<EPI_BIAS_RESIDUAL>(x, ldk, ldg, w, bias, res, out, G, S, N, K,
                                             ACT_NONE, bn, s);
  return launch_gemm_mn<EPI_BIAS_ACT>(x, ldk, ldg, w, bias, nullptr, out, G, S, N, K, ACT_NONE,
                                      bn, s);
}

// x (B, heads, T, S, d) head-leading, d % 8 == 0, w (N, heads*d) [nn.Linear
// layout], bias (N,), res (B, T, S, N) or NULL, out (B, T, S, N): bf16,
// bases 16-byte aligned; N % 8 == 0 with res; f32out as cvlm_proj_rows';
// bn the tile width (128 or
// 256). Returns a cudaError_t code.
extern "C" int cvlm_proj_from_heads(const void* x, const void* w, const void* bias,
                                    const void* res, void* out, int B, int heads, int T,
                                    int S, int d, int N, int f32out, int bn, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (f32out)  // a tensor-parallel partial: the product alone, fp32, no bias
    return res == nullptr && N % 8 == 0
               ? launch_gemm_heads<EPI_F32>(x, w, nullptr, nullptr, out, B, heads, T * S, d, N,
                                            bn, s)
               : (int)cudaErrorInvalidValue;
  if (res != nullptr)
    return launch_gemm_heads<EPI_BIAS_RESIDUAL>(x, w, bias, res, out, B, heads, T * S, d, N, bn,
                                                s);
  return launch_gemm_heads<EPI_BIAS_ACT>(x, w, bias, nullptr, out, B, heads, T * S, d, N, bn, s);
}
