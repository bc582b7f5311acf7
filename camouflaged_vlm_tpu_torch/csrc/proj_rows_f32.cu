// proj_rows_f32: out[g, s, :] = x[g, :, s] . W^T + b (+ res[g, s, :]), all in
// float32, from the d-major attention output; and the same product from the
// head-leading attention output (cvlm_proj_from_heads_f32).
//
// Replaces proj_rows of camouflaged_vlm_tpu/ops/linear.py (TPU kernel #7)
// where the JAX package runs it in float32: the out-projection + residual
// of the Alpha-CLIP ViT-L/14@336 vision blocks in MaPLe prompt training,
// reading the d-major output of the fp32 attention (qkv_packed_plain_f32.cu)
// as it lies.
//
// Shapes on that path: x (8, 1, 1024, 581) d-major with row stride 584 (the
// wrapper's ops/linear.py dmajor_empty), W (1024, 1024), the residual (8, 1,
// 581, 1024); 24 calls a step. What bounds it on the H100 is the float32
// rate of the CUDA cores: 2 G S K N = 9.75 GFLOP, 0.146 ms at 67 TFLOP/s,
// against 19 MB each of x, res and out and 4 MB of W (0.018 ms at 3.35
// TB/s).
//
// Design: one launch, sgemm_f32.cuh's sgemm_kernel<MN_MAJOR, K_MAJOR,
// EPI_ACT or EPI_RES>: x is an MN-major A (its K = 1024 along rows of
// stride ldk, the s axis contiguous), one grid z index per (B, T) group
// (stride ldg); 128 x 128 or 64 x 64 tiles (ops/linear.py f32_tile). The
// row tile reads x in float4s along s: ldk and ldg multiples of 4, and a
// ragged last tile reads up to 3 pad columns of the padded rows, which no
// output reads. N % 4 == 0 and K % 4 == 0; the wrapper checks.
//
// cvlm_proj_from_heads_f32 replaces proj_from_heads_res and proj_from_heads
// of camouflaged_vlm_tpu/ops/linear.py (TPU kernels #8 and #9) where the JAX
// package runs them in float32: out[b, t, s, :] = sum_h x[b, h, t, s, :] .
// W[:, h d:(h+1) d]^T + b (+ res), the out-projection of #11's head-leading
// output (B, heads, T, S, d) in fused 'flash' at a window of 17 or more. At
// ViT-H with window 17, batch 2: x (2, 16, 16, 289, 80), W (1280, 1280), res
// (2, 16, 289, 1280); 2 B T S K N = 30.3 GFLOP, 0.452 ms at 67 TFLOP/s,
// against 142 MB of x, res and out and 6.6 MB of W (0.044 ms at 3.35 TB/s).
// Design: the same sgemm_kernel with A read K_HEADS, one grid z index an
// image: row m = t S + s of image b, column k = h d + j at (k / d) T S d + m
// d + k % d past the image's start (the helper the wrapper takes its
// arguments from is ops/linear.py proj_heads_f32_layout); W the K-major
// (N, K) Linear weight; the residual epilogue for #8, the bias alone for #9.
#include "sgemm_f32.cuh"

// x (G groups of (K, S) with row stride ldk, group stride ldg), w (N, K), b
// (N,), res (G, S, N) or null, out (G, S, N): fp32. Returns a cudaError_t
// code.
extern "C" int cvlm_proj_rows_f32(const void* x, const void* w, const void* b, const void* res,
                                  void* out, int G, int S, long long ldk, long long ldg, int K,
                                  int N, int tile, void* stream) {
  using namespace cvlm::f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || S < 1 || K < 1 || ldk < S || ldk % 4 != 0 || ldg % 4 != 0 || K % 4 != 0 ||
      ldk > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(b);
  auto* op = static_cast<float*>(out);
  if (res != nullptr)
    return launch_sgemm<MN_MAJOR, K_MAJOR, EPI_RES>(xp, (int)ldk, ldg, wp, K, bp,
                                                    static_cast<const float*>(res), op, nullptr,
                                                    S, N, K, cvlm::ACT_NONE, tile, G, s);
  return launch_sgemm<MN_MAJOR, K_MAJOR, EPI_ACT>(xp, (int)ldk, ldg, wp, K, bp, nullptr, op,
                                                  nullptr, S, N, K, cvlm::ACT_NONE, tile, G, s);
}

// x (G groups of heads x (M, d) head-leading, group stride sa), w (N, K = heads
// d), b (N,), res (G, M, N) or null, out (G, M, N): fp32; d % 4 == 0, K % d ==
// 0, N % 4 == 0. Returns a cudaError_t code.
extern "C" int cvlm_proj_from_heads_f32(const void* x, const void* w, const void* b,
                                        const void* res, void* out, int G, int M, int d,
                                        long long sa, int K, int N, int tile, void* stream) {
  using namespace cvlm::f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || M < 1 || d < 4 || d % 4 != 0 || K % d != 0 || sa < (long long)M * K || sa % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(b);
  auto* op = static_cast<float*>(out);
  if (res != nullptr)
    return launch_sgemm<K_HEADS, K_MAJOR, EPI_RES>(xp, d, sa, wp, K, bp,
                                                   static_cast<const float*>(res), op, nullptr, M,
                                                   N, K, cvlm::ACT_NONE, tile, G, s);
  return launch_sgemm<K_HEADS, K_MAJOR, EPI_ACT>(xp, d, sa, wp, K, bp, nullptr, op, nullptr, M, N,
                                                 K, cvlm::ACT_NONE, tile, G, s);
}
