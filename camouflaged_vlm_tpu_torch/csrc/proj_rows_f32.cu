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
// stride ldk, the s axis contiguous), copied as it lies in 16-byte chunks
// along s (ldk and ldg multiples of 4; a ragged chunk's bytes past the last
// row zero-filled, none read). Where S % 4 == 0 (SAM's windows of 196 and
// 112 rows, its global blocks) the (B, T) groups' rows are tiled as one M
// (`flat`: row m of group m / S at (m / S) ldg + m % S), so that 196-row
// groups are not padded to 256; else one grid z index a group (stride ldg:
// MaPLe's and CLIP's 581 rows). At MaPLe's shape the first design (one
// block an SM, 320 tiles of 128 x 128: 2.4 rounds of 132 SMs, 581 rows in
// 640) lost 1.5x to torch.baddbmm; the plan (ops/linear.py f32_gemm_plan)
// takes 64 x 128 tiles there (two an SM), and splits K only where the
// grid is short (CLIP's rows at batch 1 and 2). N % 4 == 0 and K % 4 == 0;
// the wrapper checks.
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
// arguments from is ops/linear.py proj_heads_f32_layout), each 16-byte chunk
// copied from its own address (a 32-deep k tile straddles heads at d = 80)
// into sgemm_f32.cuh's K-major stage; W the K-major (N, K) Linear weight;
// the residual epilogue for #8, the bias alone for #9.
#include "sgemm_f32.cuh"

// x (G groups of (K, S) with row stride ldk, group stride ldg), w (N, K), b
// (N,), res (G, S, N) or null, out (G, S, N): fp32. flat: the G S rows tiled
// as one M (S % 4 == 0), else a group of tiles a group; tile, splits, tail,
// ws the product's plan. Returns a cudaError_t code.
extern "C" int cvlm_proj_rows_f32(const void* x, const void* w, const void* b, const void* res,
                                  void* out, void* ws, int G, int S, long long ldk, long long ldg,
                                  int K, int N, int tile, int splits, int tail, int flat,
                                  void* stream) {
  using namespace cvlm::f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || S < 1 || K < 1 || ldk < S || ldk % 4 != 0 || ldg % 4 != 0 || K % 4 != 0 ||
      ldk > (1LL << 31) - 1 || (flat && (S % 4 != 0 || (long long)G * S > (1LL << 31) - 1)))
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(b);
  const auto* rp = static_cast<const float*>(res);
  auto* op = static_cast<float*>(out);
  const int M = flat ? G * S : S, groups = flat ? 1 : G, gs = flat ? S : 0;
  const long long sa = flat ? 0 : ldg;
  const Plan plan{tile, splits, tail, static_cast<float*>(ws)};
  if (res != nullptr)
    return launch_sgemm<MN_MAJOR, K_MAJOR, EPI_RES>(xp, (int)ldk, sa, wp, K, bp, rp, op, nullptr, M,
                                                    N, K, cvlm::ACT_NONE, plan, groups, s, gs,
                                                    ldg);
  return launch_sgemm<MN_MAJOR, K_MAJOR, EPI_ACT>(xp, (int)ldk, sa, wp, K, bp, nullptr, op,
                                                  nullptr, M, N, K, cvlm::ACT_NONE, plan, groups,
                                                  s, gs, ldg);
}

// x (G groups of heads x (M, d) head-leading, group stride sa), w (N, K = heads
// d), b (N,), res (G, M, N) or null, out (G, M, N): fp32; d % 4 == 0, K % d ==
// 0, N % 4 == 0; tile, splits, tail, ws the product's plan. Returns a
// cudaError_t code.
extern "C" int cvlm_proj_from_heads_f32(const void* x, const void* w, const void* b,
                                        const void* res, void* out, void* ws, int G, int M, int d,
                                        long long sa, int K, int N, int tile, int splits,
                                        int tail, void* stream) {
  using namespace cvlm::f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || M < 1 || d < 4 || d % 4 != 0 || K % d != 0 || sa < (long long)M * K || sa % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(b);
  auto* op = static_cast<float*>(out);
  const Plan plan{tile, splits, tail, static_cast<float*>(ws)};
  if (res != nullptr)
    return launch_sgemm<K_HEADS, K_MAJOR, EPI_RES>(xp, d, sa, wp, K, bp,
                                                   static_cast<const float*>(res), op, nullptr, M,
                                                   N, K, cvlm::ACT_NONE, plan, G, s);
  return launch_sgemm<K_HEADS, K_MAJOR, EPI_ACT>(xp, d, sa, wp, K, bp, nullptr, op, nullptr, M, N,
                                                 K, cvlm::ACT_NONE, plan, G, s);
}
