// ln_linear: out = act(LN(x) [* mask] . W^T + b), a LayerNorm prologue
// with an optional row mask; and the LN row pass that the fused MLP
// (ln_mlp_residual.cu) and its backward (ln_mlp_residual_bwd.cu, which also
// keeps each row's mean and rstd) share.
//
// Replaces two TPU kernels of camouflaged_vlm_tpu/ops/linear.py (the plain
// product, linear_pallas, is linear.cu):
//   ln_linear_act_bt  (_ln_linear_act_bt_kernel)   -- LN:    CLIP ln_1 + qkv,
//                                                     SAM windowed LN1 + qkv
//   ln_mask_linear_bt (_ln_mask_linear_bt_kernel)  -- LN and row mask: SAM
//                      global LN1 + qkv, x (B, 4096, 1280), W (3840, 1280)
//
// Shapes on the main path (bf16): CLIP qkv x (B*581, 1024) . W (3072, 1024),
// SAM qkv x (B*16*196, 1280) (interior windows) and (B*1008, 1280) (edge
// windows) . W (3840, 1280), SAM global x (B*4096, 1280). What bounds them on
// the H100 is the tensor-core rate (989 TFLOP/s dense bf16): at SAM's
// windows, batch 2, 61.7 GFLOP in 0.062 ms against 16 + 48 MB of operands
// and output, 0.019 ms at 3.35 TB/s.
//
// Design: two launches on the caller's stream.
//   1. ln_rows_kernel, one warp per row: fp32 mean, then the mean of squared
//      deviations (two passes over the row, the JAX formulation), then
//      (x - mu) * rstd * gamma + beta, times the row mask for
//      ln_mask_linear_bt (row m of window-batch b' = m / S reads
//      mask[(b' % nwin) * S + m % S], linear.py:220), rounded to bf16 into a
//      scratch buffer the wrapper allocates: the TPU kernel's rounding point
//      (`xn.astype(o_ref.dtype)`, linear.py:137 and :222), so the product reads what
//      the TPU kernel's dot read. 16-byte loads and stores; its 2 x 16 MB at
//      SAM's windows, batch 2, take ~0.01 ms at the HBM rate.
//   2. the persistent TMA + wgmma GEMM of gemm_sm90.cuh on the bf16 rows,
//      bias and activation in fp32 on the accumulator, rounded once.
// LN is not folded into the weights algebraically: that would move the bf16
// rounding point. K % 8 == 0 (TMA row strides are 16-byte multiples).
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace cvlm {

constexpr int LN_ROWS_THREADS = 256;  // 8 warps: 8 rows a block

template <bool MASK, bool STATS = false>
__global__ void __launch_bounds__(LN_ROWS_THREADS) ln_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ mask, bf16* __restrict__ xn,
    int M, int K, int S, int nwin, float eps, float2* __restrict__ stats) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (LN_ROWS_THREADS / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)m * K);
  const int nv = K / 8;  // 16-byte chunks of the row
  float f[8], s = 0.f;
  for (int c = lane; c < nv; c += 32) {
    unpack8(row[c], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mu = warp_sum(s) / (float)K;
  float v = 0.f;
  for (int c = lane; c < nv; c += 32) {
    unpack8(row[c], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) v += (f[i] - mu) * (f[i] - mu);
  }
  const float rstd = 1.0f / sqrtf(warp_sum(v) / (float)K + eps);
  if (STATS && lane == 0) stats[m] = make_float2(mu, rstd);
  const float mk = MASK ? __bfloat162float(mask[((m / S) % nwin) * S + m % S]) : 1.f;
  uint4* dst = reinterpret_cast<uint4*>(xn + (size_t)m * K);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  for (int c = lane; c < nv; c += 32) {
    unpack8(row[c], f);
    const float4 ga = g4[2 * c], gb = g4[2 * c + 1], ba = b4[2 * c], bb = b4[2 * c + 1];
    const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
    const float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float y0 = (f[2 * i] - mu) * rstd * g[2 * i] + b[2 * i];
      float y1 = (f[2 * i + 1] - mu) * rstd * g[2 * i + 1] + b[2 * i + 1];
      if (MASK) {
        y0 *= mk;
        y1 *= mk;
      }
      o[i] = pack_bf16(y0, y1);
    }
    dst[c] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The LN row pass: xn (M, K) bf16 = LN(x) [* mask], as above. mask may be
// null (no mask); without a mask, stats (M,) float2, if not null, gets each
// row's (mean, rstd). Returns cudaGetLastError().
int launch_ln_rows(const void* x, const void* gamma, const void* beta, const void* mask,
                   void* xn, int M, int K, int S, int nwin, float eps, cudaStream_t stream,
                   float2* stats) {
  if (M < 1 || K < 8 || K % 8 != 0 || (mask != nullptr && stats != nullptr))
    return (int)cudaErrorInvalidValue;
  const int grid = (M + LN_ROWS_THREADS / 32 - 1) / (LN_ROWS_THREADS / 32);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bp = static_cast<const float*>(beta);
  auto* op = static_cast<bf16*>(xn);
  if (mask != nullptr)
    ln_rows_kernel<true><<<grid, LN_ROWS_THREADS, 0, stream>>>(
        xp, gp, bp, static_cast<const bf16*>(mask), op, M, K, S, nwin, eps, nullptr);
  else if (stats != nullptr)
    ln_rows_kernel<false, true><<<grid, LN_ROWS_THREADS, 0, stream>>>(xp, gp, bp, nullptr, op, M,
                                                                      K, 1, 1, eps, stats);
  else
    ln_rows_kernel<false><<<grid, LN_ROWS_THREADS, 0, stream>>>(xp, gp, bp, nullptr, op, M, K,
                                                                1, 1, eps, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace cvlm

// x (M, K), w (N, K) [nn.Linear layout], bias (N,), out (M, N), xn (M, K)
// scratch: bf16; gamma/beta (K,) fp32; K % 8 == 0; bn the GEMM's tile width
// (128 or 256). Queues the LN row pass and the GEMM; returns a cudaError_t code.
extern "C" int cvlm_ln_linear(const void* x, const void* gamma, const void* beta,
                              const void* w, const void* bias, void* out, void* xn, int M,
                              int K, int N, float eps, int act, int bn, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch_ln_rows(x, gamma, beta, nullptr, xn, M, K, 1, 1, eps, s, nullptr);
  if (err) return err;
  return launch_gemm<EPI_BIAS_ACT>(xn, w, bias, nullptr, out, M, N, K, act, bn, s);
}

// x (B', S, K) with B' = B * nwin, mask (nwin, S, 1), w (N, K), bias (N,),
// out (B', S, N), xn (B' * S, K) scratch: bf16; gamma/beta (K,) fp32. No
// activation. Returns a cudaError_t code.
extern "C" int cvlm_ln_mask_linear(const void* x, const void* gamma, const void* beta,
                                   const void* mask, const void* w, const void* bias,
                                   void* out, void* xn, int M, int K, int N, int S, int nwin,
                                   float eps, int bn, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask == nullptr || S < 1 || nwin < 1) return (int)cudaErrorInvalidValue;
  int err = launch_ln_rows(x, gamma, beta, mask, xn, M, K, S, nwin, eps, s, nullptr);
  if (err) return err;
  return launch_gemm<EPI_BIAS_ACT>(xn, w, bias, nullptr, out, M, N, K, ACT_NONE, bn, s);
}

extern "C" const char* cvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
