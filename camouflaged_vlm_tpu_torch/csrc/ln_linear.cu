// ln_linear: out = act(LN(x) [* mask] . W^T + b), a LayerNorm prologue
// with an optional row mask.
//
// Replaces two TPU kernels of camouflaged_vlm_tpu/ops/linear.py (the plain
// product, linear_pallas, is linear.cu's TMA + wgmma GEMM):
//   ln_linear_act_bt  (_ln_linear_act_bt_kernel)   -- LN:    CLIP ln_1 + qkv,
//                                                     SAM windowed LN1 + qkv
//   ln_mask_linear_bt (_ln_mask_linear_bt_kernel)  -- LN and row mask: SAM
//                      global LN1 + qkv, x (B, 4096, 1280), W (3840, 1280)
//
// Shapes on the main path (bf16): CLIP qkv x (B*581, 1024) . W (3072, 1024),
// SAM qkv x (B*4144, 1280) . W (3840, 1280). These products do ~2 FLOP per
// weight byte per row tile, so the bound on the H100 is the tensor-core rate
// (989 TFLOP/s dense bf16) once the tiles are reused; this first version
// stages 64x32 tiles of x and W through shared memory and runs WMMA
// 16x16x16 products with fp32 accumulation, no cp.async pipelining, no TMA.
//
// LN prologue: each block computes the fp32 mean/rstd of its 64 rows (two
// passes over the row, the JAX formulation), then normalises x while staging
// the A tile and rounds it to bf16 before the product -- the rounding point
// of the TPU kernel (`xn.astype(o_ref.dtype)`, linear.py:137). The row mask
// of ln_mask_linear_bt (row m of window-batch b' = m / S reads
// mask[(b' % nwin) * S + m % S]) multiplies the fp32 LN output before that
// rounding, as the TPU kernel does (linear.py:220). Bias and the
// activation are applied in fp32 on the accumulator, then rounded once.
// Ragged M, N and K are masked by zero-filling the staged tiles.
#include "common.cuh"

namespace cvlm {

constexpr int LL_BM = 64, LL_BN = 64, LL_BK = 32;
constexpr int LL_LDA = LL_BK + 8;   // bf16 tile row pitch (multiple of 8)
constexpr int LL_LDC = LL_BN + 4;   // fp32 epilogue pitch (multiple of 4)
constexpr int LL_THREADS = 128;     // 4 warps, each a 32x32 quarter

template <bool MASK>
__global__ void __launch_bounds__(LL_THREADS) ln_linear_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ mask,
    const bf16* __restrict__ w, const bf16* __restrict__ bias, bf16* __restrict__ out,
    int M, int K, int N, int S, int nwin, float eps, int act) {
  __shared__ __align__(128) bf16 As[LL_BM * LL_LDA];
  __shared__ __align__(128) bf16 Bs[LL_BN * LL_LDA];
  __shared__ __align__(128) float Cs[LL_BM * LL_LDC];
  __shared__ float s_mu[LL_BM], s_rstd[LL_BM], s_mask[LL_BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * LL_BM, n0 = blockIdx.x * LL_BN;

  for (int r = warp; r < LL_BM; r += LL_THREADS / 32) {
    float mu = 0.f, rstd = 0.f;
    if (m0 + r < M) row_stats(x + (size_t)(m0 + r) * K, K, eps, mu, rstd);
    if (lane == 0) {
      s_mu[r] = mu;
      s_rstd[r] = rstd;
      if (MASK) {
        const int m = m0 + r;
        s_mask[r] = m < M ? __bfloat162float(mask[((m / S) % nwin) * S + m % S]) : 0.f;
      }
    }
  }
  __syncthreads();

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += LL_BK) {
    for (int e = tid; e < LL_BM * LL_BK; e += LL_THREADS) {
      const int r = e / LL_BK, c = e % LL_BK, m = m0 + r, k = k0 + c;
      bf16 v = __float2bfloat16(0.f);
      if (m < M && k < K) {
        const float xn = (__bfloat162float(x[(size_t)m * K + k]) - s_mu[r]) * s_rstd[r];
        float y = xn * gamma[k] + beta[k];
        if (MASK) y *= s_mask[r];
        v = __float2bfloat16(y);
      }
      As[r * LL_LDA + c] = v;
    }
    for (int e = tid; e < LL_BN * LL_BK; e += LL_THREADS) {
      const int r = e / LL_BK, c = e % LL_BK, n = n0 + r, k = k0 + c;
      Bs[r * LL_LDA + c] =
          (n < N && k < K) ? w[(size_t)n * K + k] : __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < LL_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * LL_LDA + kk, LL_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn + 16 * j) * LL_LDA + kk, LL_LDA);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LL_LDC + wn + 16 * j, acc[i][j],
                              LL_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < LL_BM * LL_BN; e += LL_THREADS) {
    const int r = e / LL_BN, c = e % LL_BN, m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      const float v = Cs[r * LL_LDC + c] + __bfloat162float(bias[n]);
      out[(size_t)m * N + n] = __float2bfloat16(apply_act(v, act));
    }
  }
}

}  // namespace cvlm

// x (M, K), w (N, K) [nn.Linear layout], bias (N,), out (M, N): bf16.
// gamma/beta (K,) fp32. Returns cudaGetLastError().
extern "C" int cvlm_ln_linear(const void* x, const void* gamma, const void* beta,
                              const void* w, const void* bias, void* out, int M,
                              int K, int N, float eps, int act, void* stream) {
  using namespace cvlm;
  const dim3 grid((N + LL_BN - 1) / LL_BN, (M + LL_BM - 1) / LL_BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bp = static_cast<const float*>(beta);
  const auto* wp = static_cast<const bf16*>(w);
  const auto* biasp = static_cast<const bf16*>(bias);
  auto* op = static_cast<bf16*>(out);
  ln_linear_kernel<false><<<grid, LL_THREADS, 0, s>>>(
      xp, gp, bp, nullptr, wp, biasp, op, M, K, N, 1, 1, eps, act);
  return (int)cudaGetLastError();
}

// x (B', S, K) with B' = B * nwin, mask (nwin, S, 1), w (N, K), bias (N,),
// out (B', S, N): bf16; gamma/beta (K,) fp32. No activation. Returns
// cudaGetLastError().
extern "C" int cvlm_ln_mask_linear(const void* x, const void* gamma, const void* beta,
                                   const void* mask, const void* w, const void* bias,
                                   void* out, int M, int K, int N, int S, int nwin,
                                   float eps, void* stream) {
  using namespace cvlm;
  const dim3 grid((N + LL_BN - 1) / LL_BN, (M + LL_BM - 1) / LL_BM);
  ln_linear_kernel<true><<<grid, LL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(mask),
      static_cast<const bf16*>(w), static_cast<const bf16*>(bias), static_cast<bf16*>(out),
      M, K, N, S, nwin, eps, ACT_NONE);
  return (int)cudaGetLastError();
}

extern "C" const char* cvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
