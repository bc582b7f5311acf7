// ln_mlp_residual_f32: out = x + act(LN(x) . W1^T + b1) . W2^T + b2, all in
// float32.
//
// Replaces ln_mlp_residual_bt of camouflaged_vlm_tpu/ops/linear.py (the
// hidden-grid TPU kernel #4 and the single-chunk one #5, which compute the
// same function) where the JAX package runs it in float32: the CLIP text
// tower of `precompute_text_bank` (`AlphaClipConfig.vit_l_14_336()`, whose
// dtype is float32). At float32 the TPU kernel has no rounding point: its
// LN rows and hidden are float32 (linear.py:346-364), so neither is here.
//
// Shapes on that path: x (prompts * 77, 768) per class (camoprompts 6
// prompts: 462 rows; imagenet80: 6160), H 3072, quick_gelu, eps 1e-5. What
// bounds it on the H100 is the float32 rate of the CUDA cores (67 TFLOP/s,
// the tensor cores have no float32 mode; TF32 keeps ~3 digits and is not
// used): at 462 rows 4.36 GFLOP, 0.065 ms, against 23 MB of input, weights
// and output (0.007 ms at 3.35 TB/s).
//
// Design: three launches per row panel on the caller's stream.
//   1. ln_rows_f32_kernel, one warp per row: two-pass statistics (mean,
//      then the mean of squared deviations, the JAX formulation), xn =
//      (x - mu) * rstd * gamma + beta into an fp32 scratch;
//   2. fc1, sgemm_nt_kernel<EPI_ACT>: h = act(xn . W1^T + b1) into an fp32
//      hidden scratch of `rows` rows (the wrapper's row panels,
//      ops/linear.py mlp_panel_rows, as for the bf16 kernel);
//   3. fc2, sgemm_nt_kernel<EPI_RESIDUAL>: out = h . W2^T + b2 + x.
// The GEMM is the classic tiled FFMA product: A (M, K) and W (N, K) both
// K-contiguous, 16-deep k tiles staged transposed in shared memory (double
// buffered, the next tile's global loads in registers during the current
// tile's products), 256 threads a block, each an 8 x 8 (128 x 128 tile) or
// 4 x 4 (64 x 64 tile) block of outputs in registers; the wrapper takes the
// 64-wide tile when the 128-wide tiles would not cover the card's SMs once.
// Ragged M and N are masked; K % 4 == 0 and N % 4 == 0 (16-byte loads and
// stores, the wrapper checks).
#include "common.cuh"

namespace cvlm {
namespace {

constexpr int F32_THREADS = 256;
constexpr int F32_BK = 16;
constexpr int F32_PAD = 4;  // keeps the transposed stores at 2-way bank conflicts

enum F32Epi { EPI_ACT = 0, EPI_RESIDUAL = 1 };

__global__ void __launch_bounds__(F32_THREADS) ln_rows_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ xn, int M, int K, float eps) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (F32_THREADS / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const float4* row = reinterpret_cast<const float4*>(x + (size_t)m * K);
  const int nv = K / 4;
  float s = 0.f;
  for (int c = lane; c < nv; c += 32) {
    const float4 v = row[c];
    s += v.x + v.y + v.z + v.w;
  }
  const float mu = warp_sum(s) / (float)K;
  float q = 0.f;
  for (int c = lane; c < nv; c += 32) {
    const float4 v = row[c];
    q += (v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu) + (v.z - mu) * (v.z - mu) +
         (v.w - mu) * (v.w - mu);
  }
  const float rstd = 1.0f / sqrtf(warp_sum(q) / (float)K + eps);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  float4* dst = reinterpret_cast<float4*>(xn + (size_t)m * K);
  for (int c = lane; c < nv; c += 32) {
    const float4 v = row[c], g = g4[c], b = b4[c];
    dst[c] = make_float4((v.x - mu) * rstd * g.x + b.x, (v.y - mu) * rstd * g.y + b.y,
                         (v.z - mu) * rstd * g.z + b.z, (v.w - mu) * rstd * g.w + b.w);
  }
}

// C (M, N) = epilogue(A (M, K) . W (N, K)^T): HM x HN groups of 4 x 4
// outputs a thread (the groups 64 rows / columns apart), so the block tile
// is (64 HM) x (64 HN). EPI_ACT: act(acc + bias); EPI_RESIDUAL: acc + bias
// + res (M, N).
template <int HM, int HN, int EPI>
__global__ void __launch_bounds__(F32_THREADS) sgemm_nt_kernel(
    const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ bias,
    const float* __restrict__ res, float* __restrict__ C, int M, int N, int K, int act) {
  constexpr int BM = 64 * HM, BN = 64 * HN;
  __shared__ __align__(16) float As[2][F32_BK][BM + F32_PAD];
  __shared__ __align__(16) float Ws[2][F32_BK][BN + F32_PAD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // each thread stages HM float4s of A's tile and HN of W's: row r = idx / 4,
  // k columns 4 (idx % 4) .. +3
  float4 ra[HM], rw[HN];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < HM; ++i) {
      const int idx = tid + i * F32_THREADS, r = idx / 4, k = k0 + (idx % 4) * 4;
      ra[i] = (m0 + r < M && k < K)
                  ? *reinterpret_cast<const float4*>(A + (size_t)(m0 + r) * K + k)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < HN; ++i) {
      const int idx = tid + i * F32_THREADS, r = idx / 4, k = k0 + (idx % 4) * 4;
      rw[i] = (n0 + r < N && k < K)
                  ? *reinterpret_cast<const float4*>(W + (size_t)(n0 + r) * K + k)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < HM; ++i) {
      const int idx = tid + i * F32_THREADS, r = idx / 4, k = (idx % 4) * 4;
      As[buf][k][r] = ra[i].x;
      As[buf][k + 1][r] = ra[i].y;
      As[buf][k + 2][r] = ra[i].z;
      As[buf][k + 3][r] = ra[i].w;
    }
#pragma unroll
    for (int i = 0; i < HN; ++i) {
      const int idx = tid + i * F32_THREADS, r = idx / 4, k = (idx % 4) * 4;
      Ws[buf][k][r] = rw[i].x;
      Ws[buf][k + 1][r] = rw[i].y;
      Ws[buf][k + 2][r] = rw[i].z;
      Ws[buf][k + 3][r] = rw[i].w;
    }
  };

  float acc[4 * HM][4 * HN];
#pragma unroll
  for (int i = 0; i < 4 * HM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * HN; ++j) acc[i][j] = 0.f;

  const int nk = (K + F32_BK - 1) / F32_BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * F32_BK);
#pragma unroll
    for (int k = 0; k < F32_BK; ++k) {
      float a[4 * HM], w[4 * HN];
#pragma unroll
      for (int h = 0; h < HM; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(&As[cur][k][64 * h + 4 * ty]);
        a[4 * h] = v.x;
        a[4 * h + 1] = v.y;
        a[4 * h + 2] = v.z;
        a[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < HN; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(&Ws[cur][k][64 * h + 4 * tx]);
        w[4 * h] = v.x;
        w[4 * h + 1] = v.y;
        w[4 * h + 2] = v.z;
        w[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * HM; ++i)
#pragma unroll
        for (int j = 0; j < 4 * HN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    // the other buffer was last read before the previous iteration's barrier
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4 * HM; ++i) {
    const int m = m0 + 64 * (i / 4) + 4 * ty + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < HN; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      if (n >= N) continue;
      const float4 b = *reinterpret_cast<const float4*>(bias + n);
      float v[4] = {acc[i][4 * h] + b.x, acc[i][4 * h + 1] + b.y, acc[i][4 * h + 2] + b.z,
                    acc[i][4 * h + 3] + b.w};
      if (EPI == EPI_RESIDUAL) {
        const float4 r = *reinterpret_cast<const float4*>(res + (size_t)m * N + n);
        v[0] += r.x;
        v[1] += r.y;
        v[2] += r.z;
        v[3] += r.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = apply_act(v[c], act);
      }
      *reinterpret_cast<float4*>(C + (size_t)m * N + n) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int EPI>
int launch_sgemm(const float* A, const float* W, const float* bias, const float* res,
                 float* C, int M, int N, int K, int act, int tile, cudaStream_t s) {
  const dim3 block(F32_THREADS);
  if (tile == 128) {
    const dim3 grid((N + 127) / 128, (M + 127) / 128);
    sgemm_nt_kernel<2, 2, EPI><<<grid, block, 0, s>>>(A, W, bias, res, C, M, N, K, act);
  } else if (tile == 64) {
    const dim3 grid((N + 63) / 64, (M + 63) / 64);
    sgemm_nt_kernel<1, 1, EPI><<<grid, block, 0, s>>>(A, W, bias, res, C, M, N, K, act);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cvlm

// x/out (M, K), w1 (H, K), b1 (H,), w2 (K, H), b2 (K,), gamma/beta (K,): all
// fp32; xn (rows, K) and h (rows, H) fp32 scratch; K % 4 == 0 and H % 4 ==
// 0; t1/t2 the two GEMMs' tile widths (64 or 128). Returns a cudaError_t
// code.
extern "C" int cvlm_ln_mlp_residual_f32(const void* x, const void* gamma, const void* beta,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* b2, void* out, void* xn, void* h, int M,
                                        int K, int H, int rows, float eps, int act, int t1,
                                        int t2, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || rows < 1 || K < 4 || K % 4 != 0 || H % 4 != 0) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  auto* op = static_cast<float*>(out);
  auto* xnp = static_cast<float*>(xn);
  auto* hp = static_cast<float*>(h);
  for (int r0 = 0; r0 < M; r0 += rows) {
    const int m = M - r0 < rows ? M - r0 : rows;
    const float* xr = xp + (size_t)r0 * K;
    ln_rows_f32_kernel<<<(m + F32_THREADS / 32 - 1) / (F32_THREADS / 32), F32_THREADS, 0, s>>>(
        xr, static_cast<const float*>(gamma), static_cast<const float*>(beta), xnp, m, K, eps);
    int err = (int)cudaGetLastError();
    if (!err)
      err = launch_sgemm<EPI_ACT>(xnp, static_cast<const float*>(w1),
                                  static_cast<const float*>(b1), nullptr, hp, m, H, K, act, t1,
                                  s);
    if (!err)
      err = launch_sgemm<EPI_RESIDUAL>(hp, static_cast<const float*>(w2),
                                       static_cast<const float*>(b2), xr, op + (size_t)r0 * K, m,
                                       K, H, ACT_NONE, t2, s);
    if (err) return err;
  }
  return 0;
}
