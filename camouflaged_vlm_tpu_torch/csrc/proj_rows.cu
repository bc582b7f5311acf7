// proj_rows: out[g, s, :] = x[g, :, s]^T . W^T + b (+ res[g, s, :]).
//
// Replaces proj_rows of camouflaged_vlm_tpu/ops/linear.py (_proj_rows_kernel
// and _proj_rows_res_kernel): the attention out-projection that reads the
// attention kernel's d-major (heads*d, S) output and writes row-major rows,
// with the block's residual added in the epilogue.
//
// Shapes on the main path (bf16): CLIP vision x (B, 1, 1024, 581) d-major,
// W (1024, 1024), res (B, 1, 581, 1024). A small product (1.2 GFLOP per
// image); on the H100 it is bound by tile staging and the ragged 581-row
// edge rather than by the tensor cores. The d-major A tile is staged into
// shared memory as it lies (s contiguous, so the loads coalesce) and fed to
// WMMA as a column-major matrix_a; W is staged row-per-output-column. The
// residual and bias are added to the fp32 accumulator and rounded once, as
// the TPU kernel does (linear.py:653).
#include "common.cuh"

namespace cvlm {

constexpr int PR_BM = 64, PR_BN = 64, PR_BK = 32, PR_THREADS = 128;
constexpr int PR_LDA = PR_BM + 8;   // A staged k-major: As[k][s]
constexpr int PR_LDB = PR_BK + 8;   // B staged n-major: Bs[n][k]
constexpr int PR_LDC = PR_BN + 4;

__global__ void __launch_bounds__(PR_THREADS) proj_rows_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, const bf16* __restrict__ res,
    bf16* __restrict__ out, int S, int K, int N) {
  __shared__ __align__(128) bf16 As[PR_BK * PR_LDA];
  __shared__ __align__(128) bf16 Bs[PR_BN * PR_LDB];
  __shared__ __align__(128) float Cs[PR_BM * PR_LDC];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int s0 = blockIdx.y * PR_BM, n0 = blockIdx.x * PR_BN, g = blockIdx.z;
  const bf16* xg = x + (size_t)g * K * S;

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += PR_BK) {
    for (int e = tid; e < PR_BK * PR_BM; e += PR_THREADS) {
      const int kr = e / PR_BM, c = e % PR_BM, k = k0 + kr, s = s0 + c;
      As[kr * PR_LDA + c] =
          (k < K && s < S) ? xg[(size_t)k * S + s] : __float2bfloat16(0.f);
    }
    for (int e = tid; e < PR_BN * PR_BK; e += PR_THREADS) {
      const int r = e / PR_BK, c = e % PR_BK, n = n0 + r, k = k0 + c;
      Bs[r * PR_LDB + c] =
          (n < N && k < K) ? w[(size_t)n * K + k] : __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PR_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + kk * PR_LDA + wm + 16 * i, PR_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn + 16 * j) * PR_LDB + kk, PR_LDB);
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
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * PR_LDC + wn + 16 * j, acc[i][j],
                              PR_LDC, wmma::mem_row_major);
  __syncthreads();
  const size_t row0 = (size_t)g * S;
  for (int e = tid; e < PR_BM * PR_BN; e += PR_THREADS) {
    const int r = e / PR_BN, c = e % PR_BN, s = s0 + r, n = n0 + c;
    if (s < S && n < N) {
      const size_t o = (row0 + s) * N + n;
      float v = Cs[r * PR_LDC + c] + __bfloat162float(bias[n]);
      if (res != nullptr) v += __bfloat162float(res[o]);
      out[o] = __float2bfloat16(v);
    }
  }
}

}  // namespace cvlm

// x (G, K, S) d-major, w (N, K) [nn.Linear layout], bias (N,), res (G, S, N)
// or NULL, out (G, S, N): bf16. Returns cudaGetLastError().
extern "C" int cvlm_proj_rows(const void* x, const void* w, const void* bias,
                              const void* res, void* out, int G, int S, int K, int N,
                              void* stream) {
  using namespace cvlm;
  const dim3 grid((N + PR_BN - 1) / PR_BN, (S + PR_BM - 1) / PR_BM, G);
  proj_rows_kernel<<<grid, PR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
      static_cast<bf16*>(out), S, K, N);
  return (int)cudaGetLastError();
}
