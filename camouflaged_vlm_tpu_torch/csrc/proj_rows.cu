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
// #8/#9 (fused 'flash' at windows of 17 and more, bf16): x (B, 16, 16, 289,
// 80), W (1280, 1280), res (B, 16, 289, 1280). The head-leading tile is
// gathered as row (b, t, s) and k = h*d + j from x[b, h, t, s, j] (j
// contiguous, 8 values per 16-byte load), k-major in shared memory, and fed
// to WMMA as a column-major matrix_a; W is staged row-per-output-column.
// The residual and bias are added to the fp32 accumulator and rounded once,
// as the TPU kernels do (linear.py:653, :748).
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace cvlm {

constexpr int PR_BM = 64, PR_BN = 64, PR_BK = 32, PR_THREADS = 128;
constexpr int PR_LDA = PR_BM + 8;   // A staged k-major: As[k][s]
constexpr int PR_LDB = PR_BK + 8;   // B staged n-major: Bs[n][k]
constexpr int PR_LDC = PR_BN + 4;

// x (B, K/d, T, S, d) head-leading, group g = b * T + t.
__global__ void __launch_bounds__(PR_THREADS) proj_heads_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, const bf16* __restrict__ res,
    bf16* __restrict__ out, int S, int K, int N, int T, int d) {
  __shared__ __align__(128) bf16 As[PR_BK * PR_LDA];
  __shared__ __align__(128) bf16 Bs[PR_BN * PR_LDB];
  __shared__ __align__(128) float Cs[PR_BM * PR_LDC];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int s0 = blockIdx.y * PR_BM, n0 = blockIdx.x * PR_BN, g = blockIdx.z;
  // the group's element (k, s) at (k / d) * T*S*d + s * d + k % d from the
  // group's (b, h = 0, t) block
  const bf16* xg = x + ((size_t)(g / T) * (K / d) * T + g % T) * S * d;
  const size_t head_stride = (size_t)T * S * d;

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += PR_BK) {
    // 8 consecutive k of one row lie in one head (d % 8 == 0): one 16-byte
    // load, neighbouring threads on neighbouring k
    for (int e = tid; e < PR_BM * (PR_BK / 8); e += PR_THREADS) {
      const int c = e / (PR_BK / 8), kr = (e % (PR_BK / 8)) * 8, k = k0 + kr, s = s0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < K && s < S)
        v = *reinterpret_cast<const uint4*>(xg + (size_t)(k / d) * head_stride +
                                            (size_t)s * d + k % d);
      const bf16* vv = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) As[(kr + i) * PR_LDA + c] = vv[i];
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

// x (G, K, S) with s contiguous and row stride ldk, group stride ldg (in
// elements, multiples of 8; ldk >= S), w (N, K) [nn.Linear layout], bias
// (N,), res (G, S, N) or NULL, out (G, S, N): bf16, bases 16-byte aligned;
// K % 8 == 0 and N % 8 == 0 with res; bn the tile width (128 or 256).
// Returns a cudaError_t code.
extern "C" int cvlm_proj_rows(const void* x, const void* w, const void* bias,
                              const void* res, void* out, int G, int S, long long ldk,
                              long long ldg, int K, int N, int bn, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr)
    return launch_gemm_mn<EPI_BIAS_RESIDUAL>(x, ldk, ldg, w, bias, res, out, G, S, N, K,
                                             ACT_NONE, bn, s);
  return launch_gemm_mn<EPI_BIAS_ACT>(x, ldk, ldg, w, bias, nullptr, out, G, S, N, K, ACT_NONE,
                                      bn, s);
}

// x (B, heads, T, S, d) head-leading, d % 8 == 0, w (N, heads*d) [nn.Linear
// layout], bias (N,), res (B, T, S, N) or NULL, out (B, T, S, N): bf16.
// Returns cudaGetLastError().
extern "C" int cvlm_proj_from_heads(const void* x, const void* w, const void* bias,
                                    const void* res, void* out, int B, int heads, int T,
                                    int S, int d, int N, void* stream) {
  using namespace cvlm;
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + PR_BN - 1) / PR_BN, (S + PR_BM - 1) / PR_BM, B * T);
  proj_heads_kernel<<<grid, PR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(res), static_cast<bf16*>(out),
      S, heads * d, N, T, d);
  return (int)cudaGetLastError();
}
