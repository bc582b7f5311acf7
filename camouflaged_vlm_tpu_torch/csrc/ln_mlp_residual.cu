// ln_mlp_residual: out = x + act(LN(x) . W1^T + b1) . W2^T + b2, one kernel.
//
// Replaces ln_mlp_residual_bt of camouflaged_vlm_tpu/ops/linear.py: the
// hidden-grid TPU kernel (_ln_mlp_residual_hgrid_kernel, CLIP vision and
// text MLPs) and the single-chunk one (_ln_mlp_residual_bt_kernel, SAM),
// which compute the same function; `hidden_grid` is a TPU tiling knob.
//
// Shapes on the main path (bf16): CLIP vision x (B*581, 1024), H 4096;
// CLIP text x (61*77, 768), H 3072; quick_gelu. The 4*dim hidden never
// reaches device memory: a block owns 16 rows, computes LN once into shared
// memory (rounded to bf16 as the TPU kernel does, linear.py:351), then walks
// the hidden dimension in chunks of 128 columns:
//   phase 1: h = xn . W1[chunk]^T       (each of 8 warps one 16x16 tile)
//            h = act(h + b1), rounded to bf16 (linear.py:359)
//   phase 2: acc[16, K] += h . W2[:, chunk]^T
// The fp32 accumulator for the block's 16 x K output lives in registers,
// split across the 8 warps (K/128 fragments each), so it needs no shared
// memory: at K = 1024 a 64-row fp32 accumulator alone would be 256 KB, more
// than the 227 KB a block may use. Exact up to fp32 summation order, since
// the activation is elementwise in the hidden dimension.
//
// What bounds it on the H100: every block streams all of W1 and W2 (16 MB at
// CLIP-L) from L2 through WMMA fragment loads, and only M/16 blocks exist
// (73 at batch 2), so it is L2-bandwidth- and occupancy-bound, far from the
// tensor-core rate. Larger row tiles with the accumulator split over a
// cluster, and TMA-fed weight tiles, are later work.
#include "common.cuh"

namespace cvlm {

constexpr int MLP_BM = 16, MLP_HC = 128, MLP_THREADS = 256;
constexpr int MLP_LDH32 = MLP_HC + 4, MLP_LDHB = MLP_HC + 8;

template <int NF>  // K = 128 * NF: NF output fragments per warp
__global__ void __launch_bounds__(MLP_THREADS) ln_mlp_residual_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ w1,
    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, bf16* __restrict__ out, int M, int H, float eps,
    int act) {
  constexpr int K = 128 * NF, LDX = K + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xn = reinterpret_cast<bf16*>(smem);                        // 16 x LDX
  float* H32 = reinterpret_cast<float*>(Xn + MLP_BM * LDX);        // 16 x LDH32
  bf16* Hb = reinterpret_cast<bf16*>(H32 + MLP_BM * MLP_LDH32);    // 16 x LDHB

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * MLP_BM;

  for (int r = warp; r < MLP_BM; r += MLP_THREADS / 32) {
    const int m = m0 + r;
    if (m < M) {
      const bf16* row = x + (size_t)m * K;
      float mu, rstd;
      row_stats(row, K, eps, mu, rstd);
      for (int k = lane; k < K; k += 32) {
        const float xn = (__bfloat162float(row[k]) - mu) * rstd;
        Xn[r * LDX + k] = __float2bfloat16(xn * gamma[k] + beta[k]);
      }
    } else {
      for (int k = lane; k < K; k += 32) Xn[r * LDX + k] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  float* h32 = H32 + 16 * warp;  // this warp's 16x16 staging tile
  for (int hc0 = 0; hc0 < H; hc0 += MLP_HC) {
    // phase 1: this warp's hidden columns hc0 + 16*warp .. + 16
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hf;
    wmma::fill_fragment(hf, 0.0f);
    const bf16* w1p = w1 + (size_t)(hc0 + 16 * warp) * K;
#pragma unroll 4
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, Xn + k, LDX);
      wmma::load_matrix_sync(b, w1p + k, K);
      wmma::mma_sync(hf, a, b, hf);
    }
    wmma::store_matrix_sync(h32, hf, MLP_LDH32, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15;
      const float v = h32[r * MLP_LDH32 + c] + __bfloat162float(b1[hc0 + 16 * warp + c]);
      Hb[r * MLP_LDHB + 16 * warp + c] = __float2bfloat16(apply_act(v, act));
    }
    __syncthreads();

    // phase 2: acc[16, K] += h[16, 128] . W2[:, hc0:hc0+128]^T
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ha[MLP_HC / 16];
#pragma unroll
    for (int kk = 0; kk < MLP_HC / 16; ++kk)
      wmma::load_matrix_sync(ha[kk], Hb + 16 * kk, MLP_LDHB);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const bf16* w2p = w2 + (size_t)((warp * NF + f) * 16) * H + hc0;
#pragma unroll
      for (int kk = 0; kk < MLP_HC / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, w2p + 16 * kk, H);
        wmma::mma_sync(acc[f], ha[kk], b, acc[f]);
      }
    }
    __syncthreads();  // Hb is rewritten by the next chunk
  }

  // epilogue: + b2 + residual x in fp32, one rounding
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int n0 = (warp * NF + f) * 16;
    wmma::store_matrix_sync(h32, acc[f], MLP_LDH32, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15, m = m0 + r, n = n0 + c;
      if (m < M) {
        const float v = h32[r * MLP_LDH32 + c] + __bfloat162float(b2[n]) +
                        __bfloat162float(x[(size_t)m * K + n]);
        out[(size_t)m * K + n] = __float2bfloat16(v);
      }
    }
    __syncwarp();
  }
}

template <int NF>
int launch_ln_mlp(const void* x, const void* gamma, const void* beta, const void* w1,
                  const void* b1, const void* w2, const void* b2, void* out, int M,
                  int H, float eps, int act, cudaStream_t s) {
  constexpr int K = 128 * NF;
  const size_t smem = sizeof(bf16) * MLP_BM * (K + 8) +
                      sizeof(float) * MLP_BM * MLP_LDH32 +
                      sizeof(bf16) * MLP_BM * MLP_LDHB;
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_residual_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + MLP_BM - 1) / MLP_BM);
  ln_mlp_residual_kernel<NF><<<grid, MLP_THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), M, H, eps, act);
  return (int)cudaGetLastError();
}

}  // namespace cvlm

// x/out (M, K), w1 (H, K), b1 (H,), w2 (K, H), b2 (K,): bf16; gamma/beta
// (K,) fp32. K must be 128 * NF with 1 <= NF <= 10 and H a multiple of 128
// (the wrapper checks). Returns cudaGetLastError().
extern "C" int cvlm_ln_mlp_residual(const void* x, const void* gamma,
                                    const void* beta, const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* out, int M,
                                    int K, int H, float eps, int act, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K / 128) {
#define CVLM_MLP_CASE(nf) \
  case nf:                \
    return launch_ln_mlp<nf>(x, gamma, beta, w1, b1, w2, b2, out, M, H, eps, act, s);
    CVLM_MLP_CASE(1)
    CVLM_MLP_CASE(2)
    CVLM_MLP_CASE(3)
    CVLM_MLP_CASE(4)
    CVLM_MLP_CASE(5)
    CVLM_MLP_CASE(6)
    CVLM_MLP_CASE(7)
    CVLM_MLP_CASE(8)
    CVLM_MLP_CASE(9)
    CVLM_MLP_CASE(10)
#undef CVLM_MLP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
