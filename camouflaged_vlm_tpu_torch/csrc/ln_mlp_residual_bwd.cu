// ln_mlp_residual_bwd: the backward of out = x + act(LN(x) . W1^T + b1) . W2^T + b2
// at the upstream gradient g, one kernel per 16-row block.
//
// Replaces _ln_mlp_residual_bwd_kernel of camouflaged_vlm_tpu/ops/linear.py
// (the custom_vjp backward of ln_mlp_residual_bt, site #6): SAM ViT-H's
// fused MLP in training, x and g (32, 196, 1280), (2, 1008, 1280) and
// (2, 4096, 1280), hidden H = 5120, gelu_tanh; 60 calls per step at batch 2.
//
// Per row block the kernel recomputes LN (fp32 statistics, xn rounded to
// bf16 as the forward rounds it), then walks the hidden dimension in chunks
// of 128 columns:
//   phase 1 (each of 8 warps one 16 x 16 tile): pre1 = xn . W1[chunk]^T + b1
//           and dh_pre = g . W2[:, chunk]; dh = act'(pre1) * dh_pre in fp32,
//           rounded to bf16 for the next product (the JAX kernel's rounding);
//   phase 2: dxn[16, K] += dh . W1[chunk, :], the fp32 accumulator in
//           registers, split across the warps (K/128 fragments each).
// The hidden (16 x 5120 per block, 5 (bs, H) fp32 transients in the TPU
// kernel) never reaches device memory. The epilogue stages dxn in shared
// memory for the per-row LN backward, dx = rstd * (dxhat - mean(dxhat) -
// xhat * mean(dxhat * xhat)) + g with dxhat = dxn * gamma.
//
// Only when a weight, bias or LN parameter needs its gradient (not on the
// SAM path, whose ViT weights are frozen) the kernel also writes dh and
// act(pre1) (M, H) and xn (M, K) in bf16 for the wrapper's two weight
// products (torch.matmul, as the JAX wrapper leaves them to XLA), and per
// block the fp32 column sums of dxn * xhat, dxn and dh (dgamma, dbeta, db1
// partials, summed by the wrapper).
//
// What bounds it on the H100: like the forward, every block streams W1 twice
// and W2 once (3 x 13 MB at ViT-H) from L2 through WMMA fragment loads for
// 16 rows of work, three GEMMs of 16 x 1280 x 5120; L2 bandwidth and the
// WMMA tile loop, not HBM. Shared memory at K = 1280: ~186 KB (xn and g rows
// in bf16, the fp32 dxn staging, two 16 x 128 fp32 tiles), one block per SM.
// Larger row tiles, TMA-fed weight tiles and wgmma are later work.
#include "common.cuh"

namespace cvlm {

constexpr int MB_BM = 16, MB_HC = 128, MB_THREADS = 256;
constexpr int MB_LDT = MB_HC + 4, MB_LDHB = MB_HC + 8;

// act'(v) of the activations in common.cuh
__device__ __forceinline__ float act_grad(float v, int act) {
  switch (act) {
    case ACT_GELU:
      return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) +
             v * expf(-0.5f * v * v) * 0.39894228040143268f;
    case ACT_GELU_TANH: {
      const float c = 0.79788456080286536f;
      const float t = tanhf(c * (v + 0.044715f * v * v * v));
      return 0.5f * (1.0f + t) + 0.5f * v * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * v * v);
    }
    case ACT_QUICK_GELU: {
      const float s = 1.0f / (1.0f + expf(-1.702f * v));
      return s + 1.702f * v * s * (1.0f - s);
    }
    default:
      return 1.0f;
  }
}

template <int NF>
__host__ __device__ constexpr size_t mlp_bwd_smem() {
  constexpr int K = 128 * NF;
  return sizeof(bf16) * 2 * MB_BM * (K + 8) + sizeof(float) * MB_BM * (K + 4) +
         sizeof(float) * 2 * MB_BM * MB_LDT + sizeof(bf16) * MB_BM * MB_LDHB +
         sizeof(float) * 2 * MB_BM;
}

struct MlpBwdSide {
  bf16 *dh, *hact, *xn;    // (M, H), (M, H), (M, K)
  float *dga, *dbe, *db1;  // (blocks, K), (blocks, K), (blocks, H)
};

template <int NF>  // K = 128 * NF: NF output fragments per warp
__global__ void __launch_bounds__(MB_THREADS) ln_mlp_residual_bwd_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ w1,
    const bf16* __restrict__ b1, const bf16* __restrict__ w2, const bf16* __restrict__ g,
    bf16* __restrict__ dx, MlpBwdSide side, int M, int H, float eps, int act) {
  constexpr int K = 128 * NF, LDX = K + 8, LDF = K + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xn = reinterpret_cast<bf16*>(smem);                   // 16 x LDX
  bf16* Gs = Xn + MB_BM * LDX;                                // 16 x LDX
  float* Dx = reinterpret_cast<float*>(Gs + MB_BM * LDX);     // 16 x LDF: dxn
  float* H1 = Dx + MB_BM * LDF;                               // 16 x LDT: pre1
  float* H2 = H1 + MB_BM * MB_LDT;                            // 16 x LDT: dh_pre, then dh
  bf16* Dh = reinterpret_cast<bf16*>(H2 + MB_BM * MB_LDT);    // 16 x LDHB
  float* mu_s = reinterpret_cast<float*>(Dh + MB_BM * MB_LDHB);
  float* rstd_s = mu_s + MB_BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * MB_BM;
  const int valid = M - m0 < MB_BM ? M - m0 : MB_BM;
  const bool weights = side.dh != nullptr;

  for (int r = warp; r < MB_BM; r += MB_THREADS / 32) {
    const int m = m0 + r;
    if (r < valid) {
      const bf16* row = x + (size_t)m * K;
      float mu, rstd;
      row_stats(row, K, eps, mu, rstd);
      for (int k = lane; k < K; k += 32) {
        const float xh = (__bfloat162float(row[k]) - mu) * rstd;
        Xn[r * LDX + k] = __float2bfloat16(xh * gamma[k] + beta[k]);
        Gs[r * LDX + k] = g[(size_t)m * K + k];
      }
      if (lane == 0) {
        mu_s[r] = mu;
        rstd_s[r] = rstd;
      }
    } else {
      for (int k = lane; k < K; k += 32) {
        Xn[r * LDX + k] = __float2bfloat16(0.f);
        Gs[r * LDX + k] = __float2bfloat16(0.f);
      }
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int hc0 = 0; hc0 < H; hc0 += MB_HC) {
    // phase 1: this warp's hidden columns j0 .. j0 + 16
    const int j0 = hc0 + 16 * warp;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> pf, df;
    wmma::fill_fragment(pf, 0.0f);
    wmma::fill_fragment(df, 0.0f);
#pragma unroll 4
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ax, ag;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b1f;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b2f;
      wmma::load_matrix_sync(ax, Xn + k, LDX);
      wmma::load_matrix_sync(ag, Gs + k, LDX);
      wmma::load_matrix_sync(b1f, w1 + (size_t)j0 * K + k, K);  // W1[j0.., k..]^T
      wmma::load_matrix_sync(b2f, w2 + (size_t)k * H + j0, H);  // W2[k.., j0..]
      wmma::mma_sync(pf, ax, b1f, pf);
      wmma::mma_sync(df, ag, b2f, df);
    }
    wmma::store_matrix_sync(H1 + 16 * warp, pf, MB_LDT, wmma::mem_row_major);
    wmma::store_matrix_sync(H2 + 16 * warp, df, MB_LDT, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = 16 * warp + (e & 15), j = hc0 + c;
      const float pre = H1[r * MB_LDT + c] + __bfloat162float(b1[j]);
      const float dh = act_grad(pre, act) * H2[r * MB_LDT + c];
      Dh[r * MB_LDHB + c] = __float2bfloat16(dh);
      H2[r * MB_LDT + c] = r < valid ? dh : 0.f;
      if (weights && r < valid) {
        const size_t o = (size_t)(m0 + r) * H + j;
        side.dh[o] = __float2bfloat16(dh);
        side.hact[o] = __float2bfloat16(apply_act(pre, act));
      }
    }
    __syncwarp();
    if (weights && lane < 16) {
      float s = 0.f;
      for (int r = 0; r < MB_BM; ++r) s += H2[r * MB_LDT + 16 * warp + lane];
      side.db1[(size_t)blockIdx.x * H + j0 + lane] = s;
    }
    __syncthreads();

    // phase 2: dxn[16, K] += dh[16, 128] . W1[hc0:hc0+128, :]
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ha[MB_HC / 16];
#pragma unroll
    for (int kk = 0; kk < MB_HC / 16; ++kk) wmma::load_matrix_sync(ha[kk], Dh + 16 * kk, MB_LDHB);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int n0 = (warp * NF + f) * 16;
#pragma unroll
      for (int kk = 0; kk < MB_HC / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, w1 + (size_t)(hc0 + 16 * kk) * K + n0, K);
        wmma::mma_sync(acc[f], ha[kk], b, acc[f]);
      }
    }
    __syncthreads();  // Dh, H1 and H2 are rewritten by the next chunk
  }

  // epilogue: dxn to shared memory, then the LN backward per row
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(Dx + (warp * NF + f) * 16, acc[f], LDF, wmma::mem_row_major);
  __syncthreads();
  for (int r = warp; r < valid; r += MB_THREADS / 32) {
    const size_t m = m0 + r;
    const float mu = mu_s[r], rstd = rstd_s[r];
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float xh = (__bfloat162float(x[m * K + k]) - mu) * rstd;
      const float dxh = Dx[r * LDF + k] * gamma[k];
      s1 += dxh;
      s2 += dxh * xh;
    }
    const float m1 = warp_sum(s1) / (float)K, m2 = warp_sum(s2) / (float)K;
    for (int k = lane; k < K; k += 32) {
      const float xh = (__bfloat162float(x[m * K + k]) - mu) * rstd;
      const float dxh = Dx[r * LDF + k] * gamma[k];
      dx[m * K + k] = __float2bfloat16(rstd * (dxh - m1 - xh * m2) +
                                       __bfloat162float(Gs[r * LDX + k]));
      if (weights) side.xn[m * K + k] = Xn[r * LDX + k];
    }
  }
  if (weights) {
    for (int k = tid; k < K; k += MB_THREADS) {
      float sg = 0.f, sb = 0.f;
      for (int r = 0; r < valid; ++r) {
        const float xh = (__bfloat162float(x[(size_t)(m0 + r) * K + k]) - mu_s[r]) * rstd_s[r];
        sg += Dx[r * LDF + k] * xh;
        sb += Dx[r * LDF + k];
      }
      side.dga[(size_t)blockIdx.x * K + k] = sg;
      side.dbe[(size_t)blockIdx.x * K + k] = sb;
    }
  }
}

template <int NF>
int launch_ln_mlp_bwd(const void* x, const void* gamma, const void* beta, const void* w1,
                      const void* b1, const void* w2, const void* g, void* dx,
                      const MlpBwdSide& side, int M, int H, float eps, int act, cudaStream_t s) {
  constexpr size_t smem = mlp_bwd_smem<NF>();
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_residual_bwd_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + MB_BM - 1) / MB_BM);
  ln_mlp_residual_bwd_kernel<NF><<<grid, MB_THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2), static_cast<const bf16*>(g),
      static_cast<bf16*>(dx), side, M, H, eps, act);
  return (int)cudaGetLastError();
}

}  // namespace cvlm

// x/g/dx (M, K), w1 (H, K), b1 (H,), w2 (K, H): bf16; gamma/beta (K,) fp32.
// dh/hact (M, H) and xn (M, K) bf16, dga/dbe (ceil(M/16), K) and db1
// (ceil(M/16), H) fp32: all given (the weight side) or all null. K = 128 * NF
// with 1 <= NF <= 10, H a multiple of 128 (the wrapper checks). Returns
// cudaGetLastError().
extern "C" int cvlm_ln_mlp_residual_bwd(const void* x, const void* gamma, const void* beta,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* g, void* dx, void* dh, void* hact, void* xn,
                                        void* dga, void* dbe, void* db1, int M, int K, int H,
                                        float eps, int act, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MlpBwdSide side{static_cast<bf16*>(dh), static_cast<bf16*>(hact), static_cast<bf16*>(xn),
                        static_cast<float*>(dga), static_cast<float*>(dbe),
                        static_cast<float*>(db1)};
  if ((dh == nullptr) != (db1 == nullptr)) return (int)cudaErrorInvalidValue;
  switch (K / 128) {
#define CVLM_MLP_BWD_CASE(nf) \
  case nf:                    \
    return launch_ln_mlp_bwd<nf>(x, gamma, beta, w1, b1, w2, g, dx, side, M, H, eps, act, s);
    CVLM_MLP_BWD_CASE(1)
    CVLM_MLP_BWD_CASE(2)
    CVLM_MLP_BWD_CASE(3)
    CVLM_MLP_BWD_CASE(4)
    CVLM_MLP_BWD_CASE(5)
    CVLM_MLP_BWD_CASE(6)
    CVLM_MLP_BWD_CASE(7)
    CVLM_MLP_BWD_CASE(8)
    CVLM_MLP_BWD_CASE(9)
    CVLM_MLP_BWD_CASE(10)
#undef CVLM_MLP_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
