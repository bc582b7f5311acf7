// qkv_packed_plain: per head, o = softmax((q*scale) . k^T) . v, no bias,
// read straight from the packed qkv projection, written d-major.
//
// Replaces flash_qkv_packed_plain of camouflaged_vlm_tpu/ops/flash_attention.py
// (_qkv_packed_plain_kernel): CLIP vision attention. Input qkv (B, S, 3*H*d)
// with the last axis laid out [q heads | k heads | v heads]; output
// (B, H*d, S), the d-major layout proj_rows reads.
//
// Shapes on the main path (bf16): S = 577 + 4 VPT = 581, 16 heads, d = 64.
// One block owns 32 queries of one head and holds their whole score rows
// (32 x 640 fp32) in shared memory, so the softmax is the exact two-pass
// one of the JAX reference: max-subtracted, divided by the row sum, the
// normalised probabilities rounded to bf16 before P.V
// (flash_attention.py:901). The TPU kernel's constant-shift softmax exists
// for the TPU and is not carried over. q*scale is rounded to bf16 first
// (flash_attention.py:858). Key tiles of 64 are staged through shared
// memory; keys past S are zero-filled and excluded from the softmax.
//
// What bounds it on the H100: ~0.6 GFLOP per image at 16 heads, spread over
// 19 x 16 x B blocks of 4 warps; the score matrix round trip through shared
// memory and the per-tile synchronisation dominate, not the tensor cores.
// An online-softmax (flash) version with wgmma is later work.
#include "common.cuh"

namespace cvlm {

constexpr int QP_BQ = 32, QP_KT = 64, QP_THREADS = 128;

template <int DH>
__global__ void __launch_bounds__(QP_THREADS) qkv_packed_plain_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out, int S, int heads,
    float scale) {
  constexpr int LDH = DH + 8;
  constexpr int NW = QP_THREADS / 32;
  const int Spad = (S + QP_KT - 1) / QP_KT * QP_KT;
  const int LDS = Spad + 4, LDP = Spad + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  // scores (BQ x LDS), later reused for the O tile (BQ x DH+4)
  float* Ss = reinterpret_cast<float*>(smem);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + QP_BQ * ((Spad > DH ? Spad : DH) + 4));  // BQ x LDP
  bf16* Qs = Ps + QP_BQ * LDP;                           // BQ x LDH
  bf16* KV = Qs + QP_BQ * LDH;                           // KT x LDH

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QP_BQ, h = blockIdx.y, b = blockIdx.z;
  const int C3 = 3 * heads * DH;
  const bf16* base = qkv + (size_t)b * S * C3;
  const float sc = __bfloat162float(__float2bfloat16(scale));  // scale in bf16

  for (int e = tid; e < QP_BQ * DH; e += QP_THREADS) {
    const int r = e / DH, c = e % DH, q = q0 + r;
    float v = 0.f;
    if (q < S) v = __bfloat162float(base[(size_t)q * C3 + h * DH + c]) * sc;
    Qs[r * LDH + c] = __float2bfloat16(v);
  }

  // scores: 2 x 4 fragments per key tile, two per warp
  const int si = warp & 1, sj = (warp >> 1) * 2;
  for (int kt = 0; kt < Spad; kt += QP_KT) {
    __syncthreads();
    for (int e = tid; e < QP_KT * DH; e += QP_THREADS) {
      const int r = e / DH, c = e % DH, k = kt + r;
      KV[r * LDH + c] = k < S ? base[(size_t)k * C3 + (heads + h) * DH + c]
                              : __float2bfloat16(0.f);
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sfr[2];
    wmma::fill_fragment(sfr[0], 0.0f);
    wmma::fill_fragment(sfr[1], 0.0f);
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + 16 * si * LDH + kk, LDH);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, KV + 16 * (sj + j) * LDH + kk, LDH);
        wmma::mma_sync(sfr[j], a, bk, sfr[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Ss + 16 * si * LDS + kt + 16 * (sj + j), sfr[j], LDS,
                              wmma::mem_row_major);
  }
  __syncthreads();

  // exact softmax over the S real keys, one warp per row
  for (int r = warp; r < QP_BQ; r += NW) {
    float* row = Ss + r * LDS;
    float mx = -INFINITY;
    for (int k = lane; k < S; k += 32) mx = fmaxf(mx, row[k]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < S; k += 32) {
      const float e = expf(row[k] - mx);
      row[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int k = lane; k < Spad; k += 32)
      Ps[r * LDP + k] = __float2bfloat16(k < S ? row[k] / sum : 0.f);
  }

  // O = P . V: (BQ/16) x (DH/16) fragments spread over the warps
  constexpr int NOF = (QP_BQ / 16) * (DH / 16);
  constexpr int PER_WARP = (NOF + NW - 1) / NW;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[PER_WARP];
#pragma unroll
  for (int f = 0; f < PER_WARP; ++f) wmma::fill_fragment(of[f], 0.0f);
  for (int kt = 0; kt < Spad; kt += QP_KT) {
    __syncthreads();
    for (int e = tid; e < QP_KT * DH; e += QP_THREADS) {
      const int r = e / DH, c = e % DH, k = kt + r;
      KV[r * LDH + c] = k < S ? base[(size_t)k * C3 + (2 * heads + h) * DH + c]
                              : __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < PER_WARP; ++f) {
      const int idx = warp + NW * f;
      if (idx < NOF) {
        const int i = idx % (QP_BQ / 16), j = idx / (QP_BQ / 16);
#pragma unroll
        for (int kk = 0; kk < QP_KT; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(a, Ps + 16 * i * LDP + kt + kk, LDP);
          wmma::load_matrix_sync(bv, KV + kk * LDH + 16 * j, LDH);
          wmma::mma_sync(of[f], a, bv, of[f]);
        }
      }
    }
  }
  __syncthreads();

  // stage O in the (now free) score buffer, then write d-major
  constexpr int LDO = DH + 4;
  float* Os = Ss;
#pragma unroll
  for (int f = 0; f < PER_WARP; ++f) {
    const int idx = warp + NW * f;
    if (idx < NOF) {
      const int i = idx % (QP_BQ / 16), j = idx / (QP_BQ / 16);
      wmma::store_matrix_sync(Os + 16 * i * LDO + 16 * j, of[f], LDO,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  bf16* ob = out + ((size_t)b * heads + h) * DH * S;
  for (int e = tid; e < QP_BQ * DH; e += QP_THREADS) {
    const int c = e / QP_BQ, r = e % QP_BQ, q = q0 + r;
    if (q < S) ob[(size_t)c * S + q] = __float2bfloat16(Os[r * LDO + c]);
  }
}

template <int DH>
int launch_qkv_plain(const void* qkv, void* out, int B, int S, int heads, float scale,
                     cudaStream_t s) {
  const int Spad = (S + QP_KT - 1) / QP_KT * QP_KT;
  const size_t smem = sizeof(float) * QP_BQ * ((Spad > DH ? Spad : DH) + 4) +
                      sizeof(bf16) * QP_BQ * (Spad + 8) +
                      sizeof(bf16) * (QP_BQ + QP_KT) * (DH + 8);
  cudaError_t err = cudaFuncSetAttribute(qkv_packed_plain_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + QP_BQ - 1) / QP_BQ, heads, B);
  qkv_packed_plain_kernel<DH><<<grid, QP_THREADS, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), S, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace cvlm

// qkv (B, S, 3*heads*d), out (B, heads*d, S): bf16. d in {16, 32, 64, 80,
// 128}; the wrapper checks d and the shared-memory size. Returns
// cudaGetLastError().
extern "C" int cvlm_qkv_packed_plain(const void* qkv, void* out, int B, int S,
                                     int heads, int d, float scale, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_qkv_plain<16>(qkv, out, B, S, heads, scale, s);
    case 32: return launch_qkv_plain<32>(qkv, out, B, S, heads, scale, s);
    case 64: return launch_qkv_plain<64>(qkv, out, B, S, heads, scale, s);
    case 80: return launch_qkv_plain<80>(qkv, out, B, S, heads, scale, s);
    case 128: return launch_qkv_plain<128>(qkv, out, B, S, heads, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
