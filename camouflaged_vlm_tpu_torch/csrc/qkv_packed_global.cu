// qkv_packed_global: SAM's global attention, per head
//   o = softmax((q*scale) . k^T + rel_h[q, k / W] + rel_w[q, k % W]) . v,
// read straight from the packed qkv projection, written d-major.
//
// Replaces flash_qkv_packed_global of camouflaged_vlm_tpu/ops/flash_attention.py
// (_qkv_packed_global_kernel): the 4 global ViT-H blocks, qkv (B, 4096, 3840),
// rel (4096, B, 16, 128) position-major [rel_h | rel_w] (H = W = 64), out
// (B, 1280, 4096) for proj_rows.
//
// 4096 keys do not fit a block's shared memory as whole score rows (32 rows
// x 4096 x 4 B = 512 KB), so the kernel makes two passes over 64-key tiles
// per (query tile of 64, head, image), 4 warps of 16 query rows each:
//   pass 1: scores + bias, running row max m and row sum l (online rescale
//           l <- l * exp(m_old - m_new) + sum exp(s - m_new));
//   pass 2: the scores again, p = exp(s - m) / l normalised in fp32 and
//           rounded to bf16, O += P . V with fp32 accumulation.
// Normalising before the bf16 rounding keeps the JAX `ref` rounding point
// (flash_attention.py:987-998 records that rounding the raw exp values lost
// accuracy). q*scale is rounded to bf16 (the scale itself in bf16 first),
// the bias is the fp32 sum of the two bf16 rel values (indexing, not the
// 0/1 scatter product), added to the fp32 score; one rounding of the
// output. The TPU kernel's constant-shift exp is not carried over. kh = k / W
// and kw = k % W for any H and W; keys and queries past N are masked.
//
// What bounds it on the H100: the scores are computed twice (2 x 4 B N^2 d
// WMMA FLOP per head plus N^2 d for P.V) and each block streams K twice and
// V once through shared memory from L2; exp and the per-row statistics run
// on the CUDA cores. No wgmma, no TMA: that is later work.
#include "attn_rows.cuh"

namespace cvlm {

constexpr int GA_BQ = 64, GA_KT = 64, GA_THREADS = 128;

template <int DH>
__host__ __device__ constexpr size_t global_smem(int hw) {
  return sizeof(float) * GA_BQ * ((GA_KT + 4) > (DH + 4) ? (GA_KT + 4) : (DH + 4)) +
         sizeof(bf16) * (GA_BQ + 2 * GA_KT) * (DH + 8) + sizeof(bf16) * GA_BQ * (GA_KT + 8) +
         sizeof(float) * (GA_BQ * (hw + 1) + 2 * GA_BQ);
}

template <int DH>
__global__ void __launch_bounds__(GA_THREADS) qkv_global_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ rel, bf16* __restrict__ out,
    int N, int H, int W, int heads, float scale) {
  constexpr int LDH = DH + 8, LDS = GA_KT + 4, LDP = GA_KT + 8, LDO = DH + 4;
  const int hw = H + W, LDR = hw + 1;
  extern __shared__ __align__(128) unsigned char smem[];
  // score tile (BQ x LDS), at the end reused for the O tile (BQ x LDO)
  float* Ss = reinterpret_cast<float*>(smem);
  bf16* Qs = reinterpret_cast<bf16*>(Ss + GA_BQ * (LDS > LDO ? LDS : LDO));  // BQ x LDH
  bf16* Ks = Qs + GA_BQ * LDH;                                              // KT x LDH
  bf16* Vs = Ks + GA_KT * LDH;                                              // KT x LDH
  bf16* Ps = Vs + GA_KT * LDH;                                              // BQ x LDP
  float* Rs = reinterpret_cast<float*>(Ps + GA_BQ * LDP);  // BQ x LDR: rel rows in fp32
  float* row_m = Rs + GA_BQ * LDR;
  float* row_l = row_m + GA_BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * GA_BQ, h = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int C3 = 3 * heads * DH;
  const bf16* base = qkv + (size_t)b * N * C3;
  const float sc = __bfloat162float(__float2bfloat16(scale));  // scale in bf16

  for (int e = tid; e < GA_BQ * DH; e += GA_THREADS) {
    const int r = e / DH, c = e % DH, q = q0 + r;
    float v = 0.f;
    if (q < N) v = __bfloat162float(base[(size_t)q * C3 + h * DH + c]) * sc;
    Qs[r * LDH + c] = __float2bfloat16(v);
  }
  for (int e = tid; e < GA_BQ * hw; e += GA_THREADS) {
    const int r = e / hw, j = e % hw, q = q0 + r;
    Rs[r * LDR + j] =
        q < N ? __bfloat162float(rel[((size_t)q * B + b) * heads * hw + h * hw + j]) : 0.f;
  }
  for (int r = tid; r < GA_BQ; r += GA_THREADS) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.f;
  }

  // this warp's 16 x 64 score tile: fp32 scores of its query rows
  float* Sw = Ss + warp * 16 * LDS;
  const bf16* Qw = Qs + warp * 16 * LDH;
  auto scores = [&]() {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sfr[GA_KT / 16];
#pragma unroll
    for (int j = 0; j < GA_KT / 16; ++j) wmma::fill_fragment(sfr[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qw + kk, LDH);
#pragma unroll
      for (int j = 0; j < GA_KT / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, Ks + 16 * j * LDH + kk, LDH);
        wmma::mma_sync(sfr[j], a, bk, sfr[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < GA_KT / 16; ++j)
      wmma::store_matrix_sync(Sw + 16 * j, sfr[j], LDS, wmma::mem_row_major);
    __syncwarp();
  };
  // score + bias of row r (block row), key column c of the tile at kt
  auto biased = [&](int r, int rr, int kt, int c) {
    const int k = kt + c;
    if (k >= N) return -INFINITY;
    const float* rrow = Rs + r * LDR;
    return Sw[rr * LDS + c] + (rrow[k / W] + rrow[H + k % W]);
  };

  // pass 1: row max and row sum
  for (int kt = 0; kt < N; kt += GA_KT) {
    __syncthreads();
    load_rows<DH>(Ks, LDH, base + (size_t)kt * C3 + (heads + h) * DH, C3, GA_KT, N - kt);
    __syncthreads();
    scores();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const float m_old = row_m[r];
      const float s0 = biased(r, rr, kt, lane), s1 = biased(r, rr, kt, lane + 32);
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float e = warp_sum(expf(s0 - m_new) + expf(s1 - m_new));
      if (lane == 0) {
        row_l[r] = row_l[r] * expf(m_old - m_new) + e;
        row_m[r] = m_new;
      }
    }
  }

  // pass 2: normalised bf16 probabilities times V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(of[j], 0.0f);
  bf16* Pw = Ps + warp * 16 * LDP;
  for (int kt = 0; kt < N; kt += GA_KT) {
    __syncthreads();
    load_rows<DH>(Ks, LDH, base + (size_t)kt * C3 + (heads + h) * DH, C3, GA_KT, N - kt);
    load_rows<DH>(Vs, LDH, base + (size_t)kt * C3 + (2 * heads + h) * DH, C3, GA_KT, N - kt);
    __syncthreads();
    scores();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const float m = row_m[r], l = row_l[r];
#pragma unroll
      for (int c = lane; c < GA_KT; c += 32)
        Pw[rr * LDP + c] = __float2bfloat16(expf(biased(r, rr, kt, c) - m) / l);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < GA_KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Pw + kk, LDP);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, Vs + kk * LDH + 16 * j, LDH);
        wmma::mma_sync(of[j], a, bv, of[j]);
      }
    }
  }
  __syncthreads();

  // stage O (BQ x DH fp32) in the score buffer, then write d-major
  float* Os = Ss;
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(Os + warp * 16 * LDO + 16 * j, of[j], LDO, wmma::mem_row_major);
  __syncthreads();
  bf16* ob = out + ((size_t)b * heads + h) * DH * N;
  for (int e = tid; e < GA_BQ * DH; e += GA_THREADS) {
    const int c = e / GA_BQ, r = e % GA_BQ, q = q0 + r;
    if (q < N) ob[(size_t)c * N + q] = __float2bfloat16(Os[r * LDO + c]);
  }
}

template <int DH>
int launch_global(const void* qkv, const void* rel, void* out, int B, int N, int H, int W,
                  int heads, float scale, cudaStream_t s) {
  const size_t smem = global_smem<DH>(H + W);
  cudaError_t err = cudaFuncSetAttribute(qkv_global_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + GA_BQ - 1) / GA_BQ, heads, B);
  qkv_global_kernel<DH><<<grid, GA_THREADS, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel), static_cast<bf16*>(out),
      N, H, W, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace cvlm

// qkv (B, N, 3*heads*d), rel (N, B, heads, H+W), out (B, heads*d, N): bf16;
// N == H * W. d in {16, 32, 64, 80, 128}. Returns cudaGetLastError().
extern "C" int cvlm_qkv_packed_global(const void* qkv, const void* rel, void* out, int B,
                                      int N, int H, int W, int heads, int d, float scale,
                                      void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_global<16>(qkv, rel, out, B, N, H, W, heads, scale, s);
    case 32: return launch_global<32>(qkv, rel, out, B, N, H, W, heads, scale, s);
    case 64: return launch_global<64>(qkv, rel, out, B, N, H, W, heads, scale, s);
    case 80: return launch_global<80>(qkv, rel, out, B, N, H, W, heads, scale, s);
    case 128: return launch_global<128>(qkv, rel, out, B, N, H, W, heads, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
