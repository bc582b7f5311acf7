// attn_split: o = softmax(q . k^T [+ rel_h[q, k / W] + rel_w[q, H + k % W]]) . v
// over separate q, k, v tensors (one attention problem per leading index),
// q arriving pre-scaled. Shared by two sources:
//
//   attn_relpos.cu  BIAS = true:  flash_attention_relpos (TPU kernel #10)
//   attn_fullk.cu   BIAS = false: flash_attention_fullk  (TPU kernel #20)
//
// Layouts (bf16): q, k (BB, N, dqk); v (BB, N, DV); rel (BB, N, H+W)
// [rel_h | rel_w] per query; out (BB, N, DV). dqk is a run-time multiple of
// 16 up to 256 (the depth of the score product; #20's augmented features
// are 208 wide at ViT-H); DV is a template parameter (the P.V accumulator
// fragments live in registers).
//
// A query tile of 64 rows (4 warps x 16 rows) walks the keys in tiles of
// 64, twice, as qkv_packed_global.cu does:
//   pass 1: scores (+ bias), running row max m and row sum l (online
//           rescale l <- l * exp(m_old - m_new) + sum exp(s - m_new));
//   pass 2: the scores again, p = exp(s - m) / l normalised in fp32 and
//           rounded to bf16, O += P . V with fp32 accumulation.
// This keeps the rounding points of the JAX kernels (`_relpos_kernel`,
// `_kernel` of flash_attention.py): fp32 scores, the bias added as the fp32
// sum of the two bf16 rel values (the rel @ sel product with one nonzero
// term per lane group, here an indexed gather), max-subtracted softmax
// normalised in fp32 before the bf16 rounding, one rounding of the output.
// An online-softmax single pass would round exp(s - m_running) before the
// division and move that rounding point. Keys and queries past N are masked
// (zero-filled tiles, -inf scores, unwritten rows), so any N works: the 196
// tokens of a 14 x 14 window and the 4096 of a 64 x 64 grid alike.
//
// What bounds it on the H100: the tensor cores' work is 2 N^2 dqk (scores,
// twice) + 2 N^2 DV (P.V) per problem, through WMMA 16x16x16 with K and V
// tiles streamed from L2 into shared memory by plain 16-byte loads: no
// wgmma, no TMA, no pipelining. The bias is a gather from the fp32 rel rows
// held in shared memory, not a product. Making it fast is later work.
#pragma once

#include "common.cuh"

namespace cvlm {

constexpr int AS_BQ = 64, AS_KT = 64, AS_THREADS = 128;

// Dynamic shared memory of one block: every region is a multiple of 128
// bytes, so each WMMA tile pointer stays 32-byte aligned.
__host__ __device__ inline size_t split_smem(int dqk, int dv, int hw) {
  const int lds = AS_KT + 4, ldo = dv + 4;
  return sizeof(float) * AS_BQ * (lds > ldo ? lds : ldo) +
         sizeof(bf16) * (AS_BQ + AS_KT) * (dqk + 8) + sizeof(bf16) * AS_KT * (dv + 8) +
         sizeof(bf16) * AS_BQ * (AS_KT + 8) + sizeof(float) * (AS_BQ * (hw + 1) + 2 * AS_BQ);
}

// `rows` rows of `cols` bf16 values (cols % 8 == 0; row stride lds) into
// shared memory (pitch ldd) with 16-byte loads; rows at or past `valid` are
// zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, int ldd, const bf16* src, size_t lds,
                                          int rows, int valid, int cols) {
  const int ch = cols / 8;
  for (int e = threadIdx.x; e < rows * ch; e += blockDim.x) {
    const int r = e / ch, c = (e % ch) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * lds + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = val;
  }
}

template <int DV, bool BIAS>
__global__ void __launch_bounds__(AS_THREADS) attn_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ rel, bf16* __restrict__ out, int N, int H, int W, int dqk) {
  constexpr int LDV = DV + 8, LDS = AS_KT + 4, LDP = AS_KT + 8, LDO = DV + 4;
  const int LDQ = dqk + 8;
  const int hw = BIAS ? H + W : 0, LDR = hw + 1;
  extern __shared__ __align__(128) unsigned char smem[];
  // score tile (BQ x LDS), at the end reused for the O tile (BQ x LDO)
  float* Ss = reinterpret_cast<float*>(smem);
  bf16* Qs = reinterpret_cast<bf16*>(Ss + AS_BQ * (LDS > LDO ? LDS : LDO));  // BQ x LDQ
  bf16* Ks = Qs + AS_BQ * LDQ;                                              // KT x LDQ
  bf16* Vs = Ks + AS_KT * LDQ;                                              // KT x LDV
  bf16* Ps = Vs + AS_KT * LDV;                                              // BQ x LDP
  float* Rs = reinterpret_cast<float*>(Ps + AS_BQ * LDP);  // BQ x LDR: rel rows in fp32
  float* row_m = Rs + AS_BQ * LDR;
  float* row_l = row_m + AS_BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * AS_BQ, b = blockIdx.y;
  const bf16* kb = k + (size_t)b * N * dqk;
  const bf16* vb = v + (size_t)b * N * DV;

  load_tile(Qs, LDQ, q + ((size_t)b * N + q0) * dqk, dqk, AS_BQ, N - q0, dqk);
  if (BIAS) {
    for (int e = tid; e < AS_BQ * hw; e += AS_THREADS) {
      const int r = e / hw, j = e % hw, qi = q0 + r;
      Rs[r * LDR + j] = qi < N ? __bfloat162float(rel[((size_t)b * N + qi) * hw + j]) : 0.f;
    }
  }
  for (int r = tid; r < AS_BQ; r += AS_THREADS) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.f;
  }

  // this warp's 16 x 64 score tile: fp32 scores of its query rows
  float* Sw = Ss + warp * 16 * LDS;
  const bf16* Qw = Qs + warp * 16 * LDQ;
  auto scores = [&]() {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sfr[AS_KT / 16];
#pragma unroll
    for (int j = 0; j < AS_KT / 16; ++j) wmma::fill_fragment(sfr[j], 0.0f);
    for (int kk = 0; kk < dqk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qw + kk, LDQ);
#pragma unroll
      for (int j = 0; j < AS_KT / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, Ks + 16 * j * LDQ + kk, LDQ);
        wmma::mma_sync(sfr[j], a, bk, sfr[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < AS_KT / 16; ++j)
      wmma::store_matrix_sync(Sw + 16 * j, sfr[j], LDS, wmma::mem_row_major);
    __syncwarp();
  };
  // score (+ bias) of block row r (warp row rr), key column c of the tile at kt
  auto biased = [&](int r, int rr, int kt, int c) {
    const int key = kt + c;
    if (key >= N) return -INFINITY;
    float s = Sw[rr * LDS + c];
    if (BIAS) {
      const float* rrow = Rs + r * LDR;
      s = s + (rrow[key / W] + rrow[H + key % W]);
    }
    return s;
  };

  // pass 1: row max and row sum
  for (int kt = 0; kt < N; kt += AS_KT) {
    __syncthreads();
    load_tile(Ks, LDQ, kb + (size_t)kt * dqk, dqk, AS_KT, N - kt, dqk);
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
      __syncwarp();
    }
  }

  // pass 2: normalised bf16 probabilities times V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[DV / 16];
#pragma unroll
  for (int j = 0; j < DV / 16; ++j) wmma::fill_fragment(of[j], 0.0f);
  bf16* Pw = Ps + warp * 16 * LDP;
  for (int kt = 0; kt < N; kt += AS_KT) {
    __syncthreads();
    load_tile(Ks, LDQ, kb + (size_t)kt * dqk, dqk, AS_KT, N - kt, dqk);
    load_tile(Vs, LDV, vb + (size_t)kt * DV, DV, AS_KT, N - kt, DV);
    __syncthreads();
    scores();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const float m = row_m[r], l = row_l[r];
#pragma unroll
      for (int c = lane; c < AS_KT; c += 32)
        Pw[rr * LDP + c] = __float2bfloat16(expf(biased(r, rr, kt, c) - m) / l);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < AS_KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Pw + kk, LDP);
#pragma unroll
      for (int j = 0; j < DV / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, Vs + kk * LDV + 16 * j, LDV);
        wmma::mma_sync(of[j], a, bv, of[j]);
      }
    }
  }
  __syncthreads();

  // stage O (BQ x DV fp32) in the score buffer, then write rows
  float* Os = Ss;
#pragma unroll
  for (int j = 0; j < DV / 16; ++j)
    wmma::store_matrix_sync(Os + warp * 16 * LDO + 16 * j, of[j], LDO, wmma::mem_row_major);
  __syncthreads();
  bf16* ob = out + ((size_t)b * N + q0) * DV;
  for (int e = tid; e < AS_BQ * DV; e += AS_THREADS) {
    const int r = e / DV, c = e % DV;
    if (q0 + r < N) ob[(size_t)r * DV + c] = __float2bfloat16(Os[r * LDO + c]);
  }
}

template <int DV, bool BIAS>
int launch_split(const void* q, const void* k, const void* v, const void* rel, void* out,
                 int BB, int N, int H, int W, int dqk, cudaStream_t s) {
  if (dqk <= 0 || dqk % 16 != 0 || dqk > 256 || BB <= 0 || BB > 65535 || N <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = split_smem(dqk, DV, BIAS ? H + W : 0);
  cudaError_t err = cudaFuncSetAttribute(attn_split_kernel<DV, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + AS_BQ - 1) / AS_BQ, BB);
  attn_split_kernel<DV, BIAS><<<grid, AS_THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(rel), static_cast<bf16*>(out), N, H, W, dqk);
  return (int)cudaGetLastError();
}

template <bool BIAS>
int dispatch_split(const void* q, const void* k, const void* v, const void* rel, void* out,
                   int BB, int N, int H, int W, int dqk, int dv, cudaStream_t s) {
  switch (dv) {
    case 64: return launch_split<64, BIAS>(q, k, v, rel, out, BB, N, H, W, dqk, s);
    case 80: return launch_split<80, BIAS>(q, k, v, rel, out, BB, N, H, W, dqk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cvlm
