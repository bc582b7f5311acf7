// attn_split: o = softmax(q . k^T + rel_h[q, k / W] + rel_w[q, H + k % W]) . v,
// one attention problem per leading index b, each of N queries and N keys,
// over split, pre-scaled q, k and v: flash_attention_relpos (TPU kernel #10,
// attn_relpos.cu). (#11 and #19, which read the packed qkv in place, left
// this kernel for qkv_relpos.cu's TMA + wgmma one pass, and #20, the same
// attention without a bias, for attn_fullk.cu's.)
//
// Layouts: every operand is given by its base and its strides (elements)
// per b and per row (SplitArgs); the row of a problem is dqk (q, k), DV (v),
// H+W (rel) or DV (out) contiguous values. dqk is a run-time multiple of 16
// up to 256 (the depth of the score product); DV is a template parameter
// (the P.V accumulator fragments live in registers).
//
// A query tile of 64 rows (4 warps x 16 rows) walks the keys in tiles of
// 64, twice:
//   pass 1: scores + bias, running row max m and row sum l (online
//           rescale l <- l * exp(m_old - m_new) + sum exp(s - m_new));
//   pass 2: the scores again, p = exp(s - m) / l normalised in fp32 and
//           rounded to bf16, O += P . V with fp32 accumulation.
// This keeps the rounding points of the JAX kernel (`_relpos_kernel` of
// flash_attention.py): fp32 scores, the bias added as the fp32
// sum of the two bf16 rel values (the rel @ sel product with one nonzero
// term per lane group, here an indexed gather), max-subtracted softmax
// normalised in fp32 before the bf16 rounding, one rounding of the output.
// An online-softmax single pass would round exp(s - m_running) before the
// division and move that rounding point. Keys and queries past N are masked
// (zero-filled tiles, -inf scores, unwritten rows), so any N works.
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

// One operand's strides (elements): per problem b, per row.
struct SplitStrides {
  size_t b, r;
};

// The problems b = blockIdx.y.
struct SplitArgs {
  const bf16 *q, *k, *v, *rel;
  bf16* out;
  SplitStrides qk, vs, rs, os;  // q and k, v, rel, out
  int N, H, W, dqk;
};

template <int DV>
__global__ void __launch_bounds__(AS_THREADS) attn_split_kernel(const SplitArgs a) {
  constexpr int LDV = DV + 8, LDS = AS_KT + 4, LDP = AS_KT + 8, LDO = DV + 4;
  const int N = a.N, H = a.H, W = a.W, dqk = a.dqk;
  const int LDQ = dqk + 8;
  const int hw = H + W, LDR = hw + 1;
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
  auto at = [&](const SplitStrides& st) { return (size_t)b * st.b; };
  const bf16* kb = a.k + at(a.qk);
  const bf16* vb = a.v + at(a.vs);

  load_tile(Qs, LDQ, a.q + at(a.qk) + (size_t)q0 * a.qk.r, a.qk.r, AS_BQ, N - q0, dqk);
  const bf16* rb = a.rel + at(a.rs);
  for (int e = tid; e < AS_BQ * hw; e += AS_THREADS) {
    const int r = e / hw, j = e % hw, qi = q0 + r;
    Rs[r * LDR + j] = qi < N ? __bfloat162float(rb[(size_t)qi * a.rs.r + j]) : 0.f;
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, Qw + kk, LDQ);
#pragma unroll
      for (int j = 0; j < AS_KT / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, Ks + 16 * j * LDQ + kk, LDQ);
        wmma::mma_sync(sfr[j], af, bk, sfr[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < AS_KT / 16; ++j)
      wmma::store_matrix_sync(Sw + 16 * j, sfr[j], LDS, wmma::mem_row_major);
    __syncwarp();
  };
  // score + bias of block row r (warp row rr), key column c of the tile at kt
  auto biased = [&](int r, int rr, int kt, int c) {
    const int key = kt + c;
    if (key >= N) return -INFINITY;
    const float* rrow = Rs + r * LDR;
    return Sw[rr * LDS + c] + (rrow[key / W] + rrow[H + key % W]);
  };

  // pass 1: row max and row sum
  for (int kt = 0; kt < N; kt += AS_KT) {
    __syncthreads();
    load_tile(Ks, LDQ, kb + (size_t)kt * a.qk.r, a.qk.r, AS_KT, N - kt, dqk);
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
    load_tile(Ks, LDQ, kb + (size_t)kt * a.qk.r, a.qk.r, AS_KT, N - kt, dqk);
    load_tile(Vs, LDV, vb + (size_t)kt * a.vs.r, a.vs.r, AS_KT, N - kt, DV);
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, Pw + kk, LDP);
#pragma unroll
      for (int j = 0; j < DV / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, Vs + kk * LDV + 16 * j, LDV);
        wmma::mma_sync(of[j], af, bv, of[j]);
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
  bf16* ob = a.out + at(a.os) + (size_t)q0 * a.os.r;
  for (int e = tid; e < AS_BQ * DV; e += AS_THREADS) {
    const int r = e / DV, c = e % DV;
    if (q0 + r < N) ob[(size_t)r * a.os.r + c] = __float2bfloat16(Os[r * LDO + c]);
  }
}

template <int DV>
int launch_split(const SplitArgs& a, int problems, cudaStream_t s) {
  if (a.dqk <= 0 || a.dqk % 16 != 0 || a.dqk > 256 || problems <= 0 || problems > 65535 ||
      a.N <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = split_smem(a.dqk, DV, a.H + a.W);
  cudaError_t err = cudaFuncSetAttribute(attn_split_kernel<DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + AS_BQ - 1) / AS_BQ, problems);
  attn_split_kernel<DV><<<grid, AS_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// dv in {64, 80} (SAM ViT-B, ViT-H).
inline int dispatch_split(const SplitArgs& a, int problems, int dv, cudaStream_t s) {
  switch (dv) {
    case 64: return launch_split<64>(a, problems, s);
    case 80: return launch_split<80>(a, problems, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Split operands, one problem per leading index: q, k (BB, N, dqk), v and out
// (BB, N, dv), rel (BB, N, H+W); q pre-scaled.
inline SplitArgs split_layout(const void* q, const void* k, const void* v, const void* rel,
                              void* out, int N, int H, int W, int dqk, int dv) {
  SplitArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.rel = static_cast<const bf16*>(rel);
  a.out = static_cast<bf16*>(out);
  a.qk = {(size_t)N * dqk, (size_t)dqk};
  a.vs = {(size_t)N * dv, (size_t)dv};
  a.rs = {(size_t)N * (H + W), (size_t)(H + W)};
  a.os = a.vs;
  a.N = N;
  a.H = H;
  a.W = W;
  a.dqk = dqk;
  return a;
}

}  // namespace cvlm
