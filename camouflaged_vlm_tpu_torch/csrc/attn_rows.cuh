// attn_rows: per head, o = softmax((q*scale) . k^T + bias) . v over windows
// short enough that a block holds whole score rows in shared memory, with
// SAM's decomposed rel-pos bias, read straight from the packed qkv
// projection and written d-major: the padded carry's windows and the global
// blocks with H + W <= 32 (#12, qkv_packed_windows.cu); its row loader
// load_rows is also attn_bwd.cu's. (CLIP's attention, #16, and the compact
// carry's interior and edge windows, #13 and #15, left this kernel for the
// TMA + wgmma kernels of attn_sm90.cuh.)
//
// Layouts: qkv (BB, S, 3*H*d), last axis [q heads | k heads | v heads];
// out (BB, H*d, S) with row stride ldo. BB is the batch of windows
// (B*nwin). The rel lanes of query q of window b start at rel + (b * S + q)
// * H*32: window-major (BB, S, H*32). Grid (ceil(S/32), heads, BB), 128
// threads.
//
// One block owns 32 queries of one head and holds their whole score rows
// (32 x Spad fp32, Spad = S rounded up to 64) in shared memory, so the
// softmax is the exact max-subtracted one of the JAX `ref` formulations:
// q*scale rounded to bf16 (the scale itself rounded to bf16 first), scores
// and bias summed in fp32, probabilities normalised in fp32 and rounded to
// bf16 before P.V, fp32 accumulation, one rounding of the output. Keys past
// S are zero-filled and excluded from the softmax.
//
// The rel-pos bias is built by indexing, not by the TPU kernel's product
// with a 0/1 scatter matrix: key k has the rel lanes lo = k / win and hi =
// win + k % win (k on the win x win grid) and bias[q, k] = rel[q, lo] +
// rel[q, hi], the same fp32 sum of the same two bf16 values the scatter
// product gives. Each warp reads a query's 32 rel lanes once (one lane
// each) and gathers them with shuffles.
//
// What bounds it on the H100: the score rows' round trip through shared
// memory and the per-tile synchronisation, not the tensor cores (WMMA
// 16x16x16, no wgmma, no TMA), and k and v read again by every block of 32
// queries. qkv_packed_windows_s.cu is the design that would replace it: k
// and v loaded once per window by TMA, the bias on the tensor cores, whole
// score rows in wgmma's registers (PERF.md).
#pragma once

#include "common.cuh"

namespace cvlm {

constexpr int AR_BQ = 32, AR_KT = 64, AR_THREADS = 128;
constexpr int REL_LANES = 32;

// Copies `rows` rows of DH bf16 values (row stride lds) into shared memory
// (pitch ldd) with 16-byte loads; rows at or past `valid` are zero-filled.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, int ldd, const bf16* src, size_t lds,
                                          int rows, int valid) {
  constexpr int CH = DH / 8;
  for (int e = threadIdx.x; e < rows * CH; e += blockDim.x) {
    const int r = e / CH, c = (e % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + (size_t)r * lds + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = v;
  }
}

__host__ __device__ constexpr int rows_spad(int S) { return (S + AR_KT - 1) / AR_KT * AR_KT; }

template <int DH>
__host__ __device__ constexpr size_t rows_smem(int S) {
  return sizeof(float) * AR_BQ * ((rows_spad(S) > DH ? rows_spad(S) : DH) + 4) +
         sizeof(float) * rows_spad(S) +
         sizeof(bf16) * AR_BQ * (rows_spad(S) + 8) + sizeof(bf16) * (AR_BQ + AR_KT) * (DH + 8);
}

template <int DH>
__global__ void __launch_bounds__(AR_THREADS) attn_rows_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ rel, bf16* __restrict__ out, int S,
    int ldo, int win, int heads, float scale) {
  constexpr int LDH = DH + 8;
  constexpr int NW = AR_THREADS / 32;
  const int Spad = rows_spad(S);
  const int LDS = Spad + 4, LDP = Spad + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  // scores (BQ x LDS), later reused for the O tile (BQ x DH+4)
  float* Ss = reinterpret_cast<float*>(smem);
  int* kcode = reinterpret_cast<int*>(Ss + AR_BQ * ((Spad > DH ? Spad : DH) + 4));  // lo | hi << 8
  bf16* Ps = reinterpret_cast<bf16*>(kcode + Spad);          // BQ x LDP
  bf16* Qs = Ps + AR_BQ * LDP;                                // BQ x LDH
  bf16* KV = Qs + AR_BQ * LDH;                                // KT x LDH

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * AR_BQ, h = blockIdx.y, b = blockIdx.z;
  const int C3 = 3 * heads * DH;
  const bf16* base = qkv + (size_t)b * S * C3;
  const float sc = __bfloat162float(__float2bfloat16(scale));  // scale in bf16

  for (int e = tid; e < AR_BQ * DH; e += AR_THREADS) {
    const int r = e / DH, c = e % DH, q = q0 + r;
    float v = 0.f;
    if (q < S) v = __bfloat162float(base[(size_t)q * C3 + h * DH + c]) * sc;
    Qs[r * LDH + c] = __float2bfloat16(v);
  }
  for (int k = tid; k < S; k += AR_THREADS) kcode[k] = (k / win) | ((win + k % win) << 8);

  // scores: 2 x 4 fragments per key tile, two per warp
  const int si = warp & 1, sj = (warp >> 1) * 2;
  for (int kt = 0; kt < Spad; kt += AR_KT) {
    __syncthreads();
    load_rows<DH>(KV, LDH, base + (size_t)kt * C3 + (heads + h) * DH, C3, AR_KT, S - kt);
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

  // bias, then the exact softmax over the S real keys, one warp per row
  for (int r = warp; r < AR_BQ; r += NW) {
    float* row = Ss + r * LDS;
    const int q = q0 + r;
    float rv = 0.f;  // this lane's rel value of query q
    if (q < S)
      rv = __bfloat162float(rel[((size_t)b * S + q) * heads * REL_LANES + h * REL_LANES + lane]);
    float mx = -INFINITY;
    for (int kb = 0; kb < S; kb += 32) {  // warp-uniform trip count: shuffles inside
      const int k = kb + lane;
      const int code = k < S ? kcode[k] : 0;
      const float lo = __shfl_sync(0xffffffffu, rv, code & 31);
      const float hi = __shfl_sync(0xffffffffu, rv, (code >> 8) & 31);
      if (k < S) {
        const float s = row[k] + (lo + hi);
        row[k] = s;
        mx = fmaxf(mx, s);
      }
    }
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
  constexpr int NOF = (AR_BQ / 16) * (DH / 16);
  constexpr int PER_WARP = (NOF + NW - 1) / NW;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[PER_WARP];
#pragma unroll
  for (int f = 0; f < PER_WARP; ++f) wmma::fill_fragment(of[f], 0.0f);
  for (int kt = 0; kt < Spad; kt += AR_KT) {
    __syncthreads();
    load_rows<DH>(KV, LDH, base + (size_t)kt * C3 + (2 * heads + h) * DH, C3, AR_KT, S - kt);
    __syncthreads();
#pragma unroll
    for (int f = 0; f < PER_WARP; ++f) {
      const int idx = warp + NW * f;
      if (idx < NOF) {
        const int i = idx % (AR_BQ / 16), j = idx / (AR_BQ / 16);
#pragma unroll
        for (int kk = 0; kk < AR_KT; kk += 16) {
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
      const int i = idx % (AR_BQ / 16), j = idx / (AR_BQ / 16);
      wmma::store_matrix_sync(Os + 16 * i * LDO + 16 * j, of[f], LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();
  bf16* ob = out + ((size_t)b * heads + h) * DH * ldo;
  for (int e = tid; e < AR_BQ * DH; e += AR_THREADS) {
    const int c = e / AR_BQ, r = e % AR_BQ, q = q0 + r;
    if (q < S) ob[(size_t)c * ldo + q] = __float2bfloat16(Os[r * LDO + c]);
  }
}

template <int DH>
int launch_attn_rows(const void* qkv, const void* rel, void* out, int BB, int S, int ldo,
                     int win, int heads, float scale, cudaStream_t s) {
  const size_t smem = rows_smem<DH>(S);
  cudaError_t err = cudaFuncSetAttribute(attn_rows_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + AR_BQ - 1) / AR_BQ, heads, BB);
  attn_rows_kernel<DH><<<grid, AR_THREADS, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel), static_cast<bf16*>(out), S,
      ldo, win, heads, scale);
  return (int)cudaGetLastError();
}

inline int dispatch_attn_rows(const void* qkv, const void* rel, void* out, int BB, int S,
                              int ldo, int win, int heads, int d, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch_attn_rows<16>(qkv, rel, out, BB, S, ldo, win, heads, scale, s);
    case 32: return launch_attn_rows<32>(qkv, rel, out, BB, S, ldo, win, heads, scale, s);
    case 64: return launch_attn_rows<64>(qkv, rel, out, BB, S, ldo, win, heads, scale, s);
    case 80: return launch_attn_rows<80>(qkv, rel, out, BB, S, ldo, win, heads, scale, s);
    case 128: return launch_attn_rows<128>(qkv, rel, out, BB, S, ldo, win, heads, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cvlm
