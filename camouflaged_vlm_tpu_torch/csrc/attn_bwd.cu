// attn_bwd: the backward of SAM's rel-pos attention, per (image or window, head)
//   o = softmax((q*scale) . k^T + rel[q, k / W] + rel[q, H + k % W]) . v,
// given g = dL/do, writing dq, dk, dv into the packed qkv rows and drel into
// rel's own position-major layout.
//
// Replaces two TPU backward kernels of camouflaged_vlm_tpu/ops/flash_attention.py:
//   _qkv_packed_windows_s_bwd_kernel (flash_qkv_packed_windows_s, site #14): the
//     interior windows, qkv (B*16, 196, 3840), rel_s (196, B*16, 16*32) with
//     lanes [rel_h(14) | rel_w(14) | 0], g (B*16, 1280, 196) at ViT-H;
//   _qkv_packed_global_bwd_kernel (flash_qkv_packed_global, site #18): the 4
//     global blocks, qkv (B, 4096, 3840), rel (4096, B, 16, 128) with lanes
//     [rel_h(64) | rel_w(64)], g (B, 1280, 4096).
// Both biases are the same separable form over a position-major rel tensor
// (N, BB, heads, L): lane k / W and lane H + k % W of the query's row, with
// L = 32 (H = W = win) for the windows and L = H + W for the global blocks.
//
// The formulas are the JAX kernels' (and `attention_bwd_ref`'s): P is the
// forward's probabilities, rebuilt exactly as the forward kernels build them
// (q*scale rounded to bf16 with the scale rounded first, the fp32 bias sum
// of the two bf16 rel values, max-subtracted fp32 softmax normalised before
// any rounding);
//   dP = g . v^T,  t = sum_k dP * P (fp32),  dS = bf16(P * (dP - t)),
//   dv = bf16(P)^T . g,  dq = scale * dS . k,  dk = scale * dS^T . q (q unscaled),
//   drel = dS . sel^T, i.e. per row the sums of dS over the keys of each lane.
//
// The TPU kernels walk the grid in order and carry dk/dv across query blocks
// in scratch (the "arbitrary" axis). Blocks on Hopper run in no order, so
// this is two kernels and no atomics (the result is the same in every run):
//   pass A, query-parallel, a block per 64 queries: first over all key tiles
//     the row max m, the row sum l and t, online (t is accumulated against
//     exp(s - m_running) and rescaled with l, then divided by l); then over
//     the key tiles again dS, dq (WMMA, in registers) and drel (WMMA of dS
//     with a 0/1 lane tile built per key tile, in shared memory). It writes
//     dq, drel and the rows' m, l, t (fp32) for pass B.
//   pass B, key-parallel, a block per 64 keys: over all query tiles, with
//     their m, l, t, rebuilds P and dS and accumulates dk and dv (WMMA, in
//     registers; a warp owns 16 keys).
// The scores are thus computed three times and g . v^T twice: about 5x the
// forward's QK^T work, as in the TPU kernel's cost estimate (5 x 2 N^2 d).
//
// What bounds it on the H100: the WMMA 16x16x16 tile loops and the
// elementwise passes over shared-memory score tiles (no wgmma, no TMA, one
// block per SM at these shared-memory sizes), not device memory: nothing of
// size N^2 leaves the block. Shared memory per block at d = 80 and L = 128:
// pass A ~182 KB (q, g, k, v tiles; fp32 score, dP and drel tiles; the rel
// rows and the lane tile), pass B ~143 KB; both under the 227 KB a block may use.
#include "common.cuh"

namespace cvlm {

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

constexpr int AB_BQ = 64, AB_KT = 64, AB_THREADS = 128;

struct AttnBwdArgs {
  const bf16* qkv;   // (BB, N, 3*heads*DH)
  const bf16* rel;   // (N, BB, heads, L)
  const bf16* g;     // (BB, heads*DH, N)
  bf16* dqkv;        // like qkv
  bf16* drel;        // like rel
  float* stats;      // (3, BB*heads*N): m, l, t of every query row
  int N, H, W, L, heads;
  float scale;
};

__host__ __device__ constexpr size_t ab_align(size_t b) { return (b + 127) / 128 * 128; }
__host__ __device__ constexpr int ab_lpad(int L) { return (L + 15) / 16 * 16; }

// Shared-memory carving, shared by the kernels and their host-side sizes.
struct Carve {
  unsigned char* p;
  size_t used;
  template <class T>
  __host__ __device__ T* take(size_t n) {
    T* r = reinterpret_cast<T*>(p + used);
    used += ab_align(n * sizeof(T));
    return r;
  }
};

template <int DH>
struct QueryPassSmem {
  bf16 *Qs, *Gs, *Ks, *Vs, *dS, *Sel;
  float *S, *dP, *Rs, *Dr, *m, *l, *t;
  size_t bytes;
  __host__ __device__ QueryPassSmem(unsigned char* base, int L) {
    constexpr int LDH = DH + 8, LDS = (AB_KT > DH ? AB_KT : DH) + 4;
    const int lp = ab_lpad(L);
    Carve c{base, 0};
    Qs = c.take<bf16>(AB_BQ * LDH);
    Gs = c.take<bf16>(AB_BQ * LDH);
    Ks = c.take<bf16>(AB_KT * LDH);
    Vs = c.take<bf16>(AB_KT * LDH);
    S = c.take<float>(AB_BQ * LDS);
    dP = c.take<float>(AB_BQ * (AB_KT + 4));
    dS = c.take<bf16>(AB_BQ * (AB_KT + 8));
    Sel = c.take<bf16>(AB_KT * (lp + 8));
    Rs = c.take<float>(AB_BQ * (L + 1));
    Dr = c.take<float>(AB_BQ * (lp + 4));
    m = c.take<float>(AB_BQ);
    l = c.take<float>(AB_BQ);
    t = c.take<float>(AB_BQ);
    bytes = c.used;
  }
};

template <int DH>
struct KeyPassSmem {
  bf16 *Ks, *Vs, *Qs, *Qu, *Gs, *Pb, *dS;
  float *F, *Rs, *m, *l, *t;
  size_t bytes;
  __host__ __device__ KeyPassSmem(unsigned char* base, int L) {
    constexpr int LDH = DH + 8;
    constexpr int NF = 2 * AB_BQ * (AB_KT + 4) > AB_KT * (DH + 4) ? 2 * AB_BQ * (AB_KT + 4)
                                                                   : AB_KT * (DH + 4);
    Carve c{base, 0};
    Ks = c.take<bf16>(AB_KT * LDH);
    Vs = c.take<bf16>(AB_KT * LDH);
    Qs = c.take<bf16>(AB_BQ * LDH);
    Qu = c.take<bf16>(AB_BQ * LDH);
    Gs = c.take<bf16>(AB_BQ * LDH);
    F = c.take<float>(NF);  // scores and dP tiles; at the end the dk / dv staging
    Pb = c.take<bf16>(AB_BQ * (AB_KT + 8));
    dS = c.take<bf16>(AB_BQ * (AB_KT + 8));
    Rs = c.take<float>(AB_BQ * (L + 1));
    m = c.take<float>(AB_BQ);
    l = c.take<float>(AB_BQ);
    t = c.take<float>(AB_BQ);
    bytes = c.used;
  }
};

// Query rows q0.. of head h: q*scale (bf16, as the forward rounds it) into
// Qs, optionally the unscaled q into Qu, the d-major gradient rows into Gs,
// the rel rows (fp32) into Rs; rows past N are zero.
template <int DH>
__device__ void load_query_tile(const AttnBwdArgs& a, int b, int h, int q0, bf16* Qs, bf16* Qu,
                                bf16* Gs, float* Rs) {
  constexpr int LDH = DH + 8;
  const int C3 = 3 * a.heads * DH, BB = gridDim.z, LDR = a.L + 1;
  const bf16* base = a.qkv + (size_t)b * a.N * C3;
  const float sc = __bfloat162float(__float2bfloat16(a.scale));
  for (int e = threadIdx.x; e < AB_BQ * DH; e += blockDim.x) {
    const int r = e / DH, c = e % DH, q = q0 + r;
    const bf16 v = q < a.N ? base[(size_t)q * C3 + h * DH + c] : __float2bfloat16(0.f);
    Qs[r * LDH + c] = __float2bfloat16(__bfloat162float(v) * sc);
    if (Qu) Qu[r * LDH + c] = v;
  }
  const bf16* gb = a.g + ((size_t)b * a.heads + h) * DH * a.N;
  for (int e = threadIdx.x; e < AB_BQ * DH; e += blockDim.x) {
    const int c = e / AB_BQ, r = e % AB_BQ, q = q0 + r;
    Gs[r * LDH + c] = q < a.N ? gb[(size_t)c * a.N + q] : __float2bfloat16(0.f);
  }
  for (int e = threadIdx.x; e < AB_BQ * a.L; e += blockDim.x) {
    const int r = e / a.L, j = e % a.L, q = q0 + r;
    Rs[r * LDR + j] =
        q < a.N ? __bfloat162float(a.rel[(((size_t)q * BB + b) * a.heads + h) * a.L + j]) : 0.f;
  }
}

// score + bias of the query row `rrow` (fp32 rel lanes) and key k
__device__ __forceinline__ float biased(float s, const float* rrow, int k, int H, int W) {
  return s + (rrow[k / W] + rrow[H + k % W]);
}

template <int DH>
__global__ void __launch_bounds__(AB_THREADS) attn_bwd_query_kernel(AttnBwdArgs a) {
  constexpr int LDH = DH + 8, LDS = (AB_KT > DH ? AB_KT : DH) + 4, LDD = AB_KT + 4,
                LDP = AB_KT + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  QueryPassSmem<DH> sm(smem, a.L);
  const int lp = ab_lpad(a.L), LDL = lp + 8, LDR = a.L + 1, LDA = lp + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * AB_BQ, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N, C3 = 3 * a.heads * DH;
  const bf16* base = a.qkv + (size_t)b * N * C3;

  load_query_tile<DH>(a, b, h, q0, sm.Qs, nullptr, sm.Gs, sm.Rs);
  for (int e = threadIdx.x; e < AB_BQ * LDA; e += AB_THREADS) sm.Dr[e] = 0.f;
  for (int r = threadIdx.x; r < AB_BQ; r += AB_THREADS) {
    sm.m[r] = -INFINITY;
    sm.l[r] = 0.f;
    sm.t[r] = 0.f;
  }

  float* Sw = sm.S + warp * 16 * LDS;
  float* Pw = sm.dP + warp * 16 * LDD;
  bf16* dSw = sm.dS + warp * 16 * LDP;
  // this warp's 16 x 64 tiles of scores (Q K^T) and of dP (G V^T)
  auto tiles = [&]() {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[AB_KT / 16], pf[AB_KT / 16];
#pragma unroll
    for (int j = 0; j < AB_KT / 16; ++j) {
      wmma::fill_fragment(sf[j], 0.0f);
      wmma::fill_fragment(pf[j], 0.0f);
    }
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> aq, ag;
      wmma::load_matrix_sync(aq, sm.Qs + warp * 16 * LDH + kk, LDH);
      wmma::load_matrix_sync(ag, sm.Gs + warp * 16 * LDH + kk, LDH);
#pragma unroll
      for (int j = 0; j < AB_KT / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk, bv;
        wmma::load_matrix_sync(bk, sm.Ks + 16 * j * LDH + kk, LDH);
        wmma::load_matrix_sync(bv, sm.Vs + 16 * j * LDH + kk, LDH);
        wmma::mma_sync(sf[j], aq, bk, sf[j]);
        wmma::mma_sync(pf[j], ag, bv, pf[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < AB_KT / 16; ++j) {
      wmma::store_matrix_sync(Sw + 16 * j, sf[j], LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(Pw + 16 * j, pf[j], LDD, wmma::mem_row_major);
    }
    __syncwarp();
  };
  auto load_kv = [&](int kt) {
    __syncthreads();
    load_rows<DH>(sm.Ks, LDH, base + (size_t)kt * C3 + (a.heads + h) * DH, C3, AB_KT, N - kt);
    load_rows<DH>(sm.Vs, LDH, base + (size_t)kt * C3 + (2 * a.heads + h) * DH, C3, AB_KT, N - kt);
  };
  auto score = [&](int r, int rr, int kt, int c) {
    const int k = kt + c;
    return k < N ? biased(Sw[rr * LDS + c], sm.Rs + r * LDR, k, a.H, a.W) : -INFINITY;
  };

  // 1: row max, row sum and t (online)
  for (int kt = 0; kt < N; kt += AB_KT) {
    load_kv(kt);
    __syncthreads();
    tiles();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const float m_old = sm.m[r];
      const float s0 = score(r, rr, kt, lane), s1 = score(r, rr, kt, lane + 32);
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      const float se = warp_sum(e0 + e1);
      const float st = warp_sum(e0 * Pw[rr * LDD + lane] + e1 * Pw[rr * LDD + lane + 32]);
      if (lane == 0) {
        const float f = expf(m_old - m_new);
        sm.l[r] = sm.l[r] * f + se;
        sm.t[r] = sm.t[r] * f + st;
        sm.m[r] = m_new;
      }
    }
  }
  __syncthreads();
  const size_t row0 = ((size_t)b * a.heads + h) * N;
  const size_t nrows = (size_t)gridDim.z * a.heads * N;
  for (int r = threadIdx.x; r < AB_BQ; r += AB_THREADS) {
    sm.t[r] /= sm.l[r];
    if (q0 + r < N) {
      a.stats[row0 + q0 + r] = sm.m[r];
      a.stats[nrows + row0 + q0 + r] = sm.l[r];
      a.stats[2 * nrows + row0 + q0 + r] = sm.t[r];
    }
  }

  // 2: dS, dq += dS . K, drel += dS . Sel
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dqf[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(dqf[j], 0.0f);
  for (int kt = 0; kt < N; kt += AB_KT) {
    load_kv(kt);
    for (int e = threadIdx.x; e < AB_KT * lp; e += AB_THREADS) {
      const int kl = e / lp, j = e % lp, k = kt + kl;
      const bool on = k < N && j < a.L && (j == k / a.W || j == a.H + k % a.W);
      sm.Sel[kl * LDL + j] = __float2bfloat16(on ? 1.f : 0.f);
    }
    __syncthreads();
    tiles();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const float m = sm.m[r], l = sm.l[r], t = sm.t[r];
#pragma unroll
      for (int c = lane; c < AB_KT; c += 32) {
        const int k = kt + c;
        const float p = k < N ? expf(score(r, rr, kt, c) - m) / l : 0.f;
        dSw[rr * LDP + c] = __float2bfloat16(p * (Pw[rr * LDD + c] - t));
      }
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < AB_KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ad;
      wmma::load_matrix_sync(ad, dSw + kk, LDP);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
        wmma::load_matrix_sync(bk, sm.Ks + kk * LDH + 16 * j, LDH);
        wmma::mma_sync(dqf[j], ad, bk, dqf[j]);
      }
    }
    float* Dw = sm.Dr + warp * 16 * LDA;
    for (int j = 0; j < lp; j += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> rf;
      wmma::load_matrix_sync(rf, Dw + j, LDA, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < AB_KT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ad;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bs;
        wmma::load_matrix_sync(ad, dSw + kk, LDP);
        wmma::load_matrix_sync(bs, sm.Sel + kk * LDL + j, LDL);
        wmma::mma_sync(rf, ad, bs, rf);
      }
      wmma::store_matrix_sync(Dw + j, rf, LDA, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // dq (scale * acc) into the packed q lanes, drel into rel's layout
  constexpr int LDO = DH + 4;
  float* Os = sm.S;
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(Os + warp * 16 * LDO + 16 * j, dqf[j], LDO, wmma::mem_row_major);
  __syncthreads();
  bf16* dbase = a.dqkv + (size_t)b * N * C3;
  for (int e = threadIdx.x; e < AB_BQ * DH; e += AB_THREADS) {
    const int r = e / DH, c = e % DH, q = q0 + r;
    if (q < N) dbase[(size_t)q * C3 + h * DH + c] = __float2bfloat16(a.scale * Os[r * LDO + c]);
  }
  for (int e = threadIdx.x; e < AB_BQ * a.L; e += AB_THREADS) {
    const int r = e / a.L, j = e % a.L, q = q0 + r;
    if (q < N)
      a.drel[(((size_t)q * gridDim.z + b) * a.heads + h) * a.L + j] =
          __float2bfloat16(sm.Dr[r * LDA + j]);
  }
}

template <int DH>
__global__ void __launch_bounds__(AB_THREADS) attn_bwd_key_kernel(AttnBwdArgs a) {
  constexpr int LDH = DH + 8, LDT = AB_KT + 4, LDP = AB_KT + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  KeyPassSmem<DH> sm(smem, a.L);
  const int LDR = a.L + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * AB_KT, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N, C3 = 3 * a.heads * DH;
  const bf16* base = a.qkv + (size_t)b * N * C3;
  float* St = sm.F;                  // scores, then probabilities (BQ x LDT)
  float* Pt = sm.F + AB_BQ * LDT;    // dP (BQ x LDT)

  load_rows<DH>(sm.Ks, LDH, base + (size_t)k0 * C3 + (a.heads + h) * DH, C3, AB_KT, N - k0);
  load_rows<DH>(sm.Vs, LDH, base + (size_t)k0 * C3 + (2 * a.heads + h) * DH, C3, AB_KT, N - k0);

  const size_t row0 = ((size_t)b * a.heads + h) * N;
  const size_t nrows = (size_t)gridDim.z * a.heads * N;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dkf[DH / 16], dvf[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    wmma::fill_fragment(dkf[j], 0.0f);
    wmma::fill_fragment(dvf[j], 0.0f);
  }
  // this warp's 16 keys: k0 + 16*warp ..
  const bf16* Kw = sm.Ks + warp * 16 * LDH;
  const bf16* Vw = sm.Vs + warp * 16 * LDH;
  for (int qt = 0; qt < N; qt += AB_BQ) {
    __syncthreads();
    load_query_tile<DH>(a, b, h, qt, sm.Qs, sm.Qu, sm.Gs, sm.Rs);
    for (int r = threadIdx.x; r < AB_BQ; r += AB_THREADS) {
      const bool ok = qt + r < N;
      sm.m[r] = ok ? a.stats[row0 + qt + r] : 0.f;
      sm.l[r] = ok ? a.stats[nrows + row0 + qt + r] : 1.f;
      sm.t[r] = ok ? a.stats[2 * nrows + row0 + qt + r] : 0.f;
    }
    __syncthreads();
    // scores and dP for the warp's 16 key columns, all 64 query rows
#pragma unroll
    for (int i = 0; i < AB_BQ / 16; ++i) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf, pf;
      wmma::fill_fragment(sf, 0.0f);
      wmma::fill_fragment(pf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> aq, ag;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk, bv;
        wmma::load_matrix_sync(aq, sm.Qs + 16 * i * LDH + kk, LDH);
        wmma::load_matrix_sync(ag, sm.Gs + 16 * i * LDH + kk, LDH);
        wmma::load_matrix_sync(bk, Kw + kk, LDH);
        wmma::load_matrix_sync(bv, Vw + kk, LDH);
        wmma::mma_sync(sf, aq, bk, sf);
        wmma::mma_sync(pf, ag, bv, pf);
      }
      wmma::store_matrix_sync(St + 16 * i * LDT + 16 * warp, sf, LDT, wmma::mem_row_major);
      wmma::store_matrix_sync(Pt + 16 * i * LDT + 16 * warp, pf, LDT, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < AB_BQ * 16; e += 32) {
      const int r = e >> 4, c = 16 * warp + (e & 15), q = qt + r, k = k0 + c;
      float p = 0.f;
      if (q < N && k < N)
        p = expf(biased(St[r * LDT + c], sm.Rs + r * LDR, k, a.H, a.W) - sm.m[r]) / sm.l[r];
      sm.Pb[r * LDP + c] = __float2bfloat16(p);
      sm.dS[r * LDP + c] = __float2bfloat16(p * (Pt[r * LDT + c] - sm.t[r]));
    }
    __syncwarp();
    // dv += P^T . G and dk += dS^T . Q (unscaled) over this query tile
#pragma unroll
    for (int kk = 0; kk < AB_BQ; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ap, ad;
      wmma::load_matrix_sync(ap, sm.Pb + kk * LDP + 16 * warp, LDP);
      wmma::load_matrix_sync(ad, sm.dS + kk * LDP + 16 * warp, LDP);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bg, bq;
        wmma::load_matrix_sync(bg, sm.Gs + kk * LDH + 16 * j, LDH);
        wmma::load_matrix_sync(bq, sm.Qu + kk * LDH + 16 * j, LDH);
        wmma::mma_sync(dvf[j], ap, bg, dvf[j]);
        wmma::mma_sync(dkf[j], ad, bq, dkf[j]);
      }
    }
  }
  __syncthreads();

  // dk (scale * acc) and dv into the packed k and v lanes
  constexpr int LDO = DH + 4;
  float* Os = sm.F;
  bf16* dbase = a.dqkv + (size_t)b * N * C3;
  for (int part = 1; part <= 2; ++part) {
#pragma unroll
    for (int j = 0; j < DH / 16; ++j)
      wmma::store_matrix_sync(Os + warp * 16 * LDO + 16 * j, part == 1 ? dkf[j] : dvf[j], LDO,
                              wmma::mem_row_major);
    __syncthreads();
    const float f = part == 1 ? a.scale : 1.f;
    for (int e = threadIdx.x; e < AB_KT * DH; e += AB_THREADS) {
      const int r = e / DH, c = e % DH, k = k0 + r;
      if (k < N)
        dbase[(size_t)k * C3 + (part * a.heads + h) * DH + c] = __float2bfloat16(f * Os[r * LDO + c]);
    }
    __syncthreads();
  }
}

template <int DH>
int launch_attn_bwd(const AttnBwdArgs& a, int BB, cudaStream_t s) {
  const size_t smem_a = QueryPassSmem<DH>(nullptr, a.L).bytes;
  const size_t smem_b = KeyPassSmem<DH>(nullptr, a.L).bytes;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_query_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_key_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_a((a.N + AB_BQ - 1) / AB_BQ, a.heads, BB);
  attn_bwd_query_kernel<DH><<<grid_a, AB_THREADS, smem_a, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((a.N + AB_KT - 1) / AB_KT, a.heads, BB);
  attn_bwd_key_kernel<DH><<<grid_b, AB_THREADS, smem_b, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace cvlm

// qkv / dqkv (BB, N, 3*heads*d), rel / drel (N, BB, heads, L), g (BB, heads*d,
// N): bf16; stats (3, BB*heads*N) fp32 scratch. The bias of query q and key
// k is rel[q, k / W] + rel[q, H + k % W]; lanes of drel no key maps to are
// written 0. d in {16, 32, 64, 80, 128}. Returns the first CUDA error.
extern "C" int cvlm_attn_bwd(const void* qkv, const void* rel, const void* g, void* dqkv,
                             void* drel, void* stats, int BB, int N, int H, int W, int L,
                             int heads, int d, float scale, void* stream) {
  using namespace cvlm;
  const AttnBwdArgs a{static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel),
                      static_cast<const bf16*>(g),   static_cast<bf16*>(dqkv),
                      static_cast<bf16*>(drel),      static_cast<float*>(stats),
                      N, H, W, L, heads, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H + W > L) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch_attn_bwd<16>(a, BB, s);
    case 32: return launch_attn_bwd<32>(a, BB, s);
    case 64: return launch_attn_bwd<64>(a, BB, s);
    case 80: return launch_attn_bwd<80>(a, BB, s);
    case 128: return launch_attn_bwd<128>(a, BB, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
