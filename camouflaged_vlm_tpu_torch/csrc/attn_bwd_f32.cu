// attn_bwd_f32: the backward of SAM's rel-pos attention in float32, per
// (image or window, head)
//   o = softmax((q*scale) . k^T + rel[q, k / W] + rel[q, H + k % W]) . v,
// given g = dL/do (d-major) and the forward's output o, writing dq, dk, dv
// into the packed qkv rows and drel into rel's own position-major layout.
// All in float32, no rounding point: the formulas of `attention_bwd_ref`,
//   P = softmax(s),  dP = g . v^T,  t = sum_k dP * P = sum_c g * o,
//   dS = P * (dP - t),  dv = P^T . g,  dq = scale * dS . k,
//   dk = scale * dS^T . q (q unscaled),
//   drel[q, a] = sum of dS[q, k] over the keys k of rel lane a.
//
// Replaces two TPU backward kernels of camouflaged_vlm_tpu/ops/flash_attention.py
// where the JAX package runs them in float32 (train --dtype float32, the
// reference's own numerics):
//   _qkv_packed_windows_s_bwd_kernel (flash_qkv_packed_windows_s, #14): the
//     28 windowed ViT-H blocks' interior windows, qkv (BW, 196, 3840), rel_s
//     (196, BW, 16 * 32) position-major with lanes [rel_h(14) | rel_w(14) |
//     0], g (BW, 1280, 196), BW = 16 B;
//   _qkv_packed_global_bwd_kernel (flash_qkv_packed_global, #18): the 4
//     global blocks, qkv (B, 4096, 3840), rel (4096, B, 16, 128), g (B,
//     1280, 4096) on the 64 x 64 grid.
//
// What bounds it on the H100: the float32 rate of the CUDA cores (the
// tensor cores have no float32 mode). The function needs five products of
// 2 N^2 d a (problem, head): the scores, dP, dv, dq and dk; #14 15.7 GFLOP
// and #18 429.5 GFLOP at batch 2, 0.235 and 6.41 ms at 67 TFLOP/s.
//
// Design: six products and one round trip of dS through device memory,
// three kernels of 256 threads, no atomics (two calls on the same inputs
// are bit-equal), every score s = scale * (q . k) + bias by one FFMA chain
// over c ascending in both kernels that form it (so P <= 1 holds exactly):
//   stats, one block per (128-query tile, problem * heads + h): S alone
//     over 128-key tiles (k double-buffered by cp.async), each thread 8 x 8
//     scores, each row's max and sum online; t = sum_c g o from the forward's
//     output instead of a dP sweep, and g's d-major rows turned into rows
//     (gt) for the key kernel. Writes each row's (max, 1/sum, t).
//   key, one block per (128-key tile, problem * heads + h), its k and v
//     rows resident; steps of 32 queries, whose q and g rows, rel slots and
//     statistics cp.async brings a step ahead (double-buffered). The two
//     warpgroups split the four products, each thread 8 keys x 4 queries of
//     the scores beside 8 keys x d / 8 columns of dv or dk: the first forms
//     S^T and P from the statistics (into shared memory), then dv += P^T .
//     g; the second forms dP^T, waits on a named barrier for P, writes dS =
//     P (dP - t) into shared memory and, key-major, into a scratch dS^T,
//     then dk += dS^T . q.
//   query, one block per (128-query tile, problem * heads + h): dS^T and k
//     streamed in 64-key steps (cp.async, double-buffered); dq = scale * dS
//     . k, each thread 4 rows x d / 8 columns. drel of each step after it,
//     every sum in key order: on the W = 64 grid (a step is one grid row kh)
//     in registers, a thread's rel_w lanes 8 m + tc of its 4 rows summed
//     step after step and rel_h lane kh the step's row sum, a fixed-order
//     shuffle over the 8 threads of a row; on other grids each (row, lane)
//     by one thread, added to the steps before: rel_h lanes in drel's rows,
//     rel_w lanes in shared memory where W <= 128, else in drel's rows too
//     (the block owns them).
// The bias of a key tile: the rel lanes it touches (all W rel_w lanes where
// W <= 128, else one a key, then its rel_h lanes) are slots of a table of
// the query rows' values, at most 130 whatever H + W is, so the lanes are
// bounded only by the forward's H + W <= 512 (ops/flash_attention.py
// F32_GLOBAL_BWD_MAX_LANES).
// Ragged tiles: keys past N score -inf (stats) or get P = 0 (key), queries
// past N are zero rows with zero statistics, so they add nothing and are
// not stored. The scratch holds a chunk of (problem, head) pairs at a time
// (the wrapper sizes it; NP = N rounded up to 128): the host queues key and
// query kernels chunk by chunk.
//
// Dynamic shared memory at d = 80 (`cvlm_attn_bwd_f32_smem`): stats 197,120
// B, key 198,416 B, query 178,176 B; one block of 8 warps an SM, each thread
// up to 255 registers (launch bounds (256, 1)).
#include <stdint.h>

#include "common.cuh"

namespace cvlm {
namespace f32bwd {
namespace {

constexpr int T = 256;           // threads a block, all three kernels
constexpr int BQ = 128;          // query rows of a stats and of a query block
constexpr int BK = 128;          // keys of a stats tile and of a key block
constexpr int KQ = 32;           // query rows of a key-kernel step
constexpr int QK = 64;           // keys of a query-kernel step (one grid row at W = 64)
constexpr int NSLOT = 130;       // rel lanes a key tile touches, at most
constexpr int LDR = NSLOT + 1;   // row stride of the slot tables (odd: rows spread over banks)
constexpr int LDP = BK + 4;      // row stride of P, dS and the dS^T steps
constexpr int WS = 128;          // rel_w lanes the query kernel sums in shared memory
constexpr int LDW = BQ + 4;
constexpr int MAX_LANES = 512;   // ops/flash_attention.py F32_GLOBAL_BWD_MAX_LANES
constexpr int WIN_LANES = 32;    // #14's rel lanes a head
constexpr size_t SMEM_MAX = 232448;

// where the query kernel sums drel's rel_w lanes
enum Wsum { W_REG = 0, W_SHARED = 1, W_DREL = 2 };

// the row stride of q, k, v and g rows in shared memory: 16-byte aligned,
// 8 rows apart or 4 rows in a row land on distinct banks
template <int D>
__host__ __device__ constexpr int ldq() {
  return D + 4;
}

template <int D>
constexpr size_t stats_smem() {
  return sizeof(float) * (3 * (size_t)BQ * ldq<D>() + (size_t)BQ * LDR + BQ) + sizeof(int) * BK;
}

template <int D>
constexpr size_t key_smem() {
  return sizeof(float) * (2 * (size_t)BK * ldq<D>() + 4 * (size_t)KQ * ldq<D>() +
                          2 * (size_t)KQ * LDP + 2 * (size_t)KQ * LDR) +
         sizeof(float4) * 2 * KQ + sizeof(int) * (BK + NSLOT + 2);
}

template <int D>
constexpr size_t query_smem() {
  return sizeof(float) * (2 * ((size_t)QK * LDP + (size_t)QK * ldq<D>()) + (size_t)WS * LDW);
}

struct BwdArgs {
  const float* qkv;  // (P, N, 3 * heads * D)
  const float* rel;  // (query n, problem p, head h, lane l) at n * rq + p * rp + h * lph + l
  const float* g;    // (P, heads * D, N)
  const float* o;    // the forward's output, (P, heads * D, N) with row stride ldo
  float* dqkv;       // like qkv
  float* drel;       // like rel
  float4* stats;     // (P * heads, N): each query row's (max, 1/sum, t, 0)
  float* gt;         // (P * heads, N, D): g as rows
  float* dst;        // (chunk, NP, NP): the chunk's dS^T, key-major
  int N, NP, heads, H, W, lph;
  long long rq, rp, ldo;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes global -> shared, zero-filled where `valid` is false
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The rel lanes of key tile [k0, kend): nw rel_w slots first (lane H + s
// where W <= BK, else H + (k0 + s) % W, one a key), then nh rel_h slots
// (lanes k0 / W ..). Key j's two slots pack as w | h << 16.
struct Slots {
  int nw, nh;
};

__device__ __forceinline__ Slots tile_slots(int k0, int kend, int W) {
  return Slots{W <= BK ? W : kend - k0, (kend - 1) / W - k0 / W + 1};
}

__device__ __forceinline__ int slot_lane(int s, const Slots& sl, int k0, int H, int W) {
  return s < sl.nw ? H + (W <= BK ? s : (k0 + s) % W) : k0 / W + s - sl.nw;
}

__device__ __forceinline__ int key_slots(int key, const Slots& sl, int k0, int W) {
  const int w = W <= BK ? key % W : key - k0;
  return w | ((sl.nw + key / W - k0 / W) << 16);
}

// acc[a][b] = sum over c of X[xa + sa a][c] * Y[yb + 16 b][c], c ascending:
// the one FFMA chain of every score (stats and key kernels) and of dP
template <int D, int NA>
__device__ __forceinline__ void dot(float (&acc)[NA][8], const float* X, int xa, int sa,
                                    const float* Y, int yb) {
  constexpr int LQ = ldq<D>();
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 x[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) x[a] = *reinterpret_cast<const float4*>(X + (xa + sa * a) * LQ + c);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float4 y = *reinterpret_cast<const float4*>(Y + (yb + 16 * b) * LQ + c);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        acc[a][b] = fmaf(x[a].x, y.x, acc[a][b]);
        acc[a][b] = fmaf(x[a].y, y.y, acc[a][b]);
        acc[a][b] = fmaf(x[a].z, y.z, acc[a][b]);
        acc[a][b] = fmaf(x[a].w, y.w, acc[a][b]);
      }
    }
  }
}

// a thread's d / 8 columns of a row: 4 tc .. +3, 32 + 4 tc .. +3 and, at
// d = 80, 64 + 2 tc, +1 (8 threads cover a row)
template <int D>
__device__ __forceinline__ void load_cols(float (&v)[D / 8], const float* row, int tc) {
  const float4 x = *reinterpret_cast<const float4*>(row + 4 * tc);
  const float4 y = *reinterpret_cast<const float4*>(row + 32 + 4 * tc);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
  if constexpr (D == 80) {
    const float2 z = *reinterpret_cast<const float2*>(row + 64 + 2 * tc);
    v[8] = z.x, v[9] = z.y;
  }
}

template <int D>
__device__ __forceinline__ void store_cols(float* row, const float (&v)[D / 8], int tc, float sc) {
  *reinterpret_cast<float4*>(row + 4 * tc) = make_float4(sc * v[0], sc * v[1], sc * v[2], sc * v[3]);
  *reinterpret_cast<float4*>(row + 32 + 4 * tc) =
      make_float4(sc * v[4], sc * v[5], sc * v[6], sc * v[7]);
  if constexpr (D == 80)
    *reinterpret_cast<float2*>(row + 64 + 2 * tc) = make_float2(sc * v[8], sc * v[9]);
}

// acc[jj][cc] += sum over the step's KQ rows i (ascending) of A[i][8 tj +
// jj] * B[i][column cc of tc]: dv (A = P, B = g) and dk (A = dS, B = q)
template <int D>
__device__ __forceinline__ void acc_rows(float (&acc)[8][D / 8], const float* A, const float* B,
                                         int tj, int tc) {
  constexpr int LQ = ldq<D>();
#pragma unroll 2
  for (int i = 0; i < KQ; ++i) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + i * LDP + 8 * tj);
    const float4 a1 = *reinterpret_cast<const float4*>(A + i * LDP + 8 * tj + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[D / 8];
    load_cols<D>(bv, B + i * LQ, tc);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int cc = 0; cc < D / 8; ++cc) acc[jj][cc] = fmaf(av[jj], bv[cc], acc[jj][cc]);
  }
}

// Each query row's (max, 1/sum, t): S over 128-key tiles, online; g's rows.
template <int D>
__global__ void __launch_bounds__(T, 1) attn_bwd_f32_stats_kernel(const BwdArgs a) {
  constexpr int LQ = ldq<D>(), C4 = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [BQ][LQ] q
  float* Ks = Qs + BQ * LQ;        // [2][BK][LQ]
  float* Rt = Ks + 2 * BK * LQ;    // [BQ][LDR] the tile's rel slots of each row
  float* Ts = Rt + BQ * LDR;       // [BQ] t
  int* kslot = reinterpret_cast<int*>(Ts + BQ);  // [BK]

  const int tid = threadIdx.x, tk = tid % 16, tq = tid / 16;  // rows tq + 16 ii, keys tk + 16 jj
  const int N = a.N, H = a.H, W = a.W;
  const int q0 = blockIdx.x * BQ, ph = blockIdx.y, p = ph / a.heads, h = ph % a.heads;
  const size_t C3 = (size_t)3 * a.heads * D;
  const float* qb = a.qkv + (size_t)p * N * C3 + (size_t)h * D;
  const float* kb = qb + (size_t)a.heads * D;
  const float* rel = a.rel + (size_t)p * a.rp + (size_t)h * a.lph;
  const int nkt = (N + BK - 1) / BK;

  auto fetch_k = [&](int kt) {  // key tile kt's rows into Ks[kt % 2], zero past N
    float* dst = Ks + (kt & 1) * BK * LQ;
#pragma unroll
    for (int it = 0; it < BK * C4 / T; ++it) {
      const int idx = tid + it * T, r = idx / C4, c = (idx % C4) * 4, key = kt * BK + r;
      cp16(dst + r * LQ + c, kb + (size_t)min(key, N - 1) * C3 + c, key < N);
    }
    cp_commit();
  };
  fetch_k(0);
#pragma unroll
  for (int it = 0; it < BQ * C4 / T; ++it) {
    const int idx = tid + it * T, r = idx / C4, c = (idx % C4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < N) v = *reinterpret_cast<const float4*>(qb + (size_t)(q0 + r) * C3 + c);
    *reinterpret_cast<float4*>(Qs + r * LQ + c) = v;
  }
  if (tid < BQ) {  // t = sum_c g o of row tid, c ascending; g's row into gt
    float t = 0.f;
    const int row = q0 + tid;
    if (row < N) {
      const float* gr = a.g + (size_t)ph * D * N + row;
      const float* orow = a.o + (size_t)ph * D * a.ldo + row;
      float* gt = a.gt + ((size_t)ph * N + row) * D;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        float gv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          gv[u] = gr[(size_t)(c + u) * N];
          t = fmaf(gv[u], orow[(size_t)(c + u) * a.ldo], t);
        }
        *reinterpret_cast<float4*>(gt + c) = make_float4(gv[0], gv[1], gv[2], gv[3]);
      }
    }
    Ts[tid] = t;
  }

  float m[8], l[8];
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) m[ii] = -INFINITY, l[ii] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK, kend = min(k0 + BK, N);
    if (kt + 1 < nkt) fetch_k(kt + 1);
    // the tile's rel slots; the rel_w slots stay from tile 0 where W <= BK
    const Slots sl = tile_slots(k0, kend, W);
    if (tid < BK) kslot[tid] = k0 + tid < N ? key_slots(k0 + tid, sl, k0, W) : 0;
    const int s_lo = kt == 0 || W > BK ? 0 : sl.nw, span = sl.nw + sl.nh - s_lo;
#pragma unroll 8
    for (int idx = tid; idx < BQ * span; idx += T) {
      const int r = idx / span, s = s_lo + idx % span;
      Rt[r * LDR + s] =
          q0 + r < N ? rel[(size_t)(q0 + r) * a.rq + slot_lane(s, sl, k0, H, W)] : 0.f;
    }
    if (kt + 1 < nkt)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();

    float s[8][8];
    dot<D, 8>(s, Qs, tq, 16, Ks + (kt & 1) * BK * LQ, tk);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = tk + 16 * jj, ks = kslot[j];
      const bool valid = k0 + j < N;
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const float* rr = Rt + (tq + 16 * ii) * LDR;
        s[ii][jj] = valid ? a.scale * s[ii][jj] + rr[ks >> 16] + rr[ks & 0xffff] : -INFINITY;
      }
    }
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      float mx = s[ii][0];
#pragma unroll
      for (int jj = 1; jj < 8; ++jj) mx = fmaxf(mx, s[ii][jj]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[ii], mx);  // finite: key k0 < N is in every tile
      float e = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) e += expf(s[ii][jj] - mn);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
      l[ii] = l[ii] * expf(m[ii] - mn) + e;
      m[ii] = mn;
    }
    __syncthreads();  // Ks[kt % 2], Rt and kslot are no longer read
  }
  if (tk == 0) {
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const int r = tq + 16 * ii;
      if (q0 + r < N) a.stats[(size_t)ph * N + q0 + r] = make_float4(m[ii], 1.f / l[ii], Ts[r], 0.f);
    }
  }
}

// dk and dv of one 128-key tile; dS^T of the tile into the scratch.
template <int D>
__global__ void __launch_bounds__(T, 1) attn_bwd_f32_key_kernel(const BwdArgs a, int ph0) {
  constexpr int LQ = ldq<D>(), C4 = D / 4, NC = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* Kr = smem;               // [BK][LQ]
  float* Vr = Kr + BK * LQ;       // [BK][LQ]
  float* Qr = Vr + BK * LQ;       // [2][KQ][LQ] q
  float* Gr = Qr + 2 * KQ * LQ;   // [2][KQ][LQ] g
  float* Ps = Gr + 2 * KQ * LQ;   // [KQ][LDP] P
  float* Ds = Ps + KQ * LDP;      // [KQ][LDP] dS
  float* Rt = Ds + KQ * LDP;      // [2][KQ][LDR] the rows' rel slots
  float4* St = reinterpret_cast<float4*>(Rt + 2 * KQ * LDR);  // [2][KQ]
  int* kslot = reinterpret_cast<int*>(St + 2 * KQ);           // [BK]
  int* lane = kslot + BK;                                     // [NSLOT]

  const int tid = threadIdx.x, wg = tid / 128, u = tid % 128;
  const int tq = u % 8, tk = u / 8;  // scores: queries tq + 8 ii, keys tk + 16 jj
  const int tc = u % 8, tj = u / 8;  // dv / dk: keys 8 tj + jj, columns of tc
  const int N = a.N, H = a.H, W = a.W;
  const int k0 = blockIdx.x * BK, ph = ph0 + blockIdx.y, p = ph / a.heads, h = ph % a.heads;
  const size_t C3 = (size_t)3 * a.heads * D;
  const float* qb = a.qkv + (size_t)p * N * C3 + (size_t)h * D;
  const float* kb = qb + (size_t)a.heads * D;
  const float* vb = qb + (size_t)2 * a.heads * D;
  const float* gtb = a.gt + (size_t)ph * N * D;
  const float* rel = a.rel + (size_t)p * a.rp + (size_t)h * a.lph;
  float* dst = a.dst + (size_t)blockIdx.y * a.NP * a.NP;

#pragma unroll
  for (int it = 0; it < BK * C4 / T; ++it) {
    const int idx = tid + it * T, r = idx / C4, c = (idx % C4) * 4;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (k0 + r < N) {
      kv = *reinterpret_cast<const float4*>(kb + (size_t)(k0 + r) * C3 + c);
      vv = *reinterpret_cast<const float4*>(vb + (size_t)(k0 + r) * C3 + c);
    }
    *reinterpret_cast<float4*>(Kr + r * LQ + c) = kv;
    *reinterpret_cast<float4*>(Vr + r * LQ + c) = vv;
  }
  const Slots sl = tile_slots(k0, min(k0 + BK, N), W);
  const int ns = sl.nw + sl.nh;
  if (tid < BK) kslot[tid] = k0 + tid < N ? key_slots(k0 + tid, sl, k0, W) : 0;
  for (int s = tid; s < ns; s += T) lane[s] = slot_lane(s, sl, k0, H, W);
  __syncthreads();  // the slot lanes are in for the copies

  // step qt's q and g rows, rel slots and statistics into buffer qt % 2,
  // zero past N
  auto fetch = [&](int qt) {
    const int i0 = qt * KQ, b = qt & 1;
    float* qr = Qr + b * KQ * LQ;
    float* gr = Gr + b * KQ * LQ;
    float* rt = Rt + b * KQ * LDR;
#pragma unroll
    for (int it = 0; it < 2 * KQ * C4 / T; ++it) {
      const int idx = tid + it * T, w = idx / (KQ * C4), r = idx % (KQ * C4) / C4,
                c = (idx % C4) * 4, row = min(i0 + r, N - 1);
      if (w == 0)
        cp16(qr + r * LQ + c, qb + (size_t)row * C3 + c, i0 + r < N);
      else
        cp16(gr + r * LQ + c, gtb + (size_t)row * D + c, i0 + r < N);
    }
#pragma unroll
    for (int it = 0; it < (KQ * NSLOT + T - 1) / T; ++it) {
      const int idx = tid + it * T, r = idx / NSLOT, s = idx % NSLOT;
      if (r < KQ && s < ns)
        cp4(rt + r * LDR + s, rel + (size_t)min(i0 + r, N - 1) * a.rq + lane[s], i0 + r < N);
    }
    if (tid < KQ)
      cp16(St + b * KQ + tid, a.stats + (size_t)ph * N + min(i0 + tid, N - 1), i0 + tid < N);
    cp_commit();
  };

  float acc[8][NC];  // dv (warpgroup 0) or dk (warpgroup 1) of keys 8 tj + jj
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[jj][cc] = 0.f;
  const int nqt = (N + KQ - 1) / KQ;
  fetch(0);
  for (int qt = 0; qt < nqt; ++qt) {
    const int i0 = qt * KQ, b = qt & 1;
    cp_wait<0>();
    // step qt's copies are in, and step qt - 1 is done with buffer (qt + 1)
    // % 2, P and dS: the copies of step qt + 1 run beside step qt
    __syncthreads();
    if (qt + 1 < nqt) fetch(qt + 1);
    const float* qr = Qr + b * KQ * LQ;
    const float* gr = Gr + b * KQ * LQ;
    const float* rt = Rt + b * KQ * LDR;
    const float4* st = St + b * KQ;

    float s[4][8];  // queries tq + 8 ii, keys tk + 16 jj
    if (wg == 0) {
      dot<D, 4>(s, qr, tq, 8, Kr, tk);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = tq + 8 * ii;
        const float4 sv = st[i];  // (max, 1/sum, t): zero past N
        const float* rr = rt + i * LDR;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = tk + 16 * jj, ks = kslot[j];
          Ps[i * LDP + j] = k0 + j < N ? expf(a.scale * s[ii][jj] + rr[ks >> 16] +
                                              rr[ks & 0xffff] - sv.x) * sv.y
                                       : 0.f;
        }
      }
      bar_arrive(1, T);  // P is in for warpgroup 1
      bar_sync(2, 128);  // and for the rest of warpgroup 0
      acc_rows<D>(acc, Ps, gr, tj, tc);
    } else {
      dot<D, 4>(s, gr, tq, 8, Vr, tk);  // dP
      bar_sync(1, T);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = tq + 8 * ii;
        const float t = st[i].z;
        float* drow = dst + (size_t)(k0 + tk) * a.NP + i0 + i;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = tk + 16 * jj;
          const float ds = Ps[i * LDP + j] * (s[ii][jj] - t);
          Ds[i * LDP + j] = ds;
          drow[(size_t)16 * jj * a.NP] = ds;
        }
      }
      bar_sync(3, 128);
      acc_rows<D>(acc, Ds, qr, tj, tc);
    }
  }
  // dv into the v columns, dk (scale * dS^T . q) into the k columns
  float* db = a.dqkv + (size_t)p * N * C3 + (size_t)(2 - wg) * a.heads * D + (size_t)h * D;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int key = k0 + 8 * tj + jj;
    if (key < N) store_cols<D>(db + (size_t)key * C3, acc[jj], tc, wg == 0 ? 1.f : a.scale);
  }
}

// dq and drel of one 128-query tile from the scratch's dS^T; WSUM: where
// the rel_w lanes are summed (W_REG only at W == QK).
template <int D, int WSUM>
__global__ void __launch_bounds__(T, 1) attn_bwd_f32_query_kernel(const BwdArgs a, int ph0) {
  constexpr int LQ = ldq<D>(), C4 = D / 4, NC = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* Dt = smem;                // [2][QK][LDP] dS^T: key j, the tile's queries
  float* Kb = Dt + 2 * QK * LDP;   // [2][QK][LQ] k rows
  float* Dw = Kb + 2 * QK * LQ;    // [WS][LDW] the rows' rel_w sums (W_SHARED)

  const int tid = threadIdx.x, tc = tid % 8, tr = tid / 8;  // rows 4 tr + r, columns of tc
  const int N = a.N, H = a.H, W = a.W;
  const int q0 = blockIdx.x * BQ, ph = ph0 + blockIdx.y, p = ph / a.heads, h = ph % a.heads;
  const int nrow = min(BQ, N - q0);
  const size_t C3 = (size_t)3 * a.heads * D;
  const float* qb = a.qkv + (size_t)p * N * C3 + (size_t)h * D;
  const float* kb = qb + (size_t)a.heads * D;
  const float* src = a.dst + (size_t)blockIdx.y * a.NP * a.NP + q0;
  float* drel = a.drel + (size_t)p * a.rp + (size_t)h * a.lph + (size_t)q0 * a.rq;  // row i at i rq
  const int nkt = (N + QK - 1) / QK;

  auto fetch = [&](int kt) {  // dS^T rows j0 .. j0 + 63 and k rows (zero past N)
    const int j0 = kt * QK;
    float* dt = Dt + (kt & 1) * QK * LDP;
    float* kr = Kb + (kt & 1) * QK * LQ;
#pragma unroll
    for (int it = 0; it < QK * (BQ / 4) / T; ++it) {
      const int idx = tid + it * T, r = idx / (BQ / 4), c = (idx % (BQ / 4)) * 4;
      cp16(dt + r * LDP + c, src + (size_t)(j0 + r) * a.NP + c, true);
    }
#pragma unroll
    for (int it = 0; it < QK * C4 / T; ++it) {
      const int idx = tid + it * T, r = idx / C4, c = (idx % C4) * 4, key = j0 + r;
      cp16(kr + r * LQ + c, kb + (size_t)min(key, N - 1) * C3 + c, key < N);
    }
    cp_commit();
  };
  fetch(0);
  if (WSUM != W_REG) {
    for (int idx = tid; idx < W * BQ; idx += T) {  // the rel_w sums start at 0
      const int kw = idx / BQ, i = idx % BQ;
      if (WSUM == W_SHARED)
        Dw[kw * LDW + i] = 0.f;
      else if (i < nrow)
        drel[(size_t)i * a.rq + H + kw] = 0.f;
    }
  }

  float dq[4][NC], wacc[8][4];  // W_REG: rel_w lanes 8 m + tc of rows 4 tr + r
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dq[r][cc] = 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) wacc[m][r] = 0.f;
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_wait<0>();
    // step kt's copies are in, and step kt - 1 is done with buffer (kt + 1)
    // % 2 and has its drel sums in: the copies of step kt + 1 run beside it
    __syncthreads();
    if (kt + 1 < nkt) fetch(kt + 1);
    const float* dt = Dt + (kt & 1) * QK * LDP;
    const float* kr = Kb + (kt & 1) * QK * LQ;
#pragma unroll 4
    for (int j = 0; j < QK; ++j) {
      const float4 d4 = *reinterpret_cast<const float4*>(dt + j * LDP + 4 * tr);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
      float kv[NC];
      load_cols<D>(kv, kr + j * LQ, tc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) dq[r][cc] = fmaf(dv[r], kv[cc], dq[r][cc]);
    }
    const int j0 = kt * QK, jend = min(j0 + QK, N);
    if (WSUM == W_REG) {
      // the step is grid row kh = kt: rel_w lane 8 m + tc of each row gets
      // its key, rel_h lane kh the step's row sum (the thread's 8 keys in
      // order, then a butterfly over the row's 8 threads)
      float hs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(dt + (8 * m + tc) * LDP + 4 * tr);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          wacc[m][r] += vv[r];
          hs[r] += vv[r];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) hs[r] += __shfl_xor_sync(0xffffffffu, hs[r], off);
        if (tc == 0 && 4 * tr + r < nrow) drel[(size_t)(4 * tr + r) * a.rq + kt] = hs[r];
      }
    } else {
      // rel_w: lane slot kl holds the step's keys of lane (j0 + kl') % W
      // (W <= QK: kl' the first such key's offset), or key j0 + kl (W > QK)
      const int nl = min(W, QK);
      for (int idx = tid; idx < nl * BQ; idx += T) {
        const int kl = idx / BQ, i = idx % BQ;
        const int jf = W <= QK ? j0 + (kl - j0 % W + W) % W : j0 + kl;
        if (i >= nrow || jf >= jend) continue;
        float* w = WSUM == W_SHARED ? Dw + (jf % W) * LDW + i : drel + (size_t)i * a.rq + H + jf % W;
        float acc = *w;
        for (int j = jf; j < jend; j += W) acc += dt[(j - j0) * LDP + i];
        *w = acc;
      }
      // rel_h: grid row kh's keys in the step, added to its lane (set where
      // the step holds the row's first key)
      const int khl = j0 / W, nkh = (jend - 1) / W - khl + 1;
      for (int idx = tid; idx < nkh * BQ; idx += T) {
        const int kh = khl + idx / BQ, i = idx % BQ;
        if (i >= nrow) continue;
        const int ja = max(j0, kh * W), jb = min(jend, (kh + 1) * W);
        float acc = ja == kh * W ? 0.f : drel[(size_t)i * a.rq + kh];
        for (int j = ja; j < jb; ++j) acc += dt[(j - j0) * LDP + i];
        drel[(size_t)i * a.rq + kh] = acc;
      }
    }
  }
  __syncthreads();  // the last step's rel_w sums are in
  float* db = a.dqkv + (size_t)p * N * C3 + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * tr + r;
    if (row < nrow) {
      store_cols<D>(db + (size_t)(q0 + row) * C3, dq[r], tc, a.scale);
      if (WSUM == W_REG)
#pragma unroll
        for (int m = 0; m < 8; ++m) drel[(size_t)row * a.rq + H + 8 * m + tc] = wacc[m][r];
    }
  }
  // the rel_w sums (W_SHARED) and the lanes past H + W (0) into drel's rows
  const int nw = a.lph - H;
  for (int idx = tid; idx < nrow * nw; idx += T) {
    const int i = idx / nw, l = H + idx % nw;
    if (l >= H + W)
      drel[(size_t)i * a.rq + l] = 0.f;
    else if (WSUM == W_SHARED)
      drel[(size_t)i * a.rq + l] = Dw[(l - H) * LDW + i];
  }
}

// Raises a kernel's dynamic shared memory opt-in to `smem` where it is below
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

template <int D, int WSUM>
cudaError_t launch_query(const BwdArgs& a, dim3 grid, int ph0, cudaStream_t s) {
  static size_t allowed = 0;
  const cudaError_t e = allow_smem(attn_bwd_f32_query_kernel<D, WSUM>, query_smem<D>(), allowed);
  if (e != cudaSuccess) return e;
  attn_bwd_f32_query_kernel<D, WSUM><<<grid, T, query_smem<D>(), s>>>(a, ph0);
  return cudaGetLastError();
}

// Queues the stats kernel over all P * heads pairs, then the key and the
// query kernels a chunk of pairs at a time; returns a cudaError_t code.
template <int D>
int launch_bwd(const BwdArgs& a, int P, int chunk, cudaStream_t s) {
  static_assert(stats_smem<D>() <= SMEM_MAX && key_smem<D>() <= SMEM_MAX &&
                    query_smem<D>() <= SMEM_MAX,
                "shared memory");
  const int PH = P * a.heads;
  if (P < 1 || a.N < 1 || a.heads < 1 || PH > 65535 || chunk < 1 || a.H + a.W > MAX_LANES)
    return (int)cudaErrorInvalidValue;
  static size_t s_allowed = 0, k_allowed = 0;
  cudaError_t e = allow_smem(attn_bwd_f32_stats_kernel<D>, stats_smem<D>(), s_allowed);
  if (e == cudaSuccess) e = allow_smem(attn_bwd_f32_key_kernel<D>, key_smem<D>(), k_allowed);
  if (e != cudaSuccess) return (int)e;
  const int nt = (a.N + BQ - 1) / BQ;
  attn_bwd_f32_stats_kernel<D><<<dim3(nt, PH), T, stats_smem<D>(), s>>>(a);
  e = cudaGetLastError();
  for (int ph0 = 0; ph0 < PH && e == cudaSuccess; ph0 += chunk) {
    const dim3 grid(nt, chunk < PH - ph0 ? chunk : PH - ph0);
    attn_bwd_f32_key_kernel<D><<<grid, T, key_smem<D>(), s>>>(a, ph0);
    e = cudaGetLastError();
    if (e != cudaSuccess) break;
    if (a.W == QK)
      e = launch_query<D, W_REG>(a, grid, ph0, s);
    else if (a.W <= WS)
      e = launch_query<D, W_SHARED>(a, grid, ph0, s);
    else
      e = launch_query<D, W_DREL>(a, grid, ph0, s);
  }
  return (int)e;
}

int dispatch_bwd(const BwdArgs& a, int d, int P, int chunk, cudaStream_t s) {
  if (d == 64) return launch_bwd<64>(a, P, chunk, s);
  if (d == 80) return launch_bwd<80>(a, P, chunk, s);
  return (int)cudaErrorInvalidValue;
}

BwdArgs make_args(const void* qkv, const void* rel, const void* g, const void* o, void* dqkv,
                  void* drel, void* stats, void* gt, void* scratch, int N, int heads, int H,
                  int W, int lph, int P, int ldo, float scale) {
  BwdArgs a{};
  a.qkv = static_cast<const float*>(qkv);
  a.rel = static_cast<const float*>(rel);
  a.g = static_cast<const float*>(g);
  a.o = static_cast<const float*>(o);
  a.dqkv = static_cast<float*>(dqkv);
  a.drel = static_cast<float*>(drel);
  a.stats = static_cast<float4*>(stats);
  a.gt = static_cast<float*>(gt);
  a.dst = static_cast<float*>(scratch);
  a.N = N;
  a.NP = (N + BK - 1) / BK * BK;
  a.heads = heads;
  a.H = H;
  a.W = W;
  a.lph = lph;
  a.rp = (long long)heads * lph;
  a.rq = (long long)P * a.rp;
  a.ldo = ldo;
  a.scale = scale;
  return a;
}

}  // namespace
}  // namespace f32bwd
}  // namespace cvlm

// #14: qkv (BW, win^2, 3*heads*d), rel (win^2, BW, heads*32) position-major,
// g (BW, heads*d, win^2), o (BW, heads*d, win^2) with row stride ldo, dqkv
// like qkv, drel like rel (lanes 2 win .. 31 zero); scratch: stats (BW*heads,
// win^2, 4), gt (BW*heads, win^2, d) and dst (chunk, NP, NP), NP = win^2
// rounded up to 128: fp32; 2 win <= 32, d in {64, 80}. Returns a
// cudaError_t code.
extern "C" int cvlm_qkv_packed_windows_s_bwd_f32(const void* qkv, const void* rel, const void* g,
                                                 const void* o, void* dqkv, void* drel,
                                                 void* stats, void* gt, void* dst, int BW,
                                                 int win, int heads, int d, int ldo, int chunk,
                                                 float scale, void* stream) {
  using namespace cvlm::f32bwd;
  if (win < 1 || 2 * win > WIN_LANES || ldo < win * win) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(qkv, rel, g, o, dqkv, drel, stats, gt, dst, win * win, heads, win,
                              win, WIN_LANES, BW, ldo, scale);
  return dispatch_bwd(a, d, BW, chunk, static_cast<cudaStream_t>(stream));
}

// #18: qkv (B, N, 3*heads*d), rel (N, B, heads, H+W), g (B, heads*d, N), o
// (B, heads*d, N) with row stride ldo, dqkv like qkv, drel like rel; scratch
// as #14's: fp32; N = H * W, H + W <= 512, d in {64, 80}. Returns a
// cudaError_t code.
extern "C" int cvlm_qkv_packed_global_bwd_f32(const void* qkv, const void* rel, const void* g,
                                              const void* o, void* dqkv, void* drel, void* stats,
                                              void* gt, void* dst, int B, int N, int H, int W,
                                              int heads, int d, int ldo, int chunk, float scale,
                                              void* stream) {
  using namespace cvlm::f32bwd;
  if (H < 1 || W < 1 || H * W != N || ldo < N) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(qkv, rel, g, o, dqkv, drel, stats, gt, dst, N, heads, H, W, H + W,
                              B, ldo, scale);
  return dispatch_bwd(a, d, B, chunk, static_cast<cudaStream_t>(stream));
}

// The three kernels' dynamic shared memory at d (bytes): out = {stats, key,
// query}; the same at every H and W
extern "C" int cvlm_attn_bwd_f32_smem(int d, long long* out) {
  using namespace cvlm::f32bwd;
  if (d == 64) {
    out[0] = stats_smem<64>(), out[1] = key_smem<64>(), out[2] = query_smem<64>();
  } else if (d == 80) {
    out[0] = stats_smem<80>(), out[1] = key_smem<80>(), out[2] = query_smem<80>();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}
