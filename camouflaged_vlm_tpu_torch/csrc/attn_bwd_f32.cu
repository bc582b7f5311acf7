// attn_bwd_f32: the backward of SAM's rel-pos attention in float32, per
// (image or window, head)
//   o = softmax((q*scale) . k^T + rel[q, k / W] + rel[q, H + k % W]) . v,
// given g = dL/do (d-major), writing dq, dk, dv into the packed qkv rows and
// drel into rel's own position-major layout. All in float32, no rounding
// point: the formulas of `attention_bwd_ref` at fp32,
//   P = softmax(s),  dP = g . v^T,  t = sum_k dP * P,  dS = P * (dP - t),
//   dv = P^T . g,  dq = scale * dS . k,  dk = scale * dS^T . q (q unscaled),
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
// Design: attn_f32.cuh's tiles (64 x 64, 256 threads, each thread a 4 x 4
// block of scores, fp32 FFMA chains), two launches and no atomics, so that
// two calls on the same inputs are bit-equal:
//   the query pass, one block per (64-query tile, problem * heads + h): q
//     (scaled on load), g (read from its d-major rows, coalesced along the
//     queries) and the tile's H + W rel lanes stay in shared memory. Sweep 1
//     over the key tiles computes S and dP and keeps each row's running max,
//     sum and t = sum exp(s - m) dP online, rescaled with the max as the sum
//     is (the Function keeps only its inputs, as the JAX custom_vjp does, so
//     no forward output is at hand for t); t /= sum at the end. Sweep 2
//     computes S and dP again (the same chains, so the same values), P =
//     exp(s - m) / sum and dS = P (dP - t), stages dS in shared memory, adds
//     dS . k into dq and the tile's drel: each (row, lane) sum over the
//     tile's keys of that lane is formed by one thread in key order and
//     added to the row's fp32 lane accumulator in shared memory, tile after
//     tile. It writes dq, drel (every lane of rel's layout, 0 past H + W)
//     and the rows' (max, 1/sum, t) for the key pass.
//   the key pass, one block per (64-key tile, problem * heads + h): k^T and
//     v^T stay in shared memory; per query tile it stages q (scaled, and as
//     rows unscaled), g (transposed and as rows), the rel rows and the
//     statistics, computes S^T and dP^T by the same chains, rebuilds P^T and
//     dS^T from the statistics, and adds P^T . g into dv and dS^T . q into
//     dk. It writes dk and dv.
// 64-key tiles over N leave a ragged last one (196 = 3 * 64 + 4): keys past
// N score -inf in the query pass and are neither read for their bias nor
// stored in the key pass; queries past N are zero rows with zero statistics
// (1/sum = 0), so they add nothing to dk and dv, and are not stored.
//
// Dynamic shared memory at d = 80: the query pass 4 (4 * 80 * 68 + 64 * 80 +
// 64 * 68 + 64 L + 65 L) bytes (190,976 B at the global blocks' L = 128,
// 139,376 B at the windows' 28 lanes), the key pass 4 (4 * 80 * 68 + 2 * 64
// * 80 + 2 * 64 * 68 + 64 L) + 1,024 (196,608 B at L = 128): one block an
// SM, so each thread may hold up to 255 registers (launch bounds (256, 1)).
// The lanes bound it: L <= MAX_LANES (ops/flash_attention.py
// F32_GLOBAL_BWD_MAX_LANES).
#include "attn_f32.cuh"

namespace cvlm {
namespace f32bwd {
namespace {

using f32attn::AK;
using f32attn::AL;
using f32attn::AQ;
using f32attn::AT;
using f32attn::out_col;

constexpr int MAX_LANES = 192;         // ops/flash_attention.py F32_GLOBAL_BWD_MAX_LANES
constexpr size_t SMEM_MAX = 232448;    // dynamic shared memory a block may have (227 KB)
constexpr int DRS = AQ + 1;            // the drel accumulators' row stride

struct BwdArgs {
  const float* qkv;  // (P, N, 3 * heads * D)
  const float* rel;  // (query n, problem p, head h, lane l) at n * rq + p * rp + h * lph + l
  const float* g;    // (P, heads * D, N)
  float* dqkv;       // like qkv
  float* drel;       // like rel
  float4* stats;     // (P * heads, N): each query row's (max, 1/sum, t, 0)
  int N, heads, H, W, lph;
  long long rq, rp;
  float scale;
};

template <int D>
size_t query_smem(int L) {
  return sizeof(float) * (4 * (size_t)D * AL + (size_t)AK * D + (size_t)AK * AL + (size_t)AQ * L +
                          (size_t)L * DRS);
}

template <int D>
size_t key_smem(int L) {
  return sizeof(float) * (4 * (size_t)D * AL + 2 * (size_t)AQ * D + 2 * (size_t)AQ * AL +
                          (size_t)AQ * L) +
         sizeof(float4) * AQ;
}

// the rel lanes (H + W) of rows r0 .. r0 + 63 into Rs[r][lane], rows past N zero
__device__ __forceinline__ void load_rel_rows(float* Rs, const BwdArgs& a, const float* rel,
                                              int r0, int L) {
  for (int idx = threadIdx.x; idx < AQ * L; idx += AT) {
    const int r = idx / L, l = idx % L;
    Rs[idx] = r0 + r < a.N ? rel[(size_t)(r0 + r) * a.rq + l] : 0.f;
  }
}

// g's d-major rows D x 64 from column r0 into Gt[c][r] (and, where Gr is
// given, Gr[r][c]), columns past N zero; coalesced along the queries
template <int D>
__device__ __forceinline__ void load_g(float (*Gt)[AL], float (*Gr)[D], const float* gbase,
                                       int r0, int N) {
  for (int idx = threadIdx.x; idx < D * AQ; idx += AT) {
    const int c = idx / AQ, r = idx % AQ;
    const float v = r0 + r < N ? gbase[(size_t)c * N + r0 + r] : 0.f;
    Gt[c][r] = v;
    if (Gr != nullptr) Gr[r][c] = v;
  }
}

// the bias of a query row (its rel lanes at rr) for key `key` < N
__device__ __forceinline__ float bias(const float* rr, int key, int H, int W) {
  return rr[key / W] + rr[H + key % W];
}

// S (scores with their bias, keys past N at -inf) and dP of rows 4 ty + i
// against keys 4 tx + j: the chains both passes run, in the same order
template <int D>
__device__ __forceinline__ void scores_q(float (&s)[4][4], float (&dp)[4][4],
                                         const float (*Qs)[AL], const float (*Gs)[AL],
                                         const float (*Kt)[AL], const float (*Vt)[AL],
                                         const float* Rs, int L, int j0, int tx, int ty,
                                         const BwdArgs& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const float4 qa = *reinterpret_cast<const float4*>(&Qs[c][4 * ty]);
    const float4 ga = *reinterpret_cast<const float4*>(&Gs[c][4 * ty]);
    const float4 kb = *reinterpret_cast<const float4*>(&Kt[c][4 * tx]);
    const float4 vb = *reinterpret_cast<const float4*>(&Vt[c][4 * tx]);
    const float q[4] = {qa.x, qa.y, qa.z, qa.w}, gg[4] = {ga.x, ga.y, ga.z, ga.w};
    const float k[4] = {kb.x, kb.y, kb.z, kb.w}, v[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(q[i], k[j], s[i][j]);
        dp[i][j] = fmaf(gg[i], v[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = j0 + 4 * tx + j;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[i][j] = key < a.N ? s[i][j] + bias(Rs + (4 * ty + i) * L, key, a.H, a.W) : -INFINITY;
  }
}

// the key tile j0 .. j0 + 63 of k and v into Kt[c][j], Vt[c][j] (and k as
// rows, Kr[j][c]), keys past N zero
template <int D>
__device__ __forceinline__ void load_kv(float (*Kt)[AL], float (*Vt)[AL], float (*Kr)[D],
                                        const float* kbase, const float* vbase, size_t C3,
                                        int j0, int N) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < AK * V4; idx += AT) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (j0 + r < N) {
      kv = *reinterpret_cast<const float4*>(kbase + (j0 + r) * C3 + c);
      vv = *reinterpret_cast<const float4*>(vbase + (j0 + r) * C3 + c);
    }
    Kt[c][r] = kv.x;
    Kt[c + 1][r] = kv.y;
    Kt[c + 2][r] = kv.z;
    Kt[c + 3][r] = kv.w;
    Vt[c][r] = vv.x;
    Vt[c + 1][r] = vv.y;
    Vt[c + 2][r] = vv.z;
    Vt[c + 3][r] = vv.w;
    if (Kr != nullptr) *reinterpret_cast<float4*>(&Kr[r][c]) = kv;
  }
}

// the query tile r0 .. r0 + 63 of q, scaled, into Qt[c][i] (and unscaled as
// rows, Qr[i][c]), rows past N zero
template <int D>
__device__ __forceinline__ void load_q(float (*Qt)[AL], float (*Qr)[D], const float* base,
                                       size_t C3, int r0, int N, float scale) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < AQ * V4; idx += AT) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < N) v = *reinterpret_cast<const float4*>(base + (r0 + r) * C3 + c);
    Qt[c][r] = v.x * scale;
    Qt[c + 1][r] = v.y * scale;
    Qt[c + 2][r] = v.z * scale;
    Qt[c + 3][r] = v.w * scale;
    if (Qr != nullptr) *reinterpret_cast<float4*>(&Qr[r][c]) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(AT, 1) attn_bwd_f32_query_kernel(const BwdArgs a) {
  static_assert(D % 16 == 0, "each thread holds d / 16 columns");
  constexpr int NG = D / 64, NC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float(*Qs)[AL] = reinterpret_cast<float(*)[AL]>(smem);
  float(*Gs)[AL] = reinterpret_cast<float(*)[AL]>(smem + D * AL);
  float(*Kt)[AL] = reinterpret_cast<float(*)[AL]>(smem + 2 * D * AL);
  float(*Vt)[AL] = reinterpret_cast<float(*)[AL]>(smem + 3 * D * AL);
  float(*Kr)[D] = reinterpret_cast<float(*)[D]>(smem + 4 * D * AL);
  float(*Ps)[AL] = reinterpret_cast<float(*)[AL]>(smem + 4 * D * AL + AK * D);
  const int L = a.H + a.W;
  float* Rs = smem + 4 * D * AL + AK * D + AK * AL;  // [AQ][L]
  float* Dr = Rs + AQ * L;                          // [L][DRS]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int N = a.N, heads = a.heads;
  const int q0 = blockIdx.x * AQ, ph = blockIdx.y, p = ph / heads, h = ph % heads;
  const size_t C3 = (size_t)3 * heads * D;
  const float* base = a.qkv + (size_t)p * N * C3 + (size_t)h * D;
  const float* kbase = base + (size_t)heads * D;
  const float* vbase = base + (size_t)2 * heads * D;
  const float* rel = a.rel + (size_t)p * a.rp + (size_t)h * a.lph;

  load_q<D>(Qs, nullptr, base, C3, q0, N, a.scale);
  load_g<D>(Gs, nullptr, a.g + (size_t)ph * D * N, q0, N);
  load_rel_rows(Rs, a, rel, q0, L);
  for (int idx = tid; idx < L * DRS; idx += AT) Dr[idx] = 0.f;

  // sweep 1: each row's max, sum and t, online over the key tiles
  float mrow[4], lrow[4], trow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = trow[i] = 0.f;
  }
  const int nkt = (N + AK - 1) / AK;
  float s[4][4], dp[4][4];
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // the previous tile's k and v are no longer read
    load_kv<D>(Kt, Vt, nullptr, kbase, vbase, C3, kt * AK, N);
    __syncthreads();
    scores_q<D>(s, dp, Qs, Gs, Kt, Vt, Rs, L, kt * AK, tx, ty, a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(mrow[i], mx);
      const float msafe = mnew == -INFINITY ? 0.f : mnew;  // a row with no key seen yet
      const float alpha = expf(mrow[i] - msafe);
      float sum = 0.f, tsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - msafe);
        sum += e;
        tsum = fmaf(e, dp[i][j], tsum);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      }
      lrow[i] = lrow[i] * alpha + sum;
      trow[i] = trow[i] * alpha + tsum;
      mrow[i] = mnew;
    }
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inv[i] = lrow[i] > 0.f ? 1.0f / lrow[i] : 0.f;
    trow[i] *= inv[i];
    if (mrow[i] == -INFINITY) mrow[i] = 0.f;
    const int row = q0 + 4 * ty + i;
    if (tx == 0 && row < N) a.stats[(size_t)ph * N + row] = make_float4(mrow[i], inv[i], trow[i], 0.f);
  }

  // sweep 2: dS, then dq += dS . k and the tile's drel
  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * AK, jend = min(j0 + AK, N);
    __syncthreads();  // the previous tile's k, v and dS are no longer read
    load_kv<D>(Kt, Vt, Kr, kbase, vbase, C3, j0, N);
    __syncthreads();
    scores_q<D>(s, dp, Qs, Gs, Kt, Vt, Rs, L, j0, tx, ty, a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr = expf(s[i][j] - mrow[i]) * inv[i];
        ds[i] = pr * (dp[i][j] - trow[i]);
      }
      *reinterpret_cast<float4*>(&Ps[4 * tx + j][4 * ty]) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < AK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[j][4 * ty]);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
      float k[NC];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 kb = *reinterpret_cast<const float4*>(&Kr[j][64 * g + 4 * tx]);
        k[4 * g] = kb.x;
        k[4 * g + 1] = kb.y;
        k[4 * g + 2] = kb.z;
        k[4 * g + 3] = kb.w;
      }
#pragma unroll
      for (int c = 4 * NG; c < NC; ++c) k[c] = Kr[j][out_col<D>(c, tx)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) dq[i][c] = fmaf(pr[i], k[c], dq[i][c]);
    }
    // drel: (row r, lane l) by one thread, the tile's keys of lane l in order
    const int jm = j0 % a.W;
    for (int idx = tid; idx < AQ * L; idx += AT) {
      const int r = idx % AQ, l = idx / AQ;
      int lo, hi, step;
      if (l < a.H) {  // rel_h lane l: keys l W .. (l + 1) W - 1
        lo = max(j0, l * a.W);
        hi = min(jend, (l + 1) * a.W);
        step = 1;
      } else {  // rel_w lane H + b: keys with k % W == b
        const int b = l - a.H;
        lo = j0 + (b - jm + a.W) % a.W;
        hi = jend;
        step = a.W;
      }
      if (lo >= hi) continue;
      float acc = 0.f;
      for (int j = lo; j < hi; j += step) acc += Ps[j - j0][r];
      Dr[l * DRS + r] += acc;
    }
  }

  // dq (scale * dS . k) into the q columns of dqkv's rows
  float* dbase = a.dqkv + (size_t)p * N * C3 + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= N) continue;
    float* dst = dbase + (size_t)row * C3;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      *reinterpret_cast<float4*>(dst + 64 * g + 4 * tx) =
          make_float4(a.scale * dq[i][4 * g], a.scale * dq[i][4 * g + 1],
                      a.scale * dq[i][4 * g + 2], a.scale * dq[i][4 * g + 3]);
#pragma unroll
    for (int c = 4 * NG; c < NC; ++c) dst[out_col<D>(c, tx)] = a.scale * dq[i][c];
  }
  __syncthreads();  // the last tile's drel sums are in
  float* drel = a.drel + (size_t)p * a.rp + (size_t)h * a.lph;
  for (int idx = tid; idx < AQ * a.lph; idx += AT) {
    const int r = idx / a.lph, l = idx % a.lph;
    if (q0 + r < N) drel[(size_t)(q0 + r) * a.rq + l] = l < L ? Dr[l * DRS + r] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(AT, 1) attn_bwd_f32_key_kernel(const BwdArgs a) {
  constexpr int NG = D / 64, NC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float(*Kt)[AL] = reinterpret_cast<float(*)[AL]>(smem);
  float(*Vt)[AL] = reinterpret_cast<float(*)[AL]>(smem + D * AL);
  float(*Qt)[AL] = reinterpret_cast<float(*)[AL]>(smem + 2 * D * AL);
  float(*Gt)[AL] = reinterpret_cast<float(*)[AL]>(smem + 3 * D * AL);
  float(*Qr)[D] = reinterpret_cast<float(*)[D]>(smem + 4 * D * AL);
  float(*Gr)[D] = reinterpret_cast<float(*)[D]>(smem + 4 * D * AL + AQ * D);
  float(*Pt)[AL] = reinterpret_cast<float(*)[AL]>(smem + 4 * D * AL + 2 * AQ * D);
  float(*Dt)[AL] = reinterpret_cast<float(*)[AL]>(smem + 4 * D * AL + 2 * AQ * D + AQ * AL);
  const int L = a.H + a.W;
  float* Rs = smem + 4 * D * AL + 2 * AQ * D + 2 * AQ * AL;  // [AQ][L]
  float4* St = reinterpret_cast<float4*>(Rs + AQ * L);       // [AQ]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int N = a.N, heads = a.heads;
  const int k0 = blockIdx.x * AK, ph = blockIdx.y, p = ph / heads, h = ph % heads;
  const size_t C3 = (size_t)3 * heads * D;
  const float* base = a.qkv + (size_t)p * N * C3 + (size_t)h * D;
  const float* rel = a.rel + (size_t)p * a.rp + (size_t)h * a.lph;
  const float* gbase = a.g + (size_t)ph * D * N;
  load_kv<D>(Kt, Vt, nullptr, base + (size_t)heads * D, base + (size_t)2 * heads * D, C3, k0, N);

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[j][c] = dv[j][c] = 0.f;
  const int nqt = (N + AQ - 1) / AQ;
  for (int qt = 0; qt < nqt; ++qt) {
    const int i0 = qt * AQ;
    __syncthreads();  // the previous tile's q, g, P and dS are no longer read
    load_q<D>(Qt, Qr, base, C3, i0, N, a.scale);
    load_g<D>(Gt, Gr, gbase, i0, N);
    load_rel_rows(Rs, a, rel, i0, L);
    for (int r = tid; r < AQ; r += AT)
      St[r] = i0 + r < N ? a.stats[(size_t)ph * N + i0 + r] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    // S^T and dP^T of keys 4 ty + j against queries 4 tx + i, by the query
    // pass's chains (q . k and g . v in the same order)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[c][4 * ty]);
      const float4 va = *reinterpret_cast<const float4*>(&Vt[c][4 * ty]);
      const float4 qb = *reinterpret_cast<const float4*>(&Qt[c][4 * tx]);
      const float4 gb = *reinterpret_cast<const float4*>(&Gt[c][4 * tx]);
      const float k[4] = {ka.x, ka.y, ka.z, ka.w}, v[4] = {va.x, va.y, va.z, va.w};
      const float q[4] = {qb.x, qb.y, qb.z, qb.w}, gg[4] = {gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = fmaf(q[i], k[j], s[j][i]);
          dp[j][i] = fmaf(gg[i], v[j], dp[j][i]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + 4 * ty + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 st = St[4 * tx + i];  // (max, 1/sum, t): zero for queries past N
        float pr = 0.f, ds = 0.f;
        if (key < N) {
          pr = expf(s[j][i] + bias(Rs + (4 * tx + i) * L, key, a.H, a.W) - st.x) * st.y;
          ds = pr * (dp[j][i] - st.z);
        }
        s[j][i] = pr;
        dp[j][i] = ds;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(&Pt[4 * tx + i][4 * ty]) =
          make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
      *reinterpret_cast<float4*>(&Dt[4 * tx + i][4 * ty]) =
          make_float4(dp[0][i], dp[1][i], dp[2][i], dp[3][i]);
    }
    __syncthreads();

    // dv += P^T . g, dk += dS^T . q over the tile's queries
#pragma unroll 4
    for (int i = 0; i < AQ; ++i) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[i][4 * ty]);
      const float4 da = *reinterpret_cast<const float4*>(&Dt[i][4 * ty]);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w}, dr[4] = {da.x, da.y, da.z, da.w};
      float gq[NC], qq[NC];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 gb = *reinterpret_cast<const float4*>(&Gr[i][64 * g + 4 * tx]);
        const float4 qb = *reinterpret_cast<const float4*>(&Qr[i][64 * g + 4 * tx]);
        gq[4 * g] = gb.x;
        gq[4 * g + 1] = gb.y;
        gq[4 * g + 2] = gb.z;
        gq[4 * g + 3] = gb.w;
        qq[4 * g] = qb.x;
        qq[4 * g + 1] = qb.y;
        qq[4 * g + 2] = qb.z;
        qq[4 * g + 3] = qb.w;
      }
#pragma unroll
      for (int c = 4 * NG; c < NC; ++c) {
        gq[c] = Gr[i][out_col<D>(c, tx)];
        qq[c] = Qr[i][out_col<D>(c, tx)];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[j][c] = fmaf(pr[j], gq[c], dv[j][c]);
          dk[j][c] = fmaf(dr[j], qq[c], dk[j][c]);
        }
    }
  }

  // dk (scale * dS^T . q) and dv into the k and v columns of dqkv's rows
  float* dbase = a.dqkv + (size_t)p * N * C3 + (size_t)h * D;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + 4 * ty + j;
    if (key >= N) continue;
    float* dkr = dbase + (size_t)key * C3 + (size_t)heads * D;
    float* dvr = dkr + (size_t)heads * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      *reinterpret_cast<float4*>(dkr + 64 * g + 4 * tx) =
          make_float4(a.scale * dk[j][4 * g], a.scale * dk[j][4 * g + 1],
                      a.scale * dk[j][4 * g + 2], a.scale * dk[j][4 * g + 3]);
      *reinterpret_cast<float4*>(dvr + 64 * g + 4 * tx) =
          make_float4(dv[j][4 * g], dv[j][4 * g + 1], dv[j][4 * g + 2], dv[j][4 * g + 3]);
    }
#pragma unroll
    for (int c = 4 * NG; c < NC; ++c) {
      dkr[out_col<D>(c, tx)] = a.scale * dk[j][c];
      dvr[out_col<D>(c, tx)] = dv[j][c];
    }
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

// Queues both passes over P problems; returns a cudaError_t code.
template <int D>
int launch_bwd(const BwdArgs& a, int P, cudaStream_t s) {
  const int L = a.H + a.W;
  const size_t qs = query_smem<D>(L), ks = key_smem<D>(L);
  if (P < 1 || a.N < 1 || a.heads < 1 || (long long)P * a.heads > 65535 || L > MAX_LANES ||
      qs > SMEM_MAX || ks > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  static size_t q_allowed = 0, k_allowed = 0;
  cudaError_t e = allow_smem(attn_bwd_f32_query_kernel<D>, qs, q_allowed);
  if (e == cudaSuccess) e = allow_smem(attn_bwd_f32_key_kernel<D>, ks, k_allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.N + AQ - 1) / AQ, P * a.heads);
  attn_bwd_f32_query_kernel<D><<<grid, AT, qs, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_f32_key_kernel<D><<<grid, AT, ks, s>>>(a);
  return (int)cudaGetLastError();
}

int dispatch_bwd(const BwdArgs& a, int d, int P, cudaStream_t s) {
  if (d == 64) return launch_bwd<64>(a, P, s);
  if (d == 80) return launch_bwd<80>(a, P, s);
  return (int)cudaErrorInvalidValue;
}

BwdArgs make_args(const void* qkv, const void* rel, const void* g, void* dqkv, void* drel,
                  void* stats, int N, int heads, int H, int W, int lph, int P, float scale) {
  BwdArgs a{};
  a.qkv = static_cast<const float*>(qkv);
  a.rel = static_cast<const float*>(rel);
  a.g = static_cast<const float*>(g);
  a.dqkv = static_cast<float*>(dqkv);
  a.drel = static_cast<float*>(drel);
  a.stats = static_cast<float4*>(stats);
  a.N = N;
  a.heads = heads;
  a.H = H;
  a.W = W;
  a.lph = lph;
  a.rp = (long long)heads * lph;
  a.rq = (long long)P * a.rp;
  a.scale = scale;
  return a;
}

}  // namespace
}  // namespace f32bwd
}  // namespace cvlm

// #14: qkv (BW, win^2, 3*heads*d), rel (win^2, BW, heads*32) position-major,
// g (BW, heads*d, win^2), dqkv like qkv, drel like rel (lanes 2 win .. 31
// zero), stats (BW*heads, win^2, 4) scratch: fp32; 2 win <= 32, d in {64,
// 80}. Returns a cudaError_t code.
extern "C" int cvlm_qkv_packed_windows_s_bwd_f32(const void* qkv, const void* rel, const void* g,
                                                 void* dqkv, void* drel, void* stats, int BW,
                                                 int win, int heads, int d, float scale,
                                                 void* stream) {
  using namespace cvlm::f32bwd;
  if (win < 1 || 2 * win > cvlm::f32attn::EDGE_LANES) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(qkv, rel, g, dqkv, drel, stats, win * win, heads, win, win,
                              cvlm::f32attn::EDGE_LANES, BW, scale);
  return dispatch_bwd(a, d, BW, static_cast<cudaStream_t>(stream));
}

// #18: qkv (B, N, 3*heads*d), rel (N, B, heads, H+W), g (B, heads*d, N),
// dqkv like qkv, drel like rel, stats (B*heads, N, 4) scratch: fp32; N = H *
// W, H + W <= 192, d in {64, 80}. Returns a cudaError_t code.
extern "C" int cvlm_qkv_packed_global_bwd_f32(const void* qkv, const void* rel, const void* g,
                                              void* dqkv, void* drel, void* stats, int B, int N,
                                              int H, int W, int heads, int d, float scale,
                                              void* stream) {
  using namespace cvlm::f32bwd;
  if (H < 1 || W < 1 || H * W != N) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(qkv, rel, g, dqkv, drel, stats, N, heads, H, W, H + W, B, scale);
  return dispatch_bwd(a, d, B, static_cast<cudaStream_t>(stream));
}
