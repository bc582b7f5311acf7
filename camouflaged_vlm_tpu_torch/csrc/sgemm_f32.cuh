// The float32 building blocks of the fp32 kernel instances
// (linear_f32.cu, ln_mlp_residual_f32.cu, ln_linear_f32.cu, proj_rows_f32.cu,
// ln_mlp_residual_bwd_f32.cu): the LayerNorm row pass, its backward, and the
// tiled FFMA product with its epilogues. All on the CUDA cores: the H100's
// tensor cores have no float32 mode (TF32 keeps ~3 digits), so these
// compute in full fp32 and are bounded by the 67 TFLOP/s FFMA rate.
//
// The GEMM, C (M, N) = epilogue(A . B), is bounded by the FFMA rate: 2 M N K
// FLOP against (M + N) K + M N floats, 100-1000 FLOP a byte at the paths'
// shapes. What the design does about it:
//   - 8 x 8 outputs a thread in registers (two 4 x 4 groups, BM / 2 rows and
//     BN / 2 columns apart): 64 FFMA a k step for 16 floats read from shared
//     memory; 8 warps an SM (one 128 x 128 block of 256 threads, two of
//     64 x 128 or 128 x 64, four of 64 x 64), up to 255 registers a thread
//     and no spills (capped at 128 for two 128 x 128 blocks an SM, the
//     product spilled and ran slower);
//   - 32-deep k tiles in a 3-stage ring of cp.async copies into dynamic
//     shared memory (one barrier a k tile, no registers spent on staging);
//     each operand is copied as it lies, 16 bytes a copy:
//       K_MAJOR   P[r * ld + k]: rows contiguous along k (activation rows, the
//                 nn.Linear weight (N, K)); a stage [row][32] with its 16-byte
//                 chunks XOR-swizzled (no bank conflicts), read along k: one
//                 16-byte read gives a row's 4 k steps;
//       K_HEADS   the head-leading attention output (#8/#9): row m, column
//                 k = h d + j at h M d + m d + j, each chunk its own address;
//                 stored as K_MAJOR;
//       MN_MAJOR  P[k * ld + r]: contiguous along the output's rows or columns
//                 (the d-major attention output (K, S), W2 (K, H) and W1 (H, K)
//                 as the backward reads them); a stage [32][rows];
//   - the MN path, where both operands are MN_MAJOR (the LN-fed users #2,
//     #3, #4/#5 and the MLP backward #6: their LN rows, hidden, upstream
//     gradient and dh written MN-major, each weight that is K-major as it
//     lies transposed into a scratch, transpose_f32_kernel): each thread reads
//     the 8 + 8 values of one k (two 16-byte reads each) while the previous
//     k's 64 FFMAs run, the next k tile's first ones across the one barrier
//     a k tile; it needs 128 registers, so its own tile runs 16 warps an
//     SM (two 128 x 128 blocks);
//   - a per-shape plan (ops/linear.py f32_gemm_plan): the path, the tile,
//     and split K where a grid leaves SMs idle (short grids cut whole, or
//     the last row tiles of a longer one; the slices summed in order by a
//     second pass, no atomics); proj_rows' (B, T) groups of S % 4 == 0 rows
//     tiled as one M, so that windows of 196 or 112 rows are not padded to
//     whole row tiles.
// Loads are 16 bytes: K_MAJOR needs K % 4 == 0, MN_MAJOR ld % 4 == 0, and a
// 16-byte aligned base; the wrappers check. Ragged M, N and K are zero-filled
// by the copies' source size: nothing past the operand's last row or column
// is read. blockIdx.z walks groups of rows (proj_rows' groups of S % 4 != 0
// rows, #8/#9's images): A moves by `sa` elements a group, C and the
// residual by M * N. Each output is one fp32 sum in k order: no atomics, two
// calls, and the paths and tiles at one split, are bit-equal. Everything
// here has internal linkage: each source
// that includes it keeps its own copy.
#pragma once

#include "common.cuh"

namespace cvlm {
namespace f32 {
namespace {

constexpr int THREADS = 256;  // the LN row passes' block: one warp a row
constexpr int BK = 32;        // the GEMM's k tile

enum Layout { K_MAJOR = 0, MN_MAJOR = 1, K_HEADS = 2 };
// EPI_ACT: act(acc + bias), bias optional; EPI_RES: acc + bias + res;
// EPI_DACT (the MLP backward's dh): pre = acc + bias, C = act'(pre) * res
// (res may be C itself: each element is read, then written, by one
// thread), and act(pre) into `aux` when given; EPI_ACT_T: act(acc + bias)
// written MN-major, C^T (N, ldt), for the next product's MN-major A;
// EPI_DACT_T: EPI_DACT's C = act'(pre) * res with C and res MN-major (N,
// ldt), no aux (the MLP backward's dh on the MN path)
enum Epi { EPI_ACT = 0, EPI_RES = 1, EPI_DACT = 2, EPI_ACT_T = 3, EPI_DACT_T = 4 };

// LN of each row, one warp a row, 16-byte loads (K % 4 == 0): two-pass
// statistics (the mean, then the mean of squared deviations, the JAX
// formulation), xn = (x - mu) * rstd * gamma + beta, times the row mask
// when given (#3: row m of sequence b' = m / S reads mask[b' % nwin][m % S]);
// the rows' (mu, rstd) into `stats` when given (the backward's).
__global__ void __launch_bounds__(THREADS) ln_rows_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ xn, float2* __restrict__ stats, int M,
    int K, float eps, const float* __restrict__ mask, int S, int nwin) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const float4* row = reinterpret_cast<const float4*>(x + (size_t)m * K);
  const int nv = K / 4;
  float s = 0.f;
  for (int c = lane; c < nv; c += 32) {
    const float4 v = row[c];
    s += v.x + v.y + v.z + v.w;
  }
  const float mu = warp_sum(s) / (float)K;
  float q = 0.f;
  for (int c = lane; c < nv; c += 32) {
    const float4 v = row[c];
    q += (v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu) + (v.z - mu) * (v.z - mu) +
         (v.w - mu) * (v.w - mu);
  }
  const float rstd = 1.0f / sqrtf(warp_sum(q) / (float)K + eps);
  if (stats != nullptr && lane == 0) stats[m] = make_float2(mu, rstd);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  float4* dst = reinterpret_cast<float4*>(xn + (size_t)m * K);
  const float mv = mask != nullptr ? mask[(size_t)(m / S % nwin) * S + m % S] : 1.f;
  for (int c = lane; c < nv; c += 32) {
    const float4 v = row[c], g = g4[c], b = b4[c];
    float4 y = make_float4((v.x - mu) * rstd * g.x + b.x, (v.y - mu) * rstd * g.y + b.y,
                           (v.z - mu) * rstd * g.z + b.z, (v.w - mu) * rstd * g.w + b.w);
    if (mask != nullptr) y = make_float4(y.x * mv, y.y * mv, y.z * mv, y.w * mv);
    dst[c] = y;
  }
}

inline int launch_ln_rows(const float* x, const float* gamma, const float* beta, float* xn,
                          float2* stats, int M, int K, float eps, cudaStream_t s,
                          const float* mask = nullptr, int S = 1, int nwin = 1) {
  constexpr int rows = THREADS / 32;
  ln_rows_f32_kernel<<<(M + rows - 1) / rows, THREADS, 0, s>>>(x, gamma, beta, xn, stats, M, K,
                                                               eps, mask, S, nwin);
  return (int)cudaGetLastError();
}

// The same LN rows written MN-major, xt[k * ld + m] (ld % 4 == 0, ld >= M;
// rows M..ld-1 zero), the rows' (mu, rstd) into `stats` when given: a block
// takes 32 rows, one warp a row for the statistics (ln_rows_f32_kernel's
// sums in its order: the same values), then
// LNT_TILES 32 x 32 tiles at a time (each thread's loads in flight
// together) transposed through shared memory, 128-byte rows out.
constexpr int LNT_ROWS = 32, LNT_TILES = 4;

__global__ void __launch_bounds__(THREADS) ln_rows_t_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ xt, float2* __restrict__ stats, int M,
    int K, int ld, float eps, const float* __restrict__ mask, int S, int nwin) {
  __shared__ float st[LNT_ROWS][3];                             // mu, rstd, mask
  __shared__ float tile[LNT_TILES][LNT_ROWS][LNT_ROWS + 1];     // [k][m]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = blockIdx.x * LNT_ROWS, nv = K / 4;
  for (int r = warp; r < LNT_ROWS; r += THREADS / 32) {
    const int m = m0 + r;
    if (m >= M) continue;
    const float4* row = reinterpret_cast<const float4*>(x + (size_t)m * K);
    float s = 0.f;
    for (int c = lane; c < nv; c += 32) {
      const float4 v = row[c];
      s += v.x + v.y + v.z + v.w;
    }
    const float mu = warp_sum(s) / (float)K;
    float q = 0.f;
    for (int c = lane; c < nv; c += 32) {
      const float4 v = row[c];
      q += (v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu) + (v.z - mu) * (v.z - mu) +
           (v.w - mu) * (v.w - mu);
    }
    const float rstd = 1.0f / sqrtf(warp_sum(q) / (float)K + eps);
    if (lane == 0) {
      if (stats != nullptr) stats[m] = make_float2(mu, rstd);
      st[r][0] = mu;
      st[r][1] = rstd;
      st[r][2] = mask != nullptr ? mask[(size_t)(m / S % nwin) * S + m % S] : 1.f;
    }
  }
  __syncthreads();
  const int r = threadIdx.x / 8, c = threadIdx.x % 8;  // in: row r, 16-byte chunk c
  const int m = m0 + r, mo = m0 + 4 * c;               // out: k row r, rows mo..mo+3
  const float mu = st[r][0], rstd = st[r][1], mv = st[r][2];
  for (int k0 = 0; k0 < K; k0 += LNT_TILES * LNT_ROWS) {
    float4 v[LNT_TILES];
#pragma unroll
    for (int q = 0; q < LNT_TILES; ++q) {
      const int kk = k0 + q * LNT_ROWS + 4 * c;
      v[q] = m < M && kk < K ? *reinterpret_cast<const float4*>(x + (size_t)m * K + kk)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < LNT_TILES; ++q) {
      const int kk = k0 + q * LNT_ROWS + 4 * c;
      float y[4] = {0.f, 0.f, 0.f, 0.f};
      if (m < M && kk < K) {
        const float4 g = *reinterpret_cast<const float4*>(gamma + kk);
        const float4 b = *reinterpret_cast<const float4*>(beta + kk);
        y[0] = (v[q].x - mu) * rstd * g.x + b.x;
        y[1] = (v[q].y - mu) * rstd * g.y + b.y;
        y[2] = (v[q].z - mu) * rstd * g.z + b.z;
        y[3] = (v[q].w - mu) * rstd * g.w + b.w;
        if (mask != nullptr)
#pragma unroll
          for (int i = 0; i < 4; ++i) y[i] *= mv;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) tile[q][4 * c + i][r] = y[i];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < LNT_TILES; ++q) {
      const int k = k0 + q * LNT_ROWS + r;
      if (k < K && mo < ld)
        *reinterpret_cast<float4*>(xt + (size_t)k * ld + mo) = make_float4(
            tile[q][r][4 * c], tile[q][r][4 * c + 1], tile[q][r][4 * c + 2], tile[q][r][4 * c + 3]);
    }
    __syncthreads();
  }
}

// The rows' leading dimension of an MN-major scratch of M rows: whole
// 16-byte chunks
inline int mn_ld(int M) { return (M + 3) / 4 * 4; }

// xt (K, ld): ld % 4 == 0 and ld >= M (a row panel's scratch: the full
// panel's ld)
inline int launch_ln_rows_t(const float* x, const float* gamma, const float* beta, float* xt,
                            float2* stats, int M, int K, int ld, float eps, cudaStream_t s,
                            const float* mask = nullptr, int S = 1, int nwin = 1) {
  if (ld < M || ld % 4 != 0) return (int)cudaErrorInvalidValue;
  ln_rows_t_f32_kernel<<<(M + LNT_ROWS - 1) / LNT_ROWS, THREADS, 0, s>>>(
      x, gamma, beta, xt, stats, M, K, ld, eps, mask, S, nwin);
  return (int)cudaGetLastError();
}

// wt (C, ldt) = w (R, C)^T (ldt >= R): the MN path's copy of a weight, or of
// #6's upstream gradient (a row panel's, ldt its scratch's mn_ld; rows R..
// ldt-1 not written), 32 x 32 tiles through shared memory, 128-byte rows in
// and out (ragged tiles are cut).
__global__ void __launch_bounds__(THREADS) transpose_f32_kernel(const float* __restrict__ w,
                                                                float* __restrict__ wt, int R,
                                                                int C, int ldt) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = ty; i < 32; i += THREADS / 32)
    if (r0 + i < R && c0 + tx < C) tile[i][tx] = w[(size_t)(r0 + i) * C + c0 + tx];
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += THREADS / 32)
    if (c0 + i < C && r0 + tx < R) wt[(size_t)(c0 + i) * ldt + r0 + tx] = tile[tx][i];
}

// ldt 0: R
inline int launch_transpose(const float* w, float* wt, int R, int C, cudaStream_t s,
                            int ldt = 0) {
  if (ldt == 0) ldt = R;
  if (ldt < R || (R + 31) / 32 > 65535) return (int)cudaErrorInvalidValue;
  transpose_f32_kernel<<<dim3((C + 31) / 32, (R + 31) / 32), THREADS, 0, s>>>(w, wt, R, C, ldt);
  return (int)cudaGetLastError();
}

// The LN backward of each row, one warp a row: dx = rstd * (dxhat -
// mean(dxhat) - xhat * mean(dxhat * xhat)) + g, dxhat = dxn * gamma, xhat =
// (x - mu) * rstd from the forward's statistics; g is the residual's
// gradient, none when null (the forward had no residual).
__global__ void __launch_bounds__(THREADS) ln_bwd_rows_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ gamma,
    const float2* __restrict__ stats, const float* __restrict__ dxn, float* __restrict__ dx,
    int M, int K) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const float2 st = stats[m];
  const size_t o = (size_t)m * K;
  const float4* xr = reinterpret_cast<const float4*>(x + o);
  const float4* dr = reinterpret_cast<const float4*>(dxn + o);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const int nv = K / 4;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < nv; c += 32) {
    const float4 v = xr[c], d = dr[c], ga = g4[c];
    const float dh[4] = {d.x * ga.x, d.y * ga.y, d.z * ga.z, d.w * ga.w};
    const float xh[4] = {(v.x - st.x) * st.y, (v.y - st.x) * st.y, (v.z - st.x) * st.y,
                         (v.w - st.x) * st.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s1 += dh[i];
      s2 += dh[i] * xh[i];
    }
  }
  const float m1 = warp_sum(s1) / (float)K, m2 = warp_sum(s2) / (float)K;
  const float4* gr = g != nullptr ? reinterpret_cast<const float4*>(g + o) : nullptr;
  float4* out = reinterpret_cast<float4*>(dx + o);
  for (int c = lane; c < nv; c += 32) {
    const float4 v = xr[c], d = dr[c], ga = g4[c];
    const float4 gu = gr != nullptr ? gr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float dh[4] = {d.x * ga.x, d.y * ga.y, d.z * ga.z, d.w * ga.w};
    const float xv[4] = {v.x, v.y, v.z, v.w}, gv[4] = {gu.x, gu.y, gu.z, gu.w};
    float r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xh = (xv[i] - st.x) * st.y;
      r[i] = st.y * (dh[i] - m1 - xh * m2) + gv[i];
    }
    out[c] = make_float4(r[0], r[1], r[2], r[3]);
  }
}

inline int launch_ln_bwd_rows(const float* x, const float* g, const float* gamma,
                              const float2* stats, const float* dxn, float* dx, int M, int K,
                              cudaStream_t s) {
  constexpr int rows = THREADS / 32;
  ln_bwd_rows_f32_kernel<<<(M + rows - 1) / rows, THREADS, 0, s>>>(x, g, gamma, stats, dxn, dx,
                                                                   M, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- the GEMM
//
// One stage of an operand in shared memory: ROWS x BK floats.
//   K_MAJOR and K_HEADS: [row][BK], the 8 16-byte chunks of a row at
//     positions c ^ ((row >> 2) & 7) (an XOR swizzle: the 8 threads of a
//     128-bit load phase read 8 different rows at 8 different bank groups);
//   MN_MAJOR: [k][ROWS], as the operand lies.
// Each 16-byte chunk is copied by its own cp.async (its own address: a
// K_HEADS tile straddles heads, d = 80 being 2.5 k tiles), the bytes past the
// operand's last row or column zero-filled by the copy's source size
// (common.cuh cp16; swizzle_chunk<BK / 4, 2>: rows 4 apart on different bank
// groups).

// Queue the copies of one operand's k tile [k0, k0 + BK) of rows [r0, r0 +
// ROWS) into stage S, by the block's T threads. R rows in the operand (per
// blockIdx.z group); MN_MAJOR row m lies at (m / gs) gst + m % gs when gs > 0
// (proj_rows' groups of gs rows tiled as one M, gs % 4 == 0), else at m.
template <int LAYOUT, int ROWS, int T>
__device__ __forceinline__ void load_tile(float* S, const float* __restrict__ P, int ld, int r0,
                                          int R, int k0, int K, int gs, long long gst) {
  const int tid = threadIdx.x;
  if (LAYOUT == MN_MAJOR) {
    constexpr int CPR = ROWS / 4;  // chunks along a k row
    const int r = (tid % CPR) * 4, m = r0 + r;
    const int nv = R - m < 4 ? R - m : 4;  // rows of the chunk inside the operand
    const long long ro = gs > 0 ? (long long)(m / gs) * gst + m % gs : m;
#pragma unroll
    for (int i = 0; i < BK * CPR / T; ++i) {
      const int k = tid / CPR + i * (T / CPR), kk = k0 + k;
      const bool in = nv > 0 && kk < K;
      cp16(S + k * ROWS + r, in ? P + (size_t)kk * ld + ro : P, in ? 4 * nv : 0);
    }
  } else {
    constexpr int KC = BK / 4;  // chunks along a row
    const int c = tid % KC, kk = k0 + 4 * c;
    // the column's offset: K_HEADS column kk = h d + j lies at h R d + j
    const long long co = LAYOUT == K_MAJOR ? kk : (long long)(kk / ld) * R * ld + kk % ld;
#pragma unroll
    for (int i = 0; i < ROWS * KC / T; ++i) {
      const int r = tid / KC + i * (T / KC), m = r0 + r;
      const bool in = m < R && kk < K;
      cp16(S + r * BK + 4 * swizzle_chunk<BK / 4, 2>(c, r), in ? P + (size_t)m * ld + co : P,
           in ? 16 : 0);
    }
  }
}

// A thread's rows of one operand at chunk c (k = 4 c .. 4 c + 3) of a stage:
// f[4 h + i][kk] = row (ROWS / 2) h + 4 t + i at k = 4 c + kk. Eight 16-byte
// reads in either layout (along k in the K layout, along rows in MN).
template <int LAYOUT, int ROWS>
__device__ __forceinline__ void load_frag(float (&f)[8][4], const float* S, int t, int c) {
  if (LAYOUT == MN_MAJOR) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(S + (4 * c + kk) * ROWS + (ROWS / 2) * h + 4 * t);
        f[4 * h][kk] = v.x;
        f[4 * h + 1][kk] = v.y;
        f[4 * h + 2][kk] = v.z;
        f[4 * h + 3][kk] = v.w;
      }
  } else {
    // (row >> 2) & 7 == t & 7 for every row of the thread (ROWS / 8 is 8 or 16)
    const int pos = 4 * swizzle_chunk<BK / 4, 2>(c, 4 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(S + ((ROWS / 2) * h + 4 * t + i) * BK + pos);
        f[4 * h + i][0] = v.x;
        f[4 * h + i][1] = v.y;
        f[4 * h + i][2] = v.z;
        f[4 * h + i][3] = v.w;
      }
  }
}

// The block tiles: BM x BN outputs, 8 x 8 a thread (two 4 x 4 groups BM / 2
// rows and BN / 2 columns apart), BM BN / 64 threads, a warp 8 x 4 threads
// (its 16-byte reads touch 8 and 4 distinct chunks); STAGES k tiles in
// flight; MIN_BLOCKS co-resident blocks an SM (a register cap of 65536 /
// (MIN_BLOCKS THREADS), 255 at most: none spills). `tile` argument t of
// launch_sgemm runs case t below, the order of ops/linear.py F32_TILES; case
// 4, 128 x 128 at two blocks (16 warps) an SM, only where both operands are
// MN-major (the MN path fits 128 registers; the K-major fragments take 255).
template <int BM_, int BN_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int THREADS = BM * BN / 64;
  static constexpr int SMEM = STAGES * (BM + BN) * BK * 4;
  static_assert((BM == 64 || BM == 128) && (BN == 64 || BN == 128), "tile rows");
};

// One k of a thread's outputs from an MN-major stage: f[4 h + i] = row or
// column (ROWS / 2) h + 4 t + i at k.
template <int ROWS>
__device__ __forceinline__ void load_frag_k(float (&f)[8], const float* S, int t, int k) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(S + k * ROWS + (ROWS / 2) * h + 4 * t);
    f[4 * h] = v.x;
    f[4 * h + 1] = v.y;
    f[4 * h + 2] = v.z;
    f[4 * h + 3] = v.w;
  }
}

// The epilogue of 4 outputs of one row, v = the sum over k, at columns n..n+3
// and element o of C: + bias; EPI_ACT act(.); EPI_RES + res (none when res is
// null); EPI_DACT act'(.) * res (res may be C: read before written) and
// act(.) into aux when given.
template <int EPI>
__device__ __forceinline__ void epilogue4(float (&v)[4], int n, size_t o,
                                          const float* __restrict__ bias, const float* res,
                                          float* C, float* __restrict__ aux, int act) {
  if (bias != nullptr) {
    const float4 bv = *reinterpret_cast<const float4*>(bias + n);
    v[0] += bv.x;
    v[1] += bv.y;
    v[2] += bv.z;
    v[3] += bv.w;
  }
  if (EPI == EPI_RES && res == nullptr) {
  } else if (EPI == EPI_RES || EPI == EPI_DACT) {
    const float4 r = *reinterpret_cast<const float4*>(res + o);
    const float rv[4] = {r.x, r.y, r.z, r.w};
    if (EPI == EPI_DACT && aux != nullptr)
      *reinterpret_cast<float4*>(aux + o) = make_float4(
          apply_act(v[0], act), apply_act(v[1], act), apply_act(v[2], act), apply_act(v[3], act));
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = EPI == EPI_RES ? v[c] + rv[c] : act_grad(v[c], act) * rv[c];
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = apply_act(v[c], act);
  }
  *reinterpret_cast<float4*>(C + o) = make_float4(v[0], v[1], v[2], v[3]);
}

// The transposed epilogues of rows m..m+3 of one column at element o of C^T,
// v = the sums + bias: EPI_ACT_T act(.); EPI_DACT_T act'(.) * res (res may
// be C: read before written). One 16-byte store.
template <int EPI>
__device__ __forceinline__ void epilogue4_t(float (&v)[4], size_t o, const float* res, float* C,
                                            int act) {
  if (EPI == EPI_DACT_T) {
    const float4 r = *reinterpret_cast<const float4*>(res + o);
    const float rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = act_grad(v[i], act) * rv[i];
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = apply_act(v[i], act);
  }
  *reinterpret_cast<float4*>(C + o) = make_float4(v[0], v[1], v[2], v[3]);
}

// C (M, N) = epilogue(A . B) for A (M, K) and B (N, K) in the layouts LA,
// LB (leading dimensions lda, ldb; K_HEADS: lda = d); C, res and aux (M, N)
// with row stride N. N % 4 == 0 (16-byte epilogue rows). The tiles, gx
// along N, gy along M, then groups (A moves by sa elements a group, C, res
// and aux by M N). Without SPLIT, block (x, y, z) computes the tile of
// column x, row y of group z over all of K. With SPLIT, a second launch for
// the last `tr` row tiles of each group (of gy), block (x, y, z) computes
// slice z % splits (kspan deep) of the tail tile q = (z / splits tr + y) gx
// + x (column x, row gy - tr + y, group z / splits), its sums into ws + (q
// splits + z % splits) BM BN (a tile's BM x BN, row-major) for
// splitk_finish_kernel, which adds the slices in order and applies the
// epilogue. (Two kernels, the tiles from blockIdx: a slice's k bounds, an
// early exit or a tile index's quotients held in registers cost the
// mainloop up to 25% at 254 registers, PERF.md §6.)
template <class TL, int LA, int LB, int EPI, bool SPLIT>
__global__ void __launch_bounds__(TL::THREADS, TL::MIN_BLOCKS) sgemm_kernel(
    const float* __restrict__ A, int lda, long long sa, int gs, long long gst,
    const float* __restrict__ B, int ldb, const float* __restrict__ bias, const float* res,
    float* C, float* __restrict__ aux, int M, int N, int K, int act, int gx, int gy, int tr,
    int splits, int kspan, float* __restrict__ ws, int ldt) {
  constexpr int BM = TL::BM, BN = TL::BN, T = TL::THREADS, ST = TL::STAGES;
  constexpr int SA = BM * BK, SB = BN * BK;  // floats a stage
  // the MN path: both operands MN-major, fragments along M and N one k at a
  // time, the next k's read while this one's FFMAs run
  constexpr bool MN = LA == MN_MAJOR && LB == MN_MAJOR;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + ST * SA;
  // thread (tx, ty) of the (BN / 8) x (BM / 8) grid; a warp 8 x 4 of them
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tx = warp % (BN / 64) * 8 + lane % 8, ty = warp / (BN / 64) * 4 + lane / 8;
  const int g = SPLIT ? blockIdx.z / splits : blockIdx.z;
  const int kb = SPLIT ? (blockIdx.z - g * splits) * kspan : 0;
  const int ke = !SPLIT || K - kb < kspan ? K : kb + kspan;
  const int m0 = (SPLIT ? gy - tr + blockIdx.y : blockIdx.y) * BM, n0 = blockIdx.x * BN;
  A += (size_t)g * sa;
  const size_t co = (size_t)g * M * N;
  const int nk = (ke - kb + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) {
      load_tile<LA, BM, T>(As + s * SA, A, lda, m0, M, kb + s * BK, ke, gs, gst);
      load_tile<LB, BN, T>(Bs + s * SB, B, ldb, n0, N, kb + s * BK, ke, 0, 0);
    }
    cp_commit();
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if constexpr (MN) {
    // One barrier a k tile, at its last k: everyone has read the tile's
    // last fragments, so the stage of k tile kt - 1 (freed at the last
    // barrier) takes k tile kt + ST - 1, and k tile kt + 1 has landed; its
    // first fragments are read before the last k's FFMAs.
    float af[2][8], bf[2][8];
    cp_wait<ST - 2>();
    __syncthreads();
    load_frag_k<BM>(af[0], As, ty, 0);
    load_frag_k<BN>(bf[0], Bs, tx, 0);
    int cur = 0, nxt = ST - 1;
    for (int kt = 0; kt < nk; ++kt) {
      const float* as = As + cur * SA;
      const float* bs = Bs + cur * SB;
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        if (k == BK - 1) {
          if (kt + ST - 1 < nk) {
            const int k0 = kb + (kt + ST - 1) * BK;
            load_tile<LA, BM, T>(As + nxt * SA, A, lda, m0, M, k0, ke, gs, gst);
            load_tile<LB, BN, T>(Bs + nxt * SB, B, ldb, n0, N, k0, ke, 0, 0);
          }
          cp_commit();
          cp_wait<ST - 2>();
          __syncthreads();
          cur = cur == ST - 1 ? 0 : cur + 1;
          nxt = nxt == ST - 1 ? 0 : nxt + 1;
          load_frag_k<BM>(af[(k + 1) % 2], As + cur * SA, ty, 0);
          load_frag_k<BN>(bf[(k + 1) % 2], Bs + cur * SB, tx, 0);
        } else {
          load_frag_k<BM>(af[(k + 1) % 2], as, ty, k + 1);
          load_frag_k<BN>(bf[(k + 1) % 2], bs, tx, k + 1);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(af[k % 2][i], bf[k % 2][j], acc[i][j]);
      }
    }
  } else {
    int cur = 0, nxt = ST - 1;  // the stages of k tiles kt and kt + ST - 1
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<ST - 2>();  // this thread's copies of k tile kt have landed
      __syncthreads();    // everyone's; and k tile kt - 1's stage is read
      if (kt + ST - 1 < nk) {
        const int k0 = kb + (kt + ST - 1) * BK;
        load_tile<LA, BM, T>(As + nxt * SA, A, lda, m0, M, k0, ke, gs, gst);
        load_tile<LB, BN, T>(Bs + nxt * SB, B, ldb, n0, N, k0, ke, 0, 0);
      }
      cp_commit();
      const float* as = As + cur * SA;
      const float* bs = Bs + cur * SB;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) {
        float a[8][4];
        load_frag<LA, BM>(a, as, ty, c);
        if (LB == MN_MAJOR) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float b[8];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 v = *reinterpret_cast<const float4*>(bs + (4 * c + kk) * BN +
                                                                (BN / 2) * h + 4 * tx);
              b[4 * h] = v.x;
              b[4 * h + 1] = v.y;
              b[4 * h + 2] = v.z;
              b[4 * h + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
          }
        } else {  // B's rows one at a time, along k
          const int pos = 4 * swizzle_chunk<BK / 4, 2>(c, 4 * tx);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(
                bs + ((BN / 2) * (j / 4) + 4 * tx + j % 4) * BK + pos);
            const float b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i][kk], b[kk], acc[i][j]);
          }
        }
      }
      cur = cur == ST - 1 ? 0 : cur + 1;
      nxt = nxt == ST - 1 ? 0 : nxt + 1;
    }
  }

  if (SPLIT) {  // a slice's sums, the whole tile (zeros past the edges)
    const int q = (g * tr + blockIdx.y) * gx + blockIdx.x;
    float* part = ws + ((size_t)q * splits + blockIdx.z - g * splits) * BM * BN;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(part + ((BM / 2) * (i / 4) + 4 * ty + i % 4) * BN +
                                   (BN / 2) * h + 4 * tx) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    return;
  }
  if constexpr (EPI == EPI_ACT_T || EPI == EPI_DACT_T) {
    // C^T (N, ldt): rows m..m+3 of column n, 16 bytes; EPI_DACT_T only the
    // chunks that start below M (its res is written there)
    const int lim = EPI == EPI_DACT_T ? M : ldt;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (BM / 2) * h + 4 * ty;
      if (m >= lim) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + (BN / 2) * (j / 4) + 4 * tx + j % 4;
        if (n >= N) continue;
        const float bv = bias != nullptr ? bias[n] : 0.f;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = acc[4 * h + i][j];
          if (bias != nullptr) v[i] += bv;
        }
        epilogue4_t<EPI>(v, co + (size_t)n * ldt + m, res, C, act);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (BM / 2) * (i / 4) + 4 * ty + i % 4;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + (BN / 2) * h + 4 * tx;
        if (n >= N) continue;
        float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
        epilogue4<EPI>(v, n, co + (size_t)m * N + n, bias, res, C, aux, act);
      }
    }
  }
}

// Split K's second pass, one block a tail tile (q = blockIdx.x, numbered as
// sgemm_kernel<..., true> numbers them): each 4 outputs the sum of its
// `splits` slices in slice order, then the epilogue. EPI_ACT_T and
// EPI_DACT_T take 4 x 4 blocks, rows fastest, and write 4 rows of a column
// of C^T in one 16-byte store (ldt % 4 == 0: a chunk that starts below M
// ends below ldt).
template <class TL, int EPI>
__global__ void __launch_bounds__(256) splitk_finish_kernel(
    const float* __restrict__ ws, int splits, int M, int N, int gx, int gy, int tr,
    const float* __restrict__ bias, const float* res, float* C, float* __restrict__ aux,
    int act, int ldt) {
  constexpr int BM = TL::BM, BN = TL::BN;
  const int q = blockIdx.x;
  const int m0 = (gy - tr + q / gx % tr) * BM, n0 = q % gx * BN;
  const size_t co = (size_t)(q / (gx * tr)) * M * N;
  const float* part = ws + (size_t)blockIdx.x * splits * BM * BN;
  auto sum4 = [&](int r, int c) {  // row r, columns c..c+3 of the tile, over the slices
    float4 s = *reinterpret_cast<const float4*>(part + r * BN + c);
    for (int i = 1; i < splits; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(part + (size_t)i * BM * BN + r * BN + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    return s;
  };
  if constexpr (EPI == EPI_ACT_T || EPI == EPI_DACT_T) {
    for (int q = threadIdx.x; q < BM * BN / 16; q += 256) {
      const int r = q % (BM / 4) * 4, c = q / (BM / 4) * 4, m = m0 + r, n = n0 + c;
      if (m >= M || n >= N) continue;
      float v[4][4];  // [column][row]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 s = sum4(r + i, c);
        v[0][i] = s.x;
        v[1][i] = s.y;
        v[2][i] = s.z;
        v[3][i] = s.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (bias != nullptr)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[j][i] += bias[n + j];
        epilogue4_t<EPI>(v[j], co + (size_t)(n + j) * ldt + m, res, C, act);
      }
    }
  } else {
    for (int q = threadIdx.x; q < BM * BN / 4; q += 256) {
      const int r = q / (BN / 4), c = q % (BN / 4) * 4, m = m0 + r, n = n0 + c;
      if (m >= M || n >= N) continue;
      const float4 s = sum4(r, c);
      float v[4] = {s.x, s.y, s.z, s.w};
      epilogue4<EPI>(v, n, co + (size_t)m * N + n, bias, res, C, aux, act);
    }
  }
}

// How a product is cut (ops/linear.py F32Plan): the block tile (F32_TILES),
// and the k range of each group's last `tail_rows` row tiles in `splits`
// slices (splits 1: none), their sums in ws (groups tail_rows gx splits BM
// BN floats).
struct Plan {
  int tile, splits, tail_rows;
  float* ws;
};

template <class TL, int LA, int LB, int EPI>
int run_sgemm(const float* A, int lda, long long sa, int gs, long long gst, const float* B,
              int ldb, const float* bias, const float* res, float* C, float* aux, int M, int N,
              int K, int act, int groups, Plan plan, cudaStream_t s, int ldt) {
  static bool opted[64] = {};  // the shared-memory opt-ins, once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    e = cudaFuncSetAttribute(sgemm_kernel<TL, LA, LB, EPI, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(sgemm_kernel<TL, LA, LB, EPI, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  // whole k tiles a slice, every slice non-empty (the wrapper's splits); the
  // tail at most every row tile (a ragged last row panel has fewer)
  const int nk = (K + BK - 1) / BK, splits = plan.splits;
  if (splits < 1 || splits > nk) return (int)cudaErrorInvalidValue;
  const int per = (nk + splits - 1) / splits;
  const int gx = (N + TL::BN - 1) / TL::BN, gy = (M + TL::BM - 1) / TL::BM;
  if ((nk + per - 1) / per != splits || plan.tail_rows < 0 ||
      (splits > 1 && plan.ws == nullptr) || gy > 65535 || (long long)groups * splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int tr = splits == 1 ? 0 : (plan.tail_rows < gy ? plan.tail_rows : gy);
  if (tr < gy) {  // the row tiles computed whole
    const dim3 grid(gx, gy - tr, groups);
    sgemm_kernel<TL, LA, LB, EPI, false><<<grid, TL::THREADS, TL::SMEM, s>>>(
        A, lda, sa, gs, gst, B, ldb, bias, res, C, aux, M, N, K, act, gx, gy, 0, 1, K,
        nullptr, ldt);
    e = cudaGetLastError();
    if (e != cudaSuccess || tr == 0) return (int)e;
  }
  const int tail = gx * tr * groups;
  const dim3 grid(gx, tr, groups * splits);
  sgemm_kernel<TL, LA, LB, EPI, true><<<grid, TL::THREADS, TL::SMEM, s>>>(
      A, lda, sa, gs, gst, B, ldb, bias, res, C, aux, M, N, K, act, gx, gy, tr, splits,
      per * BK, plan.ws, ldt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  splitk_finish_kernel<TL, EPI><<<tail, 256, 0, s>>>(plan.ws, splits, M, N, gx, gy, tr, bias,
                                                      res, C, aux, act, ldt);
  return (int)cudaGetLastError();
}

// The MN path's launches (both operands MN-major), on its own tiles.
template <class TL, int LA, int LB, int EPI>
int run_sgemm_mn(const float* A, int lda, long long sa, int gs, long long gst, const float* B,
                 int ldb, const float* bias, const float* res, float* C, float* aux, int M,
                 int N, int K, int act, int groups, Plan plan, cudaStream_t s, int ldt) {
  static_assert(LA == MN_MAJOR && LB == MN_MAJOR, "the MN path");
  return run_sgemm<TL, LA, LB, EPI>(A, lda, sa, gs, gst, B, ldb, bias, res, C, aux, M, N, K, act,
                                    groups, plan, s, ldt);
}

// Queues one product as `plan` cuts it; `groups` the row groups (C, res and
// aux move by M N a group, A by sa); gs, gst MN_MAJOR A's row groups tiled
// as one M (load_tile); ldt EPI_ACT_T's and EPI_DACT_T's C^T leading
// dimension (% 4 == 0, >= M). Returns a cudaError_t code.
template <int LA, int LB, int EPI>
int launch_sgemm(const float* A, int lda, long long sa, const float* B, int ldb,
                 const float* bias, const float* res, float* C, float* aux, int M, int N, int K,
                 int act, Plan plan, int groups, cudaStream_t s, int gs = 0, long long gst = 0,
                 int ldt = 0) {
  if (M < 1 || N < 1 || K < 1 || groups < 1 || N % 4 != 0 || gs < 0 || gs % 4 != 0 ||
      ((EPI == EPI_ACT_T || EPI == EPI_DACT_T) && (groups != 1 || ldt < M || ldt % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  if constexpr (LA == MN_MAJOR && LB == MN_MAJOR) {
    switch (plan.tile) {  // the MN path: its own tile only
      case 4:
        return run_sgemm_mn<Tile<128, 128, 3, 2>, LA, LB, EPI>(A, lda, sa, gs, gst, B, ldb, bias,
                                                                res, C, aux, M, N, K, act, groups,
                                                                plan, s, ldt);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (plan.tile) {
      case 0:
        return run_sgemm<Tile<128, 128, 3, 1>, LA, LB, EPI>(A, lda, sa, gs, gst, B, ldb, bias,
                                                             res, C, aux, M, N, K, act, groups,
                                                             plan, s, ldt);
      case 1:
        return run_sgemm<Tile<64, 128, 3, 2>, LA, LB, EPI>(A, lda, sa, gs, gst, B, ldb, bias,
                                                            res, C, aux, M, N, K, act, groups,
                                                            plan, s, ldt);
      case 2:
        return run_sgemm<Tile<128, 64, 3, 2>, LA, LB, EPI>(A, lda, sa, gs, gst, B, ldb, bias,
                                                            res, C, aux, M, N, K, act, groups,
                                                            plan, s, ldt);
      case 3:
        return run_sgemm<Tile<64, 64, 3, 4>, LA, LB, EPI>(A, lda, sa, gs, gst, B, ldb, bias, res,
                                                           C, aux, M, N, K, act, groups, plan, s,
                                                           ldt);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
}

}  // namespace
}  // namespace f32
}  // namespace cvlm
