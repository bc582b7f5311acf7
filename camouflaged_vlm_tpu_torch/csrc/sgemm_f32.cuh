// The float32 building blocks of the fp32 kernel instances
// (linear_f32.cu, ln_mlp_residual_f32.cu, ln_linear_f32.cu, proj_rows_f32.cu,
// ln_mlp_residual_bwd_f32.cu): the LayerNorm row pass, its backward, and the
// tiled FFMA product with its epilogues. All on the CUDA cores: the H100's
// tensor cores have no float32 mode (TF32 keeps ~3 digits), so these
// compute in full fp32 and are bounded by the 67 TFLOP/s FFMA rate.
//
// The GEMM is the classic tiled product C (M, N) = epilogue(A . B): 256
// threads a block, each an (4 HM) x (4 HN) block of outputs in registers
// (groups of 4 x 4, 64 rows / columns apart), so a block tile is (64 HM) x
// (64 HN); 16-deep k tiles staged in shared memory as [k][row] (double
// buffered: the next tile's global loads wait in registers during the
// current tile's products). Each operand is read in one of two layouts:
//   K_MAJOR   P[r * ld + k]: rows contiguous along k (activation rows, the
//             nn.Linear weight (N, K)); staged transposed;
//   MN_MAJOR  P[k * ld + r]: contiguous along the output's rows or columns
//             (the d-major attention output (K, S), W2 (K, H) and W1 (H, K)
//             as the backward reads them); staged as it lies.
// Both load 16 bytes a thread: K_MAJOR needs K % 4 == 0, MN_MAJOR ld % 4 ==
// 0, and a 16-byte aligned base; the wrappers check. Ragged M, N and K are
// masked (an MN_MAJOR row tile may read up to 3 elements past the last row,
// inside the padded row the wrappers hand in; no output depends on them).
// blockIdx.z walks groups of rows (proj_rows' (B, T) groups): A moves by
// `sa` elements a group, C and the residual by M * N. Everything here has
// internal linkage: each source that includes it keeps its own copy.
#pragma once

#include "common.cuh"

namespace cvlm {
namespace f32 {
namespace {

constexpr int THREADS = 256;
constexpr int BK = 16;
constexpr int PAD = 4;  // keeps the transposed stores at 2-way bank conflicts, rows 16-byte aligned

enum Layout { K_MAJOR = 0, MN_MAJOR = 1, K_HEADS = 2 };
// EPI_ACT: act(acc + bias), bias optional; EPI_RES: acc + bias + res;
// EPI_DACT (the MLP backward's dh): pre = acc + bias, C = act'(pre) * res
// (res may be C itself: each element is read, then written, by one
// thread), and act(pre) into `aux` when given
enum Epi { EPI_ACT = 0, EPI_RES = 1, EPI_DACT = 2 };

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

// The LN backward of each row, one warp a row: dx = rstd * (dxhat -
// mean(dxhat) - xhat * mean(dxhat * xhat)) + g, dxhat = dxn * gamma, xhat =
// (x - mu) * rstd from the forward's statistics; g is the residual's
// gradient.
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
  const float4* gr = reinterpret_cast<const float4*>(g + o);
  float4* out = reinterpret_cast<float4*>(dx + o);
  for (int c = lane; c < nv; c += 32) {
    const float4 v = xr[c], d = dr[c], ga = g4[c], gu = gr[c];
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

// One operand's share of a (64 H) x BK tile: H float4s a thread, read from
// device memory into registers (zeros outside the R x K operand), then
// stored into the [k][r] tile in shared memory.
template <int H, int LAYOUT>
struct TileLoader {
  float4 v[H];

  __device__ __forceinline__ void load(const float* __restrict__ P, int ld, int r0, int R,
                                       int k0, int K) {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      int r, k;
      if (LAYOUT != MN_MAJOR) {  // 4 float4s along k a row
        r = idx / 4;
        k = k0 + (idx % 4) * 4;
      } else {  // 16 H float4s along r a k row
        k = k0 + idx / (16 * H);
        r = (idx % (16 * H)) * 4;
      }
      const bool in = r0 + r < R && k < K;
      const size_t off = LAYOUT == K_MAJOR    ? (size_t)(r0 + r) * ld + k
                         : LAYOUT == MN_MAJOR ? (size_t)k * ld + r0 + r
                                              : (size_t)(k / ld) * R * ld + (size_t)(r0 + r) * ld +
                                                    k % ld;
      v[i] = in ? *reinterpret_cast<const float4*>(P + off) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void store(float (*T)[64 * H + PAD]) const {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (LAYOUT != MN_MAJOR) {
        const int r = idx / 4, k = (idx % 4) * 4;
        T[k][r] = v[i].x;
        T[k + 1][r] = v[i].y;
        T[k + 2][r] = v[i].z;
        T[k + 3][r] = v[i].w;
      } else {
        const int k = idx / (16 * H), r = (idx % (16 * H)) * 4;
        *reinterpret_cast<float4*>(&T[k][r]) = v[i];
      }
    }
  }
};

// C (M, N) = epilogue(A . B) for A (M, K) and B (N, K) in the layouts LA,
// LB (leading dimensions lda, ldb); C, res and aux (M, N) with row stride
// N. N % 4 == 0 (16-byte epilogue rows).
template <int HM, int HN, int LA, int LB, int EPI>
__global__ void __launch_bounds__(THREADS) sgemm_kernel(
    const float* __restrict__ A, int lda, long long sa, const float* __restrict__ B, int ldb,
    const float* __restrict__ bias, const float* res, float* C, float* __restrict__ aux, int M,
    int N, int K, int act) {
  constexpr int BM = 64 * HM, BN = 64 * HN;
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  A += (size_t)blockIdx.z * sa;
  const size_t co = (size_t)blockIdx.z * M * N;

  TileLoader<HM, LA> la;
  TileLoader<HN, LB> lb;
  float acc[4 * HM][4 * HN];
#pragma unroll
  for (int i = 0; i < 4 * HM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * HN; ++j) acc[i][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
  la.load(A, lda, m0, M, 0, K);
  lb.load(B, ldb, n0, N, 0, K);
  la.store(As[0]);
  lb.store(Bs[0]);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      la.load(A, lda, m0, M, (kt + 1) * BK, K);
      lb.load(B, ldb, n0, N, (kt + 1) * BK, K);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4 * HM], b[4 * HN];
#pragma unroll
      for (int h = 0; h < HM; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(&As[cur][k][64 * h + 4 * ty]);
        a[4 * h] = v.x;
        a[4 * h + 1] = v.y;
        a[4 * h + 2] = v.z;
        a[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < HN; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[cur][k][64 * h + 4 * tx]);
        b[4 * h] = v.x;
        b[4 * h + 1] = v.y;
        b[4 * h + 2] = v.z;
        b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * HM; ++i)
#pragma unroll
        for (int j = 0; j < 4 * HN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous iteration's barrier
    if (kt + 1 < nk) {
      la.store(As[cur ^ 1]);
      lb.store(Bs[cur ^ 1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4 * HM; ++i) {
    const int m = m0 + 64 * (i / 4) + 4 * ty + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < HN; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      if (n >= N) continue;
      float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      if (bias != nullptr) {
        const float4 bv = *reinterpret_cast<const float4*>(bias + n);
        v[0] += bv.x;
        v[1] += bv.y;
        v[2] += bv.z;
        v[3] += bv.w;
      }
      const size_t o = co + (size_t)m * N + n;
      if (EPI == EPI_RES || EPI == EPI_DACT) {
        const float4 r = *reinterpret_cast<const float4*>(res + o);
        const float rv[4] = {r.x, r.y, r.z, r.w};
        if (EPI == EPI_DACT && aux != nullptr)
          *reinterpret_cast<float4*>(aux + o) =
              make_float4(apply_act(v[0], act), apply_act(v[1], act), apply_act(v[2], act),
                          apply_act(v[3], act));
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[c] = EPI == EPI_RES ? v[c] + rv[c] : act_grad(v[c], act) * rv[c];
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = apply_act(v[c], act);
      }
      *reinterpret_cast<float4*>(C + o) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Queues one product; `tile` is the block tile's width, 128 (128 x 128) or
// 64 (64 x 64); `groups` the row groups (blockIdx.z). Returns a cudaError_t
// code.
template <int LA, int LB, int EPI>
int launch_sgemm(const float* A, int lda, long long sa, const float* B, int ldb,
                 const float* bias, const float* res, float* C, float* aux, int M, int N, int K,
                 int act, int tile, int groups, cudaStream_t s) {
  if (M < 1 || N < 1 || K < 1 || groups < 1 || N % 4 != 0) return (int)cudaErrorInvalidValue;
  const dim3 block(THREADS);
  if (tile == 128) {
    const dim3 grid((N + 127) / 128, (M + 127) / 128, groups);
    sgemm_kernel<2, 2, LA, LB, EPI><<<grid, block, 0, s>>>(A, lda, sa, B, ldb, bias, res, C, aux,
                                                           M, N, K, act);
  } else if (tile == 64) {
    const dim3 grid((N + 63) / 64, (M + 63) / 64, groups);
    sgemm_kernel<1, 1, LA, LB, EPI><<<grid, block, 0, s>>>(A, lda, sa, B, ldb, bias, res, C, aux,
                                                           M, N, K, act);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace f32
}  // namespace cvlm
