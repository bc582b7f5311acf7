// qkv_packed_global: SAM's global attention, per head
//   o = softmax((q*scale) . k^T + rel_h[q, k / W] + rel_w[q, k % W]) . v,
// read straight from the packed qkv projection, written d-major.
//
// Replaces flash_qkv_packed_global of camouflaged_vlm_tpu/ops/flash_attention.py
// (_qkv_packed_global_kernel): the 4 global ViT-H blocks, qkv (B, 4096, 3840),
// rel (4096, B, 16, 128) position-major [rel_h | rel_w] (H = W = 64), out
// (B, 1280, 4096) for proj_rows, with the row stride the wrapper gives.
//
// What bounds it on the H100: the products, 4 B heads N^2 d = 171.8 GFLOP at
// ViT-H's shapes (B = 2), 0.1737 ms at 989 TFLOP/s; the inputs are 33 MB.
// The design is FlashAttention-3's, in one pass over the keys:
//   * one block per (128 queries, head, image), 288 threads: two consumer
//     warpgroups of 64 query rows each and one producer warp;
//   * the producer loads the block's q rows once, then keeps a ring of 3
//     stages of 64-key k and v tiles in flight, all by TMA straight from the
//     packed rows (row stride 3 heads d, column offset h d, (heads + h) d,
//     (2 heads + h) d), on "full"/"empty" mbarriers; TMA fills the rows past
//     N with zeros;
//   * each consumer warpgroup multiplies its q rows by bf16(scale) and
//     rounds them to bf16 in shared memory once (the JAX kernel's rounding
//     point), then per key tile: S = Q K^T by wgmma m64n64k16 into registers;
//     the bias added in registers; the online softmax in registers (running
//     max and sum per row, the 4 threads that share a row combine by
//     shuffles; exp2 of log2e-scaled scores); O rescaled by exp(m_old - m_new);
//     P rounded to bf16 in registers and fed to wgmma as its register A
//     operand for O += P V (m64 n=d k16), so S and P never touch shared
//     memory; the tile's buffers go back to the producer;
//   * epilogue: O / l, transposed through the warpgroup's own q buffer and
//     written d-major with 16-byte stores.
// The bias: with W equal to the 64-key tile (ViT-H's 64 x 64 grid) a tile is
// one row kh = tile of the grid, so each thread keeps rel_w of its 16 key
// columns for its 2 rows in registers for the whole pass and reads one rel_h
// value per row per tile; any other H, W (ragged N included) takes the
// general path, kh = k / W and kw = k % W per score from the staged rel
// rows, keys past N masked to -inf (at ViT-H's N, heads and d on a 32 x 128
// grid it takes 2.7x the register path's time on the H100: PERF.md). The
// bias is the fp32 sum of the two bf16 rel values, added to the fp32 score.
//
// The d = 80 layout: 160 bytes a row exceeds the 128-byte swizzle span, so
// every q, k and v tile is loaded by one 4-D tensor map (16-byte column
// chunks x rows x chunk index x image) that lays it out as wgmma's
// no-swizzle core matrices: chunk c of row r at (c * 64 + r) * 16 bytes. Q
// and K are then K-major operands (LBO = one chunk column, 1024 B; SBO = 8
// rows, 128 B), V the N-major B operand of P V (LBO = 8 keys, 128 B; SBO =
// one chunk column of d, 1024 B). The same map serves every d in {16, 32,
// 64, 80, 128}.
//
// Rounding: one pass moves one rounding point against the JAX kernel: P is
// rounded to bf16 unnormalised, exp(s - m_running), and O is divided by the
// fp32 row sum at the end, where JAX normalises in fp32 before rounding
// (flash_attention.py:986-998; on the TPU the same change measured 2.0e-5 ->
// 6.55e-4 mean relative against the XLA reference, far inside the port's
// 1e-2 gate).
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace cvlm {

constexpr int GA_BQ = 128, GA_KT = 64, GA_STAGES = 3, GA_THREADS = 288;
constexpr float GA_LOG2E = 1.4426950408889634f;

template <int DH>
__host__ __device__ constexpr size_t global_smem(int hw) {
  return 128 + sizeof(bf16) * ((size_t)GA_BQ * DH + 2 * GA_STAGES * GA_KT * DH +
                               (size_t)GA_BQ * hw) +
         sizeof(uint64_t) * (1 + 2 * GA_STAGES);
}

template <int DH, bool FAST>
__global__ void __launch_bounds__(GA_THREADS, 1) qkv_global_kernel(
    const __grid_constant__ CUtensorMap map, const bf16* __restrict__ rel,
    bf16* __restrict__ out, int N, int ldo, int H, int W, int heads, int B, float scale) {
  constexpr int TILE = GA_KT * DH;  // elements of one 64-row tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // 2 x [DH/8][64][8]: one per warpgroup
  bf16* sK = sQ + GA_BQ * DH;                // [stage][DH/8][64][8]
  bf16* sV = sK + GA_STAGES * TILE;
  bf16* sRel = sV + GA_STAGES * TILE;        // [128][hw]
  const int hw = H + W;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sRel + GA_BQ * hw);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + GA_STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = blockIdx.x * GA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (N + GA_KT - 1) / GA_KT;
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < GA_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: one thread issues every load
    if (tid == 256) {
      mbar_expect_tx(qbar, 2 * TILE * sizeof(bf16));
      tma_load_4d(sQ, &map, qbar, 0, q0, h * DH / 8, b);
      tma_load_4d(sQ + TILE, &map, qbar, 0, q0 + GA_KT, h * DH / 8, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % GA_STAGES;
        mbar_wait(&empty[s], ((t / GA_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * TILE * sizeof(bf16));
        tma_load_4d(sK + s * TILE, &map, &full[s], 0, t * GA_KT, (heads + h) * DH / 8, b);
        tma_load_4d(sV + s * TILE, &map, &full[s], 0, t * GA_KT, (2 * heads + h) * DH / 8, b);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  const int ltid = tid % 128, warp = ltid / 32, lane = tid % 32;
  const int qw = q0 + 64 * wg;  // this warpgroup's first query
  bf16* sQw = sQ + wg * TILE;
  bf16* sRelw = sRel + wg * 64 * hw;
  for (int e = ltid; e < 64 * hw; e += 128) {
    const int r = e / hw, j = e - r * hw, q = qw + r;
    sRelw[e] = q < N ? rel[((size_t)q * B + b) * heads * hw + h * hw + j] : __float2bfloat16(0.f);
  }
  mbar_wait(qbar, 0);
  {
    const float sc = __bfloat162float(__float2bfloat16(scale));  // the scale in bf16
    uint4* q4 = reinterpret_cast<uint4*>(sQw);
    for (int e = ltid; e < TILE / 8; e += 128) {
      uint4 v = q4[e];
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p2[i]);
        p2[i] = __floats2bfloat162_rn(f.x * sc, f.y * sc);
      }
      q4[e] = v;
    }
  }
  fence_async_shared();
  named_barrier(1 + wg, 128);

  // this thread's accumulator rows (within the warpgroup) and columns
  const int r_lo = warp * 16 + lane / 4, r_hi = r_lo + 8, c0 = 2 * (lane % 4);
  const bf16* rel_lo = sRelw + r_lo * hw;
  const bf16* rel_hi = sRelw + r_hi * hw;
  float relw[FAST ? 32 : 1];
  if constexpr (FAST) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        relw[j * 2 + e] = __bfloat162float(rel_lo[H + 8 * j + c0 + e]);
        relw[16 + j * 2 + e] = __bfloat162float(rel_hi[H + 8 * j + c0 + e]);
      }
  }

  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % GA_STAGES;
    mbar_wait(&full[s], (t / GA_STAGES) & 1);
    const bf16* kb = sK + s * TILE;
    const bf16* vb = sV + s * TILE;

    // S = Q K^T (64 x 64 per warpgroup), k over d in steps of 16
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      Wgmma<64>::ss(sc, wgmma_desc(sQw + ks * 2 * GA_KT * 8, GA_KT * 16, 128, LAYOUT_INTERLEAVE),
                    wgmma_desc(kb + ks * 2 * GA_KT * 8, GA_KT * 16, 128, LAYOUT_INTERLEAVE),
                    ks > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // + bias, in log2 units
    if constexpr (FAST) {
      const float rh_lo = __bfloat162float(rel_lo[t]), rh_hi = __bfloat162float(rel_hi[t]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = (sc[4 * j + e] + (rh_lo + relw[2 * j + e])) * GA_LOG2E;
          sc[4 * j + 2 + e] = (sc[4 * j + 2 + e] + (rh_hi + relw[16 + 2 * j + e])) * GA_LOG2E;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = t * GA_KT + 8 * j + c0 + e;
          if (k < N) {
            const int kh = k / W, kw = k - kh * W;
            sc[4 * j + e] = (sc[4 * j + e] + (__bfloat162float(rel_lo[kh]) +
                                              __bfloat162float(rel_lo[H + kw]))) * GA_LOG2E;
            sc[4 * j + 2 + e] = (sc[4 * j + 2 + e] + (__bfloat162float(rel_hi[kh]) +
                                                      __bfloat162float(rel_hi[H + kw]))) *
                                GA_LOG2E;
          } else {
            sc[4 * j + e] = -INFINITY;
            sc[4 * j + 2 + e] = -INFINITY;
          }
        }
    }

    // online softmax: row max over the quad, rescale, exponentiate
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o2));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = exp2f(m_lo - mn_lo), corr_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = exp2f(sc[4 * j] - mn_lo);
      sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn_lo);
      sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn_hi);
      sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn_hi);
      sum_lo += sc[4 * j] + sc[4 * j + 1];
      sum_hi += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= corr_lo;
      o[4 * j + 1] *= corr_lo;
      o[4 * j + 2] *= corr_hi;
      o[4 * j + 3] *= corr_hi;
    }

    // P (bf16, the m16n8k16 A fragment of each warp) . V
    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      pa[ks][0] = pack_bf16(sc[8 * ks], sc[8 * ks + 1]);
      pa[ks][1] = pack_bf16(sc[8 * ks + 2], sc[8 * ks + 3]);
      pa[ks][2] = pack_bf16(sc[8 * ks + 4], sc[8 * ks + 5]);
      pa[ks][3] = pack_bf16(sc[8 * ks + 6], sc[8 * ks + 7]);
    }
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Wgmma<DH>::rs(o, pa[ks], wgmma_desc(vb + ks * 16 * 8, 128, GA_KT * 16, LAYOUT_INTERLEAVE),
                    1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (ltid == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: O / l, transposed into this warpgroup's q buffer ([c][64]),
  // then d-major rows of 64 queries
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o2);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  named_barrier(1 + wg, 128);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + c0 + e;
      sQw[c * 64 + r_lo] = __float2bfloat16(o[4 * j + e] * inv_lo);
      sQw[c * 64 + r_hi] = __float2bfloat16(o[4 * j + 2 + e] * inv_hi);
    }
  named_barrier(1 + wg, 128);
  bf16* ob = out + ((size_t)b * heads + h) * DH * ldo;
  const bool vec = (ldo % 8) == 0;
  for (int e = ltid; e < DH * 8; e += 128) {
    const int c = e / 8, q = qw + 8 * (e % 8);
    if (q >= N) continue;
    const bf16* src = sQw + c * 64 + 8 * (e % 8);
    bf16* dst = ob + (size_t)c * ldo + q;
    if (vec && q + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && q + i < N; ++i) dst[i] = src[i];
    }
  }
}

template <int DH, bool FAST>
int launch_global_kernel(const CUtensorMap& map, const void* rel, void* out, int B, int N,
                         int ldo, int H, int W, int heads, float scale, cudaStream_t s) {
  // the rel rows of 128 queries sit in shared memory beside the q, k and v
  // tiles: H + W <= 587 at d = 80, 395 at d = 128
  const size_t smem = global_smem<DH>(H + W);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qkv_global_kernel<DH, FAST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + GA_BQ - 1) / GA_BQ, heads, B);
  qkv_global_kernel<DH, FAST><<<grid, GA_THREADS, smem, s>>>(
      map, static_cast<const bf16*>(rel), static_cast<bf16*>(out), N, ldo, H, W, heads, B,
      scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_global(const void* qkv, const void* rel, void* out, int B, int N, int ldo, int H,
                  int W, int heads, float scale, cudaStream_t s) {
  if (H * W != N || ldo < N) return (int)cudaErrorInvalidValue;
  // the packed rows as (8-element chunk, row, chunk index, image), box
  // (8, 64 rows, d / 8 chunks, 1): one head's q, k or v tile of 64 rows
  const cuuint64_t C3 = 3ull * heads * DH;
  const cuuint64_t dims[4] = {8, (cuuint64_t)N, C3 / 8, (cuuint64_t)B};
  const cuuint64_t strides[3] = {C3 * sizeof(bf16), 16, (cuuint64_t)N * C3 * sizeof(bf16)};
  const cuuint32_t box[4] = {8, GA_KT, DH / 8, 1};
  CUtensorMap map;
  const int err = encode_bf16_map(&map, qkv, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  if (W == GA_KT)
    return launch_global_kernel<DH, true>(map, rel, out, B, N, ldo, H, W, heads, scale, s);
  return launch_global_kernel<DH, false>(map, rel, out, B, N, ldo, H, W, heads, scale, s);
}

}  // namespace cvlm

// qkv (B, N, 3*heads*d), rel (N, B, heads, H+W), out (B, heads*d, N) with
// row stride ldo >= N: bf16;
// N == H * W, H + W within shared memory (587 at d = 80). d in {16, 32, 64,
// 80, 128}. Returns a cudaError_t code.
extern "C" int cvlm_qkv_packed_global(const void* qkv, const void* rel, void* out, int B,
                                      int N, int ldo, int H, int W, int heads, int d,
                                      float scale, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_global<16>(qkv, rel, out, B, N, ldo, H, W, heads, scale, s);
    case 32: return launch_global<32>(qkv, rel, out, B, N, ldo, H, W, heads, scale, s);
    case 64: return launch_global<64>(qkv, rel, out, B, N, ldo, H, W, heads, scale, s);
    case 80: return launch_global<80>(qkv, rel, out, B, N, ldo, H, W, heads, scale, s);
    case 128: return launch_global<128>(qkv, rel, out, B, N, ldo, H, W, heads, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
