// attn_sm90: the building blocks of the TMA + wgmma attention kernels on
// #17's design (qkv_packed_global.cu, SAM's global blocks), and the one-pass
// streaming kernel of CLIP's attention.
//
// Users: qkv_packed_plain.cu (#16, CLIP) is attn_stream_kernel;
// attn_fullk.cu (#20, SAM's 'aug_flash' global blocks) is its loop
// (stream_softmax_pv) over split q, k and v without a scale;
// qkv_packed_windows_s.cu is a whole-window kernel on the same blocks, for
// the compact carry's interior windows (#13) and its edge windows (#15) and
// the padded carry's windows (#12); qkv_relpos.cu (#11, #19, and #10 over
// split q, k and v) is the streaming loop with the rel-pos bias added in
// registers and a head-leading epilogue. #17 keeps its own copy of the streaming loop with
// its rel-pos bias: moved onto this header it measured 0.4-0.9% slower on
// the H100 in every parent-against-change run (PERF.md).
//
// The blocks:
//   * encode_packed_rows: one 4-D tensor map over the packed qkv projection
//     (B, N, 3 heads d) as (8-element chunk, row, chunk index, image), box
//     (8, rows, d / 8, 1). A TMA load of one head's q, k or v rows lands as
//     wgmma's no-swizzle core matrices, chunk c of row r at (c rows + r) * 16
//     bytes: d = 80 is 160 bytes a row, beyond the 128-byte swizzle span, and
//     this layout serves every d in {16, 32, 64, 80, 128}. Rows past N (of
//     each image) are filled with zeros. Such a tile is a K-major operand
//     (LBO = one chunk column, rows * 16 B; SBO = 8 rows, 128 B) of Q K^T and
//     the N-major B operand of P V (LBO = 8 keys, 128 B; SBO = one chunk
//     column).
//   * encode_split_rows: the same boxes over a split operand (BB, N, d), for
//     the kernels that take q, k and v apart (attn_fullk.cu, #20, and the
//     split front end of qkv_relpos.cu, #10).
//   * MbarRing: "full" / "empty" mbarriers between one producer thread that
//     issues TMA loads and the consumer warpgroups.
//   * scale_q_tile: q times bf16(scale), rounded to bf16, once in shared
//     memory (the JAX kernels' rounding point).
//   * quad_max / quad_sum: a row's statistic over a wgmma accumulator, whose
//     row lives on the 4 threads of a quad.
//   * store_o_dmajor: the epilogue, O rounded to bf16, transposed through
//     shared memory and written d-major ((.., heads d, N) with a row stride
//     ldo, what proj_rows reads: the wrappers round it up to a multiple of
//     8 elements for proj_rows' TMA loads), 16 bytes a store where the rows
//     allow (below).
//
// attn_stream_kernel<DH, NWG, STAGES>: FlashAttention-3's one pass over the
// keys without a bias, one block per (NWG x 64 queries, head, image):
//   * NWG consumer warpgroups of 64 query rows and one producer warp;
//   * the producer loads the block's q rows once, then keeps a ring of
//     STAGES 64-key k and v tiles in flight, all by TMA straight from the
//     packed rows (row stride 3 heads d, column offset h d, (heads + h) d,
//     (2 heads + h) d);
//   * each consumer warpgroup scales its q rows (scale_q_tile), then per key
//     tile: S = Q K^T by wgmma m64n64k16 into registers; then
//     stream_softmax_pv: the keys past N of a ragged last tile masked to
//     -inf; the online softmax in registers
//     (running max and sum per row, exp2 of log2e-scaled scores); O rescaled
//     by exp(m_old - m_new); P rounded to bf16 in registers and fed to wgmma
//     as its register A operand for O += P V (m64 n=d k16), so S and P never
//     touch shared memory; the tile's buffers go back to the producer;
//   * epilogue: O / l through store_o_dmajor, in the warpgroup's q buffer,
//     which has 8 spare rows for rows shifted to their destination's
//     alignment.
// Rounding: the one pass moves one rounding point against the JAX `ref`: P
// is rounded to bf16 unnormalised, exp(s - m_running), and O is divided by
// the fp32 row sum at the end, where the plain version normalises before
// the rounding (on the TPU the same change measured 2.0e-5 -> 6.55e-4 mean
// relative against the XLA reference, far inside the port's 1e-2 gate).
#pragma once

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace cvlm {

constexpr float LOG2E = 1.4426950408889634f;

// The packed rows (B, N, 3 heads DH) as TMA boxes of `rows` rows of one head.
// Returns a cudaError_t code.
template <int DH>
inline int encode_packed_rows(CUtensorMap* map, const void* qkv, int B, int N, int heads,
                              int rows) {
  const cuuint64_t C3 = 3ull * heads * DH;
  const cuuint64_t dims[4] = {8, (cuuint64_t)N, C3 / 8, (cuuint64_t)B};
  const cuuint64_t strides[3] = {C3 * sizeof(bf16), 16, (cuuint64_t)N * C3 * sizeof(bf16)};
  const cuuint32_t box[4] = {8, (cuuint32_t)rows, DH / 8, 1};
  return encode_bf16_map(map, qkv, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// A ring of STAGES slots: the producer's load t goes into slot t % STAGES
// once the `consumers` arrivals of the slot's previous use have come.
template <int STAGES>
struct MbarRing {
  uint64_t* full;
  uint64_t* empty;

  __device__ void init(int consumers) const {  // one thread, before the block's first barrier
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
  }
  // producer: wait until the slot of load t is free, then announce `bytes`
  // of TMA into it; returns the slot
  __device__ int acquire(int t, uint32_t bytes) const {
    const int s = t % STAGES;
    mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[s], bytes);
    return s;
  }
  // consumer: wait until load t has landed; returns the slot
  __device__ int wait(int t) const {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    return s;
  }
  __device__ void release(int s) const { mbar_arrive(&empty[s]); }
};

// q, the first DH / 8 chunks of a [chunk][64][8] tile, times bf16(scale) and
// rounded to bf16 in place, by the 128 threads of a warpgroup (ltid 0..127).
template <int DH>
__device__ __forceinline__ void scale_q_tile(bf16* tile, float scale, int ltid) {
  const float sc = __bfloat162float(__float2bfloat16(scale));  // the scale in bf16
  uint4* q4 = reinterpret_cast<uint4*>(tile);
  for (int e = ltid; e < 64 * DH / 8; e += 128) {
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One warpgroup's O (64 x DH in the wgmma accumulator fragment: o[4j + e] is
// row r_lo, o[4j + 2 + e] row r_hi, column 8j + c0 + e) times the row factors
// f_lo / f_hi, rounded to bf16, transposed into buf ([DH][LDB] bf16) and
// written to ob[c * ldo + q0 + r] for the rows q0 + r < N. `bar` is the
// warpgroup's named barrier; the first one waits out every read of buf.
// LDB = 64: rows as they are, 16-byte stores when ldo % 8 == 0, 8-byte ones
// when ldo % 4 == 0, else element by element.
// LDB = 72, for rows that start anywhere: each row is shifted in buf by its
// destination's misalignment, so that every 16-byte-aligned chunk of the
// destination row is one aligned 16-byte read of buf; the ragged ends go
// element by element.
template <int DH, int LDB>
__device__ __forceinline__ void store_o_dmajor(const float (&o)[DH / 2], float f_lo, float f_hi,
                                               bf16* buf, bf16* ob, int N, int ldo, int q0,
                                               int ltid, int bar) {
  static_assert(LDB == 64 || LDB == 72, "buf rows: 64, or 72 with room to shift");
  const int lane = ltid % 32;
  const int r_lo = (ltid / 32) * 16 + lane / 4, r_hi = r_lo + 8, c0 = 2 * (lane % 4);
  // the misalignment (elements past a 16-byte boundary) of row c's first output
  auto shift = [&](int c) {
    return LDB == 64 ? 0
                     : (int)((reinterpret_cast<uintptr_t>(ob + (size_t)c * ldo + q0) / 2) & 7);
  };
  named_barrier(bar, 128);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + c0 + e, sh = shift(c);
      buf[c * LDB + sh + r_lo] = __float2bfloat16(o[4 * j + e] * f_lo);
      buf[c * LDB + sh + r_hi] = __float2bfloat16(o[4 * j + 2 + e] * f_hi);
    }
  named_barrier(bar, 128);
  if constexpr (LDB == 64) {
    const bool vec8 = (ldo % 8) == 0, vec4 = (ldo % 4) == 0;
    for (int e = ltid; e < DH * 8; e += 128) {
      const int c = e / 8, q = q0 + 8 * (e % 8);
      if (q >= N) continue;
      const bf16* src = buf + c * 64 + 8 * (e % 8);
      bf16* dst = ob + (size_t)c * ldo + q;
      if (vec8 && q + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else if (vec4 && q + 8 <= N) {
        reinterpret_cast<uint2*>(dst)[0] = reinterpret_cast<const uint2*>(src)[0];
        reinterpret_cast<uint2*>(dst)[1] = reinterpret_cast<const uint2*>(src)[1];
      } else {
        for (int i = 0; i < 8 && q + i < N; ++i) dst[i] = src[i];
      }
    }
  } else {
    const int nq = min(64, N - q0);  // this tile's queries
    for (int e = ltid; e < DH * 9; e += 128) {
      const int c = e / 9, k = e - c * 9, sh = shift(c);
      // buf chunk k holds the row's queries [8k - sh, 8k + 8 - sh)
      const int lo = max(8 * k - sh, 0), hi = min(8 * k + 8 - sh, nq);
      bf16* row = ob + (size_t)c * ldo + q0;
      const bf16* src = buf + c * 72 + sh;
      if (hi - lo == 8) {
        *reinterpret_cast<uint4*>(row + lo) = *reinterpret_cast<const uint4*>(src + lo);
      } else {
        for (int r = lo; r < hi; ++r) row[r] = src[r];
      }
    }
  }
}

// ------------------------------------------------- the streaming kernel

constexpr int ST_KT = 64, ST_QROWS = 72;  // key tile; rows of a q buffer (8 spare)

// A split operand (BB, N, d), d % 8 == 0, as TMA boxes of 64 rows of wgmma's
// no-swizzle core matrices: (8-element chunk, row, chunk index, problem), box
// (8, 64, dc, 1); chunks at or past d / 8 (a depth padded to 8 dc) and rows
// past N are zeros. Returns a cudaError_t code.
inline int encode_split_rows(CUtensorMap* map, const void* base, int BB, int N, int d, int dc) {
  const cuuint64_t dims[4] = {8, (cuuint64_t)N, (cuuint64_t)d / 8, (cuuint64_t)BB};
  const cuuint64_t strides[3] = {(cuuint64_t)d * sizeof(bf16), 16,
                                 (cuuint64_t)N * d * sizeof(bf16)};
  const cuuint32_t box[4] = {8, ST_KT, (cuuint32_t)dc, 1};
  return encode_bf16_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// One key tile of the one-pass loop, after S = Q K^T (sc: a warpgroup's 64 x
// 64 accumulator, fp32): in log2 units, the keys at or past kv (a ragged last
// tile's) at -inf; the online softmax (row max m and sum l over the quad,
// rescaled by exp2(m_old - m_new)), O rescaled; P rounded to bf16 in
// registers (the m16n8k16 A fragment of each warp) and O += P V by wgmma,
// V the tile's [DV/8][64][8] no-swizzle core matrices (an N-major B).
template <int DV>
__device__ __forceinline__ void stream_softmax_pv(float (&sc)[32], float (&o)[DV / 2],
                                                  float& m_lo, float& m_hi, float& l_lo,
                                                  float& l_hi, int kv, int c0, const bf16* vb) {
  if (kv >= ST_KT) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= LOG2E;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = 8 * j + c0 + e < kv;
        sc[4 * j + e] = in ? sc[4 * j + e] * LOG2E : -INFINITY;
        sc[4 * j + 2 + e] = in ? sc[4 * j + 2 + e] * LOG2E : -INFINITY;
      }
  }

  // online softmax: row max over the quad, rescale, exponentiate
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  const float mn_lo = fmaxf(m_lo, quad_max(mx_lo)), mn_hi = fmaxf(m_hi, quad_max(mx_hi));
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
  for (int j = 0; j < DV / 8; ++j) {
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
    Wgmma<DV>::rs(o, pa[ks], wgmma_desc(vb + ks * 16 * 8, 128, ST_KT * 16, LAYOUT_INTERLEAVE),
                  1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

template <int DH, int NWG, int STAGES>
__host__ __device__ constexpr size_t stream_smem() {
  return 128 + sizeof(bf16) * ((size_t)NWG * ST_QROWS * DH + 2 * STAGES * ST_KT * DH) +
         sizeof(uint64_t) * (1 + 2 * STAGES);
}

// qkv through `map` (encode_packed_rows, 64 rows); out (B, heads DH, N)
// with row stride ldo. Grid (ceil(N / (64 NWG)), heads, B), NWG * 128 + 32
// threads.
template <int DH, int NWG, int STAGES>
__global__ void __launch_bounds__(NWG * 128 + 32, 1) attn_stream_kernel(
    const __grid_constant__ CUtensorMap map, bf16* __restrict__ out, int N, int ldo, int heads,
    float scale) {
  constexpr int TILE = ST_KT * DH;     // elements of one 64-row tile
  constexpr int QB = ST_QROWS * DH;    // elements of a warpgroup's q buffer
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // NWG x [DH/8][64][8] (+ 8 spare rows)
  bf16* sK = sQ + NWG * QB;                  // [stage][DH/8][64][8]
  bf16* sV = sK + STAGES * TILE;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + STAGES * TILE);
  const MbarRing<STAGES> ring{qbar + 1, qbar + 1 + STAGES};

  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = blockIdx.x * (NWG * 64), h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (N + ST_KT - 1) / ST_KT;
  if (tid == 0) {
    mbar_init(qbar, 1);
    ring.init(NWG);  // one arrival per consumer warpgroup
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {  // the producer warp: one thread issues every load
    if (tid == NWG * 128) {
      mbar_expect_tx(qbar, NWG * TILE * sizeof(bf16));
      for (int w = 0; w < NWG; ++w)
        tma_load_4d(sQ + w * QB, &map, qbar, 0, q0 + 64 * w, h * DH / 8, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = ring.acquire(t, 2 * TILE * sizeof(bf16));
        tma_load_4d(sK + s * TILE, &map, &ring.full[s], 0, t * ST_KT, (heads + h) * DH / 8, b);
        tma_load_4d(sV + s * TILE, &map, &ring.full[s], 0, t * ST_KT, (2 * heads + h) * DH / 8,
                    b);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  const int ltid = tid % 128, lane = tid % 32;
  bf16* sQw = sQ + wg * QB;
  mbar_wait(qbar, 0);
  scale_q_tile<DH>(sQw, scale, ltid);
  fence_async_shared();
  named_barrier(1 + wg, 128);

  const int c0 = 2 * (lane % 4);  // this thread's first accumulator column
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = ring.wait(t);
    const bf16* kb = sK + s * TILE;
    const bf16* vb = sV + s * TILE;

    // S = Q K^T (64 x 64 per warpgroup), k over d in steps of 16
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      Wgmma<64>::ss(sc, wgmma_desc(sQw + ks * 2 * ST_KT * 8, ST_KT * 16, 128, LAYOUT_INTERLEAVE),
                    wgmma_desc(kb + ks * 2 * ST_KT * 8, ST_KT * 16, 128, LAYOUT_INTERLEAVE),
                    ks > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    stream_softmax_pv<DH>(sc, o, m_lo, m_hi, l_lo, l_hi, N - t * ST_KT, c0, vb);
    if (ltid == 0) ring.release(s);
  }

  // epilogue: O / l, transposed in this warpgroup's q buffer
  store_o_dmajor<DH, ST_QROWS>(o, 1.f / quad_sum(l_lo), 1.f / quad_sum(l_hi), sQw,
                               out + ((size_t)b * heads + h) * DH * ldo, N, ldo, q0 + 64 * wg,
                               ltid, 1 + wg);
}

// Launches attn_stream_kernel; returns a cudaError_t code.
template <int DH, int NWG, int STAGES>
int launch_stream(const void* qkv, void* out, int B, int N, int ldo, int heads, float scale,
                  cudaStream_t s) {
  constexpr size_t smem = stream_smem<DH, NWG, STAGES>();
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  CUtensorMap map;
  const int err = encode_packed_rows<DH>(&map, qkv, B, N, heads, ST_KT);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(attn_stream_kernel<DH, NWG, STAGES>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + NWG * 64 - 1) / (NWG * 64), heads, B);
  attn_stream_kernel<DH, NWG, STAGES><<<grid, NWG * 128 + 32, smem, s>>>(
      map, static_cast<bf16*>(out), N, ldo, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace cvlm
