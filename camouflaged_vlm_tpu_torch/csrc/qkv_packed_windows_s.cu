// qkv_packed_windows_s: SAM's windowed attention per (window, head), read
// straight from the packed qkv projection and written d-major, for the
// compact carry's interior and edge windows and the padded carry's windows:
//   interior  o = softmax((q*scale) . k^T + rel[q, k / win]
//                          + rel[q, win + k % win]) . v
//   edge      the same with each key's two rel lanes from its window's
//             column of `sel`, the dummy keys' -1e30 of `kmask`, and a
//             virtual pad key of logit rel[q, 28] and value vb.
//
// Replaces three TPU kernels of camouflaged_vlm_tpu/ops/flash_attention.py:
//   flash_qkv_packed_windows_s (_qkv_packed_windows_s_kernel, #13): the 28
//     windowed ViT-H blocks of the reference configuration (window 14), in
//     inference and in the train forward. qkv (BW, win^2, 3 heads d) with
//     BW = B * 16 windows, rel_s (win^2, BW, heads * 32) position-major with
//     lanes [rel_h(win) | rel_w(win) | 0], out (BW, heads d, win^2); at
//     ViT-H (32, 196, 3840), (196, 32, 512), (32, 1280, 196).
//   flash_qkv_packed_windows (_qkv_packed_windows_kernel, #12): the same
//     function on the padded window carry (windows of 15 or 16, which the
//     compact layout cannot take) and on the global blocks of at most 256
//     tokens, with rel window-major (BW, win^2, heads * 32); pad tokens are
//     ordinary keys (their q, k and v are the qkv bias), as in the JAX
//     kernel. At ViT-H with window 16: qkv (2, 16, 256, 3840), rel (2, 16,
//     256, 512), out (2, 16, 1280, 256). The interior instance serves it:
//     the rel layout is only the strides of its tensor map.
//   flash_qkv_packed_edge (_qkv_packed_edge_kernel, #15): the same blocks'
//     9 edge windows of R = 112 uniform rows an image (4 right of 14 x 8
//     tokens, 4 bottom of 8 x 14, the corner of 8 x 8 with 48 dummy rows and
//     columns): qkv (B, 9, 112, 3840), rel (B, 9, 112, 16 * 32) window-major
//     with the pad key's logit in lane 28, sel (9, 32, 112), kmask (9, 1,
//     112) fp32, vb (16, 80), out (B, 9, 1280, 112).
// All outputs go to proj_rows with the row stride the wrapper gives.
//
// What bounds it on the H100: the bytes, 70 MB at #13's shapes and B = 2
// (qkv 48 MB, rel 6.4, out 16), 0.0211 ms at 3.35 TB/s, 92 MB at #12's
// (0.0275 ms) and 23 MB at #15's (0.0068 ms); the products are 6.3, 10.7
// and 1.8 GFLOP. The design, on attn_sm90.cuh's blocks:
//   * one block per (window, head), 160 threads: one consumer warpgroup and
//     one producer warp. At win 14 and d = 80 a block takes 108.6 KB of
//     shared memory, so two are resident per SM and one's loads overlap the
//     other's products (512 blocks at B = 2: 1.9 waves of 264); an edge
//     block at R = 112 takes 72 KB, three per SM (288 blocks, one wave). At
//     NP = 256 and d = 80 (#12's windows of 15 and 16) two q stages would
//     take 124.2 KB, one block an SM; one stage takes 110.1 KB and lets two
//     share an SM (ws_qstages), at most 204 registers a thread.
//   * The window's k and v are loaded once, by TMA, as NP rows: the keys
//     padded to the wgmma width (64, 208 or 256; 208 at win 14, 256 at 15
//     and 16; the edges also 112, their R at ViT-H, so no key is padding).
//     All of the window's query tiles run against them. The 64-query tiles
//     of q and their rel rows come through a ring of QST stages, with two
//     the next in flight while the current one computes.
//   * The bias by the tensor cores, the port's 'aug' identity
//     (ops/aug_attention.py): q' = [bf16(q * scale) | the query's 32 rel
//     lanes] and k' = [k | the key's 32-lane code], so S = q' k'^T is the
//     biased score in one chain of m64nNPk16 products of depth d + 32 (112
//     at d = 80). The interior code is two-hot, ones at lanes k / win and
//     win + k % win, built from win; an edge key's code is its column of
//     the window's own 0/1 `sel`, copied in. Both are built once per block
//     in shared memory beside k's chunks. Products with 0 or 1 are exact, so
//     S differs from (q k^T) + rel @ sel only in fp32 summation order. sel's
//     lane 28 is zero, so the pad-key logit in q's lane 28 adds to no score.
//   * A whole score row in registers (NP / 2 fp32 a thread): the keys past
//     the window's masked to -inf (and an edge's dummy keys given kmask's
//     -1e30, from a per-block table in shared memory), then the exact
//     max-subtracted softmax of the JAX `ref` (flash_attention.py:546-553,
//     :781-807), normalised in fp32 before the bf16 rounding: the plain
//     version's rounding points, none moved. An edge row's max and sum also
//     take the pad key, exp(lp - m). P is wgmma's register A operand for O =
//     P V (NP / 16 k16 steps); an edge row adds (pp / l) * vb in fp32.
//   * The epilogue writes d-major rows, 16-byte stores on the wrapper's row
//     stride (200 at win 14, 232 at 15, 256 at 16).
// Registers: at most NP / 2 scores, then NP / 4 packed probabilities beside
// d / 2 accumulators; one warpgroup a block leaves 255 a thread within
// reach, so win 16 at d = 128 (128 scores, then 64 + 64) needs no split of
// the keys.
#include "attn_sm90.cuh"

namespace cvlm {

constexpr int WS_THREADS = 160, WS_LANES = 32, LPAD_LANE = 28;
constexpr size_t SM_SMEM = 228 * 1024;  // shared memory of one SM; 1 KB of it per block reserved

// an edge window's key code, key mask and pad-key value (see the top)
struct EdgeArgs {
  const bf16* sel;     // (n, 32, R) 0/1
  const bf16* vb;      // (heads, d): the v slice of the qkv bias
  const float* kmask;  // (n, R): 0 real key, -1e30 dummy
  int n;               // edge windows per image
};

// shared memory: QST q' tiles [(d + 32) / 8][64][8], k' [(d + 32) / 8][NP][8],
// v [d / 8][NP][8], the barriers; an edge block also its keys' masks (NP fp32)
template <int DH, int NP, bool EDGE, int QST>
__host__ __device__ constexpr size_t windows_s_smem() {
  return 128 +
         sizeof(bf16) * ((size_t)QST * 64 * (DH + WS_LANES) + (size_t)NP * (DH + WS_LANES) +
                         (size_t)NP * DH) +
         sizeof(uint64_t) * (1 + 2 * QST) + (EDGE ? sizeof(float) * NP : 0);
}

// q' stages: 2, or for the interior windows 1 where that alone lets two
// blocks share an SM
template <int DH, int NP, bool EDGE>
constexpr int ws_qstages() {
  return !EDGE && 2 * (windows_s_smem<DH, NP, EDGE, 2>() + 1024) > SM_SMEM &&
                 2 * (windows_s_smem<DH, NP, EDGE, 1>() + 1024) <= SM_SMEM
             ? 1
             : 2;
}

// qmap / kvmap: the packed rows in boxes of 64 / NP rows (encode_packed_rows);
// relmap: rel in boxes of 64 queries x the head's 32 lanes; Nw keys (and
// queries) a window, win the interior windows' side; out rows of stride ldo.
// Grid (heads, BW). With one q' stage two blocks share an SM: at most 204
// registers a thread.
template <int DH, int NP, bool EDGE, int QST>
__global__ void __launch_bounds__(WS_THREADS, QST == 1 ? 2 : 1) qkv_windows_s_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kvmap,
    const __grid_constant__ CUtensorMap relmap, bf16* __restrict__ out, int Nw, int ldo,
    int win, int heads, float scale, EdgeArgs edge) {
  constexpr int DA = DH + WS_LANES;  // the augmented depth
  constexpr int QT = 64 * DA;        // elements of one q' tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [stage][DA/8][64][8]: q chunks, then rel
  bf16* sK = sQ + QST * QT;                  // [DA/8][NP][8]: k chunks, then the lane code
  bf16* sV = sK + NP * DA;                   // [DH/8][NP][8]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sV + NP * DH);
  const MbarRing<QST> ring{kvbar + 1, kvbar + 1 + QST};
  float* kadd = reinterpret_cast<float*>(kvbar + 1 + 2 * QST);  // edge: [NP]

  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int n_q = (Nw + 63) / 64;
  if (tid == 0) {
    mbar_init(kvbar, 1);
    ring.init(1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp: one thread issues every load
    if (tid == 128) {
      mbar_expect_tx(kvbar, 2 * NP * DH * sizeof(bf16));
      tma_load_4d(sK, &kvmap, kvbar, 0, 0, (heads + h) * DH / 8, b);
      tma_load_4d(sV, &kvmap, kvbar, 0, 0, (2 * heads + h) * DH / 8, b);
      for (int i = 0; i < n_q; ++i) {
        const int s = ring.acquire(i, QT * sizeof(bf16));
        tma_load_4d(sQ + s * QT, &qmap, &ring.full[s], 0, 64 * i, h * DH / 8, b);
        tma_load_4d(sQ + s * QT + 64 * DH, &relmap, &ring.full[s], 0, 64 * i,
                    h * WS_LANES / 8, b);
      }
    }
    return;
  }

  // ------------------------------------------------ the consumer warpgroup
  bf16* code = sK + NP * DH;
  if constexpr (EDGE) {
    // k's lane code: the window's column k of sel; the keys' masks
    const int wi = b % edge.n;
    const uint16_t* sel = reinterpret_cast<const uint16_t*>(edge.sel) + (size_t)wi * WS_LANES * Nw;
    for (int e = tid; e < (WS_LANES / 8) * NP; e += 128) {
      const int c = e / NP, k = e - c * NP;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (k < Nw) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = (uint32_t)sel[(size_t)(8 * c + 2 * i) * Nw + k] |
                 ((uint32_t)sel[(size_t)(8 * c + 2 * i + 1) * Nw + k] << 16);
      }
      reinterpret_cast<uint4*>(code)[e] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    for (int k = tid; k < NP; k += 128)
      kadd[k] = k < Nw ? edge.kmask[(size_t)wi * Nw + k] : -INFINITY;
  } else {
    // k's lane code: ones at lanes k / win and win + k % win, none past win^2
    for (int e = tid; e < (WS_LANES / 8) * NP; e += 128) {
      const int c = e / NP, k = e - c * NP;
      const int lo = k / win - 8 * c, hi = win + k % win - 8 * c;  // lanes within the chunk
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = pack_bf16(k < Nw && (2 * i == lo || 2 * i == hi) ? 1.f : 0.f,
                         k < Nw && (2 * i + 1 == lo || 2 * i + 1 == hi) ? 1.f : 0.f);
      reinterpret_cast<uint4*>(code)[e] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  fence_async_shared();
  named_barrier(1, 128);
  mbar_wait(kvbar, 0);

  const int lane = tid % 32, c0 = 2 * (lane % 4);
  const int r_lo = (tid / 32) * 16 + lane / 4, r_hi = r_lo + 8;  // this thread's rows
  bf16* ob = out + ((size_t)b * heads + h) * DH * ldo;
  for (int i = 0; i < n_q; ++i) {
    const int s = ring.wait(i);
    bf16* qt = sQ + s * QT;
    float lp_lo = 0.f, lp_hi = 0.f;  // edge: the rows' pad-key logits, rel lane 28
    if constexpr (EDGE) {
      const bf16* rl = qt + (DH + LPAD_LANE / 8 * 8) * 64 + LPAD_LANE % 8;
      lp_lo = __bfloat162float(rl[r_lo * 8]);
      lp_hi = __bfloat162float(rl[r_hi * 8]);
    }
    scale_q_tile<DH>(qt, scale, tid);
    fence_async_shared();
    named_barrier(1, 128);

    // S = q' k'^T (64 x NP): the biased scores, depth DA in k16 steps
    float sc[NP / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DA / 16; ++ks)
      Wgmma<NP>::ss(sc, wgmma_desc(qt + ks * 2 * 64 * 8, 64 * 16, 128, LAYOUT_INTERLEAVE),
                    wgmma_desc(sK + ks * 2 * NP * 8, NP * 16, 128, LAYOUT_INTERLEAVE),
                    ks > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // the exact softmax of each row over the Nw real keys (and an edge
    // row's pad key)
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (EDGE) {
          const float ka = kadd[8 * j + c0 + e];
          sc[4 * j + e] += ka;
          sc[4 * j + 2 + e] += ka;
        } else if (8 * j + c0 + e >= Nw) {
          sc[4 * j + e] = -INFINITY;
          sc[4 * j + 2 + e] = -INFINITY;
        }
        mx_lo = fmaxf(mx_lo, sc[4 * j + e]);
        mx_hi = fmaxf(mx_hi, sc[4 * j + 2 + e]);
      }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    if constexpr (EDGE) {
      mx_lo = fmaxf(mx_lo, lp_lo);
      mx_hi = fmaxf(mx_hi, lp_hi);
    }
    mx_lo *= LOG2E;
    mx_hi *= LOG2E;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(fmaf(sc[4 * j + e], LOG2E, -mx_lo));
        sc[4 * j + 2 + e] = exp2f(fmaf(sc[4 * j + 2 + e], LOG2E, -mx_hi));
        sum_lo += sc[4 * j + e];
        sum_hi += sc[4 * j + 2 + e];
      }
    float pp_lo = 0.f, pp_hi = 0.f;  // edge: the pad key's exp(lp - m)
    if constexpr (EDGE) {
      pp_lo = exp2f(fmaf(lp_lo, LOG2E, -mx_lo));
      pp_hi = exp2f(fmaf(lp_hi, LOG2E, -mx_hi));
    }
    const float inv_lo = 1.f / (quad_sum(sum_lo) + pp_lo);
    const float inv_hi = 1.f / (quad_sum(sum_hi) + pp_hi);

    // P = bf16(p / l), the m16n8k16 A fragment of each warp per 16 keys; O = P V
    uint32_t pa[NP / 16][4];
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks) {
      pa[ks][0] = pack_bf16(sc[8 * ks] * inv_lo, sc[8 * ks + 1] * inv_lo);
      pa[ks][1] = pack_bf16(sc[8 * ks + 2] * inv_hi, sc[8 * ks + 3] * inv_hi);
      pa[ks][2] = pack_bf16(sc[8 * ks + 4] * inv_lo, sc[8 * ks + 5] * inv_lo);
      pa[ks][3] = pack_bf16(sc[8 * ks + 6] * inv_hi, sc[8 * ks + 7] * inv_hi);
    }
    float o[DH / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks)
      Wgmma<DH>::rs(o, pa[ks], wgmma_desc(sV + ks * 16 * 8, 128, NP * 16, LAYOUT_INTERLEAVE),
                    ks > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    if constexpr (EDGE) {  // + (pp / l) * vb, in fp32 before the one rounding
      const bf16* vbh = edge.vb + h * DH;
      const float pw_lo = pp_lo * inv_lo, pw_hi = pp_hi * inv_hi;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = __bfloat162float(vbh[8 * j + c0 + e]);
          o[4 * j + e] += pw_lo * v;
          o[4 * j + 2 + e] += pw_hi * v;
        }
    }

    // epilogue in the tile's q chunks; then the slot goes back to the producer
    store_o_dmajor<DH, 64>(o, 1.f, 1.f, qt, ob, Nw, ldo, 64 * i, tid, 1);
    fence_async_shared();
    named_barrier(1, 128);
    if (tid == 0) ring.release(s);
  }
}

// rel_wm: rel (BW, Nw, lanes) window-major (#12, the edges), else (Nw, BW,
// lanes) position-major (#13)
template <int DH, int NP, bool EDGE, int QST>
int launch_windows_s(const void* qkv, const void* rel, bool rel_wm, void* out, int BW, int Nw,
                     int ldo, int win, int heads, float scale, const EdgeArgs& edge,
                     cudaStream_t s) {
  CUtensorMap qmap, kvmap, relmap;
  int err = encode_packed_rows<DH>(&qmap, qkv, BW, Nw, heads, 64);
  if (!err) err = encode_packed_rows<DH>(&kvmap, qkv, BW, Nw, heads, NP);
  // rel as (8-lane chunk, query, chunk index, window)
  const cuuint64_t lanes = (cuuint64_t)heads * WS_LANES, L2 = lanes * sizeof(bf16);
  const cuuint64_t dims[4] = {8, (cuuint64_t)Nw, lanes / 8, (cuuint64_t)BW};
  const cuuint64_t strides[3] = {rel_wm ? L2 : BW * L2, 16, rel_wm ? Nw * L2 : L2};
  const cuuint32_t box[4] = {8, 64, WS_LANES / 8, 1};
  if (!err) err = encode_bf16_map(&relmap, rel, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  constexpr size_t smem = windows_s_smem<DH, NP, EDGE, QST>();
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  cudaError_t e = cudaFuncSetAttribute(qkv_windows_s_kernel<DH, NP, EDGE, QST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  qkv_windows_s_kernel<DH, NP, EDGE, QST><<<dim3(heads, BW), WS_THREADS, smem, s>>>(
      qmap, kvmap, relmap, static_cast<bf16*>(out), Nw, ldo, win, heads, scale, edge);
  return (int)cudaGetLastError();
}

// the keys padded to the product's width: interior windows 64 up to win 8,
// 208 up to 14, 256; edges 64, 112 (ViT-H's R), 208 or 256
template <int DH, bool EDGE>
int dispatch_windows_s(const void* qkv, const void* rel, bool rel_wm, void* out, int BW, int Nw,
                       int ldo, int win, int heads, float scale, const EdgeArgs& edge,
                       cudaStream_t s) {
#define CVLM_WS_LAUNCH(NP)                                                                  \
  return launch_windows_s<DH, NP, EDGE, ws_qstages<DH, NP, EDGE>()>(                        \
      qkv, rel, rel_wm, out, BW, Nw, ldo, win, heads, scale, edge, s)
  if (Nw <= 64) CVLM_WS_LAUNCH(64);
  if constexpr (EDGE)
    if (Nw <= 112) CVLM_WS_LAUNCH(112);
  if (Nw <= 208) CVLM_WS_LAUNCH(208);
  CVLM_WS_LAUNCH(256);
#undef CVLM_WS_LAUNCH
}

template <bool EDGE>
int dispatch_d(const void* qkv, const void* rel, bool rel_wm, void* out, int BW, int Nw, int ldo,
               int win, int heads, int d, float scale, const EdgeArgs& edge, cudaStream_t s) {
  if (Nw < 1 || Nw > 256 || ldo < Nw || BW > 65535) return (int)cudaErrorInvalidValue;
  switch (d) {
#define CVLM_WS_CASE(D)                                                                      \
  case D:                                                                                    \
    return dispatch_windows_s<D, EDGE>(qkv, rel, rel_wm, out, BW, Nw, ldo, win, heads, scale, \
                                       edge, s);
    CVLM_WS_CASE(16)
    CVLM_WS_CASE(32)
    CVLM_WS_CASE(64)
    CVLM_WS_CASE(80)
    CVLM_WS_CASE(128)
#undef CVLM_WS_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cvlm

// qkv (BW, win*win, 3*heads*d), rel (win*win, BW, heads*32) position-major
// (#13, rel_wm = 0) or (BW, win*win, heads*32) window-major (#12), out (BW,
// heads*d, win*win) with row stride ldo >= win*win: bf16; 2 * win <= 32, d
// in {16, 32, 64, 80, 128}. Returns a cudaError_t code.
static int qkv_windows(const void* qkv, const void* rel, bool rel_wm, void* out, int BW, int win,
                       int heads, int d, float scale, int ldo, void* stream) {
  using namespace cvlm;
  if (win < 1 || 2 * win > WS_LANES) return (int)cudaErrorInvalidValue;
  return dispatch_d<false>(qkv, rel, rel_wm, out, BW, win * win, ldo, win, heads, d, scale,
                           EdgeArgs{}, static_cast<cudaStream_t>(stream));
}

extern "C" int cvlm_qkv_packed_windows_s(const void* qkv, const void* rel, void* out, int BW,
                                         int win, int heads, int d, float scale, int ldo,
                                         void* stream) {
  return qkv_windows(qkv, rel, false, out, BW, win, heads, d, scale, ldo, stream);
}

extern "C" int cvlm_qkv_packed_windows(const void* qkv, const void* rel, void* out, int BW,
                                       int win, int heads, int d, float scale, int ldo,
                                       void* stream) {
  return qkv_windows(qkv, rel, true, out, BW, win, heads, d, scale, ldo, stream);
}

// qkv (B, n, R, 3*heads*d), rel (B, n, R, heads*32) window-major, sel (n,
// 32, R), vb (heads, d), out (B, n, heads*d, R) with row stride ldo >= R:
// bf16; kmask (n, 1, R) fp32; R <= 256, d in {16, 32, 64, 80, 128}.
// Returns a cudaError_t code.
extern "C" int cvlm_qkv_packed_edge(const void* qkv, const void* rel, const void* sel,
                                    const void* vb, const void* kmask, void* out, int B,
                                    int n, int R, int heads, int d, float scale, int ldo,
                                    void* stream) {
  using namespace cvlm;
  if (n < 1) return (int)cudaErrorInvalidValue;
  const EdgeArgs edge{static_cast<const bf16*>(sel), static_cast<const bf16*>(vb),
                      static_cast<const float*>(kmask), n};
  return dispatch_d<true>(qkv, rel, true, out, B * n, R, ldo, 0, heads, d, scale, edge,
                          static_cast<cudaStream_t>(stream));
}
