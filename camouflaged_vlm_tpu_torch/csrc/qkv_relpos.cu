// qkv_relpos: SAM's windowed attention with the decomposed rel-pos bias of
// H + W lanes a head, per (window, head)
//   o = softmax((q*scale) . k^T + rel[q, k / W] + rel[q, H + k % W]) . v,
// read in place from the packed qkv projection, written head-leading; and
// the same function over split, pre-scaled q, k and v.
//
// Replaces three TPU kernels of camouflaged_vlm_tpu/ops/flash_attention.py:
//   flash_qkv_relpos_windows (_qkv_relpos_windows_kernel, #11) -- SAM's
//     fused 'flash' windows whose H + W exceeds the 32 rel lanes of the
//     packed kernels (a window of 17 or more, in the padded window carry),
//     and the global blocks of at most 512 tokens with H + W > 32: at ViT-H
//     with window 17, qkv (B, 16, 289, 48, 80), rel (B, 16, 289, 16, 34),
//     out (B, 16, 16, 289, 80);
//   flash_qkv_relpos_global (_qkv_relpos_global_kernel, #19) -- the same
//     function over one window of N tokens (nwin = 1): at ViT-H's 64 x 64
//     grid qkv (B, 4096, 48, 80), rel (B, 4096, 16, 128), out (B, 16, 4096,
//     80). No path of either package calls it; its JAX test does;
//   flash_attention_relpos (_relpos_kernel, #10) -- SAM's unfused 'flash'
//     attention, taken when num_heads % 8 != 0 (ViT-B's 12 heads x 64): q, k,
//     v (BB, N, d) apart, q pre-scaled, rel (BB, N, H + W), out (BB, N, d);
//     at batch 2 the windowed blocks' BB = 600 (25 padded 14 x 14 windows x
//     12 heads x 2 images, rel lanes 28) and the global blocks' BB = 24 over
//     the 64 x 64 grid. Seen with heads = nwin = 1 this is the packed form:
//     its out (B, heads, nwin, N, d) and rel (B nwin, N, heads, H + W) are
//     #10's. The TPU kernel adds the bias as the product rel @ sel; here
//     sel is not read (below).
// The head-leading output is what proj_from_heads (proj_rows.cu) reads.
//
// What bounds it on the H100: at window 17 and B = 2 the bytes, 105 MB
// (0.0313 ms at 3.35 TB/s; the products are 13.7 GFLOP); at the 64 x 64
// grid the products, 171.8 GFLOP (0.1737 ms at 989 TFLOP/s). #10 at batch 2:
// the global blocks' products, 103 GFLOP (0.1042 ms); the windows' bytes,
// 67 MB (0.0199 ms at 3.35 TB/s). The design is
// FlashAttention-3's one pass, as attn_sm90.cuh's attn_stream_kernel (#16)
// and qkv_packed_global.cu (#17) run it, in two arrangements:
//   * streaming (RES = false): one block per (NWG x 64 queries, head,
//     window of an image), NWG consumer warpgroups and one producer warp;
//     the producer loads the block's q rows once, then keeps a ring of
//     RP_STAGES 64-key k and v tiles in flight;
//   * resident (RES = true), where the window's k and v fit in shared
//     memory (289 keys at d = 80: 5 tiles, 100 KB): one block per (head,
//     window), three consumer warpgroups taking the window's query tiles in
//     turn through a ring of q slots, k and v loaded once and read by every
//     query tile (measured at window 17: 0.165 ms against 0.209 streaming
//     with one warpgroup a block, 0.227 with two);
//   all loads by TMA from the packed rows (encode_packed_rows), the window
//   axis folded into the image axis ((B nwin, N, 3 heads d) is the same
//   memory); or, the split front end (SPLIT, #10), from three maps over the
//   split rows (encode_split_rows), which land in the same core-matrix
//   layout; rows past N come as zeros;
//   * each consumer warpgroup stages its 64 queries' rel rows (H + W bf16
//     lanes: 68 bytes at window 17, 56 at #10's windows of 14: no TMA box)
//     by plain loads while its q
//     lands, scales q (scale_q_tile; #10's q arrives scaled and is not
//     touched), then per key tile: S = Q K^T by wgmma
//     m64n64k16 into registers; the bias (below); the keys past N of a
//     ragged last tile (289 = 4 x 64 + 33) masked to -inf; the online
//     softmax in registers; P rounded to bf16 in registers as wgmma's
//     register A operand for O += P V;
//   * the bias, by the first of three ways that takes the grid:
//     REL_REG, W equal to the key tile (the 64 x 64 grid: #19, and #10's
//       global blocks over 32 query-tile pairs x 24 problems), streaming with
//       two warpgroups as #17: a tile is one grid row, so each thread keeps
//       rel_w of its 16 key columns for its 2 rows in registers for the
//       whole pass and reads one rel_h a row a tile, adding the fp32 sum of
//       the two bf16 values to the fp32 score (#17's register path);
//     REL_TC, H + W <= 64 and resident (at d = 80 #11's windows of 17 to
//       19 and global blocks up to 19 x 19; at d = 64 #10's 14 x 14
//       windows, 196 keys in four tiles): on the tensor cores, as #13 does:
//       the rel rows staged as q's extra chunks, lanes padded to a k16 step
//       (48 at window 17), and a two-hot code of every key (ones at lanes
//       k / W and H + k % W) built once a block in shared memory, so the S
//       chain goes on over the rel lanes and yields the biased score
//       (products with 0 or 1 are exact: the fp32 sum differs from rel_h +
//       rel_w only in order); at window 17 0.165 ms against 0.181 gathered;
//     REL_TABLE, any other grid, resident where it fits (the 20 x 20 and
//       22 x 22 global blocks) else streaming: each key's lanes (k / W,
//       H + k % W) from a table built once a block, gathered per score from
//       the staged rows (on the 64 x 64 grid 2.3x the register path's time);
//   * epilogue: O / l rounded to bf16, through the warpgroup's q buffer
//     (rows padded to d + 8, no bank conflicts) into the head-leading rows,
//     which for 64 queries are one contiguous run of 64 d values: 16-byte
//     stores.
// (Times: queued, batch 2, 16 heads x 80, NVIDIA H100 80GB HBM3, 700 W;
// PERF.md.)
// Rounding: the one pass moves one rounding point against the JAX `ref`
// (flash_attention.py:182-210, :1242-1259): P is rounded to bf16
// unnormalised, exp(s - m_running), and O is divided by the fp32 row sum at
// the end, where the plain version normalises before the rounding. The
// same single point as #16 and #17; tests/test_torch_padded_flash.py holds
// this formulation to the JAX reference in bf16 at window 17 and on a 20 x
// 20 grid, and #10's (no q rounding) to the JAX kernel on 14 x 14 windows,
// an 8 x 64 grid and a ragged 5 x 6 one.
#include "attn_sm90.cuh"

namespace cvlm {

constexpr int RP_KT = 64, RP_STAGES = 3;

// How a score gets its bias: REL_REG, rel_w of the thread's key columns in
// registers (W == RP_KT); REL_TC, on the tensor cores, [q | rel] . [k |
// two-hot code] with the rel lanes padded to a multiple of 16; REL_TABLE,
// each key's two lanes from a code table, gathered per score.
enum RelMode { REL_TABLE = 0, REL_REG = 1, REL_TC = 2 };

// q buffer of a warpgroup: the [DH/8][64][8] q tile, later [64][DH + 8] O
template <int DH>
__host__ __device__ constexpr int rp_qbuf() {
  return 64 * (DH + 8);
}

// rel lanes a query row holds in shared memory: REL_TC pads hw to a k16 step
template <int MODE>
__host__ __device__ constexpr int rp_lanes(int hw) {
  return MODE == REL_TC ? (hw + 15) / 16 * 16 : hw;
}

// shared memory: NWG q buffers; the k and v tiles (RES: all n_tiles of the
// window, else a ring of RP_STAGES); NWG x 64 rel rows; the key code table
// (REL_TABLE: one uint32 a key; REL_TC: [lanes / 8][n_keys][8] bf16); the
// barriers (RES: one a k/v tile and a ring of NWG q slots; else one for q
// and the k/v ring)
template <int DH, int NWG, int MODE, bool RES>
__host__ __device__ constexpr size_t relpos_smem(int hw, int n_tiles) {
  const size_t lanes = rp_lanes<MODE>(hw), n_keys = (size_t)n_tiles * RP_KT;
  const size_t table = MODE == REL_TABLE ? sizeof(uint32_t) * n_keys
                       : MODE == REL_TC  ? sizeof(bf16) * n_keys * lanes
                                         : 0;
  const size_t kv = RES ? n_tiles : RP_STAGES;
  const size_t bars = RES ? n_tiles + 2 * NWG : 1 + 2 * RP_STAGES;
  return 128 + sizeof(bf16) * (NWG * rp_qbuf<DH>() + 2 * kv * RP_KT * DH + NWG * 64 * lanes) +
         table + sizeof(uint64_t) * bars;
}

// q, k and v through qmap, kmap, vmap: the packed form one map thrice
// (encode_packed_rows over B nwin images, 64 rows), q, k and v the chunk
// columns of head h; SPLIT (heads = nwin = 1) three maps over the split rows
// (encode_split_rows), q pre-scaled. rel (B nwin, N, heads, H + W); out (B,
// heads, nwin, N, DH). NWG * 128 + 32 threads. Grid (ceil(N / (64 NWG)),
// heads, B nwin): each warpgroup one query tile against a stream of k/v
// tiles. RES: grid (heads, B nwin), the window's k and v loaded once and
// kept, the warpgroups taking its query tiles i = wg, wg + NWG, ... through
// a ring of NWG q slots.
template <int DH, int NWG, int MODE, bool RES, bool SPLIT>
__global__ void __launch_bounds__(NWG * 128 + 32, 1) qkv_relpos_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ rel,
    bf16* __restrict__ out, int N, int H, int W, int heads, int nwin, float scale) {
  constexpr int TILE = RP_KT * DH;      // elements of one 64-row tile
  constexpr int QB = rp_qbuf<DH>();     // elements of a warpgroup's q buffer
  const int hw = H + W, lanes = rp_lanes<MODE>(hw);
  const int n_tiles = (N + RP_KT - 1) / RP_KT, n_keys = n_tiles * RP_KT;
  const int n_kv = RES ? n_tiles : RP_STAGES;  // k/v tiles in shared memory
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // NWG x q buffer
  bf16* sK = sQ + NWG * QB;                  // [n_kv][DH/8][64][8]
  bf16* sV = sK + n_kv * TILE;
  bf16* sRel = sV + n_kv * TILE;             // NWG x [64][hw], REL_TC [lanes/8][64][8]
  unsigned char* table = reinterpret_cast<unsigned char*>(sRel + NWG * 64 * lanes);
  uint32_t* kcode = reinterpret_cast<uint32_t*>(table);  // REL_TABLE: lo | hi << 16
  bf16* kcode_tc = reinterpret_cast<bf16*>(table);       // REL_TC: [lanes/8][n_keys][8]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      table + (MODE == REL_TABLE ? sizeof(uint32_t) * n_keys
               : MODE == REL_TC  ? sizeof(bf16) * n_keys * lanes
                                 : 0));
  // streaming: bars[0] q, then the k/v ring; RES: one a k/v tile, then the q ring
  const MbarRing<RP_STAGES> ring{bars + 1, bars + 1 + RP_STAGES};
  const MbarRing<NWG> qring{bars + n_tiles, bars + n_tiles + NWG};

  const int tid = threadIdx.x, wg = tid / 128;
  const int h = RES ? blockIdx.x : blockIdx.y, bw = RES ? blockIdx.y : blockIdx.z;
  const int q0 = RES ? 0 : blockIdx.x * (NWG * 64);
  if constexpr (MODE == REL_TABLE) {
    for (int k = tid; k < N; k += NWG * 128 + 32) {
      const int kh = k / W;
      kcode[k] = (uint32_t)kh | ((uint32_t)(H + k - kh * W) << 16);
    }
  } else if constexpr (MODE == REL_TC) {
    // k's lane code: ones at lanes k / W and H + k % W, none past N
    for (int e = tid; e < (lanes / 8) * n_keys; e += NWG * 128 + 32) {
      const int c = e / n_keys, k = e - c * n_keys;
      int lo = -1, hi = -1;  // the key's lanes within chunk c
      if (k < N) {
        const int kh = k / W;
        lo = kh - 8 * c;
        hi = H + k - kh * W - 8 * c;
      }
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = pack_bf16(2 * i == lo || 2 * i == hi ? 1.f : 0.f,
                         2 * i + 1 == lo || 2 * i + 1 == hi ? 1.f : 0.f);
      reinterpret_cast<uint4*>(kcode_tc)[e] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    fence_async_shared();  // wgmma reads the table through the async proxy
  }
  if (tid == 0) {
    if constexpr (RES) {
      for (int t = 0; t < n_tiles; ++t) mbar_init(&bars[t], 1);
      qring.init(1);  // each q slot is one warpgroup's
    } else {
      mbar_init(bars, 1);
      ring.init(NWG);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {  // the producer warp: one thread issues every load
    if (tid == NWG * 128) {
      // the chunk column of q, k and v: head h's in the packed rows, 0 apart
      const int cq = SPLIT ? 0 : h * DH / 8, ck = SPLIT ? 0 : (heads + h) * DH / 8,
                cv = SPLIT ? 0 : (2 * heads + h) * DH / 8;
      if constexpr (RES) {
        for (int i = 0; i < NWG && i < n_tiles; ++i) {
          const int s = qring.acquire(i, TILE * sizeof(bf16));
          tma_load_4d(sQ + s * QB, &qmap, &qring.full[s], 0, 64 * i, cq, bw);
        }
        for (int t = 0; t < n_tiles; ++t) {
          mbar_expect_tx(&bars[t], 2 * TILE * sizeof(bf16));
          tma_load_4d(sK + t * TILE, &kmap, &bars[t], 0, t * RP_KT, ck, bw);
          tma_load_4d(sV + t * TILE, &vmap, &bars[t], 0, t * RP_KT, cv, bw);
        }
        for (int i = NWG; i < n_tiles; ++i) {
          const int s = qring.acquire(i, TILE * sizeof(bf16));
          tma_load_4d(sQ + s * QB, &qmap, &qring.full[s], 0, 64 * i, cq, bw);
        }
      } else {
        mbar_expect_tx(bars, NWG * TILE * sizeof(bf16));
        for (int w = 0; w < NWG; ++w)
          tma_load_4d(sQ + w * QB, &qmap, bars, 0, q0 + 64 * w, cq, bw);
        for (int t = 0; t < n_tiles; ++t) {
          const int s = ring.acquire(t, 2 * TILE * sizeof(bf16));
          tma_load_4d(sK + s * TILE, &kmap, &ring.full[s], 0, t * RP_KT, ck, bw);
          tma_load_4d(sV + s * TILE, &vmap, &ring.full[s], 0, t * RP_KT, cv, bw);
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  const int ltid = tid % 128, lane = tid % 32;
  // this thread's accumulator rows (within the warpgroup) and first column
  const int r_lo = (ltid / 32) * 16 + lane / 4, r_hi = r_lo + 8, c0 = 2 * (lane % 4);
  bf16* sRelw = sRel + wg * 64 * lanes;
  const bf16* rel_lo = sRelw + r_lo * hw;
  const bf16* rel_hi = sRelw + r_hi * hw;
  const bf16* rb = rel + (size_t)bw * N * heads * hw + (size_t)h * hw;
  const int b = bw / nwin, w = bw - b * nwin;
  bf16* ob = out + (((size_t)b * heads + h) * nwin + w) * N * DH;
  float m_lo, m_hi, l_lo, l_hi, o[DH / 2];
  float relw[MODE == REL_REG ? 32 : 1];

  // the query tile at qw, its q rows in qb (TMA'd): stage its rel rows
  // ([64][hw], REL_TC as q's extra chunks [lanes/8][64][8]), scale q (SPLIT:
  // q arrives scaled)
  auto prepare = [&](bf16* qb, int qw, uint64_t* qbar, int parity) {
    for (int e = ltid; e < 64 * lanes; e += 128) {
      const int r = e / lanes, j = e - r * lanes, q = qw + r;
      const bf16 v = q < N && j < hw ? rb[(size_t)q * heads * hw + j] : __float2bfloat16(0.f);
      sRelw[MODE == REL_TC ? ((j >> 3) * 64 + r) * 8 + (j & 7) : e] = v;
    }
    mbar_wait(qbar, parity);
    if constexpr (!SPLIT) scale_q_tile<DH>(qb, scale, ltid);
    fence_async_shared();
    named_barrier(1 + wg, 128);
    if constexpr (MODE == REL_REG) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          relw[2 * j + e] = __bfloat162float(rel_lo[H + 8 * j + c0 + e]);
          relw[16 + 2 * j + e] = __bfloat162float(rel_hi[H + 8 * j + c0 + e]);
        }
    }
    m_lo = m_hi = -INFINITY;
    l_lo = l_hi = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  };

  // one key tile t (k and v in kb, vb) of the online softmax
  auto step = [&](const bf16* qb, const bf16* kb, const bf16* vb, int t) {
    // S = Q K^T (64 x 64 per warpgroup), k over d in steps of 16; REL_TC
    // goes on over the rel lanes against the tile's keys' code
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      Wgmma<64>::ss(sc, wgmma_desc(qb + ks * 2 * RP_KT * 8, RP_KT * 16, 128, LAYOUT_INTERLEAVE),
                    wgmma_desc(kb + ks * 2 * RP_KT * 8, RP_KT * 16, 128, LAYOUT_INTERLEAVE),
                    ks > 0 ? 1 : 0);
    if constexpr (MODE == REL_TC) {
#pragma unroll 1
      for (int ls = 0; ls < lanes / 16; ++ls)
        Wgmma<64>::ss(
            sc, wgmma_desc(sRelw + ls * 2 * 64 * 8, 64 * 16, 128, LAYOUT_INTERLEAVE),
            wgmma_desc(kcode_tc + ((size_t)ls * 2 * n_keys + t * RP_KT) * 8, n_keys * 16, 128,
                       LAYOUT_INTERLEAVE),
            1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    // + bias, in log2 units; the keys past N of a ragged last tile out
    if constexpr (MODE == REL_REG) {
      const float rh_lo = __bfloat162float(rel_lo[t]), rh_hi = __bfloat162float(rel_hi[t]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = (sc[4 * j + e] + (rh_lo + relw[2 * j + e])) * LOG2E;
          sc[4 * j + 2 + e] = (sc[4 * j + 2 + e] + (rh_hi + relw[16 + 2 * j + e])) * LOG2E;
        }
    } else {
      const int kv = N - t * RP_KT;  // the tile's real keys
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + c0 + e;
          if (c >= kv) {
            sc[4 * j + e] = -INFINITY;
            sc[4 * j + 2 + e] = -INFINITY;
          } else if constexpr (MODE == REL_TC) {
            sc[4 * j + e] *= LOG2E;
            sc[4 * j + 2 + e] *= LOG2E;
          } else {
            const uint32_t code = kcode[t * RP_KT + c];
            const int lo = code & 0xffff, hi = code >> 16;
            sc[4 * j + e] = (sc[4 * j + e] + (__bfloat162float(rel_lo[lo]) +
                                              __bfloat162float(rel_lo[hi]))) * LOG2E;
            sc[4 * j + 2 + e] = (sc[4 * j + 2 + e] + (__bfloat162float(rel_hi[lo]) +
                                                      __bfloat162float(rel_hi[hi]))) * LOG2E;
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
      Wgmma<DH>::rs(o, pa[ks], wgmma_desc(vb + ks * 16 * 8, 128, RP_KT * 16, LAYOUT_INTERLEAVE),
                    1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  };

  // O / l rounded to bf16 into qb as [64][DH + 8] rows, then the rows q < N
  // of the head-leading output: one contiguous run from query qw (16-byte
  // aligned: DH * 2 bytes a row is a multiple of 16)
  auto store = [&](bf16* qb, int qw) {
    constexpr int LDB = DH + 8;
    const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = 8 * j + c0;
      *reinterpret_cast<uint32_t*>(qb + r_lo * LDB + c) =
          pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
      *reinterpret_cast<uint32_t*>(qb + r_hi * LDB + c) =
          pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
    }
    named_barrier(1 + wg, 128);
    const int nq = min(64, N - qw);
    for (int e = ltid; e < nq * (DH / 8); e += 128) {
      const int r = e / (DH / 8), c = (e - r * (DH / 8)) * 8;
      *reinterpret_cast<uint4*>(ob + (size_t)(qw + r) * DH + c) =
          *reinterpret_cast<const uint4*>(qb + r * LDB + c);
    }
  };

  if constexpr (RES) {
    for (int i = wg; i < n_tiles; i += NWG) {
      const int s = i % NWG;
      bf16* qb = sQ + s * QB;
      prepare(qb, 64 * i, &qring.full[s], (i / NWG) & 1);
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(&bars[t], 0);
        step(qb, sK + t * TILE, sV + t * TILE, t);
      }
      store(qb, 64 * i);
      named_barrier(1 + wg, 128);  // every read of qb and the rel rows done
      if (ltid == 0) qring.release(s);
    }
  } else {
    bf16* qb = sQ + wg * QB;
    prepare(qb, q0 + 64 * wg, bars, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = ring.wait(t);
      step(qb, sK + s * TILE, sV + s * TILE, t);
      if (ltid == 0) ring.release(s);
    }
    store(qb, q0 + 64 * wg);
  }
}

// q, k and v's maps (the packed form: one map thrice); grid and shared
// memory from the arrangement
template <int DH, int NWG, int MODE, bool RES, bool SPLIT>
int launch_relpos(const CUtensorMap (&maps)[3], const void* rel, void* out, int B, int nwin,
                  int H, int W, int heads, float scale, cudaStream_t s) {
  const int N = H * W, BW = B * nwin, n_tiles = (N + RP_KT - 1) / RP_KT;
  const size_t smem = relpos_smem<DH, NWG, MODE, RES>(H + W, n_tiles);
  if (smem > 227 * 1024 || BW > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(qkv_relpos_kernel<DH, NWG, MODE, RES, SPLIT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid = RES ? dim3(heads, BW) : dim3((N + NWG * 64 - 1) / (NWG * 64), heads, BW);
  qkv_relpos_kernel<DH, NWG, MODE, RES, SPLIT><<<grid, NWG * 128 + 32, smem, s>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(rel), static_cast<bf16*>(out), N, H,
      W, heads, nwin, scale);
  return (int)cudaGetLastError();
}

// The arrangement at an H x W grid: W equal to the key tile (the 64 x 64
// grid): rel_w in registers, streaming, two warpgroups a block as #17. Else,
// where the window's k and v fit in shared memory, resident, three
// warpgroups, the bias on the tensor cores (H + W <= 64) or else gathered;
// else streaming with the gathered table.
struct RelposPlan {
  int mode, nwg;
  bool res;
  size_t smem;
};

template <int DH>
RelposPlan relpos_plan(int H, int W) {
  const int hw = H + W, n_tiles = (H * W + RP_KT - 1) / RP_KT;
  if (W == RP_KT)
    return {REL_REG, 2, false, relpos_smem<DH, 2, REL_REG, false>(hw, n_tiles)};
  const size_t tc = relpos_smem<DH, 3, REL_TC, true>(hw, n_tiles);
  if (hw <= 64 && tc <= 227 * 1024) return {REL_TC, 3, true, tc};
  const size_t table = relpos_smem<DH, 3, REL_TABLE, true>(hw, n_tiles);
  if (table <= 227 * 1024) return {REL_TABLE, 3, true, table};
  return {REL_TABLE, 2, false, relpos_smem<DH, 2, REL_TABLE, false>(hw, n_tiles)};
}

template <int DH, bool SPLIT>
int dispatch_relpos(const CUtensorMap (&maps)[3], const void* rel, void* out, int B, int nwin,
                    int H, int W, int heads, float scale, cudaStream_t s) {
  const RelposPlan p = relpos_plan<DH>(H, W);
  if (p.mode == REL_REG)
    return launch_relpos<DH, 2, REL_REG, false, SPLIT>(maps, rel, out, B, nwin, H, W, heads,
                                                       scale, s);
  if (p.mode == REL_TC)
    return launch_relpos<DH, 3, REL_TC, true, SPLIT>(maps, rel, out, B, nwin, H, W, heads,
                                                     scale, s);
  if (p.res)
    return launch_relpos<DH, 3, REL_TABLE, true, SPLIT>(maps, rel, out, B, nwin, H, W, heads,
                                                        scale, s);
  return launch_relpos<DH, 2, REL_TABLE, false, SPLIT>(maps, rel, out, B, nwin, H, W, heads,
                                                       scale, s);
}

// the packed form: one map over the (B nwin, N, 3 heads DH) rows
template <int DH>
int relpos_packed(const void* qkv, const void* rel, void* out, int B, int nwin, int H, int W,
                  int heads, float scale, cudaStream_t s) {
  CUtensorMap maps[3];
  const int err = encode_packed_rows<DH>(&maps[0], qkv, B * nwin, H * W, heads, RP_KT);
  if (err) return err;
  maps[1] = maps[2] = maps[0];
  return dispatch_relpos<DH, false>(maps, rel, out, B, nwin, H, W, heads, scale, s);
}

// the split form (#10): q, k and v (BB, N, DH) apart, q pre-scaled
template <int DH>
int relpos_split(const void* q, const void* k, const void* v, const void* rel, void* out,
                 int BB, int H, int W, cudaStream_t s) {
  const int N = H * W;
  CUtensorMap maps[3];
  const void* base[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_split_rows(&maps[i], base[i], BB, N, DH, DH / 8);
    if (err) return err;
  }
  return dispatch_relpos<DH, true>(maps, rel, out, BB, 1, H, W, 1, 1.f, s);
}

}  // namespace cvlm

// qkv (B, nwin, N, 3*heads*d), rel (B, nwin, N, heads*(H+W)), out (B, heads,
// nwin, N, d): bf16; N == H * W; d in {64, 80}. Returns a cudaError_t code.
extern "C" int cvlm_qkv_relpos(const void* qkv, const void* rel, void* out, int B, int nwin,
                               int H, int W, int heads, int d, float scale, void* stream) {
  using namespace cvlm;
  if (B < 1 || nwin < 1 || H < 1 || W < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return relpos_packed<64>(qkv, rel, out, B, nwin, H, W, heads, scale, s);
    case 80: return relpos_packed<80>(qkv, rel, out, B, nwin, H, W, heads, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// #10: q (pre-scaled), k (BB, N, d), v (BB, N, dv), rel (BB, N, H+W), out
// (BB, N, dv): bf16, bases 16-byte aligned; N == H * W; d == dv in {64, 80}
// (SAM ViT-B, ViT-H); BB <= 65535. Returns a cudaError_t code.
extern "C" int cvlm_attn_relpos(const void* q, const void* k, const void* v, const void* rel,
                                void* out, int BB, int N, int H, int W, int d, int dv,
                                void* stream) {
  using namespace cvlm;
  if (BB < 1 || H < 1 || W < 1 || N != H * W || d != dv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return relpos_split<64>(q, k, v, rel, out, BB, H, W, s);
    case 80: return relpos_split<80>(q, k, v, rel, out, BB, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What cvlm_attn_relpos and cvlm_qkv_relpos launch at an H x W grid and
// depth d: out[0] the bias mode (0 the gathered table, 1 rel_w in
// registers, 2 on the tensor cores), out[1] 1 where k and v are resident,
// out[2] the consumer warpgroups, out[3] the dynamic shared memory in bytes.
// Returns a cudaError_t code.
extern "C" int cvlm_attn_relpos_smem(int H, int W, int d, long long* out) {
  using namespace cvlm;
  if (H < 1 || W < 1 || (d != 64 && d != 80)) return (int)cudaErrorInvalidValue;
  const RelposPlan p = d == 64 ? relpos_plan<64>(H, W) : relpos_plan<80>(H, W);
  out[0] = p.mode;
  out[1] = p.res;
  out[2] = p.nwg;
  out[3] = (long long)p.smem;
  return 0;
}
