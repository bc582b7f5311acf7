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
// forward's probabilities, rebuilt exactly as the forward's plain version
// builds them (q*scale rounded to bf16 with the scale rounded first, the fp32
// bias sum of the two bf16 rel values, max-subtracted fp32 softmax normalised
// before any rounding);
//   dP = g . v^T,  t = sum_k dP * P (fp32),  dS = bf16(P * (dP - t)),
//   dv = bf16(P)^T . g,  dq = scale * dS . k,  dk = scale * dS^T . q (q unscaled),
//   drel = dS . sel^T, i.e. per row the sums of dS over the keys of each lane.
// No rounding point moves: every sum is fp32 and each output is rounded once.
//
// What bounds it on the H100: the products. The function needs five of
// 2 N^2 d a (image, head): the scores, dP, dv, dq and dk; 0.434 ms at the
// global blocks' shapes (B = 2), where the bytes take 0.02 ms. At the windows'
// shapes the bytes bound it (0.037 ms against 0.032 for the products).
//
// Blocks on Hopper run in no order and nothing carries over between them,
// and dk/dv are sums over queries while dq and drel are sums over keys. So
// three launches, no atomics (the result is bit-equal in every run), on
// attn_sm90.cuh's blocks (64-row tiles as wgmma's no-swizzle core matrices,
// mbarrier rings, a producer and two consumer warpgroups):
//   prep, one pass over the inputs into a bf16 scratch (aux) of 64-row tiles
//     laid out as the passes read them ([16-byte column][64 rows][8]), per
//     row and head [bf16(q * scale) | the rel lanes zero-padded to LPC | g |
//     q | k | v], rows past N zero. A tile, or a run of its sections, is then
//     one contiguous bulk copy (cp.async.bulk): one request, where a tensor
//     map's box of these 16-byte rows makes one request a row (640 for a 64 x
//     80 tile). Against a first form that read q, k and v by tensor maps, as
//     #17 does, the whole call measured ~10% faster, its passes 2-25%, the
//     prep pass half as fast (PERF.md §6). g
//     arrives d-major (heads d, N) and becomes rows of d, the layout that
//     serves it as the K-major A of dP = g v^T, the K-major B of dP^T = v g^T
//     and the N-major B of dv = P^T g alike. The key code, ones at lanes
//     k / W and H + k % W, comes from the wrapper in the same tiles (cached
//     per shape).
//   the query pass, one block per (128 queries, head, image): each warpgroup
//     holds its 64 rows' [q*scale | rel | g]; the producer streams the key
//     tiles (k and v and, but for the register path, the code) through a ring
//     twice (3 stages, 2 where 227 KB do not hold 3, as at d = 128 and 128
//     lanes). Sweep 1: S and dP by wgmma into registers, the row max, sum and
//     t online (t = sum exp(s - m) dP / l, rescaled with the max, like l).
//     Sweep 2: S and dP again, P = exp(s - m) / l and dS = bf16(P (dP - t))
//     in registers, then dq += dS . k and drel by wgmma with dS as the register
//     A operand. It writes dq, drel and the rows' (m, 1/l, t) for the key pass.
//   the key pass, one block per (128 keys, head, image): each warpgroup holds
//     its 64 keys' [k | code] and v; the producer streams the query tiles
//     ([q*scale | rel | g | q] and the statistics) through a ring. Per tile
//     S^T = [k | code] . [q*scale | rel]^T and dP^T = v . g^T (keys as rows),
//     P^T and dS^T in registers from the columns' statistics, then dv += P^T
//     . g and dk += dS^T . q with P^T and dS^T as the register A operands. It
//     writes dk and dv. Queries past N come as zero rows with zero statistics
//     (1/l = 0), so they add nothing.
// The scores are computed three times and dP twice: 9 products against the
// 5 of the bound (the TPU kernel's cost estimate counts 5).
//
// The bias: on the tensor cores, as #13's forward adds it: [q*scale | rel
// lanes] . [k | key code]^T yields the biased score in one chain of products
// (0/1 products are exact, so it differs from q k^T + rel @ sel only in fp32
// summation order). The register path (REG), for W = 64, the 64 x 64 grid of
// ViT-H's global blocks, where a 64-key tile is one grid row kh = tile: the
// query pass adds the bias in registers as #17 does (rel_w of the thread's 16
// key columns kept for the pass, one rel_h a row a tile), takes S over d only
// and needs no code; and drel needs no product either: the tile's rel_h lane
// gets the row sum of dS over the tile (into shared memory), and the 64 rel_w
// lanes get the dS tile itself, added into a 64-wide fp32 accumulator of the
// score layout. Any other grid takes the general path (both products); the
// C entry picks (ab_reg). The key pass forms S^T through the code chain on
// every grid, so at W = 64 the two passes add the bias in different fp32
// orders (P agrees to fp32 rounding). Within a warpgroup the dP product runs
// behind S's: the softmax on S starts while dP is in flight. (Times against
// the WMMA passes this replaced, and of REG against the general path at
// #18's shape, csrc/variants/attn_variants.cu: PERF.md §6.)
#include "attn_sm90.cuh"

namespace cvlm {

constexpr int AB_T = 64;              // rows of a query or a key tile
constexpr int AB_CHUNK = AB_T * 8;    // elements of one 16-byte column of a tile ([chunk][64][8])
constexpr int AB_NWG = 2;             // consumer warpgroups a block
constexpr int AB_THREADS = (AB_NWG + 1) * 128;  // and a producer warpgroup
constexpr size_t AB_SMEM_MAX = 232448;  // dynamic shared memory a block may use (227 KB)

// 16-byte column counts of the tiles, and the sections of an aux tile
template <int DH, int LPC>
struct AbDims {
  static constexpr int CQ = DH / 8;       // q, k, v or g
  static constexpr int CL = LPC / 8;      // rel lanes, key code
  static constexpr int CA = 2 * CQ + CL;  // [q*scale | rel lanes | g]: the query pass's rows
  static constexpr int G = CQ + CL, QU = 2 * CQ + CL, K = 3 * CQ + CL, V = 4 * CQ + CL;
  static constexpr int CT = 5 * CQ + CL;  // [q*scale | rel | g | q | k | v]
};

// The register path (REG) serves a grid W = 64 wide, where a 64-key tile is
// one grid row, with the lanes [rel_h | rel_w] packed into the code's 128
constexpr bool ab_reg(int H, int W, int L, int lpc) {
  return W == AB_T && L == H + W && lpc == 128;
}

// the query pass: NWG aux tiles, an st-stage ring of key tiles ([k | code],
// REG: k) and v tiles, REG's rel_h gradients (NWG x [64][64] fp32), barriers
constexpr size_t abq_smem(int dh, int lpc, bool reg, int st) {
  return 128 +
         sizeof(bf16) * AB_CHUNK *
             (size_t)(AB_NWG * (2 * dh / 8 + lpc / 8) + st * (2 * dh / 8 + (reg ? 0 : lpc / 8))) +
         (reg ? sizeof(float) * AB_NWG * AB_T * AB_T : 0) + sizeof(uint64_t) * (1 + 2 * st);
}

// the key pass: NWG [k | code] and v tiles, an st-stage ring of query tiles
// ([q*scale | rel | g | q], the statistics: 64 x 4 fp32), barriers
constexpr size_t abk_smem(int dh, int lpc, int st) {
  return 128 +
         sizeof(bf16) * AB_CHUNK *
             (size_t)(AB_NWG * (2 * dh / 8 + lpc / 8) + st * (3 * dh / 8 + lpc / 8)) +
         sizeof(float) * 4 * AB_T * st + sizeof(uint64_t) * (1 + 2 * st);
}

// ring stages: 3, or 2 where 227 KB do not hold 3
constexpr int abq_stages(int dh, int lpc, bool reg) {
  return abq_smem(dh, lpc, reg, 3) <= AB_SMEM_MAX ? 3 : 2;
}
constexpr int abk_stages(int dh, int lpc) { return abk_smem(dh, lpc, 3) <= AB_SMEM_MAX ? 3 : 2; }

// wgmma descriptors of a [chunk][64][8] tile: K-major over its chunks (an A,
// or a B whose rows are its N), and N-major (a B whose rows are its K)
__device__ __forceinline__ uint64_t kmajor(const bf16* p) {
  return wgmma_desc(p, AB_T * 16, 128, LAYOUT_INTERLEAVE);
}
__device__ __forceinline__ uint64_t nmajor(const bf16* p) {
  return wgmma_desc(p, 128, AB_T * 16, LAYOUT_INTERLEAVE);
}

// a contiguous run of `bytes` (a multiple of 16, both ends 16-byte aligned)
// global -> shared by one bulk copy, signalling `bar` (cp.async.bulk: one
// request, where a tensor map's box of 16-byte rows makes one a row)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// two bf16 values kept packed in one register, and back to fp32 (exact)
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// An accumulator of 64 x 64 (rows x 16 k steps' columns) as the four m16n8k16
// A fragments of the next product, whose depth is those columns; the values
// are bf16 already, so the packing is exact
__device__ __forceinline__ void to_a_frags(const float (&v)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = pack_bf16(v[8 * ks], v[8 * ks + 1]);
    a[ks][1] = pack_bf16(v[8 * ks + 2], v[8 * ks + 3]);
    a[ks][2] = pack_bf16(v[8 * ks + 4], v[8 * ks + 5]);
    a[ks][3] = pack_bf16(v[8 * ks + 6], v[8 * ks + 7]);
  }
}

// Registers: FlashAttention-3's split of a block of three warpgroups,
// producer_regs / consumer_regs (gemm_sm90.cuh).

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// aux, one (BB, heads, NTP) grid of 64-row tiles, each [CT][64][8] (the
// chunk layout the passes read, so that a tile or a run of its sections is
// one contiguous bulk copy): per row and head the sections [bf16(q *
// bf16(scale)) | rel lanes 0..L-1, then zeros to LPC | g's row | q | k | v];
// rows past N are zeros. NTP = ceil(N / 64) rounded up to the blocks' two
// tiles. Grid (NTP, heads, BB), 256 threads; g's (DH, 64) slab goes through
// shared memory; the tile is written 16 bytes a thread, neighbouring threads
// on neighbouring rows.
__global__ void __launch_bounds__(256) attn_bwd_prep_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ rel, const bf16* __restrict__ g,
    bf16* __restrict__ aux, int N, int NTP, int L, int LPC, int heads, int DH, float scale) {
  __shared__ bf16 gs[128 * 65];  // [c][64 rows + 1]
  const int t = blockIdx.x, n0 = t * AB_T, h = blockIdx.y, b = blockIdx.z, BB = gridDim.z;
  const bf16* gb = g + ((size_t)b * heads + h) * DH * N;
  for (int e = threadIdx.x; e < DH * AB_T; e += 256) {
    const int c = e / AB_T, nl = e % AB_T, n = n0 + nl;
    gs[c * 65 + nl] = n < N ? gb[(size_t)c * N + n] : __float2bfloat16(0.f);
  }
  __syncthreads();
  const float sc = __bfloat162float(__float2bfloat16(scale));  // the scale in bf16
  const int CQ = DH / 8, CL = LPC / 8, CT = 5 * CQ + CL;
  const size_t C3 = 3ull * heads * DH;
  bf16* tile = aux + (((size_t)b * heads + h) * NTP + t) * CT * AB_CHUNK;
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < CT * AB_T; e += 256) {
    const int c = e / AB_T, r = e - c * AB_T, n = n0 + r;
    uint32_t w[4] = {0u, 0u, 0u, 0u};  // 8 bf16, two a word
    if (n < N) {
      const bf16* row = qkv + ((size_t)b * N + n) * C3;
      if (c < CQ) {  // q * scale
        const uint4 in = *reinterpret_cast<const uint4*>(row + h * DH + 8 * c);
        const __nv_bfloat162* i2 = reinterpret_cast<const __nv_bfloat162*>(&in);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(i2[i]);
          w[i] = pack_bf16(f.x * sc, f.y * sc);
        }
      } else if (c < CQ + CL) {  // rel lanes
        const int j = 8 * (c - CQ);
        const bf16* rr = rel + (((size_t)n * BB + b) * heads + h) * L;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l0 = j + 2 * i;
          w[i] = pack2(l0 < L ? rr[l0] : zero, l0 + 1 < L ? rr[l0 + 1] : zero);
        }
      } else if (c < 2 * CQ + CL) {  // g
        const bf16* gr = gs + 8 * (c - CQ - CL) * 65 + r;
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = pack2(gr[2 * i * 65], gr[(2 * i + 1) * 65]);
      } else {  // q, k, v as they are
        const int sec = (c - 2 * CQ - CL) / CQ, cc = c - 2 * CQ - CL - sec * CQ;
        const uint4 in = *reinterpret_cast<const uint4*>(row + (sec * heads + h) * DH + 8 * cc);
        w[0] = in.x;
        w[1] = in.y;
        w[2] = in.z;
        w[3] = in.w;
      }
    }
    *reinterpret_cast<uint4*>(tile + e * 8) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The query pass. aux: the prep pass's tiles; code: (NTP, LPC / 8, 64, 8),
// key k's lanes k / W and H + k % W set (rows past N zero). Writes dq into
// dqkv's q lanes, drel (N, BB, heads, L) and stats (BB heads, NTP 64, 4):
// [m (log2 units), 1 / l, t, 0] of each query row, zeros past N. Grid (NTP /
// 2, heads, BB), 384 threads. REG needs W = 64 and L = H + 64.
template <int DH, int LPC, bool REG, int ST>
__global__ void __launch_bounds__(AB_THREADS, 1) attn_bwd_query_kernel(
    const bf16* __restrict__ aux, const bf16* __restrict__ code, bf16* __restrict__ dqkv,
    bf16* __restrict__ drel, float* __restrict__ stats, int N, int NTP, int H, int L,
    int heads, float scale) {
  using D = AbDims<DH, LPC>;
  constexpr int CQ = D::CQ, CL = D::CL, CA = D::CA;
  constexpr int TA = CA * AB_CHUNK, TKV = 2 * CQ * AB_CHUNK, TC = CL * AB_CHUNK;
  constexpr int NR = REG ? 32 : LPC / 2;   // drel accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  bf16* sA = reinterpret_cast<bf16*>(smem);  // NWG x [CA][64][8]: q*scale, rel, g
  bf16* sKV = sA + AB_NWG * TA;              // [ST][2 CQ][64][8]: k, then v
  bf16* sC = sKV + ST * TKV;                 // not REG: [ST][CL][64][8], the keys' code
  float* sRh = reinterpret_cast<float*>(sC + (REG ? 0 : ST * TC));  // REG: NWG x [64][64]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sRh + (REG ? AB_NWG * AB_T * AB_T : 0));
  const MbarRing<ST> ring{qbar + 1, qbar + 1 + ST};

  const int tid = threadIdx.x, wg = tid / 128;
  const int tq = blockIdx.x * AB_NWG, h = blockIdx.y, b = blockIdx.z;  // first query tile
  const int n_tiles = (N + AB_T - 1) / AB_T;
  const bf16* tiles = aux + ((size_t)b * heads + h) * NTP * D::CT * AB_CHUNK;
  if (tid == 0) {
    mbar_init(qbar, 1);
    ring.init(AB_NWG);  // one arrival per consumer warpgroup
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == AB_NWG) {  // the producer warpgroup: one thread issues every load
    producer_regs();
    if (tid == AB_NWG * 128) {
      mbar_expect_tx(qbar, AB_NWG * TA * sizeof(bf16));
      for (int w = 0; w < AB_NWG; ++w)
        bulk_load(sA + w * TA, tiles + (size_t)(tq + w) * D::CT * AB_CHUNK, TA * sizeof(bf16),
                  qbar);
      for (int it = 0; it < 2 * n_tiles; ++it) {  // two sweeps over the keys
        const int t = it < n_tiles ? it : it - n_tiles;
        const int s = ring.acquire(it, (TKV + (REG ? 0 : TC)) * sizeof(bf16));
        bulk_load(sKV + s * TKV, tiles + ((size_t)t * D::CT + D::K) * AB_CHUNK,
                  TKV * sizeof(bf16), &ring.full[s]);
        if constexpr (!REG)
          bulk_load(sC + s * TC, code + (size_t)t * TC, TC * sizeof(bf16), &ring.full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  consumer_regs();
  const int ltid = tid % 128, lane = tid % 32;
  const int r_lo = (ltid / 32) * 16 + lane / 4, r_hi = r_lo + 8, c0 = 2 * (lane % 4);
  const bf16* qa = sA + wg * TA;                 // [q*scale | rel | g] of this warpgroup's rows
  const bf16* ga = qa + (CQ + CL) * AB_CHUNK;
  auto rel_at = [&](int r, int j) { return qa[((CQ + j / 8) * AB_T + r) * 8 + j % 8]; };
  mbar_wait(qbar, 0);
  uint32_t rw_lo[8], rw_hi[8];  // REG: rel_w at the thread's key columns 8j + c0 (+1)
  if constexpr (REG) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lw = H + 8 * j + c0;
      rw_lo[j] = pack2(rel_at(r_lo, lw), rel_at(r_lo, lw + 1));
      rw_hi[j] = pack2(rel_at(r_hi, lw), rel_at(r_hi, lw + 1));
    }
  }

  // S (biased, in log2 units; keys past N at -inf) of key tile t, slot s: the
  // chain of [q*scale | rel] against k's chunks, then (not REG) the code's;
  // dP = g . v^T is issued as a second group behind it and still in flight
  // on return (wgmma_wait<0> before dp is read), so that the softmax on S
  // overlaps it
  auto scores = [&](int s, int t, float (&sc)[32], float (&dp)[32]) {
    const bf16* kb = sKV + s * TKV;
    const bf16* vb = kb + CQ * AB_CHUNK;
    const bf16* cb = sC + s * TC;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < (REG ? CQ : CQ + CL) / 2; ++ks) {
      const bf16* kc = ks < CQ / 2 ? kb + ks * 2 * AB_CHUNK : cb + (ks - CQ / 2) * 2 * AB_CHUNK;
      Wgmma<64>::ss(sc, kmajor(qa + ks * 2 * AB_CHUNK), kmajor(kc), ks > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < CQ / 2; ++ks)
      Wgmma<64>::ss(dp, kmajor(ga + ks * 2 * AB_CHUNK), kmajor(vb + ks * 2 * AB_CHUNK), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    const int kv = N - t * AB_T;  // the tile's real keys
    float rh_lo = 0.f, rh_hi = 0.f;
    if constexpr (REG) {
      rh_lo = __bfloat162float(rel_at(r_lo, t));
      rh_hi = __bfloat162float(rel_at(r_hi, t));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a = sc[4 * j + e], c = sc[4 * j + 2 + e];
        if constexpr (REG) {
          a += rh_lo + (e ? hi_f(rw_lo[j]) : lo_f(rw_lo[j]));
          c += rh_hi + (e ? hi_f(rw_hi[j]) : lo_f(rw_hi[j]));
        }
        const bool in = 8 * j + c0 + e < kv;
        sc[4 * j + e] = in ? a * LOG2E : -INFINITY;
        sc[4 * j + 2 + e] = in ? c * LOG2E : -INFINITY;
      }
  };

  // sweep 1: the row max m, the row sum l and t = sum_k P dP, online
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f, t_lo = 0.f, t_hi = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = ring.wait(t);
    float sc[32], dp[32];
    scores(s, t, sc, dp);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo)), mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float corr_lo = exp2f(m_lo - mn_lo), corr_hi = exp2f(m_hi - mn_hi);
    float sl = 0.f, sh = 0.f, tl = 0.f, th = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - mn_lo);
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mn_hi);
        sl += sc[4 * j + e];
        sh += sc[4 * j + 2 + e];
      }
    wgmma_wait<0>();
    fence_regs(dp);
    if (ltid == 0) ring.release(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        tl += sc[4 * j + e] * dp[4 * j + e];
        th += sc[4 * j + 2 + e] * dp[4 * j + 2 + e];
      }
    l_lo = l_lo * corr_lo + sl;
    l_hi = l_hi * corr_hi + sh;
    t_lo = t_lo * corr_lo + tl;
    t_hi = t_hi * corr_hi + th;
    m_lo = mn_lo;
    m_hi = mn_hi;
  }
  const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
  t_lo = quad_sum(t_lo) * inv_lo;
  t_hi = quad_sum(t_hi) * inv_hi;

  // sweep 2: dS, dq += dS . k, drel
  float dq[DH / 2], dr[NR];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NR; ++i) dr[i] = 0.f;
  float* rh = sRh + wg * AB_T * AB_T;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = ring.wait(n_tiles + t);
    float sc[32], dp[32];
    scores(s, t, sc, dp);
    // sc <- dS = bf16(P (dP - t)), kept as the fp32 of its bf16 value
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - m_lo) * inv_lo;
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - m_hi) * inv_hi;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = round_bf16(sc[4 * j + e] * (dp[4 * j + e] - t_lo));
        const float dh = round_bf16(sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - t_hi));
        sc[4 * j + e] = dl;
        sc[4 * j + 2 + e] = dh;
        if constexpr (REG) {  // rel_w: the tile itself; rel_h: its row sum
          dr[4 * j + e] += dl;
          dr[4 * j + 2 + e] += dh;
          rs_lo += dl;
          rs_hi += dh;
        }
      }
    uint32_t da[4][4];
    to_a_frags(sc, da);
    const bf16* kb = sKV + s * TKV;
    wgmma_fence();
    fence_regs(dq);
    if constexpr (!REG) fence_regs(dr);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<DH>::rs(dq, da[ks], nmajor(kb + ks * 16 * 8), 1);
    if constexpr (!REG) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<LPC>::rs(dr, da[ks], nmajor(sC + s * TC + ks * 16 * 8), 1);
    }
    wgmma_commit();
    if constexpr (REG) {  // the tile is grid row t: its rel_h lane gets the row sums
      rs_lo = quad_sum(rs_lo);
      rs_hi = quad_sum(rs_hi);
      if (lane % 4 == 0) {
        rh[r_lo * AB_T + t] = rs_lo;
        rh[r_hi * AB_T + t] = rs_hi;
      }
    }
    wgmma_wait<0>();
    fence_regs(dq);
    if constexpr (!REG) fence_regs(dr);
    if (ltid == 0) ring.release(s);
  }
  if constexpr (REG) named_barrier(1 + wg, 128);  // rh written

  // epilogue: dq (scale * acc) into the packed q lanes, drel rows, statistics
  const int BB = gridDim.z;
  const size_t C3 = 3ull * heads * DH;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = hf ? r_hi : r_lo, q = (tq + wg) * AB_T + r;
    if (lane % 4 == 0)  // every row of the tile: the key pass reads zeros past N
      *reinterpret_cast<float4*>(stats + (((size_t)b * heads + h) * NTP * AB_T + q) * 4) =
          q >= N ? make_float4(0.f, 0.f, 0.f, 0.f)
          : hf   ? make_float4(m_hi, inv_hi, t_hi, 0.f)
                 : make_float4(m_lo, inv_lo, t_lo, 0.f);
    if (q >= N) continue;
    bf16* row = dqkv + ((size_t)b * N + q) * C3 + h * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) =
          __floats2bfloat162_rn(scale * dq[4 * j + 2 * hf], scale * dq[4 * j + 2 * hf + 1]);
    bf16* rrow = drel + (((size_t)q * BB + b) * heads + h) * L;
    if constexpr (REG) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          rrow[H + 8 * j + c0 + e] = __float2bfloat16(dr[4 * j + 2 * hf + e]);
      for (int jh = lane % 4; jh < H; jh += 4) rrow[jh] = __float2bfloat16(rh[r * AB_T + jh]);
    } else {
#pragma unroll
      for (int j = 0; j < LPC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lj = 8 * j + c0 + e;
          if (lj < L) rrow[lj] = __float2bfloat16(dr[4 * j + 2 * hf + e]);
        }
    }
  }
}

// The key pass. aux, code: as the query pass; stats its (BB heads, NTP 64, 4).
// Writes dk and dv into dqkv's k and v lanes. Grid (NTP / 2, heads, BB), 384
// threads.
template <int DH, int LPC, int ST>
__global__ void __launch_bounds__(AB_THREADS, 1) attn_bwd_key_kernel(
    const bf16* __restrict__ aux, const bf16* __restrict__ code, const float* __restrict__ stats,
    bf16* __restrict__ dqkv, int N, int NTP, int heads, float scale) {
  using D = AbDims<DH, LPC>;
  constexpr int CQ = D::CQ, CL = D::CL;
  constexpr int TKP = (CQ + CL) * AB_CHUNK, TV = CQ * AB_CHUNK, TQ = D::K * AB_CHUNK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  bf16* sKp = reinterpret_cast<bf16*>(smem);  // NWG x [CQ + CL][64][8]: k, then its code
  bf16* sV = sKp + AB_NWG * TKP;              // NWG x [CQ][64][8]
  bf16* sA = sV + AB_NWG * TV;                // [ST][3 CQ + CL][64][8]: q*scale, rel, g, q
  float* sSt = reinterpret_cast<float*>(sA + ST * TQ);  // [ST][64][4]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sSt + ST * AB_T * 4);
  const MbarRing<ST> ring{kvbar + 1, kvbar + 1 + ST};

  const int tid = threadIdx.x, wg = tid / 128;
  const int tk = blockIdx.x * AB_NWG, h = blockIdx.y, b = blockIdx.z;  // first key tile
  const int n_tiles = (N + AB_T - 1) / AB_T;
  const bf16* tiles = aux + ((size_t)b * heads + h) * NTP * D::CT * AB_CHUNK;
  const float* st_rows = stats + ((size_t)b * heads + h) * NTP * AB_T * 4;
  if (tid == 0) {
    mbar_init(kvbar, 1);
    ring.init(AB_NWG);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == AB_NWG) {  // the producer warpgroup: one thread issues every load
    producer_regs();
    if (tid == AB_NWG * 128) {
      mbar_expect_tx(kvbar, AB_NWG * (TKP + TV) * sizeof(bf16));
      for (int w = 0; w < AB_NWG; ++w) {
        const bf16* kt = tiles + (size_t)(tk + w) * D::CT * AB_CHUNK;
        bulk_load(sKp + w * TKP, kt + D::K * AB_CHUNK, TV * sizeof(bf16), kvbar);
        bulk_load(sKp + w * TKP + CQ * AB_CHUNK, code + (size_t)(tk + w) * CL * AB_CHUNK,
                  CL * AB_CHUNK * sizeof(bf16), kvbar);
        bulk_load(sV + w * TV, kt + D::V * AB_CHUNK, TV * sizeof(bf16), kvbar);
      }
      for (int u = 0; u < n_tiles; ++u) {
        const int s = ring.acquire(u, TQ * sizeof(bf16) + AB_T * 4 * sizeof(float));
        bulk_load(sA + s * TQ, tiles + (size_t)u * D::CT * AB_CHUNK, TQ * sizeof(bf16),
                  &ring.full[s]);
        bulk_load(sSt + s * AB_T * 4, st_rows + (size_t)u * AB_T * 4, AB_T * 4 * sizeof(float),
                  &ring.full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  consumer_regs();
  const int ltid = tid % 128, lane = tid % 32;
  const int r_lo = (ltid / 32) * 16 + lane / 4, r_hi = r_lo + 8, c0 = 2 * (lane % 4);
  const bf16* kp = sKp + wg * TKP;
  const bf16* vw = sV + wg * TV;
  mbar_wait(kvbar, 0);
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  for (int u = 0; u < n_tiles; ++u) {
    const int s = ring.wait(u);
    const bf16* qa = sA + s * TQ;                  // [q*scale | rel | g | q] of the tile's queries
    const bf16* ga = qa + D::G * AB_CHUNK;
    const bf16* qu = qa + D::QU * AB_CHUNK;
    const float4* st = reinterpret_cast<const float4*>(sSt + s * AB_T * 4);
    // S^T = [k | code] . [q*scale | rel]^T and dP^T = v . g^T: keys as rows
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < (CQ + CL) / 2; ++ks)
      Wgmma<64>::ss(sc, kmajor(kp + ks * 2 * AB_CHUNK), kmajor(qa + ks * 2 * AB_CHUNK), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < CQ / 2; ++ks)
      Wgmma<64>::ss(dp, kmajor(vw + ks * 2 * AB_CHUNK), kmajor(ga + ks * 2 * AB_CHUNK), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S^T; dP^T still in flight
    fence_regs(sc);
    // P^T from the columns' (queries') m and 1 / l, then dS^T with their t
    float tq[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 sq = st[8 * j + c0 + e];
        tq[2 * j + e] = sq.z;
        sc[4 * j + e] = exp2f(sc[4 * j + e] * LOG2E - sq.x) * sq.y;
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] * LOG2E - sq.x) * sq.y;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * j + e] = round_bf16(sc[4 * j + e] * (dp[4 * j + e] - tq[2 * j + e]));
        dp[4 * j + 2 + e] = round_bf16(sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - tq[2 * j + e]));
        sc[4 * j + e] = round_bf16(sc[4 * j + e]);
        sc[4 * j + 2 + e] = round_bf16(sc[4 * j + 2 + e]);
      }
    uint32_t pa[4][4], da[4][4];
    to_a_frags(sc, pa);
    to_a_frags(dp, da);
    // dv += P^T . g, dk += dS^T . q
    wgmma_fence();
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      Wgmma<DH>::rs(dv, pa[ks], nmajor(ga + ks * 16 * 8), 1);
      Wgmma<DH>::rs(dk, da[ks], nmajor(qu + ks * 16 * 8), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (ltid == 0) ring.release(s);
  }

  // epilogue: dk (scale * acc) and dv into the packed k and v lanes
  const size_t C3 = 3ull * heads * DH;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int k = (tk + wg) * AB_T + (hf ? r_hi : r_lo);
    if (k >= N) continue;
    bf16* row = dqkv + ((size_t)b * N + k) * C3;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + (heads + h) * DH + 8 * j + c0) =
          __floats2bfloat162_rn(scale * dk[4 * j + 2 * hf], scale * dk[4 * j + 2 * hf + 1]);
      *reinterpret_cast<__nv_bfloat162*>(row + (2 * heads + h) * DH + 8 * j + c0) =
          __floats2bfloat162_rn(dv[4 * j + 2 * hf], dv[4 * j + 2 * hf + 1]);
    }
  }
}

struct AbArgs {
  const void *qkv, *rel, *g, *code;
  void *dqkv, *drel, *aux, *stats;
  int BB, N, NTP, H, L, heads;
  float scale;
  int W;  // the wide path's grid width
};

template <int DH, int LPC, bool REG>
int launch_attn_bwd(const AbArgs& a, cudaStream_t s) {
  constexpr int QST = abq_stages(DH, LPC, REG), KST = abk_stages(DH, LPC);
  constexpr size_t qsm = abq_smem(DH, LPC, REG, QST), ksm = abk_smem(DH, LPC, KST);
  static_assert(qsm <= AB_SMEM_MAX && ksm <= AB_SMEM_MAX, "shared memory of one block");
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_query_kernel<DH, LPC, REG, QST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)qsm);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_bwd_key_kernel<DH, LPC, KST>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ksm);
  if (e != cudaSuccess) return (int)e;
  const int NTP = a.NTP;
  bf16* aux = static_cast<bf16*>(a.aux);
  const bf16* code = static_cast<const bf16*>(a.code);
  attn_bwd_prep_kernel<<<dim3(NTP, a.heads, a.BB), 256, 0, s>>>(
      static_cast<const bf16*>(a.qkv), static_cast<const bf16*>(a.rel),
      static_cast<const bf16*>(a.g), aux, a.N, NTP, a.L, LPC, a.heads, DH, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(NTP / AB_NWG, a.heads, a.BB);
  attn_bwd_query_kernel<DH, LPC, REG, QST><<<grid, AB_THREADS, qsm, s>>>(
      aux, code, static_cast<bf16*>(a.dqkv), static_cast<bf16*>(a.drel),
      static_cast<float*>(a.stats), a.N, NTP, a.H, a.L, a.heads, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_key_kernel<DH, LPC, KST><<<grid, AB_THREADS, ksm, s>>>(
      aux, code, static_cast<const float*>(a.stats), static_cast<bf16*>(a.dqkv), a.N, NTP,
      a.heads, a.scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the wide path
// Grids of H + W > 128 rel lanes (lpc 256, 384 or 512: #18's global blocks
// past the 64 x 64 grid, images past 1024 px). The code chain above would
// hold a query row's lpc lanes and a key's code in shared memory and drel's
// lpc lanes in registers; at 512 lanes neither fits. This path takes the
// register path's idea to any grid: the key tiles are cut along the grid, so
// that a tile holds 64 keys of one grid line. Of the grid's two sides, B is
// the shorter (at most 256 lanes) and A the longer: key tile (b, c) holds the
// keys of line b whose A index is 64c .. 64c + 63 (rows past A zero and
// masked). So a key tile adds one rel_B lane and 64 consecutive rel_A lanes
// to its scores.
//   prep: the query tiles as before, per row [q*scale | rel_A lanes to 64 nc
//     | rel_B lanes to a multiple of 16 | g | q], and after them the key
//     tiles [k | v] in the grid's order (c major, then b).
//   the query pass (query tiles of 128 rows, as before): the producer streams
//     the key tiles c by c; the bias is added in registers (the thread's 16
//     rel_A values of chunk c, read once a chunk, and one rel_B value a tile
//     and row); dq += dS . k by wgmma; drel_A: dS itself into a 64-wide fp32
//     accumulator of the score layout, written out when chunk c has seen
//     every line; drel_B: the row sums of dS into an fp32 [64][B] array of
//     shared memory per warpgroup, added c by c, written at the end. B <= 256
//     keeps it within 64 KB a warpgroup.
//   the key pass (two key tiles (b, c), (b + 1, c) a block, b even): the
//     producer streams the query tiles' [q*scale | rel_A chunk c | the 16
//     rel_B lanes around b | g | q] (four bulk copies a tile), and the scores
//     come from the chain [k | code] . [q*scale | those 80 lanes]^T, where
//     the code (one of 16 tiles from the wrapper) is one-hot at the key's
//     row and at lane 64 + b % 16.
// Keys past a side's end cost work: 64 ceil(A / 64) keys a line are streamed
// where A are real (1.6x at A = 80, none at 128).
struct AbWide {
  int nA, nB, offA, offB, sA, sB;  // each side's lanes and first lane; key = b sB + a sA
  int nc, nBe, CR;  // 64-lane chunks of A, B lines rounded up to even, rel columns
};

inline AbWide ab_wide(int H, int W) {
  AbWide w;
  if (H <= W) {
    w.nB = H, w.offB = 0, w.sB = W, w.nA = W, w.offA = H, w.sA = 1;
  } else {
    w.nB = W, w.offB = H, w.sB = 1, w.nA = H, w.offA = 0, w.sA = W;
  }
  w.nc = (w.nA + AB_T - 1) / AB_T;
  w.nBe = w.nB + (w.nB & 1);
  w.CR = 8 * w.nc + 2 * ((w.nB + 15) / 16);
  return w;
}

// 16-byte columns of the code tiles: rel_A chunk (8) and the rel_B lanes (2)
constexpr int ABW_CC = 10;

// the query pass: NWG [q*scale | g] tiles, an st-stage ring of [k | v] tiles,
// NWG fp32 [64][nBp] rel_B gradients, barriers
constexpr size_t abw_query_smem(int dh, int nBp, int st) {
  return 128 + sizeof(bf16) * AB_CHUNK * (size_t)((AB_NWG + st) * 2 * dh / 8) +
         sizeof(float) * AB_NWG * AB_T * nBp + sizeof(uint64_t) * (1 + 2 * st);
}
// the key pass: NWG [k | code] and v tiles, an st-stage ring of query tiles
// ([q*scale | rel_A chunk | rel_B lanes | g | q] and the statistics), barriers
constexpr size_t abw_key_smem(int dh, int st) {
  return 128 +
         sizeof(bf16) * AB_CHUNK *
             (size_t)(AB_NWG * (2 * dh / 8 + ABW_CC) + st * (3 * dh / 8 + ABW_CC)) +
         sizeof(float) * 4 * AB_T * st + sizeof(uint64_t) * (1 + 2 * st);
}
// ring stages: 3, 2 or 1, the most that 227 KB hold (0: none)
constexpr int abw_query_stages(int dh, int nBp) {
  return abw_query_smem(dh, nBp, 3) <= AB_SMEM_MAX   ? 3
         : abw_query_smem(dh, nBp, 2) <= AB_SMEM_MAX ? 2
         : abw_query_smem(dh, nBp, 1) <= AB_SMEM_MAX ? 1
                                                     : 0;
}
constexpr int abw_key_stages(int dh) { return abw_key_smem(dh, 3) <= AB_SMEM_MAX ? 3 : 2; }

// aux of the wide path per (image, head): NTP query tiles of CQT = 3 CQ + CR
// columns, then nBe nc key tiles of 2 CQ columns (tile c nBe + b)
__host__ __device__ inline size_t abw_aux_chunks(int NTP, int CQ, const AbWide& w) {
  return (size_t)NTP * (3 * CQ + w.CR) + (size_t)w.nBe * w.nc * 2 * CQ;
}

// Grid (NTP + nBe nc, heads, BB), 256 threads: block x < NTP writes query
// tile x, the others key tile x - NTP.
__global__ void __launch_bounds__(256) attn_bwd_wide_prep_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ rel, const bf16* __restrict__ g,
    bf16* __restrict__ aux, int N, int NTP, int L, int heads, int DH, float scale, AbWide wd) {
  __shared__ bf16 gs[128 * 65];  // [c][64 rows + 1]
  const int x = blockIdx.x, h = blockIdx.y, b = blockIdx.z, BB = gridDim.z;
  const int CQ = DH / 8, CQT = 3 * CQ + wd.CR, CA = AB_T * wd.nc;  // CA: rel_A lanes
  const size_t C3 = 3ull * heads * DH;
  bf16* base = aux + ((size_t)b * heads + h) * abw_aux_chunks(NTP, CQ, wd) * AB_CHUNK;
  if (x >= NTP) {  // key tile (bk, c): [k | v] of the keys bk sB + (64 c + r) sA
    const int kt = x - NTP, c = kt / wd.nBe, bk = kt - c * wd.nBe;
    bf16* tile = base + ((size_t)NTP * CQT + (size_t)kt * 2 * CQ) * AB_CHUNK;
    for (int e = threadIdx.x; e < 2 * CQ * AB_T; e += 256) {
      const int cc = e / AB_T, r = e - cc * AB_T, a = AB_T * c + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (bk < wd.nB && a < wd.nA) {
        const int n = bk * wd.sB + a * wd.sA, sec = 1 + cc / CQ;  // k, then v
        v = *reinterpret_cast<const uint4*>(qkv + ((size_t)b * N + n) * C3 +
                                            (sec * heads + h) * DH + 8 * (cc % CQ));
      }
      *reinterpret_cast<uint4*>(tile + e * 8) = v;
    }
    return;
  }
  const int t = x, n0 = t * AB_T;
  const bf16* gb = g + ((size_t)b * heads + h) * DH * N;
  for (int e = threadIdx.x; e < DH * AB_T; e += 256) {
    const int c = e / AB_T, nl = e % AB_T, n = n0 + nl;
    gs[c * 65 + nl] = n < N ? gb[(size_t)c * N + n] : __float2bfloat16(0.f);
  }
  __syncthreads();
  const float sc = __bfloat162float(__float2bfloat16(scale));  // the scale in bf16
  bf16* tile = base + (size_t)t * CQT * AB_CHUNK;
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < CQT * AB_T; e += 256) {
    const int c = e / AB_T, r = e - c * AB_T, n = n0 + r;
    uint32_t w[4] = {0u, 0u, 0u, 0u};  // 8 bf16, two a word
    if (n < N) {
      const bf16* row = qkv + ((size_t)b * N + n) * C3;
      if (c < CQ) {  // q * scale
        const uint4 in = *reinterpret_cast<const uint4*>(row + h * DH + 8 * c);
        const __nv_bfloat162* i2 = reinterpret_cast<const __nv_bfloat162*>(&in);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(i2[i]);
          w[i] = pack_bf16(f.x * sc, f.y * sc);
        }
      } else if (c < CQ + wd.CR) {  // rel_A lanes to 64 nc, then rel_B's
        const int j = 8 * (c - CQ);
        const bool sideA = j < CA;
        const int j0 = sideA ? j : j - CA, cnt = sideA ? wd.nA : wd.nB;
        const bf16* rr =
            rel + (((size_t)n * BB + b) * heads + h) * L + (sideA ? wd.offA : wd.offB);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l0 = j0 + 2 * i;
          w[i] = pack2(l0 < cnt ? rr[l0] : zero, l0 + 1 < cnt ? rr[l0 + 1] : zero);
        }
      } else if (c < 2 * CQ + wd.CR) {  // g
        const bf16* gr = gs + 8 * (c - CQ - wd.CR) * 65 + r;
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = pack2(gr[2 * i * 65], gr[(2 * i + 1) * 65]);
      } else {  // q as it is
        const uint4 in =
            *reinterpret_cast<const uint4*>(row + h * DH + 8 * (c - 2 * CQ - wd.CR));
        w[0] = in.x;
        w[1] = in.y;
        w[2] = in.z;
        w[3] = in.w;
      }
    }
    *reinterpret_cast<uint4*>(tile + e * 8) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The wide query pass. Writes dq, drel and stats as the query pass above.
// Grid (NTP / 2, heads, BB), 384 threads.
template <int DH, int ST>
__global__ void __launch_bounds__(AB_THREADS, 1) attn_bwd_wide_query_kernel(
    const bf16* __restrict__ aux, const bf16* __restrict__ rel, bf16* __restrict__ dqkv,
    bf16* __restrict__ drel, float* __restrict__ stats, int N, int NTP, int L, int heads,
    float scale, AbWide wd) {
  constexpr int CQ = DH / 8, TQ = CQ * AB_CHUNK, TKV = 2 * TQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const int nBp = 16 * ((wd.nB + 15) / 16);
  bf16* sA = reinterpret_cast<bf16*>(smem);  // NWG x [CQ q*scale | CQ g][64][8]
  bf16* sKV = sA + AB_NWG * 2 * TQ;          // [ST][2 CQ][64][8]: k, then v
  float* sRb = reinterpret_cast<float*>(sKV + ST * TKV);  // NWG x [64][nBp]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sRb + AB_NWG * AB_T * nBp);
  const MbarRing<ST> ring{qbar + 1, qbar + 1 + ST};

  const int tid = threadIdx.x, wg = tid / 128;
  const int tq = blockIdx.x * AB_NWG, h = blockIdx.y, b = blockIdx.z, BB = gridDim.z;
  const int CQT = 3 * CQ + wd.CR, n_keys = wd.nB * wd.nc;  // key tiles a sweep
  const bf16* qtiles = aux + ((size_t)b * heads + h) * abw_aux_chunks(NTP, CQ, wd) * AB_CHUNK;
  const bf16* kvtiles = qtiles + (size_t)NTP * CQT * AB_CHUNK;
  if (tid == 0) {
    mbar_init(qbar, 1);
    ring.init(AB_NWG);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == AB_NWG) {  // the producer warpgroup: one thread issues every load
    producer_regs();
    if (tid == AB_NWG * 128) {
      mbar_expect_tx(qbar, AB_NWG * 2 * TQ * sizeof(bf16));
      for (int w = 0; w < AB_NWG; ++w) {
        const bf16* qt = qtiles + (size_t)(tq + w) * CQT * AB_CHUNK;
        bulk_load(sA + w * 2 * TQ, qt, TQ * sizeof(bf16), qbar);
        bulk_load(sA + w * 2 * TQ + TQ, qt + (size_t)(CQ + wd.CR) * AB_CHUNK, TQ * sizeof(bf16),
                  qbar);
      }
      for (int it = 0; it < 2 * n_keys; ++it) {  // two sweeps over the keys, c by c
        const int i = it < n_keys ? it : it - n_keys, c = i / wd.nB, bk = i - c * wd.nB;
        const int s = ring.acquire(it, TKV * sizeof(bf16));
        bulk_load(sKV + s * TKV, kvtiles + (size_t)(c * wd.nBe + bk) * TKV, TKV * sizeof(bf16),
                  &ring.full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  consumer_regs();
  const int ltid = tid % 128, lane = tid % 32;
  const int r_lo = (ltid / 32) * 16 + lane / 4, r_hi = r_lo + 8, c0 = 2 * (lane % 4);
  const bf16* qa = sA + wg * 2 * TQ;  // [q*scale | g] of this warpgroup's rows
  const bf16* ga = qa + TQ;
  float* rb = sRb + wg * AB_T * nBp;
  for (int i = ltid; i < AB_T * nBp; i += 128) rb[i] = 0.f;
  named_barrier(1 + wg, 128);
  const int q_lo = (tq + wg) * AB_T + r_lo, q_hi = q_lo + 8;
  // the rows' rel lanes (rows past N read as zeros)
  const bf16* rel_lo = q_lo < N ? rel + (((size_t)q_lo * BB + b) * heads + h) * L : nullptr;
  const bf16* rel_hi = q_hi < N ? rel + (((size_t)q_hi * BB + b) * heads + h) * L : nullptr;
  const bf16 zero = __float2bfloat16(0.f);
  auto rel_at = [&](const bf16* row, int j) { return row ? row[j] : zero; };
  uint32_t ra_lo[8], ra_hi[8];  // rel_A of chunk c at the thread's key columns 8j + c0 (+1)
  auto load_ra = [&](int c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int a = AB_T * c + 8 * j + c0;
      const bf16 l0 = a < wd.nA ? rel_at(rel_lo, wd.offA + a) : zero;
      const bf16 l1 = a + 1 < wd.nA ? rel_at(rel_lo, wd.offA + a + 1) : zero;
      const bf16 h0 = a < wd.nA ? rel_at(rel_hi, wd.offA + a) : zero;
      const bf16 h1 = a + 1 < wd.nA ? rel_at(rel_hi, wd.offA + a + 1) : zero;
      ra_lo[j] = pack2(l0, l1);
      ra_hi[j] = pack2(h0, h1);
    }
  };
  mbar_wait(qbar, 0);

  // S of the key tile in slot s (biased, log2 units; keys past A at -inf),
  // with dP = g . v^T issued behind it and still in flight on return
  auto scores = [&](int s, int kv, float rb_lo, float rb_hi, float (&sc)[32], float (&dp)[32]) {
    const bf16* kb = sKV + s * TKV;
    const bf16* vb = kb + TQ;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CQ / 2; ++ks)
      Wgmma<64>::ss(sc, kmajor(qa + ks * 2 * AB_CHUNK), kmajor(kb + ks * 2 * AB_CHUNK), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < CQ / 2; ++ks)
      Wgmma<64>::ss(dp, kmajor(ga + ks * 2 * AB_CHUNK), kmajor(vb + ks * 2 * AB_CHUNK), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = sc[4 * j + e] + (rb_lo + (e ? hi_f(ra_lo[j]) : lo_f(ra_lo[j])));
        const float c = sc[4 * j + 2 + e] + (rb_hi + (e ? hi_f(ra_hi[j]) : lo_f(ra_hi[j])));
        const bool in = 8 * j + c0 + e < kv;
        sc[4 * j + e] = in ? a * LOG2E : -INFINITY;
        sc[4 * j + 2 + e] = in ? c * LOG2E : -INFINITY;
      }
  };

  // sweep 1: the row max m, the row sum l and t = sum_k P dP, online
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f, t_lo = 0.f, t_hi = 0.f;
  for (int i = 0; i < n_keys; ++i) {
    const int c = i / wd.nB, bk = i - c * wd.nB;
    if (bk == 0) load_ra(c);
    const float rb_lo = __bfloat162float(rel_at(rel_lo, wd.offB + bk));
    const float rb_hi = __bfloat162float(rel_at(rel_hi, wd.offB + bk));
    const int s = ring.wait(i);
    float sc[32], dp[32];
    scores(s, wd.nA - AB_T * c, rb_lo, rb_hi, sc, dp);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo)), mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float corr_lo = exp2f(m_lo - mn_lo), corr_hi = exp2f(m_hi - mn_hi);
    float sl = 0.f, sh = 0.f, tl = 0.f, th = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - mn_lo);
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mn_hi);
        sl += sc[4 * j + e];
        sh += sc[4 * j + 2 + e];
      }
    wgmma_wait<0>();
    fence_regs(dp);
    if (ltid == 0) ring.release(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        tl += sc[4 * j + e] * dp[4 * j + e];
        th += sc[4 * j + 2 + e] * dp[4 * j + 2 + e];
      }
    l_lo = l_lo * corr_lo + sl;
    l_hi = l_hi * corr_hi + sh;
    t_lo = t_lo * corr_lo + tl;
    t_hi = t_hi * corr_hi + th;
    m_lo = mn_lo;
    m_hi = mn_hi;
  }
  const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
  t_lo = quad_sum(t_lo) * inv_lo;
  t_hi = quad_sum(t_hi) * inv_hi;

  // sweep 2: dS, dq += dS . k, drel_A (a chunk at a time), drel_B (row sums)
  float dq[DH / 2], dr[32];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) dr[i] = 0.f;
  for (int i = 0; i < n_keys; ++i) {
    const int c = i / wd.nB, bk = i - c * wd.nB;
    if (bk == 0) load_ra(c);
    const float rb_lo = __bfloat162float(rel_at(rel_lo, wd.offB + bk));
    const float rb_hi = __bfloat162float(rel_at(rel_hi, wd.offB + bk));
    const int s = ring.wait(n_keys + i);
    float sc[32], dp[32];
    scores(s, wd.nA - AB_T * c, rb_lo, rb_hi, sc, dp);
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - m_lo) * inv_lo;
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - m_hi) * inv_hi;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = round_bf16(sc[4 * j + e] * (dp[4 * j + e] - t_lo));
        const float dh = round_bf16(sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - t_hi));
        sc[4 * j + e] = dl;
        sc[4 * j + 2 + e] = dh;
        dr[4 * j + e] += dl;
        dr[4 * j + 2 + e] += dh;
        rs_lo += dl;
        rs_hi += dh;
      }
    uint32_t da[4][4];
    to_a_frags(sc, da);
    const bf16* kb = sKV + s * TKV;
    wgmma_fence();
    fence_regs(dq);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<DH>::rs(dq, da[ks], nmajor(kb + ks * 16 * 8), 1);
    wgmma_commit();
    rs_lo = quad_sum(rs_lo);
    rs_hi = quad_sum(rs_hi);
    if (lane % 4 == 0) {  // line bk's rel_B lane, chunk c's share
      rb[r_lo * nBp + bk] += rs_lo;
      rb[r_hi * nBp + bk] += rs_hi;
    }
    wgmma_wait<0>();
    fence_regs(dq);
    if (ltid == 0) ring.release(s);
    if (bk == wd.nB - 1) {  // chunk c has seen every line: its rel_A lanes
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int q = hf ? q_hi : q_lo;
        if (q < N) {
          bf16* rrow = drel + (((size_t)q * BB + b) * heads + h) * L + wd.offA;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int a = AB_T * c + 8 * j + c0 + e;
              if (a < wd.nA) rrow[a] = __float2bfloat16(dr[4 * j + 2 * hf + e]);
            }
        }
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) dr[k] = 0.f;
    }
  }
  named_barrier(1 + wg, 128);  // rb written

  // epilogue: dq (scale * acc), the rel_B lanes, statistics
  const size_t C3 = 3ull * heads * DH;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = hf ? r_hi : r_lo, q = hf ? q_hi : q_lo;
    if (lane % 4 == 0)  // every row of the tile: the key pass reads zeros past N
      *reinterpret_cast<float4*>(stats + (((size_t)b * heads + h) * NTP * AB_T + q) * 4) =
          q >= N ? make_float4(0.f, 0.f, 0.f, 0.f)
          : hf   ? make_float4(m_hi, inv_hi, t_hi, 0.f)
                 : make_float4(m_lo, inv_lo, t_lo, 0.f);
    if (q >= N) continue;
    bf16* row = dqkv + ((size_t)b * N + q) * C3 + h * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) =
          __floats2bfloat162_rn(scale * dq[4 * j + 2 * hf], scale * dq[4 * j + 2 * hf + 1]);
    bf16* rrow = drel + (((size_t)q * BB + b) * heads + h) * L + wd.offB;
    for (int jb = lane % 4; jb < wd.nB; jb += 4) rrow[jb] = __float2bfloat16(rb[r * nBp + jb]);
  }
}

// The wide key pass. code: 16 tiles [10][64][8], tile j one-hot at lanes
// (key row) and 64 + j. Writes dk and dv. Grid (nBe / 2 nc, heads, BB), 384
// threads: block x takes key tiles (2 (x / nc) + wg, x % nc).
template <int DH, int ST>
__global__ void __launch_bounds__(AB_THREADS, 1) attn_bwd_wide_key_kernel(
    const bf16* __restrict__ aux, const bf16* __restrict__ code, const float* __restrict__ stats,
    bf16* __restrict__ dqkv, int N, int NTP, int heads, float scale, AbWide wd) {
  constexpr int CQ = DH / 8, CK = CQ + ABW_CC;  // [k | code], [q*scale | 80 lanes]
  constexpr int TV = CQ * AB_CHUNK, TKP = CK * AB_CHUNK, TS = (CK + 2 * CQ) * AB_CHUNK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  bf16* sKp = reinterpret_cast<bf16*>(smem);  // NWG x [CQ + 10][64][8]: k, then its code
  bf16* sV = sKp + AB_NWG * TKP;              // NWG x [CQ][64][8]
  bf16* sA = sV + AB_NWG * TV;  // [ST][3 CQ + 10][64][8]: q*scale, rel lanes, g, q
  float* sSt = reinterpret_cast<float*>(sA + ST * TS);  // [ST][64][4]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sSt + ST * AB_T * 4);
  const MbarRing<ST> ring{kvbar + 1, kvbar + 1 + ST};

  const int tid = threadIdx.x, wg = tid / 128;
  const int c = blockIdx.x % wd.nc, b0 = 2 * (blockIdx.x / wd.nc), h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (N + AB_T - 1) / AB_T, CQT = 3 * CQ + wd.CR;
  const bf16* qtiles = aux + ((size_t)b * heads + h) * abw_aux_chunks(NTP, CQ, wd) * AB_CHUNK;
  const bf16* kvtiles = qtiles + (size_t)NTP * CQT * AB_CHUNK;
  const float* st_rows = stats + ((size_t)b * heads + h) * NTP * AB_T * 4;
  if (tid == 0) {
    mbar_init(kvbar, 1);
    ring.init(AB_NWG);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == AB_NWG) {  // the producer warpgroup: one thread issues every load
    producer_regs();
    if (tid == AB_NWG * 128) {
      mbar_expect_tx(kvbar, AB_NWG * (TKP + TV) * sizeof(bf16));
      for (int w = 0; w < AB_NWG; ++w) {
        const bf16* kt = kvtiles + (size_t)(c * wd.nBe + b0 + w) * 2 * TV;
        bulk_load(sKp + w * TKP, kt, TV * sizeof(bf16), kvbar);
        bulk_load(sKp + w * TKP + TV, code + (size_t)((b0 + w) % 16) * ABW_CC * AB_CHUNK,
                  ABW_CC * AB_CHUNK * sizeof(bf16), kvbar);
        bulk_load(sV + w * TV, kt + TV, TV * sizeof(bf16), kvbar);
      }
      const int colA = CQ + 8 * c, colB = CQ + 8 * wd.nc + 2 * (b0 / 16);
      for (int u = 0; u < n_tiles; ++u) {
        const int s = ring.acquire(u, TS * sizeof(bf16) + AB_T * 4 * sizeof(float));
        const bf16* qt = qtiles + (size_t)u * CQT * AB_CHUNK;
        bf16* dst = sA + s * TS;
        bulk_load(dst, qt, TV * sizeof(bf16), &ring.full[s]);
        bulk_load(dst + TV, qt + (size_t)colA * AB_CHUNK, 8 * AB_CHUNK * sizeof(bf16),
                  &ring.full[s]);
        bulk_load(dst + TV + 8 * AB_CHUNK, qt + (size_t)colB * AB_CHUNK,
                  2 * AB_CHUNK * sizeof(bf16), &ring.full[s]);
        bulk_load(dst + TKP, qt + (size_t)(CQ + wd.CR) * AB_CHUNK, 2 * TV * sizeof(bf16),
                  &ring.full[s]);
        bulk_load(sSt + s * AB_T * 4, st_rows + (size_t)u * AB_T * 4, AB_T * 4 * sizeof(float),
                  &ring.full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  consumer_regs();
  const int ltid = tid % 128, lane = tid % 32;
  const int r_lo = (ltid / 32) * 16 + lane / 4, r_hi = r_lo + 8, c0 = 2 * (lane % 4);
  const bf16* kp = sKp + wg * TKP;
  const bf16* vw = sV + wg * TV;
  mbar_wait(kvbar, 0);
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  for (int u = 0; u < n_tiles; ++u) {
    const int s = ring.wait(u);
    const bf16* qa = sA + s * TS;  // [q*scale | rel lanes | g | q] of the tile's queries
    const bf16* ga = qa + TKP;
    const bf16* qu = ga + TV;
    const float4* st = reinterpret_cast<const float4*>(sSt + s * AB_T * 4);
    // S^T = [k | code] . [q*scale | rel lanes]^T and dP^T = v . g^T: keys as rows
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CK / 2; ++ks)
      Wgmma<64>::ss(sc, kmajor(kp + ks * 2 * AB_CHUNK), kmajor(qa + ks * 2 * AB_CHUNK), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < CQ / 2; ++ks)
      Wgmma<64>::ss(dp, kmajor(vw + ks * 2 * AB_CHUNK), kmajor(ga + ks * 2 * AB_CHUNK), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S^T; dP^T still in flight
    fence_regs(sc);
    float tq[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 sq = st[8 * j + c0 + e];
        tq[2 * j + e] = sq.z;
        sc[4 * j + e] = exp2f(sc[4 * j + e] * LOG2E - sq.x) * sq.y;
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] * LOG2E - sq.x) * sq.y;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * j + e] = round_bf16(sc[4 * j + e] * (dp[4 * j + e] - tq[2 * j + e]));
        dp[4 * j + 2 + e] = round_bf16(sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - tq[2 * j + e]));
        sc[4 * j + e] = round_bf16(sc[4 * j + e]);
        sc[4 * j + 2 + e] = round_bf16(sc[4 * j + 2 + e]);
      }
    uint32_t pa[4][4], da[4][4];
    to_a_frags(sc, pa);
    to_a_frags(dp, da);
    wgmma_fence();
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      Wgmma<DH>::rs(dv, pa[ks], nmajor(ga + ks * 16 * 8), 1);
      Wgmma<DH>::rs(dk, da[ks], nmajor(qu + ks * 16 * 8), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (ltid == 0) ring.release(s);
  }

  // epilogue: dk (scale * acc) and dv into the packed k and v lanes of the tile's keys
  const int bk = b0 + wg;
  if (bk >= wd.nB) return;
  const size_t C3 = 3ull * heads * DH;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int a = AB_T * c + (hf ? r_hi : r_lo);
    if (a >= wd.nA) continue;
    bf16* row = dqkv + ((size_t)b * N + (size_t)bk * wd.sB + (size_t)a * wd.sA) * C3;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + (heads + h) * DH + 8 * j + c0) =
          __floats2bfloat162_rn(scale * dk[4 * j + 2 * hf], scale * dk[4 * j + 2 * hf + 1]);
      *reinterpret_cast<__nv_bfloat162*>(row + (2 * heads + h) * DH + 8 * j + c0) =
          __floats2bfloat162_rn(dv[4 * j + 2 * hf], dv[4 * j + 2 * hf + 1]);
    }
  }
}

template <int DH, int QST>
int launch_attn_bwd_wide_query(const AbArgs& a, const AbWide& wd, size_t qsm, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_wide_query_kernel<DH, QST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)qsm);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_wide_query_kernel<DH, QST>
      <<<dim3(a.NTP / AB_NWG, a.heads, a.BB), AB_THREADS, qsm, s>>>(
          static_cast<const bf16*>(a.aux), static_cast<const bf16*>(a.rel),
          static_cast<bf16*>(a.dqkv), static_cast<bf16*>(a.drel), static_cast<float*>(a.stats),
          a.N, a.NTP, a.L, a.heads, a.scale, wd);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_attn_bwd_wide(const AbArgs& a, cudaStream_t s) {
  const AbWide wd = ab_wide(a.H, a.W);
  const int nBp = 16 * ((wd.nB + 15) / 16), qst = abw_query_stages(DH, nBp);
  constexpr int KST = abw_key_stages(DH);
  constexpr size_t ksm = abw_key_smem(DH, KST);
  static_assert(ksm <= AB_SMEM_MAX, "shared memory of one block");
  if (qst == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_wide_key_kernel<DH, KST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ksm);
  if (e != cudaSuccess) return (int)e;
  bf16* aux = static_cast<bf16*>(a.aux);
  attn_bwd_wide_prep_kernel<<<dim3(a.NTP + wd.nBe * wd.nc, a.heads, a.BB), 256, 0, s>>>(
      static_cast<const bf16*>(a.qkv), static_cast<const bf16*>(a.rel),
      static_cast<const bf16*>(a.g), aux, a.N, a.NTP, a.L, a.heads, DH, a.scale, wd);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t qsm = abw_query_smem(DH, nBp, qst);
  const int rq = qst == 3   ? launch_attn_bwd_wide_query<DH, 3>(a, wd, qsm, s)
                 : qst == 2 ? launch_attn_bwd_wide_query<DH, 2>(a, wd, qsm, s)
                            : launch_attn_bwd_wide_query<DH, 1>(a, wd, qsm, s);
  if (rq != 0) return rq;
  attn_bwd_wide_key_kernel<DH, KST>
      <<<dim3(wd.nBe / 2 * wd.nc, a.heads, a.BB), AB_THREADS, ksm, s>>>(
          aux, static_cast<const bf16*>(a.code), static_cast<const float*>(a.stats),
          static_cast<bf16*>(a.dqkv), a.N, a.NTP, a.heads, a.scale, wd);
  return (int)cudaGetLastError();
}

template <int DH>
int dispatch_attn_bwd(const AbArgs& a, int lpc, bool reg, cudaStream_t s) {
  if (lpc > 128) return launch_attn_bwd_wide<DH>(a, s);
  if (reg) return launch_attn_bwd<DH, 128, true>(a, s);
  if (lpc == 32) return launch_attn_bwd<DH, 32, false>(a, s);
  return launch_attn_bwd<DH, 128, false>(a, s);
}

}  // namespace cvlm

// qkv / dqkv (BB, N, 3*heads*d), rel / drel (N, BB, heads, L), g (BB, heads*d,
// N): bf16. NTP >= ceil(N / 64), even: the 64-row tiles of the scratch from
// the caller: aux (BB, heads, NTP, (5d + lpc) / 8, 64, 8) bf16, stats
// (BB*heads, NTP*64, 4) fp32, and code (NTP, lpc / 8, 64, 8) bf16: key k's
// row, ones at lanes k / W and H + k % W, zero rows past N
// (ops/flash_attention.py attn_bwd_scratch). The bias of query q and key k
// is rel[q, k / W] + rel[q, H + k % W]; lanes of drel no key maps to are
// written 0. N == H * W, H + W <= L <= lpc, lpc 32 or 128 (the lanes padded
// to the product's width), d in {16, 32, 64, 80, 128}. The query pass takes
// the register path where ab_reg(H, W, L, lpc) holds. lpc 256, 384 or 512
// (128 < L = H + W, rounded up to 128) takes the wide path, whose aux holds
// abw_aux_chunks(NTP, d / 8, ab_wide(H, W)) 16-byte columns of 64 rows per
// (image, head) and whose code is its 16 tiles (10, 64, 8)
// (ops/flash_attention.py attn_bwd_wide_layout). Queues three launches
// (prep, query pass, key pass); returns the first CUDA error.
extern "C" int cvlm_attn_bwd(const void* qkv, const void* rel, const void* g, void* dqkv,
                             void* drel, void* aux, void* stats, const void* code, int BB, int N,
                             int NTP, int H, int W, int L, int lpc, int heads, int d, float scale,
                             void* stream) {
  using namespace cvlm;
  const AbArgs a{qkv, rel, g, code, dqkv, drel, aux, stats, BB, N, NTP, H, L, heads, scale, W};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = L > 128 && L == H + W && lpc == (L + 127) / 128 * 128 && lpc <= 512;
  if (N < 1 || H < 1 || W < 1 || H * W != N || H + W > L || L > lpc || heads < 1 ||
      BB < 1 || BB > 65535 || heads > 65535 || (lpc != 32 && lpc != 128 && !wide) ||
      NTP % AB_NWG != 0 || (long long)NTP * AB_T < N)
    return (int)cudaErrorInvalidValue;
  const bool reg = ab_reg(H, W, L, lpc);
  switch (d) {
    case 16: return dispatch_attn_bwd<16>(a, lpc, reg, s);
    case 32: return dispatch_attn_bwd<32>(a, lpc, reg, s);
    case 64: return dispatch_attn_bwd<64>(a, lpc, reg, s);
    case 80: return dispatch_attn_bwd<80>(a, lpc, reg, s);
    case 128: return dispatch_attn_bwd<128>(a, lpc, reg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What cvlm_attn_bwd launches at d on an H x W grid of L lanes padded to
// lpc: out = {1 on the register path, 2 on the wide path, else 0; the query
// pass's dynamic shared memory (bytes) and ring stages; the key pass's}
extern "C" int cvlm_attn_bwd_smem(int d, int H, int W, int L, int lpc, long long* out) {
  using namespace cvlm;
  if ((d != 16 && d != 32 && d != 64 && d != 80 && d != 128) ||
      (lpc != 32 && lpc != 128 && lpc != 256 && lpc != 384 && lpc != 512))
    return (int)cudaErrorInvalidValue;
  if (lpc > 128) {
    const AbWide wd = ab_wide(H, W);
    const int nBp = 16 * ((wd.nB + 15) / 16), qst = abw_query_stages(d, nBp);
    if (qst == 0) return (int)cudaErrorInvalidValue;
    const int kst = abw_key_stages(d);
    out[0] = 2;
    out[1] = (long long)abw_query_smem(d, nBp, qst);
    out[2] = qst;
    out[3] = (long long)abw_key_smem(d, kst);
    out[4] = kst;
    return 0;
  }
  const bool reg = ab_reg(H, W, L, lpc);
  const int qst = abq_stages(d, lpc, reg), kst = abk_stages(d, lpc);
  out[0] = reg;
  out[1] = (long long)abq_smem(d, lpc, reg, qst);
  out[2] = qst;
  out[3] = (long long)abk_smem(d, lpc, kst);
  out[4] = kst;
  return 0;
}
