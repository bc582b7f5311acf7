// qkv_packed_windows_s: SAM's windowed attention on the compact carry's
// interior windows, per (window, head)
//   o = softmax((q*scale) . k^T + rel[q, k / win] + rel[q, win + k % win]) . v,
// read straight from the packed qkv projection, written d-major.
//
// Replaces flash_qkv_packed_windows_s of camouflaged_vlm_tpu/ops/flash_attention.py
// (_qkv_packed_windows_s_kernel): the 28 windowed ViT-H blocks of the
// reference configuration (window 14), in inference and in the train
// forward. qkv (BW, win^2, 3 heads d) with BW = B * 16 windows, rel_s
// (win^2, BW, heads * 32) position-major with lanes [rel_h(win) | rel_w(win)
// | 0], out (BW, heads d, win^2) for proj_rows; at ViT-H (32, 196, 3840),
// (196, 32, 512), (32, 1280, 196).
//
// What bounds it on the H100: the bytes, 70 MB at ViT-H's shapes and B = 2
// (qkv 48 MB, rel 6.4, out 16), 0.0211 ms at 3.35 TB/s; the products are 6.3
// GFLOP (0.0064 ms). The design, on attn_sm90.cuh's blocks:
//   * one block per (window, head), 160 threads: one consumer warpgroup and
//     one producer warp. At win 14 and d = 80 a block takes 108.6 KB of
//     shared memory, so two are resident per SM and one's loads overlap the
//     other's products (512 blocks at B = 2: 1.9 waves of 264).
//   * The window's k and v are loaded once, by TMA, as NP rows: the keys
//     padded to the wgmma width (64, 208 or 256; 208 at win 14). All of the
//     window's query tiles run against them, where the whole-score-row
//     kernel read them once per 32 queries. The 64-query tiles of q and
//     their rel rows come through a 2-stage ring, the next in flight while
//     the current one computes.
//   * The bias by the tensor cores, the port's 'aug' identity
//     (ops/aug_attention.py): q' = [bf16(q * scale) | the query's 32 rel
//     lanes] and k' = [k | the key's two-hot lane code, ones at lanes
//     k / win and win + k % win], so S = q' k'^T is the biased score in one
//     chain of m64nNPk16 products of depth d + 32 (112 at d = 80). Products
//     with 0 or 1 are exact, so S differs from (q k^T) + rel @ sel only in
//     fp32 summation order. The lane code depends only on win: it is built
//     once per block in shared memory, beside k's chunks, and no score
//     takes an index computation.
//   * A whole score row in registers (NP / 2 fp32 a thread): the keys past
//     win^2 masked to -inf, then the exact max-subtracted softmax of the JAX
//     `ref` (flash_attention.py:546-553), normalised in fp32 before the bf16
//     rounding: the plain version's rounding points, none moved. P is
//     wgmma's register A operand for O = P V (NP / 16 k16 steps).
//   * The epilogue writes d-major rows (8-byte stores at win 14: 196 % 8 = 4).
// Registers: at most NP / 2 scores, then NP / 4 packed probabilities beside
// d / 2 accumulators; one warpgroup a block leaves 255 a thread within
// reach, so win 16 at d = 128 (128 scores, then 64 + 64) needs no split of
// the keys.
#include "attn_sm90.cuh"

namespace cvlm {

constexpr int WS_QSTAGES = 2, WS_THREADS = 160, WS_LANES = 32;

// shared memory: 2 q' tiles [(d + 32) / 8][64][8], k' [(d + 32) / 8][NP][8],
// v [d / 8][NP][8], the barriers
template <int DH, int NP>
__host__ __device__ constexpr size_t windows_s_smem() {
  return 128 +
         sizeof(bf16) * ((size_t)WS_QSTAGES * 64 * (DH + WS_LANES) +
                         (size_t)NP * (DH + WS_LANES) + (size_t)NP * DH) +
         sizeof(uint64_t) * (1 + 2 * WS_QSTAGES);
}

// qmap / kvmap: the packed rows in boxes of 64 / NP rows (encode_packed_rows);
// relmap: rel_s in boxes of 64 queries x the head's 32 lanes. Grid (heads, BW).
template <int DH, int NP>
__global__ void __launch_bounds__(WS_THREADS, 1) qkv_windows_s_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kvmap,
    const __grid_constant__ CUtensorMap relmap, bf16* __restrict__ out, int win, int heads,
    float scale) {
  constexpr int DA = DH + WS_LANES;  // the augmented depth
  constexpr int QT = 64 * DA;        // elements of one q' tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [stage][DA/8][64][8]: q chunks, then rel
  bf16* sK = sQ + WS_QSTAGES * QT;           // [DA/8][NP][8]: k chunks, then the lane code
  bf16* sV = sK + NP * DA;                   // [DH/8][NP][8]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sV + NP * DH);
  const MbarRing<WS_QSTAGES> ring{kvbar + 1, kvbar + 1 + WS_QSTAGES};

  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int Nw = win * win, n_q = (Nw + 63) / 64;
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
  // k's lane code: ones at lanes k / win and win + k % win, none past win^2
  bf16* code = sK + NP * DH;
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
  fence_async_shared();
  named_barrier(1, 128);
  mbar_wait(kvbar, 0);

  const int lane = tid % 32, c0 = 2 * (lane % 4);
  bf16* ob = out + ((size_t)b * heads + h) * DH * Nw;
  for (int i = 0; i < n_q; ++i) {
    const int s = ring.wait(i);
    bf16* qt = sQ + s * QT;
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

    // the exact softmax of each row over the win^2 real keys
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + c0 + e >= Nw) {
          sc[4 * j + e] = -INFINITY;
          sc[4 * j + 2 + e] = -INFINITY;
        }
        mx_lo = fmaxf(mx_lo, sc[4 * j + e]);
        mx_hi = fmaxf(mx_hi, sc[4 * j + 2 + e]);
      }
    mx_lo = quad_max(mx_lo) * LOG2E;
    mx_hi = quad_max(mx_hi) * LOG2E;
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
    const float inv_lo = 1.f / quad_sum(sum_lo), inv_hi = 1.f / quad_sum(sum_hi);

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

    // epilogue in the tile's q chunks; then the slot goes back to the producer
    store_o_dmajor<DH, 64>(o, 1.f, 1.f, qt, ob, Nw, 64 * i, tid, 1);
    fence_async_shared();
    named_barrier(1, 128);
    if (tid == 0) ring.release(s);
  }
}

template <int DH, int NP>
int launch_windows_s(const void* qkv, const void* rel, void* out, int BW, int win, int heads,
                     float scale, cudaStream_t s) {
  const int Nw = win * win;
  CUtensorMap qmap, kvmap, relmap;
  int err = encode_packed_rows<DH>(&qmap, qkv, BW, Nw, heads, 64);
  if (!err) err = encode_packed_rows<DH>(&kvmap, qkv, BW, Nw, heads, NP);
  // rel_s (Nw, BW, heads * 32) as (8-lane chunk, query, chunk index, window)
  const cuuint64_t lanes = (cuuint64_t)heads * WS_LANES;
  const cuuint64_t dims[4] = {8, (cuuint64_t)Nw, lanes / 8, (cuuint64_t)BW};
  const cuuint64_t strides[3] = {BW * lanes * sizeof(bf16), 16, lanes * sizeof(bf16)};
  const cuuint32_t box[4] = {8, 64, WS_LANES / 8, 1};
  if (!err) err = encode_bf16_map(&relmap, rel, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  const size_t smem = windows_s_smem<DH, NP>();
  cudaError_t e = cudaFuncSetAttribute(qkv_windows_s_kernel<DH, NP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  qkv_windows_s_kernel<DH, NP><<<dim3(heads, BW), WS_THREADS, smem, s>>>(
      qmap, kvmap, relmap, static_cast<bf16*>(out), win, heads, scale);
  return (int)cudaGetLastError();
}

// the keys padded to the product's width: 64 up to win 8, 208 up to 14, 256
template <int DH>
int dispatch_windows_s(const void* qkv, const void* rel, void* out, int BW, int win, int heads,
                       float scale, cudaStream_t s) {
  const int n = win * win;
  if (n <= 64) return launch_windows_s<DH, 64>(qkv, rel, out, BW, win, heads, scale, s);
  if (n <= 208) return launch_windows_s<DH, 208>(qkv, rel, out, BW, win, heads, scale, s);
  return launch_windows_s<DH, 256>(qkv, rel, out, BW, win, heads, scale, s);
}

}  // namespace cvlm

// qkv (BW, win*win, 3*heads*d), rel_s (win*win, BW, heads*32) position-major,
// out (BW, heads*d, win*win): bf16; 2 * win <= 32, d in {16, 32, 64, 80,
// 128}. Returns a cudaError_t code.
extern "C" int cvlm_qkv_packed_windows_s(const void* qkv, const void* rel, void* out, int BW,
                                         int win, int heads, int d, float scale,
                                         void* stream) {
  using namespace cvlm;
  if (win < 1 || 2 * win > WS_LANES || BW > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return dispatch_windows_s<16>(qkv, rel, out, BW, win, heads, scale, s);
    case 32: return dispatch_windows_s<32>(qkv, rel, out, BW, win, heads, scale, s);
    case 64: return dispatch_windows_s<64>(qkv, rel, out, BW, win, heads, scale, s);
    case 80: return dispatch_windows_s<80>(qkv, rel, out, BW, win, heads, scale, s);
    case 128: return dispatch_windows_s<128>(qkv, rel, out, BW, win, heads, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
