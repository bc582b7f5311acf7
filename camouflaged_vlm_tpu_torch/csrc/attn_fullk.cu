// attn_fullk: softmax(q_aug . k_aug^T) . v over augmented features, q_aug
// pre-scaled, FlashAttention-3's one pass on TMA + wgmma.
//
// Replaces flash_attention_fullk of camouflaged_vlm_tpu/ops/flash_attention.py
// (`_kernel`, TPU kernel #20): the global blocks of SAM's 'aug_flash' path,
// whose q_aug = [q * scale | rel_h | rel_w] and k_aug = [k | onehot(kh) |
// onehot(kw)] carry the decomposed rel-pos bias as extra features
// (ops/aug_attention.py), so the kernel adds no bias. At SAM ViT-H, batch 2:
// q_aug, k_aug (32, 4096, 208) (80 + 64 + 64; the TPU path pads to 256, this
// kernel takes the multiple of 16 the products need), v (32, 4096, 80).
//
// What bounds it on the H100: 2 N^2 (208 + 80) per problem, 309 GFLOP at
// batch 2, 0.3127 ms at 989 TFLOP/s, against 130 MB of operands and output
// (0.039 ms at 3.35 TB/s): the tensor cores.
//
// Design: attn_sm90.cuh's streaming loop (#16's attn_stream_kernel) over
// split operands, one block per (2 x 64 queries, problem):
//   * q, k and v arrive through their own tensor maps over the (BB, N, d)
//     rows; the producer warp loads the block's q tiles once, then keeps a
//     ring of 64-key k and v tiles in flight. q and k land as 64-column
//     boxes with the 128-byte swizzle (64 128-byte rows a box of 64 rows,
//     wgmma's K-major swizzled layout) plus, at 208, one 16-column box of
//     no-swizzle core matrices (load_qk_tile); v as core matrices, the
//     N-major B of P V;
//   * the depth is a template constant DQ in {64, 128, 192, 208, 256}: a d
//     between them reads zero chunks past d (TMA fills the box), which add
//     nothing to the scores; S = Q K^T is DQ / 16 wgmma m64n64k16 steps
//     (13 at ViT-H's 208);
//   * per key tile the online softmax and O += P V with P the register A
//     operand (stream_softmax_pv), the keys past N of a ragged last tile
//     masked; O / l is written as rows (BB, N, dv) straight from the
//     accumulator fragment, 4 bytes a thread.
// Why the swizzled boxes: with every 64-row q or k box in no-swizzle core
// matrices (as the port's other attention kernels load theirs) a key tile
// at 208 is 26 x 64 16-byte TMA rows against 3 x 64 128-byte rows and 2 x
// 64 16-byte ones, and that arrangement ran slower on the H100; three
// consumer warpgroups ran no faster than two (PERF.md).
//
// Rounding: the one pass moves one rounding point against the JAX kernel
// and the plain version, which normalise p in fp32 before rounding it to
// bf16: here P is rounded unnormalised, exp(s - m_running), and O is divided
// by the fp32 row sum at the end, as in #16, #17 and #11/#19.
#include "attn_sm90.cuh"

namespace cvlm {

constexpr int FK_NWG = 2;  // consumer warpgroups: 128 queries a block

// ring stages: as many 64-key k and v tiles as ~220 KB holds beside the q
// tiles, at most 6 (4 at 208 x 80, 3 at 256 x 80)
constexpr int fullk_stages(int dq, int dv) {
  return (220 * 1024 - FK_NWG * ST_KT * dq * 2) / (ST_KT * (dq + dv) * 2) < 6
             ? (220 * 1024 - FK_NWG * ST_KT * dq * 2) / (ST_KT * (dq + dv) * 2)
             : 6;
}

// dynamic shared memory: 1024 bytes of alignment slack, the q tiles, the
// ring of k and v tiles, the mbarriers
constexpr size_t fullk_smem(int dq, int dv, int stages) {
  return 1024 +
         sizeof(bf16) * ((size_t)FK_NWG * ST_KT * dq + (size_t)stages * ST_KT * (dq + dv)) +
         sizeof(uint64_t) * (1 + 2 * stages);
}

// the depth DQ the kernel runs a d <= 256 at (d % 16 == 0)
constexpr int fullk_depth(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : d <= 208 ? 208 : 256;
}

// The q and k tiles, 64 rows x DQ: DQ / 64 boxes of 64 rows x 64 columns
// with the 128-byte swizzle (a 3-D map, 64 128-byte rows a box), then the
// DQ % 64 columns left (16 at 208) as core matrices through `tail`, a
// core-matrix map. Loads the tile at `row` of problem b into dst,
// signalling bar.
template <int DQ>
__device__ __forceinline__ void load_qk_tile(bf16* dst, const CUtensorMap* map,
                                             const CUtensorMap* tail, uint64_t* bar, int row,
                                             int b) {
#pragma unroll
  for (int i = 0; i < DQ / 64; ++i)
    tma_load_3d(dst + i * 64 * ST_KT, map, bar, 64 * i, row, b);
  if constexpr (DQ % 64 != 0)
    tma_load_4d(dst + DQ / 64 * 64 * ST_KT, tail, bar, 0, row, DQ / 64 * 8, b);
}

// S (64 x 64) = the warpgroup's q tile . the k tile^T, in the layout of
// load_qk_tile: K-major operands, a 128-byte-swizzled box 4 k16 steps (32
// bytes each), a core-matrix column pair one.
template <int DQ>
__device__ __forceinline__ void qk_scores(float (&sc)[32], const bf16* q, const bf16* k) {
  constexpr int CORE0 = DQ / 64 * 4;  // the k16 steps in swizzled boxes
  const bf16* qc = q + DQ / 64 * 64 * ST_KT;  // the core-matrix columns
  const bf16* kc = k + DQ / 64 * 64 * ST_KT;
#pragma unroll
  for (int ks = 0; ks < CORE0; ++ks)
    Wgmma<64>::ss(sc,
                  wgmma_desc(q + ks / 4 * 64 * ST_KT + ks % 4 * 16, 16, 1024, LAYOUT_SWIZZLE_128B),
                  wgmma_desc(k + ks / 4 * 64 * ST_KT + ks % 4 * 16, 16, 1024, LAYOUT_SWIZZLE_128B),
                  ks > 0 ? 1 : 0);
#pragma unroll
  for (int ks = CORE0; ks < DQ / 16; ++ks)
    Wgmma<64>::ss(sc,
                  wgmma_desc(qc + (ks - CORE0) * 2 * ST_KT * 8, ST_KT * 16, 128, LAYOUT_INTERLEAVE),
                  wgmma_desc(kc + (ks - CORE0) * 2 * ST_KT * 8, ST_KT * 16, 128, LAYOUT_INTERLEAVE),
                  ks > 0 ? 1 : 0);
}

// Grid (ceil(N / (64 FK_NWG)), BB), FK_NWG * 128 + 32 threads. qmap, kmap: the q
// and k tiles' swizzled boxes' maps, qtail, ktail: with DQ % 64 != 0 the
// core-matrix maps of the columns left (else unread).
template <int DQ, int DV, int STAGES>
__global__ void __launch_bounds__(FK_NWG * 128 + 32, 1) attn_fullk_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap qtail, const __grid_constant__ CUtensorMap ktail,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out, int N) {
  constexpr int QT = ST_KT * DQ, VT = ST_KT * DV;  // elements of a q or k tile, a v tile
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the swizzled boxes' pattern repeats every 1024 bytes
  // (each tile's size is a multiple of 1024 bytes)
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // FK_NWG q tiles
  bf16* sK = sQ + FK_NWG * QT;               // [stage] k tile
  bf16* sV = sK + STAGES * QT;               // [stage][DV/8][64][8]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + STAGES * VT);
  const MbarRing<STAGES> ring{qbar + 1, qbar + 1 + STAGES};

  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = blockIdx.x * (FK_NWG * 64), b = blockIdx.y;
  const int n_tiles = (N + ST_KT - 1) / ST_KT;
  if (tid == 0) {
    mbar_init(qbar, 1);
    ring.init(FK_NWG);  // one arrival per consumer warpgroup
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == FK_NWG) {  // the producer warp: one thread issues every load
    if (tid == FK_NWG * 128) {
      const int nq = min(FK_NWG, (N - q0 + 63) / 64);  // the q tiles that hold a row
      mbar_expect_tx(qbar, nq * QT * sizeof(bf16));
      for (int w = 0; w < nq; ++w)
        load_qk_tile<DQ>(sQ + w * QT, &qmap, &qtail, qbar, q0 + 64 * w, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = ring.acquire(t, (QT + VT) * sizeof(bf16));
        load_qk_tile<DQ>(sK + s * QT, &kmap, &ktail, &ring.full[s], t * ST_KT, b);
        tma_load_4d(sV + s * VT, &vmap, &ring.full[s], 0, t * ST_KT, 0, b);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  // (a warpgroup whose 64 rows all lie past N runs on an unloaded q tile and
  // writes nothing)
  const int ltid = tid % 128, lane = tid % 32;
  const bf16* sQw = sQ + wg * QT;
  mbar_wait(qbar, 0);
  const int c0 = 2 * (lane % 4);  // this thread's first accumulator column
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = ring.wait(t);
    float sc[32];  // S = Q K^T (64 x 64 per warpgroup), k over DQ in steps of 16
    wgmma_fence();
    qk_scores<DQ>(sc, sQw, sK + s * QT);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    stream_softmax_pv<DV>(sc, o, m_lo, m_hi, l_lo, l_hi, N - t * ST_KT, c0, sV + s * VT);
    if (ltid == 0) ring.release(s);
  }

  // epilogue: O / l rounded to bf16, rows r_lo and r_hi of the fragment, a
  // column pair a store (16 contiguous bytes a quad)
  const float f_lo = 1.f / quad_sum(l_lo), f_hi = 1.f / quad_sum(l_hi);
  const int r_lo = (ltid / 32) * 16 + lane / 4, rows = N - q0 - 64 * wg;
  bf16* ob = out + ((size_t)b * N + q0 + 64 * wg) * DV;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int c = 8 * j + c0;
    if (r_lo < rows)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_lo * DV + c) =
          pack_bf16(o[4 * j] * f_lo, o[4 * j + 1] * f_lo);
    if (r_lo + 8 < rows)
      *reinterpret_cast<uint32_t*>(ob + (size_t)(r_lo + 8) * DV + c) =
          pack_bf16(o[4 * j + 2] * f_hi, o[4 * j + 3] * f_hi);
  }
}

template <int DQ, int DV>
int launch_fullk(const void* q, const void* k, const void* v, void* out, int BB, int N, int d,
                 cudaStream_t s) {
  constexpr int STAGES = fullk_stages(DQ, DV);
  constexpr size_t smem = fullk_smem(DQ, DV, STAGES);
  static_assert(STAGES >= 2 && smem <= 227 * 1024, "shared memory of one block");
  // 64 x 64 boxes over (BB, N, d), and the tails' core matrices
  CUtensorMap qm, km, qt, kt, vm;
  constexpr int TAIL = (DQ % 64) / 8 > 0 ? (DQ % 64) / 8 : 1;
  int err = gemm_map(&qm, q, 3, d, N, BB, d, (long long)N * d, ST_KT);
  if (!err) err = gemm_map(&km, k, 3, d, N, BB, d, (long long)N * d, ST_KT);
  if (!err) err = encode_split_rows(&qt, q, BB, N, d, TAIL);
  if (!err) err = encode_split_rows(&kt, k, BB, N, d, TAIL);
  if (!err) err = encode_split_rows(&vm, v, BB, N, DV, DV / 8);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(attn_fullk_kernel<DQ, DV, STAGES>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + FK_NWG * 64 - 1) / (FK_NWG * 64), BB);
  attn_fullk_kernel<DQ, DV, STAGES><<<grid, FK_NWG * 128 + 32, smem, s>>>(
      qm, km, qt, kt, vm, static_cast<bf16*>(out), N);
  return (int)cudaGetLastError();
}

template <int DV>
int dispatch_fullk(const void* q, const void* k, const void* v, void* out, int BB, int N, int d,
                   cudaStream_t s) {
  switch (fullk_depth(d)) {
    case 64: return launch_fullk<64, DV>(q, k, v, out, BB, N, d, s);
    case 128: return launch_fullk<128, DV>(q, k, v, out, BB, N, d, s);
    case 192: return launch_fullk<192, DV>(q, k, v, out, BB, N, d, s);
    case 208: return launch_fullk<208, DV>(q, k, v, out, BB, N, d, s);
    default: return launch_fullk<256, DV>(q, k, v, out, BB, N, d, s);
  }
}

}  // namespace cvlm

// q_aug, k_aug (BB, N, d), v (BB, N, dv), out (BB, N, dv): bf16, bases
// 16-byte aligned; d % 16 == 0, d <= 256; dv in {64, 80} (SAM ViT-B, ViT-H);
// BB <= 65535. Returns a cudaError_t code.
extern "C" int cvlm_attn_fullk(const void* q, const void* k, const void* v, void* out, int BB,
                               int N, int d, int dv, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BB < 1 || BB > 65535 || N < 1 || d < 16 || d % 16 != 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  switch (dv) {
    case 64: return dispatch_fullk<64>(q, k, v, out, BB, N, d, s);
    case 80: return dispatch_fullk<80>(q, k, v, out, BB, N, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What cvlm_attn_fullk launches at depth d and dv: out[0] the depth DQ,
// out[1] the ring stages, out[2] the dynamic shared memory in bytes.
// Returns a cudaError_t code.
extern "C" int cvlm_attn_fullk_smem(int d, int dv, long long* out) {
  using namespace cvlm;
  if (d < 16 || d % 16 != 0 || d > 256 || (dv != 64 && dv != 80))
    return (int)cudaErrorInvalidValue;
  const int dq = fullk_depth(d), stages = fullk_stages(dq, dv);
  out[0] = dq;
  out[1] = stages;
  out[2] = (long long)fullk_smem(dq, dv, stages);
  return 0;
}
