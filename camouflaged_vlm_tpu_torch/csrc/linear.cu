// linear: out = act(x . W^T + b), the plain product with a bias and an
// activation epilogue.
//
// Replaces linear_pallas of camouflaged_vlm_tpu/ops/linear.py
// (_linear_kernel): SAM's patch embed, x (B*4096, 768) . W (1280, 768), and
// the EVP prompt generator's. Bias and activation are applied in fp32 on the
// accumulator, then rounded to bf16 once, as the TPU kernel does.
//
// What bounds it on the H100: at the patch embed's shape (B = 2: 16.1 GFLOP,
// 16.6 MB) the tensor-core rate, 0.0163 ms at 989 TFLOP/s. Every operand
// fits the 50 MB L2, but each output tile streams its A rows and W columns
// through it once more: M N K 2 B (1/BN + 1/BM) of L2 reads, 252 MB for the
// 128 x 128 tiles here (128 x 256 tiles, 189 MB, measured slower: 2.4 tiles
// per SM leave the last round 40% full). The design is the Hopper GEMM
// mainloop (gemm_sm90.cuh) that the LN-prologue and MLP-epilogue kernels are
// to share:
//   * 128 x 128 output tiles (640 at B = 2: 4.85 per SM on 132 SMs), walked
//     by one persistent block per SM (tile = blockIdx.x + i * gridDim.x,
//     N fastest), 288 threads: two consumer warpgroups of 64 rows each and
//     one producer warp;
//   * the producer keeps a ring of 4 stages in flight across tiles, so the
//     next tile's loads overlap this tile's epilogue: per stage one TMA load
//     of the x tile (128 x 64) and one of the W tile (128 x 64), both K-major
//     with the 128-byte swizzle (64 bf16 = 128 B per box row), on a "full"
//     mbarrier per stage; the consumers free a stage on its "empty"
//     mbarrier;
//   * each consumer warpgroup issues 4 wgmma m64n128k16 per stage (64 fp32
//     accumulators a thread) and keeps one stage's products in flight while
//     it waits for the next stage;
//   * epilogue: bias + activation on the registers, bf16 into shared memory,
//     then 16-byte stores per row (scalar ones at a ragged N or an N that is
//     not a multiple of 8, whose rows are not 16-byte aligned).
// Ragged M, N and K: TMA fills the out-of-bounds part of a box with zeros.
// TMA strides are multiples of 16 bytes, so K % 8 == 0 (the wrapper checks).
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace cvlm {

constexpr int LIN_BM = 128, LIN_BN = 128, LIN_BK = 64, LIN_STAGES = 4;
constexpr int LIN_THREADS = 288;     // 2 consumer warpgroups + 1 producer warp
constexpr int LIN_LDC = LIN_BN + 8;  // bf16 epilogue pitch (272 B, 16-byte aligned)
constexpr int LIN_STAGE_ELEMS = (LIN_BM + LIN_BN) * LIN_BK;
constexpr size_t LIN_SMEM = 1024 +  // slack for the 1024-byte alignment of the swizzled tiles
                            sizeof(bf16) * (LIN_STAGES * LIN_STAGE_ELEMS + LIN_BM * LIN_LDC) +
                            sizeof(uint64_t) * 2 * LIN_STAGES;

__global__ void __launch_bounds__(LIN_THREADS, 1) linear_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int N, int K, int act) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sA = reinterpret_cast<bf16*>(smem);      // [stage][128 rows][64], swizzled
  bf16* sB = sA + LIN_STAGES * LIN_BM * LIN_BK;  // [stage][128 rows][64], swizzled
  bf16* sC = sB + LIN_STAGES * LIN_BN * LIN_BK;  // [128][LIN_LDC]
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + LIN_BM * LIN_LDC);
  uint64_t* empty = full + LIN_STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int k_tiles = (K + LIN_BK - 1) / LIN_BK;
  const int n_blocks = (N + LIN_BN - 1) / LIN_BN;
  const int n_tiles = n_blocks * ((M + LIN_BM - 1) / LIN_BM);
  if (tid == 0) {
    for (int s = 0; s < LIN_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: one thread issues every load
    if (tid == 256) {
      int it = 0;  // k steps over all of this block's tiles: the ring's position
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / n_blocks) * LIN_BM, n0 = (tile % n_blocks) * LIN_BN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % LIN_STAGES;
          mbar_wait(&empty[s], ((it / LIN_STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], LIN_STAGE_ELEMS * sizeof(bf16));
          tma_load_2d(sA + s * LIN_BM * LIN_BK, &xmap, &full[s], kt * LIN_BK, m0);
          tma_load_2d(sB + s * LIN_BN * LIN_BK, &wmap, &full[s], kt * LIN_BK, n0);
        }
      }
    }
    return;
  }

  const int warp = (tid % 128) / 32, lane = tid % 32;
  bf16* sCw = sC + wg * 64 * LIN_LDC;
  const bool vec = (N % 8) == 0;
  float acc[LIN_BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / n_blocks) * LIN_BM, n0 = (tile % n_blocks) * LIN_BN;
#pragma unroll
    for (int i = 0; i < LIN_BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % LIN_STAGES;
      mbar_wait(&full[s], (it / LIN_STAGES) & 1);
      const bf16* a = sA + s * LIN_BM * LIN_BK + wg * 64 * LIN_BK;
      const bf16* b = sB + s * LIN_BN * LIN_BK;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < LIN_BK / 16; ++kk)
        Wgmma<LIN_BN>::ss(acc, wgmma_desc(a + kk * 16, 16, 1024, LAYOUT_SWIZZLE_128B),
                          wgmma_desc(b + kk * 16, 16, 1024, LAYOUT_SWIZZLE_128B), 1);
      wgmma_commit();
      fence_regs(acc);
      // the previous stage's products are done: give its buffers back
      wgmma_wait<1>();
      if (kt > 0 && tid % 128 == 0) mbar_arrive(&empty[(it - 1) % LIN_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid % 128 == 0) mbar_arrive(&empty[(it - 1) % LIN_STAGES]);

    // epilogue: bias and activation in fp32, one rounding, through shared
    // memory (the barrier first: the previous tile's stores read sCw)
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < LIN_BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4), gc = n0 + col;
      const float b0 = gc < N ? __bfloat162float(bias[gc]) : 0.f;
      const float b1 = gc + 1 < N ? __bfloat162float(bias[gc + 1]) : 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = warp * 16 + lane / 4 + 8 * hf;
        *reinterpret_cast<uint32_t*>(sCw + row * LIN_LDC + col) =
            pack_bf16(apply_act(acc[4 * j + 2 * hf] + b0, act),
                      apply_act(acc[4 * j + 2 * hf + 1] + b1, act));
      }
    }
    named_barrier(1 + wg, 128);
    for (int e = tid % 128; e < 64 * (LIN_BN / 8); e += 128) {
      const int row = e / (LIN_BN / 8), ch = e % (LIN_BN / 8);
      const int gr = m0 + wg * 64 + row, gc = n0 + ch * 8;
      if (gr >= M || gc >= N) continue;
      const bf16* src = sCw + row * LIN_LDC + ch * 8;
      bf16* dst = out + (size_t)gr * N + gc;
      if (vec && gc + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int i = 0; i < 8 && gc + i < N; ++i) dst[i] = src[i];
      }
    }
  }
}

}  // namespace cvlm

// x (M, K), w (N, K) [nn.Linear layout], bias (N,), out (M, N): bf16, every
// base 16-byte aligned; K % 8 == 0. Returns a cudaError_t code.
extern "C" int cvlm_linear(const void* x, const void* w, const void* bias, void* out, int M,
                           int K, int N, int act, void* stream) {
  using namespace cvlm;
  if (M < 1 || N < 1 || K < 8 || K % 8 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  const cuuint32_t box[2] = {LIN_BK, LIN_BM};  // LIN_BM == LIN_BN: one box for x and W
  const cuuint64_t stride[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t wdims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  int err = encode_bf16_map(&xmap, x, 2, xdims, stride, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = encode_bf16_map(&wmap, w, 2, wdims, stride, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)LIN_SMEM);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = ((N + LIN_BN - 1) / LIN_BN) * ((M + LIN_BM - 1) / LIN_BM);
  const int grid = n_tiles < n_sm ? n_tiles : n_sm;
  linear_kernel<<<grid, LIN_THREADS, LIN_SMEM, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, N, K, act);
  return (int)cudaGetLastError();
}
