// ln_mlp_residual_bwd: the backward of out = x + act(LN(x) . W1^T + b1) . W2^T + b2
// at the upstream gradient g, four passes on the TMA + wgmma blocks of
// gemm_sm90.cuh.
//
// Replaces _ln_mlp_residual_bwd_kernel of camouflaged_vlm_tpu/ops/linear.py
// (the custom_vjp backward of ln_mlp_residual_bt, site #6): SAM ViT-H's
// fused MLP in training, x and g (32, 196, 1280), (2, 1008, 1280) and
// (2, 4096, 1280), hidden H = 5120, gelu_tanh; 60 calls per step at batch 2,
// none with weight gradients (SAM's ViT is frozen).
//
// What it computes, with the TPU kernel's rounding points:
//   xn = bf16(LN(x)); pre1 = xn . W1^T + b1 and dh_pre = bf16(g) . W2 in
//   fp32; dh = act'(pre1) * dh_pre, rounded to bf16 for the next product;
//   dxn = dh . W1 in fp32; dx = rstd * (dxhat - mean(dxhat) - xhat *
//   mean(dxhat * xhat)) + g with dxhat = dxn * gamma, rounded once.
//
// What bounds it on the H100: three GEMMs of 2 M H K FLOP each, 0.3257 ms at
// SAM's global blocks, batch 2 (989 TFLOP/s), against ~0.1 ms of their bf16
// operands and outputs; the tensor cores. The TPU kernel kept a row block's
// hidden in VMEM; here the bf16 dh reaches device memory (84 MB at the
// global site, batch 2: ~0.05 ms written and read at 3.35 TB/s), bounded by
// row panels of ops/linear.py mlp_panel_rows as in the forward. Per panel:
//   1. the LN row pass of ln_linear.cu: xn (bf16) and each row's (mean, rstd);
//   2. mlp_bwd_dual_kernel, one GEMM over the hidden with two products on one
//      K loop: each 128 x 128 output tile accumulates pre1 (xn against W1's
//      K-major rows) and dh_pre (g against W2 (K, H), an N-major B read
//      through imm-trans-b) in two fp32 accumulators; the epilogue adds b1
//      and writes bf16(act'(pre1) * dh_pre). A stage holds the four tiles
//      (64 KB at BK = 64), three stages; FlashAttention-3's register split
//      (producer_regs / consumer_regs: a producer warpgroup at 40, two
//      consumer warpgroups of 64 rows at 232, 2 x 64 accumulators each);
//      persistent blocks, one an SM, N fastest as in gemm_tma_kernel;
//   3. dxn = dh . W1 on gemm_tma_kernel (launch_gemm) with W1 (H, K) as an
//      N-major W and the fp32 epilogue (EPI_F32) into a (rows, K) scratch;
//   4. ln_bwd_rows_kernel: dx per row from dxn, x, the row's statistics and g.
// pre1 is never stored: rounding it to bf16 would move a rounding point.
//
// Only when a weight, bias or LN parameter needs its gradient the passes
// also keep xn and dh for every row and write act(pre1) (M, H) in bf16 for
// the wrapper's two weight products (torch.matmul, as the JAX wrapper leaves
// them to XLA); pass 2 writes fp32 column sums of dh (before its rounding)
// per 64 rows (db1), pass 4 those of dxn * xhat and dxn per 32 rows (dgamma,
// dbeta); the wrapper sums them. No atomics: two runs are bit-equal.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace cvlm {
// defined in ln_linear.cu
int launch_ln_rows(const void* x, const void* gamma, const void* beta, const void* mask,
                   void* xn, int M, int K, int S, int nwin, float eps, cudaStream_t stream,
                   float2* stats);

// ----------------------------------------------------- pass 2: the dual GEMM

constexpr int DG_BM = 128, DG_BN = 128, DG_BK = 64, DG_STAGES = 3, DG_THREADS = 384;
constexpr int DG_TILE = 128 * DG_BK;  // elements of one operand's tile in a stage
constexpr size_t DG_SMEM = 1024 +     // slack for the swizzled tiles' 1024-byte alignment
                           sizeof(bf16) * DG_STAGES * 4 * DG_TILE +
                           sizeof(float) * 2 * 4 * DG_BN +  // db1's per-warp column sums
                           sizeof(uint64_t) * 2 * DG_STAGES;

// xmap, gmap: the panel's xn and g (rows, K) in (128, 64) boxes; w1map: W1
// (H, K) in (128, 64) boxes; w2map: W2 (K, H) in 64 x 64 boxes (N-major).
// dh (rows, H) bf16; with the weights (hact != null) hact (rows, H) bf16 and
// db1 (2 ceil(rows / 128), H) fp32.
template <int ACT>
__global__ void __launch_bounds__(DG_THREADS, 1) mlp_bwd_dual_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
    const __grid_constant__ CUtensorMap w1map, const __grid_constant__ CUtensorMap w2map,
    const bf16* __restrict__ b1, bf16* __restrict__ dh, bf16* __restrict__ hact,
    float* __restrict__ db1, int M, int K, int H) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sT = reinterpret_cast<bf16*>(smem);  // [stage][xn | g | W1 rows | W2 boxes][128 x 64]
  float* red = reinterpret_cast<float*>(sT + DG_STAGES * 4 * DG_TILE);  // [wg][warp][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * 4 * DG_BN);
  uint64_t* empty = full + DG_STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int k_tiles = (K + DG_BK - 1) / DG_BK;
  const int n_blocks = (H + DG_BN - 1) / DG_BN, n_tiles = n_blocks * ((M + DG_BM - 1) / DG_BM);
  if (tid == 0) {
    for (int s = 0; s < DG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: one thread issues every load
    producer_regs();
    if (tid == 256) {
      int it = 0;  // k steps over all of this block's tiles: the ring's position
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int n0 = (tile % n_blocks) * DG_BN, m0 = (tile / n_blocks) * DG_BM;
        const int nb = min(2, (H - n0 + 63) / 64);  // W2's boxes that hold a column
        const uint32_t bytes = (3 * DG_BM + 64 * nb) * DG_BK * sizeof(bf16);
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % DG_STAGES;
          bf16* t = sT + s * 4 * DG_TILE;
          mbar_wait(&empty[s], ((it / DG_STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], bytes);
          tma_load_2d(t, &xmap, &full[s], kt * DG_BK, m0);
          tma_load_2d(t + DG_TILE, &gmap, &full[s], kt * DG_BK, m0);
          tma_load_2d(t + 2 * DG_TILE, &w1map, &full[s], kt * DG_BK, n0);
          for (int j = 0; j < nb; ++j)
            tma_load_2d(t + 3 * DG_TILE + j * 64 * DG_BK, &w2map, &full[s], n0 + 64 * j,
                        kt * DG_BK);
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  consumer_regs();
  const int ltid = tid % 128, warp = ltid / 32, lane = tid % 32;
  float pre[DG_BN / 2], dpre[DG_BN / 2];  // d[4j + r]: row 16 warp + lane/4 + 8 (r/2),
                                          // column 8j + 2 (lane % 4) + r % 2
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = (tile % n_blocks) * DG_BN, m0 = (tile / n_blocks) * DG_BM;
#pragma unroll
    for (int i = 0; i < DG_BN / 2; ++i) pre[i] = dpre[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % DG_STAGES;
      mbar_wait(&full[s], (it / DG_STAGES) & 1);
      const bf16* t = sT + s * 4 * DG_TILE;
      const bf16* xa = t + wg * 64 * DG_BK;
      const bf16* ga = t + DG_TILE + wg * 64 * DG_BK;
      const bf16* w1b = t + 2 * DG_TILE;
      const bf16* w2b = t + 3 * DG_TILE;
      wgmma_fence();
      fence_regs(pre);
      fence_regs(dpre);
#pragma unroll
      for (int kk = 0; kk < DG_BK / 16; ++kk) {
        Wgmma<DG_BN>::ss(pre, wgmma_desc(xa + kk * 16, 16, 1024, LAYOUT_SWIZZLE_128B),
                         wgmma_desc(w1b + kk * 16, 16, 1024, LAYOUT_SWIZZLE_128B), 1);
        Wgmma<DG_BN>::template ss<0, 1>(
            dpre, wgmma_desc(ga + kk * 16, 16, 1024, LAYOUT_SWIZZLE_128B),
            wgmma_desc(w2b + kk * 16 * 64, 64 * DG_BK * sizeof(bf16), 1024, LAYOUT_SWIZZLE_128B),
            1);
      }
      wgmma_commit();
      fence_regs(pre);
      fence_regs(dpre);
      // the previous stage's products are done: give its buffers back
      wgmma_wait<1>();
      if (kt > 0 && ltid == 0) mbar_arrive(&empty[(it - 1) % DG_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(pre);
    fence_regs(dpre);
    if (ltid == 0) mbar_arrive(&empty[(it - 1) % DG_STAGES]);

    // epilogue: dh = act'(pre1 + b1) * dh_pre in fp32 (kept in dpre), stored
    // in bf16 from the registers (H % 8 == 0: a column pair is in or out whole)
    const int r_lo = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < DG_BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      const bool cin = c < H;
      const float bb0 = cin ? __bfloat162float(b1[c]) : 0.f;
      const float bb1 = cin ? __bfloat162float(b1[c + 1]) : 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r_lo + 8 * hf, i = 4 * j + 2 * hf;
        const float p0 = pre[i] + bb0, p1 = pre[i + 1] + bb1;
        dpre[i] *= act_grad(p0, ACT);
        dpre[i + 1] *= act_grad(p1, ACT);
        if (r < M && cin) {
          *reinterpret_cast<uint32_t*>(dh + (size_t)r * H + c) = pack_bf16(dpre[i], dpre[i + 1]);
          if (hact != nullptr)
            *reinterpret_cast<uint32_t*>(hact + (size_t)r * H + c) =
                pack_bf16(apply_act(p0, ACT), apply_act(p1, ACT));
        }
      }
    }
    if (db1 != nullptr) {  // this warpgroup's 64 rows: column sums of the fp32 dh
      float* rw = red + (wg * 4 + warp) * DG_BN;
      named_barrier(1 + wg, 128);  // the previous tile's sums have been read
#pragma unroll
      for (int j = 0; j < DG_BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = (r_lo < M ? dpre[4 * j + e] : 0.f) + (r_lo + 8 < M ? dpre[4 * j + 2 + e] : 0.f);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) rw[8 * j + 2 * lane + e] = v;
        }
      named_barrier(1 + wg, 128);
      const float* rg = red + wg * 4 * DG_BN;
      if (n0 + ltid < H)
        db1[((size_t)(m0 / 64) + wg) * H + n0 + ltid] =
            rg[ltid] + rg[DG_BN + ltid] + rg[2 * DG_BN + ltid] + rg[3 * DG_BN + ltid];
    }
  }
}

template <int ACT>
int launch_dual(const void* xn, const void* g, const void* w1, const void* b1, const void* w2,
                void* dh, void* hact, float* db1, int M, int K, int H, cudaStream_t s) {
  static bool opted[64] = {};
  int n_sm = 0;
  int err = sm_count_opt_in(reinterpret_cast<const void*>(mlp_bwd_dual_kernel<ACT>), DG_SMEM,
                            opted, &n_sm);
  CUtensorMap xmap, gmap, w1map, w2map;
  if (!err) err = gemm_map_rows(&xmap, xn, M, K, DG_BM);
  if (!err) err = gemm_map_rows(&gmap, g, M, K, DG_BM);
  if (!err) err = gemm_map_rows(&w1map, w1, H, K, DG_BN);
  if (!err) err = gemm_map_rows(&w2map, w2, K, H, 64);
  if (err) return err;
  const long long n_tiles = (long long)((M + DG_BM - 1) / DG_BM) * ((H + DG_BN - 1) / DG_BN);
  const int grid = n_tiles < n_sm ? (int)n_tiles : n_sm;
  mlp_bwd_dual_kernel<ACT><<<grid, DG_THREADS, DG_SMEM, s>>>(
      xmap, gmap, w1map, w2map, static_cast<const bf16*>(b1), static_cast<bf16*>(dh),
      static_cast<bf16*>(hact), db1, M, K, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------- pass 4: the LN backward rows

constexpr int LB_ROWS = 32, LB_THREADS = 256;  // 8 warps, 4 rows each

// dx (M, K) bf16 from dxn (M, K) fp32, x and g (M, K) bf16, gamma (K,) fp32
// and the rows' (mean, rstd); one warp per row, 16-byte loads (K % 8 == 0).
// g is the residual's gradient, none when null (the forward had no
// residual).
// WEIGHTS: also the column sums of dxn * xhat and dxn over the block's rows
// into dga and dbe (ceil(M / 32), K) fp32.
template <bool WEIGHTS>
__global__ void __launch_bounds__(LB_THREADS) ln_bwd_rows_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ g, const float* __restrict__ gamma,
    const float2* __restrict__ stats, const float* __restrict__ dxn, bf16* __restrict__ dx,
    float* __restrict__ dga, float* __restrict__ dbe, int M, int K) {
  __shared__ float2 st_s[LB_ROWS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * LB_ROWS, rows = min(LB_ROWS, M - m0), nv = K / 8;
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  for (int rr = warp; rr < rows; rr += LB_THREADS / 32) {
    const size_t m = m0 + rr;
    const float2 st = stats[m];
    if (WEIGHTS && lane == 0) st_s[rr] = st;
    const uint4* xr = reinterpret_cast<const uint4*>(x + m * K);
    const float4* dr = reinterpret_cast<const float4*>(dxn + m * K);
    float f[8], s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < nv; c += 32) {
      unpack8(xr[c], f);
      const float4 d0 = dr[2 * c], d1 = dr[2 * c + 1], ga = g4[2 * c], gb = g4[2 * c + 1];
      const float dxh[8] = {d0.x * ga.x, d0.y * ga.y, d0.z * ga.z, d0.w * ga.w,
                            d1.x * gb.x, d1.y * gb.y, d1.z * gb.z, d1.w * gb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1 += dxh[i];
        s2 += dxh[i] * ((f[i] - st.x) * st.y);
      }
    }
    const float m1 = warp_sum(s1) / (float)K, m2 = warp_sum(s2) / (float)K;
    const uint4* gr = g != nullptr ? reinterpret_cast<const uint4*>(g + m * K) : nullptr;
    uint4* out = reinterpret_cast<uint4*>(dx + m * K);
    for (int c = lane; c < nv; c += 32) {
      float gu[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      unpack8(xr[c], f);
      if (gr != nullptr) unpack8(gr[c], gu);
      const float4 d0 = dr[2 * c], d1 = dr[2 * c + 1], ga = g4[2 * c], gb = g4[2 * c + 1];
      const float dxh[8] = {d0.x * ga.x, d0.y * ga.y, d0.z * ga.z, d0.w * ga.w,
                            d1.x * gb.x, d1.y * gb.y, d1.z * gb.z, d1.w * gb.w};
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xh0 = (f[2 * i] - st.x) * st.y, xh1 = (f[2 * i + 1] - st.x) * st.y;
        o[i] = pack_bf16(st.y * (dxh[2 * i] - m1 - xh0 * m2) + gu[2 * i],
                         st.y * (dxh[2 * i + 1] - m1 - xh1 * m2) + gu[2 * i + 1]);
      }
      out[c] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  if (WEIGHTS) {
    __syncthreads();
    for (int c = threadIdx.x; c < K; c += LB_THREADS) {
      float sg = 0.f, sb = 0.f;
      for (int r = 0; r < rows; ++r) {
        const size_t o = (size_t)(m0 + r) * K + c;
        const float d = dxn[o];
        sg += d * ((__bfloat162float(x[o]) - st_s[r].x) * st_s[r].y);
        sb += d;
      }
      dga[(size_t)blockIdx.x * K + c] = sg;
      dbe[(size_t)blockIdx.x * K + c] = sb;
    }
  }
}

int launch_ln_bwd_rows(const void* x, const void* g, const void* gamma, const float2* stats,
                       const float* dxn, void* dx, float* dga, float* dbe, int M, int K,
                       cudaStream_t s) {
  const int grid = (M + LB_ROWS - 1) / LB_ROWS;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* gp = static_cast<const bf16*>(g);
  const auto* ga = static_cast<const float*>(gamma);
  auto* out = static_cast<bf16*>(dx);
  if (dga != nullptr)
    ln_bwd_rows_kernel<true><<<grid, LB_THREADS, 0, s>>>(xp, gp, ga, stats, dxn, out, dga, dbe,
                                                        M, K);
  else
    ln_bwd_rows_kernel<false><<<grid, LB_THREADS, 0, s>>>(xp, gp, ga, stats, dxn, out, nullptr,
                                                         nullptr, M, K);
  return (int)cudaGetLastError();
}

}  // namespace cvlm

// x/g/dx (M, K), w1 (H, K), b1 (H,), w2 (K, H): bf16; gamma/beta (K,) fp32.
// Scratch: xn (R, K) and dh (R, H) bf16, stats (rows,) float2, dxn (rows, K)
// fp32, with R = M when the weight side is given and R = rows (the panel)
// when not. The weight side, all given or all null: hact (M, H) bf16, dga
// and dbe (ceil(M / 32), K), db1 (2 ceil(M / 128), H) fp32. K % 8 == 0, H %
// 8 == 0, rows a multiple of 128 or >= M; residual 1 adds g to dx (the
// forward's residual), 0 not; bn dxn's tile width (128 or 256). Queues four
// launches per panel; returns a cudaError_t code.
extern "C" int cvlm_ln_mlp_residual_bwd(const void* x, const void* gamma, const void* beta,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* g, void* dx, void* xn, void* dh, void* stats,
                                        void* dxn, void* hact, void* dga, void* dbe, void* db1,
                                        int M, int K, int H, int rows, float eps, int act,
                                        int residual, int bn, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool weights = hact != nullptr;
  if (M < 1 || rows < 1 || (rows < M && rows % DG_BM != 0) || K < 8 || K % 8 != 0 || H < 8 ||
      H % 8 != 0 || weights != (dga != nullptr) || weights != (dbe != nullptr) ||
      weights != (db1 != nullptr) || act < ACT_NONE || act > ACT_QUICK_GELU)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* gp = static_cast<const bf16*>(g);
  auto* st = static_cast<float2*>(stats);
  auto* dxnp = static_cast<float*>(dxn);
  for (int r0 = 0; r0 < M; r0 += rows) {
    const int m = M - r0 < rows ? M - r0 : rows;
    const size_t rw = weights ? r0 : 0;  // the row of xn and dh that holds the panel's first
    bf16* xnp = static_cast<bf16*>(xn) + rw * K;
    bf16* dhp = static_cast<bf16*>(dh) + rw * H;
    bf16* hp = weights ? static_cast<bf16*>(hact) + (size_t)r0 * H : nullptr;
    float* db1p = weights ? static_cast<float*>(db1) + (size_t)(r0 / 64) * H : nullptr;
    float* dgap = weights ? static_cast<float*>(dga) + (size_t)(r0 / LB_ROWS) * K : nullptr;
    float* dbep = weights ? static_cast<float*>(dbe) + (size_t)(r0 / LB_ROWS) * K : nullptr;
    int err = launch_ln_rows(xp + (size_t)r0 * K, gamma, beta, nullptr, xnp, m, K, 1, 1, eps, s,
                             st);
    if (!err) {
      const bf16* gr = gp + (size_t)r0 * K;
      switch (act) {
        case ACT_GELU: err = launch_dual<ACT_GELU>(xnp, gr, w1, b1, w2, dhp, hp, db1p, m, K, H, s);
          break;
        case ACT_GELU_TANH:
          err = launch_dual<ACT_GELU_TANH>(xnp, gr, w1, b1, w2, dhp, hp, db1p, m, K, H, s);
          break;
        case ACT_QUICK_GELU:
          err = launch_dual<ACT_QUICK_GELU>(xnp, gr, w1, b1, w2, dhp, hp, db1p, m, K, H, s);
          break;
        default: err = launch_dual<ACT_NONE>(xnp, gr, w1, b1, w2, dhp, hp, db1p, m, K, H, s);
      }
    }
    if (!err)  // pass 3: dxn = dh . W1, W1 (H, K) an N-major W, fp32 out
      err = launch_gemm<EPI_F32, true>(dhp, w1, nullptr, nullptr, dxnp, m, K, H, ACT_NONE, bn, s);
    if (!err)
      err = launch_ln_bwd_rows(xp + (size_t)r0 * K, residual ? gp + (size_t)r0 * K : nullptr,
                               gamma, st, dxnp,
                               static_cast<bf16*>(dx) + (size_t)r0 * K, dgap, dbep, m, K, s);
    if (err) return err;
  }
  return 0;
}

// The dual GEMM's (pass 2's) ring stages and dynamic shared memory in bytes,
// into out[0] and out[1].
extern "C" void cvlm_ln_mlp_residual_bwd_smem(long long* out) {
  out[0] = cvlm::DG_STAGES;
  out[1] = (long long)cvlm::DG_SMEM;
}
