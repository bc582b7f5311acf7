// qkv_packed_plain_f32: per head, o = softmax((q*scale) . k^T) . v, no bias,
// all in float32, read straight from the packed qkv projection, written
// d-major.
//
// Replaces flash_qkv_packed_plain of camouflaged_vlm_tpu/ops/flash_attention.py
// (_qkv_packed_plain_kernel, TPU kernel #16) where the JAX package runs it
// in float32: the Alpha-CLIP ViT-L/14@336 vision attention in MaPLe prompt
// training. Input qkv (B, S, 3*H*d), the last axis laid out [q heads | k
// heads | v heads]; output (B, H*d, S) with row stride ldo, the d-major
// layout proj_rows reads (proj_rows_f32.cu reads it as it lies).
//
// Shapes on that path: B = 8, S = 577 + 4 MaPLe prompts = 581, 16 heads, d
// = 64; 24 calls a step. What bounds it on the H100 is the float32 rate of
// the CUDA cores (the tensor cores have no float32 mode): 4 B H S^2 d = 11.1
// GFLOP, 0.166 ms at 67 TFLOP/s, against 57 MB of qkv and 19 MB of output
// (0.023 ms at 3.35 TB/s).
//
// Design: the flash loop, one block of 256 threads per (b * heads + h,
// 64-query tile): the block's q tile (scaled on load, as the plain version
// scales q before the product) stays in shared memory; per 64-key tile, k
// (transposed) and v are staged in shared memory, each thread computes a 4
// x 4 block of scores, the online softmax keeps each row's running max and
// sum in fp32 (the 16 threads of a row reduce with shuffles), the
// probabilities go through shared memory (transposed) into P . V, each
// thread a 4 x (d / 16) block of the output. Keys past S in the ragged last
// tile score -inf; queries past S are computed on zero rows and not stored.
// The output is divided by the row sums at the end, staged in shared
// memory as [d][query] and stored d-major, 64 contiguous queries a row
// (coalesced; the ragged tile masked). Dynamic shared memory: q, k and p
// tiles of 64 x (64 + 4) floats, d = 64: 68 KB a block.
#include "common.cuh"

namespace cvlm {
namespace {

constexpr int AQ = 64, AK = 64, AT = 256, AP = 4, AL = AQ + AP;

template <int D>
constexpr size_t plain_f32_smem() {
  // Qs [D][AL] (q^T, reused for the output), Ks [D][AL] (k^T), Vs [AK][D], Ps [AK][AL] (p^T)
  return sizeof(float) * (2 * D * AL + AK * D + AK * AL);
}

template <int D>
__global__ void __launch_bounds__(AT) qkv_plain_f32_kernel(const float* __restrict__ qkv,
                                                           float* __restrict__ out, int S,
                                                           int ldo, int heads, float scale) {
  static_assert(D % 64 == 0, "each thread holds d / 16 output columns in float4 groups");
  constexpr int NG = D / 64;  // float4 column groups a thread
  extern __shared__ __align__(16) float smem[];
  float(*Qs)[AL] = reinterpret_cast<float(*)[AL]>(smem);
  float(*Ks)[AL] = reinterpret_cast<float(*)[AL]>(smem + D * AL);
  float(*Vs)[D] = reinterpret_cast<float(*)[D]>(smem + 2 * D * AL);
  float(*Ps)[AL] = reinterpret_cast<float(*)[AL]>(smem + 2 * D * AL + AK * D);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * AQ, bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const size_t C3 = (size_t)3 * heads * D;
  const float* base = qkv + (size_t)b * S * C3 + (size_t)h * D;
  const float* kbase = base + (size_t)heads * D;
  const float* vbase = base + (size_t)2 * heads * D;
  constexpr int V4 = D / 4;  // float4s a row

  // the q tile, scaled, transposed: Qs[c][i]
  for (int idx = tid; idx < AQ * V4; idx += AT) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) v = *reinterpret_cast<const float4*>(base + (q0 + r) * C3 + c);
    Qs[c][r] = v.x * scale;
    Qs[c + 1][r] = v.y * scale;
    Qs[c + 2][r] = v.z * scale;
    Qs[c + 3][r] = v.w * scale;
  }

  float o[4][4 * NG], mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) o[i][c] = 0.f;
  }

  const int nkt = (S + AK - 1) / AK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * AK;
    __syncthreads();  // the previous tile's k, v and p are no longer read
    for (int idx = tid; idx < AK * V4; idx += AT) {
      const int r = idx / V4, c = (idx % V4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j0 + r < S) {
        kv = *reinterpret_cast<const float4*>(kbase + (j0 + r) * C3 + c);
        vv = *reinterpret_cast<const float4*>(vbase + (j0 + r) * C3 + c);
      }
      Ks[c][r] = kv.x;
      Ks[c + 1][r] = kv.y;
      Ks[c + 2][r] = kv.z;
      Ks[c + 3][r] = kv.w;
      *reinterpret_cast<float4*>(&Vs[r][c]) = vv;
    }
    __syncthreads();

    // scores of rows 4 ty + i against keys 4 tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[c][4 * ty]);
      const float4 kb = *reinterpret_cast<const float4*>(&Ks[c][4 * tx]);
      const float a[4] = {qa.x, qa.y, qa.z, qa.w}, k[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], k[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j0 + 4 * tx + j >= S)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;

    // the online softmax: each row's 64 scores lie on the 16 threads of one
    // half warp (lanes with the same ty)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(mrow[i], mx);  // finite: every tile holds a key < S
      const float alpha = expf(mrow[i] - mnew);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mnew);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      lrow[i] = lrow[i] * alpha + sum;
      mrow[i] = mnew;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) o[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[4 * tx + j][4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // o[rows 4 ty + i][columns 64 g + 4 tx + c] += p . v
#pragma unroll 8
    for (int j = 0; j < AK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[j][4 * ty]);
      const float p[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vb = *reinterpret_cast<const float4*>(&Vs[j][64 * g + 4 * tx]);
        const float v[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[i][4 * g + c] = fmaf(p[i], v[c], o[i][4 * g + c]);
      }
    }
  }

  // o / l staged as [column][query] in the q tile's place (no thread reads
  // Qs after the last tile's barrier before P . V), then stored d-major
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.0f / lrow[i];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) Qs[64 * g + 4 * tx + c][4 * ty + i] = o[i][4 * g + c] * inv;
  }
  __syncthreads();
  float* dst = out + ((size_t)b * heads * D + (size_t)h * D) * ldo + q0;
  for (int idx = tid; idx < D * AQ; idx += AT) {
    const int c = idx / AQ, r = idx % AQ;
    if (q0 + r < S) dst[(size_t)c * ldo + r] = Qs[c][r];
  }
}

template <int D>
int launch_plain_f32(const float* qkv, float* out, int B, int S, int ldo, int heads, float scale,
                     cudaStream_t s) {
  constexpr size_t smem = plain_f32_smem<D>();
  static bool attr = false;  // the opt-in above 48 KB, once per process
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        qkv_plain_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((S + AQ - 1) / AQ, B * heads);
  qkv_plain_f32_kernel<D><<<grid, AT, smem, s>>>(qkv, out, S, ldo, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cvlm

// qkv (B, S, 3*heads*d), out (B, heads*d, S) with row stride ldo >= S: fp32.
// d = 64 (CLIP ViT-L/14's), any S. Returns a cudaError_t code.
extern "C" int cvlm_qkv_packed_plain_f32(const void* qkv, void* out, int B, int S, int ldo,
                                         int heads, int d, float scale, void* stream) {
  using namespace cvlm;
  if (B < 1 || S < 1 || heads < 1 || ldo < S) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const float*>(qkv);
  auto* o = static_cast<float*>(out);
  if (d != 64) return (int)cudaErrorInvalidValue;
  return launch_plain_f32<64>(q, o, B, S, ldo, heads, scale, s);
}
