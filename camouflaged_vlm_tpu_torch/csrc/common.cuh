// Shared device helpers for the hand-written Hopper kernels.
//
// Every kernel but the float32 instances (the *_f32.cu sources, on
// sgemm_f32.cuh) takes bfloat16 activations and weights, accumulates in
// fp32 on the tensor cores (TMA + wgmma, through gemm_sm90.cuh), and rounds
// to bfloat16 exactly where the JAX package's kernels round.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cvlm {

using bf16 = __nv_bfloat16;

// Activation codes shared with the Python wrappers (ops/_cuda.py).
enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_GELU_TANH = 2, ACT_QUICK_GELU = 3 };

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case ACT_GELU:  // jax.nn.gelu(approximate=False)
      return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
    case ACT_GELU_TANH: {  // jax.nn.gelu(approximate=True)
      const float u = 0.79788456080286536f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.0f + tanhf(u));
    }
    case ACT_QUICK_GELU:  // x * sigmoid(1.702 x)
      return v / (1.0f + expf(-1.702f * v));
    default:
      return v;
  }
}

// act'(v) of the activations above (the closed forms of the derivatives
// JAX's autodiff takes)
__device__ __forceinline__ float act_grad(float v, int act) {
  switch (act) {
    case ACT_GELU:
      return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) +
             v * expf(-0.5f * v * v) * 0.39894228040143268f;
    case ACT_GELU_TANH: {
      const float c = 0.79788456080286536f;
      const float t = tanhf(c * (v + 0.044715f * v * v * v));
      return 0.5f * (1.0f + t) + 0.5f * v * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * v * v);
    }
    case ACT_QUICK_GELU: {
      const float s = 1.0f / (1.0f + expf(-1.702f * v));
      return s + 1.702f * v * s * (1.0f - s);
    }
    default:
      return 1.0f;
  }
}

// 8 bf16 values (one 16-byte load) to fp32
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------- cp.async and the chunk swizzle
// (the float32 products of sgemm_f32.cuh and the flash loop of attn_f32.cuh)

// one 16-byte copy global -> shared, `bytes` (0 or 16; a partial chunk 4, 8
// or 12) read from src and the rest zero-filled
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

// one 4-byte copy (bytes 0: a zero)
__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The place of 16-byte chunk c in row r of a row-major shared tile of CPR
// chunks a row (rows copied as they lie, read along the row, 16 bytes a
// read): an XOR swizzle within each aligned group of chunks, so that the 8
// rows a phase of 8 lanes reads, rows 1 << SHIFT apart, fall on 8 different
// bank groups. CPR % 8 == 0: a row starts on the same bank group as the
// last, c ^ ((r >> SHIFT) & 7); CPR % 8 == 4: on the other half, the low two
// bits of c ^ ((r >> (SHIFT + 1)) & 3) (groups of 4 chunks, so a row of 20
// or 52 chunks keeps its chunks).
template <int CPR, int SHIFT = 0>
__device__ __forceinline__ int swizzle_chunk(int c, int r) {
  static_assert(CPR % 4 == 0, "rows of whole groups of 4 chunks");
  if constexpr (CPR % 8 == 0)
    return c ^ ((r >> SHIFT) & 7);
  else
    return c ^ ((r >> (SHIFT + 1)) & 3);
}

// Two-pass LayerNorm statistics of one row, computed by a whole warp:
// mean, then the mean of squared deviations (the JAX formulation).
__device__ __forceinline__ void row_stats(const bf16* __restrict__ row, int K,
                                          float eps, float& mu, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += __bfloat162float(row[k]);
  mu = warp_sum(s) / (float)K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = __bfloat162float(row[k]) - mu;
    v += d * d;
  }
  rstd = 1.0f / sqrtf(warp_sum(v) / (float)K + eps);
}

}  // namespace cvlm
