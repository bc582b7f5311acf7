// gemm_sm90: the Hopper building blocks of the TMA + wgmma kernels
// (qkv_packed_global.cu, #17; the attention kernels on attn_sm90.cuh; the
// attention backward attn_bwd.cu, #14/#18; the MLP backward's dual GEMM in
// ln_mlp_residual_bwd.cu, #6), written as raw PTX so that a source that
// includes this header compiles in seconds, and the persistent GEMM
// (gemm_tma_kernel, at the end) of linear.cu (#1), ln_linear.cu (#2, #3),
// ln_mlp_residual.cu (#4/#5), proj_rows.cu (#7, #8/#9) and the MLP
// backward's dxn (#6).
//
//   * mbarrier: init, arrive, arrive with an expected transaction count,
//     and a parity wait (a barrier's phase p "has completed" once it flips;
//     a wait on the parity of the phase before the first passes at once);
//   * TMA: 2-D, 3-D and 4-D tiled loads global -> shared that signal an mbarrier
//     (cp.async.bulk.tensor ... mbarrier::complete_tx::bytes), and the host
//     side's tensor-map encoder, cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPointByVersion (cudaGetDriverEntryPoint before CUDA
//     12.5) so that the library needs no -lcuda;
//   * wgmma: the shared-memory matrix descriptor and the asynchronous
//     m64nNk16 bf16 -> fp32 products of one warpgroup (128 threads), with A
//     from shared memory (ss) or from registers (rs), plus fence, commit and
//     wait;
//   * setmaxnreg: the producer / consumer register split of a block of
//     three warpgroups (producer_regs, consumer_regs).
//
// Descriptor layouts used here (PTX ISA, "matrix descriptor"; units of 16 B):
//   * K-major, 128-byte swizzle (layout type 1): rows of 64 bf16 (128 B)
//     written by a TMA load with CU_TENSOR_MAP_SWIZZLE_128B into a
//     1024-byte-aligned tile; SBO = 1024 B (8 rows), LBO unused; a k16 step
//     advances the start address by 32 B.
//   * K-major, 32-byte swizzle (layout type 3): rows of 16 bf16 (32 B, one
//     k16 step) written with CU_TENSOR_MAP_SWIZZLE_32B into a 256-byte-
//     aligned slice; SBO = 256 B (8 rows), LBO unused.
//   * MN-major, 128-byte swizzle (a transposed A, imm-trans-a = 1, or a
//     transposed B, imm-trans-b = 1): lines of 64 bf16 of M or N (128 B), one
//     per k, written by the same kind of TMA load from a matrix whose M or N
//     is contiguous; SBO = 1024 B (8 k lines), LBO = between 64-element
//     blocks of M or N (for A one block per m64 product, so unused); a k16
//     step advances the start address by 16 lines, 2048 B.
//   * no swizzle ("interleave", layout type 0): 8 x 16-byte core matrices,
//     each 128 contiguous bytes. K-major: LBO = the distance between the
//     two core matrices of a k16 step along K, SBO = between 8-row groups.
//     N-major (a transposed B): LBO = between 8-row groups along K, SBO =
//     between 8-column groups along N.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "common.cuh"

namespace cvlm {

// ------------------------------------------------------------- mbarrier

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// a barrier among `count` threads of the block (id 1..15; 0 is __syncthreads)
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma / TMA reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled, a CUDA driver API call, through the runtime's
// entry-point query (no -lcuda);
// rank-dimensional bf16 map, dims/box innermost first, strides in bytes of
// dims 1.. . Returns a cudaError_t code (0 on success).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline int encode_bf16_map(CUtensorMap* map, const void* base, int rank,
                           const cuuint64_t* dims, const cuuint64_t* strides,
                           const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &q);
#endif
    if (err != cudaSuccess) return (int)err;
    if (fn == nullptr || q != cudaDriverEntryPointSuccess) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                      const_cast<void*>(base), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // out-of-bounds elements of a box are filled with zeros (FLOAT_OOB_FILL_NONE)
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- wgmma

// descriptor: start address, LBO, SBO (bytes, multiples of 16), layout type
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                               uint32_t layout) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}
constexpr uint32_t LAYOUT_INTERLEAVE = 0, LAYOUT_SWIZZLE_128B = 1, LAYOUT_SWIZZLE_32B = 3;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Wgmma<N>::ss: d (64 x N) += A (64 x 16) . B (N x 16)^T, B K-major in
// shared memory, A K-major or, with TA = 1 (imm-trans-a), MN-major (the
// GEMM's transposed A, widths 128 and 256); at widths 128 and 256 B may be
// N-major too, with TB = 1 (imm-trans-b: the MLP backward's W2 and W1).
// Wgmma<N>::rs: d (64 x N) += A (64 x 16, registers: the mma.sync m16n8k16 A
// fragment of each warp's 16 rows) . B (16 x N), B N-major in shared memory
// (imm-trans-b = 1). scale_d = 0 overwrites d. The accumulator fragment:
// d[4j + r] is row 16*warp + lane/4 + 8*(r/2), column 8j + 2*(lane%4) + r%2.
// ss is written out for the widths the kernels use (64, 128; 112, 208 and
// 256: a whole window's keys, qkv_packed_windows_s.cu), rs for every head
// dimension (16, 32, 64, 80, 128).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<112> {
  static __device__ __forceinline__ void ss(float (&d)[56], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55}, "
        "%56, %57, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  template <int TA = 0, int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<208> {
  static __device__ __forceinline__ void ss(float (&d)[104], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103}, "
        "%104, %105, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  template <int TA = 0, int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
        " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

// Registers of a block of three warpgroups, FlashAttention-3's split: at
// launch each thread gets at most 168; the producer warpgroup (one thread of
// it issues the loads) gives its share back and two consumer warpgroups take
// 232 each (40 x 128 + 232 x 256 = 168 x 384); both branches run to the end
// of the kernel, as setmaxnreg needs. (With a lone producer warp, 288
// threads, the block holds 168 x 288 registers and the consumers' 232 can
// never be granted: the kernel hangs.)
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// -------------------------------------------------- the persistent GEMM
//
// out = epilogue(A . W (N, K)^T), bf16 in, fp32 accumulation: one mainloop
// shared by the plain product (#1), the LN-prologue products (#2, #3: A is
// the LN row pass's bf16 output), the two products of the fused MLP
// (#4/#5), the attention out-projections (#7, #8/#9) and the MLP backward's
// dxn = dh . W1 (#6, ln_mlp_residual_bwd.cu). A comes in three layouts (AM):
//   * A_ROWS, K-major rows (M, K), one group: G = 1, S = M;
//   * A_MN, MN-major: G groups of a (K, S) matrix whose s is contiguous (row
//     stride ldk, group stride ldg, multiples of 8), the attention kernels'
//     d-major output (proj_rows.cu, #7); row s of group g is output row
//     g * S + s;
//   * A_HEADS, K-major by head: G groups (images) of S rows, each row's K =
//     heads x KH values split by head, element (g, h, r, j) at ((g heads + h)
//     S + r) KH + j: the head-leading attention output (B, heads, T, S', d)
//     with S = T S' and KH = d (proj_rows.cu, #8/#9). The K walk, four
//     wgmma k16 steps a k step: first heads x (KH / 64) steps of 64 columns
//     of one head, the tile A_ROWS reads (A's box from a rank-3 map (j, r,
//     g heads + h) with the 128-byte swizzle, W's from its (N, K) rows at
//     column h KH + j0); then the heads' last KH % 64 columns in k16 slices,
//     ceil((KH % 64) / 16) a head, four a step wherever their heads lie
//     (boxes of 16 columns with the 32-byte swizzle from a second map of x
//     and of W as (j, h, n), zeros past KH and past the last head's). At KH
//     = 80, 16 heads: 16 steps of 64 columns, then 4 of four heads' last
//     16, no zeros. Only the descriptors tell a slice step from a tile step:
//     the same four wgmmas. (Walking all of K in slices, or in 64-column
//     tiles a head whose last is one k16 step deep, ran 1.8x slower than the
//     same product on plain rows; the latter's run-time wgmma count ptxas
//     serialized (C7520). PERF.md §6.)
//   In A_MN and A_HEADS a row tile holds rows of one group only, so a group
//   takes ceil(S / BM) row tiles, the last masked at S.
// W comes in two: K-major, the nn.Linear (N, K) rows (BNM = false), or
// N-major (BNM = true), a (K, N) matrix whose n is contiguous (#6 reads W1
// (H, K) so for dxn = dh . W1): BN / 64 boxes of 64 n x 64 k, 128-byte
// swizzled, read through imm-trans-b (SBO = 1024 B, 8 k lines; LBO = 8 KB,
// between the boxes), the boxes wholly past N left out.
// The rest:
//   * BM x BN output tiles, BM = 128, BN = 128 or 256 (the wrapper picks
//     per problem, ops/linear.py gemm_tile_n), walked by one persistent block
//     per SM (tile = blockIdx.x + i * gridDim.x, N fastest: a round of
//     tiles covers whole row panels, so A's rows are read from device
//     memory about once and W stays in L2); 288 threads: two consumer
//     warpgroups of 64 rows each and one producer warp;
//   * the producer keeps a ring of STAGES k-steps in flight across tiles
//     (the next tile's loads overlap this tile's epilogue): per stage the A
//     tile (128 x 64: one K-major box, or two MN-major boxes of 64 s x 64 k,
//     the second left out where its rows are all past S) and the W tile
//     (BN x 64, K-major), all with the 128-byte swizzle, on a "full"
//     mbarrier per stage; the consumers free a stage on its "empty" mbarrier;
//   * each consumer warpgroup issues 4 wgmma m64nBNk16 per stage (BN/2 fp32
//     accumulators a thread; an MN-major A through imm-trans-a) and keeps one
//     stage's products in flight while it waits for the next stage;
//   * epilogue, chosen at compile time, in fp32 on the registers and
//     rounded once: EPI_BIAS_ACT act(acc + b) (#1, #2, #3, fc1, #7 without
//     a residual); EPI_BIAS_RESIDUAL acc + b + res, res (G*S, N) bf16 read
//     at the accumulator fragment's own rows and columns (fc2: res is the
//     block's input x; #7: the attention block's input). Then bf16 through
//     shared memory and 16-byte stores per row (scalar ones at a ragged N or
//     an N that is not a multiple of 8). EPI_F32: the accumulator itself,
//     fp32, no bias, stored from the registers (8 bytes a thread, a quad's
//     32-byte sector per row; #6's dxn).
// Ragged S, N and K: TMA fills the out-of-bounds part of a box with zeros.
// TMA strides are multiples of 16 bytes: K % 8 == 0 (W's rows, a K-major
// A's rows), and an MN-major A's ldk and ldg % 8 == 0.
enum GemmEpilogue { EPI_BIAS_ACT = 0, EPI_BIAS_RESIDUAL = 1, EPI_F32 = 2 };
enum GemmA { A_ROWS = 0, A_MN = 1, A_HEADS = 2 };

// the activation over a whole accumulator fragment: one branch, then a
// straight unrolled loop (apply_act's switch folds on a constant code)
template <int R>
__device__ __forceinline__ void act_inplace(float (&v)[R], int act) {
  switch (act) {
    case ACT_GELU:
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = apply_act(v[i], ACT_GELU);
      break;
    case ACT_GELU_TANH:
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = apply_act(v[i], ACT_GELU_TANH);
      break;
    case ACT_QUICK_GELU:
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = apply_act(v[i], ACT_QUICK_GELU);
      break;
    default:
      break;
  }
}

template <int BN>
struct GemmTile {
  static constexpr int BM = 128, BK = 64, THREADS = 288;
  // ring depth: 144-128 KB of tiles, beside the (BM, LDC) epilogue tile
  static constexpr int STAGES = BN >= 256 ? 3 : 4;
  static constexpr int LDC = BN + 8;  // bf16 epilogue pitch (16-byte aligned rows)
  static constexpr int STAGE_ELEMS = (BM + BN) * BK;
  static constexpr size_t SMEM = 1024 +  // slack for the swizzled tiles' 1024-byte alignment
                                 sizeof(__nv_bfloat16) * (STAGES * STAGE_ELEMS + BM * LDC) +
                                 sizeof(uint64_t) * 2 * STAGES;
};

// A_HEADS: amap2 and wmap2 the maps of the k16 slices of the heads' last
// KH % 64 columns, KH the depth a head (K = heads KH); unread otherwise
template <int BN, int EPI, int AM, bool BNM = false>
__global__ void __launch_bounds__(GemmTile<BN>::THREADS, 1) gemm_tma_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap amap2, const __grid_constant__ CUtensorMap wmap2,
    const bf16* __restrict__ bias, const bf16* __restrict__ res, void* __restrict__ out_, int G,
    int S, int N, int K, int act, int KH) {
  using T = GemmTile<BN>;
  constexpr int BM = T::BM, BK = T::BK, STAGES = T::STAGES, LDC = T::LDC;
  constexpr bool AMN = AM == A_MN, GROUPS = AM != A_ROWS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [stage][128 rows][64] or [stage][2][64 k][64 s]
  bf16* sB = sA + STAGES * BM * BK;          // [stage][BN rows][64] or [stage][BN/64][64 k][64 n]
  bf16* sC = sB + STAGES * BN * BK;          // [128][LDC]
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + BM * LDC);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  // A_HEADS: heads x (KH / 64) steps of one head's 64 columns, then the
  // k16 slices of the heads' last KH % 64 columns, sph a head, four a step
  const int heads = K / KH, m64 = KH / 64, sph = (KH % 64 + 15) / 16;
  const int n_main = heads * m64, n_slices = heads * sph;
  const int k_tiles = AM == A_HEADS ? n_main + (n_slices + 3) / 4 : (K + BK - 1) / BK;
  const int n_blocks = (N + BN - 1) / BN, m_blocks = (S + BM - 1) / BM;
  const int n_tiles = n_blocks * m_blocks * G;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
        const int n0 = (tile % n_blocks) * BN, rt = tile / n_blocks;
        const int s0 = (GROUPS ? rt % m_blocks : rt) * BM, g = GROUPS ? rt / m_blocks : 0;
        const bool two = !AMN || s0 + 64 < S;  // MN-major: the second box holds a row
        // N-major W: the boxes that hold a column
        const int nb = BNM ? min(BN / 64, (N - n0 + 63) / 64) : BN / 64;
        const uint32_t bytes = ((two ? BM : 64) + 64 * nb) * BK * sizeof(bf16);
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % STAGES;
          bf16* a = sA + s * BM * BK;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], bytes);
          if constexpr (AM == A_HEADS) {
            if (kt < n_main) {  // head h's columns j0..j0 + 63
              const int h = kt / m64, j0 = (kt - h * m64) * 64;
              tma_load_3d(a, &amap, &full[s], j0, s0, g * heads + h);
              tma_load_2d(sB + s * BN * BK, &wmap, &full[s], h * KH + j0, n0);
            } else {  // four k16 slices: head h's columns j0..j0 + 15
              for (int i = 0; i < BK / 16; ++i) {
                const int q = (kt - n_main) * (BK / 16) + i, h = min(q / sph, heads - 1);
                const int j0 = m64 * 64 + (q < n_slices ? q - h * sph : sph) * 16;  // past KH: 0
                tma_load_3d(a + i * BM * 16, &amap2, &full[s], j0, s0, g * heads + h);
                tma_load_3d(sB + s * BN * BK + i * BN * 16, &wmap2, &full[s], j0, h, n0);
              }
            }
            continue;
          }
          if constexpr (AMN) {
            tma_load_3d(a, &amap, &full[s], s0, kt * BK, g);
            if (two) tma_load_3d(a + 64 * BK, &amap, &full[s], s0 + 64, kt * BK, g);
          } else {
            tma_load_2d(a, &amap, &full[s], kt * BK, s0);
          }
          if constexpr (BNM) {
            for (int j = 0; j < nb; ++j)
              tma_load_2d(sB + s * BN * BK + j * 64 * BK, &wmap, &full[s], n0 + 64 * j, kt * BK);
          } else {
            tma_load_2d(sB + s * BN * BK, &wmap, &full[s], kt * BK, n0);
          }
        }
      }
    }
    return;
  }

  const int warp = (tid % 128) / 32, lane = tid % 32;
  bf16* sCw = sC + wg * 64 * LDC;
  const bool vec = (N % 8) == 0;
  float acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = (tile % n_blocks) * BN, rt = tile / n_blocks;
    // A_ROWS is one group: no division by the row tiles a group
    const int s0 = (GROUPS ? rt % m_blocks : rt) * BM;
    const size_t row0 = GROUPS ? (size_t)(rt / m_blocks) * S : 0;  // the group's first output row
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const bf16* a = sA + s * BM * BK + wg * 64 * BK;
      const bf16* b = sB + s * BN * BK;
      // A_HEADS' slice steps: [4][BM rows][16] and [4][BN rows][16]
      const bool sl = AM == A_HEADS && kt >= n_main;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // an N-major W: 16 k lines of each 64-n box a step
        const uint64_t db =
            sl    ? wgmma_desc(b + kk * BN * 16, 16, 256, LAYOUT_SWIZZLE_32B)
            : BNM ? wgmma_desc(b + kk * 16 * 64, 64 * BK * sizeof(bf16), 1024, LAYOUT_SWIZZLE_128B)
                  : wgmma_desc(b + kk * 16, 16, 1024, LAYOUT_SWIZZLE_128B);
        if constexpr (AMN)  // 16 k lines of 64 s a step
          Wgmma<BN>::template ss<1, BNM>(
              acc, wgmma_desc(a + kk * 16 * 64, 64 * BK * sizeof(bf16), 1024, LAYOUT_SWIZZLE_128B),
              db, 1);
        else
          Wgmma<BN>::template ss<0, BNM>(
              acc,
              sl ? wgmma_desc(sA + s * BM * BK + (kk * BM + wg * 64) * 16, 16, 256,
                              LAYOUT_SWIZZLE_32B)
                 : wgmma_desc(a + kk * 16, 16, 1024, LAYOUT_SWIZZLE_128B),
              db, 1);
      }
      wgmma_commit();
      fence_regs(acc);
      // the previous stage's products are done: give its buffers back
      wgmma_wait<1>();
      if (kt > 0 && tid % 128 == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid % 128 == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

    if constexpr (EPI == EPI_F32) {  // N % 2 == 0: gc even, the pair 8-byte aligned
      float* out = static_cast<float*>(out_);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int gc = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int sr = s0 + wg * 64 + warp * 16 + lane / 4 + 8 * hf;
          if (sr < S && gc < N)
            *reinterpret_cast<float2*>(out + (row0 + sr) * N + gc) =
                make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
        }
      }
      continue;
    }
    bf16* out = static_cast<bf16*>(out_);

    // epilogue in fp32 on the accumulator fragment (d[4j + r]: row
    // 16 * warp + lane / 4 + 8 * (r / 2), column 8j + 2 * (lane % 4) + r % 2),
    // one rounding, then through shared memory
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int gc = n0 + 8 * j + 2 * (lane % 4);
      const float b0 = gc < N ? __bfloat162float(bias[gc]) : 0.f;
      const float b1 = gc + 1 < N ? __bfloat162float(bias[gc + 1]) : 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        acc[4 * j + 2 * hf] += b0;
        acc[4 * j + 2 * hf + 1] += b1;
        if (EPI == EPI_BIAS_RESIDUAL) {  // N % 8 == 0: gc even, the pair 4-byte aligned
          const int sr = s0 + wg * 64 + warp * 16 + lane / 4 + 8 * hf;
          if (sr < S && gc < N) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(res + (row0 + sr) * N + gc));
            acc[4 * j + 2 * hf] += r.x;
            acc[4 * j + 2 * hf + 1] += r.y;
          }
        }
      }
    }
    if (EPI == EPI_BIAS_ACT) act_inplace(acc, act);
    named_barrier(1 + wg, 128);  // the previous tile's stores have read sCw
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = warp * 16 + lane / 4 + 8 * hf, col = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(sCw + row * LDC + col) =
            pack_bf16(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
      }
    }
    named_barrier(1 + wg, 128);
    for (int e = tid % 128; e < 64 * (BN / 8); e += 128) {
      const int row = e / (BN / 8), ch = e % (BN / 8);
      const int sr = s0 + wg * 64 + row, gc = n0 + ch * 8;
      if (sr >= S || gc >= N) continue;
      const bf16* src = sCw + row * LDC + ch * 8;
      bf16* dst = out + (row0 + sr) * N + gc;
      if (vec && gc + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int i = 0; i < 8 && gc + i < N; ++i) dst[i] = src[i];
      }
    }
  }
}

// The host's launch setup, cached: a TMA map with (box0, box1[, box2]) boxes
// over a rank-2 or rank-3 bf16 matrix, the 128-byte swizzle at box0 = 64
// (the 32-byte one at box0 = 16; dims innermost first, strides of dims 1
// and 2 in elements) is a pure
// function of those arguments, so it is encoded once per distinct key (the
// weights' maps at every call, the scratch buffers' and the attention
// outputs' whenever the allocator hands back the same block), in a small
// direct-mapped table.
inline int gemm_map(CUtensorMap* map, const void* base, int rank, int d0, int d1, int d2,
                    long long ld1, long long ld2, int box1, int box2 = 1, int box0 = 64) {
  struct Entry {
    const void* base;
    int rank, d0, d1, d2, box0, box1, box2;
    long long ld1, ld2;
    CUtensorMap map;
  };
  constexpr int SLOTS = 256;
  static Entry table[SLOTS] = {};
  static std::mutex mu;
  const uintptr_t key = reinterpret_cast<uintptr_t>(base);
  Entry& e = table[((key >> 8) ^ (key >> 20) ^ ((uintptr_t)d1 * 0x9E37u) ^ ((uintptr_t)d0 << 3) ^
                    ((uintptr_t)d2 << 7) ^ (uintptr_t)box1 ^ ((uintptr_t)box2 << 9) ^
                    ((uintptr_t)box0 << 5)) %
                   SLOTS];
  std::lock_guard<std::mutex> lock(mu);
  if (e.base != base || e.rank != rank || e.d0 != d0 || e.d1 != d1 || e.d2 != d2 ||
      e.ld1 != ld1 || e.ld2 != ld2 || e.box0 != box0 || e.box1 != box1 || e.box2 != box2) {
    const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, (cuuint32_t)box2};
    const cuuint64_t stride[2] = {(cuuint64_t)ld1 * sizeof(bf16), (cuuint64_t)ld2 * sizeof(bf16)};
    const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
    const int err = encode_bf16_map(&e.map, base, rank, dims, stride, box,
                                    box0 == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                               : CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) {
      e.base = nullptr;
      return err;
    }
    e.base = base;
    e.rank = rank;
    e.d0 = d0;
    e.d1 = d1;
    e.d2 = d2;
    e.ld1 = ld1;
    e.ld2 = ld2;
    e.box0 = box0;
    e.box1 = box1;
    e.box2 = box2;
  }
  *map = e.map;
  return 0;
}

// a row-major (rows, cols) matrix in (box_rows, 64) boxes
inline int gemm_map_rows(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  return gemm_map(map, base, 2, cols, rows, 1, cols, 0, box_rows);
}

// The device's SM count, and `kernel`'s shared-memory opt-in to `smem`
// bytes, once per device (devices 0..63): `opted` is the kernel's own flags.
inline int sm_count_opt_in(const void* kernel, size_t smem, bool (&opted)[64], int* n_sm) {
  static int sms[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  *n_sm = sms[dev];
  return 0;
}

template <int BN, int EPI, int AM, bool BNM = false>
inline int gemm_setup(int* n_sm) {
  static bool opted[64] = {};
  return sm_count_opt_in(reinterpret_cast<const void*>(gemm_tma_kernel<BN, EPI, AM, BNM>),
                         GemmTile<BN>::SMEM, opted, n_sm);
}

// amap2: A_HEADS' map of the k16 slices of the heads' last kh % 64 columns
// (else amap again);
// kh: A_HEADS' depth a head (else K)
template <int BN, int EPI, int AM, bool BNM = false>
inline int launch_gemm_tiles(const CUtensorMap& amap, const CUtensorMap& amap2, const void* w,
                             const void* bias, const void* res, void* out, int G, int S, int N,
                             int K, int act, int kh, cudaStream_t stream) {
  using T = GemmTile<BN>;
  // K-major: (N, K) rows in (BN, 64) boxes; N-major: (K, N) rows in 64 x 64;
  // A_HEADS' slices: (N, heads, kh) as (j, h, n) in (16, 1, BN) boxes, zeros
  // past kh
  CUtensorMap wmap, wmap2;
  int err = BNM ? gemm_map_rows(&wmap, w, K, N, 64) : gemm_map_rows(&wmap, w, N, K, BN);
  wmap2 = wmap;
  if (!err && AM == A_HEADS && kh % 64 != 0)
    err = gemm_map(&wmap2, w, 3, kh, K / kh, N, kh, K, 1, BN, 16);
  int n_sm = 0;
  if (!err) err = gemm_setup<BN, EPI, AM, BNM>(&n_sm);
  if (err) return err;
  const long long n_tiles =
      (long long)G * ((S + T::BM - 1) / T::BM) * ((N + BN - 1) / BN);
  const int grid = n_tiles < n_sm ? (int)n_tiles : n_sm;
  gemm_tma_kernel<BN, EPI, AM, BNM><<<grid, T::THREADS, T::SMEM, stream>>>(
      amap, wmap, amap2, wmap2, static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
      out, G, S, N, K, act, kh);
  return (int)cudaGetLastError();
}

template <int EPI, int AM, bool BNM = false>
inline int launch_gemm_width(const CUtensorMap& amap, const CUtensorMap& amap2, const void* w,
                             const void* bias, const void* res, void* out, int G, int S, int N,
                             int K, int act, int kh, int bn, cudaStream_t stream) {
  if (bn == 256)
    return launch_gemm_tiles<256, EPI, AM, BNM>(amap, amap2, w, bias, res, out, G, S, N, K, act,
                                                kh, stream);
  if (bn == 128)
    return launch_gemm_tiles<128, EPI, AM, BNM>(amap, amap2, w, bias, res, out, G, S, N, K, act,
                                                kh, stream);
  return (int)cudaErrorInvalidValue;
}

// a (M, K), w (N, K) [BNM: (K, N), N-major], bias (N,), res and out (M, N):
// bf16 (out fp32 with EPI_F32), bases 16-byte aligned; K % 8 == 0 (and N % 8
// == 0 with the residual, the fp32 epilogue or an N-major w); bn, the tile
// width, 128 or 256. Queues one launch on `stream`; returns a cudaError_t
// code.
template <int EPI, bool BNM = false>
inline int launch_gemm(const void* a, const void* w, const void* bias, const void* res,
                       void* out, int M, int N, int K, int act, int bn, cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 8 || K % 8 != 0 || ((EPI != EPI_BIAS_ACT || BNM) && N % 8 != 0))
    return (int)cudaErrorInvalidValue;
  CUtensorMap amap;
  const int err = gemm_map_rows(&amap, a, M, K, GemmTile<128>::BM);
  if (err) return err;
  return launch_gemm_width<EPI, A_ROWS, BNM>(amap, amap, w, bias, res, out, 1, M, N, K, act, K,
                                             bn, stream);
}

// The MN-major A: a holds G groups of a (K, S) matrix, element (g, k, s) at
// a[g * ldg + k * ldk + s], ldk >= S and ldk, ldg multiples of 8; w (N, K),
// bias (N,), res and out (G * S, N): bf16, bases 16-byte aligned; K % 8 ==
// 0 (and N % 8 == 0 with the residual); bn 128 or 256. Queues one launch;
// returns a cudaError_t code.
template <int EPI>
inline int launch_gemm_mn(const void* a, long long ldk, long long ldg, const void* w,
                          const void* bias, const void* res, void* out, int G, int S, int N,
                          int K, int act, int bn, cudaStream_t stream) {
  if (G < 1 || S < 1 || N < 1 || K < 8 || K % 8 != 0 || ldk < S || ldk % 8 != 0 ||
      ldg % 8 != 0 || (G > 1 && ldg < ldk * K) || (EPI == EPI_BIAS_RESIDUAL && N % 8 != 0))
    return (int)cudaErrorInvalidValue;
  CUtensorMap amap;
  const int err = gemm_map(&amap, a, 3, S, K, G, ldk, ldg, 64);
  if (err) return err;
  return launch_gemm_width<EPI, A_MN>(amap, amap, w, bias, res, out, G, S, N, K, act, K, bn,
                                      stream);
}

// The head-leading A: x (B, heads, rows, d), element (b, h, r, j) at
// x[((b * heads + h) * rows + r) * d + j], d % 8 == 0; w (N, heads * d)
// [nn.Linear layout], bias (N,), res and out (B * rows, N): bf16, bases
// 16-byte aligned; N % 8 == 0 with the residual; bn 128 or 256. Queues one
// launch; returns a cudaError_t code.
template <int EPI>
inline int launch_gemm_heads(const void* x, const void* w, const void* bias, const void* res,
                             void* out, int B, int heads, int rows, int d, int N, int bn,
                             cudaStream_t stream) {
  if (B < 1 || heads < 1 || rows < 1 || d < 8 || d % 8 != 0 || N < 1 ||
      (EPI == EPI_BIAS_RESIDUAL && N % 8 != 0))
    return (int)cudaErrorInvalidValue;
  // (j, r, b heads + h) in (64, 128, 1) boxes, and for the k16 slices of the
  // heads' last d % 64 columns in (16, 128, 1) boxes
  CUtensorMap amap, amap2;
  int err = gemm_map(&amap, x, 3, d, rows, B * heads, d, (long long)rows * d, GemmTile<128>::BM);
  amap2 = amap;
  if (!err && d % 64 != 0)
    err = gemm_map(&amap2, x, 3, d, rows, B * heads, d, (long long)rows * d, GemmTile<128>::BM,
                   1, 16);
  if (err) return err;
  return launch_gemm_width<EPI, A_HEADS>(amap, amap2, w, bias, res, out, B, rows, N, heads * d,
                                         ACT_NONE, d, bn, stream);
}

}  // namespace cvlm
