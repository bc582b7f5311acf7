// The float32 attention loop of the fp32 kernel instances
// (qkv_packed_plain_f32.cu, qkv_windows_f32.cu, qkv_packed_global_f32.cu,
// qkv_relpos_f32.cu, attn_fullk_f32.cu): per head, o = softmax((q*scale) .
// k^T + bias) . v, all in float32. q, k and v are read through strides of
// their own (problem, head, token; AttnArgs), so one loop takes the packed qkv
// projection ([q heads | k heads | v heads] on the last axis: #13, #15, #16,
// #17, #11, #12, #19) and split tensors (#10, #20). The output is written
// d-major (OUT_DMAJOR: element (c, query) at c * ldo + query, the layout
// proj_rows_f32.cu reads) or in rows (OUT_ROWS: at query * ldo + c; the
// head-leading (B, heads, nwin, N, d) of #11 and #19, the (BB, N, dv) of #10
// and #20); problem p's output starts at (p / opn) * og + (p % opn) * ow, head
// h's oh further. q . k^T runs over DQK columns and P . V over DV (#20:
// 208 and 80). On the CUDA cores: the H100's tensor cores have no float32
// mode (TF32 keeps ~3 digits), so it is bounded by the 67 TFLOP/s FFMA rate.
//
// The bias, a template argument:
//   BIAS_NONE  none (#16, CLIP's attention; #20, whose bias rides q' . k');
//   BIAS_SEP   the separable rel-pos bias rel[q, k / W] + rel[q, H + k % W]
//              (#13's and #12's windows with H = W = win, #17's grid; #10,
//              #11 and #19 with H + W lanes), the query tile's H + W rel
//              lanes held in shared memory and read one float at a time (34
//              lanes put head h at an 8-byte offset);
//   BIAS_EDGE  #15's edge windows: each key's bias rel @ sel from its
//              window's 0/1 column of sel, a product of depth 32 riding the
//              score product ([q*scale | rel] . [k | sel column]), the dummy
//              keys' -1e30 of kmask, and the virtual pad key (logit rel lane
//              28, value vb) entered into the running max and sum before any
//              key (the JAX ref takes it into the max before any exp).
// rel's element (problem p, head h, query q, lane l) lies at
// q * rq + p * rp + h * lph + l: position-major (#13, #17), window-major
// (#15, #12) or per problem (#10, #11, #19) by the strides alone.
//
// The loop: one block of 256 threads per (problem * heads + h, 64-query
// tile): the q tile (scaled on load, as the plain version scales q before
// the product) stays in shared memory; per 64-key tile, k (transposed) and v
// are staged in shared memory, each thread computes a 4 x 4 block of
// scores, the online softmax keeps each row's running max and sum in fp32
// (the 16 threads of a row reduce with shuffles), the probabilities go
// through shared memory (transposed) into P . V, each thread 4 rows x (DV /
// 16) columns of the output: float4 groups 64 g + 4 tx for the first 64 *
// (DV / 64) columns, then single columns 16 e + tx (DV = 80: 4 + 1). Keys
// past S in the ragged last tile score -inf; queries past S are computed on
// zero rows and not stored. The output is divided by the row sums at the
// end, staged in shared memory as [column][query] and stored with
// consecutive threads on consecutive addresses: along the queries
// (d-major, 64 contiguous a row) or along the columns (rows), the ragged
// tile masked. No rounding to a working type happens anywhere. Everything
// here has internal linkage: each source that includes it keeps its own
// copy.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace cvlm {
namespace f32attn {
namespace {

constexpr int AQ = 64, AK = 64, AT = 256, AP = 4, AL = AQ + AP;
constexpr int EDGE_LANES = 32, LPAD_LANE = 28;

enum Bias { BIAS_NONE = 0, BIAS_SEP = 1, BIAS_EDGE = 2 };
enum Out { OUT_DMAJOR = 0, OUT_ROWS = 1 };

// The loop's layout, in elements: q, k, v's (problem, head, token) strides
// (each a multiple of 4, for the 16-byte loads), rel's (see the top), and
// the output's; in this order the 17 values of the `layout` array the
// strided C entries take (ops/flash_attention.py f32_split_layout,
// f32_packed_layout).

struct AttnArgs {
  const float *q, *k, *v;
  long long qp, qh, qt, kp, kh, kt, vp, vh, vt;
  float* out;
  long long opn, og, ow, oh, ldo;
  int S, heads;
  float scale;
  const float* rel;  // BIAS_SEP, BIAS_EDGE: see the top
  long long rq, rp;
  int lph;
  int H, W;             // BIAS_SEP: key k's lanes k / W and H + k % W
  const float* sel;     // BIAS_EDGE: (n, 32, S) 0/1, window p % n's key codes
  const float* kmask;   // BIAS_EDGE: (n, S), 0 real key / -1e30 dummy
  const float* vb;      // BIAS_EDGE: (heads, D), the pad key's value
  int n;                // BIAS_EDGE: windows a problem's index cycles through
};

// q, k, v as the heads of the packed qkv rows (P, S, 3 * heads * D)
inline void set_packed(AttnArgs& a, const float* qkv, int S, int heads, int D) {
  const long long c3 = 3LL * heads * D;
  a.q = qkv;
  a.k = qkv + (long long)heads * D;
  a.v = qkv + 2LL * heads * D;
  a.qp = a.kp = a.vp = (long long)S * c3;
  a.qh = a.kh = a.vh = D;
  a.qt = a.kt = a.vt = c3;
}

// the output d-major, (P, heads * D, S) with row stride ldo
inline void set_dmajor(AttnArgs& a, float* out, int heads, int D, long long ldo) {
  a.out = out;
  a.opn = 1;
  a.og = (long long)heads * D * ldo;
  a.ow = 0;
  a.oh = (long long)D * ldo;
  a.ldo = ldo;
}

// the strides of a strided entry's `layout` array
inline void set_layout(AttnArgs& a, const long long* l) {
  a.qp = l[0], a.qh = l[1], a.qt = l[2];
  a.kp = l[3], a.kh = l[4], a.kt = l[5];
  a.vp = l[6], a.vh = l[7], a.vt = l[8];
  a.rp = l[9], a.rq = l[10], a.lph = (int)l[11];
  a.opn = l[12], a.og = l[13], a.ow = l[14], a.oh = l[15], a.ldo = l[16];
}

template <int DQK, int BIAS>
__host__ __device__ constexpr int depth() {
  return BIAS == BIAS_EDGE ? DQK + EDGE_LANES : DQK;
}

// Qs [DA][AL] (q^T, reused for the output), Ks [DA][AL] (k^T), Vs [AK][DV],
// Ps [AK][AL] (p^T), then for BIAS_SEP Rs [AQ][lanes]
template <int DQK, int DV, int BIAS>
size_t attn_smem(int lanes) {
  return sizeof(float) * (2 * (size_t)depth<DQK, BIAS>() * AL + (size_t)AK * DV +
                          (size_t)AK * AL + (BIAS == BIAS_SEP ? (size_t)AQ * lanes : 0));
}

// the output column of a thread's c-th accumulator
template <int D>
__device__ __forceinline__ int out_col(int c, int tx) {
  constexpr int NG = D / 64;
  return c < 4 * NG ? 64 * (c / 4) + 4 * tx + c % 4 : 64 * NG + 16 * (c - 4 * NG) + tx;
}

template <int DQK, int DV, int BIAS, int OUT>
__global__ void __launch_bounds__(AT) attn_f32_kernel(const AttnArgs a) {
  static_assert(DV % 16 == 0, "each thread holds dv / 16 output columns");
  static_assert(DQK % 4 == 0 && DV <= DQK, "q, k rows in float4s; the output staged in Qs");
  constexpr int DA = depth<DQK, BIAS>();
  constexpr int NG = DV / 64;             // float4 column groups a thread
  constexpr int NC = DV / 16;             // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float(*Qs)[AL] = reinterpret_cast<float(*)[AL]>(smem);
  float(*Ks)[AL] = reinterpret_cast<float(*)[AL]>(smem + DA * AL);
  float(*Vs)[DV] = reinterpret_cast<float(*)[DV]>(smem + 2 * DA * AL);
  float(*Ps)[AL] = reinterpret_cast<float(*)[AL]>(smem + 2 * DA * AL + AK * DV);
  float* Rs = smem + 2 * DA * AL + AK * DV + AK * AL;  // BIAS_SEP: [AQ][lanes]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int S = a.S, heads = a.heads;
  const int q0 = blockIdx.x * AQ, ph = blockIdx.y, p = ph / heads, h = ph % heads;
  const float* base = a.q + p * a.qp + h * a.qh;
  const float* kbase = a.k + p * a.kp + h * a.kh;
  const float* vbase = a.v + p * a.vp + h * a.vh;
  constexpr int V4 = DQK / 4;  // float4s a q or k row
  const float* rel = a.rel + (size_t)p * a.rp + (size_t)h * a.lph;
  const int lanes = BIAS == BIAS_SEP ? a.H + a.W : 0;  // the query tile's rel lanes
  const int w = BIAS == BIAS_EDGE ? p % a.n : 0;

  // the q tile, scaled, transposed: Qs[c][i]
  for (int idx = tid; idx < AQ * V4; idx += AT) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) v = *reinterpret_cast<const float4*>(base + (q0 + r) * a.qt + c);
    Qs[c][r] = v.x * a.scale;
    Qs[c + 1][r] = v.y * a.scale;
    Qs[c + 2][r] = v.z * a.scale;
    Qs[c + 3][r] = v.w * a.scale;
  }
  if constexpr (BIAS == BIAS_SEP) {  // the tile's rel rows: Rs[i][lane]
    for (int idx = tid; idx < AQ * lanes; idx += AT) {
      const int r = idx / lanes, l = idx % lanes;
      Rs[idx] = q0 + r < S ? rel[(size_t)(q0 + r) * a.rq + l] : 0.f;
    }
  }
  if constexpr (BIAS == BIAS_EDGE) {  // the rel lanes below q: Qs[DQK + l][i]
    for (int idx = tid; idx < AQ * EDGE_LANES; idx += AT) {
      const int r = idx / EDGE_LANES, l = idx % EDGE_LANES;
      Qs[DQK + l][r] = q0 + r < S ? rel[(size_t)(q0 + r) * a.rq + l] : 0.f;
    }
  }

  float o[4][NC], mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }
  if constexpr (BIAS == BIAS_EDGE) {  // the pad key first: m = its logit, l = 1, o = vb
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mrow[i] = Qs[DQK + LPAD_LANE][4 * ty + i];
      lrow[i] = 1.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] = a.vb[(size_t)h * DV + out_col<DV>(c, tx)];
    }
  }

  const int nkt = (S + AK - 1) / AK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * AK;
    __syncthreads();  // the previous tile's k, v and p are no longer read
    for (int idx = tid; idx < AK * V4; idx += AT) {
      const int r = idx / V4, c = (idx % V4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      const bool has_v = DV == DQK || c < DV;  // #20: v's 80 of q and k's 208 columns
      if (j0 + r < S) {
        kv = *reinterpret_cast<const float4*>(kbase + (j0 + r) * a.kt + c);
        if (has_v) vv = *reinterpret_cast<const float4*>(vbase + (j0 + r) * a.vt + c);
      }
      Ks[c][r] = kv.x;
      Ks[c + 1][r] = kv.y;
      Ks[c + 2][r] = kv.z;
      Ks[c + 3][r] = kv.w;
      if (has_v) *reinterpret_cast<float4*>(&Vs[r][c]) = vv;
    }
    if constexpr (BIAS == BIAS_EDGE) {  // the keys' sel columns below k: Ks[DQK + l][j]
      for (int idx = tid; idx < EDGE_LANES * AK; idx += AT) {
        const int l = idx / AK, r = idx % AK;
        Ks[DQK + l][r] = j0 + r < S ? a.sel[((size_t)w * EDGE_LANES + l) * S + j0 + r] : 0.f;
      }
    }
    __syncthreads();

    // scores of rows 4 ty + i against keys 4 tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DA; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[c][4 * ty]);
      const float4 kb = *reinterpret_cast<const float4*>(&Ks[c][4 * tx]);
      const float q[4] = {qa.x, qa.y, qa.z, qa.w}, k[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(q[i], k[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = j0 + 4 * tx + j;
      if (key >= S) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;
      } else if constexpr (BIAS == BIAS_SEP) {
        const int lh = key / a.W, lw = a.H + key % a.W;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* rr = Rs + (4 * ty + i) * lanes;
          s[i][j] += rr[lh] + rr[lw];
        }
      } else if constexpr (BIAS == BIAS_EDGE) {
        const float km = a.kmask[(size_t)w * S + key];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] += km;
      }
    }

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
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[4 * tx + j][4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // o[rows 4 ty + i][out_col(c)] += p . v
#pragma unroll 8
    for (int j = 0; j < AK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[j][4 * ty]);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
      float v[NC];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vb = *reinterpret_cast<const float4*>(&Vs[j][64 * g + 4 * tx]);
        v[4 * g] = vb.x;
        v[4 * g + 1] = vb.y;
        v[4 * g + 2] = vb.z;
        v[4 * g + 3] = vb.w;
      }
#pragma unroll
      for (int c = 4 * NG; c < NC; ++c) v[c] = Vs[j][out_col<DV>(c, tx)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) o[i][c] = fmaf(pr[i], v[c], o[i][c]);
    }
  }

  // o / l staged as [column][query] in the q tile's place (no thread reads
  // Qs after the last tile's barrier before P . V), then stored
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.0f / lrow[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) Qs[out_col<DV>(c, tx)][4 * ty + i] = o[i][c] * inv;
  }
  __syncthreads();
  float* dst = a.out + (p / a.opn) * a.og + (p % a.opn) * a.ow + h * a.oh;
  if constexpr (OUT == OUT_DMAJOR) {  // 64 contiguous queries a column
    dst += q0;
    for (int idx = tid; idx < DV * AQ; idx += AT) {
      const int c = idx / AQ, r = idx % AQ;
      if (q0 + r < S) dst[(size_t)c * a.ldo + r] = Qs[c][r];
    }
  } else {  // DV contiguous columns a query
    dst += (size_t)q0 * a.ldo;
    for (int idx = tid; idx < AQ * DV; idx += AT) {
      const int r = idx / DV, c = idx % DV;
      if (q0 + r < S) dst[(size_t)r * a.ldo + c] = Qs[c][r];
    }
  }
}

// Queues the loop over P problems of `a.heads` heads; returns a cudaError_t
// code (cudaErrorInvalidValue where the grid, the shared memory or the
// layout cannot hold the shapes).
template <int DQK, int DV, int BIAS, int OUT>
int launch_attn(const AttnArgs& a, int P, cudaStream_t s) {
  const long long strides[] = {a.qp, a.qh, a.qt, a.kp, a.kh, a.kt, a.vp, a.vh, a.vt};
  bool aligned = true;
  for (long long st : strides) aligned = aligned && st % 4 == 0;
  const float* bases[] = {a.q, a.k, a.v};
  for (const float* ptr : bases) aligned = aligned && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  if (P < 1 || a.S < 1 || a.heads < 1 || a.opn < 1 || !aligned ||
      a.ldo < (OUT == OUT_DMAJOR ? a.S : DV) || (long long)P * a.heads > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = attn_smem<DQK, DV, BIAS>(BIAS == BIAS_SEP ? a.H + a.W : 0);
  static size_t allowed = 0;  // the opt-in above 48 KB, raised as shapes need
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(attn_f32_kernel<DQK, DV, BIAS, OUT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const dim3 grid((a.S + AQ - 1) / AQ, P * a.heads);
  attn_f32_kernel<DQK, DV, BIAS, OUT><<<grid, AT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// d = dqk = dv: 64 (CLIP ViT-L/14's, SAM ViT-B's) or 80 (SAM ViT-H's)
template <int BIAS, int OUT = OUT_DMAJOR>
int dispatch_attn(const AttnArgs& a, int d, int P, cudaStream_t s) {
  if (d == 64) return launch_attn<64, 64, BIAS, OUT>(a, P, s);
  if (d == 80) return launch_attn<80, 80, BIAS, OUT>(a, P, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace f32attn
}  // namespace cvlm
