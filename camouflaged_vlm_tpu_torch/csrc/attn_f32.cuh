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
// The loop, one block per (problem * heads + h, query tile of QT rows):
//   - each warp owns 16 whole query rows (QT / 16 warps) for the scores, the
//     softmax and P . V alike; its q rows, copied by cp.async (with the
//     rel lanes) in one group ahead of the ring's and scaled in place (as
//     the plain version scales q before the product), stay in shared
//     memory, [row][DA] with 16-byte chunks XOR-swizzled (common.cuh
//     swizzle_chunk), read along the depth;
//   - the keys stream in 64-key tiles through a ring of KST stages of
//     cp.async copies (common.cuh cp16): k copied as it lies, [key][depth]
//     swizzled, in stages of the whole depth DA (DC = 0: one step a key tile)
//     or of DC = 32 columns (one step per 32 columns of the depth, sgemm's
//     k tiles: #20's 208-deep q' and k' do not fit whole beside a 128-row
//     q' tile); v [key][DV] as it lies, copied with a tile's first step into
//     one of two buffers; ragged tiles zero-filled by the copies' source size
//     (nothing past S is read); one block-wide barrier a step;
//   - lane (ry, cx) = (lane / 8, lane % 8) of a warp holds rows ry + 4 i
//     (i < 4) against keys cx + 8 j (j < 8): 4 x 8 scores, each 4-deep step
//     4 + 8 16-byte reads for 128 FFMA, no bank conflicts;
//   - the online softmax with exp(x - m) as exp2f(fmaf(x, log2 e, -m log2
//     e)): one FFMA where a subtraction was (pre-scaling q by log2 e instead
//     costs one more rounding of every logit, twice the error against the
//     plain version in tests/test_torch_attn_plan.py's emulation); each
//     row's running max and sum over its 8 lanes (3 shuffles), the rescale
//     once a key tile;
//   - P through a slice of shared memory private to the warp ([key][16
//     rows], __syncwarp), then P . V with the same lane holding rows ry + 4 i
//     against columns 4 cx + 32 g (g < DV / 32) and, at DV = 80, 64 + 2 cx:
//     4 x DV / 8 outputs, 3 (DV 64) or 4 (DV 80) reads a key for 32 or 40
//     FFMA; warps whose rows all lie past S skip the arithmetic;
//   - the output divided by the row sums at the end: in rows straight from
//     the registers (8 lanes a row, 16-byte stores), d-major staged in the
//     warp's own q rows as [column][16 queries] and stored along the queries.
// The tiles (QT, DC, KST), in the order of the `tile` argument
// (ops/flash_attention.py F32_ATTN_TILES, picked per shape by
// f32_attn_plan): 0 <128, 0, 2>, 1 <128, 32, 3>, 2 <64, 32, 2> (64 rows with
// whole-depth stages, one block of 4 warps an SM at d = 80, won no shape of
// the paths in `cli/kernel_timing.py --f32-attention --tiles`: not instantiated).
// Dynamic shared memory, floats: QT DA (q) + KST 64 KD (k, KD = DC or DA) +
// 2 64 DV (v) + 64 QT (P) + QT (H + W) (BIAS_SEP's rel rows); attn_smem.
// Bytes of the instances at their paths' shapes, tiles 0 1 2 ("-": none;
// tests/test_torch_attn_plan.py holds ops/flash_attention.py f32_attn_smem
// to them):
//   #16  64/64  none 0 lanes:    131072  122880   81920
//   #13  80/80  sep 28 lanes:    169984  153600  101376
//   #15  80/80  edge 0 lanes:    188416  155648  102400
//   #17  80/80  sep 128 lanes:   221184  204800  126976
//   #12  80/80  sep 32 lanes:    172032  155648  102400
//   #11  80/80  sep 34 lanes:    173056  156672  102912
//   #10  64/64  sep 28 lanes:    145408  137216   89088
//   #10  64/64  sep 128 lanes:   196608  188416  114688
//   #20  208/80 none 0 lanes:              -  204800  126976
//   #20  128/64 none 0 lanes:    196608  155648   98304
// No rounding to a working type happens anywhere; no atomics: two calls are
// bit-equal. Everything here has internal linkage: each source that includes
// it keeps its own copy.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace cvlm {
namespace f32attn {
namespace {

constexpr int AK = 64;     // keys a tile
constexpr int WR = 16;     // query rows a warp
constexpr int EDGE_LANES = 32, LPAD_LANE = 28;
constexpr int VBUF = 2;    // v buffers
constexpr float LOG2E = 1.4426950408889634f;

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

// A block tile: QT query rows (QT / 16 warps), k stages of DC columns (0:
// the whole depth) in a ring of KST; launched for MIN_BLOCKS co-resident
// blocks an SM (a 128-row block alone, two of 64 rows: 255 registers a
// thread either way, where ptxas would otherwise aim 64-row blocks at three
// an SM and spill)
template <int QT_, int DC_, int KST_>
struct ATile {
  static constexpr int QT = QT_, DC = DC_, KST = KST_, THREADS = 2 * QT_;
  static constexpr int MIN_BLOCKS = QT_ == 128 ? 1 : 2;
  static_assert(QT == 64 || QT == 128, "16 rows a warp, 4 or 8 warps");
  static_assert(DC == 0 || DC == 32, "whole-depth or 32-deep k stages");
};

// The dynamic shared memory (bytes) of a block: Qs [QT][DA], Ks [KST][64][KD],
// Vs [2][64][DV], Ps [QT / 16][64][16], then for BIAS_SEP Rs [QT][lanes]
template <int DQK, int DV, int BIAS, class TL>
size_t attn_smem(int lanes) {
  constexpr int DA = depth<DQK, BIAS>(), KD = TL::DC ? TL::DC : DA;
  return sizeof(float) * ((size_t)TL::QT * DA + (size_t)TL::KST * AK * KD +
                          (size_t)VBUF * AK * DV + (size_t)TL::QT * AK +
                          (BIAS == BIAS_SEP ? (size_t)TL::QT * lanes : 0));
}

// the output column of a thread's c-th accumulator: 4 cx + 32 g + (c % 4)
// for c < 4 NG, then (DV % 32 == 16) 32 NG + 2 cx + (c - 4 NG)
template <int DV>
__device__ __forceinline__ int out_col(int c, int cx) {
  constexpr int NG = DV / 32;
  return c < 4 * NG ? 32 * (c / 4) + 4 * cx + c % 4 : 32 * NG + 2 * cx + (c - 4 * NG);
}

// s[i][j] += q[row i] . k[key j] over NC4 16-byte chunks: the thread's q
// rows at smem offsets qo[i] (chunk cq0 + c of a row of CQ chunks, row
// index qr[i]), its keys at ko + 8 j rows of CK chunks (row index cx + 8 j:
// the same swizzle for every j)
template <int NC4, int CQ, int CK>
__device__ __forceinline__ void qk_chunks(float (&s)[4][8], const float* smem, const int (&qo)[4],
                                          const int (&qr)[4], int cq0, int ko, int cx) {
#pragma unroll
  for (int c = 0; c < NC4; ++c) {
    float4 a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(smem + qo[i] +
                                              4 * swizzle_chunk<CQ>(cq0 + c, qr[i]));
    const int kc = ko + 4 * swizzle_chunk<CK>(c, cx);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float4*>(smem + kc + 8 * j * 4 * CK);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

template <int DQK, int DV, int BIAS, int OUT, class TL>
__global__ void __launch_bounds__(TL::THREADS, TL::MIN_BLOCKS)
    attn_f32_kernel(const AttnArgs a) {
  constexpr int QT = TL::QT, T = TL::THREADS, KST = TL::KST;
  constexpr int DA = depth<DQK, BIAS>();
  constexpr int KD = TL::DC ? TL::DC : DA;   // the columns of a k stage
  constexpr int NCH = (DA + KD - 1) / KD;    // steps a key tile
  constexpr int LAST = DA - (NCH - 1) * KD;  // the last step's columns
  constexpr int CQ = DA / 4, CK = KD / 4;    // 16-byte chunks a q row, a k stage row
  constexpr int NG = DV / 32, NO = 4 * NG + (DV % 32 ? 2 : 0);  // output columns a lane
  static_assert(DQK % 32 == 0 || DQK % 32 == 16, "q, k rows of 16-byte chunks, 4 or 8 mod 8");
  static_assert(DV % 32 == 0 || DV % 32 == 16, "float4 groups of 32 columns, a float2 tail");
  static_assert(DV <= DA && LAST % 4 == 0, "the output staged in the warp's q rows");
  static_assert((VBUF - 1) * NCH >= KST - 1, "a v buffer is rewritten only after its tile's P . V");
  extern __shared__ __align__(16) float smem[];
  constexpr int QS = 0, KS = QS + QT * DA, VS = KS + KST * AK * KD, PS = VS + VBUF * AK * DV,
                RS = PS + QT * AK;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ry = lane / 8, cx = lane % 8, wq = warp * WR;
  const int S = a.S, heads = a.heads;
  const int q0 = blockIdx.x * QT, ph = blockIdx.y, p = ph / heads, h = ph % heads;
  const float* qbase = a.q + p * a.qp + h * a.qh;
  const float* kbase = a.k + p * a.kp + h * a.kh;
  const float* vbase = a.v + p * a.vp + h * a.vh;
  const float* rel = a.rel + (size_t)p * a.rp + (size_t)h * a.lph;
  const int lanes = BIAS == BIAS_SEP ? a.H + a.W : 0;  // the query tile's rel lanes
  const int w = BIAS == BIAS_EDGE ? p % a.n : 0;
  const int nkt = (S + AK - 1) / AK, steps = nkt * NCH;

  // queue step t's copies: k tile t / NCH, columns (t % NCH) KD.., into
  // stage t % KST; with a tile's first step its v into buffer (t / NCH) % 2
  auto issue = [&](int t) {
    const int kt = t / NCH, ch = t % NCH, j0 = kt * AK;
    const int chunks = ch == NCH - 1 ? LAST / 4 : CK;  // the depth's ragged last step
    float* ks = smem + KS + (t % KST) * AK * KD;
#pragma unroll
    for (int idx = tid; idx < AK * CK; idx += T) {
      const int r = idx / CK, c = idx % CK, col = ch * KD + 4 * c;
      if (c >= chunks) continue;
      const bool in = j0 + r < S;
      float* dst = ks + r * KD + 4 * swizzle_chunk<CK>(c, r);
      if (BIAS != BIAS_EDGE || col < DQK) {
        cp16(dst, in ? kbase + (size_t)(j0 + r) * a.kt + col : kbase, in ? 16 : 0);
      } else {  // the key's sel column below k: [k | sel[w][:, key]]
        const float* sp = a.sel + ((size_t)w * EDGE_LANES + col - DQK) * S + j0 + r;
#pragma unroll
        for (int e = 0; e < 4; ++e) cp4(dst + e, in ? sp + (size_t)e * S : a.sel, in ? 4 : 0);
      }
    }
    if (ch == 0) {
      float* vs = smem + VS + kt % VBUF * AK * DV;
      for (int idx = tid; idx < AK * (DV / 4); idx += T) {
        const int r = idx / (DV / 4), c = 4 * (idx % (DV / 4));
        const bool in = j0 + r < S;
        cp16(vs + r * DV + c, in ? vbase + (size_t)(j0 + r) * a.vt + c : vbase, in ? 16 : 0);
      }
    }
  };
  // the warp's q rows copied as they lie, swizzled: Qs[wq + r][.]; for
  // BIAS_EDGE the rel lanes below q, for BIAS_SEP the rows' rel lanes into
  // Rs (4-byte copies): one copy group ahead of the ring's, so that their
  // latency overlaps the first k and v tiles'
#pragma unroll
  for (int idx = lane; idx < WR * CQ; idx += 32) {
    const int r = idx / CQ, c = idx % CQ, row = q0 + wq + r, col = 4 * c;
    const bool in = row < S;
    float* dst = smem + QS + (wq + r) * DA + 4 * swizzle_chunk<CQ>(c, wq + r);
    if (BIAS != BIAS_EDGE || col < DQK) {
      cp16(dst, in ? qbase + (size_t)row * a.qt + col : qbase, in ? 16 : 0);
    } else {
      const float* rr = rel + (size_t)row * a.rq + col - DQK;
#pragma unroll
      for (int e = 0; e < 4; ++e) cp4(dst + e, in ? rr + e : rel, in ? 4 : 0);
    }
  }
  if constexpr (BIAS == BIAS_SEP) {
    for (int idx = lane; idx < WR * lanes; idx += 32) {
      const int r = idx / lanes, l = idx % lanes, row = q0 + wq + r;
      cp4(smem + RS + (wq + r) * lanes + l, row < S ? rel + (size_t)row * a.rq + l : rel,
          row < S ? 4 : 0);
    }
  }
  cp_commit();
#pragma unroll
  for (int t = 0; t < KST - 1; ++t) {
    if (t < steps) issue(t);
    cp_commit();
  }
  // q scaled in place (the plain version scales q before the product), each
  // lane its own chunks once they have landed
  cp_wait<KST - 1>();
#pragma unroll
  for (int idx = lane; idx < WR * CQ; idx += 32) {
    const int r = idx / CQ, c = idx % CQ;
    if (BIAS == BIAS_EDGE && 4 * c >= DQK) continue;
    float4* qp = reinterpret_cast<float4*>(smem + QS + (wq + r) * DA +
                                           4 * swizzle_chunk<CQ>(c, wq + r));
    const float4 v = *qp;
    *qp = make_float4(v.x * a.scale, v.y * a.scale, v.z * a.scale, v.w * a.scale);
  }
  __syncwarp();

  // the thread's q rows wq + ry + 4 i: offsets and row indices; its keys'
  // stage offset (row cx)
  int qo[4], qr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qr[i] = wq + ry + 4 * i;
    qo[i] = QS + qr[i] * DA;
  }
  const bool active = q0 + wq < S;  // a warp whose rows all lie past S only copies
  float o[4][NO], mrow[4], lrow[4], s[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NO; ++c) o[i][c] = 0.f;
  }
  if constexpr (BIAS == BIAS_EDGE) {  // the pad key first: m = its logit, l = 1, o = vb
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mrow[i] = smem[qo[i] + 4 * swizzle_chunk<CQ>((DQK + LPAD_LANE) / 4, qr[i]) + LPAD_LANE % 4];
      lrow[i] = 1.f;
#pragma unroll
      for (int c = 0; c < NO; ++c) o[i][c] = a.vb[(size_t)h * DV + out_col<DV>(c, cx)];
    }
  }

  const int pw = PS + warp * AK * WR;  // the warp's P: [key][16 rows]
  for (int t = 0, kt = 0, ch = 0; t < steps; ++t) {
    cp_wait<KST - 2>();  // this thread's copies of step t have landed
    __syncthreads();     // everyone's; and step t - 1's stage (tile t / NCH - 1's v) is read
    if (t + KST - 1 < steps) issue(t + KST - 1);
    cp_commit();
    if (active) {
      const int ko = KS + (t % KST) * AK * KD + cx * KD;
      if (ch == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      }
      float km[8];  // BIAS_EDGE: the tile's kmask, loaded ahead of the product
      if constexpr (BIAS == BIAS_EDGE) {
        if (ch == NCH - 1) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int key = kt * AK + cx + 8 * j;
            km[j] = key < S ? a.kmask[(size_t)w * S + key] : 0.f;
          }
        }
      }
      if constexpr (LAST == KD) {
        qk_chunks<CK, CQ, CK>(s, smem, qo, qr, ch * CK, ko, cx);
      } else {  // the depth's ragged last step (208 = 6 x 32 + 16)
        if (ch < NCH - 1)
          qk_chunks<CK, CQ, CK>(s, smem, qo, qr, ch * CK, ko, cx);
        else
          qk_chunks<LAST / 4, CQ, CK>(s, smem, qo, qr, ch * CK, ko, cx);
      }
      if (ch == NCH - 1) {
        const int j0 = kt * AK;
        // the bias, the ragged tile's keys past S at -inf
        if constexpr (BIAS == BIAS_SEP) {
          const int kk = j0 + cx;
          int lh = kk / a.W, lw = kk - lh * a.W;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (kk + 8 * j < S) {  // a key past S has no lanes
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float* rr = smem + RS + qr[i] * lanes;
                s[i][j] += rr[lh] + rr[a.H + lw];
              }
            }
            lw += 8;
            while (lw >= a.W) {
              lw -= a.W;
              ++lh;
            }
          }
        } else if constexpr (BIAS == BIAS_EDGE) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i][j] += km[j];
        }
        if (j0 + AK > S) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j0 + cx + 8 * j >= S) {
#pragma unroll
              for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;
            }
        }
        // the online softmax, exp(x - m) as exp2f(x log2 e - m log2 e) (one
        // FFMA): each row's 64 scores on the 8 lanes of its ry
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float mx = s[i][0];
#pragma unroll
          for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
          for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float mnew = fmaxf(mrow[i], mx);  // finite: every tile holds a key < S
          const float ml = mnew * LOG2E;
          const float alpha = exp2f(fmaf(mrow[i], LOG2E, -ml));
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[i][j] = exp2f(fmaf(s[i][j], LOG2E, -ml));
            sum += s[i][j];
          }
#pragma unroll
          for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
          lrow[i] = lrow[i] * alpha + sum;
          mrow[i] = mnew;
#pragma unroll
          for (int c = 0; c < NO; ++c) o[i][c] *= alpha;
        }
        // P through the warp's slice: Ps[key][4 ry + i]
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float4*>(smem + pw + (cx + 8 * j) * WR + 4 * ry) =
              make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        __syncwarp();
        // o[rows ry + 4 i][out_col(c)] += p . v
        const float* vs = smem + VS + kt % VBUF * AK * DV;
#pragma unroll 8
        for (int key = 0; key < AK; ++key) {
          const float4 pa = *reinterpret_cast<const float4*>(smem + pw + key * WR + 4 * ry);
          const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
          float v[NO];
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const float4 vv = *reinterpret_cast<const float4*>(vs + key * DV + 32 * g + 4 * cx);
            v[4 * g] = vv.x;
            v[4 * g + 1] = vv.y;
            v[4 * g + 2] = vv.z;
            v[4 * g + 3] = vv.w;
          }
          if constexpr (NO > 4 * NG) {
            const float2 vv = *reinterpret_cast<const float2*>(vs + key * DV + 32 * NG + 2 * cx);
            v[4 * NG] = vv.x;
            v[4 * NG + 1] = vv.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < NO; ++c) o[i][c] = fmaf(pr[i], v[c], o[i][c]);
        }
      }
    }
    if (++ch == NCH) {
      ch = 0;
      ++kt;
    }
  }
  if (!active) return;

  // o / l, stored
  float* dst = a.out + (p / a.opn) * a.og + (p % a.opn) * a.ow + h * a.oh;
  if constexpr (OUT == OUT_ROWS) {  // 8 lanes a row: 16-byte (and 8-byte) stores
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + qr[i];
      if (row >= S) continue;
      const float inv = 1.0f / lrow[i];
      float* d = dst + (size_t)row * a.ldo;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        *reinterpret_cast<float4*>(d + 32 * g + 4 * cx) =
            make_float4(o[i][4 * g] * inv, o[i][4 * g + 1] * inv, o[i][4 * g + 2] * inv,
                        o[i][4 * g + 3] * inv);
      if constexpr (NO > 4 * NG)
        *reinterpret_cast<float2*>(d + 32 * NG + 2 * cx) =
            make_float2(o[i][4 * NG] * inv, o[i][4 * NG + 1] * inv);
    }
  } else {  // staged as [column][16 queries] in the warp's q rows, stored along the queries
    float* stage = smem + QS + wq * DA;
    __syncwarp();  // every lane's last scores have read the warp's q rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float inv = 1.0f / lrow[i];
#pragma unroll
      for (int c = 0; c < NO; ++c) stage[out_col<DV>(c, cx) * WR + ry + 4 * i] = o[i][c] * inv;
    }
    __syncwarp();
    dst += q0 + wq;
    for (int idx = lane; idx < DV * WR; idx += 32) {
      const int c = idx / WR, r = idx % WR;
      if (q0 + wq + r < S) dst[(size_t)c * a.ldo + r] = stage[idx];
    }
  }
}

// Queues the loop over P problems of `a.heads` heads at tile TL; returns a
// cudaError_t code (cudaErrorInvalidValue where the grid, the shared memory
// or the layout cannot hold the shapes).
template <int DQK, int DV, int BIAS, int OUT, class TL>
int launch_tile(const AttnArgs& a, int P, cudaStream_t s) {
  const long long strides[] = {a.qp, a.qh, a.qt, a.kp, a.kh, a.kt, a.vp, a.vh, a.vt};
  bool aligned = true;
  for (long long st : strides) aligned = aligned && st % 4 == 0;
  const float* bases[] = {a.q, a.k, a.v};
  for (const float* ptr : bases) aligned = aligned && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  if (OUT == OUT_ROWS)  // the 16-byte row stores
    aligned = aligned && reinterpret_cast<uintptr_t>(a.out) % 16 == 0 && a.ldo % 4 == 0 &&
              a.og % 4 == 0 && a.ow % 4 == 0 && a.oh % 4 == 0;
  if (P < 1 || a.S < 1 || a.heads < 1 || a.opn < 1 || !aligned ||
      a.ldo < (OUT == OUT_DMAJOR ? a.S : DV) || (long long)P * a.heads > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = attn_smem<DQK, DV, BIAS, TL>(BIAS == BIAS_SEP ? a.H + a.W : 0);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // 227 KB a block
  static size_t allowed = 0;  // the opt-in above 48 KB, raised as shapes need
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(attn_f32_kernel<DQK, DV, BIAS, OUT, TL>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const dim3 grid((a.S + TL::QT - 1) / TL::QT, P * a.heads);
  attn_f32_kernel<DQK, DV, BIAS, OUT, TL><<<grid, TL::THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// `tile` t runs case t (ops/flash_attention.py F32_ATTN_TILES); the
// instances at DQK = 208 take no tile 0 (its whole-depth stages beside a
// 128-row q' tile exceed 227 KB)
template <int DQK, int DV, int BIAS, int OUT>
int launch_attn(const AttnArgs& a, int P, int tile, cudaStream_t s) {
  switch (tile) {
    case 0:
      if constexpr (depth<DQK, BIAS>() <= 128)
        return launch_tile<DQK, DV, BIAS, OUT, ATile<128, 0, 2>>(a, P, s);
      else
        return (int)cudaErrorInvalidValue;
    case 1:
      return launch_tile<DQK, DV, BIAS, OUT, ATile<128, 32, 3>>(a, P, s);
    case 2:
      return launch_tile<DQK, DV, BIAS, OUT, ATile<64, 32, 2>>(a, P, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// d = dqk = dv: 64 (CLIP ViT-L/14's, SAM ViT-B's) or 80 (SAM ViT-H's)
template <int BIAS, int OUT = OUT_DMAJOR>
int dispatch_attn(const AttnArgs& a, int d, int P, int tile, cudaStream_t s) {
  if (d == 64) return launch_attn<64, 64, BIAS, OUT>(a, P, tile, s);
  if (d == 80) return launch_attn<80, 80, BIAS, OUT>(a, P, tile, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory (bytes) of a block at (dqk, dv), bias mode,
// tile and rel lanes; -1 where no tile or depth takes them.
inline long long smem_bytes(int dqk, int dv, int bias, int tile, int lanes) {
  const int da = bias == BIAS_EDGE ? dqk + EDGE_LANES : dqk;
  const int qts[] = {128, 128, 64}, dcs[] = {0, 32, 32}, ksts[] = {2, 3, 2};
  if (tile < 0 || tile > 2 || dqk % 16 || dv % 16 || dv > da || (tile == 0 && da > 128))
    return -1;
  const long long qt = qts[tile], kd = dcs[tile] ? dcs[tile] : da;
  return 4 * (qt * da + ksts[tile] * AK * kd + (long long)VBUF * AK * dv + qt * AK +
              (bias == BIAS_SEP ? qt * lanes : 0));
}

}  // namespace
}  // namespace f32attn
}  // namespace cvlm
