// attn_relpos: softmax(q . k^T + rel_h[q, k / W] + rel_w[q, H + k % W]) . v
// over split q, k, v, q pre-scaled.
//
// Replaces flash_attention_relpos of camouflaged_vlm_tpu/ops/flash_attention.py
// (`_relpos_kernel`, TPU kernel #10): SAM's unfused 'flash' attention, taken
// when num_heads % 8 != 0. At SAM ViT-B (12 heads x 64) per image: the 8
// windowed blocks' q, k, v (300, 196, 64) (25 padded 14 x 14 windows x 12
// heads) with rel (300, 196, 28), and the 4 global blocks' (12, 4096, 64)
// with rel (12, 4096, 128). The TPU kernel adds the bias as one product of
// rel with the 0/1 scatter `sel`; here it is gathered from the two lanes
// each key maps to (attn_split.cuh), and `sel` is not read. The TPU path
// pads d to 128; this kernel takes d = 64 as it is.
//
// What bounds it on the H100 (batch 1): the windowed blocks move ~33 MB and
// do ~3 GFLOP (memory-bound, ~10 us at 3.35 TB/s); the global ones do
// ~52 GFLOP (compute-bound, ~52 us at 989 TFLOP/s). The design is
// attn_split.cuh's simple two-pass WMMA kernel; see its note.
#include "attn_split.cuh"

// q, k (BB, N, d), v (BB, N, dv), rel (BB, N, H+W), out (BB, N, dv): bf16;
// N == H * W; d % 16 == 0, d <= 256; dv in {64, 80} (SAM ViT-B, ViT-H). Returns
// cudaGetLastError().
extern "C" int cvlm_attn_relpos(const void* q, const void* k, const void* v, const void* rel,
                                void* out, int BB, int N, int H, int W, int d, int dv,
                                void* stream) {
  return cvlm::dispatch_split<true>(q, k, v, rel, out, BB, N, H, W, d, dv,
                                    static_cast<cudaStream_t>(stream));
}
