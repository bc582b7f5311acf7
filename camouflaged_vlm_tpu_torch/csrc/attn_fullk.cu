// attn_fullk: softmax(q_aug . k_aug^T) . v over augmented features, q_aug
// pre-scaled.
//
// Replaces flash_attention_fullk of camouflaged_vlm_tpu/ops/flash_attention.py
// (`_kernel`, TPU kernel #20): the global blocks of SAM's 'aug_flash' path,
// whose q_aug = [q * scale | rel_h | rel_w] and k_aug = [k | onehot(kh) |
// onehot(kw)] carry the decomposed rel-pos bias as extra features
// (ops/aug_attention.py). At SAM ViT-H per image: q_aug, k_aug (16, 4096,
// 208) (80 + 64 + 64; the TPU path pads to 256, this kernel takes the
// multiple of 16 the MMA needs), v (16, 4096, 80) (the TPU path pads to 128).
// The TPU kernel holds whole 4096-wide score rows in VMEM; a block here
// cannot (64 rows x 4096 x 4 B = 1 MB), so it tiles the keys in two passes
// (attn_split.cuh) and keeps the fp32 normalisation before the bf16
// rounding of p.
//
// What bounds it on the H100 (batch 1): 2 N^2 (208 + 80) per head, ~155
// GFLOP, compute-bound (~156 us at 989 TFLOP/s); 208-wide q and k tiles
// take 53 KB of the block's shared memory. The design is attn_split.cuh's
// simple two-pass WMMA kernel; see its note.
#include "attn_split.cuh"

// q_aug, k_aug (BB, N, d), v (BB, N, dv), out (BB, N, dv): bf16;
// d % 16 == 0, d <= 256; dv in {64, 80} (SAM ViT-B, ViT-H). Returns
// cudaGetLastError().
extern "C" int cvlm_attn_fullk(const void* q, const void* k, const void* v, void* out, int BB,
                               int N, int d, int dv, void* stream) {
  return cvlm::dispatch_split<false>(q, k, v, nullptr, out, BB, N, 1, 1, d, dv,
                                     static_cast<cudaStream_t>(stream));
}
