// qkv_packed_plain: per head, o = softmax((q*scale) . k^T) . v, no bias,
// read straight from the packed qkv projection, written d-major.
//
// Replaces flash_qkv_packed_plain of camouflaged_vlm_tpu/ops/flash_attention.py
// (_qkv_packed_plain_kernel): CLIP vision attention. Input qkv (B, S, 3*H*d)
// with the last axis laid out [q heads | k heads | v heads]; output
// (B, H*d, S) with row stride ldo, the d-major layout proj_rows reads.
// Shapes on the main path (bf16): S = 577 + 4 VPT = 581, 16 heads, d = 64,
// 24 layers x 2 passes.
//
// What bounds it on the H100: the bytes, 7.1 MB of qkv and 2.4 MB of output
// at B = 2 (0.0028 ms at 3.35 TB/s); the products are 1.4 GFLOP (0.0014
// ms). At this size the fixed costs decide, not either: on the H100,
// ablated builds of a 2-warpgroup version spent most of their time with no
// products, softmax or stores at all (the launch, the TMA loads, the ring's
// round trips, a second round of blocks), and much of the rest in the
// 2-byte stores of the ragged d-major rows. The kernel is attn_sm90.cuh's
// one-pass streaming kernel, shaped against those costs:
//   * three consumer warpgroups, 192 queries a block: B = 2 makes 4 x 16 x
//     2 = 128 blocks, one round on 132 SMs (64 queries a block made 320
//     blocks, 3 per SM; 128 made 160 blocks, 28 in a second round);
//   * a ring as deep as a head's keys: 10 stages of 64-key k and v tiles at
//     d = 64 (plain_stages), so the producer issues every TMA load of
//     CLIP's 581 keys at once and never waits for a slot;
//   * q buffers with 8 spare rows, so that the epilogue writes each d-major
//     row with aligned 16-byte stores wherever it starts (store_o_dmajor,
//     LDB = 72; the wrapper's row stride, 584 at N = 581, starts every row
//     aligned).
// Per key tile the consumers run wgmma for Q K^T and P V (P as the register
// A operand) with the online softmax in registers between them; any S
// streams, and a ragged last tile's keys past S are masked.
//
// Rounding: one pass moves one rounding point against the JAX `ref`
// (flash_attention.py:895-905): P is rounded to bf16 unnormalised and O
// divided by the fp32 row sum at the end, as in #17 (qkv_packed_global.cu).
#include "attn_sm90.cuh"

namespace cvlm {

// ring stages: as many 64-key k and v tiles as ~210 KB of shared memory holds
// beside three q buffers, at most 10 (CLIP's 581 keys): 10 at d = 64
constexpr int plain_stages(int dh) {
  return (210 * 1024 - 3 * 72 * dh * 2) / (4 * 64 * dh) < 10
             ? (210 * 1024 - 3 * 72 * dh * 2) / (4 * 64 * dh)
             : 10;
}

template <int DH>
int launch_plain(const void* qkv, void* out, int B, int S, int ldo, int heads, float scale,
                 cudaStream_t s) {
  return launch_stream<DH, 3, plain_stages(DH)>(qkv, out, B, S, ldo, heads, scale, s);
}

}  // namespace cvlm

// qkv (B, S, 3*heads*d), out (B, heads*d, S) with row stride ldo >= S: bf16.
// d in {16, 32, 64, 80, 128}, any S. Returns a cudaError_t code.
extern "C" int cvlm_qkv_packed_plain(const void* qkv, void* out, int B, int S, int ldo,
                                     int heads, int d, float scale, void* stream) {
  using namespace cvlm;
  if (ldo < S) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_plain<16>(qkv, out, B, S, ldo, heads, scale, s);
    case 32: return launch_plain<32>(qkv, out, B, S, ldo, heads, scale, s);
    case 64: return launch_plain<64>(qkv, out, B, S, ldo, heads, scale, s);
    case 80: return launch_plain<80>(qkv, out, B, S, ldo, heads, scale, s);
    case 128: return launch_plain<128>(qkv, out, B, S, ldo, heads, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
