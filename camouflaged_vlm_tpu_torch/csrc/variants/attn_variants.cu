// attn_variants: the arrangements of the padded carry's attention kernels
// that their dispatchers do not pick, for an on-card A/B
// (camouflaged_vlm_tpu_torch/cli/attn_variants.py builds this file into its
// own library; the package never links it).
//   #12 qkv_windows_s_kernel<80, 256, false, QST>: QST = 1 (the dispatcher's
//       pick at 256 keys, two blocks an SM) or 2 q' stages (one block).
//   #11/#19 qkv_relpos_kernel<80, NWG, MODE, RES, false>: streaming or
//       resident k/v, NWG consumer warpgroups, the bias gathered, in
//       registers or on the tensor cores.
//   #18 attn_bwd_query_kernel<80, 128, REG, 3>: the register path (the C
//       entry's pick at W = 64) or the general path (the bias and drel
//       through the key code on the tensor cores).
#include "../attn_bwd.cu"
#include "../qkv_packed_windows_s.cu"
#include "../qkv_relpos.cu"

extern "C" int cvlm_variant_windows(int qst, const void* qkv, const void* rel, void* out, int BW,
                                    int win, int heads, float scale, int ldo, void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Nw = win * win;
  if (Nw > 256 || Nw <= 208) return (int)cudaErrorInvalidValue;
  if (qst == 1)
    return launch_windows_s<80, 256, false, 1>(qkv, rel, true, out, BW, Nw, ldo, win, heads,
                                               scale, EdgeArgs{}, s);
  return launch_windows_s<80, 256, false, 2>(qkv, rel, true, out, BW, Nw, ldo, win, heads, scale,
                                             EdgeArgs{}, s);
}

// variant: the index into cli/attn_variants.py RELPOS_VARIANTS
extern "C" int cvlm_variant_relpos(int variant, const void* qkv, const void* rel, void* out,
                                   int B, int nwin, int H, int W, int heads, float scale,
                                   void* stream) {
  using namespace cvlm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap maps[3];
  const int err = encode_packed_rows<80>(&maps[0], qkv, B * nwin, H * W, heads, RP_KT);
  if (err) return err;
  maps[1] = maps[2] = maps[0];
#define CVLM_RP(NWG, MODE, RES) \
  launch_relpos<80, NWG, MODE, RES, false>(maps, rel, out, B, nwin, H, W, heads, scale, s)
  switch (variant) {
    case 0: return CVLM_RP(1, REL_TABLE, false);
    case 1: return CVLM_RP(2, REL_TABLE, false);
    case 2: return CVLM_RP(1, REL_TC, false);
    case 3: return CVLM_RP(2, REL_TABLE, true);
    case 4: return CVLM_RP(3, REL_TABLE, true);
    case 5: return CVLM_RP(2, REL_TC, true);
    case 6: return CVLM_RP(3, REL_TC, true);
    case 7: return CVLM_RP(1, REL_REG, false);
    case 8: return CVLM_RP(2, REL_REG, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CVLM_RP
}

// #18 at d = 80 and 128 lanes on an H x 64 grid: reg 1 the register path,
// 0 the general path; the other arguments as cvlm_attn_bwd's
extern "C" int cvlm_variant_attn_bwd(int reg, const void* qkv, const void* rel, const void* g,
                                     void* dqkv, void* drel, void* aux, void* stats,
                                     const void* code, int BB, int N, int NTP, int H, int L,
                                     int heads, float scale, void* stream) {
  using namespace cvlm;
  const AbArgs a{qkv, rel, g, code, dqkv, drel, aux, stats, BB, N, NTP, H, L, heads, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 1 || N != H * AB_T || !ab_reg(H, AB_T, L, 128) || NTP % AB_NWG != 0 ||
      NTP * AB_T < N)
    return (int)cudaErrorInvalidValue;
  return reg ? launch_attn_bwd<80, 128, true>(a, s) : launch_attn_bwd<80, 128, false>(a, s);
}
