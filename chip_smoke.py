#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

  python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases, each of which raises on failure (the script then exits non-zero and
never prints its last line):

  1. device   the card's name and power limit (nvidia-smi); no CUDA -> error
  2. build    nvcc builds the port's kernels (csrc/*.cu) for sm_90a
  3. kernels  each kernel against its plain PyTorch version at the main
              path's full-width bf16 shapes, with errors and device times
              (median of CUDA-event timings of calls launched on an idle
              card, after a warm-up; beside it the kernel's and the library
              call's time queued: 20 calls behind a device-side wait); the
              LN-fused GEMMs (#2, #3, #4/#5) at every shape of the main path
              at batch 2 and 1 and the out-projection (#7) at batch 2, each
              beside the same products alone through F.linear (#7:
              torch.matmul; gemm_library_ms), and their launches x time per
              cascade call ([per_call]); the
              general bias path of #17 at ViT-H's token count, the padded carry's
              kernels (#12, #11, #8) at ViT-H's windows 16 and 17, and the
              two that no path reaches (#9, #19) at the shapes they would take;
              the fp32 instance of #4/#5 at the bank precompute's shapes (462
              and 6160 rows, K 768, H 3072) against its plain version in fp32
              with TF32 off, within 1e-4, its bound against the fp32 CUDA-core
              peak (67 TFLOP/s)
  4. small    a small cascade in bf16 on the card against the same weights
              in fp32 on the CPU (the plain versions, which the CPU tests tie
              to the JAX package); its SAM runs 'flash' with 8 heads on a
              grid with edge and corner windows, its global blocks on #12
  5. vit_h    a depth-cut SAM ViT-H encoder at full width (1024 px, 1280
              wide, 16 heads x 80, window 14; one windowed and one global
              block) in bf16 on the card, 'flash' against 'reference' on the
              same weights
  5b. padded  as vit_h for fused 'flash' off the compact carry: global blocks
              of <= 512 tokens (256 px: #12; 320 px: #11 + #8) and the padded
              window carry at 1024 px (windows 15, 16: #12; 17: #11 + #8),
              with exact launch counts
  6. slice    the full-width cascade (SAM ViT-H at 1024 px on 'flash' with
              the rel cache, the edge decoder, MaPLe Alpha-CLIP ViT-L/14@336,
              the 61 OVCamo test classes) in bf16 from seeded random weights,
              driven through the demo CLI's session: text features encoded
              once, three requests at batch 1, one at batch 2. Outputs are
              checked, and every kernel's launch count must match the path.
              Then the cascade call's stage times (CUDA events) and the
              calls' own device memory peak at batch 1, 2 and 4.
  6b. graph   the same call captured as one CUDA graph (`graphs.GraphedCall`)
              at batch 1, 2 and 4: replays bit-equal to the eager call, the
              launches recorded at capture equal one call's expected
              launches, a replay launches nothing from the host, a
              torch.profiler trace of one replay holds the eager trace's
              kernels with the same count per name; eager and graphed walls,
              the card's busy time and idle share of each
  6c. serve   the serve CLI's engine (`cli/serve.build_engine`: full width,
              bf16, the 61 classes, buckets 1, 4, 16, 32 each captured by
              warmup()): the build's peak memory, the memory reserved with
              the four graphs, exact launches of the engine's run, requests
              that ride each bucket equal to a direct graphed call of it on
              the same padded batch, one HTTP round trip on localhost,
              `serve.bench_engine`, then `cli/serve_throughput.py`'s
              engine-only line (bucket 32, classification only)
  6d. ckpt    seeded full-width files in the reference's formats (the SAM
              ViT-H `.pth` in fp32, the OpenAI ViT-L/14@336 TorchScript
              archive in fp16, the dassl MaPLe `.pth.tar`, a `.npy` bank of
              the 61 test classes) under build/, read by the demo CLI's
              session (--sam-ckpt, --clip-ckpt, --maple-ckpt, --text-bank)
              through [slice]'s requests: every loaded weight equal to the
              file's value cast to its type, conv1_alpha zeros, [slice]'s
              launch counts exactly, outputs bit-equal to a model with that
              state dict loaded directly; the build's seconds and device peak
  6e. bank    `cli/precompute_text_bank.py` from that archive (fp32 tower):
              the 61 test classes with camoprompts, the first 4 with
              imagenet80, each within 1e-4 of the same CLI with the tower's
              MLP on its plain fp32 version, 12 launches of the fp32 #4/#5
              an encode call; then the files are deleted
  6f. bench   `cli/bench.py` in this process (eager and graphed at batch 8, 1,
              32, 2, 4; its per-batch lines and its headline: images/s, the
              batch-1 latency, TFLOP/s, MFU, peak and reserved memory, the
              card)
  7. grads    each hand-written backward kernel (the fused MLP's, the
              windowed and the global attention's) against its plain
              backward at the training path's full-width bf16 shapes, per
              output, with times; and the plain-VJP Functions of the
              LN+qkv, LN+mask+qkv, out-projection and edge-attention
              kernels against autograd of their plain versions
  8. train_small  one train step of the small cascade, bf16 on the card
              against fp32 on the CPU on the same weights and batch (loss
              and every trainable gradient), then the loss over 4 steps
  9. train_slice  the full-width cascade trained through the train CLI
              (`cli/train.main`, --device cuda, bf16, batch 2, one epoch of a
              synthetic OVCamo-layout dataset: 3 steps) with exact launch
              counts of every forward and backward kernel, frozen weights
              bit-identical, step times and peak memory; then one step cut
              into forward, backward and optimizer (CUDA events)
  9b. train_val  the train CLI validating on the card: one bf16 step on 2
              images, then --epoch-val 1's evaluate() of the test split;
              finite MAE, ckpt_best.pt and best_mae, exact launch counts
 10. unfused  as vit_h, depth 2 at full width, for SAM ViT-B on 'flash' (12
              heads: the unfused path, TPU kernel #10 in both blocks) and
              SAM ViT-H on 'aug_flash' (#20 in the global block), each
              against 'reference' on the same bf16 weights
 11. eval_slice  the evaluate CLI (`cli/evaluate.main`, --device cuda, bf16,
              batch 2) over a synthetic OVCamo-layout test split of 5 images
              (the last batch short), for the repo's ViT-H yaml, the port's
              ViT-B yaml, the ViT-H yaml on 'aug_flash' and at windows 16 and
              17 (fused 'flash' on the padded carry: #12; #11 + #8), all at
              full width and depth: finite results,
              exact launch counts, images/s and peak memory per config (a
              smoke figure: 5 images have no steady state; the rate is
              `cli/eval_throughput.py`'s over 300); then
              each configuration's cascade call cut into stages at batch 1 and 2
              (windows 16 and 17 and ViT-B also traced at batch 2: the card's
              busy time),
              and the CLI's host metric work per image

Every kernel line carries its bound (the larger of its FLOP over the bf16
tensor-core peak, the fp32 one's over the fp32 CUDA-core peak, and its bytes
over the HBM rate, at this run's shapes) and
the time of one PyTorch library call computing the same function where
there is one. Before its last line the script prints one JSON object
{"kernels": [...]} of 20 kernels (one per wrapper; `ln_mlp_residual_bt`
serves TPU kernels #4 and #5, and `ln_mlp_residual_bt_f32` is their fp32
instance, with its launches from [bank]), each with its launches on its path, or, for
#9 and #19, which no path reaches, in their check with a "path" field
saying so, and its times on both clocks (`ms`, `plain_ms`, `library_ms` on an
idle card; `queued_ms`, `library_queued_ms` queued) and the host's cost of
one launch (`host_us`: the forward kernels' enqueue time behind a
device-side wait), and for #2, #3, #4/#5 and #7 `gemm_library_ms`, their
products alone through F.linear or torch.matmul; the last line is {"ok": true, "device":
{...}}. Longer logs, and every line above (smoke.log), go to OUT_DIR.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time

import numpy as np

OUT_DIR = os.path.join("chiprun_out", "chip_smoke")

# Bound on the kernel-vs-plain relative errors (max|d|/max|ref| and
# mean|d|/mean|ref|) in bf16. Both versions round the same values at the same
# points (LN output, hidden, q*scale, probabilities, output) and differ only
# in fp32 summation order, which can flip a bf16 rounding by one ulp
# (2^-8 = 3.9e-3 relative); 1e-2 allows ~2.5 ulp. Two exceptions: the
# one-pass streaming attention kernels (the global attention #17,
# csrc/qkv_packed_global.cu, and CLIP's attention #16, csrc/attn_sm90.cuh)
# round the probabilities unnormalised, exp(s - running max), and divide the
# output by the row sum at the end, where the plain version normalises
# before the rounding; that moves each probability's rounding by at most
# one ulp too.
KERNEL_REL_BOUND = 1e-2
# Small cascade, bf16 on the card vs fp32 on the CPU: bf16 keeps ~3 decimal
# digits per op through 4 SAM blocks, the decoder and 3+3 CLIP layers.
SMALL_PROB_ABS_BOUND = 2e-2      # mask probabilities, max abs difference
SMALL_LOGIT_REL_BOUND = 5e-2     # class logits, max|d| / max|ref|
# Depth-2 ViT-H encoder, 'flash' vs 'reference', both bf16 on the card:
# mean|d| / mean|ref| of the neck output and the global block's output. The
# two paths round at different points (the reference rounds q, k, v, the
# qkv output and the attention output in other places, and keeps the
# padded windows) through two blocks and the neck; the JAX package's own
# on-chip check of the same comparison used 1.5e-2
# (scripts/verify_kernels_tpu.py:250-267).
VITH_MEAN_REL_BOUND = 1.5e-2
# Plain-VJP Functions against autograd of the plain version: the same
# plain backward on the same inputs, so equal up to fp32 summation order.
VJP_REL_BOUND = 1e-5
# Small cascade train step, bf16 on the card vs fp32 on the CPU: per
# trainable leaf |g_card - g_cpu| / max(|g_cpu|, FLOOR * max_leaf |g_cpu|)
# (L2 norms). bf16 keeps ~2.6 decimal digits per rounding; the backward
# chains ~20 rounded ops per path, so a typical leaf drifts by ~2e-2; 0.1
# leaves 5x. The floor: some leaves have an exact gradient of zero (the
# attention key biases: softmax is invariant to a bias added to every key),
# so their fp32 gradient is rounding noise and bf16's noise is larger; they
# are held to 1e-2 of the largest leaf's norm instead. Leaves whose CPU
# gradient is exactly zero (the IoU head, off the loss) must be zero on the card.
TRAIN_SMALL_GRAD_REL_BOUND = 0.1
TRAIN_SMALL_GRAD_FLOOR = 1e-2
TRAIN_SMALL_LOSS_REL_BOUND = 1e-2

# The H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W): the
# bf16 tensor-core rate and the HBM3 rate. A kernel's bound is the larger of
# its FLOP (the products the function needs) over the first and its bytes
# (each input it reads once, each output written once) over the second.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
# ... and its float32 rate on the CUDA cores (no tensor cores), the peak of
# the fp32 instance of #4/#5, which computes in full fp32 (FFMA)
PEAK_F32_FLOPS = 67e12
# fp32 #4/#5 against its plain version (cuBLAS fp32 with TF32 off), max|d| /
# max|ref| and mean|d| / mean|ref|: the same function with no rounding
# point, differing in the order of fp32 sums over K = 768 and H = 3072
# (~1e-6); 1e-4 leaves ~100x
F32_REL_BOUND = 1e-4
# the text bank from the fp32 kernel against the same from the plain fp32
# version on the card: the per-prompt features above through 12 layers,
# then means and norms
BANK_REL_BOUND = 1e-4
# the repo's configurations the eval slice runs
VIT_H_YAML = os.path.join("configs", "ovcos-sam-vit-h-maskdecoder-edge.yaml")
VIT_B_YAML = os.path.join("camouflaged_vlm_tpu_torch", "configs",
                          "ovcos-sam-vit-b-maskdecoder-edge.yaml")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


LOG_FILE = os.path.join(OUT_DIR, "smoke.log")


def log(msg: str) -> None:
    """A line to stdout and to LOG_FILE (a caller that keeps only the end of
    a long run's output still finds every line there)."""
    print(msg, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(LOG_FILE, "a") as f:
        f.write(msg + "\n")


# device cycles the stream waits before a queued timing run (~50 ms), so that
# the host can enqueue every call before the first one runs
QUEUE_SLEEP_CYCLES = 100_000_000


def time_ms(fn, warmup: int = 3, iters: int = 20, queued: bool = False) -> float:
    """A call's device time (ms) after a warm-up. Not queued (the default,
    the kernels line's `ms`, `plain_ms` and `library_ms`): the median of
    per-call CUDA-event times, each call launched on an idle card, which
    includes the launch when the host is slower than the kernel. Queued:
    `iters` calls enqueued back to back behind a device-side wait, between
    two CUDA events, divided by `iters`, so that the host's cost of a launch
    (the Python wrapper, ctypes, the TMA descriptors) stays off the clock, as
    it does inside a model whose host runs ahead of the card."""
    import torch

    for _ in range(warmup):
        fn()
    if queued:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_us(fn, iters: int = 20) -> float:
    """The host's microseconds per call (the wrapper, ctypes, the TMA
    descriptors and the launch), enqueued behind a device-side wait so that
    the card never holds the host back."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / iters


def errors(got, want):
    d = (got.float() - want.float()).abs()
    ref = want.float().abs()
    return {
        "max_abs_err": d.max().item(),
        "max_rel": (d.max() / ref.max()).item(),
        "mean_rel": (d.mean() / ref.mean()).item(),
    }


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, n_bytes: int, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: FLOP over the peak of their type
    (bf16 tensor cores unless given) or bytes over the HBM rate, whichever
    is larger, and which one it is."""
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available (this script needs an H100)")
    from camouflaged_vlm_tpu_torch.cli.bench import card_name_and_power

    name = torch.cuda.get_device_name(0)
    smi = card_name_and_power()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {name}; "
        "name and power limit (nvidia-smi):")
    log(smi)
    # fp32 references run in full fp32: TF32 would round their operands to
    # 10-bit mantissas
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for fp32 matmuls and convolutions")
    return name, smi


def phase_build():
    from camouflaged_vlm_tpu_torch.ops import _cuda
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.library()
    secs = time.perf_counter() - t0
    log(f"[build] {path.name} in {secs:.1f} s")
    info = _cuda.build_info.get("log", "")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "nvcc.log"), "w") as f:
        f.write(_cuda.build_info.get("command", "") + "\n" + info)
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", info)]
    spills = [ln.strip() for ln in info.splitlines()
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
    log(f"[build] ptxas: {len(regs)} kernel instantiations, {min(regs, default=0)}-"
        f"{max(regs, default=0)} registers per thread, {len(spills)} with spills "
        f"{spills[:4]} (full log: {OUT_DIR}/nvcc.log)")
    # the TMA + wgmma kernels (the whole-window ones at ViT-H's d = 80; #20 at
    # its depths; the MLP backward's dual GEMM at each activation) and the LN
    # row passes: registers and spills per instantiation, once each (the GEMM
    # template is instantiated in the sources that use it); their shared
    # memory is dynamic, sized at launch: below
    lines, seen = info.splitlines(), set()
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(_ZN4cvlm(15gemm_tma_kernel|14ln_rows_kernel"
                      r"|17qkv_global_kernel|18attn_stream_kernel|20qkv_windows_s_kernelILi80E"
                      r"|17qkv_relpos_kernelILi80E|17qkv_relpos_kernelILi64ELi\dELi\dELb\dELb1E"
                      r"|21attn_bwd_query_kernelILi80E"
                      r"|19attn_bwd_key_kernelILi80E|20attn_bwd_prep_kernel|17attn_fullk_kernel"
                      r"|19mlp_bwd_dual_kernel|18ln_bwd_rows_kernel)\S*)'", ln)
        if m and m.group(1) not in seen:
            seen.add(m.group(1))
            usage = [x.strip() for x in lines[i + 1:i + 4] if "Used" in x or "spill" in x]
            log(f"[build] {m.group(1)}: {'; '.join(usage)}")
    for bn in (256, 128):
        log(f"[build] dynamic shared memory per block: gemm_tma_kernel<{bn}, *, *> "
            f"{gemm_smem(bn)} B ({gemm_stages(bn)} stages of 128 x 64 + {bn} x 64)")
    # the MLP backward's dual GEMM and #20 at ViT-H's depth, as the library
    # sizes them
    dual, fk = _cuda.mlp_bwd_smem(), _cuda.attn_fullk_smem(208, 80)
    log(f"[build] dynamic shared memory per block: #6 mlp_bwd_dual_kernel<*> {dual['smem']} B "
        f"({dual['stages']} stages of 4 x 128 x 64); #20 attn_fullk_kernel<{fk['depth']}, 80, "
        f"{fk['stages']}> {fk['smem']} B (two q tiles, {fk['stages']} stages of 64 keys of k "
        f"and v)")
    # dynamic shared memory of the attention kernels at their paths' shapes
    # (csrc/attn_sm90.cuh stream_smem, csrc/qkv_packed_global.cu global_smem,
    # csrc/qkv_packed_windows_s.cu windows_s_smem): 128 B of alignment, bf16
    # buffers (q, the k/v ring, rel rows), the key code table, the mbarriers
    def stream(d, nwg, qrows, stages, lanes):
        return 128 + 2 * (nwg * qrows * d + 2 * stages * 64 * d + nwg * 64 * lanes) + 8 * (
            1 + 2 * stages)

    def windows(d, np_, edge=False, qst=2):
        return 128 + 2 * (qst * 64 * (d + 32) + np_ * (d + 32) + np_ * d) + 8 * (1 + 2 * qst) + (
            4 * np_ if edge else 0)

    log(f"[build] dynamic shared memory per block: #16 attn_stream_kernel<64, 3, 10> "
        f"{stream(64, 3, 72, 10, 0)} B; #17 qkv_global_kernel<80> at H + W = 128 "
        f"{stream(80, 2, 64, 3, 128)} B; #13 qkv_windows_s_kernel<80, 208, false, 2> (win 14) "
        f"{windows(80, 208)} B, <128, 256, false, 2> (win 16) {windows(128, 256)} B; #12 "
        f"qkv_windows_s_kernel<80, 256, false, 1> (win 15, 16) {windows(80, 256, qst=1)} B; #15 "
        f"qkv_windows_s_kernel<80, 112, true, 2> (R 112) {windows(80, 112, True)} B")
    # the one pass of qkv_relpos.cu at its paths' grids, as the library
    # arranges it (`_cuda.attn_relpos_smem`): #10 over split q, k, v at ViT-B's
    # windows and global grid, #11 and #19 over the packed rows at ViT-H's
    for site, H, d, split in (("#10 windows 14", 14, 64, True), ("#10 grid 64", 64, 64, True),
                              ("#11 window 17", 17, 80, False), ("#19 grid 64", 64, 80, False)):
        p = _cuda.attn_relpos_smem(H, H, d)
        log(f"[build] dynamic shared memory per block: {site} qkv_relpos_kernel<{d}, "
            f"{p['warpgroups']}, {p['mode']}, {'resident' if p['resident'] else 'streaming'}, "
            f"{'split' if split else 'packed'}> {p['smem']} B")
    # the attention backward at d = 80, as the library sizes it
    # (`_cuda.attn_bwd_smem`): the path, each pass's dynamic shared memory and
    # ring stages
    for site, hw, lanes in (("#14 windows", 14, 32), ("#18 global", 64, 128)):
        plan = _cuda.attn_bwd_smem(80, hw, hw, lanes, fa.attn_bwd_lanes(lanes))
        log(f"[build] dynamic shared memory per block: {site} ({plan['path']} path): "
            f"attn_bwd_query_kernel {plan['query_smem']} B, {plan['query_stages']} stages; "
            f"attn_bwd_key_kernel {plan['key_smem']} B, {plan['key_stages']} stages")

def gemm_stages(bn):
    """The ring depth of csrc/gemm_sm90.cuh's GemmTile<bn>."""
    return 3 if bn >= 256 else 4


def gemm_smem(bn):
    """GemmTile<bn>::SMEM: 1024 B of alignment slack, the ring of 128 x 64
    and bn x 64 bf16 tiles, the 128 x (bn + 8) bf16 epilogue tile, two
    mbarriers a stage."""
    st = gemm_stages(bn)
    return 1024 + 2 * (st * (128 + bn) * 64 + 128 * (bn + 8)) + 16 * st


def _check_kernel(name, kfn, pfn, args, flops=None, reads=None, library=None,
                  gemm_library=None, rel_bound=KERNEL_REL_BOUND, peak_flops=PEAK_BF16_FLOPS):
    """Kernel against its plain version on the same inputs: shape, type,
    finite, within KERNEL_REL_BOUND; times (kernel, plain, and `library`, a
    zero-argument PyTorch call computing the same function, or None) in ms;
    the bound from `flops` and the bytes of the tensors the kernel reads
    (`reads`, default every tensor argument) plus its output. For the
    GEMMs, `gemm_library` is a yardstick of their products alone: the same
    products through F.linear, torch.matmul or torch.einsum, without LN,
    mask, activation, bias or residual (`gemm_library_ms`, not `library_ms`:
    it computes another function, and the port never calls it). The fp32
    kernel passes its own `rel_bound` and `peak_flops`."""
    import torch

    got = kfn(*args)
    torch.cuda.synchronize()
    want = pfn(*args)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {got.shape}/{got.dtype} vs plain {want.shape}/{want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    e = errors(got, want)
    tensors = [a for a in (args if reads is None else reads) if isinstance(a, torch.Tensor)]
    b = bound(flops, nbytes(*tensors, got), peak_flops) if flops is not None else {}
    del got, want
    k_ms = time_ms(lambda: kfn(*args))
    k_q = time_ms(lambda: kfn(*args), queued=True)
    k_host = host_us(lambda: kfn(*args))
    p_ms = time_ms(lambda: pfn(*args))
    lib_ms = time_ms(library) if library is not None else None
    lib_q = time_ms(library, queued=True) if library is not None else None
    gemm = {}
    if gemm_library is not None:
        gemm = dict(gemm_library_ms=time_ms(gemm_library),
                    gemm_library_queued_ms=time_ms(gemm_library, queued=True))
    extra = ""
    if b:
        extra = (f" library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
                 f"{'' if lib_q is None else f' (queued {lib_q:.4f} ms)'} bound "
                 f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    if gemm:
        extra += (f" gemm_library (the products alone) {gemm['gemm_library_ms']:.4f} ms "
                  f"(queued {gemm['gemm_library_queued_ms']:.4f} ms)")
    log(f"[kernel] {name:40s} max_abs {e['max_abs_err']:.3e} max_rel {e['max_rel']:.3e} "
        f"mean_rel {e['mean_rel']:.3e} (bound {rel_bound}) kernel {k_ms:.4f} ms "
        f"(queued {k_q:.4f} ms, host {k_host:.1f} us a launch) plain {p_ms:.4f} ms{extra}")
    check(e["max_rel"] < rel_bound and e["mean_rel"] < rel_bound,
          f"{name} disagrees with its plain version: {e}")
    return dict(max_abs_err=e["max_abs_err"], ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                queued_ms=k_q, library_queued_ms=lib_q, host_us=k_host, **b, **gemm)


def phase_kernels():
    """Each kernel vs its plain version at full-width bf16 shapes (batch 2):
    the CLIP tower's shapes and SAM ViT-H's."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops import linear as lin
    from camouflaged_vlm_tpu_torch.ops.compact_window import (
        LPAD_LANE, NEG, CompactGeometry, edge_consts,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    dev = torch.device("cuda")

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    B, S, W = 2, 581, 1024
    # SAM ViT-H: 1280 wide, 16 heads x 80, 64x64 grid, window 14
    D, HD, NH, G, WIN = 1280, 80, 16, 64, 14
    geom = CompactGeometry(G, G, WIN)
    nf, ne, R = geom.n_full, geom.n_edge, geom.R_u
    edge_rel = rn(B, ne, R, NH, 32)
    off = 0
    for grp in geom.edge_groups:  # dummy rows' pad-key logit, as the encoder clamps it
        edge_rel[:, off : off + grp.n, grp.rows :, :, LPAD_LANE] = NEG
        off += grp.n
    sel_e, kmask_e = edge_consts(geom, bf, dev)
    sam_scale = HD ** -0.5
    F = torch.nn.functional

    def heads_view(qkv, heads, d):
        """The packed qkv rows as q, k, v (..., heads, S, d) views."""
        r = qkv.reshape(qkv.shape[:-1] + (3, heads, d))
        return [r[..., i, :, :].transpose(-3, -2) for i in range(3)]

    def sdpa_packed(qkv, heads, d, scale, bias=None):
        """The library call for the packed attention kernels: SDPA on views
        of the packed rows, with a materialised bias (built apart)."""
        q, k, v = heads_view(qkv, heads, d)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)

    # (name, source, replaces, kernel fn, plain fn, args, FLOP, tensors read, library call)
    x_pe, w_pe, b_pe = rn(B * 4096, 768), rn(1280, 768, std=0.02), rn(1280, std=0.02)
    qkv_clip = rn(B, S, 3 * W)
    qkv_win = rn(B * nf, WIN * WIN, 3 * D)
    rel_win = rn(WIN * WIN, B * nf, NH * 32)
    sel32 = fa.make_rel_scatter32(WIN, bf, dev)
    qkv_glob = rn(B, G * G, 3 * D)
    rel_glob = rn(G * G, B, NH, 2 * G)
    sel_glob = fa.make_rel_scatter(G, G, bf, dev)
    # the library's bias for the windows and the global blocks: rel @ sel, materialised
    bias_win = torch.matmul(rel_win.reshape(WIN * WIN, B * nf, NH, 32).permute(1, 2, 0, 3),
                            sel32)
    bias_glob = torch.matmul(rel_glob.permute(1, 2, 0, 3), sel_glob)
    edge_args = (rn(B, ne, R, 3 * D), edge_rel.reshape(B, ne, R, NH * 32), sel_e,
                 rn(NH, HD, std=0.5), kmask_e)
    edge_sdpa = sdpa_edge(*edge_args, NH, HD, sam_scale)
    cases = [
        ("linear_act", "camouflaged_vlm_tpu_torch/csrc/linear.cu",
         "camouflaged_vlm_tpu/ops/linear.py:61",
         lin.linear_act, lin.linear_act_ref, (x_pe, w_pe, b_pe),
         2.0 * B * 4096 * 768 * 1280, None, lambda: F.linear(x_pe, w_pe, b_pe)),
        ("flash_qkv_packed_plain", "camouflaged_vlm_tpu_torch/csrc/qkv_packed_plain.cu",
         "camouflaged_vlm_tpu/ops/flash_attention.py:875",
         lambda q: fa.flash_qkv_packed_plain(q, 64 ** -0.5, 16, 64),
         lambda q: fa.flash_qkv_packed_plain_ref(q, 64 ** -0.5, 16, 64),
         (qkv_clip,), 4.0 * B * 16 * S * S * 64, None,
         sdpa_packed(qkv_clip, 16, 64, 64 ** -0.5)),
        ("flash_qkv_packed_windows_s", "camouflaged_vlm_tpu_torch/csrc/qkv_packed_windows_s.cu",
         "camouflaged_vlm_tpu/ops/flash_attention.py:519",
         lambda *a: fa.flash_qkv_packed_windows_s(*a, sam_scale, NH, HD),
         lambda *a: fa.flash_qkv_packed_windows_s_ref(*a, sam_scale, NH, HD),
         (qkv_win, rel_win, sel32), 4.0 * B * nf * NH * (WIN * WIN) ** 2 * HD,
         (qkv_win, rel_win), sdpa_packed(qkv_win, NH, HD, sam_scale, bias_win)),
        ("flash_qkv_packed_edge", "camouflaged_vlm_tpu_torch/csrc/qkv_packed_windows_s.cu",
         "camouflaged_vlm_tpu/ops/flash_attention.py:755",
         lambda *a: fa.flash_qkv_packed_edge(*a, sam_scale, NH, HD),
         lambda *a: fa.flash_qkv_packed_edge_ref(*a, sam_scale, NH, HD),
         edge_args, 4.0 * B * ne * NH * R * R * HD, None, edge_sdpa),
        ("flash_qkv_packed_global", "camouflaged_vlm_tpu_torch/csrc/qkv_packed_global.cu",
         "camouflaged_vlm_tpu/ops/flash_attention.py:1083",
         lambda *a: fa.flash_qkv_packed_global(*a, sam_scale, NH, HD, G, G),
         lambda *a: fa.flash_qkv_packed_global_ref(*a, sam_scale, NH, HD),
         (qkv_glob, rel_glob, sel_glob), 4.0 * B * NH * (G * G) ** 2 * HD,
         (qkv_glob, rel_glob), sdpa_packed(qkv_glob, NH, HD, sam_scale, bias_glob)),
    ]
    # #17's general bias path (k / W, k % W per score) at ViT-H's token count,
    # heads and d: a 32 x 128 grid, which the W == 64 register path does not
    # take; its time against the 64 x 64 line above is what that path saves
    rel_gen = rn(G * G, B, NH, 32 + 128)
    sam_cases = [(
        "flash_qkv_packed_global (general bias path, grid 32x128, 2x4096x3840)",
        lambda *a: fa.flash_qkv_packed_global(*a, sam_scale, NH, HD, 32, 128),
        lambda *a: fa.flash_qkv_packed_global_ref(*a, sam_scale, NH, HD),
        (qkv_glob, rel_gen, fa.make_rel_scatter(32, 128, bf, dev)),
        4.0 * B * NH * (G * G) ** 2 * HD)]
    results, per_shape = {}, {}
    with torch.no_grad():
        lib_out = edge_sdpa().transpose(-1, -2).reshape(B, ne, NH * HD, R)
        lib_err = errors(lib_out, fa.flash_qkv_packed_edge_ref(*edge_args, sam_scale, NH, HD))
        log("[kernel] flash_qkv_packed_edge: its library call, SDPA over the R keys and the "
            "pad key (k 0, bias [rel @ sel + kmask | lp], v [v | vb]), against the plain "
            f"version: {lib_err}")
        del lib_out
        for name, source, replaces, kfn, pfn, args, flops, reads, library in cases:
            results[name] = dict(source=source, replaces=replaces,
                                 **_check_kernel(name, kfn, pfn, args, flops=flops,
                                                 reads=reads, library=library))
        for name, kfn, pfn, args, flops in sam_cases:
            _check_kernel(name, kfn, pfn, args, flops=flops)
        results.update(proj_rows_kernels(rn, per_shape))
        results.update(ln_gemm_kernels(rn, per_shape))
        per_call_table(per_shape)
        results.update(split_attention_kernels(rn))
        results.update(padded_sites(rn))
        results.update(f32_mlp_kernels(rn))
    return results


# the text tower's MLP shapes in the bank precompute: one class's prompts x
# 77 tokens a call (camoprompts 6, imagenet80 80), 768 wide, H 3072
F32_MLP_ROWS = {"camoprompts": 6 * 77, "imagenet80": 80 * 77}


def f32_mlp_kernels(rn):
    """The fp32 instance of #4/#5 (csrc/ln_mlp_residual_f32.cu) against its
    plain version in fp32 at the bank precompute's shapes, TF32 off (set in
    [device]); its bound against the fp32 CUDA-core peak; the library time
    of the same function through F.layer_norm, F.linear, the activation, F.linear
    and the residual. The kernels line holds the camoprompts shape."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    F = torch.nn.functional
    f32, K, H, eps = torch.float32, 768, 3072, 1e-5
    check(not torch.backends.cuda.matmul.allow_tf32, "fp32 kernel check needs TF32 off")
    out = {}
    for site, M in F32_MLP_ROWS.items():
        x = rn(M // 77, 77, K, dtype=f32)
        args = (x, 1 + rn(K, std=0.1, dtype=f32), rn(K, std=0.1, dtype=f32),
                rn(H, K, std=0.02, dtype=f32), rn(H, std=0.02, dtype=f32),
                rn(K, H, std=0.02, dtype=f32), rn(K, std=0.02, dtype=f32))
        g, bt, w1, b1, w2, b2 = args[1:]

        def library():
            h = F.linear(F.layer_norm(x, (K,), g, bt, eps), w1, b1)
            return x + F.linear(h * torch.sigmoid(1.702 * h), w2, b2)

        r = _check_kernel(
            f"ln_mlp_residual_bt_f32 ({site} {M}x{K}, H {H}, fp32, TF32 off)",
            lambda *a: lin.ln_mlp_residual_bt(*a, eps=eps, activation="quick_gelu"),
            lambda *a: lin.ln_mlp_residual_bt_ref(*a, eps=eps, activation="quick_gelu"),
            args, flops=4.0 * M * K * H, library=library, rel_bound=F32_REL_BOUND,
            peak_flops=PEAK_F32_FLOPS)
        if not out:
            out["ln_mlp_residual_bt_f32"] = dict(
                source="camouflaged_vlm_tpu_torch/csrc/ln_mlp_residual_f32.cu",
                replaces="camouflaged_vlm_tpu/ops/linear.py:416", **r)
        del args, x
    return out


def dmajor(x):
    """x in the layout the attention wrappers hand to proj_rows on the card
    (`ops/linear.py dmajor_empty`: rows of a stride rounded up to 8)."""
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    return lin.dmajor_empty(*x.shape, dtype=x.dtype, device=x.device).copy_(x)


def sdpa_edge(qkv, rel, sel, vb, kmask, heads, d, scale):
    """The library call of #15: one SDPA over the R keys and the virtual pad
    key appended as one more key column (k 0, bias [rel @ sel + kmask | lp],
    v [v | vb]), the same function; its inputs are built apart, on views of
    the packed rows flattened to 4D."""
    import torch

    from camouflaged_vlm_tpu_torch.ops.compact_window import LPAD_LANE

    B, n, R, _ = qkv.shape
    r = qkv.reshape(B * n, R, 3, heads, d)
    q, k, v = (r[:, :, i].transpose(1, 2) for i in range(3))  # (B n, heads, R, d)
    relh = rel.reshape(B, n, R, heads, 32).transpose(2, 3)  # (B, n, heads, R, 32)
    bias = torch.matmul(relh, sel[:, None]) + kmask[:, None].to(rel.dtype)
    bias = torch.cat([bias, relh[..., LPAD_LANE:LPAD_LANE + 1]], -1).flatten(0, 1)
    k = torch.cat([k, k.new_zeros(B * n, heads, 1, d)], 2)
    v = torch.cat([v, vb[None, :, None].expand(B * n, heads, 1, d)], 2)
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)


def proj_rows_shapes(B=2):
    """#7's shapes on the main path (the reference config at batch B):
    (site, x's shape (B, T, K, S), N): CLIP vision's 581 tokens, 1024 wide;
    SAM ViT-H's 16 interior windows of 196 tokens, its 9 edge windows of 112
    rows and its global blocks of 4096 tokens, 1280 wide."""
    return [("CLIP", (B, 1, 1024, 581), 1024), ("windows", (B, 16, 1280, 196), 1280),
            ("edge", (B, 9, 1280, 112), 1280), ("global", (B, 1, 1280, 4096), 1280)]


def proj_rows_case(rn, shape, N, padded=True):
    """(args, FLOP, gemm-only yardstick) of #7 at one shape: x d-major as the
    attention wrappers give it (contiguous unless `padded`), the residual,
    and the bare product through torch.matmul (another function: no bias,
    no residual, rows out of a transposed x)."""
    import torch

    B, T, K, S = shape
    x, w = rn(B, T, K, S), rn(N, K, std=0.02)
    x = dmajor(x) if padded else x
    args = (x, w, rn(N, std=0.02), rn(B, T, S, N))
    return args, 2.0 * B * T * S * K * N, lambda: torch.matmul(x.transpose(-1, -2), w.t())


def proj_heads_case(rn, B=2):
    """(args, FLOP, gemm-only yardstick) of #8 at the padded carry's window-17
    shape (batch B, SAM ViT-H width): x (B, 16, 16, 289, 80) head-leading, W
    (1280, 1280), the bias, the residual (B, 16, 289, 1280) (#9 takes the
    first three); the bare product as one torch.einsum over heads and d
    (another function: no bias, no residual; W's (heads, d, N) view made
    apart)."""
    import torch

    NH, T, S, HD, D = 16, 16, 289, 80, 1280
    x, w = rn(B, NH, T, S, HD), rn(D, D, std=0.02)
    args = (x, w, rn(D, std=0.02), rn(B, T, S, D))
    xr, wh = x.view(B, NH, T * S, HD), w.view(D, NH, HD).permute(1, 2, 0).contiguous()
    return args, 2.0 * B * T * S * D * D, lambda: torch.einsum("bhrd,hdn->brn", xr, wh)


def proj_rows_kernels(rn, per_shape):
    """#7 against its plain version at every main-path shape (batch 2), each
    with its bound and the gemm-only yardstick; the kernels line holds
    CLIP's shape, as in the earlier slices."""
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    out = {}
    for site, shape, N in proj_rows_shapes():
        args, flops, gemm = proj_rows_case(rn, shape, N)
        r = _check_kernel(f"proj_rows ({site} {'x'.join(map(str, shape))} -> {N}, residual)",
                          lin.proj_rows, lin.proj_rows_ref, args, flops=flops,
                          gemm_library=gemm)
        per_shape[("proj_rows", site, 2)] = r
        if site == "CLIP":
            out["proj_rows"] = dict(source="camouflaged_vlm_tpu_torch/csrc/proj_rows.cu",
                                    replaces="camouflaged_vlm_tpu/ops/linear.py:665", **r)
        del args
    return out


# the LN-fused GEMMs' sources and the TPU kernels they replace
LN_GEMMS = {
    "ln_linear_act_bt": ("camouflaged_vlm_tpu_torch/csrc/ln_linear.cu",
                         "camouflaged_vlm_tpu/ops/linear.py:143"),
    "ln_mask_linear_bt": ("camouflaged_vlm_tpu_torch/csrc/ln_linear.cu",
                          "camouflaged_vlm_tpu/ops/linear.py:228"),
    "ln_mlp_residual_bt": ("camouflaged_vlm_tpu_torch/csrc/ln_mlp_residual.cu",
                           "camouflaged_vlm_tpu/ops/linear.py:416"),
}


def ln_gemm_shapes(batches=(2, 1)):
    """Every shape the LN-fused GEMMs (#2, #3, #4/#5) take on the main path
    (the reference config: CLIP-L vision 1024 wide, H 4096, quick_gelu, LN
    eps 1e-5; the text tower 61 classes x 77 tokens, 768 wide, H 3072, once a
    session; SAM ViT-H 1280 wide, H 5120, gelu_tanh, eps 1e-6, window 14 on
    the 64 x 64 grid: 16 interior windows of 196 tokens and 1008 edge rows an
    image, 4096 tokens in a global block), at batch 2 and 1: (kernel, site,
    batch, leading dims, K, N or H, eps, activation)."""
    from camouflaged_vlm_tpu_torch.ops.compact_window import CompactGeometry

    geom = CompactGeometry(64, 64, 14)
    out = []
    for b in batches:
        out += [
            ("ln_linear_act_bt", "CLIP", b, (b, 581), 1024, 3072, 1e-5, None),
            ("ln_linear_act_bt", "windows", b, (b * geom.n_full, 196), 1280, 3840, 1e-6, None),
            ("ln_linear_act_bt", "edge", b, (b, geom.E), 1280, 3840, 1e-6, None),
            ("ln_mask_linear_bt", "global", b, (b, 4096), 1280, 3840, 1e-6, None),
            ("ln_mlp_residual_bt", "CLIP", b, (b, 581), 1024, 4096, 1e-5, "quick_gelu"),
            ("ln_mlp_residual_bt", "windows", b, (b * geom.n_full, 196), 1280, 5120, 1e-6,
             "gelu_tanh"),
            ("ln_mlp_residual_bt", "edge", b, (b, geom.E), 1280, 5120, 1e-6, "gelu_tanh"),
            ("ln_mlp_residual_bt", "global", b, (b, 4096), 1280, 5120, 1e-6, "gelu_tanh"),
        ]
    out.append(("ln_mlp_residual_bt", "text", 61, (61, 77), 768, 3072, 1e-5, "quick_gelu"))
    return out


def ln_gemm_case(rn, kernel, lead, K, N, eps, act):
    """(kernel fn, plain fn, args, FLOP, gemm-only F.linear call) of one
    LN-fused GEMM at one shape, seeded random bf16 inputs (fp32 LN scale and
    shift, an all-ones row mask for #3 as the compact carry gives it)."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    F = torch.nn.functional
    M = int(np.prod(lead))
    x = rn(*lead, K)
    g, b = 1 + rn(K, std=0.1, dtype=torch.float32), rn(K, std=0.1, dtype=torch.float32)
    w, bias = rn(N, K, std=0.02), rn(N, std=0.02)
    if kernel == "ln_mlp_residual_bt":
        w2, b2 = rn(K, N, std=0.02), rn(K, std=0.02)
        return (lambda *a: lin.ln_mlp_residual_bt(*a, eps=eps, activation=act),
                lambda *a: lin.ln_mlp_residual_bt_ref(*a, eps=eps, activation=act),
                (x, g, b, w, bias, w2, b2), 4.0 * M * K * N,
                lambda: F.linear(F.linear(x, w, bias), w2, b2))
    if kernel == "ln_mask_linear_bt":
        mask = torch.ones(1, lead[-1], 1, dtype=x.dtype, device=x.device)
        return (lambda *a: lin.ln_mask_linear_bt(*a, eps=eps),
                lambda *a: lin.ln_mask_linear_bt_ref(*a, eps=eps),
                (x, g, b, mask, w, bias), 2.0 * M * K * N, lambda: F.linear(x, w, bias))
    return (lambda *a: lin.ln_linear_act_bt(*a, eps=eps, activation=act),
            lambda *a: lin.ln_linear_act_bt_ref(*a, eps=eps, activation=act),
            (x, g, b, w, bias), 2.0 * M * K * N, lambda: F.linear(x, w, bias))


def ln_gemm_kernels(rn, per_shape):
    """#2, #3 and #4/#5 against their plain versions at every main-path
    shape (`ln_gemm_shapes`), each timed with its bound and the gemm-only
    yardstick; the kernels line holds CLIP's shape at batch 2 for #2 and
    #4/#5 and the global blocks' for #3, as in the earlier slices."""
    out = {}
    for kernel, site, b, lead, K, N, eps, act in ln_gemm_shapes():
        kfn, pfn, args, flops, gemm = ln_gemm_case(rn, kernel, lead, K, N, eps, act)
        rows = "x".join(map(str, lead))
        label = (f"{kernel} ({site} {rows}x{K}, H {N})" if kernel == "ln_mlp_residual_bt"
                 else f"{kernel} ({site} {rows}x{K} -> {N})")
        r = _check_kernel(label, kfn, pfn, args, flops=flops, gemm_library=gemm)
        per_shape[(kernel, site, b)] = r
        if kernel not in out and b == 2:
            source, replaces = LN_GEMMS[kernel]
            out[kernel] = dict(source=source, replaces=replaces, **r)
        del args
    return out


def per_call_sites():
    """A cascade call's launches of a per-layer kernel at each site of the
    reference config: SAM's windowed blocks each run the interior and the
    edge pass, its global blocks the global one, and each CLIP vision pass
    (two a call) its layers."""
    import torch
    from camouflaged_vlm_tpu_torch.models import CascadeConfig

    cfg = CascadeConfig.full(dtype=torch.bfloat16)
    n_glob = len(cfg.encoder.global_attn_indexes)
    n_win = cfg.encoder.depth - n_glob
    return {"CLIP": 2 * cfg.clip.vision_layers, "windows": n_win, "edge": n_win,
            "global": n_glob}


def per_call_table(per_shape):
    """Launches x time per cascade call of the reference config (#2, #3,
    #4/#5 at batch 2 and 1, #7 at batch 2), summed over the shapes a call
    runs (`per_call_sites`), on both clocks, beside the summed bound."""
    per_call = per_call_sites()
    for kernel, batches in (("ln_linear_act_bt", (2, 1)), ("ln_mask_linear_bt", (2, 1)),
                            ("ln_mlp_residual_bt", (2, 1)), ("proj_rows", (2,))):
        for b in batches:
            rows = [(site, n, per_shape[(kernel, site, b)]) for site, n in per_call.items()
                    if (kernel, site, b) in per_shape]
            tot = {k: sum(n * r[k] for _, n, r in rows) for k in ("ms", "queued_ms", "bound_ms")}
            parts = " + ".join(f"{n} x {site} {r['ms']:.4f} (queued {r['queued_ms']:.4f})"
                               for site, n, r in rows)
            log(f"[per_call] {kernel} batch {b}: {sum(n for _, n, _ in rows)} launches a "
                f"cascade call: {parts} = {tot['ms']:.3f} ms (queued {tot['queued_ms']:.3f} "
                f"ms), bound {tot['bound_ms']:.3f} ms")


# the two kernels no path of either package reaches (the JAX package's own
# tests call them): their launches are those of their check here
NO_PATH = {"proj_from_heads": "none: PallasHeadProj is never called without the residual",
           "flash_qkv_relpos_global": "none: ablation kernel, no caller"}


def padded_sites(rn):
    """TPU kernels #12, #11, #8, #9 and #19 at the full-width shapes of the
    paths that reach them (batch 2, SAM ViT-H width, 16 heads x 80): #12 at
    fused 'flash' with window 16 (grid 64: 16 windows of 256 tokens, H+W =
    32), on #13's whole-window kernel with rel window-major (one q stage, two
    blocks an SM); #11 at window 17 (grid padded to 68: 16 windows of 289
    tokens, H+W = 34 > 32) on the one-pass streaming loop of qkv_relpos.cu
    with each key's rel lanes from the block's code table; #8 / #9 the
    out-projection of #11's head-leading output with / without the residual;
    #19 over the 4096-token grid on the same loop, rel_w in registers (W =
    64, the key tile). Library calls: SDPA on views of the packed rows with
    the bias materialised (built apart) for the attention; none for #8 / #9
    (no single call takes the head-leading input with the bias), beside
    them the product alone through torch.einsum (`proj_heads_case`)."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import _cuda
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    F = torch.nn.functional
    bf, dev = torch.bfloat16, torch.device("cuda")
    B, D, NH, HD = 2, 1280, 16, 80
    scale = HD ** -0.5
    src = "camouflaged_vlm_tpu_torch/csrc/"
    out = {}
    for p in (_cuda.PROJ_HEADS, _cuda.QKV_RELPOS_GLOBAL):
        p.launches = 0

    def sdpa(q, k, v, bias):
        q, k, v, bias = (t.flatten(0, -4) for t in (q, k, v, bias))  # 4D, copied here
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)

    # #12: qkv (2, 16, 256, 3840), rel window-major (2, 16, 256, 512)
    nwin, win = 16, 16
    Nw = win * win
    qkv, rel = rn(B, nwin, Nw, 3 * D), rn(B, nwin, Nw, NH * 32)
    sel32 = fa.make_rel_scatter32(win, bf, dev)
    r = qkv.reshape(B, nwin, Nw, 3, NH, HD)
    q, k, v = (r[:, :, :, i].transpose(2, 3) for i in range(3))  # (B, nwin, NH, Nw, HD)
    bias = torch.matmul(rel.reshape(B, nwin, Nw, NH, 32).transpose(2, 3), sel32)
    out["flash_qkv_packed_windows"] = dict(
        source=src + "qkv_packed_windows_s.cu",
        replaces="camouflaged_vlm_tpu/ops/flash_attention.py:337",
        **_check_kernel("flash_qkv_packed_windows (ViT-H window 16, 2x16x256x3840)",
                        lambda *a: fa.flash_qkv_packed_windows(*a, scale, NH, HD),
                        lambda *a: fa.flash_qkv_packed_windows_ref(*a, scale, NH, HD),
                        (qkv, rel, sel32), flops=4.0 * B * nwin * NH * Nw * Nw * HD,
                        reads=(qkv, rel), library=sdpa(q, k, v, bias)))
    del qkv, rel, q, k, v, bias, r
    # #11 and #19: the 5D / 4D views of the packed qkv, rel per head
    for name, site, shape, H in (
            ("flash_qkv_relpos_windows", ":213", (B, 16), 17),
            ("flash_qkv_relpos_global", ":1262", (B,), 64)):
        N = H * H
        qkv, rel = rn(*shape, N, 3 * NH, HD), rn(*shape, N, NH, 2 * H)
        sel = fa.make_rel_scatter(H, H, bf, dev)
        q, k, v = (qkv[..., i * NH : (i + 1) * NH, :].movedim(-2, 1) for i in range(3))
        bias = torch.matmul(rel.movedim(-2, 1), sel)
        wrapper, plain = getattr(fa, name), getattr(fa, name + "_ref")
        label = (f"{name} (ViT-H window 17, 2x16x289x48x80)" if len(shape) == 2
                 else f"{name} (ViT-H grid 64, 2x4096x48x80)")
        out[name] = dict(
            source=src + "qkv_relpos.cu", replaces="camouflaged_vlm_tpu/ops/flash_attention.py"
            + site,
            **_check_kernel(label, lambda *a, w=wrapper, H=H: w(*a, scale, H, H),
                            lambda *a, p=plain: p(*a, scale), (qkv, rel, sel),
                            flops=4.0 * qkv.shape[:-3].numel() * NH * N * N * HD,
                            reads=(qkv, rel), library=sdpa(q, k, v, bias)))
        del qkv, rel, q, k, v, bias
    # #8 / #9: x (2, 16, 16, 289, 80) head-leading -> (2, 16, 289, 1280)
    args, flops, gemm = proj_heads_case(rn, B)
    for name, site, a in (("proj_from_heads_res", ":756", args),
                          ("proj_from_heads", ":810", args[:3])):
        out[name] = dict(
            source=src + "proj_rows.cu", replaces="camouflaged_vlm_tpu/ops/linear.py" + site,
            **_check_kernel(f"{name} (ViT-H window 17, 2x16x16x289x80 -> 1280)",
                            getattr(lin, name), lin.proj_from_heads_ref, a, flops=flops,
                            gemm_library=gemm))
    for name, path in NO_PATH.items():
        kernel = _cuda.PROJ_HEADS if name == "proj_from_heads" else _cuda.QKV_RELPOS_GLOBAL
        out[name].update(launches=kernel.launches, path=path)
    return out


def split_attention_kernels(rn):
    """TPU kernels #10 and #20 at their paths' full-width shapes, batch 2:
    #10 at SAM ViT-B's windowed blocks (25 padded 14 x 14 windows x 12 heads
    per image, d 64) and global blocks (12 heads x 4096 tokens); #20 at SAM
    ViT-H's 'aug_flash' global blocks (16 heads x 4096, q_aug/k_aug 80 + 64 +
    64 = 208 wide, v 80). Library calls: SDPA with the bias rel @ sel
    materialised (built apart and timed apart) for #10; SDPA at scale 1 on
    the augmented features, the same function, for #20."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa

    F = torch.nn.functional
    B, bf, dev = 2, torch.bfloat16, torch.device("cuda")
    out = {}
    for label, BB, H, dh in (("ViT-B windows", B * 25 * 12, 14, 64),
                             ("ViT-B global", B * 12, 64, 64)):
        N = H * H
        q, k, v = rn(BB, N, dh, std=dh ** -0.5), rn(BB, N, dh), rn(BB, N, dh)
        rel, sel = rn(BB, N, 2 * H), fa.make_rel_scatter(H, H, bf, dev)
        bias = torch.matmul(rel, sel)
        bias_ms = time_ms(lambda: torch.matmul(rel, sel))
        r = _check_kernel(
            f"flash_attention_relpos ({label} {BB}x{N}x{dh})",
            lambda *a: fa.flash_attention_relpos(*a, H, H), fa.xla_attention_relpos,
            (q, k, v, rel, sel), flops=4.0 * BB * N * N * dh, reads=(q, k, v, rel),
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0))
        log(f"[kernel] flash_attention_relpos ({label}): the library's bias build "
            f"(rel @ sel, {tuple(bias.shape)}) {bias_ms:.4f} ms, not in library_ms")
        del bias
        if label == "ViT-B global":  # the JSON line holds the global blocks' shape
            out["flash_attention_relpos"] = dict(
                source="camouflaged_vlm_tpu_torch/csrc/qkv_relpos.cu",
                replaces="camouflaged_vlm_tpu/ops/flash_attention.py:134", **r)
    BB, N, dqk, dv = B * 16, 4096, 208, 80
    q, k, v = rn(BB, N, dqk, std=dqk ** -0.5), rn(BB, N, dqk), rn(BB, N, dv)
    out["flash_attention_fullk"] = dict(
        source="camouflaged_vlm_tpu_torch/csrc/attn_fullk.cu",
        replaces="camouflaged_vlm_tpu/ops/flash_attention.py:1352",
        **_check_kernel(f"flash_attention_fullk (ViT-H aug_flash global {BB}x{N}x{dqk}/{dv})",
                        fa.flash_attention_fullk, fa.flash_attention_fullk_ref, (q, k, v),
                        flops=2.0 * BB * N * N * (dqk + dv),
                        library=lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)))
    return out


def _small_config(dtype):
    import dataclasses

    from camouflaged_vlm_tpu_torch.models import CascadeConfig, SamEncoderConfig
    from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig

    # widths the kernels take: CLIP 128 wide (8 heads x 16), text 128 (4 x 32);
    # SAM on 'flash', 128 wide (8 heads x 16), grid 10 with window 4: right,
    # bottom and corner edge windows (R_u 8)
    clip = AlphaClipConfig.tiny(dtype=dtype, vision_width=128, vision_heads=8,
                                transformer_width=128)
    enc = SamEncoderConfig.tiny(dtype=dtype, attn_impl="flash", img_size=160, embed_dim=128,
                                num_heads=8, window_size=4, prompt_scale_factor=16)
    return dataclasses.replace(CascadeConfig.tiny(dtype=dtype), inp_size=enc.img_size,
                               encoder=enc, clip=clip)


SAM_ATTENTION = ("ln_mask_linear_bt", "flash_qkv_packed_windows_s", "flash_qkv_packed_edge",
                 "flash_qkv_packed_windows", "flash_qkv_relpos_windows", "proj_from_heads_res",
                 "flash_qkv_packed_global")


def check_sam_attention(counts, enc, label, backward=False):
    """The SAM attention kernels (and their backward kernels) of one
    encoder pass launched exactly as the configuration's path says; the
    small cascade's global blocks (grid 10: 100 tokens, H+W 20) take #12,
    whose gradient is its plain version's VJP, so #17 and #18 stay idle."""
    want = sam_expected(enc)
    expected = {k: want.get(k, 0) for k in SAM_ATTENTION}
    names = list(SAM_ATTENTION)
    if backward:
        for k in ("flash_qkv_packed_windows_s", "flash_qkv_packed_global"):
            expected[k + "_bwd"] = want.get(k, 0)
            names.append(k + "_bwd")
    got = {k: counts[k] for k in names}
    log(f"[{label}] SAM attention launches {got} expected {expected}")
    check(got == expected, f"{label}: SAM attention launches {got} != {expected}")


def phase_small():
    import torch
    from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs
    from camouflaged_vlm_tpu_torch.ops import _cuda

    cpu_cfg, gpu_cfg = _small_config(torch.float32), _small_config(torch.bfloat16)
    ref = build_cascade(cpu_cfg, "cpu", seed=5)
    model = build_cascade(gpu_cfg, "cuda", seed=5)
    model.load_state_dict(ref.state_dict(), strict=True)
    rng = np.random.default_rng(5)
    B = 2
    inputs = [
        rng.standard_normal((B, cpu_cfg.inp_size, cpu_cfg.inp_size, 3)).astype(np.float32),
        rng.standard_normal((B, cpu_cfg.clip_size, cpu_cfg.clip_size, 3)).astype(np.float32),
        np.full((B, cpu_cfg.clip_size, cpu_cfg.clip_size, 1), 1.923, np.float32),
    ]
    names = ["cat", "owl", "bat", "moth", "slug"]
    outs = []
    _cuda.reset_launches()  # the CPU pass launches nothing
    for m, cfg, dev in ((ref, cpu_cfg, "cpu"), (model, gpu_cfg, "cuda")):
        bank = make_bank_inputs(cfg, names, seed=5, device=dev)
        outs.append(m.infer_cascade(*(torch.from_numpy(a).to(dev) for a in inputs),
                                    bank["prefix"], bank["suffix"], bank["eot_indices"],
                                    bank["bank_features"]))
    check_sam_attention(_cuda.launch_counts(), gpu_cfg.encoder, "small")
    (p_ref, y_ref, l_ref), (p, y, l) = outs
    p, y, l = p.float().cpu(), y.cpu(), l.float().cpu()
    dp = (p - p_ref).abs().max().item()
    dl = ((l - l_ref).abs().max() / l_ref.abs().max()).item()
    log(f"[small] SAM '{gpu_cfg.encoder.attn_impl}' {gpu_cfg.encoder.num_heads} heads, grid "
        f"{gpu_cfg.encoder.grid}, window {gpu_cfg.encoder.window_size}; bf16 card vs fp32 CPU: "
        f"probs max_abs {dp:.3e} (bound {SMALL_PROB_ABS_BOUND}), "
        f"logits max_rel {dl:.3e} (bound {SMALL_LOGIT_REL_BOUND}), "
        f"pred {y.tolist()} vs {y_ref.tolist()}")
    check(dp < SMALL_PROB_ABS_BOUND, f"small cascade probabilities differ by {dp}")
    check(dl < SMALL_LOGIT_REL_BOUND, f"small cascade logits differ by {dl}")


def phase_vit_h():
    """Depth-cut ViT-H encoder at full width, 'flash' vs 'reference' on the
    same bf16 weights: catches layout faults the small config cannot (R_u
    112, three edge groups, d 80, hw 128)."""
    import torch
    from camouflaged_vlm_tpu_torch.models import SamEncoderConfig

    cfg = SamEncoderConfig.vit_h(dtype=torch.bfloat16, depth=2, global_attn_indexes=(1,))
    e, ei, counts = _vs_reference(cfg, "flash", 11, _image(11, 1024))
    log(f"[vit_h] depth 2 (1 windowed + 1 global), 1024 px, bf16, flash vs reference: neck "
        f"mean_rel {e['mean_rel']:.3e} max_rel {e['max_rel']:.3e}; global block mean_rel "
        f"{ei['mean_rel']:.3e} max_rel {ei['max_rel']:.3e} (bound mean_rel "
        f"{VITH_MEAN_REL_BOUND}); flash launches {counts}")
    check(e["mean_rel"] < VITH_MEAN_REL_BOUND and ei["mean_rel"] < VITH_MEAN_REL_BOUND,
          f"vit_h: flash disagrees with reference: {e} {ei}")
    for name in ("flash_qkv_packed_windows_s", "flash_qkv_packed_edge",
                 "flash_qkv_packed_global", "ln_mask_linear_bt"):
        check(counts.get(name, 0) > 0, f"vit_h: flash encoder did not launch {name}")


def _image(seed, size):
    import torch

    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, size, size, 3)).astype(np.float32)).cuda()


def _vs_reference(cfg, impl, seed, x):
    """The SAM encoder `cfg` on `impl` and on 'reference', the same seeded
    bf16 weights (rel-pos tables x25, large enough for the bias to matter),
    on x: (errors of the neck output, errors of the global block's output,
    the kernel launches of the `impl` pass)."""
    import torch
    from camouflaged_vlm_tpu_torch.factory import cast_weights_, init_random_
    from camouflaged_vlm_tpu_torch.models import ImageEncoderViT
    from camouflaged_vlm_tpu_torch.ops import _cuda

    encs = {}
    for name in (impl, "reference"):
        with torch.device("meta"):
            enc = ImageEncoderViT(dataclasses.replace(cfg, attn_impl=name))
        enc = enc.to_empty(device="cuda")
        init_random_(enc, torch.Generator(device="cuda").manual_seed(seed))
        with torch.no_grad():
            for blk in enc.blocks:
                blk.attn.rel_pos_h.mul_(25.0)
                blk.attn.rel_pos_w.mul_(25.0)
        cast_weights_(enc, torch.bfloat16)
        encs[name] = enc.eval().requires_grad_(False)
    encs[impl].load_state_dict(encs["reference"].state_dict(), strict=True)
    with torch.no_grad():
        _cuda.reset_launches()
        got, got_i = encs[impl](x)
        counts = {k: v for k, v in _cuda.launch_counts().items() if v}
        want, want_i = encs["reference"](x)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(got_i[0]).all()),
          f"{impl}: non-finite output")
    e, ei = errors(got, want), errors(got_i[0], want_i[0])
    del encs, got, want, got_i, want_i
    torch.cuda.empty_cache()
    return e, ei, counts


def phase_padded():
    """Depth-2 full-width ViT-H encoders on fused 'flash' off the compact
    carry, each against 'reference' on the same bf16 weights: the global
    blocks of <= 512 tokens (256 px: grid 16, #12; 320 px: grid 20, H+W 40,
    #11 + #8) and the padded window carry at 1024 px (window 15: 25 padded
    windows of 225 tokens, #12 with the valid mask; window 16: #12; window
    17: #11 + #8). The launches of each pass are exact (`sam_expected`)."""
    import torch
    from camouflaged_vlm_tpu_torch.models import SamEncoderConfig

    for img, win in ((256, 14), (320, 14), (1024, 15), (1024, 16), (1024, 17)):
        cfg = SamEncoderConfig.vit_h(dtype=torch.bfloat16, depth=2, global_attn_indexes=(1,),
                                     img_size=img, window_size=win)
        e, ei, counts = _vs_reference(cfg, "flash", 14, _image(14, img))
        expected = {k: n for k, n in sam_expected(cfg).items() if n}
        log(f"[padded] ViT-H depth 2 (1 windowed + 1 global), {img} px, window {win}, bf16, "
            f"flash vs reference: neck mean_rel {e['mean_rel']:.3e} max_rel {e['max_rel']:.3e}; "
            f"global block mean_rel {ei['mean_rel']:.3e} max_rel {ei['max_rel']:.3e} (bound "
            f"mean_rel {VITH_MEAN_REL_BOUND}); launches {counts}")
        check(e["mean_rel"] < VITH_MEAN_REL_BOUND and ei["mean_rel"] < VITH_MEAN_REL_BOUND,
              f"padded: {img} px window {win} disagrees with reference: {e} {ei}")
        check(counts == expected, f"padded: {img} px window {win}: launches {counts} != "
              f"{expected}")


def _synthetic_images(n, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    sizes = [(480, 640), (512, 512), (720, 540), (600, 800), (384, 576)]
    out = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        base = rng.integers(0, 255, (h // 8, w // 8, 3), dtype=np.uint8)
        img = Image.fromarray(base).resize((w, h), Image.BILINEAR)  # smooth texture
        out.append(img)
    return out


def phase_slice():
    import torch
    from camouflaged_vlm_tpu_torch.cli import demo
    from camouflaged_vlm_tpu_torch.ops import _cuda

    demo_dir = os.path.join(OUT_DIR, "demo")
    os.makedirs(demo_dir, exist_ok=True)
    images = _synthetic_images(5)
    paths = []
    for i, img in enumerate(images):
        paths.append(os.path.join(demo_dir, f"synthetic_{i}.png"))
        img.save(paths[-1])
    args = demo.parse_args(["--image", paths[0], "--out-dir", demo_dir,
                            "--device", "cuda", "--dtype", "bfloat16", "--seed", "0"])

    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    session = demo.DemoSession(args)  # full-width build + 61-class text encode
    torch.cuda.synchronize()
    log(f"[slice] build + text encode ({len(session.classnames)} classes): "
        f"{time.perf_counter() - t0:.3f} s")
    cfg, n_classes = session.cfg, len(session.classnames)
    check(session.text_features.shape == (n_classes, cfg.clip.embed_dim)
          and bool(torch.isfinite(session.text_features).all()), "bad text features")
    requests = SLICE_REQUESTS
    for idx in requests:
        batch = [images[i] for i in idx]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs, pred, logits = session.predict(batch)
        dt = time.perf_counter() - t0
        check(probs.shape == (len(idx), cfg.inp_size, cfg.inp_size), f"probs shape {probs.shape}")
        check(bool(np.isfinite(probs).all()) and probs.min() >= 0 and probs.max() <= 1,
              "mask probabilities not finite in [0, 1]")
        check(logits.shape == (len(idx), n_classes) and bool(np.isfinite(logits).all()),
              f"logits shape {logits.shape} or non-finite")
        check(bool(((pred >= 0) & (pred < n_classes)).all()), f"class ids {pred}")
        for j, i in enumerate(idx):
            cls = session.classnames[int(pred[j])]
            demo.write_outputs(paths[i], np.asarray(images[i]), probs[j], cls, demo_dir)
        log(f"[slice] request batch {len(idx)}: {dt * 1000:.1f} ms wall; pred "
            f"{[session.classnames[int(c)] for c in pred]}; mask mean {probs.mean():.4f} "
            f"std {probs.std():.4f}")
    counts = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[slice] peak device memory {peak:.2f} GiB (torch.cuda.max_memory_allocated)")

    calls = len(requests)  # cascade calls; each runs the CLIP tower twice
    enc = cfg.encoder
    check(enc.attn_impl == "flash", f"slice: SAM runs {enc.attn_impl!r}, not 'flash'")
    check(all(b.attn.rel_cache is not None for b in session.model.image_encoder.blocks),
          "slice: the demo session did not attach the rel cache")
    # window 14 on grid 64: the compact carry, interior + edge windows in each
    # windowed block; the text tower once; no backward kernel
    expected = expected_launches(cfg, calls)
    log(f"[slice] kernel launches {counts} expected {expected}")
    check(counts == expected, f"launch counts {counts} != expected {expected}")
    stage_times(session.model, session.cfg, session.text_features,
                {bs: session.preprocess(images[:bs]) for bs in (1, 2, 4)}, trace=(1, 2))
    return counts, session, images


# the demo requests of [slice] and [ckpt]: images of _synthetic_images(5)
SLICE_REQUESTS = [[0], [1], [2], [3, 4]]
# [ckpt]'s files, deleted at the end of [bank]
CKPT_WORK = os.path.join("build", "chip_smoke_ckpt")


def write_reference_files(work):
    """Seeded random files in the reference's formats at full width under
    `work`: the SAM ViT-H backbone `.pth` (fp32, the stock SAM keys without
    the EVP prompt generator, plus `prompt_encoder.*` entries the port
    ignores), the OpenAI ViT-L/14@336 TorchScript archive (fp16, no
    conv1_alpha), the dassl MaPLe `.pth.tar` and a `.npy` bank of the 61 test
    classes. The weights are numpy draws (`io/synthetic.random_state_dict`)."""
    import torch
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.io import synthetic
    from camouflaged_vlm_tpu_torch.models import CascadeConfig, OVCOSCascade

    cfg = CascadeConfig.full(dtype=torch.float32)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in OVCOSCascade(cfg).state_dict().items()}
    t0 = time.perf_counter()
    src = synthetic.random_state_dict(shapes, seed=1)
    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.standard_normal(
        (cfg.clip.vocab_size, cfg.clip.transformer_width), dtype=np.float32) * np.float32(0.02))
    paths = {k: os.path.join(work, f) for k, f in (
        ("sam", "sam_vit_h.pth"), ("clip", "ViT-L-14-336px.pt"), ("maple", "model-best.pth.tar"),
        ("bank", "TestCamoPromptsTextFeatures.npy"))}
    torch.save(synthetic.sam_file_state_dict(src, cfg), paths["sam"])
    synthetic.save_torchscript(synthetic.openai_clip_file_state_dict(src, cfg.clip, tok),
                               paths["clip"])
    torch.save({"state_dict": synthetic.maple_file_state_dict(src, cfg.clip), "epoch": 5},
               paths["maple"])
    bank = rng.standard_normal((len(TEST_CLASS_NAMES), cfg.clip.embed_dim)).astype(np.float32)
    np.save(paths["bank"], bank / np.linalg.norm(bank, axis=-1, keepdims=True))
    del src
    sizes = ", ".join(f"{os.path.basename(p)} {os.path.getsize(p) / 2 ** 30:.3f} GiB"
                      for p in paths.values())
    log(f"[ckpt] wrote {sizes} in {time.perf_counter() - t0:.1f} s")
    return paths


def phase_ckpt(slice_counts):
    """The demo CLI's session at full width (bf16) from the reference's four
    files (`write_reference_files`: --sam-ckpt, --clip-ckpt, --maple-ckpt,
    --text-bank), through [slice]'s requests: every weight the files set
    equals the file's tensor cast to its type, conv1_alpha is zeros, the
    launch counts are exactly [slice]'s, and the masks, classes and text
    features are bit-equal to a second model with the first one's state dict
    loaded directly. The build's time (files read, weights copied, text
    encoded) and its device peak over what was allocated before it."""
    import torch
    from camouflaged_vlm_tpu_torch.cli import demo
    from camouflaged_vlm_tpu_torch.factory import attach_rel_cache, build_cascade, make_bank_inputs
    from camouflaged_vlm_tpu_torch.io import convert, torch_loader
    from camouflaged_vlm_tpu_torch.ops import _cuda

    os.makedirs(CKPT_WORK, exist_ok=True)
    paths = write_reference_files(CKPT_WORK)
    demo_dir = os.path.join(OUT_DIR, "demo_ckpt")
    os.makedirs(demo_dir, exist_ok=True)
    images = _synthetic_images(5)
    img_paths = []
    for i, img in enumerate(images):
        img_paths.append(os.path.join(demo_dir, f"synthetic_{i}.png"))
        img.save(img_paths[-1])
    args = demo.parse_args(["--image", img_paths[0], "--out-dir", demo_dir, "--device", "cuda",
                            "--dtype", "bfloat16", "--seed", "0",
                            "--sam-ckpt", paths["sam"], "--clip-ckpt", paths["clip"],
                            "--maple-ckpt", paths["maple"], "--text-bank", paths["bank"]])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    session = demo.DemoSession(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log(f"[ckpt] demo session from the four files (read, converted, copied; text encoded): "
        f"{build_s:.3f} s; device peak of the build {peak:.3f} GiB over the "
        f"{base / 2 ** 30:.3f} GiB allocated before it")
    outs = []
    for idx in SLICE_REQUESTS:
        batch = [images[i] for i in idx]
        outs.append(session.predict(batch))
        for j, i in enumerate(idx):
            cls = session.classnames[int(outs[-1][1][j])]
            demo.write_outputs(img_paths[i], np.asarray(images[i]), outs[-1][0][j], cls,
                               demo_dir)
    counts = _cuda.launch_counts()
    log(f"[ckpt] kernel launches {counts}")
    check(counts == slice_counts, f"[ckpt] launch counts {counts} != [slice]'s {slice_counts}")

    cfg, sd = session.cfg, session.model.state_dict()
    t0 = time.perf_counter()
    entries, tok, _ = convert.convert_openai_clip(
        torch_loader.load_openai_clip_state_dict(paths["clip"]), cfg.clip)
    n = {"clip": len(entries)}
    maple, _ = convert.convert_maple_prompt_learner(
        torch_loader.load_dassl_checkpoint(paths["maple"])[0], cfg.clip)
    sam, _ = convert.convert_sam_backbone(torch_loader.load_torch_state_dict(paths["sam"]), cfg)
    n.update(maple=len(maple), sam=len(sam))
    entries.update(maple)
    entries.update(sam)
    read_s = time.perf_counter() - t0
    bad = [k for k, v in entries.items() if not torch.equal(sd[k], v.to("cuda", sd[k].dtype))]
    alpha = sd["clip_model.image_encoder.conv1_alpha.weight"]
    bank = np.load(paths["bank"])
    log(f"[ckpt] {sum(n.values())} weights from the files ({n}; read and converted again on "
        f"the CPU in {read_s:.3f} s): {len(bad)} differ from the file's value cast to the "
        f"model's type {bad[:3]}; conv1_alpha max |w| {alpha.abs().max().item()}")
    check(not bad, f"[ckpt] loaded weights differ from the files: {bad[:5]}")
    check(alpha.abs().max().item() == 0, "[ckpt] conv1_alpha is not zeros")
    want = make_bank_inputs(cfg, session.classnames, token_embedding=tok, bank_features=bank)
    check(all(torch.equal(session.bank[k].cpu(), v) for k, v in want.items()),
          "[ckpt] the bank is not the file's features and the archive's token embedding")
    del entries, maple, sam

    direct = build_cascade(cfg, "cuda", seed=1)
    direct.load_state_dict(sd, strict=True)
    attach_rel_cache(direct)
    b = session.bank
    with torch.no_grad():
        tf = direct.encode_class_text_features(b["prefix"], b["suffix"], b["eot_indices"],
                                               b["bank_features"])
        same = [torch.equal(tf, session.text_features)]
        for idx, (probs, pred, logits) in zip(SLICE_REQUESTS, outs):
            p2, c2, l2 = direct.infer_cascade_with_text(
                *session.preprocess([images[i] for i in idx]), tf)
            same += [np.array_equal(p2[..., 0].cpu().numpy(), probs),
                     np.array_equal(c2.cpu().numpy(), pred),
                     np.array_equal(l2.float().cpu().numpy(), logits)]
    log(f"[ckpt] against the state dict loaded directly: text features, masks, classes and "
        f"logits bit-equal {all(same)} ({same}); classes "
        f"{[[session.classnames[int(c)] for c in o[1]] for o in outs]}")
    check(all(same), f"[ckpt] not bit-equal to the directly loaded session: {same}")
    del session, direct, sd
    torch.cuda.empty_cache()
    return paths


def phase_bank(paths):
    """`cli/precompute_text_bank.py` on the card from [ckpt]'s archive: the
    61 test classes with camoprompts, and imagenet80 for the first 4 (fp32
    tower: its MLPs on the fp32 #4/#5, 12 launches an encode call, one call
    a class), each against the same CLI with the tower's MLP on its plain
    fp32 version (TF32 off). Returns the fp32 kernel's launches."""
    import torch
    from camouflaged_vlm_tpu_torch.cli import precompute_text_bank as pb
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig
    from camouflaged_vlm_tpu_torch.models.clip import model as clip_model
    from camouflaged_vlm_tpu_torch.ops import _cuda
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    layers = AlphaClipConfig.vit_l_14_336().transformer_layers
    total = 0
    for mode, names, flags in (("camoprompts", TEST_CLASS_NAMES, ["--split", "test"]),
                               ("imagenet80", TEST_CLASS_NAMES[:4],
                                ["--classnames", ",".join(TEST_CLASS_NAMES[:4])])):
        argv = ["--clip-ckpt", paths["clip"], "--templates", mode, "--device", "cuda", *flags]
        runs = {}
        for kind in ("kernel", "plain"):
            out = os.path.join(CKPT_WORK, f"bank_{mode}_{kind}.npy")
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            if kind == "plain":  # the reference: the tower's MLP on its plain fp32 version
                clip_model.ln_mlp_residual_bt = lin.ln_mlp_residual_bt_ref
            try:
                bank = pb.main(argv + ["--out", out])
            finally:
                clip_model.ln_mlp_residual_bt = lin.ln_mlp_residual_bt
            torch.cuda.synchronize()
            runs[kind] = (bank, time.perf_counter() - t0, _cuda.launch_counts())
        (bank, secs, counts), (ref, ref_s, ref_counts) = runs["kernel"], runs["plain"]
        want = {k: 0 for k in counts}
        want["ln_mlp_residual_bt_f32"] = layers * len(names)
        err = float(np.abs(bank - ref).max() / np.abs(ref).max())
        norms = np.linalg.norm(bank, axis=-1)
        log(f"[bank] {mode}, {len(names)} classes: {secs:.3f} s (plain fp32 MLP {ref_s:.3f} s); "
            f"shape {bank.shape}; max|d|/max|ref| against the plain version {err:.3e} (bound "
            f"{BANK_REL_BOUND}); row norms {norms.min():.6f}-{norms.max():.6f}; fp32 #4/#5 "
            f"launches {counts['ln_mlp_residual_bt_f32']} (expected {layers} x {len(names)})")
        check(bank.shape == (len(names), 768) and bool(np.isfinite(bank).all()),
              f"[bank] {mode}: bad bank {bank.shape}")
        check(counts == want, f"[bank] {mode}: launches {counts} != {want}")
        check(not any(ref_counts.values()), f"[bank] {mode}: plain run launched {ref_counts}")
        check(err <= BANK_REL_BOUND, f"[bank] {mode}: {err} from the plain version")
        total += counts["ln_mlp_residual_bt_f32"]
    return total


def stage_times(m, cfg, tf, batches, label="", iters=5, trace=()):
    """The cascade call (`infer_cascade_with_text`) cut into its stages,
    CUDA events between them, median of `iters` calls on an idle card, for
    each batch size of `batches` ({size: (inp, clip image, clip mask)});
    beside the call's wall, the host CPU time of the process over the call
    (`time.process_time`: the wall minus it is time the host thread did not
    run, descheduled or waiting for the card). Also the device memory peak
    of those calls (the weights included, the build's fp32 staging not: the
    peak is reset before them), and for the batch sizes in `trace` a
    torch.profiler trace of one call (`trace_call`)."""
    import torch
    from camouflaged_vlm_tpu_torch.ops.resize import resize_bilinear

    names = [f"SAM encoder ({cfg.encoder.attn_impl})", "CLIP pass 1", "decoder + upsample",
             "sigmoid + alpha resize", "CLIP pass 2"]

    def call(inp, cimg, cmask):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        feats, _ = m.image_encoder(inp)
        ev[1].record()
        ifeat, tfeat, _, _ = m.clip_model.classify(cimg, cmask, tf)
        ev[2].record()
        masks, _, _ = m._decode(feats, m._sparse_embeddings(ifeat, tfeat))
        ev[3].record()
        alpha = resize_bilinear(torch.sigmoid(masks.float()), cfg.clip_size, cfg.clip_size)
        ev[4].record()
        m.clip_model.classify(cimg, alpha, tf)
        ev[5].record()
        return ev

    for bs, inputs in batches.items():
        rows = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            for it in range(iters + 1):
                torch.cuda.synchronize()
                t0, c0 = time.perf_counter(), time.process_time()
                ev = call(*inputs)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1000
                cpu = (time.process_time() - c0) * 1000
                if it:  # the first call warms up
                    rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))]
                                + [wall, cpu])
        med = np.median(np.array(rows), axis=0)
        parts = "; ".join(f"{n} {t:.2f}" for n, t in zip(names, med))
        log(f"[stages]{label} batch {bs} (median of {iters}, ms): {parts}; sum "
            f"{med[:-2].sum():.2f}; wall of the call {med[-2]:.2f}; host CPU time of the call "
            f"{med[-1]:.2f}; peak device memory of the calls "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        if bs in trace:
            with torch.no_grad():
                trace_call(lambda: call(*inputs), f"{label} batch {bs}", med[-2])


def busy_ms(events):
    """The union of the device events' intervals, ms: the card's busy time."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


# runtime calls and ops that can make the host wait for the card
SYNC_EVENTS = ("cudaMemcpy", "Synchronize", "aten::_local_scalar_dense")


def trace_call(fn, label, wall_ms, kernels=False):
    """One call of `fn` under torch.profiler (CPU and CUDA): the card's busy
    time (the union of its kernels' and copies' intervals), and against
    `wall_ms`, the call's wall without the profiler, its idle share; the
    device events' count; the runtime calls and ops that can wait for the
    card (`SYNC_EVENTS`); the host ops by self CPU time, the top ones logged
    and 25 written to OUT_DIR/trace<label>.txt; with
    `kernels`, also the device time of the kernels that take the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_ms(dev)
    avg = prof.key_averages()
    name = "trace" + re.sub(r"\W+", "_", label) + ".txt"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        f.write(avg.table(sort_by="self_cpu_time_total", row_limit=25))
    top = sorted((e for e in avg if e.self_cpu_time_total > 0),
                 key=lambda e: -e.self_cpu_time_total)[:6]
    tops = "; ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ms x {e.count}" for e in top)
    syncs = "; ".join(f"{e.key} x {e.count}" for e in avg
                      if any(s in e.key for s in SYNC_EVENTS)) or "none"
    dev_s = (f"device busy {busy:.2f} ms in {len(dev)} device events, idle share "
             f"{1 - busy / wall_ms:.3f} of the call's {wall_ms:.2f}-ms wall" if dev
             else "device busy not measured (the trace holds no device events)")
    log(f"[trace]{label}: {dev_s}; wall {wall:.2f} ms under the profiler; host ops' self "
        f"CPU {sum(e.self_cpu_time_total for e in avg) / 1e3:.2f} ms, the most: {tops}; "
        f"calls that can wait for the card: {syncs} ({OUT_DIR}/{name})")
    if kernels:
        def dt(e):
            return getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)

        ks = sorted((e for e in avg if e.device_type == DeviceType.CUDA and dt(e) > 0),
                    key=lambda e: -dt(e))[:8]
        short = [re.sub(r"^void |<.*$|\(.*$", "", e.key) for e in ks]
        log(f"[trace]{label}: kernels by device time: " + "; ".join(
            f"{n} {dt(e) / 1e3:.2f} ms x {e.count}" for n, e in zip(short, ks)))


def _check_grads(name, kfn, pfn, args, out_names, flops, reads):
    """A backward kernel against its plain backward on the same inputs:
    per output shape, type, finite, max_rel and mean_rel within
    KERNEL_REL_BOUND; times (kernel, plain) in ms; the bound from `flops`
    and the bytes of `reads` and of the outputs. No single PyTorch call
    computes these backwards (the fused MLP's dx; the attention's drel, a
    reduction of the bias gradient over the keys of each rel lane), so
    there is no library time."""
    import torch

    got = kfn(*args)
    torch.cuda.synchronize()
    want = pfn(*args)
    errs = {}
    for o, g, w in zip(out_names, got, want):
        if w is None:
            continue
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name} {o}: {g.shape}/{g.dtype} vs plain {w.shape}/{w.dtype}")
        check(bool(torch.isfinite(g).all()), f"{name} {o}: non-finite")
        errs[o] = errors(g, w)
    b = bound(flops, nbytes(*reads, *got))
    del got, want
    k_ms, p_ms = time_ms(lambda: kfn(*args)), time_ms(lambda: pfn(*args))
    k_q = time_ms(lambda: kfn(*args), queued=True)
    parts = "; ".join(f"{o} max_rel {e['max_rel']:.3e} mean_rel {e['mean_rel']:.3e}"
                      for o, e in errs.items())
    log(f"[grads] {name}: {parts} (bound {KERNEL_REL_BOUND}); kernel {k_ms:.4f} ms "
        f"(queued {k_q:.4f} ms) plain {p_ms:.4f} ms library none bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']})")
    for o, e in errs.items():
        check(e["max_rel"] < KERNEL_REL_BOUND and e["mean_rel"] < KERNEL_REL_BOUND,
              f"{name} {o} disagrees with the plain backward: {e}")
    return dict(max_abs_err=max(e["max_abs_err"] for e in errs.values()), ms=k_ms,
                plain_ms=p_ms, library_ms=None, queued_ms=k_q, library_queued_ms=None, **b)


def phase_grads():
    """The backward kernels against their plain backwards at the training
    path's full-width bf16 shapes (batch 2), and the plain-VJP Functions."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops import linear as lin
    from camouflaged_vlm_tpu_torch.ops.compact_window import (
        LPAD_LANE, NEG, CompactGeometry, edge_consts,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    bf, dev = torch.bfloat16, torch.device("cuda")

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    B, D, HD, NH, G, WIN = 2, 1280, 80, 16, 64, 14
    geom = CompactGeometry(G, G, WIN)
    nf, ne, R = geom.n_full, geom.n_edge, geom.R_u
    sg, sb = 1 + rn(D, std=0.1, dtype=torch.float32), rn(D, std=0.1, dtype=torch.float32)
    w1, b1 = rn(4 * D, D, std=0.02), rn(4 * D, std=0.02)
    w2, b2 = rn(D, 4 * D, std=0.02), rn(D, std=0.02)
    scale = HD ** -0.5
    mlp = lambda w: (lambda *a: lin.ln_mlp_residual_bt_bwd(*a, eps=1e-6, activation="gelu_tanh",  # noqa: E731
                                                           weights=w))
    mlp_ref = lambda w: (lambda *a: lin.ln_mlp_residual_bt_bwd_ref(  # noqa: E731
        *a, eps=1e-6, activation="gelu_tanh", weights=w))
    mlp_outs = ["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"]
    results = {}
    for label, rows, weights in (("SAM windows 32x196x1280", (B * nf, WIN * WIN), False),
                                 ("SAM edge 2x1008x1280", (B, geom.E), False),
                                 ("SAM global 2x4096x1280", (B, G * G), False),
                                 ("SAM windows 32x196x1280, weight grads", (B * nf, WIN * WIN),
                                  True)):
        args = (rn(*rows, D), sg, sb, w1, b1, w2, b2, rn(*rows, D, std=0.05))
        M = rows[0] * rows[1]
        # dx needs the hidden again (x . W1^T), dh = g . W2 and dx = dpre . W1;
        # with the weight gradients two more products
        r = _check_grads(f"ln_mlp_residual_bt_bwd ({label}, H 5120)", mlp(weights),
                         mlp_ref(weights), args, mlp_outs,
                         flops=2.0 * M * D * 4 * D * (5 if weights else 3), reads=args)
        if label.startswith("SAM global"):
            results["ln_mlp_residual_bt_bwd"] = dict(
                source="camouflaged_vlm_tpu_torch/csrc/ln_mlp_residual_bwd.cu",
                replaces="camouflaged_vlm_tpu/ops/linear.py:564", **r)
    S = WIN * WIN
    # per head: the scores again, dP = g . v^T, dv, dq and dk: five N^2 d products
    args = (rn(B * nf, S, 3 * D), rn(S, B * nf, NH * 32), fa.make_rel_scatter32(WIN, bf, dev),
            rn(B * nf, D, S, std=0.05), scale, NH, HD)
    results["flash_qkv_packed_windows_s_bwd"] = dict(
        source="camouflaged_vlm_tpu_torch/csrc/attn_bwd.cu",
        replaces="camouflaged_vlm_tpu/ops/flash_attention.py:617",
        **_check_grads("flash_qkv_packed_windows_s_bwd (qkv 32x196x3840)",
                       fa.flash_qkv_packed_windows_s_bwd, fa.flash_qkv_packed_windows_s_bwd_ref,
                       args, ["dqkv", "drel"], flops=10.0 * B * nf * NH * S * S * HD,
                       reads=(args[0], args[1], args[3])))
    N = G * G
    args = (rn(B, N, 3 * D), rn(N, B, NH, 2 * G), fa.make_rel_scatter(G, G, bf, dev),
            rn(B, D, N, std=0.05), scale, NH, HD, G, G)
    results["flash_qkv_packed_global_bwd"] = dict(
        source="camouflaged_vlm_tpu_torch/csrc/attn_bwd.cu",
        replaces="camouflaged_vlm_tpu/ops/flash_attention.py:1173",
        **_check_grads("flash_qkv_packed_global_bwd (qkv 2x4096x3840)",
                       fa.flash_qkv_packed_global_bwd,
                       lambda *a: fa.flash_qkv_packed_global_bwd_ref(*a[:7]), args,
                       ["dqkv", "drel"], flops=10.0 * B * NH * N * N * HD,
                       reads=(args[0], args[1], args[3])))

    # plain-VJP Functions: kernel forward, gradient of the plain version
    edge_rel = rn(B, ne, R, NH, 32)
    off = 0
    for grp in geom.edge_groups:
        edge_rel[:, off : off + grp.n, grp.rows :, :, LPAD_LANE] = NEG
        off += grp.n
    sel_e, kmask_e = edge_consts(geom, bf, dev)
    w_qkv, b_qkv = rn(3 * D, D, std=0.02), rn(3 * D, std=0.02)
    vjp_cases = [
        ("ln_linear_act_bt", lambda *a: lin.ln_linear_act_bt(*a, eps=1e-6, activation=None),
         lambda *a: lin.ln_linear_act_bt_ref(*a, eps=1e-6, activation=None),
         (rn(B * nf, S, D), sg, sb, w_qkv, b_qkv), (0,)),
        ("ln_mask_linear_bt", lambda *a: lin.ln_mask_linear_bt(*a, eps=1e-6),
         lambda *a: lin.ln_mask_linear_bt_ref(*a, eps=1e-6),
         (rn(B, N, D), sg, sb, torch.ones(1, N, 1, dtype=bf, device=dev), w_qkv, b_qkv), (0,)),
        ("proj_rows", lin.proj_rows, lin.proj_rows_ref,
         (dmajor(rn(B, nf, D, S)), rn(D, D, std=0.02), rn(D, std=0.02), rn(B, nf, S, D)),
         (0, 3)),
        ("flash_qkv_packed_edge", lambda *a: fa.flash_qkv_packed_edge(*a, scale, NH, HD),
         lambda *a: fa.flash_qkv_packed_edge_ref(*a, scale, NH, HD),
         (rn(B, ne, R, 3 * D), edge_rel.reshape(B, ne, R, NH * 32), sel_e, rn(NH, HD, std=0.5),
          kmask_e), (0, 1)),
        # #10 at SAM ViT-B's global blocks and #20 at ViT-H's 'aug_flash' ones,
        # batch 2: no backward kernel (nor in JAX), the plain version's VJP
        ("flash_attention_relpos", lambda *a: fa.flash_attention_relpos(*a, 64, 64),
         fa.xla_attention_relpos,
         (rn(24, N, 64, std=0.125), rn(24, N, 64), rn(24, N, 64), rn(24, N, 128),
          fa.make_rel_scatter(64, 64, bf, dev)), (0, 1, 2, 3)),
        ("flash_attention_fullk", fa.flash_attention_fullk, fa.flash_attention_fullk_ref,
         (rn(32, N, 208, std=0.07), rn(32, N, 208), rn(32, N, 80)), (0, 1, 2)),
    ]
    for name, fn, ref, args, wrt in vjp_cases:
        # a d-major x keeps its padded rows (a clone of the view would not)
        leaves = [(a.detach().clone() if a.is_contiguous() else dmajor(a)).requires_grad_(i in wrt)
                  for i, a in enumerate(args)]
        out = fn(*leaves)
        gy = rn(*out.shape, std=0.05)
        got = torch.autograd.grad(out, [leaves[i] for i in wrt], gy)
        want = torch.autograd.grad(ref(*leaves), [leaves[i] for i in wrt], gy)
        es = [errors(a, b) for a, b in zip(got, want)]
        log(f"[grads] {name} plain-VJP Function vs autograd of the plain version: "
            + "; ".join(f"max_rel {e['max_rel']:.3e}" for e in es) + f" (bound {VJP_REL_BOUND})")
        check(all(e["max_rel"] < VJP_REL_BOUND for e in es), f"{name} VJP differs: {es}")
    return results


def _small_batch(cfg, B=2, seed=7):
    rng = np.random.default_rng(seed)
    S, C = cfg.inp_size, cfg.clip_size
    yy, xx = np.mgrid[:S, :S]
    gt = np.stack([((yy - S * (0.35 + 0.1 * i)) ** 2 + (xx - S / 2) ** 2 < (S / 4) ** 2)
                   for i in range(B)])
    return {
        "inp": rng.standard_normal((B, S, S, 3)).astype(np.float32),
        "clip_image": rng.standard_normal((B, C, C, 3)).astype(np.float32),
        "clip_mask": np.full((B, C, C, 1), 1.923, np.float32),
        "gt": gt[..., None].astype(np.float32),
    }


def phase_train_small():
    """One train step of the small 'flash' cascade, bf16 on the card vs fp32
    on the CPU, same weights and batch; then the loss over 4 steps."""
    import torch
    from camouflaged_vlm_tpu_torch import train
    from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs
    from camouflaged_vlm_tpu_torch.ops import _cuda

    cpu_cfg, gpu_cfg = _small_config(torch.float32), _small_config(torch.bfloat16)
    ref = build_cascade(cpu_cfg, "cpu", seed=5)
    model = build_cascade(gpu_cfg, "cuda", seed=5)
    model.load_state_dict(ref.state_dict(), strict=True)
    batch = _small_batch(cpu_cfg)
    names = ["cat", "owl", "bat", "moth", "slug"]
    out = []
    _cuda.reset_launches()  # the CPU pass launches nothing
    for m, cfg, dev in ((ref, cpu_cfg, "cpu"), (model, gpu_cfg, "cuda")):
        params = train.trainable_parameters(m)
        bank = make_bank_inputs(cfg, names, seed=5, device=dev)
        tf = m.encode_class_text_features(bank["prefix"], bank["suffix"], bank["eot_indices"],
                                          bank["bank_features"])
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        masks, edges = m.forward_with_text(tb["inp"], tb["clip_image"], tb["clip_mask"], tf)
        loss, _ = train.segmentation_loss(masks, edges, tb["gt"])
        loss.backward()
        grads = {n: (p.grad.float().cpu() if p.grad is not None else torch.zeros(p.shape))
                 for n, p in m.named_parameters() if p.requires_grad}
        out.append((loss.item(), grads, params, tf, tb))
    check_sam_attention(_cuda.launch_counts(), gpu_cfg.encoder, "train_small", backward=True)
    (l_ref, g_ref, _, _, _), (l_gpu, g_gpu, params, tf, tb) = out
    dl = abs(l_gpu - l_ref) / abs(l_ref)
    rels = {}
    floor = TRAIN_SMALL_GRAD_FLOOR * max(float(w.norm()) for w in g_ref.values())
    for n, w in g_ref.items():
        nw = float(w.norm())
        d = float((g_gpu[n] - w).norm())
        if nw == 0.0:
            check(d == 0.0, f"train_small: {n} has a gradient on the card only")
            continue
        rels[n] = d / max(nw, floor)
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    log(f"[train_small] SAM 'flash' {gpu_cfg.encoder.num_heads} heads, grid "
        f"{gpu_cfg.encoder.grid}, window {gpu_cfg.encoder.window_size}; bf16 card vs fp32 CPU: "
        f"loss {l_gpu:.6f} vs {l_ref:.6f} (rel {dl:.3e}, bound {TRAIN_SMALL_LOSS_REL_BOUND}); "
        f"{len(rels)} trainable gradients, |d|/|g| median {np.median(list(rels.values())):.3e}, "
        f"worst {[(n, round(v, 4)) for n, v in worst]} (bound {TRAIN_SMALL_GRAD_REL_BOUND}, "
        f"floor {TRAIN_SMALL_GRAD_FLOOR} of the largest leaf norm {floor / TRAIN_SMALL_GRAD_FLOOR:.3e})")
    check(dl < TRAIN_SMALL_LOSS_REL_BOUND, f"train_small: loss differs by {dl}")
    check(max(rels.values()) < TRAIN_SMALL_GRAD_REL_BOUND, f"train_small: gradients {worst}")

    opt = train.make_optimizer(params)
    step = train.make_train_step(model, opt, train.cosine_epoch_schedule(2e-4, 20, 1))
    losses = [float(step({**tb, "text_features": tf}, i)["loss"]) for i in range(4)]
    log(f"[train_small] loss over 4 steps on a fixed batch: {[round(v, 5) for v in losses]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"train_small: loss {losses}")
    del ref, model, opt
    torch.cuda.empty_cache()


def phase_train_slice():
    """The full-width cascade trained through the train CLI: one epoch of 6
    synthetic images at batch 2 (3 steps)."""
    import torch
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES  # the 61 test classes
    from camouflaged_vlm_tpu_torch.cli import train as train_cli
    from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo
    from camouflaged_vlm_tpu_torch.factory import build_full_cascade
    from camouflaged_vlm_tpu_torch.ops import _cuda
    from camouflaged_vlm_tpu_torch.train.optim import is_trainable

    # the dataset and the 2 GB checkpoint stay out of OUT_DIR, which is kept
    # small enough to copy off the machine, and are removed at the end; the
    # train log is kept
    work = os.path.join("build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    info = write_synthetic_ovcamo(os.path.join(work, "ovcamo_synthetic"), n_train=6,
                                  n_test=2, seed=0, train_classes=("cat", "owl", "frog"),
                                  test_classes=tuple(TEST_CLASS_NAMES))
    save_dir = os.path.join(work, "save")
    before, _ = build_full_cascade(torch.bfloat16, "cuda", seed=0)
    start = {k: v.clone() for k, v in before.state_dict().items()}
    del before
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    run = train_cli.main(["--dataset-info", info, "--save-dir", save_dir, "--device", "cuda",
                          "--dtype", "bfloat16", "--epochs", "1", "--batch-size", "2",
                          "--epoch-val", "2", "--seed", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model, steps = run["model"], run["step"]
    cfg = model.cfg
    check(steps == 3, f"train_slice: {steps} steps, expected 3")
    metrics = run["epochs"][0]
    check(all(np.isfinite(v) for v in metrics.values()), f"train_slice: loss {metrics}")
    check(os.path.exists(os.path.join(save_dir, "ckpt_last.pt")), "train_slice: no ckpt_last")
    os.makedirs(OUT_DIR, exist_ok=True)
    shutil.copy(os.path.join(save_dir, "log.txt"), os.path.join(OUT_DIR, "train_log.txt"))
    shutil.rmtree(work)
    after = model.state_dict()
    frozen_moved = [k for k, v in start.items() if not is_trainable(k)
                    and not torch.equal(v, after[k])]
    trainable_keys = [k for k in start if is_trainable(k)]
    moved = [k for k in trainable_keys if not torch.equal(start[k], after[k])]
    pg = [k for k in trainable_keys if k.startswith("image_encoder.prompt_generator.")]
    log(f"[train_slice] {steps} steps, losses {metrics}; trainable tensors moved "
        f"{len(moved)}/{len(trainable_keys)} (prompt generator {len(set(pg) & set(moved))}/"
        f"{len(pg)}); frozen tensors changed {len(frozen_moved)}/{len(start) - len(trainable_keys)}")
    check(not frozen_moved, f"train_slice: frozen weights changed: {frozen_moved[:5]}")
    check(set(pg) <= set(moved), "train_slice: the prompt generator did not move")
    check(len(moved) >= 0.9 * len(trainable_keys), "train_slice: trainable weights did not move")

    # per step: one SAM encoder and one CLIP pass forward, SAM's backward
    expected = expected_launches(cfg, steps, clip_passes=1, backward=True)
    log(f"[train_slice] kernel launches {counts} expected {expected}")
    check(counts == expected, f"train launch counts {counts} != expected {expected}")
    st = run["step_seconds"]
    log(f"[train_slice] step wall times (s) {[round(x, 4) for x in st]}; median after the "
        f"first {np.median(st[1:]) * 1000:.1f} ms; CLI wall {wall:.1f} s; peak device memory "
        f"{peak:.2f} GiB (torch.cuda.max_memory_allocated)")
    train_times(run)
    return counts


def phase_train_val():
    """The train CLI's validation on the card: one epoch of 2 synthetic
    images at batch 2 (one step) with --epoch-val 1, so evaluate() runs on
    the model that has just taken a bf16 step (the 2-image test split at
    batch 1); its [val epoch 1] result, ckpt_best.pt and best_mae. Launches
    counted apart from train_slice's."""
    import torch
    from camouflaged_vlm_tpu_torch.cli import train as train_cli
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo
    from camouflaged_vlm_tpu_torch.ops import _cuda

    work = os.path.join("build", "chip_smoke_train_val")
    shutil.rmtree(work, ignore_errors=True)
    info = write_synthetic_ovcamo(os.path.join(work, "ovcamo_synthetic"), n_train=2,
                                  n_test=2, seed=0, train_classes=("owl", "frog"),
                                  test_classes=tuple(TEST_CLASS_NAMES))
    save_dir = os.path.join(work, "save")
    torch.cuda.empty_cache()
    _cuda.reset_launches()
    run = train_cli.main(["--dataset-info", info, "--save-dir", save_dir, "--device", "cuda",
                          "--dtype", "bfloat16", "--epochs", "1", "--batch-size", "2",
                          "--epoch-val", "1", "--seed", "0"])
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    cfg = run["model"].cfg
    vals = run["validations"]
    check(run["step"] == 1 and [v["epoch"] for v in vals] == [1],
          f"train_val: {run['step']} steps, validations {vals}")
    mae = vals[0]["mae"]
    check(np.isfinite(mae) and all(np.isfinite(v) for v in vals[0].values()),
          f"train_val: {vals[0]}")
    check(vals[0]["images"] == 2, f"train_val: {vals[0]['images']} images validated")
    with open(os.path.join(save_dir, "ckpt_meta.json")) as f:
        meta = json.load(f)
    logtext = open(os.path.join(save_dir, "log.txt")).read()
    check(os.path.exists(os.path.join(save_dir, "ckpt_best.pt")), "train_val: no ckpt_best.pt")
    check(meta.get("best_mae") == mae == run["best_mae"], f"train_val: meta {meta}, mae {mae}")
    check("[val epoch 1]" in logtext, "train_val: no [val epoch 1] line in the train log")
    # one train step (text tower once, one CLIP pass, SAM backward), then
    # evaluate(): the text tower again, a warm-up call and 2 calls at batch 1
    expected = expected_launches(cfg, 1, clip_passes=1, backward=True)
    for k, n in expected_launches(cfg, 3).items():
        expected[k] += n
    log(f"[train_val] 1 step, [val epoch 1] mae {mae} sm {vals[0]['sm']}; ckpt_best.pt and "
        f"best_mae {meta['best_mae']} written; kernel launches {counts} expected {expected}")
    check(counts == expected, f"train_val launch counts {counts} != expected {expected}")
    shutil.rmtree(work)
    del run
    torch.cuda.empty_cache()


def train_times(run, iters=3):
    """One train step at batch 2 cut into forward+loss, backward and the
    AdamW update (CUDA events), median of `iters` after a warm-up."""
    import torch
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES  # the 61 test classes
    from camouflaged_vlm_tpu_torch import train
    from camouflaged_vlm_tpu_torch.factory import make_bank_inputs

    model, opt = run["model"], run["optimizer"]
    cfg = model.cfg
    batch = {k: torch.from_numpy(v).cuda() for k, v in _small_batch(cfg).items()}
    bank = make_bank_inputs(cfg, TEST_CLASS_NAMES, device="cuda")
    tf = model.encode_class_text_features(bank["prefix"], bank["suffix"], bank["eot_indices"],
                                          bank["bank_features"])
    rows = []
    for it in range(iters + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        masks, edges = model.forward_with_text(batch["inp"], batch["clip_image"],
                                               batch["clip_mask"], tf)
        loss, _ = train.segmentation_loss(masks, edges, batch["gt"])
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        opt.zero_grad(set_to_none=True)
        ev[3].record()
        torch.cuda.synchronize()
        if it:  # the first step warms up
            rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    med = np.median(np.array(rows), axis=0)
    log(f"[train_times] batch 2 (median of {iters}, ms): forward + loss {med[0]:.2f}; "
        f"backward {med[1]:.2f}; optimizer {med[2]:.2f}; sum {med.sum():.2f}")
    # the backward alone under the profiler (its graph kept for the second
    # pass trace_call makes): the card's busy time against the backward's wall
    masks, edges = model.forward_with_text(batch["inp"], batch["clip_image"], batch["clip_mask"],
                                           tf)
    loss, _ = train.segmentation_loss(masks, edges, batch["gt"])
    trace_call(lambda: loss.backward(retain_graph=True), " train backward batch 2", med[1],
               kernels=True)
    opt.zero_grad(set_to_none=True)


def phase_unfused():
    """Depth-cut encoders at full width on the unfused paths, each against
    'reference' on the same bf16 weights: SAM ViT-B on 'flash' (12 heads x
    64: #10 in its windowed and its global block) and SAM ViT-H on
    'aug_flash' (#20 in the global block, plain attention_xla in the
    windowed one)."""
    import torch
    from camouflaged_vlm_tpu_torch.config import cascade_config_from_yaml

    vit_b = cascade_config_from_yaml(VIT_B_YAML)[0].encoder
    vit_h = cascade_config_from_yaml(VIT_H_YAML)[0].encoder
    x = _image(12, 1024)
    for label, base, impl, kernel in (("ViT-B", vit_b, "flash", "flash_attention_relpos"),
                                      ("ViT-H", vit_h, "aug_flash", "flash_attention_fullk")):
        cfg = dataclasses.replace(base, dtype=torch.bfloat16, depth=2, global_attn_indexes=(1,))
        e, ei, counts = _vs_reference(cfg, impl, 13, x)
        log(f"[unfused] SAM {label} depth 2 (1 windowed + 1 global), 1024 px, bf16, {impl!r} vs "
            f"'reference': neck mean_rel {e['mean_rel']:.3e} max_rel {e['max_rel']:.3e}; global "
            f"block mean_rel {ei['mean_rel']:.3e} max_rel {ei['max_rel']:.3e} (bound mean_rel "
            f"{VITH_MEAN_REL_BOUND}); launches {counts}")
        check(e["mean_rel"] < VITH_MEAN_REL_BOUND and ei["mean_rel"] < VITH_MEAN_REL_BOUND,
              f"unfused: {label} {impl} disagrees with reference: {e} {ei}")
        want_n = 2 if kernel == "flash_attention_relpos" else 1
        check(counts.get(kernel, 0) == want_n, f"unfused: {label} launched {kernel} "
              f"{counts.get(kernel, 0)} times, expected {want_n}")
        check(counts.get("flash_qkv_packed_global", 0) == 0, f"unfused: {label} ran fused")


def fused_route(nwin, H, W):
    """The JAX package's branch for a fused 'flash' block off the compact
    carry (`Attention.__call__`, sam_encoder.py:591-628): #12 + proj_rows,
    #11 + #8, or #17 + proj_rows."""
    if nwin > 1 or H * W <= 512:
        return ("flash_qkv_packed_windows", "proj_rows") if H + W <= 32 else (
            "flash_qkv_relpos_windows", "proj_from_heads_res")
    return ("flash_qkv_packed_global", "proj_rows")


def sam_expected(enc):
    """Kernel launches of one SAM encoder call, by its configuration's path,
    worked out from the JAX package's branches (not from the port's own
    routing): the fused blocks on the compact carry (window <= 14) or off
    it, the unfused ones on #10, the 'aug_flash' global ones on #20."""
    from camouflaged_vlm_tpu_torch.ops.compact_window import CompactGeometry

    n_glob = len(enc.global_attn_indexes)
    n_win = enc.depth - n_glob
    out = {"linear_act": 2}  # patch embed + EVP handcrafted embed
    add = lambda k, n=1: out.__setitem__(k, out.get(k, 0) + n)  # noqa: E731
    if not (enc.attn_impl == "flash" and enc.use_rel_pos and enc.num_heads % 8 == 0):
        add("flash_attention_relpos", enc.depth if enc.attn_impl == "flash" else 0)
        add("flash_attention_fullk", n_glob if enc.attn_impl == "aug_flash" else 0)
        return out
    g, win = enc.grid, enc.window_size
    geom = CompactGeometry(g, g, win)
    for windowed in [True] * n_win + [False] * n_glob:
        if windowed and geom.supported():  # interior windows, then the edge ones
            parts = 2 if geom.has_edge else 1
            for k in ("ln_linear_act_bt", "proj_rows", "ln_mlp_residual_bt"):
                add(k, parts)
            add("flash_qkv_packed_windows_s")
            add("flash_qkv_packed_edge", parts - 1)
            continue
        nwin, side = ((-(-g // win)) ** 2, win) if windowed else (1, g)
        for k in ("ln_mask_linear_bt", *fused_route(nwin, side, side), "ln_mlp_residual_bt"):
            add(k)
    return out


def expected_launches(cfg, calls, clip_passes=2, backward=False, text=True):
    """Launch counts of `calls` cascade calls (`clip_passes` CLIP vision
    passes per call), the text tower once when `text`, with SAM's backward
    kernels when `backward` (one per fused MLP, windows and global
    attention)."""
    from camouflaged_vlm_tpu_torch.ops import _cuda

    out = {k.name: 0 for k in _cuda.KERNELS}
    sam = sam_expected(cfg.encoder)
    for k, n in sam.items():
        out[k] += n * calls
    for k in ("ln_linear_act_bt", "flash_qkv_packed_plain", "proj_rows", "ln_mlp_residual_bt"):
        out[k] += clip_passes * cfg.clip.vision_layers * calls
    out["ln_mlp_residual_bt"] += cfg.clip.transformer_layers if text else 0
    if backward:
        for fwd in ("ln_mlp_residual_bt", "flash_qkv_packed_windows_s", "flash_qkv_packed_global"):
            out[fwd + "_bwd"] = sam.get(fwd, 0) * calls
    return out


def window_yaml(win, work):
    """The repo's ViT-H yaml with only `window_size` changed, under `work`:
    fused 'flash' off the compact carry (window 16: #12; window 17: #11 and
    #8). Not a published configuration, so not shipped."""
    import yaml

    raw = yaml.safe_load(open(VIT_H_YAML))
    raw["model"]["encoder"]["window_size"] = win
    path = os.path.join(work, f"vit_h_flash_win{win}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def phase_eval_slice():
    """The evaluate CLI at full width on five configurations: 5 synthetic
    test images of mixed sizes (the 61 test classes), batch 2, bf16. The
    repo's ViT-H yaml, the port's ViT-B yaml, ViT-H on 'aug_flash', and
    ViT-H at windows 16 and 17 (the padded carry)."""
    import torch
    from camouflaged_vlm_tpu_torch.cli import evaluate
    from camouflaged_vlm_tpu_torch.cli.eval_throughput import config_args
    from camouflaged_vlm_tpu_torch.config import cascade_config_from_yaml
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo
    from camouflaged_vlm_tpu_torch.ops import _cuda

    work = os.path.join("build", "chip_smoke_eval")
    shutil.rmtree(work, ignore_errors=True)
    info = write_synthetic_ovcamo(os.path.join(work, "ovcamo_synthetic"), n_train=0, n_test=5,
                                  seed=1, test_classes=tuple(TEST_CLASS_NAMES))
    n_images, batch = 5, 2
    calls = 1 + -(-n_images // batch)  # the warm-up call and 3 batches
    runs = {}
    for label in ("vit_h_flash", "vit_b_flash", "vit_h_aug_flash", "vit_h_flash_win16",
                  "vit_h_flash_win17"):
        if label.startswith("vit_h_flash_win"):  # the ViT-H yaml at another window
            path = window_yaml(int(label[-2:]), work)
        else:
            path = config_args(label, work)[1]  # 'aug_flash' as a yaml under work
        cfg = cascade_config_from_yaml(path)[0]
        out_dir = os.path.join(OUT_DIR, f"eval_{label}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        res = evaluate.main(["--dataset-info", info, "--config", path, "--device", "cuda",
                             "--dtype", "bfloat16", "--batch-size", str(batch),
                             "--output-dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(res["images"] == n_images, f"eval_slice {label}: {res['images']} images")
        check(all(np.isfinite(v) for v in res.values()), f"eval_slice {label}: {res}")
        check(os.path.exists(os.path.join(out_dir, "results.json")), "no results.json")
        expected = expected_launches(cfg, calls)
        log(f"[eval_slice] {label}: SAM {cfg.encoder.embed_dim} wide x {cfg.encoder.depth}, "
            f"{cfg.encoder.num_heads} heads, {cfg.encoder.attn_impl!r}, window "
            f"{cfg.encoder.window_size}; images_per_sec "
            f"{res['images_per_sec']} (3 batches + metric drain: a smoke figure with no steady "
            f"state; cli/eval_throughput.py measures the rate); CLI wall "
            f"{wall:.1f} s (build, text encode, warm-up included); peak device memory "
            f"{peak:.2f} GiB (torch.cuda.max_memory_allocated); sm {res['sm']} ori_sm "
            f"{res['ori_sm']} accuracy {res['accuracy']}")
        log(f"[eval_slice] {label} kernel launches {counts} expected {expected}")
        check(counts == expected, f"eval_slice {label}: launch counts {counts} != {expected}")
        runs[label] = dict(counts=counts, images_per_sec=res["images_per_sec"], peak_gib=peak)
        # the padded carry's configurations and the unfused ViT-B: the card's
        # busy time of a batch-2 call, which their kernels (#12, #11 + #8; #10)
        # move
        traced = cfg.encoder.window_size > 14 or cfg.encoder.num_heads % 8 != 0
        config_stage_times(cfg, label, trace=(2,) if traced else ())
    shutil.rmtree(work)
    host_metric_cost()
    return runs


def host_metric_cost(iters=5):
    """The evaluate CLI's per-image host work, one thread, median of
    `iters`: the class-agnostic COD metrics at the 1024 px model size, and
    the resize to an original 720 x 540 mask plus the class-aware OVCOS
    metrics (the CLI runs both in its metric pool, beside the device)."""
    from camouflaged_vlm_tpu_torch.metrics import CODMetrics, OVCOSMetricer
    from camouflaged_vlm_tpu_torch.utils.image import bilinear_resize_f32

    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:1024, :1024]
    gt = (((yy - 480) ** 2 + (xx - 530) ** 2) < 250 ** 2).astype(np.float32)
    prob = np.clip(0.8 * gt + 0.2 * rng.random((1024, 1024)), 0, 1).astype(np.float32)
    gt_orig = (bilinear_resize_f32(gt, 720, 540) > 0.5).astype(np.uint8) * 255

    def cod():
        CODMetrics().step(prob, gt)

    def ovcos():
        pred = (bilinear_resize_f32(prob, 720, 540) * 255).astype(np.uint8)
        OVCOSMetricer(["cat"], num_workers=0).step(pred, gt_orig, "cat", "cat")

    times = {}
    for name, fn in (("COD metrics at 1024 px", cod), ("resize + OVCOS metrics at 720x540", ovcos)):
        fn()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        times[name] = float(np.median(ts))
    log(f"[eval_slice] host metric work per image, one thread on the card's host "
        f"({os.cpu_count()} CPUs), median of {iters} (ms): "
        + "; ".join(f"{k} {v:.1f}" for k, v in times.items())
        + f"; sum {sum(times.values()):.1f}")


def config_stage_times(cfg, label, trace=()):
    """`stage_times` of a configuration's cascade at batch 1 and 2 (seeded
    random weights, rel cache attached, the 61 classes' text features), with
    a torch.profiler trace of one call at the batch sizes in `trace`."""
    import torch
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.data.transforms import (
        clip_image_transform, clip_ones_alpha, sam_image_transform,
    )
    from camouflaged_vlm_tpu_torch.factory import attach_rel_cache, build_cascade, make_bank_inputs

    model = attach_rel_cache(build_cascade(cfg, "cuda", 0))
    bank = make_bank_inputs(cfg, TEST_CLASS_NAMES, device="cuda")
    tf = model.encode_class_text_features(bank["prefix"], bank["suffix"], bank["eot_indices"],
                                          bank["bank_features"])
    images = _synthetic_images(2)

    def batch(n):
        return tuple(torch.from_numpy(np.stack(a)).cuda() for a in (
            [sam_image_transform(im, cfg.inp_size) for im in images[:n]],
            [clip_image_transform(im, cfg.clip_size) for im in images[:n]],
            [clip_ones_alpha(cfg.clip_size) for _ in images[:n]]))

    stage_times(model, cfg, tf, {1: batch(1), 2: batch(2)}, label=f" {label}", trace=trace)
    del model


# bounds of the graph phases: a replay runs the eager call's kernels on the
# same inputs, so its outputs are bit-equal; where a library op were not,
# its max_rel must stay within this (and the op is named)
GRAPH_REL_BOUND = 1e-2
GRAPH_BATCHES = (1, 2, 4)
TRACE_ATTEMPTS = 5


def _device_kernels(prof):
    """Kernel names and counts of a torch.profiler trace (copies and fills
    of the runtime left out), the card's busy ms, and the kernels' device
    ms by name."""
    from collections import Counter

    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    ms = Counter()
    for e in kernels:
        ms[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    return Counter(e.name for e in kernels), busy_ms(dev), ms


def _walls_ms(fn, iters=7):
    """Median wall (ms) of `iters` synchronised calls after one more."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(walls))


def phase_graph(session, images):
    """The demo configuration's cascade call captured as one CUDA graph at
    batch 1, 2 and 4 (`graphs.GraphedCall`, one shared pool): the replay's
    outputs against the eager call's on the same inputs, the launches
    recorded at capture against one call's expected launches (the text
    tower left out: it is encoded once, outside), a replay adds no host
    launch, a torch.profiler trace of one replay shows the eager trace's
    kernels with the same count per name, and the walls side by side."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from camouflaged_vlm_tpu_torch.graphs import GraphedCall
    from camouflaged_vlm_tpu_torch.ops import _cuda

    model, cfg, tf = session.model, session.cfg, session.text_features
    expected = expected_launches(cfg, 1, text=False)
    pool = torch.cuda.graph_pool_handle()
    graphs = []

    def fn(inp, cimg, cmask):
        return model.infer_cascade_with_text(inp, cimg, cmask, tf)

    for bs in GRAPH_BATCHES:
        inputs = session.preprocess(images[:bs])
        torch.cuda.synchronize()
        _cuda.reset_launches()
        eager = [t.clone() for t in fn(*inputs)]
        eager_counts = _cuda.launch_counts()
        t0 = time.perf_counter()
        g = GraphedCall(fn, *inputs, pool=pool)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        graphs.append(g)
        check(eager_counts == expected, f"graph b{bs}: eager launches {eager_counts}")
        check(g.launches == expected,
              f"graph b{bs}: launches at capture {g.launches} != expected {expected}")
        before = _cuda.launch_counts()
        out = g(*inputs)
        torch.cuda.synchronize()
        check(_cuda.launch_counts() == before, f"graph b{bs}: a replay launched from the host")
        diffs = {}
        for name, a, b in zip(("probs", "pred", "logits"), out, eager):
            check(a.shape == b.shape and a.dtype == b.dtype, f"graph b{bs}: {name} shape/type")
            if not torch.equal(a, b):
                diffs[name] = errors(a, b)["max_rel"]
        if diffs:  # name the stage that differs, then hold it to the bound
            log(f"[graph] batch {bs}: replay not bit-equal to eager: max_rel {diffs}; "
                f"stages: {graph_stage_diffs(model, cfg, tf, inputs)}")
            check(max(diffs.values()) <= GRAPH_REL_BOUND, f"graph b{bs}: max_rel {diffs}")
        # the kernels of one eager call and of one replay (no input copy); a
        # trace can lose device records (seen once in ~3.5% of a replay's),
        # so a pair that differs is traced again, up to TRACE_ATTEMPTS times
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            traces = {}
            for label, call in (("eager", lambda: fn(*inputs)),
                                ("graph", lambda: g(*g.static_inputs))):
                call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    call()
                    torch.cuda.synchronize()
                traces[label] = _device_kernels(prof)
            (k_eager, busy_eager, _), (k_graph, busy_graph, ms_graph) = (traces["eager"],
                                                                         traces["graph"])
            delta = {k[:80]: (k_eager.get(k, 0), k_graph.get(k, 0))
                     for k in set(k_eager) | set(k_graph) if k_eager.get(k) != k_graph.get(k)}
            if not delta:
                break
            log(f"[graph] batch {bs}: trace pair {attempt} differs: "
                f"{sum(k_eager.values())} kernels eager, {sum(k_graph.values())} replay; "
                f"(eager, replay) by name: {delta}")
        eager_ms = _walls_ms(lambda: fn(*inputs))
        graph_ms = _walls_ms(lambda: g(*inputs))
        log(f"[graph] batch {bs}: capture {capture_s:.2f} s; launches at capture "
            f"{sum(g.launches.values())} = expected; replay outputs "
            f"{'bit-equal to eager' if not diffs else diffs}; trace: {sum(k_graph.values())} "
            f"kernels of {len(k_graph)} names in the replay, {sum(k_eager.values())} of "
            f"{len(k_eager)} eager; card busy {busy_graph:.2f} ms replay, {busy_eager:.2f} ms "
            f"eager; wall (median of 7, ms): eager {eager_ms:.2f}, graph {graph_ms:.2f} "
            f"(x{eager_ms / graph_ms:.2f}); idle share {1 - busy_graph / graph_ms:.3f} graph, "
            f"{1 - busy_eager / eager_ms:.3f} eager; trace pair {attempt}")
        check(sum(k_graph.values()) > 0, f"graph b{bs}: the replay's trace holds no kernel")
        check(not delta, f"graph b{bs}: kernels (eager, replay) differ: {delta}")
        # where a replay's card time goes: the port's kernels against the
        # library's and aten's
        ours = sum(t for k, t in ms_graph.items() if "cvlm::" in k)
        n_ours = sum(n for k, n in k_graph.items() if "cvlm::" in k)
        top = "; ".join(f"{re.sub(r'^void |<.*$|[(].*$', '', k)} {t:.2f} ms x {k_graph[k]}"
                        for k, t in ms_graph.most_common(8))
        log(f"[graph] batch {bs}: the replay's kernels {sum(ms_graph.values()):.2f} ms: the "
            f"port's csrc kernels {ours:.2f} ms in {n_ours} launches, the rest (aten, cuBLAS, "
            f"cuDNN) {sum(ms_graph.values()) - ours:.2f} ms; the most: {top}")
    log(f"[graph] memory reserved with the {len(graphs)} graphs alive (one pool): "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB; allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    del graphs
    torch.cuda.empty_cache()


def graph_stage_diffs(model, cfg, tf, inputs):
    """max_rel of each stage's output between a graphed and an eager run
    of that stage alone, on the same inputs: where a replay differs."""
    import torch

    from camouflaged_vlm_tpu_torch.graphs import GraphedCall
    from camouflaged_vlm_tpu_torch.ops.resize import resize_bilinear

    inp, cimg, cmask = inputs
    feats, _ = model.image_encoder(inp)
    ifeat, tfeat, _, _ = model.clip_model.classify(cimg, cmask, tf)
    masks, _, _ = model._decode(feats, model._sparse_embeddings(ifeat, tfeat))
    alpha = resize_bilinear(torch.sigmoid(masks.float()), cfg.clip_size, cfg.clip_size)
    stages = {
        "SAM encoder": (lambda x: model.image_encoder(x)[0], (inp,)),
        "CLIP pass 1": (lambda c, m: model.clip_model.classify(c, m, tf)[3], (cimg, cmask)),
        "decoder + upsample": (lambda f, a, b: model._decode(
            f, model._sparse_embeddings(a, b))[0], (feats, ifeat, tfeat)),
        "CLIP pass 2": (lambda c, m: model.clip_model.classify(c, m, tf)[3], (cimg, alpha)),
    }
    out = {}
    with torch.no_grad():
        for name, (f, args) in stages.items():
            want = f(*args).clone()
            got = GraphedCall(f, *args)(*args)
            out[name] = 0.0 if torch.equal(got, want) else errors(got, want)["max_rel"]
    return out


def phase_serve(images):
    """The serving engine at full width on the default buckets (1, 4, 16,
    32), built by the serve CLI (`cli/serve.build_engine`: bf16, seeded
    weights, the 61 test classes, uint8 masks; the build's own peak
    memory), `warmup()` capturing every bucket; exact launches of the
    engine's run (the text encode, then per bucket two eager warm-up calls
    and the captured one); memory reserved with the four graphs; requests
    of 1, 3, 10 and 20 images (buckets 1, 4, 16, 32, padded), each
    request's mask, pred and logits equal to a direct graphed call of its
    bucket on the same padded batch; one HTTP round trip on localhost;
    `bench_engine` (masked, inputs staged) and `cli/serve_throughput.py`'s
    engine-only line."""
    import http.client
    import io

    import torch

    from camouflaged_vlm_tpu_torch.cli import serve as serve_cli
    from camouflaged_vlm_tpu_torch.cli import serve_throughput
    from camouflaged_vlm_tpu_torch.data.transforms import (
        clip_image_resized_u8, sam_image_resized_u8,
    )
    from camouflaged_vlm_tpu_torch.ops import _cuda
    from camouflaged_vlm_tpu_torch.serve import bench_engine

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base, base_alloc = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    # a long coalescing window, so that each burst below rides one batch
    engine = serve_cli.build_engine(serve_cli.parse_args(["--max-delay-ms", "300"]))
    torch.cuda.synchronize()
    log(f"[serve] the serve CLI's build (model, weights, 61-class text encode): peak "
        f"{(torch.cuda.max_memory_allocated() - base_alloc) / 2 ** 30:.3f} GiB above the "
        f"{base_alloc / 2 ** 30:.3f} GiB allocated before it (torch.cuda.max_memory_allocated)")
    cfg, names, buckets = engine.cfg, engine.classnames, engine.serve_cfg.buckets
    try:
        t0 = time.perf_counter()
        engine.warmup()
        warm_s = time.perf_counter() - t0
        check(engine.ready(), "serve: not ready after warmup")
        reserved = torch.cuda.memory_reserved() / 2 ** 30
        log(f"[serve] warmup: {len(buckets)} buckets {buckets} captured in {warm_s:.1f} s; "
            f"memory reserved {reserved:.2f} GiB ({(reserved - base / 2 ** 30):.2f} GiB more "
            f"than before the engine; one pool for the buckets), allocated "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
        for b, g in engine._graphs.items():
            check(g.launches == expected_launches(cfg, 1, text=False),
                  f"serve: bucket {b} launches at capture {g.launches}")
        rng = np.random.default_rng(3)
        pool = [(sam_image_resized_u8(im, cfg.inp_size), clip_image_resized_u8(im, cfg.clip_size))
                for im in images]
        pool += [(rng.integers(0, 256, a.shape, dtype=np.uint8),
                  rng.integers(0, 256, c.shape, dtype=np.uint8)) for a, c in pool[:3]]
        for n, bucket in zip((1, 3, 10, 20), buckets):
            reqs = [pool[i % len(pool)] for i in range(n)]
            t0 = time.perf_counter()
            futs = [engine.submit(a, c) for a, c in reqs]
            got = [f.result(timeout=600) for f in futs]
            wall = 1e3 * (time.perf_counter() - t0)
            pad = reqs + [reqs[-1]] * (bucket - n)
            with engine._graph_lock:
                want = [t.cpu() for t in engine._graphs[bucket](
                    *(torch.from_numpy(np.stack([r[j] for r in pad])).cuda() for j in (0, 1)))]
            for i, (m, p, s) in enumerate(got):
                check(np.array_equal(m, want[0][i].numpy()) and p == int(want[1][i])
                      and np.array_equal(s, want[2][i].float().numpy()),
                      f"serve: request {i} of {n} differs from bucket {bucket}'s direct call")
            log(f"[serve] {n} request(s) -> bucket {bucket}: each mask, pred and logits equal "
                f"to a direct graphed call of bucket {bucket} on the padded batch; wall from "
                f"the first submit to the last result {wall:.1f} ms; preds "
                f"{sorted({names[g[1]] for g in got})[:4]}")
        s = engine.stats()
        check(s["errors"] == 0 and s["requests"] == 34 and s["batches"] == 4,
              f"serve: stats {s}")
        # the engine's launches: the text tower once, three calls a bucket
        # (two eager warm-ups and the capture); the replays add none
        counts = _cuda.launch_counts()
        want = expected_launches(cfg, 3 * len(buckets))
        log(f"[serve] kernel launches of the engine's run {counts} expected {want}")
        check(counts == want, f"serve: launch counts {counts} != {want}")
        server, thread = serve_cli.serve_forever(engine, "127.0.0.1", 0, quiet=True)
        try:
            buf = io.BytesIO()
            images[1].save(buf, format="PNG")
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
            t0 = time.perf_counter()
            conn.request("POST", "/predict", body=buf.getvalue())
            r = conn.getresponse()
            body = r.read()
            rt = 1e3 * (time.perf_counter() - t0)
            resp = json.loads(body)
            check(r.status == 200 and resp["class"] in names and "mask_png_b64" in resp,
                  f"serve: HTTP {r.status} {body[:200]}")
            conn.request("GET", "/metrics")
            metrics = conn.getresponse().read().decode()
            conn.close()
            log(f"[serve] HTTP POST /predict on localhost ({images[1].size[0]}x"
                f"{images[1].size[1]} PNG): 200, class {resp['class']!r}, round trip "
                f"{rt:.1f} ms (the server's latency_ms {resp['latency_ms']}); /metrics "
                f"{metrics.splitlines()[0]}")
        finally:
            server.shutdown()
            server.server_close()
        rep = bench_engine(engine, n_images=128, stage_inputs=True)
        log(f"[serve] bench_engine, masked, staged: {rep['images_per_sec']:.2f} images/s over "
            f"128 requests ({rep['elapsed_s']:.2f} s); batches {rep['batch_size_hist']}; "
            f"per-bucket latency ms {json.dumps(rep['bucket_latency_ms'])}")
    finally:
        engine.close()
    del engine
    torch.cuda.empty_cache()
    # the engine-only mode: its own model, bucket 32, classification only
    rep = serve_throughput.main(["--requests", "192", "--buckets", "32", "--max-delay-ms", "5"])
    log(f"[serve] cli/serve_throughput.py engine-only: {rep['images_per_sec']:.2f} images/s "
        f"over 192 requests at bucket 32 (classification only, inputs staged); program-only "
        f"{rep['program_only_images_per_sec']:.2f} images/s; capture {rep['warmup_s']:.1f} s; "
        f"{rep['card']}")
    torch.cuda.empty_cache()


def phase_bench():
    """`cli/bench.py` in this process: the full cascade in bf16, eager and
    one CUDA graph per batch at 8, 1, 32, 2, 4 (5 timed calls each), its
    per-batch lines and its headline."""
    import torch

    from camouflaged_vlm_tpu_torch.cli import bench

    out = bench.main(["--iters", "5", "--warmup", "2"])
    for b, r in out["per_batch"].items():
        check(r["graph_vs_eager_max_abs"]["pred"] == 0.0, f"bench b{b}: graph pred differs")
        log(f"[bench] batch {b}: graph {r['graph_images_per_sec']:.2f} images/s "
            f"({r['graph_ms_per_call']:.2f} ms a call, latency {r['graph_latency_ms']:.2f}), "
            f"eager {r['eager_images_per_sec']:.2f} ({r['eager_ms_per_call']:.2f} ms, latency "
            f"{r['eager_latency_ms']:.2f}); x{r['graph_images_per_sec'] / r['eager_images_per_sec']:.2f}; "
            f"capture {r['capture_s']:.2f} s, {r['launches_at_capture']} launches; peak "
            f"{r['peak_memory_gib']:.3f} GiB; graph vs eager max_abs {r['graph_vs_eager_max_abs']}")
    h = out["headline"]
    log(f"[bench] headline: {json.dumps(h)}")
    check(h["value"] > 0 and h["mfu"] is not None, f"bench headline {h}")
    torch.cuda.empty_cache()


def main() -> None:
    if os.path.exists(LOG_FILE):
        os.remove(LOG_FILE)
    t_start = time.perf_counter()

    def timed(phase, *args):
        import torch

        t0 = time.perf_counter()
        out = phase(*args)
        log(f"[time] {phase.__name__}: {time.perf_counter() - t0:.1f} s (script at "
            f"{time.perf_counter() - t_start:.1f} s); device memory allocated after it "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, reserved "
            f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB")
        return out

    name, smi = timed(phase_device)
    timed(phase_build)
    results = timed(phase_kernels)
    timed(phase_small)
    timed(phase_vit_h)
    timed(phase_padded)
    counts, session, images = timed(phase_slice)
    timed(phase_graph, session, images)
    timed(phase_serve, images)
    del session
    try:
        ckpt_paths = timed(phase_ckpt, counts)
        f32_launches = timed(phase_bank, ckpt_paths)
    finally:
        shutil.rmtree(CKPT_WORK, ignore_errors=True)
    timed(phase_bench)
    grads = timed(phase_grads)
    timed(phase_train_small)
    train_counts = timed(phase_train_slice)
    timed(phase_train_val)
    timed(phase_unfused)
    evals = timed(phase_eval_slice)
    import torch

    # launches: each kernel's count in the run of its own main path (the
    # split-q/k/v and padded-carry kernels' from their eval-slice
    # configuration); the two kernels no path reaches carry their check's
    # count and say so (`NO_PATH`)
    ev = {label: r["counts"] for label, r in evals.items()}
    launches = {**counts, **{k: train_counts[k] for k in grads},
                "flash_attention_relpos": ev["vit_b_flash"]["flash_attention_relpos"],
                "flash_attention_fullk": ev["vit_h_aug_flash"]["flash_attention_fullk"],
                "flash_qkv_packed_windows": ev["vit_h_flash_win16"]["flash_qkv_packed_windows"],
                "flash_qkv_relpos_windows": ev["vit_h_flash_win17"]["flash_qkv_relpos_windows"],
                "proj_from_heads_res": ev["vit_h_flash_win17"]["proj_from_heads_res"],
                "ln_mlp_residual_bt_f32": f32_launches}
    kernels = [
        {"name": k, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": r["launches"] if k in NO_PATH else launches[k],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "queued_ms": r["queued_ms"], "library_queued_ms": r["library_queued_ms"],
         "host_us": r.get("host_us"),
         **({"gemm_library_ms": r["gemm_library_ms"]} if "gemm_library_ms" in r else {}),
         **({"path": r["path"]} if k in NO_PATH else {})}
        for res in (results, grads) for k, r in res.items()
    ]
    check(len(kernels) == 20 and all(e["launches"] > 0 for e in kernels)
          and all(launches[e["name"]] == 0 for e in kernels if e["name"] in NO_PATH),
          f"kernels line: {[(e['name'], e['launches']) for e in kernels]}")
    log("[device] name and power limit (nvidia-smi) of the card all numbers above ran on:")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
