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
  6g. profile `cli/profile.py` in this process: bf16 at batch 8 with --stages
              --trace, fp32 at batch 1 with --trace; JAX's timing lines, the
              card's busy time and idle share, the replay's device time by
              family (the port's kernels by name, cuBLAS, cuDNN, aten by
              launching op, copies and fills, other) and the eager call's
              library kernels by aten op; a replay's summed kernel time
              within 2% of its busy time, the families summing to the total,
              >= 99% of the replay's kernels paired with the eager launches;
              traces under build/chip_smoke_profile/ (removed after)
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
              images with --remat (the SAM blocks' forward kernels twice),
              then --epoch-val 1's graphed evaluate() of the test split;
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
              exact launch counts (each evaluate() one CUDA graph: its
              warm-ups and capture, replays launch nothing), images/s and peak
              memory per config (a
              smoke figure: 5 images have no steady state; the rate is
              `cli/eval_throughput.py`'s over 300); for ViT-H the graphed
              results dict equal to the eager one exactly at --mask-dtype
              float16 and float32 (the short last batch padded alike); then
              each configuration's cascade call cut into stages at batch 1 and 2
              (windows 16 and 17 and ViT-B also traced at batch 2: the card's
              busy time),
              and the CLI's host metric work per image
 12. f32_kernels  the fp32 instances on MaPLe training's path against their
              plain fp32 versions (TF32 off) within 1e-4 at its full-width
              shapes (batch 8 x 581 tokens, 1024 wide, 16 heads x 64): #2
              (LN1 + qkv), #16, #7 (out-projection + residual from the
              d-major attention output), #6 at the vision (H 4096) and text
              (14 classes x 77 tokens, 768, H 3072) sites, dx only, on each
              path its plan can choose, the paths bit-equal with K whole
              (`check_mlp_bwd`), and the fp32 #4/#5 at the vision width;
              then those on the cascade's
              path at --dtype float32 at SAM ViT-H's shapes, batch 1 and 2:
              #1 (patch embed), #3 (a global block's LN1 + mask + qkv), #13,
              #15 and #17 (16 heads x 80); and the backwards of the train CLI
              at --dtype float32: #14 and #18 at batch 2 and 1 (dqkv and
              drel; the library time a composite: autograd.grad through fp32
              SDPA with the bias built apart, drel from its gradient by one
              product) and #6 at SAM's three row sets (dx only, H 5120, each
              path; library a composite: autograd.grad through F.layer_norm,
              F.linear, the activation and F.linear);
              bounds against the fp32 CUDA-core peak (67 TFLOP/s)
 13. maple_small  one MaPLe step of a small fp32 CustomClip (128 wide, 2
              heads x 64) on the card against the same step on the CPU: the
              loss, every prompt-learner gradient within 1e-4, the prompts
              after SGD within 1e-5, exact launch counts
 14. maple_slice  `cli/train_maple.py` at full width (MaPLe Alpha-CLIP
              ViT-L/14@336, n_ctx 4, prompt depth 9) in fp32 on the card,
              batch 8, one epoch of 24 synthetic images of 14 train classes (3
              steps): exact launch counts (24 each of #2, #16, #7 and 36 each
              of the fp32 #4/#5 and #6 a step), only the prompt learner
              changed, finite losses, step walls, the CLI's peak memory; then
              one step cut into forward + loss, backward and SGD (CUDA
              events, `[maple_times]`); its model-best.pth.tar read back by
              the demo session's --maple-ckpt (the trained prompts, text
              features moved)
 15. f32_slice  the demo CLI at --dtype float32 on the card, full width (the
              reference configuration): TF32 turned off by the CLI, [slice]'s
              requests with exact launches of the fp32 instances (#1, #2, #3,
              #4/#5, #7, #13, #15, #16, #17) and none of a bf16 kernel; the
              fp32 cascade at batch 1 and full depth against the same state
              dict on the host's CPU (SAM embedding and mask logits within
              1e-3 mean relative, the same class, the CPU's seconds); the
              bf16 cascade's gap to it on the same weights (no gate); the
              graphed and eager calls at batch 1 and 2 with the card's busy
              time and idle share
 15b. jax_golden  the reference configuration's cascade on the card from
              `ab_fullsize_torch.py`'s numpy weight draw, image and bank,
              against the JAX package's own outputs on the same ones
              (tests/data/jax_fullsize_golden.npz, written on the CPU by
              `ab_fullsize_torch.py --write-golden`): fp32 (exact launches of
              the fp32 instances) within the A/B's inference bounds (the
              low-resolution mask logits, 8 channels of the SAM embedding and
              its mean and norm 1e-4 relative, the class logits 1e-3 of their
              range, the same class); bf16 on the same weights the same class
              (unless the golden's top-2 margin is under bf16's largest logit
              gap), its gaps and mask-probability MAE printed
 16. f32_train_small  one fp32 train step of a small fused cascade (SAM 512
              wide, 8 heads x 64, grid 24 with window 5: #13, #15, #17 and the
              backwards #14, #18) on the card against the same step on the
              CPU: the loss within 1e-5, every trainable gradient within
              1e-4, exact launches of the fp32 instances, none of a bf16 one
 17. f32_train_slice  the train CLI at --dtype float32 --device cuda at full
              width (batch 2, 3 steps of a synthetic split, --epoch-val 1):
              exact launches (84 / 12 / 180 of the fp32 #14 / #18 / #6), none
              of a bf16 kernel, TF32 off after the CLI, frozen weights
              unchanged, step walls, `train_times`' cut, peak memory; one
              step at depth 8 (global block 7), batch 1, card against the
              host's CPU (loss 1e-5, gradients 1e-3); the full-depth step in
              bf16 against fp32 on the card (no gate)
 17b. f32_train_remat  one fp32 step of the reference configuration at full
              width and depth, batch 2, without and with remat (the train
              CLI's --remat): loss within 1e-5, gradients within 1e-4 (bit
              equality expected, the largest difference logged), a lower peak
              with remat, both step walls, exact launches (the blocks'
              forward kernels twice)
 18. tp_kernels  #2, #3, #4/#5, #6, #7, #9, #13, #15, #16 and #17 and their
              fp32 instances at a tensor-parallel rank's widths (n_model 2
              and 4: SAM ViT-H's and CLIP ViT-L's 16 heads as 8 and 4), #4/#5
              and #7 also as a rank's fp32 partial, #6 without its residual
              term: errors against the plain versions (bf16 1e-2, fp32 1e-4),
              times on both clocks, bounds; the kernels line's `tp` rows
 19. tp_slice  the full-width bf16 cascade at batch 2 tensor-parallel over
              two ranks on this card (gloo through host memory) against one
              rank: the first SAM block within 1e-4 mean relative, the block
              by block spread of its rounding flips, the embedding within 1.5x
              one rank's own spread under an input change below bf16's
              resolution (or 1e-2), the same classes, exact launches per
              rank, each rank's all-reduces and their bytes, both walls
 20. dp_train  two ranks on this card: one fp32 train step at full width,
              depth 8, batch 2 on meshes (2, 1) and (1, 2) against one rank
              (|dloss| < 1e-5, parameters within 1e-4), then evaluate()
              data-parallel over 5 images against one device, equal metrics
 21. graph_memory  evaluate() 8 times and the train CLI's 4 validations in
              this process, memory_allocated after each: growth <= 0.05 GiB
 22. graft    graft_entry_torch.entry() on the card, then
              dryrun_multichip(2, device="cuda") (meshes (2, 1) and (1, 2))

Every kernel line carries its bound (the larger of its FLOP over the bf16
tensor-core peak, the fp32 one's over the fp32 CUDA-core peak, and its bytes
over the HBM rate, at this run's shapes) and
the time of one PyTorch library call computing the same function where
there is one. Before its last line the script prints one JSON object
{"kernels": [...]} of 38 kernels (one per wrapper; `ln_mlp_residual_bt`
serves TPU kernels #4 and #5, and `ln_mlp_residual_bt_f32` is their fp32
instance, with its launches from [bank]; the fp32 #2, #16, #7 and #6 with
theirs from [maple_slice]; the fp32 #1, #3, #13, #15 and #17 with theirs
from [f32_slice], their batch-2 times in `batch2_*` keys; the fp32 #14 and
#18 with theirs from [f32_train_slice], at batch 2 with the batch-1 times
in `batch1_*` keys; the kernels of [tp_kernels] with their rows at a
tensor-parallel rank's widths in `tp`), each with its launches on its path, or, for
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

# the trace readers the profile CLI shares (torch only, no card needed to import)
from camouflaged_vlm_tpu_torch.utils.profiling import (busy_ms, device_events, device_kernels,
                                                       trace_call)

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


# the fp32 loop's users at their paths' rel lanes, for [build]'s shared memory
F32_ATTN_SMEM_SITES = (("#16", 64, 64, "none", 0), ("#13", 80, 80, "sep", 28),
                       ("#15", 80, 80, "edge", 0), ("#17", 80, 80, "sep", 128),
                       ("#12", 80, 80, "sep", 32), ("#11", 80, 80, "sep", 34),
                       ("#10 windows", 64, 64, "sep", 28), ("#10 global", 64, 64, "sep", 128),
                       ("#20", 208, 80, "none", 0), ("#20 small", 128, 64, "none", 0))


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
                      r"|19mlp_bwd_dual_kernel|18ln_bwd_rows_kernel"
                      r"|6f32bwd\S*?attn_bwd_f32_\w+?_kernelILi80E)\S*)'", ln)
        if m and m.group(1) not in seen:
            seen.add(m.group(1))
            usage = [x.strip() for x in lines[i + 1:i + 4] if "Used" in x or "spill" in x]
            log(f"[build] {m.group(1)}: {'; '.join(usage)}")
    # csrc/sgemm_f32.cuh's instantiations (each source's own: four tiles, with
    # and without split K, per operand layout and epilogue), in one line
    sg, sg_names = [], []
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '_ZN4cvlm3f32\S*?12sgemm_kernelINS\S*?TileILi(\d+)"
                      r"ELi(\d+)ELi\d+ELi(\d+)E", ln)
        if m:
            sg_names.append((ln, m.group(3)))
            used = " ".join(lines[i + 1:i + 4])
            r = re.search(r"Used (\d+) registers", used)
            sp = re.search(r"(\d+) bytes spill stores", used)
            sg.append((m.group(1) + "x" + m.group(2), int(r.group(1)) if r else -1,
                       int(sp.group(1)) if sp else 0))
    by_tile = {}
    for t, r, _ in sg:
        by_tile.setdefault(t, []).append(r)
    regs = {t: f"{min(r)}-{max(r)}" for t, r in by_tile.items()}
    smem = {f"{bm}x{bn}": 3 * (bm + bn) * 32 * 4
            for bm, bn in ((128, 128), (64, 128), (128, 64), (64, 64))}
    # the MN path's (both operands MN-major; its own tiles at 3 and 2 blocks an SM)
    mn = sorted({(f"{t}/{b}", r) for (t, r, _), (ln, b) in zip(sg, sg_names)
                 if "EEELi1ELi1E" in ln})
    log(f"[build] sgemm_kernel (csrc/sgemm_f32.cuh): {len(sg)} instantiations, registers by "
        f"tile {regs}, {sum(1 for *_, sp in sg if sp)} with spills; dynamic shared memory per "
        f"block {smem} B (3 stages of 32-deep k tiles); the MN path's instances (tile/blocks "
        f"an SM, registers): {mn}")
    check(sg and not any(sp for *_, sp in sg), f"[build] sgemm_kernel spills: {sg}")
    # csrc/attn_f32.cuh's loop: every instantiation (each source's own, per
    # depth, bias, output layout and tile) with its registers and spills,
    # and the shared memory of each fp32 user at its path's lanes, tiles 0-3
    # as the library sizes them
    at = []
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '_ZN4cvlm7f32attn\S*?attn_f32_kernelILi(\d+)ELi(\d+)"
                      r"ELi(\d)ELi(\d)E\S*?ATileILi(\d+)ELi(\d+)ELi(\d)E", ln)
        if m:
            used = " ".join(lines[i + 1:i + 4])
            r = re.search(r"Used (\d+) registers", used)
            sp = re.search(r"(\d+) bytes spill stores", used)
            at.append(("<{},{},{},{},{}x{}x{}>".format(*m.groups()), int(r.group(1)) if r else -1,
                       int(sp.group(1)) if sp else 0))
    log(f"[build] attn_f32_kernel (csrc/attn_f32.cuh): {len(at)} instantiations "
        f"<dqk,dv,bias,out,rows x stage depth x stages>: registers "
        f"{sorted({(k, r) for k, r, _ in at})}, {sum(1 for *_, sp in at if sp)} with spills")
    check(at and not any(sp for *_, sp in at), f"[build] attn_f32_kernel spills: {at}")
    smem_at = {label: [(_cuda.attn_f32_smem(dqk, dv, bias, t, lanes)
                        if fa.f32_attn_smem(dqk, dv, bias, t, lanes) > 0 else None)
                       for t in range(len(fa.F32_ATTN_TILES))]
               for label, dqk, dv, bias, lanes in F32_ATTN_SMEM_SITES}
    log(f"[build] dynamic shared memory per block of the fp32 loop, tiles {fa.F32_ATTN_TILES}: "
        f"{smem_at} B")
    check(all(b is None or b == fa.f32_attn_smem(dqk, dv, bias, t, lanes) <= 232448
              for (label, dqk, dv, bias, lanes) in F32_ATTN_SMEM_SITES
              for t, b in enumerate(smem_at[label])),
          f"[build] the fp32 loop's shared memory disagrees with f32_attn_smem: {smem_at}")
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
    # its fp32 instance's three kernels (csrc/attn_bwd_f32.cu), the library's
    # sizes against the wrapper's `_cuda.attn_bwd_f32_smem`
    for d in (64, 80):
        lib, py = _cuda.attn_bwd_f32_smem_library(d), _cuda.attn_bwd_f32_smem(d, 64)
        log(f"[build] dynamic shared memory per block: fp32 #14/#18 at d = {d}: "
            f"attn_bwd_f32_stats_kernel {lib['stats']} B, attn_bwd_f32_key_kernel {lib['key']} "
            f"B, attn_bwd_f32_query_kernel {lib['query']} B")
        check(all(lib[k] == py[k] <= _cuda.SMEM_MAX for k in lib),
              f"attn_bwd_f32 shared memory: library {lib}, wrapper {py}")

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


# the fp32 rows of sgemm_f32.cuh's users at the cascade's shapes, by kernel
# name: the kernels line adds them to those kernels' entries ("cascade")
F32_CASCADE_ROWS = {}


def f32_library(kernel, args, eps, act):
    """One PyTorch call for the same function as an fp32 GEMM user on `args`
    (fp32, TF32 off), None where none computes it: #2 F.layer_norm +
    F.linear; #4/#5 F.layer_norm, F.linear, the activation, F.linear and the
    residual; #7 torch.baddbmm over the (B, T) groups with the bias folded
    into the residual outside the timed call (x as it lies, W^T for every
    group); #1 F.linear; #3 F.layer_norm, the row mask and F.linear."""
    import torch

    F = torch.nn.functional
    if kernel == "ln_linear_act_bt":
        x, g, b, w, bias = args
        return lambda: F.linear(F.layer_norm(x, (x.shape[-1],), g, b, eps), w, bias)
    if kernel == "ln_mask_linear_bt":
        x, g, b, mask, w, bias = args
        Bp, S, K = x.shape
        return lambda: F.linear((F.layer_norm(x, (K,), g, b, eps).view(-1, mask.shape[0], S, K)
                                 * mask).view(Bp, S, K), w, bias)
    if kernel == "ln_mlp_residual_bt":
        x, g, b, w1, b1, w2, b2 = args
        f = ((lambda h: h * torch.sigmoid(1.702 * h)) if act == "quick_gelu"
             else (lambda h: F.gelu(h, approximate="tanh")))
        return lambda: x + F.linear(f(F.linear(F.layer_norm(x, (x.shape[-1],), g, b, eps), w1,
                                               b1)), w2, b2)
    if kernel == "proj_rows":
        x, w, bias, res = args
        B, T, K, S = x.shape
        resb = (res + bias).reshape(B * T, S, -1)
        xt, wt = x.reshape(B * T, K, S).transpose(1, 2), w.t().expand(B * T, K, w.shape[0])
        return lambda: torch.baddbmm(resb, xt, wt)
    if kernel == "linear_act":
        return lambda: F.linear(*args)
    return None


def mlp_bwd_library(args, eps, act):
    """#6's yardsticks on its arguments (x, gamma, beta, W1, b1, W2, b2, g;
    fp32, TF32 off), the fused MLP's dx: (composite, products). No one
    PyTorch call computes it; the composite, as #14's and #18's, is
    torch.autograd.grad through F.layer_norm, F.linear, the activation and
    F.linear with respect to x alone (its forward graph kept, built outside
    the timed call); the products alone are #6's three through cuBLAS,
    g . W2, x . W1^T and their (M, H) result . W1 (another function: no LN,
    activation or LN backward)."""
    import torch

    F = torch.nn.functional
    x, g, b, w1, b1, w2, b2, gy = args
    K = x.shape[-1]
    f = ((lambda h: h * torch.sigmoid(1.702 * h)) if act == "quick_gelu"
         else (lambda h: F.gelu(h, approximate="tanh" if act == "gelu_tanh" else "none")))
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        y = xg + F.linear(f(F.linear(F.layer_norm(xg, (K,), g, b, eps), w1, b1)), w2, b2)
    x2, g2 = x.reshape(-1, K), gy.reshape(-1, K)

    def products():
        torch.matmul(x2, w1.t())
        return torch.matmul(torch.matmul(g2, w2), w1)

    return (lambda: torch.autograd.grad(y, xg, gy, retain_graph=True)[0]), products


def check_mlp_bwd(label, args, eps, act, flops):
    """#6 fp32 (dx only) at one site: `_check_kernel` at the plan's path,
    its bound against the fp32 peak (x, g, gamma, beta, W1, b1, W2 read;
    b2 is not), the composite and the products alone of `mlp_bwd_library`
    as its yardsticks; then each path its plan can choose
    (`linear.F32_PATH_FORCE`) against the plain dx within F32_REL_BOUND, and
    the paths bit-equal to each other with K whole (`F32_SPLIT_FORCE` 1:
    the plans' splits may differ by path). Returns `_check_kernel`'s dict
    with the paths' max_rel."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    def kfn(*a):
        return lin.ln_mlp_residual_bt_bwd(*a, eps=eps, activation=act, weights=False)[0]

    def pfn(*a):
        return lin.ln_mlp_residual_bt_bwd_ref(*a, eps=eps, activation=act, weights=False)[0]

    composite, products = mlp_bwd_library(args, eps, act)
    r = _check_kernel(f"ln_mlp_residual_bt_bwd_f32 ({label}, dx only, fp32, TF32 off)", kfn, pfn,
                      args, flops=flops, reads=args[:6] + (args[7],), library=composite,
                      gemm_library=products, rel_bound=F32_REL_BOUND, peak_flops=PEAK_F32_FLOPS)
    want, paths, whole = pfn(*args), {}, {}
    try:
        for p in lin.F32_PATHS:
            lin.F32_PATH_FORCE = p
            got = kfn(*args)
            e = errors(got, want)
            check(bool(torch.isfinite(got).all()) and e["max_rel"] < F32_REL_BOUND
                  and e["mean_rel"] < F32_REL_BOUND,
                  f"ln_mlp_residual_bt_bwd_f32 ({label}) on path {p} disagrees with plain: {e}")
            paths[p] = e["max_rel"]
            lin.F32_SPLIT_FORCE = 1
            whole[p] = kfn(*args)
            lin.F32_SPLIT_FORCE = None
    finally:
        lin.F32_PATH_FORCE = lin.F32_SPLIT_FORCE = None
    same = all(torch.equal(whole[lin.F32_PATHS[0]], w) for w in whole.values())
    log(f"[kernel] ln_mlp_residual_bt_bwd_f32 ({label}) each path: max_rel "
        f"{ {p: f'{v:.3e}' for p, v in paths.items()} }, bit-equal with K whole: {same}")
    check(same, f"ln_mlp_residual_bt_bwd_f32 ({label}): the paths differ with K whole")
    return dict(r, paths_max_rel=paths)


def f32_gemm_cases(rn, batches=(2, 1)):
    """(kernel, site, batch, kernel fn, plain fn, args, FLOP, library call,
    products alone) of sgemm_f32.cuh's users at every shape of the fp32
    cascade but #3's (`sam_f32_kernels` times it): #1's patch embed and EVP
    embed (N 40), #2 and #4/#5 at every SAM and CLIP shape of
    `ln_gemm_shapes` (and the text tower's), #7 at every `proj_rows_shapes`
    site; `rn` draws fp32; inputs are drawn case by case, in this order."""
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    for b in batches:
        for site, N in (("patch embed", 1280), ("EVP embed", 40)):
            x, w, bias = rn(b * 4096, 768), rn(N, 768, std=0.02), rn(N, std=0.02)
            yield ("linear_act", site, b, lin.linear_act, lin.linear_act_ref, (x, w, bias),
                   2.0 * b * 4096 * 768 * N, f32_library("linear_act", (x, w, bias), 0, None),
                   None)
    for kernel, site, b, lead, K, N, eps, act in ln_gemm_shapes(batches):
        if kernel == "ln_mask_linear_bt":
            continue
        kfn, pfn, args, flops, gemm = ln_gemm_case(rn, kernel, lead, K, N, eps, act)
        yield (kernel, site, b, kfn, pfn, args, flops, f32_library(kernel, args, eps, act), gemm)
    for b in batches:
        for site, shape, N in proj_rows_shapes(b):
            args, flops, gemm = proj_rows_case(rn, shape, N)
            yield ("proj_rows", site, b, lin.proj_rows, lin.proj_rows_ref, args, flops,
                   f32_library("proj_rows", args, 0, None), gemm)


def f32_cascade_gemms(rn, per_shape):
    """`f32_gemm_cases` against their plain fp32 versions within 1e-4 (TF32
    off), each timed with its bound against 67 TFLOP/s, its library call and
    its products alone; rows into `per_shape` and F32_CASCADE_ROWS."""
    import torch

    for kernel, site, b, kfn, pfn, args, flops, library, gemm in f32_gemm_cases(rn):
        shape = "x".join(map(str, args[0].shape))
        r = _check_kernel(f"{kernel}_f32 ({site} {shape}, batch {b}, fp32, TF32 off)", kfn, pfn,
                          args, flops=flops, library=library, gemm_library=gemm,
                          rel_bound=F32_REL_BOUND, peak_flops=PEAK_F32_FLOPS)
        per_shape[(kernel, site, b)] = r
        F32_CASCADE_ROWS.setdefault(kernel + "_f32", []).append(
            dict(site=site, batch=b, **{k: r.get(k) for k in (
                "ms", "queued_ms", "plain_ms", "library_ms", "gemm_library_ms", "bound_ms",
                "max_abs_err")}))
        del args, library, gemm
        torch.cuda.empty_cache()


def f32_per_call_table(per_shape):
    """Launches x time per fp32 cascade call of the reference config (#1,
    #2, #3, #4/#5, #7 at batch 1 and 2): `per_call_sites`' launches, #1 once
    for the patch embed and once for the EVP embed, summed over the shapes a
    call runs, on both clocks, beside the summed bound; and their sum."""
    per_call = {**per_call_sites(), "patch embed": 1, "EVP embed": 1}
    kernels = ("linear_act", "ln_linear_act_bt", "ln_mask_linear_bt", "ln_mlp_residual_bt",
               "proj_rows")
    for b in (1, 2):
        total = {"ms": 0.0, "queued_ms": 0.0, "bound_ms": 0.0}
        for kernel in kernels:
            rows = [(site, n, per_shape[(kernel, site, b)]) for site, n in per_call.items()
                    if (kernel, site, b) in per_shape]
            tot = {k: sum(n * r[k] for _, n, r in rows) for k in total}
            for k in total:
                total[k] += tot[k]
            parts = " + ".join(f"{n} x {site} {r['ms']:.4f} (queued {r['queued_ms']:.4f})"
                               for site, n, r in rows)
            log(f"[per_call] {kernel}_f32 batch {b}: {sum(n for _, n, _ in rows)} launches an "
                f"fp32 cascade call: {parts} = {tot['ms']:.3f} ms (queued "
                f"{tot['queued_ms']:.3f} ms), bound {tot['bound_ms']:.3f} ms")
        log(f"[per_call] sgemm_f32.cuh's users batch {b}, an fp32 cascade call: "
            f"{total['ms']:.3f} ms (queued {total['queued_ms']:.3f} ms), bound "
            f"{total['bound_ms']:.3f} ms")


# the two kernels no path of either package reaches (the JAX package's own
# tests call them): their launches are those of their check here
NO_PATH = {"proj_from_heads": "none on one device: PallasHeadProj is never called without the "
                              "residual; a tensor-parallel rank's window-17 blocks take it "
                              "for their fp32 partial ([tp_kernels])",
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
                 "flash_qkv_packed_global", "flash_attention_relpos", "flash_attention_fullk")


def check_sam_attention(counts, enc, label, backward=False, suffix=""):
    """The SAM attention kernels (and their backward kernels) of one
    encoder pass launched exactly as the configuration's path says, on
    their `suffix` instances ("_f32": the fp32 ones, 0 where there is none);
    the small cascade's global blocks (grid 10: 100 tokens, H+W 20) take
    #12, whose gradient is its plain version's VJP, so #17 and #18 stay
    idle."""
    want = sam_expected(enc)
    expected = {k: want.get(k, 0) for k in SAM_ATTENTION}
    names = list(SAM_ATTENTION)
    if backward:
        for k in ("flash_qkv_packed_windows_s", "flash_qkv_packed_global"):
            expected[k + "_bwd"] = want.get(k, 0)
            names.append(k + "_bwd")
    got = {k: counts.get(k + suffix, 0) for k in names}
    log(f"[{label}] SAM attention launches{f' ({suffix} instances)' if suffix else ''} {got} "
        f"expected {expected}")
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
                trace_call(lambda: call(*inputs), f"{label} batch {bs}", med[-2], OUT_DIR, log)


def _check_grads(name, kfn, pfn, args, out_names, flops, reads, rel_bound=KERNEL_REL_BOUND,
                 peak_flops=PEAK_BF16_FLOPS, library=None, library_label="", tag="grads"):
    """A backward kernel against its plain backward on the same inputs:
    per output shape, type, finite, max_rel and mean_rel within `rel_bound`;
    times (kernel, plain) in ms; the bound from `flops` (over `peak_flops`)
    and the bytes of `reads` and of the outputs. No single PyTorch call
    computes these backwards (the fused MLP's dx; the attention's drel, a
    reduction of the bias gradient over the keys of each rel lane): the
    library time is none, or that of `library`, a composite of PyTorch calls
    for the same outputs (`library_label` says which)."""
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
    b = bound(flops, nbytes(*reads, *got), peak_flops)
    del got, want
    k_ms, p_ms = time_ms(lambda: kfn(*args)), time_ms(lambda: pfn(*args))
    k_q = time_ms(lambda: kfn(*args), queued=True)
    lib_ms = time_ms(library) if library is not None else None
    lib_q = time_ms(library, queued=True) if library is not None else None
    lib = "none" if lib_ms is None else (f"{lib_ms:.4f} ms (queued {lib_q:.4f} ms; "
                                         f"{library_label})")
    parts = "; ".join(f"{o} max_rel {e['max_rel']:.3e} mean_rel {e['mean_rel']:.3e}"
                      for o, e in errs.items())
    log(f"[{tag}] {name}: {parts} (bound {rel_bound}); kernel {k_ms:.4f} ms "
        f"(queued {k_q:.4f} ms) plain {p_ms:.4f} ms library {lib} bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']})")
    for o, e in errs.items():
        check(e["max_rel"] < rel_bound and e["mean_rel"] < rel_bound,
              f"{name} {o} disagrees with the plain backward: {e}")
    return dict(max_abs_err=max(e["max_abs_err"] for e in errs.values()), ms=k_ms,
                plain_ms=p_ms, library_ms=lib_ms, queued_ms=k_q, library_queued_ms=lib_q, **b)


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


def step_grads(m, cfg, batch, names, dev, seed=5):
    """One train step's loss and trainable gradients (as fp32 CPU tensors)
    of model `m` on `batch` (numpy), conditioned on the text features of
    `names`' bank: (loss, {name: grad}, trainable params, text features,
    the batch on `dev`). Leaves the gradients in p.grad."""
    import torch
    from camouflaged_vlm_tpu_torch import train
    from camouflaged_vlm_tpu_torch.factory import make_bank_inputs

    params = train.trainable_parameters(m)
    bank = make_bank_inputs(cfg, names, seed=seed, device=dev)
    with torch.no_grad():
        tf = m.encode_class_text_features(bank["prefix"], bank["suffix"], bank["eot_indices"],
                                          bank["bank_features"])
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    for p in m.parameters():
        p.grad = None
    masks, edges = m.forward_with_text(tb["inp"], tb["clip_image"], tb["clip_mask"], tf)
    loss, _ = train.segmentation_loss(masks, edges, tb["gt"])
    loss.backward()
    grads = {n: (p.grad.float().cpu() if p.grad is not None else torch.zeros(p.shape))
             for n, p in m.named_parameters() if p.requires_grad}
    return loss.item(), grads, params, tf, tb


def grad_gaps(label, g_ref, g_other, floor_share=TRAIN_SMALL_GRAD_FLOOR):
    """Per trainable leaf |g_other - g_ref| / max(|g_ref|, floor_share * the
    largest leaf's |g_ref|) (L2 norms); a leaf whose reference gradient is
    exactly zero must be zero in g_other. Returns ({leaf: gap}, floor)."""
    floor = floor_share * max(float(w.norm()) for w in g_ref.values())
    rels = {}
    for n, w in g_ref.items():
        nw = float(w.norm())
        d = float((g_other[n] - w).norm())
        if nw == 0.0:
            check(d == 0.0, f"{label}: {n} has a gradient on one side only")
            continue
        rels[n] = d / max(nw, floor)
    return rels, floor


def describe_gaps(rels, floor, floor_share=TRAIN_SMALL_GRAD_FLOOR):
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    return (f"{len(rels)} trainable gradients, |d|/|g| median {np.median(list(rels.values())):.3e}, "
            f"worst {[(n, float(f'{v:.4g}')) for n, v in worst]} (floor {floor_share} of the "
            f"largest leaf norm {floor / floor_share:.3e})")


def phase_train_small():
    """One train step of the small 'flash' cascade, bf16 on the card vs fp32
    on the CPU, same weights and batch; then the loss over 4 steps."""
    import torch
    from camouflaged_vlm_tpu_torch import train
    from camouflaged_vlm_tpu_torch.factory import build_cascade
    from camouflaged_vlm_tpu_torch.ops import _cuda

    cpu_cfg, gpu_cfg = _small_config(torch.float32), _small_config(torch.bfloat16)
    ref = build_cascade(cpu_cfg, "cpu", seed=5)
    model = build_cascade(gpu_cfg, "cuda", seed=5)
    model.load_state_dict(ref.state_dict(), strict=True)
    batch = _small_batch(cpu_cfg)
    names = ["cat", "owl", "bat", "moth", "slug"]
    _cuda.reset_launches()  # the CPU pass launches nothing
    l_ref, g_ref, _, _, _ = step_grads(ref, cpu_cfg, batch, names, "cpu")
    l_gpu, g_gpu, params, tf, tb = step_grads(model, gpu_cfg, batch, names, "cuda")
    check_sam_attention(_cuda.launch_counts(), gpu_cfg.encoder, "train_small", backward=True)
    dl = abs(l_gpu - l_ref) / abs(l_ref)
    rels, floor = grad_gaps("train_small", g_ref, g_gpu)
    log(f"[train_small] SAM 'flash' {gpu_cfg.encoder.num_heads} heads, grid "
        f"{gpu_cfg.encoder.grid}, window {gpu_cfg.encoder.window_size}; bf16 card vs fp32 CPU: "
        f"loss {l_gpu:.6f} vs {l_ref:.6f} (rel {dl:.3e}, bound {TRAIN_SMALL_LOSS_REL_BOUND}); "
        f"{describe_gaps(rels, floor)} (bound {TRAIN_SMALL_GRAD_REL_BOUND})")
    check(dl < TRAIN_SMALL_LOSS_REL_BOUND, f"train_small: loss differs by {dl}")
    check(max(rels.values()) < TRAIN_SMALL_GRAD_REL_BOUND, f"train_small: gradients {rels}")

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
    images at batch 2 (one step, with --remat: the SAM blocks recomputed in
    the backward) with --epoch-val 1, so evaluate() runs on the model that
    has just taken a bf16 step (the 2-image test split at batch 1, one
    graph); its [val epoch 1] result, ckpt_best.pt and best_mae. Launches
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
                          "--epoch-val", "1", "--seed", "0", "--remat"])
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    cfg = run["model"].cfg
    vals = run["validations"]
    check(cfg.encoder.remat, "train_val: --remat did not reach the encoder's configuration")
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
    # one train step with --remat (text tower once, one CLIP pass, SAM's
    # backward and its blocks' forward again), then evaluate(): the text
    # tower again and the graph's warm-up and captured calls at batch 1
    expected = expected_launches(cfg, 1, clip_passes=1, backward=True, remat=True)
    for k, n in expected_launches(cfg, eval_calls()).items():
        expected[k] += n
    log(f"[train_val] 1 step, [val epoch 1] mae {mae} sm {vals[0]['sm']}; ckpt_best.pt and "
        f"best_mae {meta['best_mae']} written; kernel launches {counts} expected {expected}")
    check(counts == expected, f"train_val launch counts {counts} != expected {expected}")
    shutil.rmtree(work)
    del run
    torch.cuda.empty_cache()


def train_times(run, iters=3, label="train_times"):
    """One train step at batch 2 cut into forward+loss, backward and the
    AdamW update (CUDA events), median of `iters` after a warm-up; returns
    the three medians (ms)."""
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
    log(f"[{label}] batch 2 (median of {iters}, ms): forward + loss {med[0]:.2f}; "
        f"backward {med[1]:.2f}; optimizer {med[2]:.2f}; sum {med.sum():.2f}")
    # the backward alone under the profiler (its graph kept for the second
    # pass trace_call makes): the card's busy time against the backward's wall
    masks, edges = model.forward_with_text(batch["inp"], batch["clip_image"], batch["clip_mask"],
                                           tf)
    loss, _ = train.segmentation_loss(masks, edges, batch["gt"])
    trace_call(lambda: loss.backward(retain_graph=True),
               " " + label.replace("_times", "") + " backward batch 2", med[1], OUT_DIR, log,
               kernels=True)
    opt.zero_grad(set_to_none=True)
    return med


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


def expected_launches(cfg, calls, clip_passes=2, backward=False, text=True, remat=False):
    """Launch counts of `calls` cascade calls (`clip_passes` CLIP vision
    passes per call), the text tower once when `text`, with SAM's backward
    kernels when `backward` (one per fused MLP, windows and global
    attention), and with `remat` every SAM block's forward kernels once more
    (the backward's recompute; the patch embeds run once)."""
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
    if remat:
        for k, n in sam.items():
            out[k] += n * calls if k != "linear_act" else 0
    return out


# the host calls of one evaluate() on the card: the graph's eager warm-ups
# and its captured call (`graphs.GraphedCall`); its replays launch nothing
def eval_calls():
    from camouflaged_vlm_tpu_torch.graphs import WARMUP

    return WARMUP + 1


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
    calls = eval_calls()  # 3 batches, the last short, replay the one graph
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
        if label == "vit_h_flash":
            eval_graph_vs_eager(info, path, res, batch)
        # the padded carry's configurations and the unfused ViT-B: the card's
        # busy time of a batch-2 call, which their kernels (#12, #11 + #8; #10)
        # move
        traced = cfg.encoder.window_size > 14 or cfg.encoder.num_heads % 8 != 0
        config_stage_times(cfg, label, trace=(2,) if traced else ())
    shutil.rmtree(work)
    host_metric_cost()
    return runs


def eval_graph_vs_eager(info, path, graphed_f16, batch):
    """evaluate() of the ViT-H configuration (the CLI's model and bank, the
    same seed) on the 5 images at batch 2, the last batch short, graphed and
    eager at both mask types: each results dict (images_per_sec aside)
    equals the other path's exactly, at the same padding; exact launches
    (graphed: the capture's calls whatever the batches, eager: its warm-up
    call and one call a batch). `graphed_f16`: the CLI's own graphed run."""
    import torch
    from camouflaged_vlm_tpu_torch.cli import evaluate
    from camouflaged_vlm_tpu_torch.ops import _cuda

    args = evaluate.parse_args(["--dataset-info", info, "--config", path, "--device", "cuda",
                                "--dtype", "bfloat16", "--batch-size", str(batch),
                                "--output-dir", os.path.join(OUT_DIR, "eval_graph_vs_eager")])
    model, cfg, bank, index, _ = evaluate.load(args)
    n_batches = -(-len(index) // batch)
    for mask in ("float16", "float32"):
        res = {}
        for graph in (True, False):
            if graph and mask == "float16":
                res[graph] = graphed_f16
                continue
            _cuda.reset_launches()
            res[graph] = evaluate.evaluate(model, cfg, bank, index, batch_size=batch,
                                           mask_dtype=mask, graph=graph)
            torch.cuda.synchronize()
            counts = _cuda.launch_counts()
            want = expected_launches(cfg, eval_calls() if graph else 1 + n_batches)
            check(counts == want, f"eval_slice graph={graph} {mask}: launches {counts} != {want}")
        g, e = ({k: v for k, v in r.items() if k != "images_per_sec"} for r in res.values())
        log(f"[eval_slice] vit_h_flash --mask-dtype {mask}, 5 images at batch 2 (the last batch "
            f"padded): graphed images_per_sec {res[True]['images_per_sec']}, eager "
            f"{res[False]['images_per_sec']} (a smoke figure, metric drain included); results "
            f"equal exactly: {g == e}")
        check(g == e, f"eval_slice {mask}: graphed {g} != eager {e}")
    del model
    torch.cuda.empty_cache()


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
                traces[label] = device_kernels(prof)
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


# a replay runs its kernels one after another on one stream: their summed
# device time lies within this share of the card's busy time
PROFILE_SUM_BUSY_BOUND = 0.02
# the share of a replay's kernels that must pair with the eager call's
# launches (`profiling.align`: cuBLAS may pick other kernels under capture)
PROFILE_MATCH_BOUND = 0.99
PROFILE_WORK = os.path.join("build", "chip_smoke_profile")
PROFILE_LINES = ("sam encoder", "clip classify (1 pass)", "FULL fused cascade", "throughput:")


def phase_profile():
    """`cli/profile.py` in this process at full width: bf16 at batch 8 with
    --stages --trace, fp32 at batch 1 with --trace (TF32 off, as the CLI
    leaves it). Its lines go to the log: JAX's timing lines, the card's busy
    time and idle share, the replay's device time by family and by kernel,
    the eager call's library kernels by aten op. Checks: JAX's line names
    printed; a replay's summed device time within 2% of its busy time (one
    stream, no overlap); the families summing to the total; the replay's
    kernels paired (>= 99%) with the eager call's launches, the port's
    kernels among them; both traces written under --trace-dir (under
    build/, not OUT_DIR: they run to tens of MB; removed after)."""
    import contextlib
    import io

    from camouflaged_vlm_tpu_torch.cli import profile

    for dtype, argv in (("bfloat16", ["--batch", "8", "--stages"]),
                        ("float32", ["--batch", "1"])):
        trace_dir = os.path.join(PROFILE_WORK, dtype)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = profile.main([*argv, "--trace", "--dtype", dtype, "--trace-dir", trace_dir])
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(f"[profile] {dtype}: {line}")
        want = PROFILE_LINES if "--stages" in argv else PROFILE_LINES[2:]
        check(all(any(ln.startswith(n) for ln in lines) for n in want),
              f"[profile] {dtype}: JAX's lines {want} not all printed")
        rep = out["replay"]
        dev = device_events(out["profilers"]["replay"])
        summed = sum(e.time_range.end - e.time_range.start for e in dev) / 1e3
        busy = busy_ms(dev)
        gap = abs(summed - busy) / busy
        fams = sum(rep["families"].values())
        log(f"[profile] {dtype}: replay device time summed {summed:.3f} ms, busy {busy:.3f} ms "
            f"over {len(dev)} device events (gap {gap:.4f}, bound {PROFILE_SUM_BUSY_BOUND}); "
            f"families sum {fams:.3f} ms of the breakdown's total {rep['total_ms']:.3f}; "
            f"share of the kernels paired with the eager launches {rep['matched']:.4f} (bound "
            f"{PROFILE_MATCH_BOUND})")
        check(gap <= PROFILE_SUM_BUSY_BOUND, f"[profile] {dtype}: summed {summed} vs busy {busy}")
        check(abs(fams - rep["total_ms"]) <= 1e-9 * rep["total_ms"]
              and abs(rep["total_ms"] - summed) <= 1e-9 * summed,
              f"[profile] {dtype}: families {rep['families']} vs total {rep['total_ms']}")
        check(rep["matched"] >= PROFILE_MATCH_BOUND and rep["families"]["port kernels"] > 0,
              f"[profile] {dtype}: replay paired {rep['matched']} with the eager launches, or "
              "no port kernel")
        sizes = {os.path.basename(t): os.path.getsize(t) for t in out["traces"]}
        log(f"[profile] {dtype}: traces under {trace_dir}, bytes {sizes}")
        check(all(sizes.values()), f"[profile] {dtype}: empty traces {sizes}")
        del out
    shutil.rmtree(PROFILE_WORK, ignore_errors=True)
    import torch

    torch.cuda.empty_cache()


# ------------------------------------------------------------ MaPLe training

# MaPLe's full-width shapes: the ViT-L/14@336 vision blocks at the JAX CLI's
# batch 8 (577 tokens + 4 prompts, 1024 wide, 16 heads x 64, H 4096) and the
# text tower over 14 train classes x 77 tokens (768 wide, H 3072)
MAPLE_B, MAPLE_S, MAPLE_CLASSES = 8, 581, 14
# the fp32 step on the card against the same step on the CPU: both fp32
# with TF32 off, apart in summation order only; per prompt-learner tensor
# max|d| / max|g|, the loss relative
MAPLE_SMALL_REL_BOUND = 1e-4


def phase_f32_kernels():
    """The fp32 instances on MaPLe's path against their plain fp32 versions
    (TF32 off, set in [device]) at its full-width shapes, within 1e-4, their
    bound against the fp32 CUDA-core peak (67 TFLOP/s) and the HBM rate, and
    one PyTorch call for the same function (F.layer_norm + F.linear; fp32
    SDPA; torch.baddbmm with the bias folded into the residual beforehand;
    #6 a composite, `mlp_bwd_library`, and on each path, `check_mlp_bwd`);
    and the fp32 #4/#5 at the vision width; then the cascade's
    (`sam_f32_kernels`, the users of csrc/sgemm_f32.cuh at every shape of
    the fp32 cascade, `f32_cascade_gemms`, and their fp32 [per_call]
    lines), its backwards and the other routes'."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    F = torch.nn.functional
    check(not torch.backends.cuda.matmul.allow_tf32, "fp32 kernel checks need TF32 off")
    g = torch.Generator(device="cuda").manual_seed(16)

    def rn(*shape, std=1.0, dtype=None):  # fp32 whatever dtype the shared case functions ask
        return torch.randn(*shape, generator=g, device="cuda") * std

    B, S, W, NH, HD, H = MAPLE_B, MAPLE_S, 1024, 16, 64, 4096
    M, eps = B * S, 1e-5
    src = "camouflaged_vlm_tpu_torch/csrc/"
    out = {}

    def run(key, label, source, replaces, kfn, pfn, args, flops, library):
        r = _check_kernel(f"{key} ({label}, fp32, TF32 off)", kfn, pfn, args, flops=flops,
                          library=library, rel_bound=F32_REL_BOUND, peak_flops=PEAK_F32_FLOPS)
        out[key] = dict(source=src + source, replaces="camouflaged_vlm_tpu/ops/" + replaces, **r)

    with torch.no_grad():
        x, gam, bet = rn(B, S, W), 1 + rn(W, std=0.1), rn(W, std=0.1)
        wq, bq = rn(3 * W, W, std=0.02), rn(3 * W, std=0.02)
        run("ln_linear_act_bt_f32", f"LN1 + qkv {B}x{S}x{W} -> {3 * W}", "ln_linear_f32.cu",
            "linear.py:143",
            lambda *a: lin.ln_linear_act_bt(*a, eps=eps, activation=None),
            lambda *a: lin.ln_linear_act_bt_ref(*a, eps=eps, activation=None),
            (x, gam, bet, wq, bq), 2.0 * M * W * 3 * W,
            lambda: F.linear(F.layer_norm(x, (W,), gam, bet, eps), wq, bq))
        qkv = rn(B, S, 3 * W)
        r = qkv.reshape(B, S, 3, NH, HD)
        q, k, v = (r[:, :, i].transpose(1, 2) for i in range(3))
        run("flash_qkv_packed_plain_f32", f"{B}x{S}, {NH} heads x {HD}",
            "qkv_packed_plain_f32.cu", "flash_attention.py:875",
            lambda a: fa.flash_qkv_packed_plain(a, HD ** -0.5, NH, HD),
            lambda a: fa.flash_qkv_packed_plain_ref(a, HD ** -0.5, NH, HD),
            (qkv,), 4.0 * B * NH * S * S * HD,
            lambda: F.scaled_dot_product_attention(q, k, v, scale=HD ** -0.5))
        del qkv, r, q, k, v
        xd, res = dmajor(rn(B, 1, W, S)), rn(B, 1, S, W)
        wo, bo = rn(W, W, std=0.02), rn(W, std=0.02)
        # the library call's operands: x as it lies, W^T for every image, and
        # the bias folded into the residual outside the timed call
        resb, xt, wt = (res + bo).reshape(B, S, W), xd[:, 0].transpose(1, 2), wo.t().expand(B, W, W)
        run("proj_rows_f32", f"out-proj + residual {B}x{S}, K {W} -> {W}", "proj_rows_f32.cu",
            "linear.py:665", lin.proj_rows, lin.proj_rows_ref, (xd, wo, bo, res),
            2.0 * M * W * W, lambda: torch.baddbmm(resb, xt, wt))
        del xd, res, resb, xt, wt
        for site, (bb, ss, kk, hh) in (("vision", (B, S, W, H)),
                                       ("text", (MAPLE_CLASSES, 77, 768, 3072))):
            rows = bb * ss
            xm = rn(bb, ss, kk)
            args = (xm, 1 + rn(kk, std=0.1), rn(kk, std=0.1), rn(hh, kk, std=0.02),
                    rn(hh, std=0.02), rn(kk, hh, std=0.02), rn(kk, std=0.02))
            ga, be, w1, b1, w2, b2 = args[1:]
            gy = rn(bb, ss, kk)
            if site == "vision":
                def library():
                    h = F.linear(F.layer_norm(xm, (kk,), ga, be, eps), w1, b1)
                    return xm + F.linear(h * torch.sigmoid(1.702 * h), w2, b2)

                _check_kernel(
                    f"ln_mlp_residual_bt_f32 (vision {rows}x{kk}, H {hh}, fp32, TF32 off)",
                    lambda *a: lin.ln_mlp_residual_bt(*a, eps=eps, activation="quick_gelu"),
                    lambda *a: lin.ln_mlp_residual_bt_ref(*a, eps=eps, activation="quick_gelu"),
                    args, flops=4.0 * rows * kk * hh, library=library, rel_bound=F32_REL_BOUND,
                    peak_flops=PEAK_F32_FLOPS)
            # the kernels line holds the vision site
            r = check_mlp_bwd(f"{site} {rows}x{kk}, H {hh}", args + (gy,), eps, "quick_gelu",
                              6.0 * rows * kk * hh)
            if site == "vision":
                out["ln_mlp_residual_bt_bwd_f32"] = dict(
                    source=src + "ln_mlp_residual_bwd_f32.cu",
                    replaces="camouflaged_vlm_tpu/ops/linear.py:564", **r)
            del xm, args, gy, ga, be, w1, b1, w2, b2
        torch.cuda.empty_cache()
        per_shape = {}
        out.update(sam_f32_kernels(rn, per_shape))
        f32_cascade_gemms(rn, per_shape)
        f32_per_call_table(per_shape)
    out.update(sam_f32_grads(rn))
    torch.cuda.empty_cache()
    with torch.no_grad():
        out.update(route_f32_kernels(rn))
    torch.cuda.empty_cache()
    return out


# the fp32 instances of SAM's kernels, whose launches the kernels line takes
# from [f32_slice], and of its attention backwards, from [f32_train_slice]
# (the other fp32 instances' from [bank] and [maple_slice])
SAM_F32 = ("linear_act_f32", "ln_mask_linear_bt_f32", "flash_qkv_packed_windows_s_f32",
           "flash_qkv_packed_edge_f32", "flash_qkv_packed_global_f32")
SAM_F32_BWD = ("flash_qkv_packed_windows_s_bwd_f32", "flash_qkv_packed_global_bwd_f32")


def sam_f32_kernels(rn, per_shape):
    """The fp32 instances on the cascade's path at --dtype float32 (SAM
    ViT-H at 1024 px: #1, #3, #13, #15, #17; `rn` draws fp32) against their plain fp32
    versions within 1e-4, at batch 1 and 2, each with its bound against the
    fp32 CUDA-core peak and one PyTorch call for the same function (#1
    F.linear; #3 F.layer_norm, the row mask and F.linear, its product alone
    through F.linear as `gemm_library`; #13 and #17 fp32 SDPA with the bias rel @ sel built
    outside the timed call; #15 SDPA with the pad key as one more key). The
    kernels line holds batch 1 and the batch-2 times beside it; #1's and
    #3's rows also go into `per_shape` for the fp32 [per_call] lines."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops import linear as lin
    from camouflaged_vlm_tpu_torch.ops.compact_window import (
        LPAD_LANE, NEG, CompactGeometry, edge_consts,
    )

    F = torch.nn.functional
    f32, dev = torch.float32, torch.device("cuda")
    D, HD, NH, G, WIN, eps = 1280, 80, 16, 64, 14, 1e-6
    scale = HD ** -0.5
    geom = CompactGeometry(G, G, WIN)
    nf, ne, R = geom.n_full, geom.n_edge, geom.R_u
    sel32, sel_g = fa.make_rel_scatter32(WIN, f32, dev), fa.make_rel_scatter(G, G, f32, dev)
    sel_e, kmask_e = edge_consts(geom, f32, dev)
    src, rep = "camouflaged_vlm_tpu_torch/csrc/", "camouflaged_vlm_tpu/ops/"

    def heads_view(qkv):
        r = qkv.reshape(qkv.shape[:-1] + (3, NH, HD))
        return [r[..., i, :, :].transpose(-3, -2) for i in range(3)]

    def sdpa(qkv, bias):
        q, k, v = heads_view(qkv)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)

    def cases(B):
        """(name, source, replaces, kernel fn, plain fn, args, FLOP, tensors
        read, library call, products alone) at batch B."""
        x_pe, w_pe, b_pe = rn(B * 4096, 768), rn(1280, 768, std=0.02), rn(1280, std=0.02)
        yield ("linear_act_f32", "linear_f32.cu", "linear.py:61", lin.linear_act,
               lin.linear_act_ref, (x_pe, w_pe, b_pe), 2.0 * B * 4096 * 768 * 1280, None,
               lambda: F.linear(x_pe, w_pe, b_pe), None)
        del x_pe, w_pe, b_pe
        x = rn(B, G * G, D)
        w, b = rn(3 * D, D, std=0.02), rn(3 * D, std=0.02)
        args = (x, 1 + rn(D, std=0.1), rn(D, std=0.1),
                x.new_ones(1, G * G, 1), w, b)  # the global blocks' mask, as the encoder gives it
        yield ("ln_mask_linear_bt_f32", "ln_linear_f32.cu", "linear.py:228",
               lambda *a: lin.ln_mask_linear_bt(*a, eps=eps),
               lambda *a: lin.ln_mask_linear_bt_ref(*a, eps=eps), args,
               2.0 * B * G * G * D * 3 * D, None, f32_library("ln_mask_linear_bt", args, eps, None),
               lambda: F.linear(x, w))
        del x, w, b, args
        qkv, rel = rn(B * nf, WIN * WIN, 3 * D), rn(WIN * WIN, B * nf, NH * 32)
        bias = torch.matmul(rel.reshape(WIN * WIN, B * nf, NH, 32).permute(1, 2, 0, 3), sel32)
        yield ("flash_qkv_packed_windows_s_f32", "qkv_windows_f32.cu", "flash_attention.py:519",
               lambda *a: fa.flash_qkv_packed_windows_s(*a, scale, NH, HD),
               lambda *a: fa.flash_qkv_packed_windows_s_ref(*a, scale, NH, HD),
               (qkv, rel, sel32), 4.0 * B * nf * NH * (WIN * WIN) ** 2 * HD, (qkv, rel),
               sdpa(qkv, bias), None)
        del qkv, rel, bias
        rel = rn(B, ne, R, NH, 32)
        off = 0
        for grp in geom.edge_groups:  # dummy rows' pad-key logit, as the encoder clamps it
            rel[:, off : off + grp.n, grp.rows :, :, LPAD_LANE] = NEG
            off += grp.n
        args = (rn(B, ne, R, 3 * D), rel.reshape(B, ne, R, NH * 32), sel_e,
                rn(NH, HD, std=0.5), kmask_e)
        # the bias product rel @ sel (depth 32) beside q k^T
        yield ("flash_qkv_packed_edge_f32", "qkv_windows_f32.cu", "flash_attention.py:755",
               lambda *a: fa.flash_qkv_packed_edge(*a, scale, NH, HD),
               lambda *a: fa.flash_qkv_packed_edge_ref(*a, scale, NH, HD), args,
               2.0 * B * ne * NH * R * R * (2 * HD + 32), None, sdpa_edge(*args, NH, HD, scale),
               None)
        del rel, args
        qkv, rel = rn(B, G * G, 3 * D), rn(G * G, B, NH, 2 * G)
        bias = torch.matmul(rel.permute(1, 2, 0, 3), sel_g)
        yield ("flash_qkv_packed_global_f32", "qkv_packed_global_f32.cu",
               "flash_attention.py:1083",
               lambda *a: fa.flash_qkv_packed_global(*a, scale, NH, HD, G, G),
               lambda *a: fa.flash_qkv_packed_global_ref(*a, scale, NH, HD),
               (qkv, rel, sel_g), 4.0 * B * NH * (G * G) ** 2 * HD, (qkv, rel),
               sdpa(qkv, bias), None)

    out = {}
    for B in (1, 2):
        for name, source, replaces, kfn, pfn, args, flops, reads, library, gemm in cases(B):
            r = _check_kernel(f"{name} (SAM ViT-H at batch {B}, fp32, TF32 off)", kfn, pfn, args,
                              flops=flops, reads=reads, library=library, gemm_library=gemm,
                              rel_bound=F32_REL_BOUND, peak_flops=PEAK_F32_FLOPS)
            if name == "ln_mask_linear_bt_f32":
                per_shape[("ln_mask_linear_bt", "global", B)] = r
            if B == 1:
                out[name] = dict(source=src + source, replaces=rep + replaces, **r)
            else:
                out[name].update({f"batch2_{k}": r[k] for k in (
                    "ms", "queued_ms", "plain_ms", "library_ms", "bound_ms")})
            torch.cuda.empty_cache()
    check(tuple(out) == SAM_F32, f"sam_f32_kernels: {tuple(out)}")
    return out


# the fp32 instances of the other configurations' routes, by the eval
# configuration of [f32_routes] whose run gives their launches; the two no
# path reaches (NO_PATH_F32) carry their check's
ROUTE_F32 = {"flash_attention_relpos_f32": "vit_b_flash",
             "flash_attention_fullk_f32": "vit_h_aug_flash",
             "flash_qkv_packed_windows_f32": "vit_h_flash_win16",
             "flash_qkv_relpos_windows_f32": "vit_h_flash_win17",
             "proj_from_heads_res_f32": "vit_h_flash_win17"}
NO_PATH_F32 = {k + "_f32": v for k, v in NO_PATH.items()}


def route_f32_kernels(rn):
    """The fp32 instances of #10, #20, #12, #11, #19, #8 and #9 (`rn` draws
    fp32) against their plain fp32 versions within 1e-4 (TF32 off) at the
    bf16 rows' full-width shapes, batch 2 (`split_attention_kernels`,
    `padded_sites`, `proj_heads_case`): #10 at SAM ViT-B's windows and
    global blocks (the kernels line holds the global ones), #20 at ViT-H's
    'aug_flash' global blocks, #12 at window 16, #11 at window 17, #19 on the
    64 x 64 grid, #8 / #9 at window 17; bounds against the fp32 CUDA-core
    peak. Library calls: fp32 SDPA with the bias rel @ sel built outside the
    timed call (#10, #11, #12, #19), fp32 SDPA at scale 1 on the augmented
    features (#20); none for #8 / #9, their product alone through
    torch.einsum beside them (`gemm_library_ms`)."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import _cuda
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    F = torch.nn.functional
    f32, dev = torch.float32, torch.device("cuda")
    B, D, NH, HD = 2, 1280, 16, 80
    scale = HD ** -0.5
    src, rep = "camouflaged_vlm_tpu_torch/csrc/", "camouflaged_vlm_tpu/ops/"
    out = {}
    for k in (_cuda.PROJ_HEADS_F32, _cuda.QKV_RELPOS_GLOBAL_F32):
        k.launches = 0

    def run(key, label, source, replaces, kfn, pfn, args, flops, reads=None, library=None,
            gemm=None):
        r = _check_kernel(f"{key} ({label}, fp32, TF32 off)", kfn, pfn, args, flops=flops,
                          reads=reads, library=library, gemm_library=gemm,
                          rel_bound=F32_REL_BOUND, peak_flops=PEAK_F32_FLOPS)
        out[key] = dict(source=src + source, replaces=rep + replaces, **r)

    def sdpa(q, k, v, bias, sc=scale):
        q, k, v, bias = (t.flatten(0, -4) for t in (q, k, v, bias))  # 4D, copied here
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=sc)

    # #10 at SAM ViT-B's windows and global blocks (12 heads x 64)
    for label, BB, H in (("ViT-B windows", B * 25 * 12, 14), ("ViT-B global", B * 12, 64)):
        N, dh = H * H, 64
        q, k, v = rn(BB, N, dh, std=dh ** -0.5), rn(BB, N, dh), rn(BB, N, dh)
        rel, sel = rn(BB, N, 2 * H), fa.make_rel_scatter(H, H, f32, dev)
        bias = torch.matmul(rel, sel)
        run("flash_attention_relpos_f32", f"{label} {BB}x{N}x{dh}", "qkv_relpos_f32.cu",
            "flash_attention.py:134", lambda *a, H=H: fa.flash_attention_relpos(*a, H, H),
            fa.xla_attention_relpos, (q, k, v, rel, sel), 4.0 * BB * N * N * dh,
            reads=(q, k, v, rel),
            library=lambda q=q, k=k, v=v, b=bias: F.scaled_dot_product_attention(
                q, k, v, attn_mask=b, scale=1.0))
        del q, k, v, rel, bias
    # #20 at ViT-H's 'aug_flash' global blocks
    BB, N, dqk, dv = B * NH, 4096, 208, 80
    q, k, v = rn(BB, N, dqk, std=dqk ** -0.5), rn(BB, N, dqk), rn(BB, N, dv)
    run("flash_attention_fullk_f32", f"ViT-H aug_flash global {BB}x{N}x{dqk}/{dv}",
        "attn_fullk_f32.cu", "flash_attention.py:1352", fa.flash_attention_fullk,
        fa.flash_attention_fullk_ref, (q, k, v), 2.0 * BB * N * N * (dqk + dv),
        library=lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
    del q, k, v
    torch.cuda.empty_cache()
    # #12 at window 16: qkv (2, 16, 256, 3840), rel window-major (2, 16, 256, 512)
    nwin, win = 16, 16
    Nw = win * win
    qkv, rel = rn(B, nwin, Nw, 3 * D), rn(B, nwin, Nw, NH * 32)
    sel32 = fa.make_rel_scatter32(win, f32, dev)
    r = qkv.reshape(B, nwin, Nw, 3, NH, HD)
    q, k, v = (r[:, :, :, i].transpose(2, 3) for i in range(3))
    bias = torch.matmul(rel.reshape(B, nwin, Nw, NH, 32).transpose(2, 3), sel32)
    run("flash_qkv_packed_windows_f32", "ViT-H window 16, 2x16x256x3840", "qkv_windows_f32.cu",
        "flash_attention.py:337", lambda *a: fa.flash_qkv_packed_windows(*a, scale, NH, HD),
        lambda *a: fa.flash_qkv_packed_windows_ref(*a, scale, NH, HD), (qkv, rel, sel32),
        4.0 * B * nwin * NH * Nw * Nw * HD, reads=(qkv, rel), library=sdpa(q, k, v, bias))
    del qkv, rel, q, k, v, bias, r
    # #11 at window 17 and #19 on the 64 x 64 grid: the 5D / 4D views of the
    # packed qkv, rel per head
    for name, site, shape, H in (("flash_qkv_relpos_windows", ":213", (B, 16), 17),
                                 ("flash_qkv_relpos_global", ":1262", (B,), 64)):
        N = H * H
        qkv, rel = rn(*shape, N, 3 * NH, HD), rn(*shape, N, NH, 2 * H)
        sel = fa.make_rel_scatter(H, H, f32, dev)
        q, k, v = (qkv[..., i * NH:(i + 1) * NH, :].movedim(-2, 1) for i in range(3))
        bias = torch.matmul(rel.movedim(-2, 1), sel)
        wrapper, plain = getattr(fa, name), getattr(fa, name + "_ref")
        label = ("ViT-H window 17, 2x16x289x48x80" if len(shape) == 2
                 else "ViT-H grid 64, 2x4096x48x80")
        run(name + "_f32", label, "qkv_relpos_f32.cu", "flash_attention.py" + site,
            lambda *a, w=wrapper, H=H: w(*a, scale, H, H), lambda *a, p=plain: p(*a, scale),
            (qkv, rel, sel), 4.0 * qkv.shape[:-3].numel() * NH * N * N * HD, reads=(qkv, rel),
            library=sdpa(q, k, v, bias))
        del qkv, rel, q, k, v, bias
        torch.cuda.empty_cache()
    # #8 / #9 at window 17: x (2, 16, 16, 289, 80) head-leading -> (2, 16, 289, 1280)
    args, flops, gemm = proj_heads_case(rn, B)
    for name, site, a in (("proj_from_heads_res", ":756", args),
                          ("proj_from_heads", ":810", args[:3])):
        run(name + "_f32", "ViT-H window 17, 2x16x16x289x80 -> 1280", "proj_rows_f32.cu",
            "linear.py" + site, getattr(lin, name), lin.proj_from_heads_ref, a, flops, gemm=gemm)
    del args
    for name, path in NO_PATH_F32.items():
        kernel = _cuda.PROJ_HEADS_F32 if name == "proj_from_heads_f32" else \
            _cuda.QKV_RELPOS_GLOBAL_F32
        out[name].update(launches=kernel.launches, path=path)
    check(set(out) == set(ROUTE_F32) | set(NO_PATH_F32), f"route_f32_kernels: {tuple(out)}")
    return out


def sdpa_bwd_composite(qkv, relh, sel, g, scale, heads, d):
    """A library yardstick for the attention backward in fp32: a zero-argument
    call of torch.autograd.grad through fp32 SDPA (its forward graph kept,
    built outside the timed call) with respect to q, k, v and the bias, built
    apart as a (..., N, N) tensor that requires grad (rel @ sel), then drel
    from the bias gradient by one product against sel. A composite of
    PyTorch calls, not one call: its bias gradient alone is N / (H + W) times
    drel's size."""
    import torch

    BB, N, _ = qkv.shape
    r = qkv.reshape(BB, N, 3, heads, d)
    q, k, v = (r[:, :, i].transpose(1, 2).contiguous().requires_grad_(True) for i in range(3))
    bias = torch.matmul(relh, sel).requires_grad_(True)
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)
    go = g.reshape(BB, heads, d, N).transpose(-1, -2)

    def run():
        grads = torch.autograd.grad(out, (q, k, v, bias), go, retain_graph=True)
        return torch.matmul(grads[3], sel.t())

    return run


def sam_f32_grads(rn):
    """The fp32 backwards on the train CLI's path at --dtype float32 (SAM
    ViT-H at 1024 px; `rn` draws fp32) against their plain fp32 backwards
    within 1e-4, TF32 off: #14 and #18 at batch 2 and 1 (dqkv and drel;
    the kernel reads the fp32 forward kernel's output o, as the train step
    hands it), each with its bound against the fp32 CUDA-core peak and
    `sdpa_bwd_composite` as the library time (the kernels line holds batch
    2, the train slice's, with the batch-1 times beside it), and two calls
    bit-equal; then #6 at SAM's three row sets at batch 2 (dx only, K 1280,
    H 5120, `check_mlp_bwd`)."""
    import torch
    from camouflaged_vlm_tpu_torch.models import CascadeConfig
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops.compact_window import CompactGeometry

    f32, dev = torch.float32, torch.device("cuda")
    D, HD, NH, G, WIN = 1280, 80, 16, 64, 14
    S, N, scale = WIN * WIN, G * G, HD ** -0.5
    geom = CompactGeometry(G, G, WIN)
    sel32, sel_g = fa.make_rel_scatter32(WIN, f32, dev), fa.make_rel_scatter(G, G, f32, dev)
    src, rep = "camouflaged_vlm_tpu_torch/csrc/attn_bwd_f32.cu", "camouflaged_vlm_tpu/ops/"
    label = "composite: autograd.grad through fp32 SDPA, bias built apart, drel = dbias . sel^T"

    def cases(B):
        """(name, replaces, shape, kernel fn, plain fn, args, FLOP, the
        rel lanes per (problem, head, query), sel) at batch B"""
        BW = B * geom.n_full
        args = (rn(BW, S, 3 * D), rn(S, BW, NH * 32), sel32, rn(BW, D, S, std=0.05), scale, NH,
                HD)
        o = fa.flash_qkv_packed_windows_s(*args[:3], scale, NH, HD)
        yield ("flash_qkv_packed_windows_s_bwd_f32", "flash_attention.py:617",
               f"qkv {BW}x{S}x{3 * D}",
               lambda *a, o=o: fa.flash_qkv_packed_windows_s_bwd(*a, o=o),
               fa.flash_qkv_packed_windows_s_bwd_ref, args, o, 10.0 * BW * NH * S * S * HD,
               args[1].reshape(S, BW, NH, 32).permute(1, 2, 0, 3), sel32)
        args = (rn(B, N, 3 * D), rn(N, B, NH, 2 * G), sel_g, rn(B, D, N, std=0.05), scale, NH,
                HD, G, G)
        o = fa.flash_qkv_packed_global(*args[:3], scale, NH, HD, G, G)
        yield ("flash_qkv_packed_global_bwd_f32", "flash_attention.py:1173",
               f"qkv {B}x{N}x{3 * D}", lambda *a, o=o: fa.flash_qkv_packed_global_bwd(*a, o=o),
               lambda *a: fa.flash_qkv_packed_global_bwd_ref(*a[:7]), args, o,
               10.0 * B * NH * N * N * HD, args[1].permute(1, 2, 0, 3), sel_g)

    out = {}
    for B in (2, 1):
        for name, replaces, shape, kfn, pfn, args, o, flops, relh, sel in cases(B):
            # five N^2 d products a (problem, head): the scores, dP, dv, dq, dk
            r = _check_grads(f"{name} (SAM ViT-H {shape}, batch {B}, fp32, TF32 off)", kfn, pfn,
                             args, ["dqkv", "drel"], flops, reads=(args[0], args[1], args[3], o),
                             rel_bound=F32_REL_BOUND, peak_flops=PEAK_F32_FLOPS,
                             library=sdpa_bwd_composite(args[0], relh, sel, args[3], scale, NH,
                                                        HD),
                             library_label=label, tag="kernel")
            # no atomics: two calls on the same inputs give the same bits
            first, second = kfn(*args), kfn(*args)
            same = all(torch.equal(x, y) for x, y in zip(first, second))
            log(f"[kernel] {name} batch {B}: two calls bit-equal (dqkv, drel): {same}")
            check(same, f"{name}: two calls on the same inputs differ")
            del first, second
            if B == 2:
                out[name] = dict(source=src, replaces=rep + replaces, **r)
            else:
                out[name].update({f"batch1_{k}": r[k] for k in (
                    "ms", "queued_ms", "plain_ms", "library_ms", "bound_ms")})
            del args, relh, o
            torch.cuda.empty_cache()
    enc = CascadeConfig.full().encoder
    act = "gelu_tanh" if enc.gelu_approximate else "gelu"
    for site, rows in (("global", (2, N)), ("windows", (2 * geom.n_full, S)),
                       ("edge", (2, geom.E))):
        M = rows[0] * rows[1]
        args = (rn(*rows, D), 1 + rn(D, std=0.1), rn(D, std=0.1), rn(4 * D, D, std=0.02),
                rn(4 * D, std=0.02), rn(D, 4 * D, std=0.02), rn(D, std=0.02), rn(*rows, D))
        # dx needs the hidden again (x . W1^T), dh = g . W2 and dx = dpre . W1
        check_mlp_bwd(f"SAM {site} {rows[0]}x{rows[1]}x{D}, H {4 * D}", args, 1e-6, act,
                      6.0 * M * D * 4 * D)
        del args
        torch.cuda.empty_cache()
    return out


def _maple_small_config(dtype):
    import dataclasses

    from camouflaged_vlm_tpu_torch.models import CascadeConfig
    from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig

    # the fp32 attention takes d in (64, 128): CLIP 128 wide (2 heads x 64),
    # 3 vision and 3 text layers, prompt depth 3
    clip = AlphaClipConfig.tiny(dtype=dtype, vision_width=128, vision_heads=2, prompt_depth=3)
    return dataclasses.replace(CascadeConfig.tiny(dtype=dtype), clip=clip)


def maple_expected(clip, steps):
    """Launch counts of `steps` MaPLe steps in fp32: per step the vision
    tower's LN1 + qkv, attention and out-projection in each of its blocks,
    the fused MLP in each block of both towers (the text tower's attention
    is masked and plain), and the MLP's backward in each of them (the
    prompts enter both towers' first layer, so every block is on the
    gradient's path; the plain backwards of the others launch nothing)."""
    from camouflaged_vlm_tpu_torch.ops import _cuda

    out = {k.name: 0 for k in _cuda.KERNELS}
    for k in ("ln_linear_act_bt_f32", "flash_qkv_packed_plain_f32", "proj_rows_f32"):
        out[k] = clip.vision_layers * steps
    for k in ("ln_mlp_residual_bt_f32", "ln_mlp_residual_bt_bwd_f32"):
        out[k] = (clip.vision_layers + clip.transformer_layers) * steps
    return out


def phase_maple_small():
    """One MaPLe step of a small fp32 CustomClip on the card against the same
    step on the CPU, same weights, bank and batch: the loss, every
    prompt-learner gradient and the prompts after the SGD update; exact
    launch counts on the card."""
    import torch
    from camouflaged_vlm_tpu_torch import train
    from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs
    from camouflaged_vlm_tpu_torch.ops import _cuda

    cfg = _maple_small_config(torch.float32)
    names = ["cat", "owl", "bat", "moth", "slug"]
    rng = np.random.default_rng(3)
    C = cfg.clip_size
    batch = {"clip_image": rng.standard_normal((4, C, C, 3)).astype(np.float32),
             "clip_alpha": rng.standard_normal((4, C, C, 1)).astype(np.float32),
             "label_id": np.array([0, 3, 1, 4], np.int32)}
    ref = build_cascade(cfg, "cpu", seed=4)
    runs = {}
    for dev in ("cpu", "cuda"):
        model = build_cascade(cfg, dev, seed=4)
        model.load_state_dict(ref.state_dict(), strict=True)
        params = train.trainable_parameters(model, train.MAPLE_TRAINABLE_PREFIXES)
        pnames = {id(p): n for n, p in model.named_parameters()}
        grads = {}
        for p in params:
            p.register_post_accumulate_grad_hook(
                lambda q, grads=grads, pnames=pnames: grads.__setitem__(pnames[id(q)],
                                                                         q.grad.float().cpu()))
        opt = train.make_maple_optimizer(params, 0.01)
        step = train.make_maple_train_step(model.clip_model, opt,
                                           train.maple_schedule(0.01, 5, 1, warmup_epochs=0))
        bank = make_bank_inputs(cfg, names, seed=4, device=dev)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _cuda.reset_launches()
        m = step({**tb, **bank}, 0)
        counts = _cuda.launch_counts()
        after = {n: p.detach().cpu() for n, p in model.named_parameters()
                 if n.startswith(train.MAPLE_TRAINABLE_PREFIXES)}
        runs[dev] = (float(m["loss"]), float(m["acc"]), grads, after, counts)
    l_ref, a_ref, g_ref, p_ref, c_ref = runs["cpu"]
    l_gpu, a_gpu, g_gpu, p_gpu, c_gpu = runs["cuda"]
    want = maple_expected(cfg.clip, 1)
    dl = abs(l_gpu - l_ref) / abs(l_ref)
    rel = {n: float((g_gpu[n] - g).abs().max() / g.abs().max()) for n, g in g_ref.items()}
    upd = max(float((p_gpu[n] - v).abs().max()) for n, v in p_ref.items())
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    log(f"[maple_small] CLIP {cfg.clip.vision_width} wide ({cfg.clip.vision_heads} heads x 64), "
        f"{cfg.clip.vision_layers} + {cfg.clip.transformer_layers} layers, fp32 card vs fp32 CPU: "
        f"loss {l_gpu:.7f} vs {l_ref:.7f} (rel {dl:.3e}), acc {a_gpu} vs {a_ref}; {len(rel)} "
        f"prompt-learner gradients, max|d|/max|g| worst {[(n, f'{v:.3e}') for n, v in worst]} "
        f"(bound {MAPLE_SMALL_REL_BOUND}); prompts after the update max|d| {upd:.3e}; "
        f"launches {({k: v for k, v in c_gpu.items() if v})}")
    check(not any(c_ref.values()), f"[maple_small] the CPU run launched {c_ref}")
    check(c_gpu == want, f"[maple_small] launches {c_gpu} != {want}")
    check(dl < MAPLE_SMALL_REL_BOUND and a_gpu == a_ref, f"[maple_small] loss {dl}, acc")
    check(set(rel) == set(g_ref) == set(g_gpu) and max(rel.values()) < MAPLE_SMALL_REL_BOUND,
          f"[maple_small] gradients {worst}")
    check(upd < 1e-5, f"[maple_small] updated prompts differ by {upd}")


def phase_maple_slice():
    """`cli/train_maple.py` at full width (the cascade's MaPLe Alpha-CLIP
    ViT-L/14@336: n_ctx 4, prompt depth 9) in fp32 on the card, batch 8, one
    epoch of a seeded synthetic OVCamo tree with 14 train classes (24
    images: 3 steps): exact launch counts per step, only the prompt learner
    changed, finite losses, the step times, the peak memory; then one step
    cut into forward + loss, backward and SGD (CUDA events); then its
    model-best.pth.tar read by the demo session's --maple-ckpt."""
    import torch
    from camouflaged_vlm_tpu_torch import train
    from camouflaged_vlm_tpu_torch.cli import demo
    from camouflaged_vlm_tpu_torch.cli import train_maple as maple_cli
    from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo
    from camouflaged_vlm_tpu_torch.factory import build_full_cascade
    from camouflaged_vlm_tpu_torch.ops import _cuda

    work = os.path.join("build", "chip_smoke_maple")
    shutil.rmtree(work, ignore_errors=True)
    classes = tuple(f"class_{i}" for i in range(MAPLE_CLASSES))
    info = write_synthetic_ovcamo(os.path.join(work, "ovcamo_synthetic"), n_train=24,
                                  n_test=2, seed=0, train_classes=classes,
                                  test_classes=("bat", "slug"))
    save_dir = os.path.join(work, "save")
    before, _ = build_full_cascade(torch.float32, "cuda", seed=0)
    start = {k: v.clone() for k, v in before.state_dict().items()}
    del before
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    run = maple_cli.main(["--dataset-info", info, "--save-dir", save_dir, "--device", "cuda",
                          "--epochs", "1", "--batch-size", str(MAPLE_B), "--seed", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    model, steps = run["model"], run["step"]
    clip = model.cfg.clip
    check(model.cfg.clip.dtype == torch.float32 and (clip.vision_width, clip.vision_layers,
                                                     clip.n_ctx, clip.prompt_depth)
          == (1024, 24, 4, 9), f"[maple_slice] not the full-width fp32 CLIP: {clip}")
    check(steps == 3, f"[maple_slice] {steps} steps, expected 3")
    check(all(np.isfinite(e["loss"]) for e in run["epochs"]), f"[maple_slice] {run['epochs']}")
    after = model.state_dict()
    moved = [k for k, v in start.items() if not torch.equal(v, after[k])]
    pl = [k for k in start if k.startswith(train.MAPLE_TRAINABLE_PREFIXES)]
    # the trained and the seeded prompts (the timed steps below move them again)
    trained = {k: after[k].clone() for k in pl}
    seeded = {k[len("clip_model."):]: start[k] for k in pl}
    expected = maple_expected(clip, steps)
    st = run["step_seconds"]
    log(f"[maple_slice] {steps} steps at batch {MAPLE_B} (fp32), epoch {run['epochs']}; tensors "
        f"changed {len(moved)} (prompt learner {len(set(moved) & set(pl))}/{len(pl)}; others "
        f"{len(set(moved) - set(pl))}); step wall times (s) {[round(x, 4) for x in st]}; CLI wall "
        f"{wall:.1f} s; the CLI's peak device memory {peak:.2f} GiB (over the "
        f"{base / 2 ** 30:.2f} GiB allocated before it)")
    log(f"[maple_slice] kernel launches {({k: v for k, v in counts.items() if v})} expected "
        f"{({k: v for k, v in expected.items() if v})}")
    check(counts == expected, f"[maple_slice] launches {counts} != {expected}")
    check(set(moved) == set(pl), f"[maple_slice] changed {sorted(set(moved) ^ set(pl))[:5]}")
    for name in ("maple_last.pt", "maple_best.pt", "prompt_learner_best.npz",
                 "model-best.pth.tar", "log.txt"):
        check(os.path.exists(os.path.join(save_dir, name)), f"[maple_slice] no {name}")
    os.makedirs(OUT_DIR, exist_ok=True)
    shutil.copy(os.path.join(save_dir, "log.txt"), os.path.join(OUT_DIR, "maple_log.txt"))

    # one step cut into forward + loss, backward and SGD, median of 3 after a
    # warm-up, on a seeded batch of 8 (the trained model, its optimizer)
    opt, bank = run["optimizer"], run["bank"]
    rng = np.random.default_rng(5)
    C = model.cfg.clip_size
    batch = {"clip_image": torch.from_numpy(rng.standard_normal((MAPLE_B, C, C, 3))
                                            .astype(np.float32)).cuda(),
             "clip_alpha": torch.from_numpy(rng.standard_normal((MAPLE_B, C, C, 1))
                                            .astype(np.float32)).cuda(),
             "label_id": torch.from_numpy(rng.integers(0, MAPLE_CLASSES, MAPLE_B)).cuda()}
    rows = []
    for it in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        logits = model.clip_model(batch["clip_image"], batch["clip_alpha"], bank["prefix"],
                                  bank["suffix"], bank["eot_indices"], bank["bank_features"])[3]
        loss = train.maple_loss(logits, batch["label_id"])
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        opt.zero_grad(set_to_none=True)
        ev[3].record()
        torch.cuda.synchronize()
        if it:
            rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    med = np.median(np.array(rows), axis=0)
    log(f"[maple_times] batch {MAPLE_B}, {MAPLE_CLASSES} classes, fp32 (median of 3, ms): "
        f"forward + loss {med[0]:.2f}; backward {med[1]:.2f}; SGD {med[2]:.2f}; sum "
        f"{med.sum():.2f}")
    del run, model, opt, bank, after, start, logits, loss
    torch.cuda.empty_cache()

    # the trainer's file read back by the demo session (bf16, the 61 test
    # classes): its prompt learner is the trained one rounded to bf16 where
    # the session holds bf16, and the text features move with it
    image = os.path.join(work, "image.png")
    _synthetic_images(1)[0].save(image)
    args = demo.parse_args(["--image", image, "--out-dir", os.path.join(work, "demo"),
                            "--device", "cuda", "--dtype", "bfloat16", "--seed", "0",
                            "--maple-ckpt", os.path.join(save_dir, "model-best.pth.tar")])
    session = demo.DemoSession(args)
    sd = session.model.state_dict()
    bad = [k for k, v in trained.items() if not torch.equal(sd[k], v.to(sd[k].dtype))]
    tf = session.text_features
    # the seeded prompts (the fp32 draws, cast on load as the bf16 build casts them)
    missing, unexpected = session.model.clip_model.load_state_dict(seeded, strict=False)
    check(not unexpected and len(missing) + len(seeded) == len(
        session.model.clip_model.state_dict()), "[maple_slice] seeded prompts not loaded")
    b = session.bank
    with torch.no_grad():
        tf0 = session.model.encode_class_text_features(b["prefix"], b["suffix"],
                                                       b["eot_indices"], b["bank_features"])
    d = float((tf.float() - tf0.float()).abs().max())
    log(f"[maple_slice] model-best.pth.tar through the demo session's --maple-ckpt: "
        f"{len(trained) - len(bad)}/{len(trained)} prompt-learner tensors equal the trained ones "
        f"in the session's types; text features against the seeded prompts' max|d| {d:.4e}")
    check(not bad, f"[maple_slice] --maple-ckpt loaded other prompts: {bad[:5]}")
    check(d > 0, "[maple_slice] the trained prompts did not change the text features")
    del session, tf, tf0, seeded, trained
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    return counts


# The fp32 cascade on the card against the same state dict on the card host's
# CPU (the plain versions, which the CPU tests tie to the JAX package), at
# batch 1 and full depth: mean|d| / mean|ref| of the SAM embedding and of
# the mask logits. Both sides compute in fp32 with no rounding point (TF32
# off); they differ in the order of fp32 sums (the kernels' tiles, the CPU's
# BLAS), ~1e-7 relative per product, which 32 blocks, the decoder and CLIP
# grow by well under 100x; 1e-3 leaves room for that growth while a wrong
# kernel (a dropped bias, a wrong window or pad key) moves the embedding by
# 1e-2 and more.
F32_SLICE_MEAN_REL_BOUND = 1e-3


def f32_expected(expected):
    """`expected_launches` of a fp32 run: each kernel's launches on its fp32
    instance (`<name>_f32`), none on a bf16 kernel."""
    from camouflaged_vlm_tpu_torch.ops import _cuda

    out = {k.name: 0 for k in _cuda.KERNELS}
    for k, n in expected.items():
        if n:
            check(k + "_f32" in out, f"{k} has no fp32 instance")
            out[k + "_f32"] += n
    return out


def cascade_outputs(m, cfg, tf, inp, cimg, cmask):
    """`infer_cascade_with_text` with its stages' outputs kept: the SAM
    embedding (the neck's), the mask logits, the class logits and the
    predicted class."""
    import torch
    from camouflaged_vlm_tpu_torch.ops.resize import resize_bilinear

    with torch.no_grad():
        feats, _ = m.image_encoder(inp)
        ifeat, tfeat, _, _ = m.clip_model.classify(cimg, cmask, tf)
        masks, _, _ = m._decode(feats, m._sparse_embeddings(ifeat, tfeat))
        alpha = resize_bilinear(torch.sigmoid(masks.float()), cfg.clip_size, cfg.clip_size)
        _, _, pred, score = m.clip_model.classify(cimg, alpha, tf)
    return {"embedding": feats, "mask_logits": masks, "class_logits": score, "pred": pred}


def phase_f32_slice():
    """The demo CLI at --dtype float32 on the card at full width (the
    reference configuration, the rel cache, the 61 test classes): TF32 turned
    off by the CLI, [slice]'s requests with exact launch counts on the fp32
    instances and none on a bf16 kernel; then the fp32 cascade at batch 1
    against the same state dict on the CPU (SAM embedding and mask logits
    within F32_SLICE_MEAN_REL_BOUND, the same class); the bf16 cascade on
    the same weights against the fp32 one (a measurement, no gate); the
    graphed and eager calls at batch 1 and 2 with the card's busy time."""
    import torch
    from camouflaged_vlm_tpu_torch.cli import demo
    from camouflaged_vlm_tpu_torch.factory import attach_rel_cache, build_cascade
    from camouflaged_vlm_tpu_torch.graphs import GraphedCall
    from camouflaged_vlm_tpu_torch.models import CascadeConfig
    from camouflaged_vlm_tpu_torch.ops import _cuda

    demo_dir = os.path.join(OUT_DIR, "demo_f32")
    os.makedirs(demo_dir, exist_ok=True)
    images = _synthetic_images(5)
    paths = []
    for i, img in enumerate(images):
        paths.append(os.path.join(demo_dir, f"synthetic_{i}.png"))
        img.save(paths[-1])
    args = demo.parse_args(["--image", paths[0], "--out-dir", demo_dir,
                            "--device", "cuda", "--dtype", "float32", "--seed", "0"])
    torch.backends.cuda.matmul.allow_tf32 = True  # the CLI must turn both off
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    session = demo.DemoSession(args)
    torch.cuda.synchronize()
    cfg, n_classes = session.cfg, len(session.classnames)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    log(f"[f32_slice] demo session at --dtype float32: build + text encode ({n_classes} "
        f"classes) {time.perf_counter() - t0:.3f} s; TF32 (matmul, cuDNN) after it {tf32}")
    check(tf32 == (False, False), f"[f32_slice] the demo CLI left TF32 on: {tf32}")
    check(cfg.encoder.dtype == cfg.decoder.dtype == cfg.clip.dtype == torch.float32
          and cfg.encoder.attn_impl == "flash" and cfg.encoder.embed_dim == 1280,
          f"[f32_slice] not the reference configuration in fp32: {cfg.encoder}")
    for idx in SLICE_REQUESTS:
        t0 = time.perf_counter()
        probs, pred, logits = session.predict([images[i] for i in idx])
        dt = time.perf_counter() - t0
        check(probs.shape == (len(idx), cfg.inp_size, cfg.inp_size)
              and bool(np.isfinite(probs).all()) and probs.min() >= 0 and probs.max() <= 1,
              "[f32_slice] mask probabilities not finite in [0, 1]")
        check(logits.shape == (len(idx), n_classes) and bool(np.isfinite(logits).all()),
              f"[f32_slice] logits {logits.shape} or non-finite")
        for j, i in enumerate(idx):
            demo.write_outputs(paths[i], np.asarray(images[i]), probs[j],
                               session.classnames[int(pred[j])], demo_dir)
        log(f"[f32_slice] request batch {len(idx)}: {dt * 1000:.1f} ms wall; pred "
            f"{[session.classnames[int(c)] for c in pred]}; mask mean {probs.mean():.4f}")
    counts = _cuda.launch_counts()
    expected = f32_expected(expected_launches(cfg, len(SLICE_REQUESTS)))
    log(f"[f32_slice] peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"kernel launches {({k: v for k, v in counts.items() if v})} expected "
        f"{({k: v for k, v in expected.items() if v})}")
    check(counts == expected, f"[f32_slice] launches {counts} != {expected}")

    # batch 1, full depth: the card against the CPU on the same state dict
    model, tf = session.model, session.text_features
    inputs = session.preprocess(images[:1])
    gpu = cascade_outputs(model, cfg, tf, *inputs)
    t0 = time.perf_counter()
    cpu_model = build_cascade(cfg, "cpu", seed=1)
    cpu_model.load_state_dict(model.state_dict(), strict=True)
    attach_rel_cache(cpu_model)
    t_build = time.perf_counter() - t0
    b = {k: v.cpu() for k, v in session.bank.items()}
    t0 = time.perf_counter()
    with torch.no_grad():
        tf_cpu = cpu_model.encode_class_text_features(b["prefix"], b["suffix"],
                                                      b["eot_indices"], b["bank_features"])
        cpu = cascade_outputs(cpu_model, cfg, tf_cpu, *(t.cpu() for t in inputs))
    t_cpu = time.perf_counter() - t0
    del cpu_model
    e = {k: errors(gpu[k].cpu(), cpu[k]) for k in ("embedding", "mask_logits", "class_logits")}
    e["text_features"] = errors(tf.cpu(), tf_cpu)
    same = bool(torch.equal(gpu["pred"].cpu(), cpu["pred"]))
    log(f"[f32_slice] fp32 cascade at batch 1, full depth (32 blocks), card vs the card host's "
        f"CPU ({torch.get_num_threads()} threads; plain versions) on the same state dict: "
        + "; ".join(f"{k} mean_rel {v['mean_rel']:.3e} max_rel {v['max_rel']:.3e} max_abs "
                    f"{v['max_abs_err']:.3e}" for k, v in e.items())
        + f" (bound mean_rel {F32_SLICE_MEAN_REL_BOUND} on the embedding and the mask logits); "
        f"class {session.classnames[int(gpu['pred'][0])]} vs "
        f"{session.classnames[int(cpu['pred'][0])]}; the CPU's seconds: build {t_build:.1f}, "
        f"text encode + cascade call {t_cpu:.1f}")
    check(e["embedding"]["mean_rel"] < F32_SLICE_MEAN_REL_BOUND
          and e["mask_logits"]["mean_rel"] < F32_SLICE_MEAN_REL_BOUND,
          f"[f32_slice] the fp32 cascade on the card disagrees with the CPU: {e}")
    check(same, "[f32_slice] the card and the CPU predict different classes")
    del cpu, tf_cpu

    # the bf16 cascade on the same weights against the fp32 one: how far the
    # bf16 roundings carry through 32 blocks (a measurement, no gate)
    bcfg = CascadeConfig.full(dtype=torch.bfloat16)
    bmodel = build_cascade(bcfg, "cuda", seed=1)
    bmodel.load_state_dict(model.state_dict(), strict=True)
    attach_rel_cache(bmodel)
    with torch.no_grad():
        btf = bmodel.encode_class_text_features(session.bank["prefix"], session.bank["suffix"],
                                                session.bank["eot_indices"],
                                                session.bank["bank_features"])
    bf = cascade_outputs(bmodel, bcfg, btf, *inputs)
    del bmodel
    gap = {k: errors(bf[k], gpu[k]) for k in ("embedding", "mask_logits", "class_logits")}
    pm = [(torch.sigmoid(o["mask_logits"].float()) > 0.5) for o in (bf, gpu)]
    agree = float((pm[0] == pm[1]).float().mean())
    log("[f32_slice] bf16 cascade against the fp32 one on the card, same weights, batch 1: "
        + "; ".join(f"{k} mean_rel {v['mean_rel']:.3e} max_rel {v['max_rel']:.3e}"
                    for k, v in gap.items())
        + f"; mask pixels (p > 0.5) that agree {agree:.4f}; class "
        f"{session.classnames[int(bf['pred'][0])]} vs {session.classnames[int(gpu['pred'][0])]}")
    del bf, btf, gpu
    torch.cuda.empty_cache()

    # graphed and eager calls at batch 1 and 2, and the card's busy time
    pool = torch.cuda.graph_pool_handle()
    want = f32_expected(expected_launches(cfg, 1, text=False))

    def fn(inp, cimg, cmask):
        return model.infer_cascade_with_text(inp, cimg, cmask, tf)

    graphs = []  # alive until the end: a pool whose graphs are freed takes no capture
    for bs in (1, 2):
        inputs = session.preprocess(images[:bs])
        eager = [t.clone() for t in fn(*inputs)]
        g = GraphedCall(fn, *inputs, pool=pool)
        graphs.append(g)
        check(g.launches == want, f"[f32_slice] graph b{bs}: launches {g.launches} != {want}")
        out = g(*inputs)
        torch.cuda.synchronize()
        d = max(errors(out[i], eager[i])["max_rel"] for i in (0, 2))  # probs, class logits
        eager_ms = _walls_ms(lambda: fn(*inputs))
        graph_ms = _walls_ms(lambda: g(*inputs))
        log(f"[f32_slice] batch {bs}, fp32: wall (median of 7, ms) eager {eager_ms:.2f}, graph "
            f"{graph_ms:.2f} ({1e3 * bs / graph_ms:.3f} images/s graphed); replay against eager "
            f"max_rel {d:.3e} (probabilities and class logits)")
        with torch.no_grad():
            trace_call(lambda: fn(*inputs), f"_f32 eager batch {bs}", eager_ms, OUT_DIR, log,
                       kernels=True)
            trace_call(lambda: g(*g.static_inputs), f"_f32 graph batch {bs}", graph_ms, OUT_DIR,
                       log)
        del g, eager, out
    del graphs, session, model, tf
    torch.cuda.empty_cache()
    return counts


# the mask-probability MAE that scripts/ab_trained_numeric.py allows a bf16
# cascade against fp32 (printed beside bf16's gap to the JAX golden, no gate)
GOLDEN_BF16_PROB_MAE = 0.02


def phase_jax_golden():
    """The card against the JAX package itself, in one hop: the reference
    configuration's fp32 cascade at batch 1 from `ab_fullsize_torch`'s
    numpy weight draw (its weights, image and bank seeds, checked against
    the golden's fingerprint of them) against the JAX package's outputs on
    the same ones, `tests/data/jax_fullsize_golden.npz`
    (its A/B's inference bounds: the low-resolution mask logits, 8 channels
    of the SAM embedding, the embedding's mean and L2 norm within 1e-4
    relative, the class logits within 1e-3 of their range, the same class;
    exact launches of the fp32 instances). Then bf16 on the same weights: the
    same class, unless the golden's top-2 margin is under bf16's largest
    logit gap; its gaps and the mask-probability MAE (sigmoid of the
    low-resolution logits) printed beside GOLDEN_BF16_PROB_MAE."""
    import torch

    import ab_fullsize_torch as ab
    from camouflaged_vlm_tpu_torch.cli.common import exact_fp32_on_card
    from camouflaged_vlm_tpu_torch.config import with_dtype
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.factory import make_bank_inputs
    from camouflaged_vlm_tpu_torch.ops import _cuda

    golden, meta = ab.read_golden()
    work = os.path.join("build", "chip_smoke_golden")
    cfg = ab.port_config(meta["route"], False, work)
    exact_fp32_on_card("cuda", cfg)
    t0 = time.perf_counter()
    weights = ab.draw_weights(ab.port_shapes(cfg))
    t_draw = time.perf_counter() - t0
    # a golden drawn from other weights, inputs or bank is stale, not a departure
    ab.check_golden_digest(meta, ab.draw_digest(meta["route"], weights, work))
    inputs = [torch.from_numpy(a).cuda()
              for a in ab.make_inputs(cfg.inp_size, cfg.clip_size, meta["batch"])]

    def run(c):
        model = ab.load_port_cascade(c, weights, "cuda")
        bank = make_bank_inputs(c, TEST_CLASS_NAMES, seed=ab.BANK_SEED, device="cuda")
        tf = model.encode_class_text_features(bank["prefix"], bank["suffix"],
                                              bank["eot_indices"], bank["bank_features"])
        _cuda.reset_launches()
        t1 = time.perf_counter()
        taps = ab.port_taps(model, c, *inputs, tf)
        torch.cuda.synchronize()
        return ab.golden_gaps(ab.golden_entries(taps), golden), taps, time.perf_counter() - t1

    gaps, taps, t_call = run(cfg)
    counts = _cuda.launch_counts()
    expected = f32_expected(expected_launches(cfg, 1, text=False))
    desc = "; ".join(f"{k} mean_rel {gaps[k]['mean_rel']:.3e} max_abs {gaps[k]['max_abs']:.3e}"
                     for k in ("mask_lowres", "embedding_slice", "class_logits"))
    log(f"[jax_golden] fp32 cascade on the card (batch 1, full depth, {len(TEST_CLASS_NAMES)} "
        f"classes) against the JAX package's golden ({os.path.relpath(ab.GOLDEN, ab.REPO)}, "
        f"written on the CPU by ab_fullsize_torch.py --write-golden): {desc}; embedding mean rel {gaps['embedding_mean']['rel']:.3e}, "
        f"L2 norm rel {gaps['embedding_norm']['rel']:.3e} (bound {ab.TAP_MEAN_REL}); class logits "
        f"max_abs bound {gaps['logit_bound']:.3e} (1e-3 of their range); class {gaps['pred'][0]} vs "
        f"the golden's {gaps['pred'][1]} (top-2 margin {gaps['top2_margin']:.4f}); weight draw "
        f"{t_draw:.1f} s (numpy, this host), the call {t_call * 1e3:.1f} ms with taps; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    check(counts == expected, f"[jax_golden] launches {counts} != {expected}")
    check(all(gaps[k]["mean_rel"] <= ab.TAP_MEAN_REL
              for k in ("mask_lowres", "embedding_slice"))
          and gaps["embedding_mean"]["rel"] <= ab.TAP_MEAN_REL
          and gaps["embedding_norm"]["rel"] <= ab.TAP_MEAN_REL
          and gaps["class_logits"]["max_abs"] <= gaps["logit_bound"]
          and gaps["pred"][0] == gaps["pred"][1],
          f"[jax_golden] the fp32 card departs from the JAX golden: {gaps}")

    bgaps, btaps, _ = run(with_dtype(cfg, torch.bfloat16))
    mae = float(np.abs(1.0 / (1.0 + np.exp(-btaps["mask_lowres"][0, 0].astype(np.float64)))
                       - 1.0 / (1.0 + np.exp(-golden["mask_lowres"].astype(np.float64)))).mean())
    log(f"[jax_golden] bf16 cascade on the card, same weights, against the golden: "
        + "; ".join(f"{k} mean_rel {bgaps[k]['mean_rel']:.3e} max_abs {bgaps[k]['max_abs']:.3e}"
                    for k in ("mask_lowres", "embedding_slice", "class_logits"))
        + f"; mask-probability MAE (low resolution) {mae:.4e} beside {GOLDEN_BF16_PROB_MAE} "
        f"(scripts/ab_trained_numeric.py, no gate); class {bgaps['pred'][0]} vs the golden's "
        f"{bgaps['pred'][1]}, the golden's top-2 margin {bgaps['top2_margin']:.4f} against bf16's "
        f"largest logit gap {bgaps['class_logits']['max_abs']:.4f}")
    check(bgaps["pred"][0] == bgaps["pred"][1]
          or bgaps["top2_margin"] < bgaps["class_logits"]["max_abs"],
          f"[jax_golden] bf16 predicts class {bgaps['pred'][0]}, the golden "
          f"{bgaps['pred'][1]}, with a margin over bf16's logit gap")
    del weights, taps, btaps
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)


# fp32 train steps, card against CPU on the same weights and batch: both
# fp32 with TF32 off, apart only in the order of fp32 sums (~1e-7 relative a
# product). The small cascade: the loss within 1e-5 and each trainable leaf's
# gradient within 1e-4 (grad_gaps' floor rule), as the MaPLe step's; the
# full-width one at depth 8 (8 blocks of 1280, the decoder, CLIP's 24 layers
# in the forward), where the sums grow longer: gradients within 1e-3. A
# wrong backward (a dropped bias or drel lane, a wrong statistic) moves a
# gradient by 1e-2 and more.
F32_TRAIN_LOSS_REL_BOUND = 1e-5
F32_TRAIN_SMALL_GRAD_REL_BOUND = 1e-4
F32_TRAIN_FULL_GRAD_REL_BOUND = 1e-3
# the train CLI's device peak at --dtype float32, full width, batch 2 (GiB):
# 14.03 measured before the fp32 attention backward took its dS^T scratch
# (512 MiB, `flash_attention.F32_BWD_SCRATCH_BYTES`), plus 1 GiB
F32_TRAIN_PEAK_GIB = 15.03


def _small_f32_config():
    """A small fused cascade whose every kernel has an fp32 instance
    (`_small_config`'s SAM, 8 heads x 16 on a grid of 10, runs its global
    blocks on #12 and heads of 16: no fp32 route on the card): SAM 'flash'
    512 wide (8 heads x 64) at 384 px, grid 24 with window 5: interior and
    edge windows on the compact carry (#13, #15; backward #14), global
    blocks of 576 tokens (#17; backward #18, H + W = 48); CLIP 128 wide (2
    heads x 64), fp32 throughout."""
    import dataclasses

    import torch
    from camouflaged_vlm_tpu_torch.models import CascadeConfig, SamEncoderConfig
    from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig

    f32 = torch.float32
    clip = AlphaClipConfig.tiny(dtype=f32, vision_width=128, vision_heads=2,
                                transformer_width=128)
    enc = SamEncoderConfig.tiny(dtype=f32, attn_impl="flash", img_size=384, embed_dim=512,
                                num_heads=8, window_size=5, prompt_scale_factor=32)
    return dataclasses.replace(CascadeConfig.tiny(dtype=f32), inp_size=enc.img_size,
                               encoder=enc, clip=clip)


def _small_f32_route_configs():
    """Small fp32 cascades on each route off the compact carry, `_small_f32_config`'s
    CLIP and widths the fp32 instances take (heads of 64), tiny depth 4
    (global blocks 1 and 3):
      vit_b_flash       unfused 'flash' (4 heads: #10), 256 wide at 256 px,
                        grid 16, window 5 (padded to 20: windows of 25)
                        and global blocks of 256 tokens;
      vit_h_aug_flash   'aug_flash', 256 wide at 512 px, grid 32, window 8:
                        global blocks of 1024 tokens on #20 (d_qk 64 + 32 +
                        32 = 128, dv 64), the windows plain;
      vit_h_flash_win16 fused 'flash' (8 heads), 512 wide at 320 px, grid 20,
                        window 16 (padded carry: 4 windows of 256 on #12)
                        and global blocks of 400 tokens (H + W 40: #11 + #8);
      vit_h_flash_win17 the same at window 17 (4 windows of 289: #11 + #8)."""
    import dataclasses

    from camouflaged_vlm_tpu_torch.models import SamEncoderConfig

    base = _small_f32_config()

    def cfg(**enc):
        e = SamEncoderConfig.tiny(dtype=base.encoder.dtype, **enc)
        return dataclasses.replace(base, inp_size=e.img_size, encoder=e)

    return {
        "vit_b_flash": cfg(attn_impl="flash", img_size=256, embed_dim=256, num_heads=4,
                           window_size=5, prompt_scale_factor=16),
        "vit_h_aug_flash": cfg(attn_impl="aug_flash", img_size=512, embed_dim=256, num_heads=4,
                               window_size=8, prompt_scale_factor=16),
        "vit_h_flash_win16": cfg(attn_impl="flash", img_size=320, embed_dim=512, num_heads=8,
                                 window_size=16, prompt_scale_factor=32),
        "vit_h_flash_win17": cfg(attn_impl="flash", img_size=320, embed_dim=512, num_heads=8,
                                 window_size=17, prompt_scale_factor=32),
    }


def check_no_bf16_kernel(counts, label):
    bf16 = {k: n for k, n in counts.items() if n and not k.endswith("_f32")}
    check(not bf16, f"{label}: bf16 kernels launched in an fp32 run: {bf16}")


def phase_f32_train_small():
    """One fp32 train step of a small cascade on the card against the same
    step on the CPU (same weights, bank and batch), on each route: the
    compact carry (`_small_f32_config`: the SAM attention and its backward
    on their fp32 instances #13, #15, #17; #14, #18) and the four routes of
    `_small_f32_route_configs` (#10; #20; #12, #11 + #8; #11 + #8, whose
    gradients are their plain versions' VJPs): the loss and every
    trainable gradient, exact launches, no bf16 kernel."""
    import torch
    from camouflaged_vlm_tpu_torch.factory import build_cascade
    from camouflaged_vlm_tpu_torch.ops import _cuda

    names = ["cat", "owl", "bat", "moth", "slug"]
    configs = {"compact": _small_f32_config(), **_small_f32_route_configs()}
    for route, cfg in configs.items():
        label = f"f32_train_small {route}"
        ref = build_cascade(cfg, "cpu", seed=5)
        model = build_cascade(cfg, "cuda", seed=5)
        model.load_state_dict(ref.state_dict(), strict=True)
        batch = _small_batch(cfg)
        _cuda.reset_launches()  # the CPU step launches nothing
        l_ref, g_ref, _, _, _ = step_grads(ref, cfg, batch, names, "cpu")
        l_gpu, g_gpu, _, _, _ = step_grads(model, cfg, batch, names, "cuda")
        counts = _cuda.launch_counts()
        check_sam_attention(counts, cfg.encoder, label, backward=True, suffix="_f32")
        expected = f32_expected(expected_launches(cfg, 1, clip_passes=1, backward=True))
        check(counts == expected, f"{label}: launches {counts} != {expected}")
        check_no_bf16_kernel(counts, label)
        dl = abs(l_gpu - l_ref) / abs(l_ref)
        rels, floor = grad_gaps(label, g_ref, g_gpu)
        enc = cfg.encoder
        log(f"[f32_train_small] {route}: SAM {enc.attn_impl!r} {enc.embed_dim} wide, "
            f"{enc.num_heads} heads x {enc.embed_dim // enc.num_heads}, grid {enc.grid}, window "
            f"{enc.window_size}; fp32 card vs fp32 CPU: loss {l_gpu:.8f} vs {l_ref:.8f} (rel "
            f"{dl:.3e}, bound {F32_TRAIN_LOSS_REL_BOUND}); {describe_gaps(rels, floor)} (bound "
            f"{F32_TRAIN_SMALL_GRAD_REL_BOUND}); launches "
            f"{({k: v for k, v in counts.items() if v})}")
        check(dl < F32_TRAIN_LOSS_REL_BOUND, f"{label}: loss differs by {dl}")
        check(max(rels.values()) < F32_TRAIN_SMALL_GRAD_REL_BOUND, f"{label}: gradients {rels}")
        del ref, model
        torch.cuda.empty_cache()


def phase_f32_train_slice():
    """The train CLI at --dtype float32 --device cuda at full width (the
    reference configuration): one epoch of 6 synthetic images at batch 2 (3
    steps) with --epoch-val 1, so that validation runs at fp32 too; exact
    launches of the fp32 instances and none of a bf16 kernel, TF32 off after
    the CLI, frozen weights unchanged and trainable ones moved, step walls,
    the step cut by `train_times`, peak memory. Then one fp32 step of a
    full-width model at depth 8 (global block 7) on the card against the
    same step on the CPU, and the full-depth step in bf16 against fp32 on
    the card (a measurement, no gate). Returns the CLI run's launch counts."""
    import dataclasses

    import torch
    from camouflaged_vlm_tpu_torch.cli import train as train_cli
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo
    from camouflaged_vlm_tpu_torch.factory import build_cascade, build_full_cascade
    from camouflaged_vlm_tpu_torch.models import CascadeConfig
    from camouflaged_vlm_tpu_torch.ops import _cuda
    from camouflaged_vlm_tpu_torch.train.optim import is_trainable

    work = os.path.join("build", "chip_smoke_train_f32")
    shutil.rmtree(work, ignore_errors=True)
    # train classes that are not test classes, so that validation reads only
    # the test split's images
    info = write_synthetic_ovcamo(os.path.join(work, "ovcamo_synthetic"), n_train=6,
                                  n_test=2, seed=0, train_classes=("owl", "frog", "gecko"),
                                  test_classes=tuple(TEST_CLASS_NAMES))
    save_dir = os.path.join(work, "save")
    before, _ = build_full_cascade(torch.float32, "cuda", seed=0)
    start = {k: v.cpu() for k, v in before.state_dict().items()}  # off the card's peak
    del before
    torch.backends.cuda.matmul.allow_tf32 = True  # the CLI must turn both off
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        run = train_cli.main(["--dataset-info", info, "--save-dir", save_dir, "--device",
                              "cuda", "--dtype", "float32", "--epochs", "1", "--batch-size", "2",
                              "--epoch-val", "1", "--seed", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        counts = _cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(tf32 == (False, False), f"f32_train_slice: the train CLI left TF32 on: {tf32}")
        check(peak <= F32_TRAIN_PEAK_GIB,
              f"f32_train_slice: peak {peak:.2f} GiB above {F32_TRAIN_PEAK_GIB} GiB")
        model, steps, vals = run["model"], run["step"], run["validations"]
        cfg = model.cfg
        check(cfg.encoder.dtype == cfg.decoder.dtype == cfg.clip.dtype == torch.float32
              and cfg.encoder.embed_dim == 1280 and cfg.encoder.depth == 32,
              f"f32_train_slice: not the reference configuration in fp32: {cfg.encoder}")
        check(steps == 3, f"f32_train_slice: {steps} steps, expected 3")
        metrics = run["epochs"][0]
        check(all(np.isfinite(v) for v in metrics.values()), f"f32_train_slice: loss {metrics}")
        check([v["epoch"] for v in vals] == [1] and vals[0]["images"] == 2
              and all(np.isfinite(v) for v in vals[0].values()),
              f"f32_train_slice: validations {vals}")
        check(os.path.exists(os.path.join(save_dir, "ckpt_best.pt")),
              "f32_train_slice: no ckpt_best.pt")
        os.makedirs(OUT_DIR, exist_ok=True)
        shutil.copy(os.path.join(save_dir, "log.txt"), os.path.join(OUT_DIR, "train_f32_log.txt"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    after = model.state_dict()
    frozen_moved = [k for k, v in start.items() if not is_trainable(k)
                    and not torch.equal(v, after[k].cpu())]
    trainable_keys = [k for k in start if is_trainable(k)]
    moved = [k for k in trainable_keys if not torch.equal(start[k], after[k].cpu())]
    del start, after
    log(f"[f32_train_slice] train CLI --dtype float32 --device cuda: {steps} steps at batch 2, "
        f"losses {metrics}; [val epoch 1] mae {vals[0]['mae']}; TF32 (matmul, cuDNN) after it "
        f"{tf32}; trainable tensors moved {len(moved)}/{len(trainable_keys)}; frozen tensors "
        f"changed {len(frozen_moved)}")
    check(not frozen_moved, f"f32_train_slice: frozen weights changed: {frozen_moved[:5]}")
    check(len(moved) >= 0.9 * len(trainable_keys), "f32_train_slice: trainable weights did not move")
    # 3 steps (the text tower once, one CLIP pass, SAM's backward), then
    # evaluate(): the text tower again and the graph's warm-up and captured
    # calls at batch 1
    expected = expected_launches(cfg, steps, clip_passes=1, backward=True)
    for k, n in expected_launches(cfg, eval_calls()).items():
        expected[k] += n
    expected = f32_expected(expected)
    log(f"[f32_train_slice] kernel launches {({k: v for k, v in counts.items() if v})} expected "
        f"{({k: v for k, v in expected.items() if v})}")
    check(counts == expected, f"f32_train_slice: launches {counts} != {expected}")
    check_no_bf16_kernel(counts, "f32_train_slice")
    st = run["step_seconds"]
    log(f"[f32_train_slice] step wall times (s) {[round(x, 4) for x in st]}; median after the "
        f"first {np.median(st[1:]) * 1000:.1f} ms; CLI wall {wall:.1f} s (the build, the text "
        f"tower, 3 steps, 2 checkpoints, validation); peak device memory {peak:.2f} GiB "
        "(torch.cuda.max_memory_allocated)")
    train_times(run, label="f32_train_times")
    run["optimizer"].zero_grad(set_to_none=True)
    del run
    torch.cuda.empty_cache()

    # depth 8 (the 7 windowed blocks and global block 7: #14 and #18 both on
    # the path), full width, batch 1: the card against the card host's CPU
    cfg8 = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, depth=8,
                                                                global_attn_indexes=(7,)))
    batch = _small_batch(cfg8, B=1)
    cpu8 = build_cascade(cfg8, "cpu", seed=3)
    gpu8 = build_cascade(cfg8, "cuda", seed=3)
    gpu8.load_state_dict(cpu8.state_dict(), strict=True)
    _cuda.reset_launches()
    l_gpu, g_gpu, _, _, _ = step_grads(gpu8, cfg8, batch, TEST_CLASS_NAMES, "cuda")
    torch.cuda.synchronize()
    counts8 = _cuda.launch_counts()
    t0 = time.perf_counter()
    l_cpu, g_cpu, _, _, _ = step_grads(cpu8, cfg8, batch, TEST_CLASS_NAMES, "cpu")
    t_cpu = time.perf_counter() - t0
    del cpu8, gpu8
    want8 = f32_expected(expected_launches(cfg8, 1, clip_passes=1, backward=True))
    check(counts8 == want8, f"f32_train_slice depth 8: launches {counts8} != {want8}")
    dl = abs(l_gpu - l_cpu) / abs(l_cpu)
    rels, floor = grad_gaps("f32_train_slice depth 8", g_cpu, g_gpu)
    log(f"[f32_train_slice] one fp32 step at full width, depth 8 (global block 7), batch 1, card "
        f"vs the card host's CPU ({torch.get_num_threads()} threads; plain versions) on the same "
        f"weights: loss {l_gpu:.8f} vs {l_cpu:.8f} (rel {dl:.3e}, bound "
        f"{F32_TRAIN_LOSS_REL_BOUND}); {describe_gaps(rels, floor)} (bound "
        f"{F32_TRAIN_FULL_GRAD_REL_BOUND}); the CPU's step {t_cpu:.1f} s")
    check(dl < F32_TRAIN_LOSS_REL_BOUND, f"f32_train_slice depth 8: loss differs by {dl}")
    check(max(rels.values()) < F32_TRAIN_FULL_GRAD_REL_BOUND,
          f"f32_train_slice depth 8: gradients {rels}")
    del g_gpu, g_cpu
    torch.cuda.empty_cache()

    # full depth, batch 1: the bf16 step against the fp32 one on the card,
    # the same weights (how far bf16's roundings carry into the gradients)
    batch = _small_batch(cfg, B=1)
    model32 = build_cascade(cfg, "cuda", seed=4)
    l32, g32, _, _, _ = step_grads(model32, cfg, batch, TEST_CLASS_NAMES, "cuda")
    bcfg = CascadeConfig.full(dtype=torch.bfloat16)
    model16 = build_cascade(bcfg, "cuda", seed=4)
    model16.load_state_dict(model32.state_dict(), strict=True)
    del model32
    l16, g16, _, _, _ = step_grads(model16, bcfg, batch, TEST_CLASS_NAMES, "cuda")
    del model16
    check(np.isfinite(l16) and all(bool(torch.isfinite(g).all()) for g in g16.values()),
          "f32_train_slice: the bf16 step is not finite")
    rels, floor = grad_gaps("f32_train_slice bf16 vs fp32", g32, g16)
    log(f"[f32_train_slice] one step at full width and depth, batch 1, bf16 against fp32 on the "
        f"card, the same weights (no gate): loss {l16:.6f} vs {l32:.6f} (rel "
        f"{abs(l16 - l32) / abs(l32):.3e}); {describe_gaps(rels, floor)}")
    del g32, g16
    torch.cuda.empty_cache()
    return counts


# timed steps of [f32_train_remat] after its warm-up step (the median kept)
REMAT_STEPS = 3


def phase_f32_train_remat():
    """fp32 train steps (forward, loss, backward; the text features encoded
    before them, a warm-up step first, the median of REMAT_STEPS) of the reference
    configuration at full width and depth, batch 2, without and with remat
    (`encoder.remat`, what the train CLI's --remat sets), each from the
    same seeded weights and batch: the loss within 1e-5 and every trainable
    gradient within 1e-4 of the step without remat (bit-equality expected:
    the recompute runs the same deterministic kernels on the same inputs;
    the largest difference logged), remat's peak device memory below the
    step's without, the steps' walls, exact launches (remat: every SAM
    block's forward kernels twice)."""
    import dataclasses

    import torch
    from camouflaged_vlm_tpu_torch import train
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.factory import (attach_rel_cache, build_cascade,
                                                   make_bank_inputs)
    from camouflaged_vlm_tpu_torch.models import CascadeConfig
    from camouflaged_vlm_tpu_torch.ops import _cuda

    base = CascadeConfig.full(dtype=torch.float32)
    batch = {k: torch.from_numpy(v).cuda() for k, v in _small_batch(base, B=2).items()}
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, encoder=dataclasses.replace(base.encoder, remat=remat))
        model = build_cascade(cfg, "cuda", seed=6)
        attach_rel_cache(model)
        params = train.trainable_parameters(model)
        bank = make_bank_inputs(cfg, TEST_CLASS_NAMES, seed=5, device="cuda")
        with torch.no_grad():
            tf = model.encode_class_text_features(bank["prefix"], bank["suffix"],
                                                  bank["eot_indices"], bank["bank_features"])

        def step():
            for p in params:
                p.grad = None
            masks, edges = model.forward_with_text(batch["inp"], batch["clip_image"],
                                                   batch["clip_mask"], tf)
            loss, _ = train.segmentation_loss(masks, edges, batch["gt"])
            loss.backward()
            return loss.detach()

        step()  # the warm-up step; its memory stays cached for the timed ones
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _cuda.reset_launches()
        walls = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            loss = float(step())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        counts = _cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        grads = {n: p.grad.float().cpu() if p.grad is not None else torch.zeros(p.shape)
                 for n, p in model.named_parameters() if p.requires_grad}
        want = f32_expected(expected_launches(cfg, REMAT_STEPS, clip_passes=1, backward=True,
                                              text=False, remat=remat))
        check(counts == want, f"f32_train_remat remat={remat}: launches {counts} != {want}")
        check_no_bf16_kernel(counts, f"f32_train_remat remat={remat}")
        runs[remat] = dict(loss=loss, grads=grads, wall=wall, peak=peak / 2 ** 30,
                           above=(peak - held) / 2 ** 30, counts=counts)
        del model, params, tf, step
        torch.cuda.empty_cache()
    a, b = runs[False], runs[True]
    dl = abs(b["loss"] - a["loss"]) / abs(a["loss"])
    rels, floor = grad_gaps("f32_train_remat", a["grads"], b["grads"])
    diff = max(float((b["grads"][k] - g).abs().max()) for k, g in a["grads"].items())
    same = sum(torch.equal(b["grads"][k], g) for k, g in a["grads"].items())
    twice = {k: (a["counts"][k], b["counts"][k]) for k in a["counts"]
             if b["counts"][k] != a["counts"][k]}
    log(f"[f32_train_remat] fp32 steps (forward, loss, backward) at full width and depth, "
        f"batch 2, median of {REMAT_STEPS} after a warm-up step: without remat {a['wall'] * 1e3:.1f} ms, peak "
        f"{a['peak']:.3f} GiB ({a['above']:.3f} above the weights and state held before it); "
        f"with remat {b['wall'] * 1e3:.1f} ms, peak {b['peak']:.3f} GiB ({b['above']:.3f} "
        f"above); loss {a['loss']:.8f} vs {b['loss']:.8f} (rel {dl:.3e}, bound "
        f"{F32_TRAIN_LOSS_REL_BOUND}); {same}/{len(a['grads'])} trainable gradients bit-equal, "
        f"largest |d| {diff:.3e}; {describe_gaps(rels, floor)} (bound "
        f"{F32_TRAIN_SMALL_GRAD_REL_BOUND}); launches that remat adds (without, with): {twice}")
    check(dl < F32_TRAIN_LOSS_REL_BOUND, f"f32_train_remat: loss differs by {dl}")
    check(max(rels.values()) < F32_TRAIN_SMALL_GRAD_REL_BOUND, f"f32_train_remat: {rels}")
    check(b["peak"] < a["peak"], f"f32_train_remat: remat's peak {b['peak']} >= {a['peak']}")


# the configurations of [f32_routes]: those of [eval_slice] off the
# reference one, whose routes launch the fp32 #10, #20, #12 and #11 + #8
F32_ROUTES = ("vit_b_flash", "vit_h_aug_flash", "vit_h_flash_win16", "vit_h_flash_win17")


def _route_config(label, work):
    """The fp32 configuration and yaml of an [eval_slice] label: the ViT-H
    yaml at another window, or `eval_throughput.config_args`' yaml."""
    import torch
    from camouflaged_vlm_tpu_torch.cli.eval_throughput import config_args
    from camouflaged_vlm_tpu_torch.config import cascade_config_from_yaml, with_dtype

    if label.startswith("vit_h_flash_win"):
        path = window_yaml(int(label[-2:]), work)
    else:
        path = config_args(label, work)[1]
    return with_dtype(cascade_config_from_yaml(path)[0], torch.float32), path


def _route_inputs(cfg, images):
    """The cascade's inputs for `images` on the card, as the CLIs build them."""
    import torch
    from camouflaged_vlm_tpu_torch.data.transforms import (
        clip_image_transform, clip_ones_alpha, sam_image_transform,
    )

    return tuple(torch.from_numpy(np.stack(a)).cuda() for a in (
        [sam_image_transform(im, cfg.inp_size) for im in images],
        [clip_image_transform(im, cfg.clip_size) for im in images],
        [clip_ones_alpha(cfg.clip_size) for _ in images]))


def _route_vs_cpu(cfg, label, image):
    """The fp32 cascade at batch 1 on the card against the same state dict
    on the host's CPU (plain versions): ViT-H at depth 8 with global block 7
    kept, ViT-B at full depth; the SAM embedding and the mask logits within
    F32_SLICE_MEAN_REL_BOUND, the same class."""
    import dataclasses

    import torch
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.factory import attach_rel_cache, build_cascade, make_bank_inputs

    enc = cfg.encoder
    if enc.embed_dim == 1280:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(enc, depth=8,
                                                                   global_attn_indexes=(7,)))
    outs, secs = {}, {}
    inputs = _route_inputs(cfg, [image])
    gpu = attach_rel_cache(build_cascade(cfg, "cuda", seed=2))
    state = {k: v.cpu() for k, v in gpu.state_dict().items()}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        if dev == "cuda":
            m = gpu
        else:
            m = build_cascade(cfg, "cpu", seed=3)
            m.load_state_dict(state, strict=True)
            attach_rel_cache(m)
        bank = make_bank_inputs(cfg, TEST_CLASS_NAMES, seed=0, device=dev)
        with torch.no_grad():
            tf = m.encode_class_text_features(bank["prefix"], bank["suffix"], bank["eot_indices"],
                                              bank["bank_features"])
        outs[dev] = {k: v.cpu() for k, v in
                     cascade_outputs(m, cfg, tf, *(t.to(dev) for t in inputs)).items()}
        secs[dev] = time.perf_counter() - t0
        del m, tf
    del gpu, state
    torch.cuda.empty_cache()
    e = {k: errors(outs["cuda"][k], outs["cpu"][k])
         for k in ("embedding", "mask_logits", "class_logits")}
    same = bool(torch.equal(outs["cuda"]["pred"], outs["cpu"]["pred"]))
    log(f"[f32_routes] {label}: fp32 cascade at batch 1, depth {cfg.encoder.depth} (global "
        f"blocks {cfg.encoder.global_attn_indexes}), card vs the card host's CPU "
        f"({torch.get_num_threads()} threads; plain versions) on the same state dict: "
        + "; ".join(f"{k} mean_rel {v['mean_rel']:.3e} max_rel {v['max_rel']:.3e} max_abs "
                    f"{v['max_abs_err']:.3e}" for k, v in e.items())
        + f" (bound mean_rel {F32_SLICE_MEAN_REL_BOUND} on the embedding and the mask logits); "
        f"class {TEST_CLASS_NAMES[int(outs['cuda']['pred'][0])]} vs "
        f"{TEST_CLASS_NAMES[int(outs['cpu']['pred'][0])]}; seconds (build, text encode, call): "
        f"card {secs['cuda']:.1f}, CPU {secs['cpu']:.1f}")
    check(e["embedding"]["mean_rel"] < F32_SLICE_MEAN_REL_BOUND
          and e["mask_logits"]["mean_rel"] < F32_SLICE_MEAN_REL_BOUND,
          f"[f32_routes] {label}: the fp32 cascade on the card disagrees with the CPU: {e}")
    check(same, f"[f32_routes] {label}: the card and the CPU predict different classes")


def _route_walls(cfg, label, images, gap=False):
    """The configuration's fp32 cascade call at full width and depth (seeded
    weights, the rel cache, the 61 classes' text features): its wall at
    batch 1 and 2 (`_walls_ms`, median of 5); with `gap`, the bf16 cascade
    on the same weights against it at batch 1 (a measurement, no gate): how
    far bf16's roundings carry through the configuration's blocks."""
    import torch
    from camouflaged_vlm_tpu_torch.config import with_dtype
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.factory import attach_rel_cache, build_cascade, make_bank_inputs

    def text(m, c):
        bank = make_bank_inputs(c, TEST_CLASS_NAMES, seed=0, device="cuda")
        with torch.no_grad():
            return m.encode_class_text_features(bank["prefix"], bank["suffix"],
                                                bank["eot_indices"], bank["bank_features"])

    m32 = attach_rel_cache(build_cascade(cfg, "cuda", seed=4))
    tf = text(m32, cfg)
    walls = {}
    with torch.no_grad():
        for bs in (1, 2):
            inputs = _route_inputs(cfg, images[:bs])
            walls[bs] = _walls_ms(lambda: m32.infer_cascade_with_text(*inputs, tf), iters=5)
    log(f"[f32_routes] {label}: fp32 cascade call at full width and depth, wall (median of 5, "
        f"ms) batch 1 {walls[1]:.2f}, batch 2 {walls[2]:.2f} "
        f"({2e3 / walls[2]:.3f} images/s)")
    if gap:
        inputs = _route_inputs(cfg, images[:1])
        o32 = cascade_outputs(m32, cfg, tf, *inputs)
        c16 = with_dtype(cfg, torch.bfloat16)
        m16 = build_cascade(c16, "cuda", seed=4)
        m16.load_state_dict(m32.state_dict(), strict=True)
        del m32, tf
        attach_rel_cache(m16)
        o16 = cascade_outputs(m16, c16, text(m16, c16), *inputs)
        del m16
        g = {k: errors(o16[k], o32[k]) for k in ("embedding", "mask_logits", "class_logits")}
        pm = [(torch.sigmoid(o["mask_logits"].float()) > 0.5) for o in (o16, o32)]
        agree = float((pm[0] == pm[1]).float().mean())
        log(f"[f32_routes] {label}: bf16 cascade against the fp32 one on the card, full depth "
            f"({cfg.encoder.depth} blocks), same weights, batch 1 (no gate): "
            + "; ".join(f"{k} mean_rel {v['mean_rel']:.3e} max_rel {v['max_rel']:.3e}"
                        for k, v in g.items())
            + f"; mask pixels (p > 0.5) that agree {agree:.4f}; class "
            f"{TEST_CLASS_NAMES[int(o16['pred'][0])]} vs "
            f"{TEST_CLASS_NAMES[int(o32['pred'][0])]}")
    torch.cuda.empty_cache()
    return walls


def phase_f32_routes():
    """The evaluate CLI at --dtype float32 --device cuda on the four
    configurations of [eval_slice] off the reference one (`F32_ROUTES`: SAM
    ViT-B's unfused 'flash' on #10, ViT-H on 'aug_flash' with #20, ViT-H at
    window 16 on #12 and #11 + #8, at window 17 on #11 + #8), 5 synthetic
    test images, batch 2: exact launches of the fp32 instances and none of
    a bf16 kernel, TF32 off after the CLI; each configuration's cascade at
    batch 1 on the card against the host's CPU (`_route_vs_cpu`), and its
    full-depth call's wall at batch 1 and 2 (`_route_walls`; on window 17
    with the bf16 cascade's gap to fp32). Returns each configuration's
    launch counts."""
    import torch
    from camouflaged_vlm_tpu_torch.cli import evaluate
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo
    from camouflaged_vlm_tpu_torch.ops import _cuda

    work = os.path.join("build", "chip_smoke_eval_f32")
    shutil.rmtree(work, ignore_errors=True)
    info = write_synthetic_ovcamo(os.path.join(work, "ovcamo_synthetic"), n_train=0, n_test=5,
                                  seed=1, test_classes=tuple(TEST_CLASS_NAMES))
    n_images, batch = 5, 2
    calls = eval_calls()  # 3 batches, the last short, replay the one graph
    images = _synthetic_images(2, seed=3)
    runs = {}
    try:
        for label in F32_ROUTES:
            cfg, path = _route_config(label, work)
            out_dir = os.path.join(OUT_DIR, f"eval_f32_{label}")
            torch.backends.cuda.matmul.allow_tf32 = True  # the CLI must turn both off
            torch.backends.cudnn.allow_tf32 = True
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            res = evaluate.main(["--dataset-info", info, "--config", path, "--device", "cuda",
                                 "--dtype", "float32", "--batch-size", str(batch),
                                 "--output-dir", out_dir])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _cuda.launch_counts()
            tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check(tf32 == (False, False), f"[f32_routes] {label}: the CLI left TF32 on: {tf32}")
            check(res["images"] == n_images, f"[f32_routes] {label}: {res['images']} images")
            check(all(np.isfinite(v) for v in res.values()), f"[f32_routes] {label}: {res}")
            expected = f32_expected(expected_launches(cfg, calls))
            enc = cfg.encoder
            log(f"[f32_routes] {label}: evaluate CLI --dtype float32, SAM {enc.embed_dim} wide x "
                f"{enc.depth}, {enc.num_heads} heads, {enc.attn_impl!r}, window "
                f"{enc.window_size}; images_per_sec {res['images_per_sec']} (a smoke figure); CLI "
                f"wall {wall:.1f} s; peak device memory {peak:.2f} GiB; TF32 after it {tf32}; sm "
                f"{res['sm']} accuracy {res['accuracy']}")
            log(f"[f32_routes] {label} kernel launches "
                f"{({k: v for k, v in counts.items() if v})} expected "
                f"{({k: v for k, v in expected.items() if v})}")
            check(counts == expected, f"[f32_routes] {label}: launches {counts} != {expected}")
            check_no_bf16_kernel(counts, f"[f32_routes] {label}")
            runs[label] = counts
            _route_vs_cpu(cfg, label, images[0])
            _route_walls(cfg, label, images, gap=label == "vit_h_flash_win17")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return runs


# ------------------------------------------------------------- multi-device

# n_model of the tensor-parallel widths [tp_kernels] holds the kernels at:
# SAM ViT-H's and CLIP ViT-L's 16 heads become 8 and 4 a rank
TP_WIDTHS = (2, 4)
# [tp_slice]: two tensor-parallel bf16 ranks against one rank, mean|d| /
# mean|ref|. The ranks sum fp32 partials and round once, as one rank does;
# their products' fp32 sums run in another order, which flips a bf16
# rounding here and there: after the first SAM block within
# TP_BLOCK0_MEAN_REL_BOUND (a wrong shard or collective is off by O(1)).
# The 32 random-weight blocks then spread such flips block by block (the
# TP_TRACE_BLOCKS lines), so the embedding moves about as far as one rank's
# own does under an input change far below bf16's resolution (x
# TP_NOISE_SCALE): the embedding is held to TP_EMB_NOISE_FACTOR times that
# gap, measured in the same run, or to 1e-2 where that gap is smaller
TP_BLOCK0_MEAN_REL_BOUND = 1e-4
TP_EMB_MEAN_REL_BOUND = 1e-2
TP_EMB_NOISE_FACTOR = 1.5
TP_NOISE_SCALE = 1.0 + 2.0 ** -20
TP_TRACE_BLOCKS = (0, 1, 7, 15, 31)
# [graph_memory]: device memory allocated after the last of 8 evaluate()
# calls (and of 4 validations) against after the first
MEMORY_GROWTH_BOUND_GIB = 0.05


def _check_tp(label, kfn, pfn, args, flops, reads=None, rel_bound=KERNEL_REL_BOUND,
              peak_flops=PEAK_BF16_FLOPS):
    """A kernel at a tensor-parallel rank's width against its plain version
    on the same inputs: shape, type, finite, errors within `rel_bound`; its
    device time on both clocks and its bound (FLOP over the peak of its
    type, bytes of `reads` (default every tensor argument) and the output
    over the HBM rate)."""
    import torch

    got = kfn(*args)
    torch.cuda.synchronize()
    want = pfn(*args)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: {got.shape}/{got.dtype} vs plain {want.shape}/{want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    e = errors(got, want)
    tensors = [a for a in (args if reads is None else reads) if isinstance(a, torch.Tensor)]
    b = bound(flops, nbytes(*tensors, got), peak_flops)
    del got, want
    k_ms = time_ms(lambda: kfn(*args), iters=10)
    k_q = time_ms(lambda: kfn(*args), iters=10, queued=True)
    log(f"[tp_kernels] {label:58s} max_abs {e['max_abs_err']:.3e} max_rel {e['max_rel']:.3e} "
        f"mean_rel {e['mean_rel']:.3e} (bound {rel_bound}) kernel {k_ms:.4f} ms (queued "
        f"{k_q:.4f} ms) bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    check(e["max_rel"] < rel_bound and e["mean_rel"] < rel_bound,
          f"{label} disagrees with its plain version: {e}")
    return dict(max_abs_err=e["max_abs_err"], max_rel=e["max_rel"], ms=k_ms, queued_ms=k_q, **b)


def tp_kernel_cases(rn, n):
    """The kernels of a tensor-parallel rank's sublayers at n_model = n, at
    batch 2 of the main path (SAM ViT-H: 16 / n heads x 80, qkv N 3840 / n,
    proj K 1280 / n, MLP H 5120 / n; CLIP ViT-L: 16 / n heads x 64, qkv N
    3072 / n, proj K 1024 / n, MLP H 4096 / n): (kernel, label, kernel fn,
    plain fn, args, FLOP, tensors read). `rn` draws the type under test.
    #4/#5 and #7 come with the residual (one device) and as a rank's
    partial (no residual, fp32 out), the backward #6 with and without its
    residual term, and #9 (window 17's padded carry) as a rank's partial."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops import linear as lin
    from camouflaged_vlm_tpu_torch.ops.compact_window import (
        LPAD_LANE, NEG, CompactGeometry, edge_consts,
    )

    dt, dev = rn(1).dtype, rn(1).device
    B, D, HD, G, WIN, S, W = 2, 1280, 80, 64, 14, 581, 1024
    heads, cheads = 16 // n, 16 // n
    C, CC, H, CH = heads * HD, cheads * 64, 5120 // n, 4096 // n
    geom = CompactGeometry(G, G, WIN)
    nf, ne, R = geom.n_full, geom.n_edge, geom.R_u
    scale = HD ** -0.5
    win_rows, clip_rows = (B * nf, WIN * WIN), (B, S)
    for kernel, site, lead, K, N, eps in (
            ("ln_linear_act_bt", "SAM windows", win_rows, D, 3 * C, 1e-6),
            ("ln_linear_act_bt", "CLIP", clip_rows, W, 3 * CC, 1e-5),
            ("ln_mask_linear_bt", "SAM global", (B, G * G), D, 3 * C, 1e-6)):
        kfn, pfn, args, flops, _ = ln_gemm_case(rn, kernel, lead, K, N, eps, None)
        yield (kernel, f"{site} {'x'.join(map(str, lead))}x{K} -> {N}", kfn, pfn, args, flops,
               None)
    for site, lead, K, Hh, eps, act in (("SAM windows", win_rows, D, H, 1e-6, "gelu_tanh"),
                                        ("CLIP", clip_rows, W, CH, 1e-5, "quick_gelu")):
        _, _, args, flops, _ = ln_gemm_case(rn, "ln_mlp_residual_bt", lead, K, Hh, eps, act)
        for res in (True, False):
            yield ("ln_mlp_residual_bt",
                   f"{site} {'x'.join(map(str, lead))}x{K}, H {Hh}, "
                   + ("residual" if res else "partial (fp32 out)"),
                   lambda *a, e=eps, ac=act, r=res: lin.ln_mlp_residual_bt(
                       *a, eps=e, activation=ac, residual=r),
                   lambda *a, e=eps, ac=act, r=res: lin.ln_mlp_residual_bt_ref(
                       *a, eps=e, activation=ac, residual=r), args, flops, None)
        if site == "SAM windows":  # the backward, dx only: the blocks are frozen
            g = rn(*lead, K, std=0.05)
            for res in (True, False):
                yield ("ln_mlp_residual_bt_bwd",
                       f"{site} {'x'.join(map(str, lead))}x{K}, H {Hh}, dx, residual {res}",
                       lambda *a, e=eps, ac=act, r=res: lin.ln_mlp_residual_bt_bwd(
                           *a, eps=e, activation=ac, weights=False, residual=r)[0],
                       lambda *a, e=eps, ac=act, r=res: lin.ln_mlp_residual_bt_bwd_ref(
                           *a, eps=e, activation=ac, weights=False, residual=r)[0],
                       (*args, g), 6.0 * np.prod(lead) * K * Hh, None)
    for site, shape, N in (("SAM windows", (B, nf, C, WIN * WIN), D), ("CLIP", (B, 1, CC, S), W)):
        args, flops, _ = proj_rows_case(rn, shape, N)
        yield ("proj_rows", f"{site} {'x'.join(map(str, shape))} -> {N}, residual",
               lin.proj_rows, lin.proj_rows_ref, args, flops, None)
        yield ("proj_rows", f"{site} {'x'.join(map(str, shape))} -> {N}, partial (fp32 out)",
               lambda *a: lin.proj_rows(*a, partial=True),
               lambda *a: lin.proj_rows_ref(*a, partial=True), args[:3], flops, None)
    x = rn(B, heads, 16, 289, HD)
    yield ("proj_from_heads", f"window 17 {B}x{heads}x16x289x{HD} -> {D}, partial (fp32 out)",
           lambda *a: lin.proj_from_heads(*a, partial=True),
           lambda *a: lin.proj_from_heads_ref(*a, partial=True),
           (x, rn(D, C, std=0.02), rn(D, std=0.02)), 2.0 * B * 16 * 289 * C * D, None)
    qkv, rel = rn(B * nf, WIN * WIN, 3 * C), rn(WIN * WIN, B * nf, heads * 32)
    yield ("flash_qkv_packed_windows_s", f"SAM windows {B * nf}x196, {heads} heads x {HD}",
           lambda *a: fa.flash_qkv_packed_windows_s(*a, scale, heads, HD),
           lambda *a: fa.flash_qkv_packed_windows_s_ref(*a, scale, heads, HD),
           (qkv, rel, fa.make_rel_scatter32(WIN, dt, dev)),
           4.0 * B * nf * heads * (WIN * WIN) ** 2 * HD, (qkv, rel))
    rel = rn(B, ne, R, heads, 32)
    off = 0
    for grp in geom.edge_groups:  # dummy rows' pad-key logit, as the encoder clamps it
        rel[:, off : off + grp.n, grp.rows :, :, LPAD_LANE] = NEG
        off += grp.n
    sel_e, kmask_e = edge_consts(geom, dt, dev)
    yield ("flash_qkv_packed_edge", f"SAM edge {B}x{ne}x{R}, {heads} heads x {HD}",
           lambda *a: fa.flash_qkv_packed_edge(*a, scale, heads, HD),
           lambda *a: fa.flash_qkv_packed_edge_ref(*a, scale, heads, HD),
           (rn(B, ne, R, 3 * C), rel.reshape(B, ne, R, heads * 32), sel_e,
            rn(heads, HD, std=0.5), kmask_e), 4.0 * B * ne * heads * R * R * HD, None)
    qkv = rn(B, S, 3 * CC)
    yield ("flash_qkv_packed_plain", f"CLIP {B}x{S}, {cheads} heads x 64",
           lambda q: fa.flash_qkv_packed_plain(q, 64 ** -0.5, cheads, 64),
           lambda q: fa.flash_qkv_packed_plain_ref(q, 64 ** -0.5, cheads, 64),
           (qkv,), 4.0 * B * cheads * S * S * 64, None)
    qkv, rel = rn(B, G * G, 3 * C), rn(G * G, B, heads, 2 * G)
    yield ("flash_qkv_packed_global", f"SAM global {B}x{G * G}, {heads} heads x {HD}",
           lambda *a: fa.flash_qkv_packed_global(*a, scale, heads, HD, G, G),
           lambda *a: fa.flash_qkv_packed_global_ref(*a, scale, heads, HD),
           (qkv, rel, fa.make_rel_scatter(G, G, dt, dev)),
           4.0 * B * heads * (G * G) ** 2 * HD, (qkv, rel))


def phase_tp_kernels():
    """#2, #3, #4/#5 (with the residual and as a partial), #6, #7, #9, #13,
    #15, #16 and #17 at the widths of a tensor-parallel rank (`TP_WIDTHS`, the
    heads and widths of `tp_kernel_cases`), bf16 within KERNEL_REL_BOUND
    and their fp32 instances within F32_REL_BOUND (TF32 off): errors, times
    on both clocks and bounds. Returns {kernels line name: [rows]}, which
    the kernels line adds to each kernel's entry (`tp`)."""
    import torch

    check(not torch.backends.cuda.matmul.allow_tf32, "fp32 kernel check needs TF32 off")
    g = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for dt, suffix, rel_bound, peak in ((torch.bfloat16, "", KERNEL_REL_BOUND, PEAK_BF16_FLOPS),
                                        (torch.float32, "_f32", F32_REL_BOUND, PEAK_F32_FLOPS)):
        def rn(*shape, std=1.0, dtype=dt):
            return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

        with torch.no_grad():
            for n in TP_WIDTHS:
                for kernel, label, kfn, pfn, args, flops, reads in tp_kernel_cases(rn, n):
                    r = _check_tp(f"{kernel}{suffix} n_model={n} {label}", kfn, pfn, args, flops,
                                  reads, rel_bound, peak)
                    out.setdefault(kernel + suffix, []).append(
                        {"n_model": n, "site": label, **r})
                    del args
                torch.cuda.empty_cache()
    return out


def _tp_inputs(cfg, dev, B=2, seed=3):
    """A seeded batch of B normalised images for the cascade call, on dev."""
    import torch

    rng = np.random.default_rng(seed)
    S, C = cfg.inp_size, cfg.clip_size
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(rng.standard_normal((B, S, S, 3)).astype(np.float32)),
            t(rng.standard_normal((B, C, C, 3)).astype(np.float32)),
            t(np.full((B, C, C, 1), 1.923, np.float32)))


def _cascade_call(model, cfg, dev, iters=3, scale=1.0, collectives=None):
    """The bf16 cascade's call at batch 2 on `model` (the 61 test classes'
    text features encoded first; the image input times `scale`): the SAM
    blocks' outputs at TP_TRACE_BLOCKS (the compact carry's interior rows
    of a windowed block) and the embedding, the outputs,
    launch counts and host-clock walls (after one warm call); with
    `collectives` (a list the caller's all-reduce wrapper appends each
    all-reduce's bytes to), those of the measured call."""
    import torch
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.factory import attach_rel_cache, make_bank_inputs
    from camouflaged_vlm_tpu_torch.ops import _cuda

    attach_rel_cache(model)
    bank = make_bank_inputs(cfg, TEST_CLASS_NAMES, device=dev)
    tf = model.encode_class_text_features(bank["prefix"], bank["suffix"], bank["eot_indices"],
                                          bank["bank_features"])
    inputs = _tp_inputs(cfg, dev)
    inputs = (inputs[0] * scale,) + inputs[1:]
    seen = {}
    hooks = [model.image_encoder.register_forward_hook(
        lambda m, a, out: seen.__setitem__("emb", out[0].float().cpu().numpy()))]
    for i in TP_TRACE_BLOCKS:
        hooks.append(model.image_encoder.blocks[i].register_forward_hook(
            lambda m, a, out, i=i: seen.__setitem__(
                i, (out[0] if isinstance(out, tuple) else out).float().cpu().numpy())))
    _cuda.reset_launches()
    if collectives is not None:
        collectives.clear()
    probs, pred, score = model.infer_cascade_with_text(*inputs, tf)
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    reduced = list(collectives) if collectives is not None else []
    for h in hooks:
        h.remove()
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        model.infer_cascade_with_text(*inputs, tf)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return dict(emb=seen["emb"], blocks={i: seen[i] for i in TP_TRACE_BLOCKS},
                all_reduce_bytes=reduced,
                probs=probs.float().cpu().numpy(), pred=pred.cpu().numpy(),
                score=score.float().cpu().numpy(), counts=counts, walls_ms=walls)


def _tp_slice_rank():
    """One rank of [tp_slice]: the full-width bf16 cascade sharded over a
    (1, 2) mesh of two ranks on one card."""
    import torch
    from camouflaged_vlm_tpu_torch.factory import build_full_cascade
    from camouflaged_vlm_tpu_torch.parallel import make_mesh, shard_model_

    from camouflaged_vlm_tpu_torch.parallel import sharding

    mesh = make_mesh(1, 2)
    model, cfg = build_full_cascade(dtype=torch.bfloat16, device=mesh.device, seed=0)
    shard_model_(model, mesh)
    sizes, real = [], sharding.all_reduce_

    def counted(t, group, *a, **kw):  # the model group's all-reduces, by bytes
        sizes.append(t.numel() * t.element_size())
        return real(t, group, *a, **kw)

    sharding.all_reduce_ = counted
    return {"mesh": repr(mesh), **_cascade_call(model, cfg, mesh.device, collectives=sizes)}


def phase_tp_slice():
    """The full-width bf16 cascade (SAM ViT-H at 1024 px + Alpha-CLIP
    ViT-L/14@336, the 61 test classes) tensor-parallel over two ranks on
    this card (gloo, each all-reduce through host memory), batch 2, against
    one rank on the card on the same seeded weights: the first SAM block's
    output within TP_BLOCK0_MEAN_REL_BOUND, the SAM embedding within
    max(TP_EMB_MEAN_REL_BOUND, TP_EMB_NOISE_FACTOR x one rank's own gap
    under the input times TP_NOISE_SCALE), the same classes, each rank's
    launches exactly one call's; the walls of both."""
    import torch
    import graft_entry_torch
    from camouflaged_vlm_tpu_torch.factory import build_full_cascade

    model, cfg = build_full_cascade(dtype=torch.bfloat16, device="cuda", seed=0)
    ref = _cascade_call(model, cfg, torch.device("cuda"))
    noisy = _cascade_call(model, cfg, torch.device("cuda"), iters=0, scale=TP_NOISE_SCALE)
    del model
    torch.cuda.empty_cache()
    ranks = graft_entry_torch.spawn_ranks(2, _tp_slice_rank, device="cuda")
    want = expected_launches(cfg, 1, text=False)
    check(ref["counts"] == want, f"[tp_slice] one rank: launches {ref['counts']} != {want}")
    def rel(a, b):
        return float(np.abs(a - b).mean() / np.abs(b).mean())

    def differ(a, b):
        return float((a != b).mean())

    def trace(got):
        return "; ".join(f"block {i} mean_rel {rel(got['blocks'][i], ref['blocks'][i]):.3e}, "
                         f"{differ(got['blocks'][i], ref['blocks'][i]):.3e} of it differing"
                         for i in TP_TRACE_BLOCKS)

    noise = rel(noisy["emb"], ref["emb"])
    emb_bound = max(TP_EMB_MEAN_REL_BOUND, TP_EMB_NOISE_FACTOR * noise)
    log(f"[tp_slice] one rank against itself with the input times {TP_NOISE_SCALE!r}: "
        f"{trace(noisy)}; embedding {noise:.3e}: the embedding's bound {emb_bound:.3e}")
    for r, got in enumerate(ranks):
        mean_rel, block0 = rel(got["emb"], ref["emb"]), rel(got["blocks"][0], ref["blocks"][0])
        logit_rel = float(np.abs(got["score"] - ref["score"]).max() / np.abs(ref["score"]).max())
        log(f"[tp_slice] rank {r} of {got['mesh']} against one rank: {trace(got)}; first block "
            f"bound {TP_BLOCK0_MEAN_REL_BOUND}; embedding mean_rel {mean_rel:.3e} (bound "
            f"{emb_bound:.3e}), max_abs {float(np.abs(got['emb'] - ref['emb']).max()):.3e}; "
            f"class logits max_rel {logit_rel:.3e}; classes {got['pred'].tolist()} vs one rank "
            f"{ref['pred'].tolist()}; call walls {[round(w, 2) for w in got['walls_ms']]} ms "
            f"against one rank's {[round(w, 2) for w in ref['walls_ms']]} ms (gloo through "
            "host memory on one card: nothing of NVLink)")
        sizes = got["all_reduce_bytes"]
        log(f"[tp_slice] rank {r}: {len(sizes)} all-reduces a batch-2 cascade call (the model "
            f"group's, fp32 partials), {sum(sizes) / 2 ** 20:.1f} MiB in all; by size (MiB x "
            f"count): {sorted(((round(b / 2 ** 20, 2), sizes.count(b)) for b in set(sizes)), reverse=True)}")
        check(block0 < TP_BLOCK0_MEAN_REL_BOUND, f"[tp_slice] rank {r}: first block {block0}")
        check(mean_rel < emb_bound, f"[tp_slice] rank {r}: embedding {mean_rel}")
        check(np.array_equal(got["pred"], ref["pred"]), f"[tp_slice] rank {r}: classes differ")
        check(np.isfinite(got["probs"]).all(), f"[tp_slice] rank {r}: non-finite mask")
        check(got["counts"] == want, f"[tp_slice] rank {r}: launches {got['counts']} != {want}")


def _depth8_f32_config():
    """The reference configuration at fp32, full width, SAM cut to depth 8
    (the 7 windowed blocks and global block 7)."""
    import torch
    from camouflaged_vlm_tpu_torch.models import CascadeConfig

    cfg = CascadeConfig.full(dtype=torch.float32)
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, depth=8, global_attn_indexes=(7,)))


def _dp_train_rank(info):
    """One rank of [dp_train]: the depth-8 fp32 step on a (2, 1) and a
    (1, 2) mesh, then a data-parallel evaluate() on (2, 1)."""
    import torch
    import graft_entry_torch
    from camouflaged_vlm_tpu_torch.parallel import make_mesh

    cfg = _depth8_f32_config()
    batch = _small_batch(cfg)
    out = {}
    for nd, nm in ((2, 1), (1, 2)):
        out[(nd, nm)] = graft_entry_torch.train_step_case(cfg, batch, make_mesh(nd, nm), seed=5)
        torch.cuda.empty_cache()
    out["evaluate"] = _vit_h_evaluate(info, make_mesh(2, 1), batch_size=2)
    return out


def _vit_h_evaluate(info, mesh, batch_size):
    """evaluate() of the repo's ViT-H configuration in bf16 (seeded weights,
    the test split's bank) over `info`'s test split, on `mesh` or one
    device."""
    import torch
    import yaml
    from camouflaged_vlm_tpu_torch.cli.evaluate import evaluate
    from camouflaged_vlm_tpu_torch.config import cascade_config_from_yaml, with_dtype
    from camouflaged_vlm_tpu_torch.data.ovcamo import OVCamoIndex
    from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs
    from camouflaged_vlm_tpu_torch.parallel import shard_model_

    cfg = with_dtype(cascade_config_from_yaml(VIT_H_YAML)[0], torch.bfloat16)
    dev = mesh.device if mesh is not None else torch.device("cuda")
    with open(info) as f:
        index = OVCamoIndex.from_dataset_info(yaml.safe_load(f), "test")
    model = shard_model_(build_cascade(cfg, dev, 0), mesh)
    res = evaluate(model, cfg, make_bank_inputs(cfg, index.classes, device=dev), index,
                   batch_size=batch_size, num_workers=4, mesh=mesh, log=log)
    del model
    torch.cuda.empty_cache()
    return res


def phase_dp_train():
    """Two ranks on this card (gloo): one fp32 train step of the full-width
    cascade at depth 8 (batch 2) on a (2, 1) and on a (1, 2) mesh, each
    against the same step of one rank on the card (|dloss| < 1e-5, the
    updated trainable parameters within 1e-4); then evaluate() of the ViT-H
    configuration data-parallel over 5 synthetic images (batch 2, one row a
    rank, each rank its own graph) against one device at batch 1, the same
    rows' program: equal metrics."""
    import torch
    import graft_entry_torch
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo

    work = os.path.join("build", "chip_smoke_dp")
    shutil.rmtree(work, ignore_errors=True)
    try:
        info = write_synthetic_ovcamo(os.path.join(work, "ovcamo_synthetic"), n_train=0,
                                      n_test=5, seed=1, test_classes=tuple(TEST_CLASS_NAMES))
        cfg = _depth8_f32_config()
        ref = graft_entry_torch.train_step_case(cfg, _small_batch(cfg), device="cuda", seed=5)
        torch.cuda.empty_cache()
        single = _vit_h_evaluate(info, None, batch_size=1)
        t0 = time.perf_counter()
        got = graft_entry_torch.spawn_ranks(2, _dp_train_rank, info, device="cuda")[0]
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    m1 = ref["metrics"][0]
    for mesh in ((2, 1), (1, 2)):
        m = got[mesh]["metrics"][0]
        dloss = abs(m["loss"] - m1["loss"])
        dparams = max(float(np.abs(got[mesh]["params"][k] - ref["params"][k]).max())
                      for k in ref["params"])
        log(f"[dp_train] fp32 step, full width, depth 8, batch 2, mesh (data={mesh[0]}, model="
            f"{mesh[1]}), two ranks on this card over gloo: loss {m['loss']:.8f} vs one rank "
            f"{m1['loss']:.8f}: dloss {dloss:.3e} (bound {graft_entry_torch.DLOSS_BOUND}), "
            f"dparams {dparams:.3e} (bound {graft_entry_torch.DPARAMS_BOUND})")
        check(dloss < graft_entry_torch.DLOSS_BOUND, f"[dp_train] {mesh}: dloss {dloss}")
        check(dparams < graft_entry_torch.DPARAMS_BOUND, f"[dp_train] {mesh}: dparams {dparams}")
    dp = got["evaluate"]
    keys = ("sm", "wfm", "mae", "avgiou", "ori_mae", "accuracy")
    gaps = {k: abs(dp[k] - single[k]) for k in keys}
    log(f"[dp_train] evaluate() data-parallel (data=2, batch 2) vs one device (batch 1) on 5 "
        f"images: {({k: dp[k] for k in keys})} vs {({k: single[k] for k in keys})}; the "
        f"ranks' spawn and both meshes took {wall:.1f} s")
    check(dp["images"] == single["images"] == 5, f"[dp_train] images {dp['images']}")
    check(max(gaps.values()) <= 1e-6, f"[dp_train] data-parallel evaluate() differs: {gaps}")


def phase_graph_memory():
    """Device memory across CUDA-graph captures: evaluate() of the ViT-H
    configuration (bf16) eight times in this process (one capture each),
    then the train CLI (bf16, full width, 4 epochs of one step, --epoch-val
    1: four graphed validations); torch.cuda.memory_allocated() after each.
    The allocated memory after the last may exceed that after the first by
    MEMORY_GROWTH_BOUND_GIB at most."""
    import torch
    from camouflaged_vlm_tpu_torch.cli import train as train_cli
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo

    gib = lambda: torch.cuda.memory_allocated() / 2 ** 30  # noqa: E731
    work = os.path.join("build", "chip_smoke_memory")
    shutil.rmtree(work, ignore_errors=True)
    try:
        info = write_synthetic_ovcamo(os.path.join(work, "ovcamo_synthetic"), n_train=2,
                                      n_test=2, seed=2, train_classes=("owl", "frog"),
                                      test_classes=tuple(TEST_CLASS_NAMES))
        import yaml
        from camouflaged_vlm_tpu_torch.cli.evaluate import evaluate
        from camouflaged_vlm_tpu_torch.config import cascade_config_from_yaml, with_dtype
        from camouflaged_vlm_tpu_torch.data.ovcamo import OVCamoIndex
        from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs

        cfg = with_dtype(cascade_config_from_yaml(VIT_H_YAML)[0], torch.bfloat16)
        with open(info) as f:
            index = OVCamoIndex.from_dataset_info(yaml.safe_load(f), "test")
        model = build_cascade(cfg, "cuda", 0)
        bank = make_bank_inputs(cfg, index.classes, device="cuda")
        evals = []
        for _ in range(8):
            evaluate(model, cfg, bank, index, batch_size=2, num_workers=2)
            torch.cuda.synchronize()
            evals.append(gib())
        del model, bank
        torch.cuda.empty_cache()
        vals = []
        real = train_cli.evaluate

        def validate(*a, **kw):
            res = real(*a, **kw)
            torch.cuda.synchronize()
            vals.append(gib())
            return res

        train_cli.evaluate = validate
        try:
            train_cli.main(["--dataset-info", info, "--device", "cuda", "--dtype", "bfloat16",
                            "--epochs", "4", "--batch-size", "2", "--epoch-val", "1",
                            "--save-dir", os.path.join(work, "train")])
        finally:
            train_cli.evaluate = real
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for label, seq in (("evaluate() x 8", evals), ("train CLI validations x 4", vals)):
        grow = seq[-1] - seq[0]
        log(f"[graph_memory] {label}: memory_allocated after each "
            f"{[round(v, 4) for v in seq]} GiB; growth first to last {grow:.4f} GiB (bound "
            f"{MEMORY_GROWTH_BOUND_GIB})")
        check(len(seq) == (8 if "evaluate" in label else 4), f"[graph_memory] {label}: {seq}")
        check(grow <= MEMORY_GROWTH_BOUND_GIB, f"[graph_memory] {label}: grew {grow} GiB")


def phase_graft():
    """graft_entry_torch.py on this card: entry()'s bf16 cascade forward
    once (finite outputs of the expected shapes), then dryrun_multichip(2,
    device="cuda"): two ranks on this card over gloo, the train step and
    the eval program of a small fp32 cascade on meshes (2, 1) and (1, 2)
    held to one process."""
    import torch
    import graft_entry_torch

    fwd, args = graft_entry_torch.entry()
    probs, pred, score = fwd(*args)
    torch.cuda.synchronize()
    check(probs.shape == (1, 1024, 1024, 1) and bool(torch.isfinite(probs).all()),
          f"[graft] entry(): mask {tuple(probs.shape)}")
    check(score.shape == (1, len(graft_entry_torch.TEST_CLASSNAMES_SMALL))
          and bool(torch.isfinite(score).all()), f"[graft] entry(): logits {tuple(score.shape)}")
    log(f"[graft] entry(): bf16 cascade forward on the card, mask {tuple(probs.shape)}, class "
        f"{int(pred[0])}, logits {score.float().cpu().numpy().round(4).tolist()}")
    del fwd, args, probs, pred, score
    torch.cuda.empty_cache()
    for r in graft_entry_torch.dryrun_multichip(2, device="cuda"):
        log(f"[graft] dryrun_multichip(2, cuda) mesh {r['mesh']}: loss {r['loss']:.6f} dloss "
            f"{r['dloss']:.3e} dparams {r['dparams']:.3e} deval {r['deval']:.3e}")


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
    timed(phase_profile)
    grads = timed(phase_grads)
    timed(phase_train_small)
    train_counts = timed(phase_train_slice)
    timed(phase_train_val)
    timed(phase_unfused)
    evals = timed(phase_eval_slice)
    f32 = timed(phase_f32_kernels)
    timed(phase_maple_small)
    maple_counts = timed(phase_maple_slice)
    f32_counts = timed(phase_f32_slice)
    timed(phase_jax_golden)
    timed(phase_f32_train_small)
    f32_train_counts = timed(phase_f32_train_slice)
    timed(phase_f32_train_remat)
    route_counts = timed(phase_f32_routes)
    tp = timed(phase_tp_kernels)
    timed(phase_tp_slice)
    timed(phase_dp_train)
    timed(phase_graph_memory)
    timed(phase_graft)
    import torch
    from camouflaged_vlm_tpu_torch.ops import _cuda

    # launches: each kernel's count in the run of its own main path (the
    # split-q/k/v and padded-carry kernels' from their eval-slice
    # configuration, their fp32 instances' from [f32_routes]); the kernels
    # no path reaches (#9, #19 and their fp32 instances) carry their check's
    # count and say so (`NO_PATH`, `NO_PATH_F32`)
    ev = {label: r["counts"] for label, r in evals.items()}
    launches = {**counts, **{k: train_counts[k] for k in grads},
                "flash_attention_relpos": ev["vit_b_flash"]["flash_attention_relpos"],
                "flash_attention_fullk": ev["vit_h_aug_flash"]["flash_attention_fullk"],
                "flash_qkv_packed_windows": ev["vit_h_flash_win16"]["flash_qkv_packed_windows"],
                "flash_qkv_relpos_windows": ev["vit_h_flash_win17"]["flash_qkv_relpos_windows"],
                "proj_from_heads_res": ev["vit_h_flash_win17"]["proj_from_heads_res"],
                "ln_mlp_residual_bt_f32": f32_launches,
                **{k: (f32_counts if k in SAM_F32 else f32_train_counts if k in SAM_F32_BWD
                       else route_counts[ROUTE_F32[k]] if k in ROUTE_F32
                       else f32_counts if k in NO_PATH_F32 else maple_counts)[k] for k in f32}}
    no_path = {**NO_PATH, **NO_PATH_F32}
    kernels = [
        {"name": k, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": r["launches"] if k in no_path else launches[k],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "queued_ms": r["queued_ms"], "library_queued_ms": r["library_queued_ms"],
         "host_us": r.get("host_us"),
         **({"gemm_library_ms": r["gemm_library_ms"]} if "gemm_library_ms" in r else {}),
         **({"cascade": F32_CASCADE_ROWS[k]} if k in F32_CASCADE_ROWS else {}),
         **{k2: v for k2, v in r.items() if k2.startswith(("batch2_", "batch1_"))},
         **({"path": r["path"]} if k in no_path else {}),
         **({"tp": tp[k]} if k in tp else {})}
        for res in (results, grads, f32) for k, r in res.items()
    ]
    check(set(tp) <= {e["name"] for e in kernels}, f"tp rows without an entry: {set(tp)}")
    check(len(kernels) == len(_cuda.KERNELS) == 38 and all(e["launches"] > 0 for e in kernels)
          and all(launches[e["name"]] == 0 for e in kernels if e["name"] in no_path),
          f"kernels line: {[(e['name'], e['launches']) for e in kernels]}")
    log("[device] name and power limit (nvidia-smi) of the card all numbers above ran on:")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
