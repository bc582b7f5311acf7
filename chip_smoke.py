#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

  python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases, each of which raises on failure (the script then exits non-zero and
never prints its last line):

  1. device   the card's name and power limit (nvidia-smi); no CUDA -> error
  2. build    nvcc builds the port's kernels (csrc/*.cu) for sm_90a
  3. kernels  each kernel against its plain PyTorch version at the main
              path's full-width bf16 shapes, with errors and times (median
              of CUDA-event timings after a warm-up); then the bounds of the
              TPU kernels not ported yet at the shapes of the configurations
              that would reach them
  4. small    a small cascade in bf16 on the card against the same weights
              in fp32 on the CPU (the plain versions, which the CPU tests tie
              to the JAX package); its SAM runs 'flash' with 8 heads on a
              grid with edge and corner windows
  5. vit_h    a depth-cut SAM ViT-H encoder at full width (1024 px, 1280
              wide, 16 heads x 80, window 14; one windowed and one global
              block) in bf16 on the card, 'flash' against 'reference' on the
              same weights
  6. slice    the full-width cascade (SAM ViT-H at 1024 px on 'flash' with
              the rel cache, the edge decoder, MaPLe Alpha-CLIP ViT-L/14@336,
              the 61 OVCamo test classes) in bf16 from seeded random weights,
              driven through the demo CLI's session: text features encoded
              once, three requests at batch 1, one at batch 2. Outputs are
              checked, and every kernel's launch count must match the path.
              Then the cascade call's stage times (CUDA events) at batch 1
              and 2.
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
 10. unfused  as vit_h, depth 2 at full width, for SAM ViT-B on 'flash' (12
              heads: the unfused path, TPU kernel #10 in both blocks) and
              SAM ViT-H on 'aug_flash' (#20 in the global block), each
              against 'reference' on the same bf16 weights
 11. eval_slice  the evaluate CLI (`cli/evaluate.main`, --device cuda, bf16,
              batch 2) over a synthetic OVCamo-layout test split of 5 images
              (the last batch short), for the repo's ViT-H yaml, the port's
              ViT-B yaml and the ViT-H yaml on 'aug_flash': finite results,
              exact launch counts, images/s and peak memory per config (a
              smoke figure: 5 images have no steady state; the rate is
              `cli/eval_throughput.py`'s over 300); then
              each configuration's cascade call cut into stages at batch 2,
              and the CLI's host metric work per image

Every kernel line carries its bound (the larger of its FLOP over the bf16
tensor-core peak and its bytes over the HBM rate, at this run's shapes) and
the time of one PyTorch library call computing the same function where
there is one. Before its last line the script prints one JSON object
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}. Longer
logs go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import time

import numpy as np

OUT_DIR = os.path.join("chiprun_out", "chip_smoke")

# Bound on the kernel-vs-plain relative errors (max|d|/max|ref| and
# mean|d|/mean|ref|) in bf16. Both versions round the same values at the same
# points (LN output, hidden, q*scale, probabilities, output) and differ only
# in fp32 summation order, which can flip a bf16 rounding by one ulp
# (2^-8 = 3.9e-3 relative); 1e-2 allows ~2.5 ulp.
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
# the repo's configurations the eval slice runs
VIT_H_YAML = os.path.join("configs", "ovcos-sam-vit-h-maskdecoder-edge.yaml")
VIT_B_YAML = os.path.join("camouflaged_vlm_tpu_torch", "configs",
                          "ovcos-sam-vit-b-maskdecoder-edge.yaml")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median of per-call CUDA-event times (ms) after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
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


def bound(flops: float, n_bytes: int) -> dict:
    """The least time the card could take: FLOP over the bf16 peak or bytes
    over the HBM rate, whichever is larger, and which one it is."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, n_bytes / PEAK_HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available (this script needs an H100)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
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


def _check_kernel(name, kfn, pfn, args, timed=True, flops=None, reads=None, library=None):
    """Kernel against its plain version on the same inputs: shape, type,
    finite, within KERNEL_REL_BOUND; times (kernel, plain, and `library`, a
    zero-argument PyTorch call computing the same function, or None) in ms;
    the bound from `flops` and the bytes of the tensors the kernel reads
    (`reads`, default every tensor argument) plus its output."""
    import torch

    got = kfn(*args)
    torch.cuda.synchronize()
    want = pfn(*args)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {got.shape}/{got.dtype} vs plain {want.shape}/{want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    e = errors(got, want)
    tensors = [a for a in (args if reads is None else reads) if isinstance(a, torch.Tensor)]
    b = bound(flops, nbytes(*tensors, got)) if flops is not None else {}
    del got, want
    k_ms = time_ms(lambda: kfn(*args)) if timed else float("nan")
    p_ms = time_ms(lambda: pfn(*args)) if timed else float("nan")
    lib_ms = time_ms(library) if (timed and library is not None) else None
    extra = ""
    if b:
        extra = (f" library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'} bound "
                 f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    log(f"[kernel] {name:40s} max_abs {e['max_abs_err']:.3e} max_rel {e['max_rel']:.3e} "
        f"mean_rel {e['mean_rel']:.3e} (bound {KERNEL_REL_BOUND}) kernel {k_ms:.4f} ms "
        f"plain {p_ms:.4f} ms{extra}")
    check(e["max_rel"] < KERNEL_REL_BOUND and e["mean_rel"] < KERNEL_REL_BOUND,
          f"{name} disagrees with its plain version: {e}")
    return dict(max_abs_err=e["max_abs_err"], ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, **b)


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
    ln_g, ln_b = 1 + rn(W, std=0.1, dtype=torch.float32), rn(W, std=0.1, dtype=torch.float32)
    # SAM ViT-H: 1280 wide, 16 heads x 80, 64x64 grid, window 14
    D, HD, NH, G, WIN = 1280, 80, 16, 64, 14
    geom = CompactGeometry(G, G, WIN)
    nf, ne, R = geom.n_full, geom.n_edge, geom.R_u
    sg, sb = 1 + rn(D, std=0.1, dtype=torch.float32), rn(D, std=0.1, dtype=torch.float32)
    w_qkv, b_qkv = rn(3 * D, D, std=0.02), rn(3 * D, std=0.02)
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
    cases = [
        ("linear_act", "camouflaged_vlm_tpu_torch/csrc/ln_linear.cu",
         "camouflaged_vlm_tpu/ops/linear.py:61",
         lin.linear_act, lin.linear_act_ref, (x_pe, w_pe, b_pe),
         2.0 * B * 4096 * 768 * 1280, None, lambda: F.linear(x_pe, w_pe, b_pe)),
        ("ln_linear_act_bt", "camouflaged_vlm_tpu_torch/csrc/ln_linear.cu",
         "camouflaged_vlm_tpu/ops/linear.py:143",
         lambda *a: lin.ln_linear_act_bt(*a, eps=1e-5, activation=None),
         lambda *a: lin.ln_linear_act_bt_ref(*a, eps=1e-5, activation=None),
         (rn(B, S, W), ln_g, ln_b, rn(3 * W, W, std=0.02), rn(3 * W, std=0.02)),
         2.0 * B * S * W * 3 * W, None, None),
        ("ln_mask_linear_bt", "camouflaged_vlm_tpu_torch/csrc/ln_linear.cu",
         "camouflaged_vlm_tpu/ops/linear.py:228",
         lambda *a: lin.ln_mask_linear_bt(*a, eps=1e-6),
         lambda *a: lin.ln_mask_linear_bt_ref(*a, eps=1e-6),
         (rn(B, G * G, D), sg, sb, torch.ones(1, G * G, 1, dtype=bf, device=dev), w_qkv,
          b_qkv),
         2.0 * B * G * G * D * 3 * D, None, None),
        ("ln_mlp_residual_bt", "camouflaged_vlm_tpu_torch/csrc/ln_mlp_residual.cu",
         "camouflaged_vlm_tpu/ops/linear.py:416",
         lambda *a: lin.ln_mlp_residual_bt(*a, eps=1e-5, activation="quick_gelu"),
         lambda *a: lin.ln_mlp_residual_bt_ref(*a, eps=1e-5, activation="quick_gelu"),
         (rn(B, S, W), ln_g, ln_b, rn(4 * W, W, std=0.02), rn(4 * W, std=0.02),
          rn(W, 4 * W, std=0.02), rn(W, std=0.02)),
         4.0 * B * S * W * 4 * W, None, None),
        ("proj_rows", "camouflaged_vlm_tpu_torch/csrc/proj_rows.cu",
         "camouflaged_vlm_tpu/ops/linear.py:665",
         lin.proj_rows, lin.proj_rows_ref,
         (rn(B, 1, W, S), rn(W, W, std=0.02), rn(W, std=0.02), rn(B, 1, S, W)),
         2.0 * B * S * W * W, None, None),
        ("flash_qkv_packed_plain", "camouflaged_vlm_tpu_torch/csrc/qkv_packed_plain.cu",
         "camouflaged_vlm_tpu/ops/flash_attention.py:875",
         lambda q: fa.flash_qkv_packed_plain(q, 64 ** -0.5, 16, 64),
         lambda q: fa.flash_qkv_packed_plain_ref(q, 64 ** -0.5, 16, 64),
         (qkv_clip,), 4.0 * B * 16 * S * S * 64, None,
         sdpa_packed(qkv_clip, 16, 64, 64 ** -0.5)),
        ("flash_qkv_packed_windows_s", "camouflaged_vlm_tpu_torch/csrc/qkv_packed_windows.cu",
         "camouflaged_vlm_tpu/ops/flash_attention.py:519",
         lambda *a: fa.flash_qkv_packed_windows_s(*a, sam_scale, NH, HD),
         lambda *a: fa.flash_qkv_packed_windows_s_ref(*a, sam_scale, NH, HD),
         (qkv_win, rel_win, sel32), 4.0 * B * nf * NH * (WIN * WIN) ** 2 * HD,
         (qkv_win, rel_win), sdpa_packed(qkv_win, NH, HD, sam_scale, bias_win)),
        ("flash_qkv_packed_edge", "camouflaged_vlm_tpu_torch/csrc/qkv_packed_windows.cu",
         "camouflaged_vlm_tpu/ops/flash_attention.py:755",
         lambda *a: fa.flash_qkv_packed_edge(*a, sam_scale, NH, HD),
         lambda *a: fa.flash_qkv_packed_edge_ref(*a, sam_scale, NH, HD),
         (rn(B, ne, R, 3 * D), edge_rel.reshape(B, ne, R, NH * 32), sel_e,
          rn(NH, HD, std=0.5), kmask_e),
         4.0 * B * ne * NH * R * R * HD, None, None),
        ("flash_qkv_packed_global", "camouflaged_vlm_tpu_torch/csrc/qkv_packed_global.cu",
         "camouflaged_vlm_tpu/ops/flash_attention.py:1083",
         lambda *a: fa.flash_qkv_packed_global(*a, sam_scale, NH, HD, G, G),
         lambda *a: fa.flash_qkv_packed_global_ref(*a, sam_scale, NH, HD),
         (qkv_glob, rel_glob, sel_glob), 4.0 * B * NH * (G * G) ** 2 * HD,
         (qkv_glob, rel_glob), sdpa_packed(qkv_glob, NH, HD, sam_scale, bias_glob)),
    ]
    # the same kernels at SAM's shapes where the JSON line holds the CLIP one
    # (the LN-fused and residual-fused functions have no single library call)
    Mw, Mg = B * nf * WIN * WIN, B * G * G  # SAM rows: interior windows, global
    sam_cases = [
        ("ln_linear_act_bt (SAM windows 32x196x1280 -> 3840)",
         lambda *a: lin.ln_linear_act_bt(*a, eps=1e-6, activation=None),
         lambda *a: lin.ln_linear_act_bt_ref(*a, eps=1e-6, activation=None),
         (rn(B * nf, WIN * WIN, D), sg, sb, w_qkv, b_qkv), 2.0 * Mw * D * 3 * D),
        ("ln_mlp_residual_bt (SAM windows 32x196x1280, H 5120)",
         lambda *a: lin.ln_mlp_residual_bt(*a, eps=1e-6, activation="gelu_tanh"),
         lambda *a: lin.ln_mlp_residual_bt_ref(*a, eps=1e-6, activation="gelu_tanh"),
         (rn(B * nf, WIN * WIN, D), sg, sb, rn(4 * D, D, std=0.02), rn(4 * D, std=0.02),
          rn(D, 4 * D, std=0.02), rn(D, std=0.02)), 4.0 * Mw * D * 4 * D),
        ("ln_mlp_residual_bt (SAM global 2x4096x1280, H 5120)",
         lambda *a: lin.ln_mlp_residual_bt(*a, eps=1e-6, activation="gelu_tanh"),
         lambda *a: lin.ln_mlp_residual_bt_ref(*a, eps=1e-6, activation="gelu_tanh"),
         (rn(B, G * G, D), sg, sb, rn(4 * D, D, std=0.02), rn(4 * D, std=0.02),
          rn(D, 4 * D, std=0.02), rn(D, std=0.02)), 4.0 * Mg * D * 4 * D),
        ("proj_rows (SAM windows 2x16x1280x196, residual)",
         lin.proj_rows, lin.proj_rows_ref,
         (rn(B, nf, D, WIN * WIN), rn(D, D, std=0.02), rn(D, std=0.02),
          rn(B, nf, WIN * WIN, D)), 2.0 * Mw * D * D),
        ("proj_rows (SAM global 2x1x1280x4096, residual)",
         lin.proj_rows, lin.proj_rows_ref,
         (rn(B, 1, D, G * G), rn(D, D, std=0.02), rn(D, std=0.02), rn(B, 1, G * G, D)),
         2.0 * Mg * D * D),
    ]
    # the text tower's MLP shape is on the path too (checked, not timed)
    text_mlp = (rn(61, 77, 768), 1 + rn(768, std=0.1, dtype=torch.float32),
                rn(768, std=0.1, dtype=torch.float32), rn(3072, 768, std=0.02),
                rn(3072, std=0.02), rn(768, 3072, std=0.02), rn(768, std=0.02))
    results = {}
    with torch.no_grad():
        for name, source, replaces, kfn, pfn, args, flops, reads, library in cases:
            results[name] = dict(source=source, replaces=replaces,
                                 **_check_kernel(name, kfn, pfn, args, flops=flops,
                                                 reads=reads, library=library))
        for name, kfn, pfn, args, flops in sam_cases:
            _check_kernel(name, kfn, pfn, args, flops=flops)
        _check_kernel("ln_mlp_residual_bt (text 61x77x768)",
                      lambda *a: lin.ln_mlp_residual_bt(*a, eps=1e-5, activation="quick_gelu"),
                      lambda *a: lin.ln_mlp_residual_bt_ref(*a, eps=1e-5,
                                                            activation="quick_gelu"),
                      text_mlp, timed=False)
        results.update(split_attention_kernels(rn))
        unported_sites(rn)
    return results


def unported_sites(rn):
    """The TPU kernels not ported yet, at the full-width shapes of the
    configurations that would reach them (worked out from the JAX package's
    code; batch 2, SAM ViT-H width, 16 heads x 80): their bound, and the
    time of SDPA with the bias materialised where one call computes the
    function. #12: fused 'flash' with window 16 (grid 64: 16 windows of 256
    tokens, H+W = 32); #11: window 17 (grid padded to 68: 16 windows of 289
    tokens, H+W = 34 > 32), rel per head; #8 / #9: the out-projection of
    #11's head-leading output with / without the residual; #19: the global
    blocks (the function of #17, whose row holds the library time)."""
    import torch

    F = torch.nn.functional
    B, D, NH, HD = 2, 1280, 16, 80
    for site, name, nwin, n, hw in (("#12", "flash_qkv_packed_windows", 16, 256, 32),
                                    ("#11", "flash_qkv_relpos_windows", 16, 289, 34)):
        BB = B * nwin
        q, k, v = rn(BB, NH, n, HD), rn(BB, NH, n, HD), rn(BB, NH, n, HD)
        bias = rn(BB, NH, n, n)
        rel_bytes = 2 * BB * n * NH * hw
        b = bound(4.0 * BB * NH * n * n * HD, nbytes(q, k, v, q) + rel_bytes)
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                             scale=HD ** -0.5))
        log(f"[unported] {site} {name} ({BB} windows x {n} tokens, {NH} heads x {HD}, H+W "
            f"{hw}): bound {b['bound_ms']:.4f} ms ({b['bound_by']}); library (SDPA, bias "
            f"materialised) {lib:.4f} ms")
        del q, k, v, bias
    rows = B * 16 * 289
    x_bytes = 2 * rows * D
    for site, name, res in (("#8", "proj_from_heads_res", True), ("#9", "proj_from_heads", False)):
        b = bound(2.0 * rows * D * D, x_bytes + 2 * D * D + 2 * D + x_bytes * (2 if res else 1))
        log(f"[unported] {site} {name} (x {B}x{NH}x16x289x{HD} -> {B}x16x289x{D}"
            f"{', residual' if res else ''}): bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
            "library none (no single call takes the head-leading input with the bias)")
    N = 64 * 64
    b = bound(4.0 * B * NH * N * N * HD, 2 * (B * N * 3 * D + N * B * NH * 128 + B * N * D))
    log(f"[unported] #19 flash_qkv_relpos_global (qkv {B}x{N}x{3 * D}, rel {N}x{B}x{NH}x128): "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); library as #17's row (the same "
        "function at the same shape)")


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
                source="camouflaged_vlm_tpu_torch/csrc/attn_relpos.cu",
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


def phase_small():
    import torch
    from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs

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
    for m, cfg, dev in ((ref, cpu_cfg, "cpu"), (model, gpu_cfg, "cuda")):
        bank = make_bank_inputs(cfg, names, seed=5, device=dev)
        outs.append(m.infer_cascade(*(torch.from_numpy(a).to(dev) for a in inputs),
                                    bank["prefix"], bank["suffix"], bank["eot_indices"],
                                    bank["bank_features"]))
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
    from camouflaged_vlm_tpu_torch.factory import cast_weights_, init_random_
    from camouflaged_vlm_tpu_torch.models import ImageEncoderViT, SamEncoderConfig
    from camouflaged_vlm_tpu_torch.ops import _cuda

    kw = dict(dtype=torch.bfloat16, depth=2, global_attn_indexes=(1,))
    encs = {}
    for impl in ("flash", "reference"):
        with torch.device("meta"):
            enc = ImageEncoderViT(SamEncoderConfig.vit_h(attn_impl=impl, **kw))
        enc = enc.to_empty(device="cuda")
        init_random_(enc, torch.Generator(device="cuda").manual_seed(11))
        with torch.no_grad():  # rel-pos tables large enough for the bias to matter
            for blk in enc.blocks:
                blk.attn.rel_pos_h.mul_(25.0)
                blk.attn.rel_pos_w.mul_(25.0)
        cast_weights_(enc, torch.bfloat16)
        encs[impl] = enc.eval().requires_grad_(False)
    encs["flash"].load_state_dict(encs["reference"].state_dict(), strict=True)
    x = torch.from_numpy(
        np.random.default_rng(11).standard_normal((1, 1024, 1024, 3)).astype(np.float32)
    ).cuda()
    with torch.no_grad():
        _cuda.reset_launches()
        got, got_i = encs["flash"](x)
        counts = {k: v for k, v in _cuda.launch_counts().items() if v}
        want, want_i = encs["reference"](x)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(got_i[0]).all()),
          "vit_h: non-finite flash output")
    e, ei = errors(got, want), errors(got_i[0], want_i[0])
    log(f"[vit_h] depth 2 (1 windowed + 1 global), 1024 px, bf16, flash vs reference: neck "
        f"mean_rel {e['mean_rel']:.3e} max_rel {e['max_rel']:.3e}; global block mean_rel "
        f"{ei['mean_rel']:.3e} max_rel {ei['max_rel']:.3e} (bound mean_rel "
        f"{VITH_MEAN_REL_BOUND}); flash launches {counts}")
    check(e["mean_rel"] < VITH_MEAN_REL_BOUND and ei["mean_rel"] < VITH_MEAN_REL_BOUND,
          f"vit_h: flash disagrees with reference: {e} {ei}")
    for name in ("flash_qkv_packed_windows_s", "flash_qkv_packed_edge",
                 "flash_qkv_packed_global", "ln_mask_linear_bt"):
        check(counts.get(name, 0) > 0, f"vit_h: flash encoder did not launch {name}")
    del encs
    torch.cuda.empty_cache()


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
    requests = [[0], [1], [2], [3, 4]]
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
    layers = cfg.clip.vision_layers
    enc = cfg.encoder
    check(enc.attn_impl == "flash", f"slice: SAM runs {enc.attn_impl!r}, not 'flash'")
    check(all(b.attn.rel_cache is not None for b in session.model.image_encoder.blocks),
          "slice: the demo session did not attach the rel cache")
    n_glob = len(enc.global_attn_indexes)
    n_win = enc.depth - n_glob  # windowed blocks: interior + edge windows each (grid 64, win 14)
    expected = {
        "linear_act": 2 * calls,  # SAM patch embed + EVP handcrafted embed
        "ln_linear_act_bt": (2 * n_win + 2 * layers) * calls,
        "ln_mask_linear_bt": n_glob * calls,
        "flash_qkv_packed_windows_s": n_win * calls,
        "flash_qkv_packed_edge": n_win * calls,
        "flash_qkv_packed_global": n_glob * calls,
        "flash_qkv_packed_plain": 2 * layers * calls,
        "proj_rows": (2 * n_win + n_glob + 2 * layers) * calls,
        # text tower once (12 layers) + SAM's and the vision towers' MLPs
        "ln_mlp_residual_bt": cfg.clip.transformer_layers
        + (2 * n_win + n_glob + 2 * layers) * calls,
        # inference launches no backward kernel
        "ln_mlp_residual_bt_bwd": 0,
        "flash_qkv_packed_windows_s_bwd": 0,
        "flash_qkv_packed_global_bwd": 0,
        # SAM ViT-H on 'flash' is fused: no split-q/k/v attention
        "flash_attention_relpos": 0,
        "flash_attention_fullk": 0,
    }
    log(f"[slice] kernel launches {counts} expected {expected}")
    check(counts == expected, f"launch counts {counts} != expected {expected}")
    stage_times(session.model, session.cfg, session.text_features,
                {bs: session.preprocess(images[:bs]) for bs in (1, 2)})
    return counts


def stage_times(m, cfg, tf, batches, label="", iters=5):
    """The cascade call (`infer_cascade_with_text`) cut into its stages,
    CUDA events between them, median of `iters` calls for each batch size of
    `batches` ({size: (inp, clip image, clip mask)})."""
    import torch
    from camouflaged_vlm_tpu_torch.ops.resize import resize_bilinear

    names = [f"SAM encoder ({cfg.encoder.attn_impl})", "CLIP pass 1", "decoder + upsample",
             "sigmoid + alpha resize", "CLIP pass 2"]
    for bs, (inp, cimg, cmask) in batches.items():
        rows = []
        with torch.no_grad():
            for it in range(iters + 1):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev[0].record()
                feats, _ = m.image_encoder(inp)
                ev[1].record()
                ifeat, tfeat, _, _ = m.clip_model.classify(cimg, cmask, tf)
                ev[2].record()
                masks, _, _ = m._decode(feats, m._sparse_embeddings(ifeat, tfeat))
                ev[3].record()
                alpha = resize_bilinear(torch.sigmoid(masks.float()), cfg.clip_size,
                                        cfg.clip_size)
                ev[4].record()
                m.clip_model.classify(cimg, alpha, tf)
                ev[5].record()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1000
                if it:  # the first call warms up
                    rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))]
                                + [wall])
        med = np.median(np.array(rows), axis=0)
        parts = "; ".join(f"{n} {t:.2f}" for n, t in zip(names, med))
        log(f"[stages]{label} batch {bs} (median of {iters}, ms): {parts}; sum "
            f"{med[:-1].sum():.2f}; wall of the call {med[-1]:.2f}")


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
    parts = "; ".join(f"{o} max_rel {e['max_rel']:.3e} mean_rel {e['mean_rel']:.3e}"
                      for o, e in errs.items())
    log(f"[grads] {name}: {parts} (bound {KERNEL_REL_BOUND}); kernel {k_ms:.4f} ms "
        f"plain {p_ms:.4f} ms library none bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    for o, e in errs.items():
        check(e["max_rel"] < KERNEL_REL_BOUND and e["mean_rel"] < KERNEL_REL_BOUND,
              f"{name} {o} disagrees with the plain backward: {e}")
    return dict(max_abs_err=max(e["max_abs_err"] for e in errs.values()), ms=k_ms,
                plain_ms=p_ms, library_ms=None, **b)


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
         (rn(B, nf, D, S), rn(D, D, std=0.02), rn(D, std=0.02), rn(B, nf, S, D)), (0, 3)),
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
        leaves = [a.detach().clone().requires_grad_(i in wrt) for i, a in enumerate(args)]
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

    cpu_cfg, gpu_cfg = _small_config(torch.float32), _small_config(torch.bfloat16)
    ref = build_cascade(cpu_cfg, "cpu", seed=5)
    model = build_cascade(gpu_cfg, "cuda", seed=5)
    model.load_state_dict(ref.state_dict(), strict=True)
    batch = _small_batch(cpu_cfg)
    names = ["cat", "owl", "bat", "moth", "slug"]
    out = []
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

    enc, layers = cfg.encoder, cfg.clip.vision_layers
    n_glob = len(enc.global_attn_indexes)
    n_win = enc.depth - n_glob
    expected = {  # per step: one SAM encoder and one CLIP pass forward, SAM's backward
        "linear_act": 2 * steps,
        "ln_linear_act_bt": (2 * n_win + layers) * steps,
        "ln_mask_linear_bt": n_glob * steps,
        "flash_qkv_packed_windows_s": n_win * steps,
        "flash_qkv_packed_edge": n_win * steps,
        "flash_qkv_packed_global": n_glob * steps,
        "flash_qkv_packed_plain": layers * steps,
        "proj_rows": (2 * n_win + n_glob + layers) * steps,
        # + the text tower once
        "ln_mlp_residual_bt": cfg.clip.transformer_layers + (2 * n_win + n_glob + layers) * steps,
        "ln_mlp_residual_bt_bwd": (2 * n_win + n_glob) * steps,
        "flash_qkv_packed_windows_s_bwd": n_win * steps,
        "flash_qkv_packed_global_bwd": n_glob * steps,
        "flash_attention_relpos": 0,
        "flash_attention_fullk": 0,
    }
    log(f"[train_slice] kernel launches {counts} expected {expected}")
    check(counts == expected, f"train launch counts {counts} != expected {expected}")
    st = run["step_seconds"]
    log(f"[train_slice] step wall times (s) {[round(x, 4) for x in st]}; median after the "
        f"first {np.median(st[1:]) * 1000:.1f} ms; CLI wall {wall:.1f} s; peak device memory "
        f"{peak:.2f} GiB (torch.cuda.max_memory_allocated)")
    train_times(run)
    return counts


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


def phase_unfused():
    """Depth-cut encoders at full width on the unfused paths, each against
    'reference' on the same bf16 weights: SAM ViT-B on 'flash' (12 heads x
    64: #10 in its windowed and its global block) and SAM ViT-H on
    'aug_flash' (#20 in the global block, plain attention_xla in the
    windowed one)."""
    import torch
    from camouflaged_vlm_tpu_torch.config import cascade_config_from_yaml
    from camouflaged_vlm_tpu_torch.factory import cast_weights_, init_random_
    from camouflaged_vlm_tpu_torch.models import ImageEncoderViT
    from camouflaged_vlm_tpu_torch.ops import _cuda

    vit_b = cascade_config_from_yaml(VIT_B_YAML)[0].encoder
    vit_h = cascade_config_from_yaml(VIT_H_YAML)[0].encoder
    x = torch.from_numpy(
        np.random.default_rng(12).standard_normal((1, 1024, 1024, 3)).astype(np.float32)
    ).cuda()
    for label, base, impl, kernel in (("ViT-B", vit_b, "flash", "flash_attention_relpos"),
                                      ("ViT-H", vit_h, "aug_flash", "flash_attention_fullk")):
        kw = dict(dtype=torch.bfloat16, depth=2, global_attn_indexes=(1,))
        encs = {}
        for name in (impl, "reference"):
            with torch.device("meta"):
                enc = ImageEncoderViT(dataclasses.replace(base, attn_impl=name, **kw))
            enc = enc.to_empty(device="cuda")
            init_random_(enc, torch.Generator(device="cuda").manual_seed(13))
            with torch.no_grad():  # rel-pos tables large enough for the bias to matter
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
              f"unfused: non-finite {label} {impl} output")
        e, ei = errors(got, want), errors(got_i[0], want_i[0])
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
        del encs, got, want, got_i, want_i
        torch.cuda.empty_cache()


def eval_expected(cfg, calls):
    """Launch counts of `calls` cascade calls of the evaluate CLI, whose text
    tower runs once, by the configuration's SAM path."""
    enc, layers = cfg.encoder, cfg.clip.vision_layers
    n_glob = len(enc.global_attn_indexes)
    n_win = enc.depth - n_glob
    fused = enc.attn_impl == "flash" and enc.num_heads % 8 == 0
    sam = {  # per call: the fused SAM kernels, or the split-q/k/v attention
        "ln_linear_act_bt": 2 * n_win if fused else 0,
        "ln_mask_linear_bt": n_glob if fused else 0,
        "flash_qkv_packed_windows_s": n_win if fused else 0,
        "flash_qkv_packed_edge": n_win if fused else 0,
        "flash_qkv_packed_global": n_glob if fused else 0,
        "proj_rows": 2 * n_win + n_glob if fused else 0,
        "ln_mlp_residual_bt": 2 * n_win + n_glob if fused else 0,
        "flash_attention_relpos": enc.depth if enc.attn_impl == "flash" and not fused else 0,
        "flash_attention_fullk": n_glob if enc.attn_impl == "aug_flash" else 0,
    }
    clip = {"ln_linear_act_bt": 2 * layers, "flash_qkv_packed_plain": 2 * layers,
            "proj_rows": 2 * layers, "ln_mlp_residual_bt": 2 * layers}
    out = {k: 0 for k in ("ln_mlp_residual_bt_bwd", "flash_qkv_packed_windows_s_bwd",
                          "flash_qkv_packed_global_bwd")}
    out["linear_act"] = 2 * calls  # SAM patch embed + EVP handcrafted embed
    for k in set(sam) | set(clip):
        out[k] = (sam.get(k, 0) + clip.get(k, 0)) * calls
    out["ln_mlp_residual_bt"] += cfg.clip.transformer_layers  # the text tower, once
    return out


def phase_eval_slice():
    """The evaluate CLI at full width on three configurations: 5 synthetic
    test images of mixed sizes (the 61 test classes), batch 2, bf16."""
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
    for label in ("vit_h_flash", "vit_b_flash", "vit_h_aug_flash"):
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
        expected = eval_expected(cfg, calls)
        log(f"[eval_slice] {label}: SAM {cfg.encoder.embed_dim} wide x {cfg.encoder.depth}, "
            f"{cfg.encoder.num_heads} heads, {cfg.encoder.attn_impl!r}; images_per_sec "
            f"{res['images_per_sec']} (3 batches + metric drain: a smoke figure with no steady "
            f"state; cli/eval_throughput.py measures the rate); CLI wall "
            f"{wall:.1f} s (build, text encode, warm-up included); peak device memory "
            f"{peak:.2f} GiB (torch.cuda.max_memory_allocated); sm {res['sm']} ori_sm "
            f"{res['ori_sm']} accuracy {res['accuracy']}")
        log(f"[eval_slice] {label} kernel launches {counts} expected {expected}")
        check(counts == expected, f"eval_slice {label}: launch counts {counts} != {expected}")
        runs[label] = dict(counts=counts, images_per_sec=res["images_per_sec"], peak_gib=peak)
        config_stage_times(cfg, label)
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


def config_stage_times(cfg, label):
    """`stage_times` of a configuration's cascade at batch 2 (seeded random
    weights, rel cache attached, the 61 classes' text features)."""
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
    batch = tuple(torch.from_numpy(np.stack(a)).cuda() for a in (
        [sam_image_transform(im, cfg.inp_size) for im in images],
        [clip_image_transform(im, cfg.clip_size) for im in images],
        [clip_ones_alpha(cfg.clip_size) for _ in images]))
    stage_times(model, cfg, tf, {2: batch}, label=f" {label}")
    del model


def main() -> None:
    name, smi = phase_device()
    phase_build()
    results = phase_kernels()
    phase_small()
    phase_vit_h()
    counts = phase_slice()
    grads = phase_grads()
    phase_train_small()
    train_counts = phase_train_slice()
    phase_unfused()
    evals = phase_eval_slice()
    import torch

    # launches: each kernel's count in the run of its own main path (the
    # split-q/k/v kernels' from their eval-slice configuration)
    launches = {**counts, **{k: train_counts[k] for k in grads},
                "flash_attention_relpos": evals["vit_b_flash"]["counts"]["flash_attention_relpos"],
                "flash_attention_fullk": evals["vit_h_aug_flash"]["counts"]["flash_attention_fullk"]}
    kernels = [
        {"name": k, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for res in (results, grads) for k, r in res.items()
    ]
    check(len(kernels) == 14 and all(e["launches"] > 0 for e in kernels),
          f"kernels line: {[(e['name'], e['launches']) for e in kernels]}")
    log("[device] name and power limit (nvidia-smi) of the card all numbers above ran on:")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
