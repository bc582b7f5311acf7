#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

  python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases, each of which raises on failure (the script then exits non-zero and
never prints its last line):

  1. device   the card's name and power limit (nvidia-smi); no CUDA -> error
  2. build    nvcc builds the port's kernels (csrc/*.cu) for sm_90a
  3. kernels  each kernel against its plain PyTorch version at the main
              path's full-width bf16 shapes, with errors and times (median
              of CUDA-event timings after a warm-up)
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

Before its last line it prints one JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}. Longer logs go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import json
import os
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
    for line in info.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")


def _check_kernel(name, kfn, pfn, args, timed=True):
    """Kernel against its plain version on the same inputs: shape, type,
    finite, within KERNEL_REL_BOUND; times (kernel, plain) in ms."""
    import torch

    got = kfn(*args)
    torch.cuda.synchronize()
    want = pfn(*args)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {got.shape}/{got.dtype} vs plain {want.shape}/{want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    e = errors(got, want)
    del got, want
    k_ms = time_ms(lambda: kfn(*args)) if timed else float("nan")
    p_ms = time_ms(lambda: pfn(*args)) if timed else float("nan")
    log(f"[kernel] {name:40s} max_abs {e['max_abs_err']:.3e} max_rel {e['max_rel']:.3e} "
        f"mean_rel {e['mean_rel']:.3e} (bound {KERNEL_REL_BOUND}) kernel {k_ms:.4f} ms "
        f"plain {p_ms:.4f} ms")
    check(e["max_rel"] < KERNEL_REL_BOUND and e["mean_rel"] < KERNEL_REL_BOUND,
          f"{name} disagrees with its plain version: {e}")
    return dict(max_abs_err=e["max_abs_err"], ms=k_ms, plain_ms=p_ms)


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
    cases = [
        # (name, source, replaces, kernel fn, plain fn, args)
        ("linear_act", "camouflaged_vlm_tpu_torch/csrc/ln_linear.cu",
         "camouflaged_vlm_tpu/ops/linear.py:61",
         lin.linear_act, lin.linear_act_ref,
         (rn(B * 4096, 768), rn(1280, 768, std=0.02), rn(1280, std=0.02))),
        ("ln_linear_act_bt", "camouflaged_vlm_tpu_torch/csrc/ln_linear.cu",
         "camouflaged_vlm_tpu/ops/linear.py:143",
         lambda *a: lin.ln_linear_act_bt(*a, eps=1e-5, activation=None),
         lambda *a: lin.ln_linear_act_bt_ref(*a, eps=1e-5, activation=None),
         (rn(B, S, W), ln_g, ln_b, rn(3 * W, W, std=0.02), rn(3 * W, std=0.02))),
        ("ln_mask_linear_bt", "camouflaged_vlm_tpu_torch/csrc/ln_linear.cu",
         "camouflaged_vlm_tpu/ops/linear.py:228",
         lambda *a: lin.ln_mask_linear_bt(*a, eps=1e-6),
         lambda *a: lin.ln_mask_linear_bt_ref(*a, eps=1e-6),
         (rn(B, G * G, D), sg, sb, torch.ones(1, G * G, 1, dtype=bf, device=dev), w_qkv,
          b_qkv)),
        ("ln_mlp_residual_bt", "camouflaged_vlm_tpu_torch/csrc/ln_mlp_residual.cu",
         "camouflaged_vlm_tpu/ops/linear.py:416",
         lambda *a: lin.ln_mlp_residual_bt(*a, eps=1e-5, activation="quick_gelu"),
         lambda *a: lin.ln_mlp_residual_bt_ref(*a, eps=1e-5, activation="quick_gelu"),
         (rn(B, S, W), ln_g, ln_b, rn(4 * W, W, std=0.02), rn(4 * W, std=0.02),
          rn(W, 4 * W, std=0.02), rn(W, std=0.02))),
        ("proj_rows", "camouflaged_vlm_tpu_torch/csrc/proj_rows.cu",
         "camouflaged_vlm_tpu/ops/linear.py:665",
         lin.proj_rows, lin.proj_rows_ref,
         (rn(B, 1, W, S), rn(W, W, std=0.02), rn(W, std=0.02), rn(B, 1, S, W))),
        ("flash_qkv_packed_plain", "camouflaged_vlm_tpu_torch/csrc/qkv_packed_plain.cu",
         "camouflaged_vlm_tpu/ops/flash_attention.py:875",
         lambda q: fa.flash_qkv_packed_plain(q, 64 ** -0.5, 16, 64),
         lambda q: fa.flash_qkv_packed_plain_ref(q, 64 ** -0.5, 16, 64),
         (rn(B, S, 3 * W),)),
        ("flash_qkv_packed_windows_s", "camouflaged_vlm_tpu_torch/csrc/qkv_packed_windows.cu",
         "camouflaged_vlm_tpu/ops/flash_attention.py:519",
         lambda *a: fa.flash_qkv_packed_windows_s(*a, sam_scale, NH, HD),
         lambda *a: fa.flash_qkv_packed_windows_s_ref(*a, sam_scale, NH, HD),
         (rn(B * nf, WIN * WIN, 3 * D), rn(WIN * WIN, B * nf, NH * 32),
          fa.make_rel_scatter32(WIN, bf, dev))),
        ("flash_qkv_packed_edge", "camouflaged_vlm_tpu_torch/csrc/qkv_packed_windows.cu",
         "camouflaged_vlm_tpu/ops/flash_attention.py:755",
         lambda *a: fa.flash_qkv_packed_edge(*a, sam_scale, NH, HD),
         lambda *a: fa.flash_qkv_packed_edge_ref(*a, sam_scale, NH, HD),
         (rn(B, ne, R, 3 * D), edge_rel.reshape(B, ne, R, NH * 32), sel_e,
          rn(NH, HD, std=0.5), kmask_e)),
        ("flash_qkv_packed_global", "camouflaged_vlm_tpu_torch/csrc/qkv_packed_global.cu",
         "camouflaged_vlm_tpu/ops/flash_attention.py:1083",
         lambda *a: fa.flash_qkv_packed_global(*a, sam_scale, NH, HD, G, G),
         lambda *a: fa.flash_qkv_packed_global_ref(*a, sam_scale, NH, HD),
         (rn(B, G * G, 3 * D), rn(G * G, B, NH, 2 * G), fa.make_rel_scatter(G, G, bf, dev))),
    ]
    # the same kernels at SAM's shapes where the JSON line holds the CLIP one
    sam_cases = [
        ("ln_linear_act_bt (SAM windows 32x196x1280 -> 3840)",
         lambda *a: lin.ln_linear_act_bt(*a, eps=1e-6, activation=None),
         lambda *a: lin.ln_linear_act_bt_ref(*a, eps=1e-6, activation=None),
         (rn(B * nf, WIN * WIN, D), sg, sb, w_qkv, b_qkv)),
        ("ln_mlp_residual_bt (SAM windows 32x196x1280, H 5120)",
         lambda *a: lin.ln_mlp_residual_bt(*a, eps=1e-6, activation="gelu_tanh"),
         lambda *a: lin.ln_mlp_residual_bt_ref(*a, eps=1e-6, activation="gelu_tanh"),
         (rn(B * nf, WIN * WIN, D), sg, sb, rn(4 * D, D, std=0.02), rn(4 * D, std=0.02),
          rn(D, 4 * D, std=0.02), rn(D, std=0.02))),
        ("ln_mlp_residual_bt (SAM global 2x4096x1280, H 5120)",
         lambda *a: lin.ln_mlp_residual_bt(*a, eps=1e-6, activation="gelu_tanh"),
         lambda *a: lin.ln_mlp_residual_bt_ref(*a, eps=1e-6, activation="gelu_tanh"),
         (rn(B, G * G, D), sg, sb, rn(4 * D, D, std=0.02), rn(4 * D, std=0.02),
          rn(D, 4 * D, std=0.02), rn(D, std=0.02))),
        ("proj_rows (SAM windows 2x16x1280x196, residual)",
         lin.proj_rows, lin.proj_rows_ref,
         (rn(B, nf, D, WIN * WIN), rn(D, D, std=0.02), rn(D, std=0.02),
          rn(B, nf, WIN * WIN, D))),
        ("proj_rows (SAM global 2x1x1280x4096, residual)",
         lin.proj_rows, lin.proj_rows_ref,
         (rn(B, 1, D, G * G), rn(D, D, std=0.02), rn(D, std=0.02), rn(B, 1, G * G, D))),
    ]
    # the text tower's MLP shape is on the path too (checked, not timed)
    text_mlp = (rn(61, 77, 768), 1 + rn(768, std=0.1, dtype=torch.float32),
                rn(768, std=0.1, dtype=torch.float32), rn(3072, 768, std=0.02),
                rn(3072, std=0.02), rn(768, 3072, std=0.02), rn(768, std=0.02))
    results = {}
    with torch.no_grad():
        for name, source, replaces, kfn, pfn, args in cases:
            results[name] = dict(source=source, replaces=replaces,
                                 **_check_kernel(name, kfn, pfn, args))
        for name, kfn, pfn, args in sam_cases:
            _check_kernel(name, kfn, pfn, args)
        _check_kernel("ln_mlp_residual_bt (text 61x77x768)",
                      lambda *a: lin.ln_mlp_residual_bt(*a, eps=1e-5, activation="quick_gelu"),
                      lambda *a: lin.ln_mlp_residual_bt_ref(*a, eps=1e-5,
                                                            activation="quick_gelu"),
                      text_mlp, timed=False)
    return results


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
    }
    log(f"[slice] kernel launches {counts} expected {expected}")
    check(counts == expected, f"launch counts {counts} != expected {expected}")
    stage_times(session, images)
    return counts


def stage_times(session, images, iters=5):
    """The cascade call (`infer_cascade_with_text`) cut into its stages,
    CUDA events between them, median of `iters` calls at batch 1 and 2."""
    import torch
    from camouflaged_vlm_tpu_torch.ops.resize import resize_bilinear

    m, cfg, tf = session.model, session.cfg, session.text_features
    names = ["SAM encoder (flash)", "CLIP pass 1", "decoder + upsample",
             "sigmoid + alpha resize", "CLIP pass 2"]
    for bs in (1, 2):
        inp, cimg, cmask = session.preprocess(images[:bs])
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
                masks = m._decode(feats, m._sparse_embeddings(ifeat, tfeat))
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
        log(f"[stages] batch {bs} (median of {iters}, ms): {parts}; sum {med[:-1].sum():.2f}; "
            f"wall of the call {med[-1]:.2f}")


def main() -> None:
    name, _ = phase_device()
    phase_build()
    results = phase_kernels()
    phase_small()
    phase_vit_h()
    counts = phase_slice()
    import torch

    kernels = [
        {"name": k, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": counts[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for k, r in results.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
