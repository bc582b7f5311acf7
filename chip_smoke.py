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
              to the JAX package)
  5. slice    the full-width cascade (SAM ViT-H at 1024 px with reference
              attention, the edge decoder, MaPLe Alpha-CLIP ViT-L/14@336, the
              61 OVCamo test classes) in bf16 from seeded random weights,
              driven through the demo CLI's session: text features encoded
              once, three requests at batch 1, one at batch 2. Outputs are
              checked, and every kernel's launch count must match the path.

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


def phase_kernels():
    """Each kernel vs its plain version at full-width bf16 shapes (batch 2)."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    B, S, W = 2, 581, 1024
    ln_g, ln_b = 1 + rn(W, std=0.1, dtype=torch.float32), rn(W, std=0.1, dtype=torch.float32)
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
    ]
    # the text tower's MLP shape is on the path too (checked, not timed)
    text_mlp = (rn(61, 77, 768), 1 + rn(768, std=0.1, dtype=torch.float32),
                rn(768, std=0.1, dtype=torch.float32), rn(3072, 768, std=0.02),
                rn(3072, std=0.02), rn(768, 3072, std=0.02), rn(768, std=0.02))
    results = {}
    with torch.no_grad():
        for name, source, replaces, kfn, pfn, args in cases:
            got = kfn(*args)
            torch.cuda.synchronize()
            want = pfn(*args)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name}: {got.shape}/{got.dtype} vs plain {want.shape}/{want.dtype}")
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
            e = errors(got, want)
            k_ms, p_ms = time_ms(lambda: kfn(*args)), time_ms(lambda: pfn(*args))
            log(f"[kernel] {name:24s} shape {tuple(got.shape)} max_abs {e['max_abs_err']:.3e} "
                f"max_rel {e['max_rel']:.3e} mean_rel {e['mean_rel']:.3e} "
                f"(bound {KERNEL_REL_BOUND}) kernel {k_ms:.4f} ms plain {p_ms:.4f} ms")
            check(e["max_rel"] < KERNEL_REL_BOUND and e["mean_rel"] < KERNEL_REL_BOUND,
                  f"{name} disagrees with its plain version: {e}")
            results[name] = dict(source=source, replaces=replaces,
                                 max_abs_err=e["max_abs_err"], ms=k_ms, plain_ms=p_ms)
        got = lin.ln_mlp_residual_bt(*text_mlp, eps=1e-5, activation="quick_gelu")
        want = lin.ln_mlp_residual_bt_ref(*text_mlp, eps=1e-5, activation="quick_gelu")
        e = errors(got, want)
        log(f"[kernel] ln_mlp_residual_bt (text 61x77x768) max_abs {e['max_abs_err']:.3e} "
            f"max_rel {e['max_rel']:.3e} mean_rel {e['mean_rel']:.3e}")
        check(e["max_rel"] < KERNEL_REL_BOUND and e["mean_rel"] < KERNEL_REL_BOUND,
              f"ln_mlp_residual_bt (text shape) disagrees: {e}")
    return results


def _small_config(dtype):
    import dataclasses

    from camouflaged_vlm_tpu_torch.models import CascadeConfig
    from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig

    # widths the kernels take: CLIP 128 wide (8 heads x 16), text 128 (4 x 32)
    clip = AlphaClipConfig.tiny(dtype=dtype, vision_width=128, vision_heads=8,
                                transformer_width=128)
    return dataclasses.replace(CascadeConfig.tiny(dtype=dtype), clip=clip)


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
    log(f"[small] bf16 card vs fp32 CPU: probs max_abs {dp:.3e} (bound {SMALL_PROB_ABS_BOUND}), "
        f"logits max_rel {dl:.3e} (bound {SMALL_LOGIT_REL_BOUND}), "
        f"pred {y.tolist()} vs {y_ref.tolist()}")
    check(dp < SMALL_PROB_ABS_BOUND, f"small cascade probabilities differ by {dp}")
    check(dl < SMALL_LOGIT_REL_BOUND, f"small cascade logits differ by {dl}")


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
    expected = {
        "linear_act": 2 * calls,  # SAM patch embed + EVP handcrafted embed
        "ln_linear_act_bt": 2 * layers * calls,
        "flash_qkv_packed_plain": 2 * layers * calls,
        "proj_rows": 2 * layers * calls,
        # text tower once (12 layers) + the vision MLPs
        "ln_mlp_residual_bt": cfg.clip.transformer_layers + 2 * layers * calls,
    }
    log(f"[slice] kernel launches {counts} expected {expected}")
    check(counts == expected, f"launch counts {counts} != expected {expected}")
    return counts


def main() -> None:
    name, _ = phase_device()
    phase_build()
    results = phase_kernels()
    phase_small()
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
