"""Steady-state throughput of the evaluate CLI, beside what bounds it.

Writes a synthetic OVCamo-layout test split of `--images` images (the 61
OVCamo test classes in turn; 16 image sizes drawn from `--seed` between 500
and 1400 px a side, the range the JAX package's `scripts/eval_throughput.py`
takes for OVCamo), then for each configuration and batch size:

  * runs `cli.evaluate.main` on the split: its `images_per_sec` (the first
    timed batch to the drained metric pool) and the peak device memory;
  * times the cascade call alone at that batch on the same configuration
    (median of `--iters` synchronised calls): the rate the device allows;
  * runs the CLI's host work alone, once per batch size and input size: the
    loader (decode + resize, 8 threads) feeding `evaluate.score_image` in an
    8-thread pool, with a fixed probability map in place of the model's.

With `--preproc PIL native ...` each configuration and batch size runs the
CLI and the host work alone once a word, in that order, with the host
preprocessing that word names (CVLM_NATIVE_PREPROC set for the run); without
it, once with whatever the environment chooses.

One JSON line {"eval_throughput": {...}} per run; all of them also go to
<out>/eval_throughput.json. The split is deleted at the end.

  python -m camouflaged_vlm_tpu_torch.cli.eval_throughput --images 300 --batch-sizes 2 4
  python -m camouflaged_vlm_tpu_torch.cli.eval_throughput --images 300 --batch-sizes 2 \
      --configs vit_h_flash --preproc PIL native native PIL
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import yaml

from ..data import native
from ..data.loader import iter_eval_batches
from ..data.ovcamo import TEST_CLASS_NAMES, OVCamoIndex
from ..data.synthetic import write_synthetic_ovcamo
from ..factory import attach_rel_cache, build_cascade, make_bank_inputs
from ..metrics import CODMetrics, OVCOSMetricer
from . import evaluate
from .common import cascade_config, device_or_raise, preproc_line

_PKG = Path(__file__).resolve().parents[1]
VIT_H_YAML = _PKG.parent / "configs" / "ovcos-sam-vit-h-maskdecoder-edge.yaml"
VIT_B_YAML = _PKG / "configs" / "ovcos-sam-vit-b-maskdecoder-edge.yaml"
# name -> (yaml, attn_impl override); None is the built-in tiny configuration
CONFIGS = {
    "vit_h_flash": (VIT_H_YAML, None),
    "vit_b_flash": (VIT_B_YAML, None),
    "vit_h_aug_flash": (VIT_H_YAML, "aug_flash"),
    "tiny": (None, None),
}
# the evaluate CLI's loader threads and metric pool
NUM_WORKERS = 8


def config_args(name: str, work: str) -> list:
    """The evaluate CLI's `--config`/`--tiny` arguments for `name`; an
    attn_impl override is written as a yaml under `work`."""
    path, impl = CONFIGS[name]
    if path is None:
        return ["--tiny"]
    if impl is None:
        return ["--config", str(path)]
    raw = yaml.safe_load(open(path))
    raw["model"]["encoder"]["attn_impl"] = impl
    out = os.path.join(work, f"{name}.yaml")
    with open(out, "w") as f:
        yaml.safe_dump(raw, f)
    return ["--config", out]


@torch.no_grad()
def cascade_call_ms(cfg, classes, batch: int, device, iters: int, seed: int) -> float:
    """Median wall time (ms) of one synchronised cascade call at `batch` on
    seeded random weights, the rel cache attached, the classes' text
    features encoded once."""
    model = attach_rel_cache(build_cascade(cfg, device, seed))
    bank = make_bank_inputs(cfg, classes, seed=seed, device=device)
    tf = model.encode_class_text_features(bank["prefix"], bank["suffix"], bank["eot_indices"],
                                          bank["bank_features"])
    # fp32 inputs, as the CLI normalises them on the device
    inp = torch.zeros((batch, cfg.inp_size, cfg.inp_size, 3), device=device)
    cimg = torch.zeros((batch, cfg.clip_size, cfg.clip_size, 3), device=device)
    cmask = torch.ones((batch, cfg.clip_size, cfg.clip_size, 1), device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    times = []
    for i in range(iters + 2):  # two warm-up calls
        t0 = time.perf_counter()
        model.infer_cascade_with_text(inp, cimg, cmask, tf)
        sync()
        if i >= 2:
            times.append(1e3 * (time.perf_counter() - t0))
    del model
    return float(np.median(times))


def host_only_rate(index: OVCamoIndex, cfg, batch: int) -> float:
    """Images/s of the CLI's host work with no model: the loader's batches,
    each image scored by `evaluate.score_image` in the CLI's bounded metric
    pool against a fixed probability map (0.8 x its target + 0.1)."""
    cod = CODMetrics()
    metricer = OVCOSMetricer(class_names=index.classes, num_workers=NUM_WORKERS)
    futures: deque = deque()
    n = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=NUM_WORKERS) as pool:
        for b in iter_eval_batches(index, batch, cfg.inp_size, cfg.clip_size, NUM_WORKERS,
                                   raw_uint8=True):
            for s in b:
                prob = (0.8 * s.gt[:, :, 0] + 0.1).astype(np.float32)
                futures.append(pool.submit(evaluate.score_image, cod, metricer, prob, s,
                                           s.label_name))
                if len(futures) > 4 * NUM_WORKERS:
                    futures.popleft().result()
            n += len(b)
        while futures:
            futures.popleft().result()
    metricer.show()
    return n / (time.perf_counter() - t0)


def one_run(args, device, info, index, cfg, cfg_args, name, batch, label,
            host_rates) -> dict:
    """The evaluate CLI on the split and the host work alone (cached in
    `host_rates` by input size and batch), with the host preprocessing
    the environment chooses."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = evaluate.main(["--dataset-info", info, *cfg_args, "--device", args.device,
                         "--dtype", args.dtype, "--batch-size", str(batch),
                         "--seed", str(args.seed), "--output-dir",
                         os.path.join(args.out, f"{name}_b{batch}{label}")])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if device.type == "cuda" else None
    key = (cfg.inp_size, cfg.clip_size, batch)
    if key not in host_rates:
        host_rates[key] = host_only_rate(index, cfg, batch)
    return {"config": name, "attn_impl": cfg.encoder.attn_impl,
            "sam_width": cfg.encoder.embed_dim, "sam_depth": cfg.encoder.depth,
            "batch": batch, "images": res["images"],
            "images_per_sec": res["images_per_sec"], "cli_wall_s": wall,
            "peak_gib": peak, "host_only_images_per_sec": host_rates[key],
            "host_preproc": "native" if native.enabled() else "PIL",
            "preproc_status": native.status(), "cpus": os.cpu_count()}


def parse_args(argv: Sequence[str] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--images", type=int, default=300)
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[2, 4])
    p.add_argument("--configs", nargs="+", choices=sorted(CONFIGS),
                   default=["vit_h_flash", "vit_b_flash", "vit_h_aug_flash"])
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--iters", type=int, default=5, help="timed cascade calls per run")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--work", default=os.path.join("build", "eval_throughput"),
                   help="where the synthetic split is written (deleted at the end)")
    p.add_argument("--out", default=os.path.join("chiprun_out", "eval_throughput"))
    p.add_argument("--preproc", nargs="+", choices=("native", "PIL"),
                   help="one run a word with that host preprocessing, in this order")
    return p.parse_args(argv)


def preproc_runs(modes):
    """(label, CVLM_NATIVE_PREPROC value or None) a run: one run under the
    environment as it is without `modes`, else one a word of `modes`."""
    if not modes:
        return [("", None)]
    return [(f"_{m}{i}", "1" if m == "native" else "0") for i, m in enumerate(modes)]


def main(argv: Sequence[str] = None) -> list:
    args = parse_args(argv)
    device = device_or_raise(args.device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    print(preproc_line("eval_throughput"), flush=True)
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    sizes = [(int(h), int(w)) for h, w in rng.integers(500, 1400, (16, 2))]
    info = write_synthetic_ovcamo(os.path.join(args.work, "ovcamo"), n_train=0,
                                  n_test=args.images, seed=args.seed,
                                  test_classes=tuple(TEST_CLASS_NAMES), sizes=sizes)
    index = OVCamoIndex.from_dataset_info(yaml.safe_load(open(info)), "test")
    host_rates: dict = {}
    rows = []
    for name in args.configs:
        cfg_args = config_args(name, args.work)
        cfg = cascade_config(cfg_args[1] if cfg_args[0] == "--config" else None,
                             cfg_args[0] == "--tiny", args.dtype)
        for batch in args.batch_sizes:
            call_ms = cascade_call_ms(cfg, index.classes, batch, device, args.iters, args.seed)
            for label, switch in preproc_runs(args.preproc):
                before = os.environ.get(native.ENV_SWITCH)
                if switch is not None:
                    os.environ[native.ENV_SWITCH] = switch
                try:
                    row = one_run(args, device, info, index, cfg, cfg_args, name, batch,
                                  label, host_rates if switch is None else {})
                finally:
                    os.environ.pop(native.ENV_SWITCH, None)
                    if before is not None:
                        os.environ[native.ENV_SWITCH] = before
                row.update(cascade_call_ms=call_ms, device_only_images_per_sec=1e3 * batch
                           / call_ms)
                print(json.dumps({"eval_throughput": row}), flush=True)
                rows.append(row)
    with open(os.path.join(args.out, "eval_throughput.json"), "w") as f:
        json.dump(rows, f, indent=2)
    shutil.rmtree(args.work)
    return rows


if __name__ == "__main__":
    main()
