"""End-to-end cascade throughput on one GPU: the eager call against one
CUDA graph per batch size.

Counterpart of the repository's root `bench.py` (the JAX bench, which times
one jitted `infer_cascade_with_text` per batch on a TPU). Measures images/s
through the whole cascade at 1024 px (SAM ViT-H encoder + CLIP pass 1 with
the all-ones alpha + edge mask decoder + mask upsample + alpha handoff +
CLIP pass 2), built in bf16 from seeded random weights, the rel-pos tables
attached and the 61 class-text features encoded once outside the timed
call. Each batch size is timed twice in the same process: the eager call,
and the same call captured as one CUDA graph (`graphs.GraphedCall`),
inputs copied into its static buffers at every replay.

Per batch: steady-state seconds per call (`--iters` calls enqueued back to
back after `--warmup`, one synchronise at the end), the latency of one
call (median of `--iters` synchronised calls), the graph's capture time
and the launches captured, the peak device memory of the batch's calls
(`torch.cuda.max_memory_allocated`, the weights included) and how far the
graph's outputs lie from the eager call's on the same inputs.

Prints JSON lines: one {"per_batch_update": {B: {...}}} the moment each
batch finishes (sweep order 8, 1, 32, then 2, 4), then the headline last:
the best graphed images/s and its batch, the eager rate there, the batch-1
latency, achieved TFLOP/s (`cascade_flops_per_image`) and MFU against the
H100 SXM's 989 TFLOP/s dense bf16 peak, the peak and reserved device memory
(reserved with every batch's graph alive in one shared memory pool, the
eager calls' cached blocks released), and the card's name and power limit
from `nvidia-smi`.

Usage (on the card; `--device cpu --tiny` runs the same code on the CPU,
where nothing is graphed and no device number is reported):
  python -m camouflaged_vlm_tpu_torch.cli.bench [--batches 8,1,32,2,4] \
      [--iters 10] [--warmup 2]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import DTYPES
from ..data.ovcamo import TEST_CLASS_NAMES
from ..data.transforms import ONES_ALPHA_VALUE
from ..factory import attach_rel_cache, build_cascade, make_bank_inputs
from ..graphs import GraphedCall
from .common import cascade_config, device_or_raise, refuse_fp32_on_card

SWEEP = (8, 1, 32, 2, 4)
# NVIDIA's data sheet, H100 SXM, dense bf16 at 700 W
H100_BF16_PEAK_TFLOPS = 989.0

clock = time.perf_counter


def cascade_flops_per_image() -> float:
    """Analytic forward FLOPs/image of the full cascade (multiply-add = 2):
    the port's copy of the root `bench.py`'s count (held to it by a CPU
    test).

    Counts the matmul/conv work of the timed call (both CLIP vision
    passes; the class-text encoding is hoisted out of the loop). Elementwise,
    norm, softmax and resize work is excluded. The EVP high-pass term counts
    dense circulant matmuls (~8.6 GFLOP/image), as the JAX package and the
    port both compute it.
    """
    # --- SAM ViT-H encoder @1024px: S=4096 tokens, D=1280, 32 blocks ---
    S, D, depth, heads = 64 * 64, 1280, 32, 16
    win, n_global = 14 * 14, 4
    patch_embed = 2 * S * D * (16 * 16 * 3)
    per_tok_linear = 2 * D * (3 * D) + 2 * D * D + 2 * 2 * D * (4 * D)  # qkv+proj+mlp
    blocks_linear = depth * S * per_tok_linear
    # attention score+pv dots: 4*S*K*D with K = kv length (win or S)
    attn = (depth - n_global) * 4 * S * win * D + n_global * 4 * S * S * D
    # decomposed rel-pos: per-block q against the combined tables
    relpos = depth * 2 * S * D * 128
    # EVP prompt generator: FFT high-pass as circulant matmuls over the
    # 1024^2 image + per-block lightweight MLPs
    evp = 4 * 2 * 1024**3 + depth * S * 2 * 40 * (40 + D)
    neck = 2 * S * D * 256 + 2 * 9 * S * 256 * 256
    encoder = patch_embed + blocks_linear + attn + relpos + evp + neck

    # --- Alpha-CLIP ViT-L/14@336 vision tower, TWO passes ---
    Sc, Dc, depth_c = 24 * 24 + 1 + 4, 1024, 24  # 577 tokens + 4 visual ctx
    clip_patch = 2 * (24 * 24) * Dc * (14 * 14 * 4)  # RGB + alpha convs
    clip_linear = depth_c * Sc * (2 * Dc * (3 * Dc) + 2 * Dc * Dc + 2 * 2 * Dc * (4 * Dc))
    clip_attn = depth_c * 4 * Sc * Sc * Dc
    clip_proj = 2 * Sc * Dc * 768
    clip = 2 * (clip_patch + clip_linear + clip_attn + clip_proj)

    # --- edge mask decoder + cond two-way transformer (dim 256) ---
    decoder = 6e9

    return float(encoder + clip + decoder)


def card_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def example_inputs(cfg, batch: int, device, seed: int = 0):
    """Seeded standard-normal SAM and CLIP images, (B, S, S, 3), (B, C, C, 3)
    fp32 (the root bench's `make_example_inputs`)."""
    rng = np.random.default_rng(seed)
    inp = rng.standard_normal((batch, cfg.inp_size, cfg.inp_size, 3)).astype(np.float32)
    cimg = rng.standard_normal((batch, cfg.clip_size, cfg.clip_size, 3)).astype(np.float32)
    return torch.from_numpy(inp).to(device), torch.from_numpy(cimg).to(device)


def cascade_call(model, cfg, text_features):
    """The timed function: the cascade call with the all-ones stage-1 alpha
    built inside it."""
    def call(inp, cimg):
        cmask = torch.full((inp.shape[0], cfg.clip_size, cfg.clip_size, 1), ONES_ALPHA_VALUE,
                           device=inp.device)
        return model.infer_cascade_with_text(inp, cimg, cmask, text_features)
    return call


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seconds_per_call(call, device, iters: int, warmup: int) -> float:
    """Steady state: `iters` calls enqueued back to back after `warmup`,
    one synchronise at the end."""
    for _ in range(warmup):
        call()
    _sync(device)
    t0 = clock()
    for _ in range(iters):
        call()
    _sync(device)
    return (clock() - t0) / iters


def latency_ms(call, device, iters: int) -> float:
    """The median wall of one synchronised call."""
    walls = []
    for _ in range(iters):
        _sync(device)
        t0 = clock()
        call()
        _sync(device)
        walls.append(1e3 * (clock() - t0))
    return float(np.median(walls))


def time_batch(model, cfg, text_features, batch: int, device, iters: int, warmup: int,
               pool=None, seed: int = 0) -> Dict:
    """One batch size, eager then graphed; returns its record and keeps
    the graph alive in it ("graph", removed before printing)."""
    inp, cimg = example_inputs(cfg, batch, device, seed)
    call = cascade_call(model, cfg, text_features)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        eager_s = seconds_per_call(lambda: call(inp, cimg), device, iters, warmup)
        eager_lat = latency_ms(lambda: call(inp, cimg), device, iters)
        eager_out = [t.clone() for t in call(inp, cimg)]
        t0 = clock()
        graph = GraphedCall(call, inp, cimg, pool=pool, warmup=warmup)
        _sync(device)
        capture_s = clock() - t0
        graph_s = seconds_per_call(lambda: graph(inp, cimg), device, iters, warmup)
        graph_lat = latency_ms(lambda: graph(inp, cimg), device, iters)
        graph_out = graph(inp, cimg)
        diff = {name: float((g.float() - e.float()).abs().max())
                for name, g, e in zip(("probs", "pred", "logits"), graph_out, eager_out)}
    return {
        "batch": batch,
        "device": "gpu" if cuda else "cpu",
        "graph_images_per_sec": batch / graph_s,
        "eager_images_per_sec": batch / eager_s,
        "graph_ms_per_call": 1e3 * graph_s,
        "eager_ms_per_call": 1e3 * eager_s,
        "graph_latency_ms": graph_lat,
        "eager_latency_ms": eager_lat,
        "capture_s": capture_s,
        "launches_at_capture": sum(graph.launches.values()) if graph.launches else None,
        "graph_vs_eager_max_abs": diff,
        "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
        "graph": graph,
    }


def headline(per_batch: Dict[int, Dict], dtype: str, device_info: Dict,
             flops_per_image: Optional[float], reserved_gib: Optional[float]) -> Dict:
    """The best graphed rate and the numbers beside it."""
    best = max(per_batch.values(), key=lambda r: r["graph_images_per_sec"])
    ips = best["graph_images_per_sec"]
    tflops = flops_per_image * ips / 1e12 if flops_per_image else None
    b1 = per_batch.get(1)
    peaks = [r["peak_memory_gib"] for r in per_batch.values() if r["peak_memory_gib"] is not None]
    how = "eager on the CPU" if device_info["device"] == "cpu" else "one CUDA graph per batch"
    return {
        "metric": "cascade_images_per_sec",
        "value": ips,
        "unit": f"img/s @{device_info['inp_size']}px e2e (batch {best['batch']}, {dtype}, {how})",
        "batch": best["batch"],
        "eager_images_per_sec": best["eager_images_per_sec"],
        "latency_ms_batch1": b1["graph_latency_ms"] if b1 else None,
        "eager_latency_ms_batch1": b1["eager_latency_ms"] if b1 else None,
        "achieved_tflops": tflops,
        "mfu": tflops / H100_BF16_PEAK_TFLOPS if tflops is not None else None,
        "peak_memory_gib": max(peaks) if peaks else None,
        "memory_reserved_gib": reserved_gib,
        "device": device_info["device"],
        "card": device_info["card"],
    }


def parse_args(argv: Sequence[str] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", default=",".join(map(str, SWEEP)),
                   help="batch sizes in sweep order")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke test; no FLOP count)")
    return p.parse_args(argv)


def main(argv: Sequence[str] = None) -> Dict:
    args = parse_args(argv)
    cfg = cascade_config(None, args.tiny, args.dtype)
    refuse_fp32_on_card(args.device, cfg)
    device = device_or_raise(args.device)
    model = build_cascade(cfg, device, args.seed)
    attach_rel_cache(model)
    bank = make_bank_inputs(cfg, TEST_CLASS_NAMES, seed=args.seed, device=device)
    text_features = model.encode_class_text_features(
        bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"])
    cuda = device.type == "cuda"
    pool = torch.cuda.graph_pool_handle() if cuda else None
    per_batch: Dict[int, Dict] = {}
    graphs: List[GraphedCall] = []
    for b in (int(x) for x in args.batches.split(",")):
        rec = time_batch(model, cfg, text_features, b, device, args.iters, args.warmup,
                         pool=pool, seed=args.seed)
        graphs.append(rec.pop("graph"))
        per_batch[b] = rec
        print(json.dumps({"per_batch_update": {b: rec}}), flush=True)
    if cuda:  # what the graphs hold, without the eager calls' cached blocks
        torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device) / 2**30 if cuda else None
    info = {"inp_size": cfg.inp_size, "device": "gpu" if cuda else "cpu",
            "card": card_name_and_power() if cuda else None}
    result = headline(per_batch, args.dtype, info,
                      None if args.tiny or not cuda else cascade_flops_per_image(), reserved)
    print(json.dumps(result), flush=True)
    del graphs
    return {"per_batch": per_batch, "headline": result}


if __name__ == "__main__":
    main()
