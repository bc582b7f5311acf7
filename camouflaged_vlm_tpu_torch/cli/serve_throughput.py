"""The serving engine's ceiling on one GPU, without the network.

Counterpart of the `--engine-only` mode of the repository's
`scripts/serve_throughput.py`: the full-width cascade (bf16, seeded random
weights, the 61 OVCamo test classes) behind `serve.InferenceEngine`,
warmed up (one CUDA graph per bucket), then driven by `serve.bench_engine`
with each bucket's inputs staged on the device once and, by default, the
classification-only program (`return_mask=False`; `--engine-mask` keeps the
mask and its download). Beside the engine's images/s, the program-only rate
of the largest bucket: its graph replayed 8 times back to back, the pred
output read back once at the end as the barrier.

Prints one JSON line {"serve_engine_only": {...}} with the card's name and
power limit from `nvidia-smi` (None on the CPU).

Usage:
  python -m camouflaged_vlm_tpu_torch.cli.serve_throughput \
      [--requests 192] [--buckets 32] [--max-delay-ms 5]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Sequence

import torch

from ..config import DTYPES
from ..data.ovcamo import TEST_CLASS_NAMES
from ..factory import build_cascade, make_bank_inputs
from ..serve import InferenceEngine, ServeConfig, bench_engine
from .bench import card_name_and_power
from .common import cascade_config, device_or_raise, exact_fp32_on_card, refuse_fp32_on_card


def parse_args(argv: Sequence[str] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke test)")
    p.add_argument("--requests", type=int, default=192, help="timed requests")
    p.add_argument("--buckets", default="32")
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--max-inflight", type=int, default=2)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--mask-dtype", default="uint8", choices=["uint8", "float16"])
    p.add_argument("--engine-mask", action="store_true",
                   help="keep the mask output in the program (its download is then "
                   "on the clock)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def program_only_images_per_sec(engine: InferenceEngine, iters: int = 8) -> float:
    """The largest bucket's program replayed `iters` times back to back on
    the engine's device, its pred output read back once at the end."""
    b = engine.serve_cfg.buckets[-1]
    with engine._graph_lock:
        program = engine._graph_for(b)
        cfg, dev = engine.cfg, engine.device
        inp = torch.zeros((b, cfg.inp_size, cfg.inp_size, 3), dtype=torch.uint8, device=dev)
        cimg = torch.zeros((b, cfg.clip_size, cfg.clip_size, 3), dtype=torch.uint8, device=dev)
        pred_index = 1 if engine.serve_cfg.return_mask else 0
        program(inp, cimg)[pred_index].cpu()  # warm + barrier
        t0 = time.perf_counter()
        for _ in range(iters):
            outs = program(inp, cimg)
        outs[pred_index].cpu()
        return iters * b / (time.perf_counter() - t0)


def main(argv: Sequence[str] = None) -> Dict:
    args = parse_args(argv)
    cfg = cascade_config(None, args.tiny, args.dtype)
    refuse_fp32_on_card(args.device, cfg)
    device = device_or_raise(args.device)
    exact_fp32_on_card(args.device, cfg)
    model = build_cascade(cfg, device, args.seed)
    bank = make_bank_inputs(cfg, TEST_CLASS_NAMES, seed=args.seed, device=device)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    engine = InferenceEngine(model, cfg, bank, TEST_CLASS_NAMES, ServeConfig(
        buckets=buckets, max_delay_ms=args.max_delay_ms, mask_dtype=args.mask_dtype,
        max_inflight=args.max_inflight, return_mask=args.engine_mask))
    try:
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        # an untimed lead-in primes the pipeline and the staging cache's path
        bench_engine(engine, n_images=2 * buckets[-1], stage_inputs=True, seed=args.seed)
        rep = bench_engine(engine, n_images=args.requests, stage_inputs=True, seed=args.seed)
        rep.update(buckets=list(buckets), warmup_s=warmup_s,
                   program_only_images_per_sec=program_only_images_per_sec(engine),
                   device="gpu" if device.type == "cuda" else "cpu",
                   card=card_name_and_power() if device.type == "cuda" else None)
    finally:
        engine.close()
    print(json.dumps({"serve_engine_only": rep}, default=float), flush=True)
    return rep


if __name__ == "__main__":
    main()
