"""Profiling CLI: per-stage times, a torch.profiler trace and the card's
time split by family and by kernel.

Counterpart of `camouflaged_vlm_tpu/cli/profile.py`, with its flags and its
lines. The model is built as the demo's session builds it
(`cli/demo.DemoSession`: `--dtype`, `--tiny`, the checkpoint flags, seeded
random weights for what no file sets, the 61 test classes' text features
encoded once). JAX's one jitted program is here one CUDA graph
(`graphs.GraphedCall`): the full `infer_cascade_with_text` at `--batch`,
and with `--stages` the SAM encoder and one CLIP `classify` pass, each
captured on its own in one shared memory pool. Each line is the mean of
`--iters` calls enqueued back to back after `--warmup`, one synchronise at
the end (as `cli/bench.py` times).

`--trace` traces `--iters` replays of the full graph, each synchronised
(`utils/profiling.trace`), and prints the card's busy time a call, its idle
share against the unprofiled synchronised wall, and `device_breakdown` by
family and by kernel; and one eager call of the same program, whose CPU ops
name the aten op behind each library kernel (a replay has none): its
library kernels' device time by launching op, whose owners the replay's
kernels take where the two kernel sequences match. Both traces
(Chrome/Perfetto json) go under `--trace-dir`.

Usage:
  python -m camouflaged_vlm_tpu_torch.cli.profile --batch 8 --stages --trace \
      --trace-dir ./trace_out
  python -m camouflaged_vlm_tpu_torch.cli.profile --tiny --device cpu --stages --trace

`--device cuda` (the default) on a host without a card raises. On the CPU
(`--device cpu`) the calls run eagerly, the lines are host times, and the
traces hold no device event: the breakdown says so.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Sequence

import torch

from ..config import DTYPES
from ..data.transforms import ONES_ALPHA_VALUE
from ..graphs import GraphedCall
from ..utils import profiling
from .bench import cascade_call, example_inputs, latency_ms, seconds_per_call
from .common import add_checkpoint_flags
from .demo import DemoSession


def _timed(fn, device, iters: int, warmup: int, name: str) -> float:
    dt = seconds_per_call(fn, device, iters, warmup)
    print(f"{name:32s} {dt*1e3:9.2f} ms", flush=True)
    return dt


def parse_args(argv: Sequence[str] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--stages", action="store_true", help="time each stage")
    p.add_argument("--trace", action="store_true",
                   help="capture torch.profiler traces of the replays and of one eager call")
    p.add_argument("--trace-dir",
                   default=os.path.join(tempfile.gettempdir(), "camouflaged-vlm-trace"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    add_checkpoint_flags(p)
    args = p.parse_args(argv)
    args.classnames = None  # the demo session's default: the 61 test classes
    if args.iters < 1 or args.warmup < 0:
        p.error(f"--iters {args.iters} must be >= 1 and --warmup {args.warmup} >= 0")
    return args


def main(argv: Sequence[str] = None) -> dict:
    """Print the timing lines (and with --trace the breakdowns); return
    {"seconds": {line: s a call}, "replay": breakdown, "eager": breakdown,
    "traces": [paths], "profilers": {"replay", "eager"}} (the last four with
    --trace)."""
    args = parse_args(argv)
    session = DemoSession(args)
    model, cfg, tf, device = session.model, session.cfg, session.text_features, session.device
    cuda = device.type == "cuda"
    where = torch.cuda.get_device_name(device) if cuda else "the CPU (eager, host times)"
    print(f"[profile] SAM {cfg.encoder.embed_dim} wide x {cfg.encoder.depth}, {args.dtype}, "
          f"batch {args.batch}, on {where}", flush=True)
    inp, cimg = example_inputs(cfg, args.batch, device, args.seed)
    cmask = torch.full((args.batch, cfg.clip_size, cfg.clip_size, 1), ONES_ALPHA_VALUE,
                       device=device)
    pool = torch.cuda.graph_pool_handle() if cuda else None
    out = {"seconds": {}}

    if args.stages:
        enc = GraphedCall(lambda x: model.image_encoder(x), inp, pool=pool)
        out["seconds"]["sam encoder"] = _timed(lambda: enc(inp), device, args.iters,
                                               args.warmup, "sam encoder")
        clip = GraphedCall(lambda i, a: model.clip_model.classify(i, a, tf), cimg, cmask,
                           pool=pool)
        out["seconds"]["clip classify (1 pass)"] = _timed(
            lambda: clip(cimg, cmask), device, args.iters, args.warmup,
            "clip classify (1 pass)")

    call = cascade_call(model, cfg, tf)
    full = GraphedCall(call, inp, cimg, pool=pool)
    dt = _timed(lambda: full(inp, cimg), device, args.iters, args.warmup,
                "FULL fused cascade")
    out["seconds"]["FULL fused cascade"] = dt
    print(f"throughput: {args.batch/dt:.2f} img/s (incl. per-call dispatch)", flush=True)

    if args.trace:
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        wall = latency_ms(lambda: full(inp, cimg), device, args.iters)
        with torch.no_grad():
            call(inp, cimg)  # the eager trace's warm-up
            sync()
            with profiling.trace(args.trace_dir, "eager") as eager:
                call(inp, cimg)
                sync()
        with profiling.trace(args.trace_dir, "replay") as prof:
            for _ in range(args.iters):
                full(inp, cimg)
                sync()
        out["eager"] = profiling.device_breakdown(eager, top=20)
        out["replay"] = rep = profiling.device_breakdown(
            prof, top=20, like=profiling.attribute(eager))
        print(f"[trace] {args.iters} replays of the full graph, each synchronised:")
        if rep["events"]:
            busy = rep["busy_ms"] / args.iters
            print(f"device busy {busy:.3f} ms a call against the unprofiled synchronised "
                  f"wall {wall:.3f} ms: idle share {1 - busy / wall:.3f}; kernel time summed "
                  f"{rep['total_ms'] / args.iters:.3f} ms a call; share of the replay's "
                  f"kernels paired with the eager call's launches {rep['matched']:.4f}")
        for line in profiling.format_breakdown(rep, per=args.iters):
            print(line)
        print("[trace] one eager call (CPU ops name each kernel's launching op):")
        for line in profiling.format_breakdown(out["eager"]):
            print(line)
        out["profilers"] = {"replay": prof, "eager": eager}
        out["traces"] = [os.path.join(args.trace_dir, f"{n}.json") for n in ("replay", "eager")]
        print(f"trace written to {args.trace_dir} ({', '.join(out['traces'])})", flush=True)
    return out


if __name__ == "__main__":
    main()
