"""Samples/s of the eval loader's host preprocessing, native against PIL.

Writes `--pairs` seeded OVCamo-layout pairs (a 700 x 500 JPEG image and a
PNG mask of its size, the source size of the JAX package's
`scripts/bench_native_preproc.py`) and times one eval sample
(`data/loader._load_eval_sample`: decode, 1024 px bilinear + nearest, 336 px
bicubic + crop, fp32 normalise) over `--samples` samples, the pairs in turn,
at each thread count of `--threads`; the paths alternate PIL, native,
native, PIL, each reading after one warm-up sample. Prints the card's name
and power limit where `nvidia-smi` answers, the host's CPU count and
`native.status()`, then one JSON line {"preproc_timing": {...}} per thread
count with both readings of each path. The pairs are deleted at the end.

  python -m camouflaged_vlm_tpu_torch.cli.preproc_timing --samples 400 --threads 1 8
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import yaml

from ..data import loader, native
from ..data.ovcamo import TEST_CLASS_NAMES, OVCamoIndex
from ..data.synthetic import write_synthetic_ovcamo

# (height, width) of the seeded pairs
SIZE = (500, 700)
# the order of a thread count's readings
ORDER = ("PIL", "native", "native", "PIL")


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the card, or why there is none."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        return f"no card ({e})"


def rate(samples, use_native: bool, threads: int) -> float:
    """Eval samples a second through `threads` threads (one warm-up first)."""
    def one(s):
        return loader._load_eval_sample(s, 1024, 336, use_native=use_native)

    one(samples[0])
    t0 = time.perf_counter()
    if threads == 1:
        for s in samples:
            one(s)
    else:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(one, samples))
    return len(samples) / (time.perf_counter() - t0)


def parse_args(argv: Sequence[str] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=32, help="distinct seeded pairs")
    p.add_argument("--samples", type=int, default=400, help="samples a reading")
    p.add_argument("--threads", type=int, nargs="+", default=[1, 8])
    p.add_argument("--seed", type=int, default=4)
    p.add_argument("--work", default=os.path.join("build", "preproc_timing"),
                   help="where the pairs are written (deleted at the end)")
    return p.parse_args(argv)


def main(argv: Sequence[str] = None) -> list:
    args = parse_args(argv)
    if not native.enabled():
        raise SystemExit(f"preproc_timing compares both paths: unset {native.ENV_SWITCH}")
    print(card_line(), flush=True)
    print(f"[preproc_timing] host CPUs {os.cpu_count()}; {native.status()}", flush=True)
    shutil.rmtree(args.work, ignore_errors=True)
    rows = []
    try:
        info = write_synthetic_ovcamo(os.path.join(args.work, "ovcamo"), n_train=0,
                                      n_test=args.pairs, seed=args.seed,
                                      test_classes=tuple(TEST_CLASS_NAMES), sizes=(SIZE,))
        with open(info) as f:
            index = OVCamoIndex.from_dataset_info(yaml.safe_load(f), "test")
        samples = [index.samples[i % args.pairs] for i in range(args.samples)]
        for threads in args.threads:
            readings = {"PIL": [], "native": []}
            for mode in ORDER:
                readings[mode].append(rate(samples, mode == "native", threads))
            row = {"threads": threads, "samples": args.samples, "pairs": args.pairs,
                   "size": list(SIZE), "pil_samples_per_sec": readings["PIL"],
                   "native_samples_per_sec": readings["native"],
                   "native_over_pil": sum(readings["native"]) / sum(readings["PIL"]),
                   "cpus": os.cpu_count(), "status": native.status()}
            print(json.dumps({"preproc_timing": row}), flush=True)
            rows.append(row)
    finally:
        shutil.rmtree(args.work, ignore_errors=True)
    return rows


if __name__ == "__main__":
    main()
