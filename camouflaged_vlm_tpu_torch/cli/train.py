"""OVCOS cascade training on the GPU.

Counterpart of `camouflaged_vlm_tpu/cli/train.py` (the reference's
`train_ovcos_maskdecoder_edge.py`): AdamW(2e-4) with a per-epoch cosine to
1e-7, training only the EVP prompt generator, the mask decoder, the
CLIP->prompt projections and no_mask_embed; a checkpoint of weights,
optimizer state and step after every epoch, so `--resume` continues
exactly.

Usage:
  python -m camouflaged_vlm_tpu_torch.cli.train --dataset-info dataset_info.yaml \
      --save-dir ./save/ovcos --epochs 20 --batch-size 4 --epoch-val 21 \
      [--config configs/ovcos-sam-vit-h-maskdecoder-edge.yaml]

As in the JAX package, the training forward is conditioned on the TEST
split's class-text features (the reference passes `self.training` into
CustomCLIP's `label` slot, so its test-branch prompts run at every step);
the text tower is frozen, so those features are encoded once per run.
Without checkpoints the weights are random (seeded by `--seed`). `--device
cuda` on a machine without a GPU raises.

`--config` takes a model yaml (native or the reference's format), as the
JAX CLI does; its train section is not read (the flags set the recipe).

Not ported yet (ROADMAP.md, Queue 1): validation inside the run (the CLI
refuses `--epoch-val <= --epochs` rather than skip it; `cli/evaluate.py`
evaluates a saved checkpoint), data/tensor parallelism, remat, the
optimizer-fusion flag and the checkpoint-loading flags.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Sequence

import numpy as np
import torch
import yaml

from ..config import DTYPES
from ..data.loader import iter_train_batches
from ..data.ovcamo import OVCamoIndex
from ..factory import attach_rel_cache, build_cascade, make_bank_inputs
from ..io.checkpoint import restore_checkpoint, save_checkpoint
from ..train import (
    SCANNED_BATCH_KEYS,
    cosine_epoch_schedule,
    make_optimizer,
    make_train_step,
    trainable_parameters,
)
from .common import Logger, cascade_config, device_or_raise


def parse_args(argv: Sequence[str] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset-info", required=True, help="OVCamo dataset_info yaml")
    p.add_argument("--save-dir", default="./save/ovcos_torch")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--weight-decay", type=float, default=0.01,
                   help="AdamW decoupled weight decay (torch AdamW's default, which the "
                   "reference inherits)")
    p.add_argument("--eta-min", type=float, default=1e-7)
    p.add_argument("--epoch-val", type=int, default=2,
                   help="validate every N epochs; validation inside the run is not wired "
                   "yet, so it must exceed --epochs")
    p.add_argument("--loss", default="iou", choices=["bce", "bbce", "iou"])
    p.add_argument("--accum-steps", type=int, default=1,
                   help="split each batch into this many microbatches, one update")
    p.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                   help="compute type; default the config's (bfloat16 without --config)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", default=None,
                   help="model config yaml (native or the reference's format)")
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke test)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--resume", action="store_true",
                   help="continue from <save-dir>/ckpt_last.pt: weights, optimizer state "
                   "and step")
    p.add_argument("--stop-after-epoch", type=int, default=None,
                   help="exit after this epoch's checkpoint (for resume tests)")
    args = p.parse_args(argv)
    if args.epoch_val <= args.epochs:
        p.error(f"--epoch-val {args.epoch_val} <= --epochs {args.epochs} asks for "
                "validation, which is not wired into the run yet (ROADMAP.md Queue 1, item "
                "10); pass --epoch-val greater than --epochs and run cli/evaluate.py on the "
                "checkpoint")
    if args.accum_steps < 1 or args.batch_size % args.accum_steps:
        p.error(f"--batch-size {args.batch_size} must be a multiple of --accum-steps "
                f"{args.accum_steps} >= 1")
    return args


def to_device_batch(batch: dict, device, accum: int) -> dict:
    out = {}
    for k in SCANNED_BATCH_KEYS:
        x = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if accum > 1:
            x = x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))
        out[k] = x.to(device, non_blocking=True)
    return out


def main(argv: Sequence[str] = None) -> dict:
    """Train; return {"model", "optimizer", "step", "epochs": [per-epoch
    mean metrics], "step_seconds": [wall seconds of every step]}."""
    args = parse_args(argv)
    device = device_or_raise(args.device)
    cfg = cascade_config(args.config, args.tiny, args.dtype)
    os.makedirs(args.save_dir, exist_ok=True)
    log = Logger(args.save_dir)

    with open(args.dataset_info) as f:
        dataset_info = yaml.safe_load(f)
    train_index = OVCamoIndex.from_dataset_info(dataset_info, "train")
    val_index = OVCamoIndex.from_dataset_info(dataset_info, "test")
    log(f"[train] {len(train_index)} samples / {len(train_index.classes)} classes")

    model = build_cascade(cfg, device, args.seed)
    params = trainable_parameters(model)
    steps_per_epoch = max(1, len(train_index) // args.batch_size)
    schedule = cosine_epoch_schedule(args.lr, args.epochs, steps_per_epoch, args.eta_min)
    optimizer = make_optimizer(params, args.lr, args.weight_decay)

    step, start_epoch = 0, 1
    ckpt_last = os.path.join(args.save_dir, "ckpt_last.pt")
    meta_path = os.path.join(args.save_dir, "ckpt_meta.json")
    if args.resume:
        if not os.path.exists(ckpt_last):
            raise FileNotFoundError(f"--resume: no checkpoint at {ckpt_last}")
        step = restore_checkpoint(ckpt_last, model, optimizer)
        # the epoch follows from the restored step, the checkpoint's own record
        start_epoch = step // steps_per_epoch + 1
        log(f"[resume] restored step {step} from {ckpt_last}; continuing at epoch "
            f"{start_epoch}")
    # after the weights are final (the rel-pos parameters are frozen)
    attach_rel_cache(model)

    # the reference's quirk: the training forward sees the TEST split's
    # class-text features, encoded once (the text tower is frozen)
    bank = make_bank_inputs(cfg, val_index.classes, seed=args.seed, device=device)
    text_features = model.encode_class_text_features(
        bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"])
    train_step = make_train_step(model, optimizer, schedule, args.loss, args.accum_steps)

    epochs, step_seconds = [], []
    for epoch in range(start_epoch, args.epochs + 1):
        t_epoch = time.perf_counter()
        # a per-epoch seed, so a resumed run replays the epochs it skips
        rng = np.random.default_rng([args.seed, epoch])
        metrics = []
        for batch in iter_train_batches(train_index, args.batch_size, rng, cfg.inp_size,
                                        cfg.clip_size):
            t0 = time.perf_counter()
            m = train_step({**to_device_batch(batch, device, args.accum_steps),
                            "text_features": text_features}, step)
            metrics.append({k: float(v) for k, v in m.items()})  # waits for the step
            step_seconds.append(time.perf_counter() - t0)
            step += 1
        means = {k: float(np.mean([m[k] for m in metrics])) for k in (metrics[0] if metrics else {})}
        epochs.append(means)
        log(f"epoch {epoch}/{args.epochs} "
            + " ".join(f"{k}={v:.4f}" for k, v in means.items())
            + f" ({time.perf_counter() - t_epoch:.1f}s)")
        save_checkpoint(ckpt_last, model, optimizer, step)
        with open(meta_path, "w") as f:
            json.dump({"epoch": epoch, "step": step}, f)
        if args.stop_after_epoch == epoch:
            log(f"[stop-after-epoch] exiting after epoch {epoch}")
            break
    else:
        log("training done")
    return {"model": model, "optimizer": optimizer, "step": step, "epochs": epochs,
            "step_seconds": step_seconds}


if __name__ == "__main__":
    main()
