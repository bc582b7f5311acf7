"""MaPLe prompt-learner training on the GPU.

Counterpart of `camouflaged_vlm_tpu/cli/train_maple.py`, the reference's
dassl `MaPLeAlphaCLIP(TrainerX)` trainer: every parameter of the cascade's
CustomClip frozen but the multi-modal prompt learner, trained with
cross-entropy on OVCamo train-split (CLIP image, GT-mask alpha, label)
batches against the train classes' prompts (`train/maple.py`: SGD with
momentum 0.9 and weight decay 5e-4, a constant warm-up of 1e-5, then a
per-epoch cosine from `--lr`). The text tower runs in every step, so the
gradient passes through both CLIP towers.

Usage:
  python -m camouflaged_vlm_tpu_torch.cli.train_maple --dataset-info dataset_info.yaml \
      --save-dir ./save/maple_torch [--clip-ckpt ViT-L-14-336px.pt] \
      [--maple-ckpt model-best.pth.tar] [--train-text-bank train_bank.npy]

The default type is float32, as in the JAX CLI; on the card it runs the
fp32 instances of the CLIP kernels (#2, #16, #7, #4/#5 and the MLP
backward #6, `ops/`). Under float32 the CLI turns TF32 off
(`torch.backends.cuda.matmul.allow_tf32` and `torch.backends.cudnn.allow_tf32`),
so that what runs outside the kernels (the text tower's attention, the patch
embeddings' convolutions, the plain backwards of #2, #16 and #7) computes in
full fp32 too. `--dtype bfloat16` runs the bf16 kernels. `--device cuda` on
a machine without a GPU raises.

The starting weights come from the checkpoint flags (`cli/common.py`); the
train split's bank from `--train-text-bank`, else `--text-bank`; what no file
sets is random (seeded by `--seed`). After every epoch, in `--save-dir`:
  maple_last.pt           CustomClip's weights, the SGD state and the step
                          (`--resume` continues from it exactly; the best
                          accuracy so far is kept in maple_meta.json);
and at each new best train accuracy:
  maple_best.pt           the same;
  prompt_learner_best.npz the prompt learner's tensors under the port's keys;
  model-best.pth.tar      the prompt learner in the dassl layout
                          ({"state_dict": prompt_learner.* under the
                          reference's names, "epoch": e}), which `--maple-ckpt`
                          reads back;
plus log.txt, and tensorboard scalars when `torch.utils.tensorboard` imports.
Each epoch draws its shuffle and flips from (--seed, epoch), so that a
resumed run replays the epochs it skips (the JAX CLI draws from one
generator over the run).
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
from ..data.loader import iter_maple_train_batches
from ..data.ovcamo import OVCamoIndex
from ..factory import build_cascade
from ..io.checkpoint import restore_checkpoint, save_checkpoint
from ..io.convert import PROMPT_LEARNER, maple_pairs
from ..train import (
    MAPLE_TRAINABLE_PREFIXES,
    make_maple_optimizer,
    make_maple_train_step,
    maple_schedule,
    trainable_parameters,
)
from .common import (
    Logger,
    add_checkpoint_flags,
    cascade_config,
    device_or_raise,
    exact_fp32_on_card,
    fallback_line,
    load_checkpoints,
    preproc_line,
    tensorboard_writer,
)


def parse_args(argv: Sequence[str] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset-info", required=True, help="OVCamo dataset_info yaml")
    p.add_argument("--save-dir", default="./save/maple_torch")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.0035)
    p.add_argument("--warmup-epochs", type=int, default=1)
    add_checkpoint_flags(p)
    p.add_argument("--train-text-bank", default=None,
                   help="the train split's bank (default --text-bank)")
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES),
                   help="prompt training is small; float32 by default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke test)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--resume", action="store_true",
                   help="continue from <save-dir>/maple_last.pt: weights, SGD state and step")
    p.add_argument("--stop-after-epoch", type=int, default=None,
                   help="exit after this epoch's checkpoints (for resume tests)")
    return p.parse_args(argv)


def save_dassl(path: str, model, cfg, epoch: int) -> None:
    """The prompt learner as the reference's dassl trainer saves it:
    {"state_dict": its tensors under `prompt_learner.*`, "epoch": epoch}."""
    sd = model.state_dict()
    tmp = f"{path}.tmp"
    torch.save({"state_dict": {fk: sd[tk].detach().float().cpu()
                               for tk, fk in maple_pairs(cfg.clip, "prompt_learner")},
                "epoch": int(epoch)}, tmp)
    os.replace(tmp, path)


def main(argv: Sequence[str] = None) -> dict:
    """Train; return {"model": the cascade, "optimizer", "step", "epochs":
    [{"loss", "acc"} per epoch], "step_seconds": [wall seconds of every
    step], "best_acc", "bank": the train split's class bank}."""
    args = parse_args(argv)
    cfg = cascade_config(None, args.tiny, args.dtype)
    device = device_or_raise(args.device)
    exact_fp32_on_card(args.device, cfg)  # full fp32 outside the kernels too
    os.makedirs(args.save_dir, exist_ok=True)
    log = Logger(args.save_dir)
    writer = tensorboard_writer(os.path.join(args.save_dir, "tensorboard"))

    with open(args.dataset_info) as f:
        dataset_info = yaml.safe_load(f)
    train_index = OVCamoIndex.from_dataset_info(dataset_info, "train")
    log(f"[maple] {len(train_index)} samples / {len(train_index.classes)} classes")
    log(preproc_line("maple"))

    model = build_cascade(cfg, device, args.seed)
    make_bank = load_checkpoints(model, cfg, clip_ckpt=args.clip_ckpt,
                                 maple_ckpt=args.maple_ckpt, sam_ckpt=args.sam_ckpt,
                                 cascade_ckpt=args.cascade_ckpt, seed=args.seed, log=log)
    bank = make_bank(train_index.classes, args.train_text_bank or args.text_bank)
    clip = model.clip_model
    params = trainable_parameters(model, MAPLE_TRAINABLE_PREFIXES)
    steps_per_epoch = max(1, len(train_index) // args.batch_size)
    schedule = maple_schedule(args.lr, args.epochs, steps_per_epoch, args.warmup_epochs)
    optimizer = make_maple_optimizer(params, args.lr)

    last = os.path.join(args.save_dir, "maple_last.pt")
    best = os.path.join(args.save_dir, "maple_best.pt")
    meta_path = os.path.join(args.save_dir, "maple_meta.json")
    step, start_epoch, best_acc = 0, 1, -1.0
    if args.resume:
        if not os.path.exists(last):
            raise FileNotFoundError(f"--resume: no checkpoint at {last}")
        step = restore_checkpoint(last, clip, optimizer)
        start_epoch = step // steps_per_epoch + 1
        with open(meta_path) as f:
            best_acc = float(json.load(f)["best_acc"])
        log(f"[resume] restored step {step} from {last}; continuing at epoch {start_epoch} "
            f"(best train-acc {best_acc})")
    train_step = make_maple_train_step(clip, optimizer, schedule)

    epochs, step_seconds = [], []
    for epoch in range(start_epoch, args.epochs + 1):
        t_epoch = time.perf_counter()
        rng = np.random.default_rng([args.seed, epoch])
        losses, accs = [], []
        for batch in iter_maple_train_batches(train_index, args.batch_size, rng, cfg.clip_size):
            t0 = time.perf_counter()
            dev = {k: torch.from_numpy(batch[k]).to(device, non_blocking=True)
                   for k in ("clip_image", "clip_alpha", "label_id")}
            m = train_step({**dev, **bank}, step)
            losses.append(float(m["loss"]))  # waits for the step
            accs.append(float(m["acc"]))
            step_seconds.append(time.perf_counter() - t0)
            step += 1
        loss = float(np.mean(losses)) if losses else float("nan")
        acc = float(np.mean(accs)) if accs else 0.0
        epochs.append({"loss": loss, "acc": acc})
        log(f"[maple] epoch {epoch}/{args.epochs} loss={loss:.4f} train-acc={acc:.4f} "
            f"({time.perf_counter() - t_epoch:.1f}s)")
        if writer:
            writer.add_scalar("maple/loss", loss, epoch)
            writer.add_scalar("maple/train_acc", acc, epoch)
        save_checkpoint(last, clip, optimizer, step)
        if acc > best_acc:
            best_acc = acc
            save_checkpoint(best, clip, optimizer, step)
            np.savez(os.path.join(args.save_dir, "prompt_learner_best.npz"),
                     **{k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()
                        if k.startswith(PROMPT_LEARNER)})
            save_dassl(os.path.join(args.save_dir, "model-best.pth.tar"), model, cfg, epoch)
        with open(meta_path, "w") as f:
            json.dump({"epoch": epoch, "step": step, "best_acc": best_acc}, f)
        if args.stop_after_epoch == epoch:
            log(f"[stop-after-epoch] exiting after epoch {epoch}")
            break
    else:
        log(f"[maple] done; best train-acc {best_acc:.4f}")
    log(fallback_line("maple"))
    if writer:
        writer.close()
    return {"model": model, "optimizer": optimizer, "step": step, "epochs": epochs,
            "step_seconds": step_seconds, "best_acc": best_acc, "bank": bank}


if __name__ == "__main__":
    main()
