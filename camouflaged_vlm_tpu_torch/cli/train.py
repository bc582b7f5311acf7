"""OVCOS cascade training on the GPU.

Counterpart of `camouflaged_vlm_tpu/cli/train.py` (the reference's
`train_ovcos_maskdecoder_edge.py`): AdamW(2e-4) with a per-epoch cosine to
1e-7, training only the EVP prompt generator, the mask decoder, the
CLIP->prompt projections and no_mask_embed; a checkpoint of weights,
optimizer state and step after every epoch, so `--resume` continues
exactly. Every `--epoch-val` epochs the model as it stands is evaluated on
the test split (`cli/evaluate.evaluate`, batch max(1, batch_size // 2)); the
lowest validation MAE so far is saved as `ckpt_best.pt`, and `best_mae`
is kept in `ckpt_meta.json` across `--resume`.

Usage:
  python -m camouflaged_vlm_tpu_torch.cli.train --dataset-info dataset_info.yaml \
      --save-dir ./save/ovcos --epochs 20 --batch-size 4 --epoch-val 2 \
      [--config configs/ovcos-sam-vit-h-maskdecoder-edge.yaml]

As in the JAX package, the training forward is conditioned on the TEST
split's class-text features (the reference passes `self.training` into
CustomCLIP's `label` slot, so its test-branch prompts run at every step);
the text tower is frozen, so those features are encoded once per run.
The checkpoint flags (`cli/common.py`: `--sam-ckpt`, `--clip-ckpt`,
`--maple-ckpt`) set the starting weights, and the banks come as in the JAX
CLI (`cli/train.py:184-196`): `--text-bank`, the test split's, conditions
validation and the training forward; the train split's bank is built from
`--train-text-bank`, else `--text-bank`, and conditions nothing (the JAX
CLI hands it only to the parameter init). What no file sets is random
(seeded by `--seed`). `--device cuda` on a machine without a GPU raises.
`--dtype float32 --device cuda` trains the reference configuration in
full fp32 on the card (TF32 off, `common.exact_fp32_on_card`): every
kernel on the path on its fp32 instance, the backwards #6, #14 and #18
included; a configuration whose routes launch a kernel with no fp32
instance yet is refused before the build (`common.refuse_fp32_on_card`).

`--config` takes a model yaml (native or the reference's format), as the
JAX CLI does, and its train section sets the recipe: `epochs`,
`batch_size`, `lr`, `eta_min`, `epoch_val` and `loss` (a reference-format
yaml's `epoch_max`, `lr_min`, ...) replace the flags where present.

`--remat` (or a yaml's `encoder.remat: true`) recomputes each SAM block's
forward in the backward pass (`torch.utils.checkpoint`, JAX's `nn.remat`):
the step keeps only the blocks' inputs, trading memory for one more encoder
forward; the gradients are those of the step without it. Each epoch's mean
losses go to TensorBoard under `<save-dir>/tensorboard` when
`torch.utils.tensorboard` imports, under JAX's names (the metric keys, step
= the epoch).

Several cards, one process a rank (`parallel/`): `--distributed` starts the
process group from torchrun's environment, or from `--coordinator host:port
--num-processes N --process-id I` (the JAX CLI's flags), and `--n-model M`
makes the ranks a data x model mesh (tensor parallelism over groups of M
ranks, the Megatron rules of `parallel/sharding.py`), e.g.

  torchrun --nproc-per-node 8 -m camouflaged_vlm_tpu_torch.cli.train \
      --dataset-info dataset_info.yaml --distributed --n-model 2 --batch-size 8

Every rank builds the same batches from the seed and trains on its rows (the
microbatch, batch_size / accum_steps, must divide over the data ranks); the
gradients are averaged over the data ranks (the JAX package's fix of the
reference's DDP, which never synchronised them). The log, TensorBoard and
ckpt_meta.json come from rank 0; a checkpoint is the full, unsharded state
(rank 0 writes it), and `--resume` loads it on any mesh. Validation runs
on the mesh, data-parallel over its data ranks. On one card shared by
several ranks the backend is gloo (`parallel/mesh.py`).

The JAX CLI's `--fused-optimizer` is left out on
purpose: its "auto" changes the optimizer state's layout, so a resume from an
older checkpoint fails (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Sequence

import numpy as np
import torch
import yaml

from ..config import DTYPES, cascade_config_from_yaml
from ..data.loader import iter_train_batches
from ..data.ovcamo import OVCamoIndex
from ..factory import attach_rel_cache, build_cascade
from ..io.checkpoint import restore_checkpoint, save_checkpoint
from ..parallel import batch_rows, check_tp_config, init_distributed, make_mesh, shard_model_
from ..train import (
    SCANNED_BATCH_KEYS,
    cosine_epoch_schedule,
    make_optimizer,
    make_train_step,
    trainable_parameters,
)
from .common import (
    Logger,
    cascade_config,
    device_or_raise,
    exact_fp32_on_card,
    load_checkpoints,
    refuse_fp32_on_card,
    tensorboard_writer,
)
from .evaluate import evaluate

# the train-section keys of a yaml that replace the flags (JAX's CLI)
RECIPE_KEYS = ("epochs", "batch_size", "lr", "eta_min", "epoch_val", "loss")


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
                   help="validate on the test split every N epochs")
    p.add_argument("--loss", default="iou", choices=["bce", "bbce", "iou"])
    p.add_argument("--accum-steps", type=int, default=1,
                   help="split each batch into this many microbatches, one update")
    p.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                   help="compute type; default the config's (bfloat16 without --config)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", default=None,
                   help="model config yaml (native or the reference's format)")
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke test)")
    p.add_argument(
        "--remat", action="store_true",
        help="rematerialise encoder blocks in the backward pass: each block keeps only its "
        "input and its forward runs again in the backward, so the step's activation memory "
        "drops to the blocks' inputs and one block's activations, for about one more SAM "
        "forward a step. Use for larger per-card batches.",
    )
    p.add_argument("--device", default="cuda")
    p.add_argument("--sam-ckpt", default=None, help="SAM backbone (sam_vit_h_4b8939.pth)")
    p.add_argument("--clip-ckpt", default=None,
                   help="OpenAI CLIP TorchScript archive (ViT-L-14-336px.pt)")
    p.add_argument("--maple-ckpt", default=None,
                   help="dassl MaPLe prompt learner (model-best.pth.tar)")
    p.add_argument("--text-bank", default=None,
                   help="the TEST split's bank: conditions validation and the training forward")
    p.add_argument("--train-text-bank", default=None,
                   help="the train split's bank (default --text-bank)")
    p.add_argument("--resume", action="store_true",
                   help="continue from <save-dir>/ckpt_last.pt: weights, optimizer state "
                   "and step")
    p.add_argument("--stop-after-epoch", type=int, default=None,
                   help="exit after this epoch's checkpoint and validation (for resume "
                   "tests)")
    p.add_argument("--n-model", type=int, default=1,
                   help="tensor-parallel group size (with --distributed)")
    p.add_argument("--distributed", action="store_true",
                   help="one process a rank over torch.distributed: the group from "
                   "torchrun's environment, or from --coordinator/--num-processes/"
                   "--process-id")
    p.add_argument("--coordinator", default=None, help="host:port of rank 0's store")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)
    if args.n_model > 1 and not args.distributed:
        p.error("--n-model > 1 needs --distributed (one process a rank)")
    if args.config:  # the yaml's recipe replaces the flags, as in the JAX CLI
        _, train_hp = cascade_config_from_yaml(args.config)
        for key in RECIPE_KEYS:
            if key in train_hp:
                setattr(args, key, train_hp[key])
    if args.epoch_val < 1:
        p.error(f"epoch_val must be >= 1, got {args.epoch_val}")
    if args.accum_steps < 1 or args.batch_size % args.accum_steps:
        p.error(f"--batch-size {args.batch_size} must be a multiple of --accum-steps "
                f"{args.accum_steps} >= 1")
    return args


def to_device_batch(batch: dict, device, accum: int, mesh=None) -> dict:
    """The batch's tensors on `device`, (accum, B/accum, ...) with
    accumulation; on a mesh this data rank's rows of each (microbatch)."""
    out = {}
    for k in SCANNED_BATCH_KEYS:
        x = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if accum > 1:
            x = x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))
        x = batch_rows(x, mesh, axis=1 if accum > 1 else 0).contiguous()
        out[k] = x.to(device, non_blocking=True)
    return out


def main(argv: Sequence[str] = None) -> dict:
    """Train; return {"model", "optimizer", "mesh", "step", "epochs":
    [per-epoch mean metrics], "step_seconds": [wall seconds of every step],
    "validations": [{"epoch", **evaluate() results} per validation],
    "best_mae", "text_features": the test split's, which condition training,
    "bank" and "train_bank": the test and the train split's class banks}."""
    args = parse_args(argv)
    cfg = cascade_config(args.config, args.tiny, args.dtype)
    if args.remat:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, remat=True))
    refuse_fp32_on_card(args.device, cfg, training=True)
    check_tp_config(cfg, args.n_model)
    mesh = None
    if args.distributed:
        mesh = make_mesh(n_model=args.n_model, device=init_distributed(
            args.coordinator, args.num_processes, args.process_id, device=args.device))
        micro = args.batch_size // args.accum_steps
        if micro % mesh.n_data:
            raise ValueError(f"the microbatch, --batch-size {args.batch_size} / --accum-steps "
                             f"{args.accum_steps} = {micro}, does not divide over "
                             f"{mesh.n_data} data ranks")
    main_rank = mesh is None or mesh.is_main
    device = mesh.device if mesh is not None else device_or_raise(args.device)
    exact_fp32_on_card(args.device, cfg)  # full fp32 outside the kernels too
    os.makedirs(args.save_dir, exist_ok=True)
    log = Logger(args.save_dir, quiet=not main_rank)
    writer = tensorboard_writer(os.path.join(args.save_dir, "tensorboard")) if main_rank else None
    if mesh is not None:
        log(f"[train] mesh data={mesh.n_data} x model={mesh.n_model} ({mesh.backend})")

    with open(args.dataset_info) as f:
        dataset_info = yaml.safe_load(f)
    train_index = OVCamoIndex.from_dataset_info(dataset_info, "train")
    val_index = OVCamoIndex.from_dataset_info(dataset_info, "test")
    log(f"[train] {len(train_index)} samples / {len(train_index.classes)} classes")

    model = build_cascade(cfg, device, args.seed)
    make_bank = load_checkpoints(model, cfg, clip_ckpt=args.clip_ckpt,
                                 maple_ckpt=args.maple_ckpt, sam_ckpt=args.sam_ckpt,
                                 seed=args.seed, log=log)
    train_bank = make_bank(train_index.classes, args.train_text_bank or args.text_bank)
    shard_model_(model, mesh)
    params = trainable_parameters(model)
    steps_per_epoch = max(1, len(train_index) // args.batch_size)
    schedule = cosine_epoch_schedule(args.lr, args.epochs, steps_per_epoch, args.eta_min)
    optimizer = make_optimizer(params, args.lr, args.weight_decay)

    step, start_epoch, best_mae = 0, 1, float("inf")
    ckpt_last = os.path.join(args.save_dir, "ckpt_last.pt")
    ckpt_best = os.path.join(args.save_dir, "ckpt_best.pt")
    meta_path = os.path.join(args.save_dir, "ckpt_meta.json")
    if args.resume:
        if not os.path.exists(ckpt_last):
            raise FileNotFoundError(f"--resume: no checkpoint at {ckpt_last}")
        step = restore_checkpoint(ckpt_last, model, optimizer, mesh)
        # the epoch follows from the restored step, the checkpoint's own
        # record; the meta file only carries best_mae
        start_epoch = step // steps_per_epoch + 1
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                best_mae = float(json.load(f).get("best_mae", float("inf")))
        log(f"[resume] restored step {step} from {ckpt_last}; continuing at epoch "
            f"{start_epoch} (best mae {best_mae})")
    # after the weights are final (the rel-pos parameters are frozen)
    attach_rel_cache(model)

    # the reference's quirk: the training forward sees the TEST split's
    # class-text features, encoded once (the text tower is frozen)
    bank = make_bank(val_index.classes, args.text_bank)
    text_features = model.encode_class_text_features(
        bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"])
    train_step = make_train_step(model, optimizer, schedule, args.loss, args.accum_steps,
                                 mesh=mesh)

    epochs, step_seconds, validations = [], [], []
    for epoch in range(start_epoch, args.epochs + 1):
        t_epoch = time.perf_counter()
        # a per-epoch seed, so a resumed run replays the epochs it skips
        rng = np.random.default_rng([args.seed, epoch])
        metrics = []
        for batch in iter_train_batches(train_index, args.batch_size, rng, cfg.inp_size,
                                        cfg.clip_size):
            t0 = time.perf_counter()
            m = train_step({**to_device_batch(batch, device, args.accum_steps, mesh),
                            "text_features": text_features}, step)
            metrics.append({k: float(v) for k, v in m.items()})  # waits for the step
            step_seconds.append(time.perf_counter() - t0)
            step += 1
        means = {k: float(np.mean([m[k] for m in metrics])) for k in (metrics[0] if metrics else {})}
        epochs.append(means)
        log(f"epoch {epoch}/{args.epochs} "
            + " ".join(f"{k}={v:.4f}" for k, v in means.items())
            + f" ({time.perf_counter() - t_epoch:.1f}s)")
        if writer:
            for k, v in means.items():
                writer.add_scalar(k, v, epoch)
        save_checkpoint(ckpt_last, model, optimizer, step, mesh)
        if main_rank:
            with open(meta_path, "w") as f:
                json.dump({"epoch": epoch, "step": step, "best_mae": best_mae}, f)
        if epoch % args.epoch_val == 0:
            # the model as it stands (evaluate() runs under no grad and leaves
            # the module's mode alone: the cascade has no train-mode layers);
            # on a mesh data-parallel, the batch rounded up to a multiple of
            # the data ranks, as in the JAX CLI
            n_data = mesh.n_data if mesh is not None else 1
            val_bs = -(-max(1, args.batch_size // 2) // n_data) * n_data
            results = evaluate(model, cfg, bank, val_index, batch_size=val_bs, mesh=mesh,
                               log=log)
            validations.append({"epoch": epoch, **results})
            log(f"[val epoch {epoch}] {json.dumps(results)}")
            if results.get("mae", 1.0) < best_mae:
                best_mae = results["mae"]
                save_checkpoint(ckpt_best, model, optimizer, step, mesh)
                if main_rank:
                    with open(meta_path, "w") as f:
                        json.dump({"epoch": epoch, "step": step, "best_mae": best_mae}, f)
                log(f"[val epoch {epoch}] new best mae {best_mae}")
        # after the epoch's validation, so that a resumed run validates as an
        # uninterrupted one does
        if args.stop_after_epoch == epoch:
            log(f"[stop-after-epoch] exiting after epoch {epoch}")
            break
    else:
        log("training done")
    if writer:
        writer.close()
    return {"model": model, "optimizer": optimizer, "mesh": mesh, "step": step, "epochs": epochs,
            "step_seconds": step_seconds, "validations": validations,
            "best_mae": best_mae, "text_features": text_features, "bank": bank,
            "train_bank": train_bank}


if __name__ == "__main__":
    main()
