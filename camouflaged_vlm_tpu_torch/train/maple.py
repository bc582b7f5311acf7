"""MaPLe prompt-learner training: the loss, the step, SGD and its schedule.

Counterpart of `camouflaged_vlm_tpu/train/maple.py`, the reference's dassl
`MaPLeAlphaCLIP(TrainerX)` trainer, which produced the `model-best.pth.tar`
prompt learner the cascade loads: CustomClip with every parameter frozen
but the multi-modal prompt learner, cross-entropy on (image, GT-mask alpha,
label) batches, SGD with momentum and weight decay under a constant
warm-up, then a per-epoch cosine.

The text tower runs inside the differentiated step (the learned prompts
change at every update), so the step's gradient passes through both CLIP
towers: on the card through the kernels' backwards (`ops/`), the frozen
weights taking no weight-gradient product (`requires_grad` is off).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable

import torch
import torch.nn.functional as F
from torch import nn

# the JAX package's MAPLE_TRAINABLE_SUBTREES as the port's state-dict prefixes
# (`optim.trainable_parameters(model, MAPLE_TRAINABLE_PREFIXES)` sets them)
MAPLE_TRAINABLE_PREFIXES = ("clip_model.prompt_learner.",)


def maple_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the class logits, in fp32 (dassl's
    F.cross_entropy)."""
    return F.cross_entropy(logits.float(), labels.long())


def maple_schedule(base_lr: float = 0.0035, total_epochs: int = 10, steps_per_epoch: int = 1,
                   warmup_epochs: int = 1, warmup_lr: float = 1e-5) -> Callable[[int], float]:
    """The learning rate of optimizer step `step` (counted from 0, before
    its increment, as optax reads its count): `warmup_lr` over the warm-up
    epochs (dassl's ConstantWarmupScheduler), then the per-epoch cosine at
    index epoch - warmup, so the first epoch after the warm-up runs at the
    full base rate; the epoch is clamped at `total_epochs`."""

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, total_epochs)
        if epoch < warmup_epochs:
            return warmup_lr
        return 0.5 * base_lr * (1.0 + math.cos(math.pi * (epoch - warmup_epochs) / total_epochs))

    return schedule


def make_maple_optimizer(params: Iterable[nn.Parameter], base_lr: float = 0.0035,
                         momentum: float = 0.9, weight_decay: float = 5e-4) -> torch.optim.SGD:
    """SGD with momentum over the prompt learner: the decayed weights are
    added to the gradient before the momentum trace, as optax's
    `add_decayed_weights` -> `sgd(momentum)` chain does (torch's SGD with
    `weight_decay` and no dampening computes the same). The step sets the
    learning rate from the schedule before every update."""
    return torch.optim.SGD(list(params), lr=base_lr, momentum=momentum, dampening=0.0,
                           weight_decay=weight_decay, nesterov=False)


def make_maple_train_step(
    model,
    optimizer: torch.optim.Optimizer,
    schedule: Callable[[int], float],
) -> Callable[[Dict[str, torch.Tensor], int], Dict[str, torch.Tensor]]:
    """`step(batch, step_index) -> {loss, acc}` (detached fp32 scalars on the
    model's device). `model` is a CustomClip; batch keys: clip_image (B, h,
    w, 3), clip_alpha (B, h, w, 1), label_id (B,), and the TRAIN split's
    prefix, suffix, eot_indices and bank_features."""

    def train_step(batch, step_index: int):
        optimizer.zero_grad(set_to_none=True)
        _, _, pred, logits = model(batch["clip_image"], batch["clip_alpha"], batch["prefix"],
                                   batch["suffix"], batch["eot_indices"],
                                   batch["bank_features"])
        labels = batch["label_id"].long()
        loss = maple_loss(logits, labels)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = schedule(step_index)
        optimizer.step()
        return {"loss": loss.detach(), "acc": (pred == labels).float().mean()}

    return train_step
