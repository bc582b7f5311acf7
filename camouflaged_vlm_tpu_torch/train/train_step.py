"""The training step: forward, loss, backward, one AdamW update.

Counterpart of `camouflaged_vlm_tpu/train/train_step.py`. The frozen
parameters carry `requires_grad=False` (`optim.trainable_parameters`), so
autograd computes no gradient for them and the kernels' Functions skip
their weight-gradient products. With `accum_steps > 1` the batch's image
tensors arrive with a leading microbatch axis (A, B/A, ...), the step runs
forward and backward per microbatch, sums the gradients, divides by A and
makes one update; the metrics are the microbatch means.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from .losses import segmentation_loss

# batch tensors with a per-image leading axis (a microbatch axis under
# accumulation); the rest (text features) is shared by all microbatches
SCANNED_BATCH_KEYS = ("inp", "gt", "clip_image", "clip_mask")


def make_train_step(
    model,
    optimizer: torch.optim.Optimizer,
    schedule: Callable[[int], float],
    loss_mode: str = "iou",
    accum_steps: int = 1,
) -> Callable[[Dict[str, torch.Tensor], int], Dict[str, torch.Tensor]]:
    """`step(batch, step_index) -> {loss, loss_mask, loss_edge}` (detached
    fp32 scalars on the model's device). batch keys: inp (B, H, W, 3), gt
    (B, H, W, 1), clip_image (B, h, w, 3), clip_mask (B, h, w, 1), and
    either text_features (N, D) or prefix/suffix/eot_indices/bank_features
    (the prompt-bank path)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def loss_of(batch):
        args = (batch["inp"], batch["clip_image"], batch["clip_mask"])
        if "text_features" in batch:
            masks, edges = model.forward_with_text(*args, batch["text_features"])
        else:
            masks, edges = model(*args, batch["prefix"], batch["suffix"],
                                 batch["eot_indices"], batch["bank_features"])
        total, parts = segmentation_loss(masks, edges, batch["gt"], loss_mode)
        return total, parts

    def update(step_index: int):
        for group in optimizer.param_groups:
            group["lr"] = schedule(step_index)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    def train_step(batch, step_index: int):
        optimizer.zero_grad(set_to_none=True)
        total, parts = loss_of(batch)
        total.backward()
        update(step_index)
        return {"loss": total.detach(), **{k: v.detach() for k, v in parts.items()}}

    if accum_steps == 1:
        return train_step

    def train_step_accum(batch, step_index: int):
        for k in SCANNED_BATCH_KEYS:
            # a mismatched leading axis would mis-scale the gradient average
            if batch[k].shape[0] != accum_steps:
                raise ValueError(
                    f"batch['{k}'] leading dim {batch[k].shape[0]} != accum_steps "
                    f"{accum_steps}: reshape to (accum, B/accum, ...) first")
        optimizer.zero_grad(set_to_none=True)
        metrics = []
        for a in range(accum_steps):
            mb = {k: (v[a] if k in SCANNED_BATCH_KEYS else v) for k, v in batch.items()}
            total, parts = loss_of(mb)
            total.backward()  # gradients sum over the microbatches
            metrics.append({"loss": total.detach(), **{k: v.detach() for k, v in parts.items()}})
        for p in params:
            if p.grad is not None:
                p.grad.div_(accum_steps)
        update(step_index)
        return {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}

    return train_step_accum
