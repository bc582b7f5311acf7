"""Training losses for the cascade.

Counterpart of `camouflaged_vlm_tpu/train/losses.py` (the reference's loss
stack):

  total = BCEWithLogits(mask, gt) + softIoU(mask, gt)
        + dice(edge_prob, morphological_edge(gt))

All tensors are NHWC (B, H, W, 1); every reduction runs in fp32. The edge
target is detached. With a data-parallel `mesh` each rank holds its rows of
the batch: the losses that are means of per-image terms need nothing more
(ranks with equal rows average to the global mean in the train step), but
the balanced BCE's class counts are the whole batch's, as GSPMD computes
them in the JAX package, so they are summed over the data group.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.pooling import morphological_edge
from ..parallel.mesh import all_reduce_


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits, the numerically stable form."""
    x, t = logits.float(), targets.float()
    return (x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def balanced_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                             mesh=None) -> torch.Tensor:
    """Class-balanced BCE (reference `BBCEWithLogitLoss`): pos_weight =
    neg/pos, overall weight pos/(pos+neg), the counts over the whole batch
    (summed over `mesh`'s data group when its ranks hold rows of it)."""
    x, t = logits.float(), targets.float()
    counts = torch.stack([t.sum(), (1.0 - t).sum()]).detach()
    if mesh is not None and mesh.n_data > 1:
        all_reduce_(counts, mesh.data_group)
    count_pos = counts[0] + 1e-10
    count_neg = counts[1]
    ratio = count_neg / count_pos
    w_neg = count_pos / (count_pos + count_neg)
    loss = -(ratio * t * F.logsigmoid(x) + (1.0 - t) * F.logsigmoid(-x))
    return w_neg * loss.mean()


def soft_iou_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """1 - soft IoU over the spatial axes, averaged over batch and channels."""
    pred, t = torch.sigmoid(logits.float()), targets.float()
    inter = (pred * t).sum(dim=(1, 2))
    union = (pred + t).sum(dim=(1, 2)) - inter
    return (1.0 - inter / union).mean()


def soft_dice_loss(probs: torch.Tensor, targets: torch.Tensor, smooth: float = 1.0,
                   p: float = 2.0) -> torch.Tensor:
    """Per-sample flattened soft dice (reference `soft_dice_loss`)."""
    B = probs.shape[0]
    pr, t = probs.float().reshape(B, -1), targets.float().reshape(B, -1)
    num = 2.0 * (pr * t).sum(1) + smooth
    den = (pr ** p + t ** p).sum(1) + smooth
    return (1.0 - num / den).mean()


def edge_dice_loss(edge_probs: torch.Tensor, edge_targets: torch.Tensor) -> torch.Tensor:
    """Dice loss on the (already sigmoided) edge prediction."""
    return soft_dice_loss(edge_probs, edge_targets)


def segmentation_loss(
    mask_logits: torch.Tensor,
    edge_probs: torch.Tensor,
    gt_mask: torch.Tensor,
    loss_mode: str = "iou",
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference loss: (total, {loss_mask, loss_edge}); `mesh` as in
    `balanced_bce_with_logits`."""
    if loss_mode == "bce":
        loss_mask = bce_with_logits(mask_logits, gt_mask)
    elif loss_mode == "bbce":
        loss_mask = balanced_bce_with_logits(mask_logits, gt_mask, mesh)
    elif loss_mode == "iou":
        loss_mask = bce_with_logits(mask_logits, gt_mask) + soft_iou_loss(mask_logits, gt_mask)
    else:
        raise ValueError(f"unknown loss mode {loss_mode!r}")
    edge_gt = morphological_edge(gt_mask.float().detach(), 5)
    loss_edge = edge_dice_loss(edge_probs, edge_gt)
    return loss_mask + loss_edge, {"loss_mask": loss_mask, "loss_edge": loss_edge}
