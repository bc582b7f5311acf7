"""The cascade's optimizer: AdamW, a per-epoch cosine schedule, the freeze rule.

Counterpart of `camouflaged_vlm_tpu/train/optim.py` (the reference recipe):

  * AdamW, lr 2e-4, weight decay 0.01, betas (0.9, 0.999), eps 1e-8 (the
    reference's torch AdamW defaults, which optax.adamw shares), with a
    cosine schedule stepped per epoch (T_max = the run's epochs, eta_min
    1e-7);
  * trainable: the EVP prompt generator inside the SAM encoder, the mask
    decoder, no_mask_embed and the two CLIP->prompt projections; frozen:
    the SAM ViT, the whole Alpha-CLIP tower (with its MaPLe prompt
    learner) and pe_layer, whose Gaussian matrix is a buffer and never a
    parameter.

Freezing is `requires_grad`: the frozen parameters get no gradient, the
kernels' Functions skip their weight-gradient products, and the optimizer
holds state for the trainable ones only.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Tuple

import torch
from torch import nn

# the JAX package's TRAINABLE_SUBTREES as the port's state-dict prefixes
TRAINABLE_PREFIXES: Tuple[str, ...] = (
    "image_encoder.prompt_generator.",
    "mask_decoder.",
    "no_mask_embed.",
    "sam_visual_proj.",
    "sam_text_proj.",
)


def is_trainable(name: str) -> bool:
    return name.startswith(TRAINABLE_PREFIXES)


def trainable_parameters(model: nn.Module) -> List[nn.Parameter]:
    """Set `requires_grad` on exactly the trainable parameters (and clear it
    on every other one); return them in `named_parameters` order."""
    out = []
    for name, p in model.named_parameters():
        p.requires_grad_(is_trainable(name))
        if p.requires_grad:
            out.append(p)
    return out


def cosine_epoch_schedule(base_lr: float = 2e-4, total_epochs: int = 20,
                          steps_per_epoch: int = 1, eta_min: float = 1e-7
                          ) -> Callable[[int], float]:
    """CosineAnnealingLR stepped per epoch: the learning rate of optimizer
    step `step` (constant within an epoch)."""

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, total_epochs)
        return eta_min + 0.5 * (base_lr - eta_min) * (
            1.0 + math.cos(math.pi * epoch / total_epochs))

    return schedule


def make_optimizer(params: Iterable[nn.Parameter], base_lr: float = 2e-4,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over the trainable parameters only (optax's adamw defaults).
    The train step sets the learning rate from the schedule before every
    update. `fused=True` on CUDA: one multi-tensor kernel per update. The
    moments are kept in each parameter's type, as optax keeps them."""
    params = list(params)
    fused = bool(params) and all(p.is_cuda for p in params)
    return torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay, fused=fused or None)
