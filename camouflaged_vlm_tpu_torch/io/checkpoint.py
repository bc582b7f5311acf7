"""Training checkpoints: model state dict + optimizer state + step.

Counterpart of `camouflaged_vlm_tpu/io/checkpoint.py` (orbax there, one
`torch.save` file here). A resume restores the weights, the AdamW moments
and the step, so the per-epoch schedule continues where it stopped; the
epoch comes from the restored step.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, model, optimizer, step: int) -> None:
    """Write {model, optimizer, step} to `path` atomically (a temporary
    file, then a rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": int(step)}, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, model, optimizer) -> int:
    """Load a checkpoint written by `save_checkpoint` into `model` (strict)
    and `optimizer`; return its step."""
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(ckpt["model"], strict=True)
    optimizer.load_state_dict(ckpt["optimizer"])
    return int(ckpt["step"])
