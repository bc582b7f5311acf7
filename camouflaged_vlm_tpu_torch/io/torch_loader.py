"""Readers of the reference's checkpoint files -> torch tensors on the CPU.

Counterpart of `camouflaged_vlm_tpu/io/torch_loader.py`. The reference
ships or loads four torch formats:

  1. `sam_vit_h_4b8939.pth`          plain state dict (SAM backbone)
  2. `model_epoch_best.pth`          plain state dict (trained cascade)
  3. OpenAI CLIP `ViT-L-14-336px.pt` TorchScript archive
  4. `model-best.pth.tar`            dassl dict {'state_dict', 'epoch', ...}

and its text-feature banks as `.pth` single tensors (the port also reads
`.npy`). Every reader loads to the CPU (`map_location="cpu"`), memory-mapped
where the file is a zip archive, so that a 2.5-GB SAM file is never staged
on the device whole: the caller copies one tensor at a time into the
model's parameters. Tensors keep the file's type.

Formats 1 and 2 and the banks hold tensors only and are unpickled with
`weights_only=True`. The OpenAI archive's `torch.load` fallback and the
dassl checkpoint hold other Python objects (the optimizer's and
scheduler's state, the epoch) and are unpickled with `weights_only=False`,
as the JAX package's loader does: load only files of a trusted source.
"""

from __future__ import annotations

import zipfile
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _load(path: str, weights_only: bool):
    return torch.load(path, map_location="cpu", weights_only=weights_only,
                      mmap=zipfile.is_zipfile(path))


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """A plain `torch.save`d state dict (formats 1 and 2), unwrapped from
    {'state_dict': ...} when the file holds one."""
    obj = _load(path, weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj and not torch.is_tensor(
            next(iter(obj.values()), None)):
        obj = obj["state_dict"]
    return obj


def load_openai_clip_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The OpenAI CLIP `.pt`: a TorchScript archive, else a pickled state
    dict (the reference's order, `cocotrainers/mapleAlphaCLIP.py:34-41`),
    without the archive's `input_resolution`, `context_length` and
    `vocab_size` entries."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not a TorchScript archive
        sd = _load(path, weights_only=False)
    sd = dict(sd)
    for k in ("input_resolution", "context_length", "vocab_size"):
        sd.pop(k, None)
    return sd


def load_dassl_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """A dassl checkpoint -> (its state dict, the other entries: epoch, ...)."""
    ckpt = _load(path, weights_only=False)
    extras = {k: v for k, v in ckpt.items() if k != "state_dict"}
    return ckpt["state_dict"], extras


def load_text_bank(path: str) -> np.ndarray:
    """A frozen text-feature bank (num_classes, embed_dim) as fp32 numpy:
    `.npy`, or a single tensor saved with `torch.save`."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    return _load(path, weights_only=True).detach().float().numpy()
