"""Training checkpoints: model state dict + optimizer state + step.

Counterpart of `camouflaged_vlm_tpu/io/checkpoint.py` (orbax there, one
`torch.save` file here). A resume restores the weights, the AdamW moments
and the step, so the per-epoch schedule continues where it stopped; the
epoch comes from the restored step.

On a mesh (`parallel.make_mesh`) the file is still the full, unsharded state
of the model and the optimizer, the file a one-device run writes: every
rank gathers its model group's shards, rank 0 writes, and the ranks meet at
a barrier after the write. A restore on any mesh loads the full state and
slices it to the rank's shard.
"""

from __future__ import annotations

import os

import torch

from ..parallel.mesh import barrier
from ..parallel.sharding import (
    gather_optimizer_state,
    gather_state_dict,
    shard_optimizer_state,
    shard_state_dict,
)


def save_checkpoint(path: str, model, optimizer, step: int, mesh=None) -> None:
    """Write {model, optimizer, step} to `path` atomically (a temporary
    file, then a rename); on a mesh every rank calls it and rank 0 writes
    the gathered state."""
    state = {"model": gather_state_dict(model, mesh),
             "optimizer": gather_optimizer_state(optimizer, model, mesh), "step": int(step)}
    if mesh is None or mesh.is_main:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
    if mesh is not None:
        barrier()


def restore_checkpoint(path: str, model, optimizer, mesh=None) -> int:
    """Load a checkpoint written by `save_checkpoint` into `model` (strict)
    and `optimizer`, sliced to this rank's shard on a mesh; return its
    step."""
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(shard_state_dict(ckpt["model"], mesh), strict=True)
    optimizer.load_state_dict(shard_optimizer_state(ckpt["optimizer"], optimizer, model, mesh))
    return int(ckpt["step"])
