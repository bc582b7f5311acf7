"""Random-Fourier dense positional encoding for the mask decoder.

Counterpart of `camouflaged_vlm_tpu/models/position_embedding.py`. The
(2, C/2) Gaussian matrix is a buffer, as in the reference, and is restored
from checkpoints under `pe_layer.positional_encoding_gaussian_matrix`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from ..ops.constants import device_constant


@functools.lru_cache(maxsize=None)
def _coords(size: int, device: torch.device) -> torch.Tensor:
    """The grid's cell centres on `device`, copied there once (a copy from
    pageable host memory at every call would make the host wait for the
    card)."""
    return device_constant((np.arange(size, dtype=np.float32) + 0.5) / size, device)


def random_position_embedding(gaussian_matrix: torch.Tensor, size: int) -> torch.Tensor:
    """gaussian_matrix (2, C/2) -> (size, size, C) fp32 PE grid."""
    coords = _coords(size, gaussian_matrix.device)
    y = coords[:, None].expand(size, size)
    x = coords[None, :].expand(size, size)
    grid = torch.stack([x, y], dim=-1)  # (H, W, 2), order (x, y)
    proj = 2.0 * math.pi * ((2.0 * grid - 1.0) @ gaussian_matrix.float())
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.register_buffer(
            "positional_encoding_gaussian_matrix", torch.zeros(2, num_pos_feats)
        )

    def forward(self, size: int) -> torch.Tensor:
        return random_position_embedding(self.positional_encoding_gaussian_matrix, size)
