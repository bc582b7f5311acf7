"""Layer normalisation with fp32 statistics.

Counterpart of `camouflaged_vlm_tpu/ops/norms.py`: the statistics and the
affine transform run in fp32 whatever the working type, and the result is
cast back to the input's type. SAM uses eps 1e-6; CLIP, the decoder and the
cascade projections use 1e-5. With NHWC layouts the reference's
`LayerNorm2d` is the same last-axis norm.
"""

from __future__ import annotations

import torch
from torch import nn


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalise the last axis in fp32; return in x.dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class LayerNormFP32(nn.Module):
    """Last-axis LayerNorm with fp32 statistics (`weight`/`bias` keys, as in
    the reference's state dicts)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
