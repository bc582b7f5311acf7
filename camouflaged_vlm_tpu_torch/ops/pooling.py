"""Max pooling and the morphological edge target, on NHWC tensors.

Counterpart of `camouflaged_vlm_tpu/ops/pooling.py`: the reference derives
the edge ground truth from the mask as dilation minus erosion, both
max-pools of kernel 5, stride 1, same padding (the padding never wins a
max, as `lax.reduce_window`'s -inf init).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2d(x: torch.Tensor, kernel: int, stride: int = 1) -> torch.Tensor:
    """Same-padded max pool over the spatial axes of (B, H, W, C)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride, padding=kernel // 2)
    return y.permute(0, 2, 3, 1)


def morphological_edge(mask: torch.Tensor, kernel: int = 5) -> torch.Tensor:
    """Edge target: (dilate(mask) - erode(mask)) > 0, in mask's type.
    mask: (B, H, W, C) in [0, 1]."""
    dilated = max_pool_2d(mask, kernel)
    eroded = -max_pool_2d(-mask, kernel)
    return (dilated - eroded > 0).to(mask.dtype)
