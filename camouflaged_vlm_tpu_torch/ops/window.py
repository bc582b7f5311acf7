"""Window partition / unpartition for windowed ViT attention.

Counterpart of `camouflaged_vlm_tpu/ops/window.py`, the padded layout: at
ViT-H the 64x64 grid pads to 70x70, 25 windows of 14x14 per image. The
encoder keeps activations in the window-major sequence layout across a run
of windowed blocks, and `window_valid_mask` re-zeroes the pad tokens after
each LN1.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .constants import device_constant


def window_partition(x: torch.Tensor, window: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nWin, window, window, C), plus padded (Hp, Wp)."""
    B, H, W, C = x.shape
    pad_h = (window - H % window) % window
    pad_w = (window - W % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C)
    return x, (Hp, Wp)


def window_unpartition(
    windows: torch.Tensor, window: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]
) -> torch.Tensor:
    """Inverse of `window_partition`; crops the padding back to (H, W)."""
    Hp, Wp = pad_hw
    H, W = hw
    C = windows.shape[-1]
    B = windows.shape[0] // ((Hp // window) * (Wp // window))
    x = windows.reshape(B, Hp // window, Wp // window, window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W, :]


def window_partition_seq(x: torch.Tensor, window: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nWin, window*window, C) plus padded (Hp, Wp)."""
    xw, pad_hw = window_partition(x, window)
    return xw.reshape(xw.shape[0], window * window, x.shape[-1]), pad_hw


def window_unpartition_seq(
    xw: torch.Tensor, window: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]
) -> torch.Tensor:
    """Inverse of `window_partition_seq` (crops back to hw)."""
    return window_unpartition(
        xw.reshape(xw.shape[0], window, window, xw.shape[-1]), window, pad_hw, hw
    )


@functools.lru_cache(maxsize=None)
def window_valid_mask(H: int, W: int, window: int, device=None) -> torch.Tensor:
    """(nWin, window*window, 1) fp32 0/1 mask of the tokens inside (H, W),
    built once per shape and device (a copy from pageable host memory at
    every call would make the host wait for the card); callers must not
    write to it."""
    Hp = -(-H // window) * window
    Wp = -(-W // window) * window
    m = ((np.arange(Hp)[:, None] < H) & (np.arange(Wp)[None, :] < W)).astype(np.float32)
    m = m.reshape(Hp // window, window, Wp // window, window)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window * window, 1)
    return device_constant(m, device)
