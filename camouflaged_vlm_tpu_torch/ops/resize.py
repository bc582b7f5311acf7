"""Bilinear resize with torch's `F.interpolate(align_corners=False)`
semantics and no antialiasing (which `F.interpolate(antialias=True)` would
add), as two separable interpolation-matrix products.

Counterpart of `camouflaged_vlm_tpu/ops/resize.py`: used for the decoder's
256 -> 1024 mask upsample and the 1024 -> 336 alpha hand-off.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .constants import device_constant


@lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) matrix M with M @ x = bilinear resample of x."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == out_size:
        np.fill_diagonal(m, 1.0)
        return m
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        src_clamped = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src_clamped))
        hi = min(lo + 1, in_size - 1)
        frac = src_clamped - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


@lru_cache(maxsize=None)
def _interp_matrix_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """`_interp_matrix` on `device`, copied there once: a copy from pageable
    host memory at every call would make the host wait for the card."""
    return device_constant(_interp_matrix(in_size, out_size), device)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize (B, H, W, C) spatially; computed in fp32, returned in x.dtype."""
    _, H, W, _ = x.shape
    mh = _interp_matrix_on(H, out_h, x.device)
    mw = _interp_matrix_on(W, out_w, x.device)
    y = torch.einsum("oh,bhwc->bowc", mh, x.float())
    y = torch.einsum("ow,bhwc->bhoc", mw, y)
    return y.to(x.dtype)
