"""Host-side image helpers for the eval path.

The port's copy of `camouflaged_vlm_tpu/utils/image.py` kept so that the port
imports nothing of the JAX package; the CPU tests hold the two to the same
results.

`bilinear_resize_f32` reproduces the reference eval's prediction resize —
`cv2.resize(pred_f32, (w, h), interpolation=cv2.INTER_LINEAR)` at
the reference's `test_ovcos_maskdecoder_edge.py:36-42` — without a cv2
dependency: plain separable bilinear with half-pixel centers and edge
clamping, NO antialiasing prefilter (cv2.INTER_LINEAR does not antialias
on downscale; PIL's `Image.resize(..., BILINEAR)` does, which is why PIL
cannot stand in for it). The reference then quantises with
`(pred * 255).astype(np.uint8)` — truncation, not rounding — AFTER the
resize (`test_ovcos_maskdecoder_edge.py:61,131`); callers must preserve
that order or per-image OVCOS metrics drift at bin boundaries.
"""

from __future__ import annotations

import numpy as np


def _axis_weights(n_src: int, n_dst: int):
    """Source indices + lerp weights for one axis (half-pixel mapping)."""
    x = (np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5
    i0 = np.floor(x).astype(np.int64)
    frac = (x - i0).astype(np.float32)
    i1 = np.clip(i0 + 1, 0, n_src - 1)
    i0 = np.clip(i0, 0, n_src - 1)
    return i0, i1, frac


def bilinear_resize_f32(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize a (H, W) float array to (height, width), cv2.INTER_LINEAR
    semantics (half-pixel centers, edge clamp, no antialias)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if h == height and w == width:
        return img
    j0, j1, fx = _axis_weights(w, width)
    rows = img[:, j0] * (1.0 - fx) + img[:, j1] * fx
    i0, i1, fy = _axis_weights(h, height)
    out = rows[i0] * (1.0 - fy)[:, None] + rows[i1] * fy[:, None]
    return out.astype(np.float32)
