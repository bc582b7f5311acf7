"""Sample-level preprocessing on the native (libcvtpre) path.

The port's copy of `camouflaged_vlm_tpu/data/native_pipeline.py`, function
for function: `data/transforms.py` on uint8 HWC numpy arrays, with the same
resample filters, the same fp32 normalisation order and the same
torchvision shorter-side / center-crop geometry, so that every output is
bit-identical to the PIL path (tests/test_torch_native_preproc.py asserts
this per function and per assembled sample, against the port's PIL path
and the JAX package's loader). The loaders take this path unless
CVLM_NATIVE_PREPROC=0, and fall back to PIL per sample only where the
decoder reports the container unsupported (16-bit PNG, CMYK JPEG).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import native as nat
from .transforms import (
    CLIP_ALPHA_MEAN,
    CLIP_ALPHA_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    _center_crop,
)


def available() -> bool:
    """Whether the native path is on (`native.enabled`); the library is
    built at its first call, and a failed build raises."""
    return nat.enabled()


def decode_pair(
    image_path: str, mask_path: str
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode (image as RGB u8 HW3, mask as L u8 HW1) with the reference's
    rot90 fix-up when their sizes differ (`transforms.maybe_rot90_to_match`).
    None: the caller falls back to PIL (a container the decoder does not
    take)."""
    img = nat.decode_file(image_path, 3)
    if img is None:
        return None
    mask = nat.decode_file(mask_path, 1)
    if mask is None:
        return None
    if img.shape[:2] != mask.shape[:2]:
        img = nat.rot90ccw(img)
    return img, mask


def sam_image_transform(img: np.ndarray, size: int = 1024) -> np.ndarray:
    """transforms.sam_image_transform on a u8 HW3 array (fused native
    resize+normalise)."""
    return nat.normalize(
        nat.resize(img, (size, size), nat.BILINEAR), IMAGENET_MEAN, IMAGENET_STD
    )


def sam_image_resized_u8(img: np.ndarray, size: int = 1024) -> np.ndarray:
    return nat.resize(img, (size, size), nat.BILINEAR)


def mask_to_target(mask: np.ndarray, size: int = 1024) -> np.ndarray:
    """transforms.mask_to_target: NEAREST resize then /255 (normalize with
    mean 0 / std 1 is exactly arr/255.0f in the same fp32 order)."""
    return nat.normalize(
        nat.resize(mask, (size, size), nat.NEAREST),
        np.zeros(1, np.float32),
        np.ones(1, np.float32),
    )


def _shorter_side_size(w: int, h: int, n_px: int) -> Tuple[int, int]:
    # torchvision F.resize(int): truncated long side (transforms.py:54-65)
    if w <= h:
        return n_px, max(1, int(h * n_px / w))
    return max(1, int(w * n_px / h)), n_px


def clip_image_transform(img: np.ndarray, n_px: int = 336) -> np.ndarray:
    new_w, new_h = _shorter_side_size(img.shape[1], img.shape[0], n_px)
    resized = nat.resize(img, (new_w, new_h), nat.BICUBIC)
    return nat.normalize(
        _center_crop(resized, n_px), OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
    )


def clip_image_resized_u8(img: np.ndarray, n_px: int = 336) -> np.ndarray:
    new_w, new_h = _shorter_side_size(img.shape[1], img.shape[0], n_px)
    return np.ascontiguousarray(
        _center_crop(nat.resize(img, (new_w, new_h), nat.BICUBIC), n_px)
    )


def clip_alpha_transform(mask: np.ndarray, n_px: int = 336) -> np.ndarray:
    new_w, new_h = _shorter_side_size(mask.shape[1], mask.shape[0], n_px)
    resized = nat.resize(mask, (new_w, new_h), nat.BICUBIC)
    return nat.normalize(
        np.ascontiguousarray(_center_crop(resized, n_px)),
        np.full(1, CLIP_ALPHA_MEAN, np.float32),
        np.full(1, CLIP_ALPHA_STD, np.float32),
    )


def fliplr(arr: np.ndarray) -> np.ndarray:
    return nat.fliplr(arr)
