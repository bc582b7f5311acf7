"""Host input pipeline: decode and preprocess in a thread pool, prefetch batches.

The port's copy of `camouflaged_vlm_tpu/data/loader.py` (`iter_eval_batches`,
`iter_train_batches`, `iter_maple_train_batches`), kept so that the port
imports nothing of the JAX package; the CPU tests hold the two to the same
arrays. As in the JAX loader, every sample takes the native path
(`data/native.py`, the C library `csrc/preproc` built at first use: decode,
rot90 fix-up, flips, resample and normalisation with the GIL released) and
gives the PIL path's bytes (tests/test_torch_native_preproc.py).
CVLM_NATIVE_PREPROC=0 chooses PIL for every sample. A sample whose
container the decoder does not take (16-bit PNG, CMYK JPEG) goes through
PIL alone; such samples are counted (`pil_fallbacks`), and the CLIs print
the count.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
from PIL import Image

from . import native
from . import native_pipeline as npp
from .ovcamo import OVCamoIndex, OVCamoSample
from .transforms import (
    clip_alpha_transform,
    clip_image_resized_u8,
    clip_image_transform,
    clip_ones_alpha,
    mask_to_target,
    maybe_rot90_to_match,
    sam_image_resized_u8,
    sam_image_transform,
)


@dataclasses.dataclass
class EvalSample:
    inp: np.ndarray          # (1024, 1024, 3) fp32 normalised, or uint8 raw
    gt: np.ndarray           # (1024, 1024, 1)
    clip_image: np.ndarray   # (336, 336, 3) fp32 normalised, or uint8 raw
    clip_mask: Optional[np.ndarray]  # (336, 336, 1); None in raw_uint8 mode
    label_id: int
    label_name: str
    image_path: str
    mask_path: str
    orig_size: tuple         # (H, W) of the original mask


_fallbacks = [0]
_fallback_lock = threading.Lock()


def pil_fallbacks() -> int:
    """Samples that went through PIL with the native path on, since the last
    `reset_pil_fallbacks`: containers the decoder reports unsupported."""
    return _fallbacks[0]


def reset_pil_fallbacks() -> None:
    with _fallback_lock:
        _fallbacks[0] = 0


def _count_fallback() -> None:
    with _fallback_lock:
        _fallbacks[0] += 1


def _native_pair(image_path: str, mask_path: str, use_native: bool):
    """The decoded (image RGB, mask L) arrays, rot90-fixed, on the native
    path; None where it is off, or (counted) where the decoder does not take
    a container and the sample goes through PIL."""
    if not use_native:
        return None
    pair = npp.decode_pair(image_path, mask_path)
    if pair is None:
        _count_fallback()
    return pair


def _load_eval_sample(sample: OVCamoSample, inp_size: int, clip_size: int,
                      raw_uint8: bool = False, use_native: bool = False) -> EvalSample:
    pair = _native_pair(sample.image_path, sample.mask_path, use_native)
    if pair is not None:
        img_a, mask_a = pair
        if raw_uint8:
            inp = npp.sam_image_resized_u8(img_a, inp_size)
            cimg = npp.clip_image_resized_u8(img_a, clip_size)
            cmask = None
        else:
            inp = npp.sam_image_transform(img_a, inp_size)
            cimg = npp.clip_image_transform(img_a, clip_size)
            cmask = clip_ones_alpha(clip_size)
        return EvalSample(
            inp=inp,
            gt=npp.mask_to_target(mask_a, inp_size),
            clip_image=cimg,
            clip_mask=cmask,
            label_id=sample.class_id,
            label_name=sample.class_label,
            image_path=sample.image_path,
            mask_path=sample.mask_path,
            orig_size=tuple(mask_a.shape[:2]),
        )
    img = Image.open(sample.image_path).convert("RGB")
    mask = Image.open(sample.mask_path).convert("L")
    img = maybe_rot90_to_match(img, mask)
    if raw_uint8:
        # resize-only host work; /255 and the normalisation run on the device
        inp = sam_image_resized_u8(img, inp_size)
        cimg = clip_image_resized_u8(img, clip_size)
        cmask = None  # the constant alpha is built on the device
    else:
        inp = sam_image_transform(img, inp_size)
        cimg = clip_image_transform(img, clip_size)
        cmask = clip_ones_alpha(clip_size)
    return EvalSample(
        inp=inp,
        gt=mask_to_target(mask, inp_size),
        clip_image=cimg,
        clip_mask=cmask,
        label_id=sample.class_id,
        label_name=sample.class_label,
        image_path=sample.image_path,
        mask_path=sample.mask_path,
        orig_size=(mask.size[1], mask.size[0]),
    )


def iter_eval_batches(
    index: OVCamoIndex,
    batch_size: int = 1,
    inp_size: int = 1024,
    clip_size: int = 336,
    num_workers: int = 8,
    prefetch: int = 2,
    raw_uint8: bool = False,
) -> Iterator[List[EvalSample]]:
    """Yield lists of EvalSamples (the last batch may be short). At most
    `num_workers + prefetch * batch_size` samples are decoded ahead, so a
    slow consumer never holds the whole decoded dataset in host memory."""
    use_native = native.enabled()

    def load(s):
        return _load_eval_sample(s, inp_size, clip_size, raw_uint8, use_native)

    batch: List[EvalSample] = []
    for item in _map_bounded(load, index.samples, num_workers,
                             num_workers + prefetch * batch_size):
        batch.append(item)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def _map_bounded(load: Callable, items: Sequence, num_workers: int, window: int) -> Iterator:
    """`pool.map(load, items)` in submission order with at most `window`
    results in flight; `num_workers=0` runs synchronously."""
    if num_workers <= 0:
        for item in items:
            yield load(item)
        return
    window = max(window, 1)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending: deque = deque()
        next_i = 0
        while next_i < len(items) or pending:
            while next_i < len(items) and len(pending) < window:
                pending.append(pool.submit(load, items[next_i]))
                next_i += 1
            yield pending.popleft().result()


def iter_train_batches(
    index: OVCamoIndex,
    batch_size: int,
    rng: np.random.Generator,
    inp_size: int = 1024,
    clip_size: int = 336,
    num_workers: int = 8,
) -> Iterator[dict]:
    """One epoch of shuffled, h-flip-augmented train batches (stacked
    arrays), the reference's TrainDataset semantics: the CLIP crop is taken
    before the flip, flip probability 0.5, nearest-resized GT. The shuffle
    and the flips are drawn on the calling thread (a numpy Generator is not
    thread-safe)."""
    order = rng.permutation(len(index.samples))
    flips = rng.random(len(order)) < 0.5
    use_native = native.enabled()

    def load(args):
        i, flip = args
        s = index.samples[int(i)]
        pair = _native_pair(s.image_path, s.mask_path, use_native)
        if pair is not None:
            img_a, mask_a = pair
            clip_img = npp.clip_image_transform(img_a, clip_size)
            if flip:
                img_a = npp.fliplr(img_a)
                mask_a = npp.fliplr(mask_a)
            return (
                npp.sam_image_transform(img_a, inp_size),
                npp.mask_to_target(mask_a, inp_size),
                clip_img,
                s.class_id,
            )
        img = Image.open(s.image_path).convert("RGB")
        mask = Image.open(s.mask_path).convert("L")
        img = maybe_rot90_to_match(img, mask)
        clip_img = clip_image_transform(img, clip_size)
        if flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
        return (
            sam_image_transform(img, inp_size),
            mask_to_target(mask, inp_size),
            clip_img,
            s.class_id,
        )

    n_full = (len(order) // batch_size) * batch_size
    items = list(zip(order[:n_full], flips[:n_full]))
    stream = _map_bounded(load, items, num_workers, num_workers + 2 * batch_size)
    chunk = []
    for item in stream:
        chunk.append(item)
        if len(chunk) < batch_size:
            continue
        inp, gt, cimg, label = zip(*chunk)
        chunk = []
        yield {
            "inp": np.stack(inp),
            "gt": np.stack(gt),
            "clip_image": np.stack(cimg),
            "clip_mask": np.broadcast_to(
                clip_ones_alpha(clip_size), (batch_size, clip_size, clip_size, 1)
            ).copy(),
            "label_id": np.asarray(label, np.int32),
        }


def iter_maple_train_batches(
    index: OVCamoIndex,
    batch_size: int,
    rng: np.random.Generator,
    clip_size: int = 336,
    num_workers: int = 8,
) -> Iterator[dict]:
    """One epoch of (clip_image, GT-mask alpha, label) batches for MaPLe
    prompt training (the reference's dassl `MaPLeAlphaCLIP` trainer, which
    conditions Alpha-CLIP on the ground-truth mask): shuffled, the flips
    drawn on the calling thread, the rot90 fix, the flip applied to image
    and mask BEFORE both CLIP transforms (unlike `iter_train_batches`), the
    last partial batch dropped."""
    order = rng.permutation(len(index.samples))
    flips = rng.random(len(order)) < 0.5
    use_native = native.enabled()

    def load(args):
        i, flip = args
        s = index.samples[int(i)]
        pair = _native_pair(s.image_path, s.mask_path, use_native)
        if pair is not None:
            img_a, mask_a = pair
            if flip:
                img_a = npp.fliplr(img_a)
                mask_a = npp.fliplr(mask_a)
            return (
                npp.clip_image_transform(img_a, clip_size),
                npp.clip_alpha_transform(mask_a, clip_size),
                s.class_id,
            )
        img = Image.open(s.image_path).convert("RGB")
        mask = Image.open(s.mask_path).convert("L")
        img = maybe_rot90_to_match(img, mask)
        if flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
        return (
            clip_image_transform(img, clip_size),
            clip_alpha_transform(mask, clip_size),
            s.class_id,
        )

    n_full = (len(order) // batch_size) * batch_size
    items = list(zip(order[:n_full], flips[:n_full]))
    chunk = []
    for item in _map_bounded(load, items, num_workers, num_workers + 2 * batch_size):
        chunk.append(item)
        if len(chunk) < batch_size:
            continue
        cimg, alpha, label = zip(*chunk)
        chunk = []
        yield {
            "clip_image": np.stack(cimg),
            "clip_alpha": np.stack(alpha),
            "label_id": np.asarray(label, np.int32),
        }
