"""A synthetic dataset in the OVCamo layout, for smoke runs and tests.

Writes `<root>/{train,test}/{image,mask}/`, `<root>/jsonfile/{class_info,
sample_info}.json` and `<root>/dataset_info.yaml`, the files
`OVCamoIndex.from_dataset_info` reads. Images are smooth random textures
of mixed sizes, masks a random blob each; everything is drawn from `seed`.
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np
import yaml
from PIL import Image

SIZES: Tuple[Tuple[int, int], ...] = ((480, 640), (512, 512), (720, 540), (600, 800),
                                      (384, 576), (300, 420))


def write_synthetic_ovcamo(root: str, n_train: int = 6, n_test: int = 2, seed: int = 0,
                           train_classes: Sequence[str] = ("cat", "owl"),
                           test_classes: Sequence[str] = ("bat", "slug"),
                           sizes: Sequence[Tuple[int, int]] = SIZES) -> str:
    """Write the dataset under `root`; return the dataset_info yaml's path."""
    rng = np.random.default_rng(seed)
    classes = ([{"name": n, "split": "train"} for n in train_classes]
               + [{"name": n, "split": "test"} for n in test_classes])
    samples = []
    for split, n, names in (("train", n_train, train_classes), ("test", n_test, test_classes)):
        for d in ("image", "mask"):
            os.makedirs(os.path.join(root, split, d), exist_ok=True)
        for i in range(n):
            uid = f"{split}{i}"
            h, w = sizes[(i + (split == "test")) % len(sizes)]
            base = rng.integers(0, 255, (max(1, h // 8), max(1, w // 8), 3), dtype=np.uint8)
            Image.fromarray(base).resize((w, h), Image.BILINEAR).save(
                os.path.join(root, split, "image", f"{uid}.jpg"))
            yy, xx = np.mgrid[:h, :w]
            cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
            r = rng.uniform(0.15, 0.3) * min(h, w)
            mask = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.uint8) * 255
            Image.fromarray(mask).save(os.path.join(root, split, "mask", f"{uid}.png"))
            samples.append({"unique_id": uid, "base_class": names[i % len(names)],
                            "image": f"{uid}.jpg", "mask": f"{uid}.png"})
    os.makedirs(os.path.join(root, "jsonfile"), exist_ok=True)
    with open(os.path.join(root, "jsonfile", "class_info.json"), "w") as f:
        json.dump(classes, f)
    with open(os.path.join(root, "jsonfile", "sample_info.json"), "w") as f:
        json.dump(samples, f)
    info = {
        "OVCamo_CLASS_JSON_PATH": os.path.join(root, "jsonfile", "class_info.json"),
        "OVCamo_SAMPLE_JSON_PATH": os.path.join(root, "jsonfile", "sample_info.json"),
        "OVCamo_TR_IMAGE_DIR": os.path.join(root, "train", "image"),
        "OVCamo_TR_MASK_DIR": os.path.join(root, "train", "mask"),
        "OVCamo_TE_IMAGE_DIR": os.path.join(root, "test", "image"),
        "OVCamo_TE_MASK_DIR": os.path.join(root, "test", "mask"),
    }
    path = os.path.join(root, "dataset_info.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(info, f)
    return path
