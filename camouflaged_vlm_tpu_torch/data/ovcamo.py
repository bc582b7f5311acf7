"""OVCamo dataset index.

The port's copy of `camouflaged_vlm_tpu/data/ovcamo.py` kept so that the port
imports nothing of the JAX package; the CPU tests hold the two to the same
results.

Equivalent of the reference's `ImageFolder`
(the reference's `datasets/image_folder.py:10-101`): read `class_info.json`
(class -> split) and `sample_info.json`, keep samples whose base class
belongs to the requested split, and resolve image/mask paths by unique id.

Splits: 14 seen (train) classes / 61 unseen (test) classes
(the reference's `datasets/ovcamo_info/class_names.py`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

TRAIN_CLASS_NAMES: List[str] = [
    "mantis", "owl", "grasshopper", "katydid", "snake", "spider", "lizard",
    "snow leopard", "human", "seahorse", "pipefish", "flatfish", "frog",
    "succulent plant",
]

TEST_CLASS_NAMES: List[str] = [
    "owlfly larva", "grouse", "frogmouth", "bat", "bee",
    "bittern", "mockingbird", "dragonfly", "heron", "egyptian nightjar",
    "potoo", "cicada", "butterfly", "moth", "slug",
    "reccoon", "monkey", "kangaroo", "mongoose", "lion",
    "elephant", "jerboa", "snail", "duck", "cheetah",
    "giraffe", "ant", "beetle", "wolf", "rabbit",
    "tiger", "squirrel", "polar bear", "deer", "dog",
    "scorpion", "arctic fox", "goat", "hedgehog", "chameleon",
    "leopard", "worm", "stick insect", "cat", "crocodilefish",
    "batfish", "clownfish", "frogfish", "seadragon", "stingaree",
    "crocodile", "starfish", "hermit crab", "cuttlefish", "shrimp",
    "seal", "crab", "octopus", "turtle", "scorpionfish", "non-succulent plant",
]


@dataclasses.dataclass
class OVCamoSample:
    class_label: str
    class_id: int
    image_path: str
    mask_path: str


@dataclasses.dataclass
class OVCamoIndex:
    """Resolved (class, image, mask) triples for one split."""

    split: str
    classes: List[str]
    samples: List[OVCamoSample]

    def __len__(self) -> int:
        return len(self.samples)

    @classmethod
    def from_dataset_info(
        cls, dataset_info: Dict[str, str], split: str
    ) -> "OVCamoIndex":
        """dataset_info keys follow the reference's splitted_ovcamo.yaml:
        OVCamo_CLASS_JSON_PATH, OVCamo_SAMPLE_JSON_PATH,
        OVCamo_{TR,TE}_{IMAGE,MASK}_DIR."""
        with open(dataset_info["OVCamo_CLASS_JSON_PATH"], encoding="utf-8") as f:
            class_infos = json.load(f)
        with open(dataset_info["OVCamo_SAMPLE_JSON_PATH"], encoding="utf-8") as f:
            sample_infos = json.load(f)

        classes = [ci["name"] for ci in class_infos if ci["split"] == split]
        img_dir = dataset_info[
            "OVCamo_TR_IMAGE_DIR" if split == "train" else "OVCamo_TE_IMAGE_DIR"
        ]
        mask_dir = dataset_info[
            "OVCamo_TR_MASK_DIR" if split == "train" else "OVCamo_TE_MASK_DIR"
        ]

        samples: List[OVCamoSample] = []
        for si in sample_infos:
            name = si["base_class"]
            if name not in classes:
                continue
            uid = si["unique_id"]
            img_ext = os.path.splitext(si["image"])[1]
            mask_ext = os.path.splitext(si["mask"])[1]
            samples.append(
                OVCamoSample(
                    class_label=name,
                    class_id=classes.index(name),
                    image_path=os.path.join(img_dir, uid + img_ext),
                    mask_path=os.path.join(mask_dir, uid + mask_ext),
                )
            )
        return cls(split=split, classes=classes, samples=samples)
