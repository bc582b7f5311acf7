"""What the CLIs share: the device check and the model's configuration.

Counterpart of the configuration half of `camouflaged_vlm_tpu/cli/common.py`
(`assemble_cascade`): the built-in full or tiny configuration, or a yaml
(`--config`, either format `config.cascade_config_from_yaml` reads), built
with seeded random weights. The checkpoint converters of the JAX package
(`--sam-ckpt/--clip-ckpt/--maple-ckpt/--text-bank`) are not ported;
`--cascade-ckpt` loads a reference-layout state dict strictly.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..config import DTYPES, cascade_config_from_yaml, with_dtype
from ..models import CascadeConfig, OVCOSCascade


def device_or_raise(name: str) -> torch.device:
    """`torch.device(name)`; 'cuda' on a host without a card raises (the CLIs
    never carry on on the CPU unless asked to)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    return device


def cascade_config(config: Optional[str], tiny: bool, dtype: Optional[str]) -> CascadeConfig:
    """The yaml's configuration (`--config`), else the tiny or the full one.
    `dtype` (a key of DTYPES) overrides the compute type; None keeps the
    yaml's, or bfloat16 for the built-in configurations."""
    if config and tiny:
        raise ValueError("--config and --tiny are exclusive")
    if config:
        cfg, _ = cascade_config_from_yaml(config)
        return with_dtype(cfg, DTYPES[dtype]) if dtype else cfg
    dt = DTYPES[dtype or "bfloat16"]
    return CascadeConfig.tiny(dtype=dt) if tiny else CascadeConfig.full(dtype=dt)


def load_cascade_ckpt(model: OVCOSCascade, path: str, device) -> None:
    """A reference-layout cascade state dict (or a train checkpoint's
    'model' entry), loaded strictly."""
    sd = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(sd.get("model", sd), strict=True)



class Logger:
    """Lines to stdout and to <out_dir>/log.txt."""

    def __init__(self, out_dir: str):
        self.path = os.path.join(out_dir, "log.txt")

    def __call__(self, msg: str) -> None:
        print(msg, flush=True)
        with open(self.path, "a") as f:
            f.write(msg + "\n")
