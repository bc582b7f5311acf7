"""What the CLIs share: the device checks, the model's configuration, and the
model's weights and class bank from the reference's files.

Counterpart of `camouflaged_vlm_tpu/cli/common.py` (`assemble_cascade`): the
built-in full or tiny configuration, or a yaml (`--config`, either format
`config.cascade_config_from_yaml` reads), built with seeded random weights
(`factory.build_cascade`), then `load_checkpoints` restores what the
checkpoint flags name, in the reference's order
(`test_ovcos_maskdecoder_edge.py:180-189`, `train_ovcos_maskdecoder_edge.py:266-303`):

  --clip-ckpt    the OpenAI CLIP archive (`ViT-L-14-336px.pt`): both CLIP
                 towers and the token embedding the class banks read;
  --maple-ckpt   the dassl MaPLe prompt learner (`model-best.pth.tar`);
  --sam-ckpt     the SAM backbone (`sam_vit_h_4b8939.pth`);
  --cascade-ckpt a reference-layout cascade state dict (or a train
                 checkpoint's 'model'), loaded strictly, last;
  --text-bank    the frozen text-feature bank (`.npy` or a single-tensor
                 `.pth`) of the class split.

Each file is read to the CPU and copied into the model one tensor at a
time, cast to the type the model holds it in; for the weights of rank >= 2,
already in the compute type, that is the JAX package's cast after the last
merge (a file's value rounded once). Checkpoint flags take local files:
the port downloads nothing, and a model-zoo name, a URL or a missing path
raises (the JAX package resolves the first two and skips a missing file).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..config import DTYPES, cascade_config_from_yaml, with_dtype
from ..factory import make_bank_inputs
from ..io.convert import (
    convert_maple_prompt_learner,
    convert_openai_clip,
    convert_sam_backbone,
    merge_into_state,
)
from ..io.torch_loader import (
    load_dassl_checkpoint,
    load_openai_clip_state_dict,
    load_text_bank,
    load_torch_state_dict,
)
from ..models import CascadeConfig, OVCOSCascade

# The kernels with no fp32 instance yet (ROADMAP Queue 2), in the order to
# port them: MaPLe training's first, then SAM's, then the other paths'.
# The LN+MLP+residual kernel (#4/#5) has one.
NO_FP32_KERNEL = ("#2 ln_linear_act_bt", "#7 proj_rows", "#16 flash_qkv_packed_plain",
                  "#6 ln_mlp_residual_bt_bwd", "#1 linear_act", "#3 ln_mask_linear_bt",
                  "#13 flash_qkv_packed_windows_s", "#15 flash_qkv_packed_edge",
                  "#17 flash_qkv_packed_global", "#8 proj_from_heads_res",
                  "#10 flash_attention_relpos", "#11 flash_qkv_relpos_windows",
                  "#12 flash_qkv_packed_windows", "#14 and #18 (the attention backward)",
                  "#20 flash_attention_fullk")


def refuse_fp32_on_card(device: str, cfg: CascadeConfig) -> None:
    """Raise at once when the cascade would run in fp32 on a card: its
    kernels take bfloat16 (but #4/#5), and no path falls back to the plain
    versions."""
    dtypes = (cfg.encoder.dtype, cfg.decoder.dtype, cfg.clip.dtype)
    if torch.device(device).type == "cuda" and torch.float32 in dtypes:
        raise NotImplementedError(
            f"--device {device} with float32: the cascade's kernels take bfloat16; no fp32 "
            f"instance yet of {', '.join(NO_FP32_KERNEL)} (ROADMAP.md Queue 2). Run "
            "--dtype bfloat16 on the card, or float32 with --device cpu.")


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


def add_checkpoint_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cascade-ckpt", default=None,
                   help="reference-layout cascade state dict (.pth), loaded strict, last")
    p.add_argument("--sam-ckpt", default=None, help="SAM backbone (sam_vit_h_4b8939.pth)")
    p.add_argument("--clip-ckpt", default=None,
                   help="OpenAI CLIP TorchScript archive (ViT-L-14-336px.pt)")
    p.add_argument("--maple-ckpt", default=None,
                   help="dassl MaPLe prompt learner (model-best.pth.tar)")
    p.add_argument("--text-bank", default=None,
                   help="the class split's text-feature bank (.npy or single-tensor .pth)")


def local_file(path: str, flag: str) -> str:
    """`path` if it is a file; anything else (a missing path, a model-zoo
    name, a URL) raises."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{flag} {path!r}: no such file (checkpoint flags take local "
                                "paths; the port downloads nothing)")
    return path


BankBuilder = Callable[[Sequence[str], Optional[str]], Dict[str, torch.Tensor]]


def load_checkpoints(model: OVCOSCascade, cfg: CascadeConfig, *,
                     clip_ckpt: Optional[str] = None, maple_ckpt: Optional[str] = None,
                     sam_ckpt: Optional[str] = None, cascade_ckpt: Optional[str] = None,
                     seed: int = 0, log: Callable[[str], None] = print) -> BankBuilder:
    """Restore the named files into `model` (OpenAI CLIP -> MaPLe -> SAM ->
    cascade) and return `make_bank(classnames, bank_path=None)`, the class
    bank (`factory.make_bank_inputs`) on the model's device with the CLIP
    file's token embedding and the bank file's features (random ones, drawn
    from `seed`, where a file is not given). Call it before
    `factory.attach_rel_cache`."""
    device = next(model.parameters()).device
    token_embedding = None
    if clip_ckpt:
        sd = load_openai_clip_state_dict(local_file(clip_ckpt, "--clip-ckpt"))
        entries, token_embedding, missing = convert_openai_clip(sd, cfg.clip)
        merge_into_state(model, entries)
        log(f"[assemble] OpenAI CLIP loaded from {clip_ckpt} (missing={len(missing)})")
    if maple_ckpt:
        sd, extras = load_dassl_checkpoint(local_file(maple_ckpt, "--maple-ckpt"))
        entries, _ = convert_maple_prompt_learner(sd, cfg.clip)
        merge_into_state(model, entries)
        log(f"[assemble] MaPLe prompt learner from {maple_ckpt} (epoch={extras.get('epoch')})")
    if sam_ckpt:
        sd = load_torch_state_dict(local_file(sam_ckpt, "--sam-ckpt"))
        entries, _ = convert_sam_backbone(sd, cfg)
        merge_into_state(model, entries)
        log(f"[assemble] SAM backbone from {sam_ckpt} ({len(entries)} tensors)")
    if cascade_ckpt:  # a reference-layout state dict, or a train checkpoint's 'model'
        sd = load_torch_state_dict(local_file(cascade_ckpt, "--cascade-ckpt"))
        model.load_state_dict(sd.get("model", sd), strict=True)
        log(f"[assemble] cascade weights from {cascade_ckpt}")

    def make_bank(classnames: Sequence[str], bank_path: Optional[str] = None):
        feats: Optional[np.ndarray] = None
        if bank_path:
            feats = load_text_bank(local_file(bank_path, "--text-bank"))
            log(f"[assemble] text-feature bank {feats.shape} from {bank_path}")
        return make_bank_inputs(cfg, classnames, token_embedding=token_embedding,
                                bank_features=feats, seed=seed, device=device)

    return make_bank


class Logger:
    """Lines to stdout and to <out_dir>/log.txt."""

    def __init__(self, out_dir: str):
        self.path = os.path.join(out_dir, "log.txt")

    def __call__(self, msg: str) -> None:
        print(msg, flush=True)
        with open(self.path, "a") as f:
            f.write(msg + "\n")
