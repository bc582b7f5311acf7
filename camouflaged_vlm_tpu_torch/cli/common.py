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
from typing import Callable, Dict, List, Optional, Sequence

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
from ..models.sam_encoder import fused_attention_enabled
from ..ops import _cuda
from ..parallel import init_distributed, make_mesh
from ..ops.compact_window import REL_LANES, CompactGeometry

# The TPU kernel number of each kernel wrapper, by the name its launch count
# carries (PERF.md section 6)
TPU_KERNEL = {
    "linear_act": "#1", "ln_linear_act_bt": "#2", "ln_mask_linear_bt": "#3",
    "ln_mlp_residual_bt": "#4/#5", "ln_mlp_residual_bt_bwd": "#6", "proj_rows": "#7",
    "proj_from_heads_res": "#8", "flash_attention_relpos": "#10",
    "flash_qkv_relpos_windows": "#11", "flash_qkv_packed_windows": "#12",
    "flash_qkv_packed_windows_s": "#13", "flash_qkv_packed_windows_s_bwd": "#14",
    "flash_qkv_packed_edge": "#15", "flash_qkv_packed_plain": "#16",
    "flash_qkv_packed_global": "#17", "flash_qkv_packed_global_bwd": "#18",
    "flash_attention_fullk": "#20",
}


def cascade_kernels(cfg: CascadeConfig, training: bool = False) -> List[str]:
    """The kernels (by wrapper name) the cascade's routes launch on the card
    for this configuration, in TPU-kernel order; with `training`, the
    backward kernels of the train CLI too. SAM's blocks follow the
    encoder's routes (`sam_encoder.Attention.fused_route`, as in the JAX
    package): the fused 'flash' windows on the compact carry (#2, #13, #15
    where the grid leaves edge windows, #7), off it (LN1 + mask + qkv #3,
    then #12 at H+W <= 32, #11 + #8 beyond, or #17 for a global block of >
    512 tokens); unfused 'flash' on #10; 'aug_flash' (and 'flash' without
    rel-pos) on #20 for blocks of >= 1024 tokens. The patch embed (#1), the
    MLPs (#4/#5) and CLIP's vision blocks (#2, #16, #7) run in every
    configuration."""
    enc = cfg.encoder
    out = {"linear_act", "ln_linear_act_bt", "flash_qkv_packed_plain", "proj_rows",
           "ln_mlp_residual_bt"}
    g, win = enc.grid, enc.window_size
    glob = set(enc.global_attn_indexes)
    kinds = {win > 0 and i not in glob for i in range(enc.depth)}  # windowed or global
    fused = fused_attention_enabled(enc.attn_impl, enc.use_rel_pos, enc.num_heads)
    for windowed in kinds:
        if windowed and fused and CompactGeometry(g, g, win).supported():
            out.add("flash_qkv_packed_windows_s")
            if CompactGeometry(g, g, win).has_edge:
                out.add("flash_qkv_packed_edge")
            continue
        nwin, side = ((-(-g // win)) ** 2, win) if windowed else (1, g)
        if fused:
            out.add("ln_mask_linear_bt")
            if nwin > 1 or side * side <= 512:
                out.update(("flash_qkv_packed_windows",) if 2 * side <= REL_LANES
                           else ("flash_qkv_relpos_windows", "proj_from_heads_res"))
            else:
                out.add("flash_qkv_packed_global")
        elif enc.attn_impl == "flash" and enc.use_rel_pos:
            out.add("flash_attention_relpos")
        elif enc.attn_impl in ("aug_flash", "flash") and side * side >= 1024:
            out.add("flash_attention_fullk")
    if training:  # the hand-written backwards; the others take plain VJPs
        out.add("ln_mlp_residual_bt_bwd")
        for fwd in ("flash_qkv_packed_windows_s", "flash_qkv_packed_global"):
            if fwd in out:
                out.add(fwd + "_bwd")
    order = list(TPU_KERNEL)
    return sorted(out, key=order.index)


def fp32_missing_kernels(cfg: CascadeConfig, training: bool = False) -> List[str]:
    """The kernels this configuration's routes launch (`cascade_kernels`)
    that have no fp32 instance, as "#N name". Every kernel of every route
    has one (#1-#20), so this is [] for every configuration of the repo; it
    stays the net for a kernel added without one."""
    return [f"{TPU_KERNEL[k]} {k}" for k in cascade_kernels(cfg, training)
            if not _cuda.has_f32_instance(k)]


def _fp32_on_card(device: str, cfg: CascadeConfig) -> bool:
    dtypes = (cfg.encoder.dtype, cfg.decoder.dtype, cfg.clip.dtype)
    return torch.device(device).type == "cuda" and torch.float32 in dtypes


def refuse_fp32_on_card(device: str, cfg: CascadeConfig, training: bool = False) -> None:
    """Raise at once, before the build, when the cascade would run in fp32
    on a card through a kernel with no fp32 instance (`fp32_missing_kernels`
    of this configuration, with the backward kernels for the train CLI),
    naming those kernels; no path falls back to the plain versions. Every
    route of the repo's configurations has its fp32 instances (the
    reference's #1, #2, #3, #4/#5, #7, #13, #15, #16, #17; SAM ViT-B's
    unfused #10; 'aug_flash' #20; the padded carry's #12, and #11 + #8 at
    windows of 17 and more; the backwards #6, #14 and #18), so demo,
    evaluate, serve, serve_throughput, bench and train run each at fp32 on
    the card; this stays the net for a kernel added without one."""
    if not _fp32_on_card(device, cfg):
        return
    missing = fp32_missing_kernels(cfg, training)
    if missing:
        raise NotImplementedError(
            f"--device {device} with float32: this configuration's path launches kernels with "
            f"no fp32 instance yet: {', '.join(missing)} (ROADMAP.md Queue 2). Run --dtype "
            "bfloat16 on the card, or float32 with --device cpu.")


def exact_fp32_on_card(device: str, cfg: CascadeConfig) -> None:
    """Turn TF32 off where the cascade runs float32 on a card, in matmuls
    and in cuDNN (on by default for convolutions: SAM's neck, CLIP's conv1,
    the decoder's transposed convolutions), so that fp32 is full fp32 there,
    as the JAX package's and the reference's fp32 are."""
    if _fp32_on_card(device, cfg):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


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


def tensorboard_writer(logdir: str):
    """A SummaryWriter under `logdir` when torch.utils.tensorboard imports
    (it needs the tensorboard package), else None, as in the JAX CLIs."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir)


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
    """Lines to stdout and to <out_dir>/log.txt; `quiet` drops them (every
    rank of a mesh but rank 0, the JAX CLI's `set_quiet`)."""

    def __init__(self, out_dir: str, quiet: bool = False):
        self.path = os.path.join(out_dir, "log.txt")
        self.quiet = quiet

    def __call__(self, msg: str) -> None:
        if self.quiet:
            return
        print(msg, flush=True)
        with open(self.path, "a") as f:
            f.write(msg + "\n")


def add_mesh_flags(p: argparse.ArgumentParser) -> None:
    """evaluate's and serve's multi-device flags (the JAX CLIs')."""
    p.add_argument("--data-parallel", action="store_true",
                   help="run under torchrun, one process a rank: each batch's rows split "
                   "over the data ranks")
    p.add_argument("--n-model", type=int, default=1,
                   help="tensor-parallel group size (Megatron rules, parallel/sharding.py); "
                   "ranks are arranged data x model, so 8 ranks with --n-model 2 give a 4 x 2 "
                   "mesh")


def mesh_from_args(args: argparse.Namespace):
    """The data x model mesh of `--data-parallel` / `--n-model` (the process
    group started from torchrun's environment), None on one device."""
    if not (args.data_parallel or args.n_model > 1):
        return None
    return make_mesh(n_model=args.n_model, device=init_distributed(device=args.device))
