"""Seeded random files in the reference's checkpoint formats, for smoke runs
and tests (no real checkpoint ships with the repository).

From a state dict in the port's layout, the entries each file format holds
under its own names (`io/convert.py`'s key lists, read backwards): the SAM
backbone's `.pth` (the stock SAM keys, without the EVP prompt generator,
plus `prompt_encoder.*` entries the port ignores), the OpenAI CLIP archive
(`visual.*`, the bare text tower, the token embedding and the archive's
three integers; no `conv1_alpha`) and the dassl prompt learner (with its
`token_prefix`/`token_suffix` buffers). `save_torchscript` writes an OpenAI
archive: a TorchScript module that holds the entries as its parameters.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..models.cascade import CascadeConfig
from ..models.clip.model import AlphaClipConfig
from .convert import maple_pairs, openai_clip_pairs, sam_backbone_keys

Tensors = Dict[str, torch.Tensor]


def random_state_dict(shapes: Mapping[str, torch.Size], seed: int, std: float = 0.02) -> Tensors:
    """fp32 normal(0, std) entries drawn with numpy from `seed`, in the
    order of `shapes`; vectors named `weight` (the LayerNorm scales) at 1 +
    normal(0, std)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        v = np.asarray(rng.standard_normal(tuple(shape), dtype=np.float32) * np.float32(std))
        if len(shape) == 1 and k.endswith("weight"):
            v += np.float32(1.0)
        out[k] = torch.from_numpy(v)
    return out


def sam_file_state_dict(src: Mapping[str, torch.Tensor], cfg: CascadeConfig) -> Tensors:
    out = {k: src[k] for k in sam_backbone_keys(cfg) if ".prompt_generator." not in k}
    out["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = src[
        "pe_layer.positional_encoding_gaussian_matrix"]
    out["prompt_encoder.no_mask_embed.weight"] = src["no_mask_embed.weight"]
    return out


def openai_clip_file_state_dict(src: Mapping[str, torch.Tensor], clip: AlphaClipConfig,
                                token_embedding: torch.Tensor, dtype=torch.float16,
                                in_proj_renamed: bool = False) -> Tensors:
    out = {fk: src[tk].to(dtype) for tk, fk in openai_clip_pairs(clip, in_proj_renamed)
           if "conv1_alpha" not in fk}
    out["token_embedding.weight"] = token_embedding.to(dtype)
    out["input_resolution"] = torch.tensor(clip.image_resolution)
    out["context_length"] = torch.tensor(clip.context_length)
    out["vocab_size"] = torch.tensor(clip.vocab_size)
    return out


def maple_file_state_dict(src: Mapping[str, torch.Tensor], clip: AlphaClipConfig,
                          wrapped: bool = True) -> Tensors:
    prefix = "prompt_learner" if wrapped else ""
    out = {fk: src[tk] for tk, fk in maple_pairs(clip, prefix)}
    head = f"{prefix}." if prefix else ""
    w = clip.transformer_width
    out[head + "token_prefix"] = torch.zeros(2, 1, w)
    out[head + "token_suffix"] = torch.zeros(2, clip.context_length - 1 - clip.n_ctx, w)
    return out


def save_torchscript(sd: Mapping[str, torch.Tensor], path: str) -> None:
    """A TorchScript archive whose `state_dict()` is `sd` (floating entries
    as parameters, integer ones as buffers), as OpenAI's `.pt` files are."""
    root = nn.Module()
    for key, v in sd.items():
        *path_, leaf = key.split(".")
        mod = root
        for name in path_:
            if name not in mod._modules:
                mod.add_module(name, nn.Module())
            mod = mod._modules[name]
        if v.is_floating_point():
            mod.register_parameter(leaf, nn.Parameter(v, requires_grad=False))
        else:
            mod.register_buffer(leaf, v)
    torch.jit.save(torch.jit.script(root), path)
