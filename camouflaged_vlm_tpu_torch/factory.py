"""Model and class-bank builders shared by the CLI, the smoke script and tests.

Counterpart of `camouflaged_vlm_tpu/factory.py`. Without checkpoints the
weights are random, drawn from an explicit `torch.Generator` on the target
device; the class bank's token embedding and frozen text features come from
numpy with the same seed and draws as the JAX package's `make_bank_inputs`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .models import CascadeConfig, OVCOSCascade
from .models.clip import build_class_prompt_bank
from .models.position_embedding import PositionEmbeddingRandom
from .models.sam_encoder import precompute_rel_tables
from .ops.norms import LayerNormFP32


def init_random_(model: nn.Module, generator: torch.Generator, scale: float = 0.02) -> None:
    """Seeded random weights: LayerNorms at (1, 0), the decoder's Gaussian PE
    matrix at unit normals, the CLIP logit scale at log(1/0.07), every other
    tensor normal(0, scale)."""
    with torch.no_grad():
        for mod in model.modules():
            own = list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)
            )
            for name, t in own:
                if isinstance(mod, LayerNormFP32):
                    t.fill_(1.0 if name == "weight" else 0.0)
                elif isinstance(mod, PositionEmbeddingRandom):
                    t.normal_(0.0, 1.0, generator=generator)
                elif name == "logit_scale":
                    t.fill_(math.log(1.0 / 0.07))
                else:
                    t.normal_(0.0, scale, generator=generator)


def cast_weights_(model: nn.Module, dtype: torch.dtype) -> None:
    """Cast every parameter of rank >= 2 to the compute type; biases,
    LayerNorm parameters and other vectors stay fp32 (the JAX CLI's rule,
    `cli/common.py` of the JAX package)."""
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2:
                p.data = p.data.to(dtype)


def build_cascade(
    cfg: CascadeConfig, device, seed: int = 0
) -> OVCOSCascade:
    """The cascade on `device` with seeded random weights, weights of rank
    >= 2 in cfg's compute type, no parameter requiring grad (training sets
    its trainable ones, `train.trainable_parameters`)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    with torch.device("meta"):
        model = OVCOSCascade(cfg)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_random_(model, gen)
    cast_weights_(model, cfg.encoder.dtype)
    return model.eval().requires_grad_(False)


def attach_rel_cache(model: OVCOSCascade) -> OVCOSCascade:
    """Build the SAM encoder's parameter-derived rel tables once
    (counterpart of the JAX `attach_rel_cache`); training attaches them too,
    since the rel-pos parameters are frozen. Call it after
    the weights are final: a cache built before a state-dict load would be
    stale, and the encoder raises if it finds one. Without a cache the
    'flash' path builds the tables in every forward."""
    enc = model.image_encoder
    for i, tables in precompute_rel_tables(enc).items():
        enc.blocks[i].attn.set_rel_cache(tables)
    return model


def build_full_cascade(dtype=torch.bfloat16, device="cuda", seed: int = 0
                       ) -> Tuple[OVCOSCascade, CascadeConfig]:
    cfg = CascadeConfig.full(dtype=dtype)
    return build_cascade(cfg, device, seed), cfg


def build_tiny_cascade(dtype=torch.float32, device="cpu", seed: int = 0
                       ) -> Tuple[OVCOSCascade, CascadeConfig]:
    cfg = CascadeConfig.tiny(dtype=dtype)
    return build_cascade(cfg, device, seed), cfg


def make_bank_inputs(
    cfg: CascadeConfig,
    classnames: Sequence[str],
    token_embedding: Optional[np.ndarray] = None,
    bank_features: Optional[np.ndarray] = None,
    seed: int = 0,
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """Class-split constants (prompt bank + frozen text-feature bank). The
    random token embedding and bank features follow the JAX package's draws
    for the same seed."""
    rng = np.random.default_rng(seed)
    width = cfg.clip.transformer_width
    if token_embedding is None:
        token_embedding = (
            rng.standard_normal((cfg.clip.vocab_size, width)).astype(np.float32) * 0.02
        )
    bank = build_class_prompt_bank(
        classnames, token_embedding, n_ctx=cfg.clip.n_ctx,
        context_length=cfg.clip.context_length,
    )
    if bank_features is None:
        bank_features = rng.standard_normal(
            (len(classnames), cfg.clip.embed_dim)
        ).astype(np.float32)
        bank_features /= np.linalg.norm(bank_features, axis=-1, keepdims=True)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {
        "prefix": as_t(bank.prefix),
        "suffix": as_t(bank.suffix),
        "eot_indices": as_t(bank.eot_indices),
        "bank_features": as_t(bank_features),
    }
