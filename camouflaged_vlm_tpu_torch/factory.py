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


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """t ~ normal(0, std), drawn in fp32 whatever t's type (the same draws
    as on an fp32 tensor of t's shape), then rounded to t's type."""
    if t.dtype == torch.float32:
        t.normal_(0.0, std, generator=generator)
    else:
        t.copy_(torch.empty(t.shape, device=t.device).normal_(0.0, std, generator=generator))


def init_random_(model: nn.Module, generator: torch.Generator, scale: float = 0.02) -> None:
    """Seeded random weights: LayerNorms at (1, 0), the decoder's Gaussian PE
    matrix at unit normals, the CLIP logit scale at log(1/0.07), every other
    tensor normal(0, scale). A tensor in a narrower type gets the fp32 draws
    rounded, so that casting after the fill gives the same weights."""
    with torch.no_grad():
        for mod in model.modules():
            own = list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)
            )
            for name, t in own:
                if isinstance(mod, LayerNormFP32):
                    t.fill_(1.0 if name == "weight" else 0.0)
                elif isinstance(mod, PositionEmbeddingRandom):
                    _normal_(t, 1.0, generator)
                elif name == "logit_scale":
                    t.fill_(math.log(1.0 / 0.07))
                else:
                    _normal_(t, scale, generator)


# Parameters of rank >= 2 that stay fp32: JAX's counterpart is a vector, which
# its cast rule leaves in fp32 (`no_mask_embed`: a (C,) param in the JAX
# package, an (1, C) embedding here, the reference's layout). It is
# trainable, and rounded to the compute type only where it is used.
FP32_WEIGHTS = ("no_mask_embed.weight",)


def cast_weights_(model: nn.Module, dtype: torch.dtype) -> None:
    """Cast every parameter of rank >= 2 but FP32_WEIGHTS to the compute
    type; biases, LayerNorm parameters and other vectors stay fp32 (the JAX
    CLI's rule, `cli/common.py` of the JAX package)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2 and name not in FP32_WEIGHTS:
                p.data = p.data.to(dtype)


def build_cascade(
    cfg: CascadeConfig, device, seed: int = 0
) -> OVCOSCascade:
    """The cascade on `device` with seeded random weights, weights of rank
    >= 2 in cfg's compute type, no parameter requiring grad (training sets
    its trainable ones, `train.trainable_parameters`). The weights are
    allocated in their final types and filled one tensor at a time (each
    drawn in fp32, then rounded), so that the build's memory peak is the
    model's own; the weights equal an fp32 fill cast afterwards."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    with torch.device("meta"):
        model = OVCOSCascade(cfg)
    cast_weights_(model, cfg.encoder.dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_random_(model, gen)
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
