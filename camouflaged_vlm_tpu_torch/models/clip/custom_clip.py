"""CustomCLIP: prompt learner + text tower + Alpha-CLIP vision tower.

Counterpart of `camouflaged_vlm_tpu/models/clip/custom_clip.py`. Logits are
exp(logit_scale) times normalised image features against (normalised
learned text features + the frozen prompt-bank features); the picked text
feature is taken after the bank addition without renormalisation.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from .model import AlphaClipConfig, AlphaClipVisionTower, ClipTextTower
from .prompt_learner import MultiModalPromptLearner


class CustomClip(nn.Module):
    def __init__(self, cfg: AlphaClipConfig):
        super().__init__()
        self.cfg = cfg
        self.prompt_learner = MultiModalPromptLearner(
            cfg.n_ctx, cfg.prompt_depth, cfg.transformer_width, cfg.vision_width, cfg.dtype
        )
        self.text_encoder = ClipTextTower(cfg)
        self.image_encoder = AlphaClipVisionTower(cfg)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def encode_class_text_features(
        self,
        prefix: torch.Tensor,         # (N, 1, W)
        suffix: torch.Tensor,         # (N, L-1-n_ctx, W)
        eot_indices: torch.Tensor,    # (N,)
        bank_features: torch.Tensor,  # (N, embed_dim)
    ) -> torch.Tensor:
        """Per-class text features; image-independent, so encoded once per
        class split."""
        prompts, deep_text = self.prompt_learner.text_prompts(prefix, suffix)
        tf = self.text_encoder(prompts, eot_indices, deep_text)
        tf = tf / torch.linalg.norm(tf, dim=-1, keepdim=True)
        return tf + bank_features.float()

    def classify(
        self,
        image: torch.Tensor,          # (B, H, W, 3)
        alpha: torch.Tensor,          # (B, H, W, 1)
        text_features: torch.Tensor,  # (N, embed_dim)
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        shared_ctx, deep_visual = self.prompt_learner.visual_prompts()
        imf = self.image_encoder(image, alpha, shared_ctx, deep_visual)
        imf = imf / torch.linalg.norm(imf, dim=-1, keepdim=True)
        logits = (torch.exp(self.logit_scale.float()) * imf) @ text_features.T
        pred = logits.argmax(dim=-1)
        return imf[:, None, :], text_features[pred][:, None, :], pred, logits

    def forward(
        self,
        image: torch.Tensor,          # (B, H, W, 3)
        alpha: torch.Tensor,          # (B, H, W, 1)
        prefix: torch.Tensor,         # (N, 1, W) class-split prompt prefix
        suffix: torch.Tensor,         # (N, L-1-n_ctx, W)
        eot_indices: torch.Tensor,    # (N,)
        bank_features: torch.Tensor,  # (N, embed_dim)
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The whole call, JAX's `CustomClip.__call__`: the class split's text
        features, encoded in this call (so that a gradient reaches the prompt
        learner through the text tower, as MaPLe training needs), then
        `classify`."""
        text_features = self.encode_class_text_features(prefix, suffix, eot_indices,
                                                        bank_features)
        return self.classify(image, alpha, text_features)
