"""MaPLe multi-modal prompt learner.

Counterpart of `camouflaged_vlm_tpu/models/clip/prompt_learner.py`: the
learned text context `ctx`, its projection `proj` to the shallow visual
prompt, and the deep text prompts with their own projections to the deep
visual prompts. The per-class token prefix/suffix are data
(`ClassPromptBank`), not parameters.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.layers import dense
from .tokenizer import tokenize


@dataclasses.dataclass
class ClassPromptBank:
    """Frozen per-class prompt data for one class split (numpy)."""

    tokenized: np.ndarray     # (N, 77) int32
    prefix: np.ndarray        # (N, 1, text_width) — SOT embedding
    suffix: np.ndarray        # (N, 77-1-n_ctx, text_width)
    eot_indices: np.ndarray   # (N,) int32 — argmax of token ids

    @property
    def num_classes(self) -> int:
        return self.tokenized.shape[0]


def build_class_prompt_bank(
    classnames: Sequence[str],
    token_embedding: np.ndarray,  # (vocab, text_width)
    n_ctx: int = 4,
    ctx_init: str = "a photo of a",
    context_length: int = 77,
) -> ClassPromptBank:
    """Tokenize '{ctx_init} {name}.' per class and embed prefix/suffix."""
    names = [name.replace("_", " ") for name in classnames]
    tokenized = tokenize([f"{ctx_init} {name}." for name in names], context_length)
    embedded = token_embedding[tokenized]
    return ClassPromptBank(
        tokenized=tokenized,
        prefix=embedded[:, :1, :].astype(np.float32),
        suffix=embedded[:, 1 + n_ctx:, :].astype(np.float32),
        eot_indices=tokenized.argmax(axis=-1).astype(np.int32),
    )


class MultiModalPromptLearner(nn.Module):
    def __init__(self, n_ctx: int, prompt_depth: int, text_width: int,
                 vision_width: int, dtype: torch.dtype):
        super().__init__()
        self.n_ctx, self.dtype = n_ctx, dtype
        self.ctx = nn.Parameter(torch.zeros(n_ctx, text_width))
        self.proj = nn.Linear(text_width, vision_width)
        self.compound_prompts_text = nn.ParameterList(
            nn.Parameter(torch.zeros(n_ctx, text_width)) for _ in range(prompt_depth - 1)
        )
        self.compound_prompt_projections = nn.ModuleList(
            nn.Linear(text_width, vision_width) for _ in range(prompt_depth - 1)
        )

    def visual_prompts(self) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(shared_ctx (n_ctx, vision_width), deep visual prompts)."""
        shared_ctx = dense(self.ctx, self.proj, self.dtype)
        deep = [
            dense(p, lin, self.dtype)
            for p, lin in zip(self.compound_prompts_text, self.compound_prompt_projections)
        ]
        return shared_ctx, deep

    def text_prompts(
        self, prefix: torch.Tensor, suffix: torch.Tensor
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(prompts (N, L, text_width) fp32, deep text prompts) for the class
        split's prefix (N, 1, W) and suffix (N, L-1-n_ctx, W)."""
        n_cls = prefix.shape[0]
        ctx = self.ctx[None].expand(n_cls, -1, -1)
        prompts = torch.cat([prefix.float(), ctx.float(), suffix.float()], dim=1)
        return prompts, list(self.compound_prompts_text)
