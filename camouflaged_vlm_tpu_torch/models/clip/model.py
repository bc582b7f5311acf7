"""Alpha-CLIP vision/text transformers with MaPLe deep prompting.

Counterpart of `camouflaged_vlm_tpu/models/clip/model.py`. The vision
tower's 24 blocks always run the kernel path:
`ln_linear_act_bt` (ln_1 + qkv) -> `flash_qkv_packed_plain` (attention,
d-major out) -> `proj_rows` (out-proj + residual) -> `ln_mlp_residual_bt`
(ln_2 + MLP + residual, QuickGELU). The JAX package gates that path on
Mosaic's alignment rules; the port takes it at any width. The text tower
runs causal attention in plain PyTorch and its MLPs through
`ln_mlp_residual_bt`, as the JAX fused path does.

Layouts are batch-first (B, L, D); parameter names are the reference's
state-dict keys (`in_proj.weight` in the vision tower, torch
MultiheadAttention's `in_proj_weight` in the text tower).

Sharded over a model group (`parallel.shard_model_`), each block runs its
rank's heads and its slice of the MLP's hidden width into fp32 partials
(the row-parallel biases on model rank 0 only), sums them over the group
after each sublayer and adds the residual before the one rounding
(`parallel/sharding.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flash_attention import flash_qkv_packed_plain
from ...ops.layers import conv_nhwc, scaled
from ...ops.linear import ln_linear_act_bt, ln_mlp_residual_bt, proj_rows
from ...ops.norms import LayerNormFP32
from ...parallel.sharding import (
    add_residual,
    copy_to_model,
    local_heads,
    reduce_from_model,
    replicated,
    row_bias,
    row_linear,
    tp_of,
)


@dataclasses.dataclass(frozen=True)
class AlphaClipConfig:
    # vision tower (ViT-L/14@336)
    image_resolution: int = 336
    vision_patch_size: int = 14
    vision_width: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    embed_dim: int = 768
    # text tower
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 768
    transformer_heads: int = 12
    transformer_layers: int = 12
    # MaPLe
    n_ctx: int = 4
    prompt_depth: int = 9
    dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @classmethod
    def vit_l_14_336(cls, **overrides) -> "AlphaClipConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "AlphaClipConfig":
        defaults = dict(
            image_resolution=28, vision_patch_size=14, vision_width=32,
            vision_layers=3, vision_heads=4, embed_dim=16,
            context_length=77, vocab_size=49408, transformer_width=24,
            transformer_heads=4, transformer_layers=3,
            n_ctx=2, prompt_depth=2,
        )
        defaults.update(overrides)
        return cls(**defaults)


def build_causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask (length, length): 0 on/below the diagonal, -inf above."""
    return torch.full((length, length), float("-inf"), device=device).triu(1)


class ClipMLP(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.c_fc = nn.Linear(dim, 4 * dim)
        self.c_proj = nn.Linear(4 * dim, dim)


class VisionAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.in_proj = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)


class TextAttention(nn.Module):
    """torch `nn.MultiheadAttention` parameter names; plain attention."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor, dtype) -> torch.Tensor:
        """Sharded: this rank's heads and its fp32 partial out-projection."""
        B, L, D = x.shape
        tp = tp_of(self)
        hd = D // self.num_heads
        heads = local_heads(self.num_heads, tp)
        qkv = F.linear(x.to(dtype), self.in_proj_weight.to(dtype), self.in_proj_bias.to(dtype))
        q, k, v = qkv.reshape(B, L, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
        logits = torch.matmul(scaled(q, hd ** -0.5).float(), k.float().transpose(-1, -2))
        probs = torch.softmax(logits + attn_mask, dim=-1).to(v.dtype)
        out = torch.matmul(probs.float(), v.float()).to(x.dtype)
        return row_linear(tp, out.transpose(1, 2).reshape(B, L, heads * hd), self.out_proj,
                          dtype)


class ResidualBlock(nn.Module):
    """Pre-norm residual attention block of either tower."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype, causal: bool):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.attn = TextAttention(dim, num_heads) if causal else VisionAttention(dim)
        self.ln_1 = LayerNormFP32(dim, eps=1e-5)
        self.mlp = ClipMLP(dim)
        self.ln_2 = LayerNormFP32(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None):
        dt, tp = self.dtype, tp_of(self)
        if attn_mask is not None:
            x = x + reduce_from_model(tp, self.attn(copy_to_model(tp, self.ln_1(x)), attn_mask,
                                                    dt)).to(x.dtype)
        else:
            B, L, D = x.shape
            hd = D // self.num_heads
            heads = local_heads(self.num_heads, tp)
            a = self.attn
            qkv = ln_linear_act_bt(
                copy_to_model(tp, x), replicated(tp, self.ln_1.weight),
                replicated(tp, self.ln_1.bias), a.in_proj.weight.to(dt), a.in_proj.bias.to(dt),
                eps=1e-5, activation=None,
            )
            out = flash_qkv_packed_plain(qkv, hd ** -0.5, heads, hd).reshape(B, 1, heads * hd, L)
            w, b = a.out_proj.weight.to(dt), row_bias(tp, a.out_proj.bias).to(dt)
            if tp is None:
                x = proj_rows(out, w, b, x.reshape(B, 1, L, D)).reshape(B, L, D)
            else:
                x = add_residual(reduce_from_model(tp, proj_rows(out, w, b, partial=True)),
                                 x.reshape(B, 1, L, D), dt).reshape(B, L, D)
        m = self.mlp
        args = (m.c_fc.weight.to(dt), m.c_fc.bias.to(dt), m.c_proj.weight.to(dt),
                row_bias(tp, m.c_proj.bias).to(dt))
        if tp is None:
            return ln_mlp_residual_bt(x, self.ln_2.weight, self.ln_2.bias, *args, eps=1e-5,
                                      activation="quick_gelu")
        partial = ln_mlp_residual_bt(copy_to_model(tp, x), replicated(tp, self.ln_2.weight),
                                     replicated(tp, self.ln_2.bias), *args, eps=1e-5,
                                     activation="quick_gelu", residual=False)
        return add_residual(reduce_from_model(tp, partial), x, dt)


class Transformer(nn.Module):
    """Holds the blocks under the reference's `transformer.resblocks` keys."""

    def __init__(self, width: int, layers: int, heads: int, dtype, causal: bool):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualBlock(width, heads, dtype, causal) for _ in range(layers)
        )


def _splice_visual_prompt(x: torch.Tensor, prompt: torch.Tensor, n_ctx: int) -> torch.Tensor:
    """Replace the trailing n_ctx tokens with this layer's prompt."""
    ctx = prompt[None].to(x.dtype).expand(x.shape[0], n_ctx, x.shape[-1])
    return torch.cat([x[:, : x.shape[1] - n_ctx], ctx], dim=1)


def _splice_text_prompt(x: torch.Tensor, prompt: torch.Tensor, n_ctx: int) -> torch.Tensor:
    """Replace tokens [1 : 1+n_ctx] (after SOT) with this layer's prompt."""
    ctx = prompt[None].to(x.dtype).expand(x.shape[0], n_ctx, x.shape[-1])
    return torch.cat([x[:, :1], ctx, x[:, 1 + n_ctx:]], dim=1)


class AlphaClipVisionTower(nn.Module):
    """MaPLe Alpha-CLIP vision transformer -> (B, embed_dim) fp32 features."""

    def __init__(self, cfg: AlphaClipConfig):
        super().__init__()
        w, p = cfg.vision_width, cfg.vision_patch_size
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, w, p, stride=p, bias=False)
        self.conv1_alpha = nn.Conv2d(1, w, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.grid ** 2 + 1, w))
        self.ln_pre = LayerNormFP32(w, eps=1e-5)
        self.transformer = Transformer(w, cfg.vision_layers, cfg.vision_heads,
                                       cfg.dtype, causal=False)
        self.ln_post = LayerNormFP32(w, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(
        self,
        image: torch.Tensor,                  # (B, H, W, 3) normalised
        alpha: torch.Tensor,                  # (B, H, W, 1)
        shared_ctx: torch.Tensor,             # (n_ctx, width)
        deep_prompts: Sequence[torch.Tensor],  # prompt_depth-1 of (n_ctx, width)
    ) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        width = cfg.vision_width
        x = conv_nhwc(image, self.conv1, dt) + conv_nhwc(alpha, self.conv1_alpha, dt)
        B = x.shape[0]
        x = x.reshape(B, -1, width)  # (B, grid^2, width)
        cls = self.class_embedding.to(dt).expand(B, 1, width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        vctx = shared_ctx.to(dt).expand(B, cfg.n_ctx, width)
        x = self.ln_pre(torch.cat([x, vctx], dim=1)).contiguous()
        for i, blk in enumerate(self.transformer.resblocks):
            if i > 0 and (i - 1) < len(deep_prompts):
                x = _splice_visual_prompt(x, deep_prompts[i - 1], cfg.n_ctx)
            x = blk(x)
        x = self.ln_post(x[:, 0, :])
        return x.float() @ self.proj.float()


class ClipTextTower(nn.Module):
    """MaPLe CLIP text transformer on pre-embedded prompts -> (N, embed_dim)."""

    def __init__(self, cfg: AlphaClipConfig):
        super().__init__()
        w = cfg.transformer_width
        self.cfg = cfg
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, w))
        self.transformer = Transformer(w, cfg.transformer_layers, cfg.transformer_heads,
                                       cfg.dtype, causal=True)
        self.ln_final = LayerNormFP32(w, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(
        self,
        prompt_embeddings: torch.Tensor,       # (N, L, width)
        eot_indices: torch.Tensor,             # (N,) int
        deep_prompts: Sequence[torch.Tensor],  # prompt_depth-1 of (n_ctx, width)
    ) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        x = prompt_embeddings.to(dt) + self.positional_embedding.to(dt)
        mask = build_causal_mask(cfg.context_length, device=x.device)
        for i, blk in enumerate(self.transformer.resblocks):
            if i > 0 and (i - 1) < len(deep_prompts):
                x = _splice_text_prompt(x, deep_prompts[i - 1], cfg.n_ctx)
            x = blk(x, mask)
        x = self.ln_final(x)
        x = x[torch.arange(x.shape[0], device=x.device), eot_indices.long()]
        return x.float() @ self.text_projection.float()
