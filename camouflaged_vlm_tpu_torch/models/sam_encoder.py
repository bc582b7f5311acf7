"""SAM image encoder (ViTDet-style ViT-H) with the EVP prompt generator.

Counterpart of `camouflaged_vlm_tpu/models/sam_encoder.py`, reference-mode
attention only: SAM's 32 blocks run LN, the qkv projection, dense
decomposed rel-pos attention and a plain MLP in PyTorch, windowed blocks in
the padded window-major carry (pad tokens re-zeroed after every LN1). The
patch embeds go through the `linear_act` kernel. The 'flash' attention path
and its kernels are still to be ported (ROADMAP.md, Queue 2).

Layouts are the JAX package's: NHWC images and grids, (B', S, C)
sequences. Parameter names are the reference's state-dict keys.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fft_prompt import fft_highpass
from ..ops.layers import conv_nhwc, dense
from ..ops.linear import linear_act
from ..ops.norms import LayerNormFP32
from ..ops.rel_pos import attention_with_decomposed_rel_pos
from ..ops.window import window_partition_seq, window_unpartition_seq, window_valid_mask


@dataclasses.dataclass(frozen=True)
class SamEncoderConfig:
    img_size: int = 1024
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    use_rel_pos: bool = True
    prompt_scale_factor: int = 32
    freq_rate: float = 0.25
    dtype: torch.dtype = torch.float32
    # 'reference' (dense rel-pos attention in PyTorch) is the only
    # implementation of the port so far; 'flash' is the JAX package's
    # default and raises until its kernels land.
    attn_impl: str = "flash"
    gelu_approximate: bool = True

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def prompt_dim(self) -> int:
        return self.embed_dim // self.prompt_scale_factor

    @classmethod
    def vit_h(cls, **overrides) -> "SamEncoderConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "SamEncoderConfig":
        defaults = dict(
            img_size=64, patch_size=16, embed_dim=64, depth=4, num_heads=4,
            out_chans=32, window_size=2, global_attn_indexes=(1, 3),
            prompt_scale_factor=8,
        )
        defaults.update(overrides)
        return cls(**defaults)


def check_attn_impl(attn_impl: str) -> None:
    if attn_impl == "flash":
        raise NotImplementedError(
            "SamEncoderConfig.attn_impl='flash' is not ported yet: its kernels "
            "(ln_mask_linear_bt, flash_qkv_packed_windows_s, flash_qkv_packed_edge, "
            "flash_qkv_packed_global) come with ROADMAP.md Queue 2, 'To port, "
            "in order' item 1 (SAM 'flash'). Use attn_impl='reference'."
        )
    if attn_impl != "reference":
        raise NotImplementedError(
            f"attn_impl={attn_impl!r}: the port implements only 'reference'"
        )


class PatchEmbedMatmul(nn.Module):
    """Patch-embed conv (kernel == stride, no padding) as one matmul on
    rearranged patches, through the `linear_act` kernel. The conv's weight
    is the reference's `proj` (out, in, p, p)."""

    def __init__(self, in_chans: int, features: int, patch: int, dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, features, patch, stride=patch)
        self.patch = patch
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        B, H, W, C = x.shape
        p = self.patch
        gh, gw = H // p, W // p
        x2 = (
            x.to(self.dtype)
            .reshape(B, gh, p, gw, p, C)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(B * gh * gw, p * p * C)
        )
        F_ = self.proj.out_channels
        # (out, in, kh, kw) -> (out, kh*kw*in): the rows' (kh, kw, c) order
        w2 = self.proj.weight.to(self.dtype).permute(0, 2, 3, 1).reshape(F_, p * p * C)
        y = linear_act(x2, w2.contiguous(), self.proj.bias.to(self.dtype))
        return y.reshape(B, gh, gw, F_)


class Attention(nn.Module):
    """Multi-head attention with the decomposed rel-pos bias, on (B', S, C)
    sequences with S == H*W of `input_size`."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool,
                 input_size: Tuple[int, int], dtype: torch.dtype):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.input_size, self.dtype = input_size, dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            hd = dim // num_heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        hd = self.dim // self.num_heads
        qkv = dense(x, self.qkv, self.dtype).reshape(B, N, 3, self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, heads, N, hd)
        out = attention_with_decomposed_rel_pos(
            q, k, v,
            self.rel_pos_h if self.use_rel_pos else None,
            self.rel_pos_w if self.use_rel_pos else None,
            self.input_size, hd ** -0.5,
        )
        out = out.transpose(1, 2).reshape(B, N, self.dim)
        return dense(out, self.proj, self.dtype)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype, gelu_approximate: bool):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.dtype = dtype
        self.approximate = "tanh" if gelu_approximate else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(dense(x, self.lin1, self.dtype), approximate=self.approximate)
        return dense(h, self.lin2, self.dtype)


class Block(nn.Module):
    """Pre-norm ViT block on (B', S, C). Windowed blocks run in the window
    carry (B' = B * nWin, S = window^2) and get `mask`, which re-zeroes the
    pad tokens after LN1 (the reference zero-pads after LN1, so a pad key or
    value equals the qkv bias)."""

    def __init__(self, cfg: SamEncoderConfig, attn_size: Tuple[int, int]):
        super().__init__()
        self.norm1 = LayerNormFP32(cfg.embed_dim, eps=1e-6)
        self.attn = Attention(cfg.embed_dim, cfg.num_heads, cfg.use_rel_pos,
                              attn_size, cfg.dtype)
        self.norm2 = LayerNormFP32(cfg.embed_dim, eps=1e-6)
        self.mlp = MLPBlock(cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio),
                            cfg.dtype, cfg.gelu_approximate)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if mask is not None:  # (nwin, S, 1), broadcast over B' = B * nwin
            nwin = mask.shape[0]
            x = (x.reshape(-1, nwin, *x.shape[1:]) * mask[None].to(x.dtype)).reshape(x.shape)
        x = shortcut + self.attn(x)
        return x + self.mlp(self.norm2(x))


class PromptGenerator(nn.Module):
    """EVP adapter: FFT high-pass handcrafted features + embedding features
    -> one prompt per block (reference `PromptGenerator`)."""

    def __init__(self, cfg: SamEncoderConfig):
        super().__init__()
        pd = cfg.prompt_dim
        self.cfg = cfg
        self.shared_mlp = nn.Linear(pd, cfg.embed_dim)
        self.embedding_generator = nn.Linear(cfg.embed_dim, pd)
        for i in range(cfg.depth):  # reference: Sequential(Linear, GELU)
            self.add_module(f"lightweight_mlp_{i}", nn.Sequential(nn.Linear(pd, pd)))
        # PatchEmbed2 over the high-passed image (key `prompt_generator.proj`)
        self.prompt_generator = PatchEmbedMatmul(
            cfg.in_chans, pd, cfg.patch_size, cfg.dtype
        )

    def init_features(self, image: torch.Tensor, patch_tokens: torch.Tensor) -> torch.Tensor:
        """image (B, H, W, 3); patch_tokens (B, h, w, D).

        The reference reshapes the NHWC patch tokens as (N, C, H*W) without
        permuting first, scrambling tokens against channels before the
        embedding generator; trained weights absorbed that, so it is kept."""
        dt = self.cfg.dtype
        handcrafted = self.prompt_generator(
            fft_highpass(image, self.cfg.freq_rate).to(dt)
        )
        B, h, w, D = patch_tokens.shape
        scrambled = patch_tokens.reshape(B, D, h * w).transpose(1, 2)
        embedding = dense(scrambled, self.embedding_generator, dt).reshape(B, h, w, -1)
        return handcrafted + embedding

    def block_prompt(self, features: torch.Tensor, i: int) -> torch.Tensor:
        lin = getattr(self, f"lightweight_mlp_{i}")[0]
        p = F.gelu(dense(features, lin, self.cfg.dtype))
        return dense(p, self.shared_mlp, self.cfg.dtype)


class ImageEncoderViT(nn.Module):
    """SAM image encoder: (B, H, W, 3) -> (neck features (B, h, w, out_chans),
    the global blocks' outputs)."""

    def __init__(self, cfg: SamEncoderConfig):
        super().__init__()
        check_attn_impl(cfg.attn_impl)
        self.cfg = cfg
        g, win = cfg.grid, cfg.window_size
        self.patch_embed = PatchEmbedMatmul(cfg.in_chans, cfg.embed_dim,
                                            cfg.patch_size, cfg.dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            Block(cfg, (win, win) if self._windowed(i) else (g, g))
            for i in range(cfg.depth)
        )
        self.neck = nn.ModuleList([
            nn.Conv2d(cfg.embed_dim, cfg.out_chans, 1, bias=False),
            LayerNormFP32(cfg.out_chans, eps=1e-6),
            nn.Conv2d(cfg.out_chans, cfg.out_chans, 3, padding=1, bias=False),
            LayerNormFP32(cfg.out_chans, eps=1e-6),
        ])
        self.prompt_generator = PromptGenerator(cfg)

    def _windowed(self, i: int) -> bool:
        return self.cfg.window_size > 0 and i not in self.cfg.global_attn_indexes

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        cfg = self.cfg
        inp = x
        x = self.patch_embed(x)  # (B, h, w, D)
        prompt_features = self.prompt_generator.init_features(inp, x)
        x = x + self.pos_embed.to(cfg.dtype)

        B, H, W, D = x.shape
        win = cfg.window_size
        if any(self._windowed(i) for i in range(cfg.depth)):
            valid = window_valid_mask(H, W, win, device=x.device)
            pf_w, _ = window_partition_seq(prompt_features, win)

        interm = []
        x_w = None  # window-carry activations (None <=> x holds the grid)
        for i, blk in enumerate(self.blocks):
            if self._windowed(i):
                if x_w is None:
                    x_w, pad_hw = window_partition_seq(x, win)
                x_w = x_w + self.prompt_generator.block_prompt(pf_w, i)
                x_w = blk(x_w, valid)
            else:
                if x_w is not None:
                    x = window_unpartition_seq(x_w, win, pad_hw, (H, W))
                    x_w = None
                x = x + self.prompt_generator.block_prompt(prompt_features, i)
                x = blk(x.reshape(B, H * W, D)).reshape(B, H, W, D)
                interm.append(x)
        if x_w is not None:
            x = window_unpartition_seq(x_w, win, pad_hw, (H, W))

        y = conv_nhwc(x, self.neck[0], cfg.dtype)
        y = self.neck[1](y)
        y = conv_nhwc(y, self.neck[2], cfg.dtype)
        return self.neck[3](y), interm
