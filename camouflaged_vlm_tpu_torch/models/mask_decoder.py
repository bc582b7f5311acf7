"""Edge-aware SAM mask decoder.

Counterpart of `camouflaged_vlm_tpu/models/mask_decoder.py`: 6 output
tokens (iou + 4 mask + edge), the CLIP sparse embeddings as the two-way
transformer's cond stream, a 4x ConvTranspose edge branch, the edge-gated
mask fusion `masks * sigmoid(edge) + masks`, and an IoU head over the 4 mask
tokens. `interm_embeddings` is accepted and ignored, as in the reference.
Layouts NHWC; the ConvTranspose layers run NCHW in PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import conv_transpose_nhwc, dense
from ..ops.norms import LayerNormFP32
from .two_way_transformer import TwoWayTransformer, TwoWayTransformerConfig


@dataclasses.dataclass(frozen=True)
class MaskDecoderConfig:
    transformer_dim: int = 256
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    transformer: TwoWayTransformerConfig = dataclasses.field(
        default_factory=TwoWayTransformerConfig
    )
    dtype: torch.dtype = torch.float32

    @property
    def num_mask_tokens(self) -> int:  # 4 mask + 1 edge
        return self.num_multimask_outputs + 1 + 1


class HyperMLP(nn.Module):
    """ReLU MLP under the reference's `layers.{j}` keys."""

    def __init__(self, in_dim: int, hidden: int, out: int, num_layers: int, dtype):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.dtype = dtype

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = dense(x, lin, self.dtype)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def _upscale_stack(C: int) -> nn.ModuleList:
    # ConvT 2x2/2 -> LN -> GELU -> ConvT 2x2/2 (GELU holds index 2)
    return nn.ModuleList([
        nn.ConvTranspose2d(C, C // 4, 2, stride=2),
        LayerNormFP32(C // 4, eps=1e-6),
        nn.GELU(),
        nn.ConvTranspose2d(C // 4, C // 8, 2, stride=2),
    ])


class EdgeMaskDecoder(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig):
        super().__init__()
        C = cfg.transformer_dim
        self.cfg = cfg
        self.transformer = TwoWayTransformer(cfg.transformer)
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(cfg.num_mask_tokens - 1, C)
        self.edge_token = nn.Embedding(1, C)
        self.output_upscaling = _upscale_stack(C)
        self.embedding_encoder = _upscale_stack(C)
        self.embedding_maskfeature = nn.ModuleList([
            nn.ConvTranspose2d(C // 8, C // 4, 3, stride=1, padding=1),
            LayerNormFP32(C // 4, eps=1e-6),
            nn.GELU(),
            nn.ConvTranspose2d(C // 4, C // 8, 3, stride=1, padding=1),
        ])
        self.output_hypernetworks_mlps = nn.ModuleList(
            HyperMLP(C, C, C // 8, 3, cfg.dtype) for _ in range(cfg.num_mask_tokens - 1)
        )
        self.edge_mlp = HyperMLP(C, C, C // 8, 3, cfg.dtype)
        self.iou_prediction_head = HyperMLP(
            C, cfg.iou_head_hidden_dim, cfg.num_mask_tokens - 1, cfg.iou_head_depth, cfg.dtype
        )

    def _stack(self, x, stack, gelu_last: bool):
        dt = self.cfg.dtype
        x = F.gelu(stack[1](conv_transpose_nhwc(x, stack[0], dt)))
        x = conv_transpose_nhwc(x, stack[3], dt)
        return F.gelu(x) if gelu_last else x

    def forward(
        self,
        image_embeddings: torch.Tensor,          # (B, h, w, C)
        image_pe: torch.Tensor,                  # (h, w, C)
        sparse_prompt_embeddings: torch.Tensor,  # (B, S, C)
        dense_prompt_embeddings: torch.Tensor,   # (B, h, w, C)
        multimask_output: bool = False,
        interm_embeddings: Optional[List[torch.Tensor]] = None,  # unused
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg, dt = self.cfg, self.cfg.dtype
        C = cfg.transformer_dim
        B, h, w, _ = image_embeddings.shape
        n_tokens = 1 + cfg.num_mask_tokens

        edge_embeddings = self._stack(image_embeddings, self.embedding_encoder, False)

        output_tokens = torch.cat(
            [self.iou_token.weight, self.mask_tokens.weight, self.edge_token.weight], dim=0
        )
        tokens = output_tokens[None].to(dt).expand(B, n_tokens, C)
        src = (image_embeddings + dense_prompt_embeddings).reshape(B, h * w, C)
        pe = image_pe.reshape(1, h * w, C).to(dt).expand(B, h * w, C)
        hs, src_out = self.transformer(src, pe, tokens, sparse_prompt_embeddings)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1: 1 + cfg.num_mask_tokens, :]

        upscaled = self._stack(src_out.reshape(B, h, w, C), self.output_upscaling, True)
        mf = self.embedding_maskfeature
        f = F.gelu(mf[1](conv_transpose_nhwc(upscaled, mf[0], dt)))
        edge_feat = conv_transpose_nhwc(f, mf[3], dt) + edge_embeddings

        hyper_masks = torch.stack(
            [mlp(mask_tokens_out[:, i, :]) for i, mlp in enumerate(self.output_hypernetworks_mlps)],
            dim=1,
        )  # (B, 4, C/8)
        hyper_edge = self.edge_mlp(mask_tokens_out[:, cfg.num_mask_tokens - 1, :])
        masks = torch.einsum("btc,bhwc->bthw", hyper_masks.float(), upscaled.float())
        edge = torch.einsum("bc,bhwc->bhw", hyper_edge.float(), edge_feat.float())[:, None]
        edge = torch.sigmoid(edge)
        masks = masks * edge + masks

        iou_pred = self.iou_prediction_head(iou_token_out)
        if multimask_output:
            return masks[:, 1:], edge, iou_pred[:, 1:]
        return masks[:, 0:1], edge, iou_pred[:, 0:1]
