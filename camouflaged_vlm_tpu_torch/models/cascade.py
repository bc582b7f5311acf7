"""The OVCOS cascade: prompt-tuned SAM + Alpha-CLIP classification.

Counterpart of `camouflaged_vlm_tpu/models/cascade.py`:

  stage 1: SAM ViT-H encoder -> CLIP pass with all-ones alpha -> CLIP image
    and text features projected to two 256-d sparse prompts -> edge mask
    decoder -> bilinear upsample of the mask logits to the input size.
  stage 2: alpha = bilinear(sigmoid(mask), 336) -> second CLIP pass ->
    class logits against the class-split text features.

The text features are image-independent: `encode_class_text_features` runs
once per class split and `infer_cascade_with_text` per batch. Training
runs stage 1 only (`forward_with_text`, or `forward`/`stage1` through the
prompt bank) and returns the mask logits and the edge probabilities at
the input resolution. The CLIP tower is frozen: it runs under no grad and
builds no graph.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.norms import LayerNormFP32
from ..ops.resize import resize_bilinear
from .clip import AlphaClipConfig, CustomClip
from .mask_decoder import EdgeMaskDecoder, MaskDecoderConfig
from .position_embedding import PositionEmbeddingRandom
from ..ops.layers import dense
from .sam_encoder import ImageEncoderViT, SamEncoderConfig
from .two_way_transformer import TwoWayTransformerConfig


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    inp_size: int = 1024
    clip_size: int = 336
    prompt_embed_dim: int = 256
    encoder: SamEncoderConfig = dataclasses.field(default_factory=SamEncoderConfig)
    decoder: MaskDecoderConfig = dataclasses.field(default_factory=MaskDecoderConfig)
    clip: AlphaClipConfig = dataclasses.field(default_factory=AlphaClipConfig)

    @property
    def embedding_size(self) -> int:
        return self.inp_size // self.encoder.patch_size

    @classmethod
    def full(cls, dtype=torch.float32) -> "CascadeConfig":
        """SAM ViT-H (on 'flash', the fused kernels) + Alpha-CLIP ViT-L/14@336."""
        return cls(
            encoder=SamEncoderConfig.vit_h(dtype=dtype, attn_impl="flash"),
            decoder=MaskDecoderConfig(
                transformer=TwoWayTransformerConfig(dtype=dtype), dtype=dtype
            ),
            clip=AlphaClipConfig.vit_l_14_336(dtype=dtype),
        )

    @classmethod
    def tiny(cls, dtype=torch.float32) -> "CascadeConfig":
        """Small config for tests, the JAX package's: SAM on 'flash' with 4
        heads, hence its unfused path (TPU kernel #10 for every block)."""
        enc = SamEncoderConfig.tiny(dtype=dtype, attn_impl="flash")
        dec_dim = 32
        return cls(
            inp_size=enc.img_size,
            clip_size=28,
            prompt_embed_dim=dec_dim,
            encoder=enc,
            decoder=MaskDecoderConfig(
                transformer_dim=dec_dim,
                transformer=TwoWayTransformerConfig(
                    embedding_dim=dec_dim, num_heads=4, mlp_dim=64, dtype=dtype
                ),
                dtype=dtype,
            ),
            clip=AlphaClipConfig.tiny(dtype=dtype),
        )


class OVCOSCascade(nn.Module):
    def __init__(self, cfg: CascadeConfig):
        super().__init__()
        if cfg.decoder.transformer_dim != cfg.prompt_embed_dim:
            raise ValueError("decoder.transformer_dim must equal prompt_embed_dim")
        C = cfg.prompt_embed_dim
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg.encoder)
        self.mask_decoder = EdgeMaskDecoder(cfg.decoder)
        self.pe_layer = PositionEmbeddingRandom(C // 2)
        self.no_mask_embed = nn.Embedding(1, C)
        self.clip_model = CustomClip(cfg.clip)
        clip_dim = cfg.clip.embed_dim
        self.sam_visual_proj = nn.ModuleList([
            LayerNormFP32(clip_dim, eps=1e-5), nn.Linear(clip_dim, C), LayerNormFP32(C, eps=1e-5),
        ])
        self.sam_text_proj = nn.ModuleList([
            LayerNormFP32(clip_dim, eps=1e-5), nn.Linear(clip_dim, C),
        ])

    def _sparse_embeddings(self, image_feat, text_feat):
        """(B, 1, 768) x2 -> (B, 2, 256) CLIP-conditioned sparse prompts."""
        dt = self.cfg.decoder.dtype
        vp, tp = self.sam_visual_proj, self.sam_text_proj
        v = vp[2](dense(vp[0](image_feat), vp[1], dt))
        t = dense(tp[0](text_feat), tp[1], dt)
        return torch.cat([v, t], dim=1)

    def _decode(self, features, sparse):
        """-> (mask logits, edge probabilities), both (B, H, W, 1) at the
        input resolution, and the IoU prediction (B, 1)."""
        cfg = self.cfg
        B, g = features.shape[0], cfg.embedding_size
        dense_emb = self.no_mask_embed.weight[0].to(features.dtype).expand(
            B, g, g, cfg.prompt_embed_dim
        )
        masks, edges, iou = self.mask_decoder(features, self.pe_layer(g), sparse, dense_emb)
        # (B, 1, H/4, W/4) -> NHWC -> input resolution
        up = lambda a: resize_bilinear(a.permute(0, 2, 3, 1), cfg.inp_size, cfg.inp_size)  # noqa: E731
        return up(masks), up(edges), iou

    # ----- training entry points (stage 1)

    def stage1(self, inp, clip_image, clip_mask, prefix, suffix, eot_indices, bank_features):
        """Segmentation pass through the prompt bank. inp (B, 1024, 1024, 3),
        clip_* (B, 336, 336, C) -> (mask logits (B, H, W, 1), edge
        probabilities (B, H, W, 1), iou (B, 1), clip pred ids (B,), clip
        logits (B, N))."""
        features, _ = self.image_encoder(inp)
        with torch.no_grad():  # the frozen CLIP tower
            text_features = self.clip_model.encode_class_text_features(
                prefix, suffix, eot_indices, bank_features
            )
            image_feat, text_feat, pred, score = self.clip_model.classify(
                clip_image, clip_mask, text_features
            )
        masks, edges, iou = self._decode(features, self._sparse_embeddings(image_feat, text_feat))
        return masks, edges, iou, pred, score

    def forward(self, inp, clip_image, clip_mask, prefix, suffix, eot_indices, bank_features):
        """Training forward through the prompt bank: (mask logits, edge
        probabilities) at the input resolution."""
        masks, edges, _, _, _ = self.stage1(
            inp, clip_image, clip_mask, prefix, suffix, eot_indices, bank_features
        )
        return masks, edges

    def forward_with_text(self, inp, clip_image, clip_mask, text_features):
        """Training forward with the class-text features encoded once per run
        (exact: the text tower and prompt learner are frozen) -> (mask
        logits, edge probabilities) at the input resolution."""
        features, _ = self.image_encoder(inp)
        with torch.no_grad():  # the frozen CLIP tower
            image_feat, text_feat, _, _ = self.clip_model.classify(
                clip_image, clip_mask, text_features
            )
        masks, edges, _ = self._decode(features, self._sparse_embeddings(image_feat, text_feat))
        return masks, edges

    # ----- inference entry points

    @torch.no_grad()
    def encode_class_text_features(self, prefix, suffix, eot_indices, bank_features):
        """Per-class-split text features (N, embed_dim), fp32."""
        return self.clip_model.encode_class_text_features(
            prefix, suffix, eot_indices, bank_features
        )

    @torch.no_grad()
    def infer_cascade_with_text(self, inp, clip_image, clip_mask, text_features):
        """inp (B, 1024, 1024, 3), clip_image (B, 336, 336, 3), clip_mask
        (B, 336, 336, 1) -> (mask_probs (B, H, W, 1) fp32, pred (B,),
        class_logits (B, N))."""
        cfg = self.cfg
        features, _ = self.image_encoder(inp)
        image_feat, text_feat, _, _ = self.clip_model.classify(
            clip_image, clip_mask, text_features
        )
        masks, _, _ = self._decode(features, self._sparse_embeddings(image_feat, text_feat))
        probs = torch.sigmoid(masks.float())
        alpha = resize_bilinear(probs, cfg.clip_size, cfg.clip_size)
        _, _, pred, score = self.clip_model.classify(clip_image, alpha, text_features)
        return probs, pred, score

    @torch.no_grad()
    def infer_cascade(self, inp, clip_image, clip_mask, prefix, suffix, eot_indices,
                      bank_features):
        """The fused pipeline with the text tower run in the same call."""
        text_features = self.encode_class_text_features(
            prefix, suffix, eot_indices, bank_features
        )
        return self.infer_cascade_with_text(inp, clip_image, clip_mask, text_features)
