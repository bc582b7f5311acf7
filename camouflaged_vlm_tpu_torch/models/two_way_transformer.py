"""Two-way transformer with CLIP-conditioned cross-attention.

Counterpart of `camouflaged_vlm_tpu/models/two_way_transformer.py`. Each
block: token self-attention, token -> image, token -> cond (the CLIP sparse
embeddings), token MLP, image -> cond, image -> token. Plain PyTorch:
sequences are tiny (6 tokens, 4096 image tokens, 2 cond). Sharded over a
model group (`parallel.shard_model_`), each attention runs its rank's heads
and each MLP its slice of the hidden width into fp32 partials (the
out-projection's and lin2's bias on model rank 0 only), summed over the
group and rounded once.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import LayerNormFP32
from ..ops.layers import dense
from ..parallel.sharding import copy_to_model, local_heads, reduce_from_model, row_linear, tp_of


@dataclasses.dataclass(frozen=True)
class TwoWayTransformerConfig:
    depth: int = 2
    embedding_dim: int = 256
    num_heads: int = 8
    mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    dtype: torch.dtype = torch.float32


class ProjectedAttention(nn.Module):
    """Separate q/k/v projections to embedding_dim // downsample_rate,
    fp32 logits and softmax."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int,
                 dtype: torch.dtype):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.num_heads, self.internal, self.dtype = num_heads, internal, dtype
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(embedding_dim, internal)
        self.v_proj = nn.Linear(embedding_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def forward(self, q, k, v):
        dt, hd, tp = self.dtype, self.internal // self.num_heads, tp_of(self)
        heads = local_heads(self.num_heads, tp)
        q, k, v = copy_to_model(tp, q, k, v)

        def split(x):
            b, n, _ = x.shape
            return x.reshape(b, n, heads, hd).transpose(1, 2)

        qh = split(dense(q, self.q_proj, dt))
        kh = split(dense(k, self.k_proj, dt))
        vh = split(dense(v, self.v_proj, dt))
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / (hd ** 0.5)
        probs = torch.softmax(logits, dim=-1).to(vh.dtype)
        out = torch.matmul(probs.float(), vh.float()).to(q.dtype)
        out = out.transpose(1, 2).reshape(q.shape[0], q.shape[1], heads * hd)
        return reduce_from_model(tp, row_linear(tp, out, self.out_proj, dt)).to(dt)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.dtype = dtype

    def forward(self, x):
        dt, tp = self.dtype, tp_of(self)
        h = F.relu(dense(copy_to_model(tp, x), self.lin1, dt))
        return reduce_from_model(tp, row_linear(tp, h, self.lin2, dt)).to(dt)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: TwoWayTransformerConfig, skip_first_layer_pe: bool):
        super().__init__()
        C, h, ds, dt = cfg.embedding_dim, cfg.num_heads, cfg.attention_downsample_rate, cfg.dtype
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = ProjectedAttention(C, h, 1, dt)
        self.cross_attn_token_to_image = ProjectedAttention(C, h, ds, dt)
        self.cross_attn_token_to_cond = ProjectedAttention(C, h, ds, dt)
        self.cross_attn_image_to_cond = ProjectedAttention(C, h, ds, dt)
        self.cross_attn_image_to_token = ProjectedAttention(C, h, ds, dt)
        for name in ("norm1", "norm2", "norm2_cond", "norm3", "norm4", "norm4_cond"):
            setattr(self, name, LayerNormFP32(C, eps=1e-5))
        self.mlp = MLP(C, cfg.mlp_dim, dt)

    def forward(self, queries, keys, query_pe, key_pe, cond_embedding, cond_pe):
        # 1. token self-attention
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        # 2. token -> image
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        # 3. token -> cond
        q, k = queries + query_pe, cond_embedding + cond_pe
        queries = self.norm2_cond(
            queries + self.cross_attn_token_to_cond(q, k, cond_embedding)
        )
        # 4. token MLP
        queries = self.norm3(queries + self.mlp(queries))
        # 5. image -> cond (queries are the image tokens)
        q, k = cond_embedding + cond_pe, keys + key_pe
        keys = self.norm4_cond(keys + self.cross_attn_image_to_cond(k, q, cond_embedding))
        # 6. image -> token
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: TwoWayTransformerConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(cfg, skip_first_layer_pe=(i == 0)) for i in range(cfg.depth)
        )
        self.final_attn_token_to_image = ProjectedAttention(
            cfg.embedding_dim, cfg.num_heads, cfg.attention_downsample_rate, cfg.dtype
        )
        self.norm_final_attn = LayerNormFP32(cfg.embedding_dim, eps=1e-5)

    def forward(
        self,
        image_embedding: torch.Tensor,  # (B, N, C)
        image_pe: torch.Tensor,         # (B, N, C)
        point_embedding: torch.Tensor,  # (B, T, C)
        cond_embedding: torch.Tensor,   # (B, S, C)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(
                queries, keys, query_pe=point_embedding, key_pe=image_pe,
                cond_embedding=cond_embedding, cond_pe=cond_embedding,
            )
        q, k = queries + point_embedding, keys + image_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys)
        )
        return queries, keys
