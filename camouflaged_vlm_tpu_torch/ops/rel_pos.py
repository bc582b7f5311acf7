"""Decomposed relative-position attention (ViTDet style), plain PyTorch.

Counterpart of `camouflaged_vlm_tpu/ops/rel_pos.py`: the bias
``attn[q, k] += rel_h[qh, qw, kh] + rel_w[qh, qw, kw]`` is computed from the
*unscaled* query and added to logits computed from the scaled one. This is
SAM's 'reference' attention, which materialises the (seq x seq) bias; the
'flash' path's kernels (`ops/flash_attention.py`, `csrc/`) rebuild the bias
inside the kernel from its rank-2 factors instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .layers import scaled


def get_rel_pos_table(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, head_dim) slice of the relative embeddings. Tables
    are required to hold exactly 2*max(q, k)-1 entries (no resampling)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        raise ValueError(
            f"rel_pos table has {rel_pos.shape[0]} entries, expected {max_rel_dist}"
        )
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative.long()]


def rel_pos_contributions(
    q: torch.Tensor,           # (..., H*W, head_dim) UNSCALED
    rel_pos_h: torch.Tensor,
    rel_pos_w: torch.Tensor,
    hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rel_h (..., H, W, H), rel_w (..., H, W, W)), in the promoted type of
    q and the tables."""
    H, W = hw
    dt = torch.promote_types(q.dtype, rel_pos_h.dtype)
    Rh = get_rel_pos_table(H, H, rel_pos_h).to(dt)
    Rw = get_rel_pos_table(W, W, rel_pos_w).to(dt)
    rq = q.reshape(q.shape[:-2] + (H, W, q.shape[-1])).to(dt)
    rel_h = torch.einsum("...hwc,hkc->...hwk", rq, Rh)
    rel_w = torch.einsum("...hwc,wkc->...hwk", rq, Rw)
    return rel_h, rel_w


def attention_with_decomposed_rel_pos(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_pos_h: Optional[torch.Tensor],
    rel_pos_w: Optional[torch.Tensor],
    hw: Tuple[int, int],
    scale: float,
) -> torch.Tensor:
    """Dense attention with the decomposed rel-pos bias. q, k, v:
    (..., H*W, head_dim); fp32 logits and softmax; returns q.dtype."""
    H, W = hw
    logits = torch.matmul(scaled(q, scale).float(), k.float().transpose(-1, -2))
    if rel_pos_h is not None:
        rel_h, rel_w = rel_pos_contributions(q, rel_pos_h, rel_pos_w, hw)
        bias = rel_h[..., :, :, :, None] + rel_w[..., :, :, None, :]
        logits = logits + bias.reshape(bias.shape[:-4] + (H * W, H * W)).float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
