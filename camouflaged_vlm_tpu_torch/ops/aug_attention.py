"""Decomposed rel-pos attention as attention over augmented features.

Counterpart of `camouflaged_vlm_tpu/ops/aug_attention.py` (XLA code in the
JAX package, plain PyTorch here). The ViTDet bias is rank-structured,
``bias[q, k] = rel_h[q, kh(k)] + rel_w[q, kw(k)]``, which is the inner
product of [rel_h[q], rel_w[q]] with [onehot(kh(k)), onehot(kw(k))]. So

    q' = [q * scale, rel_h[q], rel_w[q]]      (d + H + W, zero-padded)
    k' = [k,         onehot_kh, onehot_kw]
    softmax(q' . k'^T) . v

is the biased attention with no seq x seq bias. The 'aug_flash' path sends
the global blocks' q', k' to `flash_attention_fullk` (TPU kernel #20) and
every other block to `attention_xla`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import scaled
from .rel_pos import get_rel_pos_table


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def augment_qk(
    q: torch.Tensor,
    k: torch.Tensor,
    rel_pos_h: Optional[torch.Tensor],
    rel_pos_w: Optional[torch.Tensor],
    hw: Tuple[int, int],
    scale: float,
    pad_to: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k (..., H*W, d) -> (q', k') (..., H*W, d_aug), d_aug padded with
    zeros to a multiple of `pad_to` (zero lanes change no score). q' is
    pre-scaled (scale rounded to q's type first, as JAX's scalar multiply);
    the bias uses the UNSCALED q, rounded to q's type like JAX's einsums."""
    H, W = hw
    d = q.shape[-1]
    qs = scaled(q, scale)
    if rel_pos_h is None:
        d_aug = _round_up(d, pad_to)
        return F.pad(qs, (0, d_aug - d)), F.pad(k, (0, d_aug - d))

    dt = q.dtype
    Rh = get_rel_pos_table(H, H, rel_pos_h).to(dt)  # (H, H, d)
    Rw = get_rel_pos_table(W, W, rel_pos_w).to(dt)  # (W, W, d)
    rq = q.reshape(q.shape[:-2] + (H, W, d))
    rel_h = torch.einsum("...hwc,hkc->...hwk", rq, Rh).reshape(q.shape[:-1] + (H,))
    rel_w = torch.einsum("...hwc,wkc->...hwk", rq, Rw).reshape(q.shape[:-1] + (W,))

    n = H * W
    kidx = torch.arange(n, device=k.device)
    onehot_h = F.one_hot(kidx // W, H).to(k.dtype)  # row k -> onehot(k // W)
    onehot_w = F.one_hot(kidx % W, W).to(k.dtype)   # row k -> onehot(k % W)
    bshape = k.shape[:-2] + (n,)
    k_aug = torch.cat([k, onehot_h.expand(bshape + (H,)), onehot_w.expand(bshape + (W,))],
                      dim=-1)
    q_aug = torch.cat([qs, rel_h.to(dt), rel_w.to(dt)], dim=-1)
    d_aug = _round_up(d + H + W, pad_to)
    pad = (0, d_aug - (d + H + W))
    return F.pad(q_aug, pad), F.pad(k_aug, pad)


def attention_xla(q_aug: torch.Tensor, k_aug: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention on augmented features: fp32 scores and softmax, the
    probabilities rounded to v's type before P.V, fp32 accumulation."""
    logits = torch.matmul(q_aug.float(), k_aug.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)
