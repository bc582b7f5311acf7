"""Packed-qkv attention: the Hopper kernel and its plain version.

Counterpart of `flash_qkv_packed_plain` in
`camouflaged_vlm_tpu/ops/flash_attention.py` (TPU kernel #16), the CLIP
vision tower's attention. The other attention kernels of that module serve
SAM's 'flash' path and training, and are still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import torch

from . import _cuda
from .layers import scaled

# Shared memory of one block of the kernel: 32 query rows of fp32 scores and
# bf16 probabilities over the padded key length, plus q and k/v tiles.
_SMEM_LIMIT = 232448
_HEAD_DIMS = (16, 32, 64, 80, 128)


def _kernel_smem(S: int, d: int) -> int:
    s_pad = -(-S // 64) * 64
    return 4 * 32 * (max(s_pad, d) + 4) + 2 * 32 * (s_pad + 8) + 2 * 96 * (d + 8)


def flash_qkv_packed_plain_ref(qkv: torch.Tensor, scale: float, heads: int, d: int):
    B, S, _ = qkv.shape
    r = qkv.reshape(B, S, 3, heads, d)
    q = scaled(r[:, :, 0].transpose(1, 2), scale)  # in the working type, as JAX does
    k = r[:, :, 1].transpose(1, 2)
    v = r[:, :, 2].transpose(1, 2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(p.float(), v.float()).to(v.dtype)  # (B, heads, S, d)
    return o.transpose(-1, -2).reshape(B, heads * d, S)


def flash_qkv_packed_plain(
    qkv: torch.Tensor,  # (B, S, 3*heads*d), last axis [q heads | k heads | v heads]
    scale: float,
    heads: int,
    d: int,
) -> torch.Tensor:
    """softmax((q*scale) . k^T) . v per head, no bias -> d-major (B, heads*d, S)."""
    if not _cuda.use_kernel("flash_qkv_packed_plain", qkv):
        return flash_qkv_packed_plain_ref(qkv, scale, heads, d)
    _cuda.check_dtype("flash_qkv_packed_plain", torch.bfloat16, qkv)
    B, S, C3 = qkv.shape
    if C3 != 3 * heads * d:
        raise ValueError(f"flash_qkv_packed_plain: qkv {qkv.shape} vs heads={heads} d={d}")
    if d not in _HEAD_DIMS or _kernel_smem(S, d) > _SMEM_LIMIT:
        raise ValueError(
            f"flash_qkv_packed_plain: CUDA kernel takes d in {_HEAD_DIMS} and "
            f"S up to ~1000 (got S={S}, d={d})"
        )
    out = torch.empty((B, heads * d, S), dtype=qkv.dtype, device=qkv.device)
    _cuda.QKV_PACKED_PLAIN(qkv.data_ptr(), out.data_ptr(), B, S, heads, d, float(scale))
    return out
