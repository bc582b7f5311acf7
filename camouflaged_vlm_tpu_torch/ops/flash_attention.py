"""Packed-qkv attention: the Hopper kernels and their plain versions.

Counterparts of `camouflaged_vlm_tpu/ops/flash_attention.py`:

  flash_qkv_packed_plain      (TPU kernel #16)  CLIP vision attention
  flash_qkv_packed_windows_s  (#13)  SAM interior windows, rel-pos bias
  flash_qkv_packed_edge       (#15)  SAM edge windows, plus the virtual pad key
  flash_qkv_packed_global     (#17)  SAM global blocks, separable rel-pos bias

Each reads q, k and v as slices of the raw packed qkv projection ([q heads |
k heads | v heads] on the last axis) and writes the d-major (..., heads*d, S)
layout `proj_rows` reads. The layouts at these functions are the JAX
package's (position-major rel for the windows and the global blocks, rel
lane 28 carrying the edge windows' pad-key logit), so the tests compare like
with like. For CPU tensors each runs its plain version, the JAX `ref`
formulation: q*scale rounded to the working type, the bias rel @ sel added
to the fp32 scores, max-subtracted fp32 softmax, probabilities rounded to
the working type before P.V, fp32 accumulation, one final rounding. For CUDA
tensors each launches its kernel (`csrc/`) or raises.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _cuda
from .compact_window import LPAD_LANE, REL_LANES
from .layers import scaled

# Shared memory of one block of the whole-score-row kernels (csrc/attn_rows.cuh):
# 32 query rows of fp32 scores and bf16 probabilities over the padded key
# length, plus q and k/v tiles (and per-key bias codes for the rel-pos modes).
_SMEM_LIMIT = 232448
_HEAD_DIMS = (16, 32, 64, 80, 128)


def _rows_smem(S: int, d: int, bias: bool = False) -> int:
    s_pad = -(-S // 64) * 64
    extra = 4 * (2 * s_pad + 32) if bias else 0
    return 4 * 32 * (max(s_pad, d) + 4) + extra + 2 * 32 * (s_pad + 8) + 2 * 96 * (d + 8)


def _check_head_dim(name: str, S: int, d: int, bias: bool) -> None:
    if d not in _HEAD_DIMS or _rows_smem(S, d, bias) > _SMEM_LIMIT:
        raise ValueError(
            f"{name}: CUDA kernel takes d in {_HEAD_DIMS} and S up to ~1000 "
            f"(got S={S}, d={d})"
        )


def _split_heads(qkv: torch.Tensor, scale: float, heads: int, d: int):
    """(..., S, 3*heads*d) -> q*scale, k, v as (..., heads, S, d)."""
    r = qkv.reshape(qkv.shape[:-1] + (3, heads, d))
    q, k, v = (r[..., i, :, :].transpose(-3, -2) for i in range(3))
    return scaled(q, scale), k, v


@functools.lru_cache(maxsize=None)
def make_rel_scatter(H: int, W: int, dtype: torch.dtype = torch.float32, device="cpu"):
    """((H+W), H*W) 0/1 matrix: row a scatters rel_h[:, a] to the keys with
    k // W == a, row H+b rel_w[:, b] to the keys with k % W == b. Built once
    per shape, type and device."""
    n = H * W
    kh, kw = np.arange(n) // W, np.arange(n) % W
    sel = np.concatenate([kh[None] == np.arange(H)[:, None],
                          kw[None] == np.arange(W)[:, None]], axis=0)
    return torch.from_numpy(sel.astype(np.float32)).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=None)
def make_rel_scatter32(win: int, dtype: torch.dtype = torch.float32, device="cpu"):
    """`make_rel_scatter(win, win)` padded with zero rows to REL_LANES."""
    sel = make_rel_scatter(win, win, dtype, device)
    return torch.cat([sel, sel.new_zeros(REL_LANES - 2 * win, win * win)])


def xla_attention_relpos(q, k, v, rel, sel):
    """q (..., N, d) pre-scaled, k (..., N, d), v (..., N, dv), rel (..., N, H+W),
    sel (H+W, N) -> softmax(q k^T + rel @ sel) v in v's type."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s + torch.matmul(rel.float(), sel.float())
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


# ---------------------------------------------------------------- plain (#16)


def flash_qkv_packed_plain_ref(qkv: torch.Tensor, scale: float, heads: int, d: int):
    B, S, _ = qkv.shape
    q, k, v = _split_heads(qkv, scale, heads, d)
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
    _check_head_dim("flash_qkv_packed_plain", S, d, bias=False)
    out = torch.empty((B, heads * d, S), dtype=qkv.dtype, device=qkv.device)
    _cuda.QKV_PACKED_PLAIN(qkv.data_ptr(), out.data_ptr(), B, S, heads, d, float(scale))
    return out


# ------------------------------------------------------------- windows (#13)


def flash_qkv_packed_windows_s_ref(qkv, rel_s, sel32, scale, heads, d):
    BW, Nw, _ = qkv.shape
    q, k, v = _split_heads(qkv, scale, heads, d)  # (BW, heads, Nw, d)
    relh = rel_s.reshape(Nw, BW, heads, REL_LANES).permute(1, 2, 0, 3)
    o = xla_attention_relpos(q, k, v, relh, sel32)
    return o.transpose(-1, -2).reshape(BW, heads * d, Nw)


def flash_qkv_packed_windows_s(
    qkv: torch.Tensor,    # (BW, Nw, 3*heads*d), Nw = win*win
    rel_s: torch.Tensor,  # (Nw, BW, heads*32) position-major [rel_h | rel_w | 0]
    sel32: torch.Tensor,  # (32, Nw) make_rel_scatter(win, win) + zero rows
    scale: float,
    heads: int,
    d: int,
) -> torch.Tensor:
    """Windowed attention with the decomposed rel-pos bias -> d-major
    (BW, heads*d, Nw). The kernel builds the bias by indexing
    (rel[q, k // win] + rel[q, win + k % win]) and does not read sel32."""
    name = "flash_qkv_packed_windows_s"
    if not _cuda.use_kernel(name, qkv, rel_s, sel32):
        return flash_qkv_packed_windows_s_ref(qkv, rel_s, sel32, scale, heads, d)
    _cuda.check_dtype(name, torch.bfloat16, qkv, rel_s)
    BW, Nw, C3 = qkv.shape
    win = math.isqrt(Nw)
    if (C3 != 3 * heads * d or win * win != Nw or 2 * win > REL_LANES
            or rel_s.shape != (Nw, BW, heads * REL_LANES) or sel32.shape != (REL_LANES, Nw)):
        raise ValueError(f"{name}: qkv {qkv.shape} rel_s {rel_s.shape} sel32 {sel32.shape}")
    _check_head_dim(name, Nw, d, bias=True)
    out = torch.empty((BW, heads * d, Nw), dtype=qkv.dtype, device=qkv.device)
    _cuda.QKV_WINDOWS(qkv.data_ptr(), rel_s.data_ptr(), out.data_ptr(), BW, win, heads, d,
                      float(scale))
    return out


# ---------------------------------------------------------------- edge (#15)


def flash_qkv_packed_edge_ref(qkv, rel, sel, vb, kmask, scale, heads, d):
    B, n, R, _ = qkv.shape
    q, k, v = _split_heads(qkv, scale, heads, d)  # (B, n, heads, R, d)
    relh = rel.reshape(B, n, R, heads, REL_LANES).transpose(2, 3)  # (B, n, heads, R, 32)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s + torch.matmul(relh.float(), sel.float()[:, None])
    s = s + kmask[:, None]  # (n, 1, 1, R): 0 real / -1e30 dummy keys
    lp = relh[..., LPAD_LANE].float()[..., None]  # the virtual pad key's logit
    m = torch.maximum(s.amax(-1, keepdim=True), lp)
    p = torch.exp(s - m)
    pp = torch.exp(lp - m)
    l = p.sum(-1, keepdim=True) + pp
    o = torch.matmul((p / l).to(v.dtype).float(), v.float())
    o = o + (pp / l) * vb.float()[:, None, :]
    return o.to(qkv.dtype).transpose(-1, -2).reshape(B, n, heads * d, R)


def flash_qkv_packed_edge(
    qkv: torch.Tensor,    # (B, n, R, 3*heads*d) uniform edge rows
    rel: torch.Tensor,    # (B, n, R, heads*32) rel factors, pad-key logit in lane 28
    sel: torch.Tensor,    # (n, 32, R) per-window scatter (compact_window.edge_consts)
    vb: torch.Tensor,     # (heads, d) v slice of the qkv bias (the pad tokens' value)
    kmask: torch.Tensor,  # (n, 1, R) fp32: 0 real keys / -1e30 dummy columns
    scale: float,
    heads: int,
    d: int,
) -> torch.Tensor:
    """Edge-window attention on the compact layout: softmax over [real keys |
    one virtual pad key] -> d-major (B, n, heads*d, R)."""
    name = "flash_qkv_packed_edge"
    if not _cuda.use_kernel(name, qkv, rel, sel, vb, kmask):
        return flash_qkv_packed_edge_ref(qkv, rel, sel, vb, kmask, scale, heads, d)
    _cuda.check_dtype(name, torch.bfloat16, qkv, rel, sel, vb)
    _cuda.check_dtype(name, torch.float32, kmask)
    B, n, R, C3 = qkv.shape
    if (C3 != 3 * heads * d or rel.shape != (B, n, R, heads * REL_LANES)
            or sel.shape != (n, REL_LANES, R) or vb.shape != (heads, d)
            or kmask.shape != (n, 1, R)):
        raise ValueError(f"{name}: qkv {qkv.shape} rel {rel.shape} sel {sel.shape}")
    _check_head_dim(name, R, d, bias=True)
    out = torch.empty((B, n, heads * d, R), dtype=qkv.dtype, device=qkv.device)
    _cuda.QKV_EDGE(qkv.data_ptr(), rel.data_ptr(), sel.data_ptr(), vb.data_ptr(),
                   kmask.data_ptr(), out.data_ptr(), B, n, R, heads, d, float(scale))
    return out


# -------------------------------------------------------------- global (#17)


def flash_qkv_packed_global_ref(qkv, rel, sel, scale, heads, d):
    B, N, _ = qkv.shape
    q, k, v = _split_heads(qkv, scale, heads, d)  # (B, heads, N, d)
    o = xla_attention_relpos(q, k, v, rel.permute(1, 2, 0, 3), sel)
    return o.transpose(-1, -2).reshape(B, heads * d, N)


def flash_qkv_packed_global(
    qkv: torch.Tensor,  # (B, N, 3*heads*d)
    rel: torch.Tensor,  # (N, B, heads, H+W) position-major [rel_h | rel_w]
    sel: torch.Tensor,  # (H+W, N) make_rel_scatter(H, W); read by the plain version only
    scale: float,
    heads: int,
    d: int,
    H: int,
    W: int,
) -> torch.Tensor:
    """Global attention with the separable bias rel_h[q, k // W] +
    rel_w[q, k % W] -> d-major (B, heads*d, N). The kernel streams keys in
    two passes (row statistics, then normalised P.V), so N is not bounded
    by shared memory."""
    name = "flash_qkv_packed_global"
    if not _cuda.use_kernel(name, qkv, rel, sel):
        return flash_qkv_packed_global_ref(qkv, rel, sel, scale, heads, d)
    _cuda.check_dtype(name, torch.bfloat16, qkv, rel)
    B, N, C3 = qkv.shape
    if (C3 != 3 * heads * d or H * W != N or rel.shape != (N, B, heads, H + W)
            or sel.shape != (H + W, N)):
        raise ValueError(f"{name}: qkv {qkv.shape} rel {rel.shape} H={H} W={W}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: CUDA kernel takes d in {_HEAD_DIMS}, got {d}")
    out = torch.empty((B, heads * d, N), dtype=qkv.dtype, device=qkv.device)
    _cuda.QKV_GLOBAL(qkv.data_ptr(), rel.data_ptr(), out.data_ptr(), B, N, H, W, heads, d,
                     float(scale))
    return out
