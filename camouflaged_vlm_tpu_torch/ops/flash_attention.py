"""SAM and CLIP attention: the Hopper kernels and their plain versions.

Counterparts of `camouflaged_vlm_tpu/ops/flash_attention.py`:

  flash_qkv_packed_plain      (TPU kernel #16)  CLIP vision attention
  flash_qkv_packed_windows_s  (#13)  SAM interior windows, rel-pos bias
  flash_qkv_packed_edge       (#15)  SAM edge windows, plus the virtual pad key
  flash_qkv_packed_global     (#17)  SAM global blocks, separable rel-pos bias
  flash_attention_relpos      (#10)  SAM's unfused 'flash' blocks: split q, k, v
  flash_attention_fullk       (#20)  SAM's 'aug_flash' global blocks

The packed kernels read q, k and v as slices of the raw packed qkv
projection ([q heads | k heads | v heads] on the last axis) and write the
d-major (..., heads*d, S) layout `proj_rows` reads; #10 and #20 take split,
pre-scaled q and k and write (BB, N, dv) rows. The layouts at these functions are the JAX
package's (position-major rel for the windows and the global blocks, rel
lane 28 carrying the edge windows' pad-key logit), so the tests compare like
with like. For CPU tensors each runs its plain version, the JAX `ref`
formulation: q*scale rounded to the working type, the bias rel @ sel added
to the fp32 scores, max-subtracted fp32 softmax, probabilities rounded to
the working type before P.V, fp32 accumulation, one final rounding. For CUDA
tensors each launches its kernel (`csrc/`) or raises.

Gradients: the windows (#14) and global (#18) attention have hand-written
backward kernels (`csrc/attn_bwd.cu`) and plain backwards (`*_bwd_ref`)
for the CPU; the plain, edge, #10 and #20 attention take the VJP of their
plain version (`ops/autograd.py`), as the JAX package's do.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _cuda, autograd
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
    return autograd.run("flash_qkv_packed_plain", _plain_cuda, flash_qkv_packed_plain_ref,
                        (qkv,), (scale, heads, d))


def _plain_cuda(qkv, scale, heads, d):
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
    (rel[q, k // win] + rel[q, win + k % win]) and does not read sel32.
    Backward: `flash_qkv_packed_windows_s_bwd` (TPU kernel #14)."""
    return _with_attn_bwd("flash_qkv_packed_windows_s", _windows_cuda,
                          flash_qkv_packed_windows_s_ref, flash_qkv_packed_windows_s_bwd,
                          (qkv, rel_s, sel32), (scale, heads, d))


def _windows_cuda(qkv, rel_s, sel32, scale, heads, d):
    name = "flash_qkv_packed_windows_s"
    win = _check_windows(name, qkv, rel_s, sel32, heads, d)
    BW, Nw, _ = qkv.shape
    out = torch.empty((BW, heads * d, Nw), dtype=qkv.dtype, device=qkv.device)
    _cuda.QKV_WINDOWS(qkv.data_ptr(), rel_s.data_ptr(), out.data_ptr(), BW, win, heads, d,
                      float(scale))
    return out


def _check_windows(name, qkv, rel_s, sel32, heads, d) -> int:
    _cuda.check_dtype(name, torch.bfloat16, qkv, rel_s)
    BW, Nw, C3 = qkv.shape
    win = math.isqrt(Nw)
    if (C3 != 3 * heads * d or win * win != Nw or 2 * win > REL_LANES
            or rel_s.shape != (Nw, BW, heads * REL_LANES) or sel32.shape != (REL_LANES, Nw)):
        raise ValueError(f"{name}: qkv {qkv.shape} rel_s {rel_s.shape} sel32 {sel32.shape}")
    _check_head_dim(name, Nw, d, bias=True)
    return win


def attention_bwd_ref(q, k, v, relh, sel, g, scale):
    """The plain attention backward, the formulas of the JAX backward
    kernels (`_qkv_packed_windows_s_bwd_kernel`, `_qkv_packed_global_bwd_kernel`).
    q, k, v (..., N, d) with q UNSCALED; relh (..., N, L); sel (L, N);
    g (..., N, d) the output's gradient. P is the forward's probabilities
    (q*scale rounded to the working type, fp32 softmax of the biased
    scores); dP = g.v^T, t = sum_k dP*P, dS = P*(dP - t) rounded to the
    working type; dv = P^T.g (P rounded), dq = scale*dS.k, dk = scale*dS^T.q,
    drel = dS.sel^T (per-row sums of dS over the keys of each rel lane).
    All in fp32 -> (dq, dk, dv, drel)."""
    dt = q.dtype
    f = lambda a: a.float()  # noqa: E731
    s = torch.matmul(f(scaled(q, scale)), f(k).transpose(-1, -2))
    P = torch.softmax(s + torch.matmul(f(relh), f(sel)), dim=-1)
    dP = torch.matmul(f(g), f(v).transpose(-1, -2))
    t = (dP * P).sum(-1, keepdim=True)
    dS = f((P * (dP - t)).to(dt))
    dv = torch.matmul(f(P.to(dt)).transpose(-1, -2), f(g))
    dq = torch.matmul(dS, f(k)) * scale
    dk = torch.matmul(dS.transpose(-1, -2), f(q)) * scale
    return dq, dk, dv, torch.matmul(dS, f(sel).transpose(-1, -2))


def _unsplit(dq, dk, dv, dtype):
    """(..., heads, N, d) x3 -> packed rows (..., N, 3*heads*d)."""
    rows = lambda a: a.transpose(-3, -2).reshape(a.shape[:-3] + (a.shape[-2], -1))  # noqa: E731
    return torch.cat([rows(dq), rows(dk), rows(dv)], dim=-1).to(dtype)


def _heads_rows(qkv, heads, d):
    r = qkv.reshape(qkv.shape[:-1] + (3, heads, d))
    return (r[..., i, :, :].transpose(-3, -2) for i in range(3))  # unscaled q, k, v


def flash_qkv_packed_windows_s_bwd_ref(qkv, rel_s, sel32, g, scale, heads, d):
    """(dqkv like qkv, drel like rel_s) at upstream g (BW, heads*d, Nw)."""
    BW, Nw, _ = qkv.shape
    q, k, v = _heads_rows(qkv, heads, d)
    relh = rel_s.reshape(Nw, BW, heads, REL_LANES).permute(1, 2, 0, 3)
    gr = g.reshape(BW, heads, d, Nw).transpose(-1, -2)
    dq, dk, dv, drel = attention_bwd_ref(q, k, v, relh, sel32, gr, scale)
    drel = drel.permute(2, 0, 1, 3).reshape(Nw, BW, heads * REL_LANES)
    return _unsplit(dq, dk, dv, qkv.dtype), drel.to(rel_s.dtype)


def _attn_bwd_launch(kernel, qkv, rel, g, BB, N, H, W, L, heads, d, scale):
    dqkv, drel = torch.empty_like(qkv), torch.empty_like(rel)
    # row statistics (max, sum, t) of the query pass, read by the key pass
    stats = torch.empty((3, BB * heads * N), dtype=torch.float32, device=qkv.device)
    kernel(qkv.data_ptr(), rel.data_ptr(), g.data_ptr(), dqkv.data_ptr(), drel.data_ptr(),
           stats.data_ptr(), BB, N, H, W, L, heads, d, float(scale))
    return dqkv, drel


def flash_qkv_packed_windows_s_bwd(qkv, rel_s, sel32, g, scale, heads, d):
    """Backward of `flash_qkv_packed_windows_s`: the kernel for CUDA tensors
    (TPU kernel #14), the plain backward for CPU tensors. dqkv is written in
    qkv's packed rows, drel in rel_s's position-major layout."""
    name = "flash_qkv_packed_windows_s_bwd"
    if not _cuda.use_kernel(name, qkv, rel_s, sel32, g):
        return flash_qkv_packed_windows_s_bwd_ref(qkv, rel_s, sel32, g, scale, heads, d)
    win = _check_windows(name, qkv, rel_s, sel32, heads, d)
    BW, Nw, _ = qkv.shape
    _cuda.check_dtype(name, torch.bfloat16, g)
    if g.shape != (BW, heads * d, Nw):
        raise ValueError(f"{name}: gradient {g.shape}, expected {(BW, heads * d, Nw)}")
    return _attn_bwd_launch(_cuda.QKV_WINDOWS_BWD, qkv, rel_s, g, BW, Nw, win, win, REL_LANES,
                            heads, d, scale)


class AttnWithBwd(torch.autograd.Function):
    """An attention kernel with its hand-written backward `bwd(qkv, rel,
    sel, g, *static) -> (dqkv, drel)`; sel gets no gradient. Keeps only its
    inputs."""

    @staticmethod
    def forward(ctx, fwd, bwd, qkv, rel, sel, *static):
        ctx.save_for_backward(qkv, rel, sel)
        ctx.bwd, ctx.static = bwd, static
        return fwd(qkv, rel, sel, *static)

    @staticmethod
    def backward(ctx, g):
        qkv, rel, sel = ctx.saved_tensors
        # the kernels read g in its d-major rows: a non-contiguous gradient is copied here
        dqkv, drel = ctx.bwd(qkv, rel, sel, g.contiguous(), *ctx.static)
        needs = ctx.needs_input_grad
        return (None, None, dqkv if needs[2] else None, drel if needs[3] else None, None,
                *([None] * len(ctx.static)))


def _with_attn_bwd(name, launch, plain, bwd, tensors, static):
    fwd = autograd.forward_fn(name, launch, plain, tensors)
    if autograd.wants_grad(*tensors):
        return AttnWithBwd.apply(fwd, bwd, *tensors, *static)
    return fwd(*tensors, *static)


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
    return autograd.run("flash_qkv_packed_edge", _edge_cuda, flash_qkv_packed_edge_ref,
                        (qkv, rel, sel, vb, kmask), (scale, heads, d))


def _edge_cuda(qkv, rel, sel, vb, kmask, scale, heads, d):
    name = "flash_qkv_packed_edge"
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
    by shared memory. Backward: `flash_qkv_packed_global_bwd` (TPU kernel
    #18)."""
    return _with_attn_bwd("flash_qkv_packed_global", _global_cuda,
                          _global_plain, flash_qkv_packed_global_bwd,
                          (qkv, rel, sel), (scale, heads, d, H, W))


def _global_plain(qkv, rel, sel, scale, heads, d, H, W):
    return flash_qkv_packed_global_ref(qkv, rel, sel, scale, heads, d)


def _check_global(name, qkv, rel, sel, heads, d, H, W):
    _cuda.check_dtype(name, torch.bfloat16, qkv, rel)
    B, N, C3 = qkv.shape
    if (C3 != 3 * heads * d or H * W != N or rel.shape != (N, B, heads, H + W)
            or sel.shape != (H + W, N)):
        raise ValueError(f"{name}: qkv {qkv.shape} rel {rel.shape} H={H} W={W}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: CUDA kernel takes d in {_HEAD_DIMS}, got {d}")


def _global_cuda(qkv, rel, sel, scale, heads, d, H, W):
    _check_global("flash_qkv_packed_global", qkv, rel, sel, heads, d, H, W)
    B, N, _ = qkv.shape
    out = torch.empty((B, heads * d, N), dtype=qkv.dtype, device=qkv.device)
    _cuda.QKV_GLOBAL(qkv.data_ptr(), rel.data_ptr(), out.data_ptr(), B, N, H, W, heads, d,
                     float(scale))
    return out


def flash_qkv_packed_global_bwd_ref(qkv, rel, sel, g, scale, heads, d):
    """(dqkv like qkv, drel like rel) at upstream g (B, heads*d, N)."""
    B, N, _ = qkv.shape
    q, k, v = _heads_rows(qkv, heads, d)
    gr = g.reshape(B, heads, d, N).transpose(-1, -2)
    dq, dk, dv, drel = attention_bwd_ref(q, k, v, rel.permute(1, 2, 0, 3), sel, gr, scale)
    return _unsplit(dq, dk, dv, qkv.dtype), drel.permute(2, 0, 1, 3).to(rel.dtype)


# the key pass keeps the rel rows of 64 queries in fp32 shared memory
GLOBAL_BWD_MAX_LANES = 128


def flash_qkv_packed_global_bwd(qkv, rel, sel, g, scale, heads, d, H, W):
    """Backward of `flash_qkv_packed_global`: the kernel for CUDA tensors
    (TPU kernel #18), the plain backward for CPU tensors. dqkv is written in
    qkv's packed rows, drel in rel's position-major layout."""
    name = "flash_qkv_packed_global_bwd"
    if not _cuda.use_kernel(name, qkv, rel, sel, g):
        return flash_qkv_packed_global_bwd_ref(qkv, rel, sel, g, scale, heads, d)
    _check_global(name, qkv, rel, sel, heads, d, H, W)
    B, N, _ = qkv.shape
    _cuda.check_dtype(name, torch.bfloat16, g)
    if g.shape != (B, heads * d, N):
        raise ValueError(f"{name}: gradient {g.shape}, expected {(B, heads * d, N)}")
    if H + W > GLOBAL_BWD_MAX_LANES:
        raise ValueError(f"{name}: CUDA kernel takes H+W <= {GLOBAL_BWD_MAX_LANES}, got {H + W}")
    return _attn_bwd_launch(_cuda.QKV_GLOBAL_BWD, qkv, rel, g, B, N, H, W, H + W, heads, d,
                            scale)


# -------------------------------------------------- split q, k, v (#10, #20)

_SPLIT_DV = (64, 80)


def _check_split(name, q, k, v, extra=()):
    _cuda.check_dtype(name, torch.bfloat16, q, k, v, *extra)
    BB, N, d = q.shape
    dv = v.shape[-1]
    if k.shape != q.shape or v.shape != (BB, N, dv):
        raise ValueError(f"{name}: q {q.shape} k {k.shape} v {v.shape}")
    if d % 16 or d > 256 or dv not in _SPLIT_DV or BB > 65535:
        raise ValueError(f"{name}: CUDA kernel takes d a multiple of 16 up to 256, dv in "
                         f"{_SPLIT_DV} and at most 65535 problems (got d={d}, dv={dv}, "
                         f"BB={BB})")
    return BB, N, d, dv


def flash_attention_relpos(
    q: torch.Tensor,    # (BB, N, d) pre-scaled
    k: torch.Tensor,    # (BB, N, d)
    v: torch.Tensor,    # (BB, N, dv)
    rel: torch.Tensor,  # (BB, N, H+W) [rel_h | rel_w] per query
    sel: torch.Tensor,  # (H+W, N) make_rel_scatter(H, W); read by the plain version only
    H: int,
    W: int,
) -> torch.Tensor:
    """softmax(q k^T + rel @ sel) v -> (BB, N, dv): SAM's unfused 'flash'
    attention (TPU kernel #10). The kernel (`csrc/attn_relpos.cu`) adds the
    bias by indexing, rel[q, k // W] + rel[q, H + k % W]. Gradients: the VJP
    of the plain version, as the JAX package's `pallas_with_xla_vjp`."""
    return autograd.run("flash_attention_relpos", _relpos_cuda, _relpos_plain,
                        (q, k, v, rel, sel), (H, W))


def _relpos_plain(q, k, v, rel, sel, H, W):
    return xla_attention_relpos(q, k, v, rel, sel)


def _relpos_cuda(q, k, v, rel, sel, H, W):
    name = "flash_attention_relpos"
    BB, N, d, dv = _check_split(name, q, k, v, (rel,))
    if H * W != N or rel.shape != (BB, N, H + W) or sel.shape != (H + W, N):
        raise ValueError(f"{name}: q {q.shape} rel {rel.shape} sel {sel.shape} H={H} W={W}")
    out = torch.empty((BB, N, dv), dtype=v.dtype, device=v.device)
    _cuda.ATTN_RELPOS(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), out.data_ptr(),
                      BB, N, H, W, d, dv)
    return out


def flash_attention_fullk_ref(q_aug, k_aug, v):
    """The JAX `ref`: fp32 scores and softmax, probabilities rounded to v's
    type before P.V, fp32 accumulation, one rounding."""
    s = torch.matmul(q_aug.float(), k_aug.float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def flash_attention_fullk(
    q_aug: torch.Tensor,  # (BB, N, d_qk) pre-scaled, bias-augmented (ops/aug_attention.py)
    k_aug: torch.Tensor,  # (BB, N, d_qk)
    v: torch.Tensor,      # (BB, N, dv)
) -> torch.Tensor:
    """softmax(q_aug k_aug^T) v -> (BB, N, dv): the 'aug_flash' global blocks
    (TPU kernel #20, `csrc/attn_fullk.cu`). Gradients: the VJP of the plain
    version."""
    return autograd.run("flash_attention_fullk", _fullk_cuda, flash_attention_fullk_ref,
                        (q_aug, k_aug, v))


def _fullk_cuda(q_aug, k_aug, v):
    BB, N, d, dv = _check_split("flash_attention_fullk", q_aug, k_aug, v)
    out = torch.empty((BB, N, dv), dtype=v.dtype, device=v.device)
    _cuda.ATTN_FULLK(q_aug.data_ptr(), k_aug.data_ptr(), v.data_ptr(), out.data_ptr(), BB, N,
                     d, dv)
    return out
