"""SAM and CLIP attention: the Hopper kernels and their plain versions.

Counterparts of `camouflaged_vlm_tpu/ops/flash_attention.py`:

  flash_qkv_packed_plain      (TPU kernel #16)  CLIP vision attention
  flash_qkv_packed_windows_s  (#13)  SAM interior windows, rel-pos bias
  flash_qkv_packed_edge       (#15)  SAM edge windows, plus the virtual pad key
  flash_qkv_packed_windows    (#12)  SAM padded windows (and global blocks of
                                     <= 256 tokens), rel window-major
  flash_qkv_packed_global     (#17)  SAM global blocks, separable rel-pos bias
  flash_qkv_relpos_windows    (#11)  SAM padded windows with H+W > 32 (and
                                     global blocks of <= 512 tokens)
  flash_qkv_relpos_global     (#19)  #11 over one window (no caller, as in JAX)
  flash_attention_relpos      (#10)  SAM's unfused 'flash' blocks: split q, k, v
  flash_attention_fullk       (#20)  SAM's 'aug_flash' global blocks

The packed kernels read q, k and v as slices of the raw packed qkv
projection ([q heads | k heads | v heads] on the last axis) and write the
d-major (..., heads*d, S) layout `proj_rows` reads (on the card a
`linear.dmajor_empty` view: rows of a stride rounded up to 8), except #11
and #19, which write the head-leading (B, heads, nwin, N, d) layout
`proj_from_heads_res` reads; #10 and #20 take split, pre-scaled q and k and
write (BB, N, dv) rows. The layouts at these functions are the JAX
package's (position-major rel for the compact windows and the global
blocks, window-major for the padded windows, rel lane 28 carrying the edge
windows' pad-key logit), so the tests compare like
with like. For CPU tensors each runs its plain version, the JAX `ref`
formulation: q*scale rounded to the working type, the bias rel @ sel added
to the fp32 scores, max-subtracted fp32 softmax, probabilities rounded to
the working type before P.V, fp32 accumulation, one final rounding. For CUDA
tensors each launches its kernel (`csrc/`) or raises. Each also has a
float32 instance, which CUDA tensors in float32 reach: one fp32 flash loop
on the CUDA cores (`csrc/attn_f32.cuh`) at d = 64 and 80 (#20: d_qk 208 or
128 with dv 80 or 64), with no rounding point, for MaPLe training and the
cascade at --dtype float32. It reads q, k and v through strides of their
own, so the packed rows and split tensors share it; #10, #11, #12, #19 and
#20 take those strides from `f32_split_layout` / `f32_packed_layout`.

Gradients: the windows (#14) and global (#18) attention have hand-written
backward kernels and plain backwards (`*_bwd_ref`) for the CPU. The bf16
kernels (`csrc/attn_bwd.cu`) are one wgmma design for both: a prep pass
into a scratch of [q*scale | rel lanes | g | q | k | v] rows in 64-row
tiles (`row_tiles`' layout, read by bulk copies), a query-parallel pass
(row statistics, then dq and drel) and a key-parallel pass (dk, dv); the
wrapper picks the lane width (`attn_bwd_lanes`) and hands in the scratch
and the key code (`attn_bwd_scratch`), the C entry picks the bias path. Past
128 rel lanes (#18 on grids above 64 x 64, images above 1024 px) it takes
a wide path that cuts the key tiles along the grid's lines
(`attn_bwd_wide_layout`); #18 takes H + W <= GLOBAL_BWD_MAX_LANES (512,
the fp32 instance's F32_GLOBAL_BWD_MAX_LANES) and raises past it.
Their fp32 instances (`csrc/attn_bwd_f32.cu`, train --dtype float32 on the
card) run on the CUDA cores with no rounding point, in three kernels: the
rows' (max, 1/sum) from S alone and t = sum g o from the forward's output
`o` (which `AttnWithBwd` keeps in float32), then per chunk of (problem,
head) pairs a key-parallel kernel (dk, dv, and dS^T into a scratch) and a
query-parallel one (dq from that dS^T, and drel summed in a fixed order:
no atomics); `attn_bwd_f32_scratch` sizes the scratch. #18's takes H + W
<= F32_GLOBAL_BWD_MAX_LANES lanes, as its forward and as the bf16 kernel.
The plain, edge, #10, #11, #12, #19 and #20 attention take the VJP of their
plain version (`ops/autograd.py`), as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from . import _cuda, autograd
from .compact_window import LPAD_LANE, REL_LANES
from .constants import device_constant
from .layers import scaled
from .linear import dmajor_empty

_HEAD_DIMS = (16, 32, 64, 80, 128)


def _check_d(name: str, d: int) -> None:
    """The head dims the attention kernels are built for. Nothing else is
    bounded here: the windows and edges have at most 256 keys, the
    streaming kernels (#16, #17) take any length, and #17's C entry point
    refuses the H + W its shared memory cannot hold."""
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: CUDA kernel takes d in {_HEAD_DIMS}, got {d}")


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
    return device_constant(sel.astype(np.float32), device, dtype)


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
    """softmax((q*scale) . k^T) . v per head, no bias -> d-major (B, heads*d, S).
    qkv in bfloat16 runs the TMA + wgmma kernel, in float32 its fp32
    instance."""
    return autograd.run("flash_qkv_packed_plain", _plain_cuda, flash_qkv_packed_plain_ref,
                        (qkv,), (scale, heads, d))


# the head dims of the fp32 attention instances (csrc/attn_f32.cuh): CLIP
# ViT-L/14's and SAM ViT-H's
_F32_HEAD_DIMS = (64, 80)


def _check_f32_attention(name: str, d: int, problems: int, heads: int) -> None:
    """What the fp32 flash loop takes: d in _F32_HEAD_DIMS, and one block
    row per (problem, head) of its grid."""
    if d not in _F32_HEAD_DIMS:
        raise ValueError(f"{name}: CUDA kernel takes d in {_F32_HEAD_DIMS}, got {d}")
    if problems * heads > 65535:
        raise ValueError(f"{name}: CUDA kernel takes at most 65535 (problem, head) pairs, got "
                         f"{problems * heads}")


# The block tiles of the fp32 flash loop (csrc/attn_f32.cuh ATile), in the
# order of its C entries' `tile` argument: (query rows a block, 16 a warp;
# columns of a k stage, 0 the whole depth), and each one's k stages in the
# cp.async ring. 64-key tiles, two v buffers.
F32_ATTN_TILES = ((128, 0), (128, 32), (64, 32))
F32_ATTN_STAGES = (2, 3, 2)
F32_ATTN_KEYS, F32_ATTN_VBUF, F32_ATTN_EDGE_LANES = 64, 2, 32
# the H100's shared memory: 227 KB a block, 228 KB an SM with 1 KB of it
# reserved a block; its 65536 registers an SM and the registers a thread of
# the loop takes (ptxas: the most of any instance, of 158-254), which
# bound the blocks an SM holds
F32_ATTN_MAX_SMEM, F32_ATTN_SM_SMEM, F32_ATTN_SM_REGS = 232448, 233472, 65536
F32_ATTN_REGS = 254
# An SM's rate at each tile relative to tile 0 when full, and the warps an
# SM needs for its full rate (fewer run at that share)
F32_ATTN_TILE_RATE = (1.0, 0.95, 0.95)
F32_ATTN_FULL_WARPS = 8
# tests: one of F32_ATTN_TILES to take at every shape instead of the plan's
F32_ATTN_TILE_FORCE: Optional[tuple] = None


def f32_attn_smem(dqk: int, dv: int, bias: str, tile: int, lanes: int = 0) -> int:
    """The dynamic shared memory (bytes) of a block of the fp32 loop at tile
    `tile` (csrc/attn_f32.cuh attn_smem): the q tile (QT rows of the depth
    DA: dqk, + 32 rel lanes for the edge bias), the ring's k stages, two v
    buffers, each warp's P and, for the separable bias, the tile's rel rows;
    -1 where the instance takes no such tile (the whole-depth stages beside
    a 128-row tile only up to DA = 128)."""
    qt, dc = F32_ATTN_TILES[tile]
    da = dqk + (F32_ATTN_EDGE_LANES if bias == "edge" else 0)
    if tile == 0 and da > 128:
        return -1
    kd = dc or da
    return 4 * (qt * da + F32_ATTN_STAGES[tile] * F32_ATTN_KEYS * kd
                + F32_ATTN_VBUF * F32_ATTN_KEYS * dv + qt * F32_ATTN_KEYS
                + (qt * lanes if bias == "sep" else 0))


def f32_attn_blocks_per_sm(dqk: int, dv: int, bias: str, tile: int, lanes: int = 0) -> int:
    """Blocks of the tile an SM holds at once (0: it does not fit): its
    shared memory and F32_ATTN_REGS registers a thread."""
    smem = f32_attn_smem(dqk, dv, bias, tile, lanes)
    if smem < 0 or smem > F32_ATTN_MAX_SMEM:
        return 0
    threads = 2 * F32_ATTN_TILES[tile][0]
    return min(F32_ATTN_SM_SMEM // (smem + 1024), F32_ATTN_SM_REGS // (threads * F32_ATTN_REGS))


def f32_attn_plan(dqk: int, dv: int, bias: str, S: int, pairs: int, lanes: int,
                  n_sm: int) -> int:
    """The tile (index into F32_ATTN_TILES) of one launch of the fp32 loop
    over `pairs` (problem, head) pairs of S tokens on a card of `n_sm` SMs:
    of the tiles that fit, the one of the least modelled time. A block's
    work is its QT rows against S's 64-key tiles over dqk (+ 32) + dv
    columns; each SM runs rounds of `f32_attn_blocks_per_sm` blocks, at
    F32_ATTN_TILE_RATE, slower while it holds fewer than F32_ATTN_FULL_WARPS
    warps (a last round of few blocks; a 64-row tile one block an SM), so
    that wave quantisation and the ragged last q tile count. The first on a
    tie. F32_ATTN_TILE_FORCE overrides the pick (ValueError where that tile
    does not fit)."""
    force = tuple(F32_ATTN_TILE_FORCE) if F32_ATTN_TILE_FORCE else None
    return _f32_attn_plan(dqk, dv, bias, S, pairs, lanes, n_sm, force)


@functools.lru_cache(maxsize=None)
def _f32_attn_plan(dqk, dv, bias, S, pairs, lanes, n_sm, force) -> int:
    da = dqk + (F32_ATTN_EDGE_LANES if bias == "edge" else 0)
    keys = -(-S // F32_ATTN_KEYS) * F32_ATTN_KEYS
    best = None
    for t in ([F32_ATTN_TILES.index(force)] if force else range(len(F32_ATTN_TILES))):
        bps = f32_attn_blocks_per_sm(dqk, dv, bias, t, lanes)
        if not bps:
            continue
        qt = F32_ATTN_TILES[t][0]
        warps, blocks = qt // 16, -(-S // qt) * pairs
        block_s = qt * keys * (da + dv) / F32_ATTN_TILE_RATE[t]
        full, rem = divmod(-(-blocks // n_sm), bps)

        def rnd(n: int) -> float:
            return n * block_s / min(1.0, n * warps / F32_ATTN_FULL_WARPS)

        cost = full * rnd(bps) + (rnd(rem) if rem else 0.0)
        if best is None or cost < best[0]:
            best = (cost, t)
    if best is None:
        raise ValueError(f"fp32 attention: no tile of the loop fits d_qk={dqk}, dv={dv}, "
                         f"bias={bias}, {lanes} rel lanes (tile {force})")
    return best[1]


def f32_attn_blocks(S: int, pairs: int, tile: int) -> list:
    """(pair, first query, end query, warps that compute) of each block of a
    launch at `tile`, in launch order (csrc/attn_f32.cuh: grid (query tiles,
    pairs), x fastest): QT rows a block, the last cut at S; a warp's 16 rows
    run the arithmetic only where its first row lies before S."""
    qt = F32_ATTN_TILES[tile][0]
    return [(p, q0, min(q0 + qt, S), sum(1 for w in range(qt // 16) if q0 + 16 * w < S))
            for p in range(pairs) for q0 in range(0, S, qt)]


def f32_attn_steps(S: int, dqk: int, bias: str, tile: int) -> list:
    """The ring's steps of one block, in order (csrc/attn_f32.cuh `issue`):
    (the key tile's first key, its end cut at S, the step's k columns [c0,
    c1) of the depth DA, its k stage, the key tile's v buffer). A key tile
    takes one step (whole-depth stages) or one per 32 columns, the last
    ragged."""
    dc, kst = F32_ATTN_TILES[tile][1], F32_ATTN_STAGES[tile]
    da = dqk + (F32_ATTN_EDGE_LANES if bias == "edge" else 0)
    kd = dc or da
    nch = -(-da // kd)
    return [(j0, min(j0 + F32_ATTN_KEYS, S), ch * kd, min(da, ch * kd + kd),
             (j0 // F32_ATTN_KEYS * nch + ch) % kst, j0 // F32_ATTN_KEYS % F32_ATTN_VBUF)
            for j0 in range(0, S, F32_ATTN_KEYS) for ch in range(nch)]


def f32_attn_tile(qkv_or_q: torch.Tensor, dqk: int, dv: int, bias: str, S: int, pairs: int,
                  lanes: int = 0) -> int:
    """`f32_attn_plan` on the tensor's card."""
    return f32_attn_plan(dqk, dv, bias, S, pairs, lanes, _cuda.sm_count(qkv_or_q.device))


# The fp32 flash loop's layout (csrc/attn_f32.cuh AttnArgs), in elements, for
# the entries that take it as an argument (#10, #11, #12, #19, #20): q, k
# and v's (problem, head, token) strides; rel's (problem, query, head); the
# output's problems a group, its group, problem-in-group and head strides,
# and its row stride (d-major: between columns; rows: between queries).
# Problem p's output starts at (p // opn) * og + (p % opn) * ow.
F32_LAYOUT_FIELDS = ("qp", "qh", "qt", "kp", "kh", "kt", "vp", "vh", "vt",
                     "rp", "rq", "lph", "opn", "og", "ow", "oh", "ldo")


def f32_split_layout(BB: int, N: int, dqk: int, dv: int, lanes: int = 0) -> tuple:
    """The loop's strides over split q, k (BB, N, dqk) and v (BB, N, dv), one
    head a problem, rel (BB, N, lanes), and an output (BB, N, dv) in rows
    (#10, #20)."""
    qk = (N * dqk, 0, dqk)
    return (*qk, *qk, N * dv, 0, dv, N * lanes, lanes, 0, 1, N * dv, 0, 0, dv)


def f32_packed_layout(B: int, nwin: int, N: int, heads: int, d: int, lanes: int,
                      ldo: int = 0):
    """(element offsets of q, k, v from the packed rows' start, the loop's
    strides) over the packed qkv rows (B, nwin, N, 3*heads*d) with the (B,
    nwin) pairs as problems, rel (B, nwin, N, heads, lanes), and the output
    head-leading (B, heads, nwin, N, d) (#11, #19: nwin 1), or, given its
    row stride `ldo`, d-major (B, nwin, heads*d, N) (#12)."""
    c3 = 3 * heads * d
    rows = (N * c3, d, c3)
    if ldo:
        out = (1, heads * d * ldo, 0, d * ldo, ldo)
    else:
        out = (nwin, heads * nwin * N * d, N * d, nwin * N * d, d)
    return (0, heads * d, 2 * heads * d), (*rows, *rows, *rows, N * heads * lanes,
                                           heads * lanes, lanes, *out)


def _packed_ptrs(qkv: torch.Tensor, offsets) -> list:
    """The addresses of q, k and v inside the packed rows."""
    return [qkv.data_ptr() + o * qkv.element_size() for o in offsets]


def _plain_f32_cuda(qkv, scale, heads, d):
    """The fp32 instance (MaPLe training's vision attention, and CLIP's in
    the cascade at --dtype float32; csrc/qkv_packed_plain_f32.cu): the flash
    loop on the CUDA cores, the same d-major output."""
    name = "flash_qkv_packed_plain (float32)"
    B, S, C3 = qkv.shape
    if C3 != 3 * heads * d:
        raise ValueError(f"{name}: qkv {qkv.shape} vs heads={heads} d={d}")
    _check_f32_attention(name, d, B, heads)
    out = dmajor_empty(B, heads * d, S, dtype=qkv.dtype, device=qkv.device)
    _cuda.QKV_PACKED_PLAIN_F32(qkv.data_ptr(), out.data_ptr(), B, S, out.stride(-2), heads, d,
                               float(scale), f32_attn_tile(qkv, d, d, "none", S, B * heads))
    return out


def _plain_cuda(qkv, scale, heads, d):
    if qkv.dtype == torch.float32:
        return _plain_f32_cuda(qkv, scale, heads, d)
    _cuda.check_dtype("flash_qkv_packed_plain", torch.bfloat16, qkv)
    B, S, C3 = qkv.shape
    if C3 != 3 * heads * d:
        raise ValueError(f"flash_qkv_packed_plain: qkv {qkv.shape} vs heads={heads} d={d}")
    _check_d("flash_qkv_packed_plain", d)
    out = dmajor_empty(B, heads * d, S, dtype=qkv.dtype, device=qkv.device)
    _cuda.QKV_PACKED_PLAIN(qkv.data_ptr(), out.data_ptr(), B, S, out.stride(-2), heads, d,
                           float(scale))
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
    (BW, heads*d, Nw). The kernel (`csrc/qkv_packed_windows_s.cu`) adds the
    bias rel[q, k // win] + rel[q, win + k % win] on the tensor cores, as the
    product of [q*scale | rel] with [k | the key's two-hot lane code], and
    does not read sel32. Backward: `flash_qkv_packed_windows_s_bwd` (TPU
    kernel #14)."""
    return _with_attn_bwd("flash_qkv_packed_windows_s", _windows_cuda,
                          flash_qkv_packed_windows_s_ref, flash_qkv_packed_windows_s_bwd,
                          (qkv, rel_s, sel32), (scale, heads, d))


def _windows_cuda(qkv, rel_s, sel32, scale, heads, d):
    name = "flash_qkv_packed_windows_s"
    BW, Nw, _ = qkv.shape
    if qkv.dtype == torch.float32:  # the fp32 instance (csrc/qkv_windows_f32.cu)
        name += " (float32)"
        win = _check_windows(name, qkv, rel_s, sel32, heads, d, dtype=torch.float32)
        _check_f32_attention(name, d, BW, heads)
        out = dmajor_empty(BW, heads * d, Nw, dtype=qkv.dtype, device=qkv.device)
        _cuda.QKV_WINDOWS_F32(qkv.data_ptr(), rel_s.data_ptr(), out.data_ptr(), BW, win, heads,
                              d, float(scale), out.stride(-2),
                              f32_attn_tile(qkv, d, d, "sep", Nw, BW * heads, 2 * win))
        return out
    win = _check_windows(name, qkv, rel_s, sel32, heads, d)
    out = dmajor_empty(BW, heads * d, Nw, dtype=qkv.dtype, device=qkv.device)
    _cuda.QKV_WINDOWS(qkv.data_ptr(), rel_s.data_ptr(), out.data_ptr(), BW, win, heads, d,
                      float(scale), out.stride(-2))
    return out


def _check_windows(name, qkv, rel, sel32, heads, d, window_major=False,
                   dtype=torch.bfloat16) -> int:
    """qkv (..., Nw, 3*heads*d); rel (..., Nw, heads*32) window-major, else
    (Nw, BW, heads*32) position-major with BW the product of qkv's leading
    dims; both in `dtype`. Returns the window side."""
    _cuda.check_dtype(name, dtype, qkv, rel)
    *lead, Nw, C3 = qkv.shape
    win = math.isqrt(Nw)
    lanes = heads * REL_LANES
    want = (*lead, Nw, lanes) if window_major else (Nw, math.prod(lead), lanes)
    if (C3 != 3 * heads * d or win * win != Nw or 2 * win > REL_LANES
            or rel.shape != want or sel32.shape != (REL_LANES, Nw)):
        raise ValueError(f"{name}: qkv {qkv.shape} rel {rel.shape} sel32 {sel32.shape}")
    if dtype == torch.bfloat16:
        _check_d(name, d)
    return win


# ------------------------------------------------------ padded windows (#12)


def flash_qkv_packed_windows_ref(qkv, rel, sel32, scale, heads, d):
    B, nwin, Nw, _ = qkv.shape
    q, k, v = _split_heads(qkv, scale, heads, d)  # (B, nwin, heads, Nw, d)
    relh = rel.reshape(B, nwin, Nw, heads, REL_LANES).transpose(2, 3)
    o = xla_attention_relpos(q, k, v, relh, sel32)
    return o.transpose(-1, -2).reshape(B, nwin, heads * d, Nw)


def flash_qkv_packed_windows(
    qkv: torch.Tensor,    # (B, nwin, Nw, 3*heads*d), Nw = win*win
    rel: torch.Tensor,    # (B, nwin, Nw, heads*32) window-major [rel_h | rel_w | 0]
    sel32: torch.Tensor,  # (32, Nw) make_rel_scatter(win, win) + zero rows
    scale: float,
    heads: int,
    d: int,
) -> torch.Tensor:
    """#13's function with the rel window-major: the fused 'flash' padded
    window carry (windows of 15 or 16) and the global blocks of at most 256
    tokens -> d-major (B, nwin, heads*d, Nw). Pad tokens are ordinary keys.
    The kernel is #13's (`csrc/qkv_packed_windows_s.cu`) with rel read
    window-major; it builds the key code from the window side and does not
    read sel32. In float32 its fp32 instance (`csrc/qkv_windows_f32.cu`).
    Gradients: the VJP of the plain version."""
    return autograd.run("flash_qkv_packed_windows", _padded_windows_cuda,
                        flash_qkv_packed_windows_ref, (qkv, rel, sel32), (scale, heads, d))


def _padded_windows_f32_cuda(qkv, rel, sel32, scale, heads, d):
    """The fp32 instance (csrc/qkv_windows_f32.cu): #13's flash loop with
    rel's window-major strides, the loop's layout from `f32_packed_layout`."""
    name = "flash_qkv_packed_windows (float32)"
    win = _check_windows(name, qkv, rel, sel32, heads, d, window_major=True, dtype=torch.float32)
    B, nwin, Nw, _ = qkv.shape
    _check_f32_attention(name, d, B * nwin, heads)
    out = dmajor_empty(B, nwin, heads * d, Nw, dtype=qkv.dtype, device=qkv.device)
    offsets, layout = f32_packed_layout(B, nwin, Nw, heads, d, REL_LANES, ldo=out.stride(-2))
    _cuda.QKV_WINDOWS_PADDED_F32(*_packed_ptrs(qkv, offsets), rel.data_ptr(), out.data_ptr(),
                                 _cuda.layouts(layout), B * nwin, heads, win, d, float(scale),
                                 f32_attn_tile(qkv, d, d, "sep", Nw, B * nwin * heads, 2 * win))
    return out


def _padded_windows_cuda(qkv, rel, sel32, scale, heads, d):
    if qkv.dtype == torch.float32:
        return _padded_windows_f32_cuda(qkv, rel, sel32, scale, heads, d)
    win = _check_windows("flash_qkv_packed_windows", qkv, rel, sel32, heads, d,
                         window_major=True)
    B, nwin, Nw, _ = qkv.shape
    out = dmajor_empty(B, nwin, heads * d, Nw, dtype=qkv.dtype, device=qkv.device)
    _cuda.QKV_WINDOWS_PADDED(qkv.data_ptr(), rel.data_ptr(), out.data_ptr(), B * nwin, win,
                             heads, d, float(scale), out.stride(-2))
    return out


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


# rows of a query or key tile of the backward kernels (csrc/attn_bwd.cu AB_T)
ATTN_BWD_TILE = 64
# the bf16 backward takes as many rel lanes as its fp32 instance
# (F32_GLOBAL_BWD_MAX_LANES, below): H + W <= 512, square images up to 4096
# px (the wide path keeps the shorter side's <= 256 drel lanes in shared
# memory)
GLOBAL_BWD_MAX_LANES = 512


def attn_bwd_lanes(L: int) -> int:
    """`cvlm_attn_bwd`'s lpc for L rel lanes: 32 up to 32 lanes, else L
    rounded up to a multiple of 128 (at most GLOBAL_BWD_MAX_LANES). Up to 128
    it is the width of the drel product and of the bias chain; past 128 the C
    entry takes its wide path (`attn_bwd_wide_layout`). (The C entry picks the
    bias path itself: the register path where W = 64 and L = H + 64,
    `drel_w64_ref`.)"""
    if L > GLOBAL_BWD_MAX_LANES:
        raise ValueError(f"attn_bwd_lanes: the backward kernels take at most "
                         f"{GLOBAL_BWD_MAX_LANES} rel lanes, got {L}")
    return 32 if L <= 32 else -(-L // 128) * 128


def rel_code(H: int, W: int, lpc: int, device="cpu"):
    """(H*W, lpc) bf16: key k's code, ones at lanes k // W and H + k % W and
    zeros to lpc (`make_rel_scatter`'s transpose, padded): the keys' side of
    the backward kernels' bias chain [q*scale | rel] . [k | code]^T and the
    B of drel = dS . code; the wrapper hands it in as `row_tiles`, built once
    per shape and device."""
    sel = make_rel_scatter(H, W, torch.bfloat16, device)
    return torch.nn.functional.pad(sel.t(), (0, lpc - H - W)).contiguous()


def drel_w64_ref(dS: torch.Tensor, H: int) -> torch.Tensor:
    """drel = dS . sel^T on an H x 64 grid, as the register path of the
    backward kernels (csrc/attn_bwd.cu ab_reg) forms it: a 64-key tile is
    grid row kh, so rel_h lane kh gets the tile's row sum of dS and the 64
    rel_w lanes get the tiles themselves, summed. dS (..., Nq, H*64) ->
    (..., Nq, H + 64)."""
    t = dS.reshape(dS.shape[:-1] + (H, ATTN_BWD_TILE))
    return torch.cat([t.sum(-1), t.sum(-2)], dim=-1)


def row_tiles(x: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """(rows, C) -> (n_tiles, C / 8, 64, 8): the backward kernels' tile layout
    (16-byte columns of 64-row tiles, what wgmma reads), rows past the end
    zero."""
    rows, C = x.shape
    t = ATTN_BWD_TILE
    x = torch.nn.functional.pad(x, (0, 0, 0, n_tiles * t - rows))
    return x.reshape(n_tiles, t, C // 8, 8).transpose(1, 2).contiguous()


def attn_bwd_tiles(N: int) -> int:
    """64-row tiles the backward kernels lay N rows out in: rounded up to
    the two tiles of a block."""
    n = -(-N // ATTN_BWD_TILE)
    return n + n % 2


@functools.lru_cache(maxsize=None)
def _rel_code_tiles(H: int, W: int, lpc: int, device):
    if lpc > 128:  # the wide path's 16 code tiles
        return wide_code_tiles(device)
    return row_tiles(rel_code(H, W, lpc, device), attn_bwd_tiles(H * W))


@dataclasses.dataclass(frozen=True)
class WideLayout:
    """The wide path's cut of an H x W grid (csrc/attn_bwd.cu `ab_wide`):
    side B is the shorter (one rel_B lane a key tile), side A the longer (a
    key tile holds 64 consecutive A positions of one B line); key = b * sB +
    a * sA, rel_A at lanes offA.., rel_B at offB.."""

    nA: int
    nB: int
    offA: int
    offB: int
    sA: int
    sB: int

    @property
    def nc(self) -> int:  # 64-wide chunks of side A
        return -(-self.nA // ATTN_BWD_TILE)

    @property
    def nBe(self) -> int:  # B lines rounded up to even (two key tiles a block)
        return self.nB + self.nB % 2

    @property
    def rel_columns(self) -> int:  # 16-byte rel columns of a query row
        return 8 * self.nc + 2 * -(-self.nB // 16)

    def aux_columns(self, ntp: int, d: int) -> int:
        """16-byte columns of 64 rows per (image, head) of the wide aux:
        ntp query tiles [q*scale | rel_A | rel_B | g | q], then nBe * nc key
        tiles [k | v] (csrc/attn_bwd.cu `abw_aux_chunks`)."""
        cq = d // 8
        return ntp * (3 * cq + self.rel_columns) + self.nBe * self.nc * 2 * cq

    def key(self, b: int, a: int) -> int:
        return b * self.sB + a * self.sA


def attn_bwd_wide_layout(H: int, W: int) -> WideLayout:
    if H <= W:
        return WideLayout(nA=W, nB=H, offA=H, offB=0, sA=1, sB=W)
    return WideLayout(nA=H, nB=W, offA=0, offB=H, sA=W, sB=1)


def wide_code(device="cpu") -> torch.Tensor:
    """(16, 64, 80) bf16: the wide key pass's code, tile j one-hot at lane r
    (key row r's rel_A lane of its chunk) and at lane 64 + j (its rel_B lane
    among the 16 the query tiles carry around it)."""
    t = ATTN_BWD_TILE
    code = torch.zeros((16, t, t + 16), dtype=torch.bfloat16, device=device)
    r = torch.arange(t, device=device)
    code[:, r, r] = 1
    code[torch.arange(16, device=device), :, t + torch.arange(16, device=device)] = 1
    return code


def wide_code_tiles(device="cpu") -> torch.Tensor:
    """`wide_code` as the C entry reads it: (16, 10, 64, 8) (`row_tiles`)."""
    return torch.cat([row_tiles(c, 1) for c in wide_code(device)])


def drel_wide_ref(dS: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """drel = dS . sel^T as the wide path forms it: per key tile (b, c) the
    rel_B lane b gets the tile's row sum, added chunk c by chunk c, and the
    rel_A lanes of chunk c the dS tiles themselves, summed over the lines b.
    dS (..., Nq, H*W) -> (..., Nq, H + W)."""
    lay = attn_bwd_wide_layout(H, W)
    g = dS.reshape(dS.shape[:-1] + (H, W))
    if lay.sB == 1:  # B is the width: lines are grid columns
        g = g.transpose(-1, -2)
    t = ATTN_BWD_TILE
    g = torch.nn.functional.pad(g, (0, lay.nc * t - lay.nA))  # (..., nB, nc * 64)
    tiles = g.reshape(g.shape[:-1] + (lay.nc, t))
    rb = tiles.sum(-1)[..., 0]
    for c in range(1, lay.nc):
        rb = rb + tiles.sum(-1)[..., c]
    ra = tiles.sum(-3).reshape(g.shape[:-2] + (lay.nc * t,))[..., :lay.nA]
    out = dS.new_zeros(dS.shape[:-1] + (H + W,))
    out[..., lay.offA:lay.offA + lay.nA] = ra
    out[..., lay.offB:lay.offB + lay.nB] = rb
    return out


def attn_bwd_scratch(qkv, BB, N, H, W, L, heads, d):
    """`cvlm_attn_bwd`'s lane width and tile count and its scratch: (lpc,
    ntp, aux, stats, code). aux holds per (image, head) the rows' [q*scale |
    rel lanes to lpc | g | q | k | v] in 64-row tiles (the prep pass; on the
    wide path, L > 128, `WideLayout.aux_columns`), stats the rows' (max,
    1/sum, t, 0) from the query pass for the key pass, code the keys' code
    tiles (cached per shape and device; the wide path's 16, `wide_code_tiles`)."""
    lpc, ntp = attn_bwd_lanes(L), attn_bwd_tiles(N)
    if lpc > 128:
        cols = attn_bwd_wide_layout(H, W).aux_columns(ntp, d)
        aux = torch.empty((BB, heads, cols, ATTN_BWD_TILE, 8), dtype=qkv.dtype,
                          device=qkv.device)
    else:
        aux = torch.empty((BB, heads, ntp, (5 * d + lpc) // 8, ATTN_BWD_TILE, 8),
                          dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((BB * heads, ntp * ATTN_BWD_TILE, 4), dtype=torch.float32,
                        device=qkv.device)
    return lpc, ntp, aux, stats, _rel_code_tiles(H, W, lpc, qkv.device)


def _attn_bwd_launch(kernel, qkv, rel, g, BB, N, H, W, L, heads, d, scale):
    lpc, ntp, aux, stats, code = attn_bwd_scratch(qkv, BB, N, H, W, L, heads, d)
    dqkv, drel = torch.empty_like(qkv), torch.empty_like(rel)
    kernel(qkv.data_ptr(), rel.data_ptr(), g.data_ptr(), dqkv.data_ptr(), drel.data_ptr(),
           aux.data_ptr(), stats.data_ptr(), code.data_ptr(), BB, N, ntp, H, W, L, lpc, heads,
           d, float(scale))
    return dqkv, drel


def _check_bwd_grad(name, g, dtype, shape):
    _cuda.check_dtype(name, dtype, g)
    if g.shape != shape:
        raise ValueError(f"{name}: gradient {g.shape}, expected {shape}")


# the fp32 backward's dS^T scratch holds as many (problem, head) pairs as
# fit in this many bytes (at least one); the C entry runs its key and query
# kernels a chunk of pairs at a time
F32_BWD_SCRATCH_BYTES = 512 << 20


def attn_bwd_f32_scratch(BB: int, heads: int, N: int, d: int, device="cpu"):
    """`csrc/attn_bwd_f32.cu`'s scratch: (stats, gt, dst, chunk). stats
    holds each query row's (max, 1/sum, t, 0), gt g as rows (BB * heads, N,
    d), dst a chunk of pairs' dS^T, (chunk, NP, NP) with NP = N rounded up
    to the kernels' 128-row tile, key-major."""
    t = _cuda.ATTN_BWD_F32_TILE
    NP = -(-N // t) * t
    chunk = min(BB * heads, max(1, F32_BWD_SCRATCH_BYTES // (4 * NP * NP)))
    stats = torch.empty((BB * heads, N, 4), dtype=torch.float32, device=device)
    gt = torch.empty((BB * heads, N, d), dtype=torch.float32, device=device)
    dst = torch.empty((chunk, NP, NP), dtype=torch.float32, device=device)
    return stats, gt, dst, chunk


def _check_bwd_out(name, o, qkv, shape):
    """The forward's output the fp32 backward reads t = sum g o from: fp32,
    d-major (P, heads * d, N) on qkv's device, rows of any stride
    (`dmajor_empty`'s)."""
    if o is None:
        raise ValueError(f"{name}: the CUDA kernel needs the forward's output o")
    _cuda.check_dtype(name, torch.float32, o)
    P, C, N = shape
    if (o.shape != shape or o.device != qkv.device or o.stride(-1) != 1
            or o.stride(0) != C * o.stride(1) or o.stride(1) < N):
        raise ValueError(f"{name}: o {tuple(o.shape)} strides {o.stride()}, expected d-major "
                         f"{shape}")


def _attn_bwd_f32_launch(kernel, qkv, rel, g, o, BB, heads, *shape):
    """The fp32 backward's outputs, its scratch (`attn_bwd_f32_scratch`) and
    one launch of its C entry (`shape`: the entry's ints before ldo)."""
    dqkv, drel = torch.empty_like(qkv), torch.empty_like(rel)
    _, N, C3 = qkv.shape
    stats, gt, dst, chunk = attn_bwd_f32_scratch(BB, heads, N, C3 // (3 * heads), qkv.device)
    *ints, scale = shape
    kernel(qkv.data_ptr(), rel.data_ptr(), g.data_ptr(), o.data_ptr(), dqkv.data_ptr(),
           drel.data_ptr(), stats.data_ptr(), gt.data_ptr(), dst.data_ptr(), BB, *ints,
           o.stride(1), chunk, scale)
    return dqkv, drel


def flash_qkv_packed_windows_s_bwd(qkv, rel_s, sel32, g, scale, heads, d, o=None):
    """Backward of `flash_qkv_packed_windows_s`: the kernel for CUDA tensors
    (TPU kernel #14; in float32 its fp32 instance, which also reads the
    forward's output `o`), the plain backward for CPU tensors. dqkv is
    written in qkv's packed rows, drel in rel_s's position-major layout."""
    name = "flash_qkv_packed_windows_s_bwd"
    if not _cuda.use_kernel(name, qkv, rel_s, sel32, g):
        return flash_qkv_packed_windows_s_bwd_ref(qkv, rel_s, sel32, g, scale, heads, d)
    BW, Nw, _ = qkv.shape
    if qkv.dtype == torch.float32:  # the fp32 instance (csrc/attn_bwd_f32.cu)
        name += " (float32)"
        win = _check_windows(name, qkv, rel_s, sel32, heads, d, dtype=torch.float32)
        _check_f32_attention(name, d, BW, heads)
        _check_bwd_grad(name, g, torch.float32, (BW, heads * d, Nw))
        _check_bwd_out(name, o, qkv, (BW, heads * d, Nw))
        return _attn_bwd_f32_launch(_cuda.QKV_WINDOWS_BWD_F32, qkv, rel_s, g, o, BW, heads, win,
                                    heads, d, float(scale))
    win = _check_windows(name, qkv, rel_s, sel32, heads, d)
    _check_bwd_grad(name, g, torch.bfloat16, (BW, heads * d, Nw))
    return _attn_bwd_launch(_cuda.QKV_WINDOWS_BWD, qkv, rel_s, g, BW, Nw, win, win, REL_LANES,
                            heads, d, scale)


class AttnWithBwd(torch.autograd.Function):
    """An attention kernel with its hand-written backward `bwd(qkv, rel,
    sel, g, *static, o=...) -> (dqkv, drel)`; sel gets no gradient. Keeps
    its inputs and, in float32, its output o (the fp32 backward's t = sum g
    o; the out-projection after it keeps o anyway)."""

    @staticmethod
    def forward(ctx, fwd, bwd, qkv, rel, sel, *static):
        out = fwd(qkv, rel, sel, *static)
        ctx.save_for_backward(qkv, rel, sel, out if qkv.dtype == torch.float32 else None)
        ctx.bwd, ctx.static = bwd, static
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, rel, sel, o = ctx.saved_tensors
        # the kernels read g in its d-major rows: a non-contiguous gradient is copied here
        dqkv, drel = ctx.bwd(qkv, rel, sel, g.contiguous(), *ctx.static, o=o)
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
    one virtual pad key] -> d-major (B, n, heads*d, R). The kernel
    (`csrc/qkv_packed_windows_s.cu`, #13's) adds each key's bias rel @ sel
    on the tensor cores, as the product of [q*scale | rel] with [k | the
    key's column of sel]: sel's lane LPAD_LANE is zero, so the pad-key
    logit there adds to no score."""
    return autograd.run("flash_qkv_packed_edge", _edge_cuda, flash_qkv_packed_edge_ref,
                        (qkv, rel, sel, vb, kmask), (scale, heads, d))


def _edge_cuda(qkv, rel, sel, vb, kmask, scale, heads, d):
    name = "flash_qkv_packed_edge"
    f32 = qkv.dtype == torch.float32  # the fp32 instance (csrc/qkv_windows_f32.cu)
    if f32:
        name += " (float32)"
    _cuda.check_dtype(name, torch.float32 if f32 else torch.bfloat16, qkv, rel, sel, vb)
    _cuda.check_dtype(name, torch.float32, kmask)
    B, n, R, C3 = qkv.shape
    if (C3 != 3 * heads * d or rel.shape != (B, n, R, heads * REL_LANES)
            or sel.shape != (n, REL_LANES, R) or vb.shape != (heads, d)
            or kmask.shape != (n, 1, R)):
        raise ValueError(f"{name}: qkv {qkv.shape} rel {rel.shape} sel {sel.shape}")
    if f32:  # keys streamed in tiles: any R
        _check_f32_attention(name, d, B * n, heads)
    else:
        _check_d(name, d)
        if R > 256 or B * n > 65535:
            raise ValueError(f"{name}: CUDA kernel takes R <= 256 and B*n <= 65535, got "
                             f"R={R}, B*n={B * n}")
    out = dmajor_empty(B, n, heads * d, R, dtype=qkv.dtype, device=qkv.device)
    args = (qkv.data_ptr(), rel.data_ptr(), sel.data_ptr(), vb.data_ptr(), kmask.data_ptr(),
            out.data_ptr(), B, n, R, heads, d, float(scale), out.stride(-2))
    if f32:
        _cuda.QKV_EDGE_F32(*args, f32_attn_tile(qkv, d, d, "edge", R, B * n * heads))
    else:
        _cuda.QKV_EDGE(*args)
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
    one pass (online softmax); it holds 128 queries' rel rows in shared
    memory, so it refuses H + W > 587 at d = 80 (square images of 4704 px
    and up); in float32 its fp32 instance holds 64 queries' and refuses H +
    W > F32_GLOBAL_MAX_LANES (512: square images above 4096 px).
    Backward: `flash_qkv_packed_global_bwd` (TPU kernel #18), which takes
    H + W <= 512 in both precisions (GLOBAL_BWD_MAX_LANES,
    F32_GLOBAL_BWD_MAX_LANES) and raises past it."""
    return _with_attn_bwd("flash_qkv_packed_global", _global_cuda,
                          _global_plain, flash_qkv_packed_global_bwd,
                          (qkv, rel, sel), (scale, heads, d, H, W))


def _global_plain(qkv, rel, sel, scale, heads, d, H, W):
    return flash_qkv_packed_global_ref(qkv, rel, sel, scale, heads, d)


def _check_global(name, qkv, rel, sel, heads, d, H, W, dtype=torch.bfloat16):
    _cuda.check_dtype(name, dtype, qkv, rel)
    B, N, C3 = qkv.shape
    if (C3 != 3 * heads * d or H * W != N or rel.shape != (N, B, heads, H + W)
            or sel.shape != (H + W, N)):
        raise ValueError(f"{name}: qkv {qkv.shape} rel {rel.shape} H={H} W={W}")
    if dtype == torch.bfloat16:
        _check_d(name, d)


# the fp32 global attention (csrc/qkv_packed_global_f32.cu) holds a query
# tile's H + W rel lanes in shared memory: at most this many
F32_GLOBAL_MAX_LANES = 512


def _global_cuda(qkv, rel, sel, scale, heads, d, H, W):
    name = "flash_qkv_packed_global"
    B, N, _ = qkv.shape
    if qkv.dtype == torch.float32:  # the fp32 instance
        name += " (float32)"
        _check_global(name, qkv, rel, sel, heads, d, H, W, dtype=torch.float32)
        _check_f32_attention(name, d, B, heads)
        if H + W > F32_GLOBAL_MAX_LANES:
            raise ValueError(f"{name}: CUDA kernel takes H+W <= {F32_GLOBAL_MAX_LANES} (the "
                             f"rel lanes it holds in shared memory), got {H + W}")
        out = dmajor_empty(B, heads * d, N, dtype=qkv.dtype, device=qkv.device)
        _cuda.QKV_GLOBAL_F32(qkv.data_ptr(), rel.data_ptr(), out.data_ptr(), B, N,
                             out.stride(-2), H, W, heads, d, float(scale),
                             f32_attn_tile(qkv, d, d, "sep", N, B * heads, H + W))
        return out
    _check_global(name, qkv, rel, sel, heads, d, H, W)
    out = dmajor_empty(B, heads * d, N, dtype=qkv.dtype, device=qkv.device)
    _cuda.QKV_GLOBAL(qkv.data_ptr(), rel.data_ptr(), out.data_ptr(), B, N, out.stride(-2), H, W,
                     heads, d, float(scale))
    return out


def flash_qkv_packed_global_bwd_ref(qkv, rel, sel, g, scale, heads, d):
    """(dqkv like qkv, drel like rel) at upstream g (B, heads*d, N)."""
    B, N, _ = qkv.shape
    q, k, v = _heads_rows(qkv, heads, d)
    gr = g.reshape(B, heads, d, N).transpose(-1, -2)
    dq, dk, dv, drel = attention_bwd_ref(q, k, v, rel.permute(1, 2, 0, 3), sel, gr, scale)
    return _unsplit(dq, dk, dv, qkv.dtype), drel.permute(2, 0, 1, 3).to(rel.dtype)


def flash_qkv_packed_global_bwd_ref_chunked(qkv, rel, sel, g, scale, heads, d, chunk=2048):
    """`flash_qkv_packed_global_bwd_ref` a block of `chunk` queries at a
    time: a query's softmax runs over every key, so the rows split exactly
    (dk and dv summed over the blocks). For grids whose (heads, N, N) fp32
    products do not fit the card (N = 256 x 256: 16 GiB a product a head)."""
    B, N, _ = qkv.shape
    f = lambda a: a.float()  # noqa: E731
    q, k, v = _heads_rows(qkv, heads, d)
    relh = rel.permute(1, 2, 0, 3)
    gr = g.reshape(B, heads, d, N).transpose(-1, -2)
    kf, vf, sf, qs = f(k), f(v), f(sel), f(scaled(q, scale))
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    drel = torch.empty(relh.shape, dtype=torch.float32, device=q.device)
    for i in range(0, N, chunk):
        rows = slice(i, min(i + chunk, N))
        P = torch.softmax(torch.matmul(qs[..., rows, :], kf.transpose(-1, -2))
                          + torch.matmul(f(relh[..., rows, :]), sf), dim=-1)
        dP = torch.matmul(f(gr[..., rows, :]), vf.transpose(-1, -2))
        dS = f((P * (dP - (dP * P).sum(-1, keepdim=True))).to(q.dtype))
        dv += torch.matmul(f(P.to(q.dtype)).transpose(-1, -2), f(gr[..., rows, :]))
        dq[..., rows, :] = torch.matmul(dS, kf) * scale
        dk += torch.matmul(dS.transpose(-1, -2), f(q[..., rows, :])) * scale
        drel[..., rows, :] = torch.matmul(dS, sf.transpose(-1, -2))
        del P, dP, dS
    return _unsplit(dq, dk, dv, qkv.dtype), drel.permute(2, 0, 1, 3).to(rel.dtype)


# the fp32 backward (csrc/attn_bwd_f32.cu) holds at most 130 rel slots of a
# key tile whatever H + W is: it takes what its forward takes, and the bf16
# backward as much (GLOBAL_BWD_MAX_LANES)
F32_GLOBAL_BWD_MAX_LANES = F32_GLOBAL_MAX_LANES
assert GLOBAL_BWD_MAX_LANES == F32_GLOBAL_BWD_MAX_LANES


def flash_qkv_packed_global_bwd(qkv, rel, sel, g, scale, heads, d, H, W, o=None):
    """Backward of `flash_qkv_packed_global`: the kernel for CUDA tensors
    (TPU kernel #18; in float32 its fp32 instance, H + W <=
    F32_GLOBAL_BWD_MAX_LANES, which also reads the forward's output `o`),
    the plain backward for CPU tensors. dqkv is written in qkv's packed
    rows, drel in rel's position-major layout."""
    name = "flash_qkv_packed_global_bwd"
    if not _cuda.use_kernel(name, qkv, rel, sel, g):
        return flash_qkv_packed_global_bwd_ref(qkv, rel, sel, g, scale, heads, d)
    B, N, _ = qkv.shape
    if qkv.dtype == torch.float32:  # the fp32 instance (csrc/attn_bwd_f32.cu)
        name += " (float32)"
        _check_global(name, qkv, rel, sel, heads, d, H, W, dtype=torch.float32)
        _check_f32_attention(name, d, B, heads)
        _check_bwd_grad(name, g, torch.float32, (B, heads * d, N))
        if H + W > F32_GLOBAL_BWD_MAX_LANES:
            raise ValueError(f"{name}: CUDA kernel takes H+W <= {F32_GLOBAL_BWD_MAX_LANES} (as "
                             f"its forward), got {H + W}")
        _check_bwd_out(name, o, qkv, (B, heads * d, N))
        return _attn_bwd_f32_launch(_cuda.QKV_GLOBAL_BWD_F32, qkv, rel, g, o, B, heads, N, H, W,
                                    heads, d, float(scale))
    _check_global(name, qkv, rel, sel, heads, d, H, W)
    _check_bwd_grad(name, g, torch.bfloat16, (B, heads * d, N))
    if H + W > GLOBAL_BWD_MAX_LANES:
        raise ValueError(f"{name}: CUDA kernel takes H+W <= {GLOBAL_BWD_MAX_LANES} (as its "
                         f"fp32 instance; square images above 4096 px), got {H + W}")
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
    attention (TPU kernel #10). The kernel is the split front end of
    `csrc/qkv_relpos.cu`'s one pass: it adds the bias without reading sel,
    rel[q, k // W] + rel[q, H + k % W], rounds P unnormalised and divides O
    by the fp32 row sum at the end, where the plain version normalises
    first. It takes d == dv in (64, 80), the head widths of SAM ViT-B and
    ViT-H, which every configuration of the repo has; a CUDA tensor of any
    other depth raises ValueError. In float32 its fp32 instance
    (`csrc/qkv_relpos_f32.cu`, the same d, H + W <= F32_GLOBAL_MAX_LANES).
    Gradients: the VJP of the plain version, as the JAX package's
    `pallas_with_xla_vjp`."""
    return autograd.run("flash_attention_relpos", _relpos_cuda, _relpos_plain,
                        (q, k, v, rel, sel), (H, W))


def _relpos_plain(q, k, v, rel, sel, H, W):
    return xla_attention_relpos(q, k, v, rel, sel)


def _check_relpos_lanes(name, H, W):
    if H + W > F32_GLOBAL_MAX_LANES:
        raise ValueError(f"{name}: CUDA kernel takes H+W <= {F32_GLOBAL_MAX_LANES} (the rel "
                         f"lanes it holds in shared memory), got {H + W}")


def _relpos_f32_cuda(q, k, v, rel, sel, H, W):
    """The fp32 instance (csrc/qkv_relpos_f32.cu) over split rows, one head a
    problem, q pre-scaled (scale 1)."""
    name = "flash_attention_relpos (float32)"
    _cuda.check_dtype(name, torch.float32, q, k, v, rel)
    BB, N, d = q.shape
    if (k.shape != q.shape or v.shape != q.shape or H * W != N or rel.shape != (BB, N, H + W)
            or sel.shape != (H + W, N)):
        raise ValueError(f"{name}: q {q.shape} k {k.shape} v {v.shape} rel {rel.shape} H={H} "
                         f"W={W} (d == dv)")
    _check_f32_attention(name, d, BB, 1)
    _check_relpos_lanes(name, H, W)
    out = torch.empty_like(v)
    _cuda.ATTN_RELPOS_F32(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(),
                          out.data_ptr(), _cuda.layouts(f32_split_layout(BB, N, d, d, H + W)),
                          BB, 1, H, W, d, 1.0, f32_attn_tile(q, d, d, "sep", N, BB, H + W))
    return out


def _relpos_cuda(q, k, v, rel, sel, H, W):
    if q.dtype == torch.float32:
        return _relpos_f32_cuda(q, k, v, rel, sel, H, W)
    name = "flash_attention_relpos"
    BB, N, d, dv = _check_split(name, q, k, v, (rel,))
    if d != dv:
        raise ValueError(f"{name}: CUDA kernel takes d == dv in {_SPLIT_DV}, got d={d}, dv={dv}")
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
    (TPU kernel #20). The kernel (`csrc/attn_fullk.cu`) is the TMA + wgmma
    one pass, which rounds P unnormalised and divides O by the fp32 row sum
    at the end, where the plain version normalises first. In float32 its
    fp32 instance (`csrc/attn_fullk_f32.cu`) at (d_qk, dv) in
    F32_FULLK_DEPTHS. Gradients: the VJP of the plain version."""
    return autograd.run("flash_attention_fullk", _fullk_cuda, flash_attention_fullk_ref,
                        (q_aug, k_aug, v))


# the (d_qk, dv) of the fp32 #20's instances: SAM ViT-H's 'aug_flash' at 1024
# px (80 + 64 + 64 = 208, 80) and the small 'aug_flash' cascade of
# chip_smoke.py's [f32_train_small] (64 + 32 + 32 = 128, 64)
F32_FULLK_DEPTHS = ((208, 80), (128, 64))


def _fullk_f32_cuda(q_aug, k_aug, v):
    """The fp32 instance (csrc/attn_fullk_f32.cu): the flash loop, q' . k'^T
    over d_qk, P . V over dv."""
    name = "flash_attention_fullk (float32)"
    _cuda.check_dtype(name, torch.float32, q_aug, k_aug, v)
    BB, N, dqk = q_aug.shape
    dv = v.shape[-1]
    if k_aug.shape != q_aug.shape or v.shape != (BB, N, dv):
        raise ValueError(f"{name}: q {q_aug.shape} k {k_aug.shape} v {v.shape}")
    if (dqk, dv) not in F32_FULLK_DEPTHS or BB > 65535:
        raise ValueError(f"{name}: CUDA kernel takes (d_qk, dv) in {F32_FULLK_DEPTHS} and at "
                         f"most 65535 problems (got ({dqk}, {dv}), BB={BB})")
    out = torch.empty((BB, N, dv), dtype=v.dtype, device=v.device)
    _cuda.ATTN_FULLK_F32(q_aug.data_ptr(), k_aug.data_ptr(), v.data_ptr(), out.data_ptr(),
                         _cuda.layouts(f32_split_layout(BB, N, dqk, dv)), BB, N, dqk, dv,
                         f32_attn_tile(q_aug, dqk, dv, "none", N, BB))
    return out


def _fullk_cuda(q_aug, k_aug, v):
    if q_aug.dtype == torch.float32:
        return _fullk_f32_cuda(q_aug, k_aug, v)
    BB, N, d, dv = _check_split("flash_attention_fullk", q_aug, k_aug, v)
    out = torch.empty((BB, N, dv), dtype=v.dtype, device=v.device)
    _cuda.ATTN_FULLK(q_aug.data_ptr(), k_aug.data_ptr(), v.data_ptr(), out.data_ptr(), BB, N,
                     d, dv)
    return out


# ------------------------------------ packed qkv, head-leading out (#11, #19)


def flash_qkv_relpos_windows_ref(qkv, rel, sel, scale):
    heads = qkv.shape[-2] // 3
    q, k, v = (qkv[..., i * heads : (i + 1) * heads, :].movedim(-2, 1) for i in range(3))
    return xla_attention_relpos(scaled(q, scale), k, v, rel.movedim(-2, 1), sel)


def flash_qkv_relpos_windows(
    qkv: torch.Tensor,  # (B, nwin, Nw, 3*heads, d): a view of the packed qkv rows
    rel: torch.Tensor,  # (B, nwin, Nw, heads, H+W) [rel_h | rel_w] per query
    sel: torch.Tensor,  # (H+W, Nw) make_rel_scatter(H, W); read by the plain version only
    scale: float,
    H: int,
    W: int,
) -> torch.Tensor:
    """Windowed attention with the decomposed rel-pos bias for H+W beyond
    the 32 packed lanes: the fused 'flash' padded carry at a window of 17 or
    more, and the global blocks of at most 512 tokens with H+W > 32 ->
    head-leading (B, heads, nwin, Nw, d), what `proj_from_heads_res` reads.
    The kernel (`csrc/qkv_relpos.cu`) reads q, k and v in place and adds
    the bias by indexing, in one pass over the keys (P rounded to the
    working type before its normalisation, as #16 and #17). In float32 its
    fp32 instance (`csrc/qkv_relpos_f32.cu`). Gradients: the VJP of the plain
    version."""
    return autograd.run("flash_qkv_relpos_windows", _relpos_windows_cuda,
                        _relpos_windows_plain, (qkv, rel, sel), (scale, H, W))


def _relpos_windows_plain(qkv, rel, sel, scale, H, W):
    return flash_qkv_relpos_windows_ref(qkv, rel, sel, scale)


def _relpos_packed_launch(kernel, f32_kernel, qkv, rel, sel, scale, H, W):
    """qkv (B, nwin, N, 3*heads, d), rel (B, nwin, N, heads, H+W) ->
    (B, heads, nwin, N, d) through `cvlm_qkv_relpos` (`kernel`), or in
    float32 through its fp32 instance `cvlm_attn_relpos_f32` (`f32_kernel`)."""
    f32 = qkv.dtype == torch.float32
    name = kernel.name + (" (float32)" if f32 else "")
    _cuda.check_dtype(name, torch.float32 if f32 else torch.bfloat16, qkv, rel)
    B, nwin, N, h3, d = qkv.shape
    heads = h3 // 3
    if (h3 != 3 * heads or H * W != N or rel.shape != (B, nwin, N, heads, H + W)
            or sel.shape != (H + W, N)):
        raise ValueError(f"{name}: qkv {qkv.shape} rel {rel.shape} H={H} W={W}")
    if f32:
        _check_f32_attention(name, d, B * nwin, heads)
        _check_relpos_lanes(name, H, W)
        out = torch.empty((B, heads, nwin, N, d), dtype=qkv.dtype, device=qkv.device)
        offsets, layout = f32_packed_layout(B, nwin, N, heads, d, H + W)
        f32_kernel(*_packed_ptrs(qkv, offsets), rel.data_ptr(), out.data_ptr(),
                   _cuda.layouts(layout), B * nwin, heads, H, W, d, float(scale),
                   f32_attn_tile(qkv, d, d, "sep", N, B * nwin * heads, H + W))
        return out
    if d not in _SPLIT_DV or B * nwin > 65535:
        raise ValueError(f"{kernel.name}: CUDA kernel takes d in {_SPLIT_DV} and at most "
                         f"65535 (batch, window) pairs (got d={d}, {B * nwin})")
    out = torch.empty((B, heads, nwin, N, d), dtype=qkv.dtype, device=qkv.device)
    kernel(qkv.data_ptr(), rel.data_ptr(), out.data_ptr(), B, nwin, H, W, heads, d,
           float(scale))
    return out


def _relpos_windows_cuda(qkv, rel, sel, scale, H, W):
    return _relpos_packed_launch(_cuda.QKV_RELPOS_WINDOWS, _cuda.QKV_RELPOS_WINDOWS_F32, qkv, rel,
                                 sel, scale, H, W)


def flash_qkv_relpos_global_ref(qkv, rel, sel, scale):
    return flash_qkv_relpos_windows_ref(qkv[:, None], rel[:, None], sel, scale)[:, :, 0]


def flash_qkv_relpos_global(
    qkv: torch.Tensor,  # (B, N, 3*heads, d): a view of the packed qkv rows
    rel: torch.Tensor,  # (B, N, heads, H+W)
    sel: torch.Tensor,  # (H+W, N) make_rel_scatter(H, W); read by the plain version only
    scale: float,
    H: int,
    W: int,
) -> torch.Tensor:
    """`flash_qkv_relpos_windows` over one window of N = H*W tokens ->
    (B, heads, N, d). The JAX package calls it from no path (an ablation
    kernel); so does the port. The kernel is #11's, with its own launch
    count, in float32 #11's fp32 instance with its own. Gradients: the VJP
    of the plain version."""
    return autograd.run("flash_qkv_relpos_global", _relpos_global_cuda, _relpos_global_plain,
                        (qkv, rel, sel), (scale, H, W))


def _relpos_global_plain(qkv, rel, sel, scale, H, W):
    return flash_qkv_relpos_global_ref(qkv, rel, sel, scale)


def _relpos_global_cuda(qkv, rel, sel, scale, H, W):
    out = _relpos_packed_launch(_cuda.QKV_RELPOS_GLOBAL, _cuda.QKV_RELPOS_GLOBAL_F32,
                                qkv[:, None], rel[:, None], sel, scale, H, W)
    return out[:, :, 0]
