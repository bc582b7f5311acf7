"""SAM image encoder (ViTDet-style ViT) with the EVP prompt generator.

Counterpart of `camouflaged_vlm_tpu/models/sam_encoder.py`, with its four
attention implementations:

  'flash'      the JAX package's default and production path. With
               num_heads % 8 == 0 and the rel-pos bias it is fused. With a
               window of at most 14, windowed blocks run in the compact
               (pad-free) carry (`ops/compact_window.py`): LN1+qkv
               (`ln_linear_act_bt`), the interior-window and edge-window
               attention kernels, the out-projection with the residual
               (`proj_rows`) and LN2+MLP+residual (`ln_mlp_residual_bt`).
               Every other fused block (the padded window carry of a larger
               window, and the global blocks) runs LN1+mask+qkv
               (`ln_mask_linear_bt`), then JAX's branches
               (`Attention.fused_route`): padded windows or a global block
               of <= 512 tokens with H+W <= 32 take the padded windows
               kernel (#12) and `proj_rows`, with H+W > 32 the head-leading
               kernel (#11) and `proj_from_heads_res` (#8); larger global
               blocks the global kernel (#17) and `proj_rows`; then
               `ln_mlp_residual_bt`. The rel-pos bias is never
               materialised: its rank-2 factors are built with einsums and
               the kernels add them by indexing. Otherwise (SAM ViT-B's
               12 heads, the 4-head tiny config) it is unfused: plain LN,
               qkv and MLP, windowed blocks in the padded window carry,
               and every block's attention is
               `flash_attention_relpos` (TPU kernel #10) over split q, k, v
               with the rel factors [rel_h | rel_w] of the unscaled q.
  'aug_flash'  the bias as augmented features (`ops/aug_attention.py`):
               blocks of >= 1024 tokens through `flash_attention_fullk`
               (TPU kernel #20), the others through plain `attention_xla`
               (XLA code in the JAX package, which makes the same choice).
  'aug_xla'    augmented features, `attention_xla` everywhere.
  'reference'  dense decomposed rel-pos attention and a plain MLP in
               PyTorch, windowed blocks in the padded window carry (pad
               tokens re-zeroed after every LN1): the parity anchor.

The patch embeds go through the `linear_act` kernel. Layouts are the JAX
package's: NHWC images and grids, (B', S, C) sequences. Parameter names are
the reference's state-dict keys.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.compact_window import (
    REL_LANES,
    CompactGeometry,
    compact_partition,
    compact_unpartition,
    edge_consts,
    edge_rel_lpad,
)
from ..ops.aug_attention import attention_xla, augment_qk
from ..ops.fft_prompt import fft_highpass
from ..ops.flash_attention import (
    flash_attention_fullk,
    flash_attention_relpos,
    flash_qkv_packed_edge,
    flash_qkv_packed_global,
    flash_qkv_packed_windows,
    flash_qkv_packed_windows_s,
    flash_qkv_relpos_windows,
    make_rel_scatter,
    make_rel_scatter32,
)
from ..ops.layers import conv_nhwc, dense, scaled
from ..ops.linear import (
    linear_act,
    ln_linear_act_bt,
    ln_mask_linear_bt,
    ln_mlp_residual_bt,
    proj_from_heads,
    proj_from_heads_res,
    proj_rows,
)
from ..ops.norms import LayerNormFP32
from ..ops.rel_pos import attention_with_decomposed_rel_pos, get_rel_pos_table
from ..ops.window import window_partition_seq, window_unpartition_seq, window_valid_mask
from ..parallel.sharding import (
    add_residual,
    copy_to_model,
    local_heads,
    reduce_from_model,
    replicated,
    row_bias,
    row_linear,
    tp_of,
)


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
    # 'flash' | 'aug_flash' | 'aug_xla' | 'reference'; see the module docstring
    attn_impl: str = "flash"
    gelu_approximate: bool = True
    # recompute each block's forward in the backward pass instead of keeping
    # its activations (torch.utils.checkpoint, JAX's nn.remat): training
    # keeps only the blocks' inputs; no effect on inference
    remat: bool = False

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


def fused_attention_enabled(attn_impl: str, use_rel_pos: bool, num_heads: int) -> bool:
    """The fused attention data path (the 'flash' kernels), as in the JAX
    package: it needs the rel-pos bias and head groups of 8."""
    return attn_impl == "flash" and use_rel_pos and num_heads % 8 == 0


ATTN_IMPLS = ("flash", "aug_flash", "aug_xla", "reference")
# augment_qk's zero padding of d + H + W on the 'aug_*' paths: the multiple
# of 16 the kernels' MMA depth needs (the JAX package pads to 128 lanes);
# zero lanes change no score
AUG_PAD = 16


def check_attn_impl(cfg: "SamEncoderConfig") -> None:
    """Raise on an unknown implementation. Every implementation takes any
    window and grid the JAX package takes."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={cfg.attn_impl!r}: expected one of {ATTN_IMPLS}")


def make_rcomb(H, W, rel_pos_h, rel_pos_w, dt, lanes=REL_LANES):
    """Combined per-(qh, qw) rel table (H, W, hd, lanes) in `dt`: lane j < H
    holds Rh[qh, j], lanes H..H+W-1 hold Rw[qw, j-H], the rest zero. One
    einsum of the unscaled queries with it gives the kernels' packed
    [rel_h | rel_w | 0] rel factors."""
    if H + W > lanes:
        raise ValueError(f"make_rcomb: H+W={H + W} exceeds {lanes} lanes")
    Rh = get_rel_pos_table(H, H, rel_pos_h).to(dt)  # (qh, kh, hd)
    Rw = get_rel_pos_table(W, W, rel_pos_w).to(dt)  # (qw, kw, hd)
    hd = Rh.shape[-1]
    parts = [Rh.transpose(1, 2)[:, None].expand(H, W, hd, H),
             Rw.transpose(1, 2)[None].expand(H, W, hd, W)]
    if lanes > H + W:
        parts.append(Rh.new_zeros(H, W, hd, lanes - H - W))
    return torch.cat(parts, dim=-1)


def rel_smajor_windows(qkv_flat, rel_pos_h, rel_pos_w, win, heads, hd, rcomb=None):
    """Position-major packed rel of the windowed blocks. qkv_flat (BW, S,
    3*heads*hd), UNSCALED q in the leading lanes -> (rel_s (S, BW,
    heads*32), sel32 (32, S)). One einsum per head against the (S, hd, 32)
    combined table: the JAX package's no-cache formulation; `rcomb` is the
    cached table (`precompute_rel_tables`)."""
    S = win * win
    if rcomb is None:
        rcomb = make_rcomb(win, win, rel_pos_h, rel_pos_w, qkv_flat.dtype)
    rc = rcomb.to(qkv_flat.dtype).reshape(S, hd, REL_LANES)
    q = qkv_flat[:, :, : heads * hd].reshape(-1, S, heads, hd)
    rel_s = torch.einsum("wshr,src->swhc", q, rc).reshape(S, -1, heads * REL_LANES)
    return rel_s.contiguous(), make_rel_scatter32(win, qkv_flat.dtype, qkv_flat.device)


def rel_packed32(q_heads, rel_pos_h, rel_pos_w, H, W, rcomb=None):
    """Window-major packed rel of the fused padded windows and the global
    blocks of <= 512 tokens with H+W <= 32 (#12). q_heads (..., H, W, heads,
    hd) UNSCALED -> (rel (..., H, W, heads, 32) = [rel_h | rel_w | 0] per
    head, sel32 (32, H*W)). One einsum against the combined (H, W, hd, 32)
    table, `rcomb` when cached."""
    dt = q_heads.dtype
    if rcomb is None:
        rcomb = make_rcomb(H, W, rel_pos_h, rel_pos_w, dt)
    rel = torch.einsum("...hwnc,hwcj->...hwnj", q_heads, rcomb.to(dt))
    sel = make_rel_scatter(H, W, dt, q_heads.device)
    return rel.contiguous(), torch.cat([sel, sel.new_zeros(REL_LANES - H - W, H * W)])


def global_rel_tables(H, W, rel_pos_h, rel_pos_w, dt):
    """(Rh (H, H, hd), Rw (W, W, hd)) in `dt`: the rel tables of the fused
    blocks that take #11 or #17 and of every unfused 'flash' block."""
    return (get_rel_pos_table(H, H, rel_pos_h).to(dt),
            get_rel_pos_table(W, W, rel_pos_w).to(dt))


def rel_and_scatter(q_heads, rel_pos_h, rel_pos_w, H, W, tables=None):
    """The rel factors of the unfused 'flash' path. q_heads (..., H, W, heads,
    hd) UNSCALED -> (rel (..., H, W, heads, H+W) = [rel_h | rel_w] per query,
    sel (H+W, H*W)) with bias[q, k] = (rel @ sel)[q, k]; `tables` is the
    cached (Rh, Rw)."""
    dt = q_heads.dtype
    Rh, Rw = tables if tables is not None else global_rel_tables(H, W, rel_pos_h, rel_pos_w, dt)
    rel_h = torch.einsum("...hwnc,hkc->...hwnk", q_heads, Rh.to(dt))
    rel_w = torch.einsum("...hwnc,wkc->...hwnk", q_heads, Rw.to(dt))
    return torch.cat([rel_h, rel_w], dim=-1), make_rel_scatter(H, W, dt, q_heads.device)


def rel_smajor_global(q_heads, rel_pos_h, rel_pos_w, H, W, tables=None):
    """Position-major packed rel of the global blocks. q_heads (B, H, W,
    heads, hd) UNSCALED -> (rel_s (H*W, B, heads, H+W), sel (H+W, H*W)) with
    bias[q, k] = (rel_s[q] @ sel)[k]. Two einsums against Rh and Rw (cached
    as `tables`), the same products as the JAX package's combined-table
    einsum without its (H, W, hd, H+W) table."""
    B, _, _, heads, _ = q_heads.shape
    dt = q_heads.dtype
    Rh, Rw = tables if tables is not None else global_rel_tables(H, W, rel_pos_h, rel_pos_w, dt)
    rel_h = torch.einsum("bhwnc,hkc->hwbnk", q_heads, Rh.to(dt))
    rel_w = torch.einsum("bhwnc,wkc->hwbnk", q_heads, Rw.to(dt))
    rel_s = torch.cat([rel_h, rel_w], dim=-1).reshape(H * W, B, heads, H + W)
    return rel_s, make_rel_scatter(H, W, dt, q_heads.device)


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
    sequences with S == H*W of `input_size` (one window for the windowed
    blocks, the grid for the global ones). `forward` is every unfused path
    ('reference', unfused 'flash', 'aug_*'); `forward_compact` (the compact
    carry) and `forward_fused` (the padded carry's windows, B' = B *
    `num_windows`, and the global blocks) are the fused 'flash' path.

    Sharded over a model group (`parallel.shard_model_`) each rank holds
    the qkv rows of num_heads / n_model whole heads and the matching
    columns of `proj`: it runs its heads through the same kernels (the
    route is the unsharded one's) and returns its partial projection in
    fp32, unrounded, with the bias on model rank 0 only and no residual;
    `Block` sums the partials over the group and adds the residual."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool,
                 input_size: Tuple[int, int], dtype: torch.dtype, attn_impl: str,
                 num_windows: int = 1, compact: bool = False):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.input_size, self.dtype = input_size, dtype
        self.attn_impl = attn_impl
        self.num_windows, self.compact = num_windows, compact
        self.fused = fused_attention_enabled(attn_impl, use_rel_pos, num_heads)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            hd = dim // num_heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))
        # (tables, versions of rel_pos_h/w when built); see attach_rel_cache
        self.rel_cache = None

    @property
    def uses_rel_tables(self) -> bool:
        """The 'flash' paths read param-derived rel tables; the others build
        their bias from the rel-pos parameters in the forward."""
        return self.attn_impl == "flash" and self.use_rel_pos

    @property
    def fused_route(self) -> Optional[str]:
        """The fused 'flash' block's attention, by the JAX package's
        conditions (`Attention.__call__`): 'compact' (#13 and #15 on the
        compact carry); 'packed' (#12: padded windows, or a global block of
        <= 512 tokens, with H+W <= 32); 'relpos' (#11 and #8: the same with
        H+W > 32); 'global' (#17). None off the fused path."""
        if not self.fused:
            return None
        if self.compact:
            return "compact"
        H, W = self.input_size
        if self.num_windows > 1 or H * W <= 512:
            return "packed" if H + W <= REL_LANES else "relpos"
        return "global"

    def rel_pos(self):
        """(rel_pos_h, rel_pos_w) as the forward reads them: replicated
        parameters inside the parallel region when sharded."""
        tp = tp_of(self)
        return replicated(tp, self.rel_pos_h), replicated(tp, self.rel_pos_w)

    def build_rel_tables(self):
        """The 'flash' path's param-derived rel tables in the compute type:
        Rcomb (H, W, hd, 32) for a fused block on the 'compact' or 'packed'
        route, (Rh, Rw) for the other fused blocks and every unfused one."""
        H, W = self.input_size
        rel_pos_h, rel_pos_w = self.rel_pos()
        if self.fused_route in ("compact", "packed"):
            return make_rcomb(H, W, rel_pos_h, rel_pos_w, self.dtype)
        return global_rel_tables(H, W, rel_pos_h, rel_pos_w, self.dtype)

    def set_rel_cache(self, tables) -> None:
        self.rel_cache = (tables, (self.rel_pos_h._version, self.rel_pos_w._version))

    def rel_tables(self):
        """The cached tables if attached, else built in the forward (as the
        JAX package does without its 'relcache' collection)."""
        if self.rel_cache is None:
            return self.build_rel_tables()
        tables, versions = self.rel_cache
        if versions != (self.rel_pos_h._version, self.rel_pos_w._version):
            raise RuntimeError(
                "stale rel cache: the rel-pos parameters changed after attach_rel_cache "
                "(e.g. a state-dict load); call factory.attach_rel_cache again"
            )
        return tables

    def _weights(self):
        """The qkv and proj weights in the compute type (this rank's shard,
        and the proj bias on model rank 0 only, when sharded)."""
        dt = self.dtype
        return (self.qkv.weight.to(dt), self.qkv.bias.to(dt),
                self.proj.weight.to(dt), row_bias(tp_of(self), self.proj.bias).to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The unfused paths on LN1's output x (B, N, C), the JAX package's
        branches (`Attention.__call__` past its fused block): 'reference';
        'flash' with rel-pos (the rel factors of the unscaled q, then #10 on
        the scaled q); otherwise the augmented features, through #20 at
        'aug_flash' or 'flash' for N >= 1024 and `attention_xla` else."""
        B, N, _ = x.shape
        H, W = self.input_size
        tp = tp_of(self)
        hd = self.dim // self.num_heads
        heads = local_heads(self.num_heads, tp)
        scale = hd ** -0.5
        qkv = dense(x, self.qkv, self.dtype).reshape(B, N, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, heads, N, hd)
        rel_pos_h, rel_pos_w = self.rel_pos() if self.use_rel_pos else (None, None)
        # (B, heads, N, c) -> the kernels' (B*heads, N, c) problems
        flat = lambda t: t.reshape(B * heads, N, t.shape[-1]).contiguous()  # noqa: E731
        if self.attn_impl == "reference":
            out = attention_with_decomposed_rel_pos(q, k, v, rel_pos_h, rel_pos_w, (H, W),
                                                    scale)
        elif self.attn_impl == "flash" and self.use_rel_pos:
            rel, sel = rel_and_scatter(q.transpose(1, 2).reshape(B, H, W, heads, hd),
                                       rel_pos_h, rel_pos_w, H, W, tables=self.rel_tables())
            rel = rel.reshape(B, N, heads, H + W).transpose(1, 2)  # (B, heads, N, H+W)
            out = flash_attention_relpos(flat(scaled(q, scale)), flat(k), flat(v), flat(rel),
                                         sel, H, W).reshape(B, heads, N, hd)
        else:
            q_aug, k_aug = augment_qk(q, k, rel_pos_h, rel_pos_w, (H, W), scale,
                                      pad_to=AUG_PAD)
            if self.attn_impl in ("aug_flash", "flash") and N >= 1024:
                out = flash_attention_fullk(flat(q_aug), flat(k_aug), flat(v))
                out = out.reshape(B, heads, N, hd)
            else:
                out = attention_xla(q_aug, k_aug, v)
        return row_linear(tp, out.transpose(1, 2).reshape(B, N, heads * hd), self.proj, self.dtype)

    def forward_fused(self, x: torch.Tensor, norm1: LayerNormFP32,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """'flash' block off the compact carry: x (B * nwin, H*W, C) is the
        block's raw input, the padded window carry with its valid `mask`
        (nwin, H*W, 1) or a global block (nwin 1, no mask); returns
        x + proj(attention(LN1(x) * mask)) by `fused_route`. LN1 and the mask
        ride the qkv kernel's prologue, the residual the projection's
        epilogue. Sharded: this rank's fp32 partial of proj(...), no x."""
        Bp, N, C = x.shape
        H, W = self.input_size
        tp, nwin = tp_of(self), self.num_windows
        hd = C // self.num_heads
        heads = local_heads(self.num_heads, tp)
        Cl = heads * hd  # this rank's heads' width
        scale = hd ** -0.5
        B = Bp // nwin
        wq, bq, wp, bp = self._weights()
        m = mask.to(x.dtype) if mask is not None else x.new_ones(1, N, 1)
        qkv = ln_mask_linear_bt(x, replicated(tp, norm1.weight), replicated(tp, norm1.bias), m,
                                wq, bq, eps=norm1.eps)
        qh = qkv[:, :, :Cl].reshape(Bp, H, W, heads, hd)  # unscaled q
        partial = tp is not None
        tables, res = self.rel_tables(), None if partial else x.reshape(B, nwin, N, C)
        rel_pos_h, rel_pos_w = self.rel_pos()
        route = self.fused_route
        if route == "packed":
            rel, sel32 = rel_packed32(qh, rel_pos_h, rel_pos_w, H, W, rcomb=tables)
            out = flash_qkv_packed_windows(qkv.reshape(B, nwin, N, 3 * Cl),
                                           rel.reshape(B, nwin, N, heads * REL_LANES), sel32,
                                           scale, heads, hd)  # (B, nwin, Cl, N)
            y = proj_rows(out, wp, bp, res, partial)
        elif route == "relpos":
            rel, sel = rel_and_scatter(qh, rel_pos_h, rel_pos_w, H, W, tables=tables)
            out = flash_qkv_relpos_windows(qkv.reshape(B, nwin, N, 3 * heads, hd),
                                           rel.reshape(B, nwin, N, heads, H + W), sel, scale,
                                           H, W)  # (B, heads, nwin, N, hd)
            y = (proj_from_heads(out, wp, bp, partial=True) if partial
                 else proj_from_heads_res(out, wp, bp, res))
        else:
            rel_s, sel = rel_smajor_global(qh, rel_pos_h, rel_pos_w, H, W, tables=tables)
            out = flash_qkv_packed_global(qkv, rel_s, sel, scale, heads, hd, H, W)
            y = proj_rows(out.reshape(B, 1, Cl, N), wp, bp, res, partial)
        return y.reshape(Bp, N, C)

    def forward_compact(self, xf: torch.Tensor, xe: Optional[torch.Tensor],
                        norm1: LayerNormFP32, geom: CompactGeometry):
        """'flash' windowed block on the compact carry: x_full (B*n_full,
        win^2, C) through the interior-window kernel, x_edge (B, E, C)
        through the edge kernel with its virtual pad key. Both are raw block
        inputs; returns (x_full + attn, x_edge + attn), sharded this rank's
        fp32 partials of (attn, attn) without x."""
        win, C = geom.win, self.dim
        tp = tp_of(self)
        hd = C // self.num_heads
        heads = local_heads(self.num_heads, tp)
        Cl = heads * hd  # this rank's heads' width
        scale = hd ** -0.5
        S, nf = win * win, geom.n_full
        B = xf.shape[0] // nf
        wq, bq, wp, bp = self._weights()
        g1, b1 = replicated(tp, norm1.weight), replicated(tp, norm1.bias)
        rcomb = self.rel_tables()
        rel_pos_h, rel_pos_w = self.rel_pos()

        qkv_f = ln_linear_act_bt(xf, g1, b1, wq, bq, eps=norm1.eps,
                                 activation=None)  # (B*nf, S, 3Cl)
        rel_s, sel32 = rel_smajor_windows(qkv_f, rel_pos_h, rel_pos_w, win, heads, hd,
                                          rcomb=rcomb)
        out_f = flash_qkv_packed_windows_s(qkv_f, rel_s, sel32, scale, heads, hd)
        partial = tp is not None
        yf = proj_rows(out_f.reshape(B, nf, Cl, S), wp, bp,
                       None if partial else xf.reshape(B, nf, S, C), partial)
        yf = yf.reshape(B * nf, S, C)
        if xe is None:
            return yf, None

        n, R = geom.n_edge, geom.R_u
        qkv_e = ln_linear_act_bt(xe, g1, b1, wq, bq, eps=norm1.eps,
                                 activation=None)  # (B, E, 3Cl)
        k_bias = self.qkv.bias[Cl : 2 * Cl].reshape(heads, hd)
        rel_e = edge_rel_lpad(qkv_e[:, :, :Cl].reshape(B, geom.E, heads, hd), rcomb, k_bias,
                              scale, geom)  # (B, E, heads, 32), Lpad in lane 28
        sel_e, kmask_e = edge_consts(geom, qkv_e.dtype, xe.device)
        vb = bq[2 * Cl :].reshape(heads, hd)  # the pad tokens' value
        out_e = flash_qkv_packed_edge(qkv_e.reshape(B, n, R, 3 * Cl),
                                      rel_e.reshape(B, n, R, heads * REL_LANES),
                                      sel_e, vb, kmask_e, scale, heads, hd)
        ye = proj_rows(out_e, wp, bp, None if partial else xe.reshape(B, n, R, C), partial)
        return yf, ye.reshape(B, geom.E, C)


class MLPBlock(nn.Module):
    """lin1 -> GELU -> lin2; sharded, this rank's slice of the hidden width
    into an fp32 partial, lin2's bias on model rank 0 only."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype, gelu_approximate: bool):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.dtype = dtype
        self.approximate = "tanh" if gelu_approximate else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(dense(x, self.lin1, self.dtype), approximate=self.approximate)
        return row_linear(tp_of(self), h, self.lin2, self.dtype)


class Block(nn.Module):
    """Pre-norm ViT block on (B', S, C).

    Windowed blocks off the compact carry run in the padded window carry
    (B' = B * nWin, S = window^2) and get `mask`, which re-zeroes the pad
    tokens after LN1 (the reference zero-pads after LN1, so a pad key or
    value equals the qkv bias). Fused 'flash': windowed blocks with a window
    of at most 14 take the compact carry (x_full, x_edge) with its `geom`;
    global blocks take (B, H*W, C); LN1 (and the mask) and LN2 ride the
    kernels' prologues and both residuals their epilogues."""

    def __init__(self, cfg: SamEncoderConfig, attn_size: Tuple[int, int],
                 num_windows: int = 1, compact: bool = False):
        super().__init__()
        self.norm1 = LayerNormFP32(cfg.embed_dim, eps=1e-6)
        self.attn = Attention(cfg.embed_dim, cfg.num_heads, cfg.use_rel_pos,
                              attn_size, cfg.dtype, cfg.attn_impl, num_windows, compact)
        self.norm2 = LayerNormFP32(cfg.embed_dim, eps=1e-6)
        self.mlp = MLPBlock(cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio),
                            cfg.dtype, cfg.gelu_approximate)
        self.act = "gelu_tanh" if cfg.gelu_approximate else "gelu"
        self.dtype = cfg.dtype

    def _summed(self, partials, xs):
        """A sharded sublayer's output for each x of xs (None passes
        through): its ranks' fp32 partials summed over the model group (one
        all-reduce for all of them), then x added and rounded once."""
        sums = reduce_from_model(tp_of(self), *partials)
        sums = sums if isinstance(sums, tuple) else (sums,)
        out = [None if x is None else add_residual(s, x, self.dtype) for s, x in zip(sums, xs)]
        return out[0] if len(out) == 1 else tuple(out)

    def _fused_mlp(self, *xs: Optional[torch.Tensor]):
        """x + MLP(LN2(x)) as one kernel, for each x of xs (None passes
        through). Sharded, each rank runs its slice of the hidden width into
        an fp32 partial (lin2's bias on model rank 0 only), `_summed`."""
        dt, m, tp = self.dtype, self.mlp, tp_of(self)
        args = (m.lin1.weight.to(dt), m.lin1.bias.to(dt), m.lin2.weight.to(dt),
                row_bias(tp, m.lin2.bias).to(dt))
        kw = dict(eps=self.norm2.eps, activation=self.act)
        if tp is None:
            out = [None if x is None else ln_mlp_residual_bt(
                x, self.norm2.weight, self.norm2.bias, *args, **kw) for x in xs]
            return out[0] if len(out) == 1 else tuple(out)
        xin = copy_to_model(tp, *xs) if len(xs) > 1 else (copy_to_model(tp, xs[0]),)
        g2, b2 = replicated(tp, self.norm2.weight), replicated(tp, self.norm2.bias)
        return self._summed([None if x is None else ln_mlp_residual_bt(
            x, g2, b2, *args, residual=False, **kw) for x in xin], xs)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                geom: Optional[CompactGeometry] = None):
        tp = tp_of(self)
        if geom is not None:  # 'flash' windowed block, compact carry
            if tp is None:
                return self._fused_mlp(*self.attn.forward_compact(x[0], x[1], self.norm1, geom))
            xf, xe = copy_to_model(tp, x[0], x[1])
            return self._fused_mlp(*self._summed(
                self.attn.forward_compact(xf, xe, self.norm1, geom), x))
        if self.attn.fused:  # 'flash' padded windows or global block
            if tp is None:
                return self._fused_mlp(self.attn.forward_fused(x, self.norm1, mask))
            y = self.attn.forward_fused(copy_to_model(tp, x), self.norm1, mask)
            return self._fused_mlp(self._summed([y], [x]))
        shortcut = x
        x = self.norm1(x)
        if mask is not None:  # (nwin, S, 1), broadcast over B' = B * nwin
            nwin = mask.shape[0]
            x = (x.reshape(-1, nwin, *x.shape[1:]) * mask[None].to(x.dtype)).reshape(x.shape)
        dt = shortcut.dtype
        x = shortcut + reduce_from_model(tp, self.attn(copy_to_model(tp, x))).to(dt)
        return x + reduce_from_model(tp, self.mlp(copy_to_model(tp, self.norm2(x)))).to(dt)


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
        check_attn_impl(cfg)
        self.cfg = cfg
        self.fused = fused_attention_enabled(cfg.attn_impl, cfg.use_rel_pos, cfg.num_heads)
        g, win = cfg.grid, cfg.window_size
        # fused windowed blocks take the compact carry where its layout holds
        # the window (<= 14), else the padded carry of nwin windows per image
        self.compact = (self.fused and win > 0
                        and CompactGeometry(g, g, win).supported())
        nwin = (-(-g // win)) ** 2 if win > 0 else 1
        self.patch_embed = PatchEmbedMatmul(cfg.in_chans, cfg.embed_dim,
                                            cfg.patch_size, cfg.dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            Block(cfg, (win, win), nwin, self.compact) if self._windowed(i)
            else Block(cfg, (g, g))
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
        pg = self.prompt_generator
        inp = x
        x = self.patch_embed(x)  # (B, h, w, D)
        prompt_features = pg.init_features(inp, x)
        x = x + self.pos_embed.to(cfg.dtype)

        B, H, W, D = x.shape
        win = cfg.window_size
        geom = None
        if any(self._windowed(i) for i in range(cfg.depth)):
            if self.compact:
                # compact carry: prompt features partitioned once, edge
                # dummy rows carried and dropped at unpartition
                geom = CompactGeometry(H, W, win)
                pf_f, pf_e = compact_partition(prompt_features, geom)
            else:
                valid = window_valid_mask(H, W, win, device=x.device)
                pf_w, _ = window_partition_seq(prompt_features, win)

        interm = []
        x_w = None  # padded window carry
        xc = None   # compact carry (x_full, x_edge) ('flash')
        # JAX's nn.remat(Block): only the block is recomputed; the prompts,
        # the partitions and interm stay outside
        remat = cfg.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            if remat:
                blk = functools.partial(checkpoint, blk, use_reentrant=False)
            if self._windowed(i) and geom is not None:
                if xc is None:
                    xc = compact_partition(x, geom)
                xf = xc[0] + pg.block_prompt(pf_f, i)
                xe = xc[1] + pg.block_prompt(pf_e, i) if xc[1] is not None else None
                xc = blk((xf, xe), geom=geom)
            elif self._windowed(i):
                if x_w is None:
                    x_w, pad_hw = window_partition_seq(x, win)
                x_w = x_w + pg.block_prompt(pf_w, i)
                x_w = blk(x_w, valid)
            else:
                if xc is not None:
                    x = compact_unpartition(xc[0], xc[1], geom)
                    xc = None
                if x_w is not None:
                    x = window_unpartition_seq(x_w, win, pad_hw, (H, W))
                    x_w = None
                x = x + pg.block_prompt(prompt_features, i)
                x = blk(x.reshape(B, H * W, D)).reshape(B, H, W, D)
                interm.append(x)
        if xc is not None:
            x = compact_unpartition(xc[0], xc[1], geom)
        if x_w is not None:
            x = window_unpartition_seq(x_w, win, pad_hw, (H, W))

        y = conv_nhwc(x, self.neck[0], cfg.dtype)
        y = self.neck[1](y)
        y = conv_nhwc(y, self.neck[2], cfg.dtype)
        return self.neck[3](y), interm


@torch.no_grad()
def precompute_rel_tables(encoder: ImageEncoderViT) -> dict:
    """{block index: its 'flash' rel tables} for every block that reads them
    (`Attention.uses_rel_tables`): Rcomb (H, W, hd, 32) per fused block on
    the 'compact' or 'packed' route (~1 MB at ViT-H in bf16), (Rh, Rw) per
    other fused block and per unfused 'flash' block. The other paths build
    their bias in the forward and get no cache. Counterpart of the JAX
    `precompute_rel_tables`, which caches the TPU einsum's block-diagonal
    kron(I_8, Rcomb) tables instead (~5.2 GB at ViT-H in bf16) and fails on
    a window of 17 or more (its `make_rcomb` asserts H+W <= 32); the port
    caches every geometry it runs."""
    return {i: blk.attn.build_rel_tables() for i, blk in enumerate(encoder.blocks)
            if blk.attn.uses_rel_tables}
