"""Compact (pad-free) window layout for SAM's windowed attention.

Counterpart of `camouflaged_vlm_tpu/ops/compact_window.py`. The reference
pads the token grid to a multiple of the window before every windowed block
(ViT-H: 64x64 tokens -> 70x70 = 25 windows of 196); the compact layout
keeps only the real tokens:

    x_full: (B * n_full, win*win, C)   interior windows (all tokens real)
    x_edge: (B, n_edge * R_u, C)       right | bottom | corner windows,
                                       window-major, row-major inside

All edge windows share one row count R_u; narrower windows (the corner)
carry zero dummy rows, whose keys are masked and whose outputs are dropped.
ViT-H: n_full = 16, n_edge = 9, R_u = 112 -> 4144 rows per image, not 4900.

The reference zero-pads *after* LN1, so a pad token's k and v equal the
qkv bias. Its attention logit for a query at window position (qh, qw) is
q.k_bias*scale + rel_h[qh, kh] + rel_w[qw, kw]; the pad positions of a
window are a union of at most two row x column product sets, so their whole
probability mass is one virtual key with the logit

    Lpad = logsumexp_t [ q.k_bias*scale + LSE(rel_h over kh_t)
                                        + LSE(rel_w over kw_t) ],

carried to the edge attention in rel lane LPAD_LANE (`edge_rel_lpad`).
Softmax over [real keys | virtual key] equals the reference's softmax over
the padded window.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .constants import device_constant

# Per head, rel lanes [0, win) hold rel_h over kh, [win, 2*win) rel_w over
# kw; edge windows carry the virtual-pad-key logit in lane LPAD_LANE.
REL_LANES = 32
LPAD_LANE = 28
NEG = -1e30


@dataclasses.dataclass(frozen=True)
class EdgeGroup:
    """`n` edge windows of `nr` x `nc` real tokens; `terms` lists each
    window's pad-position product sets as (kh_lo, kh_hi, kw_lo, kw_hi)."""

    n: int
    nr: int
    nc: int
    terms: Tuple[Tuple[int, int, int, int], ...]

    @property
    def rows(self) -> int:
        return self.nr * self.nc


@dataclasses.dataclass(frozen=True)
class CompactGeometry:
    """The compact window layout of an (H, W) grid."""

    H: int
    W: int
    win: int

    @property
    def nh(self) -> int:
        return self.H // self.win

    @property
    def nw(self) -> int:
        return self.W // self.win

    @property
    def rb(self) -> int:  # bottom-edge real rows
        return self.H % self.win

    @property
    def rw(self) -> int:  # right-edge real columns
        return self.W % self.win

    @property
    def n_full(self) -> int:
        return self.nh * self.nw

    @property
    def has_edge(self) -> bool:
        return self.rb > 0 or self.rw > 0

    @property
    def edge_groups(self) -> Tuple[EdgeGroup, ...]:
        """Right, bottom and corner groups, in x_edge's window order."""
        k, nh, nw, rb, rw = self.win, self.nh, self.nw, self.rb, self.rw
        groups = []
        if rw:
            groups.append(EdgeGroup(nh, k, rw, ((0, k, rw, k),)))
        if rb:
            groups.append(EdgeGroup(nw, rb, k, ((rb, k, 0, k),)))
        if rb and rw:
            groups.append(EdgeGroup(1, rb, rw, ((rb, k, 0, k), (0, rb, rw, k))))
        return tuple(groups)

    @property
    def n_edge(self) -> int:
        return sum(g.n for g in self.edge_groups)

    @property
    def R_u(self) -> int:
        return max((g.rows for g in self.edge_groups), default=0)

    @property
    def E(self) -> int:
        return self.n_edge * self.R_u

    def supported(self) -> bool:
        return 2 * self.win <= LPAD_LANE


def compact_partition(
    x: torch.Tensor, geom: CompactGeometry
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, H, W, C) -> (x_full (B*n_full, win^2, C), x_edge (B, E, C) | None)."""
    B, H, W, C = x.shape
    k, nh, nw, rb, rw = geom.win, geom.nh, geom.nw, geom.rb, geom.rw
    fh, fw = nh * k, nw * k
    xf = (
        x[:, :fh, :fw]
        .reshape(B, nh, k, nw, k, C)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(B * nh * nw, k * k, C)
    )
    if not geom.has_edge:
        return xf, None
    R = geom.R_u
    parts = []
    if rw:
        parts.append(x[:, :fh, fw:].reshape(B, nh, k * rw, C))
    if rb:
        parts.append(
            x[:, fh:, :fw].reshape(B, rb, nw, k, C).permute(0, 2, 1, 3, 4)
            .reshape(B, nw, rb * k, C)
        )
    if rb and rw:
        parts.append(x[:, fh:, fw:].reshape(B, 1, rb * rw, C))
    parts = [F.pad(p, (0, 0, 0, R - p.shape[2])) if p.shape[2] != R else p for p in parts]
    return xf, torch.cat(parts, dim=1).reshape(B, geom.E, C)


def compact_unpartition(
    xf: torch.Tensor, xe: Optional[torch.Tensor], geom: CompactGeometry
) -> torch.Tensor:
    """Inverse of `compact_partition` -> (B, H, W, C); dummy rows dropped."""
    k, nh, nw, rb, rw = geom.win, geom.nh, geom.nw, geom.rb, geom.rw
    C = xf.shape[-1]
    fh, fw = nh * k, nw * k
    B = xf.shape[0] // (nh * nw)
    full = xf.reshape(B, nh, nw, k, k, C).permute(0, 1, 3, 2, 4, 5).reshape(B, fh, fw, C)
    if xe is None:
        return full
    xe = xe.reshape(B, geom.n_edge, geom.R_u, C)
    off = 0
    top, bot = full, None
    if rw:
        right = xe[:, :nh, : k * rw].reshape(B, fh, rw, C)
        off += nh
        top = torch.cat([full, right], dim=2)
    if rb:
        bot = (
            xe[:, off : off + nw, : rb * k].reshape(B, nw, rb, k, C)
            .permute(0, 2, 1, 3, 4).reshape(B, rb, fw, C)
        )
        off += nw
        if rw:
            corner = xe[:, off, : rb * rw].reshape(B, rb, rw, C)
            bot = torch.cat([bot, corner], dim=2)
    return torch.cat([top, bot], dim=1) if bot is not None else top


@functools.lru_cache(maxsize=None)
def _edge_consts_np(geom: CompactGeometry):
    """sel (n_edge, REL_LANES, R_u): lane a < win scatters to keys with
    kh == a, lane win+b to kw == b; zero at dummy columns and at the
    LPAD_LANE row. kmask (n_edge, R_u): 0 at real keys, -1e30 at dummies."""
    win, R = geom.win, geom.R_u
    sels, kmasks = [], []
    for g in geom.edge_groups:
        n = g.rows
        kh = np.arange(n) // g.nc
        kw = np.arange(n) % g.nc
        sel = np.zeros((REL_LANES, R), np.float32)
        for a in range(g.nr):
            sel[a, np.flatnonzero(kh == a)] = 1.0
        for b in range(g.nc):
            sel[win + b, np.flatnonzero(kw == b)] = 1.0
        km = np.full((R,), NEG, np.float32)
        km[:n] = 0.0
        sels += [sel] * g.n
        kmasks += [km] * g.n
    return np.stack(sels), np.stack(kmasks)


@functools.lru_cache(maxsize=None)
def edge_consts(geom: CompactGeometry, dtype: torch.dtype, device="cpu"):
    """(sel (n_edge, 32, R_u) in `dtype`, kmask (n_edge, 1, R_u) fp32) on
    `device`, built once per geometry, type and device."""
    sel, km = _edge_consts_np(geom)
    return device_constant(sel, device, dtype), device_constant(km[:, None, :], device)


def edge_rel_lpad(
    q_edge: torch.Tensor,   # (B, E, heads, hd) UNSCALED queries
    rcomb: torch.Tensor,    # (win, win, hd, REL_LANES) combined rel table
    k_bias: torch.Tensor,   # (heads, hd) k slice of the qkv bias
    scale: float,
    geom: CompactGeometry,
) -> torch.Tensor:
    """Packed rel factors of the edge windows with the virtual-pad-key logit
    in lane LPAD_LANE -> (B, E, heads, REL_LANES), in q's type. The
    logsumexps run in fp32 on the rounded rel values; dummy rows are zero."""
    B, E, heads, hd = q_edge.shape
    win, R = geom.win, geom.R_u
    kb = k_bias.to(q_edge.dtype)
    q4 = q_edge.reshape(B, geom.n_edge, R, heads, hd)
    out = []
    off = 0
    for g in geom.edge_groups:
        qp = q4[:, off : off + g.n, : g.rows].reshape(B, g.n, g.nr, g.nc, heads, hd)
        off += g.n
        rel = torch.einsum("bnhwxc,hwcj->bnhwxj", qp,
                           rcomb[: g.nr, : g.nc, :, :LPAD_LANE].to(q_edge.dtype))
        qkb = torch.einsum("bnhwxc,xc->bnhwx", qp, kb).float() * scale
        relf = rel.float()
        lp = None
        for (hlo, hhi, wlo, whi) in g.terms:
            t = (qkb + torch.logsumexp(relf[..., hlo:hhi], -1)
                 + torch.logsumexp(relf[..., win + wlo : win + whi], -1))
            lp = t if lp is None else torch.logaddexp(lp, t)
        rel = torch.cat([
            rel, lp[..., None].to(rel.dtype),
            rel.new_zeros(rel.shape[:-1] + (REL_LANES - LPAD_LANE - 1,)),
        ], dim=-1).reshape(B, g.n, g.rows, heads, REL_LANES)
        if g.rows != R:
            rel = F.pad(rel, (0, 0, 0, 0, 0, R - g.rows))
        out.append(rel)
    return torch.cat(out, dim=1).reshape(B, E, heads, REL_LANES)


def edge_attention_literal(
    qkv_edge: torch.Tensor,   # (B, E, 3*heads*hd) packed qkv, uniform layout
    qkv_bias: torch.Tensor,   # (3*heads*hd,) qkv projection bias
    rel_pos_h: torch.Tensor,  # (2*win-1, hd)
    rel_pos_w: torch.Tensor,
    scale: float,
    heads: int,
    geom: CompactGeometry,
) -> torch.Tensor:
    """Test oracle: rebuild each padded edge window literally (pad k/v rows
    = the qkv bias), run dense rel-pos attention over all win^2 keys, and
    return the real query rows, dummy rows zero -> (B, heads, E, hd)."""
    from .rel_pos import attention_with_decomposed_rel_pos

    B, E, C3 = qkv_edge.shape
    win, R = geom.win, geom.R_u
    hd = C3 // (3 * heads)
    bias_row = qkv_bias.to(qkv_edge.dtype)
    q4 = qkv_edge.reshape(B, geom.n_edge, R, C3)
    outs = []
    off = 0
    for g in geom.edge_groups:
        full = bias_row.expand(B, g.n, win, win, C3).clone()
        full[:, :, : g.nr, : g.nc] = q4[:, off : off + g.n, : g.rows].reshape(
            B, g.n, g.nr, g.nc, C3)
        off += g.n
        full = full.reshape(B, g.n, win * win, 3, heads, hd)
        q, k, v = (full[..., i, :, :].transpose(2, 3) for i in range(3))
        o = attention_with_decomposed_rel_pos(q, k, v, rel_pos_h, rel_pos_w, (win, win), scale)
        o = o.reshape(B, g.n, heads, win, win, hd)[:, :, :, : g.nr, : g.nc]
        o = o.reshape(B, g.n, heads, g.rows, hd)
        if g.rows != R:
            o = F.pad(o, (0, 0, 0, R - g.rows))
        outs.append(o.transpose(1, 2))  # (B, heads, n, R, hd)
    return torch.cat(outs, dim=2).reshape(B, heads, E, hd)
