"""Fused linear layers: the Hopper kernels and their plain versions.

Counterparts of `camouflaged_vlm_tpu/ops/linear.py`. Each public function
runs its CUDA kernel (`csrc/`) for CUDA tensors and its plain PyTorch
version for CPU tensors; on CUDA it launches the kernel or raises, never
falls back. When a gradient is wanted, `linear_act`, `ln_linear_act_bt`,
`ln_mask_linear_bt`, `proj_rows` and `proj_from_heads(_res)` take the VJP of
their plain version
(`ops/autograd.py`), as their JAX counterparts take `pallas_with_xla_vjp`;
`ln_mlp_residual_bt` has a hand-written backward, the LN row pass and
three TMA + wgmma passes on the card (`csrc/ln_mlp_residual_bwd.cu`) and
`ln_mlp_residual_bt_bwd_ref` on the CPU. The plain versions transcribe the
JAX `ref` formulations: LN statistics in fp32, LN output cast to the working type before the product,
fp32 accumulation, bias and activation in fp32 on the accumulator, one
rounding at the end. Those of the LN-fused functions are written as the
card's stages: the LN row pass (`ln_rows_ref`), then the GEMM with its
epilogue (`linear_act_ref`; `linear_residual_ref` for the MLP's fc2).

`linear_act`, `ln_linear_act_bt`, `ln_mask_linear_bt`,
`ln_mlp_residual_bt` and `proj_rows` run on one persistent TMA + wgmma GEMM
(`csrc/gemm_sm90.cuh`) with 128 x `gemm_tile_n` tiles; the LN-fused ones
first write the bf16 LN rows to a scratch buffer (and the MLP its bf16
hidden), allocated here; `proj_rows` reads the attention kernels' d-major
output as it lies, rows of a stride rounded up to 8 elements
(`dmajor_empty`).

Layouts: activations as in the JAX package ((M, K) rows, (B, S, K)
sequences, the d-major (B, T, K, S) and head-leading (B, heads, T, S, d)
attention outputs); weights in the
`nn.Linear` layout (out, in), biases (out,), LN scale/shift (K,) fp32.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda, autograd


def apply_act(acc: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation == "gelu_tanh":
        return F.gelu(acc, approximate="tanh")
    if activation == "gelu":
        return F.gelu(acc)
    if activation == "quick_gelu":
        return acc * torch.sigmoid(1.702 * acc)
    if activation is None:
        return acc
    raise ValueError(f"unknown activation {activation!r}")


def _ln_fp32(x: torch.Tensor, gamma, beta, eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    xn = (x32 - mu) * torch.rsqrt(var + eps)
    return xn * gamma.float() + beta.float()


def _matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) . w (N, K)^T with fp32 accumulation of the given values."""
    return torch.matmul(a.float(), w.float().t())


# ------------------------------------------------------ the GEMM's geometry

GEMM_BM = 128  # rows of a tile (csrc/gemm_sm90.cuh GemmTile::BM)
# A round of 256-wide tiles' time relative to two rounds of 128-wide ones
# (csrc/gemm_sm90.cuh GemmTile), without and with an activation in the
# epilogue: 256-wide tiles pay where they cut rounds, but not with an
# activation. With these costs the pick is the faster width at every
# main-path shape at batch 2 in the forced-width times of
# `cli/kernel_timing.py` on the H100 (PERF.md, PR 8).
GEMM_TILE_COST = {128: 1.0, 256: 0.85}
GEMM_TILE_COST_ACT = {128: 1.0, 256: 1.0}
# proj_rows over groups whose rows end in a partial row tile: its A boxes,
# partly past the group's rows, are loaded once per n-block, twice as often
# in 128-wide tiles. In the forced-width times of `cli/kernel_timing.py` on
# the H100 a 256-wide round took 1.5x a 128-wide one at SAM's windows (32
# groups of 196 rows), 1.8x at its global blocks (2 of 4096) (PERF.md, PR 9).
GEMM_TILE_COST_RAGGED = {128: 1.0, 256: 0.75}


@functools.lru_cache(maxsize=None)
def gemm_tile_n(M: int, N: int, n_sm: int, act: bool = False, groups: int = 1) -> int:
    """The GEMM's tile width (128 or 256) for `groups` groups of M rows
    (a row tile holds rows of one group: proj_rows' (B, T) groups): the one
    whose rounds of tiles over the card's `n_sm` SMs (one persistent block
    each) take the least time, a round costing its tile width times
    GEMM_TILE_COST (GEMM_TILE_COST_ACT with an activation,
    GEMM_TILE_COST_RAGGED for groups that end in a partial row tile), so
    that the last round is not mostly empty; 128 on a tie."""
    if act:
        table = GEMM_TILE_COST_ACT
    else:
        table = GEMM_TILE_COST_RAGGED if groups > 1 and M % GEMM_BM else GEMM_TILE_COST

    def cost(bn: int) -> float:
        tiles = groups * -(-M // GEMM_BM) * -(-N // bn)
        return -(-tiles // n_sm) * bn * table[bn]

    return min((128, 256), key=cost)


# hidden elements of the fused MLP's scratch per row panel (64 MB of bf16)
MLP_SCRATCH_ELEMS = 32 * 2 ** 20


def mlp_panel_rows(M: int, H: int) -> int:
    """Rows per panel of the fused MLP on the card: all M while the bf16
    hidden (M, H) fits MLP_SCRATCH_ELEMS, else M split into panels of equal
    size, rounded up to the GEMM's 128-row tiles, each of which fits (the
    largest multiple of 128 rows that fits caps them; at least 128 rows)."""
    if M * H <= MLP_SCRATCH_ELEMS:
        return M
    cap = max(GEMM_BM, MLP_SCRATCH_ELEMS // H // GEMM_BM * GEMM_BM)
    rows = -(-M // -(-M // cap))
    return min(M, -(-rows // GEMM_BM) * GEMM_BM)


def _check_tma_k(name: str, *widths: int) -> None:
    for k in widths:
        if k % 8:  # TMA row strides are multiples of 16 bytes
            raise ValueError(f"{name}: CUDA kernel takes K % 8 == 0, got K = {k}")


# ------------------------------------------------------------ linear_act


def linear_act_ref(x, w, b, activation=None):
    acc = _matmul_f32(x, w) + b.float()
    return apply_act(acc, activation).to(x.dtype)


def linear_act(
    x: torch.Tensor,  # (M, K)
    w: torch.Tensor,  # (N, K)
    b: torch.Tensor,  # (N,)
    activation: Optional[str] = None,
) -> torch.Tensor:
    """act(x . w^T + b). Counterpart of `linear_pallas` (TPU kernel #1)."""
    return autograd.run("linear_act", _linear_act_cuda, linear_act_ref, (x, w, b),
                        (activation,))


def _linear_act_cuda(x, w, b, activation):
    _cuda.check_dtype("linear_act", torch.bfloat16, x, w, b)
    M, K = x.shape
    N = w.shape[0]
    if w.shape != (N, K) or b.shape != (N,):
        raise ValueError(f"linear_act: shapes x {x.shape} w {w.shape} b {b.shape}")
    _check_tma_k("linear_act", K)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _cuda.LINEAR_ACT(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
                     _cuda.ACTIVATIONS[activation],
                     gemm_tile_n(M, N, _cuda.sm_count(x.device), activation is not None))
    return out


def linear_residual_ref(x, w, b, res):
    """x . w^T + b + res, fp32 on the accumulator, one rounding: the fused
    MLP's fc2 stage."""
    return (_matmul_f32(x, w) + b.float() + res.float()).to(x.dtype)


# ----------------------------------------------------------------- ln_rows


def ln_rows_ref(x, gamma, beta, eps, mask=None):
    """The LN row pass of #2, #3 and #4/#5: LN(x) in fp32 (two-pass
    statistics), times the row mask if given ((nwin, S, 1) for x (B', S, K);
    row b' reads mask[b' % nwin]), rounded to x's type: the TPU kernels'
    first rounding point."""
    y = _ln_fp32(x, gamma, beta, eps)
    if mask is not None:
        Bp, S, _ = x.shape
        nwin = mask.shape[0]
        y = y * mask.float()[None].expand(Bp // nwin, nwin, S, 1).reshape(Bp, S, 1)
    return y.to(x.dtype)


# ------------------------------------------------------- ln_linear_act_bt


def ln_linear_act_bt_ref(x, gamma, beta, w, b, eps=1e-5, activation="quick_gelu"):
    return linear_act_ref(ln_rows_ref(x, gamma, beta, eps), w, b, activation)


def ln_linear_act_bt(
    x: torch.Tensor,      # (B, S, K)
    gamma: torch.Tensor,  # (K,)
    beta: torch.Tensor,   # (K,)
    w: torch.Tensor,      # (N, K)
    b: torch.Tensor,      # (N,)
    eps: float = 1e-5,
    activation: Optional[str] = "quick_gelu",
) -> torch.Tensor:
    """act(LN(x) . w^T + b). Counterpart of `ln_linear_act_bt` (TPU kernel #2)."""
    return autograd.run("ln_linear_act_bt", _ln_linear_act_bt_cuda, ln_linear_act_bt_ref,
                        (x, gamma, beta, w, b), (eps, activation))


def _ln_linear_act_bt_cuda(x, gamma, beta, w, b, eps, activation):
    _cuda.check_dtype("ln_linear_act_bt", torch.bfloat16, x, w, b)
    _cuda.check_dtype("ln_linear_act_bt", torch.float32, gamma, beta)
    B, S, K = x.shape
    N = w.shape[0]
    if w.shape != (N, K) or b.shape != (N,) or gamma.shape != (K,) or beta.shape != (K,):
        raise ValueError(f"ln_linear_act_bt: shapes x {x.shape} w {w.shape}")
    _check_tma_k("ln_linear_act_bt", K)
    M = B * S
    out = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    xn = torch.empty((M, K), dtype=x.dtype, device=x.device)  # the LN rows' scratch
    _cuda.LN_LINEAR(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), xn.data_ptr(), M, K, N, float(eps), _cuda.ACTIVATIONS[activation],
        gemm_tile_n(M, N, _cuda.sm_count(x.device), activation is not None),
    )
    return out


# ------------------------------------------------------ ln_mask_linear_bt


def ln_mask_linear_bt_ref(x, gamma, beta, mask, w, b, eps=1e-6):
    return linear_act_ref(ln_rows_ref(x, gamma, beta, eps, mask), w, b)


def ln_mask_linear_bt(
    x: torch.Tensor,      # (B', S, K), B' = B * nwin
    gamma: torch.Tensor,  # (K,)
    beta: torch.Tensor,   # (K,)
    mask: torch.Tensor,   # (nwin, S, 1) row mask in x's type; row b' reads mask[b' % nwin]
    w: torch.Tensor,      # (N, K)
    b: torch.Tensor,      # (N,)
    eps: float = 1e-6,
) -> torch.Tensor:
    """(LN(x) * mask) . w^T + b: LN1, the pad-row re-zeroing and the qkv
    projection in one kernel. Counterpart of `ln_mask_linear_bt` (TPU
    kernel #3)."""
    return autograd.run("ln_mask_linear_bt", _ln_mask_linear_bt_cuda, ln_mask_linear_bt_ref,
                        (x, gamma, beta, mask, w, b), (eps,))


def _ln_mask_linear_bt_cuda(x, gamma, beta, mask, w, b, eps):
    _cuda.check_dtype("ln_mask_linear_bt", torch.bfloat16, x, mask, w, b)
    _cuda.check_dtype("ln_mask_linear_bt", torch.float32, gamma, beta)
    Bp, S, K = x.shape
    N, nwin = w.shape[0], mask.shape[0]
    if (w.shape != (N, K) or b.shape != (N,) or gamma.shape != (K,) or beta.shape != (K,)
            or mask.shape != (nwin, S, 1) or Bp % nwin):
        raise ValueError(f"ln_mask_linear_bt: shapes x {x.shape} mask {mask.shape} w {w.shape}")
    _check_tma_k("ln_mask_linear_bt", K)
    M = Bp * S
    out = torch.empty((Bp, S, N), dtype=x.dtype, device=x.device)
    xn = torch.empty((M, K), dtype=x.dtype, device=x.device)  # the LN rows' scratch
    _cuda.LN_MASK_LINEAR(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mask.data_ptr(), w.data_ptr(),
        b.data_ptr(), out.data_ptr(), xn.data_ptr(), M, K, N, S, nwin, float(eps),
        gemm_tile_n(M, N, _cuda.sm_count(x.device)),
    )
    return out


# ----------------------------------------------------- ln_mlp_residual_bt


def ln_mlp_residual_bt_ref(x, gamma, beta, w1, b1, w2, b2, eps=1e-6,
                             activation="gelu_tanh"):
    """The card's three stages: the LN row pass, fc1 with bias and
    activation (h rounded to x's type, the TPU kernel's second rounding
    point), fc2 with bias and the residual x in fp32, rounded once."""
    h = linear_act_ref(ln_rows_ref(x, gamma, beta, eps), w1, b1, activation)
    return linear_residual_ref(h, w2, b2, x)


def act_and_grad(pre: torch.Tensor, activation: Optional[str]):
    """(act(pre), act'(pre)) in fp32, the closed forms of the derivatives
    JAX's autodiff takes of `_apply_act`."""
    v = pre.float()
    if activation == "gelu_tanh":
        c = math.sqrt(2.0 / math.pi)
        t = torch.tanh(c * (v + 0.044715 * v ** 3))
        return (0.5 * v * (1.0 + t),
                0.5 * (1.0 + t) + 0.5 * v * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * v * v))
    if activation == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(v / math.sqrt(2.0)))
        return v * cdf, cdf + v * torch.exp(-0.5 * v * v) / math.sqrt(2.0 * math.pi)
    if activation == "quick_gelu":
        sg = torch.sigmoid(1.702 * v)
        return v * sg, sg + 1.702 * v * sg * (1.0 - sg)
    if activation is None:
        return v, torch.ones_like(v)
    raise ValueError(f"unknown activation {activation!r}")


def ln_mlp_residual_bt_bwd_ref(x, gamma, beta, w1, b1, w2, b2, g, eps=1e-6,
                               activation="gelu_tanh", weights=True):
    """The backward of `ln_mlp_residual_bt` at upstream gradient g (like x):
    (dx, dgamma, dbeta, dw1, db1, dw2, db2), the weight side None unless
    `weights`. Transcribes the JAX backward kernel (`ops/linear.py`,
    `_ln_mlp_residual_bwd_kernel`) and its wrapper's weight products:
    LN and pre1 = xn.W1^T + b1 recomputed, dh = act'(pre1) * (g.W2),
    dxn = dh.W1 with g and dh rounded to the working type before their
    products, the LN backward in fp32, plus the residual g."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mu) * rstd
    xnb = (xhat * gamma.float() + beta.float()).to(dt)
    hact, dact = act_and_grad(_matmul_f32(xnb, w1) + b1.float(), activation)
    dh = dact * _matmul_f32(g.to(dt), w2.t())           # (.., H) = act' * (g . W2)
    dxn = _matmul_f32(dh.to(dt), w1.t())                # (.., K) = dh . W1
    dxhat = dxn * gamma.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2) + g.float()).to(dt)
    if not weights:
        return dx, None, None, None, None, None, None
    K, H = x.shape[-1], w1.shape[0]
    dh2, g2 = dh.to(dt).reshape(-1, H), g.to(dt).reshape(-1, K)
    dw1 = torch.matmul(dh2.float().t(), xnb.reshape(-1, K).float()).to(w1.dtype)
    dw2 = torch.matmul(g2.float().t(), hact.to(dt).reshape(-1, H).float()).to(w2.dtype)
    sum_rows = lambda a: a.reshape(-1, a.shape[-1]).sum(0)  # noqa: E731
    return (dx, sum_rows(dxn * xhat).to(gamma.dtype), sum_rows(dxn).to(beta.dtype), dw1,
            sum_rows(dh).to(b1.dtype), dw2, sum_rows(g.float()).to(b2.dtype))


def _check_mlp_shapes(name, x, gamma, beta, w1, b1, w2, b2, dtype=torch.bfloat16):
    _cuda.check_dtype(name, dtype, x, w1, b1, w2, b2)
    _cuda.check_dtype(name, torch.float32, gamma, beta)
    K, H = x.shape[-1], w1.shape[0]
    if (w1.shape != (H, K) or w2.shape != (K, H) or b1.shape != (H,)
            or b2.shape != (K,) or gamma.shape != (K,) or beta.shape != (K,)):
        raise ValueError(f"{name}: shapes x {x.shape} w1 {w1.shape} w2 {w2.shape}")
    return K, H


def f32_tile(M: int, N: int, n_sm: int) -> int:
    """The fp32 instance's GEMM tile (csrc/ln_mlp_residual_f32.cu): 128 x 128,
    or 64 x 64 where the 128-wide tiles would not give every SM one."""
    return 128 if -(-M // 128) * -(-N // 128) >= n_sm else 64


def _ln_mlp_residual_f32_cuda(x, gamma, beta, w1, b1, w2, b2, eps, activation):
    """The fp32 instance (the CLIP text tower of the bank precompute): the
    LN rows and the hidden in fp32 scratch, products on the CUDA cores in
    full fp32, per row panel of `mlp_panel_rows`."""
    name = "ln_mlp_residual_bt (float32)"
    K, H = _check_mlp_shapes(name, x, gamma, beta, w1, b1, w2, b2, torch.float32)
    if K % 4 or H % 4:  # 16-byte rows
        raise ValueError(f"{name}: CUDA kernel takes K % 4 == 0 and H % 4 == 0, got {K}, {H}")
    M = x.numel() // K
    rows = mlp_panel_rows(M, H)
    n_sm = _cuda.sm_count(x.device)
    out = torch.empty_like(x)
    scratch = torch.empty(rows * (K + H), dtype=x.dtype, device=x.device)
    xn = scratch.data_ptr()
    _cuda.LN_MLP_RESIDUAL_F32(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), xn, xn + 4 * rows * K, M, K, H, rows,
        float(eps), _cuda.ACTIVATIONS[activation], f32_tile(rows, H, n_sm),
        f32_tile(rows, K, n_sm),
    )
    return out


def _ln_mlp_residual_bt_cuda(x, gamma, beta, w1, b1, w2, b2, eps, activation):
    if x.dtype == torch.float32:
        return _ln_mlp_residual_f32_cuda(x, gamma, beta, w1, b1, w2, b2, eps, activation)
    name = "ln_mlp_residual_bt"
    K, H = _check_mlp_shapes(name, x, gamma, beta, w1, b1, w2, b2)
    _check_tma_k(name, K, H)
    M = x.numel() // K
    rows = mlp_panel_rows(M, H)
    n_sm = _cuda.sm_count(x.device)
    # one scratch for the LN rows (rows, K) and the hidden (rows, H): each
    # 16-byte aligned, as TMA needs (K % 8 == 0)
    out = torch.empty_like(x)
    scratch = torch.empty(rows * (K + H), dtype=x.dtype, device=x.device)
    xn = scratch.data_ptr()
    _cuda.LN_MLP_RESIDUAL(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), xn, xn + 2 * rows * K, M, K, H,
        rows, float(eps), _cuda.ACTIVATIONS[activation],
        gemm_tile_n(rows, H, n_sm, activation is not None), gemm_tile_n(rows, K, n_sm),
    )
    return out


# Rows per partial sum of the backward's weight side (csrc/ln_mlp_residual_bwd.cu):
# dgamma/dbeta per block of the LN-backward row pass, db1 per consumer
# warpgroup of the dual GEMM (half a 128-row tile).
MLP_BWD_LN_ROWS = 32
MLP_BWD_DB1_ROWS = 64


def ln_mlp_residual_bt_bwd(x, gamma, beta, w1, b1, w2, b2, g, eps=1e-6,
                           activation="gelu_tanh", weights=True):
    """The backward of `ln_mlp_residual_bt`: the kernel for CUDA tensors
    (TPU kernel #6: per row panel of `mlp_panel_rows`, the LN row pass, the
    dual GEMM for dh, dxn = dh . W1 and the LN-backward rows, one count),
    `ln_mlp_residual_bt_bwd_ref` for CPU tensors. With `weights` the kernel
    also keeps xn and dh for every row, writes act(pre1) and the
    dgamma/dbeta/db1 partials, and dw1 = dh^T.xn, dw2 = g^T.act(pre1) are
    `torch.matmul` products (the JAX wrapper leaves them to XLA)."""
    name = "ln_mlp_residual_bt_bwd"
    if not _cuda.use_kernel(name, x, gamma, beta, w1, b1, w2, b2, g):
        return ln_mlp_residual_bt_bwd_ref(x, gamma, beta, w1, b1, w2, b2, g, eps, activation,
                                          weights)
    K, H = _check_mlp_shapes(name, x, gamma, beta, w1, b1, w2, b2)
    _check_tma_k(name, K, H)
    _cuda.check_dtype(name, torch.bfloat16, g)
    if g.shape != x.shape:
        raise ValueError(f"{name}: gradient {g.shape} vs x {x.shape}")
    M = x.numel() // K
    rows = mlp_panel_rows(M, H)
    # xn and dh hold every row when the weight products read them, else one
    # panel's; the rows' (mean, rstd) and dxn one panel's
    R = M if weights else rows

    def e(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=x.device)

    xn, dh, stats, dxn = e(R, K, dt=x.dtype), e(R, H, dt=x.dtype), e(rows, 2), e(rows, K)
    dx = torch.empty_like(x)
    side = [None] * 4
    if weights:
        # db1's partials: per warpgroup of each 128-row tile, the last one's second
        # holding zeros when no row reaches it
        side = [e(M, H, dt=x.dtype), e(-(-M // MLP_BWD_LN_ROWS), K),
                e(-(-M // MLP_BWD_LN_ROWS), K),
                e(-(-M // GEMM_BM) * (GEMM_BM // MLP_BWD_DB1_ROWS), H)]
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    _cuda.LN_MLP_RESIDUAL_BWD(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), g.data_ptr(), dx.data_ptr(), xn.data_ptr(), dh.data_ptr(), stats.data_ptr(),
        dxn.data_ptr(),
        *map(ptr, side), M, K, H, rows, float(eps), _cuda.ACTIVATIONS[activation],
        gemm_tile_n(rows, K, _cuda.sm_count(x.device)),
    )
    if not weights:
        return dx, None, None, None, None, None, None
    hact, dga, dbe, db1 = side
    g2 = g.reshape(M, K)
    return (dx, dga.sum(0).to(gamma.dtype), dbe.sum(0).to(beta.dtype),
            torch.matmul(dh.t(), xn).to(w1.dtype), db1.sum(0).to(b1.dtype),
            torch.matmul(g2.t(), hact).to(w2.dtype), g2.float().sum(0).to(b2.dtype))


class LnMlpResidual(torch.autograd.Function):
    """`ln_mlp_residual_bt` with its hand-written backward; keeps only its
    inputs, as the JAX custom_vjp does."""

    @staticmethod
    def forward(ctx, fwd, x, gamma, beta, w1, b1, w2, b2, eps, activation):
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2)
        ctx.eps, ctx.activation = eps, activation
        return fwd(x, gamma, beta, w1, b1, w2, b2, eps, activation)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, w1, b1, w2, b2 = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:8]
        # the kernel reads g as rows: a non-contiguous gradient is copied here
        grads = ln_mlp_residual_bt_bwd(x, gamma, beta, w1, b1, w2, b2, g.contiguous(),
                                       ctx.eps, ctx.activation, weights=any(needs[1:]))
        return (None, *(d if n else None for d, n in zip(grads, needs)), None, None)


def ln_mlp_residual_bt(
    x: torch.Tensor,      # (B', S, K) — also the residual
    gamma: torch.Tensor,  # (K,)
    beta: torch.Tensor,   # (K,)
    w1: torch.Tensor,     # (H, K)
    b1: torch.Tensor,     # (H,)
    w2: torch.Tensor,     # (K, H)
    b2: torch.Tensor,     # (K,)
    eps: float = 1e-6,
    activation: str = "gelu_tanh",
) -> torch.Tensor:
    """x + act(LN(x) . w1^T + b1) . w2^T + b2: on the card the LN row pass,
    fc1 and fc2 with the residual, one entry point, the hidden in a scratch
    of at most MLP_SCRATCH_ELEMS elements (row panels beyond). Counterpart of
    `ln_mlp_residual_bt` (TPU kernels #4 and #5; `hidden_grid` is a TPU
    tiling knob and has no counterpart), with the backward of #6 when a
    gradient is wanted. x in bfloat16 runs the TMA + wgmma kernel, x in
    float32 its fp32 instance (`_ln_mlp_residual_f32_cuda`), which has no
    backward on the card yet."""
    tensors = (x, gamma, beta, w1, b1, w2, b2)
    fwd = autograd.forward_fn("ln_mlp_residual_bt", _ln_mlp_residual_bt_cuda,
                              ln_mlp_residual_bt_ref, tensors)
    if autograd.wants_grad(*tensors):
        if fwd is _ln_mlp_residual_bt_cuda and x.dtype == torch.float32:
            raise NotImplementedError(
                "ln_mlp_residual_bt: no float32 backward on the card (#6 takes bfloat16); "
                "it comes with MaPLe training, ROADMAP.md Queue 1 item 5")
        return LnMlpResidual.apply(fwd, *tensors, eps, activation)
    return fwd(*tensors, eps, activation)


# --------------------------------------------------------------- proj_rows


# TMA strides are multiples of 16 bytes: the d-major rows' stride in bf16
DMAJOR_ALIGN = 8


def dmajor_empty(*shape: int, dtype: torch.dtype, device) -> torch.Tensor:
    """An uninitialised d-major (..., K, S) tensor as `proj_rows` reads it
    on the card: the view [..., :S] of (..., K, S8), S8 = S rounded up to a
    multiple of DMAJOR_ALIGN. The attention kernels write their output into
    it; no kernel reads the pad columns."""
    *lead, S = shape
    s8 = -(-S // DMAJOR_ALIGN) * DMAJOR_ALIGN
    return torch.empty(*lead, s8, dtype=dtype, device=device)[..., :S]


def proj_rows_ref(x, w, b, res=None):
    acc = _matmul_f32(x.transpose(-1, -2), w) + b.float()
    if res is not None:
        acc = acc + res.float()
    return acc.to(x.dtype)


def proj_rows(
    x: torch.Tensor,                      # (B, T, K, S) — d-major attention output
    w: torch.Tensor,                      # (N, K)
    b: torch.Tensor,                      # (N,)
    res: Optional[torch.Tensor] = None,   # (B, T, S, N)
) -> torch.Tensor:
    """out[b, t, s, :] = x[b, t, :, s] . w^T + b (+ res) -> (B, T, S, N).
    Counterpart of `proj_rows` (TPU kernel #7). On the card x is read as it
    lies by TMA: its last stride 1, its row and (B, T) group strides
    multiples of DMAJOR_ALIGN (the attention wrappers' `dmajor_empty`
    output); anything else raises."""
    return autograd.run("proj_rows", _proj_rows_cuda, proj_rows_ref, (x, w, b, res), strided=1)


def _group_stride(x: torch.Tensor) -> Optional[int]:
    """The stride of x's (B, T) groups flattened into one, None if they do
    not flatten."""
    B, T = x.shape[:2]
    if T == 1:
        return x.stride(0)
    if B == 1 or x.stride(0) == T * x.stride(1):
        return x.stride(1)
    return None


def _proj_rows_cuda(x, w, b, res):
    _cuda.check_dtype("proj_rows", torch.bfloat16, x, w, b, *([res] if res is not None else []))
    B, T, K, S = x.shape
    N = w.shape[0]
    if w.shape != (N, K) or b.shape != (N,) or (res is not None and res.shape != (B, T, S, N)):
        raise ValueError(f"proj_rows: shapes x {x.shape} w {w.shape}")
    ldk, ldg = x.stride(2), _group_stride(x)
    if x.stride(3) != 1 or ldk % DMAJOR_ALIGN or ldg is None or ldg % DMAJOR_ALIGN:
        raise ValueError(f"proj_rows: CUDA kernel reads x by TMA: last stride 1, row and group "
                         f"strides multiples of {DMAJOR_ALIGN}, got strides {x.stride()}")
    _check_tma_k("proj_rows", K)
    if res is not None and N % 8:
        raise ValueError(f"proj_rows: CUDA kernel takes N % 8 == 0 with the residual, got {N}")
    out = torch.empty((B, T, S, N), dtype=x.dtype, device=x.device)
    _cuda.PROJ_ROWS(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        res.data_ptr() if res is not None else None, out.data_ptr(),
        B * T, S, ldk, ldg, K, N, gemm_tile_n(S, N, _cuda.sm_count(x.device), False, B * T),
    )
    return out


# ---------------------------------------------------------- proj_from_heads


def proj_from_heads_ref(x, w, b, res=None):
    B, heads, T, S, d = x.shape
    rows = x.permute(0, 2, 3, 1, 4).reshape(B, T, S, heads * d)  # k = h*d + j
    return proj_rows_ref(rows.transpose(-1, -2), w, b, res)


def proj_from_heads_res(
    x: torch.Tensor,    # (B, heads, T, S, d) — head-leading attention output
    w: torch.Tensor,    # (N, heads*d)
    b: torch.Tensor,    # (N,)
    res: torch.Tensor,  # (B, T, S, N) — the block's residual
) -> torch.Tensor:
    """out[b, t, s, :] = sum_h x[b, h, t, s, :] . w[:, h*d:(h+1)*d]^T + b + res
    -> (B, T, S, N). Counterpart of `proj_from_heads_res` (TPU kernel #8).
    The kernel (`csrc/proj_rows.cu`) is the persistent GEMM with x as a
    K-major A split by head; it takes d % 8 == 0 and N % 8 == 0 (the
    residual's epilogue), else a CUDA tensor raises ValueError."""
    return autograd.run("proj_from_heads_res", _proj_heads_res_cuda, proj_from_heads_ref,
                        (x, w, b, res))


def proj_from_heads(
    x: torch.Tensor,  # (B, heads, T, S, d)
    w: torch.Tensor,  # (N, heads*d)
    b: torch.Tensor,  # (N,)
) -> torch.Tensor:
    """`proj_from_heads_res` without the residual. Counterpart of
    `proj_from_heads` (TPU kernel #9), which no path of either package
    calls; the kernel is #8's, with its own launch count."""
    return autograd.run("proj_from_heads", _proj_heads_cuda, proj_from_heads_ref, (x, w, b))


def _proj_heads_launch(kernel, x, w, b, res):
    _cuda.check_dtype(kernel.name, torch.bfloat16, x, w, b, *([res] if res is not None else []))
    B, heads, T, S, d = x.shape
    N = w.shape[0]
    if (w.shape != (N, heads * d) or b.shape != (N,) or d % 8
            or (res is not None and res.shape != (B, T, S, N))):
        raise ValueError(f"{kernel.name}: shapes x {x.shape} w {w.shape} (d a multiple of 8)")
    if res is not None and N % 8:
        raise ValueError(f"{kernel.name}: CUDA kernel takes N % 8 == 0 with the residual, "
                         f"got {N}")
    out = torch.empty((B, T, S, N), dtype=x.dtype, device=x.device)
    kernel(x.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr() if res is not None else None,
           out.data_ptr(), B, heads, T, S, d, N,
           gemm_tile_n(T * S, N, _cuda.sm_count(x.device), False, B))
    return out


def _proj_heads_res_cuda(x, w, b, res):
    return _proj_heads_launch(_cuda.PROJ_HEADS_RES, x, w, b, res)


def _proj_heads_cuda(x, w, b):
    return _proj_heads_launch(_cuda.PROJ_HEADS, x, w, b, None)
