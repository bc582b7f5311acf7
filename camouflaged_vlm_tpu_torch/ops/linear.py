"""Fused linear layers: the Hopper kernels and their plain versions.

Counterparts of `camouflaged_vlm_tpu/ops/linear.py`. Each public function
runs its CUDA kernel (`csrc/`) for CUDA tensors and its plain PyTorch
version for CPU tensors; on CUDA it launches the kernel or raises, never
falls back. When a gradient is wanted, `linear_act`, `ln_linear_act_bt`,
`ln_mask_linear_bt` and `proj_rows` take the VJP of their plain version
(`ops/autograd.py`), as their JAX counterparts take `pallas_with_xla_vjp`;
`ln_mlp_residual_bt` has a hand-written backward, a kernel on the card
(`csrc/ln_mlp_residual_bwd.cu`) and `ln_mlp_residual_bt_bwd_ref` on the
CPU. The plain versions transcribe the JAX `ref` formulations: LN
statistics in fp32, LN output cast to the working type before the product,
fp32 accumulation, bias and activation in fp32 on the accumulator, one
rounding at the end.

Layouts: activations as in the JAX package ((M, K) rows, (B, S, K)
sequences, the d-major (B, T, K, S) attention output); weights in the
`nn.Linear` layout (out, in), biases (out,), LN scale/shift (K,) fp32.
"""

from __future__ import annotations

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
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _cuda.LINEAR_ACT(
        x.data_ptr(), None, None, w.data_ptr(), b.data_ptr(), out.data_ptr(),
        M, K, N, 0.0, _cuda.ACTIVATIONS[activation], 0,
    )
    return out


# ------------------------------------------------------- ln_linear_act_bt


def ln_linear_act_bt_ref(x, gamma, beta, w, b, eps=1e-5, activation="quick_gelu"):
    xn = _ln_fp32(x, gamma, beta, eps).to(x.dtype)
    acc = _matmul_f32(xn, w) + b.float()
    return apply_act(acc, activation).to(x.dtype)


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
    out = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    _cuda.LN_LINEAR(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), B * S, K, N, float(eps), _cuda.ACTIVATIONS[activation], 1,
    )
    return out


# ------------------------------------------------------ ln_mask_linear_bt


def ln_mask_linear_bt_ref(x, gamma, beta, mask, w, b, eps=1e-6):
    Bp, S, _ = x.shape
    nwin = mask.shape[0]
    m = mask.float()[None].expand(Bp // nwin, nwin, S, 1).reshape(Bp, S, 1)
    xn = (_ln_fp32(x, gamma, beta, eps) * m).to(x.dtype)
    return (_matmul_f32(xn, w) + b.float()).to(x.dtype)


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
    out = torch.empty((Bp, S, N), dtype=x.dtype, device=x.device)
    _cuda.LN_MASK_LINEAR(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mask.data_ptr(), w.data_ptr(),
        b.data_ptr(), out.data_ptr(), Bp * S, K, N, S, nwin, float(eps),
    )
    return out


# ----------------------------------------------------- ln_mlp_residual_bt


def ln_mlp_residual_bt_ref(x, gamma, beta, w1, b1, w2, b2, eps=1e-6,
                             activation="gelu_tanh"):
    xn = _ln_fp32(x, gamma, beta, eps).to(x.dtype)
    h = apply_act(_matmul_f32(xn, w1) + b1.float(), activation)
    acc = _matmul_f32(h.to(x.dtype), w2)
    return (acc + b2.float() + x.float()).to(x.dtype)


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


def _check_mlp_shapes(name, x, gamma, beta, w1, b1, w2, b2):
    _cuda.check_dtype(name, torch.bfloat16, x, w1, b1, w2, b2)
    _cuda.check_dtype(name, torch.float32, gamma, beta)
    K, H = x.shape[-1], w1.shape[0]
    if (w1.shape != (H, K) or w2.shape != (K, H) or b1.shape != (H,)
            or b2.shape != (K,) or gamma.shape != (K,) or beta.shape != (K,)):
        raise ValueError(f"{name}: shapes x {x.shape} w1 {w1.shape} w2 {w2.shape}")
    if K % 128 or not 1 <= K // 128 <= 10 or H % 128:
        raise ValueError(
            f"{name}: CUDA kernel needs K = 128*n (n <= 10) and H % 128 == 0, got K={K} H={H}"
        )
    return K, H


def _ln_mlp_residual_bt_cuda(x, gamma, beta, w1, b1, w2, b2, eps, activation):
    K, H = _check_mlp_shapes("ln_mlp_residual_bt", x, gamma, beta, w1, b1, w2, b2)
    out = torch.empty_like(x)
    _cuda.LN_MLP_RESIDUAL(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), x.numel() // K, K, H, float(eps),
        _cuda.ACTIVATIONS[activation],
    )
    return out


MLP_BWD_ROWS = 16  # rows per block of csrc/ln_mlp_residual_bwd.cu (its partials' count)


def ln_mlp_residual_bt_bwd(x, gamma, beta, w1, b1, w2, b2, g, eps=1e-6,
                           activation="gelu_tanh", weights=True):
    """The backward of `ln_mlp_residual_bt`: the kernel for CUDA tensors
    (TPU kernel #6), `ln_mlp_residual_bt_bwd_ref` for CPU tensors. With
    `weights` the kernel also writes dh, act(pre1), xn and per-block
    dgamma/dbeta/db1 partials, and dw1 = dh^T.xn, dw2 = g^T.act(pre1) are
    `torch.matmul` products (the JAX wrapper leaves them to XLA)."""
    name = "ln_mlp_residual_bt_bwd"
    if not _cuda.use_kernel(name, x, gamma, beta, w1, b1, w2, b2, g):
        return ln_mlp_residual_bt_bwd_ref(x, gamma, beta, w1, b1, w2, b2, g, eps, activation,
                                          weights)
    K, H = _check_mlp_shapes(name, x, gamma, beta, w1, b1, w2, b2)
    _cuda.check_dtype(name, torch.bfloat16, g)
    if g.shape != x.shape:
        raise ValueError(f"{name}: gradient {g.shape} vs x {x.shape}")
    M = x.numel() // K
    nblk = -(-M // MLP_BWD_ROWS)
    dx = torch.empty_like(x)
    side = [None] * 6
    if weights:
        e = lambda *shape, dt=x.dtype: torch.empty(shape, dtype=dt, device=x.device)  # noqa: E731
        side = [e(M, H), e(M, H), e(M, K), e(nblk, K, dt=torch.float32),
                e(nblk, K, dt=torch.float32), e(nblk, H, dt=torch.float32)]
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    _cuda.LN_MLP_RESIDUAL_BWD(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), g.data_ptr(), dx.data_ptr(), *map(ptr, side), M, K, H, float(eps),
        _cuda.ACTIVATIONS[activation],
    )
    if not weights:
        return dx, None, None, None, None, None, None
    dh, hact, xn, dga, dbe, db1 = side
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
    """x + act(LN(x) . w1^T + b1) . w2^T + b2 as one kernel; the hidden never
    reaches device memory. Counterpart of `ln_mlp_residual_bt` (TPU kernels
    #4 and #5; `hidden_grid` is a TPU tiling knob and has no counterpart),
    with the backward of #6 when a gradient is wanted."""
    tensors = (x, gamma, beta, w1, b1, w2, b2)
    fwd = autograd.forward_fn("ln_mlp_residual_bt", _ln_mlp_residual_bt_cuda,
                              ln_mlp_residual_bt_ref, tensors)
    if autograd.wants_grad(*tensors):
        return LnMlpResidual.apply(fwd, *tensors, eps, activation)
    return fwd(*tensors, eps, activation)


# --------------------------------------------------------------- proj_rows


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
    Counterpart of `proj_rows` (TPU kernel #7)."""
    return autograd.run("proj_rows", _proj_rows_cuda, proj_rows_ref, (x, w, b, res))


def _proj_rows_cuda(x, w, b, res):
    _cuda.check_dtype("proj_rows", torch.bfloat16, x, w, b, *([res] if res is not None else []))
    B, T, K, S = x.shape
    N = w.shape[0]
    if w.shape != (N, K) or b.shape != (N,) or (res is not None and res.shape != (B, T, S, N)):
        raise ValueError(f"proj_rows: shapes x {x.shape} w {w.shape}")
    out = torch.empty((B, T, S, N), dtype=x.dtype, device=x.device)
    _cuda.PROJ_ROWS(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        res.data_ptr() if res is not None else None, out.data_ptr(),
        B * T, S, K, N,
    )
    return out
