"""Fused linear layers: the Hopper kernels and their plain versions.

Counterparts of `camouflaged_vlm_tpu/ops/linear.py`. Each public function
runs its CUDA kernel (`csrc/`) for CUDA tensors and its plain PyTorch
version for CPU tensors; on CUDA it launches the kernel or raises, never
falls back. The plain versions transcribe the JAX `ref` formulations: LN
statistics in fp32, LN output cast to the working type before the product,
fp32 accumulation, bias and activation in fp32 on the accumulator, one
rounding at the end.

Layouts: activations as in the JAX package ((M, K) rows, (B, S, K)
sequences, the d-major (B, T, K, S) attention output); weights in the
`nn.Linear` layout (out, in), biases (out,), LN scale/shift (K,) fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda


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
    if not _cuda.use_kernel("linear_act", x, w, b):
        return linear_act_ref(x, w, b, activation)
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
    if not _cuda.use_kernel("ln_linear_act_bt", x, gamma, beta, w, b):
        return ln_linear_act_bt_ref(x, gamma, beta, w, b, eps, activation)
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
    if not _cuda.use_kernel("ln_mask_linear_bt", x, gamma, beta, mask, w, b):
        return ln_mask_linear_bt_ref(x, gamma, beta, mask, w, b, eps)
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
    #4 and #5; `hidden_grid` is a TPU tiling knob and has no counterpart)."""
    if not _cuda.use_kernel("ln_mlp_residual_bt", x, gamma, beta, w1, b1, w2, b2):
        return ln_mlp_residual_bt_ref(x, gamma, beta, w1, b1, w2, b2, eps, activation)
    _cuda.check_dtype("ln_mlp_residual_bt", torch.bfloat16, x, w1, b1, w2, b2)
    _cuda.check_dtype("ln_mlp_residual_bt", torch.float32, gamma, beta)
    Bp, S, K = x.shape
    H = w1.shape[0]
    if (w1.shape != (H, K) or w2.shape != (K, H) or b1.shape != (H,)
            or b2.shape != (K,) or gamma.shape != (K,) or beta.shape != (K,)):
        raise ValueError(f"ln_mlp_residual_bt: shapes x {x.shape} w1 {w1.shape} w2 {w2.shape}")
    if K % 128 or not 1 <= K // 128 <= 10 or H % 128:
        raise ValueError(
            f"ln_mlp_residual_bt: CUDA kernel needs K = 128*n (n <= 10) and "
            f"H % 128 == 0, got K={K} H={H}"
        )
    out = torch.empty_like(x)
    _cuda.LN_MLP_RESIDUAL(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), Bp * S, K, H, float(eps),
        _cuda.ACTIVATIONS[activation],
    )
    return out


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
    if not _cuda.use_kernel("proj_rows", x, w, b, res):
        return proj_rows_ref(x, w, b, res)
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
