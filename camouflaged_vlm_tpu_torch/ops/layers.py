"""flax layer semantics in PyTorch, for the plain parts of the port.

flax computes `nn.Dense(dtype=dt)` / `nn.Conv(dtype=dt)` with input,
weight and bias cast to `dt`, and multiplies a tensor by a Python scalar in
the tensor's type (the scalar is rounded first). These helpers do the same
on the port's NHWC / (B, S, D) layouts, with weights in PyTorch's layouts.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=dtype)`: input, kernel and bias in `dtype`."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Conv(dtype=dtype)` on NHWC, computed NCHW by PyTorch."""
    bias = conv.bias.to(dtype) if conv.bias is not None else None
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype), bias,
                 stride=conv.stride, padding=conv.padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose_nhwc(x: torch.Tensor, conv: nn.ConvTranspose2d,
                        dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.ConvTranspose(transpose_kernel=True, dtype=dtype)` on NHWC."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype),
                           conv.bias.to(dtype), stride=conv.stride, padding=conv.padding)
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _rounded(scale: float, dtype: torch.dtype) -> float:
    return torch.tensor(scale, dtype=dtype).item()


def scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x * scale with the scale rounded to x's type first (JAX's weak-typed
    scalar multiply). The rounded scale goes in as a Python float: the
    multiply computes in fp32 (bf16, fp16) or in x's type, where the
    rounded scale is exact, so the product is rounded once, as by a tensor
    of x's type, and no host-to-device copy is made (a CUDA graph capture
    forbids one)."""
    return x * _rounded(scale, x.dtype)
