"""Autograd around the kernels: a kernel forward with the plain version's VJP.

Counterpart of `camouflaged_vlm_tpu/ops/vjp.py` (`pallas_with_xla_vjp`).
A wrapper calls `run(name, launch, plain, tensors, static)`:

  * no gradient wanted (grad mode off, or no tensor requires grad): the
    kernel (`launch`) for CUDA tensors, the plain version for CPU tensors,
    exactly as before; the inference path is unchanged;
  * a gradient wanted: `PlainVJP`, whose forward is that same call under
    no grad, and whose backward re-runs the plain version on the saved
    inputs under `torch.enable_grad()` and differentiates it only for the
    inputs with `ctx.needs_input_grad`. A frozen weight therefore costs no
    weight-gradient product: the port's form of the JAX package's
    trainable/frozen partition (`train/train_step.py`).

Each Function keeps only its inputs, as JAX's custom_vjp keeps its
residuals. The kernels with a hand-written backward (`ln_mlp_residual_bt`,
`flash_qkv_packed_windows_s`, `flash_qkv_packed_global`) have their own
Functions beside their wrappers.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from . import _cuda


def wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


def forward_fn(name: str, launch: Callable, plain: Callable,
               tensors: Sequence[Optional[torch.Tensor]], strided: int = 0) -> Callable:
    """The kernel for CUDA tensors (after `_cuda.use_kernel`'s checks; the
    first `strided` tensors may be strided views), the plain version for CPU
    tensors."""
    return launch if _cuda.use_kernel(name, *tensors, strided=strided) else plain


class PlainVJP(torch.autograd.Function):
    """Forward: `fwd(*tensors, *static)`; backward: the VJP of
    `plain(*tensors, *static)`."""

    @staticmethod
    def forward(ctx, fwd, plain, n, *args):
        tensors, static = args[:n], args[n:]
        ctx.plain, ctx.n, ctx.static = plain, n, static
        ctx.save_for_backward(*tensors)
        return fwd(*tensors, *static)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[3 : 3 + ctx.n]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) if t is not None else None
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*inputs, *ctx.static)
            got = iter(torch.autograd.grad(out, [x for x, n in zip(inputs, needs) if n], g))
        grads = [next(got) if n else None for n in needs]
        return (None, None, None, *grads, *([None] * len(ctx.static)))


def run(name: str, launch: Callable, plain: Callable,
        tensors: Sequence[Optional[torch.Tensor]], static: Sequence = (), strided: int = 0):
    """`launch(*tensors, *static)` on the card or `plain(...)` on the CPU;
    through `PlainVJP` when a gradient is wanted."""
    fwd = forward_fn(name, launch, plain, tensors, strided)
    if wants_grad(*tensors):
        return PlainVJP.apply(fwd, plain, len(tensors), *tensors, *static)
    return fwd(*tensors, *static)
