"""FFT high-pass filter for the EVP handcrafted prompt stream.

Counterpart of `camouflaged_vlm_tpu/ops/fft_prompt.py`: the centred
low-frequency square of the shifted spectrum is zeroed, the image
inverse-transformed, and |real part| taken. The mask is separable, so
``ifft2(mask * fft2(x))`` is two circulant products ``A X B^T`` whose
matrices are built once in numpy; the real part is ``Ar X Br^T - Ai X Bi^T``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .constants import device_constant


def _line(H: int, W: int, rate: float) -> int:
    return int((H * W * rate) ** 0.5 // 2)


@lru_cache(maxsize=8)
def _lowpass_circulant(N: int, line: int):
    """(real, imag) fp32 circulant matrix of ifft(diag(m) fft(.)) along one
    axis, m keeping the `line` lowest positive and negative frequencies."""
    m = np.zeros(N)
    m[:line] = 1.0
    if line > 0:
        m[N - line:] = 1.0
    c = np.fft.ifft(m)
    idx = (np.arange(N)[:, None] - np.arange(N)[None, :]) % N
    A = c[idx]
    return A.real.astype(np.float32), A.imag.astype(np.float32)


@lru_cache(maxsize=None)
def _lowpass_circulant_on(N: int, line: int, device: torch.device):
    """`_lowpass_circulant` on `device`, copied there once (a copy from
    pageable host memory at every call would make the host wait for the
    card)."""
    return tuple(device_constant(a, device) for a in _lowpass_circulant(N, line))


def fft_highpass(x: torch.Tensor, rate: float) -> torch.Tensor:
    """x: (B, H, W, C) -> same shape, |real(ifft(highpass(fft(x))))|."""
    x32 = x.float()
    H, W = x.shape[1], x.shape[2]
    line = _line(H, W, rate)
    Ar, Ai = _lowpass_circulant_on(H, line, x.device)
    Br, Bi = _lowpass_circulant_on(W, line, x.device)
    t_r = torch.einsum("hk,bkwc->bhwc", Ar, x32)
    t_i = torch.einsum("hk,bkwc->bhwc", Ai, x32)
    low = torch.einsum("bhwc,lw->bhlc", t_r, Br) - torch.einsum("bhwc,lw->bhlc", t_i, Bi)
    return (x32 - low).abs().to(x.dtype)
