"""Host-built constants copied to the device once, for the whole process.

The port's shape-dependent constants (interpolation matrices, window masks,
rel-pos scatter matrices, the FFT prompt's circulants, the decoder's grid
coordinates) are built with numpy and cached per shape and device by their
module. Copying one to a card reads pageable host memory, which a CUDA
graph capture forbids; so the eager warm-up before a capture builds every
constant the captured call needs, and a first build during a capture
raises here instead of breaking the capture. The caches that hold them are
unbounded: a captured graph reads a constant by its address, so an evicted
entry would leave the graph reading freed memory.
"""

from __future__ import annotations

import numpy as np
import torch


def device_constant(array: np.ndarray, device, dtype: torch.dtype = None) -> torch.Tensor:
    """`array` as a tensor on `device` (in `dtype`, else its own type).
    Raises on a CUDA device while the current stream is capturing."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a host constant was first built during CUDA graph capture; run the "
            "captured function eagerly once first (graphs.GraphedCall does)")
    return torch.from_numpy(np.ascontiguousarray(array)).to(device=device, dtype=dtype)
