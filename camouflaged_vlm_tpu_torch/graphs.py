"""One function at fixed input shapes, captured as one CUDA graph.

The PyTorch counterpart of the JAX package's one compiled program per
batch bucket (`jax.jit` of the cascade, `serve.py` and `bench.py` there):
the eager cascade call makes thousands of launches, each with the host's
Python, ctypes and TMA-descriptor work; a replay of the captured graph
makes one.

`GraphedCall(fn, *example_inputs)` copies the example inputs into static
buffers, runs `fn` on them eagerly on a side stream (the warm-up: the
kernels' build and load, their shared-memory opt-ins, the numpy-built
device constants, the allocator), then captures one call with
`torch.cuda.graph`. Calling it copies new inputs into the static buffers,
replays the graph on the current stream and returns the static outputs,
which the next replay overwrites: a caller that keeps them copies them
first, on the same stream. Every buffer address is baked into the graph
(the kernels' TMA maps are `__grid_constant__` parameters encoded on the
host at capture), so the inputs always go through the static buffers and
every intermediate lives in the graph's memory pool.

The kernels' launch counts (`ops/_cuda.launch_counts`) count host calls,
so a replay adds none: `launches` holds the counts of the captured call.
On the CPU the function runs eagerly (the caller asked for the CPU), and so
it does on a card with `capture=False` (a program whose collectives no
graph can hold: tensor parallelism over gloo), its inputs copied to the
card. On a card a failed capture or replay raises; nothing falls back to
the eager call.

Every warm-up runs on one side stream per card, kept for the process:
cuBLAS keeps a workspace for each stream it has run on until the process
ends, so a new stream per capture would leave one behind at every capture.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from .ops import _cuda

# eager calls before the capture: with the captured call, a GraphedCall's
# host launches are WARMUP + 1 calls' (`launches` holds the captured one's)
WARMUP = 2


@functools.lru_cache(maxsize=None)
def warmup_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every capture on `device` warms up on."""
    return torch.cuda.Stream(device)


class GraphedCall:
    """`fn` captured at the shapes, types and device of `example_inputs`.

    pool: a `torch.cuda.graph_pool_handle()` shared with other captures
        whose replays never overlap (one stream serialises them), so that
        their intermediates share memory; None gives the graph a pool of
        its own.
    warmup: eager calls before the capture.
    capture: False runs `fn` eagerly on the card too (see the module
        docstring).
    """

    def __init__(self, fn: Callable, *example_inputs: torch.Tensor, pool=None,
                 warmup: int = WARMUP, capture: bool = True):
        self.fn = fn
        self.device = example_inputs[0].device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Optional[Dict[str, int]] = None
        if self.device.type != "cuda" or not capture:
            return
        self.static_inputs = tuple(t.detach().clone() for t in example_inputs)
        side = warmup_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(warmup):
                fn(*self.static_inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _cuda.launch_counts()
        # thread_local: other threads of the process (a server's completion
        # thread waiting on an event) may make CUDA calls during the capture
        with torch.no_grad(), torch.cuda.graph(graph, pool=pool,
                                               capture_error_mode="thread_local"):
            self.static_outputs = fn(*self.static_inputs)
        after = _cuda.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        self.graph = graph

    def __call__(self, *inputs: torch.Tensor) -> Tuple:
        if self.graph is None:
            with torch.no_grad():
                return self.fn(*(x.to(self.device, non_blocking=True) for x in inputs))
        if len(inputs) != len(self.static_inputs):
            raise ValueError(f"GraphedCall: {len(inputs)} inputs, captured with "
                             f"{len(self.static_inputs)}")
        for s, x in zip(self.static_inputs, inputs):
            if x.shape != s.shape or x.dtype != s.dtype:
                raise ValueError(f"GraphedCall: input {tuple(x.shape)} {x.dtype}, captured "
                                 f"at {tuple(s.shape)} {s.dtype}")
            if x is not s:
                s.copy_(x, non_blocking=True)
        self.graph.replay()
        return self.static_outputs
