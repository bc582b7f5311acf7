"""Tensor parallelism: the Megatron partition rules and their collectives.

Counterpart of `camouflaged_vlm_tpu/parallel/sharding.py`, whose rules
(`_RULES`) this module states over the reference's state-dict names:

  column-parallel (output features sharded; weights and biases): qkv,
      in_proj / in_proj_weight, lin1, c_fc, q_proj, k_proj, v_proj;
  row-parallel (input features sharded; weights only): attn.proj, out_proj,
      lin2, c_proj;
  everything else replicated (norms, rel-pos tables, convs, embeddings,
      the row-parallel biases).

One deliberate departure: a packed qkv / in_proj weight (3 dim rows: q of
every head, then k, then v) is sliced head-aligned. Model rank m keeps the
q, k and v rows of heads [m h/n, (m+1) h/n), so its shard is again a packed
[q | k | v] of h/n whole heads. JAX shards it contiguously (P(None,
"model")) and GSPMD reshards inside the program; the port's attention
kernels read whole heads. So n_model must divide every tower's head count
and the decoder's (`check_tp_config` raises before anything is built).

Where the JAX package lets GSPMD place the collectives, the port places
Megatron's pair: `copy_to_model` (identity forward, model-group all-reduce
of the gradient) at each tensor-parallel sublayer's input, and
`reduce_from_model` (model-group all-reduce forward, identity backward)
after its row-parallel product: two all-reduces a transformer block in the
forward. The sublayers fuse LayerNorm into their first kernel, so the
replicated parameters they read inside the parallel region (the norms, the
rel-pos tables) go through `copy_to_model` too; the row-parallel bias is
added on model rank 0 only (`row_bias`).

A second departure: each rank's row-parallel product leaves its kernel
unrounded, in fp32 (`proj_rows(..., partial=True)`,
`ln_mlp_residual_bt(..., residual=False)`; `row_linear` for the plain
ones), the all-reduce sums the fp32 partials, and the residual is added
after the sum (`add_residual`), in fp32, before the one rounding to the
compute type: the rounding points of one device, up to the order of the
fp32 sums. Partials rounded to bf16 before the sum (JAX's bf16 psum) put a
second rounding on every element of every block's output (on an H100 the
full-width bf16 SAM embedding of two ranks then sat 2.4e-2 mean relative
from one device's, against 1.5e-2 with fp32 partials, which is one
device's own spread under an input change far below bf16's resolution;
PERF.md, multi-device).

`shard_model_` slices a built model's weights in place to this rank's
shard and marks every module with the mesh (`tp_of`);
`gather_state_dict` and `gather_optimizer_state` give back the full state a
one-device run holds (the checkpoint's), `shard_state_dict` and
`shard_optimizer_state` slice it again on any mesh.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .mesh import Mesh, all_gather, all_reduce_

_COLUMN = re.compile(r"(^|\.)(qkv|in_proj|lin1|c_fc|q_proj|k_proj|v_proj)[._](weight|bias)$")
_ROW = re.compile(r"(^|\.)(attn\.proj|out_proj|lin2|c_proj)\.weight$")
_PACKED = re.compile(r"(^|\.)(qkv|in_proj)[._](weight|bias)$")


def param_partition_kind(name: str) -> Optional[str]:
    """'column', 'row' or None (replicated) for a state-dict name."""
    if _COLUMN.search(name):
        return "column"
    if _ROW.search(name):
        return "row"
    return None


def is_packed(name: str) -> bool:
    """A packed [q | k | v] projection, sliced head-aligned."""
    return bool(_PACKED.search(name))


def shard_tensor(t: torch.Tensor, name: str, n: int, m: int) -> torch.Tensor:
    """Model rank m's shard of the full tensor `t` (a contiguous copy)."""
    kind = param_partition_kind(name)
    if kind is None or n == 1:
        return t
    axis = 0 if kind == "column" else 1
    size = t.shape[axis] // 3 if is_packed(name) else t.shape[axis]
    if size % n:
        raise ValueError(f"{name}: {kind}-parallel width {size} does not divide over "
                         f"{n} model ranks")
    if is_packed(name):
        return t.reshape(3, n, size // n, *t.shape[1:])[:, m].reshape(-1, *t.shape[1:]).clone()
    return t.chunk(n, dim=axis)[m].contiguous()


def unshard_tensor(shards: Sequence[torch.Tensor], name: str) -> torch.Tensor:
    """The full tensor from the model ranks' shards, in rank order."""
    kind = param_partition_kind(name)
    if kind is None or len(shards) == 1:
        return shards[0]
    if is_packed(name):
        rest = shards[0].shape[1:]
        return torch.stack([s.reshape(3, -1, *rest) for s in shards], 1).reshape(-1, *rest)
    return torch.cat(list(shards), dim=0 if kind == "column" else 1)


def check_tp_config(cfg, n_model: int) -> None:
    """Raise unless n_model divides every sharded width of the cascade: the
    heads of SAM, of both CLIP towers and of the decoder (the packed
    projections are sliced by whole heads), and the MLP hidden widths."""
    if n_model == 1:
        return
    enc, clip, dec = cfg.encoder, cfg.clip, cfg.decoder.transformer
    widths = {
        "SAM heads": enc.num_heads, "SAM MLP": int(enc.embed_dim * enc.mlp_ratio),
        "CLIP vision heads": clip.vision_heads, "CLIP vision MLP": 4 * clip.vision_width,
        "CLIP text heads": clip.transformer_heads, "CLIP text MLP": 4 * clip.transformer_width,
        "decoder heads": dec.num_heads, "decoder MLP": dec.mlp_dim,
    }
    bad = {k: v for k, v in widths.items() if v % n_model}
    if bad:
        raise ValueError(f"--n-model {n_model} does not divide "
                         + ", ".join(f"{k} ({v})" for k, v in bad.items()))


def tp_of(module) -> Optional[Mesh]:
    """The mesh a sharded module runs on (`shard_model_`), None unsharded."""
    return module.__dict__.get("tp")


def shard_model_(model: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Slice every column- and row-parallel weight of `model` in place to
    this rank's shard and mark every module with the mesh. With one model
    rank (or no mesh) the model is left as it is."""
    if mesh is None or mesh.n_model == 1:
        return model
    with torch.no_grad():
        for name, p in model.named_parameters():
            if param_partition_kind(name):
                p.data = shard_tensor(p.data, name, mesh.n_model, mesh.model_rank)
    for mod in model.modules():
        mod.tp = mesh
    return model


def gather_tensor(name: str, t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The full tensor of parameter `name` (or a tensor shaped like it: a
    gradient, a moment) from its model group's shards."""
    if mesh is None or mesh.n_model == 1 or param_partition_kind(name) is None:
        return t
    return unshard_tensor(all_gather(t, mesh.model_group), name)


def gather_state_dict(model: torch.nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The full state dict a one-device run holds (every model rank calls
    it; every rank gets it)."""
    return {k: gather_tensor(k, v, mesh) for k, v in model.state_dict().items()}


def shard_state_dict(sd: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """A full state dict sliced to this rank's shard."""
    if mesh is None or mesh.n_model == 1:
        return sd
    return {k: shard_tensor(v, k, mesh.n_model, mesh.model_rank) for k, v in sd.items()}


def _optimizer_names(optimizer, model) -> List[str]:
    """The state-dict name of each of the optimizer's parameters, in its
    state-dict index order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _map_optimizer_state(sd: dict, names: List[str], fn) -> dict:
    """The optimizer state dict with fn(name, tensor) applied to every state
    tensor shaped like its parameter (AdamW's moments; not the step)."""
    state = {}
    for i, s in sd["state"].items():
        state[i] = {k: (fn(names[i], v) if isinstance(v, torch.Tensor) and v.ndim > 0 else v)
                    for k, v in s.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def gather_optimizer_state(optimizer, model, mesh: Optional[Mesh]) -> dict:
    """The optimizer state dict with every moment of a sharded parameter
    gathered to its full shape (every model rank calls it)."""
    sd = optimizer.state_dict()
    if mesh is None or mesh.n_model == 1:
        return sd
    return _map_optimizer_state(sd, _optimizer_names(optimizer, model),
                                lambda n, v: gather_tensor(n, v, mesh))


def shard_optimizer_state(sd: dict, optimizer, model, mesh: Optional[Mesh]) -> dict:
    """A full optimizer state dict sliced to this rank's shard."""
    if mesh is None or mesh.n_model == 1:
        return sd
    return _map_optimizer_state(sd, _optimizer_names(optimizer, model),
                                lambda n, v: shard_tensor(v, n, mesh.n_model, mesh.model_rank))


# ------------------------------------------------------------- collectives


def _reduce(xs: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The sums over `group` of the tensors xs, in one all-reduce; new
    tensors, the inputs untouched."""
    if len(xs) == 1:
        return [all_reduce_(xs[0].contiguous().clone(), group).view_as(xs[0])]
    flat = torch.cat([x.reshape(-1) for x in xs])
    all_reduce_(flat, group)
    return [c.view_as(x) for c, x in zip(flat.split([x.numel() for x in xs]), xs)]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_reduce(gs, ctx.group))


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        return tuple(_reduce(xs, group))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


def _each(xs, fn):
    """fn over the tensors of xs, one result each (None entries pass
    through); one tensor for one."""
    live = [x for x in xs if x is not None]
    outs = iter(fn(live))
    got = [next(outs) if x is not None else None for x in xs]
    return got[0] if len(got) == 1 else tuple(got)


def _wants_grad(xs) -> bool:
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs)


def copy_to_model(tp: Optional[Mesh], *xs):
    """Megatron's f: the identity forward, the model group's all-reduce of
    the gradients backward (one collective for all of xs). Returns xs (one
    tensor for one); None entries pass through."""
    if tp is None or not _wants_grad(xs):
        return xs[0] if len(xs) == 1 else xs
    return _each(xs, lambda live: _CopyToModel.apply(tp.model_group, *live))


def reduce_from_model(tp: Optional[Mesh], *xs):
    """Megatron's g: the model group's all-reduce forward (one collective
    for all of xs), the identity backward. Returns new tensors (one for
    one); None entries pass through."""
    if tp is None:
        return xs[0] if len(xs) == 1 else xs
    if _wants_grad(xs):
        return _each(xs, lambda live: _ReduceFromModel.apply(tp.model_group, *live))
    return _each(xs, lambda live: _reduce(live, tp.model_group))


def local_heads(heads: int, tp: Optional[Mesh]) -> int:
    return heads if tp is None else heads // tp.n_model


def replicated(tp: Optional[Mesh], p: torch.Tensor) -> torch.Tensor:
    """A replicated parameter read inside the parallel region: its
    gradient is summed over the model ranks."""
    return copy_to_model(tp, p)


def row_bias(tp: Optional[Mesh], b: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's bias: the bias on model rank 0, zeros on
    the others (as a product with 0 where a gradient is wanted, so that
    every rank's backward holds the same collectives)."""
    if tp is None or tp.model_rank == 0:
        return replicated(tp, b)
    if torch.is_grad_enabled() and b.requires_grad:
        return replicated(tp, b) * 0
    return torch.zeros_like(b)


def row_linear(tp: Optional[Mesh], x: torch.Tensor, layer: torch.nn.Linear,
               dtype: torch.dtype) -> torch.Tensor:
    """A plain row-parallel nn.Linear as flax's Dense(dtype): on one device
    x . w^T + b in `dtype`; sharded, this rank's partial in fp32 (x, w and
    the bias rounded to `dtype` first, the bias on model rank 0 only)."""
    w, b = layer.weight.to(dtype), row_bias(tp, layer.bias).to(dtype)
    if tp is None:
        return F.linear(x.to(dtype), w, b)
    return F.linear(x.to(dtype).float(), w.float(), b.float())


def add_residual(y: torch.Tensor, res: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """y + res in fp32, rounded once to `dtype`: a row-parallel sublayer's
    output, its fp32 partials summed over the model group first."""
    return (y.float() + res.float()).to(dtype)
