"""The process grid: `data` x `model` ranks over torch.distributed.

Counterpart of `camouflaged_vlm_tpu/parallel/mesh.py`. JAX runs one
controller over many devices and GSPMD places the collectives; the port
runs one process per rank and places them itself (`parallel/sharding.py`
for the tensor-parallel ones, the train step, `cli/evaluate.py` and the
serving engine for the data-parallel ones).

Ranks are laid out data-major, `rank = d * n_model + m`: the model groups
are contiguous ranks, as JAX's `reshape(n_data, n_model)` of the device
list. Each rank's device is explicit: `cuda:{local_rank}` where the host has
a card per local rank, the card `local_rank % cards` where the local ranks
share fewer cards, and `cpu` when the caller asks for it. The backend
follows, chosen up front and logged: NCCL where every rank has a card of its
own; gloo on the CPU and where ranks share a card (NCCL refuses two ranks on
one device). A backend that fails to start raises; nothing falls back.

`axis data` keeps the JAX package's fix of the reference's DDP: the
gradients of the data ranks are all-reduced and averaged (the reference
unwraps `.module` before training, so its ranks never synchronised; SURVEY.md
section 5.8).

Every collective of the port goes through the helpers below. Gloo's support
for CUDA tensors is partial, so on gloo a CUDA tensor is staged through host
memory here, in this one place.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

# start-up and collectives may wait on a peer that is still building the
# kernels or loading weights
TIMEOUT = datetime.timedelta(minutes=30)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pick_backend(device_type: str, local_world: int, cards: int) -> str:
    """'nccl' where every local rank has a card of its own, else 'gloo' (the
    CPU, or ranks that share a card)."""
    if device_type == "cuda" and local_world <= cards:
        return "nccl"
    return "gloo"


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device: str = "cuda",
                     log=_log) -> torch.device:
    """Start the default process group and return this rank's device.

    With `coordinator` ('host:port'), `num_processes` and `process_id` (the
    JAX CLI's three flags) the group meets at that address; without them it
    takes torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR/MASTER_PORT), the counterpart of JAX's autodetect. The local
    rank is LOCAL_RANK where set, else the process id (one host). Then one
    barrier, as the JAX CLI's `sync_global_devices` right after start-up.
    Already initialised: the device only."""
    if dist.is_initialized():
        return rank_device(device)
    given = [coordinator is not None, num_processes is not None, process_id is not None]
    if any(given) and not all(given):
        raise ValueError("--coordinator, --num-processes and --process-id go together")
    if coordinator is not None:
        rank, world, init = process_id, num_processes, f"tcp://{coordinator}"
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"distributed start: no --coordinator and no torchrun "
                               f"environment (missing {', '.join(missing)})")
        rank, world, init = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside [0, {world})")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    cards = torch.cuda.device_count() if device == "cuda" else 0
    backend = pick_backend(device, local_world, cards)
    dev = torch.device(f"cuda:{local_rank % cards}") if device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=TIMEOUT)
    if rank == 0:
        share = (f"; {local_world} local ranks share {cards} card(s)"
                 if device == "cuda" and backend == "gloo" else "")
        log(f"[dist] {world} ranks, backend {backend}, rank 0 on {dev}{share}")
    barrier()
    return dev


def rank_device(device: str = "cuda") -> torch.device:
    """This rank's device in an initialised group (see `init_distributed`)."""
    if device != "cuda":
        return torch.device("cpu")
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device(f"cuda:{local_rank % torch.cuda.device_count()}")


@dataclasses.dataclass
class Mesh:
    """One rank's view of the `data` x `model` grid: its coordinates, its
    device, and the process groups of its row and column. `capturable`: the
    model group's collectives can be captured in a CUDA graph (NCCL's can,
    gloo's through host memory cannot)."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    device: torch.device
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    backend: str = "gloo"

    @property
    def rank(self) -> int:
        return self.data_rank * self.n_model + self.model_rank

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def capturable(self) -> bool:
        return self.n_model == 1 or (self.backend == "nccl" and self.device.type == "cuda")

    def __repr__(self) -> str:
        return (f"Mesh(data={self.n_data}, model={self.n_model}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """The grid over the initialised default group: `n_data` defaults to
    world_size // n_model; raises when n_data * n_model != world_size (the
    JAX `make_mesh` asserts). Every rank creates every row's and column's
    group, in the same order, as `new_group` requires. `device` defaults to
    this rank's card where CUDA is available (`rank_device`), else the CPU:
    a caller on a card's host that wants the CPU passes it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: the default process group is not initialised "
                           "(parallel.init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} ranks")
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = g
    dev = torch.device(device) if device is not None else rank_device(
        "cuda" if torch.cuda.is_available() else "cpu")
    return Mesh(n_data, n_model, rank // n_model, rank % n_model, dev, data_group, model_group,
                dist.get_backend())


def batch_rows(x: torch.Tensor, mesh: Optional[Mesh], axis: int = 0) -> torch.Tensor:
    """This data rank's rows [d B/n, (d+1) B/n) of a global batch that every
    rank builds the same way from the seed (the counterpart of
    `make_global_batch_array`); `axis=1` splits the (A, B/A, ...) microbatch
    axis of an accumulated batch. Raises when the rows do not divide."""
    if mesh is None or mesh.n_data == 1:
        return x
    B = x.shape[axis]
    if B % mesh.n_data:
        raise ValueError(f"batch axis {axis} of {B} rows does not divide over "
                         f"{mesh.n_data} data ranks")
    b = B // mesh.n_data
    return x.narrow(axis, mesh.data_rank * b, b)


# --------------------------------------------------------------- collectives


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a contiguous `t` over `group`."""
    if _staged(t):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every member's `t` (same shape and type), in group-rank order, on
    t's device."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    if _staged(src):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In-place broadcast from global rank `src`."""
    if _staged(t):
        h = t.cpu()
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def broadcast_object(obj, src: int = 0):
    """A picklable object from global rank `src` to every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=torch.device("cpu")
                               if dist.get_backend() == "gloo" else None)
    return box[0]


def barrier() -> None:
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def data_mean(values: Tuple[torch.Tensor, ...], mesh: Optional[Mesh]) -> Tuple[torch.Tensor, ...]:
    """The data-group means of scalar tensors (one collective)."""
    if mesh is None or mesh.n_data == 1:
        return values
    flat = torch.stack([v.detach().float().reshape(()) for v in values])
    all_reduce_(flat, mesh.data_group)
    return tuple(flat / mesh.n_data)
