"""Driver entry points of the PyTorch port (counterpart of `__graft_entry__.py`).

`entry()`: the forward of the flagship OVCOS cascade (SAM ViT-H +
Alpha-CLIP ViT-L/14@336, bf16, both stages fused, the rel tables attached)
with example arguments, on the card.

`dryrun_multichip(n, device="cpu")`: starts n processes that form one
process group (gloo on the CPU; on one card shared by the ranks gloo too,
NCCL where each rank has a card: `parallel/mesh.py`) and, for every mesh
shape of n ranks that the heads allow, (n, 1), (n/2, 2) and (1, n), runs
the full train step (forward, loss, backward, AdamW on the trainable set)
and the eval program, and holds each to the same step and program in one
process: |dloss| < 1e-5 and updated parameters within 1e-4 (the JAX dry
run's bounds), the eval program's mask probabilities and class logits
within 1e-5 relative (max|d| / max|ref|, against one process's program on
each data rank's rows) and its classes equal. On the CPU the cascade is the tiny
one (the JAX dry run's); on the card a small fp32 cascade whose widths the
fp32 kernels take (heads of 64; fused 'flash' SAM with 8 heads).

`spawn_ranks(n, fn, *args)` is the process harness both use: fn(*args) in
each of n fresh processes of one group, each rank's return value back.

This file imports torch and the port, never jax.
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import socket
import sys
import time
import traceback
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

TEST_CLASSNAMES_SMALL = ["cat", "owl", "snow leopard", "scorpionfish"]
# the JAX dry run's bounds (`__graft_entry__.py`)
DLOSS_BOUND, DPARAMS_BOUND, DEVAL_BOUND = 1e-5, 1e-4, 1e-5


def entry():
    """(forward, example_args): forward(*example_args) runs the bf16
    cascade's fused inference on the card -> (mask probs, pred, logits)."""
    import torch

    from camouflaged_vlm_tpu_torch.factory import (
        attach_rel_cache,
        build_full_cascade,
        make_bank_inputs,
    )

    model, cfg = build_full_cascade(dtype=torch.bfloat16, device="cuda")
    attach_rel_cache(model)
    bank = make_bank_inputs(cfg, TEST_CLASSNAMES_SMALL, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    inp = torch.randn(1, cfg.inp_size, cfg.inp_size, 3, device="cuda", generator=gen)
    cimg = torch.randn(1, cfg.clip_size, cfg.clip_size, 3, device="cuda", generator=gen)
    cmask = torch.full((1, cfg.clip_size, cfg.clip_size, 1), 1.923, device="cuda")

    def forward(inp, cimg, cmask, prefix, suffix, eot_indices, bank_features):
        return model.infer_cascade(inp, cimg, cmask, prefix, suffix, eot_indices,
                                   bank_features)

    return forward, (inp, cimg, cmask, bank["prefix"], bank["suffix"], bank["eot_indices"],
                     bank["bank_features"])


# ------------------------------------------------------------ the harness


def exact_fp32() -> None:
    """fp32 matmuls and convolutions in full fp32 in this process (TF32
    would round their operands), as the dry run compares its ranks with
    one process and the CLIs run fp32 on the card."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, device: str, fn: Callable, args: tuple, queue):
    import torch
    import torch.distributed as dist

    from camouflaged_vlm_tpu_torch.parallel import init_distributed

    try:
        if device == "cpu":  # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * n)))
        else:
            exact_fp32()
        init_distributed(f"127.0.0.1:{port}", n, rank, device=device, log=lambda m: None)
        queue.put((rank, True, fn(*args)))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(n: int, fn: Callable, *args, device: str = "cpu", timeout: float = 900) -> list:
    """fn(*args) in n fresh processes of one process group (`fn` importable
    by name, its arguments and result picklable); each rank's result in rank
    order. Raises with the failing ranks' tracebacks."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, device, fn, args, queue))
             for r in range(n)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        # drained before the joins; a failed rank (or one that died without a
        # word, an abort in a collective) leaves its peers waiting: stop them
        while (len(got) < n and time.monotonic() < deadline
               and all(ok for ok, _ in got.values())):
            try:
                rank, ok, value = queue.get(timeout=1.0)
                got[rank] = (ok, value)
            except queue_mod.Empty:
                got.update({r: (False, f"exited with code {p.exitcode}")
                            for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                            and r not in got})
    finally:
        for p in procs:
            p.join(timeout=60 if len(got) == n and all(ok for ok, _ in got.values()) else 1)
            if p.is_alive():
                p.kill()
    failed = [f"rank {r}: {v}" for r, (ok, v) in sorted(got.items()) if not ok]
    if failed or len(got) < n:
        raise RuntimeError("spawn_ranks: " + ("\n".join(failed) or f"{n - len(got)} ranks "
                                              "returned nothing"))
    return [got[r][1] for r in range(n)]


# ------------------------------------------------------- the dry run's step


def dryrun_config(device: str):
    """The tiny cascade on the CPU; on the card a small fp32 cascade whose
    widths the fp32 kernels take (SAM 512 wide, 8 heads of 64, fused
    'flash' on the compact carry; CLIP 2 heads of 64)."""
    import torch

    from camouflaged_vlm_tpu_torch.models import CascadeConfig, SamEncoderConfig
    from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig

    if device == "cpu":
        return CascadeConfig.tiny()
    f32 = torch.float32
    clip = AlphaClipConfig.tiny(dtype=f32, vision_width=128, vision_heads=2,
                                transformer_width=128)
    enc = SamEncoderConfig.tiny(dtype=f32, attn_impl="flash", img_size=384, embed_dim=512,
                                num_heads=8, window_size=5, prompt_scale_factor=32)
    return dataclasses.replace(CascadeConfig.tiny(dtype=f32), inp_size=enc.img_size,
                               encoder=enc, clip=clip)


def dryrun_batch(cfg, rows: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded global batch of `rows` images (the JAX dry run's draws)."""
    rng = np.random.default_rng(seed)
    S, C = cfg.inp_size, cfg.clip_size
    return {
        "inp": rng.standard_normal((rows, S, S, 3)).astype(np.float32),
        "gt": (rng.random((rows, S, S, 1)) > 0.5).astype(np.float32),
        "clip_image": rng.standard_normal((rows, C, C, 3)).astype(np.float32),
        "clip_mask": np.full((rows, C, C, 1), 1.923, np.float32),
    }


def train_step_case(cfg, batch: Dict[str, np.ndarray], mesh=None, device: str = "cpu",
                    accum: int = 1, loss: str = "iou", seed: int = 0, steps: int = 1,
                    classnames: Sequence[str] = TEST_CLASSNAMES_SMALL, state=None) -> dict:
    """`steps` train steps of a seeded cascade (or one holding the full
    state dict `state`) on `batch` (the global batch: on a mesh this rank
    takes its rows and shards the model), AdamW at its defaults, the
    per-epoch cosine of 20 one-step epochs; returns {"metrics": [per step], "grads": the last
    step's synchronised trainable gradients and "params": the trainable
    parameters after it, both gathered to full shape, as numpy}."""
    import torch

    from camouflaged_vlm_tpu_torch.factory import attach_rel_cache, build_cascade
    from camouflaged_vlm_tpu_torch.factory import make_bank_inputs
    from camouflaged_vlm_tpu_torch.parallel import batch_rows, shard_model_
    from camouflaged_vlm_tpu_torch.parallel.sharding import gather_state_dict, gather_tensor
    from camouflaged_vlm_tpu_torch.train import (
        SCANNED_BATCH_KEYS,
        cosine_epoch_schedule,
        make_train_step,
        trainable_parameters,
    )

    dev = mesh.device if mesh is not None else torch.device(device)
    model = build_cascade(cfg, dev, seed)
    if state is not None:
        model.load_state_dict(state, strict=True)
    shard_model_(model, mesh)
    attach_rel_cache(model)
    bank = make_bank_inputs(cfg, classnames, device=dev)
    text = model.encode_class_text_features(bank["prefix"], bank["suffix"],
                                            bank["eot_indices"], bank["bank_features"])
    params = trainable_parameters(model)
    grads: List[torch.Tensor] = []

    class Recording(torch.optim.AdamW):
        def step(self, closure=None):
            grads[:] = [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                        for p in params]
            return super().step(closure)

    opt = Recording(params, lr=2e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    step = make_train_step(model, opt, cosine_epoch_schedule(2e-4, 20), loss, accum, mesh=mesh)
    tb = {}
    for k in SCANNED_BATCH_KEYS:
        x = torch.from_numpy(batch[k])
        if accum > 1:
            x = x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))
        tb[k] = batch_rows(x, mesh, axis=1 if accum > 1 else 0).contiguous().to(dev)
    metrics = [{k: float(v) for k, v in step({**tb, "text_features": text}, i).items()}
               for i in range(steps)]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    full = gather_state_dict(model, mesh)
    return {"metrics": metrics,
            "grads": {n: gather_tensor(n, g, mesh).float().cpu().numpy()
                      for n, g in zip(names, grads)},
            "params": {n: full[n].float().cpu().numpy() for n in names}}


def eval_case(cfg, batch: Dict[str, np.ndarray], mesh=None, device: str = "cpu",
              seed: int = 0, classnames: Sequence[str] = TEST_CLASSNAMES_SMALL) -> list:
    """The eval program (`infer_cascade_with_text`) of a seeded cascade on
    the global batch: on a mesh this rank's rows on its model shard, the
    data ranks' outputs gathered in rank order; on a card captured as one
    CUDA graph (`graphs.GraphedCall`, as evaluate() runs it) where the
    mesh's collectives can be captured (NCCL's), eager where they cannot
    (gloo's). -> [mask probs, pred, logits] as numpy."""
    import torch

    from camouflaged_vlm_tpu_torch.factory import attach_rel_cache, build_cascade
    from camouflaged_vlm_tpu_torch.factory import make_bank_inputs
    from camouflaged_vlm_tpu_torch.graphs import GraphedCall
    from camouflaged_vlm_tpu_torch.parallel import batch_rows, shard_model_
    from camouflaged_vlm_tpu_torch.parallel.mesh import all_gather

    dev = mesh.device if mesh is not None else torch.device(device)
    model = shard_model_(build_cascade(cfg, dev, seed), mesh)
    attach_rel_cache(model)
    bank = make_bank_inputs(cfg, classnames, device=dev)
    text = model.encode_class_text_features(bank["prefix"], bank["suffix"],
                                            bank["eot_indices"], bank["bank_features"])
    args = [batch_rows(torch.from_numpy(batch[k]), mesh).to(dev)
            for k in ("inp", "clip_image", "clip_mask")]
    graphed = GraphedCall(lambda *a: model.infer_cascade_with_text(*a, text), *args,
                          capture=mesh is None or mesh.capturable)
    outs = [o.clone() for o in graphed(*args)]
    if mesh is not None and mesh.n_data > 1:
        outs = [torch.cat(all_gather(o, mesh.data_group)) for o in outs]
    return [o.float().cpu().numpy() for o in outs]


def mesh_shapes(n: int, cfg) -> List[Tuple[int, int]]:
    """(n, 1), (n/2, 2) and (1, n), each where n_model divides the heads and
    widths (`parallel.check_tp_config`), without repeats."""
    from camouflaged_vlm_tpu_torch.parallel import check_tp_config

    out = []
    for nd, nm in ((n, 1), (n // 2, 2), (1, n)):
        if nd * nm != n or (nd, nm) in out:
            continue
        try:
            check_tp_config(cfg, nm)
        except ValueError:
            continue
        out.append((nd, nm))
    return out


def _dryrun_rank(shapes, device: str) -> list:
    """One rank of the dry run: the train step and the eval program on
    each mesh shape."""
    from camouflaged_vlm_tpu_torch.parallel import make_mesh
    from camouflaged_vlm_tpu_torch.parallel.mesh import rank_device

    cfg = dryrun_config(device)
    out = []
    for nd, nm in shapes:
        mesh = make_mesh(nd, nm, rank_device(device))
        batch = dryrun_batch(cfg, 2 * nd)
        step = train_step_case(cfg, batch, mesh)
        out.append((step, eval_case(cfg, batch, mesh)))
    return out


def _gap(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> float:
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


def dryrun_multichip(n_devices: int, device: str = "cpu") -> List[dict]:
    """The dry run (see the module docstring). Prints one line per mesh
    shape; raises when a shape departs from one process beyond the bounds;
    returns each shape's figures. On the card it turns TF32 off in this
    process, as in the ranks."""
    cfg = dryrun_config(device)
    shapes = mesh_shapes(n_devices, cfg)
    if device != "cpu":
        exact_fp32()  # as in the ranks
    ranks = spawn_ranks(n_devices, _dryrun_rank, shapes, device, device=device)
    report = []
    for i, (nd, nm) in enumerate(shapes):
        batch = dryrun_batch(cfg, 2 * nd)
        ref_step = train_step_case(cfg, batch, device=device)
        # the eval program of one process on each data rank's rows, the
        # programs of the same shapes (a kernel's plan depends on its rows)
        ref_eval = [np.concatenate(parts) for parts in zip(*(
            eval_case(cfg, {k: v[2 * d:2 * d + 2] for k, v in batch.items()}, device=device)
            for d in range(nd)))]
        step, outs = ranks[0][i]
        m, m1 = step["metrics"][0], ref_step["metrics"][0]
        dloss = abs(m["loss"] - m1["loss"])
        dparams = _gap(step["params"], ref_step["params"])
        # the mask probabilities and the class logits, max|d| / max|ref| each;
        # the predicted classes equal
        deval = max(float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                    for a, b in (zip(outs[::2], ref_eval[::2])))
        if not np.array_equal(outs[1], ref_eval[1]):
            deval = float("inf")
        report.append({"mesh": (nd, nm), "loss": m["loss"], "dloss": dloss,
                       "dparams": dparams, "deval": deval})
        print(f"dryrun_multichip OK: mesh=(data={nd}, model={nm}) loss={m['loss']:.4f} "
              f"loss_mask={m['loss_mask']:.4f} loss_edge={m['loss_edge']:.4f} "
              f"| vs one process: dloss={dloss:.2e} dparams={dparams:.2e} deval={deval:.2e}"
              if dloss < DLOSS_BOUND and dparams < DPARAMS_BOUND and deval < DEVAL_BOUND
              else f"dryrun_multichip FAILED: mesh=(data={nd}, model={nm}) dloss={dloss:.2e} "
              f"dparams={dparams:.2e} deval={deval:.2e}", flush=True)
        if not (dloss < DLOSS_BOUND and dparams < DPARAMS_BOUND and deval < DEVAL_BOUND):
            raise AssertionError(f"mesh ({nd}, {nm}) departs from one process: dloss {dloss}, "
                                 f"dparams {dparams}, deval {deval}")
    return report


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                     sys.argv[2] if len(sys.argv) > 2 else "cpu")
