"""Full OVCamo split evaluation on the GPU.

Counterpart of `camouflaged_vlm_tpu/cli/evaluate.py` (the reference's
`test_ovcos_maskdecoder_edge.py`). Per image:

  * the stage-1 mask -> class-agnostic COD metrics (sm/em/wfm/mae) at the
    model's input size (1024 px);
  * stage-2 classification (alpha = the resized sigmoid mask) -> top-1,
    top-5 and macro-F1;
  * class-aware OVCOS metrics at the ORIGINAL mask size (zeroed on a class
    mismatch);
  * optionally the predicted masks as images.

Usage:
  python -m camouflaged_vlm_tpu_torch.cli.evaluate --dataset-info dataset_info.yaml \
      --config configs/ovcos-sam-vit-h-maskdecoder-edge.yaml --output-dir ./eval_out

`--config` takes a native or a reference-format yaml; the port ships SAM
ViT-B's (`camouflaged_vlm_tpu_torch/configs/ovcos-sam-vit-b-maskdecoder-edge.yaml`).
The checkpoint flags (`--sam-ckpt`, `--clip-ckpt`, `--maple-ckpt`,
`--cascade-ckpt`, `--text-bank`: the reference's files, `cli/common.py`)
set the weights and the test split's bank; what no file sets is random
(seeded by `--seed`). `--device cuda` (the default) on a host without a
card raises, and so does float32 on the card where the configuration's path
has a kernel with no fp32 instance (`common.refuse_fp32_on_card`).

On the card each `evaluate()` call captures the batch's whole program (the
uint8 upload, the normalisation, both cascade stages, the mask cast) once
as one CUDA graph and replays it per batch, the counterpart of the JAX
CLI's one jitted program (its `run`); a short last batch is padded by
repeating its last sample, and the pad rows are dropped.

Several cards (or CPU processes with `--device cpu`): run under torchrun,
one process a rank, with `--data-parallel` (every rank a data rank) and
`--n-model N` (tensor parallelism over groups of N ranks: the Megatron
rules of `parallel/sharding.py`), e.g.

  torchrun --nproc-per-node 4 -m camouflaged_vlm_tpu_torch.cli.evaluate \
      --dataset-info dataset_info.yaml --data-parallel --n-model 2 --batch-size 8

Each data rank runs its rows of each batch (the batch size must divide over
the data ranks) on its model shard; rank 0 gathers the probabilities and
logits, computes the metrics (equal to one device's) and writes the
results. Each rank captures its own CUDA graph. A tensor-parallel program
holds collectives, which a graph can capture only where they are NCCL's:
with `--n-model` > 1 on gloo (ranks that share a card, or the CPU) it runs
eagerly, and the log says so.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch
import yaml
from PIL import Image

from ..config import DTYPES
from ..data.loader import iter_eval_batches
from ..data.ovcamo import OVCamoIndex
from ..data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ONES_ALPHA_VALUE,
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
)
from ..factory import attach_rel_cache, build_cascade
from ..graphs import GraphedCall
from ..metrics import ClassificationEvaluator, CODMetrics, OVCOSMetricer
from ..parallel import check_tp_config, shard_model_
from ..parallel.mesh import all_gather, broadcast_object
from ..utils.image import bilinear_resize_f32
from .common import (
    Logger,
    add_checkpoint_flags,
    add_mesh_flags,
    cascade_config,
    device_or_raise,
    exact_fp32_on_card,
    fallback_line,
    load_checkpoints,
    mesh_from_args,
    preproc_line,
    refuse_fp32_on_card,
)

# batches dispatched before the oldest is drained
IN_FLIGHT = 3


def score_image(cod: CODMetrics, metricer: OVCOSMetricer, prob: np.ndarray, s,
                pre_cls: str, save_img_path: Optional[str] = None) -> None:
    """One image's host metric work: the COD metrics of `prob` (the model's
    1024 px probability map) against the sample's target, then the
    class-aware OVCOS metrics at the original mask size."""
    cod.step(prob, s.gt[:, :, 0])
    gt = np.asarray(Image.open(s.mask_path).convert("L"))
    h, w = gt.shape
    # the reference's order: resize the float probability (cv2
    # INTER_LINEAR semantics), then truncate to uint8
    pred_full = (bilinear_resize_f32(prob, h, w) * 255).astype(np.uint8)
    metricer.step(pre=pred_full, gt=gt, pre_cls=pre_cls, gt_cls=s.label_name,
                  gt_path=s.mask_path)
    if save_img_path:
        Image.fromarray(pred_full).save(
            os.path.join(save_img_path, f"[{pre_cls}]{os.path.basename(s.mask_path)}"))


def rank_samples(index: OVCamoIndex, batch_size: int, n_data: int, data_rank: int) -> list:
    """A data rank's samples: its rows [d B/n, (d+1) B/n) of every batch of
    `batch_size`, the short last batch padded by repeating its last sample
    first (as `evaluate` pads it)."""
    rows, out = batch_size // n_data, []
    for i in range(0, len(index.samples), batch_size):
        batch = index.samples[i:i + batch_size]
        batch = batch + [batch[-1]] * (batch_size - len(batch))
        out += batch[data_rank * rows:(data_rank + 1) * rows]
    return out


@torch.no_grad()
def evaluate(model, cfg, bank, index: OVCamoIndex, batch_size: int = 4,
             save_img_path: Optional[str] = None, num_workers: int = 8,
             oracle_cls: bool = False, mask_dtype: str = "float16",
             graph: bool = True, mesh=None, log=print) -> dict:
    """Run the full OVCOS evaluation of `model` (on its device) over
    `index`; `bank` is the split's class bank (`factory.make_bank_inputs`).
    `oracle_cls=True` scores the class-aware metrics with the ground-truth
    class (segmentation quality alone). Returns the JAX package's results
    dict: the OVCOS metrics, ori_sm/em/wfm/mae, accuracy/error_rate/top5/
    macro_f1, images and images_per_sec (metric drain included).

    Every batch runs at `batch_size`: a short last batch is padded by
    repeating its last sample (as the server pads its buckets) and the pad
    rows are dropped before anything reads them. On a card the call (the
    uint8 upload through the graph's static inputs, the normalisation, the
    cascade and the cast to `mask_dtype`) is captured once as one CUDA graph
    (`graphs.GraphedCall`, its warm-up calls replacing the eager warm-up),
    which lives until this function returns: the rel tables attached here
    are new tensors every call. `graph=False` runs each batch eagerly (the
    same rows; on the CPU the call is eager either way).

    With a `mesh` (`parallel.make_mesh`; `model` sharded over its model
    group) every rank calls this: each data rank runs its rows of every
    batch (batch_size must divide over the data ranks), rank 0 gathers the
    outputs and computes the metrics, and every rank returns rank 0's
    results. A tensor-parallel program runs eagerly where its collectives
    cannot be captured (gloo), with a line to `log`."""
    device = next(model.parameters()).device
    n_data = mesh.n_data if mesh is not None else 1
    main = mesh is None or mesh.is_main
    if batch_size % n_data:
        raise ValueError(f"batch size {batch_size} does not divide over {n_data} data ranks")
    rows = batch_size // n_data
    if graph and device.type == "cuda" and mesh is not None and not mesh.capturable:
        graph = False
        if main:
            log(f"[eval] n_model={mesh.n_model} on {mesh.backend}: the tensor-parallel "
                "program runs eagerly (its collectives cannot be captured in a CUDA graph)")
    classnames = index.classes
    # the weights are fixed for the whole run: the rel tables once, from the
    # current weights (so a validation inside training caches its own)
    attach_rel_cache(model)
    # the class-split text features, once
    text_features = model.encode_class_text_features(
        bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"])
    consts = {k: torch.from_numpy(v).to(device) for k, v in (
        ("mean", IMAGENET_MEAN), ("std", IMAGENET_STD),
        ("cmean", OPENAI_CLIP_MEAN), ("cstd", OPENAI_CLIP_STD))}
    out_dt = torch.float16 if mask_dtype == "float16" else torch.float32

    def body(inp_u8: torch.Tensor, cimg_u8: torch.Tensor):
        # uint8 on the device (a quarter of the fp32 bytes), then /255 and the
        # normalisation there, in the host transforms' fp32 op order
        inp = (inp_u8.float() / 255.0 - consts["mean"]) / consts["std"]
        cimg = (cimg_u8.float() / 255.0 - consts["cmean"]) / consts["cstd"]
        cmask = torch.full((inp.shape[0], cfg.clip_size, cfg.clip_size, 1),
                           ONES_ALPHA_VALUE, device=device)
        probs, pred, score = model.infer_cascade_with_text(inp, cimg, cmask, text_features)
        # fp16 by default halves the device->host mask bytes; its ~3e-4
        # resolution is finer than the 256-bin threshold metrics
        return probs.to(out_dt), pred, score

    cod = CODMetrics()
    metricer = OVCOSMetricer(class_names=classnames, num_workers=num_workers)
    clf = ClassificationEvaluator(class_names=classnames)
    if save_img_path and main:
        os.makedirs(save_img_path, exist_ok=True)

    shapes = ((rows, cfg.inp_size, cfg.inp_size, 3),
              (rows, cfg.clip_size, cfg.clip_size, 3))
    if graph:
        # the capture before the clock: its eager warm-ups build and load the
        # kernels and warm the allocator; the uint8 host batches are copied
        # into its static inputs at every replay
        graphed = GraphedCall(body, *(torch.zeros(s, dtype=torch.uint8, device=device)
                                      for s in shapes))

        def run_rows(inp_u8: np.ndarray, cimg_u8: np.ndarray):
            outs = graphed(torch.from_numpy(inp_u8), torch.from_numpy(cimg_u8))
            # the next replay overwrites the static outputs (and a float32
            # probs.to() is probs itself): copies, queued before it
            return tuple(t.clone() for t in outs)
    else:
        def run_rows(inp_u8: np.ndarray, cimg_u8: np.ndarray):
            return body(*(torch.from_numpy(a).to(device, non_blocking=True)
                          for a in (inp_u8, cimg_u8)))

        # one call before the clock: the kernels' build and load, allocator warm-up
        [t.cpu() for t in run_rows(*(np.zeros(s, np.uint8) for s in shapes))]
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def run(inp_u8: np.ndarray, cimg_u8: np.ndarray):
        """The batch's outputs: this rank's rows, then (on a data-parallel
        mesh) every data rank's gathered in rank order."""
        outs = run_rows(inp_u8, cimg_u8)
        if n_data == 1:
            return outs
        return tuple(torch.cat(all_gather(t, mesh.data_group)) for t in outs)

    n_done = 0
    t0 = time.time()
    # every per-image host metric runs in this pool; each queued job pins a
    # full-size probability map, so the queue is bounded
    metric_pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
    metric_futures: deque = deque()
    max_metric_queue = 4 * max(num_workers, 1)

    def consume(outs, batch):
        nonlocal n_done
        n = len(batch)  # the rows past it are padding
        probs = outs[0][:n].float().cpu().numpy()[:, :, :, 0]
        pred = outs[1][:n].cpu().numpy()
        clf.process(outs[2][:n].float().cpu().numpy(), np.asarray([s.label_id for s in batch]))
        for i, s in enumerate(batch):
            pre_cls = s.label_name if oracle_cls else classnames[int(pred[i])]
            metric_futures.append(metric_pool.submit(score_image, cod, metricer, probs[i], s,
                                                     pre_cls, save_img_path))
            if len(metric_futures) > max_metric_queue:
                metric_futures.popleft().result()
        n_done += n

    # pipelined: up to IN_FLIGHT batches are queued on the device before the
    # oldest is drained, so its copy back and metric fan-out overlap the
    # device's work on the next ones (on a data-parallel mesh the gather
    # waits for each batch)
    pending: deque = deque()
    in_flight = IN_FLIGHT if n_data == 1 else 1
    if main:  # whole batches: this rank's rows are their first
        batches = iter_eval_batches(index, batch_size, cfg.inp_size, cfg.clip_size,
                                    num_workers, raw_uint8=True)
    else:  # this rank's rows only; no metrics here
        mine = dataclasses.replace(index, samples=rank_samples(index, batch_size, n_data,
                                                               mesh.data_rank))
        batches = iter_eval_batches(mine, rows, cfg.inp_size, cfg.clip_size, num_workers,
                                    raw_uint8=True)
    for batch in batches:
        padded = (batch + [batch[-1]] * (batch_size - len(batch)))[:rows]
        inp = np.stack([s.inp for s in padded])
        cimg = np.stack([s.clip_image for s in padded])
        outs = run(inp, cimg)
        if not main:
            continue
        pending.append((outs, batch))
        if len(pending) > in_flight - 1:
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())
    while metric_futures:
        metric_futures.popleft().result()  # surfaces worker exceptions
    metric_pool.shutdown(wait=True)
    graphed = None  # the graph and its memory pool go before the caller continues

    results = None
    if main:
        ovcos = metricer.show()
        ori_sm, ori_em, ori_wfm, ori_mae = cod.results()
        elapsed = time.time() - t0  # includes the metric drain
        cls_res = clf.evaluate()
        results = {
            **ovcos,
            "ori_sm": round(ori_sm, 4),
            "ori_em": round(ori_em, 4),
            "ori_wfm": round(ori_wfm, 4),
            "ori_mae": round(ori_mae, 4),
            **{k: round(v, 2) for k, v in cls_res.items()},
            "images": n_done,
            "images_per_sec": round(n_done / elapsed, 3),
        }
    return results if mesh is None else broadcast_object(results)


def parse_args(argv: Sequence[str] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset-info", required=True, help="OVCamo dataset_info yaml")
    p.add_argument("--config", default=None,
                   help="model config yaml (native or the reference's format)")
    p.add_argument("--split", default="test")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--output-dir", default="./eval_results")
    p.add_argument("--save-images", action="store_true")
    add_checkpoint_flags(p)
    p.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                   help="compute type; default the config's (bfloat16 without --config)")
    p.add_argument("--mask-dtype", default="float16", choices=["float16", "float32"],
                   help="device->host probability type (float16 halves the bytes)")
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke runs)")
    p.add_argument("--oracle-cls", action="store_true",
                   help="score the class-aware metrics with the ground-truth class")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    add_mesh_flags(p)
    return p.parse_args(argv)


def load(args: argparse.Namespace, mesh=None):
    """The CLI's model (sharded over `mesh`'s model group), configuration,
    test-split bank, index and logger, from parsed arguments: (model, cfg,
    bank, index, log)."""
    cfg = cascade_config(args.config, args.tiny, args.dtype)
    check_tp_config(cfg, mesh.n_model if mesh is not None else 1)
    refuse_fp32_on_card(args.device, cfg)
    device = mesh.device if mesh is not None else device_or_raise(args.device)
    exact_fp32_on_card(args.device, cfg)
    os.makedirs(args.output_dir, exist_ok=True)
    log = Logger(args.output_dir, quiet=not (mesh is None or mesh.is_main))

    with open(args.dataset_info) as f:
        dataset_info = yaml.safe_load(f)
    index = OVCamoIndex.from_dataset_info(dataset_info, args.split)
    log(f"[eval] {len(index)} samples, {len(index.classes)} classes ({args.split}); SAM "
        f"{cfg.encoder.embed_dim} wide x {cfg.encoder.depth} blocks, "
        f"{cfg.encoder.num_heads} heads, attn_impl={cfg.encoder.attn_impl!r}")
    model = build_cascade(cfg, device, args.seed)
    make_bank = load_checkpoints(model, cfg, clip_ckpt=args.clip_ckpt,
                                 maple_ckpt=args.maple_ckpt, sam_ckpt=args.sam_ckpt,
                                 cascade_ckpt=args.cascade_ckpt, seed=args.seed, log=log)
    bank = make_bank(index.classes, args.text_bank)
    shard_model_(model, mesh)
    return model, cfg, bank, index, log


def main(argv: Sequence[str] = None) -> dict:
    """Evaluate and write <output-dir>/results.json (rank 0 on a mesh);
    return the results."""
    args = parse_args(argv)
    mesh = mesh_from_args(args)
    model, cfg, bank, index, log = load(args, mesh)
    log(preproc_line("eval"))
    if mesh is not None:
        log(f"[eval] mesh data={mesh.n_data} x model={mesh.n_model} ({mesh.backend})")
    save_path = os.path.join(args.output_dir, "result_image") if args.save_images else None
    results = evaluate(model, cfg, bank, index, batch_size=args.batch_size,
                       save_img_path=save_path, oracle_cls=args.oracle_cls,
                       mask_dtype=args.mask_dtype, mesh=mesh, log=log)
    log(fallback_line("eval"))
    if mesh is None or mesh.is_main:
        log(json.dumps(results, indent=2))
        with open(os.path.join(args.output_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
