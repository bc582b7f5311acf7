"""What each rank of `tests/test_torch_parallel.py`'s process groups runs.

A module of its own, importing torch and the port only (no jax, no
conftest), so that the spawned ranks start fast; the test module computes
the one-process references and compares. Every function here runs on every
rank of the group (`graft_entry_torch.spawn_ranks`) and returns what rank 0
reports.
"""

import dataclasses
import os

import numpy as np
import torch

import graft_entry_torch as g
from camouflaged_vlm_tpu_torch.models import CascadeConfig
from camouflaged_vlm_tpu_torch.parallel import make_mesh

CLASSNAMES = ["cat", "owl", "bat", "moth"]
# (n_data, n_model, train_step_case options, remat) of the two-rank step cases
STEP_CASES = {
    "dp": (2, 1, {}, False),
    "tp": (1, 2, {}, False),
    "dp_accum2": (2, 1, {"accum": 2}, False),
    "dp_bbce": (2, 1, {"loss": "bbce"}, False),
    "tp_remat": (1, 2, {}, True),
}
STEP_ROWS = 4


def tiny(remat: bool = False):
    cfg = CascadeConfig.tiny()
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, remat=remat))


def rand_requests(cfg, n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, cfg.inp_size, cfg.inp_size, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, cfg.clip_size, cfg.clip_size, 3), dtype=np.uint8))


def stepper(model, mesh, batch, restore=None):
    """(optimizer, first step index, step(i)) for an already built (and
    sharded) `model` on this rank's rows of `batch`, the weights and the
    optimizer state first restored from the checkpoint `restore` if given."""
    from camouflaged_vlm_tpu_torch.factory import attach_rel_cache, make_bank_inputs
    from camouflaged_vlm_tpu_torch.io.checkpoint import restore_checkpoint
    from camouflaged_vlm_tpu_torch.parallel import batch_rows
    from camouflaged_vlm_tpu_torch.train import (
        SCANNED_BATCH_KEYS, cosine_epoch_schedule, make_optimizer, make_train_step,
        trainable_parameters,
    )

    opt = make_optimizer(trainable_parameters(model))
    start = restore_checkpoint(restore, model, opt, mesh) if restore else 0
    attach_rel_cache(model)  # after the weights are final
    bank = make_bank_inputs(model.cfg, g.TEST_CLASSNAMES_SMALL)
    text = model.encode_class_text_features(bank["prefix"], bank["suffix"],
                                            bank["eot_indices"], bank["bank_features"])
    step = make_train_step(model, opt, cosine_epoch_schedule(2e-4, 20), "iou", 1, mesh=mesh)
    tb = {k: batch_rows(torch.from_numpy(batch[k]), mesh).contiguous()
          for k in SCANNED_BATCH_KEYS}
    return opt, start, lambda i: step({**tb, "text_features": text}, i)


def resume_case(path: str):
    """One step on a (2, 1) mesh and its checkpoint, then the checkpoint
    restored on a (1, 2) mesh (into a model of other weights) and a second
    step: the trainable parameters after it, gathered."""
    from camouflaged_vlm_tpu_torch.factory import build_cascade
    from camouflaged_vlm_tpu_torch.io.checkpoint import save_checkpoint
    from camouflaged_vlm_tpu_torch.parallel import shard_model_
    from camouflaged_vlm_tpu_torch.parallel.sharding import gather_state_dict

    cfg, batch = tiny(), g.dryrun_batch(tiny(), STEP_ROWS)
    mesh = make_mesh(2, 1)
    model = build_cascade(cfg, "cpu", 0)
    opt, _, step = stepper(model, mesh, batch)
    step(0)
    save_checkpoint(path, model, opt, 1, mesh)
    mesh = make_mesh(1, 2)
    model = shard_model_(build_cascade(cfg, "cpu", 1), mesh)
    _, start, step = stepper(model, mesh, batch, restore=path)
    step(start)
    full = gather_state_dict(model, mesh)
    return {"start": start, "params": {n: full[n].numpy() for n, p in model.named_parameters()
                                       if p.requires_grad}}


def evaluate_case(info: str, n_data: int, n_model: int):
    from camouflaged_vlm_tpu_torch.cli.evaluate import evaluate
    from camouflaged_vlm_tpu_torch.data.ovcamo import OVCamoIndex
    from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs
    from camouflaged_vlm_tpu_torch.parallel import shard_model_
    import yaml

    mesh = make_mesh(n_data, n_model)
    cfg = tiny()
    with open(info) as f:
        index = OVCamoIndex.from_dataset_info(yaml.safe_load(f), "test")
    model = shard_model_(build_cascade(cfg, "cpu", 0), mesh)
    bank = make_bank_inputs(cfg, index.classes)
    return evaluate(model, cfg, bank, index, batch_size=2, num_workers=2, mesh=mesh,
                    log=lambda m: None)


def engine_case():
    """Four requests through a (2, 1) engine's bucket of 4 (rank 1
    follows): the results and the engine's batch count."""
    from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs
    from camouflaged_vlm_tpu_torch.serve import InferenceEngine, ServeConfig

    mesh = make_mesh(2, 1)
    cfg = tiny()
    eng = InferenceEngine(build_cascade(cfg, "cpu", 0), cfg, make_bank_inputs(cfg, CLASSNAMES),
                          CLASSNAMES, ServeConfig(buckets=(2, 4), max_delay_ms=500.0),
                          mesh=mesh)
    if not mesh.is_main:
        eng.follow()
        return None
    try:
        eng.warmup()
        inp, cimg = rand_requests(cfg, 4)
        futs = [eng.submit(inp[i], cimg[i]) for i in range(4)]
        results = [f.result(timeout=120) for f in futs]
        return {"results": results, "batches": eng.stats()["batches"]}
    finally:
        eng.close()


def train_cli_args(info: str, save_dir: str):
    return ["--dataset-info", info, "--tiny", "--device", "cpu", "--dtype", "float32",
            "--epochs", "1", "--batch-size", "2", "--epoch-val", "1", "--save-dir", save_dir]


class WriterStub:
    """Stands in for the CLI's TensorBoard writer (whose import takes
    seconds): records where it was made and what it was given."""

    def __init__(self, path):
        self.path, self.scalars = path, []

    def add_scalar(self, *a):
        self.scalars.append(a)

    def close(self):
        pass


def train_cli_case(info: str, save_dir: str):
    """The train CLI with --distributed on the group (a (2, 1) mesh): the
    trainable parameters after its epoch, and the writers it made."""
    from camouflaged_vlm_tpu_torch.cli import train as cli

    writers = []
    cli.tensorboard_writer = lambda path: writers.append(WriterStub(path)) or writers[-1]
    out = cli.main(train_cli_args(info, save_dir) + ["--distributed"])
    model = out["model"]
    return {"params": {n: p.detach().numpy() for n, p in model.named_parameters()
                       if p.requires_grad},
            "val_mae": out["validations"][0]["mae"], "mesh": repr(out["mesh"]),
            "writers": [len(w.scalars) for w in writers]}



def two_rank_cases(work: str, info: str) -> dict:
    """Every two-rank case, in one group."""
    out = {}
    for key, (nd, nm, kw, remat) in STEP_CASES.items():
        cfg = tiny(remat)
        out[key] = g.train_step_case(cfg, g.dryrun_batch(cfg, STEP_ROWS), make_mesh(nd, nm),
                                     **kw)
    out["resume"] = resume_case(os.path.join(work, "ckpt_resume.pt"))
    out["evaluate_dp"] = evaluate_case(info, 2, 1)
    out["evaluate_tp"] = evaluate_case(info, 1, 2)
    out["engine"] = engine_case()
    out["train_cli"] = train_cli_case(info, os.path.join(work, "cli"))
    return out


def four_rank_step(cfg, batch, state) -> dict:
    """The (2, 2) train step of a cascade holding `state`."""
    return g.train_step_case(cfg, batch, make_mesh(2, 2), classnames=CLASSNAMES, state=state)
