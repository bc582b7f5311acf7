"""Helpers of the port's checkpoint-interop tests (CPU, tiny config): the
reference's four file formats and both bank formats written from
numpy-seeded tensors, JAX's parameter init replaced by the port's seeded
random weights (so that the two packages start from the same weights and a
whole state dict can be compared bit for bit; JAX's own init of the tiny
cascade takes ~20 s), and a JAX CLI run up to its model assembly.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from camouflaged_vlm_tpu.cli import common as j_common
from camouflaged_vlm_tpu.io.convert import convert_cascade_checkpoint as j_convert_cascade
from camouflaged_vlm_tpu_torch.factory import build_cascade
from camouflaged_vlm_tpu_torch.io import synthetic
from camouflaged_vlm_tpu_torch.io.convert import state_dict_from_jax_params
from camouflaged_vlm_tpu_torch.models import CascadeConfig

FILE_SEED, CASCADE_SEED, TOKEN_SEED, BANK_SEED = 3, 5, 4, 6


def tiny_shapes():
    return {k: v.shape for k, v in build_cascade(CascadeConfig.tiny(), "cpu").state_dict().items()}


def write_reference_files(d, classes, test_classes=None) -> dict:
    """Every format under directory `d`, at the tiny config's shapes:
    sam.pth (fp32 stock SAM keys and two `prompt_encoder.*` extras),
    cascade.pth (a whole reference-layout state dict), clip.pt and
    clip_renamed.pt (OpenAI TorchScript archives in fp16 without
    conv1_alpha; `in_proj_weight`, or the renamed `in_proj.weight`),
    maple.pth.tar and maple_bare.pth.tar (dassl, wrapped and bare), and
    the banks bank.npy / bank.pth ((len(classes), embed_dim)) and, with
    `test_classes`, test_bank.npy."""
    cfg = CascadeConfig.tiny()
    shapes = tiny_shapes()
    src = synthetic.random_state_dict(shapes, FILE_SEED)
    rng = np.random.default_rng(TOKEN_SEED)
    tok = torch.from_numpy(rng.standard_normal(
        (cfg.clip.vocab_size, cfg.clip.transformer_width), dtype=np.float32) * np.float32(0.02))
    p = {k: os.path.join(str(d), k) for k in (
        "sam.pth", "cascade.pth", "clip.pt", "clip_renamed.pt", "maple.pth.tar",
        "maple_bare.pth.tar", "bank.npy", "bank.pth", "test_bank.npy")}
    torch.save(synthetic.sam_file_state_dict(src, cfg), p["sam.pth"])
    torch.save(synthetic.random_state_dict(shapes, CASCADE_SEED), p["cascade.pth"])
    for name, renamed in (("clip.pt", False), ("clip_renamed.pt", True)):
        synthetic.save_torchscript(synthetic.openai_clip_file_state_dict(
            src, cfg.clip, tok, in_proj_renamed=renamed), p[name])
    for name, wrapped in (("maple.pth.tar", True), ("maple_bare.pth.tar", False)):
        torch.save({"state_dict": synthetic.maple_file_state_dict(src, cfg.clip, wrapped),
                    "epoch": 7, "optimizer": {"state": {}, "param_groups": []}}, p[name])
    brng = np.random.default_rng(BANK_SEED)
    bank = lambda n: brng.standard_normal((n, cfg.clip.embed_dim)).astype(np.float32)  # noqa
    np.save(p["bank.npy"], bank(len(classes)))
    torch.save(torch.from_numpy(bank(len(classes))), p["bank.pth"])
    if test_classes is not None:
        np.save(p["test_bank.npy"], bank(len(test_classes)))
    return p


def same_init_in_jax(monkeypatch) -> None:
    """JAX's `init_cascade_params` (as `assemble_cascade` calls it) returns
    the port's seeded random fp32 weights of the same configuration."""
    def init(model, cfg, bank, seed=0):
        sd = build_cascade(CascadeConfig.tiny(), "cpu", seed).state_dict()
        tree, _, _ = j_convert_cascade({k: v.numpy() for k, v in sd.items()}, cfg)
        return {"params": tree}

    monkeypatch.setattr(j_common, "init_cascade_params", init)


def jax_state_dict(params) -> dict:
    """JAX's assembled params as the port's fp32 state dict."""
    import jax

    return state_dict_from_jax_params(jax.tree.map(np.asarray, params), CascadeConfig.tiny())


class Stop(Exception):
    pass


def run_jax_cli(jcli, argv, monkeypatch, stop_at="assemble_cascade") -> dict:
    """Run the JAX CLI module `jcli`'s main() with `argv` up to its model
    assembly: {"assembled": assemble_cascade's return value, "banks": the
    banks its bank builder made}; with `stop_at` another name of the module
    (train: make_mesh), the run goes on to that call."""
    same_init_in_jax(monkeypatch)
    seen = {"banks": []}

    def assemble(*a, **k):
        out = j_common.assemble_cascade(*a, **k)
        seen["assembled"] = out
        if k.get("return_bank_builder"):
            make_bank = out[-1]

            def recorded(*a2, **k2):
                seen["banks"].append(make_bank(*a2, **k2))
                return seen["banks"][-1]

            out = (*out[:-1], recorded)
        if stop_at == "assemble_cascade":
            raise Stop
        return out

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(jcli, "assemble_cascade", assemble)
    if stop_at != "assemble_cascade":
        monkeypatch.setattr(jcli, stop_at, stop)
    monkeypatch.setattr(sys, "argv", [jcli.__name__, *argv])
    # JAX's train CLI tries tensorboard's writer (a heavy import) and goes
    # on without one
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(Stop):
        jcli.main()
    return seen


def assert_state_equal(got: dict, want: dict, keys=None) -> None:
    """Bit-equal entries (in fp32) over `keys` (default: every key of both,
    which must agree)."""
    if keys is None:
        assert set(got) == set(want)
        keys = want
    for k in keys:
        np.testing.assert_array_equal(got[k].detach().float().numpy(),
                                      want[k].detach().float().numpy(), err_msg=k)


def assert_bank_equal(got: dict, want: dict) -> None:
    for k in ("prefix", "suffix", "eot_indices", "bank_features"):
        np.testing.assert_array_equal(np.asarray(got[k].cpu()), np.asarray(want[k]), err_msg=k)
