"""The PyTorch port's training path against the JAX package, on the CPU.

Losses, the freeze rule, AdamW with the per-epoch cosine, and the whole
train slice: an 8-head SAM on 'flash' (grid 5, window 2: right, bottom and
corner edge windows), the edge decoder and an 8-head CLIP, the same
numpy-drawn parameters in both packages. On the CPU the port's kernel
Functions run their plain forwards and plain backwards, so the slice test
holds the hand-written backward formulas (the fused MLP, the windowed and
the global attention) inside the whole step against JAX's
`value_and_grad`. Then the port's own equalities (the prompt-bank path
against the hoisted text features, accumulation against the full batch)
and the train CLI (one epoch, resume, the yaml's recipe against JAX's CLI,
validation inside the run, the test-split text conditioning, its refusals).

Tolerances: losses and pooling 1e-6 (fp32 both sides, a few reductions);
AdamW 1e-6 relative (elementwise, the same formulas); the slice's loss
1e-5 and its gradients 1e-4 relative with an absolute floor of 1e-4 of the
leaf's largest magnitude plus 1e-8 (as the JAX package's own gradient
equality, `tests/test_train.py`), since fp32 summation orders differ
through four blocks, the decoder and the backward; port-internal
equalities 1e-6.
"""

import dataclasses
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import traverse_util  # noqa: E402

from camouflaged_vlm_tpu import train as jtrain  # noqa: E402
from camouflaged_vlm_tpu.factory import make_bank_inputs as j_make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu.models import CascadeConfig as JCascadeConfig  # noqa: E402
from camouflaged_vlm_tpu.models import OVCOSCascade as JCascade  # noqa: E402
from camouflaged_vlm_tpu.models import sam_encoder as j_sam  # noqa: E402
from camouflaged_vlm_tpu.models.clip import AlphaClipConfig as JClipConfig  # noqa: E402
from camouflaged_vlm_tpu.train.train_step import combine_params, partition_params  # noqa: E402

from camouflaged_vlm_tpu_torch import train  # noqa: E402
from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu_torch.io.convert import (  # noqa: E402
    _inverse_transform,
    cascade_key_map,
    load_jax_params,
    state_dict_from_jax_params,
)
from camouflaged_vlm_tpu_torch.models import CascadeConfig, SamEncoderConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig  # noqa: E402

T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
J = jnp.asarray
CLASSES = ["cat", "owl", "bat", "moth"]
ENC_8 = dict(img_size=80, embed_dim=64, num_heads=8, prompt_scale_factor=8)
CLIP_8x16 = dict(vision_width=128, vision_heads=8)


def close(got, want, rtol, floor=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max() + floor)


# ------------------------------------------------------------------ losses


def _loss_inputs(rng):
    logits = rng.standard_normal((2, 12, 12, 1)).astype(np.float32) * 2
    gt = (rng.random((2, 12, 12, 1)) > 0.6).astype(np.float32)
    probs = rng.random((2, 12, 12, 1)).astype(np.float32)
    return logits, gt, probs


@pytest.mark.parametrize("name", ["bce_with_logits", "balanced_bce_with_logits",
                                  "soft_iou_loss", "soft_dice_loss", "edge_dice_loss"])
def test_loss_matches_jax(rng, name):
    logits, gt, probs = _loss_inputs(rng)
    first = probs if "dice" in name else logits
    got = getattr(train, name)(T(first), T(gt))
    want = getattr(jtrain, name)(J(first), J(gt))
    close(got, want, 1e-6)


@pytest.mark.parametrize("mode", ["iou", "bce", "bbce"])
def test_segmentation_loss_matches_jax(rng, mode):
    logits, gt, probs = _loss_inputs(rng)
    total, parts = train.segmentation_loss(T(logits), T(probs), T(gt), mode)
    jtotal, jparts = jtrain.segmentation_loss(J(logits), J(probs), J(gt), mode)
    close(total, jtotal, 1e-6)
    for k in jparts:
        close(parts[k], jparts[k], 1e-6)


def test_edge_target_is_detached(rng):
    """The ground truth reaches the loss through the mask terms only: the
    morphological edge target carries no gradient."""
    logits, gt, probs = _loss_inputs(rng)
    gt_t = T(gt).requires_grad_(True)
    _, parts = train.segmentation_loss(T(logits), T(probs).requires_grad_(True), gt_t)
    assert torch.autograd.grad(parts["loss_edge"], gt_t, allow_unused=True,
                               retain_graph=True)[0] is None
    assert torch.autograd.grad(parts["loss_mask"], gt_t)[0] is not None


# ---------------------------------------------------------------- optimizer


def rnd_f(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_cosine_schedule_matches_jax():
    j = jtrain.cosine_epoch_schedule(2e-4, total_epochs=5, steps_per_epoch=3, eta_min=1e-7)
    s = train.cosine_epoch_schedule(2e-4, total_epochs=5, steps_per_epoch=3, eta_min=1e-7)
    for step in range(0, 20):
        assert abs(s(step) - float(j(step))) <= 1e-6 * s(step)  # JAX evaluates in fp32


def test_adamw_with_schedule_matches_optax(rng):
    shapes = [(6, 5), (7,), (3, 2, 4)]
    params = [rnd_f(rng, s) for s in shapes]
    grads = [[rnd_f(rng, s) for s in shapes] for _ in range(3)]
    sched = train.cosine_epoch_schedule(2e-3, total_epochs=3, steps_per_epoch=1, eta_min=1e-6)
    tx = optax.adamw(jtrain.cosine_epoch_schedule(2e-3, total_epochs=3, steps_per_epoch=1,
                                                  eta_min=1e-6), weight_decay=0.01)
    jp = [J(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(T(p)) for p in params]
    opt = train.make_optimizer(tp, base_lr=2e-3, weight_decay=0.01)
    for step, g in enumerate(grads):
        updates, state = tx.update([J(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for group in opt.param_groups:
            group["lr"] = sched(step)
        for p, x in zip(tp, g):
            p.grad = T(x)
        opt.step()
        for p, want in zip(tp, jp):
            close(p, want, 1e-6)


# --------------------------------------------------------------- the slice


def random_params(shapes, seed=0):
    """numpy params over an eval_shape tree: LayerNorm scales near 1, the
    logit scale at its init, everything else N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        name = str(path[-1].key)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)
        if name == "logit_scale":
            return np.full(sd.shape, np.log(1 / 0.07), np.float32)
        return (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def slice_pair():
    """The train slice in both packages: 8-head 'flash' SAM with edge and
    corner windows, same parameters, the same batch and text features."""
    jenc = j_sam.SamEncoderConfig.tiny(attn_impl="flash", **ENC_8)
    jcfg = dataclasses.replace(JCascadeConfig.tiny(), inp_size=jenc.img_size, encoder=jenc,
                               clip=JClipConfig.tiny(**CLIP_8x16))
    jmodel = JCascade(jcfg)
    jbank = j_make_bank_inputs(jcfg, CLASSES, seed=3)
    bank = (jbank["prefix"], jbank["suffix"], jbank["eot_indices"], jbank["bank_features"])
    rng = np.random.default_rng(1)
    B, S, C = 2, jcfg.inp_size, jcfg.clip_size
    yy, xx = np.mgrid[:S, :S]
    gt = np.stack([((yy - 30 - 10 * i) ** 2 + (xx - 40) ** 2 < 400) for i in range(B)])
    batch = {
        "inp": rng.standard_normal((B, S, S, 3)).astype(np.float32),
        "clip_image": rng.standard_normal((B, C, C, 3)).astype(np.float32),
        "clip_mask": np.full((B, C, C, 1), 1.923, np.float32),
        "gt": gt[..., None].astype(np.float32),
    }
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, batch["inp"], batch["clip_image"], batch["clip_mask"], *bank,
                              method=jmodel.infer_cascade),
        jax.random.PRNGKey(0),
    )
    params = random_params(shapes, seed=2)
    cfg = dataclasses.replace(CascadeConfig.tiny(), inp_size=jenc.img_size,
                              encoder=SamEncoderConfig.tiny(attn_impl="flash", **ENC_8),
                              clip=AlphaClipConfig.tiny(**CLIP_8x16))
    model = build_cascade(cfg, "cpu")
    load_jax_params(model, params, cfg)
    return jcfg, jmodel, params, cfg, model, bank, batch


def test_trainable_set_matches_jax_freeze_rule(slice_pair):
    """The port's trainable parameters are exactly JAX's 'train' leaves,
    by the converter's key names; pe_layer is a frozen buffer in both."""
    _, _, params, cfg, model, _, _ = slice_pair
    labels = traverse_util.flatten_dict(jtrain.trainable_mask(params)["params"])
    trainable = {n for n, p in model.named_parameters() if train.optim.is_trainable(n)}
    for tk, fp, _ in cascade_key_map(cfg):
        assert (labels[tuple(fp.split("/"))] == "train") == (tk in trainable), tk
    assert labels[("pe_layer", "positional_encoding_gaussian_matrix")] == "freeze"
    names = dict(model.named_parameters())
    assert "pe_layer.positional_encoding_gaussian_matrix" not in names
    params_t = train.trainable_parameters(model)
    assert {id(p) for p in params_t} == {id(names[n]) for n in trainable}
    assert all(p.requires_grad == (n in trainable) for n, p in model.named_parameters())
    assert any(n.startswith("image_encoder.prompt_generator.") for n in trainable)
    assert not any(n.startswith(("image_encoder.blocks.", "clip_model.")) for n in trainable)


def _torch_loss_and_grads(model, batch, text_features, bank=None):
    params = train.trainable_parameters(model)
    for p in params:
        p.grad = None
    args = (T(batch["inp"]), T(batch["clip_image"]), T(batch["clip_mask"]))
    if bank is None:
        masks, edges = model.forward_with_text(*args, text_features)
    else:
        masks, edges = model(*args, *bank)
    total, parts = train.segmentation_loss(masks, edges, T(batch["gt"]))
    total.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters() if p.requires_grad}
    return total.detach(), grads


def _check_step_against_jax(jmodel, params, bank, cfg, model, batch):
    """Loss and every trainable gradient of forward_with_text + the loss:
    the port's `model` against `jmodel`'s value_and_grad on the same
    parameters (loss 1e-5, gradients 1e-4 with the floor)."""
    jtf = jmodel.apply(params, *bank, method=jmodel.encode_class_text_features)
    trainable, frozen = partition_params(jax.tree.map(jnp.asarray, params))

    def loss(t):
        masks, edges = jmodel.apply(combine_params(t, frozen), batch["inp"],
                                    batch["clip_image"], batch["clip_mask"], jtf,
                                    method=jmodel.forward_with_text)
        return jtrain.segmentation_loss(masks, edges, batch["gt"], "iou")[0]

    jl, jg = jax.jit(jax.value_and_grad(loss))(trainable)
    tbank = make_bank_inputs(cfg, CLASSES, seed=3)
    tf = model.encode_class_text_features(tbank["prefix"], tbank["suffix"],
                                          tbank["eot_indices"], tbank["bank_features"])
    close(tf, jtf, 1e-5)
    total, grads = _torch_loss_and_grads(model, batch, tf)
    close(total, jl, 1e-5)
    seen = 0
    for tk, fp, kind in cascade_key_map(cfg):
        key = ("params",) + tuple(fp.split("/"))
        assert (key in jg) == (tk in grads), tk
        if tk in grads:
            want = _inverse_transform(kind, np.asarray(jg[key], np.float32))
            close(grads[tk], want, 1e-4, floor=1e-8)
            seen += 1
    assert seen == len(grads) > 40
    return grads


def test_train_slice_loss_and_grads_match_jax(slice_pair):
    """Loss and every trainable gradient of forward_with_text + the loss:
    the port (its kernels' plain backwards on the CPU) against JAX."""
    _, jmodel, params, cfg, model, bank, batch = slice_pair
    grads = _check_step_against_jax(jmodel, params, bank, cfg, model, batch)
    # the gradient reaches the encoder's prompt generator through every block
    pg = grads["image_encoder.prompt_generator.lightweight_mlp_0.0.weight"]
    assert float(pg.abs().max()) > 1e-6


def test_bank_path_matches_hoisted_text_features(slice_pair):
    """`forward` (the prompt bank inside the step) and `forward_with_text`
    (text features encoded once) give the same loss and gradients."""
    _, _, _, cfg, model, _, batch = slice_pair
    tbank = make_bank_inputs(cfg, CLASSES, seed=3)
    bank = (tbank["prefix"], tbank["suffix"], tbank["eot_indices"], tbank["bank_features"])
    tf = model.encode_class_text_features(*bank)
    l1, g1 = _torch_loss_and_grads(model, batch, tf)
    l2, g2 = _torch_loss_and_grads(model, batch, None, bank=bank)
    close(l2, l1.numpy(), 1e-6)
    assert set(g1) == set(g2)
    for k in g1:
        close(g2[k], g1[k].numpy(), 1e-6, floor=1e-12)


def test_accumulation_matches_full_batch(slice_pair):
    """One step with accum_steps=2 moves the parameters as the full batch
    does (SGD with lr 1, so the update is the averaged gradient itself)."""
    _, _, _, cfg, model, _, batch = slice_pair
    tbank = make_bank_inputs(cfg, CLASSES, seed=3)
    tf = model.encode_class_text_features(tbank["prefix"], tbank["suffix"],
                                          tbank["eot_indices"], tbank["bank_features"])
    start = {k: v.clone() for k, v in model.state_dict().items()}
    deltas, losses = [], []
    for accum in (1, 2):
        model.load_state_dict(start)
        params = train.trainable_parameters(model)
        opt = torch.optim.SGD(params, lr=1.0)
        step = train.make_train_step(model, opt, lambda s: 1.0, "iou", accum)
        tb = {k: T(v) for k, v in batch.items()}
        if accum > 1:
            tb = {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))
                  for k, v in tb.items()}
        m = step({**tb, "text_features": tf}, 0)
        losses.append(float(m["loss"]))
        deltas.append({n: (p.detach() - start[n]) for n, p in model.named_parameters()
                       if p.requires_grad})
    model.load_state_dict(start)
    assert abs(losses[0] - losses[1]) < 1e-6 * abs(losses[0])
    for k in deltas[0]:
        # the update is read back as p_after - p_before: exact up to the
        # rounding of p itself, so the floor is a few ulp of |p|
        ulp = float(np.finfo(np.float32).eps) * float(start[k].abs().max())
        close(deltas[1][k], deltas[0][k].numpy(), 1e-5, floor=4 * ulp)
    with pytest.raises(ValueError, match="leading dim"):
        train.make_train_step(model, opt, lambda s: 1.0, "iou", 3)(
            {**{k: T(v) for k, v in batch.items()}, "text_features": tf}, 0)


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def synthetic_dataset(tmp_path_factory):
    from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo

    root = tmp_path_factory.mktemp("ovcamo")
    return write_synthetic_ovcamo(str(root), sizes=((60, 80), (64, 64), (90, 70)))


def _cli(info, save_dir, *extra):
    from camouflaged_vlm_tpu_torch.cli import train as cli

    return cli.main(["--dataset-info", info, "--tiny", "--device", "cpu", "--dtype", "float32",
                     "--epochs", "2", "--batch-size", "2", "--epoch-val", "3", "--save-dir",
                     str(save_dir), *extra])


@pytest.mark.parametrize("epoch_val", ["3", "1"])
def test_train_cli_epoch_then_resume_equals_uninterrupted(synthetic_dataset, tmp_path,
                                                          epoch_val):
    """With --epoch-val 1 the stop epoch is a validation epoch: the cut run
    validates it before it exits, the resumed run the next one, as the
    uninterrupted run does both."""
    full = _cli(synthetic_dataset, tmp_path / "full", "--epoch-val", epoch_val)
    assert full["step"] == 6 and len(full["epochs"]) == 2
    assert all(np.isfinite(v) for e in full["epochs"] for v in e.values())
    first = _cli(synthetic_dataset, tmp_path / "cut", "--stop-after-epoch", "1",
                 "--epoch-val", epoch_val)
    assert first["step"] == 3 and (tmp_path / "cut" / "ckpt_last.pt").exists()
    frozen = {k: v.clone() for k, v in first["model"].state_dict().items()
              if not train.optim.is_trainable(k)}
    resumed = _cli(synthetic_dataset, tmp_path / "cut", "--resume", "--epoch-val", epoch_val)
    assert resumed["step"] == 6 and len(resumed["epochs"]) == 1
    a, b = full["model"].state_dict(), resumed["model"].state_dict()
    for k in a:
        close(b[k], a[k].numpy(), 1e-6, floor=1e-12)
    for k, v in frozen.items():  # frozen weights never move
        assert torch.equal(b[k], v), k
    assert "training done" in (tmp_path / "cut" / "log.txt").read_text()
    vals = first["validations"] + resumed["validations"]
    assert [v["epoch"] for v in vals] == [v["epoch"] for v in full["validations"]]
    for got, want in zip(vals, full["validations"]):
        assert got["mae"] == pytest.approx(want["mae"], abs=1e-6)
    assert resumed["best_mae"] == pytest.approx(full["best_mae"], abs=1e-6)
    assert (tmp_path / "cut" / "ckpt_best.pt").exists() == (epoch_val == "1")


def test_train_cli_refuses_validation_and_missing_card(synthetic_dataset, tmp_path):
    """Validation inside the run is accepted now (--epoch-val <= --epochs);
    what the CLI still refuses: an epoch_val below 1, a batch that the
    accumulation does not divide, and --device cuda without a card."""
    from camouflaged_vlm_tpu_torch.cli import train as cli

    args = cli.parse_args(["--dataset-info", synthetic_dataset, "--epochs", "2",
                           "--epoch-val", "2"])
    assert (args.epochs, args.epoch_val) == (2, 2)
    with pytest.raises(SystemExit):
        cli.parse_args(["--dataset-info", synthetic_dataset, "--epoch-val", "0"])
    with pytest.raises(SystemExit):
        cli.parse_args(["--dataset-info", synthetic_dataset, "--epochs", "2",
                        "--epoch-val", "3", "--batch-size", "3", "--accum-steps", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--dataset-info", synthetic_dataset, "--tiny", "--device", "cuda",
                      "--epochs", "1", "--epoch-val", "2", "--save-dir", str(tmp_path)])


def test_epoch_val_refusal_names_the_missing_module(synthetic_dataset, tmp_path):
    """Validation inside the run is `cli/evaluate.py`'s evaluate() on the
    model as it stands: every --epoch-val epochs a [val epoch N] line, the
    lowest MAE saved as ckpt_best.pt and best_mae in ckpt_meta.json, which a
    --resume reads back; the numbers equal evaluate() on the same weights."""
    import json

    from camouflaged_vlm_tpu_torch.cli.evaluate import evaluate
    from camouflaged_vlm_tpu_torch.data.ovcamo import OVCamoIndex

    save = tmp_path / "val"
    run = _cli(synthetic_dataset, save, "--epoch-val", "1")
    assert [v["epoch"] for v in run["validations"]] == [1, 2]
    maes = [v["mae"] for v in run["validations"]]
    assert run["best_mae"] == min(maes) and np.isfinite(run["best_mae"])
    assert (save / "ckpt_best.pt").exists()
    meta = json.loads((save / "ckpt_meta.json").read_text())
    assert meta["best_mae"] == run["best_mae"] and meta["epoch"] == 2
    logtext = (save / "log.txt").read_text()
    assert "[val epoch 1]" in logtext and "[val epoch 2]" in logtext
    # the last validation ran on the final weights, at batch max(1, 2 // 2)
    import yaml

    with open(synthetic_dataset) as f:
        index = OVCamoIndex.from_dataset_info(yaml.safe_load(f), "test")
    bank = make_bank_inputs(run["model"].cfg, index.classes, seed=0)
    want = evaluate(run["model"], run["model"].cfg, bank, index, batch_size=1)
    got = run["validations"][-1]
    for k, v in want.items():
        if k != "images_per_sec":
            assert got[k] == pytest.approx(v, abs=1e-4), k
    # a resume keeps best_mae (epoch 3 runs no validation)
    resumed = _cli(synthetic_dataset, save, "--resume", "--epochs", "3", "--epoch-val", "5")
    assert resumed["step"] == 9 and resumed["validations"] == []
    assert resumed["best_mae"] == run["best_mae"]
    assert json.loads((save / "ckpt_meta.json").read_text())["best_mae"] == run["best_mae"]
    assert f"(best mae {run['best_mae']})" in (save / "log.txt").read_text()


RECIPE = {"epochs": 3, "batch_size": 6, "lr": 1e-3, "eta_min": 1e-6, "epoch_val": 1,
          "loss": "bce"}


def _jax_cli_recipe(argv, monkeypatch, tmp_path):
    """The recipe JAX's train CLI resolves (flags, then the yaml's train
    section over them, camouflaged_vlm_tpu/cli/train.py:180-183): its main()
    runs up to the model assembly, which is stopped there."""
    import argparse
    import sys

    from camouflaged_vlm_tpu.cli import train as jcli

    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def keep(self, *a, **k):
        seen["args"] = parse(self, *a, **k)
        return seen["args"]

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", keep)
    monkeypatch.setattr(jcli, "assemble_cascade", stop)
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--save-dir", str(tmp_path / "jax")])
    with pytest.raises(Stop):
        jcli.main()
    return {k: getattr(seen["args"], k) for k in RECIPE}


@pytest.mark.parametrize("fmt", ["native", "reference"])
def test_train_cli_reads_the_yaml_recipe_as_jax(synthetic_dataset, tmp_path, monkeypatch, fmt):
    """With --config, the yaml's train section (a reference-format yaml's
    epoch_max, lr_min, optimizer lr, batch size, epoch_val and loss) replaces
    the flags exactly as in JAX's CLI; the result differs from the flags'
    defaults, and the accumulation check runs on the resolved batch."""
    import yaml

    from camouflaged_vlm_tpu_torch.cli import train as cli

    path = tmp_path / f"{fmt}.yaml"
    if fmt == "native":
        with open("configs/ovcos-sam-vit-h-maskdecoder-edge.yaml") as f:
            raw = yaml.safe_load(f)
        raw["train"] = dict(RECIPE)
    else:
        raw = {"model": {"name": "sam", "args": {"inp_size": 1024, "loss": "bce",
                                                  "encoder_mode": {"name": "sam"}}},
               "epoch_max": 3, "epoch_val": 1, "lr_min": 1e-6,
               "optimizer": {"name": "adamw", "args": {"lr": 1e-3}},
               "train_dataset": {"batch_size": 6}}
    path.write_text(yaml.safe_dump(raw))
    argv = ["--dataset-info", synthetic_dataset, "--config", str(path)]
    args = cli.parse_args(argv)
    got = {k: getattr(args, k) for k in RECIPE}
    assert got == RECIPE
    assert got == _jax_cli_recipe(argv, monkeypatch, tmp_path)
    defaults = cli.parse_args(["--dataset-info", synthetic_dataset])
    assert all(getattr(defaults, k) != v for k, v in RECIPE.items())
    with pytest.raises(SystemExit):  # batch 6 from the yaml, 4 microbatches
        cli.parse_args(argv + ["--accum-steps", "4"])


def test_train_cli_text_features_are_jax_val_bank_features(synthetic_dataset, tmp_path,
                                                           monkeypatch):
    """The reference's quirk: the training forward is conditioned on the
    TEST split's class-text features. The port's CLI encodes them from the
    test classes' bank; JAX's CLI from `val_bank` (cli/train.py:278-309).
    On the same random weights (JAX's tiny cascade, seed 0, loaded into the
    port's model) the two are equal."""
    import yaml

    from camouflaged_vlm_tpu.cli.common import assemble_cascade
    from camouflaged_vlm_tpu.data.ovcamo import OVCamoIndex as JIndex
    from camouflaged_vlm_tpu_torch.cli import train as cli

    with open(synthetic_dataset) as f:
        info = yaml.safe_load(f)
    train_index, val_index = JIndex.from_dataset_info(info, "train"), \
        JIndex.from_dataset_info(info, "test")
    jmodel, _, params, _, make_bank = assemble_cascade(
        train_index.classes, dtype=jnp.float32, tiny=True, seed=0, return_bank_builder=True)
    val_bank = make_bank(val_index.classes)
    jtf = jmodel.apply(params, val_bank["prefix"], val_bank["suffix"],
                       val_bank["eot_indices"], val_bank["bank_features"],
                       method=jmodel.encode_class_text_features)

    def build_with_jax_weights(cfg, device, seed):
        model = build_cascade(cfg, device, seed)
        load_jax_params(model, jax.tree.map(np.asarray, params), cfg)
        return model

    monkeypatch.setattr(cli, "build_cascade", build_with_jax_weights)
    run = _cli(synthetic_dataset, tmp_path / "tf", "--epochs", "1")
    assert set(val_index.classes) != set(train_index.classes)
    close(run["text_features"], np.asarray(jtf), 1e-5)


def test_train_cli_checkpoint_flags_assemble_as_jax_cli(synthetic_dataset, tmp_path,
                                                       monkeypatch):
    """The CLI with --sam-ckpt, --clip-ckpt, --maple-ckpt and both banks
    starts from the weights JAX's train CLI assembles from the same flags
    (no epoch run: the whole state dict bit for bit), and takes its banks as
    JAX's does (cli/train.py:184-196): the test split's from --text-bank,
    which conditions validation and the training forward, and the train
    split's from --train-text-bank, else --text-bank. JAX's CLI runs up to
    its mesh; its init is the port's seeded random weights."""
    import yaml

    from _torch_ckpt_files import (
        assert_bank_equal,
        assert_state_equal,
        jax_state_dict,
        run_jax_cli,
        write_reference_files,
    )

    from camouflaged_vlm_tpu.cli import train as jcli
    from camouflaged_vlm_tpu.data.ovcamo import OVCamoIndex as JIndex

    with open(synthetic_dataset) as f:
        info = yaml.safe_load(f)
    train_classes = JIndex.from_dataset_info(info, "train").classes
    test_classes = JIndex.from_dataset_info(info, "test").classes
    files = write_reference_files(tmp_path, train_classes, test_classes)
    flags = ["--dataset-info", synthetic_dataset, "--tiny", "--dtype", "float32",
             "--sam-ckpt", files["sam.pth"], "--clip-ckpt", files["clip.pt"],
             "--maple-ckpt", files["maple.pth.tar"], "--text-bank", files["test_bank.npy"]]
    for extra in (["--train-text-bank", files["bank.npy"]], []):
        seen = run_jax_cli(jcli, flags + extra + ["--save-dir", str(tmp_path / "jax")],
                           monkeypatch, stop_at="make_mesh")
        _, _, params, jtrain_bank, _ = seen["assembled"]
        run = _cli(synthetic_dataset, tmp_path / "port", *flags[2:], *extra, "--epochs", "0")
        assert run["step"] == 0
        assert_state_equal(run["model"].state_dict(), jax_state_dict(params))
        assert_bank_equal(run["bank"], seen["banks"][0])
        assert_bank_equal(run["train_bank"], jtrain_bank)
    np.testing.assert_array_equal(run["train_bank"]["bank_features"].numpy(),
                                  np.load(files["test_bank.npy"]))


def test_no_mask_embed_trains_in_fp32_in_bfloat16_as_in_jax():
    """In a bf16 build `no_mask_embed` stays fp32, as JAX's (C,) param does
    under its cast rule (rank >= 2 only): two bf16 AdamW steps at lr 2e-5 of
    a small cascade (the tiny one cut to 1 SAM block and 1 + 1 CLIP layers)
    in both packages from the same weights and batch move it as JAX moves
    it, within a quarter of JAX's largest move. AdamW's early updates are
    ~lr * sign(g), and the two bf16 forwards round at other places, so the
    gradients, and the moves where two of them differ, differ by a few
    per cent. A bf16 copy of the weight (normal(0, 0.02)) would not move
    where it is above 0.008: bf16's spacing there (6.1e-5 and up) is more
    than twice the update."""
    from camouflaged_vlm_tpu.io.convert import convert_cascade_checkpoint as j_convert
    from camouflaged_vlm_tpu.train.train_step import create_train_state

    bf, small = torch.bfloat16, dict(depth=1, global_attn_indexes=(0,))
    clip = dict(vision_layers=1, transformer_layers=1)

    def config(cls, enc, cc, dtype):
        base = cls.tiny(dtype=dtype)
        return dataclasses.replace(base, encoder=enc.tiny(dtype=dtype, **small),
                                   clip=cc.tiny(dtype=dtype, **clip))

    cfg = config(CascadeConfig, SamEncoderConfig, AlphaClipConfig, bf)
    jcfg = config(JCascadeConfig, j_sam.SamEncoderConfig, JClipConfig, jnp.bfloat16)
    cfg32 = config(CascadeConfig, SamEncoderConfig, AlphaClipConfig, torch.float32)
    model = build_cascade(cfg, "cpu", 3)
    w0 = model.no_mask_embed.weight.detach().clone()
    assert w0.dtype == torch.float32 and model.mask_decoder.iou_token.weight.dtype == bf
    fp32 = build_cascade(cfg32, "cpu", 3).state_dict()
    assert torch.equal(w0, fp32["no_mask_embed.weight"])
    tree, _, _ = j_convert({k: v.numpy() for k, v in fp32.items()}, jcfg)
    # JAX's CLI cast (`cli/common.py`): rank >= 2 to the compute type
    params = jax.tree.map(lambda p: J(p, jnp.bfloat16) if np.ndim(p) >= 2 else J(p),
                          {"params": tree})
    assert params["params"]["no_mask_embed"].dtype == jnp.float32
    bank = make_bank_inputs(cfg, CLASSES, seed=3)
    rng = np.random.default_rng(4)
    B, S, C = 1, cfg.inp_size, cfg.clip_size
    batch = {"inp": rng.standard_normal((B, S, S, 3)).astype(np.float32),
             "gt": (rng.random((B, S, S, 1)) > 0.6).astype(np.float32),
             "clip_image": rng.standard_normal((B, C, C, 3)).astype(np.float32),
             "clip_mask": np.full((B, C, C, 1), 1.923, np.float32)}
    steps, lr = 2, 2e-5
    tx = jtrain.make_optimizer(base_lr=lr, total_epochs=steps)
    state = create_train_state(params, tx)
    jstep = jax.jit(jtrain.make_train_step(JCascade(jcfg), tx))
    jbatch = {**{k: J(v) for k, v in batch.items()},
              **{k: J(v.numpy()) for k, v in bank.items()}}
    opt = train.make_optimizer(train.trainable_parameters(model), lr)
    step = train.make_train_step(model, opt, train.cosine_epoch_schedule(lr, steps))
    tbatch = {**{k: T(v).to(bf) for k, v in batch.items()}, **bank}
    for i in range(steps):
        state, _ = jstep(state, jbatch)
        step(tbatch, i)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params),
                                      cfg32)["no_mask_embed.weight"]
    got = model.no_mask_embed.weight.detach()
    assert got.dtype == torch.float32
    moved = (want - w0).abs().max()
    assert moved > lr  # two steps: lr, then lr x the cosine's 0.5
    assert (got - want).abs().max() < 0.25 * moved
