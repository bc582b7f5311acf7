"""The port's MaPLe prompt training against the JAX package's, on the CPU.

On the tiny configuration, from the same weights (the port's seeded random
cascade, handed to JAX through its own converter) and the same batch: one
MaPLe step's loss, accuracy and every prompt-learner gradient within 1e-4
of JAX's (max|d| / max|g| per tensor; both fp32, apart in summation order
only), the prompts after the SGD update within 1e-5 of JAX's
`make_maple_train_step`, every other parameter bit-unchanged. The learning
rate at every step of a 5-epoch, 3-step, 1-warm-up run (past its end: the
clamp) equals JAX's schedule, read off optax's updates, to float32
rounding (1e-6 relative), and two steps of SGD with the decay equal
optax's chain to 1e-6. `iter_maple_train_batches` under one seed is
bit-equal to JAX's on its PIL path (CVLM_NATIVE_PREPROC=0), a rot90 sample
included. The CLI on the CPU writes its five outputs, its
`model-best.pth.tar` loads back through `load_checkpoints(maple_ckpt=...)`
bit-equal, a resume equals an uninterrupted run bit for bit, and
`--device cuda` raises on a host without a card.
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from PIL import Image  # noqa: E402

from camouflaged_vlm_tpu.data import loader as j_loader  # noqa: E402
from camouflaged_vlm_tpu.data import ovcamo as j_ovcamo  # noqa: E402
from camouflaged_vlm_tpu.factory import make_bank_inputs as j_make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu.io.convert import convert_cascade_checkpoint as j_convert  # noqa: E402
from camouflaged_vlm_tpu.models import CascadeConfig as JCascadeConfig  # noqa: E402
from camouflaged_vlm_tpu.models import OVCOSCascade as JCascade  # noqa: E402
from camouflaged_vlm_tpu.train import (  # noqa: E402
    MAPLE_TRAINABLE_SUBTREES,
    create_train_state,
    make_maple_optimizer as j_make_maple_optimizer,
    make_maple_train_step as j_make_maple_train_step,
)
from camouflaged_vlm_tpu.train.train_step import combine_params  # noqa: E402

from camouflaged_vlm_tpu_torch import train  # noqa: E402
from camouflaged_vlm_tpu_torch.cli import train_maple  # noqa: E402
from camouflaged_vlm_tpu_torch.cli.common import load_checkpoints  # noqa: E402
from camouflaged_vlm_tpu_torch.data import loader, ovcamo  # noqa: E402
from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo  # noqa: E402
from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu_torch.io.convert import (  # noqa: E402
    PROMPT_LEARNER,
    state_dict_from_jax_params,
)
from camouflaged_vlm_tpu_torch.models import CascadeConfig  # noqa: E402

CLASSES = ["cat", "owl", "sea_horse"]
SEED = 5
LR = 0.01


def _clip_call(m, *a):
    return m.clip_model(*a)


class ClipView:
    """JAX's cascade driven through its CustomClip, as the JAX CLI does."""

    def __init__(self, jmodel):
        self.jmodel = jmodel

    def apply(self, p, *a):
        return self.jmodel.apply(p, *a, method=_clip_call)


@pytest.fixture(scope="module")
def pair():
    """The tiny cascade in both packages from the port's seeded weights, the
    train classes' bank (equal draws in both) and one batch."""
    cfg, jcfg = CascadeConfig.tiny(), JCascadeConfig.tiny()
    model = build_cascade(cfg, "cpu", SEED)
    tree, _, _ = j_convert({k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    jbank = j_make_bank_inputs(jcfg, CLASSES, seed=SEED)
    bank = make_bank_inputs(cfg, CLASSES, seed=SEED)
    for k in bank:
        np.testing.assert_array_equal(bank[k].numpy(), np.asarray(jbank[k]), err_msg=k)
    rng = np.random.default_rng(2)
    C = cfg.clip_size
    batch = {"clip_image": rng.standard_normal((3, C, C, 3)).astype(np.float32),
             "clip_alpha": rng.standard_normal((3, C, C, 1)).astype(np.float32),
             "label_id": np.array([0, 2, 1], np.int32)}
    return cfg, model, JCascade(jcfg), {"params": tree}, bank, jbank, batch


def _jax_batch(batch, jbank):
    return {**{k: jnp.asarray(v) for k, v in batch.items()},
            **{k: jnp.asarray(np.asarray(v)) for k, v in jbank.items()}}


def test_maple_step_matches_jax(pair):
    """Loss, accuracy, every prompt-learner gradient (1e-4) and the prompts
    after one SGD step (1e-5) against JAX's step on the same weights and
    batch; only the prompt learner moves."""
    cfg, model, jmodel, params, bank, jbank, batch = pair
    jb = _jax_batch(batch, jbank)
    # JAX's optimizer behind a pass-through that keeps the gradient it is
    # given as its state: one jitted step gives the gradient and the update
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))
    tx = optax.chain(keep, j_make_maple_optimizer(base_lr=LR, total_epochs=5, steps_per_epoch=2,
                                                  warmup_epochs=0))
    state = create_train_state(params, tx, MAPLE_TRAINABLE_SUBTREES)
    new_state, metrics = jax.jit(j_make_maple_train_step(ClipView(jmodel), tx))(state, jb)
    jgrads = new_state.opt_state[0]

    def as_port(flat):  # a flat trainable dict -> the port's prompt-learner entries
        sd = state_dict_from_jax_params(combine_params(jax.tree.map(np.asarray, flat),
                                                       state.frozen), cfg)
        return {k: v for k, v in sd.items() if k.startswith(PROMPT_LEARNER)}

    want_grads, want_after = as_port(jgrads), as_port(new_state.trainable)

    model = build_cascade(cfg, "cpu", SEED)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params_t = train.trainable_parameters(model, train.MAPLE_TRAINABLE_PREFIXES)
    names = {id(p): n for n, p in model.named_parameters()}
    assert sorted(names[id(p)] for p in params_t) == sorted(want_grads)
    opt = train.make_maple_optimizer(params_t, LR)
    step = train.make_maple_train_step(model.clip_model, opt,
                                       train.maple_schedule(LR, 5, 2, warmup_epochs=0))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for p in params_t:  # the gradient, kept before the update clears it
        p.register_post_accumulate_grad_hook(
            lambda q: grads.__setitem__(names[id(q)], q.grad.clone()))
    m = step({**tb, **bank}, 0)

    np.testing.assert_allclose(float(m["loss"]), float(metrics["loss"]), rtol=1e-4)
    assert float(m["acc"]) == float(metrics["acc"])
    for k, want in want_grads.items():
        d = (grads[k] - want).abs().max() / want.abs().max()
        assert d.item() < 1e-4, (k, d.item())
    after = model.state_dict()
    for k, v in before.items():
        if k in want_after:
            np.testing.assert_allclose(after[k].numpy(), want_after[k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
            assert not torch.equal(after[k], v), k
        else:
            assert torch.equal(after[k], v), k


def test_maple_schedule_and_sgd_match_optax():
    """The learning rate at every step of 5 epochs x 3 steps with 1 warm-up
    epoch, and 6 steps past the end (the epoch clamps at total_epochs),
    against JAX's schedule read off optax's momentum-free, decay-free
    updates of a unit gradient; then two steps of SGD with momentum and
    decay against optax's chain."""
    base, total, spe, warm = 0.0035, 5, 3, 1
    tx = j_make_maple_optimizer(base_lr=base, total_epochs=total, steps_per_epoch=spe,
                                warmup_epochs=warm, momentum=0.0, weight_decay=0.0)
    p = {"w": jnp.zeros((1,))}
    s = tx.init(p)
    schedule = train.maple_schedule(base, total, spe, warm)
    lrs = []
    for step in range((total + 2) * spe):
        up, s = tx.update({"w": jnp.ones((1,))}, s, p)
        lrs.append(schedule(step))
        np.testing.assert_allclose(lrs[-1], -float(up["w"][0]), rtol=1e-6, err_msg=str(step))
    assert lrs[0] == 1e-5 and lrs[spe] == base and lrs[-1] == lrs[total * spe]

    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    gs = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(2)]
    tx = j_make_maple_optimizer(base_lr=base, total_epochs=total, steps_per_epoch=1,
                                warmup_epochs=0)
    jp = {"w": jnp.asarray(w0)}
    js = tx.init(jp)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = train.make_maple_optimizer([w], base)
    schedule = train.maple_schedule(base, total, 1, warmup_epochs=0)
    for step, g in enumerate(gs):
        up, js = tx.update({"w": jnp.asarray(g)}, js, jp)
        jp = {"w": jp["w"] + up["w"]}
        w.grad = torch.from_numpy(g)
        opt.param_groups[0]["lr"] = schedule(step)
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["w"]), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """6 train images of 2 classes (one whose mask is the image's size
    transposed: the rot90 fix applies) and 2 test images."""
    root = tmp_path_factory.mktemp("ovcamo_maple")
    info = write_synthetic_ovcamo(str(root), n_train=6, n_test=2, seed=3)
    mask = Image.open(root / "train" / "mask" / "train0.png")  # 480 x 640
    mask.transpose(Image.TRANSPOSE).save(root / "train" / "mask" / "train0.png")
    return info


def test_maple_batches_match_jax(dataset, monkeypatch):
    """Under one seed: the same batches (images, alphas, labels, so the same
    order and flips), the same draws consumed, the partial batch dropped."""
    monkeypatch.setenv("CVLM_NATIVE_PREPROC", "0")
    import yaml

    with open(dataset) as f:
        info = yaml.safe_load(f)
    idx = ovcamo.OVCamoIndex.from_dataset_info(info, "train")
    jidx = j_ovcamo.OVCamoIndex.from_dataset_info(info, "train")
    s = idx.samples[0]
    assert Image.open(s.image_path).size != Image.open(s.mask_path).size  # the rot90 sample
    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    got = list(loader.iter_maple_train_batches(idx, 4, rng, 28, num_workers=2))
    want = list(j_loader.iter_maple_train_batches(jidx, 4, jrng, 28, num_workers=2))
    assert len(got) == len(want) == 1
    for bg, bw in zip(got, want):
        assert set(bg) == set(bw) == {"clip_image", "clip_alpha", "label_id"}
        for k in bw:
            assert bg[k].dtype == bw[k].dtype
            np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)
    assert rng.random() == jrng.random()
    # every sample, the rot90 one among them, in batches of 2 (3 full batches)
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    got = list(loader.iter_maple_train_batches(idx, 2, rng, 28, num_workers=0))
    want = list(j_loader.iter_maple_train_batches(jidx, 2, jrng, 28, num_workers=0))
    assert len(got) == 3
    for bg, bw in zip(got, want):
        for k in bw:
            np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)


def _cli(dataset, save_dir, *extra):
    return train_maple.main(["--dataset-info", dataset, "--save-dir", str(save_dir), "--tiny",
                             "--device", "cpu", "--batch-size", "2", "--epochs", "2",
                             "--lr", "0.01", "--seed", "1", *extra])


def _prompts(model):
    return {k: v.clone() for k, v in model.state_dict().items() if k.startswith(PROMPT_LEARNER)}


def test_maple_cli_outputs_reload_and_resume(dataset, tmp_path, monkeypatch):
    """Two epochs on the CPU: the five outputs; model-best.pth.tar read back
    by `load_checkpoints(maple_ckpt=...)` equals maple_best.pt's prompt
    learner bit for bit (and the npz); stopping after epoch 1 and resuming
    equals the uninterrupted run, weights and SGD state."""
    # tensorboard's writer is optional (a heavy import); the CLI goes on without it
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    full = _cli(dataset, tmp_path / "full")
    assert full["step"] == 6 and len(full["epochs"]) == 2
    assert all(np.isfinite(e["loss"]) for e in full["epochs"])
    out = tmp_path / "full"
    for name in ("maple_last.pt", "maple_best.pt", "prompt_learner_best.npz",
                 "model-best.pth.tar", "log.txt"):
        assert (out / name).exists(), name
    text = (out / "log.txt").read_text()
    assert "[maple] epoch 2/2" in text and "[maple] done" in text

    best = torch.load(out / "maple_best.pt", weights_only=True)["model"]
    best = {f"clip_model.{k}": v for k, v in best.items() if k.startswith("prompt_learner.")}
    cfg = CascadeConfig.tiny()
    fresh = build_cascade(cfg, "cpu", 9)
    assert not all(torch.equal(fresh.state_dict()[k], v) for k, v in best.items())
    load_checkpoints(fresh, cfg, maple_ckpt=str(out / "model-best.pth.tar"))
    got = _prompts(fresh)
    assert set(got) == set(best)
    for k, v in best.items():
        assert torch.equal(got[k], v), k
    npz = np.load(out / "prompt_learner_best.npz")
    assert set(npz.files) == set(best)
    for k, v in best.items():
        np.testing.assert_array_equal(npz[k], v.numpy(), err_msg=k)
    meta = json.loads((out / "maple_meta.json").read_text())
    assert meta["best_acc"] == full["best_acc"] == max(e["acc"] for e in full["epochs"])

    part = tmp_path / "part"
    first = _cli(dataset, part, "--stop-after-epoch", "1")
    assert first["step"] == 3
    resumed = _cli(dataset, part, "--resume")
    assert resumed["step"] == 6 and resumed["epochs"] == full["epochs"][1:]
    a, b = _prompts(full["model"]), _prompts(resumed["model"])
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = full["optimizer"].state_dict(), resumed["optimizer"].state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        assert torch.equal(st["momentum_buffer"], sb["state"][i]["momentum_buffer"])


def test_maple_cli_cuda_without_card_raises(dataset, tmp_path, monkeypatch):
    """float32 is this CLI's default and is not refused (its kernels have
    fp32 instances); without a card `--device cuda` raises before anything
    is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_maple.main(["--dataset-info", dataset, "--save-dir", str(tmp_path / "out"),
                          "--tiny", "--device", "cuda"])
    assert not (tmp_path / "out").exists()
