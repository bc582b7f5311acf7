"""Remat and the train CLI's tensorboard scalars in the PyTorch port,
against the step without remat and against the JAX package, on the CPU.

`encoder.remat` runs each SAM block through `torch.utils.checkpoint`
(non-reentrant), JAX's `nn.remat(Block)`: the step's loss and gradients
equal the step without it bit for bit, fewer bytes are saved for the
backward, and the step matches JAX's remat step at the slice's tolerances
(loss 1e-5, gradients 1e-4 with the floor; `test_torch_train.py`'s slice
pair: 8-head 'flash' SAM on the compact carry with edge and corner
windows). The train CLI's `--remat` trains to the same weights, and writes
each epoch's mean losses under JAX's names to a (stand-in) SummaryWriter.
Kept apart from `test_torch_train.py`, whose fixtures and helpers it takes,
so that the two files run side by side.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from test_torch_train import (  # noqa: E402,F401  (fixtures by name)
    CLASSES,
    JCascade,
    T,
    _check_step_against_jax,
    _cli,
    build_cascade,
    make_bank_inputs,
    slice_pair,
    synthetic_dataset,
    train,
)


def _with_remat(cfg, model):
    """`model`'s weights in a cascade whose SAM blocks are rematerialised."""
    rcfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, remat=True))
    remat = build_cascade(rcfg, "cpu")
    remat.load_state_dict(model.state_dict())
    return rcfg, remat


def test_remat_step_is_bit_equal_and_keeps_less(slice_pair):
    """`encoder.remat` (each block through torch.utils.checkpoint): the
    same loss and gradients bit for bit as the step without it (the
    recompute runs the same forward on the same inputs), and fewer bytes
    saved for the backward outside the blocks (the blocks' activations are
    recomputed, not kept)."""
    _, _, _, cfg, model, _, batch = slice_pair
    rcfg, remat = _with_remat(cfg, model)
    tbank = make_bank_inputs(cfg, CLASSES, seed=3)
    bank = (tbank["prefix"], tbank["suffix"], tbank["eot_indices"], tbank["bank_features"])
    tf = model.encode_class_text_features(*bank)
    args = (T(batch["inp"]), T(batch["clip_image"]), T(batch["clip_mask"]))
    runs = []
    for m in (model, remat):
        params = train.trainable_parameters(m)
        for p in params:
            p.grad = None
        kept = {}

        def pack(t, kept=kept):
            kept[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            masks, edges = m.forward_with_text(*args, tf)
        total, _ = train.segmentation_loss(masks, edges, T(batch["gt"]))
        total.backward()
        grads = {n: p.grad for n, p in m.named_parameters() if p.requires_grad}
        runs.append((total.detach(), grads, sum(kept.values())))
    (l0, g0, kept0), (l1, g1, kept1) = runs
    assert rcfg.encoder.remat and not cfg.encoder.remat
    assert torch.equal(l0, l1)
    assert set(g0) == set(g1) and len(g0) > 40
    for k in g0:
        assert (g0[k] is None) == (g1[k] is None), k
        assert g0[k] is None or torch.equal(g0[k], g1[k]), k
    assert kept1 < kept0, (kept1, kept0)


def test_remat_step_matches_jax_remat_step(slice_pair):
    """The port's remat step against JAX's with `encoder.remat=True`
    (nn.remat(Block)) on the same parameters, at the slice's tolerances."""
    jcfg, _, params, cfg, model, bank, batch = slice_pair
    jr = JCascade(dataclasses.replace(jcfg, encoder=dataclasses.replace(jcfg.encoder,
                                                                        remat=True)))
    _, remat = _with_remat(cfg, model)
    _check_step_against_jax(jr, params, bank, remat.cfg, remat, batch)


class _ScalarWriter:
    """A SummaryWriter stand-in that keeps what it is given."""

    made = []

    def __init__(self, logdir):
        self.logdir, self.scalars, self.closed = logdir, [], False
        self.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        self.closed = True


def test_train_cli_remat_trains_as_without_and_writes_scalars(synthetic_dataset, tmp_path,
                                                             monkeypatch):
    """--remat trains to the same weights and losses bit for bit; each
    epoch's mean losses go to the writer under <save-dir>/tensorboard by the
    JAX CLI's names (the metric keys), step = the epoch (a stand-in writer:
    tensorboard need not be installed)."""
    from camouflaged_vlm_tpu_torch.cli import train as cli

    _ScalarWriter.made.clear()
    monkeypatch.setattr(cli, "tensorboard_writer", _ScalarWriter)
    plain = _cli(synthetic_dataset, tmp_path / "plain", "--epochs", "1")
    remat = _cli(synthetic_dataset, tmp_path / "remat", "--epochs", "1", "--remat")
    assert remat["model"].cfg.encoder.remat and not plain["model"].cfg.encoder.remat
    assert remat["epochs"] == plain["epochs"] and remat["step"] == plain["step"] == 3
    a, b = plain["model"].state_dict(), remat["model"].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = _ScalarWriter.made[-1]
    assert w.logdir == str(tmp_path / "remat" / "tensorboard") and w.closed
    assert w.scalars == [(k, v, e + 1) for e, means in enumerate(remat["epochs"])
                         for k, v in means.items()]
    assert {k for k, _, _ in w.scalars} == {"loss", "loss_mask", "loss_edge"}
