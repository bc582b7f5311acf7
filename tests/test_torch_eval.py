"""The PyTorch port's evaluation slice against the JAX package, on the CPU.

The config loader (the repo's ViT-H yaml, the port's ViT-B yaml and a
reference-format yaml give equal configs in both packages; JAX-only keys
load only where harmless), the port's own copies of the framework-free
modules (data index, transforms, loader, tokenizer, image resize, metrics)
against the JAX package's, `evaluate()` against JAX's `evaluate()` on a
tiny synthetic OVCamo split with the same converted weights, the evaluate
and train CLIs on the CPU, and the port's isolation from JAX.

Tolerances: the copies are held to exact equality (the same numpy code on
the same inputs), except the metric values, compared to 1e-12 relative
(float64 sums in the same order) and macro-F1, computed without sklearn,
to 1e-12. `evaluate()`: the classification results and the image count
exactly (the predicted classes are equal); the mask metrics within 5e-3
absolute. Both packages compute the probabilities in fp32 and differ by
~1e-6 (fp32 summation order), so a pixel whose probability lies that close
to a 1/255 truncation boundary of the uint8 maps falls in the neighbouring
bin; each such pixel moves a per-image mean by about 1/(pixels of the
image), a few 1e-4 at these image sizes, and the results are rounded to 3-4
decimals.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402
from PIL import Image  # noqa: E402

from camouflaged_vlm_tpu import config as j_config  # noqa: E402
from camouflaged_vlm_tpu import metrics as j_metrics  # noqa: E402
from camouflaged_vlm_tpu.cli import evaluate as j_evaluate  # noqa: E402
from camouflaged_vlm_tpu.data import loader as j_loader  # noqa: E402
from camouflaged_vlm_tpu.data import ovcamo as j_ovcamo  # noqa: E402
from camouflaged_vlm_tpu.data import transforms as j_transforms  # noqa: E402
from camouflaged_vlm_tpu.factory import make_bank_inputs as j_make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu.models import CascadeConfig as JCascadeConfig  # noqa: E402
from camouflaged_vlm_tpu.models import OVCOSCascade as JCascade  # noqa: E402
from camouflaged_vlm_tpu.models.clip import tokenizer as j_tokenizer  # noqa: E402
from camouflaged_vlm_tpu.utils import image as j_image  # noqa: E402

from camouflaged_vlm_tpu_torch import config  # noqa: E402
from camouflaged_vlm_tpu_torch import metrics  # noqa: E402
from camouflaged_vlm_tpu_torch.cli import evaluate  # noqa: E402
from camouflaged_vlm_tpu_torch.data import loader, ovcamo, transforms  # noqa: E402
from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo  # noqa: E402
from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu_torch.io.convert import load_jax_params  # noqa: E402
from camouflaged_vlm_tpu_torch.models import CascadeConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.models.clip import tokenizer  # noqa: E402
from camouflaged_vlm_tpu_torch.utils import image  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT_H_YAML = os.path.join(REPO, "configs", "ovcos-sam-vit-h-maskdecoder-edge.yaml")
VIT_B_YAML = os.path.join(REPO, "camouflaged_vlm_tpu_torch", "configs",
                          "ovcos-sam-vit-b-maskdecoder-edge.yaml")
DTYPE_NAMES = {jnp.bfloat16: "bfloat16", jnp.float32: "float32",
               torch.bfloat16: "bfloat16", torch.float32: "float32"}
JAX_ONLY = {"fused": True}  # the harmless value of each


def as_plain(cfg):
    """A config dataclass of either package as nested dicts, dtypes by name,
    the JAX-only fields checked at their harmless value and dropped."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in JAX_ONLY:
            assert v == JAX_ONLY[f.name], (f.name, v)
            continue
        if dataclasses.is_dataclass(v):
            v = as_plain(v)
        elif f.name == "dtype":
            v = DTYPE_NAMES[v]
        out[f.name] = v
    return out


# ----------------------------------------------------------------- config


REFERENCE_FORMAT = {
    "model": {"name": "sam", "args": {
        "inp_size": 1024, "loss": "iou",
        "encoder_mode": {"name": "sam", "img_size": 1024, "patch_size": 16,
                         "embed_dim": 768, "depth": 12, "num_heads": 12, "mlp_ratio": 4,
                         "out_chans": 256, "window_size": 14, "use_rel_pos": True,
                         "global_attn_indexes": [2, 5, 8, 11], "scale_factor": 32,
                         "freq_nums": 0.25, "prompt_embed_dim": 256, "input_type": "fft",
                         "prompt_type": "highpass", "tuning_stage": 1234,
                         "handcrafted_tune": True, "embedding_tune": True,
                         "adaptor": "adaptor", "qkv_bias": True}}},
    "MAPLE_ALPHA_CLIP": {"INPUT": {"SIZE": [336, 336]},
                         "TRAINER": {"MAPLE": {"N_CTX": 4, "PROMPT_DEPTH": 9}}},
    "epoch_max": 20, "epoch_val": 2, "lr_min": 1e-7,
    "optimizer": {"name": "adamw", "args": {"lr": 2e-4}},
    "train_dataset": {"batch_size": 1},
}


@pytest.fixture(scope="module")
def reference_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "reference.yaml"
    path.write_text(yaml.safe_dump(REFERENCE_FORMAT))
    return str(path)


@pytest.mark.parametrize("which", ["vit_h", "vit_b", "reference"])
def test_config_loader_matches_jax(which, reference_yaml):
    path = {"vit_h": VIT_H_YAML, "vit_b": VIT_B_YAML, "reference": reference_yaml}[which]
    cfg, hp = config.cascade_config_from_yaml(path)
    jcfg, jhp = j_config.cascade_config_from_yaml(path)
    assert as_plain(cfg) == as_plain(jcfg)
    assert hp == jhp
    if which == "vit_h":
        assert cfg == CascadeConfig.full(dtype=torch.bfloat16)
    else:  # SAM ViT-B (segment-anything's build_sam_vit_b), the rest unchanged
        enc = cfg.encoder
        assert (enc.embed_dim, enc.depth, enc.num_heads, enc.global_attn_indexes,
                enc.window_size, enc.prompt_dim) == (768, 12, 12, (2, 5, 8, 11), 14, 24)
        assert enc.attn_impl == "flash" and enc.num_heads % 8  # the unfused path
        full = CascadeConfig.full(dtype=torch.bfloat16)
        assert (cfg.decoder, cfg.clip) == (full.decoder, full.clip)


def test_config_loader_refuses_what_it_cannot_run(tmp_path):
    raw = yaml.safe_load(open(VIT_B_YAML))
    path = tmp_path / "c.yaml"
    for section, key, value, err in (("clip", "fused", False, NotImplementedError),
                                     ("encoder", "no_such_key", 1, KeyError)):
        bad = yaml.safe_load(yaml.safe_dump(raw))
        bad["model"][section][key] = value
        path.write_text(yaml.safe_dump(bad))
        with pytest.raises(err, match=key if err is KeyError else "port"):
            config.cascade_config_from_yaml(str(path))
    with pytest.raises(ValueError, match="tuning_stage"):
        ref = yaml.safe_load(yaml.safe_dump(REFERENCE_FORMAT))
        ref["model"]["args"]["encoder_mode"]["tuning_stage"] = 12
        path.write_text(yaml.safe_dump(ref))
        config.cascade_config_from_yaml(str(path))


def test_config_loader_loads_remat_as_jax(tmp_path):
    """`encoder.remat: true` loads into the port's field, as into JAX's."""
    raw = yaml.safe_load(open(VIT_B_YAML))
    raw["model"]["encoder"]["remat"] = True
    path = tmp_path / "remat.yaml"
    path.write_text(yaml.safe_dump(raw))
    cfg, _ = config.cascade_config_from_yaml(str(path))
    jcfg, _ = j_config.cascade_config_from_yaml(str(path))
    assert cfg.encoder.remat is True and jcfg.encoder.remat is True
    assert as_plain(cfg) == as_plain(jcfg)


# ------------------------------------------- the copies of the JAX modules


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("ovcamo")
    return write_synthetic_ovcamo(str(root), n_train=4, n_test=5,
                                  sizes=((60, 80), (64, 64), (90, 70), (48, 100)))


def test_data_copies_match_jax(synthetic):
    info = yaml.safe_load(open(synthetic))
    assert ovcamo.TEST_CLASS_NAMES == j_ovcamo.TEST_CLASS_NAMES
    assert ovcamo.TRAIN_CLASS_NAMES == j_ovcamo.TRAIN_CLASS_NAMES
    for split in ("train", "test"):
        idx = ovcamo.OVCamoIndex.from_dataset_info(info, split)
        jidx = j_ovcamo.OVCamoIndex.from_dataset_info(info, split)
        assert idx.classes == jidx.classes
        assert [dataclasses.astuple(s) for s in idx.samples] == \
            [dataclasses.astuple(s) for s in jidx.samples]
    img = Image.open(idx.samples[0].image_path)
    mask = Image.open(idx.samples[0].mask_path)
    for name in ("sam_image_transform", "clip_image_transform", "sam_image_resized_u8",
                 "clip_image_resized_u8"):
        np.testing.assert_array_equal(getattr(transforms, name)(img, 64),
                                      getattr(j_transforms, name)(img, 64), err_msg=name)
    np.testing.assert_array_equal(transforms.mask_to_target(mask, 64),
                                  j_transforms.mask_to_target(mask, 64))
    np.testing.assert_array_equal(transforms.clip_alpha_transform(mask, 28),
                                  j_transforms.clip_alpha_transform(mask, 28))
    # the loader: PIL only in the port; the JAX package's native decoder, when
    # built, gives the same arrays
    for raw in (False, True):
        got = list(loader.iter_eval_batches(idx, 2, 64, 28, num_workers=2, raw_uint8=raw))
        want = list(j_loader.iter_eval_batches(jidx, 2, 64, 28, num_workers=2, raw_uint8=raw))
        assert [len(b) for b in got] == [len(b) for b in want] == [2, 2, 1]
        for bg, bw in zip(got, want):
            for g, w in zip(bg, bw):
                for f in ("inp", "gt", "clip_image", "clip_mask", "label_id", "orig_size"):
                    np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
    tidx = ovcamo.OVCamoIndex.from_dataset_info(info, "train")
    jtidx = j_ovcamo.OVCamoIndex.from_dataset_info(info, "train")
    got = list(loader.iter_train_batches(tidx, 2, np.random.default_rng(4), 64, 28, 2))
    want = list(j_loader.iter_train_batches(jtidx, 2, np.random.default_rng(4), 64, 28, 2))
    assert len(got) == len(want) == 2
    for bg, bw in zip(got, want):
        assert set(bg) == set(bw)
        for k in bw:
            np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)


def test_tokenizer_and_resize_copies_match_jax(rng):
    texts = ["a photo of a cat.", "X X X X owlfly larva.", "Ã©clair &amp; café", "non-succulent plant"]
    np.testing.assert_array_equal(tokenizer.tokenize(texts), j_tokenizer.tokenize(texts))
    assert os.path.exists(tokenizer.DEFAULT_BPE_PATH)
    assert os.path.dirname(tokenizer.DEFAULT_BPE_PATH).startswith(
        os.path.join(REPO, "camouflaged_vlm_tpu_torch"))
    x = rng.random((37, 50)).astype(np.float32)
    for h, w in ((37, 50), (64, 64), (20, 33)):
        np.testing.assert_array_equal(image.bilinear_resize_f32(x, h, w),
                                      j_image.bilinear_resize_f32(x, h, w))


def _masks(rng, n=4, shape=(40, 52)):
    out = []
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    for i in range(n):
        gt = (((yy - 15 - 2 * i) ** 2 + (xx - 20) ** 2) < 100 + 30 * i).astype(np.uint8) * 255
        pred = np.clip(gt * 0.7 + rng.random(shape) * 90, 0, 255).astype(np.uint8)
        out.append((pred, gt))
    out.append((rng.integers(0, 255, shape, dtype=np.uint8), np.zeros(shape, np.uint8)))
    return out


def test_metrics_match_jax(rng):
    """Every metric of the copy against the JAX package's on random masks:
    the per-image SOD measures, the COD accumulator, the class-aware OVCOS
    metricer with a class mismatch (zeroed scores) and the classification
    evaluator (macro-F1 without sklearn)."""
    pairs = _masks(rng)
    for pred, gt in pairs:
        p, g = metrics.prepare_pred_gt(pred, gt)
        jp, jg = j_metrics.prepare_pred_gt(pred, gt)
        np.testing.assert_array_equal(p, jp)
        assert metrics.s_measure(p, g) == pytest.approx(j_metrics.s_measure(jp, jg), rel=1e-12)
        assert metrics.weighted_f_measure(p, g) == pytest.approx(
            j_metrics.weighted_f_measure(jp, jg), rel=1e-12)
        assert metrics.mae_score(p, g) == j_metrics.mae_score(jp, jg)
        a, b = metrics.threshold_curves(p, g), j_metrics.threshold_curves(jp, jg)
        for f in dataclasses.fields(b):
            np.testing.assert_allclose(getattr(a, f.name), getattr(b, f.name), rtol=1e-12)
    cod, jcod = metrics.CODMetrics(), j_metrics.CODMetrics()
    names = ["cat", "owl", "bat"]
    ov = metrics.OVCOSMetricer(names, num_workers=2)
    jov = j_metrics.OVCOSMetricer(names, num_workers=2)
    for i, (pred, gt) in enumerate(pairs):
        cod.step(pred / 255.0, gt / 255.0)
        jcod.step(pred / 255.0, gt / 255.0)
        pre_cls = names[i % 3]  # every third image has the right class
        ov.step(pred, gt, pre_cls, "cat")
        jov.step(pred, gt, pre_cls, "cat")
    np.testing.assert_allclose(cod.results(), jcod.results(), rtol=1e-12)
    got, want = ov.show(num_bits=None), jov.show(num_bits=None)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    mismatch = metrics.calc_ovcamo(pairs[0][0], pairs[0][1], "owl", "cat")
    assert mismatch["sm"] == 0 and mismatch["mae"] == 1 and mismatch["maxfm"] == 0
    logits = rng.standard_normal((23, 7))
    labels = rng.integers(0, 6, 23)  # class 6 never true: excluded from macro-F1
    clf, jclf = metrics.ClassificationEvaluator(), j_metrics.ClassificationEvaluator()
    for sl in (slice(0, 10), slice(10, 23)):
        clf.process(logits[sl], labels[sl])
        jclf.process(logits[sl], labels[sl])
    got, want = clf.evaluate(), jclf.evaluate()
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


# ------------------------------------------------------------- evaluate()


def random_params(shapes, seed=0):
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        name = str(path[-1].key)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)
        if name == "logit_scale":
            return np.full(sd.shape, np.log(1 / 0.07), np.float32)
        return (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_evaluate_matches_jax(synthetic):
    """The port's `evaluate()` against JAX's on the synthetic test split (5
    images of 4 sizes, batch 2, so the last batch is short), the tiny
    cascade in both packages on the same weights (SAM 'flash' at 4 heads:
    the unfused path), fp32, probabilities returned in fp32."""
    info = yaml.safe_load(open(synthetic))
    jidx = j_ovcamo.OVCamoIndex.from_dataset_info(info, "test")
    idx = ovcamo.OVCamoIndex.from_dataset_info(info, "test")
    jcfg = JCascadeConfig.tiny()
    jmodel = JCascade(jcfg)
    jbank = j_make_bank_inputs(jcfg, jidx.classes, seed=0)
    S, C = jcfg.inp_size, jcfg.clip_size
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, S, S, 3)), jnp.zeros((1, C, C, 3)),
                              jnp.zeros((1, C, C, 1)), jbank["prefix"], jbank["suffix"],
                              jbank["eot_indices"], jbank["bank_features"],
                              method=jmodel.infer_cascade),
        jax.random.PRNGKey(0))
    params = random_params(shapes, seed=5)
    want = j_evaluate.evaluate(jmodel, jcfg, jax.tree.map(jnp.asarray, params), jbank, jidx,
                               batch_size=2, num_workers=2, mask_dtype="float32")
    cfg = CascadeConfig.tiny()
    model = build_cascade(cfg, "cpu")
    load_jax_params(model, params, cfg)
    bank = make_bank_inputs(cfg, idx.classes, seed=0)
    got = evaluate.evaluate(model, cfg, bank, idx, batch_size=2, num_workers=2,
                            mask_dtype="float32")
    assert set(got) == set(want)
    assert got["images"] == want["images"] == 5
    for k in ("accuracy", "error_rate", "top5", "macro_f1"):
        assert got[k] == want[k], k
    for k in set(want) - {"images", "images_per_sec", "accuracy", "error_rate", "top5",
                          "macro_f1"}:
        assert abs(got[k] - want[k]) <= 5e-3, (k, got[k], want[k])
    assert got["images_per_sec"] > 0
    assert 0 < want["ori_sm"] < 1 and want["maxfm"] > 0  # not degenerate


@pytest.fixture(scope="module")
def tiny_eval(synthetic):
    """The tiny cascade in fp32 on the CPU, its test split and bank."""
    info = yaml.safe_load(open(synthetic))
    idx = ovcamo.OVCamoIndex.from_dataset_info(info, "test")
    cfg = CascadeConfig.tiny()
    model = build_cascade(cfg, "cpu", seed=4)
    return model, cfg, make_bank_inputs(cfg, idx.classes, seed=0), idx


def _same_results(got, want, exact=False):
    assert set(got) == set(want) and got["images"] == want["images"] == 5
    for k in set(want) - {"images_per_sec"}:
        if exact:
            assert got[k] == want[k], k
        else:  # the results carry 4 decimals (classification 2)
            assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


def test_evaluate_pads_a_short_last_batch(tiny_eval):
    """5 images at batch 2 (the last batch of 1 padded by repeating its
    sample, the pad row dropped) give batch 1's results."""
    model, cfg, bank, idx = tiny_eval
    got = evaluate.evaluate(model, cfg, bank, idx, batch_size=2, num_workers=2,
                            mask_dtype="float32")
    want = evaluate.evaluate(model, cfg, bank, idx, batch_size=1, num_workers=2,
                             mask_dtype="float32")
    _same_results(got, want)
    assert 0 < want["ori_sm"] < 1


class _ReplayStandIn:
    """`graphs.GraphedCall` as a replay behaves on the card: the function
    runs, and every call hands back the same output buffers, which the next
    call overwrites."""

    def __init__(self, fn, *example_inputs, **kw):
        self.fn, self.static_outputs, self.calls = fn, None, 0

    def __call__(self, *inputs):
        outs = self.fn(*inputs)
        if self.static_outputs is None:
            self.static_outputs = tuple(torch.empty_like(t) for t in outs)
        for s, o in zip(self.static_outputs, outs):
            s.copy_(o)
        self.calls += 1
        return self.static_outputs


def test_evaluate_keeps_no_replay_output(tiny_eval, monkeypatch):
    """With static output buffers reused by every replay (at float32
    masks, where probs.to() is probs itself) and IN_FLIGHT batches queued
    before the oldest is read, evaluate() returns the eager run's results
    exactly: it copies what it reads before the next replay."""
    model, cfg, bank, idx = tiny_eval
    want = evaluate.evaluate(model, cfg, bank, idx, batch_size=2, num_workers=2,
                             mask_dtype="float32", graph=False)
    made = []
    monkeypatch.setattr(evaluate, "GraphedCall",
                        lambda *a, **k: made.append(_ReplayStandIn(*a, **k)) or made[-1])
    got = evaluate.evaluate(model, cfg, bank, idx, batch_size=2, num_workers=2,
                            mask_dtype="float32")
    assert len(made) == 1 and made[0].calls == 3 > evaluate.IN_FLIGHT - 1
    _same_results(got, want, exact=True)


def test_evaluate_cli_on_cpu_writes_results(synthetic, tmp_path, capsys, monkeypatch):
    """The CLI with `--config` (a native tiny yaml) on the CPU; the train CLI
    trains from the same yaml, whose train section sets its recipe (one
    epoch at batch 2, validated after it). `--device cuda` without a card
    raises before any output."""
    raw = yaml.safe_load(open(VIT_B_YAML))
    m = raw["model"]
    m.update(inp_size=64, clip_size=28, dtype="float32")
    m["encoder"].update(img_size=64, embed_dim=96, depth=4, num_heads=12, out_chans=32,
                        window_size=2, global_attn_indexes=[1, 3], prompt_scale_factor=8)
    m["decoder"] = {"transformer_dim": 32, "transformer": {"num_heads": 4, "mlp_dim": 64}}
    m["clip"] = dict(image_resolution=28, vision_patch_size=14, vision_width=32,
                     vision_layers=3, vision_heads=4, embed_dim=16, transformer_width=24,
                     transformer_heads=4, transformer_layers=3, n_ctx=2, prompt_depth=2)
    raw["train"] = {"epochs": 1, "batch_size": 2, "epoch_val": 1}
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    out = tmp_path / "eval"
    res = evaluate.main(["--dataset-info", synthetic, "--config", str(path), "--device", "cpu",
                         "--batch-size", "2", "--output-dir", str(out), "--save-images"])
    written = json.loads((out / "results.json").read_text())
    assert written == res and res["images"] == 5
    assert all(np.isfinite(v) for v in res.values())
    assert len(os.listdir(out / "result_image")) == 5
    assert "attn_impl='flash'" in capsys.readouterr().out

    from camouflaged_vlm_tpu_torch.cli import train as train_cli

    # no tensorboard here (its import takes seconds): the scalars are
    # test_torch_train.py's
    monkeypatch.setattr(train_cli, "tensorboard_writer", lambda logdir: None)
    run = train_cli.main(["--dataset-info", synthetic, "--config", str(path), "--device", "cpu",
                          "--epochs", "5", "--batch-size", "4", "--epoch-val", "3",
                          "--save-dir", str(tmp_path / "train")])
    assert run["step"] == 2 and run["model"].cfg.encoder.num_heads == 12
    assert [v["epoch"] for v in run["validations"]] == [1]
    assert all(np.isfinite(v) for v in run["epochs"][0].values())
    moved = [n for n, p in run["model"].named_parameters() if p.requires_grad]
    assert moved

    with pytest.raises(ValueError, match="exclusive"):
        evaluate.main(["--dataset-info", synthetic, "--config", str(path), "--tiny",
                       "--device", "cpu", "--output-dir", str(tmp_path / "x")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main(["--dataset-info", synthetic, "--tiny",
                           "--output-dir", str(tmp_path / "cuda")])
        assert not (tmp_path / "cuda").exists()


def test_eval_throughput_reports_each_run(tmp_path):
    """The throughput script on the CPU at the tiny config: one row per batch
    size with the CLI's rate beside the device-only and host-only rates, its
    results.json per run, and the synthetic split removed."""
    from camouflaged_vlm_tpu_torch.cli import eval_throughput

    work, out = tmp_path / "work", tmp_path / "out"
    rows = eval_throughput.main(["--configs", "tiny", "--device", "cpu", "--dtype", "float32",
                                 "--images", "5", "--batch-sizes", "2", "3", "--iters", "1",
                                 "--work", str(work), "--out", str(out)])
    assert [(r["config"], r["batch"], r["images"]) for r in rows] == [("tiny", 2, 5),
                                                                      ("tiny", 3, 5)]
    for r in rows:
        assert r["attn_impl"] == "flash" and r["peak_gib"] is None
        for k in ("images_per_sec", "cascade_call_ms", "device_only_images_per_sec",
                  "host_only_images_per_sec"):
            assert np.isfinite(r[k]) and r[k] > 0, k
        assert (out / f"tiny_b{r['batch']}" / "results.json").exists()
    assert json.loads((out / "eval_throughput.json").read_text()) == rows
    assert not work.exists()


def test_evaluate_cli_checkpoint_flags_assemble_as_jax_cli(synthetic, tmp_path, monkeypatch):
    """The CLI with the reference's four files (--sam-ckpt, --clip-ckpt,
    --maple-ckpt, --text-bank; tiny, fp32) builds the model and the test
    split's bank that JAX's CLI assembles from the same flags, bit for bit
    (both run up to the evaluation; JAX's init is the port's seeded random
    weights, `tests/_torch_ckpt_files.py`); a missing file raises before the
    evaluation."""
    from _torch_ckpt_files import (
        Stop,
        assert_bank_equal,
        assert_state_equal,
        jax_state_dict,
        run_jax_cli,
        write_reference_files,
    )

    classes = ovcamo.OVCamoIndex.from_dataset_info(yaml.safe_load(open(synthetic)),
                                                   "test").classes
    files = write_reference_files(tmp_path, classes)
    flags = ["--dataset-info", synthetic, "--tiny", "--dtype", "float32",
             "--sam-ckpt", files["sam.pth"], "--clip-ckpt", files["clip.pt"],
             "--maple-ckpt", files["maple.pth.tar"], "--text-bank", files["bank.npy"]]
    _, _, params, jbank = run_jax_cli(j_evaluate, flags + ["--output-dir", str(tmp_path / "j")],
                                      monkeypatch)["assembled"]
    seen = {}

    def stop(model, cfg, bank, index, **kw):
        seen.update(model=model, bank=bank)
        raise Stop

    monkeypatch.setattr(evaluate, "evaluate", stop)
    with pytest.raises(Stop):
        evaluate.main(flags + ["--device", "cpu", "--output-dir", str(tmp_path / "p")])
    assert_state_equal(seen["model"].state_dict(), jax_state_dict(params))
    assert_bank_equal(seen["bank"], jbank)
    with pytest.raises(FileNotFoundError, match="--sam-ckpt"):
        evaluate.main(flags[:5] + ["--sam-ckpt", str(tmp_path / "none.pth"), "--device", "cpu",
                                   "--output-dir", str(tmp_path / "p2")])


# -------------------------------------------------------------- isolation


def test_port_imports_nothing_of_the_jax_package():
    """In a fresh process where the JAX package cannot be imported at all,
    every module of the port, graft_entry_torch.py and ab_fullsize_torch.py
    import and jax stays unloaded; and no source file of the port, nor
    chip_smoke.py, graft_entry_torch.py or ab_fullsize_torch.py (which
    chip_smoke.py imports on the card's host) names the JAX package or jax
    in an import."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['camouflaged_vlm_tpu'] = None\n"
        "import camouflaged_vlm_tpu_torch as pkg\n"
        "import graft_entry_torch\n"
        "import ab_fullsize_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in sys.modules and 'flax' not in sys.modules\n"
        "print('IMPORTED', len(names))\n"
        "print('NAMES', ' '.join(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split("IMPORTED")[1].split()[0]) > 40
    # the serving engine, the graph helper, the bench, the checkpoint
    # interop and bank precompute modules and MaPLe training among them
    imported = set(proc.stdout.split("NAMES")[1].split())
    for m in ("serve", "graphs", "ops.constants", "cli.serve", "cli.bench",
              "cli.serve_throughput", "io.torch_loader", "io.synthetic",
              "cli.precompute_text_bank", "cli.export_checkpoint", "data.templates",
              "train.maple", "cli.train_maple", "parallel.mesh", "parallel.sharding"):
        assert f"camouflaged_vlm_tpu_torch.{m}" in imported, m

    import ast

    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "graft_entry_torch.py",
                                             "ab_fullsize_torch.py")]
    for root, _, names in os.walk(os.path.join(REPO, "camouflaged_vlm_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("camouflaged_vlm_tpu", "jax", "jaxlib", "flax", "optax"), \
                    (path, mod)
