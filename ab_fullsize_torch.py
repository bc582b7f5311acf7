#!/usr/bin/env python3
"""Full-size fp32 A/B of the PyTorch port against the JAX package, on the CPU.

The port's counterpart of `scripts/ab_fullsize_cpu.py`: the production
configuration (SAM ViT-H at 1024 px, 32 blocks with global blocks 7/15/23/31;
Alpha-CLIP ViT-L/14@336 with MaPLe prompts of depth 9; the 61 OVCamo test
classes) runs in both packages on the same weights and inputs, fp32 on the
CPU. On the JAX side the Pallas sites fall back to their XLA formulations; on
the port's side every kernel wrapper runs its plain version.

Three legs:
  infer   `infer_cascade_with_text` on six routes (the repo's ViT-H yaml on
          'flash' at batch 2; then at batch 1 the same on 'reference' with
          exact GELU, SAM ViT-B 'flash', ViT-H 'aug_flash', ViT-H at windows
          16 and 17), with taps along the cascade: the patch embedding, the
          EVP prompt features, block 0, the last windowed block before each
          global block and each global block, the neck, CLIP pass 1's image
          feature, the sparse prompts, the low-resolution mask logits, the
          upsampled probabilities, the 336 alpha, CLIP pass 2's feature, the
          class logits and the class;
  train   one cascade train step at batch 1 (each package's make_train_step,
          the forward conditioned on the test split's text features, block
          remat on both sides at full size): the loss and every trainable
          gradient;
  maple   one MaPLe step at batch 2 on the 14 train classes (the loss and
          the prompt learner's gradients), and the 61 test classes' text bank
          through each package's `precompute_text_bank.encode_text_features`.

Weights come from `draw_weights` (numpy only, one generator per key of the
port's state dict), which both packages load strictly; the JAX side through
its own converter. Each side of each leg runs in a subprocess of its own
(`--side torch` here, `tests/_ab_fullsize_jax.py` for JAX), writes its taps to
an .npz under build/ab_fullsize/, and the parent compares the files, so the
memory peak is one package's. Each leg prints one JSON line (per tap the
mean_rel, max_rel and max_abs, and the port's self-gap: the port against
itself with its inputs scaled by 1 + 2^-23), the last line PASS or FAIL.

  python ab_fullsize_torch.py                       # all legs (~30 min on 8 CPUs)
  python ab_fullsize_torch.py --legs infer --routes vit_h_flash_win17
  python ab_fullsize_torch.py --small               # the same code at small widths
  python ab_fullsize_torch.py --write-golden        # tests/data/jax_fullsize_golden.npz

This file imports neither jax nor the JAX package: `chip_smoke.py` imports
its weight draw, inputs and taps on the card's host, which has no jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "ab_fullsize")
JAX_SIDE = os.path.join(REPO, "tests", "_ab_fullsize_jax.py")
GOLDEN = os.path.join(REPO, "tests", "data", "jax_fullsize_golden.npz")
VIT_H_YAML = os.path.join(REPO, "configs", "ovcos-sam-vit-h-maskdecoder-edge.yaml")
VIT_B_YAML = os.path.join(REPO, "camouflaged_vlm_tpu_torch", "configs",
                          "ovcos-sam-vit-b-maskdecoder-edge.yaml")
HOST = f"this host's CPU ({os.cpu_count()} CPUs, no card used)"

WEIGHT_SEED, IMAGE_SEED, BANK_SEED, TRAIN_SEED, MAPLE_SEED, TOKEN_SEED = 27, 1, 2, 3, 4, 5
# the last layer of each output hypernetwork is scaled so that the mask
# logits saturate the sigmoid: the 336 alpha then carries a mask, not 0.5
HYPER_SCALE = 300.0
NOISE = 1.0 + 2.0 ** -23  # the self-gap's input scale
ONES_ALPHA = (1.0 - 0.5) / 0.26  # the data pipeline's all-ones alpha, normalised

# the bounds; a failed bound is a fault to find
TAP_MEAN_REL = 1e-4      # every inference tap
PROB_MAX_ABS = 5e-3      # the upsampled probabilities (scripts/ab_fullsize_cpu.py)
LOGIT_RANGE_SHARE = 1e-3  # class logits: max abs <= this x their range
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-3    # |d|_2 / max(|g|_2, GRAD_FLOOR x the largest leaf's |g|_2)
# under 1e-5 of the largest leaf's gradient the cascade has only the q/k
# projections of the decoder's two-way transformer (1e-11 to 5e-6 of the
# largest; the k biases are zero in exact arithmetic, softmax ignores them),
# where the port against itself with its image x (1 + 2^-23) already differs
# by up to 1.7 relative L2, and the IoU head and hypernetworks 1-3, which the
# loss does not reach (exactly zero on both sides). Such a leaf is held to
# |d|_2 <= 1e-8 of the largest leaf's |g|_2, every other to plain relative L2.
GRAD_FLOOR = 1e-5
MAPLE_LOSS_REL = 1e-5
MAPLE_GRAD_REL = 1e-4    # max|d| / max|g| per prompt-learner tensor
BANK_REL = 1e-4          # max|d| / max|bank|
COVERAGE = (0.05, 0.95)  # each image's share of pixels with probability > 0.5

ROUTES = {
    "vit_h_flash": dict(yaml=VIT_H_YAML, batch=2),
    "vit_h_reference": dict(yaml=VIT_H_YAML, batch=1,
                            encoder=dict(attn_impl="reference", gelu_approximate=False)),
    "vit_b_flash": dict(yaml=VIT_B_YAML, batch=1),
    "vit_h_aug_flash": dict(yaml=VIT_H_YAML, batch=1, encoder=dict(attn_impl="aug_flash")),
    "vit_h_flash_win16": dict(yaml=VIT_H_YAML, batch=1, encoder=dict(window_size=16)),
    "vit_h_flash_win17": dict(yaml=VIT_H_YAML, batch=1, encoder=dict(window_size=17)),
}
LEGS = ("infer", "train", "maple")
ROUTE_1 = "vit_h_flash"  # also the train and MaPLe legs' and the golden's

# --small: the same routes at widths the card's small configurations use,
# depth 2 (a windowed block, then a global one, as ViT-H ends); every
# windowed grid has edge windows
SMALL_CLIP = dict(image_resolution=28, vision_patch_size=14, vision_width=128, vision_layers=2,
                  vision_heads=8, embed_dim=64, transformer_width=128, transformer_heads=4,
                  transformer_layers=2, n_ctx=2, prompt_depth=2)
_SMALL_SAM = dict(img_size=160, embed_dim=128, depth=2, num_heads=8, window_size=4,
                  global_attn_indexes=[1], prompt_scale_factor=16)
SMALL_SAM = {
    "vit_h_flash": _SMALL_SAM,
    "vit_h_reference": _SMALL_SAM,
    "vit_b_flash": dict(_SMALL_SAM, embed_dim=64, num_heads=4),  # unfused, as ViT-B's 12
    # global blocks of 1024 tokens: 'aug_flash' runs them on its streaming kernel
    "vit_h_aug_flash": dict(_SMALL_SAM, img_size=512, embed_dim=64, num_heads=4, window_size=8),
    # the padded window carry, global blocks of 400 tokens
    "vit_h_flash_win16": dict(_SMALL_SAM, img_size=320, window_size=16),
    "vit_h_flash_win17": dict(_SMALL_SAM, img_size=320, window_size=17),
}
# --small runs CLIP and the decoder's two-way transformer one layer deep
# where the leg does not test them (see `is_light`)
SMALL_LIGHT = dict(clip=dict(vision_layers=1, transformer_layers=1, prompt_depth=1),
                   decoder=dict(depth=1))


def is_light(leg: str, route: str, small: bool) -> bool:
    """Whether --small runs `leg` on `route` with SMALL_LIGHT: routes 2-6
    differ from route 1 only in the image encoder, and the train step
    trains no CLIP weight (its decoder's backward at depth 2 is held to JAX
    in tests/test_torch_train.py); route 1's inference and the MaPLe leg
    keep CLIP's and the decoder's depth 2."""
    return small and (leg == "train" or (leg == "infer" and route != ROUTE_1))


# ----------------------------------------------------------- configuration


def route_raw(route: str, small: bool, light: bool = False) -> dict:
    """The route's configuration as a yaml dict in fp32: the repo's yaml with
    the route's encoder overrides, at --small also its small widths (and
    SMALL_LIGHT's depths where `light`)."""
    import yaml

    spec = ROUTES[route]
    with open(spec["yaml"]) as f:
        raw = yaml.safe_load(f)
    m = raw["model"]
    m["dtype"] = "float32"
    m["encoder"].update(spec.get("encoder", {}))
    if small:
        m["encoder"].update(SMALL_SAM[route])
        m["clip"].update(SMALL_CLIP)
        if light:
            m["clip"].update(SMALL_LIGHT["clip"])
            m["decoder"]["transformer"].update(SMALL_LIGHT["decoder"])
        m["inp_size"] = m["encoder"]["img_size"]
        m["clip_size"] = SMALL_CLIP["image_resolution"]
    return raw


def route_yaml(route: str, small: bool, out_dir: str = OUT_DIR, light: bool = False) -> str:
    """`route_raw` written under `out_dir`, both packages read that file;
    written whole under another name first, as sides on other threads may
    be reading it."""
    import threading

    import yaml

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{route}{'_small' if small else ''}{'_light' if light else ''}"
                                 ".yaml")
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        yaml.safe_dump(route_raw(route, small, light), f)
    os.replace(tmp, path)
    return path


def port_config(route: str, small: bool, out_dir: str = OUT_DIR, light: bool = False):
    from camouflaged_vlm_tpu_torch.config import cascade_config_from_yaml

    return cascade_config_from_yaml(route_yaml(route, small, out_dir, light))[0]


def tap_blocks(depth: int, window_size: int, global_attn_indexes) -> list:
    """Block 0, the last windowed block before each global block, each
    global block."""
    g = sorted(global_attn_indexes) if window_size > 0 else []
    return sorted({0} | {i - 1 for i in g if i > 0} | set(g))


# ----------------------------------------------------------------- weights


def port_shapes(cfg) -> dict:
    """{key: shape} of the port's state dict (the reference's names)."""
    import torch
    from camouflaged_vlm_tpu_torch.models import OVCOSCascade

    with torch.device("meta"):
        model = OVCOSCascade(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _draw(k: str, shape: tuple, seed: int, i: int) -> np.ndarray:
    if k.endswith("logit_scale"):
        return np.full(shape, np.log(1.0 / 0.07), np.float32)
    v = np.random.default_rng([seed, i]).standard_normal(shape, dtype=np.float32)
    if k == "pe_layer.positional_encoding_gaussian_matrix":
        return v
    v *= np.float32(0.02)
    if len(shape) == 1 and k.endswith("weight"):
        v += np.float32(1.0)
    if ".output_hypernetworks_mlps." in k and ".layers.2." in k:
        v *= np.float32(HYPER_SCALE)
    return v


def draw_weights(shapes: dict, seed: int = WEIGHT_SEED, keys=None) -> dict:
    """fp32 numpy weights for the keys of `shapes`, each from its own
    generator `default_rng([seed, i])`, i its index in sorted order (so a
    subset draws the same values, and the keys are drawn on a thread pool:
    numpy fills an array without the GIL): LayerNorm weights 1 + N(0,
    0.02^2), other vectors N(0, 0.02^2), matrices and convolutions N(0,
    0.02^2), the decoder's Gaussian PE matrix N(0, 1), the CLIP logit scale
    log(1/0.07); the last layer of each output hypernetwork times
    HYPER_SCALE."""
    from concurrent.futures import ThreadPoolExecutor

    want = set(shapes if keys is None else keys)
    jobs = [(k, shapes[k], seed, i) for i, k in enumerate(sorted(shapes)) if k in want]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return dict(zip((j[0] for j in jobs), pool.map(lambda j: _draw(*j), jobs)))


def load_port_cascade(cfg, weights: dict, device="cpu", rel_cache: bool = True):
    """The port's cascade on `device` in cfg's types with `weights` loaded
    strictly, no parameter requiring grad, the rel cache attached."""
    import torch
    from camouflaged_vlm_tpu_torch.factory import attach_rel_cache, cast_weights_
    from camouflaged_vlm_tpu_torch.models import OVCOSCascade

    with torch.device("meta"):
        model = OVCOSCascade(cfg)
    cast_weights_(model, cfg.encoder.dtype)
    model = model.to_empty(device=device)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()}, strict=True)
    model = model.eval().requires_grad_(False)
    return attach_rel_cache(model) if rel_cache else model


# ------------------------------------------------------------------ inputs


def make_inputs(inp_size: int, clip_size: int, batch: int, seed: int = IMAGE_SEED,
                noise: float = 1.0):
    """(inp, clip image, clip alpha) NHWC fp32: two seeded images, the first
    `batch` of them (batch 1 is the first image of batch 2), the alpha all
    ones; `noise` scales both images."""
    rng = np.random.default_rng(seed)
    inp = rng.standard_normal((2, inp_size, inp_size, 3), dtype=np.float32)[:batch]
    cimg = rng.standard_normal((2, clip_size, clip_size, 3), dtype=np.float32)[:batch]
    cmask = np.full((batch, clip_size, clip_size, 1), ONES_ALPHA, np.float32)
    s = np.float32(noise)
    return inp * s, cimg * s, cmask


def _disc(rng, n: int, size: int) -> np.ndarray:
    """(n, size, size, 1) 0/1 discs at seeded centres and radii."""
    yy, xx = np.mgrid[:size, :size]
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(0.3, 0.7, 2) * size
        r = rng.uniform(0.15, 0.3) * size
        out.append(((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)[..., None])
    return np.stack(out).astype(np.float32)


def make_train_batch(inp_size: int, clip_size: int, seed: int = TRAIN_SEED, noise: float = 1.0):
    """One image: inp, a disc as gt, clip image, the all-ones alpha."""
    inp, cimg, cmask = make_inputs(inp_size, clip_size, 1, seed, noise)
    gt = _disc(np.random.default_rng([seed, 1]), 1, inp_size)
    return {"inp": inp, "gt": gt, "clip_image": cimg, "clip_mask": cmask}


def make_maple_batch(clip_size: int, n_classes: int, seed: int = MAPLE_SEED, noise: float = 1.0):
    """Two images with disc alphas (normalised as the data pipeline does)
    and seeded labels."""
    _, cimg, _ = make_inputs(clip_size, clip_size, 2, seed, noise)
    rng = np.random.default_rng([seed, 1])
    alpha = (_disc(rng, 2, clip_size) - np.float32(0.5)) / np.float32(0.26)
    labels = rng.integers(0, n_classes, 2).astype(np.int32)
    return {"clip_image": cimg, "clip_alpha": alpha, "label_id": labels}


def token_embedding(vocab: int, width: int, seed: int = TOKEN_SEED, noise: float = 1.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((vocab, width), dtype=np.float32) * np.float32(0.02 * noise)


# -------------------------------------------------------------------- taps


def port_taps(model, cfg, inp, cimg, cmask, text_features) -> dict:
    """`infer_cascade_with_text` with its stages' outputs kept (forward
    hooks, and wrappers of the methods that are not a module's forward),
    as fp32 numpy; windowed blocks' outputs back on the (B, h, w, C) grid."""
    import torch
    from camouflaged_vlm_tpu_torch.ops.compact_window import compact_unpartition
    from camouflaged_vlm_tpu_torch.ops.window import window_unpartition_seq

    taps = {}
    enc, e = model.image_encoder, cfg.encoder
    g, win, B = cfg.embedding_size, e.window_size, inp.shape[0]

    def keep(name, t):
        taps[name] = t.detach().float().cpu().numpy()

    def block_hook(i):
        def hook(mod, args, kwargs, out):
            if isinstance(out, tuple):  # compact carry
                out = compact_unpartition(out[0], out[1], kwargs["geom"])
            elif out.shape[0] != B:  # padded window carry
                pad = -(-g // win) * win
                out = window_unpartition_seq(out, win, (pad, pad), (g, g))
            keep(f"block_{i}", out.reshape(B, g, g, -1))
        return hook

    handles = [enc.patch_embed.register_forward_hook(lambda m, a, o: keep("patch_embed", o)),
               enc.register_forward_hook(lambda m, a, o: keep("neck", o[0])),
               model.mask_decoder.register_forward_hook(lambda m, a, o: keep("mask_lowres", o[0]))]
    for i in tap_blocks(e.depth, win, e.global_attn_indexes):
        handles.append(enc.blocks[i].register_forward_hook(block_hook(i), with_kwargs=True))
    calls = []

    def wrap(obj, name, record):
        orig = getattr(obj, name)

        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            record(args, out)
            return out

        setattr(obj, name, wrapper)
        return lambda: delattr(obj, name)

    def classified(args, out):
        calls.append(None)
        if len(calls) == 1:
            keep("clip1_image_feat", out[0])
        else:
            keep("alpha", args[1])
            keep("clip2_image_feat", out[0])

    undo = [wrap(enc.prompt_generator, "init_features",
                 lambda a, o: keep("prompt_features", o)),
            wrap(model, "_sparse_embeddings", lambda a, o: keep("sparse", o)),
            wrap(model.clip_model, "classify", classified)]
    try:
        with torch.no_grad():
            probs, pred, score = model.infer_cascade_with_text(inp, cimg, cmask, text_features)
    finally:
        for h in handles:
            h.remove()
        for u in undo:
            u()
    keep("probs", probs)
    keep("class_logits", score)
    taps["pred"] = pred.cpu().numpy().astype(np.int64)
    return taps


# ------------------------------------------------------------- torch side


def _peak_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _bank(cfg, classes, device="cpu"):
    from camouflaged_vlm_tpu_torch.factory import make_bank_inputs

    b = make_bank_inputs(cfg, classes, seed=BANK_SEED, device=device)
    return b["prefix"], b["suffix"], b["eot_indices"], b["bank_features"]


def grad_capture(named):
    """An optimizer over the (name, parameter) pairs `named` whose step keeps
    each gradient (`.grads`, by name) and moves nothing, so that the port's
    own train step yields its gradients."""
    import torch

    class Capture(torch.optim.Optimizer):
        def __init__(self):
            super().__init__([p for _, p in named], {"lr": 0.0})
            self.names = {id(p): n for n, p in named}
            self.grads = {}

        @torch.no_grad()
        def step(self, closure=None):
            for group in self.param_groups:
                for p in group["params"]:
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    self.grads[self.names[id(p)]] = g.float().numpy().copy()

    return Capture()


def torch_infer(route: str, small: bool, out_dir: str = OUT_DIR) -> dict:
    import torch
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES

    t0 = time.perf_counter()
    cfg = port_config(route, small, out_dir, is_light("infer", route, small))
    model = load_port_cascade(cfg, draw_weights(port_shapes(cfg)))
    t_load = time.perf_counter() - t0
    tf = model.encode_class_text_features(*_bank(cfg, TEST_CLASS_NAMES))
    out = {}
    for tag, noise in (("", 1.0), ("self_", NOISE)):
        args = [torch.from_numpy(a) for a in
                make_inputs(cfg.inp_size, cfg.clip_size, ROUTES[route]["batch"], noise=noise)]
        t1 = time.perf_counter()
        taps = port_taps(model, cfg, *args, tf)
        out.update({tag + k: v for k, v in taps.items()})
        out[f"{tag}forward_s"] = time.perf_counter() - t1
    out["text_features"] = tf.numpy()
    out["load_s"] = t_load
    return out


def torch_train(route: str, small: bool, out_dir: str = OUT_DIR) -> dict:
    """One step of the port's make_train_step (block remat on at full size,
    for memory, as on the JAX side), its gradients captured by an optimizer
    that moves nothing; twice, the second with the image scaled by NOISE."""
    import torch
    from camouflaged_vlm_tpu_torch import train
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES

    cfg = port_config(route, small, out_dir, is_light("train", route, small))
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, remat=not small))
    model = load_port_cascade(cfg, draw_weights(port_shapes(cfg)))
    tf = model.encode_class_text_features(*_bank(cfg, TEST_CLASS_NAMES))
    train.trainable_parameters(model)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    out = {}
    for tag, noise in (("", 1.0), ("self_", NOISE)):
        opt = grad_capture(named)
        step = train.make_train_step(model, opt, lambda s: 0.0, loss_mode="iou")
        batch = {k: torch.from_numpy(v) for k, v in
                 make_train_batch(cfg.inp_size, cfg.clip_size, noise=noise).items()}
        t1 = time.perf_counter()
        m = step({**batch, "text_features": tf}, 0)
        out[f"{tag}step_s"] = time.perf_counter() - t1
        out[f"{tag}loss"] = np.float64(m["loss"])
        out.update({f"{tag}grad/{k}": v for k, v in opt.grads.items()})
    return out


def torch_maple(route: str, small: bool, out_dir: str = OUT_DIR) -> dict:
    """One MaPLe step (batch 2, the 14 train classes) of the cascade's
    CustomClip through the port's make_maple_train_step, and the 61 test
    classes' text bank through the port's precompute CLI; each twice, the
    second with its inputs scaled by NOISE."""
    import torch
    from camouflaged_vlm_tpu_torch.cli import precompute_text_bank as bank_cli
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES, TRAIN_CLASS_NAMES
    from camouflaged_vlm_tpu_torch.data.templates import TEMPLATE_SETS
    from camouflaged_vlm_tpu_torch.models.clip import CustomClip
    from camouflaged_vlm_tpu_torch.train.maple import make_maple_train_step

    cfg = port_config(route, small, out_dir)
    shapes = port_shapes(cfg)
    w = draw_weights(shapes, keys=[k for k in shapes if k.startswith("clip_model.")])
    with torch.device("meta"):
        clip = CustomClip(cfg.clip)
    clip = clip.to_empty(device="cpu")
    clip.load_state_dict({k[len("clip_model."):]: torch.from_numpy(v) for k, v in w.items()},
                         strict=True)
    clip.eval()
    for n, p in clip.named_parameters():
        p.requires_grad_(n.startswith("prompt_learner."))
    named = [("clip_model." + n, p) for n, p in clip.named_parameters() if p.requires_grad]
    bank = _bank(cfg, TRAIN_CLASS_NAMES)
    out = {}
    for tag, noise in (("", 1.0), ("self_", NOISE)):
        opt = grad_capture(named)
        step = make_maple_train_step(clip, opt, lambda s: 0.0)
        b = {k: torch.from_numpy(v) for k, v in
             make_maple_batch(cfg.clip_size, len(TRAIN_CLASS_NAMES), noise=noise).items()}
        b.update(zip(("prefix", "suffix", "eot_indices", "bank_features"), bank))
        t1 = time.perf_counter()
        m = step(b, 0)
        out[f"{tag}step_s"] = time.perf_counter() - t1
        out[f"{tag}loss"] = np.float64(m["loss"])
        out.update({f"{tag}grad/{k}": v for k, v in opt.grads.items()})
    text = "clip_model.text_encoder."
    tower = bank_cli.build_text_tower(
        cfg.clip, {k[len(text):]: torch.from_numpy(v) for k, v in w.items() if k.startswith(text)},
        "cpu")
    for tag, noise in (("", 1.0), ("self_", NOISE)):
        enc = bank_cli.make_encoder(tower, token_embedding(cfg.clip.vocab_size,
                                                           cfg.clip.transformer_width,
                                                           noise=noise))
        t1 = time.perf_counter()
        out[f"{tag}bank"] = bank_cli.encode_text_features(enc, TEST_CLASS_NAMES,
                                                          TEMPLATE_SETS["camoprompts"])
        out[f"{tag}bank_s"] = time.perf_counter() - t1
    return out


TORCH_LEGS = {"infer": torch_infer, "train": torch_train, "maple": torch_maple}


def run_side(fn, leg: str, route: str, small: bool, out_dir: str) -> dict:
    """One side of one leg: its arrays, wall and peak RSS."""
    t0 = time.perf_counter()
    out = fn(route, small, out_dir)
    out["wall_s"] = time.perf_counter() - t0
    out["peak_rss_gib"] = _peak_rss_gib()
    return out


# ---------------------------------------------------------------- compare


def errors(got, want) -> dict:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d, ref = np.abs(got - want), np.abs(want)
    return {"mean_rel": float(d.mean() / ref.mean()), "max_rel": float(d.max() / ref.max()),
            "max_abs": float(d.max())}


def _scalar(d, k):
    return float(np.asarray(d[k])) if k in d else None


def _fmt(x):
    return float(f"{x:.4g}")


def _side_stats(j, t):
    return {"jax": {"wall_s": _scalar(j, "wall_s"), "peak_rss_gib": _scalar(j, "peak_rss_gib")},
            "torch": {"wall_s": _scalar(t, "wall_s"), "peak_rss_gib": _scalar(t, "peak_rss_gib")}}


def compare_infer(route: str, j: dict, t: dict) -> dict:
    """Every tap of the port against JAX within TAP_MEAN_REL, the
    probabilities within PROB_MAX_ABS, the class logits within
    LOGIT_RANGE_SHARE of their range, the same class on every image (but an
    image whose top-2 margin is under the logit bound), each image's mask
    coverage within COVERAGE; the self-gap beside each tap."""
    taps = sorted(k for k in j if k in t and not k.startswith(("self_", "meta"))
                  and np.asarray(j[k]).ndim > 0 and k != "pred")
    rows, fails = {}, []
    for k in taps:
        if np.asarray(j[k]).shape != np.asarray(t[k]).shape:
            fails.append(f"{k}: shape {np.asarray(t[k]).shape} vs jax {np.asarray(j[k]).shape}")
            continue
        e = errors(t[k], j[k])
        if "self_" + k in t:  # the text features do not depend on the image
            e["self_mean_rel"] = errors(t["self_" + k], t[k])["mean_rel"]
        rows[k] = {n: _fmt(v) for n, v in e.items()}
        if not e["mean_rel"] <= TAP_MEAN_REL:
            fails.append(f"{k}: mean_rel {e['mean_rel']:.3e} > {TAP_MEAN_REL}")
    e = errors(t["probs"], j["probs"])
    if not e["max_abs"] <= PROB_MAX_ABS:
        fails.append(f"probs: max_abs {e['max_abs']:.3e} > {PROB_MAX_ABS}")
    jl, tl = np.asarray(j["class_logits"], np.float64), np.asarray(t["class_logits"], np.float64)
    logit_bound = LOGIT_RANGE_SHARE * float(np.ptp(jl))
    if not float(np.abs(tl - jl).max()) <= logit_bound:
        fails.append(f"class_logits: max_abs {np.abs(tl - jl).max():.3e} > {logit_bound:.3e}")
    top2 = np.sort(jl, axis=-1)[:, -2:]
    margins = (top2[:, 1] - top2[:, 0]).tolist()
    jp, tp = np.asarray(j["pred"]).tolist(), np.asarray(t["pred"]).tolist()
    for b, (a, c, m) in enumerate(zip(jp, tp, margins)):
        if a != c and m >= logit_bound:
            fails.append(f"image {b}: class {c} vs jax {a} (top-2 margin {m:.3e})")
    coverage = [float((np.asarray(j["probs"])[b] > 0.5).mean()) for b in range(len(jp))]
    for b, c in enumerate(coverage):
        if not COVERAGE[0] <= c <= COVERAGE[1]:
            fails.append(f"image {b}: mask coverage {c:.4f} outside {COVERAGE}: the alpha "
                         "channel is not exercised (fix HYPER_SCALE)")
    meta = json.loads(str(j["meta"]))
    return {"leg": "infer", "route": route, "pass": not fails, "fails": fails, "taps": rows,
            "probs_max_abs": _fmt(e["max_abs"]), "logit_bound": _fmt(logit_bound),
            "pred": {"jax": jp, "torch": tp}, "top2_margin": [_fmt(m) for m in margins],
            "coverage": [_fmt(c) for c in coverage], "jax_meta": meta,
            "forward_s": {"jax": _scalar(j, "forward_s"), "torch": _scalar(t, "forward_s")},
            **_side_stats(j, t)}


def grad_gaps(ref: dict, other: dict) -> tuple:
    """Per tensor |d|_2 / max(|g|_2, GRAD_FLOOR x the largest |g|_2): the
    plain relative L2 of every leaf at or above the floor. Returns (gaps,
    floor, the leaves under the floor)."""
    norms = {k: float(np.linalg.norm(v)) for k, v in ref.items()}
    floor = GRAD_FLOOR * max(norms.values())
    gaps = {k: float(np.linalg.norm(np.asarray(other[k], np.float64) - ref[k])
                     / max(norms[k], floor)) for k in ref}
    return gaps, floor, sorted(k for k in ref if norms[k] < floor)


def under_floor(ref: dict, other: dict, under: list, floor: float) -> dict:
    """The leaves under the floor: how many, how many are exactly zero on
    both sides, their largest |g|_2 and |d|_2 as shares of the largest leaf's
    |g|_2, and their plain relative L2 where |g| is not zero."""
    largest = floor / GRAD_FLOOR
    d = {k: float(np.linalg.norm(np.asarray(other[k], np.float64) - ref[k])) for k in under}
    g = {k: float(np.linalg.norm(ref[k])) for k in under}
    rel = [d[k] / g[k] for k in under if g[k] > 0]
    return {"n": len(under), "exact_zero": sum(g[k] == 0 and d[k] == 0 for k in under),
            "max_share": _fmt(max(g.values(), default=0.0) / largest),
            "max_diff_share": _fmt(max(d.values(), default=0.0) / largest),
            "max_rel_l2": _fmt(max(rel, default=0.0))}


def max_rel(ref: dict, other: dict) -> dict:
    return {k: float(np.abs(np.asarray(other[k], np.float64) - ref[k]).max()
                     / max(float(np.abs(ref[k]).max()), 1e-30)) for k in ref}


def _grads(d, tag=""):
    p = f"{tag}grad/"
    return {k[len(p):]: np.asarray(v, np.float64) for k, v in d.items() if k.startswith(p)}


def _worst(rels: dict, n: int = 3):
    return [(k, _fmt(v)) for k, v in sorted(rels.items(), key=lambda kv: -kv[1])[:n]]


def compare_train(route: str, j: dict, t: dict) -> dict:
    jg, tg, sg = _grads(j), _grads(t), _grads(t, "self_")
    fails = []
    if set(jg) != set(tg):
        fails.append(f"trainable sets differ: {sorted(set(jg) ^ set(tg))[:5]}")
    keys = sorted(set(jg) & set(tg))
    rels, floor, under = grad_gaps({k: jg[k] for k in keys}, tg)
    self_rels, self_floor, self_under = grad_gaps({k: tg[k] for k in keys}, sg)
    held = {k: v for k, v in rels.items() if k not in under}
    lj, lt = float(j["loss"]), float(t["loss"])
    loss_rel = abs(lt - lj) / abs(lj)
    if not loss_rel <= TRAIN_LOSS_REL:
        fails.append(f"loss {lt} vs jax {lj}: rel {loss_rel:.3e} > {TRAIN_LOSS_REL}")
    bad = {k: v for k, v in rels.items() if not v <= TRAIN_GRAD_REL}
    if bad:
        fails.append(f"gradients over {TRAIN_GRAD_REL} (relative L2; under the floor "
                     f"{floor:.3e}, |d|_2 over it x {TRAIN_GRAD_REL}): {_worst(bad)}")
    if not any(k.startswith("image_encoder.prompt_generator.") and float(np.abs(jg[k]).max()) > 0
               for k in keys):
        fails.append("no gradient reaches the EVP prompt generator")
    meta = json.loads(str(j["meta"]))
    return {"leg": "train", "route": route, "pass": not fails, "fails": fails,
            "loss": {"jax": lj, "torch": lt, "rel": _fmt(loss_rel),
                     "self_rel": _fmt(abs(float(t["self_loss"]) - lt) / abs(lt))},
            "grads": {"n": len(keys), "held": len(held),
                      "max_rel_l2": _fmt(max(held.values(), default=0.0)),
                      "median_rel_l2": _fmt(float(np.median(list(held.values())))),
                      "worst": _worst(held), "floor": _fmt(floor),
                      "self_max_rel_l2": _fmt(max((v for k, v in self_rels.items()
                                                   if k not in self_under), default=0.0)),
                      "under_floor": under_floor({k: jg[k] for k in keys}, tg, under, floor),
                      "self_under_floor": under_floor({k: tg[k] for k in keys}, sg, self_under,
                                                      self_floor)},
            "step_s": {"jax": _scalar(j, "step_s"), "torch": _scalar(t, "step_s")},
            "jax_meta": meta, **_side_stats(j, t)}


def compare_maple(route: str, j: dict, t: dict) -> dict:
    jg, tg, sg = _grads(j), _grads(t), _grads(t, "self_")
    fails = []
    if set(jg) != set(tg):
        fails.append(f"prompt-learner sets differ: {sorted(set(jg) ^ set(tg))[:5]}")
    keys = sorted(set(jg) & set(tg))
    rels = max_rel({k: jg[k] for k in keys}, tg)
    self_rels = max_rel({k: tg[k] for k in keys}, sg)
    lj, lt = float(j["loss"]), float(t["loss"])
    loss_rel = abs(lt - lj) / abs(lj)
    if not loss_rel <= MAPLE_LOSS_REL:
        fails.append(f"loss {lt} vs jax {lj}: rel {loss_rel:.3e} > {MAPLE_LOSS_REL}")
    bad = {k: v for k, v in rels.items() if not v <= MAPLE_GRAD_REL}
    if bad:
        fails.append(f"prompt gradients over {MAPLE_GRAD_REL}: {_worst(bad)}")
    jb, tb = np.asarray(j["bank"], np.float64), np.asarray(t["bank"], np.float64)
    bank_rel = float(np.abs(tb - jb).max() / np.abs(jb).max()) if jb.shape == tb.shape else 1.0
    if not bank_rel <= BANK_REL:
        fails.append(f"text bank {tb.shape} vs jax {jb.shape}: rel {bank_rel:.3e} > {BANK_REL}")
    return {"leg": "maple", "route": route, "pass": not fails, "fails": fails,
            "loss": {"jax": lj, "torch": lt, "rel": _fmt(loss_rel),
                     "self_rel": _fmt(abs(float(t["self_loss"]) - lt) / abs(lt))},
            "grads": {"n": len(keys), "max_rel": _fmt(max(rels.values())),
                      "worst": _worst(rels), "self_max_rel": _fmt(max(self_rels.values()))},
            "bank": {"shape": list(tb.shape), "max_rel": _fmt(bank_rel),
                     "self_max_rel": _fmt(float(np.abs(np.asarray(t["self_bank"]) - tb).max()
                                                / np.abs(tb).max()))},
            "step_s": {"jax": _scalar(j, "step_s"), "torch": _scalar(t, "step_s")},
            "bank_s": {"jax": _scalar(j, "bank_s"), "torch": _scalar(t, "bank_s")},
            **_side_stats(j, t)}


COMPARE = {"infer": compare_infer, "train": compare_train, "maple": compare_maple}


# ----------------------------------------------------------------- golden


def golden_entries(taps: dict) -> dict:
    """What the golden keeps of a batch-1 route: the class logits and class,
    the low-resolution mask logits, channels 0-7 of the SAM embedding and
    the whole embedding's mean and L2 norm."""
    neck = np.asarray(taps["neck"], np.float32)[0]
    return {"class_logits": np.asarray(taps["class_logits"], np.float32)[0],
            "pred": np.asarray(taps["pred"]).reshape(-1)[:1].astype(np.int64),
            "mask_lowres": np.asarray(taps["mask_lowres"], np.float32)[0, 0],
            "embedding_slice": np.ascontiguousarray(neck[..., :8].transpose(2, 0, 1)),
            "embedding_mean": np.float64(neck.mean(dtype=np.float64)),
            "embedding_norm": np.float64(np.linalg.norm(neck.astype(np.float64)))}


# one key of each of `_draw`'s rules (logit scale, the Gaussian PE matrix, a
# LayerNorm weight, a bias, a matrix, a scaled hypernetwork layer, a prompt)
DIGEST_KEYS = ("clip_model.logit_scale", "pe_layer.positional_encoding_gaussian_matrix",
               "image_encoder.blocks.31.norm1.weight", "image_encoder.blocks.31.attn.qkv.bias",
               "image_encoder.blocks.31.attn.rel_pos_h",
               "mask_decoder.output_hypernetworks_mlps.0.layers.2.weight",
               "clip_model.prompt_learner.ctx")


def draw_digest(route: str = ROUTE_1, weights: dict = None, out_dir: str = OUT_DIR) -> dict:
    """A cheap fingerprint of what a full-size run of `route` at batch 1 is
    made of: the sum and sum of squares (float64) of DIGEST_KEYS' draws (from
    `weights` where given), of the seeded image and of the port's text bank,
    and the sha256 of the route's configuration. The golden keeps it, so that
    a change to the draw, the inputs, the bank or the yaml shows as a stale
    golden and not as a departure of the card."""
    from camouflaged_vlm_tpu_torch.data.ovcamo import TEST_CLASS_NAMES

    cfg = port_config(route, False, out_dir)
    if weights is None:
        weights = draw_weights(port_shapes(cfg), keys=DIGEST_KEYS)

    def sums(a):
        a = np.asarray(a, np.float64)
        return [float(a.sum()), float((a * a).sum())]

    bank = _bank(cfg, TEST_CLASS_NAMES)
    raw = json.dumps(route_raw(route, False), sort_keys=True)
    return {"weights": {k: sums(weights[k]) for k in DIGEST_KEYS},
            "inputs": [sums(a) for a in make_inputs(cfg.inp_size, cfg.clip_size, 1)],
            "bank": [sums(b.numpy()) for b in bank],
            "config_sha256": hashlib.sha256(raw.encode()).hexdigest()}


def check_golden_digest(meta: dict, digest: dict) -> None:
    """Raises unless `digest` is the golden's (sums within 1e-9 relative)."""
    def flat(d):
        return np.asarray([v for k in DIGEST_KEYS for v in d["weights"][k]]
                          + np.ravel(d["inputs"]).tolist() + np.ravel(d["bank"]).tolist())

    want = meta.get("digest")
    if not (want is not None and want["config_sha256"] == digest["config_sha256"]
            and set(want["weights"]) == set(DIGEST_KEYS)
            and np.allclose(flat(digest), flat(want), rtol=1e-9, atol=0)):
        raise ValueError(f"{os.path.relpath(GOLDEN, REPO)} was drawn from other weights, inputs, "
                         "bank or configuration than this code makes: rerun "
                         "`python ab_fullsize_torch.py --write-golden`")


def write_golden(taps: dict, path: str = GOLDEN) -> None:
    entries = golden_entries(taps)
    seeds = {"weight_seed": WEIGHT_SEED, "image_seed": IMAGE_SEED, "bank_seed": BANK_SEED,
             "hyper_scale": HYPER_SCALE, "route": ROUTE_1, "batch": 1,
             "shapes": {k: list(np.shape(v)) for k, v in entries.items()},
             "digest": draw_digest()}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, meta=json.dumps(seeds), **entries)


def read_golden(path: str = GOLDEN) -> tuple:
    """(entries, meta); raises if an entry's shape is not the one the meta
    records."""
    with np.load(path) as f:
        meta = json.loads(str(f["meta"]))
        entries = {k: f[k] for k in f.files if k != "meta"}
    for k, shape in meta["shapes"].items():
        if list(entries[k].shape) != shape:
            raise ValueError(f"golden {k}: shape {entries[k].shape} != {shape}")
    return entries, meta


def golden_gaps(entries: dict, golden: dict) -> dict:
    """A batch-1 run's `golden_entries` against the golden: the taps'
    mean_rel, the class logits' max abs against their bound, the class and
    the golden's top-2 margin."""
    out = {k: errors(entries[k], golden[k]) for k in ("mask_lowres", "embedding_slice",
                                                      "class_logits")}
    for k in ("embedding_mean", "embedding_norm"):
        out[k] = {"rel": abs(float(entries[k]) - float(golden[k])) / abs(float(golden[k]))}
    gl = np.asarray(golden["class_logits"], np.float64)
    top2 = np.sort(gl)[-2:]
    out["logit_bound"] = LOGIT_RANGE_SHARE * float(np.ptp(gl))
    out["top2_margin"] = float(top2[1] - top2[0])
    out["pred"] = (int(entries["pred"][0]), int(golden["pred"][0]))
    return out


# ------------------------------------------------------------------ main


def _npz(out_dir, side, leg, route, small):
    return os.path.join(out_dir, f"{side}_{leg}_{route}{'_small' if small else ''}.npz")


def _load(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _legs(legs, routes):
    """(leg, route) pairs: infer on each route, train and maple on route 1."""
    out = []
    for leg in legs:
        out += [(leg, r) for r in routes] if leg == "infer" else [(leg, ROUTE_1)]
    return out


def _run_sub(cmd, log_path) -> int:
    with open(log_path, "w") as log:
        return subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=REPO).returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--legs", nargs="+", default=list(LEGS), choices=LEGS)
    ap.add_argument("--routes", nargs="+", default=list(ROUTES), choices=list(ROUTES))
    ap.add_argument("--small", action="store_true",
                    help="small widths, a windowed and a global block (minutes, not an hour)")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--side", choices=("torch",), help="run the port's side of one leg only")
    ap.add_argument("--leg", choices=LEGS)
    ap.add_argument("--route", choices=list(ROUTES))
    ap.add_argument("--write-golden", action="store_true",
                    help=f"run JAX's route 1 at batch 1 and write {os.path.relpath(GOLDEN, REPO)}")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.side == "torch":  # one side of one leg, in this process
        out = run_side(TORCH_LEGS[args.leg], args.leg, args.route, args.small, args.out_dir)
        np.savez(_npz(args.out_dir, "torch", args.leg, args.route, args.small), **out)
        return 0
    if args.write_golden:
        cmd = [sys.executable, JAX_SIDE, "--write-golden", "--out-dir", args.out_dir]
        return subprocess.run(cmd, cwd=REPO).returncode

    ok = True
    for leg, route in _legs(args.legs, args.routes):
        paths = {}
        for side in ("jax", "torch"):
            paths[side] = _npz(args.out_dir, side, leg, route, args.small)
            script = JAX_SIDE if side == "jax" else os.path.abspath(__file__)
            cmd = [sys.executable, script, "--side", side, "--leg", leg, "--route", route,
                   "--out-dir", args.out_dir] + (["--small"] if args.small else [])
            log_path = paths[side][:-4] + ".log"
            t0 = time.perf_counter()
            rc = _run_sub(cmd, log_path)
            print(f"[{leg} {route}] {side} side: rc {rc} in {time.perf_counter() - t0:.1f} s "
                  f"on {HOST} (log {os.path.relpath(log_path, REPO)})", flush=True)
            if rc != 0:
                with open(log_path) as f:
                    print(f.read()[-4000:], flush=True)
                return 1
        report = COMPARE[leg](route, _load(paths["jax"]), _load(paths["torch"]))
        report["host"] = HOST
        report["small"] = args.small
        print(json.dumps(report), flush=True)
        ok &= report["pass"]
    print(f"FULL-SIZE A/B OF THE PORT AGAINST JAX{' (small)' if args.small else ''}: "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
