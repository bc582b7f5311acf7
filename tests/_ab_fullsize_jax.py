"""The JAX package's side of `ab_fullsize_torch.py` (CPU, fp32).

Each leg as `ab_fullsize_torch.py`'s port side runs it, on the same weights
(the port's numpy draw, `ab_fullsize_torch.draw_weights`, through the JAX
package's own converter: no missing, no unused key, every parameter of the
model filled), the same inputs and each package's own `make_bank_inputs` at
the same seed. Taps come from a flax method interceptor (`nn.intercept_methods`)
around `infer_cascade_with_text`, gradients from the package's own
`make_train_step` / `make_maple_train_step` with an optax transformation that
keeps the gradient in its state and moves nothing.

Where `attach_rel_cache` asserts (its `make_rcomb` takes H + W <= 32, so a
window of 17 or more), the route runs without precomputed tables and the
report says so. Any other failure of the JAX side fails its leg.

  python tests/_ab_fullsize_jax.py --side jax --leg infer --route vit_h_flash [--small]
  python tests/_ab_fullsize_jax.py --write-golden
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import traverse_util  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import ab_fullsize_torch as ab  # noqa: E402
from camouflaged_vlm_tpu.cli.precompute_text_bank import encode_text_features  # noqa: E402
from camouflaged_vlm_tpu.config import cascade_config_from_yaml  # noqa: E402
from camouflaged_vlm_tpu.data.ovcamo import TEST_CLASS_NAMES, TRAIN_CLASS_NAMES  # noqa: E402
from camouflaged_vlm_tpu.data.templates import TEMPLATE_SETS  # noqa: E402
from camouflaged_vlm_tpu.factory import attach_rel_cache, make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu.io.convert import (  # noqa: E402
    cascade_key_map, convert_state_dict, export_state_dict, merge_into_params,
)
from camouflaged_vlm_tpu.models import OVCOSCascade  # noqa: E402
from camouflaged_vlm_tpu.models.clip import CustomClip  # noqa: E402
from camouflaged_vlm_tpu.ops.compact_window import CompactGeometry, compact_unpartition  # noqa: E402
from camouflaged_vlm_tpu.ops.window import window_unpartition_seq  # noqa: E402
from camouflaged_vlm_tpu.train.maple import (  # noqa: E402
    MAPLE_TRAINABLE_SUBTREES, make_maple_train_step,
)
from camouflaged_vlm_tpu.train.train_step import create_train_state, make_train_step  # noqa: E402

BANK_KEYS = ("prefix", "suffix", "eot_indices", "bank_features")
# --small compiles at XLA's lowest optimisation: at those sizes compiling, not
# running, is the JAX side's time (the outputs move by ~1e-6 relative)
SMALL_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jit(fn, small):
    return jax.jit(fn, compiler_options=SMALL_XLA if small else None)


@contextlib.contextmanager
def pallas_interpret():
    """Pallas calls in interpret mode, as the JAX package's own tests run
    them on the CPU. Every wrapper but `flash_attention_fullk` ('aug_flash'
    at >= 1024 tokens) takes its XLA formulation on the CPU before it reaches
    `pallas_call`, so only that kernel runs interpreted."""
    orig = pl.pallas_call

    def interpreted(*args, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*args, **kw)

    pl.pallas_call = interpreted
    try:
        yield
    finally:
        pl.pallas_call = orig


def jax_config(route, small, out_dir, light=False, **encoder):
    cfg = cascade_config_from_yaml(ab.route_yaml(route, small, out_dir, light))[0]
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, **encoder))


def load_params(cfg, shapes, weights, prefix=""):
    """`weights` (the port's names, those under `prefix`) through JAX's
    converter into the parameter tree `shapes` (eval_shape's 'params', the
    subtree under `prefix` where one is given): raises on a missing,
    unused or unfilled key."""
    key_map = [e for e in cascade_key_map(cfg) if e[0].startswith(prefix)]
    tree, missing, used = convert_state_dict(weights, key_map)
    unused = sorted(set(weights) - set(used))
    for node in [p for p in prefix.split(".") if p]:
        tree = tree[node]
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = merge_into_params({"params": zeros}, tree)["params"]
    unfilled = sorted("/".join(k) for k in set(traverse_util.flatten_dict(zeros))
                      - set(traverse_util.flatten_dict(tree)))
    if missing or unused or unfilled:
        raise KeyError(f"weights into JAX: missing {missing[:5]}, unused {unused[:5]}, "
                       f"unfilled {unfilled[:5]}")
    del tree
    return {"params": jax.tree.map(jnp.asarray, params)}, {
        "keys": len(used), "missing": 0, "unused": 0, "unfilled": 0}


def port_weights(route, small, out_dir, prefix="", light=False):
    shapes = ab.port_shapes(ab.port_config(route, small, out_dir, light))
    return ab.draw_weights(shapes, keys=[k for k in shapes if k.startswith(prefix)])


def grad_capture():
    """An optax transformation whose state is the last gradient and whose
    update is zero."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}))


def _grid(cfg, out, B):
    """A block's output on the (B, h, w, C) grid, whatever its carry."""
    e, g = cfg.encoder, cfg.embedding_size
    win = e.window_size
    if isinstance(out, tuple):
        return compact_unpartition(out[0], out[1], CompactGeometry(g, g, win))
    if out.shape[0] != B:
        pad = -(-g // win) * win
        return window_unpartition_seq(out, win, (pad, pad), (g, g))
    return out.reshape(B, g, g, -1)


def tapped_infer(model, cfg, keep_blocks, variables, inp, cimg, cmask, tf):
    """`infer_cascade_with_text` with a method interceptor keeping the
    stages' outputs (and the 336 alpha, the second CLIP pass's argument)."""
    taps, clip_calls = {}, []
    B = inp.shape[0]

    def intercept(next_fun, args, kwargs, ctx):
        out = next_fun(*args, **kwargs)
        path, name = tuple(ctx.module.path), ctx.method_name
        if path == ("image_encoder", "patch_embed") and name == "__call__":
            taps["patch_embed"] = out
        elif path == ("image_encoder", "prompt_generator") and name == "init_features":
            taps["prompt_features"] = out
        elif (len(path) == 2 and path[0] == "image_encoder" and path[1].startswith("block_")
              and name == "__call__" and int(path[1][6:]) in keep_blocks):
            taps[path[1]] = _grid(cfg, out, B)
        elif path == ("image_encoder",) and name == "__call__":
            taps["neck"] = out[0]
        elif path == ("clip_model",) and name == "classify":
            clip_calls.append(None)
            if len(clip_calls) == 1:
                taps["clip1_image_feat"] = out[0]
            else:
                taps["alpha"] = args[1]
                taps["clip2_image_feat"] = out[0]
        elif path == () and name == "_sparse_embeddings":
            taps["sparse"] = out
        elif path == ("mask_decoder",) and name == "__call__":
            taps["mask_lowres"] = out[0]
        return out

    with nn.intercept_methods(intercept):
        probs, pred, score = model.apply(variables, inp, cimg, cmask, tf,
                                         method=model.infer_cascade_with_text)
    return {**taps, "probs": probs, "class_logits": score, "pred": pred}


def _error_text(e: BaseException) -> str:
    frame = traceback.extract_tb(e.__traceback__)[-1]
    return (f"{type(e).__name__}: {e} ({os.path.relpath(frame.filename, REPO)}:{frame.lineno} "
            f"in {frame.name})")


def jax_infer(route, small, out_dir, batch=None):
    lite = ab.is_light("infer", route, small)
    cfg = jax_config(route, small, out_dir, lite)
    model = OVCOSCascade(cfg)
    bank = make_bank_inputs(cfg, TEST_CLASS_NAMES, seed=ab.BANK_SEED)
    bank_args = tuple(bank[k] for k in BANK_KEYS)
    B = batch or ab.ROUTES[route]["batch"]
    inputs = tuple(jnp.asarray(a) for a in ab.make_inputs(cfg.inp_size, cfg.clip_size, B))
    t0 = time.perf_counter()
    shapes = jax.eval_shape(lambda k: model.init(k, *inputs, *bank_args,
                                                 method=model.infer_cascade),
                            jax.random.PRNGKey(0))["params"]
    params, meta = load_params(cfg, shapes, port_weights(route, small, out_dir, light=lite))
    tf = jit(lambda p, *b: model.apply(p, *b, method=model.encode_class_text_features), small)(
        params, *bank_args)
    try:
        variables = attach_rel_cache(params, cfg)
        meta["jax_rel_cache"] = True
    except AssertionError as e:
        variables = params
        meta["jax_rel_cache"] = False
        meta["jax_rel_cache_error"] = _error_text(e)
    load_s = time.perf_counter() - t0
    keep = ab.tap_blocks(cfg.encoder.depth, cfg.encoder.window_size,
                         cfg.encoder.global_attn_indexes)

    t1 = time.perf_counter()
    fn = jit(lambda v_, *a: tapped_infer(model, cfg, keep, v_, *a), small)
    taps = jax.tree.map(np.asarray, fn(variables, *inputs, tf))
    out = {**taps, "text_features": np.asarray(tf), "pred": taps["pred"].astype(np.int64)}
    out.update(forward_s=time.perf_counter() - t1, load_s=load_s, meta=json.dumps(meta))
    return out


def jax_train(route, small, out_dir):
    """One step of JAX's make_train_step on the test split's text features
    (block remat on at full size, for memory), the gradients in the port's
    names."""
    lite = ab.is_light("train", route, small)
    cfg = jax_config(route, small, out_dir, lite, remat=not small)
    model = OVCOSCascade(cfg)
    bank = make_bank_inputs(cfg, TEST_CLASS_NAMES, seed=ab.BANK_SEED)
    bank_args = tuple(bank[k] for k in BANK_KEYS)
    batch = {k: jnp.asarray(v) for k, v in ab.make_train_batch(cfg.inp_size, cfg.clip_size).items()}
    shapes = jax.eval_shape(lambda k: model.init(k, batch["inp"], batch["clip_image"],
                                                 batch["clip_mask"], *bank_args,
                                                 method=model.infer_cascade),
                            jax.random.PRNGKey(0))["params"]
    params, meta = load_params(cfg, shapes, port_weights(route, small, out_dir, light=lite))
    batch["text_features"] = jit(
        lambda p, *b: model.apply(p, *b, method=model.encode_class_text_features), small)(
        params, *bank_args)
    tx = grad_capture()
    state = create_train_state(params, tx)
    del params
    step = jit(make_train_step(model, tx, loss_mode="iou"), small)
    t1 = time.perf_counter()
    new, metrics = step(state, batch)
    loss = float(metrics["loss"])
    step_s = time.perf_counter() - t1
    grads = traverse_util.unflatten_dict(new.opt_state["g"])["params"]
    sd, _ = export_state_dict(jax.tree.map(np.asarray, grads), cascade_key_map(cfg))
    meta["remat"] = not small
    return {"loss": np.float64(loss), "step_s": step_s, "meta": json.dumps(meta),
            **{f"grad/{k}": v for k, v in sd.items()}}


def jax_maple(route, small, out_dir):
    """One MaPLe step of the cascade's CustomClip (batch 2, the 14 train
    classes) through JAX's make_maple_train_step, and the 61 test classes'
    text bank through JAX's precompute CLI."""
    cfg = jax_config(route, small, out_dir)
    clip = CustomClip(cfg.clip)
    bank = make_bank_inputs(cfg, TRAIN_CLASS_NAMES, seed=ab.BANK_SEED)
    batch = {k: jnp.asarray(v) for k, v in
             ab.make_maple_batch(cfg.clip_size, len(TRAIN_CLASS_NAMES)).items()}
    batch.update({k: bank[k] for k in BANK_KEYS})
    shapes = jax.eval_shape(lambda k: clip.init(k, batch["clip_image"], batch["clip_alpha"],
                                                *(bank[k_] for k_ in BANK_KEYS)),
                            jax.random.PRNGKey(0))["params"]
    params, meta = load_params(cfg, shapes, port_weights(route, small, out_dir, "clip_model."),
                               prefix="clip_model.")
    tx = grad_capture()
    state = create_train_state(params, tx, MAPLE_TRAINABLE_SUBTREES)
    step = jit(make_maple_train_step(clip, tx), small)
    t1 = time.perf_counter()
    new, metrics = step(state, batch)
    loss = float(metrics["loss"])
    step_s = time.perf_counter() - t1
    grads = traverse_util.unflatten_dict(new.opt_state["g"])["params"]
    pl_map = [e for e in cascade_key_map(cfg) if e[0].startswith("clip_model.prompt_learner.")]
    sd, _ = export_state_dict({"clip_model": jax.tree.map(np.asarray, grads)}, pl_map,
                              strict=True)
    t2 = time.perf_counter()
    text_bank = encode_text_features(
        cfg.clip, params["params"]["text_encoder"],
        ab.token_embedding(cfg.clip.vocab_size, cfg.clip.transformer_width),
        TEST_CLASS_NAMES, TEMPLATE_SETS["camoprompts"])
    return {"loss": np.float64(loss), "step_s": step_s, "bank": text_bank,
            "bank_s": time.perf_counter() - t2, "meta": json.dumps(meta),
            **{f"grad/{k}": v for k, v in sd.items()}}


JAX_LEGS = {"infer": jax_infer, "train": jax_train, "maple": jax_maple}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the JAX side of ab_fullsize_torch.py")
    ap.add_argument("--side", choices=("jax",), default="jax")
    ap.add_argument("--leg", choices=ab.LEGS)
    ap.add_argument("--route", choices=list(ab.ROUTES))
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out-dir", default=ab.OUT_DIR)
    ap.add_argument("--write-golden", action="store_true",
                    help="route 1 at batch 1 -> ab_fullsize_torch.GOLDEN")
    args = ap.parse_args(argv)
    if args.write_golden:
        t0 = time.perf_counter()
        with pallas_interpret():
            taps = jax_infer("vit_h_flash", False, args.out_dir, batch=1)
        ab.write_golden(taps)
        print(f"wrote {os.path.relpath(ab.GOLDEN, REPO)} ({os.path.getsize(ab.GOLDEN)} bytes) in "
              f"{time.perf_counter() - t0:.1f} s on {ab.HOST}; class {int(taps['pred'][0])}",
              flush=True)
        return 0
    with pallas_interpret():
        out = ab.run_side(JAX_LEGS[args.leg], args.leg, args.route, args.small, args.out_dir)
    np.savez(ab._npz(args.out_dir, "jax", args.leg, args.route, args.small), **out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
