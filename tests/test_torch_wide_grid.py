"""A train step at img_size 1280 (an 80 x 80 token grid), the port against
the JAX package on the CPU.

Above 1024 px the global blocks' grid passes 64 x 64, so #18's rel lanes
pass 128 (H + W = 160 here) and the windowed blocks' compact carry pads 80
tokens to 84 (6 x 6 windows of 14, the edge windows 10 wide, where ViT-H's
64 grid has 8). The cascade's whole train step at that size: a depth-2 SAM
(block 0 windowed on the compact carry, block 1 global), width 64 in 8 heads,
which is what the fused 'flash' path needs (head groups of 8; at 4 heads
the port and JAX take the unfused blocks, which no grid limits), the edge
decoder and an 8-head CLIP, on the same numpy-drawn parameters in both
packages. On the CPU the port runs its kernels' plain forwards and plain
backwards (the card runs the same step in `chip_smoke.py [wide_global]`).

Tolerances as `tests/test_torch_train.py`'s slice: loss 1e-5, each
trainable gradient 1e-4 relative with an absolute floor of 1e-4 of the
leaf's largest magnitude plus 1e-8. JAX's step is jitted with the batch as
an argument, so that XLA does not fold the 1280 x 1280 target into the
program.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from camouflaged_vlm_tpu import train as jtrain  # noqa: E402
from camouflaged_vlm_tpu.factory import make_bank_inputs as j_make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu.models import CascadeConfig as JCascadeConfig  # noqa: E402
from camouflaged_vlm_tpu.models import OVCOSCascade as JCascade  # noqa: E402
from camouflaged_vlm_tpu.models import sam_encoder as j_sam  # noqa: E402
from camouflaged_vlm_tpu.models.clip import AlphaClipConfig as JClipConfig  # noqa: E402
from camouflaged_vlm_tpu.train.train_step import combine_params, partition_params  # noqa: E402

from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu_torch.io.convert import (  # noqa: E402
    _inverse_transform,
    cascade_key_map,
    load_jax_params,
)
from camouflaged_vlm_tpu_torch.models import CascadeConfig, SamEncoderConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.models.sam_encoder import ImageEncoderViT  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from test_torch_train import CLASSES, CLIP_8x16, _torch_loss_and_grads, close  # noqa: E402
from test_torch_train import random_params  # noqa: E402

IMG = 1280
ENC = dict(img_size=IMG, embed_dim=64, num_heads=8, prompt_scale_factor=8, depth=2,
           window_size=14, global_attn_indexes=(1,))


@pytest.fixture(scope="module")
def pair():
    jenc = j_sam.SamEncoderConfig.tiny(attn_impl="flash", **ENC)
    jcfg = dataclasses.replace(JCascadeConfig.tiny(), inp_size=IMG, encoder=jenc,
                               clip=JClipConfig.tiny(**CLIP_8x16))
    jmodel = JCascade(jcfg)
    jbank = j_make_bank_inputs(jcfg, CLASSES, seed=3)
    bank = (jbank["prefix"], jbank["suffix"], jbank["eot_indices"], jbank["bank_features"])
    rng = np.random.default_rng(1)
    C = jcfg.clip_size
    yy, xx = np.mgrid[:IMG, :IMG]
    batch = {
        "inp": rng.standard_normal((1, IMG, IMG, 3)).astype(np.float32),
        "clip_image": rng.standard_normal((1, C, C, 3)).astype(np.float32),
        "clip_mask": np.full((1, C, C, 1), 1.923, np.float32),
        "gt": (((yy - 430) ** 2 + (xx - 640) ** 2 < 320 ** 2)[None, ..., None]
               .astype(np.float32)),
    }
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, batch["inp"], batch["clip_image"], batch["clip_mask"], *bank,
                              method=jmodel.infer_cascade),
        jax.random.PRNGKey(0),
    )
    params = random_params(shapes, seed=2)
    cfg = dataclasses.replace(CascadeConfig.tiny(), inp_size=IMG,
                              encoder=SamEncoderConfig.tiny(attn_impl="flash", **ENC),
                              clip=AlphaClipConfig.tiny(**CLIP_8x16))
    model = build_cascade(cfg, "cpu")
    load_jax_params(model, params, cfg)
    return jmodel, params, bank, cfg, model, batch


def test_the_1280_px_grid_takes_the_wide_lanes_and_the_compact_carry(pair):
    """What the step below reaches: an 80 x 80 grid, #18 at 160 lanes padded
    to 256 (the wide path), the windowed block on the compact carry."""
    *_, cfg, model, _ = pair
    enc = model.image_encoder
    assert isinstance(enc, ImageEncoderViT) and enc.fused and enc.compact
    grid = IMG // cfg.encoder.patch_size
    assert grid == 80 and fa.attn_bwd_lanes(2 * grid) == 256
    assert [b.attn.fused_route for b in enc.blocks] == ["compact", "global"]


def test_train_step_at_1280_px_matches_jax(pair):
    """Loss and every trainable gradient of forward_with_text + the loss at
    img_size 1280: the port (plain backwards on the CPU) against JAX's
    value_and_grad on the same parameters and batch."""
    jmodel, params, bank, cfg, model, batch = pair
    jtf = jmodel.apply(params, *bank, method=jmodel.encode_class_text_features)
    trainable, frozen = partition_params(jax.tree.map(jnp.asarray, params))

    def loss(t, b):
        masks, edges = jmodel.apply(combine_params(t, frozen), b["inp"], b["clip_image"],
                                    b["clip_mask"], jtf, method=jmodel.forward_with_text)
        return jtrain.segmentation_loss(masks, edges, b["gt"], "iou")[0]

    jl, jg = jax.jit(jax.value_and_grad(loss))(trainable, batch)
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
            close(grads[tk], _inverse_transform(kind, np.asarray(jg[key], np.float32)), 1e-4,
                  floor=1e-8)
            seen += 1
    assert seen == len(grads) > 40
    # the gradient reaches the prompt generator through the global block
    pg = grads["image_encoder.prompt_generator.lightweight_mlp_0.0.weight"]
    assert float(pg.abs().max()) > 1e-6
