"""The PyTorch port's modules against the JAX package's, on the CPU.

Each module that holds a kernel — the CLIP residual block, vision tower and
text tower, and SAM's patch embed — plus the modules around them on the
slice's path (the SAM encoder with its EVP prompt generator and padded
window carry, the edge mask decoder, the prompt learner) runs in both
packages on the same numpy-drawn parameters and inputs, in fp32. The CLIP
vision width is 8 heads x d 16 so that the JAX side walks its fused kernel
branch; SAM runs `attn_impl='reference'`.

Tolerance: 1e-4 relative to the output's largest magnitude — fp32 on both
sides, differing only in summation order through several layers (see
test_torch_ops.py for the per-op 1e-5).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from camouflaged_vlm_tpu.factory import make_bank_inputs as jax_make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu.models import CascadeConfig as JCascadeConfig  # noqa: E402
from camouflaged_vlm_tpu.models import OVCOSCascade as JCascade  # noqa: E402
from camouflaged_vlm_tpu.models.clip import AlphaClipConfig as JClipConfig  # noqa: E402
from camouflaged_vlm_tpu.models.clip.model import ResidualBlock as JResidualBlock  # noqa: E402
from camouflaged_vlm_tpu.models.sam_encoder import PatchEmbedMatmul as JPatchEmbed  # noqa: E402
from camouflaged_vlm_tpu.models.sam_encoder import SamEncoderConfig as JSamConfig  # noqa: E402

from camouflaged_vlm_tpu_torch.factory import build_cascade  # noqa: E402
from camouflaged_vlm_tpu_torch.io.convert import load_jax_params  # noqa: E402
from camouflaged_vlm_tpu_torch.models import CascadeConfig, SamEncoderConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.models.clip.model import ResidualBlock, build_causal_mask  # noqa: E402
from camouflaged_vlm_tpu_torch.models.sam_encoder import PatchEmbedMatmul  # noqa: E402

RTOL = 1e-4
CLIP_8x16 = dict(vision_width=128, vision_heads=8)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def japply(module, variables, method, *args):
    """`module.apply` compiled once: a tiny program compiles faster than
    flax dispatches it op by op."""
    return jax.jit(lambda v, *a: module.apply(v, *a, method=method))(variables, *args)


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


def make_pair(enc_overrides=None, seed=0):
    """(JAX cascade, its params, the port's cascade with them loaded)."""
    enc_overrides = dict(enc_overrides or {})
    jcfg = JCascadeConfig.tiny()
    jenc = JSamConfig.tiny(attn_impl="reference", **enc_overrides)
    jcfg = dataclasses.replace(jcfg, inp_size=jenc.img_size, encoder=jenc,
                               clip=JClipConfig.tiny(**CLIP_8x16))
    jmodel = JCascade(jcfg)
    bank = jax_make_bank_inputs(jcfg, ["cat", "owl", "moth"])
    B = 2
    args = (
        jnp.zeros((B, jcfg.inp_size, jcfg.inp_size, 3)),
        jnp.zeros((B, jcfg.clip_size, jcfg.clip_size, 3)),
        jnp.zeros((B, jcfg.clip_size, jcfg.clip_size, 1)),
        bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"],
    )
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, *args, method=jmodel.infer_cascade), jax.random.PRNGKey(0)
    )
    params = random_params(shapes, seed)
    cfg = CascadeConfig.tiny()
    cfg = dataclasses.replace(
        cfg, inp_size=jenc.img_size,
        encoder=SamEncoderConfig.tiny(attn_impl="reference", **enc_overrides),
        clip=AlphaClipConfig.tiny(**CLIP_8x16),
    )
    model = build_cascade(cfg, "cpu")
    load_jax_params(model, params, cfg)
    return jcfg, jmodel, params, model


@pytest.fixture(scope="module")
def pair():
    return make_pair()


# ------------------------------------------------- modules holding kernels


@pytest.mark.parametrize("causal", [False, True])
def test_clip_residual_block_matches_jax(rng, causal):
    """Vision block (fused kernel path in both packages) and text block
    (causal plain attention + the fused MLP kernel)."""
    dim, heads, L = (128, 8, 13) if not causal else (48, 4, 9)
    jblock = JResidualBlock(dim, heads, jnp.float32, fused=True)
    x = rng.standard_normal((2, L, dim)).astype(np.float32)
    mask = None if not causal else build_causal_mask(L).numpy()
    shapes = jax.eval_shape(
        lambda k: jblock.init(k, jnp.asarray(x), None if mask is None else jnp.asarray(mask)),
        jax.random.PRNGKey(0),
    )
    p = random_params(shapes)["params"]
    want = jblock.apply({"params": p}, jnp.asarray(x), None if mask is None else jnp.asarray(mask))

    block = ResidualBlock(dim, heads, torch.float32, causal=causal)
    a = p["attn"]
    sd = {
        "ln_1.weight": p["ln_1"]["scale"], "ln_1.bias": p["ln_1"]["bias"],
        "ln_2.weight": p["ln_2"]["scale"], "ln_2.bias": p["ln_2"]["bias"],
        "attn.out_proj.weight": a["out_proj"]["kernel"].T, "attn.out_proj.bias": a["out_proj"]["bias"],
        "mlp.c_fc.weight": p["mlp"]["c_fc"]["kernel"].T, "mlp.c_fc.bias": p["mlp"]["c_fc"]["bias"],
        "mlp.c_proj.weight": p["mlp"]["c_proj"]["kernel"].T,
        "mlp.c_proj.bias": p["mlp"]["c_proj"]["bias"],
    }
    w_in, b_in = a["in_proj"]["kernel"].T, a["in_proj"]["bias"]
    if causal:
        sd.update({"attn.in_proj_weight": w_in, "attn.in_proj_bias": b_in})
    else:
        sd.update({"attn.in_proj.weight": w_in, "attn.in_proj.bias": b_in})
    block.load_state_dict({k: T(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = block(T(x), None if mask is None else T(mask))
    close(got, want)


def test_clip_vision_tower_matches_jax(pair, rng):
    jcfg, jmodel, params, model = pair
    c = jcfg.clip
    img = rng.standard_normal((2, c.image_resolution, c.image_resolution, 3)).astype(np.float32)
    alpha = rng.standard_normal((2, c.image_resolution, c.image_resolution, 1)).astype(np.float32)
    ctx = rng.standard_normal((c.n_ctx, c.vision_width)).astype(np.float32)
    deep = [rng.standard_normal((c.n_ctx, c.vision_width)).astype(np.float32)
            for _ in range(c.prompt_depth - 1)]
    want = japply(jmodel, params, lambda m, *a: m.clip_model.image_encoder(*a),
                  img, alpha, ctx, deep)
    with torch.no_grad():
        got = model.clip_model.image_encoder(T(img), T(alpha), T(ctx), [T(d) for d in deep])
    close(got, want)


def test_clip_text_tower_matches_jax(pair, rng):
    jcfg, jmodel, params, model = pair
    c = jcfg.clip
    prompts = (0.3 * rng.standard_normal((5, c.context_length, c.transformer_width))).astype(np.float32)
    eot = np.array([9, 12, 76, 5, 30], np.int32)
    deep = [rng.standard_normal((c.n_ctx, c.transformer_width)).astype(np.float32)
            for _ in range(c.prompt_depth - 1)]
    want = japply(jmodel, params, lambda m, *a: m.clip_model.text_encoder(*a),
                  prompts, eot, deep)
    with torch.no_grad():
        got = model.clip_model.text_encoder(T(prompts), T(eot), [T(d) for d in deep])
    close(got, want)


@pytest.mark.parametrize("features", [64, 8])
def test_sam_patch_embed_matches_jax(rng, features):
    jpe = JPatchEmbed(features, 16)
    x = rng.standard_normal((2, 48, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jpe.init(k, jnp.asarray(x)), jax.random.PRNGKey(0))
    p = random_params(shapes)["params"]
    want = jpe.apply({"params": p}, jnp.asarray(x))
    pe = PatchEmbedMatmul(3, features, 16, torch.float32)
    pe.load_state_dict({"proj.weight": T(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)),
                        "proj.bias": T(p["bias"])}, strict=True)
    with torch.no_grad():
        close(pe(T(x)), want)


# ---------------------------------------------- the modules around them


@pytest.mark.parametrize("enc", [None, dict(img_size=80), dict(gelu_approximate=False)])
def test_sam_encoder_matches_jax(rng, enc):
    """Reference-mode SAM encoder incl. the EVP prompt stream (raw-reshape
    scramble) and the padded window carry; img 80 gives a 5x5 grid padded
    to 6x6, so pad tokens are re-zeroed after every LN1."""
    jcfg, jmodel, params, model = make_pair(enc, seed=2)
    x = rng.standard_normal((2, jcfg.inp_size, jcfg.inp_size, 3)).astype(np.float32)
    want, want_interm = japply(jmodel, params, lambda m, a: m.image_encoder(a, interm=True), x)
    with torch.no_grad():
        got, interm = model.image_encoder(T(x))
    close(got, want)
    assert len(interm) == len(want_interm)
    for g, w in zip(interm, want_interm):
        close(g, w)


def test_mask_decoder_matches_jax(pair, rng):
    jcfg, jmodel, params, model = pair
    C, g = jcfg.prompt_embed_dim, jcfg.embedding_size
    feats = rng.standard_normal((2, g, g, C)).astype(np.float32)
    pe = rng.standard_normal((g, g, C)).astype(np.float32)
    sparse = rng.standard_normal((2, 2, C)).astype(np.float32)
    dense = rng.standard_normal((2, g, g, C)).astype(np.float32)
    want = japply(jmodel, params, lambda m, *a: m.mask_decoder(*a), feats, pe, sparse, dense)
    with torch.no_grad():
        got = model.mask_decoder(T(feats), T(pe), T(sparse), T(dense))
    for gt, wt in zip(got, want):
        close(gt, wt)


def test_prompt_learner_matches_jax(pair, rng):
    jcfg, jmodel, params, model = pair
    w = jcfg.clip.transformer_width
    prefix = rng.standard_normal((3, 1, w)).astype(np.float32)
    suffix = rng.standard_normal((3, 77 - 1 - jcfg.clip.n_ctx, w)).astype(np.float32)
    want = japply(jmodel, params, lambda m, *a: m.clip_model.prompt_learner(*a), prefix, suffix)
    pl = model.clip_model.prompt_learner
    with torch.no_grad():
        prompts, deep_text = pl.text_prompts(T(prefix), T(suffix))
        shared, deep_visual = pl.visual_prompts()
    close(prompts, want[0])
    close(shared, want[1])
    for g, wt in zip(deep_text + deep_visual, list(want[2]) + list(want[3])):
        close(g, wt)


def test_decoder_pe_matrix_stays_fp32_as_in_the_reference():
    """The decoder's Gaussian PE matrix is a buffer the port never casts, as
    in the reference's SAM module, in fp32 and bf16 builds alike: its PE on
    the 64 x 64 grid (ViT-H's, 128 frequencies) equals JAX's PE of the fp32
    matrix within 1e-6. JAX's bf16 configuration casts the matrix (a rank-2
    param) to bf16 before the fp32 PE, which moves the PE by ~0.05 max abs
    from these draws: a fault of the JAX package that the port does not copy
    (ROADMAP.md)."""
    from camouflaged_vlm_tpu.models.position_embedding import (
        random_position_embedding as j_pe,
    )
    from camouflaged_vlm_tpu_torch.models.position_embedding import random_position_embedding

    for dtype in (torch.float32, torch.bfloat16):
        model = build_cascade(CascadeConfig.tiny(dtype=dtype), "cpu", 0)
        assert model.pe_layer.positional_encoding_gaussian_matrix.dtype == torch.float32
    g = np.random.default_rng(0).standard_normal((2, 128)).astype(np.float32)
    got = random_position_embedding(torch.from_numpy(g), 64).numpy()
    assert got.shape == (64, 64, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(j_pe(jnp.asarray(g), 64)), rtol=0, atol=1e-6)
    bf16_cfg = np.asarray(j_pe(jnp.asarray(g, jnp.bfloat16), 64))
    d = np.abs(got - bf16_cfg).max()
    assert 0.02 < d < 0.1, d
