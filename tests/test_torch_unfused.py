"""SAM's unfused 'flash' and 'aug_*' paths in the PyTorch port against the JAX
package, on the CPU.

The plain versions of TPU kernels #10 (`flash_attention_relpos`) and #20
(`flash_attention_fullk`) against the JAX kernels run in Pallas interpret
mode (as `tests/test_attention_impls.py` runs them), `augment_qk` and
`attention_xla` against JAX's, the encoder on every unfused path against
the JAX encoder on the same converted weights (4, 6 and 12 heads; a 2-block
config at 512 px whose global block has N = 1024 tokens, so that the
`N >= 1024` choice of #20 is pinned), the tiny cascade at a ViT-B-like head
count end to end, and one train step of the tiny unfused-'flash' cascade
(loss and every trainable gradient against JAX's `value_and_grad`).

Tolerances, relative to the output's largest magnitude: ops 1e-5 (fp32 on
both sides, differing only in summation order; the port pads the augmented
features to 16 lanes where JAX pads to 128, zero lanes that add exact
zeros); modules, the cascade and the train step 1e-4 (the same through
several blocks, the decoder and the backward), the gradients with an
absolute floor of 1e-8 as in `tests/test_torch_train.py`.
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
from camouflaged_vlm_tpu.ops import aug_attention as j_aug  # noqa: E402
from camouflaged_vlm_tpu.ops import flash_attention as j_fa  # noqa: E402
from camouflaged_vlm_tpu.train.train_step import combine_params, partition_params  # noqa: E402

from camouflaged_vlm_tpu_torch import train  # noqa: E402
from camouflaged_vlm_tpu_torch.factory import (  # noqa: E402
    attach_rel_cache,
    build_cascade,
    make_bank_inputs,
)
from camouflaged_vlm_tpu_torch.io.convert import (  # noqa: E402
    _inverse_transform,
    cascade_key_map,
    load_jax_params,
)
from camouflaged_vlm_tpu_torch.models import CascadeConfig, SamEncoderConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.models import sam_encoder  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import aug_attention as aug  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import flash_attention as fa  # noqa: E402

OP_RTOL, MODULE_RTOL = 1e-5, 1e-4
CLASSES = ["cat", "owl", "bat", "moth"]
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
J = jnp.asarray


def close(got, want, rtol, floor=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max() + floor)


def rnd(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    orig = j_fa.pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*args, **kw)

    monkeypatch.setattr(j_fa.pl, "pallas_call", interp)
    monkeypatch.setattr(j_fa, "_on_cpu", lambda: False)


# ------------------------------------------------------------ the kernels


@pytest.mark.parametrize("BB,H,W,d", [(3, 14, 14, 64), (5, 32, 32, 64), (7, 5, 6, 16)])
def test_flash_attention_relpos_matches_jax_kernel(rng, interpret, BB, H, W, d):
    """#10's plain version against the TPU kernel: a window batch of 196
    tokens, a global grid of 1024 (two query tiles of 512), a ragged one."""
    N = H * W
    q, k, v = rnd(rng, BB, N, d, scale=d ** -0.5), rnd(rng, BB, N, d), rnd(rng, BB, N, d)
    rel = rnd(rng, BB, N, H + W, scale=0.5)
    sel = fa.make_rel_scatter(H, W)
    want = j_fa.flash_attention_relpos(J(q), J(k), J(v), J(rel), J(sel.numpy()))
    close(fa.flash_attention_relpos(T(q), T(k), T(v), T(rel), sel, H, W), want, OP_RTOL)


@pytest.mark.parametrize("BB,N,dqk,dv,block_q", [(3, 256, 208, 80, 128),
                                                 (5, 1024, 48, 16, 128), (2, 196, 96, 32, 196)])
def test_flash_attention_fullk_matches_jax_kernel(rng, interpret, BB, N, dqk, dv, block_q):
    q, k, v = rnd(rng, BB, N, dqk, scale=dqk ** -0.5), rnd(rng, BB, N, dqk), rnd(rng, BB, N, dv)
    want = j_fa.flash_attention_fullk(J(q), J(k), J(v), block_q=block_q)
    close(fa.flash_attention_fullk(T(q), T(k), T(v)), want, OP_RTOL)
    close(fa.flash_attention_fullk_ref(T(q), T(k), T(v)), want, OP_RTOL)


@pytest.mark.parametrize("H,W,use_rel,pad_to", [(4, 4, True, 128), (3, 5, True, 16),
                                                (14, 14, True, 16), (2, 4, False, 128)])
def test_augment_qk_and_attention_xla_match_jax(rng, H, W, use_rel, pad_to):
    B, heads, d = 2, 3, 16
    N = H * W
    q, k, v = rnd(rng, B, heads, N, d), rnd(rng, B, heads, N, d), rnd(rng, B, heads, N, d)
    rh = rnd(rng, 2 * H - 1, d, scale=0.3) if use_rel else None
    rw = rnd(rng, 2 * W - 1, d, scale=0.3) if use_rel else None
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    jq, jk = j_aug.augment_qk(J(q), J(k), opt(rh, J), opt(rw, J), (H, W), d ** -0.5, pad_to)
    tq, tk = aug.augment_qk(T(q), T(k), opt(rh, T), opt(rw, T), (H, W), d ** -0.5, pad_to)
    close(tq, jq, OP_RTOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))  # data movement: exact
    close(aug.attention_xla(tq, tk, T(v)), j_aug.attention_xla(jq, jk, J(v)), OP_RTOL)
    if pad_to == 16:  # the padding the port's encoder uses changes no result
        wq, wk = j_aug.augment_qk(J(q), J(k), opt(rh, J), opt(rw, J), (H, W), d ** -0.5)
        close(aug.attention_xla(tq, tk, T(v)), j_aug.attention_xla(wq, wk, J(v)), OP_RTOL)


def test_rel_and_scatter_matches_jax(rng):
    H, W, heads, d = 5, 7, 3, 8
    q = rnd(rng, 2, H, W, heads, d)
    rh, rw = rnd(rng, 2 * H - 1, d), rnd(rng, 2 * W - 1, d)
    jrel, jsel = j_sam.rel_and_scatter(J(q), J(rh), J(rw), H, W)
    tables = sam_encoder.global_rel_tables(H, W, T(rh), T(rw), torch.float32)
    for t in (None, tables):
        rel, sel = sam_encoder.rel_and_scatter(T(q), T(rh), T(rw), H, W, tables=t)
        close(rel, jrel, OP_RTOL)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))


# -------------------------------------------------- encoder and cascade


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
        if name.startswith("rel_pos"):  # large enough for the bias to matter
            return (0.5 * rng.standard_normal(sd.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def make_pair(enc, seed=2, B=2):
    """(JAX cascade, its params, the port's cascade with them loaded,
    inputs, bank) for the tiny cascade with SAM encoder overrides `enc`."""
    jenc = j_sam.SamEncoderConfig.tiny(**enc)
    jcfg = dataclasses.replace(JCascadeConfig.tiny(), inp_size=jenc.img_size, encoder=jenc)
    jmodel = JCascade(jcfg)
    jbank = j_make_bank_inputs(jcfg, CLASSES, seed=3)
    bank = (jbank["prefix"], jbank["suffix"], jbank["eot_indices"], jbank["bank_features"])
    rng = np.random.default_rng(seed)
    inputs = (
        rng.standard_normal((B, jcfg.inp_size, jcfg.inp_size, 3)).astype(np.float32),
        rng.standard_normal((B, jcfg.clip_size, jcfg.clip_size, 3)).astype(np.float32),
        np.full((B, jcfg.clip_size, jcfg.clip_size, 1), 1.923, np.float32),
    )
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, *inputs, *bank, method=jmodel.infer_cascade),
        jax.random.PRNGKey(0))
    params = random_params(shapes, seed)
    cfg = dataclasses.replace(CascadeConfig.tiny(), inp_size=jenc.img_size,
                              encoder=SamEncoderConfig.tiny(**enc))
    model = build_cascade(cfg, "cpu")
    load_jax_params(model, params, cfg)
    return jcfg, jmodel, params, cfg, model, inputs, bank


def _jax_encoder(jmodel, params, x):
    return jax.jit(lambda v, a: jmodel.apply(
        v, a, method=lambda m, a: m.image_encoder(a, interm=True)))(params, x)


class _Counting:
    """Counts the calls of a kernel wrapper that the encoder makes."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


ENCODERS = [
    ("flash 4 heads", dict(attn_impl="flash")),
    ("flash 6 heads", dict(attn_impl="flash", embed_dim=48, num_heads=6, prompt_scale_factor=8)),
    ("flash 4 heads, img 80 (padded windows)", dict(attn_impl="flash", img_size=80)),
    ("aug_flash", dict(attn_impl="aug_flash")),
    ("aug_xla", dict(attn_impl="aug_xla", img_size=80)),
]


@pytest.mark.parametrize("name,enc", ENCODERS, ids=[e[0] for e in ENCODERS])
def test_unfused_encoder_matches_jax(monkeypatch, name, enc):
    """The port's encoder on the unfused paths against JAX's (which runs the
    same branch: 'flash' at heads % 8 != 0 is unfused in both), with and
    without the rel cache; #10 serves every 'flash' block, and no block
    reaches #20 below 1024 tokens."""
    jcfg, jmodel, params, cfg, model, inputs, _ = make_pair(enc)
    want, want_interm = _jax_encoder(jmodel, params, inputs[0])
    relpos = _Counting(sam_encoder.flash_attention_relpos)
    fullk = _Counting(sam_encoder.flash_attention_fullk)
    monkeypatch.setattr(sam_encoder, "flash_attention_relpos", relpos)
    monkeypatch.setattr(sam_encoder, "flash_attention_fullk", fullk)
    enc_t = model.image_encoder
    with torch.no_grad():
        for cached in (False, True):
            if cached:
                attach_rel_cache(model)
            got, interm = enc_t(T(inputs[0]))
            close(got, want, MODULE_RTOL)
            assert len(interm) == len(want_interm)
            for g, w in zip(interm, want_interm):
                close(g, w, MODULE_RTOL)
        enc_t(T(inputs[0]))  # the cache stays valid: no stale-cache raise
    depth = cfg.encoder.depth
    assert relpos.calls == (3 * depth if enc["attn_impl"] == "flash" else 0)
    assert fullk.calls == 0
    cached = [b.attn.rel_cache is not None for b in enc_t.blocks]
    assert all(cached) if enc["attn_impl"] == "flash" else not any(cached)
    assert float(np.asarray(want).std()) > 1e-2


TWO_BLOCKS_512 = dict(img_size=512, depth=2, global_attn_indexes=(1,))


@pytest.mark.parametrize("impl,use_rel", [("aug_flash", True), ("aug_xla", True),
                                          ("flash", True), ("flash", False)])
def test_global_block_of_1024_tokens_takes_the_jax_branch(interpret, monkeypatch, impl,
                                                          use_rel):
    """A 2-block encoder at 512 px (grid 32): the global block has N = 1024,
    where JAX sends 'aug_flash' and rel-pos-free 'flash' to #20 and keeps
    'aug_xla' on `attention_xla` and rel-pos 'flash' on #10. The port takes
    the same branches (counted) and agrees with JAX's outputs, whose #20 runs
    in interpret mode."""
    enc = dict(attn_impl=impl, use_rel_pos=use_rel, **TWO_BLOCKS_512)
    _, jmodel, params, _, model, inputs, _ = make_pair(enc, B=1)
    want, _ = _jax_encoder(jmodel, params, inputs[0])
    relpos = _Counting(sam_encoder.flash_attention_relpos)
    fullk = _Counting(sam_encoder.flash_attention_fullk)
    monkeypatch.setattr(sam_encoder, "flash_attention_relpos", relpos)
    monkeypatch.setattr(sam_encoder, "flash_attention_fullk", fullk)
    with torch.no_grad():
        got, _ = model.image_encoder(T(inputs[0]))
    close(got, want, MODULE_RTOL)
    to_fullk = impl == "aug_flash" or (impl == "flash" and not use_rel)
    assert fullk.calls == int(to_fullk)
    assert relpos.calls == (2 if impl == "flash" and use_rel else 0)


def test_vit_b_like_cascade_matches_jax():
    """The tiny cascade with SAM at 12 heads (ViT-B's count, d 8) on
    'flash', hence unfused, against JAX end to end."""
    enc = dict(attn_impl="flash", embed_dim=96, num_heads=12, prompt_scale_factor=8,
               img_size=80)
    _, jmodel, params, _, model, inputs, bank = make_pair(enc)
    jprobs, jpred, jlogits = jax.jit(
        lambda p, *a: jmodel.apply(p, *a, method=jmodel.infer_cascade))(params, *inputs, *bank)
    attach_rel_cache(model)
    probs, pred, logits = model.infer_cascade(*map(T, inputs), *map(T, bank))
    close(probs, jprobs, MODULE_RTOL)
    close(logits, jlogits, MODULE_RTOL)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    assert float(np.asarray(jprobs).std()) > 1e-3


def test_unfused_flash_train_step_matches_jax():
    """Loss and every trainable gradient of forward_with_text + the loss on
    the tiny cascade (SAM 'flash' at 4 heads, unfused): #10's plain-VJP
    Function and the padded-window carry against JAX's `value_and_grad`."""
    _, jmodel, params, cfg, model, inputs, bank = make_pair(dict(attn_impl="flash", img_size=80))
    S = cfg.inp_size
    yy, xx = np.mgrid[:S, :S]
    gt = np.stack([((yy - 30 - 10 * i) ** 2 + (xx - 40) ** 2 < 400) for i in range(2)])
    gt = gt[..., None].astype(np.float32)
    jtf = jmodel.apply(params, *bank, method=jmodel.encode_class_text_features)
    trainable, frozen = partition_params(jax.tree.map(jnp.asarray, params))

    def loss(t):
        masks, edges = jmodel.apply(combine_params(t, frozen), *inputs, jtf,
                                    method=jmodel.forward_with_text)
        return jtrain.segmentation_loss(masks, edges, gt, "iou")[0]

    jl, jg = jax.jit(jax.value_and_grad(loss))(trainable)
    tbank = make_bank_inputs(cfg, CLASSES, seed=3)
    tf = model.encode_class_text_features(tbank["prefix"], tbank["suffix"],
                                          tbank["eot_indices"], tbank["bank_features"])
    attach_rel_cache(model)  # as the train CLI does: the rel-pos parameters are frozen
    params_t = train.trainable_parameters(model)
    masks, edges = model.forward_with_text(*map(T, inputs), tf)
    total, _ = train.segmentation_loss(masks, edges, T(gt))
    total.backward()
    close(total, jl, 1e-5)
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert len(grads) == len(params_t)
    seen = 0
    for tk, fp, kind in cascade_key_map(cfg):
        key = ("params",) + tuple(fp.split("/"))
        assert (key in jg) == (tk in grads), tk
        if tk in grads:
            want = _inverse_transform(kind, np.asarray(jg[key], np.float32))
            got = grads[tk] if grads[tk] is not None else torch.zeros(want.shape)
            close(got, want, MODULE_RTOL, floor=1e-8)
            seen += 1
    assert seen > 40
    pg = grads["image_encoder.prompt_generator.lightweight_mlp_0.0.weight"]
    assert float(pg.abs().max()) > 1e-6  # through every block, #10's VJP included
