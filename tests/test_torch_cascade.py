"""The PyTorch port's whole slice against the JAX package, on the CPU.

A tiny cascade is built in both packages from the same random parameters:
SAM on `attn_impl='reference'`, and an Alpha-CLIP vision tower of 8 heads x
d 16 (width 128), so that the JAX side walks its fused kernel branch (its
alignment gates need heads % 8 == 0 and 8*d % 128 == 0). The JAX
parameters are drawn with numpy over the tree `jax.eval_shape` gives (no
init program is compiled), converted by the port's jax-free converter, and
loaded with `strict=True`.

Tolerance: 1e-4 relative (to the output's largest magnitude) for the
probabilities and logits. Both sides compute in fp32 on the CPU, so the only
differences are the summation orders of XLA's and PyTorch's matmuls,
convolutions and reductions, accumulated through ~20 layers; 1e-4 leaves
about two orders of magnitude over the fp32 rounding that produces while
still catching any change of formula. The predicted class ids must be equal.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from camouflaged_vlm_tpu.factory import make_bank_inputs as jax_make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu.io.convert import export_cascade_checkpoint  # noqa: E402
from camouflaged_vlm_tpu.models import CascadeConfig as JaxCascadeConfig  # noqa: E402
from camouflaged_vlm_tpu.models import OVCOSCascade as JaxCascade  # noqa: E402
from camouflaged_vlm_tpu.models.clip import AlphaClipConfig as JaxClipConfig  # noqa: E402

from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu_torch.io.convert import (  # noqa: E402
    cascade_key_map,
    load_jax_params,
    state_dict_from_jax_params,
)
from camouflaged_vlm_tpu_torch.models import CascadeConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig  # noqa: E402

CLASSES = ["cat", "owl", "bat", "sea horse", "moth"]
CLIP_8x16 = dict(vision_width=128, vision_heads=8)


def _rel_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


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
def tiny_pair():
    jcfg = JaxCascadeConfig.tiny()
    jcfg = dataclasses.replace(
        jcfg,
        encoder=dataclasses.replace(jcfg.encoder, attn_impl="reference"),
        clip=JaxClipConfig.tiny(**CLIP_8x16),
    )
    jmodel = JaxCascade(jcfg)
    jbank = jax_make_bank_inputs(jcfg, CLASSES, seed=3)
    rng = np.random.default_rng(1)
    B = 2
    inputs = (
        rng.standard_normal((B, jcfg.inp_size, jcfg.inp_size, 3)).astype(np.float32),
        rng.standard_normal((B, jcfg.clip_size, jcfg.clip_size, 3)).astype(np.float32),
        np.full((B, jcfg.clip_size, jcfg.clip_size, 1), 1.923, np.float32),
    )
    bank_args = (jbank["prefix"], jbank["suffix"], jbank["eot_indices"], jbank["bank_features"])
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, *inputs, *bank_args, method=jmodel.infer_cascade),
        jax.random.PRNGKey(0),
    )
    params = random_params(shapes)

    cfg = dataclasses.replace(CascadeConfig.tiny(), clip=AlphaClipConfig.tiny(**CLIP_8x16))
    model = build_cascade(cfg, "cpu")
    load_jax_params(model, params, cfg)
    return jcfg, jmodel, params, cfg, model, inputs, bank_args


def test_converter_matches_jax_export_bit_for_bit(tiny_pair):
    jcfg, _, params, cfg, model, _, _ = tiny_pair
    want, missing = export_cascade_checkpoint(params, jcfg, strict=True)
    assert not missing
    got = state_dict_from_jax_params(params, cfg)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the port's modules carry exactly the reference's keys
    assert set(model.state_dict()) == {tk for tk, _, _ in cascade_key_map(cfg)}


def test_infer_cascade_matches_jax(tiny_pair):
    _, jmodel, params, cfg, model, inputs, bank_args = tiny_pair
    jprobs, jpred, jlogits = jax.jit(
        lambda p, *a: jmodel.apply(p, *a, method=jmodel.infer_cascade)
    )(params, *inputs, *bank_args)

    t = lambda a: torch.from_numpy(np.asarray(a))
    probs, pred, logits = model.infer_cascade(
        *map(t, inputs), *map(t, bank_args)
    )
    assert probs.shape == jprobs.shape and logits.shape == jlogits.shape
    _rel_close(probs.numpy(), jprobs, 1e-4)
    _rel_close(logits.numpy(), jlogits, 1e-4)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    # the run is not degenerate: the mask varies and classes are separated
    assert float(np.asarray(jprobs).std()) > 1e-3
    assert float(np.ptp(np.asarray(jlogits), axis=-1).min()) > 1e-2


def test_bank_inputs_match_jax():
    jcfg = JaxCascadeConfig.tiny()
    want = jax_make_bank_inputs(jcfg, CLASSES, seed=7)
    got = make_bank_inputs(CascadeConfig.tiny(), CLASSES, seed=7)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_port_imports_no_jax():
    """Importing the whole port (and running it) loads neither jax nor flax.
    A subprocess, because this test process has jax imported already."""
    code = (
        "import sys, pkgutil, importlib, torch\n"
        "import camouflaged_vlm_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from camouflaged_vlm_tpu_torch.factory import build_tiny_cascade, make_bank_inputs\n"
        "m, cfg = build_tiny_cascade()\n"
        "b = make_bank_inputs(cfg, ['cat', 'owl'])\n"
        "m.encode_class_text_features(b['prefix'], b['suffix'], b['eot_indices'], b['bank_features'])\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout
