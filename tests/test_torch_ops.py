"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and go through the JAX function and
its port in fp32. On the CPU the JAX kernel wrappers take their XLA `ref`
formulation (`ops/vjp.py:on_cpu`) and the port's wrappers take their plain
PyTorch version, so these tests pin the plain versions — the references the
CUDA kernels are held to on the card — to the JAX package.

Tolerance: 1e-5 relative to the output's largest magnitude. Both sides are
fp32; they differ only in the summation order of matmuls and reductions
(fp32 rounding ~6e-8 per op, a few dozen ops deep), so 1e-5 is loose enough
for that and tight enough to catch a wrong formula, layout or rounding
point. Pure data movement (window partition, tables, prompt banks) must be
bit-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from camouflaged_vlm_tpu.models.clip.model import build_causal_mask as j_causal  # noqa: E402
from camouflaged_vlm_tpu.models.clip.prompt_learner import (  # noqa: E402
    build_class_prompt_bank as j_bank,
)
from camouflaged_vlm_tpu.models.position_embedding import (  # noqa: E402
    random_position_embedding as j_pe,
)
from camouflaged_vlm_tpu.ops import fft_prompt as j_fft  # noqa: E402
from camouflaged_vlm_tpu.ops import flash_attention as j_fa  # noqa: E402
from camouflaged_vlm_tpu.ops import linear as j_lin  # noqa: E402
from camouflaged_vlm_tpu.ops import norms as j_norms  # noqa: E402
from camouflaged_vlm_tpu.ops import rel_pos as j_rel  # noqa: E402
from camouflaged_vlm_tpu.ops import resize as j_resize  # noqa: E402
from camouflaged_vlm_tpu.ops import window as j_win  # noqa: E402

from camouflaged_vlm_tpu_torch.models.clip.model import build_causal_mask  # noqa: E402
from camouflaged_vlm_tpu_torch.models.clip.prompt_learner import (  # noqa: E402
    build_class_prompt_bank,
)
from camouflaged_vlm_tpu_torch.models.position_embedding import (  # noqa: E402
    random_position_embedding,
)
from camouflaged_vlm_tpu_torch.ops import fft_prompt, flash_attention, linear, norms  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import rel_pos, resize, window  # noqa: E402

RTOL = 1e-5
ACTS = [None, "gelu", "gelu_tanh", "quick_gelu"]


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def rnd(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


T = torch.from_numpy
J = jnp.asarray


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("activation", ACTS)
def test_linear_act_matches_linear_pallas(rng, activation):
    x, w, b = rnd(rng, 40, 48), rnd(rng, 48, 24, scale=0.2), rnd(rng, 24)
    want = j_lin.linear_pallas(J(x), J(w), J(b[None]), activation=activation)
    close(linear.linear_act(T(x), T(w.T.copy()), T(b), activation), want)


@pytest.mark.parametrize("nwin", [1, 3])
def test_ln_mask_linear_bt_matches_jax(rng, nwin):
    x = rnd(rng, 2 * nwin, 9, 32) + 0.5
    g, be = 1 + rnd(rng, 32, scale=0.1), rnd(rng, 32, scale=0.1)
    mask = (rng.random((nwin, 9, 1)) > 0.3).astype(np.float32)
    w, b = rnd(rng, 32, 40, scale=0.2), rnd(rng, 40)
    want = j_lin.ln_mask_linear_bt(J(x), J(g[None]), J(be[None]), J(mask), J(w), J(b[None]),
                                   eps=1e-6)
    close(linear.ln_mask_linear_bt(T(x), T(g), T(be), T(mask), T(w.T.copy()), T(b), eps=1e-6),
          want)


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_ln_linear_act_bt_matches_jax(rng, activation, eps):
    x = rnd(rng, 2, 13, 32, scale=3.0) + 1.0
    g, be = 1 + rnd(rng, 32, scale=0.1), rnd(rng, 32, scale=0.1)
    w, b = rnd(rng, 32, 48, scale=0.2), rnd(rng, 48)
    want = j_lin.ln_linear_act_bt(
        J(x), J(g[None]), J(be[None]), J(w), J(b[None]), eps=eps, activation=activation
    )
    got = linear.ln_linear_act_bt(T(x), T(g), T(be), T(w.T.copy()), T(b), eps, activation)
    close(got, want)


@pytest.mark.parametrize("activation", ["gelu_tanh", "gelu", "quick_gelu"])
@pytest.mark.parametrize("hidden_grid", [1, 4])
def test_ln_mlp_residual_bt_matches_jax(rng, activation, hidden_grid):
    x = rnd(rng, 3, 11, 32, scale=2.0)
    g, be = 1 + rnd(rng, 32, scale=0.1), rnd(rng, 32, scale=0.1)
    w1, b1 = rnd(rng, 32, 128, scale=0.2), rnd(rng, 128, scale=0.1)
    w2, b2 = rnd(rng, 128, 32, scale=0.1), rnd(rng, 32, scale=0.1)
    want = j_lin.ln_mlp_residual_bt(
        J(x), J(g[None]), J(be[None]), J(w1), J(b1[None]), J(w2), J(b2[None]),
        eps=1e-5, activation=activation, hidden_grid=hidden_grid,
    )
    got = linear.ln_mlp_residual_bt(
        T(x), T(g), T(be), T(w1.T.copy()), T(b1), T(w2.T.copy()), T(b2),
        eps=1e-5, activation=activation,
    )
    close(got, want)


@pytest.mark.parametrize("with_res", [False, True])
def test_proj_rows_matches_jax(rng, with_res):
    x, w, b = rnd(rng, 2, 3, 32, 19), rnd(rng, 32, 24, scale=0.2), rnd(rng, 24)
    res = rnd(rng, 2, 3, 19, 24) if with_res else None
    want = j_lin.proj_rows(J(x), J(w), J(b[None]), None if res is None else J(res))
    got = linear.proj_rows(T(x), T(w.T.copy()), T(b), None if res is None else T(res))
    close(got, want)


@pytest.mark.parametrize("heads,d,S", [(8, 16, 37), (4, 8, 7), (2, 64, 21)])
def test_flash_qkv_packed_plain_matches_jax(rng, heads, d, S):
    qkv = rnd(rng, 2, S, 3 * heads * d, scale=1.5)
    scale = d ** -0.5
    want = j_fa.flash_qkv_packed_plain(J(qkv), scale, heads, d)
    close(flash_attention.flash_qkv_packed_plain(T(qkv), scale, heads, d), want)


# ------------------------------------------------------------ plain ops


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norm_matches_jax(rng, eps):
    x = rnd(rng, 4, 7, 24, scale=5.0) + 3.0
    s, b = 1 + rnd(rng, 24, scale=0.1), rnd(rng, 24, scale=0.1)
    want = j_norms.layer_norm(J(x), J(s), J(b), eps)
    close(norms.layer_norm(T(x), T(s), T(b), eps), want)
    ln = norms.LayerNormFP32(24, eps=eps)
    with torch.no_grad():
        ln.weight.copy_(T(s))
        ln.bias.copy_(T(b))
    close(ln(T(x)), want)


@pytest.mark.parametrize("size", [2, 5, 14])
def test_rel_pos_table_matches_jax(rng, size):
    table = rnd(rng, 2 * size - 1, 8)
    want = j_rel.get_rel_pos_table(size, size, J(table))
    np.testing.assert_array_equal(rel_pos.get_rel_pos_table(size, size, T(table)).numpy(), want)


def test_rel_pos_contributions_matches_jax(rng):
    H, W, d = 3, 4, 8
    q = rnd(rng, 2, 5, H * W, d)
    rh, rw = rnd(rng, 2 * H - 1, d), rnd(rng, 2 * W - 1, d)
    want = j_rel.rel_pos_contributions(J(q), J(rh), J(rw), (H, W))
    got = rel_pos.rel_pos_contributions(T(q), T(rh), T(rw), (H, W))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("use_rel", [True, False])
def test_attention_with_decomposed_rel_pos_matches_jax(rng, use_rel):
    H, W, d = 3, 4, 16
    q, k, v = (rnd(rng, 2, 3, H * W, d, scale=1.5) for _ in range(3))
    rh = rnd(rng, 2 * H - 1, d, scale=0.3) if use_rel else None
    rw = rnd(rng, 2 * W - 1, d, scale=0.3) if use_rel else None
    want = j_rel.attention_with_decomposed_rel_pos(
        J(q), J(k), J(v), None if rh is None else J(rh), None if rw is None else J(rw),
        (H, W), d ** -0.5,
    )
    got = rel_pos.attention_with_decomposed_rel_pos(
        T(q), T(k), T(v), None if rh is None else T(rh), None if rw is None else T(rw),
        (H, W), d ** -0.5,
    )
    close(got, want)


@pytest.mark.parametrize("hw,win", [((64, 64), 14), ((5, 5), 2), ((6, 4), 2)])
def test_window_partition_roundtrip_matches_jax(rng, hw, win):
    """At ViT-H the 64x64 grid pads to 70x70: 25 windows of 14x14."""
    H, W = hw
    x = rnd(rng, 2, H, W, 3)
    want, want_pad = j_win.window_partition_seq(J(x), win)
    got, pad = window.window_partition_seq(T(x), win)
    assert pad == want_pad
    np.testing.assert_array_equal(got.numpy(), want)
    back = window.window_unpartition_seq(got, win, pad, (H, W))
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        window.window_valid_mask(H, W, win).numpy(), j_win.window_valid_mask(H, W, win)
    )
    if (H, W, win) == (64, 64, 14):
        assert pad == (70, 70) and got.shape[0] == 2 * 25


@pytest.mark.parametrize("size", [32, 48])
def test_fft_highpass_matches_jax(rng, size):
    x = rnd(rng, 2, size, size, 3)
    want = j_fft.fft_highpass(J(x), 0.25)
    got = fft_prompt.fft_highpass(T(x), 0.25)
    close(got, want)
    close(got, j_fft.fft_highpass_fft(J(x), 0.25), rtol=1e-4)  # the FFT oracle


@pytest.mark.parametrize("shape,out", [((2, 16, 16, 1), (64, 64)), ((2, 64, 48, 1), (28, 28)),
                                       ((1, 10, 12, 3), (7, 15))])
def test_resize_bilinear_matches_jax(rng, shape, out):
    x = rnd(rng, *shape)
    want = j_resize.resize_bilinear(J(x), *out)
    close(resize.resize_bilinear(T(x), *out), want)


def test_resize_bilinear_matches_interpolate_without_antialias(rng):
    x = rnd(rng, 2, 40, 40, 1)
    want = torch.nn.functional.interpolate(
        T(x).permute(0, 3, 1, 2), size=(17, 17), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1)
    close(resize.resize_bilinear(T(x), 17, 17), want.numpy())


def test_random_position_embedding_matches_jax(rng):
    g = rnd(rng, 2, 16)
    close(random_position_embedding(T(g), 8), j_pe(J(g), 8))


def test_causal_mask_matches_jax():
    np.testing.assert_array_equal(build_causal_mask(9).numpy(), j_causal(9))


def test_class_prompt_bank_matches_jax(rng):
    emb = rnd(rng, 49408, 12)
    names = ["sea_horse", "owl", "egyptian nightjar"]
    want = j_bank(names, emb, n_ctx=4)
    got = build_class_prompt_bank(names, emb, n_ctx=4)
    for field in ("tokenized", "prefix", "suffix", "eot_indices"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
