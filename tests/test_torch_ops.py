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

import jax  # noqa: E402
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


# The card runs #2, #3 and #4/#5 as stages (ops/linear.py): the LN row pass
# (`ln_rows_ref`, with or without the row mask), then the GEMM with its
# epilogue (`linear_act_ref`; the MLP's fc2 `linear_residual_ref`, on the
# hidden rounded to the working type). Composed, the stages must be the JAX
# function: in fp32 at RTOL, and in bf16 within BF16_MAX_REL / BF16_MEAN_REL.
# In bf16 both sides round the same values at the same points and differ only
# in fp32 summation order, which flips a rounding by one bf16 ulp (2^-8 =
# 3.9e-3 of that element) for a few elements (measured: at most 0.04% of
# them, mean relative error < 3e-9); moving a rounding point (the LN output or
# the hidden kept in fp32) gives a mean relative error of 4.5e-4 to 1.9e-3 on
# these inputs, so BF16_MEAN_REL = 1e-4 shows the rounding points are the TPU
# kernels'. BF16_MAX_REL = 1e-2 (~2.5 ulp) is the card's gate.
BF16_MAX_REL, BF16_MEAN_REL = 1e-2, 1e-4
STAGE_DTYPES = ["float32", "bfloat16"]


def stages_close(got, want, dtype):
    if dtype == "float32":
        close(got, want)
        return
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got - want)
    assert d.max() / np.abs(want).max() < BF16_MAX_REL
    assert d.mean() / np.abs(want).mean() < BF16_MEAN_REL


def _in(dtype):
    """numpy -> (torch, jax) converters in the working type."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    return (lambda a: T(np.ascontiguousarray(a)).to(tdt)), (lambda a: jnp.asarray(a, jdt))


@pytest.mark.parametrize("dtype", STAGE_DTYPES)
@pytest.mark.parametrize("activation", [None, "quick_gelu"])
def test_ln_linear_stages_match_jax(rng, dtype, activation):
    x = rnd(rng, 2, 37, 64, scale=3.0) + 1.0
    g, be = 1 + rnd(rng, 64, scale=0.1), rnd(rng, 64, scale=0.1)
    w, b = rnd(rng, 64, 96, scale=0.125), rnd(rng, 96)
    tt, jj = _in(dtype)
    want = j_lin.ln_linear_act_bt(jj(x), J(g[None]), J(be[None]), jj(w), jj(b[None]), eps=1e-5,
                                  activation=activation)
    xn = linear.ln_rows_ref(tt(x), T(g), T(be), 1e-5)
    assert xn.dtype == getattr(torch, dtype)  # the LN rows are rounded to the working type
    stages_close(linear.linear_act_ref(xn, tt(w.T), tt(b), activation), want, dtype)


@pytest.mark.parametrize("dtype", STAGE_DTYPES)
@pytest.mark.parametrize("nwin", [1, 3])
def test_ln_mask_linear_stages_match_jax(rng, dtype, nwin):
    x = rnd(rng, 2 * nwin, 25, 64) + 0.5
    g, be = 1 + rnd(rng, 64, scale=0.1), rnd(rng, 64, scale=0.1)
    mask = (rng.random((nwin, 25, 1)) > 0.3).astype(np.float32)
    w, b = rnd(rng, 64, 80, scale=0.125), rnd(rng, 80)
    tt, jj = _in(dtype)
    want = j_lin.ln_mask_linear_bt(jj(x), J(g[None]), J(be[None]), jj(mask), jj(w), jj(b[None]),
                                   eps=1e-6)
    xn = linear.ln_rows_ref(tt(x), T(g), T(be), 1e-6, tt(mask))
    for i in range(2 * nwin):  # masked rows are exact zeros before the product
        assert not xn[i][torch.from_numpy(mask[i % nwin, :, 0] == 0)].any()
    stages_close(linear.linear_act_ref(xn, tt(w.T), tt(b)), want, dtype)


@pytest.mark.parametrize("dtype", STAGE_DTYPES)
@pytest.mark.parametrize("activation", ["gelu_tanh", "quick_gelu"])
def test_ln_mlp_residual_stages_match_jax(rng, dtype, activation):
    x = rnd(rng, 3, 17, 64, scale=2.0)
    g, be = 1 + rnd(rng, 64, scale=0.1), rnd(rng, 64, scale=0.1)
    w1, b1 = rnd(rng, 64, 256, scale=0.125), rnd(rng, 256, scale=0.1)
    w2, b2 = rnd(rng, 256, 64, scale=0.0625), rnd(rng, 64, scale=0.1)
    tt, jj = _in(dtype)
    want = j_lin.ln_mlp_residual_bt(jj(x), J(g[None]), J(be[None]), jj(w1), jj(b1[None]), jj(w2),
                                    jj(b2[None]), eps=1e-5, activation=activation)
    xt = tt(x)
    h = linear.linear_act_ref(linear.ln_rows_ref(xt, T(g), T(be), 1e-5), tt(w1.T), tt(b1),
                              activation)  # fc1: the hidden, rounded to the working type
    assert h.dtype == xt.dtype and h.shape == (3, 17, 256)
    stages_close(linear.linear_residual_ref(h, tt(w2.T), tt(b2), xt), want, dtype)


@pytest.mark.parametrize("M,N,act,want", [
    (8192, 1280, True, 128),   # patch embed, batch 2: 5 rounds of 128-wide tiles, 3 of 256
    (6272, 3840, False, 256),  # SAM windows qkv: 12 rounds against 6
    (1162, 3072, False, 256),  # CLIP qkv: 240 tiles in 2 rounds, 120 in one
    (1162, 1024, False, 128),  # CLIP fc2: 80 tiles in one round either way
    (1162, 4096, True, 128),   # CLIP fc1: 3 rounds against 2, but the activation
    (6272, 5120, True, 128),   # SAM windows fc1: 15 rounds against 8
    (8192, 5120, True, 128),   # SAM global fc1: 20 rounds against 10, a tie
    (2016, 1280, False, 256),  # SAM edge fc2: 160 tiles in 2 rounds, 80 in one
    (581, 1024, False, 128),   # CLIP fc2 at batch 1: 40 tiles in one round, 20 in one
])
def test_gemm_tile_n_fills_the_last_round(M, N, act, want):
    assert linear.gemm_tile_n(M, N, 132, act) == want


@pytest.mark.parametrize("S,N,G,want", [
    (196, 1280, 32, 256),  # SAM windows: 64 row tiles, 640 in 5 rounds, 320 in 3, ragged
    (112, 1280, 18, 256),  # SAM edge: 18 row tiles, 180 in 2 rounds, 90 in one
    (4096, 1280, 2, 128),  # SAM global: 64 row tiles, 640 in 5 rounds, 320 in 3
    (581, 1024, 2, 128),   # CLIP: 10 row tiles, 80 in one round, 40 in one
])
def test_gemm_tile_n_counts_row_tiles_per_group(S, N, G, want):
    """proj_rows' tiles hold rows of one (B, T) group: G groups of S rows
    are G * ceil(S / 128) row tiles (64 at SAM's windows, where the rows
    alone make 49), and groups that end in a partial row tile make 256-wide
    rounds cheaper. The picks are the faster width at the main-path shapes
    at batch 2 in the forced-width times of `cli/kernel_timing.py` on the
    H100 (PERF.md, PR 9): the windows and the global blocks have the same
    tile counts and opposite winners."""
    assert linear.gemm_tile_n(S, N, 132, False, G) == want


@pytest.mark.parametrize("M,H", [(6272, 5120), (8192, 5120), (16384, 5120), (1162, 4096),
                                 (37, 512), (13100, 5120)])
def test_mlp_panel_rows_bound_the_scratch(M, H):
    rows = linear.mlp_panel_rows(M, H)
    panels = -(-M // rows)
    assert rows == M or rows % linear.GEMM_BM == 0
    assert rows * H <= linear.MLP_SCRATCH_ELEMS  # (13100, 5120): not 2 x 6656 rows
    # panels of nearly equal size: the last is not a sliver
    assert M - (panels - 1) * rows > rows // 2 or panels == 1


@pytest.mark.parametrize("with_res", [False, True])
def test_proj_rows_matches_jax(rng, with_res):
    x, w, b = rnd(rng, 2, 3, 32, 19), rnd(rng, 32, 24, scale=0.2), rnd(rng, 24)
    res = rnd(rng, 2, 3, 19, 24) if with_res else None
    want = j_lin.proj_rows(J(x), J(w), J(b[None]), None if res is None else J(res))
    got = linear.proj_rows(T(x), T(w.T.copy()), T(b), None if res is None else T(res))
    close(got, want)


@pytest.mark.parametrize("S", [37, 196])
def test_proj_rows_reads_a_padded_view_as_jax(rng, S):
    """x as the attention wrappers hand it to proj_rows on the card: the
    view [..., :S] of rows padded to a multiple of 8 (`linear.dmajor_empty`)."""
    x, w, b = rnd(rng, 2, 3, 32, S), rnd(rng, 32, 24, scale=0.2), rnd(rng, 24)
    res = rnd(rng, 2, 3, S, 24)
    xv = linear.dmajor_empty(2, 3, 32, S, dtype=torch.float32, device="cpu").copy_(T(x))
    assert not xv.is_contiguous() and xv.stride(-2) == -(-S // 8) * 8
    want = j_lin.proj_rows(J(x), J(w), J(b[None]), J(res))
    close(linear.proj_rows(xv, T(w.T.copy()), T(b), T(res)), want)


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


# ------------------------------------------- plain backwards and pooling
#
# Each plain backward against `jax.vjp` of the JAX function (on the CPU, XLA
# autodiff of its `ref`) and against torch autograd of the port's plain
# forward, fp32, at RTOL: the same formulas in both, only summation orders
# differ.


def _vjp(fn, primals, cot):
    _, pull = jax.vjp(fn, *map(J, primals))
    return pull(J(cot))


@pytest.mark.parametrize("activation", ["gelu_tanh", "gelu", "quick_gelu"])
def test_ln_mlp_residual_bt_bwd_ref_matches_jax_vjp(rng, activation):
    x = rnd(rng, 3, 11, 32, scale=2.0)
    g, be = 1 + rnd(rng, 32, scale=0.1), rnd(rng, 32, scale=0.1)
    w1, b1 = rnd(rng, 32, 128, scale=0.2), rnd(rng, 128, scale=0.1)
    w2, b2 = rnd(rng, 128, 32, scale=0.1), rnd(rng, 32, scale=0.1)
    gy = rnd(rng, 3, 11, 32)
    want = _vjp(lambda *a: j_lin.ln_mlp_residual_bt(*a, eps=1e-5, activation=activation),
                (x, g[None], be[None], w1, b1[None], w2, b2[None]), gy)
    targs = [T(a) for a in (x, g, be, w1.T.copy(), b1, w2.T.copy(), b2)]
    got = linear.ln_mlp_residual_bt_bwd_ref(*targs, T(gy), eps=1e-5, activation=activation)
    # JAX layouts: gamma/beta/biases (1, n), w1 (K, H), w2 (H, K)
    to_jax = [lambda a: a, lambda a: a[None], lambda a: a[None], lambda a: a.T,
              lambda a: a[None], lambda a: a.T, lambda a: a[None]]
    for f, gt, wt in zip(to_jax, got, want):
        close(f(gt.numpy()), wt)
    leaves = [t.requires_grad_(True) for t in targs]
    auto = torch.autograd.grad(
        linear.ln_mlp_residual_bt_ref(*leaves, eps=1e-5, activation=activation), leaves, T(gy))
    for gt, at in zip(got, auto):
        close(gt, at.numpy())


@pytest.mark.parametrize("win", [4, 5])
def test_flash_qkv_packed_windows_s_bwd_ref_matches_jax_vjp(rng, win):
    heads, d, BW = 8, 8, 3
    S = win * win
    qkv, rel_s = rnd(rng, BW, S, 3 * heads * d), rnd(rng, S, BW, heads * 32)
    sel32 = flash_attention.make_rel_scatter32(win)
    gy = rnd(rng, BW, heads * d, S)
    scale = d ** -0.5
    want = _vjp(lambda q, r: j_fa.flash_qkv_packed_windows_s(q, r, J(sel32.numpy()), scale,
                                                              heads, d), (qkv, rel_s), gy)
    got = flash_attention.flash_qkv_packed_windows_s_bwd_ref(T(qkv), T(rel_s), sel32, T(gy),
                                                             scale, heads, d)
    for gt, wt in zip(got, want):
        close(gt, wt)
    leaves = [T(qkv).requires_grad_(True), T(rel_s).requires_grad_(True)]
    auto = torch.autograd.grad(
        flash_attention.flash_qkv_packed_windows_s_ref(*leaves, sel32, scale, heads, d),
        leaves, T(gy))
    for gt, at in zip(got, auto):
        close(gt, at.numpy())


@pytest.mark.parametrize("H,W", [(8, 8), (10, 10)])
def test_flash_qkv_packed_global_bwd_ref_matches_jax_vjp(rng, H, W):
    heads, d, B = 8, 8, 2
    N = H * W
    qkv, rel = rnd(rng, B, N, 3 * heads * d), rnd(rng, N, B, heads, H + W)
    sel = flash_attention.make_rel_scatter(H, W)
    gy = rnd(rng, B, heads * d, N)
    scale = d ** -0.5
    want = _vjp(lambda q, r: j_fa.flash_qkv_packed_global(q, r, J(sel.numpy()), scale, heads,
                                                           d, H, W), (qkv, rel), gy)
    got = flash_attention.flash_qkv_packed_global_bwd_ref(T(qkv), T(rel), sel, T(gy), scale,
                                                          heads, d)
    for gt, wt in zip(got, want):
        close(gt, wt)
    leaves = [T(qkv).requires_grad_(True), T(rel).requires_grad_(True)]
    auto = torch.autograd.grad(
        flash_attention.flash_qkv_packed_global_ref(*leaves, sel, scale, heads, d), leaves,
        T(gy))
    for gt, at in zip(got, auto):
        close(gt, at.numpy())


@pytest.mark.parametrize("activation", ["gelu_tanh", "gelu", "quick_gelu"])
def test_ln_mlp_residual_bt_function_grads(rng, activation):
    """The wrapper's Function (plain forward, plain backward on the CPU)
    against autograd of the plain forward, frozen weights and all trainable."""
    x = rnd(rng, 2, 7, 32, scale=2.0)
    args = [T(a) for a in (x, 1 + rnd(rng, 32, scale=0.1), rnd(rng, 32, scale=0.1),
                           rnd(rng, 128, 32, scale=0.2), rnd(rng, 128, scale=0.1),
                           rnd(rng, 32, 128, scale=0.1), rnd(rng, 32, scale=0.1))]
    gy = T(rnd(rng, 2, 7, 32))
    for trainable in (False, True):
        leaves = [a.clone().requires_grad_(i == 0 or trainable) for i, a in enumerate(args)]
        out = linear.ln_mlp_residual_bt(*leaves, eps=1e-6, activation=activation)
        want = linear.ln_mlp_residual_bt_ref(*leaves, eps=1e-6, activation=activation)
        close(out, want.detach().numpy())
        wrt = [t for t in leaves if t.requires_grad]
        for gt, wt in zip(torch.autograd.grad(out, wrt, gy), torch.autograd.grad(want, wrt, gy)):
            close(gt, wt.numpy())


@pytest.mark.parametrize("kernel", [3, 5])
def test_morphological_edge_matches_jax(rng, kernel):
    from camouflaged_vlm_tpu.ops import pooling as j_pool

    from camouflaged_vlm_tpu_torch.ops import pooling

    mask = (rng.random((2, 13, 17, 1)) > 0.6).astype(np.float32)
    np.testing.assert_array_equal(pooling.morphological_edge(T(mask), kernel).numpy(),
                                  np.asarray(j_pool.morphological_edge(J(mask), kernel)))
    x = rnd(rng, 2, 9, 11, 3)
    close(pooling.max_pool_2d(T(x), kernel), j_pool.max_pool_2d(J(x), kernel), 1e-6)
