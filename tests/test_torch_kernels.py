"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and the CUDA toolkit (`nvcc`); on a host
without them each one skips with the reason. On the card, without the JAX
package (tests/conftest.py imports jax):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q

Shapes are small and ragged (row counts, sequence lengths and output widths
that are not multiples of the kernels' tiles). Tolerance in bf16: max|d| /
max|ref| and mean|d| / mean|ref| below 1e-2 — kernel and plain version
round the same values at the same points and differ in fp32 summation
order, which can flip a bf16 rounding by one ulp (3.9e-3); 1e-2 is ~2.5 ulp.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from camouflaged_vlm_tpu_torch.ops import _cuda, flash_attention, linear  # noqa: E402
from camouflaged_vlm_tpu_torch.ops.compact_window import (  # noqa: E402
    LPAD_LANE,
    NEG,
    CompactGeometry,
    edge_consts,
)

pytestmark = pytest.mark.gpu
BOUND = 1e-2
ACTS = [None, "gelu", "gelu_tanh", "quick_gelu"]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def rn(gen, *shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)


def assert_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    d = (got.float() - want.float()).abs()
    ref = want.float().abs()
    assert torch.isfinite(got).all()
    assert (d.max() / ref.max()).item() < BOUND
    assert (d.mean() / ref.mean()).item() < BOUND


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("M,K,N", [(100, 768, 40), (67, 96, 130)])
def test_linear_act_kernel(gen, activation, M, K, N):
    args = (rn(gen, M, K), rn(gen, N, K, std=0.05), rn(gen, N, std=0.1))
    before = _cuda.LINEAR_ACT.launches
    got = linear.linear_act(*args, activation=activation)
    assert _cuda.LINEAR_ACT.launches == before + 1
    assert_close(got, linear.linear_act_ref(*args, activation=activation))


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("B,S,K,N", [(2, 37, 128, 384), (1, 581, 64, 72)])
def test_ln_linear_act_bt_kernel(gen, activation, B, S, K, N):
    args = (rn(gen, B, S, K) + 0.5, 1 + rn(gen, K, std=0.1, dtype=torch.float32),
            rn(gen, K, std=0.1, dtype=torch.float32), rn(gen, N, K, std=0.05),
            rn(gen, N, std=0.1))
    got = linear.ln_linear_act_bt(*args, eps=1e-5, activation=activation)
    assert_close(got, linear.ln_linear_act_bt_ref(*args, eps=1e-5, activation=activation))


@pytest.mark.parametrize("activation", ["gelu_tanh", "gelu", "quick_gelu"])
@pytest.mark.parametrize("B,S,K,H", [(2, 37, 128, 512), (3, 7, 768, 256), (1, 21, 1280, 640)])
def test_ln_mlp_residual_bt_kernel(gen, activation, B, S, K, H):
    args = (rn(gen, B, S, K), 1 + rn(gen, K, std=0.1, dtype=torch.float32),
            rn(gen, K, std=0.1, dtype=torch.float32), rn(gen, H, K, std=0.05),
            rn(gen, H, std=0.1), rn(gen, K, H, std=0.05), rn(gen, K, std=0.1))
    got = linear.ln_mlp_residual_bt(*args, eps=1e-6, activation=activation)
    assert_close(got, linear.ln_mlp_residual_bt_ref(*args, eps=1e-6, activation=activation))


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("B,T,K,S,N", [(2, 1, 128, 37, 128), (1, 3, 64, 70, 96)])
def test_proj_rows_kernel(gen, with_res, B, T, K, S, N):
    res = rn(gen, B, T, S, N) if with_res else None
    args = (rn(gen, B, T, K, S), rn(gen, N, K, std=0.05), rn(gen, N, std=0.1), res)
    assert_close(linear.proj_rows(*args), linear.proj_rows_ref(*args))


@pytest.mark.parametrize("B,S,heads,d", [(2, 37, 8, 16), (1, 581, 2, 64), (2, 7, 4, 32),
                                         (1, 100, 2, 80), (1, 65, 1, 128)])
def test_flash_qkv_packed_plain_kernel(gen, B, S, heads, d):
    qkv = rn(gen, B, S, 3 * heads * d)
    got = flash_attention.flash_qkv_packed_plain(qkv, d ** -0.5, heads, d)
    assert_close(got, flash_attention.flash_qkv_packed_plain_ref(qkv, d ** -0.5, heads, d))


@pytest.mark.parametrize("Bp,S,K,N,nwin", [(4, 37, 128, 384, 2), (1, 100, 64, 72, 1),
                                          (2, 196, 1280, 3840, 1)])
def test_ln_mask_linear_bt_kernel(gen, Bp, S, K, N, nwin):
    mask = (torch.rand(nwin, S, 1, generator=gen, device="cuda") > 0.3).to(torch.bfloat16)
    args = (rn(gen, Bp, S, K) + 0.5, 1 + rn(gen, K, std=0.1, dtype=torch.float32),
            rn(gen, K, std=0.1, dtype=torch.float32), mask, rn(gen, N, K, std=0.05),
            rn(gen, N, std=0.1))
    before = _cuda.LN_MASK_LINEAR.launches
    got = linear.ln_mask_linear_bt(*args, eps=1e-6)
    assert _cuda.LN_MASK_LINEAR.launches == before + 1
    assert_close(got, linear.ln_mask_linear_bt_ref(*args, eps=1e-6))


@pytest.mark.parametrize("BW,win,heads,d", [(3, 14, 2, 80), (5, 4, 8, 16), (2, 7, 1, 64),
                                            (2, 5, 2, 32)])
def test_flash_qkv_packed_windows_s_kernel(gen, BW, win, heads, d):
    S = win * win
    qkv = rn(gen, BW, S, 3 * heads * d)
    rel_s = rn(gen, S, BW, heads * 32)
    sel32 = flash_attention.make_rel_scatter32(win, torch.bfloat16, torch.device("cuda"))
    args = (qkv, rel_s, sel32, d ** -0.5, heads, d)
    got = flash_attention.flash_qkv_packed_windows_s(*args)
    assert_close(got, flash_attention.flash_qkv_packed_windows_s_ref(*args))


@pytest.mark.parametrize("H,W,win,heads,d", [(64, 64, 14, 2, 80), (10, 10, 4, 8, 16),
                                             (5, 5, 2, 1, 32), (9, 12, 5, 2, 64)])
def test_flash_qkv_packed_edge_kernel(gen, H, W, win, heads, d):
    """Right, bottom and corner windows (the corner ragged, with dummy rows
    whose pad-key logit is -1e30, as the encoder gives them)."""
    geom = CompactGeometry(H, W, win)
    B, n, R = 2, geom.n_edge, geom.R_u
    qkv = rn(gen, B, n, R, 3 * heads * d)
    rel = rn(gen, B, n, R, heads, 32)
    for g_start, g in zip(np.cumsum([0] + [g.n for g in geom.edge_groups]), geom.edge_groups):
        rel[:, g_start : g_start + g.n, g.rows :, :, LPAD_LANE] = NEG
    rel = rel.reshape(B, n, R, heads * 32)
    sel, kmask = edge_consts(geom, torch.bfloat16, torch.device("cuda"))
    vb = rn(gen, heads, d, std=0.5)
    args = (qkv, rel, sel, vb, kmask, d ** -0.5, heads, d)
    got = flash_attention.flash_qkv_packed_edge(*args)
    assert_close(got, flash_attention.flash_qkv_packed_edge_ref(*args))


@pytest.mark.parametrize("B,H,W,heads,d", [(2, 8, 8, 2, 80), (1, 10, 10, 8, 16),
                                           (1, 6, 10, 2, 64), (1, 64, 64, 1, 80)])
def test_flash_qkv_packed_global_kernel(gen, B, H, W, heads, d):
    N = H * W
    qkv = rn(gen, B, N, 3 * heads * d)
    rel = rn(gen, N, B, heads, H + W)
    sel = flash_attention.make_rel_scatter(H, W, torch.bfloat16, torch.device("cuda"))
    args = (qkv, rel, sel, d ** -0.5, heads, d, H, W)
    before = _cuda.QKV_GLOBAL.launches
    got = flash_attention.flash_qkv_packed_global(*args)
    assert _cuda.QKV_GLOBAL.launches == before + 1
    assert_close(got, flash_attention.flash_qkv_packed_global_ref(*args[:6]))


def test_kernels_refuse_what_they_do_not_take(gen):
    x = rn(gen, 1, 5, 128)
    g32, b32 = torch.ones(128, device="cuda"), torch.zeros(128, device="cuda")
    w1, b1 = rn(gen, 256, 128), rn(gen, 256)
    w2, b2 = rn(gen, 128, 256), rn(gen, 128)
    with pytest.raises(TypeError, match="bfloat16"):  # fp32 activations
        linear.ln_mlp_residual_bt(x.float(), g32, b32, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="K = 128"):  # width the kernel has no tile for
        linear.ln_mlp_residual_bt(x[..., :96].contiguous(), g32[:96], b32[:96],
                                  w1[:, :96].contiguous(), b1, w2[:96].contiguous(), b2[:96])
    with pytest.raises(ValueError, match="contiguous"):
        linear.linear_act(x[0].t(), rn(gen, 8, 5), rn(gen, 8))
    with pytest.raises(ValueError, match="unsupported devices"):  # mixed devices
        linear.linear_act(x[0], rn(gen, 8, 128).cpu(), rn(gen, 8))
    # a weight that needs its gradient goes through the plain-VJP Function:
    # the kernel forward, the plain version's gradient
    wg = rn(gen, 8, 128).requires_grad_(True)
    b8 = rn(gen, 8)
    before = _cuda.LINEAR_ACT.launches
    y = linear.linear_act(x[0], wg, b8)
    assert _cuda.LINEAR_ACT.launches == before + 1 and y.requires_grad
    gy = rn(gen, *y.shape)
    (got,) = torch.autograd.grad(y, wg, gy)
    (want,) = torch.autograd.grad(linear.linear_act_ref(x[0], wg, b8), wg, gy)
    assert_close(got, want)
    with pytest.raises(ValueError, match="K = 128"):  # the backward kernel refuses it too
        linear.ln_mlp_residual_bt_bwd(x[..., :96].contiguous(), g32[:96], b32[:96],
                                      w1[:, :96].contiguous(), b1, w2[:96].contiguous(),
                                      b2[:96], x[..., :96].contiguous())


# ------------------------------------------------ the backward kernels


def _grad_close(got, want):
    for gt, wt in zip(got, want):
        if wt is None:
            assert gt is None
        else:
            assert_close(gt, wt)


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("activation", ["gelu_tanh", "gelu", "quick_gelu"])
@pytest.mark.parametrize("B,S,K,H", [(2, 37, 128, 512), (3, 7, 768, 256), (1, 21, 1280, 640)])
def test_ln_mlp_residual_bt_bwd_kernel(gen, weights, activation, B, S, K, H):
    args = (rn(gen, B, S, K), 1 + rn(gen, K, std=0.1, dtype=torch.float32),
            rn(gen, K, std=0.1, dtype=torch.float32), rn(gen, H, K, std=0.05),
            rn(gen, H, std=0.1), rn(gen, K, H, std=0.05), rn(gen, K, std=0.1), rn(gen, B, S, K))
    before = _cuda.LN_MLP_RESIDUAL_BWD.launches
    got = linear.ln_mlp_residual_bt_bwd(*args, eps=1e-6, activation=activation, weights=weights)
    assert _cuda.LN_MLP_RESIDUAL_BWD.launches == before + 1
    want = linear.ln_mlp_residual_bt_bwd_ref(*args, eps=1e-6, activation=activation,
                                             weights=weights)
    _grad_close(got, want)


@pytest.mark.parametrize("BW,win,heads,d", [(3, 14, 2, 80), (5, 4, 8, 16), (2, 7, 1, 64),
                                            (2, 5, 2, 32)])
def test_flash_qkv_packed_windows_s_bwd_kernel(gen, BW, win, heads, d):
    S = win * win
    qkv = rn(gen, BW, S, 3 * heads * d)
    rel_s = rn(gen, S, BW, heads * 32)
    sel32 = flash_attention.make_rel_scatter32(win, torch.bfloat16, torch.device("cuda"))
    g = rn(gen, BW, heads * d, S)
    args = (qkv, rel_s, sel32, g, d ** -0.5, heads, d)
    before = _cuda.QKV_WINDOWS_BWD.launches
    got = flash_attention.flash_qkv_packed_windows_s_bwd(*args)
    assert _cuda.QKV_WINDOWS_BWD.launches == before + 1
    _grad_close(got, flash_attention.flash_qkv_packed_windows_s_bwd_ref(*args))


@pytest.mark.parametrize("B,H,W,heads,d", [(2, 8, 8, 2, 80), (1, 10, 10, 8, 16),
                                           (1, 6, 10, 2, 64), (1, 9, 7, 1, 128)])
def test_flash_qkv_packed_global_bwd_kernel(gen, B, H, W, heads, d):
    N = H * W
    qkv = rn(gen, B, N, 3 * heads * d)
    rel = rn(gen, N, B, heads, H + W)
    sel = flash_attention.make_rel_scatter(H, W, torch.bfloat16, torch.device("cuda"))
    g = rn(gen, B, heads * d, N)
    args = (qkv, rel, sel, g, d ** -0.5, heads, d, H, W)
    before = _cuda.QKV_GLOBAL_BWD.launches
    got = flash_attention.flash_qkv_packed_global_bwd(*args)
    assert _cuda.QKV_GLOBAL_BWD.launches == before + 1
    _grad_close(got, flash_attention.flash_qkv_packed_global_bwd_ref(*args[:7]))


def test_attention_functions_launch_the_backward_kernels(gen):
    """A gradient through the wrappers runs the backward kernel once and
    equals the plain backward's."""
    heads, d, win, H, W = 2, 32, 5, 6, 10
    cases = [
        (flash_attention.flash_qkv_packed_windows_s,
         flash_attention.flash_qkv_packed_windows_s_bwd_ref, _cuda.QKV_WINDOWS_BWD,
         (rn(gen, 3, win * win, 3 * heads * d), rn(gen, win * win, 3, heads * 32),
          flash_attention.make_rel_scatter32(win, torch.bfloat16, torch.device("cuda"))),
         (d ** -0.5, heads, d), ()),
        (flash_attention.flash_qkv_packed_global,
         flash_attention.flash_qkv_packed_global_bwd_ref, _cuda.QKV_GLOBAL_BWD,
         (rn(gen, 1, H * W, 3 * heads * d), rn(gen, H * W, 1, heads, H + W),
          flash_attention.make_rel_scatter(H, W, torch.bfloat16, torch.device("cuda"))),
         (d ** -0.5, heads, d), (H, W)),
    ]
    for fn, bwd_ref, kernel, (qkv, rel, sel), static, hw in cases:
        qkv.requires_grad_(True)
        rel.requires_grad_(True)
        before = kernel.launches
        out = fn(qkv, rel, sel, *static, *hw)
        g = rn(gen, *out.shape)
        got = torch.autograd.grad(out, (qkv, rel), g)
        assert kernel.launches == before + 1
        _grad_close(got, bwd_ref(qkv.detach(), rel.detach(), sel, g, *static))


# ------------------------------------- split q, k, v attention (#10, #20)


@pytest.mark.parametrize("BB,H,W,d", [(3, 14, 14, 64), (2, 64, 64, 64), (5, 5, 6, 64),
                                      (2, 10, 10, 80), (1, 9, 7, 80)])
def test_flash_attention_relpos_kernel(gen, BB, H, W, d):
    """Windowed (196) and global (4096) token counts at SAM ViT-B's d 64,
    ViT-H's d 80, ragged ones, odd problem counts; q pre-scaled as the
    encoder gives it."""
    N = H * W
    q = rn(gen, BB, N, d, std=d ** -0.5)
    args = (q, rn(gen, BB, N, d), rn(gen, BB, N, d), rn(gen, BB, N, H + W),
            flash_attention.make_rel_scatter(H, W, torch.bfloat16, torch.device("cuda")))
    before = _cuda.ATTN_RELPOS.launches
    got = flash_attention.flash_attention_relpos(*args, H, W)
    assert _cuda.ATTN_RELPOS.launches == before + 1
    assert_close(got, flash_attention.xla_attention_relpos(*args))


@pytest.mark.parametrize("BB,N,dqk,dv", [(2, 4096, 208, 80), (3, 100, 48, 64),
                                         (1, 1024, 192, 64), (2, 77, 256, 80)])
def test_flash_attention_fullk_kernel(gen, BB, N, dqk, dv):
    args = (rn(gen, BB, N, dqk, std=dqk ** -0.5), rn(gen, BB, N, dqk), rn(gen, BB, N, dv))
    before = _cuda.ATTN_FULLK.launches
    got = flash_attention.flash_attention_fullk(*args)
    assert _cuda.ATTN_FULLK.launches == before + 1
    assert_close(got, flash_attention.flash_attention_fullk_ref(*args))


def test_split_attention_gradients_are_the_plain_vjp(gen):
    """#10 and #20 have no backward kernel (nor had the TPU kernels): a
    gradient through them launches the forward kernel once and is the
    autograd gradient of the plain version."""
    H, W, d = 6, 10, 64
    N = H * W
    sel = flash_attention.make_rel_scatter(H, W, torch.bfloat16, torch.device("cuda"))
    cases = [
        (lambda *a: flash_attention.flash_attention_relpos(*a, sel, H, W),
         lambda *a: flash_attention.xla_attention_relpos(*a, sel), _cuda.ATTN_RELPOS,
         (rn(gen, 3, N, d, std=0.2), rn(gen, 3, N, d), rn(gen, 3, N, d), rn(gen, 3, N, H + W))),
        (flash_attention.flash_attention_fullk, flash_attention.flash_attention_fullk_ref,
         _cuda.ATTN_FULLK, (rn(gen, 2, N, 48, std=0.2), rn(gen, 2, N, 48), rn(gen, 2, N, 80))),
    ]
    for fn, ref, kernel, args in cases:
        leaves = [a.clone().requires_grad_(True) for a in args]
        before = kernel.launches
        out = fn(*leaves)
        assert kernel.launches == before + 1
        g = rn(gen, *out.shape)
        got = torch.autograd.grad(out, leaves, g)
        want = torch.autograd.grad(ref(*leaves), leaves, g)
        for a, b in zip(got, want):  # the same plain backward: fp32 summation order only
            assert ((a.float() - b.float()).abs().max() / b.float().abs().max()).item() < 1e-5
