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


@pytest.fixture(params=[128, 256])
def tile_n(request, monkeypatch):
    """Each tile width of the persistent GEMM (csrc/gemm_sm90.cuh) at every
    shape, whatever `linear.gemm_tile_n` would pick there."""
    monkeypatch.setattr(linear, "gemm_tile_n", lambda *_: request.param)
    return request.param


def rn(gen, *shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)


def dmajor(x):
    """x in the layout the attention wrappers hand to proj_rows: the view of
    rows whose stride is rounded up to a multiple of 8."""
    return linear.dmajor_empty(*x.shape, dtype=x.dtype, device=x.device).copy_(x)


def assert_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    d = (got.float() - want.float()).abs()
    ref = want.float().abs()
    assert torch.isfinite(got).all()
    assert (d.max() / ref.max()).item() < BOUND
    assert (d.mean() / ref.mean()).item() < BOUND


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("M,K,N", [(100, 768, 40), (67, 96, 130), (8192, 768, 1280),
                                   (130, 200, 264)])
def test_linear_act_kernel(gen, tile_n, activation, M, K, N):
    """Ragged M and N, K not a multiple of the 64-deep tile (96, 200), and
    the patch embed's shape at batch 2; each tile width."""
    args = (rn(gen, M, K), rn(gen, N, K, std=0.05), rn(gen, N, std=0.1))
    before = _cuda.LINEAR_ACT.launches
    got = linear.linear_act(*args, activation=activation)
    assert _cuda.LINEAR_ACT.launches == before + 1
    assert_close(got, linear.linear_act_ref(*args, activation=activation))


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("B,S,K,N", [(2, 37, 128, 384), (1, 581, 64, 72), (2, 581, 1024, 3072),
                                     (1, 581, 1024, 3072), (2, 1008, 1280, 3840),
                                     (3, 7, 768, 2304), (2, 37, 200, 130), (1, 5, 8, 24)])
def test_ln_linear_act_bt_kernel(gen, tile_n, activation, B, S, K, N):
    """CLIP's qkv at batch 2 and 1, SAM's edge windows (2 x 1008 rows), K =
    768, K not a multiple of the 64-deep tile (200, 8) with a ragged N;
    each tile width."""
    args = (rn(gen, B, S, K) + 0.5, 1 + rn(gen, K, std=0.1, dtype=torch.float32),
            rn(gen, K, std=0.1, dtype=torch.float32), rn(gen, N, K, std=0.05),
            rn(gen, N, std=0.1))
    before = _cuda.LN_LINEAR.launches
    got = linear.ln_linear_act_bt(*args, eps=1e-5, activation=activation)
    assert _cuda.LN_LINEAR.launches == before + 1
    assert_close(got, linear.ln_linear_act_bt_ref(*args, eps=1e-5, activation=activation))


@pytest.mark.parametrize("activation", ["gelu_tanh", "gelu", "quick_gelu"])
@pytest.mark.parametrize("B,S,K,H", [(2, 37, 128, 512), (3, 7, 768, 256), (1, 21, 1280, 640),
                                     (2, 581, 1024, 4096), (2, 1008, 1280, 5120),
                                     (61, 77, 768, 3072), (2, 37, 200, 264), (1, 3, 96, 136)])
def test_ln_mlp_residual_bt_kernel(gen, tile_n, activation, B, S, K, H):
    """CLIP's MLP (fc2: N 1024 from K 4096), SAM's edge windows (2 x 1008
    rows, H 5120), the text tower's (61 x 77, K 768), ragged M, K and H not
    multiples of the tile (200 / 264, 96 / 136); each tile width."""
    args = (rn(gen, B, S, K), 1 + rn(gen, K, std=0.1, dtype=torch.float32),
            rn(gen, K, std=0.1, dtype=torch.float32), rn(gen, H, K, std=0.05),
            rn(gen, H, std=0.1), rn(gen, K, H, std=0.05), rn(gen, K, std=0.1))
    before = _cuda.LN_MLP_RESIDUAL.launches
    got = linear.ln_mlp_residual_bt(*args, eps=1e-6, activation=activation)
    assert _cuda.LN_MLP_RESIDUAL.launches == before + 1
    assert_close(got, linear.ln_mlp_residual_bt_ref(*args, eps=1e-6, activation=activation))


@pytest.mark.parametrize("scratch", [128 * 512, 300 * 512])
def test_ln_mlp_residual_bt_kernel_row_panels(gen, monkeypatch, scratch):
    """A hidden larger than the scratch: the entry point walks M in row
    panels (here 128 or 256 rows of 700; the last one ragged), one count."""
    monkeypatch.setattr(linear, "MLP_SCRATCH_ELEMS", scratch)
    B, S, K, H = 2, 350, 128, 512
    assert linear.mlp_panel_rows(B * S, H) < B * S
    args = (rn(gen, B, S, K), 1 + rn(gen, K, std=0.1, dtype=torch.float32),
            rn(gen, K, std=0.1, dtype=torch.float32), rn(gen, H, K, std=0.05),
            rn(gen, H, std=0.1), rn(gen, K, H, std=0.05), rn(gen, K, std=0.1))
    before = _cuda.LN_MLP_RESIDUAL.launches
    got = linear.ln_mlp_residual_bt(*args, eps=1e-6, activation="gelu_tanh")
    assert _cuda.LN_MLP_RESIDUAL.launches == before + 1
    assert_close(got, linear.ln_mlp_residual_bt_ref(*args, eps=1e-6, activation="gelu_tanh"))


# the fp32 instance against its plain version (cuBLAS in full fp32, TF32
# off): the same function with no rounding point, differing in the order of
# fp32 sums only (~1e-6 relative over K = 3072)
F32_BOUND = 1e-4


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("tile", [128, 64])
@pytest.mark.parametrize("B,S,K,H", [(6, 77, 768, 3072), (3, 50, 200, 264), (1, 7, 96, 136)])
def test_ln_mlp_residual_bt_kernel_float32(gen, monkeypatch, activation, tile, B, S, K, H):
    """The text tower's shape at camoprompts (6 prompts x 77 tokens) and
    ragged ones (M, K and H not multiples of the tiles or the 16-deep k
    step); each tile size; row panels (a scratch of 128 x 512 elements); a
    gradient refused."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(linear, "f32_tile", lambda *_: tile)
    f32 = torch.float32
    args = (rn(gen, B, S, K, dtype=f32), 1 + rn(gen, K, std=0.1, dtype=f32),
            rn(gen, K, std=0.1, dtype=f32), rn(gen, H, K, std=0.05, dtype=f32),
            rn(gen, H, std=0.1, dtype=f32), rn(gen, K, H, std=0.05, dtype=f32),
            rn(gen, K, std=0.1, dtype=f32))
    want = linear.ln_mlp_residual_bt_ref(*args, eps=1e-5, activation=activation)
    for scratch in (linear.MLP_SCRATCH_ELEMS, 128 * 512):
        monkeypatch.setattr(linear, "MLP_SCRATCH_ELEMS", scratch)
        before = (_cuda.LN_MLP_RESIDUAL_F32.launches, _cuda.LN_MLP_RESIDUAL.launches)
        got = linear.ln_mlp_residual_bt(*args, eps=1e-5, activation=activation)
        assert (_cuda.LN_MLP_RESIDUAL_F32.launches, _cuda.LN_MLP_RESIDUAL.launches) == (
            before[0] + 1, before[1])
        assert got.dtype == f32 and torch.isfinite(got).all()
        assert ((got - want).abs().max() / want.abs().max()).item() < F32_BOUND
    x = args[0].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        linear.ln_mlp_residual_bt(x, *args[1:], eps=1e-5, activation=activation)


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("B,T,K,S,N", [(2, 1, 128, 37, 128), (1, 3, 64, 70, 96),
                                       (2, 2, 128, 50, 136),
                                       (1, 2, 1280, 196, 1280),   # SAM windows, 2 of 32 groups
                                       (1, 3, 1280, 112, 1280),   # SAM edge, 3 of 18
                                       (1, 1, 1280, 4096, 1280),  # SAM global, 1 of 2
                                       (2, 1, 1024, 581, 1024)])  # CLIP at batch 2
def test_proj_rows_kernel(gen, tile_n, with_res, B, T, K, S, N):
    """The persistent GEMM with an MN-major A at the main path's shapes
    (fewer groups) and ragged ones (S under one 64-row box, N not a multiple
    of the tile), x as the attention wrappers give it (padded row stride);
    each tile width."""
    res = rn(gen, B, T, S, N) if with_res else None
    args = (dmajor(rn(gen, B, T, K, S)), rn(gen, N, K, std=0.05), rn(gen, N, std=0.1), res)
    before = _cuda.PROJ_ROWS.launches
    got = linear.proj_rows(*args)
    assert _cuda.PROJ_ROWS.launches == before + 1
    assert_close(got, linear.proj_rows_ref(*args))


@pytest.mark.parametrize("B,S,heads,d", [(2, 37, 8, 16), (1, 581, 2, 64), (2, 7, 4, 32),
                                         (1, 100, 2, 80), (1, 65, 1, 128), (2, 581, 16, 64),
                                         (1, 1200, 2, 64), (3, 64, 2, 16), (1, 1200, 1, 80),
                                         (2, 129, 2, 128)])
def test_flash_qkv_packed_plain_kernel(gen, B, S, heads, d):
    """CLIP's full shape (2, 581, 16 heads, d 64); sequences shorter than
    a 64-key tile (7), exactly one (64), ragged (37, 65, 129) and long
    (1200, more keys than the ring has stages); d 16 to 128."""
    qkv = rn(gen, B, S, 3 * heads * d)
    before = _cuda.QKV_PACKED_PLAIN.launches
    got = flash_attention.flash_qkv_packed_plain(qkv, d ** -0.5, heads, d)
    assert _cuda.QKV_PACKED_PLAIN.launches == before + 1 and got.stride(-2) % 8 == 0
    assert_close(got, flash_attention.flash_qkv_packed_plain_ref(qkv, d ** -0.5, heads, d))


@pytest.mark.parametrize("Bp,S,K,N,nwin", [(4, 37, 128, 384, 2), (1, 100, 64, 72, 1),
                                          (2, 196, 1280, 3840, 1), (32, 196, 1280, 3840, 16),
                                          (6, 50, 200, 96, 3)])
def test_ln_mask_linear_bt_kernel(gen, tile_n, Bp, S, K, N, nwin):
    """SAM's width, one window and 16 (the padded carry's layout: row b'
    reads mask[b' % nwin]), K not a multiple of the 64-deep tile (200);
    each tile width."""
    mask = (torch.rand(nwin, S, 1, generator=gen, device="cuda") > 0.3).to(torch.bfloat16)
    args = (rn(gen, Bp, S, K) + 0.5, 1 + rn(gen, K, std=0.1, dtype=torch.float32),
            rn(gen, K, std=0.1, dtype=torch.float32), mask, rn(gen, N, K, std=0.05),
            rn(gen, N, std=0.1))
    before = _cuda.LN_MASK_LINEAR.launches
    got = linear.ln_mask_linear_bt(*args, eps=1e-6)
    assert _cuda.LN_MASK_LINEAR.launches == before + 1
    assert_close(got, linear.ln_mask_linear_bt_ref(*args, eps=1e-6))


@pytest.mark.parametrize("BW,win,heads,d", [(3, 14, 2, 80), (5, 4, 8, 16), (2, 7, 1, 64),
                                            (2, 5, 2, 32), (32, 14, 16, 80), (2, 16, 2, 128),
                                            (3, 16, 1, 80), (2, 8, 2, 80), (2, 9, 2, 128),
                                            (1, 11, 3, 16)])
def test_flash_qkv_packed_windows_s_kernel(gen, BW, win, heads, d):
    """ViT-H's shape (32 windows of 14, 16 heads, d 80); win 16, the 256-key
    edge (and its register peak at d 128); the key paddings 64 (win 4, 5,
    7, and 8 exactly), 208 (win 9, 11, 14) and 256."""
    S = win * win
    qkv = rn(gen, BW, S, 3 * heads * d)
    rel_s = rn(gen, S, BW, heads * 32)
    sel32 = flash_attention.make_rel_scatter32(win, torch.bfloat16, torch.device("cuda"))
    args = (qkv, rel_s, sel32, d ** -0.5, heads, d)
    before = _cuda.QKV_WINDOWS.launches
    got = flash_attention.flash_qkv_packed_windows_s(*args)
    assert _cuda.QKV_WINDOWS.launches == before + 1 and got.stride(-2) % 8 == 0
    assert_close(got, flash_attention.flash_qkv_packed_windows_s_ref(*args))


@pytest.mark.parametrize("H,W,win,heads,d", [(64, 64, 14, 2, 80), (10, 10, 4, 8, 16),
                                             (5, 5, 2, 1, 32), (9, 12, 5, 2, 64),
                                             (20, 20, 14, 2, 80), (26, 26, 14, 1, 128)])
def test_flash_qkv_packed_edge_kernel(gen, H, W, win, heads, d):
    """Right, bottom and corner windows (the corner ragged, with dummy rows
    whose pad-key logit is -1e30, as the encoder gives them); R = 112 (ViT-H:
    the 112-key product, no key padding), 84 (keys padded to 112), 168 (to
    208) and R <= 64; sel's pad-key lane empty in every geometry."""
    geom = CompactGeometry(H, W, win)
    B, n, R = 2, geom.n_edge, geom.R_u
    qkv = rn(gen, B, n, R, 3 * heads * d)
    rel = rn(gen, B, n, R, heads, 32)
    for g_start, g in zip(np.cumsum([0] + [g.n for g in geom.edge_groups]), geom.edge_groups):
        rel[:, g_start : g_start + g.n, g.rows :, :, LPAD_LANE] = NEG
    rel = rel.reshape(B, n, R, heads * 32)
    sel, kmask = edge_consts(geom, torch.bfloat16, torch.device("cuda"))
    assert not sel[:, LPAD_LANE].any()  # the pad-key logit's lane adds to no score
    vb = rn(gen, heads, d, std=0.5)
    args = (qkv, rel, sel, vb, kmask, d ** -0.5, heads, d)
    before = _cuda.QKV_EDGE.launches
    got = flash_attention.flash_qkv_packed_edge(*args)
    assert _cuda.QKV_EDGE.launches == before + 1 and got.stride(-2) % 8 == 0
    assert_close(got, flash_attention.flash_qkv_packed_edge_ref(*args))


@pytest.mark.parametrize("B,H,W,heads,d", [(2, 8, 8, 2, 80), (1, 10, 10, 8, 16),
                                           (1, 6, 10, 2, 64), (1, 64, 64, 1, 80),
                                           (2, 64, 64, 2, 80), (1, 7, 9, 2, 32),
                                           (1, 5, 20, 1, 80), (1, 8, 64, 2, 16),
                                           (1, 9, 64, 1, 128), (1, 16, 16, 2, 128),
                                           (1, 2, 128, 1, 64)])
def test_flash_qkv_packed_global_kernel(gen, B, H, W, heads, d):
    """ViT-H's 64 x 64 grid (W equal to the 64-key tile: the bias in
    registers) at d = 80, 16 and 128; W not a multiple of the tile and
    ragged N (63, 100 keys); W a multiple of the tile but not equal (128)."""
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
    # K % 8 != 0: TMA row strides are multiples of 16 bytes
    xr = rn(gen, 1, 5, 100)
    g100, b100 = torch.ones(100, device="cuda"), torch.zeros(100, device="cuda")
    with pytest.raises(ValueError, match="K % 8"):
        linear.ln_mlp_residual_bt(xr, g100, b100, rn(gen, 256, 100), b1, rn(gen, 100, 256),
                                  rn(gen, 100))
    with pytest.raises(ValueError, match="K % 8"):  # the hidden's rows too
        linear.ln_mlp_residual_bt(x, g32, b32, rn(gen, 100, 128), rn(gen, 100),
                                  rn(gen, 128, 100), b2)
    with pytest.raises(ValueError, match="K % 8"):
        linear.ln_linear_act_bt(xr, g100, b100, rn(gen, 8, 100), rn(gen, 8))
    with pytest.raises(ValueError, match="K % 8"):
        linear.ln_mask_linear_bt(xr, g100, b100, torch.ones(1, 5, 1, dtype=torch.bfloat16,
                                                            device="cuda"),
                                 rn(gen, 8, 100), rn(gen, 8))
    with pytest.raises(TypeError, match="float32"):  # LN scale and shift are fp32
        linear.ln_linear_act_bt(x, g32.to(torch.bfloat16), b32, rn(gen, 8, 128), rn(gen, 8))
    with pytest.raises(ValueError, match="contiguous"):
        linear.linear_act(x[0].t(), rn(gen, 8, 5), rn(gen, 8))
    with pytest.raises(ValueError, match="K % 8"):  # TMA strides: 16-byte multiples
        linear.linear_act(rn(gen, 4, 100), rn(gen, 8, 100), rn(gen, 8))
    # proj_rows reads x by TMA: a row stride that is not a multiple of 8
    # elements, or an x whose s is not contiguous, is refused, not copied
    with pytest.raises(ValueError, match="multiples of 8"):
        linear.proj_rows(rn(gen, 1, 1, 64, 37), rn(gen, 64, 64), rn(gen, 64))
    with pytest.raises(ValueError, match="last stride 1"):
        linear.proj_rows(rn(gen, 1, 1, 40, 64).transpose(-1, -2), rn(gen, 64, 64), rn(gen, 64))
    # #10 takes d == dv in (64, 80); #8's residual epilogue N % 8 == 0
    sel = flash_attention.make_rel_scatter(5, 6, torch.bfloat16, torch.device("cuda"))
    with pytest.raises(ValueError, match="d == dv"):
        flash_attention.flash_attention_relpos(rn(gen, 2, 30, 48), rn(gen, 2, 30, 48),
                                               rn(gen, 2, 30, 64), rn(gen, 2, 30, 11), sel, 5, 6)
    with pytest.raises(ValueError, match="N % 8"):
        linear.proj_from_heads_res(rn(gen, 1, 2, 5, 70, 64), rn(gen, 130, 128), rn(gen, 130),
                                   rn(gen, 1, 5, 70, 130))
    with pytest.raises(ValueError, match="unsupported devices"):  # mixed devices
        linear.linear_act(x[0], rn(gen, 8, 128).cpu(), rn(gen, 8))
    with pytest.raises(ValueError, match="takes d in"):  # no attention kernel for d = 48
        flash_attention.flash_qkv_packed_plain(rn(gen, 1, 5, 3 * 48), 0.1, 1, 48)
    # the global attention holds 128 queries' rel rows in shared memory:
    # H + W = 397 is beyond it at d = 128
    H, W = 1, 396
    sel = flash_attention.make_rel_scatter(H, W, torch.bfloat16, torch.device("cuda"))
    with pytest.raises(RuntimeError, match="cvlm_qkv_packed_global"):
        flash_attention.flash_qkv_packed_global(rn(gen, 1, H * W, 3 * 128),
                                                rn(gen, H * W, 1, 1, H + W), sel,
                                                128 ** -0.5, 1, 128, H, W)
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
    # the backward kernel takes any K % 8 == 0 (K = 96 is not a multiple of
    # 128) and matches its plain version; K % 8 != 0 it refuses as the forward
    a96 = (x[..., :96].contiguous(), g32[:96], b32[:96], w1[:, :96].contiguous(), b1,
           w2[:96].contiguous(), b2[:96], rn(gen, 1, 5, 96))
    _grad_close(linear.ln_mlp_residual_bt_bwd(*a96, weights=True),
                linear.ln_mlp_residual_bt_bwd_ref(*a96, weights=True))
    with pytest.raises(ValueError, match="K % 8"):
        linear.ln_mlp_residual_bt_bwd(xr, g100, b100, rn(gen, 256, 100), b1, rn(gen, 100, 256),
                                      rn(gen, 100), rn(gen, 1, 5, 100))


# ------------------------------------------------ the backward kernels


def _grad_close(got, want):
    for gt, wt in zip(got, want):
        if wt is None:
            assert gt is None
        else:
            assert_close(gt, wt)


def _mlp_bwd_args(gen, B, S, K, H):
    return (rn(gen, B, S, K), 1 + rn(gen, K, std=0.1, dtype=torch.float32),
            rn(gen, K, std=0.1, dtype=torch.float32), rn(gen, H, K, std=0.05),
            rn(gen, H, std=0.1), rn(gen, K, H, std=0.05), rn(gen, K, std=0.1), rn(gen, B, S, K))


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("activation", ["gelu_tanh", "gelu", "quick_gelu"])
@pytest.mark.parametrize("B,S,K,H", [(2, 37, 128, 512), (3, 7, 768, 256), (1, 21, 1280, 640),
                                     (2, 37, 96, 136), (1, 21, 200, 264), (2, 581, 1024, 4096)])
def test_ln_mlp_residual_bt_bwd_kernel(gen, weights, activation, B, S, K, H):
    """Ragged M; K and H not multiples of 128 (96 / 136, 200 / 264); CLIP's
    vision MLP (2 x 581 rows, K 1024, H 4096), which MaPLe trains."""
    args = _mlp_bwd_args(gen, B, S, K, H)
    before = _cuda.LN_MLP_RESIDUAL_BWD.launches
    got = linear.ln_mlp_residual_bt_bwd(*args, eps=1e-6, activation=activation, weights=weights)
    assert _cuda.LN_MLP_RESIDUAL_BWD.launches == before + 1
    want = linear.ln_mlp_residual_bt_bwd_ref(*args, eps=1e-6, activation=activation,
                                             weights=weights)
    _grad_close(got, want)


@pytest.mark.parametrize("weights", [False, True])
def test_ln_mlp_residual_bt_bwd_kernel_row_panels(gen, monkeypatch, weights):
    """A hidden larger than the scratch: the backward walks M in row panels
    (256 rows of 700, the last one ragged), one count; with the weights its
    partial sums run on across the panels."""
    monkeypatch.setattr(linear, "MLP_SCRATCH_ELEMS", 300 * 512)
    B, S, K, H = 2, 350, 128, 512
    assert linear.mlp_panel_rows(B * S, H) == 256
    args = _mlp_bwd_args(gen, B, S, K, H)
    before = _cuda.LN_MLP_RESIDUAL_BWD.launches
    got = linear.ln_mlp_residual_bt_bwd(*args, eps=1e-6, activation="gelu_tanh", weights=weights)
    assert _cuda.LN_MLP_RESIDUAL_BWD.launches == before + 1
    _grad_close(got, linear.ln_mlp_residual_bt_bwd_ref(*args, eps=1e-6, activation="gelu_tanh",
                                                       weights=weights))


def test_ln_mlp_residual_bt_bwd_kernel_is_deterministic(gen):
    """No atomics: two runs of the backward (SAM's edge windows, with the
    weight side) are bit-equal."""
    args = _mlp_bwd_args(gen, 2, 1008, 1280, 5120)
    a = linear.ln_mlp_residual_bt_bwd(*args, weights=True)
    b = linear.ln_mlp_residual_bt_bwd(*args, weights=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


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


def _windows_bwd_args(gen, BW, win, heads, d):
    S = win * win
    return (rn(gen, BW, S, 3 * heads * d), rn(gen, S, BW, heads * 32),
            flash_attention.make_rel_scatter32(win, torch.bfloat16, torch.device("cuda")),
            rn(gen, BW, heads * d, S, std=0.05), d ** -0.5, heads, d)


def _global_bwd_args(gen, B, H, W, heads, d):
    N = H * W
    return (rn(gen, B, N, 3 * heads * d), rn(gen, N, B, heads, H + W),
            flash_attention.make_rel_scatter(H, W, torch.bfloat16, torch.device("cuda")),
            rn(gen, B, heads * d, N, std=0.05), d ** -0.5, heads, d, H, W)


def test_attention_bwd_kernels_at_vit_h_width(gen):
    """ViT-H's full width at a reduced batch: the interior windows of one
    image (16 windows of 196 keys) and one image's global block (the 64 x 64
    grid, the register path), 16 heads x 80."""
    args = _windows_bwd_args(gen, 16, 14, 16, 80)
    _grad_close(flash_attention.flash_qkv_packed_windows_s_bwd(*args),
                flash_attention.flash_qkv_packed_windows_s_bwd_ref(*args))
    args = _global_bwd_args(gen, 1, 64, 64, 16, 80)
    assert _cuda.attn_bwd_smem(80, 64, 64, 128, 128)["path"] == "register"
    _grad_close(flash_attention.flash_qkv_packed_global_bwd(*args),
                flash_attention.flash_qkv_packed_global_bwd_ref(*args[:7]))


def test_attention_bwd_kernels_are_deterministic(gen):
    """No atomics: two calls on the same inputs give bit-equal dqkv and drel."""
    for fn, args in ((flash_attention.flash_qkv_packed_windows_s_bwd,
                      _windows_bwd_args(gen, 8, 14, 4, 80)),
                     (flash_attention.flash_qkv_packed_global_bwd,
                      _global_bwd_args(gen, 2, 8, 64, 4, 80))):
        first = fn(*args)
        second = fn(*args)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.parametrize("H,W,heads,d,path", [
    (4, 64, 2, 80, "register"), (3, 64, 3, 64, "register"), (2, 64, 1, 128, "register"),
    (4, 60, 2, 80, "general"), (3, 63, 3, 64, "general"), (2, 62, 1, 128, "general")])
def test_flash_qkv_packed_global_bwd_paths(gen, H, W, heads, d, path):
    """Both paths the C entry picks at 128 lanes: on an H x 64 grid the
    register path (bias in registers, drel as row sums and the dS tiles
    themselves), on other widths the general path (bias and drel through
    the key code on the tensor cores)."""
    assert _cuda.attn_bwd_smem(d, H, W, H + W, 128)["path"] == path
    args = _global_bwd_args(gen, 2, H, W, heads, d)
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


@pytest.mark.parametrize("BB,H,W,d,mode", [(3, 14, 14, 64, "tensor_core"),
                                           (2, 64, 64, 64, "register"),
                                           (5, 5, 6, 64, "tensor_core"),
                                           (2, 10, 10, 80, "tensor_core"),
                                           (1, 9, 7, 80, "tensor_core")])
def test_flash_attention_relpos_kernel(gen, BB, H, W, d, mode):
    """Windowed (196) and global (4096) token counts at SAM ViT-B's d 64,
    ViT-H's d 80, ragged ones, odd problem counts; q pre-scaled as the
    encoder gives it. The library runs the 64 x 64 grid streaming with rel_w
    in registers, and the windows resident with the bias on the tensor cores
    in one block of shared memory."""
    plan = _cuda.attn_relpos_smem(H, W, d)
    assert plan["mode"] == mode and plan["resident"] == (mode == "tensor_core")
    assert plan["smem"] <= 227 * 1024
    N = H * W
    q = rn(gen, BB, N, d, std=d ** -0.5)
    args = (q, rn(gen, BB, N, d), rn(gen, BB, N, d), rn(gen, BB, N, H + W),
            flash_attention.make_rel_scatter(H, W, torch.bfloat16, torch.device("cuda")))
    before = _cuda.ATTN_RELPOS.launches
    got = flash_attention.flash_attention_relpos(*args, H, W)
    assert _cuda.ATTN_RELPOS.launches == before + 1
    assert_close(got, flash_attention.xla_attention_relpos(*args))


@pytest.mark.parametrize("BB,N,dqk,dv", [(2, 4096, 208, 80), (3, 100, 48, 64),
                                         (1, 1024, 192, 64), (2, 77, 256, 80),
                                         (2, 130, 144, 80), (1, 64, 16, 64)])
def test_flash_attention_fullk_kernel(gen, BB, N, dqk, dv):
    args = (rn(gen, BB, N, dqk, std=dqk ** -0.5), rn(gen, BB, N, dqk), rn(gen, BB, N, dv))
    before = _cuda.ATTN_FULLK.launches
    got = flash_attention.flash_attention_fullk(*args)
    assert _cuda.ATTN_FULLK.launches == before + 1
    assert_close(got, flash_attention.flash_attention_fullk_ref(*args))
    # the depth the library runs dqk at, and a ring that fits one block
    plan = _cuda.attn_fullk_smem(dqk, dv)
    assert dqk <= plan["depth"] <= 256 and plan["stages"] >= 2 and plan["smem"] <= 227 * 1024


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


def test_relpos_and_proj_from_heads_kernels_are_deterministic(gen):
    """No atomics: two calls of #10 (the windows' and the grid's
    arrangements) and of #8 on the same inputs are bit-equal."""
    for H, W in ((14, 14), (8, 64)):
        N = H * W
        args = (rn(gen, 6, N, 64, std=0.125), rn(gen, 6, N, 64), rn(gen, 6, N, 64),
                rn(gen, 6, N, H + W),
                flash_attention.make_rel_scatter(H, W, torch.bfloat16, torch.device("cuda")))
        assert torch.equal(flash_attention.flash_attention_relpos(*args, H, W),
                           flash_attention.flash_attention_relpos(*args, H, W))
    args = (rn(gen, 2, 4, 3, 37, 80), rn(gen, 96, 320, std=0.05), rn(gen, 96),
            rn(gen, 2, 3, 37, 96))
    assert torch.equal(linear.proj_from_heads_res(*args), linear.proj_from_heads_res(*args))


# ----------- the padded carry and the head-leading attention (#12, #11, #19, #8, #9)


@pytest.mark.parametrize("B,nwin,win,heads,d", [(2, 16, 16, 2, 80), (1, 25, 15, 2, 80),
                                                (2, 3, 4, 8, 16), (1, 1, 16, 1, 64),
                                                (2, 4, 15, 16, 80)])
def test_flash_qkv_packed_windows_kernel(gen, B, nwin, win, heads, d):
    """#12: window-major rel; windows of 16 (ViT-H), 15 (225 keys under the
    256-wide product: ragged tiles, and rows of the padded stride 232; also
    at ViT-H's 16 heads), 4, and one window of a 16 x 16 global block."""
    Nw = win * win
    sel32 = flash_attention.make_rel_scatter32(win, torch.bfloat16, torch.device("cuda"))
    args = (rn(gen, B, nwin, Nw, 3 * heads * d), rn(gen, B, nwin, Nw, heads * 32), sel32,
            d ** -0.5, heads, d)
    before = _cuda.QKV_WINDOWS_PADDED.launches
    got = flash_attention.flash_qkv_packed_windows(*args)
    assert _cuda.QKV_WINDOWS_PADDED.launches == before + 1
    assert got.stride(-2) == -(-Nw // 8) * 8  # proj_rows' padded d-major rows
    assert_close(got, flash_attention.flash_qkv_packed_windows_ref(*args))


@pytest.mark.parametrize("B,nwin,H,W,heads,d", [(2, 4, 17, 17, 2, 80), (1, 3, 5, 6, 3, 64),
                                                (1, 1, 20, 20, 2, 80), (1, 2, 18, 18, 16, 80),
                                                (2, 1, 22, 22, 2, 64), (1, 1, 24, 40, 2, 80)])
def test_flash_qkv_relpos_windows_kernel(gen, B, nwin, H, W, heads, d):
    """#11 on each of its kernel's arrangements: k and v resident with the
    bias on the tensor cores at windows of 17 (289 keys, H+W 34) and 18
    (324 keys, at ViT-H's 16 heads), on a ragged non-square window and on
    a 22 x 22 global block at d = 64 (484 tokens, H+W 44); resident with
    the gathered code table on a 20 x 20 global block (400 tokens, H+W 40),
    whose tensor-core table does not fit beside k and v at d = 80; and
    streaming with the gathered table on a 24 x 40 grid (960 keys, H+W
    64); the last key tile ragged in each."""
    N = H * W
    qkv, rel = rn(gen, B, nwin, N, 3 * heads, d), rn(gen, B, nwin, N, heads, H + W)
    sel = flash_attention.make_rel_scatter(H, W, torch.bfloat16, torch.device("cuda"))
    before = _cuda.QKV_RELPOS_WINDOWS.launches
    got = flash_attention.flash_qkv_relpos_windows(qkv, rel, sel, d ** -0.5, H, W)
    assert _cuda.QKV_RELPOS_WINDOWS.launches == before + 1
    assert_close(got, flash_attention.flash_qkv_relpos_windows_ref(qkv, rel, sel, d ** -0.5))


@pytest.mark.parametrize("B,H,W,heads,d", [(2, 64, 64, 1, 80), (1, 6, 10, 3, 64),
                                         (2, 64, 64, 16, 80), (1, 3, 64, 2, 64),
                                         (1, 4, 70, 2, 64)])
def test_flash_qkv_relpos_global_kernel(gen, B, H, W, heads, d):
    """#19: the 64 x 64 grid (W equal to the key tile: streaming, rel_w in
    registers), also at ViT-H's 16 heads, and a 3 x 64 one on the same path
    whose last block's second warpgroup has no query; the ragged 6 x 10
    grid, resident with the bias on the tensor cores, its second and third
    warpgroups idle; a 4 x 70 grid (H+W 74 > 64, 280 keys), resident with
    the gathered code table."""
    N = H * W
    qkv, rel = rn(gen, B, N, 3 * heads, d), rn(gen, B, N, heads, H + W)
    sel = flash_attention.make_rel_scatter(H, W, torch.bfloat16, torch.device("cuda"))
    before = _cuda.QKV_RELPOS_GLOBAL.launches
    got = flash_attention.flash_qkv_relpos_global(qkv, rel, sel, d ** -0.5, H, W)
    assert _cuda.QKV_RELPOS_GLOBAL.launches == before + 1
    assert_close(got, flash_attention.flash_qkv_relpos_global_ref(qkv, rel, sel, d ** -0.5))


@pytest.mark.parametrize("with_res,B,heads,T,S,d,N", [
    (False, 2, 4, 3, 37, 80, 96), (True, 2, 4, 3, 37, 80, 96), (False, 1, 2, 5, 70, 64, 130),
    (True, 1, 2, 5, 70, 64, 136), (True, 2, 16, 16, 289, 80, 1280), (False, 2, 3, 2, 50, 8, 40),
    (True, 1, 5, 1, 9, 8, 64), (False, 1, 3, 2, 40, 96, 64), (True, 1, 3, 1, 33, 48, 72)])
def test_proj_from_heads_kernel(gen, with_res, B, heads, T, S, d, N):
    """#8 (with the residual) and #9 (without), each with its own count: the
    window-17 shape of the main path (2, 16, 16, 289, 80) -> 1280; d = 80
    (a 64-column step a head, then the heads' last 16 columns as k16
    slices, four a step: 4 heads fill one), 64 (no slices), 8 (one slice a
    head, half TMA's zero fill; 3 and 5 heads leave the last step part
    zeros), 96 (two slices a head) and 48 (three, so steps straddle heads);
    N ragged against both tile widths. #8's residual epilogue takes N % 8 ==
    0 (136, not #9's 130)."""
    x, w, b = rn(gen, B, heads, T, S, d), rn(gen, N, heads * d, std=0.05), rn(gen, N, std=0.1)
    kernel = _cuda.PROJ_HEADS_RES if with_res else _cuda.PROJ_HEADS
    before = kernel.launches
    if with_res:
        res = rn(gen, B, T, S, N)
        got = linear.proj_from_heads_res(x, w, b, res)
    else:
        res = None
        got = linear.proj_from_heads(x, w, b)
    assert kernel.launches == before + 1
    assert_close(got, linear.proj_from_heads_ref(x, w, b, res))


def test_padded_carry_gradients_are_the_plain_vjp(gen):
    """#12, #11 and #8 have no backward kernel (nor had the TPU kernels): a
    gradient launches the forward kernel once and is autograd's gradient of
    the plain version."""
    heads, d, win, H = 2, 64, 4, 17
    dev = torch.device("cuda")
    sel32 = flash_attention.make_rel_scatter32(win, torch.bfloat16, dev)
    sel = flash_attention.make_rel_scatter(H, H, torch.bfloat16, dev)
    cases = [
        (lambda q, r: flash_attention.flash_qkv_packed_windows(q, r, sel32, 0.125, heads, d),
         lambda q, r: flash_attention.flash_qkv_packed_windows_ref(q, r, sel32, 0.125, heads, d),
         _cuda.QKV_WINDOWS_PADDED,
         (rn(gen, 2, 3, win * win, 3 * heads * d), rn(gen, 2, 3, win * win, heads * 32))),
        (lambda q, r: flash_attention.flash_qkv_relpos_windows(q, r, sel, 0.125, H, H),
         lambda q, r: flash_attention.flash_qkv_relpos_windows_ref(q, r, sel, 0.125),
         _cuda.QKV_RELPOS_WINDOWS,
         (rn(gen, 1, 2, H * H, 3 * heads, d), rn(gen, 1, 2, H * H, heads, 2 * H))),
        (linear.proj_from_heads_res, linear.proj_from_heads_ref, _cuda.PROJ_HEADS_RES,
         (rn(gen, 1, heads, 2, 37, d), rn(gen, 96, heads * d, std=0.05), rn(gen, 96),
          rn(gen, 1, 2, 37, 96))),
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
