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
@pytest.mark.parametrize("tile", linear.F32_TILES)
@pytest.mark.parametrize("B,S,K,H", [(6, 77, 768, 3072), (3, 50, 200, 264), (1, 7, 96, 136)])
def test_ln_mlp_residual_bt_kernel_float32(gen, monkeypatch, activation, tile, B, S, K, H):
    """The text tower's shape at camoprompts (6 prompts x 77 tokens) and
    ragged ones (M, K and H not multiples of the tiles or the 32-deep k
    step); each tile of the plan; row panels (a scratch of 128 x 512 elements); a
    gradient refused."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(linear, "F32_TILE_FORCE", tile)
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
    # a gradient goes through the fp32 instance of #6 (one launch each way)
    x = args[0].clone().requires_grad_(True)
    before = (_cuda.LN_MLP_RESIDUAL_F32.launches, _cuda.LN_MLP_RESIDUAL_BWD_F32.launches)
    y = linear.ln_mlp_residual_bt(x, *args[1:], eps=1e-5, activation=activation)
    gy = rn(gen, *y.shape, dtype=f32)
    (gx,) = torch.autograd.grad(y, x, gy)
    assert (_cuda.LN_MLP_RESIDUAL_F32.launches, _cuda.LN_MLP_RESIDUAL_BWD_F32.launches) == (
        before[0] + 1, before[1] + 1)
    want_dx = linear.ln_mlp_residual_bt_bwd_ref(*args, gy, eps=1e-5, activation=activation,
                                                weights=False)[0]
    assert ((gx - want_dx).abs().max() / want_dx.abs().max()).item() < F32_BOUND


def assert_close_f32(got, want):
    """fp32 kernel against its plain fp32 version (TF32 off): the same
    function with no rounding point, apart in fp32 summation order."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    assert torch.isfinite(got).all()
    d = (got - want).abs()
    assert (d.max() / want.abs().max()).item() < F32_BOUND
    assert (d.mean() / want.abs().mean()).item() < F32_BOUND


@pytest.fixture
def no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.mark.parametrize("tile", linear.F32_TILES)
@pytest.mark.parametrize("activation", [None, "quick_gelu"])
@pytest.mark.parametrize("B,S,K,N", [(8, 581, 1024, 3072), (2, 37, 200, 264), (1, 7, 96, 12)])
def test_ln_linear_act_bt_kernel_float32(gen, monkeypatch, no_tf32, tile, activation, B, S, K, N):
    """#2's fp32 instance at MaPLe's vision shape (batch 8, 581 tokens, K
    1024, N 3072) and ragged ones; each tile."""
    monkeypatch.setattr(linear, "F32_TILE_FORCE", tile)
    f32 = torch.float32
    args = (rn(gen, B, S, K, dtype=f32) + 0.5, 1 + rn(gen, K, std=0.1, dtype=f32),
            rn(gen, K, std=0.1, dtype=f32), rn(gen, N, K, std=0.05, dtype=f32),
            rn(gen, N, std=0.1, dtype=f32))
    before = (_cuda.LN_LINEAR_F32.launches, _cuda.LN_LINEAR.launches)
    got = linear.ln_linear_act_bt(*args, eps=1e-5, activation=activation)
    assert (_cuda.LN_LINEAR_F32.launches, _cuda.LN_LINEAR.launches) == (before[0] + 1, before[1])
    assert_close_f32(got, linear.ln_linear_act_bt_ref(*args, eps=1e-5, activation=activation))


def _ln_fed_f32_calls(gen, rows):
    """#2, #3 (two sequences of `rows` rows, a 0/1 row mask of two windows)
    and #4/#5 in fp32 at `rows` rows, K 200 (not a multiple of the 32-deep
    k tile), N and H 264: (name, CudaKernel, call, plain call)."""
    f32 = torch.float32

    def r(*shape, std=1.0):
        return rn(gen, *shape, std=std, dtype=f32)

    K, N = 200, 264
    x, x3 = r(1, rows, K) + 0.5, r(2, rows, K)
    g, be = 1 + r(K, std=0.1), r(K, std=0.1)
    w, b, w2, b2 = r(N, K, std=0.05), r(N, std=0.1), r(K, N, std=0.05), r(K, std=0.1)
    mask = (torch.rand(2, rows, 1, generator=gen, device="cuda") > 0.3).to(f32)
    lin = linear
    return [
        ("#2", _cuda.LN_LINEAR_F32,
         lambda: lin.ln_linear_act_bt(x, g, be, w, b, eps=1e-5, activation="quick_gelu"),
         lambda: lin.ln_linear_act_bt_ref(x, g, be, w, b, eps=1e-5, activation="quick_gelu")),
        ("#3", _cuda.LN_MASK_LINEAR_F32,
         lambda: lin.ln_mask_linear_bt(x3, g, be, mask, w, b, eps=1e-6),
         lambda: lin.ln_mask_linear_bt_ref(x3, g, be, mask, w, b, eps=1e-6)),
        ("#4/#5", _cuda.LN_MLP_RESIDUAL_F32,
         lambda: lin.ln_mlp_residual_bt(x, g, be, w, b, w2, b2, eps=1e-5, activation="gelu_tanh"),
         lambda: lin.ln_mlp_residual_bt_ref(x, g, be, w, b, w2, b2, eps=1e-5,
                                            activation="gelu_tanh")),
    ]


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("tile", range(len(linear.F32_TILES) + len(linear.F32_MN_TILES)))
@pytest.mark.parametrize("rows", [127, 128, 129, 581])
def test_ln_fed_f32_users_on_each_path(gen, monkeypatch, no_tf32, splits, tile, rows):
    """#2, #3 and #4/#5 in fp32 at each tile number on the path that takes
    it (`linear.F32_PATH_RATE`: path 0 on F32_TILES, the MN path 1 on its
    own), K whole (splits 1) and cut in 2 slices (the MN path's transposed
    hidden through the second pass): within 1e-4 of plain (max and mean
    relative, TF32 off), one launch of the fp32 instance a call, two calls
    bit-equal, and bit-equal to path 0 at 64 x 128 with the same slices
    (each output one sum over k in order, whatever the path and tile);
    #4/#5 also in row panels of 128 rows, the last one ragged."""
    monkeypatch.setattr(linear, "F32_SPLIT_FORCE", splits)
    (path,) = [p for p in linear.F32_PATHS if (p, tile) in linear.F32_PATH_RATE]
    for name, kernel, call, plain in _ln_fed_f32_calls(gen, rows):
        want = plain()
        for scratch in ((linear.MLP_SCRATCH_ELEMS, 128 * 264) if name == "#4/#5"
                        else (linear.MLP_SCRATCH_ELEMS,)):
            monkeypatch.setattr(linear, "MLP_SCRATCH_ELEMS", scratch)
            monkeypatch.setattr(linear, "F32_TILE_FORCE", 1)
            monkeypatch.setattr(linear, "F32_PATH_FORCE", 0)
            ref = call()
            monkeypatch.setattr(linear, "F32_TILE_FORCE", tile)
            monkeypatch.setattr(linear, "F32_PATH_FORCE", path)
            before = kernel.launches
            got = call()
            assert kernel.launches == before + 1, name
            assert_close_f32(got, want)
            assert torch.equal(got, call()) and torch.equal(got, ref), name


@pytest.mark.parametrize("tile", linear.F32_TILES)
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("B,T,K,S,N", [(8, 1, 1024, 581, 1024), (1, 3, 64, 70, 96),
                                       (2, 2, 200, 37, 136)])
def test_proj_rows_kernel_float32(gen, monkeypatch, no_tf32, tile, with_res, B, T, K, S, N):
    """#7's fp32 instance at MaPLe's vision shape and ragged ones, x as the
    fp32 attention gives it (rows of a stride rounded up to 8)."""
    monkeypatch.setattr(linear, "F32_TILE_FORCE", tile)
    f32 = torch.float32
    res = rn(gen, B, T, S, N, dtype=f32) if with_res else None
    args = (dmajor(rn(gen, B, T, K, S, dtype=f32)), rn(gen, N, K, std=0.05, dtype=f32),
            rn(gen, N, std=0.1, dtype=f32), res)
    before = (_cuda.PROJ_ROWS_F32.launches, _cuda.PROJ_ROWS.launches)
    got = linear.proj_rows(*args)
    assert (_cuda.PROJ_ROWS_F32.launches, _cuda.PROJ_ROWS.launches) == (before[0] + 1, before[1])
    assert_close_f32(got, linear.proj_rows_ref(*args))


@pytest.mark.parametrize("tile", linear.F32_TILES)
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("B,T,K,S,N", [(2, 16, 200, 196, 136), (1, 9, 96, 112, 1280),
                                       (2, 1, 72, 36, 40), (3, 5, 24, 4, 68)])
def test_proj_rows_kernel_float32_flat_rows(gen, monkeypatch, no_tf32, tile, with_res, B, T, K, S,
                                            N):
    """#7's fp32 instance with its (B, T) groups' rows tiled as one M (S % 4
    == 0, `linear.f32_gemm_plan`'s flat plan): SAM's windows (196 rows a
    group) and edge windows (112) at ragged widths, N = 40, groups of 4 rows,
    K not a multiple of the 32-deep k tile; each tile."""
    monkeypatch.setattr(linear, "F32_TILE_FORCE", tile)
    assert linear.f32_gemm_plan(S, N, K, 132, B * T, mn_groups=True).flat
    f32 = torch.float32
    res = rn(gen, B, T, S, N, dtype=f32) if with_res else None
    args = (dmajor(rn(gen, B, T, K, S, dtype=f32)), rn(gen, N, K, std=0.05, dtype=f32),
            rn(gen, N, std=0.1, dtype=f32), res)
    before = _cuda.PROJ_ROWS_F32.launches
    got = linear.proj_rows(*args)
    assert _cuda.PROJ_ROWS_F32.launches == before + 1
    assert_close_f32(got, linear.proj_rows_ref(*args))


@pytest.mark.parametrize("splits", [2, 3])
def test_f32_gemm_users_split_k(gen, monkeypatch, no_tf32, splits):
    """Split K forced on every tile (`linear.F32_SPLIT_FORCE`: each slice's
    sums into the scratch, the second pass adding them in order and applying
    the epilogue): each user of csrc/sgemm_f32.cuh at ragged shapes (K 200,
    not a multiple of the 32-deep k tile; N 40; 8 groups of 581 rows; flat
    rows; K_HEADS at d 80; #6's in-place EPI_DACT with and without aux)
    against its plain version; two calls bit-equal."""
    monkeypatch.setattr(linear, "F32_SPLIT_FORCE", splits)
    f32 = torch.float32

    def r(*shape, std=1.0):
        return rn(gen, *shape, std=std, dtype=f32)

    x, g, b = r(3, 50, 200), 1 + r(200, std=0.1), r(200, std=0.1)
    w1, b1, w2, b2 = r(264, 200, std=0.05), r(264, std=0.1), r(200, 264, std=0.05), r(200)
    mask = (torch.rand(3, 50, 1, generator=gen, device="cuda") > 0.3).to(f32)
    xg, xf = dmajor(r(8, 1, 256, 581)), dmajor(r(2, 3, 200, 36))
    wg, resf = r(136, 256, std=0.05), r(2, 3, 36, 96)
    xh, wh, resh = r(2, 4, 3, 37, 80), r(96, 320, std=0.05), r(2, 3, 37, 96)
    cases = [
        (linear.linear_act, linear.linear_act_ref, (x[0], w1[:40], b1[:40], "gelu"), {}),
        (linear.ln_linear_act_bt, linear.ln_linear_act_bt_ref, (x, g, b, w1, b1),
         dict(eps=1e-5, activation=None)),
        (linear.ln_mask_linear_bt, linear.ln_mask_linear_bt_ref, (x, g, b, mask, w1, b1), {}),
        (linear.ln_mlp_residual_bt, linear.ln_mlp_residual_bt_ref, (x, g, b, w1, b1, w2, b2),
         dict(eps=1e-5, activation="quick_gelu")),
        (linear.proj_rows, linear.proj_rows_ref, (xg, wg, b1[:136], None), {}),
        (linear.proj_rows, linear.proj_rows_ref, (xf, w1[:96], b1[:96], resf), {}),
        (linear.proj_from_heads_res, linear.proj_from_heads_ref, (xh, wh, b1[:96], resh), {}),
    ]
    cases = [(lambda f=f, a=a, k=k: f(*a, **k), lambda f=p, a=a, k=k: f(*a, **k))
             for f, p, a, k in cases]
    for weights in (False, True):
        args = (x, g, b, w1, b1, w2, b2, x * 0.5)
        cases.append((lambda a=args, w=weights: torch.cat([t.flatten() for t in (
                          linear.ln_mlp_residual_bt_bwd(*a, eps=1e-5, activation="quick_gelu",
                                                        weights=w)) if t is not None]),
                      lambda a=args, w=weights: torch.cat([t.flatten() for t in (
                          linear.ln_mlp_residual_bt_bwd_ref(*a, eps=1e-5, activation="quick_gelu",
                                                            weights=w)) if t is not None])))
    for call, plain in cases:
        got = call()
        assert torch.equal(got, call())
        want = plain()
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert ((got - want).abs().max() / want.abs().max()).item() < F32_BOUND


def test_f32_gemm_users_are_deterministic(gen, no_tf32):
    """No atomics: two calls of each user of csrc/sgemm_f32.cuh (#1, #2, #3,
    #4/#5, #6 with the weight side, #7 flat and grouped, #8) on the same
    inputs are bit-equal. (#6's dh is written in place by its EPI_DACT
    epilogue, res == C, with act(pre) into aux when the weight side is
    wanted: test_ln_mlp_residual_bt_bwd_kernel_float32.)"""
    f32 = torch.float32

    def r(*shape, std=1.0):
        return rn(gen, *shape, std=std, dtype=f32)

    x, g, b = r(3, 50, 200), 1 + r(200, std=0.1), r(200, std=0.1)
    w1, b1, w2, b2 = r(264, 200, std=0.05), r(264, std=0.1), r(200, 264, std=0.05), r(200)
    calls = [
        lambda: linear.linear_act(x[0], w1, b1, "gelu"),
        lambda: linear.ln_linear_act_bt(x, g, b, w1, b1, eps=1e-5, activation=None),
        lambda: linear.ln_mask_linear_bt(x, g, b, torch.ones(3, 50, 1, device="cuda"), w1, b1),
        lambda: linear.ln_mlp_residual_bt(x, g, b, w1, b1, w2, b2, eps=1e-5,
                                          activation="quick_gelu"),
        lambda: torch.cat([t.flatten() for t in linear.ln_mlp_residual_bt_bwd(
            x, g, b, w1, b1, w2, b2, x * 0.5, eps=1e-5, activation="quick_gelu")]),
    ]
    for S in (36, 37):  # flat, grouped
        xd = dmajor(r(2, 3, 200, S))
        calls.append(lambda xd=xd, S=S: linear.proj_rows(xd, w1, b1, r(2, 3, S, 264) * 0 + 1))
    xh = r(2, 4, 3, 37, 80)
    calls.append(lambda: linear.proj_from_heads_res(xh, r(96, 320, std=0.05), b1[:96],
                                                    r(2, 3, 37, 96) * 0))
    for call in calls:
        torch.manual_seed(0)
        gen.manual_seed(1)
        first = call()
        gen.manual_seed(1)
        assert torch.equal(first, call())


@pytest.mark.parametrize("B,S,heads,d", [(8, 581, 16, 64), (1, 7, 2, 64), (2, 64, 1, 64),
                                         (1, 129, 2, 64), (2, 1200, 1, 64)])
def test_flash_qkv_packed_plain_kernel_float32(gen, no_tf32, B, S, heads, d):
    """#16's fp32 instance at MaPLe's vision shape (batch 8, 581 tokens, 16
    heads x 64); sequences under one 64-key tile, exactly one, ragged and
    long; d = 64 (CLIP ViT-L/14's) and 80, no other. Its output feeds the
    fp32 proj_rows as it lies."""
    qkv = rn(gen, B, S, 3 * heads * d, dtype=torch.float32)
    before = (_cuda.QKV_PACKED_PLAIN_F32.launches, _cuda.QKV_PACKED_PLAIN.launches)
    got = flash_attention.flash_qkv_packed_plain(qkv, d ** -0.5, heads, d)
    assert (_cuda.QKV_PACKED_PLAIN_F32.launches, _cuda.QKV_PACKED_PLAIN.launches) == (
        before[0] + 1, before[1])
    assert got.stride(-2) % 8 == 0
    assert_close_f32(got, flash_attention.flash_qkv_packed_plain_ref(qkv, d ** -0.5, heads, d))
    with pytest.raises(ValueError, match="takes d in"):
        flash_attention.flash_qkv_packed_plain(rn(gen, 1, 5, 3 * 32, dtype=torch.float32),
                                               0.1, 1, 32)


@pytest.mark.parametrize("tile", linear.F32_TILES)
@pytest.mark.parametrize("activation", [None, "gelu"])
@pytest.mark.parametrize("M,K,N", [(8192, 768, 1280), (4096, 768, 40), (67, 96, 132),
                                   (130, 200, 12)])
def test_linear_act_kernel_float32(gen, monkeypatch, no_tf32, tile, activation, M, K, N):
    """#1's fp32 instance at the patch embed's shape at batch 2 and the EVP
    embed's (N 40), and ragged ones; each tile."""
    monkeypatch.setattr(linear, "F32_TILE_FORCE", tile)
    f32 = torch.float32
    args = (rn(gen, M, K, dtype=f32), rn(gen, N, K, std=0.05, dtype=f32),
            rn(gen, N, std=0.1, dtype=f32))
    before = (_cuda.LINEAR_ACT_F32.launches, _cuda.LINEAR_ACT.launches)
    got = linear.linear_act(*args, activation=activation)
    assert (_cuda.LINEAR_ACT_F32.launches, _cuda.LINEAR_ACT.launches) == (before[0] + 1, before[1])
    assert_close_f32(got, linear.linear_act_ref(*args, activation=activation))


@pytest.mark.parametrize("tile", linear.F32_TILES)
@pytest.mark.parametrize("Bp,S,K,N,nwin", [(1, 4096, 1280, 3840, 1), (6, 50, 200, 96, 3),
                                          (4, 37, 128, 384, 1), (3, 7, 96, 12, 3)])
def test_ln_mask_linear_bt_kernel_float32(gen, monkeypatch, no_tf32, tile, Bp, S, K, N, nwin):
    """#3's fp32 instance at a ViT-H global block's shape at batch 1 (the
    mask of ones the encoder gives it) and ragged ones with nwin 1 and 3
    (row b' reads mask[b' % nwin]); each tile."""
    monkeypatch.setattr(linear, "F32_TILE_FORCE", tile)
    f32 = torch.float32
    mask = (torch.rand(nwin, S, 1, generator=gen, device="cuda") > 0.3).to(f32)
    if S == 4096:
        mask = torch.ones_like(mask)
    args = (rn(gen, Bp, S, K, dtype=f32) + 0.5, 1 + rn(gen, K, std=0.1, dtype=f32),
            rn(gen, K, std=0.1, dtype=f32), mask, rn(gen, N, K, std=0.05, dtype=f32),
            rn(gen, N, std=0.1, dtype=f32))
    before = (_cuda.LN_MASK_LINEAR_F32.launches, _cuda.LN_MASK_LINEAR.launches)
    got = linear.ln_mask_linear_bt(*args, eps=1e-6)
    assert (_cuda.LN_MASK_LINEAR_F32.launches, _cuda.LN_MASK_LINEAR.launches) == (
        before[0] + 1, before[1])
    assert_close_f32(got, linear.ln_mask_linear_bt_ref(*args, eps=1e-6))


@pytest.mark.parametrize("BW,win,heads,d", [(32, 14, 16, 80), (3, 14, 2, 80), (5, 4, 8, 64),
                                            (2, 7, 1, 64), (2, 9, 2, 80), (1, 16, 2, 64),
                                            (2, 8, 2, 80)])
def test_flash_qkv_packed_windows_s_kernel_float32(gen, no_tf32, BW, win, heads, d):
    """#13's fp32 instance at ViT-H's shape (32 windows of 14, 16 heads x
    80) and others: windows under, at and over one 64-key tile (4, 8, 9,
    14, 16), d 64 and 80."""
    f32 = torch.float32
    S = win * win
    qkv = rn(gen, BW, S, 3 * heads * d, dtype=f32)
    rel_s = rn(gen, S, BW, heads * 32, dtype=f32)
    sel32 = flash_attention.make_rel_scatter32(win, f32, torch.device("cuda"))
    args = (qkv, rel_s, sel32, d ** -0.5, heads, d)
    before = (_cuda.QKV_WINDOWS_F32.launches, _cuda.QKV_WINDOWS.launches)
    got = flash_attention.flash_qkv_packed_windows_s(*args)
    assert (_cuda.QKV_WINDOWS_F32.launches, _cuda.QKV_WINDOWS.launches) == (before[0] + 1,
                                                                            before[1])
    assert got.stride(-2) % 8 == 0
    assert_close_f32(got, flash_attention.flash_qkv_packed_windows_s_ref(*args))


@pytest.mark.parametrize("H,W,win,heads,d", [(64, 64, 14, 2, 80), (10, 10, 4, 2, 64),
                                             (9, 12, 5, 2, 64), (20, 20, 14, 2, 80),
                                             (26, 26, 14, 1, 80), (5, 5, 2, 1, 64)])
def test_flash_qkv_packed_edge_kernel_float32(gen, no_tf32, H, W, win, heads, d):
    """#15's fp32 instance: right, bottom and corner windows with ragged
    R_u (112 at ViT-H, 84, 168, and under one 64-key tile), the corner's
    dummy rows with a pad-key logit of -1e30 and dummy keys of kmask's
    -1e30, as the encoder gives them; d 64 and 80."""
    f32 = torch.float32
    geom = CompactGeometry(H, W, win)
    B, n, R = 2, geom.n_edge, geom.R_u
    qkv = rn(gen, B, n, R, 3 * heads * d, dtype=f32)
    rel = rn(gen, B, n, R, heads, 32, dtype=f32)
    for g_start, g in zip(np.cumsum([0] + [g.n for g in geom.edge_groups]), geom.edge_groups):
        rel[:, g_start : g_start + g.n, g.rows :, :, LPAD_LANE] = NEG
    rel = rel.reshape(B, n, R, heads * 32)
    sel, kmask = edge_consts(geom, f32, torch.device("cuda"))
    vb = rn(gen, heads, d, std=0.5, dtype=f32)
    args = (qkv, rel, sel, vb, kmask, d ** -0.5, heads, d)
    before = (_cuda.QKV_EDGE_F32.launches, _cuda.QKV_EDGE.launches)
    got = flash_attention.flash_qkv_packed_edge(*args)
    assert (_cuda.QKV_EDGE_F32.launches, _cuda.QKV_EDGE.launches) == (before[0] + 1, before[1])
    assert got.stride(-2) % 8 == 0
    assert_close_f32(got, flash_attention.flash_qkv_packed_edge_ref(*args))


@pytest.mark.parametrize("B,H,W,heads,d", [(1, 64, 64, 2, 80), (2, 64, 64, 1, 80),
                                           (1, 5, 5, 2, 64), (2, 6, 10, 2, 80),
                                           (1, 7, 9, 1, 64), (1, 5, 20, 1, 80),
                                           (1, 33, 40, 1, 80), (1, 2, 128, 1, 64)])
def test_flash_qkv_packed_global_kernel_float32(gen, no_tf32, B, H, W, heads, d):
    """#17's fp32 instance on grids from 5 x 5 to ViT-H's 64 x 64, H != W
    and ragged N; d 64 and 80."""
    f32 = torch.float32
    N = H * W
    qkv = rn(gen, B, N, 3 * heads * d, dtype=f32)
    rel = rn(gen, N, B, heads, H + W, dtype=f32)
    sel = flash_attention.make_rel_scatter(H, W, f32, torch.device("cuda"))
    args = (qkv, rel, sel, d ** -0.5, heads, d, H, W)
    before = (_cuda.QKV_GLOBAL_F32.launches, _cuda.QKV_GLOBAL.launches)
    got = flash_attention.flash_qkv_packed_global(*args)
    assert (_cuda.QKV_GLOBAL_F32.launches, _cuda.QKV_GLOBAL.launches) == (before[0] + 1,
                                                                          before[1])
    assert got.stride(-2) % 8 == 0
    assert_close_f32(got, flash_attention.flash_qkv_packed_global_ref(*args[:6]))


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("tile", linear.F32_TILES)
@pytest.mark.parametrize("B,S,K,H", [(8, 581, 1024, 4096), (14, 77, 768, 3072), (2, 37, 200, 264),
                                     (1, 7, 96, 136), (2, 1008, 1280, 5120),
                                     (2, 4096, 1280, 5120)])
def test_ln_mlp_residual_bt_bwd_kernel_float32(gen, monkeypatch, no_tf32, weights, tile, B, S, K,
                                                H):
    """#6's fp32 instance at MaPLe's two sites (vision: batch 8 x 581 rows,
    K 1024, H 4096; text: 14 classes x 77 tokens, K 768, H 3072), at SAM
    ViT-H's (K 1280, H 5120: the edge windows' 2 x 1008 rows, and the global
    blocks' 2 x 4096, whose hidden walks row panels) and ragged ones; each
    tile; with and without the weight side."""
    monkeypatch.setattr(linear, "F32_TILE_FORCE", tile)
    f32 = torch.float32
    args = (rn(gen, B, S, K, dtype=f32), 1 + rn(gen, K, std=0.1, dtype=f32),
            rn(gen, K, std=0.1, dtype=f32), rn(gen, H, K, std=0.05, dtype=f32),
            rn(gen, H, std=0.1, dtype=f32), rn(gen, K, H, std=0.05, dtype=f32),
            rn(gen, K, std=0.1, dtype=f32), rn(gen, B, S, K, dtype=f32))
    before = (_cuda.LN_MLP_RESIDUAL_BWD_F32.launches, _cuda.LN_MLP_RESIDUAL_BWD.launches)
    got = linear.ln_mlp_residual_bt_bwd(*args, eps=1e-5, activation="quick_gelu",
                                        weights=weights)
    assert (_cuda.LN_MLP_RESIDUAL_BWD_F32.launches, _cuda.LN_MLP_RESIDUAL_BWD.launches) == (
        before[0] + 1, before[1])
    want = linear.ln_mlp_residual_bt_bwd_ref(*args, eps=1e-5, activation="quick_gelu",
                                             weights=weights)
    for gt, wt in zip(got, want):
        if wt is None:
            assert gt is None
        else:
            assert_close_f32(gt, wt)


def test_ln_mlp_residual_bt_bwd_kernel_float32_row_panels(gen, monkeypatch, no_tf32):
    """A hidden larger than the scratch: the fp32 backward walks M in row
    panels (256 rows of 700, the last one ragged), one count, with and
    without the weight side."""
    monkeypatch.setattr(linear, "MLP_SCRATCH_ELEMS", 300 * 512)
    B, S, K, H = 2, 350, 128, 512
    assert linear.mlp_panel_rows(B * S, H) == 256
    f32 = torch.float32
    args = (rn(gen, B, S, K, dtype=f32), 1 + rn(gen, K, std=0.1, dtype=f32),
            rn(gen, K, std=0.1, dtype=f32), rn(gen, H, K, std=0.05, dtype=f32),
            rn(gen, H, std=0.1, dtype=f32), rn(gen, K, H, std=0.05, dtype=f32),
            rn(gen, K, std=0.1, dtype=f32), rn(gen, B, S, K, dtype=f32))
    for weights in (False, True):
        before = _cuda.LN_MLP_RESIDUAL_BWD_F32.launches
        got = linear.ln_mlp_residual_bt_bwd(*args, eps=1e-6, activation="gelu_tanh",
                                            weights=weights)
        assert _cuda.LN_MLP_RESIDUAL_BWD_F32.launches == before + 1
        want = linear.ln_mlp_residual_bt_bwd_ref(*args, eps=1e-6, activation="gelu_tanh",
                                                 weights=weights)
        for gt, wt in zip(got, want):
            assert (gt is None) == (wt is None)
            if wt is not None:
                assert_close_f32(gt, wt)


def _mlp_bwd_f32_args(gen, B, S, K, H):
    f32 = torch.float32
    return (rn(gen, B, S, K, dtype=f32), 1 + rn(gen, K, std=0.1, dtype=f32),
            rn(gen, K, std=0.1, dtype=f32), rn(gen, H, K, std=0.05, dtype=f32),
            rn(gen, H, std=0.1, dtype=f32), rn(gen, K, H, std=0.05, dtype=f32),
            rn(gen, K, std=0.1, dtype=f32), rn(gen, B, S, K, dtype=f32))


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("path", linear.F32_PATHS)
@pytest.mark.parametrize("B,S,K,H", [(8, 581, 1024, 4096), (14, 77, 768, 3072), (1, 127, 200, 264),
                                     (1, 129, 200, 264), (2, 1008, 1280, 5120),
                                     (2, 4096, 1280, 5120)])
def test_ln_mlp_residual_bt_bwd_kernel_float32_on_each_path(gen, monkeypatch, no_tf32, path,
                                                             weights, B, S, K, H):
    """#6's fp32 instance with each path forced (`linear.F32_PATH_FORCE`;
    the weight side takes path 0 whatever is forced) at MaPLe's and SAM's
    sites and ragged ones: every output within 1e-4 of plain (TF32 off), one
    launch a call, two calls bit-equal."""
    monkeypatch.setattr(linear, "F32_PATH_FORCE", path)
    M = B * S
    plans = linear.f32_mlp_bwd_plans(M, linear.mlp_panel_rows(M, H), K, H,
                                     _cuda.sm_count(torch.device("cuda")), weights)
    assert plans[0].path == plans[1].path == (0 if weights else path)
    args = _mlp_bwd_f32_args(gen, B, S, K, H)
    before = _cuda.LN_MLP_RESIDUAL_BWD_F32.launches
    got = linear.ln_mlp_residual_bt_bwd(*args, eps=1e-6, activation="gelu_tanh", weights=weights)
    assert _cuda.LN_MLP_RESIDUAL_BWD_F32.launches == before + 1
    want = linear.ln_mlp_residual_bt_bwd_ref(*args, eps=1e-6, activation="gelu_tanh",
                                             weights=weights)
    again = linear.ln_mlp_residual_bt_bwd(*args, eps=1e-6, activation="gelu_tanh",
                                          weights=weights)
    for gt, wt, g2 in zip(got, want, again):
        assert (gt is None) == (wt is None) == (g2 is None)
        if wt is not None:
            assert_close_f32(gt, wt)
            assert torch.equal(gt, g2)


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("tile", range(len(linear.F32_TILES) + len(linear.F32_MN_TILES)))
@pytest.mark.parametrize("rows", [127, 128, 129, 581])
def test_ln_mlp_residual_bt_bwd_float32_paths_bit_equal(gen, monkeypatch, no_tf32, splits, tile,
                                                        rows):
    """#6's dx at each tile number on the path that takes it (path 0 on
    F32_TILES, the MN path on its own), K and H cut into `splits` slices
    (the MN path's EPI_ACT_T and EPI_DACT_T through the second pass): within
    1e-4 of plain and bit-equal to path 0 at 64 x 128 with the same slices
    (each output one sum over k in order, the LN statistics the same sums),
    also in row panels of 128 rows (the last one ragged)."""
    monkeypatch.setattr(linear, "F32_SPLIT_FORCE", splits)
    (path,) = [p for p in linear.F32_PATHS if (p, tile) in linear.F32_PATH_RATE]
    args = _mlp_bwd_f32_args(gen, 1, rows, 200, 264)
    want = linear.ln_mlp_residual_bt_bwd_ref(*args, eps=1e-5, activation="quick_gelu",
                                             weights=False)[0]

    def dx():
        return linear.ln_mlp_residual_bt_bwd(*args, eps=1e-5, activation="quick_gelu",
                                             weights=False)[0]

    for scratch in (linear.MLP_SCRATCH_ELEMS, 128 * 264):
        monkeypatch.setattr(linear, "MLP_SCRATCH_ELEMS", scratch)
        monkeypatch.setattr(linear, "F32_TILE_FORCE", 1)
        monkeypatch.setattr(linear, "F32_PATH_FORCE", 0)
        ref = dx()
        monkeypatch.setattr(linear, "F32_TILE_FORCE", tile)
        monkeypatch.setattr(linear, "F32_PATH_FORCE", path)
        got = dx()
        assert_close_f32(got, want)
        assert torch.equal(got, ref), (scratch, path, tile)


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
    # the fp32 attention takes d in (64, 80) only, and its global instance
    # holds a query tile's H + W rel lanes: at most 512
    f32 = torch.float32
    sel4 = flash_attention.make_rel_scatter32(4, f32, torch.device("cuda"))
    with pytest.raises(ValueError, match="takes d in"):
        flash_attention.flash_qkv_packed_windows_s(rn(gen, 2, 16, 3 * 32, dtype=f32),
                                                   rn(gen, 16, 2, 32, dtype=f32), sel4,
                                                   0.1, 1, 32)
    sel5 = flash_attention.make_rel_scatter(5, 5, f32, torch.device("cuda"))
    with pytest.raises(ValueError, match="takes d in"):
        flash_attention.flash_qkv_packed_global(rn(gen, 1, 25, 3 * 128, dtype=f32),
                                                rn(gen, 25, 1, 1, 10, dtype=f32), sel5,
                                                0.1, 1, 128, 5, 5)
    H, W = 1, 512
    sel = flash_attention.make_rel_scatter(H, W, f32, torch.device("cuda"))
    with pytest.raises(ValueError, match="H\\+W <= 512"):
        flash_attention.flash_qkv_packed_global(rn(gen, 1, H * W, 3 * 64, dtype=f32),
                                                rn(gen, H * W, 1, 1, H + W, dtype=f32), sel,
                                                0.125, 1, 64, H, W)
    geom = CompactGeometry(10, 10, 4)
    sel_e, km = edge_consts(geom, f32, torch.device("cuda"))
    n, R = geom.n_edge, geom.R_u
    with pytest.raises(ValueError, match="takes d in"):
        flash_attention.flash_qkv_packed_edge(rn(gen, 1, n, R, 3 * 16, dtype=f32),
                                              rn(gen, 1, n, R, 32, dtype=f32), sel_e,
                                              rn(gen, 1, 16, dtype=f32), km, 0.25, 1, 16)
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


def _windows_bwd_args(gen, BW, win, heads, d, dtype=torch.bfloat16):
    S = win * win
    return (rn(gen, BW, S, 3 * heads * d, dtype=dtype), rn(gen, S, BW, heads * 32, dtype=dtype),
            flash_attention.make_rel_scatter32(win, dtype, torch.device("cuda")),
            rn(gen, BW, heads * d, S, std=0.05, dtype=dtype), d ** -0.5, heads, d)


def _global_bwd_args(gen, B, H, W, heads, d, dtype=torch.bfloat16):
    N = H * W
    return (rn(gen, B, N, 3 * heads * d, dtype=dtype), rn(gen, N, B, heads, H + W, dtype=dtype),
            flash_attention.make_rel_scatter(H, W, dtype, torch.device("cuda")),
            rn(gen, B, heads * d, N, std=0.05, dtype=dtype), d ** -0.5, heads, d, H, W)


def _bwd_out(args):
    """The forward's output the fp32 backward reads (t = sum g o): the plain
    fp32 forward's on the backward's arguments, in the rows of a stride
    rounded up to 8 that the forward kernels write."""
    qkv, rel, sel, _, scale, heads, d = args[:7]
    ref = flash_attention.flash_qkv_packed_windows_s_ref if len(args) == 7 else \
        flash_attention.flash_qkv_packed_global_ref
    return dmajor(ref(qkv, rel, sel, scale, heads, d))


@pytest.mark.parametrize("BW,win,heads,d", [(32, 14, 16, 80), (16, 14, 16, 80), (3, 4, 2, 64),
                                            (2, 9, 2, 80), (2, 14, 2, 64), (1, 16, 2, 80),
                                            (2, 16, 1, 64)])
def test_flash_qkv_packed_windows_s_bwd_kernel_float32(gen, no_tf32, BW, win, heads, d):
    """#14's fp32 instance at ViT-H's shapes (32 and 16 windows of 14, 16
    heads x 80) and ragged ones: windows of 4 (16 keys, one short tile), 9
    (81: a ragged second tile, 18 live lanes), 14 (196: a last tile of 4)
    and 16, d 64 and 80; dqkv and drel within 1e-4 of the plain fp32
    backward, the dead lanes exactly 0; one launch of the fp32 instance,
    none of the bf16 kernel."""
    args = _windows_bwd_args(gen, BW, win, heads, d, dtype=torch.float32)
    before = (_cuda.QKV_WINDOWS_BWD_F32.launches, _cuda.QKV_WINDOWS_BWD.launches)
    got = flash_attention.flash_qkv_packed_windows_s_bwd(*args, o=_bwd_out(args))
    assert (_cuda.QKV_WINDOWS_BWD_F32.launches, _cuda.QKV_WINDOWS_BWD.launches) == (
        before[0] + 1, before[1])
    for gt, wt in zip(got, flash_attention.flash_qkv_packed_windows_s_bwd_ref(*args)):
        assert_close_f32(gt, wt)
    assert not got[1].reshape(win * win, BW, heads, 32)[..., 2 * win:].any()


@pytest.mark.parametrize("B,H,W,heads,d", [(1, 64, 64, 16, 80), (2, 64, 64, 2, 80),
                                           (2, 64, 64, 1, 64), (1, 10, 10, 2, 64),
                                           (2, 10, 10, 2, 80), (2, 8, 64, 2, 80),
                                           (1, 8, 64, 1, 64), (1, 5, 20, 2, 80),
                                           (2, 3, 50, 2, 80), (1, 2, 130, 2, 64)])
def test_flash_qkv_packed_global_bwd_kernel_float32(gen, no_tf32, B, H, W, heads, d):
    """#18's fp32 instance on ViT-H's 64 x 64 grid (batch 1 at full width,
    16 heads x 80) and on 10 x 10 (a ragged tile), 8 x 64, 5 x 20, 3 x 50
    (a grid row across two key tiles) and 2 x 130 (W > 128: a rel slot a
    key, the rel_w sums in drel itself), d 64 and 80; within 1e-4 of the
    plain fp32 backward, the fp32 count up by one and the bf16 count
    unchanged."""
    args = _global_bwd_args(gen, B, H, W, heads, d, dtype=torch.float32)
    before = (_cuda.QKV_GLOBAL_BWD_F32.launches, _cuda.QKV_GLOBAL_BWD.launches)
    got = flash_attention.flash_qkv_packed_global_bwd(*args, o=_bwd_out(args))
    assert (_cuda.QKV_GLOBAL_BWD_F32.launches, _cuda.QKV_GLOBAL_BWD.launches) == (
        before[0] + 1, before[1])
    for gt, wt in zip(got, flash_attention.flash_qkv_packed_global_bwd_ref(*args[:7])):
        assert_close_f32(gt, wt)


def test_flash_qkv_packed_global_bwd_float32_lane_limit(gen, no_tf32):
    """The fp32 #18 takes H + W <= F32_GLOBAL_BWD_MAX_LANES lanes, its
    forward's 512: at the limit it runs, one past it it refuses, naming
    the limit; without the forward's output it refuses too."""
    limit = flash_attention.F32_GLOBAL_BWD_MAX_LANES
    assert limit == flash_attention.F32_GLOBAL_MAX_LANES == 512
    args = _global_bwd_args(gen, 1, 2, limit - 2, 1, 64, dtype=torch.float32)
    for gt, wt in zip(flash_attention.flash_qkv_packed_global_bwd(*args, o=_bwd_out(args)),
                      flash_attention.flash_qkv_packed_global_bwd_ref(*args[:7])):
        assert_close_f32(gt, wt)
    with pytest.raises(ValueError, match="forward's output"):
        flash_attention.flash_qkv_packed_global_bwd(*args)
    args = _global_bwd_args(gen, 1, 2, limit - 1, 1, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match=f"H\\+W <= {limit}"):
        flash_attention.flash_qkv_packed_global_bwd(*args, o=_bwd_out(args))


def test_flash_qkv_packed_global_bwd_lane_limit(gen):
    """The bf16 #18 takes H + W <= GLOBAL_BWD_MAX_LANES, its fp32
    instance's 512: at the limit it runs, one past it it refuses, naming
    the limit."""
    limit = flash_attention.GLOBAL_BWD_MAX_LANES
    assert limit == flash_attention.F32_GLOBAL_BWD_MAX_LANES == 512
    args = _global_bwd_args(gen, 1, 2, limit - 2, 1, 64)
    _grad_close(flash_attention.flash_qkv_packed_global_bwd(*args),
                flash_attention.flash_qkv_packed_global_bwd_ref(*args[:7]))
    args = _global_bwd_args(gen, 1, 2, limit - 1, 1, 64)
    with pytest.raises(ValueError, match=f"H\\+W <= {limit}"):
        flash_attention.flash_qkv_packed_global_bwd(*args)


@pytest.mark.parametrize("H,W,d", [(256, 256, 80), (250, 262, 80), (200, 300, 128),
                                   (256, 256, 128)])
def test_flash_qkv_packed_global_bwd_largest_grids(gen, H, W, d):
    """The wide path at the largest grids it takes (B 1, one head): a
    shorter side of 250 or 256 at d 80, where the query pass's [64][B] fp32
    drel_B array leaves the ring two stages, and past 192 at d 128, where it
    leaves one; against the plain backward a block of queries at a time
    (the whole one's (N, N) fp32 products would not fit the card)."""
    plan = _cuda.attn_bwd_smem(d, H, W, H + W, flash_attention.attn_bwd_lanes(H + W))
    assert plan["path"] == "wide" and plan["query_smem"] <= _cuda.SMEM_MAX
    assert plan["query_stages"] == (2 if d == 80 else 1)
    args = _global_bwd_args(gen, 1, H, W, 1, d)
    before = _cuda.QKV_GLOBAL_BWD.launches
    got = flash_attention.flash_qkv_packed_global_bwd(*args)
    assert _cuda.QKV_GLOBAL_BWD.launches == before + 1
    _grad_close(got, flash_attention.flash_qkv_packed_global_bwd_ref_chunked(*args[:7]))


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


def test_attention_bwd_kernels_float32_are_deterministic(gen):
    """The fp32 instances have no atomics either: drel's sums in a fixed
    order, so two calls give bit-equal dqkv and drel."""
    f32 = torch.float32
    for fn, args in ((flash_attention.flash_qkv_packed_windows_s_bwd,
                      _windows_bwd_args(gen, 8, 14, 4, 80, dtype=f32)),
                     (flash_attention.flash_qkv_packed_global_bwd,
                      _global_bwd_args(gen, 2, 64, 64, 2, 80, dtype=f32))):
        o = _bwd_out(args)
        first = fn(*args, o=o)
        second = fn(*args, o=o)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.parametrize("H,W,heads,d,path", [
    (4, 64, 2, 80, "register"), (3, 64, 3, 64, "register"), (2, 64, 1, 128, "register"),
    (4, 60, 2, 80, "general"), (3, 63, 3, 64, "general"), (2, 62, 1, 128, "general"),
    (80, 80, 2, 80, "wide"), (5, 130, 2, 64, "wide"), (131, 3, 2, 128, "wide"),
    (3, 200, 1, 16, "wide"), (17, 300, 1, 32, "wide")])
def test_flash_qkv_packed_global_bwd_paths(gen, H, W, heads, d, path):
    """The three paths the C entry picks: at 128 lanes on an H x 64 grid the
    register path (bias in registers, drel as row sums and the dS tiles
    themselves), on other widths the general path (bias and drel through
    the key code on the tensor cores); past 128 lanes the wide path (key
    tiles along the grid's lines, the longer side's 64 lanes a tile)."""
    assert _cuda.attn_bwd_smem(d, H, W, H + W,
                               flash_attention.attn_bwd_lanes(H + W))["path"] == path
    args = _global_bwd_args(gen, 2, H, W, heads, d)
    before = _cuda.QKV_GLOBAL_BWD.launches
    got = flash_attention.flash_qkv_packed_global_bwd(*args)
    assert _cuda.QKV_GLOBAL_BWD.launches == before + 1
    _grad_close(got, flash_attention.flash_qkv_packed_global_bwd_ref(*args[:7]))


def _grads_through_the_wrappers(gen, dtype, heads, d, kernels, close):
    """A gradient through the windows and the global attention wrappers in
    `dtype`: each runs its backward kernel (`kernels`) once and equals the
    plain backward's (`close`)."""
    win, H, W, cuda = 5, 6, 10, torch.device("cuda")
    cases = [
        (flash_attention.flash_qkv_packed_windows_s,
         flash_attention.flash_qkv_packed_windows_s_bwd_ref, kernels[0],
         (rn(gen, 3, win * win, 3 * heads * d, dtype=dtype),
          rn(gen, win * win, 3, heads * 32, dtype=dtype),
          flash_attention.make_rel_scatter32(win, dtype, cuda)), (d ** -0.5, heads, d), ()),
        (flash_attention.flash_qkv_packed_global,
         flash_attention.flash_qkv_packed_global_bwd_ref, kernels[1],
         (rn(gen, 1, H * W, 3 * heads * d, dtype=dtype), rn(gen, H * W, 1, heads, H + W,
                                                             dtype=dtype),
          flash_attention.make_rel_scatter(H, W, dtype, cuda)), (d ** -0.5, heads, d), (H, W)),
    ]
    for fn, bwd_ref, kernel, (qkv, rel, sel), static, hw in cases:
        qkv.requires_grad_(True)
        rel.requires_grad_(True)
        before = kernel.launches
        out = fn(qkv, rel, sel, *static, *hw)
        g = rn(gen, *out.shape, dtype=dtype)
        got = torch.autograd.grad(out, (qkv, rel), g)
        assert kernel.launches == before + 1
        for gt, wt in zip(got, bwd_ref(qkv.detach(), rel.detach(), sel, g.contiguous(),
                                       *static)):
            close(gt, wt)


def test_attention_functions_launch_the_backward_kernels(gen):
    """A gradient through the wrappers runs the backward kernel once and
    equals the plain backward's."""
    _grads_through_the_wrappers(gen, torch.bfloat16, 2, 32,
                                (_cuda.QKV_WINDOWS_BWD, _cuda.QKV_GLOBAL_BWD), assert_close)


def test_attention_functions_launch_the_float32_backward_kernels(gen, no_tf32):
    """In float32 (train --dtype float32) the same gradients run the fp32
    instances once each, within 1e-4 of the plain fp32 backward."""
    _grads_through_the_wrappers(gen, torch.float32, 2, 64,
                                (_cuda.QKV_WINDOWS_BWD_F32, _cuda.QKV_GLOBAL_BWD_F32),
                                assert_close_f32)


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


# ---------------- the fp32 instances of #10, #20, #12, #11, #19, #8 and #9


@pytest.mark.parametrize("BB,H,W,d", [(6, 14, 14, 64), (2, 64, 64, 64), (3, 17, 17, 80),
                                      (2, 5, 6, 64), (1, 9, 7, 80)])
def test_flash_attention_relpos_kernel_float32(gen, no_tf32, BB, H, W, d):
    """#10's fp32 instance (csrc/qkv_relpos_f32.cu over split rows): SAM
    ViT-B's windows (196 tokens: the last key tile ragged) and global grid
    (4096, 128 lanes), 289 tokens at d 80, ragged ones; q pre-scaled as the
    encoder gives it. Any other d raises."""
    f32, N = torch.float32, H * W
    args = (rn(gen, BB, N, d, std=d ** -0.5, dtype=f32), rn(gen, BB, N, d, dtype=f32),
            rn(gen, BB, N, d, dtype=f32), rn(gen, BB, N, H + W, dtype=f32),
            flash_attention.make_rel_scatter(H, W, f32, torch.device("cuda")))
    before = (_cuda.ATTN_RELPOS_F32.launches, _cuda.ATTN_RELPOS.launches)
    got = flash_attention.flash_attention_relpos(*args, H, W)
    assert (_cuda.ATTN_RELPOS_F32.launches, _cuda.ATTN_RELPOS.launches) == (before[0] + 1,
                                                                            before[1])
    assert_close_f32(got, flash_attention.xla_attention_relpos(*args))
    small = [t[..., :32] if i < 3 else t for i, t in enumerate(args)]
    with pytest.raises(ValueError, match="takes d in"):
        flash_attention.flash_attention_relpos(*(t.contiguous() for t in small), H, W)


@pytest.mark.parametrize("BB,N,dqk,dv", [(2, 4096, 208, 80), (3, 1024, 128, 64),
                                         (2, 196, 208, 80), (1, 289, 128, 64), (2, 7, 208, 80)])
def test_flash_attention_fullk_kernel_float32(gen, no_tf32, BB, N, dqk, dv):
    """#20's fp32 instance (csrc/attn_fullk_f32.cu) at ViT-H's 'aug_flash'
    global blocks (4096 tokens, d_qk 208, dv 80), the small 'aug_flash'
    cascade's (1024, 128, 64), and ragged token counts; its shared memory
    one block's; any other depth raises."""
    f32 = torch.float32
    args = (rn(gen, BB, N, dqk, std=dqk ** -0.5, dtype=f32), rn(gen, BB, N, dqk, dtype=f32),
            rn(gen, BB, N, dv, dtype=f32))
    before = (_cuda.ATTN_FULLK_F32.launches, _cuda.ATTN_FULLK.launches)
    got = flash_attention.flash_attention_fullk(*args)
    assert (_cuda.ATTN_FULLK_F32.launches, _cuda.ATTN_FULLK.launches) == (before[0] + 1,
                                                                          before[1])
    assert_close_f32(got, flash_attention.flash_attention_fullk_ref(*args))
    for t in range(len(flash_attention.F32_ATTN_TILES)):  # each tile the instance takes
        want = flash_attention.f32_attn_smem(dqk, dv, "none", t)
        if 0 < want <= 227 * 1024:
            assert _cuda.attn_f32_smem(dqk, dv, "none", t) == want
    with pytest.raises(ValueError, match="takes \\(d_qk, dv\\)"):
        flash_attention.flash_attention_fullk(args[0][..., :96].contiguous(),
                                              args[1][..., :96].contiguous(), args[2])


@pytest.mark.parametrize("B,nwin,win,heads,d", [(2, 16, 16, 2, 80), (1, 25, 15, 2, 80),
                                                (2, 3, 4, 8, 64), (1, 1, 16, 1, 64),
                                                (2, 4, 15, 16, 80)])
def test_flash_qkv_packed_windows_kernel_float32(gen, no_tf32, B, nwin, win, heads, d):
    """#12's fp32 instance (csrc/qkv_windows_f32.cu): window-major rel;
    windows of 16 (ViT-H; 256 keys, 4 tiles), 15 (225: ragged, rows of the
    padded stride 232; also at ViT-H's 16 heads), 4, and a 16 x 16 global
    block."""
    f32, Nw = torch.float32, win * win
    sel32 = flash_attention.make_rel_scatter32(win, f32, torch.device("cuda"))
    args = (rn(gen, B, nwin, Nw, 3 * heads * d, dtype=f32),
            rn(gen, B, nwin, Nw, heads * 32, dtype=f32), sel32, d ** -0.5, heads, d)
    before = (_cuda.QKV_WINDOWS_PADDED_F32.launches, _cuda.QKV_WINDOWS_PADDED.launches)
    got = flash_attention.flash_qkv_packed_windows(*args)
    assert (_cuda.QKV_WINDOWS_PADDED_F32.launches, _cuda.QKV_WINDOWS_PADDED.launches) == (
        before[0] + 1, before[1])
    assert got.stride(-2) == -(-Nw // 8) * 8  # proj_rows' padded d-major rows
    assert_close_f32(got, flash_attention.flash_qkv_packed_windows_ref(*args))


@pytest.mark.parametrize("B,nwin,H,W,heads,d", [(2, 4, 17, 17, 2, 80), (1, 3, 14, 14, 2, 64),
                                                (1, 1, 20, 20, 2, 80), (1, 2, 18, 18, 16, 80),
                                                (1, 3, 5, 6, 3, 64)])
def test_flash_qkv_relpos_windows_kernel_float32(gen, no_tf32, B, nwin, H, W, heads, d):
    """#11's fp32 instance (csrc/qkv_relpos_f32.cu over the packed rows):
    windows of 17 (289 keys, 34 lanes: head h's rel 8 bytes off a 16-byte
    boundary) and 14 (196), a 20 x 20 global block (H + W 40), 18 at ViT-H's
    16 heads, a ragged non-square one; head-leading out."""
    f32, N = torch.float32, H * W
    qkv = rn(gen, B, nwin, N, 3 * heads, d, dtype=f32)
    rel = rn(gen, B, nwin, N, heads, H + W, dtype=f32)
    sel = flash_attention.make_rel_scatter(H, W, f32, torch.device("cuda"))
    before = (_cuda.QKV_RELPOS_WINDOWS_F32.launches, _cuda.QKV_RELPOS_WINDOWS.launches)
    got = flash_attention.flash_qkv_relpos_windows(qkv, rel, sel, d ** -0.5, H, W)
    assert (_cuda.QKV_RELPOS_WINDOWS_F32.launches, _cuda.QKV_RELPOS_WINDOWS.launches) == (
        before[0] + 1, before[1])
    assert_close_f32(got, flash_attention.flash_qkv_relpos_windows_ref(qkv, rel, sel, d ** -0.5))


@pytest.mark.parametrize("B,H,W,heads,d", [(2, 64, 64, 2, 80), (1, 6, 10, 3, 64),
                                           (1, 4, 70, 2, 64)])
def test_flash_qkv_relpos_global_kernel_float32(gen, no_tf32, B, H, W, heads, d):
    """#19's fp32 instance (#11's over one window, its own count): the 64 x
    64 grid (128 lanes), a ragged 6 x 10 one and 4 x 70 (74 lanes)."""
    f32, N = torch.float32, H * W
    qkv, rel = rn(gen, B, N, 3 * heads, d, dtype=f32), rn(gen, B, N, heads, H + W, dtype=f32)
    sel = flash_attention.make_rel_scatter(H, W, f32, torch.device("cuda"))
    before = (_cuda.QKV_RELPOS_GLOBAL_F32.launches, _cuda.QKV_RELPOS_GLOBAL.launches,
              _cuda.QKV_RELPOS_WINDOWS_F32.launches)
    got = flash_attention.flash_qkv_relpos_global(qkv, rel, sel, d ** -0.5, H, W)
    assert (_cuda.QKV_RELPOS_GLOBAL_F32.launches, _cuda.QKV_RELPOS_GLOBAL.launches,
            _cuda.QKV_RELPOS_WINDOWS_F32.launches) == (before[0] + 1, before[1], before[2])
    assert_close_f32(got, flash_attention.flash_qkv_relpos_global_ref(qkv, rel, sel, d ** -0.5))


# ------------- csrc/attn_f32.cuh's loop at each tile the plan can pick

# S tokens as (H, W) grids for the users with a separable bias
_F32_LOOP_GRIDS = {127: (1, 127), 128: (8, 16), 129: (3, 43), 581: (7, 83)}


def _f32_loop_users(gen, S):
    """(name, kernel, call, plain) of every user of the fp32 loop at S
    tokens, 2 heads (the windows' users, #13 and #12, at the window whose
    win^2 is nearest S within 2 win <= 32: 11, 11, 11 and 16)."""
    f32, dev = torch.float32, torch.device("cuda")
    fa = flash_attention
    H, W = _F32_LOOP_GRIDS[S]
    heads, d = 2, 80

    def r(*shape, std=1.0):
        return rn(gen, *shape, std=std, dtype=f32)

    out = []
    qkv = r(2, S, 3 * heads * 64)
    out.append(("#16", _cuda.QKV_PACKED_PLAIN_F32,
                lambda: fa.flash_qkv_packed_plain(qkv, 0.125, heads, 64),
                lambda: fa.flash_qkv_packed_plain_ref(qkv, 0.125, heads, 64)))
    win = 11 if S < 200 else 16
    qw, rw = r(3, win * win, 3 * heads * d), r(win * win, 3, heads * 32)
    s32 = fa.make_rel_scatter32(win, f32, dev)
    out.append(("#13", _cuda.QKV_WINDOWS_F32,
                lambda: fa.flash_qkv_packed_windows_s(qw, rw, s32, d ** -0.5, heads, d),
                lambda: fa.flash_qkv_packed_windows_s_ref(qw, rw, s32, d ** -0.5, heads, d)))
    qp, rp = r(1, 2, win * win, 3 * heads * d), r(1, 2, win * win, heads * 32)
    out.append(("#12", _cuda.QKV_WINDOWS_PADDED_F32,
                lambda: fa.flash_qkv_packed_windows(qp, rp, s32, d ** -0.5, heads, d),
                lambda: fa.flash_qkv_packed_windows_ref(qp, rp, s32, d ** -0.5, heads, d)))
    n = 2
    sel = (torch.rand(n, 32, S, generator=gen, device="cuda") > 0.8).to(f32)
    kmask = torch.where(torch.rand(n, 1, S, generator=gen, device="cuda") > 0.1,
                        torch.zeros((), device="cuda"), torch.full((), NEG, device="cuda"))
    kmask[..., 0] = 0.0  # a real key in every window
    ea = (r(2, n, S, 3 * heads * d), r(2, n, S, heads * 32), sel, r(heads, d, std=0.5), kmask)
    out.append(("#15", _cuda.QKV_EDGE_F32,
                lambda: fa.flash_qkv_packed_edge(*ea, d ** -0.5, heads, d),
                lambda: fa.flash_qkv_packed_edge_ref(*ea, d ** -0.5, heads, d)))
    sel_g = fa.make_rel_scatter(H, W, f32, dev)
    ga = (r(2, S, 3 * heads * d), r(S, 2, heads, H + W), sel_g)
    out.append(("#17", _cuda.QKV_GLOBAL_F32,
                lambda: fa.flash_qkv_packed_global(*ga, d ** -0.5, heads, d, H, W),
                lambda: fa.flash_qkv_packed_global_ref(*ga, d ** -0.5, heads, d)))
    ra = (r(3, S, 64, std=0.125), r(3, S, 64), r(3, S, 64), r(3, S, H + W), sel_g)
    out.append(("#10", _cuda.ATTN_RELPOS_F32,
                lambda: fa.flash_attention_relpos(*ra, H, W),
                lambda: fa.xla_attention_relpos(*ra)))
    q5, r5 = r(1, 2, S, 3 * heads, d), r(1, 2, S, heads, H + W)
    out.append(("#11", _cuda.QKV_RELPOS_WINDOWS_F32,
                lambda: fa.flash_qkv_relpos_windows(q5, r5, sel_g, d ** -0.5, H, W),
                lambda: fa.flash_qkv_relpos_windows_ref(q5, r5, sel_g, d ** -0.5)))
    out.append(("#19", _cuda.QKV_RELPOS_GLOBAL_F32,
                lambda: fa.flash_qkv_relpos_global(q5[:, 0], r5[:, 0], sel_g, d ** -0.5, H, W),
                lambda: fa.flash_qkv_relpos_global_ref(q5[:, 0], r5[:, 0], sel_g, d ** -0.5)))
    for dqk, dv in fa.F32_FULLK_DEPTHS:
        fk = (r(2, S, dqk, std=dqk ** -0.5), r(2, S, dqk), r(2, S, dv))
        out.append((f"#20 {dqk}/{dv}", _cuda.ATTN_FULLK_F32,
                    lambda fk=fk: fa.flash_attention_fullk(*fk),
                    lambda fk=fk: fa.flash_attention_fullk_ref(*fk)))
    return out


@pytest.mark.parametrize("tile", flash_attention.F32_ATTN_TILES)
@pytest.mark.parametrize("S", sorted(_F32_LOOP_GRIDS))
def test_f32_loop_users_at_each_tile(gen, monkeypatch, no_tf32, tile, S):
    """Every user of csrc/attn_f32.cuh's loop (#16, #13, #12, #15, #17,
    #10, #11, #19, #20 at both depths) at the tiles' boundaries (S 127, 128,
    129: one, exactly one and just over one 128-row tile, 2 x 64 keys; 581,
    MaPLe's) under each tile the plan can pick, forced (the ones an instance
    does not take raise ValueError): within 1e-4 of the plain version, and
    two calls bit-equal (no atomics)."""
    monkeypatch.setattr(flash_attention, "F32_ATTN_TILE_FORCE", tile)
    t = flash_attention.F32_ATTN_TILES.index(tile)
    for name, kernel, call, plain in _f32_loop_users(gen, S):
        if name == "#20 208/80" and t == 0:  # whole-depth stages beside 128 q' rows: > 227 KB
            with pytest.raises(ValueError, match="no tile"):
                call()
            continue
        before = kernel.launches
        got = call()
        assert kernel.launches == before + 1, name
        assert_close_f32(got, plain())
        assert torch.equal(got, call()), name


@pytest.mark.parametrize("S", [129, 581])
def test_f32_loop_tiles_are_bit_equal(gen, monkeypatch, no_tf32, S):
    """The tile changes neither the order of a score's FFMA chain (the depth
    in order, whatever its steps) nor P . V's (the keys in order): every
    tile an instance takes gives the same bits."""
    outs = {}
    for tile in flash_attention.F32_ATTN_TILES:
        monkeypatch.setattr(flash_attention, "F32_ATTN_TILE_FORCE", tile)
        gen.manual_seed(3)
        for name, _, call, _ in _f32_loop_users(gen, S):
            try:
                outs.setdefault(name, []).append(call())
            except ValueError:  # #20 at 208 deep takes no tile 0
                assert name == "#20 208/80" and tile == flash_attention.F32_ATTN_TILES[0]
    for name, got in outs.items():
        assert all(torch.equal(got[0], g) for g in got[1:]), name


@pytest.mark.parametrize("tile", linear.F32_TILES)
@pytest.mark.parametrize("with_res,B,heads,T,S,d,N", [
    (True, 2, 16, 16, 289, 80, 1280), (False, 2, 16, 16, 289, 80, 1280),
    (True, 2, 4, 3, 37, 80, 96), (False, 1, 2, 5, 70, 64, 132), (True, 1, 3, 2, 33, 8, 68)])
def test_proj_from_heads_kernel_float32(gen, monkeypatch, no_tf32, tile, with_res, B, heads, T,
                                        S, d, N):
    """#8's (with the residual) and #9's (without) fp32 instances, each with
    its own count: the window-17 shape of the main path (2, 16, 16, 289, 80)
    -> 1280, and ragged rows and widths (d 80, 64 and 8: 16-column k tiles
    that span two heads at d 8); each tile."""
    monkeypatch.setattr(linear, "F32_TILE_FORCE", tile)
    f32 = torch.float32
    x = rn(gen, B, heads, T, S, d, dtype=f32)
    w, b = rn(gen, N, heads * d, std=0.05, dtype=f32), rn(gen, N, std=0.1, dtype=f32)
    kernels = ((_cuda.PROJ_HEADS_RES_F32, _cuda.PROJ_HEADS_RES) if with_res
               else (_cuda.PROJ_HEADS_F32, _cuda.PROJ_HEADS))
    before = tuple(k.launches for k in kernels)
    res = rn(gen, B, T, S, N, dtype=f32) if with_res else None
    got = (linear.proj_from_heads_res(x, w, b, res) if with_res
           else linear.proj_from_heads(x, w, b))
    assert tuple(k.launches for k in kernels) == (before[0] + 1, before[1])
    assert_close_f32(got, linear.proj_from_heads_ref(x, w, b, res))


def test_fp32_route_kernels_are_deterministic_and_take_the_plain_vjp(gen, no_tf32):
    """No atomics: two calls of the fp32 #11 and #8 on the same inputs are
    bit-equal; a gradient through the fp32 #10 launches it once and is
    autograd's gradient of the plain version."""
    f32, H, heads, d = torch.float32, 17, 2, 80
    sel = flash_attention.make_rel_scatter(H, H, f32, torch.device("cuda"))
    qkv, rel = rn(gen, 1, 2, H * H, 3 * heads, d, dtype=f32), rn(gen, 1, 2, H * H, heads, 2 * H,
                                                               dtype=f32)
    assert torch.equal(flash_attention.flash_qkv_relpos_windows(qkv, rel, sel, 0.1, H, H),
                       flash_attention.flash_qkv_relpos_windows(qkv, rel, sel, 0.1, H, H))
    args = (rn(gen, 2, 4, 3, 37, 80, dtype=f32), rn(gen, 96, 320, std=0.05, dtype=f32),
            rn(gen, 96, dtype=f32), rn(gen, 2, 3, 37, 96, dtype=f32))
    assert torch.equal(linear.proj_from_heads_res(*args), linear.proj_from_heads_res(*args))
    N = H * H
    leaves = [rn(gen, 3, N, 64, std=0.2, dtype=f32), rn(gen, 3, N, 64, dtype=f32),
              rn(gen, 3, N, 64, dtype=f32), rn(gen, 3, N, 2 * H, dtype=f32)]
    leaves = [t.requires_grad_(True) for t in leaves]
    before = _cuda.ATTN_RELPOS_F32.launches
    out = flash_attention.flash_attention_relpos(*leaves, sel, H, H)
    assert _cuda.ATTN_RELPOS_F32.launches == before + 1
    g = rn(gen, *out.shape, dtype=f32)
    got = torch.autograd.grad(out, leaves, g)
    want = torch.autograd.grad(flash_attention.xla_attention_relpos(*leaves, sel), leaves, g)
    for a, b in zip(got, want):
        assert ((a - b).abs().max() / b.abs().max()).item() < 1e-5
