"""The attention backward kernels' algorithm (`csrc/attn_bwd.cu`, TPU kernels
#14 and #18, and their fp32 instances, `csrc/attn_bwd_f32.cu`) and the
host-side planning around them, on the CPU.

The kernels run only on the card; here their algorithm is emulated in torch,
in the working types: the query pass's online row statistics over 64-key
tiles in log2 units (max, sum, t = sum P dP), then dS = bf16(P (dP - t)),
dq and drel per tile; the key pass's P and dS rebuilt from those statistics,
dv = bf16(P)^T g and dk = dS^T q; drel through the key code, or by the W = 64
rule of the register path. That emulation is held to the JAX package's VJP
of `flash_qkv_packed_windows_s` and `flash_qkv_packed_global` in bf16, with
the card's kernel gate (max|d| / max|ref| and mean|d| / mean|ref| below
1e-2: bf16 rounds each output once, 2^-8 relative, and summation orders
differ), and to the port's plain backward, which the card holds the kernels
to. No rounding point moves against the plain backward: the emulation
rounds where it rounds. The W = 64 drel rule is held equal to dS . sel^T.
The wrapper's scratch (lane width, tiles, sizes) is checked here too.

In float32 the fp32 instances' algorithm is emulated too (each row's max
and sum online over 128-key tiles from S alone, t = sum g o from the
forward's output, P and dS per 128-key tile and 32-query step, dS^T kept
for dq over 64-key steps, drel walked in key order) with no rounding point,
and held to the JAX package's fp32 VJP and to the port's plain fp32
backward within 1e-5: only the order of fp32 sums differs. The kernels'
shared memory (`_cuda.attn_bwd_f32_smem`) is checked against the H100's
limit here too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from camouflaged_vlm_tpu.ops import flash_attention as j_fa  # noqa: E402

from camouflaged_vlm_tpu_torch.ops import _cuda  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from camouflaged_vlm_tpu_torch.ops.compact_window import REL_LANES  # noqa: E402

LOG2E = 1.4426950408889634
GATE = 1e-2  # the card's kernel gate (chip_smoke.KERNEL_REL_BOUND)
F32_GATE = 1e-5  # fp32 against fp32: summation order alone
BF = torch.bfloat16


def rel_err(got, want):
    """max|d| / max|ref| and mean|d| / mean|ref|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    return d.max() / np.abs(want).max(), d.mean() / np.abs(want).mean()


def kernel_bwd_emulation(qkv, rel, g, scale, heads, d, H, W):
    """csrc/attn_bwd.cu's backward in torch: qkv (BB, N, 3 heads d), rel (N,
    BB, heads, L), g (BB, heads d, N), bf16 -> (dqkv, drel) in bf16. fp32
    arithmetic on the bf16 values; the biased scores [q*scale | rel] .
    [k | code]^T (the register path adds the same two bf16 lanes in fp32).
    Past 128 lanes the wide path's key tiles: 64 keys of one line of the
    grid's longer side, chunk by chunk, and its drel rule."""
    BB, N, _ = qkv.shape
    L = rel.shape[-1]
    lpc = fa.attn_bwd_lanes(L)
    reg = W == fa.ATTN_BWD_TILE and L == H + W and lpc == 128  # csrc/attn_bwd.cu ab_reg
    r = qkv.float().reshape(BB, N, 3, heads, d)
    q, k, v = (r[:, :, i].transpose(1, 2) for i in range(3))  # (BB, heads, N, d)
    qs = (q * torch.tensor(scale, dtype=BF).float()).to(BF).float()
    relh = rel.float().permute(1, 2, 0, 3)  # (BB, heads, N, L)
    gr = g.float().reshape(BB, heads, d, N).transpose(-1, -2)
    code = fa.rel_code(H, W, lpc).float()[:, :L]  # (N, L)
    if lpc > 128:  # the wide path: key tiles along the grid's lines, c major
        lay = fa.attn_bwd_wide_layout(H, W)
        tiles = [torch.tensor([lay.key(b, a) for a in range(64 * c, min(64 * c + 64, lay.nA))])
                 for c in range(lay.nc) for b in range(lay.nB)]
    else:
        tiles = [slice(t, min(t + fa.ATTN_BWD_TILE, N)) for t in range(0, N, fa.ATTN_BWD_TILE)]

    def scores(ks):  # biased scores against key slice ks, log2 units; and dP
        s = qs @ k[..., ks, :].transpose(-1, -2) + relh @ code[ks].T
        return s * LOG2E, gr @ v[..., ks, :].transpose(-1, -2)

    # the query pass, sweep 1: the rows' max, sum and t, online over the tiles
    m = torch.full((BB, heads, N), -float("inf"))
    l, t = torch.zeros(BB, heads, N), torch.zeros(BB, heads, N)
    for ks in tiles:
        s, dp = scores(ks)
        mn = torch.maximum(m, s.amax(-1))
        corr, p = torch.exp2(m - mn), torch.exp2(s - mn[..., None])
        l, t, m = l * corr + p.sum(-1), t * corr + (p * dp).sum(-1), mn
    inv = 1.0 / l
    t = t * inv

    def p_ds(ks):  # P (fp32) and dS (its bf16 values) of key slice ks
        s, dp = scores(ks)
        p = torch.exp2(s - m[..., None]) * inv[..., None]
        return p, (p * (dp - t[..., None])).to(BF).float()

    # sweep 2: dq and drel; the key pass: dk and dv from the same statistics
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(q), torch.zeros_like(q)
    dS = torch.zeros(BB, heads, N, N)
    for ks in tiles:
        p, ds = p_ds(ks)
        dq += ds @ k[..., ks, :]
        dS[..., ks] = ds
        dv[..., ks, :] = p.to(BF).float().transpose(-1, -2) @ gr
        dk[..., ks, :] = ds.transpose(-1, -2) @ q
    drel = (fa.drel_w64_ref(dS, H) if reg else fa.drel_wide_ref(dS, H, W) if lpc > 128
            else dS @ code)

    def rows(a):
        return a.transpose(1, 2).reshape(BB, N, heads * d)

    dqkv = torch.cat([rows(dq * scale), rows(dk * scale), rows(dv)], -1).to(BF)
    return dqkv, drel.permute(2, 0, 1, 3).to(BF)


def kernel_bwd_emulation_f32(qkv, rel, g, scale, heads, d, H, W):
    """csrc/attn_bwd_f32.cu's backward in torch, all fp32: qkv (BB, N, 3
    heads d), rel (N, BB, heads, L), g (BB, heads d, N) -> (dqkv, drel).
    Scores s = scale * (q . k) + bias. The stats kernel: each row's max and
    sum online over 128-key tiles of S alone (natural units, keys past N
    absent), t = sum_c g o from the forward's output (here the plain fp32
    forward's). The key kernel: per 128-key tile and 32-query step, P =
    exp(s - m) / sum and dS = P (dP - t); dv = P^T g and dk = scale * dS^T q
    summed step after step; dS kept.
    The query kernel: dq = scale * dS k over 64-key steps; drel walked in key
    order, rel_h lane kh the sum of grid row kh, rel_w lane kw summed over
    the grid rows in order, lanes past H + W zero."""
    BB, N, _ = qkv.shape
    L = rel.shape[-1]
    tile, kstep, qstep = (_cuda.ATTN_BWD_F32_TILE, _cuda.ATTN_BWD_F32_KEY_STEP,
                          _cuda.ATTN_BWD_F32_QUERY_STEP)
    r = qkv.reshape(BB, N, 3, heads, d)
    q, k, v = (r[:, :, i].transpose(1, 2) for i in range(3))  # (BB, heads, N, d)
    relh = rel.permute(1, 2, 0, 3)  # (BB, heads, N, L)
    gr = g.reshape(BB, heads, d, N).transpose(-1, -2)
    code = fa.make_rel_scatter(H, W).T  # (N, H + W): key k's lanes k // W and H + k % W
    s = scale * (q @ k.transpose(-1, -2)) + relh[..., :H + W] @ code.T  # biased scores
    o = torch.softmax(s, -1) @ v  # the forward's output
    t = (gr * o).sum(-1)

    def tiles(n):
        return [slice(a, min(a + n, N)) for a in range(0, N, n)]

    m = torch.full((BB, heads, N), -float("inf"))
    l = torch.zeros(BB, heads, N)
    for ks in tiles(tile):
        mn = torch.maximum(m, s[..., ks].amax(-1))
        l, m = l * torch.exp(m - mn) + torch.exp(s[..., ks] - mn[..., None]).sum(-1), mn
    inv = 1.0 / l
    dk, dv, dS = torch.zeros_like(q), torch.zeros_like(q), torch.zeros_like(s)
    for ks in tiles(tile):
        for qr in tiles(kstep):
            p = torch.exp(s[..., qr, ks] - m[..., qr, None]) * inv[..., qr, None]
            ds = p * (gr[..., qr, :] @ v[..., ks, :].transpose(-1, -2) - t[..., qr, None])
            dv[..., ks, :] += p.transpose(-1, -2) @ gr[..., qr, :]
            dk[..., ks, :] += ds.transpose(-1, -2) @ q[..., qr, :]
            dS[..., qr, ks] = ds
    dq = torch.zeros_like(q)
    for ks in tiles(qstep):
        dq += dS[..., ks] @ k[..., ks, :]
    rows = dS.reshape(BB, heads, N, H, W)
    drel = torch.zeros(BB, heads, N, L)
    drel[..., :H] = rows.sum(-1)
    for kh in range(H):
        drel[..., H:H + W] += rows[..., kh, :]

    def cat_rows(a):
        return a.transpose(1, 2).reshape(BB, N, heads * d)

    dqkv = torch.cat([cat_rows(dq * scale), cat_rows(dk * scale), cat_rows(dv)], -1)
    return dqkv, drel.permute(2, 0, 1, 3)


def _draw(rng, dtype, *shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return a.astype(jnp.bfloat16) if dtype == BF else a


def _bf16(rng, *shape, scale=1.0):
    return _draw(rng, BF, *shape, scale=scale)


def _t(a, dtype=BF):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _check(got, want, port, gate=GATE):
    for gt, wt, pt in zip(got, want, port):
        assert gt.shape == tuple(wt.shape) == pt.shape
        for ref in (np.asarray(wt, np.float32), pt.float().numpy()):
            max_rel, mean_rel = rel_err(gt.float().numpy(), ref)
            assert max_rel < gate and mean_rel < gate, (max_rel, mean_rel)


F32 = torch.float32
JNP = {BF: jnp.bfloat16, F32: jnp.float32}


def _emulate(dtype, *args):
    """The kernel's algorithm in `dtype`: csrc/attn_bwd.cu's in bf16, its fp32
    instance's in float32."""
    return (kernel_bwd_emulation if dtype == BF else kernel_bwd_emulation_f32)(*args)


@pytest.mark.parametrize("win,dtype", [pytest.param(9, BF, id="9"), pytest.param(14, BF, id="14"),
                                       pytest.param(9, F32, id="9-float32"),
                                       pytest.param(14, F32, id="14-float32")])
def test_windows_bwd_emulation_matches_jax_vjp(rng, win, dtype):
    """#14's shapes at 81 keys (a ragged second tile; in fp32 18 live lanes of
    32, the others' drel exactly zero) and ViT-H's 196 (four tiles, the last
    of 4 keys), narrow: 2 windows, 2 heads x 16."""
    BW, heads, d = 2, 2, 16
    S = win * win
    qkv = _draw(rng, dtype, BW, S, 3 * heads * d)
    rel = _draw(rng, dtype, S, BW, heads * REL_LANES, scale=0.5)
    gy = _draw(rng, dtype, BW, heads * d, S)
    sel32 = fa.make_rel_scatter32(win)
    scale = d ** -0.5
    _, pull = jax.vjp(lambda a, b: j_fa.flash_qkv_packed_windows_s(
        a, b, jnp.asarray(sel32.numpy(), JNP[dtype]), scale, heads, d), qkv, rel)
    want = pull(jnp.asarray(gy))
    args = (_t(qkv, dtype), _t(rel, dtype))
    got = _emulate(dtype, args[0], args[1].reshape(S, BW, heads, REL_LANES), _t(gy, dtype),
                   scale, heads, d, win, win)
    got = (got[0], got[1].reshape(S, BW, heads * REL_LANES))
    port = fa.flash_qkv_packed_windows_s_bwd_ref(*args, sel32.to(dtype), _t(gy, dtype), scale,
                                                 heads, d)
    if dtype == F32:
        assert not got[1].reshape(S, BW, heads, REL_LANES)[..., 2 * win:].any()
    _check(got, want, port, GATE if dtype == BF else F32_GATE)


@pytest.mark.parametrize("H,W,dtype", [pytest.param(2, 64, BF, id="2-64"),
                                       pytest.param(10, 10, BF, id="10-10"),
                                       pytest.param(2, 64, F32, id="2-64-float32"),
                                       pytest.param(10, 10, F32, id="10-10-float32"),
                                       pytest.param(3, 50, F32, id="3-50-float32"),
                                       pytest.param(2, 130, F32, id="2-130-float32"),
                                       pytest.param(5, 130, BF, id="5-130"),
                                       pytest.param(131, 3, BF, id="131-3")])
def test_global_bwd_emulation_matches_jax_vjp(rng, H, W, dtype):
    """#18 on a 2 x 64 grid (the bf16 register path's rule: a 64-key tile is
    a grid row) and on 10 x 10 (the general path, 20 lanes, a ragged tile);
    in bf16 past 128 lanes the wide path on 5 x 130 (rows are the lines,
    three chunks, the last of 2 keys) and 131 x 3 (columns are the lines,
    odd in count);
    in fp32 also on 3 x 50 (two 128-key tiles, grid row 2 across their
    boundary and across the query kernel's 64-key steps) and 2 x 130 (W >
    128: a rel_w slot a key, the rel_w sums in drel itself)."""
    B, heads, d = 1, 2, 16
    N = H * W
    qkv = _draw(rng, dtype, B, N, 3 * heads * d)
    rel = _draw(rng, dtype, N, B, heads, H + W, scale=0.5)
    gy = _draw(rng, dtype, B, heads * d, N)
    sel = fa.make_rel_scatter(H, W)
    scale = d ** -0.5
    _, pull = jax.vjp(lambda a, b: j_fa.flash_qkv_packed_global(
        a, b, jnp.asarray(sel.numpy(), JNP[dtype]), scale, heads, d, H, W), qkv, rel)
    want = pull(jnp.asarray(gy))
    got = _emulate(dtype, _t(qkv, dtype), _t(rel, dtype), _t(gy, dtype), scale, heads, d, H, W)
    port = fa.flash_qkv_packed_global_bwd_ref(_t(qkv, dtype), _t(rel, dtype), sel.to(dtype),
                                              _t(gy, dtype), scale, heads, d)
    _check(got, want, port, GATE if dtype == BF else F32_GATE)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_global_bwd_ref_by_query_chunks(rng, dtype):
    """The plain backward a block of queries at a time (the card tests' at
    the largest grids) is the whole one's: dq and drel row by row, dk and dv
    summed over the blocks; a chunk that leaves a short last block."""
    B, heads, d, H, W = 2, 2, 16, 6, 11
    N = H * W
    qkv = _t(_draw(rng, dtype, B, N, 3 * heads * d), dtype)
    rel = _t(_draw(rng, dtype, N, B, heads, H + W, scale=0.5), dtype)
    gy = _t(_draw(rng, dtype, B, heads * d, N), dtype)
    args = (qkv, rel, fa.make_rel_scatter(H, W).to(dtype), gy, d ** -0.5, heads, d)
    for got, want in zip(fa.flash_qkv_packed_global_bwd_ref_chunked(*args, chunk=16),
                         fa.flash_qkv_packed_global_bwd_ref(*args)):
        if dtype == F32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        else:  # the same fp32 values, rounded once to bf16: at most one bf16 step apart
            torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("H,W", [(14, 14), (64, 64), (2, fa.F32_GLOBAL_BWD_MAX_LANES - 2),
                                 (fa.F32_GLOBAL_BWD_MAX_LANES - 128, 128)])
def test_attn_bwd_f32_smem_within_the_h100_limit(d, H, W):
    """Each of csrc/attn_bwd_f32.cu's three kernels stays within the 232,448
    B of dynamic shared memory a block may have, at the windows' 14 + 14
    lanes, the grid's 64 + 64 and at the lane limit (W > 128 and W = 128):
    the sizes do not grow with the lanes, the rel slots of a key tile are
    at most 130, and the query kernel sums rel_w in registers at W = 64 and
    in shared memory only up to 128 lanes."""
    assert H + W <= fa.F32_GLOBAL_BWD_MAX_LANES == fa.F32_GLOBAL_MAX_LANES
    got = _cuda.attn_bwd_f32_smem(d, W)
    assert got == {**_cuda.attn_bwd_f32_smem(d, 1), "rel_w": got["rel_w"]}
    assert got["rel_w"] == ("registers" if W == 64 else "shared" if W <= 128 else "drel")
    for kernel in ("stats", "key", "query"):
        assert 0 < got[kernel] <= _cuda.SMEM_MAX
    if d == 80:  # the sizes the source's header states
        assert (got["stats"], got["key"], got["query"]) == (197120, 198416, 178176)


@pytest.mark.parametrize("BB,heads,N,chunk", [(32, 16, 196, 512), (2, 16, 4096, 8),
                                              (1, 16, 4096, 8), (1, 2, 100, 2)])
def test_attn_bwd_f32_scratch(BB, heads, N, chunk):
    """The fp32 backward's scratch: four statistics a row, g as rows, and
    dS^T of as many (problem, head) pairs as fit in F32_BWD_SCRATCH_BYTES
    (512 MiB: 8 of the global blocks' 4096 x 4096, every window pair at
    batch 2), NP = N rounded up to 128."""
    stats, gt, dst, got = fa.attn_bwd_f32_scratch(BB, heads, N, 80, device="meta")
    NP = -(-N // 128) * 128
    assert got == chunk and stats.shape == (BB * heads, N, 4) and dst.shape == (chunk, NP, NP)
    assert gt.shape == (BB * heads, N, 80)
    assert dst.numel() * 4 <= max(fa.F32_BWD_SCRATCH_BYTES, NP * NP * 4)


@pytest.mark.parametrize("H", [1, 3, 64])
def test_drel_w64_rule_equals_the_scatter_product(rng, H):
    """On an H x 64 grid, rel_h lane kh gets the row sums of dS over key tile
    kh and the rel_w lanes the tiles themselves: exactly dS . sel^T."""
    dS = torch.from_numpy(rng.standard_normal((2, 5, H * 64)).astype(np.float32)).to(BF).float()
    want = dS @ fa.make_rel_scatter(H, 64).T
    torch.testing.assert_close(fa.drel_w64_ref(dS, H), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("H,W,L,d,lpc", [
    (14, 14, 32, 80, 32),     # ViT-H's interior windows (#14)
    (16, 16, 32, 128, 32),    # the largest window the 32 packed lanes take
    (64, 64, 128, 80, 128),   # ViT-H's global blocks (#18)
    (8, 64, 72, 16, 128),
    (64, 32, 96, 64, 128),
    (10, 10, 20, 32, 32),
    (50, 50, 100, 80, 128),   # the narrow paths' last lanes
    (80, 80, 160, 80, 256),   # 1280-px images: the wide path
    (96, 30, 126, 80, 128),
    (130, 7, 137, 16, 256),
    (256, 256, 512, 80, 512),  # up to GLOBAL_BWD_MAX_LANES
])
def test_attn_bwd_scratch(H, W, L, d, lpc):
    """The scratch the wrapper hands `cvlm_attn_bwd`: the lanes padded to 32
    or a multiple of 128, an even number of 64-row tiles covering N, aux
    tiles of [q*scale | lanes | g | q | k | v] columns (the wide path: query
    tiles of [q*scale | rel_A | rel_B | g | q], then the key tiles [k | v]),
    four statistics a row, the code tiles (the wide path's 16)."""
    BB, heads, N = 2, 3, H * W
    qkv = torch.zeros(BB, N, 3 * heads * d, dtype=BF, device="meta")  # sizes only
    got_lpc, ntp, aux, stats, code = fa.attn_bwd_scratch(qkv, BB, N, H, W, L, heads, d)
    assert code.is_meta
    code = fa.attn_bwd_scratch(torch.zeros(1, 1, 3 * d, dtype=BF), 1, N, H, W, L, 1, d)[4]
    assert got_lpc == fa.attn_bwd_lanes(L) == lpc and ntp == fa.attn_bwd_tiles(N)
    assert stats.shape == (BB * heads, ntp * 64, 4) and stats.dtype == torch.float32
    assert aux.dtype == code.dtype == BF
    if lpc <= 128:
        assert aux.shape == (BB, heads, ntp, (5 * d + lpc) // 8, 64, 8)
        assert code.shape == (ntp, lpc // 8, 64, 8)
        assert torch.equal(code, fa.row_tiles(fa.rel_code(H, W, lpc), ntp))
        return
    lay = fa.attn_bwd_wide_layout(H, W)
    assert (lay.nA, lay.nB) == (max(H, W), min(H, W)) and lay.nB <= 256
    cols = ntp * (3 * d // 8 + 8 * lay.nc + 2 * -(-lay.nB // 16)) + lay.nBe * lay.nc * d // 4
    assert aux.shape == (BB, heads, cols, 64, 8) == (BB, heads, lay.aux_columns(ntp, d), 64, 8)
    assert code.shape == (16, 10, 64, 8)
    assert torch.equal(code, fa.wide_code_tiles())


@pytest.mark.parametrize("L,lpc", [(20, 32), (32, 32), (33, 128), (128, 128), (129, 256),
                                   (160, 256), (384, 384), (400, 512), (512, 512)])
def test_attn_bwd_lanes(L, lpc):
    """The lanes padded to 32, or to a multiple of 128 up to
    GLOBAL_BWD_MAX_LANES, which is the fp32 backward's (512)."""
    assert fa.attn_bwd_lanes(L) == lpc
    assert fa.GLOBAL_BWD_MAX_LANES == fa.F32_GLOBAL_BWD_MAX_LANES == 512


def test_attn_bwd_lanes_refuse_past_512():
    with pytest.raises(ValueError, match="at most 512 rel lanes, got 513"):
        fa.attn_bwd_lanes(513)


@pytest.mark.parametrize("H,W", [(80, 80), (96, 96), (128, 128), (5, 130), (131, 3), (17, 300),
                                 (256, 256)])
def test_drel_wide_rule_equals_the_scatter_product(rng, H, W):
    """The wide path's drel: per key tile (64 keys of one line of the longer
    side) the shorter side's lane gets the tile's row sum and the longer
    side's 64 lanes the tile itself, summed over the lines: dS . sel^T."""
    dS = torch.from_numpy(rng.standard_normal((1, 3, H * W)).astype(np.float32)).to(BF).float()
    want = dS @ fa.make_rel_scatter(H, W).T
    torch.testing.assert_close(fa.drel_wide_ref(dS, H, W), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("H,W", [(80, 80), (5, 130), (131, 3)])
def test_wide_code_picks_a_keys_two_lanes(rng, H, W):
    """The wide key pass's bias chain: a key tile's [k | code j] against a
    query's [q*scale | rel_A chunk c | the 16 rel_B lanes around line b] adds
    exactly rel_A[64 c + r] + rel_B[b] to key r's score (j = b % 16)."""
    lay = fa.attn_bwd_wide_layout(H, W)
    code = fa.wide_code()
    assert code.shape == (16, 64, 80) and torch.equal(code.float().sum(-1), torch.full((16, 64), 2.))
    rel = torch.from_numpy(rng.standard_normal((H + W,)).astype(np.float32)).to(BF).float()
    relA = torch.nn.functional.pad(rel[lay.offA:lay.offA + lay.nA], (0, 64 * lay.nc - lay.nA))
    relB = torch.nn.functional.pad(rel[lay.offB:lay.offB + lay.nB], (0, 16 * -(-lay.nB // 16)))
    for b in (0, lay.nB - 1):
        for c in range(lay.nc):
            lanes = torch.cat([relA[64 * c:64 * c + 64], relB[16 * (b // 16):16 * (b // 16) + 16]])
            got = code[b % 16].float() @ lanes
            for r in range(min(64, lay.nA - 64 * c)):
                want = rel[lay.key(b, 64 * c + r) // W] + rel[H + lay.key(b, 64 * c + r) % W]
                assert got[r] == want


@pytest.mark.parametrize("H,W,lpc", [(14, 14, 32), (9, 7, 32), (64, 64, 128), (10, 10, 128),
                                     (80, 80, 256), (256, 256, 512)])
def test_rel_code_is_the_padded_scatter(H, W, lpc):
    code = fa.rel_code(H, W, lpc)
    assert code.shape == (H * W, lpc) and code.dtype == BF and code.is_contiguous()
    assert torch.equal(code[:, :H + W].float(), fa.make_rel_scatter(H, W).T)
    assert not code[:, H + W:].any()
    assert torch.equal(code.float().sum(-1), torch.full((H * W,), 2.0))


@pytest.mark.parametrize("rows,C", [(196, 32), (4096, 128), (63, 16), (100, 128)])
def test_row_tiles_layout(rows, C):
    """The backward kernels' scratch layout: 64-row tiles of 16-byte columns,
    an even number of tiles (a block takes two), rows past the end zero."""
    x = torch.arange(rows * C, dtype=torch.float32).reshape(rows, C)
    n = fa.attn_bwd_tiles(rows)
    t = fa.row_tiles(x, n)
    assert t.shape == (n, C // 8, 64, 8) and n % 2 == 0 and (n - 2) * 64 < rows <= n * 64
    assert t[(rows - 1) // 64, (C - 1) // 8, (rows - 1) % 64, 7] == x[rows - 1, C - 1]
    back = t.transpose(1, 2).reshape(n * 64, C)
    assert torch.equal(back[:rows], x) and not back[rows:].any()
