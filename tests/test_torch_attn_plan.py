"""The fp32 flash loop's tiles (`flash_attention.f32_attn_plan`,
csrc/attn_f32.cuh) and its order of sums, held on the CPU.

The plan's query tiles and the cp.async ring's key tiles and depth steps
cover every (query, key) pair and every column once; a ring stage or a v
buffer is written only after the step that reads it; every instance's
shared memory fits a block and is the size the .cuh states; a torch
emulation of the loop (its key tiles, its depth steps, its rescale once a
key tile, exp(x - m) as exp2 of the one-rounding x log2 e - m log2 e, and
for the edge windows the pad key first) matches the plain versions within 1e-6 and the JAX package's
`flash_qkv_packed_plain` (its CPU reference) and `flash_attention_fullk`
(its Pallas kernel in interpret mode) within 1e-5. The kernels themselves
run only on the card (tests/test_torch_kernels.py).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from camouflaged_vlm_tpu.ops import flash_attention as j_fa  # noqa: E402

from camouflaged_vlm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from camouflaged_vlm_tpu_torch.ops.compact_window import LPAD_LANE, NEG  # noqa: E402

N_SM = 132  # the H100's SMs
SRC = Path(fa.__file__).resolve().parent.parent / "csrc" / "attn_f32.cuh"
TILES = range(len(fa.F32_ATTN_TILES))
LENGTHS = (7, 64, 127, 128, 129, 196, 581, 1008, 4096)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
J = jnp.asarray

# (label, d_qk, dv, bias, rel lanes) of the loop's users at their paths' shapes
USERS = (("#16", 64, 64, "none", 0), ("#13", 80, 80, "sep", 28), ("#15", 80, 80, "edge", 0),
         ("#17", 80, 80, "sep", 128), ("#12", 80, 80, "sep", 32), ("#11", 80, 80, "sep", 34),
         ("#10", 64, 64, "sep", 28), ("#10", 64, 64, "sep", 128), ("#20", 208, 80, "none", 0),
         ("#20", 128, 64, "none", 0))


def _takes(dqk, dv, bias, lanes, tile):
    return fa.f32_attn_blocks_per_sm(dqk, dv, bias, tile, lanes) > 0


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("label,dqk,dv,bias,lanes", USERS[:3] + USERS[8:9])
def test_tiles_cover_every_pair_once(S, label, dqk, dv, bias, lanes):
    """Each (pair, query) in one block, each block's steps over every key
    once and, within a key tile, every column of the depth once in order;
    a block's idle warps are those wholly past S."""
    pairs = 3
    da = dqk + (32 if bias == "edge" else 0)
    for t in TILES:
        if not _takes(dqk, dv, bias, lanes, t):
            continue
        qt = fa.F32_ATTN_TILES[t][0]
        blocks = fa.f32_attn_blocks(S, pairs, t)
        rows = sorted((p, q) for p, q0, q1, _ in blocks for q in range(q0, q1))
        assert rows == [(p, q) for p in range(pairs) for q in range(S)]
        assert all(w == min(qt // 16, -(-(q1 - q0) // 16)) for _, q0, q1, w in blocks)
        steps = fa.f32_attn_steps(S, dqk, bias, t)
        keys = sorted({(j0, j1) for j0, j1, *_ in steps})
        assert [k for j0, j1 in keys for k in range(j0, j1)] == list(range(S))
        for j0, j1 in keys:
            cols = [(c0, c1) for a, b, c0, c1, *_ in steps if (a, b) == (j0, j1)]
            assert [c for c0, c1 in cols for c in range(c0, c1)] == list(range(da))
            assert all(c0 % 32 == 0 and (c1 - c0) % 4 == 0 for c0, c1 in cols)


@pytest.mark.parametrize("tile", TILES)
def test_ring_rewrites_a_buffer_only_after_it_is_read(tile):
    """Step t + KST - 1 is queued after step t's barrier, into the stage
    that step t - 1 read; a key tile's v goes with its first step into the
    buffer that the tile two before read at its last step, which has
    passed a barrier since."""
    kst = fa.F32_ATTN_STAGES[tile]
    for dqk, bias in ((64, "none"), (80, "sep"), (80, "edge"), (208, "none"), (128, "none")):
        steps = fa.f32_attn_steps(581, dqk, bias, tile)
        for t, (*_, stage, vbuf) in enumerate(steps):
            assert stage == t % kst
            if t >= kst:  # queued at step t - kst + 1: its stage was last read at t - kst
                assert steps[t - kst][4] == stage
        firsts = [t for t, st in enumerate(steps) if st[2] == 0]
        lasts = [t for t, st in enumerate(steps) if st[3] == steps[-1][3]]
        for kt, t in enumerate(firsts):
            queued = t - (kst - 1)  # the loop step whose barrier it follows
            if kt >= fa.F32_ATTN_VBUF:
                assert steps[t][5] == steps[firsts[kt - fa.F32_ATTN_VBUF]][5]
                assert lasts[kt - fa.F32_ATTN_VBUF] < queued


def _cuh_tables():
    src = SRC.read_text()
    cases = re.findall(r"case (\d+):\s*(?:if constexpr[^\n]*\n\s*)?return launch_tile<DQK, DV, "
                       r"BIAS, OUT, ATile<(\d+), (\d+), (\d+)>>", src)
    sizes = re.findall(r"//\s+(#\d+)\s+(\d+)/(\d+)\s+(none|sep|edge)\s+(\d+) lanes:\s+([-\d ]+)\n",
                       src)
    return src, cases, sizes


def test_tile_tables_match_the_kernel_source():
    """F32_ATTN_TILES and F32_ATTN_STAGES are launch_attn's `tile` cases in
    order; the key tile and v buffers are the source's."""
    src, cases, _ = _cuh_tables()
    assert [int(c) for c, *_ in cases] == list(TILES)
    assert [(int(q), int(d)) for _, q, d, _ in cases] == list(fa.F32_ATTN_TILES)
    assert [int(k) for *_, k in cases] == list(fa.F32_ATTN_STAGES)
    assert re.search(rf"constexpr int AK = {fa.F32_ATTN_KEYS};", src)
    assert re.search(rf"constexpr int VBUF = {fa.F32_ATTN_VBUF};", src)
    assert re.search(r"qts\[\] = \{(\d+), (\d+), (\d+)\}", src).groups() == tuple(
        str(q) for q, _ in fa.F32_ATTN_TILES)


def test_shared_memory_is_what_the_source_states():
    """Every instance at its path's lanes: the bytes of the .cuh's table,
    within the 227 KB a block can have (tile 0 at 208 deep: none)."""
    _, _, sizes = _cuh_tables()
    assert {(lab, int(a), int(b), bias, int(ln)) for lab, a, b, bias, ln, _ in sizes} == set(USERS)
    for lab, dqk, dv, bias, lanes, row in sizes:
        for t, want in zip(TILES, row.split()):
            got = fa.f32_attn_smem(int(dqk), int(dv), bias, t, int(lanes))
            if want == "-":
                assert got < 0 or got > fa.F32_ATTN_MAX_SMEM
                assert not _takes(int(dqk), int(dv), bias, int(lanes), t)
            else:
                assert got == int(want) <= fa.F32_ATTN_MAX_SMEM == 227 * 1024, (lab, t)


def test_lane_limit_fits_a_tile():
    """H + W up to F32_GLOBAL_MAX_LANES fits the 64-row, 32-deep tile at d 64
    and 80 (tile 2); the plan never picks a tile that does not fit."""
    for d in (64, 80):
        tile = fa.f32_attn_plan(d, d, "sep", 4096, 2, fa.F32_GLOBAL_MAX_LANES, N_SM)
        assert _takes(d, d, "sep", fa.F32_GLOBAL_MAX_LANES, tile)
        assert fa.f32_attn_smem(d, d, "sep", 2, fa.F32_GLOBAL_MAX_LANES) <= fa.F32_ATTN_MAX_SMEM


@pytest.mark.parametrize("label,dqk,dv,bias,lanes", USERS)
def test_plan_picks_a_tile_that_fits(monkeypatch, label, dqk, dv, bias, lanes):
    for S in LENGTHS:
        for pairs in (1, 32, 128, 512):
            assert _takes(dqk, dv, bias, lanes, fa.f32_attn_plan(dqk, dv, bias, S, pairs, lanes,
                                                                 N_SM))
    for t, tile in zip(TILES, fa.F32_ATTN_TILES):  # the override: forced, or refused
        monkeypatch.setattr(fa, "F32_ATTN_TILE_FORCE", tile)
        if _takes(dqk, dv, bias, lanes, t):
            assert fa.f32_attn_plan(dqk, dv, bias, 581, 32, lanes, N_SM) == t
        else:
            with pytest.raises(ValueError, match="no tile"):
                fa.f32_attn_plan(dqk, dv, bias, 581, 32, lanes, N_SM)


def test_plan_at_the_paths_shapes():
    """#20 at 'aug_flash' (208 deep) takes 128 q' rows with 32-deep k'
    stages; the path's other users fit at least one block of 8 warps an SM
    (wave quantisation aside)."""
    assert fa.f32_attn_plan(208, 80, "none", 4096, 32, 0, N_SM) == 1
    assert fa.f32_attn_plan(208, 80, "none", 4096, 16, 0, N_SM) == 1
    for label, dqk, dv, bias, lanes in USERS:
        t = fa.f32_attn_plan(dqk, dv, bias, 581, 128, lanes, N_SM)
        bps = fa.f32_attn_blocks_per_sm(dqk, dv, bias, t, lanes)
        assert bps * fa.F32_ATTN_TILES[t][0] // 16 >= fa.F32_ATTN_FULL_WARPS, label


# ------------------------------------------------ the loop's order of sums


def emulate(q, k, v, scale, tile, sep=None, edge=None):
    """csrc/attn_f32.cuh's loop on (P, S, d) rows in fp32: q scaled; per
    64-key tile the scores one FFMA chain over the depth, in order; the
    bias (sep: rel (P, S, H + W), H, W; edge: rel (P, S, 32), sel (P, 32,
    S), kmask (P, S), vb (P, dv)); keys past S at -inf; the running max m',
    ml = m' log2 e rounded, the rescale alpha = exp2(fma(m, log2 e, -ml)), p
    = exp2(fma(s, log2 e, -ml)) (the product exact, one rounding), l and o
    once a key tile; edge: the pad key (logit rel lane 28, value vb) first;
    o * (1 / l) at the end."""
    f32, log2e = torch.float32, torch.tensor(math.log2(math.e), dtype=torch.float32)

    def exp2_fma(x, ml):  # exp2f(fmaf(x, log2 e, -ml))
        return torch.exp2((x.double() * log2e.double() - ml.double()).to(f32))

    P, S, dqk = q.shape
    qs = q * torch.tensor(scale, dtype=f32)
    kk = k
    if edge is not None:
        rel, sel, kmask, vb = edge
        qs = torch.cat([qs, rel], -1)
        kk = torch.cat([k, sel.transpose(1, 2)], -1)
    da = qs.shape[-1]
    kd = fa.F32_ATTN_TILES[tile][1] or da
    m = torch.full((P, S, 1), -math.inf, dtype=f32)
    l = torch.zeros((P, S, 1), dtype=f32)
    o = torch.zeros((P, S, v.shape[-1]), dtype=f32)
    if edge is not None:
        m = rel[..., LPAD_LANE:LPAD_LANE + 1].clone()
        l = torch.ones_like(l)
        o = vb[:, None].expand_as(o).clone()
    if sep is not None:
        rel, H, W = sep
    for j0 in range(0, S, 64):
        j1 = min(j0 + 64, S)
        s = torch.zeros((P, S, 64), dtype=f32)
        for c0 in range(0, da, kd):  # the depth steps; in each, one FFMA chain in depth order
            for c in range(c0, min(da, c0 + kd)):
                s[..., :j1 - j0] = (s[..., :j1 - j0].double() + qs[..., c, None].double()
                                    * kk[:, None, j0:j1, c].double()).to(f32)
        key = torch.arange(j0, j0 + 64)
        valid = key < S
        if sep is not None:
            kc = key.clamp(max=S - 1)
            s = s + torch.where(valid, rel[..., kc // W] + rel[..., H + kc % W],
                                torch.zeros((), dtype=f32))
        if edge is not None:
            s[..., :j1 - j0] += kmask[:, j0:j1][:, None]
        s = torch.where(valid, s, torch.full((), -math.inf, dtype=f32))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        ml = mn * log2e
        alpha, p = exp2_fma(m, ml), exp2_fma(s, ml)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p[..., :j1 - j0] @ v[:, j0:j1]
        m = mn
    return o * (1.0 / l)


def _rel_error(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _heads(qkv, heads, d):
    """(B, S, 3 heads d) -> q, k, v as (B heads, S, d)"""
    B, S, _ = qkv.shape
    r = qkv.reshape(B, S, 3, heads, d).permute(2, 0, 3, 1, 4)
    return [t.reshape(B * heads, S, d) for t in r]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("S", [7, 129, 200])
def test_emulation_matches_plain_packed(rng, tile, S):
    """#16 (no bias) and #17 (the separable bias, H x W = S) on the packed
    rows, d-major out."""
    heads, d = 2, 64
    qkv = T(rng.standard_normal((2, S, 3 * heads * d)).astype(np.float32))
    q, k, v = _heads(qkv, heads, d)
    got = emulate(q, k, v, d ** -0.5, tile)
    want = fa.flash_qkv_packed_plain_ref(qkv, d ** -0.5, heads, d)
    got = got.reshape(2, heads, S, d).transpose(2, 3).reshape(2, heads * d, S)
    assert _rel_error(got, want) < 1e-6
    H, W = {7: (1, 7), 129: (3, 43), 200: (10, 20)}[S]
    rel = T(rng.standard_normal((S, 2, heads, H + W)).astype(np.float32))
    sel = fa.make_rel_scatter(H, W)
    want = fa.flash_qkv_packed_global_ref(qkv, rel, sel, d ** -0.5, heads, d)
    got = emulate(q, k, v, d ** -0.5, tile,
                  sep=(rel.permute(1, 2, 0, 3).reshape(2 * heads, S, H + W), H, W))
    got = got.reshape(2, heads, S, d).transpose(2, 3).reshape(2, heads * d, S)
    assert _rel_error(got, want) < 1e-6


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("R", [30, 112, 150])
def test_emulation_matches_plain_edge(rng, tile, R):
    """#15: the 32-lane bias riding the scores, dummy keys of -1e30, the pad
    key first (a dummy row's pad logit -1e30 too)."""
    B, n, heads, d = 2, 3, 2, 80
    f = lambda *s: T(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    qkv, rel = f(B, n, R, 3 * heads * d), f(B, n, R, heads, 32)
    rel[:, :, R - 3:, :, LPAD_LANE] = NEG
    sel = T((rng.random((n, 32, R)) > 0.8).astype(np.float32))
    kmask = T(np.where(rng.random((n, 1, R)) > 0.2, 0.0, NEG).astype(np.float32))
    kmask[..., 0] = 0.0
    vb = f(heads, d)
    args = (qkv, rel.reshape(B, n, R, heads * 32), sel, vb, kmask, d ** -0.5, heads, d)
    want = fa.flash_qkv_packed_edge_ref(*args)
    q, k, v = _heads(qkv.reshape(B * n, R, -1), heads, d)  # (B n heads, R, d)
    P = B * n * heads
    w = torch.arange(B * n).repeat_interleave(heads) % n  # each problem's window
    relp = rel.permute(0, 1, 3, 2, 4).reshape(P, R, 32)
    got = emulate(q, k, v, d ** -0.5, tile,
                  edge=(relp, sel[w], kmask[w, 0], vb.repeat(B * n, 1)))
    got = got.reshape(B, n, heads, R, d).transpose(3, 4).reshape(B, n, heads * d, R)
    assert _rel_error(got, want) < 1e-6


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("N,dqk,dv", [(100, 208, 80), (256, 128, 64)])
def test_emulation_matches_plain_fullk_and_relpos(rng, tile, N, dqk, dv):
    """#20 (split q', k', v, scale 1; 208 deep: seven depth steps, the last
    16 columns) and #10 (split rows, the separable bias)."""
    f = lambda *s, sc=1.0: T((sc * rng.standard_normal(s)).astype(np.float32))  # noqa: E731
    q, k, v = f(3, N, dqk, sc=dqk ** -0.5), f(3, N, dqk), f(3, N, dv)
    assert _rel_error(emulate(q, k, v, 1.0, tile), fa.flash_attention_fullk_ref(q, k, v)) < 1e-6
    H, W = {100: (10, 10), 256: (16, 16)}[N]
    q, k, v, rel = f(3, N, 64, sc=0.125), f(3, N, 64), f(3, N, 64), f(3, N, H + W)
    want = fa.xla_attention_relpos(q, k, v, rel, fa.make_rel_scatter(H, W))
    assert _rel_error(emulate(q, k, v, 1.0, tile, sep=(rel, H, W)), want) < 1e-6


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    orig = j_fa.pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*args, **kw)

    monkeypatch.setattr(j_fa.pl, "pallas_call", interp)


@pytest.mark.parametrize("tile", TILES)
def test_emulation_matches_jax(rng, interpret, tile):
    """The JAX package's #16 (`flash_qkv_packed_plain`, its CPU reference)
    and #20 (`flash_attention_fullk`, its Pallas kernel in interpret mode)."""
    heads, d, S = 2, 64, 75
    qkv = rng.standard_normal((2, S, 3 * heads * d)).astype(np.float32)
    want = np.asarray(j_fa.flash_qkv_packed_plain(J(qkv), d ** -0.5, heads, d))
    q, k, v = _heads(T(qkv), heads, d)
    got = emulate(q, k, v, d ** -0.5, tile)
    got = got.reshape(2, heads, S, d).transpose(2, 3).reshape(2, heads * d, S)
    assert _rel_error(got, T(want)) < 1e-5
    q = (rng.standard_normal((2, 256, 208)) * 208 ** -0.5).astype(np.float32)
    k, v = (rng.standard_normal((2, 256, n)).astype(np.float32) for n in (208, 80))
    want = np.asarray(j_fa.flash_attention_fullk(J(q), J(k), J(v), block_q=128))
    assert _rel_error(emulate(T(q), T(k), T(v), 1.0, tile), T(want)) < 1e-5
