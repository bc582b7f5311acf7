"""The tile plan of the fp32 GEMM (`linear.f32_gemm_plan`, csrc/sgemm_f32.cuh)
at every shape its users take on the port's paths, held on the CPU: the
plan's blocks and each block's threads cover every output element exactly
once, a split tile's k slices partition K in order, and the flattened rows
of an MN-major A (proj_rows' groups tiled as one M) land on the element that
indexing of x gives. The kernels themselves run only on the card
(tests/test_torch_kernels.py)."""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from camouflaged_vlm_tpu_torch.ops import linear as lin  # noqa: E402

N_SM = 132  # the H100's SMs
SGEMM = Path(lin.__file__).resolve().parent.parent / "csrc" / "sgemm_f32.cuh"


def _mlp(M, K, H):
    """#4/#5 and #6: the H-wide (depth K) and K-wide (depth H) products of
    a row panel, and of the ragged last one."""
    rows = lin.mlp_panel_rows(M, H)
    last = M % rows or rows
    return [(rows, H, K, 1, False), (rows, K, H, 1, False), (last, H, K, 1, False),
            (last, K, H, 1, False)]


def _sites():
    """(label, M, N, K, groups, mn_groups) of every product the paths run:
    the cascade's at batch 1 and 2, MaPLe's at batch 8, the text tower's."""
    out = []
    for b in (1, 2):
        out += [(f"#1 patch embed b{b}", b * 4096, 1280, 768, 1, False),
                (f"#1 EVP embed b{b}", b * 4096, 40, 768, 1, False),
                (f"#2 CLIP b{b}", b * 581, 3072, 1024, 1, False),
                (f"#2 windows b{b}", b * 16 * 196, 3840, 1280, 1, False),
                (f"#2 edge b{b}", b * 1008, 3840, 1280, 1, False),
                (f"#3 global b{b}", b * 4096, 3840, 1280, 1, False),
                (f"#7 CLIP b{b}", 581, 1024, 1024, b, True),
                (f"#7 windows b{b}", 196, 1280, 1280, b * 16, True),
                (f"#7 edge b{b}", 112, 1280, 1280, b * 9, True),
                (f"#7 global b{b}", 4096, 1280, 1280, b, True),
                (f"#8/#9 window 17 b{b}", 16 * 289, 1280, 1280, b, False)]
        for site, M, K, H in (("CLIP", b * 581, 1024, 4096), ("windows", b * 3136, 1280, 5120),
                              ("edge", b * 1008, 1280, 5120), ("global", b * 4096, 1280, 5120)):
            out += [(f"#4/#5 #6 {site} b{b} {i}", *p) for i, p in enumerate(_mlp(M, K, H))]
    out += [("#2 MaPLe", 8 * 581, 3072, 1024, 1, False), ("#7 MaPLe", 581, 1024, 1024, 8, True)]
    for site, M, K, H in (("MaPLe vision", 8 * 581, 1024, 4096),
                          ("MaPLe text", 14 * 77, 768, 3072),
                          ("text camoprompts", 6 * 77, 768, 3072),
                          ("text 61 classes", 61 * 77, 768, 3072),
                          ("text imagenet80", 80 * 77, 768, 3072)):
        out += [(f"#4/#5 #6 {site} {i}", *p) for i, p in enumerate(_mlp(M, K, H))]
    return out


SITES = _sites()


def _partition(tiles, size, extent):
    """The [t * size, t * size + size) of t < tiles, cut at `extent`: each
    index of range(extent) exactly once, in order."""
    idx = [i for t in range(tiles) for i in range(t * size, min(t * size + size, extent))]
    return idx == list(range(extent))


def _check_plan(plan, M, N, K, groups, mn):
    gx, gy, gz = plan.grid
    assert (plan.bm, plan.bn) in lin.F32_TILES and 0 <= plan.tile < len(lin.F32_TILES)
    # the C rows the tiles cover: groups of `rows` rows (C row g rows + m),
    # or one flat M of all groups' rows
    assert plan.rows * plan.groups == M * groups and (plan.n, plan.k) == (N, K)
    assert plan.flat == (mn and groups > 1 and M % 4 == 0)
    assert gz == (1 if plan.flat else groups)
    assert _partition(gy, plan.bm, plan.rows) and _partition(gx, plan.bn, N)
    # no tile lies wholly past the outputs
    assert (gy - 1) * plan.bm < plan.rows and (gx - 1) * plan.bn < N
    # the launches' blocks: every tile once over all of K, or the split
    # tail's (each group's last tail_rows row tiles) once a slice, the
    # slices in order
    assert 1 <= plan.splits <= max(lin.F32_MAX_SPLITS, lin.F32_SPLIT_FORCE or 0)
    assert (plan.splits > 1) == (plan.tail_rows > 0) and plan.tail_rows <= gy
    assert plan.tail == gx * plan.tail_rows * gz * (plan.splits > 1)
    assert plan.ws_elems == plan.tail * plan.splits * plan.bm * plan.bn
    by_tile = {}
    for g, m0, n0, k0, k1 in lin.f32_blocks(plan):
        by_tile.setdefault((g, m0, n0), []).append((k0, k1))
    assert sorted(by_tile) == [(g, y * plan.bm, x * plan.bn) for g in range(gz)
                               for y in range(gy) for x in range(gx)]
    for (g, m0, n0), ks in by_tile.items():
        split = m0 >= (gy - plan.tail_rows) * plan.bm and plan.splits > 1
        assert ks == (plan.slices() if split else [(0, K)])
        assert [k for k0, k1 in ks for k in range(k0, k1)] == list(range(K))
        assert all(k0 % lin.F32_BK == 0 and k1 > k0 for k0, k1 in ks)


@pytest.mark.parametrize("label,M,N,K,groups,mn", SITES, ids=[s[0] for s in SITES])
def test_plan_covers_every_output_once(label, M, N, K, groups, mn):
    plan = lin.f32_gemm_plan(M, N, K, N_SM, groups, mn_groups=mn)
    _check_plan(plan, M, N, K, groups, mn)
    slots = N_SM * lin.F32_TILE_BLOCKS[(plan.bm, plan.bn)]
    if plan.tail and plan.tail < plan.tiles:  # a K-major A's split tail: the last
        # round's tiles, in one round
        assert not mn and plan.tiles % slots <= plan.tail and plan.tail * plan.splits <= slots
    elif plan.splits > 1 and mn:  # an MN-major A splits only a grid of one round
        assert plan.tiles <= slots
    assert len(plan.slices()) == plan.splits


@pytest.mark.parametrize("tile", lin.F32_TILES)
def test_block_threads_cover_their_tile_once(tile):
    bm, bn = tile
    out = lin.f32_thread_outputs(bm, bn)
    assert out.shape == (bm * bn // 64, 64, 2)
    flat = out[..., 0] * bn + out[..., 1]
    assert torch.equal(torch.sort(flat.flatten()).values, torch.arange(bm * bn))
    # each thread's 4-column groups start at a multiple of 4: one 16-byte store
    assert bool((out[:, ::4, 1] % 4 == 0).all())


def test_plan_tables_match_the_kernel_source():
    """F32_TILES is the order of launch_sgemm's `tile` cases, and
    F32_TILE_BLOCKS their MIN_BLOCKS; F32_BK its k tile; every tile in
    F32_TILE_RATE."""
    src = SGEMM.read_text()
    cases = re.findall(r"case (\d+):\s*return run_sgemm<Tile<(\d+), (\d+), \d+, (\d+)>", src)
    assert [(int(b), int(n)) for _, b, n, _ in cases] == list(lin.F32_TILES)
    assert [int(c) for c, _, _, _ in cases] == list(range(len(lin.F32_TILES)))
    assert {(int(b), int(n)): int(k) for _, b, n, k in cases} == lin.F32_TILE_BLOCKS
    assert re.search(rf"constexpr int BK = {lin.F32_BK};", src)
    assert set(lin.F32_TILE_RATE) == set(lin.F32_TILES)


@pytest.mark.parametrize("tile", lin.F32_TILES)
def test_plan_takes_a_forced_tile(monkeypatch, tile):
    monkeypatch.setattr(lin, "F32_TILE_FORCE", tile)
    for _, M, N, K, groups, mn in SITES[:12]:
        plan = lin.f32_gemm_plan(M, N, K, N_SM, groups, mn)
        assert (plan.bm, plan.bn) == tile
        _check_plan(plan, M, N, K, groups, mn)


@pytest.mark.parametrize("splits", [2, 3, 4, 7])
@pytest.mark.parametrize("M,N,K,groups,mn", [(581, 1024, 4096, 1, False), (37, 136, 200, 2, True),
                                             (100, 40, 768, 1, False), (70, 96, 24, 3, True),
                                             (4624, 1280, 1280, 2, False)])
def test_forced_splits_cut_every_tile_in_order(monkeypatch, splits, M, N, K, groups, mn):
    """Split K forced (the tests of the kernels): every tile's K cut into
    whole k tiles, at most `splits` non-empty slices, in order."""
    monkeypatch.setattr(lin, "F32_SPLIT_FORCE", splits)
    plan = lin.f32_gemm_plan(M, N, K, N_SM, groups, mn)
    nk = -(-K // lin.F32_BK)
    # the most slices, at most `splits`, that are all non-empty
    assert plan.splits == max(s for s in range(1, min(splits, nk) + 1)
                              if -(-nk // -(-nk // s)) == s)
    assert plan.tail == (plan.tiles if plan.splits > 1 else 0)
    _check_plan(plan, M, N, K, groups, mn)


@pytest.mark.parametrize("B,T,K,S", [(2, 16, 24, 196), (2, 9, 12, 112), (1, 2, 8, 36),
                                     (3, 1, 4, 581), (2, 2, 8, 70)])
def test_flat_rows_land_on_x(B, T, K, S):
    """x d-major as the attention wrappers give it (rows of a stride rounded
    up to 8, `dmajor_empty`): row m = g S + s of the flat A, column k, lies at
    k ldk + mn_row_offset(m, S, ldg) past x's start, x[g // T, g % T, k, s];
    a 16-byte chunk of rows m..m+3 (m % 4 == 0) is 4 consecutive elements of
    one group. A plan flattens only when S % 4 == 0."""
    plan = lin.f32_gemm_plan(S, 64, K, N_SM, B * T, mn_groups=True)
    assert plan.flat == (S % 4 == 0 and B * T > 1)
    x = lin.dmajor_empty(B, T, K, S, dtype=torch.float64, device="cpu")
    x.copy_(torch.arange(x.numel(), dtype=torch.float64).reshape(x.shape))
    ldk, ldg = lin._dmajor_strides("test", x)
    n = x.untyped_storage().nbytes() // x.element_size() - x.storage_offset()
    flat = torch.as_strided(x, (n,), (1,), x.storage_offset())
    if not plan.flat:
        return
    m = torch.arange(B * T * S)
    k = torch.arange(K)[:, None]
    off = torch.tensor([lin.mn_row_offset(int(i), S, ldg) for i in m])
    got = flat[k * ldk + off]  # (K, B T S)
    want = x.reshape(B * T, K, S).permute(1, 0, 2).reshape(K, B * T * S)
    assert torch.equal(got, want)
    chunk = off.reshape(-1, 4)
    assert torch.equal(chunk - chunk[:, :1], torch.arange(4).expand_as(chunk))
    assert lin.mn_row_offset(5, 0, 0) == 5  # no groups: row m at m


def test_proj_rows_flattens_only_rows_in_whole_chunks():
    for S, flat in ((196, True), (112, True), (4096, True), (581, False), (70, False)):
        assert lin.f32_gemm_plan(S, 1280, 1280, N_SM, 8, mn_groups=True).flat == flat
    # one group, or an A that is not MN-major: never
    assert not lin.f32_gemm_plan(4096, 1280, 1280, N_SM, 1, mn_groups=True).flat
    assert not lin.f32_gemm_plan(196, 1280, 1280, N_SM, 8).flat
