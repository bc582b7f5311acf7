"""The tile plan of the fp32 GEMM (`linear.f32_gemm_plan`, csrc/sgemm_f32.cuh)
at every shape its users take on the port's paths, held on the CPU: the
plan's blocks and each block's threads cover every output element exactly
once, a split tile's k slices partition K in order, and the flattened rows
of an MN-major A (proj_rows' groups tiled as one M) land on the element that
indexing of x gives. The kernels themselves run only on the card
(tests/test_torch_kernels.py)."""

import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from camouflaged_vlm_tpu_torch.ops import _cuda  # noqa: E402
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
    assert 0 <= plan.tile < len(lin.F32_TILES) + len(lin.F32_MN_TILES)
    assert lin.f32_tile(plan.tile)[:2] == (plan.bm, plan.bn)
    assert plan.tile < len(lin.F32_TILES) or plan.path == 1  # the MN tiles: path 1 only
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


# ------------------------------------------------- the LN-fed users' MN path
#
# #2, #3 and #4/#5 on path 1 (csrc/ln_linear_f32.cu, ln_mlp_residual_f32.cu):
# the LN rows written MN-major by ln_rows_t_f32_kernel, the MLP's hidden by
# fc1's EPI_ACT_T epilogue, both (K or H, mn_ld(rows)); the weights
# transposed into a scratch (transpose_f32_kernel); every output one sum
# over k in order.

LN_T_ROWS, LN_T_THREADS = 32, 256  # sgemm_f32.cuh LNT_ROWS, THREADS
CSRC = SGEMM.parent


def _ln_rows_t_writes(M, K, ld):
    """(flat index into xt, source row, source column) of every element
    ln_rows_t_f32_kernel writes: block b takes rows 32 b.., thread t loads
    row r = t / 8, columns k0 + 4 (t % 8) + i into tile[4 (t % 8) + i][r],
    then writes tile[r][4 (t % 8) + i] to xt[(k0 + r) ld + 32 b + 4 (t % 8)
    + i] where k0 + r < K and the chunk's first row < ld; rows >= M read
    as zero (source row -1)."""
    nb = -(-M // LN_T_ROWS)
    t = torch.arange(LN_T_THREADS)
    r, c = t // 8, t % 8
    b = torch.arange(nb)[:, None]
    idx, src_m, src_k = [], [], []
    for k0 in range(0, K, LN_T_ROWS):
        # the tile each block holds: tile[k][m] = (row, column) it was loaded from
        tm = torch.full((nb, LN_T_ROWS, LN_T_ROWS), -1)
        tk = torch.full((nb, LN_T_ROWS, LN_T_ROWS), -1)
        for i in range(4):
            m, kk = b * LN_T_ROWS + r, k0 + 4 * c + i
            ok = (m < M) & (kk < K)
            tm[:, 4 * c + i, r] = torch.where(ok, m, -1)
            tk[:, 4 * c + i, r] = torch.where(ok, kk.expand_as(m), -1)
        mo = b * LN_T_ROWS + 4 * c
        for i in range(4):
            ok = ((k0 + r < K) & (mo < ld)).expand(nb, -1)
            idx.append(((k0 + r) * ld + mo + i)[ok])
            src_m.append(tm[:, r, 4 * c + i][ok])
            src_k.append(tk[:, r, 4 * c + i][ok])
    return torch.cat(idx), torch.cat(src_m), torch.cat(src_k)


@pytest.mark.parametrize("K", [768, 1024, 1280])
@pytest.mark.parametrize("M", [1, 127, 128, 129, 581, 2016, 6272])
def test_mn_ln_scratch_covers_every_element_once(M, K):
    """The MN-major LN rows: every element of the (K, mn_ld(M)) scratch
    written once, element (k, m) from x's row m, column k (rows M.. of the
    last chunk zero)."""
    ld = lin.mn_ld(M)
    assert ld % 4 == 0 and M <= ld < M + 4
    idx, src_m, src_k = _ln_rows_t_writes(M, K, ld)
    assert torch.equal(torch.sort(idx).values, torch.arange(K * ld))
    k, m = idx // ld, idx % ld
    inside = m < M
    assert torch.equal(src_m[inside], m[inside]) and torch.equal(src_k[inside], k[inside])
    assert bool((src_m[~inside] == -1).all())


def _hidden_t_writes(plan, ldt, lim=None):
    """(n, m) of every element fc1's EPI_ACT_T writes to the hidden (H, ldt)
    in the first column tile of each row tile (the columns' partition is
    `_check_plan`'s): a whole tile's threads their 8 x 8 outputs, a 4-row
    chunk of a column when its first row < `lim` (ldt; #6's EPI_DACT_T
    M); a split tile's second pass each 4-row chunk of a column that starts
    below M (splitk_finish_kernel)."""
    lim = ldt if lim is None else lim
    thr = lin.f32_thread_outputs(plan.bm, plan.bn).reshape(-1, 2)
    blocks = [(m0, (k0, k1) != (0, plan.k)) for g, m0, n0, k0, k1 in lin.f32_blocks(plan)
              if n0 == 0]
    m0 = torch.tensor(sorted({m0 for m0, _ in blocks}))
    split = torch.tensor([any(s for b, s in blocks if b == int(m)) for m in m0])
    m, n = m0[:, None] + thr[None, :, 0], thr[None, :, 1].expand(len(m0), -1)
    ok = (n < plan.n) & torch.where(split[:, None], m - m % 4 < plan.rows, m - m % 4 < lim)
    return torch.stack([n[ok], m[ok]], 1)


@pytest.mark.parametrize("K", [768, 1024, 1280])
@pytest.mark.parametrize("M", [1, 127, 128, 129, 581, 2016, 6272])
def test_mn_hidden_covers_every_element_once(M, K):
    """fc1 of #4/#5 on the MN path at H = 4 K, at its plan and with its K
    cut in two: every hidden element (n, m < rows) of the row panel written
    once, nothing outside (H, mn_ld(rows))."""
    H, rows = 4 * K, lin.mlp_panel_rows(M, 4 * K)
    ldt = lin.mn_ld(rows)
    for splits in (None, 2):
        plan = lin._f32_gemm_plan(rows, H, K, N_SM, 1, False, None, splits, (1,))
        assert plan.path == 1
        w = _hidden_t_writes(plan, ldt)
        assert bool(((w[:, 0] < H) & (w[:, 1] < ldt)).all())
        inside = w[w[:, 1] < rows]
        flat = inside[:, 0] * rows + inside[:, 1]
        assert torch.equal(torch.sort(flat).values, torch.arange(min(H, plan.bn) * rows))


def _transpose_writes(R, C, ldt):
    """(flat index into wt, source row, source column) of every element
    transpose_f32_kernel writes: block (x, y) loads w[32 y + i][32 x + t %
    32] into tile[i][t % 32] (i = t / 32, + 8, ...), then writes tile[t %
    32][i], w's element (32 y + t % 32, 32 x + i), to wt[(32 x + i) ldt +
    32 y + t % 32], where both lie inside R x C."""
    y = torch.arange(-(-R // 32))[:, None, None, None]
    x = torch.arange(-(-C // 32))[None, :, None, None]
    i, t = torch.arange(32)[None, None, :, None], torch.arange(32)[None, None, None, :]
    r, c = torch.broadcast_tensors(32 * y + t, 32 * x + i)
    ok = (r < R) & (c < C)
    return (c * ldt + r)[ok], r[ok], c[ok]


@pytest.mark.parametrize("splits", [None, 2])
@pytest.mark.parametrize("M,K,H,scratch", [(127, 200, 264, None), (129, 200, 264, None),
                                           (581, 1024, 4096, None), (2016, 1280, 5120, None),
                                           (700, 128, 512, 300 * 512)])
def test_mn_bwd_scratches_cover_every_element_once(monkeypatch, splits, M, K, H, scratch):
    """#6 on the MN path, per row panel of `mlp_panel_rows` (the last one
    ragged, its scratches at the full panel's ld): g^T (K, ld) from
    transpose_f32_kernel and dh^T (H, ld), first dh_pre^T through EPI_ACT_T,
    then dh^T in its place through EPI_DACT_T at the same plan: each element
    of the panel's rows written once by each, nothing outside (K or H, ld),
    and EPI_DACT_T reads (res = C) only elements EPI_ACT_T wrote."""
    if scratch is not None:
        monkeypatch.setattr(lin, "MLP_SCRATCH_ELEMS", scratch)
    rows = lin.mlp_panel_rows(M, H)
    ld = lin.mn_ld(rows)
    plan = lin._f32_gemm_plan(rows, H, K, N_SM, 1, False, None, splits, (1,))
    assert plan.path == 1 and (scratch is None or rows < M)
    for m in sorted({rows, M - (-(-M // rows) - 1) * rows}):  # a full panel, the last
        idx, src_r, src_c = _transpose_writes(m, K, ld)
        assert bool((idx < K * ld).all())
        k, r = idx // ld, idx % ld
        assert torch.equal(torch.sort(k * m + r).values, torch.arange(K * m))
        assert torch.equal(src_r, r) and torch.equal(src_c, k)
        p = dataclasses.replace(plan, rows=m)  # the C entry runs every panel at one plan
        first, dact = _hidden_t_writes(p, ld), _hidden_t_writes(p, ld, lim=m)
        assert bool(((dact[:, 0] < H) & (dact[:, 1] < ld)).all())
        inside = dact[dact[:, 1] < m]
        flat = inside[:, 0] * m + inside[:, 1]
        assert torch.equal(torch.sort(flat).values, torch.arange(min(H, p.bn) * m))
        wrote = set(map(tuple, first.tolist()))
        assert all(tuple(e) in wrote for e in dact.tolist())


def test_plan_paths_match_the_kernel_source():
    """The plan offers only the paths the C entries of #2, #3 and #4/#5 take
    (`path == 0` the K-major layouts, path 1 the MN ones; any other
    refused): path 0 on F32_TILES, path 1 on the MN tiles, numbered on from
    F32_TILES, launch_sgemm's `run_sgemm_mn` cases with their MIN_BLOCKS;
    at every LN-fed site the plans pick a path and a tile the sources
    instantiate."""
    for name in ("ln_linear_f32.cu", "ln_mlp_residual_f32.cu", "ln_mlp_residual_bwd_f32.cu"):
        src = (CSRC / name).read_text()
        assert "path == 0" in src and re.search(r"path != 1|path > 1", src)
        assert "launch_sgemm<MN_MAJOR, MN_MAJOR," in src and "launch_transpose(" in src
    assert lin.F32_PATHS == (0, 1)
    n_all = len(lin.F32_TILES) + len(lin.F32_MN_TILES)
    assert set(lin.F32_PATH_RATE) == {(0, t) for t in range(len(lin.F32_TILES))} | {
        (1, t) for t in range(len(lin.F32_TILES), n_all)}
    mn = re.findall(r"case (\d+):\s*return run_sgemm_mn<Tile<(\d+), (\d+), \d+, (\d+)>",
                    SGEMM.read_text())
    assert [int(c) for c, *_ in mn] == list(range(len(lin.F32_TILES), n_all))
    assert [(int(b), int(n)) for _, b, n, _ in mn] == list(lin.F32_MN_TILES)
    assert {(int(b), int(n)): int(k) for _, b, n, k in mn} == lin.F32_MN_TILE_BLOCKS
    for label, M, N, K, groups, mn_ in SITES:
        if label.startswith(("#2", "#3")):
            plan = lin._ln_linear_f32_spec(M, K, N, N_SM)[0]
            assert (plan.path, plan.tile) in lin.F32_PATH_RATE
            _check_plan(plan, M, N, K, groups, mn_)
    for M, K, H in ((3136, 1280, 5120), (6272, 1280, 5120), (8192, 1280, 5120),
                    (1162, 1024, 4096), (4697, 768, 3072)):
        rows, p1, p2, _ = lin._ln_mlp_f32_spec(M, K, H, N_SM)
        assert p1.path == p2.path in lin.F32_PATHS
        assert (p1.rows, p1.n, p1.k, p2.rows, p2.n, p2.k) == (rows, H, K, rows, K, H)
        assert all((p.path, p.tile) in lin.F32_PATH_RATE for p in (p1, p2))


def _c_arg_kinds(src, entry):
    """The ctypes type of each parameter of C entry `entry` in `src`."""
    params = re.search(rf'extern "C" int {entry}\((.*?)\)\s*{{', src, re.S).group(1)
    return [P if "*" in a else (F if a.split()[0] == "float" else I) for a in params.split(",")]


P, I, F = _cuda.P, _cuda.I, _cuda.F


@pytest.mark.parametrize("forced", [None, 0, 1])
def test_mlp_bwd_plans_match_the_kernel_source(monkeypatch, forced):
    """#6's plans (`linear.f32_mlp_bwd_plans`) at its sites (SAM ViT-H's
    windows, edge and global rows at batch 1 and 2, MaPLe's vision and text
    towers): the three products on one path, which the C entry takes (its
    EPI_DACT_T product on path 1, refused with the weight side); with the
    weight side always path 0, F32_PATH_FORCE or not; the scratch the entry
    reads for that path; the entry's arguments as the wrapper binds them."""
    monkeypatch.setattr(lin, "F32_PATH_FORCE", forced)
    src = (CSRC / "ln_mlp_residual_bwd_f32.cu").read_text()
    assert "launch_sgemm<MN_MAJOR, MN_MAJOR, EPI_DACT_T>" in src
    assert "path == 1 && (gt == nullptr || wt == nullptr || hact != nullptr)" in src
    kinds = _c_arg_kinds(src, "cvlm_ln_mlp_residual_bwd_f32")
    assert _cuda.LN_MLP_RESIDUAL_BWD_F32.argtypes == kinds  # the stream the last of both
    for M, K, H in ((6272, 1280, 5120), (3136, 1280, 5120), (2016, 1280, 5120),
                    (1008, 1280, 5120), (8192, 1280, 5120), (4096, 1280, 5120),
                    (4648, 1024, 4096), (1078, 768, 3072)):
        for weights in (False, True):
            rows, p1, p2, elems = lin._ln_mlp_bwd_f32_spec(M, K, H, N_SM, weights, None, None,
                                                           forced, lin.MLP_SCRATCH_ELEMS)
            assert rows == lin.mlp_panel_rows(M, H)
            assert p1.path == p2.path == (0 if weights else forced if forced is not None
                                          else p1.path)
            assert (p1.rows, p1.n, p1.k, p2.rows, p2.n, p2.k) == (rows, H, K, rows, K, H)
            assert all((p.path, p.tile) in lin.F32_PATH_RATE for p in (p1, p2))
            if forced is None:  # the plans' blocks cover C (path 1 at these shapes)
                _check_plan(p1, rows, H, K, 1, False)
                _check_plan(p2, rows, K, H, 1, False)
            R, ld = (M if weights else rows), (lin.mn_ld(rows) if p1.path else M if weights
                                               else rows)
            assert elems == (K * ld, H * ld, R * K, K * ld * p1.path, H * K * p1.path,
                             max(p1.ws_elems, p2.ws_elems), 2 * R)
            assert all(e % 4 == 0 for e in elems[:-1])  # each buffer 16-byte aligned


def _fma_sum(a, b, k0, k1, acc=None):
    """sum over k in [k0, k1) of a[:, k] b[:, k]^T, in order, each step one
    fmaf (the float64 product of two floats is exact; one rounding to
    float32 a step)."""
    acc = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32) if acc is None else acc
    a64, b64 = a.double(), b.double()
    for k in range(k0, k1):
        acc = (acc.double() + a64[:, k, None] * b64[None, :, k]).float()
    return acc


def _mn_path_product(a, w, plan):
    """The kernel's sums for plan `plan`: each output over its k range in
    order, a split tile's slices added in slice order by the second pass."""
    if plan.splits == 1:
        return _fma_sum(a, w, 0, a.shape[1])
    parts = [_fma_sum(a, w, k0, k1) for k0, k1 in plan.slices()]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@pytest.mark.parametrize("splits", [None, 2])
@pytest.mark.parametrize("rows", [127, 129])
def test_mn_path_order_of_sums_matches_plain(rows, splits):
    """The MN path's order of sums (LN rows as ln_rows_t writes them, each
    output one fmaf chain over k, split slices added in order; the MLP's
    hidden rounded to fp32 then fc2 with bias and residual) within 1e-6 of
    the plain versions of #2 and #4/#5; and #6's (g^T and xn^T the A of the
    H-wide products at one plan, dh_pre^T through EPI_ACT_T, dh^T = act'(pre1)
    dh_pre through EPI_DACT_T, dxn = dh . W1, the LN backward from the
    same statistics) within 1e-6 of its plain dx."""
    g = torch.Generator().manual_seed(0)
    K, N = 200, 40

    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=g) * std

    x, gam, bet = r(1, rows, K) + 0.5, 1 + r(K, std=0.1), r(K, std=0.1)
    w, b, w2, b2 = r(N, K, std=0.05), r(N, std=0.1), r(K, N, std=0.05), r(K, std=0.1)
    xn = lin.ln_rows_ref(x, gam, bet, 1e-5).reshape(rows, K)
    p1 = lin._f32_gemm_plan(rows, N, K, N_SM, 1, False, None, splits, (1,))
    p2 = lin._f32_gemm_plan(rows, K, N, N_SM, 1, False, None, splits, (1,))
    y = lin.apply_act(_mn_path_product(xn, w, p1) + b, "quick_gelu")
    want = lin.ln_linear_act_bt_ref(x, gam, bet, w, b, eps=1e-5, activation="quick_gelu")
    assert ((y - want.reshape(rows, N)).abs().max() / want.abs().max()).item() < 1e-6
    h = lin.apply_act(_mn_path_product(xn, w, p1) + b, "gelu_tanh")
    out = _mn_path_product(h, w2, p2) + b2 + x.reshape(rows, K)
    want = lin.ln_mlp_residual_bt_ref(x, gam, bet, w, b, w2, b2, eps=1e-5,
                                      activation="gelu_tanh")
    assert ((out - want.reshape(rows, K)).abs().max() / want.abs().max()).item() < 1e-6
    gy = r(1, rows, K)
    dh_pre = _mn_path_product(gy.reshape(rows, K), w2.t(), p1)  # B: W2 (K, H) as it lies
    dh = lin.act_and_grad(_mn_path_product(xn, w, p1) + b, "gelu_tanh")[1] * dh_pre
    dxn = _mn_path_product(dh, w.t(), p2)  # B: W1 (H, K) as it lies
    x2 = x.reshape(rows, K)
    mu = x2.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x2 - mu).square().mean(-1, keepdim=True) + 1e-5)
    xhat, dxhat = (x2 - mu) * rstd, dxn * gam
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True)) + gy.reshape(rows, K)
    want = lin.ln_mlp_residual_bt_bwd_ref(x, gam, bet, w, b, w2, b2, gy, eps=1e-5,
                                          activation="gelu_tanh", weights=False)[0]
    assert ((dx - want.reshape(rows, K)).abs().max() / want.abs().max()).item() < 1e-6


@pytest.mark.parametrize("rows", [127, 128, 129])
def test_ln_fed_users_match_jax_at_the_path_rows(rows):
    """On the CPU the port's #2, #3 and #4/#5 (their plain versions, which
    both paths are held to on the card) against the JAX functions, run as
    the JAX package's tests run them, at the row counts around a 128-row
    tile: within 1e-5 of the largest output."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import numpy as np

    from camouflaged_vlm_tpu.ops import linear as j_lin

    rng = np.random.default_rng(rows)

    def rnd(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())

    T, J = torch.from_numpy, jnp.asarray
    K, N = 32, 48
    x, g, be = rnd(2, rows, K, scale=2.0) + 0.5, 1 + rnd(K, scale=0.1), rnd(K, scale=0.1)
    w, b, w2, b2 = rnd(K, N, scale=0.2), rnd(N), rnd(N, K, scale=0.1), rnd(K, scale=0.1)
    mask = (rng.random((2, rows, 1)) > 0.3).astype(np.float32)
    close(lin.ln_linear_act_bt(T(x), T(g), T(be), T(w.T.copy()), T(b), 1e-5, "quick_gelu"),
          j_lin.ln_linear_act_bt(J(x), J(g[None]), J(be[None]), J(w), J(b[None]), eps=1e-5,
                                 activation="quick_gelu"))
    close(lin.ln_mask_linear_bt(T(x), T(g), T(be), T(mask), T(w.T.copy()), T(b), eps=1e-6),
          j_lin.ln_mask_linear_bt(J(x), J(g[None]), J(be[None]), J(mask), J(w), J(b[None]),
                                  eps=1e-6))
    close(lin.ln_mlp_residual_bt(T(x), T(g), T(be), T(w.T.copy()), T(b), T(w2.T.copy()),
                                 T(b2), eps=1e-5, activation="gelu_tanh"),
          j_lin.ln_mlp_residual_bt(J(x), J(g[None]), J(be[None]), J(w), J(b[None]), J(w2),
                                   J(b2[None]), eps=1e-5, activation="gelu_tanh"))


@pytest.mark.parametrize("rows", [127, 128, 129])
def test_mlp_bwd_matches_jax_vjp_at_the_path_rows(monkeypatch, rows):
    """#6's plain version in fp32 (which both paths are held to on the
    card) against the VJP of the JAX package's `ln_mlp_residual_bt` through
    its own backward kernel, run in Pallas interpret mode as the JAX tests
    run it, at the row counts around a 128-row tile, with and without the
    weight side: every gradient within 1e-5 of its largest element."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from camouflaged_vlm_tpu.ops import linear as j_lin

    ran, orig = [], j_lin.pl.pallas_call

    def interp(kernel, *args, **kw):
        ran.append(getattr(kernel, "func", kernel).__name__)
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(kernel, *args, **kw)

    monkeypatch.setattr(j_lin.pl, "pallas_call", interp)
    monkeypatch.setattr(j_lin, "_on_cpu", lambda: False)
    rng = np.random.default_rng(rows)

    def rnd(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    K, H = 32, 48
    a = dict(x=rnd(1, rows, K, scale=2.0), gamma=1 + rnd(K, scale=0.1), beta=rnd(K, scale=0.1),
             w1=rnd(H, K, scale=0.1), b1=rnd(H, scale=0.1), w2=rnd(K, H, scale=0.05),
             b2=rnd(K, scale=0.1), g=rnd(1, rows, K))
    J = jnp.asarray
    jargs = (J(a["x"]), J(a["gamma"])[None], J(a["beta"])[None], J(a["w1"]).T,
             J(a["b1"])[None], J(a["w2"]).T, J(a["b2"])[None])
    _, pull = jax.vjp(lambda *p: j_lin.ln_mlp_residual_bt(*p, eps=1e-5, activation="quick_gelu"),
                      *jargs)
    want = pull(J(a["g"]))
    assert "_ln_mlp_residual_bwd_kernel" in ran  # the TPU kernel #6 itself ran
    to_port = [lambda v: v, lambda v: v[0], lambda v: v[0], lambda v: v.T, lambda v: v[0],
               lambda v: v.T, lambda v: v[0]]
    args = [torch.from_numpy(a[k]) for k in ("x", "gamma", "beta", "w1", "b1", "w2", "b2", "g")]
    for weights in (False, True):
        got = lin.ln_mlp_residual_bt_bwd_ref(*args, eps=1e-5, activation="quick_gelu",
                                             weights=weights)
        for gt, f, wt in zip(got, to_port, want):
            if gt is None:
                assert not weights
                continue
            ref = np.asarray(f(wt))
            np.testing.assert_allclose(gt.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_f32_wrapper_checks_run_once_per_signature():
    """The fp32 LN-fed wrappers' shape and type checks (`linear._checked`)
    run once per signature of shapes and dtypes, their result kept; a
    signature that fails raises every time."""
    calls = []

    def check(name, *ts):
        calls.append(name)
        return ts[0].shape[-1]

    x = torch.zeros(2, 3, 8)
    assert lin._checked(check, "a", x) == lin._checked(check, "a", torch.ones(2, 3, 8)) == 8
    lin._checked(check, "a", torch.zeros(2, 3, 4))
    lin._checked(check, "a", torch.zeros(2, 3, 4, dtype=torch.float64))
    assert len(calls) == 3
    K, H = 8, 16
    args = [torch.zeros(2, 3, K), torch.ones(K), torch.zeros(K), torch.zeros(H, K), torch.zeros(H),
            torch.zeros(K, H), torch.zeros(K)]
    assert lin._checked(lin._check_mlp_f32, "mlp", *args) == (K, H)
    bad = args[:5] + [torch.zeros(H, K)] + args[6:]
    for _ in range(2):
        with pytest.raises(ValueError):
            lin._checked(lin._check_mlp_f32, "mlp", *bad)
    with pytest.raises(TypeError):
        lin._checked(lin._check_ln_linear_f32, "ln", args[0].double(), *args[1:3], args[3],
                     args[4])
