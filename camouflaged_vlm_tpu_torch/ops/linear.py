"""Fused linear layers: the Hopper kernels and their plain versions.

Counterparts of `camouflaged_vlm_tpu/ops/linear.py`. Each public function
runs its CUDA kernel (`csrc/`) for CUDA tensors and its plain PyTorch
version for CPU tensors; on CUDA it launches the kernel or raises, never
falls back. When a gradient is wanted, `linear_act`, `ln_linear_act_bt`,
`ln_mask_linear_bt`, `proj_rows` and `proj_from_heads(_res)` take the VJP of
their plain version
(`ops/autograd.py`), as their JAX counterparts take `pallas_with_xla_vjp`;
`ln_mlp_residual_bt` has a hand-written backward, the LN row pass and
three TMA + wgmma passes on the card (`csrc/ln_mlp_residual_bwd.cu`) and
`ln_mlp_residual_bt_bwd_ref` on the CPU. `ln_linear_act_bt`,
`ln_mlp_residual_bt` (and its backward) and `proj_rows` also have float32
instances, which CUDA tensors in float32 reach (tiled FFMA products on the
CUDA cores, `csrc/sgemm_f32.cuh`: MaPLe training's path and the bank
precompute's text tower), and so do `linear_act` and `ln_mask_linear_bt`
(SAM's patch embed and global blocks in the cascade at --dtype float32). The plain versions transcribe the
JAX `ref` formulations: LN statistics in fp32, LN output cast to the working type before the product,
fp32 accumulation, bias and activation in fp32 on the accumulator, one
rounding at the end. Those of the LN-fused functions are written as the
card's stages: the LN row pass (`ln_rows_ref`), then the GEMM with its
epilogue (`linear_act_ref`; `linear_residual_ref` for the MLP's fc2).

`linear_act`, `ln_linear_act_bt`, `ln_mask_linear_bt`,
`ln_mlp_residual_bt` and `proj_rows` run on one persistent TMA + wgmma GEMM
(`csrc/gemm_sm90.cuh`) with 128 x `gemm_tile_n` tiles; the LN-fused ones
first write the bf16 LN rows to a scratch buffer (and the MLP its bf16
hidden), allocated here; `proj_rows` reads the attention kernels' d-major
output as it lies, rows of a stride rounded up to 8 elements
(`dmajor_empty`).

Layouts: activations as in the JAX package ((M, K) rows, (B, S, K)
sequences, the d-major (B, T, K, S) and head-leading (B, heads, T, S, d)
attention outputs); weights in the
`nn.Linear` layout (out, in), biases (out,), LN scale/shift (K,) fp32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda, autograd


def apply_act(acc: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation == "gelu_tanh":
        return F.gelu(acc, approximate="tanh")
    if activation == "gelu":
        return F.gelu(acc)
    if activation == "quick_gelu":
        return acc * torch.sigmoid(1.702 * acc)
    if activation is None:
        return acc
    raise ValueError(f"unknown activation {activation!r}")


def _ln_fp32(x: torch.Tensor, gamma, beta, eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    xn = (x32 - mu) * torch.rsqrt(var + eps)
    return xn * gamma.float() + beta.float()


def _matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) . w (N, K)^T with fp32 accumulation of the given values."""
    return torch.matmul(a.float(), w.float().t())


# ------------------------------------------------------ the GEMM's geometry

GEMM_BM = 128  # rows of a tile (csrc/gemm_sm90.cuh GemmTile::BM)
# A round of 256-wide tiles' time relative to two rounds of 128-wide ones
# (csrc/gemm_sm90.cuh GemmTile), without and with an activation in the
# epilogue: 256-wide tiles pay where they cut rounds, but not with an
# activation. With these costs the pick is the faster width at every
# main-path shape at batch 2 in the forced-width times of
# `cli/kernel_timing.py` on the H100 (PERF.md, PR 8).
GEMM_TILE_COST = {128: 1.0, 256: 0.85}
GEMM_TILE_COST_ACT = {128: 1.0, 256: 1.0}
# proj_rows over groups whose rows end in a partial row tile: its A boxes,
# partly past the group's rows, are loaded once per n-block, twice as often
# in 128-wide tiles. In the forced-width times of `cli/kernel_timing.py` on
# the H100 a 256-wide round took 1.5x a 128-wide one at SAM's windows (32
# groups of 196 rows), 1.8x at its global blocks (2 of 4096) (PERF.md, PR 9).
GEMM_TILE_COST_RAGGED = {128: 1.0, 256: 0.75}


@functools.lru_cache(maxsize=None)
def gemm_tile_n(M: int, N: int, n_sm: int, act: bool = False, groups: int = 1) -> int:
    """The GEMM's tile width (128 or 256) for `groups` groups of M rows
    (a row tile holds rows of one group: proj_rows' (B, T) groups): the one
    whose rounds of tiles over the card's `n_sm` SMs (one persistent block
    each) take the least time, a round costing its tile width times
    GEMM_TILE_COST (GEMM_TILE_COST_ACT with an activation,
    GEMM_TILE_COST_RAGGED for groups that end in a partial row tile), so
    that the last round is not mostly empty; 128 on a tie."""
    if act:
        table = GEMM_TILE_COST_ACT
    else:
        table = GEMM_TILE_COST_RAGGED if groups > 1 and M % GEMM_BM else GEMM_TILE_COST

    def cost(bn: int) -> float:
        tiles = groups * -(-M // GEMM_BM) * -(-N // bn)
        return -(-tiles // n_sm) * bn * table[bn]

    return min((128, 256), key=cost)


# hidden elements of the fused MLP's scratch per row panel (64 MB of bf16)
MLP_SCRATCH_ELEMS = 32 * 2 ** 20


def mlp_panel_rows(M: int, H: int) -> int:
    """Rows per panel of the fused MLP on the card: all M while the bf16
    hidden (M, H) fits MLP_SCRATCH_ELEMS, else M split into panels of equal
    size, rounded up to the GEMM's 128-row tiles, each of which fits (the
    largest multiple of 128 rows that fits caps them; at least 128 rows)."""
    if M * H <= MLP_SCRATCH_ELEMS:
        return M
    cap = max(GEMM_BM, MLP_SCRATCH_ELEMS // H // GEMM_BM * GEMM_BM)
    rows = -(-M // -(-M // cap))
    return min(M, -(-rows // GEMM_BM) * GEMM_BM)


def _check_tma_k(name: str, *widths: int) -> None:
    for k in widths:
        if k % 8:  # TMA row strides are multiples of 16 bytes
            raise ValueError(f"{name}: CUDA kernel takes K % 8 == 0, got K = {k}")


# --------------------------------------------------- the fp32 GEMM's plan

# The block tiles (BM, BN) of csrc/sgemm_f32.cuh, in the order of its
# launch_sgemm `tile` argument: 8 x 8 outputs a thread, BM BN / 64 threads.
F32_TILES = ((128, 128), (64, 128), (128, 64), (64, 64))
# the blocks of each tile an SM holds at once (its Tile MIN_BLOCKS): 16384
# outputs an SM whatever the tile
F32_TILE_BLOCKS = {(128, 128): 1, (64, 128): 2, (128, 64): 2, (64, 64): 4}
# An SM's FFMA rate when it is full of each tile's blocks, relative to
# 128 x 128, and one SM's rate at 128 x 128: 64% of the H100's 67 TFLOP/s
# over 132 SMs, the in-wave share of the products at the cascade's widest
# shapes (cli/kernel_timing.py --f32-gemm --tiles; PERF.md §6). An SM
# holding fewer than F32_FULL_WARPS warps runs at that share of its rate.
F32_TILE_RATE = {(128, 128): 1.0, (64, 128): 1.03, (128, 64): 1.0, (64, 64): 0.97}
F32_SM_FLOPS = 67e12 / 132 * 0.64
F32_FULL_WARPS = 8
# The products' paths (csrc/sgemm_f32.cuh): 0, both operands as they lie
# (K-major fragments, 4 k of 8 rows a thread), on F32_TILES; 1, the
# LN-fed users' MN path (the weight transposed into a scratch each call,
# the LN rows and the MLP's hidden written MN-major, 8 + 8 fragment values
# of one k read while the last k's FFMAs run), on its own tile, numbered on
# from F32_TILES: 128 x 128 at two blocks (16 warps) an SM, which its 128
# registers allow.
F32_PATHS = (0, 1)
F32_MN_TILES = ((128, 128),)
F32_MN_TILE_BLOCKS = {(128, 128): 2}
# each (path, tile number)'s rate relative to F32_TILE_RATE of its (BM, BN):
# the MN tile's products run 3-12% faster than path 0's (each kernel's
# device ms, cli/kernel_timing.py --f32-gemm; PERF.md §6), and 1.09 picks
# the faster path at every LN-fed site of the cascade but three near-ties
# (within 1.3%), where it keeps path 0
F32_PATH_RATE = {(0, 0): 1.0, (0, 1): 1.0, (0, 2): 1.0, (0, 3): 1.0, (1, 4): 1.09}
# #6's in-place epilogue dh = act'(pre1) * dh_pre (EPI_DACT, EPI_DACT_T),
# which reads dh_pre back: its product's rate relative to the others' on
# each path (H100, SAM windows b2: 2.45 against 2.05 ms on path 0, 1.83
# against 1.74 on path 1; cli/kernel_timing.py --f32-gemm, PERF.md §6)
F32_DACT_RATE = {0: 0.84, 1: 0.95}
# the passes around the products, at their measured rates (bytes read and
# written over seconds, the same runs): the row-major LN pass, the MN-major
# one, and the weights' transposes
F32_LN_BYTES_S = {0: 2.4e12, 1: 1.5e12}
F32_TRANSPOSE_BYTES_S = 2.1e12
# split K's second pass: a launch, and each split tile's slices read, its
# outputs read (a residual) and written at the HBM rate
F32_FINISH_S, F32_HBM_BYTES_S = 4e-6, 3.35e12
# the k depth of a stage (csrc/sgemm_f32.cuh BK); split K cuts K into at
# most F32_MAX_SPLITS slices of at least F32_MIN_SLICE k tiles each
F32_BK, F32_MAX_SPLITS, F32_MIN_SLICE = 32, 4, 4
# tests: a tile to take at every shape instead of the plan's pick (one of
# F32_TILES, or a tile number, which may name an MN tile); a number of k
# slices to cut every tile's K into; a path to take wherever the caller
# offers it
F32_TILE_FORCE = None
F32_SPLIT_FORCE: Optional[int] = None
F32_PATH_FORCE: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class F32Plan:
    """How csrc/sgemm_f32.cuh's product covers a C of `groups` groups of
    `rows` x `n` outputs over depth `k`: blocks of F32_TILES[tile], a grid of
    (n, rows, groups) tiles (`grid`); each group's last `tail_rows` row
    tiles have their k range cut into `splits` slices (`slices`), each
    slice's sums into a scratch of `ws_elems` floats, added in slice order by
    a second pass; `flat`: an MN-major A's row groups tiled as one M (the
    kernel's gs, gst); `path`: the operands' layouts (F32_PATHS), `tile` a
    number in F32_TILES + F32_MN_TILES; `cost`: the modelled seconds the
    plan was picked by."""

    tile: int
    groups: int
    rows: int
    n: int
    k: int
    flat: bool = False
    splits: int = 1
    tail_rows: int = 0
    path: int = 0
    cost: float = dataclasses.field(default=0.0, compare=False)

    @property
    def bm(self) -> int:
        return f32_tile(self.tile)[0]

    @property
    def bn(self) -> int:
        return f32_tile(self.tile)[1]

    @property
    def grid(self) -> tuple:
        """(tiles along n, along rows, groups)"""
        return (-(-self.n // self.bn), -(-self.rows // self.bm), self.groups)

    @property
    def tiles(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def tail(self) -> int:
        """the tiles whose k range is split"""
        gx, _, gz = self.grid
        return gx * self.tail_rows * gz if self.splits > 1 else 0

    @property
    def ws_elems(self) -> int:
        return self.tail * self.splits * self.bm * self.bn

    def slices(self) -> list:
        """(k begin, k end) of each k slice of a split tile, in order."""
        per = _slice_tiles(self.k, self.splits)
        return [(k0, min(self.k, k0 + per * F32_BK))
                for k0 in range(0, self.k, per * F32_BK)]


def _slice_tiles(K: int, splits: int) -> int:
    """k tiles a slice when K is cut into `splits` (csrc/sgemm_f32.cuh
    run_sgemm: whole k tiles, every slice non-empty)."""
    nk = -(-K // F32_BK)
    return -(-nk // splits)


def _valid_splits(K: int, splits: int) -> bool:
    """Whether `splits` slices of `_slice_tiles` k tiles each are all
    non-empty (csrc/sgemm_f32.cuh run_sgemm refuses others)."""
    nk = -(-K // F32_BK)
    return -(-nk // _slice_tiles(K, splits)) == splits


def f32_gemm_plan(M: int, N: int, K: int, n_sm: int, groups: int = 1,
                  mn_groups: bool = False, paths: tuple = (0,)) -> F32Plan:
    """The plan of one fp32 product of `groups` groups of M x N outputs over
    depth K on a card of `n_sm` SMs, on one of the `paths` the caller can
    lay its operands out for (F32_PATHS). With `mn_groups` (an MN-major A
    whose groups lie at a fixed stride, proj_rows) and M % 4 == 0 the
    groups' rows are tiled as one M: a 16-byte chunk of 4 rows never crosses
    a group. The path, tile and split are those of the least modelled time
    (`_launch_s` for each launch at the path's rate, plus a split's second
    pass): no split; every tile's K cut into 2 to F32_MAX_SPLITS slices; or,
    for a K-major A, the last row tiles of each group, as few as hold the
    last round's tiles, cut into the slices that fit one round. An MN-major
    A's grids of more than one round are not split (their splits measured
    slower than modelled, PERF.md §6). The first on a tie.
    F32_TILE_FORCE, F32_SPLIT_FORCE (every tile split) and F32_PATH_FORCE
    (where `paths` holds it) override the pick."""
    return _f32_gemm_plan(M, N, K, n_sm, groups, mn_groups, _forced_tile(), F32_SPLIT_FORCE,
                          _offered_paths(paths))


def _forced_tile() -> Optional[int]:
    """F32_TILE_FORCE as a tile number."""
    t = F32_TILE_FORCE
    return F32_TILES.index(tuple(t)) if t is not None and not isinstance(t, int) else t


def _offered_paths(paths: tuple) -> tuple:
    """The paths of `paths` that F32_PATH_FORCE and F32_TILE_FORCE leave:
    the forced path where offered, and those that take the forced tile."""
    if F32_PATH_FORCE is not None and F32_PATH_FORCE in paths:
        paths = (F32_PATH_FORCE,)
    t = _forced_tile()
    return tuple(p for p in paths if t is None or (p, t) in F32_PATH_RATE)


def f32_path_overhead_s(path: int, M: int, K: int, weights: int, launches: int = 1) -> float:
    """The modelled seconds of an LN-fed call's passes besides its products
    on `path`: the LN rows over M x K (x read, the rows written), and on
    path 1 the transposes of `weights` elements in `launches` launches more."""
    s = 8.0 * M * K / F32_LN_BYTES_S[path]
    if path == 1:
        s += 8.0 * weights / F32_TRANSPOSE_BYTES_S + launches * F32_FINISH_S
    return s


def f32_mlp_plans(M: int, rows: int, K: int, H: int, n_sm: int) -> tuple:
    """The plans of #4/#5's two products over a row panel of `rows` of its
    M rows, fc1 (rows x H over K) and fc2 (rows x K over H), on one path
    (the hidden's layout joins them): the path of the least modelled time
    of a call, its panels' products and `f32_path_overhead_s`."""
    panels = -(-M // rows)
    plans = [(f32_gemm_plan(rows, H, K, n_sm, paths=(p,)),
              f32_gemm_plan(rows, K, H, n_sm, paths=(p,))) for p in _offered_paths(F32_PATHS)]
    return min(plans, key=lambda pp: panels * (pp[0].cost + pp[1].cost)
               + f32_path_overhead_s(pp[0].path, M, K, 2 * H * K))


def f32_mlp_bwd_plans(M: int, rows: int, K: int, H: int, n_sm: int,
                      weights: bool = False) -> tuple:
    """The plans of #6's three products over a row panel of `rows` of its M
    rows, the H-wide g . W2 and xn . W1^T (one plan: rows x H over K) and
    the K-wide dh . W1 (rows x K over H), on one path (dh's layout joins
    them): the path of the least modelled time of a call, its panels'
    products (xn . W1^T's at F32_DACT_RATE) and `f32_path_overhead_s` with,
    on path 1, the transposes of W1 and of g (one launch a panel). With
    `weights`, path 0: the weight side reads the row-major scratches
    (csrc/ln_mlp_residual_bwd_f32.cu)."""
    panels = -(-M // rows)
    paths = (0,) if weights else _offered_paths(F32_PATHS)
    plans = [(f32_gemm_plan(rows, H, K, n_sm, paths=(p,)),
              f32_gemm_plan(rows, K, H, n_sm, paths=(p,))) for p in paths]

    def cost(pp):
        p = pp[0].path
        return (panels * ((1 + 1 / F32_DACT_RATE[p]) * pp[0].cost + pp[1].cost)
                + f32_path_overhead_s(p, M, K, H * K + M * K, 1 + panels))

    return min(plans, key=cost)


def mn_ld(m: int) -> int:
    """The leading dimension of an MN-major scratch over m rows
    (csrc/sgemm_f32.cuh mn_ld): m rounded up to whole 16-byte chunks."""
    return -(-m // 4) * 4


def f32_scratch(device, *elems: int) -> list:
    """One fp32 allocation cut into buffers of `elems` floats each (each a
    multiple of 4: 16-byte aligned): the tensor, which the caller holds
    until the launch is queued, and the buffers' data pointers (None for 0
    elements)."""
    buf = torch.empty(sum(elems), dtype=torch.float32, device=device)
    ptr, out = buf.data_ptr(), []
    for n in elems:
        out.append(ptr if n else None)
        ptr += 4 * n
    return buf, out


def f32_tile(t: int) -> tuple:
    """Tile number t's (BM, BN, blocks an SM, rate on path 0): F32_TILES,
    then F32_MN_TILES (which only path 1 takes, at its own rates)."""
    if t < len(F32_TILES):
        tl = F32_TILES[t]
        return (*tl, F32_TILE_BLOCKS[tl], F32_TILE_RATE[tl])
    tl = F32_MN_TILES[t - len(F32_TILES)]
    return (*tl, F32_MN_TILE_BLOCKS[tl], F32_TILE_RATE[tl])


def _launch_s(blocks: int, t: int, depth: int, n_sm: int, path: int = 0) -> float:
    """The modelled seconds of a launch of `blocks` blocks of tile number t
    over `depth` of K on `path`: each SM's ceil(blocks / n_sm) blocks in
    rounds of its co-resident ones, a round's rate scaled down while its
    warps are fewer than F32_FULL_WARPS."""
    bm, bn, occ, rate = f32_tile(t)
    warps = bm * bn // 2048
    block_s = 2.0 * bm * bn * depth / (F32_SM_FLOPS * rate * F32_PATH_RATE[(path, t)])
    full, rem = divmod(-(-blocks // n_sm), occ)

    def rnd(n: int) -> float:
        return n * block_s / min(1.0, n * warps / F32_FULL_WARPS)

    return full * rnd(occ) + (rnd(rem) if rem else 0.0)


@functools.lru_cache(maxsize=None)
def _f32_gemm_plan(M, N, K, n_sm, groups, mn_groups, force_tile, force_split,
                   paths=(0,)) -> F32Plan:
    flat = mn_groups and groups > 1 and M % 4 == 0
    if flat:
        M, groups = M * groups, 1
    best = None
    for path, t in F32_PATH_RATE:
        if path not in paths or force_tile not in (None, t):
            continue
        bm, bn, occ, _ = f32_tile(t)
        plan = F32Plan(t, groups, M, N, K, flat, path=path)
        gx, gy, _ = plan.grid
        slots = n_sm * occ
        rem = plan.tiles % slots

        def finish(tail: int, s: int) -> float:
            return F32_FINISH_S + (s + 2) * tail * bm * bn * 4 / F32_HBM_BYTES_S

        def launch(blocks: int, depth: int, t=t, path=path) -> float:
            return _launch_s(blocks, t, depth, n_sm, path)

        if force_split:  # every tile's K in at most that many slices
            s = min(force_split, -(-K // F32_BK))
            while not _valid_splits(K, s):
                s -= 1
            options = [(0.0, s, gy if s > 1 else 0)]
        else:
            options = [(launch(plan.tiles, K), 1, 0)]
        tr = -(-rem // (gx * groups))  # the row tiles a group that hold the last round's
        tail = gx * tr * groups
        for s in range(2, F32_MAX_SPLITS + 1):
            depth = _slice_tiles(K, s) * F32_BK
            if (force_split or depth < F32_MIN_SLICE * F32_BK or not _valid_splits(K, s)
                    or (mn_groups and plan.tiles > slots)):
                continue
            options.append((launch(plan.tiles * s, depth) + finish(plan.tiles, s), s, gy))
            if rem and not mn_groups and tail < plan.tiles and tail * s <= slots:
                options.append((launch(plan.tiles - tail, K) + launch(tail * s, depth)
                                + finish(tail, s), s, tr))
        for cost, s, rows in options:
            if best is None or cost < best[0]:
                best = (cost, dataclasses.replace(plan, splits=s, tail_rows=rows, cost=cost))
    if best is None:
        raise ValueError(f"fp32 GEMM: tile {force_tile} is on none of the paths {paths}")
    return best[1]


def f32_blocks(plan: F32Plan) -> list:
    """(group, first row, first column, k begin, k end) of each block of the
    product's launches, in order (csrc/sgemm_f32.cuh run_sgemm): the grid of
    whole row tiles (column fastest, then row, then group), then the split
    tail's grid (column, tail row, then group and slice: z = group splits +
    slice)."""
    gx, gy, gz = plan.grid
    tr = min(plan.tail_rows, gy) if plan.splits > 1 else 0
    out = [(g, y * plan.bm, x * plan.bn, 0, plan.k)
           for g in range(gz) for y in range(gy - tr) for x in range(gx)]
    span = _slice_tiles(plan.k, plan.splits) * F32_BK
    for z in range(gz * plan.splits if tr else 0):
        g, kb = z // plan.splits, z % plan.splits * span
        out += [(g, (gy - tr + y) * plan.bm, x * plan.bn, kb, min(plan.k, kb + span))
                for y in range(tr) for x in range(gx)]
    return out


def f32_workspace(device, *plans: F32Plan) -> Optional[torch.Tensor]:
    """The split-K scratch the plans of one entry point share (products
    queued one after another on the stream), None when none splits."""
    n = max(p.ws_elems for p in plans)
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def f32_thread_outputs(bm: int, bn: int) -> torch.Tensor:
    """(threads, 64, 2): the (row, column) in its block tile of each of a
    thread's 8 x 8 outputs (csrc/sgemm_f32.cuh sgemm_kernel: thread t, lane
    t % 32 of warp t // 32, is (tx, ty) = (warp % (bn / 64) 8 + lane % 8,
    warp // (bn / 64) 4 + lane // 8) and holds rows (bm / 2) h + 4 ty + i
    and columns (bn / 2) h' + 4 tx + j)."""
    t = torch.arange(bm * bn // 64)
    lane, warp = t % 32, t // 32
    tx, ty = warp % (bn // 64) * 8 + lane % 8, warp // (bn // 64) * 4 + lane // 8
    i = torch.arange(8)
    rows = (bm // 2) * (i // 4) + 4 * ty[:, None] + i % 4  # (threads, 8)
    cols = (bn // 2) * (i // 4) + 4 * tx[:, None] + i % 4
    return torch.stack(torch.broadcast_tensors(rows[:, :, None], cols[:, None, :]), -1).reshape(
        -1, 64, 2)


def mn_row_offset(m: int, gs: int, gst: int) -> int:
    """Where row m of an MN-major A lies along its rows (csrc/sgemm_f32.cuh
    load_tile): (m // gs) gst + m % gs with row groups of gs rows at stride
    gst (a flat plan), else m."""
    return (m // gs) * gst + m % gs if gs > 0 else m


def _check_f32_widths(name: str, *widths: int) -> None:
    for k in widths:
        if k % 4:  # the fp32 kernels load and store 16 bytes a thread
            raise ValueError(f"{name}: CUDA kernel takes widths % 4 == 0, got {k}")


# ------------------------------------------------------------ linear_act


def linear_act_ref(x, w, b, activation=None):
    acc = _matmul_f32(x, w) + b.float()
    return apply_act(acc, activation).to(x.dtype)


def linear_act(
    x: torch.Tensor,  # (M, K)
    w: torch.Tensor,  # (N, K)
    b: torch.Tensor,  # (N,)
    activation: Optional[str] = None,
) -> torch.Tensor:
    """act(x . w^T + b). Counterpart of `linear_pallas` (TPU kernel #1); x
    in bfloat16 runs the TMA + wgmma kernel, x in float32 its fp32
    instance."""
    return autograd.run("linear_act", _linear_act_cuda, linear_act_ref, (x, w, b),
                        (activation,))


def _linear_act_f32_cuda(x, w, b, activation):
    """The fp32 instance (SAM's patch embed at --dtype float32,
    csrc/linear_f32.cu): the tiled FFMA product with the bias and
    activation in its epilogue."""
    name = "linear_act (float32)"
    _cuda.check_dtype(name, torch.float32, x, w, b)
    M, K = x.shape
    N = w.shape[0]
    if w.shape != (N, K) or b.shape != (N,):
        raise ValueError(f"{name}: shapes x {x.shape} w {w.shape} b {b.shape}")
    _check_f32_widths(name, K, N)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    plan = f32_gemm_plan(M, N, K, _cuda.sm_count(x.device))
    ws = f32_workspace(x.device, plan)
    _cuda.LINEAR_ACT_F32(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), _ptr(ws), M, K,
                         N, _cuda.ACTIVATIONS[activation], plan.tile, plan.splits, plan.tail_rows)
    return out


def _linear_act_cuda(x, w, b, activation):
    if x.dtype == torch.float32:
        return _linear_act_f32_cuda(x, w, b, activation)
    _cuda.check_dtype("linear_act", torch.bfloat16, x, w, b)
    M, K = x.shape
    N = w.shape[0]
    if w.shape != (N, K) or b.shape != (N,):
        raise ValueError(f"linear_act: shapes x {x.shape} w {w.shape} b {b.shape}")
    _check_tma_k("linear_act", K)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _cuda.LINEAR_ACT(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
                     _cuda.ACTIVATIONS[activation],
                     gemm_tile_n(M, N, _cuda.sm_count(x.device), activation is not None))
    return out


def linear_residual_ref(x, w, b, res):
    """x . w^T + b + res, fp32 on the accumulator, one rounding: the fused
    MLP's fc2 stage."""
    return (_matmul_f32(x, w) + b.float() + res.float()).to(x.dtype)


# ----------------------------------------------------------------- ln_rows


def ln_rows_ref(x, gamma, beta, eps, mask=None):
    """The LN row pass of #2, #3 and #4/#5: LN(x) in fp32 (two-pass
    statistics), times the row mask if given ((nwin, S, 1) for x (B', S, K);
    row b' reads mask[b' % nwin]), rounded to x's type: the TPU kernels'
    first rounding point."""
    y = _ln_fp32(x, gamma, beta, eps)
    if mask is not None:
        Bp, S, _ = x.shape
        nwin = mask.shape[0]
        y = y * mask.float()[None].expand(Bp // nwin, nwin, S, 1).reshape(Bp, S, 1)
    return y.to(x.dtype)


# ------------------------------------------------------- ln_linear_act_bt


def ln_linear_act_bt_ref(x, gamma, beta, w, b, eps=1e-5, activation="quick_gelu"):
    return linear_act_ref(ln_rows_ref(x, gamma, beta, eps), w, b, activation)


def ln_linear_act_bt(
    x: torch.Tensor,      # (B, S, K)
    gamma: torch.Tensor,  # (K,)
    beta: torch.Tensor,   # (K,)
    w: torch.Tensor,      # (N, K)
    b: torch.Tensor,      # (N,)
    eps: float = 1e-5,
    activation: Optional[str] = "quick_gelu",
) -> torch.Tensor:
    """act(LN(x) . w^T + b). Counterpart of `ln_linear_act_bt` (TPU kernel #2);
    x in bfloat16 runs the TMA + wgmma kernel, x in float32 its fp32
    instance."""
    return autograd.run("ln_linear_act_bt", _ln_linear_act_bt_cuda, ln_linear_act_bt_ref,
                        (x, gamma, beta, w, b), (eps, activation))


@functools.lru_cache(maxsize=None)
def _ln_linear_f32_spec(M: int, K: int, N: int, n_sm: int, *forced) -> tuple:
    """#2's and #3's plan at one shape, on the path of the least modelled
    time (its product's and `f32_path_overhead_s`), and their scratch:
    the LN rows' floats (M K, or K mn_ld(M) MN-major), the split-K
    workspace's and W^T's (path 1). `forced`: the F32_*_FORCE settings, part
    of the cache's key."""
    plan = min((f32_gemm_plan(M, N, K, n_sm, paths=(p,)) for p in _offered_paths(F32_PATHS)),
               key=lambda p: p.cost + f32_path_overhead_s(p.path, M, K, N * K))
    if plan.path == 0:
        return plan, (M * K, plan.ws_elems, 0)
    return plan, (K * mn_ld(M), plan.ws_elems, N * K)


_CHECKED: dict = {}


def _checked(check, name, *tensors):
    """`check(name, *tensors)` run once per signature of the tensors'
    shapes and dtypes, which are all the fp32 wrappers' checks read: its
    result, kept."""
    key = (check, *[(t.shape, t.dtype) for t in tensors])
    out = _CHECKED.get(key)
    if out is None:
        out = _CHECKED[key] = check(name, *tensors)
    return out


def _check_ln_linear_f32(name, x, gamma, beta, w, b):
    _cuda.check_dtype(name, torch.float32, x, gamma, beta, w, b)
    B, S, K = x.shape
    N = w.shape[0]
    if w.shape != (N, K) or b.shape != (N,) or gamma.shape != (K,) or beta.shape != (K,):
        raise ValueError(f"{name}: shapes x {x.shape} w {w.shape}")
    _check_f32_widths(name, K, N)
    return B, S, K, N


def _ln_linear_f32_launch(x, M, K, N):
    """The plan and the scratch pointers (LN rows, workspace, W^T) of one
    call, the plan cached per shape and forced settings."""
    plan, elems = _ln_linear_f32_spec(M, K, N, _cuda.sm_count(x.device), F32_TILE_FORCE,
                                      F32_SPLIT_FORCE, F32_PATH_FORCE)
    buf, (xn, ws, wt) = f32_scratch(x.device, *elems)
    return plan, buf, xn, ws, wt


def _ln_linear_act_f32_cuda(x, gamma, beta, w, b, eps, activation):
    """The fp32 instance (MaPLe training's vision LN1 + qkv, the cascade's
    SAM and CLIP qkv at --dtype float32, csrc/ln_linear_f32.cu): the LN rows
    in an fp32 scratch, the product on the CUDA cores in full fp32, on the
    plan's path."""
    B, S, K, N = _checked(_check_ln_linear_f32, "ln_linear_act_bt (float32)", x, gamma, beta,
                          w, b)
    plan, buf, xn, ws, wt = _ln_linear_f32_launch(x, B * S, K, N)
    out = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    _cuda.LN_LINEAR_F32(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), xn, ws, wt, B * S, K, N, float(eps), _cuda.ACTIVATIONS[activation],
        plan.tile, plan.splits, plan.tail_rows, plan.path,
    )
    return out


def _ln_linear_act_bt_cuda(x, gamma, beta, w, b, eps, activation):
    if x.dtype == torch.float32:
        return _ln_linear_act_f32_cuda(x, gamma, beta, w, b, eps, activation)
    _cuda.check_dtype("ln_linear_act_bt", torch.bfloat16, x, w, b)
    _cuda.check_dtype("ln_linear_act_bt", torch.float32, gamma, beta)
    B, S, K = x.shape
    N = w.shape[0]
    if w.shape != (N, K) or b.shape != (N,) or gamma.shape != (K,) or beta.shape != (K,):
        raise ValueError(f"ln_linear_act_bt: shapes x {x.shape} w {w.shape}")
    _check_tma_k("ln_linear_act_bt", K)
    M = B * S
    out = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    xn = torch.empty((M, K), dtype=x.dtype, device=x.device)  # the LN rows' scratch
    _cuda.LN_LINEAR(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), xn.data_ptr(), M, K, N, float(eps), _cuda.ACTIVATIONS[activation],
        gemm_tile_n(M, N, _cuda.sm_count(x.device), activation is not None),
    )
    return out


# ------------------------------------------------------ ln_mask_linear_bt


def ln_mask_linear_bt_ref(x, gamma, beta, mask, w, b, eps=1e-6):
    return linear_act_ref(ln_rows_ref(x, gamma, beta, eps, mask), w, b)


def ln_mask_linear_bt(
    x: torch.Tensor,      # (B', S, K), B' = B * nwin
    gamma: torch.Tensor,  # (K,)
    beta: torch.Tensor,   # (K,)
    mask: torch.Tensor,   # (nwin, S, 1) row mask in x's type; row b' reads mask[b' % nwin]
    w: torch.Tensor,      # (N, K)
    b: torch.Tensor,      # (N,)
    eps: float = 1e-6,
) -> torch.Tensor:
    """(LN(x) * mask) . w^T + b: LN1, the pad-row re-zeroing and the qkv
    projection in one kernel. Counterpart of `ln_mask_linear_bt` (TPU
    kernel #3); x in bfloat16 runs the TMA + wgmma kernel, x in float32 its
    fp32 instance."""
    return autograd.run("ln_mask_linear_bt", _ln_mask_linear_bt_cuda, ln_mask_linear_bt_ref,
                        (x, gamma, beta, mask, w, b), (eps,))


def _check_mask_shapes(name, x, gamma, beta, mask, w, b, dtype):
    _cuda.check_dtype(name, dtype, x, mask, w, b)
    _cuda.check_dtype(name, torch.float32, gamma, beta)
    Bp, S, K = x.shape
    N, nwin = w.shape[0], mask.shape[0]
    if (w.shape != (N, K) or b.shape != (N,) or gamma.shape != (K,) or beta.shape != (K,)
            or mask.shape != (nwin, S, 1) or Bp % nwin):
        raise ValueError(f"{name}: shapes x {x.shape} mask {mask.shape} w {w.shape}")
    return Bp, S, K, N, nwin


def _check_mask_f32(name, *tensors):
    out = _check_mask_shapes(name, *tensors, torch.float32)
    _check_f32_widths(name, out[2], out[3])
    return out


def _ln_mask_linear_f32_cuda(x, gamma, beta, mask, w, b, eps):
    """The fp32 instance (SAM's global blocks at --dtype float32,
    csrc/ln_linear_f32.cu): the masked LN rows in an fp32 scratch, the
    product on the CUDA cores in full fp32, on the plan's path."""
    Bp, S, K, N, nwin = _checked(_check_mask_f32, "ln_mask_linear_bt (float32)", x, gamma, beta,
                                 mask, w, b)
    plan, buf, xn, ws, wt = _ln_linear_f32_launch(x, Bp * S, K, N)
    out = torch.empty((Bp, S, N), dtype=x.dtype, device=x.device)
    _cuda.LN_MASK_LINEAR_F32(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mask.data_ptr(), w.data_ptr(),
        b.data_ptr(), out.data_ptr(), xn, ws, wt, Bp * S, K, N, S, nwin, float(eps),
        plan.tile, plan.splits, plan.tail_rows, plan.path,
    )
    return out


def _ln_mask_linear_bt_cuda(x, gamma, beta, mask, w, b, eps):
    if x.dtype == torch.float32:
        return _ln_mask_linear_f32_cuda(x, gamma, beta, mask, w, b, eps)
    Bp, S, K, N, nwin = _check_mask_shapes("ln_mask_linear_bt", x, gamma, beta, mask, w, b,
                                           torch.bfloat16)
    _check_tma_k("ln_mask_linear_bt", K)
    M = Bp * S
    out = torch.empty((Bp, S, N), dtype=x.dtype, device=x.device)
    xn = torch.empty((M, K), dtype=x.dtype, device=x.device)  # the LN rows' scratch
    _cuda.LN_MASK_LINEAR(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mask.data_ptr(), w.data_ptr(),
        b.data_ptr(), out.data_ptr(), xn.data_ptr(), M, K, N, S, nwin, float(eps),
        gemm_tile_n(M, N, _cuda.sm_count(x.device)),
    )
    return out


# ----------------------------------------------------- ln_mlp_residual_bt


def ln_mlp_residual_bt_ref(x, gamma, beta, w1, b1, w2, b2, eps=1e-6,
                             activation="gelu_tanh", residual=True):
    """The card's three stages: the LN row pass, fc1 with bias and
    activation (h rounded to x's type, the TPU kernel's second rounding
    point), fc2 with bias and the residual x in fp32, rounded once; without
    `residual`, fc2 with bias alone in fp32, unrounded (a tensor-parallel
    rank's partial, which its caller sums over the ranks in fp32 before the
    residual and the one rounding)."""
    h = linear_act_ref(ln_rows_ref(x, gamma, beta, eps), w1, b1, activation)
    if not residual:
        return _matmul_f32(h, w2) + b2.float()
    return linear_residual_ref(h, w2, b2, x)


def act_and_grad(pre: torch.Tensor, activation: Optional[str]):
    """(act(pre), act'(pre)) in fp32, the closed forms of the derivatives
    JAX's autodiff takes of `_apply_act`."""
    v = pre.float()
    if activation == "gelu_tanh":
        c = math.sqrt(2.0 / math.pi)
        t = torch.tanh(c * (v + 0.044715 * v ** 3))
        return (0.5 * v * (1.0 + t),
                0.5 * (1.0 + t) + 0.5 * v * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * v * v))
    if activation == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(v / math.sqrt(2.0)))
        return v * cdf, cdf + v * torch.exp(-0.5 * v * v) / math.sqrt(2.0 * math.pi)
    if activation == "quick_gelu":
        sg = torch.sigmoid(1.702 * v)
        return v * sg, sg + 1.702 * v * sg * (1.0 - sg)
    if activation is None:
        return v, torch.ones_like(v)
    raise ValueError(f"unknown activation {activation!r}")


def ln_mlp_residual_bt_bwd_ref(x, gamma, beta, w1, b1, w2, b2, g, eps=1e-6,
                               activation="gelu_tanh", weights=True, residual=True):
    """The backward of `ln_mlp_residual_bt` at upstream gradient g (like x):
    (dx, dgamma, dbeta, dw1, db1, dw2, db2), the weight side None unless
    `weights`. Transcribes the JAX backward kernel (`ops/linear.py`,
    `_ln_mlp_residual_bwd_kernel`) and its wrapper's weight products:
    LN and pre1 = xn.W1^T + b1 recomputed, dh = act'(pre1) * (g.W2),
    dxn = dh.W1 with g and dh rounded to the working type before their
    products, the LN backward in fp32, plus the residual g (without
    `residual`, the forward's residual-free form: no g term)."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mu) * rstd
    xnb = (xhat * gamma.float() + beta.float()).to(dt)
    hact, dact = act_and_grad(_matmul_f32(xnb, w1) + b1.float(), activation)
    dh = dact * _matmul_f32(g.to(dt), w2.t())           # (.., H) = act' * (g . W2)
    dxn = _matmul_f32(dh.to(dt), w1.t())                # (.., K) = dh . W1
    dxhat = dxn * gamma.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    dx = (dx + g.float() if residual else dx).to(dt)
    if not weights:
        return dx, None, None, None, None, None, None
    K, H = x.shape[-1], w1.shape[0]
    dh2, g2 = dh.to(dt).reshape(-1, H), g.to(dt).reshape(-1, K)
    dw1 = torch.matmul(dh2.float().t(), xnb.reshape(-1, K).float()).to(w1.dtype)
    dw2 = torch.matmul(g2.float().t(), hact.to(dt).reshape(-1, H).float()).to(w2.dtype)
    sum_rows = lambda a: a.reshape(-1, a.shape[-1]).sum(0)  # noqa: E731
    return (dx, sum_rows(dxn * xhat).to(gamma.dtype), sum_rows(dxn).to(beta.dtype), dw1,
            sum_rows(dh).to(b1.dtype), dw2, sum_rows(g.float()).to(b2.dtype))


def _check_mlp_shapes(name, x, gamma, beta, w1, b1, w2, b2, dtype=torch.bfloat16):
    _cuda.check_dtype(name, dtype, x, w1, b1, w2, b2)
    _cuda.check_dtype(name, torch.float32, gamma, beta)
    K, H = x.shape[-1], w1.shape[0]
    if (w1.shape != (H, K) or w2.shape != (K, H) or b1.shape != (H,)
            or b2.shape != (K,) or gamma.shape != (K,) or beta.shape != (K,)):
        raise ValueError(f"{name}: shapes x {x.shape} w1 {w1.shape} w2 {w2.shape}")
    return K, H


@functools.lru_cache(maxsize=None)
def _ln_mlp_f32_spec(M: int, K: int, H: int, n_sm: int, *forced) -> tuple:
    """#4/#5's row panel, its two plans on one path (`f32_mlp_plans`) and
    its scratch: the LN rows', the hidden's, the split-K workspace's and
    W1^T and W2^T's floats (rows K, rows H, ..., 0; or MN-major K
    mn_ld(rows), H mn_ld(rows), ..., 2 H K).
    `forced`: the F32_*_FORCE settings and MLP_SCRATCH_ELEMS, part of the
    cache's key."""
    rows = mlp_panel_rows(M, H)
    p1, p2 = f32_mlp_plans(M, rows, K, H, n_sm)
    ld = rows if p1.path == 0 else mn_ld(rows)
    return rows, p1, p2, (K * ld, H * ld, max(p1.ws_elems, p2.ws_elems),
                          2 * H * K if p1.path == 1 else 0)


def _check_mlp_f32(name, *tensors):
    K, H = _check_mlp_shapes(name, *tensors, torch.float32)
    _check_f32_widths(name, K, H)
    return K, H


def _ln_mlp_residual_f32_cuda(x, gamma, beta, w1, b1, w2, b2, eps, activation, residual):
    """The fp32 instance (the CLIP towers in MaPLe training and the bank
    precompute's text tower; SAM's and CLIP's MLPs in the cascade at --dtype
    float32): the LN rows and the hidden in fp32 scratch, products on the
    CUDA cores in full fp32, per row panel of `mlp_panel_rows`, on the
    plans' path; fc2's epilogue adds x only with `residual`."""
    K, H = _checked(_check_mlp_f32, "ln_mlp_residual_bt (float32)", x, gamma, beta, w1, b1, w2,
                    b2)
    M = x.numel() // K
    rows, p1, p2, elems = _ln_mlp_f32_spec(M, K, H, _cuda.sm_count(x.device), F32_TILE_FORCE,
                                           F32_SPLIT_FORCE, F32_PATH_FORCE, MLP_SCRATCH_ELEMS)
    buf, (xn, h, ws, wt) = f32_scratch(x.device, *elems)
    out = torch.empty_like(x)
    _cuda.LN_MLP_RESIDUAL_F32(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), xn, h, ws, wt, M, K, H, rows, float(eps),
        _cuda.ACTIVATIONS[activation], int(residual), p1.tile, p1.splits, p1.tail_rows, p2.tile,
        p2.splits, p2.tail_rows, p1.path,
    )
    return out


def _ln_mlp_residual_bt_cuda(x, gamma, beta, w1, b1, w2, b2, eps, activation, residual):
    if x.dtype == torch.float32:
        return _ln_mlp_residual_f32_cuda(x, gamma, beta, w1, b1, w2, b2, eps, activation,
                                         residual)
    name = "ln_mlp_residual_bt"
    K, H = _check_mlp_shapes(name, x, gamma, beta, w1, b1, w2, b2)
    _check_tma_k(name, K, H)
    M = x.numel() // K
    rows = mlp_panel_rows(M, H)
    n_sm = _cuda.sm_count(x.device)
    # one scratch for the LN rows (rows, K) and the hidden (rows, H): each
    # 16-byte aligned, as TMA needs (K % 8 == 0); without the residual fc2's
    # product in fp32, the bias added here
    out = torch.empty_like(x) if residual else torch.empty(x.shape, device=x.device)
    scratch = torch.empty(rows * (K + H), dtype=x.dtype, device=x.device)
    xn = scratch.data_ptr()
    _cuda.LN_MLP_RESIDUAL(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), xn, xn + 2 * rows * K, M, K, H,
        rows, float(eps), _cuda.ACTIVATIONS[activation], int(residual),
        gemm_tile_n(rows, H, n_sm, activation is not None), gemm_tile_n(rows, K, n_sm),
    )
    return out if residual else out.add_(b2.float())


# Rows per partial sum of the backward's weight side (csrc/ln_mlp_residual_bwd.cu):
# dgamma/dbeta per block of the LN-backward row pass, db1 per consumer
# warpgroup of the dual GEMM (half a 128-row tile).
MLP_BWD_LN_ROWS = 32
MLP_BWD_DB1_ROWS = 64


def ln_mlp_residual_bt_bwd(x, gamma, beta, w1, b1, w2, b2, g, eps=1e-6,
                           activation="gelu_tanh", weights=True, residual=True):
    """The backward of `ln_mlp_residual_bt`: the kernel for CUDA tensors
    (TPU kernel #6: per row panel of `mlp_panel_rows`, the LN row pass, the
    dual GEMM for dh, dxn = dh . W1 and the LN-backward rows, one count),
    `ln_mlp_residual_bt_bwd_ref` for CPU tensors. With `weights` the kernel
    also keeps xn and dh for every row, writes act(pre1) and the
    dgamma/dbeta/db1 partials, and dw1 = dh^T.xn, dw2 = g^T.act(pre1) are
    `torch.matmul` products (the JAX wrapper leaves them to XLA). x in
    float32 runs the fp32 instance (`_ln_mlp_residual_bwd_f32_cuda`).
    Without `residual` (the forward's residual-free form) the LN-backward
    rows add no g term."""
    name = "ln_mlp_residual_bt_bwd"
    if not _cuda.use_kernel(name, x, gamma, beta, w1, b1, w2, b2, g):
        return ln_mlp_residual_bt_bwd_ref(x, gamma, beta, w1, b1, w2, b2, g, eps, activation,
                                          weights, residual)
    if x.dtype == torch.float32:
        return _ln_mlp_residual_bwd_f32_cuda(x, gamma, beta, w1, b1, w2, b2, g, eps, activation,
                                             weights, residual)
    K, H = _check_mlp_shapes(name, x, gamma, beta, w1, b1, w2, b2)
    _check_tma_k(name, K, H)
    _cuda.check_dtype(name, torch.bfloat16, g)
    if g.shape != x.shape:
        raise ValueError(f"{name}: gradient {g.shape} vs x {x.shape}")
    M = x.numel() // K
    rows = mlp_panel_rows(M, H)
    # xn and dh hold every row when the weight products read them, else one
    # panel's; the rows' (mean, rstd) and dxn one panel's
    R = M if weights else rows

    def e(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=x.device)

    xn, dh, stats, dxn = e(R, K, dt=x.dtype), e(R, H, dt=x.dtype), e(rows, 2), e(rows, K)
    dx = torch.empty_like(x)
    side = [None] * 4
    if weights:
        # db1's partials: per warpgroup of each 128-row tile, the last one's second
        # holding zeros when no row reaches it
        side = [e(M, H, dt=x.dtype), e(-(-M // MLP_BWD_LN_ROWS), K),
                e(-(-M // MLP_BWD_LN_ROWS), K),
                e(-(-M // GEMM_BM) * (GEMM_BM // MLP_BWD_DB1_ROWS), H)]
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    _cuda.LN_MLP_RESIDUAL_BWD(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), g.data_ptr(), dx.data_ptr(), xn.data_ptr(), dh.data_ptr(), stats.data_ptr(),
        dxn.data_ptr(),
        *map(ptr, side), M, K, H, rows, float(eps), _cuda.ACTIVATIONS[activation],
        int(residual), gemm_tile_n(rows, K, _cuda.sm_count(x.device)),
    )
    if not weights:
        return dx, None, None, None, None, None, None
    hact, dga, dbe, db1 = side
    g2 = g.reshape(M, K)
    return (dx, dga.sum(0).to(gamma.dtype), dbe.sum(0).to(beta.dtype),
            torch.matmul(dh.t(), xn).to(w1.dtype), db1.sum(0).to(b1.dtype),
            torch.matmul(g2.t(), hact).to(w2.dtype), g2.float().sum(0).to(b2.dtype))


@functools.lru_cache(maxsize=None)
def _ln_mlp_bwd_f32_spec(M: int, K: int, H: int, n_sm: int, weights: bool, *forced) -> tuple:
    """#6's row panel, its plans on one path (`f32_mlp_bwd_plans`) and its
    scratch's floats: xn, dh, dxn, g^T and W1^T (path 1), the split-K
    workspace and the rows' statistics, over R rows (M with the weight
    side, else the panel's); on path 1 xn, dh and g^T MN-major, (K, H and
    K) x mn_ld(rows). `forced`: the F32_*_FORCE settings and
    MLP_SCRATCH_ELEMS, part of the cache's key."""
    rows = mlp_panel_rows(M, H)
    p1, p2 = f32_mlp_bwd_plans(M, rows, K, H, n_sm, weights)
    R = M if weights else rows
    ld, gt, wt = (R, 0, 0) if p1.path == 0 else (mn_ld(rows), K * mn_ld(rows), H * K)
    return rows, p1, p2, (K * ld, H * ld, R * K, gt, wt, max(p1.ws_elems, p2.ws_elems), 2 * R)


def _ln_mlp_residual_bwd_f32_cuda(x, gamma, beta, w1, b1, w2, b2, g, eps, activation, weights,
                                  residual):
    """The fp32 instance of #6 (MaPLe training's CLIP MLPs, SAM's MLPs in
    the fp32 train step; csrc/ln_mlp_residual_bwd_f32.cu): per row panel of
    `mlp_panel_rows` the LN row pass, dh_pre = g . W2, dh = act'(xn . W1^T +
    b1) * dh_pre and dxn = dh . W1 on the CUDA cores, then the LN-backward
    rows, on the plans' path; one count. With `weights` (path 0) the kernel
    keeps xn, dh, dxn and the rows' statistics for every row and writes
    act(pre1), and the weight side is formed here with torch."""
    name = "ln_mlp_residual_bt_bwd (float32)"
    K, H = _check_mlp_shapes(name, x, gamma, beta, w1, b1, w2, b2, torch.float32)
    _check_f32_widths(name, K, H)
    _cuda.check_dtype(name, torch.float32, g)
    if g.shape != x.shape:
        raise ValueError(f"{name}: gradient {g.shape} vs x {x.shape}")
    M = x.numel() // K
    rows, p1, p2, elems = _ln_mlp_bwd_f32_spec(M, K, H, _cuda.sm_count(x.device), weights,
                                               F32_TILE_FORCE, F32_SPLIT_FORCE, F32_PATH_FORCE,
                                               MLP_SCRATCH_ELEMS)
    buf, (xn, dh, dxn, gt, wt, ws, stats) = f32_scratch(x.device, *elems)
    hact = torch.empty((M, H), dtype=torch.float32, device=x.device) if weights else None
    dx = torch.empty_like(x)
    _cuda.LN_MLP_RESIDUAL_BWD_F32(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), g.data_ptr(), dx.data_ptr(), xn, dh, stats, dxn, _ptr(hact), ws, gt, wt,
        M, K, H, rows, float(eps), _cuda.ACTIVATIONS[activation], int(residual), p1.tile,
        p1.splits, p1.tail_rows, p2.tile, p2.splits, p2.tail_rows, p1.path,
    )
    if not weights:
        return dx, None, None, None, None, None, None
    part = buf.split(elems)
    xn, dh, dxn, stats = (part[i].view(M, -1) for i in (0, 1, 2, 6))
    xhat = (x.reshape(M, K) - stats[:, :1]) * stats[:, 1:]
    g2 = g.reshape(M, K)
    return (dx, (dxn * xhat).sum(0), dxn.sum(0), torch.matmul(dh.t(), xn), dh.sum(0),
            torch.matmul(g2.t(), hact), g2.sum(0))


class LnMlpResidual(torch.autograd.Function):
    """`ln_mlp_residual_bt` with its hand-written backward; keeps only its
    inputs, as the JAX custom_vjp does."""

    @staticmethod
    def forward(ctx, fwd, x, gamma, beta, w1, b1, w2, b2, eps, activation, residual):
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2)
        ctx.eps, ctx.activation, ctx.residual = eps, activation, residual
        return fwd(x, gamma, beta, w1, b1, w2, b2, eps, activation, residual)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, w1, b1, w2, b2 = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:8]
        # the kernel reads g as rows of x's type (an fp32 partial's gradient
        # is a cast bf16 one): a non-contiguous gradient is copied here
        grads = ln_mlp_residual_bt_bwd(x, gamma, beta, w1, b1, w2, b2,
                                       g.to(x.dtype).contiguous(),
                                       ctx.eps, ctx.activation, weights=any(needs[1:]),
                                       residual=ctx.residual)
        return (None, *(d if n else None for d, n in zip(grads, needs)), None, None, None)


def ln_mlp_residual_bt(
    x: torch.Tensor,      # (B', S, K) — also the residual
    gamma: torch.Tensor,  # (K,)
    beta: torch.Tensor,   # (K,)
    w1: torch.Tensor,     # (H, K)
    b1: torch.Tensor,     # (H,)
    w2: torch.Tensor,     # (K, H)
    b2: torch.Tensor,     # (K,)
    eps: float = 1e-6,
    activation: str = "gelu_tanh",
    residual: bool = True,
) -> torch.Tensor:
    """x + act(LN(x) . w1^T + b1) . w2^T + b2: on the card the LN row pass,
    fc1 and fc2 with the residual, one entry point, the hidden in a scratch
    of at most MLP_SCRATCH_ELEMS elements (row panels beyond). Counterpart of
    `ln_mlp_residual_bt` (TPU kernels #4 and #5; `hidden_grid` is a TPU
    tiling knob and has no counterpart), with the backward of #6 when a
    gradient is wanted. x in bfloat16 runs the TMA + wgmma kernels, x in
    float32 their fp32 instances (`_ln_mlp_residual_f32_cuda`,
    `_ln_mlp_residual_bwd_f32_cuda`). `residual=False` returns a
    tensor-parallel rank's partial: fc2's product with its bias, without x,
    in fp32 and unrounded (the kernel's accumulator), and the backward has
    no g term."""
    tensors = (x, gamma, beta, w1, b1, w2, b2)
    fwd = autograd.forward_fn("ln_mlp_residual_bt", _ln_mlp_residual_bt_cuda,
                              ln_mlp_residual_bt_ref, tensors)
    if autograd.wants_grad(*tensors):
        return LnMlpResidual.apply(fwd, *tensors, eps, activation, residual)
    return fwd(*tensors, eps, activation, residual)


# --------------------------------------------------------------- proj_rows


# TMA strides are multiples of 16 bytes: the d-major rows' stride in bf16
DMAJOR_ALIGN = 8


def dmajor_empty(*shape: int, dtype: torch.dtype, device) -> torch.Tensor:
    """An uninitialised d-major (..., K, S) tensor as `proj_rows` reads it
    on the card: the view [..., :S] of (..., K, S8), S8 = S rounded up to a
    multiple of DMAJOR_ALIGN. The attention kernels write their output into
    it; no kernel reads the pad columns."""
    *lead, S = shape
    s8 = -(-S // DMAJOR_ALIGN) * DMAJOR_ALIGN
    return torch.empty(*lead, s8, dtype=dtype, device=device)[..., :S]


def proj_rows_ref(x, w, b, res=None, partial=False):
    acc = _matmul_f32(x.transpose(-1, -2), w) + b.float()
    if res is not None:
        acc = acc + res.float()
    return acc if partial else acc.to(x.dtype)


def proj_rows(
    x: torch.Tensor,                      # (B, T, K, S) — d-major attention output
    w: torch.Tensor,                      # (N, K)
    b: torch.Tensor,                      # (N,)
    res: Optional[torch.Tensor] = None,   # (B, T, S, N)
    partial: bool = False,
) -> torch.Tensor:
    """out[b, t, s, :] = x[b, t, :, s] . w^T + b (+ res) -> (B, T, S, N).
    Counterpart of `proj_rows` (TPU kernel #7). On the card x is read as it
    lies (by TMA in bfloat16; in 16-byte loads by the fp32 instance): its
    last stride 1, its row and (B, T) group strides multiples of
    DMAJOR_ALIGN (the attention wrappers' `dmajor_empty` output); anything
    else raises. `partial` (no `res`): the output in fp32, unrounded, a
    tensor-parallel rank's partial that its caller sums over the ranks."""
    return autograd.run("proj_rows", _proj_rows_cuda, proj_rows_ref, (x, w, b, res), (partial,),
                        strided=1)


def _group_stride(x: torch.Tensor) -> Optional[int]:
    """The stride of x's (B, T) groups flattened into one, None if they do
    not flatten."""
    B, T = x.shape[:2]
    if T == 1:
        return x.stride(0)
    if B == 1 or x.stride(0) == T * x.stride(1):
        return x.stride(1)
    return None


def _dmajor_strides(name, x):
    """x's row and (B, T) group strides, which the kernels read as they lie."""
    ldk, ldg = x.stride(2), _group_stride(x)
    if x.stride(3) != 1 or ldk % DMAJOR_ALIGN or ldg is None or ldg % DMAJOR_ALIGN:
        raise ValueError(f"{name}: CUDA kernel reads x by TMA: last stride 1, row and group "
                         f"strides multiples of {DMAJOR_ALIGN}, got strides {x.stride()}")
    return ldk, ldg


def _proj_rows_f32_cuda(x, w, b, res):
    """The fp32 instance (MaPLe training's vision out-projection,
    csrc/proj_rows_f32.cu): x read as it lies in 16-byte loads along s."""
    name = "proj_rows (float32)"
    _cuda.check_dtype(name, torch.float32, x, w, b, *([res] if res is not None else []))
    B, T, K, S = x.shape
    N = w.shape[0]
    if w.shape != (N, K) or b.shape != (N,) or (res is not None and res.shape != (B, T, S, N)):
        raise ValueError(f"{name}: shapes x {x.shape} w {w.shape}")
    ldk, ldg = _dmajor_strides(name, x)
    _check_f32_widths(name, K, N)
    out = torch.empty((B, T, S, N), dtype=x.dtype, device=x.device)
    plan = f32_gemm_plan(S, N, K, _cuda.sm_count(x.device), B * T, mn_groups=True)
    ws = f32_workspace(x.device, plan)
    _cuda.PROJ_ROWS_F32(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(res), out.data_ptr(), _ptr(ws), B * T, S,
        ldk, ldg, K, N, plan.tile, plan.splits, plan.tail_rows, int(plan.flat),
    )
    return out


def _proj_rows_cuda(x, w, b, res, partial=False):
    if x.dtype == torch.float32:  # the fp32 instance's output is the partial
        return _proj_rows_f32_cuda(x, w, b, res)
    _cuda.check_dtype("proj_rows", torch.bfloat16, x, w, b, *([res] if res is not None else []))
    B, T, K, S = x.shape
    N = w.shape[0]
    if w.shape != (N, K) or b.shape != (N,) or (res is not None and res.shape != (B, T, S, N)):
        raise ValueError(f"proj_rows: shapes x {x.shape} w {w.shape}")
    ldk, ldg = _dmajor_strides("proj_rows", x)
    _check_tma_k("proj_rows", K)
    if (res is not None or partial) and N % 8:
        raise ValueError(f"proj_rows: CUDA kernel takes N % 8 == 0 with the residual or a "
                         f"partial, got {N}")
    if partial and res is not None:
        raise ValueError("proj_rows: a partial takes no residual")
    out = torch.empty((B, T, S, N), dtype=torch.float32 if partial else x.dtype, device=x.device)
    _cuda.PROJ_ROWS(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        res.data_ptr() if res is not None else None, out.data_ptr(),
        B * T, S, ldk, ldg, K, N, int(partial),
        gemm_tile_n(S, N, _cuda.sm_count(x.device), False, B * T),
    )
    return out.add_(b.float()) if partial else out


# ---------------------------------------------------------- proj_from_heads


def proj_from_heads_ref(x, w, b, res=None, partial=False):
    B, heads, T, S, d = x.shape
    rows = x.permute(0, 2, 3, 1, 4).reshape(B, T, S, heads * d)  # k = h*d + j
    return proj_rows_ref(rows.transpose(-1, -2), w, b, res, partial)


def proj_from_heads_res(
    x: torch.Tensor,    # (B, heads, T, S, d) — head-leading attention output
    w: torch.Tensor,    # (N, heads*d)
    b: torch.Tensor,    # (N,)
    res: torch.Tensor,  # (B, T, S, N) — the block's residual
) -> torch.Tensor:
    """out[b, t, s, :] = sum_h x[b, h, t, s, :] . w[:, h*d:(h+1)*d]^T + b + res
    -> (B, T, S, N). Counterpart of `proj_from_heads_res` (TPU kernel #8).
    The kernel (`csrc/proj_rows.cu`) is the persistent GEMM with x as a
    K-major A split by head; it takes d % 8 == 0 and N % 8 == 0 (the
    residual's epilogue), else a CUDA tensor raises ValueError. In float32
    its fp32 instance (`csrc/proj_rows_f32.cu`, the tiled FFMA product with a
    head-leading A, `proj_heads_f32_layout`; d % 4 == 0, N % 4 == 0)."""
    return autograd.run("proj_from_heads_res", _proj_heads_res_cuda, proj_from_heads_ref,
                        (x, w, b, res))


def proj_from_heads(
    x: torch.Tensor,  # (B, heads, T, S, d)
    w: torch.Tensor,  # (N, heads*d)
    b: torch.Tensor,  # (N,)
    partial: bool = False,
) -> torch.Tensor:
    """`proj_from_heads_res` without the residual. Counterpart of
    `proj_from_heads` (TPU kernel #9), which no path of the JAX package
    calls; the kernel is #8's, with its own launch count. The port's
    tensor-parallel ranks call it with `partial` (fp32 out, unrounded, as
    `proj_rows`')."""
    return autograd.run("proj_from_heads", _proj_heads_cuda, proj_from_heads_ref, (x, w, b),
                        (None, partial))


def proj_heads_f32_layout(B: int, heads: int, T: int, S: int, d: int) -> dict:
    """The arguments the fp32 #8/#9 (`cvlm_proj_from_heads_f32`) read the
    head-leading x (B, heads, T, S, d) by: one group an image (G = B, group
    stride `sa`), its M = T*S rows, K = heads*d columns of the A the product
    takes, A[m, h*d + j] = x[b, h, t, s, j] at `heads_a_offset`."""
    return dict(G=B, M=T * S, d=d, sa=heads * T * S * d, K=heads * d)


def heads_a_offset(g: int, m: int, k: int, M: int, d: int, sa: int) -> int:
    """The element of x that row m, column k of group g of the head-leading A
    reads (csrc/sgemm_f32.cuh K_HEADS): (k // d) M d + m d + k % d past the
    group's start."""
    return g * sa + (k // d) * M * d + m * d + k % d


def _proj_heads_f32_launch(kernel, x, w, b, res):
    name = kernel.name
    _cuda.check_dtype(name, torch.float32, x, w, b, *([res] if res is not None else []))
    B, heads, T, S, d = x.shape
    N = w.shape[0]
    if (w.shape != (N, heads * d) or b.shape != (N,)
            or (res is not None and res.shape != (B, T, S, N))):
        raise ValueError(f"{name}: shapes x {x.shape} w {w.shape}")
    if d % 4 or N % 4:
        raise ValueError(f"{name}: CUDA kernel takes d % 4 == 0 and N % 4 == 0 (16-byte loads "
                         f"and epilogue rows), got d={d}, N={N}")
    lay = proj_heads_f32_layout(B, heads, T, S, d)
    out = torch.empty((B, T, S, N), dtype=x.dtype, device=x.device)
    plan = f32_gemm_plan(lay["M"], N, lay["K"], _cuda.sm_count(x.device), lay["G"])
    ws = f32_workspace(x.device, plan)
    kernel(x.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(res), out.data_ptr(), _ptr(ws),
           lay["G"], lay["M"], lay["d"], lay["sa"], lay["K"], N, plan.tile, plan.splits,
           plan.tail_rows)
    return out


def _proj_heads_launch(kernel, f32_kernel, x, w, b, res, partial=False):
    if x.dtype == torch.float32:
        return _proj_heads_f32_launch(f32_kernel, x, w, b, res)
    _cuda.check_dtype(kernel.name, torch.bfloat16, x, w, b, *([res] if res is not None else []))
    B, heads, T, S, d = x.shape
    N = w.shape[0]
    if (w.shape != (N, heads * d) or b.shape != (N,) or d % 8
            or (res is not None and res.shape != (B, T, S, N))):
        raise ValueError(f"{kernel.name}: shapes x {x.shape} w {w.shape} (d a multiple of 8)")
    if (res is not None or partial) and N % 8:
        raise ValueError(f"{kernel.name}: CUDA kernel takes N % 8 == 0 with the residual or a "
                         f"partial, got {N}")
    out = torch.empty((B, T, S, N), dtype=torch.float32 if partial else x.dtype, device=x.device)
    kernel(x.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr() if res is not None else None,
           out.data_ptr(), B, heads, T, S, d, N, int(partial),
           gemm_tile_n(T * S, N, _cuda.sm_count(x.device), False, B))
    return out.add_(b.float()) if partial else out


def _proj_heads_res_cuda(x, w, b, res):
    return _proj_heads_launch(_cuda.PROJ_HEADS_RES, _cuda.PROJ_HEADS_RES_F32, x, w, b, res)


def _proj_heads_cuda(x, w, b, res=None, partial=False):
    return _proj_heads_launch(_cuda.PROJ_HEADS, _cuda.PROJ_HEADS_F32, x, w, b, None, partial)
