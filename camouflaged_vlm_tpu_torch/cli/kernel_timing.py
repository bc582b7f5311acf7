"""Time the GEMM and attention kernels of one checkout on the card.

  python camouflaged_vlm_tpu_torch/cli/kernel_timing.py [--root DIR] [--label NAME]
                                                      [--padded-calls]
                                                      [--f32-attention [--against FILE]]
                                                      [--f32-gemm [--tiles] [--against FILE]]
                                                      [--global-bwd [--against FILE]]

Imports `camouflaged_vlm_tpu_torch` from the checkout at --root (default:
this one), builds its kernels there, and times each case of `cases()`
through the checkout's public wrapper at the main path's bf16 shapes,
batch 2: #1 `linear_act` at the patch embed's shape; #2, #3 and #4/#5 at
every shape of `chip_smoke.ln_gemm_shapes`; #7 `proj_rows` at every shape
of `chip_smoke.proj_rows_shapes` (x d-major, in the padded layout on a
checkout that has it, `ops/linear.py dmajor_empty`, else contiguous); #16,
#13, #15 and #17 at CLIP's, SAM's windows', edge windows' and global
blocks'; last, the padded carry's #12 (window 16) and #11 (window 17) and
#19 (the 64 x 64 grid), `padded_carry_cases`; after them the attention
backward at the training path's shapes, #14 at the interior windows and #18
at the global blocks (`backward_cases`: errors per output, no library call,
and the device time of each of the call's kernels, from torch.profiler);
last the MLP backward #6 at SAM's three sites and with the weight
gradients, and the 'aug_flash' global attention #20 (`mlp_aug_cases`);
then #10 at SAM ViT-B's windows and global blocks and #8/#9 at the padded
carry's window 17 (`relpos_heads_cases`).
Each case prints one JSON line:
the error against the plain version; the idle-card median and the queued
time (`chip_smoke.time_ms`); the host's microseconds a call
(`chip_smoke.host_us`) through the wrapper and through its `CudaKernel`
alone, replaying the arguments the wrapper passed; one PyTorch call beside
it (SDPA for attention, #15's with the pad key as one more key,
`library_ms`; for the GEMMs the same products alone through F.linear or,
for #7, torch.matmul, `gemm_library_ms`, another function). On a checkout
with the GEMM template (`ops/linear.py gemm_tile_n`) also the queued time
at each tile width (the replay with the width changed; #7's on a checkout
where it runs on the template) and of the template passes alone through
`linear_act`. A last line sums launches x host us
over a batch-2 cascade call's launches at the timed shapes. The first
line gives the card's name and power limit and the registers, spills and
shared memory ptxas gave each kernel. Two checkouts compare on one card
in one call when their runs alternate (parent, change, change, parent).
With --padded-calls it times, instead of the kernels, the checkout's
window-16, window-17 and ViT-B cascade calls by stage and traces one
batch-2 call of each (`padded_calls`): the card's busy time that #12, #11 +
#8 and #10 move. With --f32-attention it runs, instead, every user of
csrc/attn_f32.cuh's fp32 loop at every shape of its paths
(`f32_attention_cases`: #16 at MaPLe's 8 x 581 and the cascade's 1 and 2 x
581; #13, #15, #17 at SAM ViT-H batch 1 and 2; #20 at 'aug_flash' batch 1
and 2; #12 at window 16, #11 at window 17 and #10 at ViT-B's windows and
global blocks, batch 1 and 2; #19 on the 64 x 64 grid; then the backwards
#14 and #18 at batch 2) on seeded inputs, one JSON line each with the
SHA-256 of its output bytes, its error against the plain version, both
clocks, the host's microseconds a call through the wrapper and through its
CudaKernel alone, the library call's times (chip_smoke.py's), its bound
and, on a checkout with the loop's tile plan, the tile it took (--tiles:
the queued time at each tile, forced); the backwards' device ms by kernel,
from torch.profiler; --against FILE (another checkout's lines) adds
whether each output is bit-equal to that checkout's. With --f32-gemm it does the same for every
user of csrc/sgemm_f32.cuh (#1, #2, #3, #4/#5, #6, #7, #8/#9) at every shape
of its paths (`f32_gemm_cases`), each line with its error against the plain
version, both clocks, each launch's device ms (`kernel_launches_ms`) and,
on a checkout with the fp32 tile plan, the plans the call took (--tiles:
the queued time at each tile, forced). With --global-bwd it hashes and times
the bf16 #18 alone at its three paths' shapes (`global_bwd`), so that a
parent and a change of csrc/attn_bwd.cu compare bit for bit and by time.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _smoke():
    """This checkout's chip_smoke.py, for its timing helpers and shapes."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_usage(log: str) -> dict:
    """Registers, spills and static shared memory of each kernel
    instantiation in an nvcc -Xptxas -v log."""
    out, lines = {}, log.splitlines()
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(_ZN4cvlm\S*)'", ln)
        if m:
            out[m.group(1)] = "; ".join(x.strip() for x in lines[i + 1:i + 4]
                                        if "Used" in x or "spill" in x)
    return out


@dataclass
class Case:
    name: str            # the wrapper's kernel name (its CudaKernel's)
    site: str
    shape: list
    call: Callable       # the wrapper on its inputs
    plain: Callable      # its plain version on the same inputs
    kernel: str          # the CudaKernel's attribute in ops/_cuda.py
    library: Optional[Callable]  # one PyTorch call beside it, or None (the backwards)
    library_key: str     # "library" (same function) or "gemm_library" (its products alone)
    per_call: int        # launches in a batch-2 cascade call at this shape
    widths: Dict[str, int] = field(default_factory=dict)  # GEMM pass -> tile-width argument
    passes: Dict[str, Callable] = field(default_factory=dict)  # template passes alone
    outputs: tuple = ("dqkv", "drel")  # a backward's outputs, by name


def entry_replay(kernel, call):
    """Run `call` once, keeping the arguments it passed to `kernel`'s C entry
    point; return (its output, replay), where replay(widths) is a
    zero-argument launch of those arguments through the CudaKernel object
    (its stream, error check and count), with the tile widths of `widths`
    ({argument position: width}) swapped in. The replays write into that
    output, held by the caller, and into the wrapper's scratch, which has
    gone back to PyTorch's caching allocator on this stream: whatever reuses
    it later on the stream runs behind them."""
    call()  # binds kernel._fn
    fn, seen = kernel._fn, []
    kernel._fn = lambda *a: seen.append(a) or fn(*a)
    try:
        out = call()
    finally:
        kernel._fn = fn
    args = seen[-1][:-1]  # the stream is the CudaKernel's own

    def replay(widths: Optional[dict] = None):
        a = list(args)
        for pos, bn in (widths or {}).items():
            a[pos] = bn
        return lambda: kernel(*a)

    return out, replay


def cases(smoke, rn, template: bool):
    """The timed cases (`Case`) on seeded random inputs."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops import linear as lin
    from camouflaged_vlm_tpu_torch.ops.compact_window import (
        LPAD_LANE, NEG, CompactGeometry, edge_consts,
    )

    F = torch.nn.functional
    sites = smoke.per_call_sites()
    x, w, b = rn(8192, 768), rn(1280, 768, std=0.02), rn(1280, std=0.02)
    out = [Case("linear_act", "patch embed", [8192, 768, 1280], lambda: lin.linear_act(x, w, b),
                lambda: lin.linear_act_ref(x, w, b), "LINEAR_ACT", lambda: F.linear(x, w, b),
                "library", 1, {"gemm": -1})]
    kernels = {"ln_linear_act_bt": "LN_LINEAR", "ln_mask_linear_bt": "LN_MASK_LINEAR",
               "ln_mlp_residual_bt": "LN_MLP_RESIDUAL"}
    for kernel, site, _, lead, K, N, eps, act in smoke.ln_gemm_shapes(batches=(2,)):
        kfn, pfn, a, _, gemm = smoke.ln_gemm_case(rn, kernel, lead, K, N, eps, act)
        c = Case(kernel, site, [*lead, K, N], lambda kfn=kfn, a=a: kfn(*a),
                 lambda pfn=pfn, a=a: pfn(*a), kernels[kernel], gemm, "gemm_library",
                 sites.get(site, 0))
        if template:  # the passes on rows that stand in for the LN pass's output
            rows = a[0].reshape(-1, K)
            if kernel == "ln_mlp_residual_bt":
                w1, b1, w2, b2 = a[3:7]
                h = lin.linear_act(rows, w1, b1, act)
                c.widths = {"fc1": -2, "fc2": -1}
                c.passes = {"fc1": lambda rows=rows, w1=w1, b1=b1, act=act:
                            lin.linear_act(rows, w1, b1, act),
                            "fc2": lambda h=h, w2=w2, b2=b2: lin.linear_act(h, w2, b2)}
            else:
                c.widths = {"gemm": -1}
                c.passes = {"gemm": lambda rows=rows, w=a[-2], b=a[-1]: lin.linear_act(rows, w, b)}
        out.append(c)

    def sdpa(qkv, heads, d, scale, bias=None):
        r = qkv.reshape(qkv.shape[:-1] + (3, heads, d))
        q, k, v = (r[..., i, :, :].transpose(-3, -2) for i in range(3))
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)

    B, NH, HD, WIN, G = 2, 16, 80, 14, 64
    sam, dev, bf = HD ** -0.5, torch.device("cuda"), torch.bfloat16
    qkv_clip = rn(B, 581, 3 * 1024)
    qkv_win, rel_win = rn(32, WIN * WIN, 3 * 1280), rn(WIN * WIN, 32, NH * 32)
    sel32 = fa.make_rel_scatter32(WIN, bf, dev)
    qkv_glob, rel_glob = rn(B, G * G, 3 * 1280), rn(G * G, B, NH, 2 * G)
    sel_glob = fa.make_rel_scatter(G, G, bf, dev)
    bias_win = torch.matmul(rel_win.reshape(WIN * WIN, 32, NH, 32).permute(1, 2, 0, 3), sel32)
    bias_glob = torch.matmul(rel_glob.permute(1, 2, 0, 3), sel_glob)
    out += [
        Case("flash_qkv_packed_plain", "CLIP", [B, 581, 3072],
             lambda: fa.flash_qkv_packed_plain(qkv_clip, 0.125, 16, 64),
             lambda: fa.flash_qkv_packed_plain_ref(qkv_clip, 0.125, 16, 64),
             "QKV_PACKED_PLAIN", sdpa(qkv_clip, 16, 64, 0.125), "library", sites["CLIP"]),
        Case("flash_qkv_packed_windows_s", "windows", [32, 196, 3840],
             lambda: fa.flash_qkv_packed_windows_s(qkv_win, rel_win, sel32, sam, NH, HD),
             lambda: fa.flash_qkv_packed_windows_s_ref(qkv_win, rel_win, sel32, sam, NH, HD),
             "QKV_WINDOWS", sdpa(qkv_win, NH, HD, sam, bias_win), "library", sites["windows"]),
        Case("flash_qkv_packed_global", "global", [B, 4096, 3840],
             lambda: fa.flash_qkv_packed_global(qkv_glob, rel_glob, sel_glob, sam, NH, HD, G, G),
             lambda: fa.flash_qkv_packed_global_ref(qkv_glob, rel_glob, sel_glob, sam, NH, HD),
             "QKV_GLOBAL", sdpa(qkv_glob, NH, HD, sam, bias_glob), "library", sites["global"]),
    ]
    # #15 and #7 last: the cases above allocate and draw their inputs in the
    # same order as on a checkout that times neither (an A/B's parent), and a
    # kernel's time moves with where its inputs lie
    geom = CompactGeometry(G, G, WIN)
    ne, R = geom.n_edge, geom.R_u
    edge_rel = rn(B, ne, R, NH, 32)
    off = 0
    for grp in geom.edge_groups:  # dummy rows' pad-key logit, as the encoder clamps it
        edge_rel[:, off : off + grp.n, grp.rows :, :, LPAD_LANE] = NEG
        off += grp.n
    sel_e, kmask_e = edge_consts(geom, bf, dev)
    edge = (rn(B, ne, R, 3 * 1280), edge_rel.reshape(B, ne, R, NH * 32), sel_e,
            rn(NH, HD, std=0.5), kmask_e)
    out.append(Case("flash_qkv_packed_edge", "edge", [B, ne, R, 3840],
                    lambda: fa.flash_qkv_packed_edge(*edge, sam, NH, HD),
                    lambda: fa.flash_qkv_packed_edge_ref(*edge, sam, NH, HD),
                    "QKV_EDGE", smoke.sdpa_edge(*edge, NH, HD, sam), "library", sites["edge"]))
    padded = hasattr(lin, "dmajor_empty")  # #7 on the template, its x padded
    for site, shape, N in smoke.proj_rows_shapes(B=2):
        pa, _, gemm = smoke.proj_rows_case(rn, shape, N, padded)
        out.append(Case("proj_rows", site, [*shape, N], lambda pa=pa: lin.proj_rows(*pa),
                        lambda pa=pa: lin.proj_rows_ref(*pa),
                        "PROJ_ROWS", gemm, "gemm_library", sites.get(site, 0),
                        {"gemm": -1} if template and padded else {}))
    return (out + padded_carry_cases(rn) + backward_cases(rn) + mlp_aug_cases(rn)
            + relpos_heads_cases(smoke, rn))


def backward_cases(rn):
    """The attention backward at batch 2, full width (16 heads x 80), as the
    train step runs it: #14 over the 32 interior windows of 196 keys (rel
    position-major, 32 lanes) and #18 over the 64 x 64 global grid, g d-major.
    No single PyTorch call computes either (drel), so no library time; they
    run in training only: `per_call` 0. Drawn last, after every forward case."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa

    B, NH, HD, WIN, G, nf, dev, bf = 2, 16, 80, 14, 64, 16, torch.device("cuda"), torch.bfloat16
    sam, S, N = HD ** -0.5, WIN * WIN, G * G
    win = (rn(B * nf, S, 3 * NH * HD), rn(S, B * nf, NH * 32), fa.make_rel_scatter32(WIN, bf, dev),
           rn(B * nf, NH * HD, S, std=0.05), sam, NH, HD)
    glob = (rn(B, N, 3 * NH * HD), rn(N, B, NH, 2 * G), fa.make_rel_scatter(G, G, bf, dev),
            rn(B, NH * HD, N, std=0.05), sam, NH, HD, G, G)
    return [Case("flash_qkv_packed_windows_s_bwd", "windows backward", [B * nf, S, 3 * NH * HD],
                 lambda: fa.flash_qkv_packed_windows_s_bwd(*win),
                 lambda: fa.flash_qkv_packed_windows_s_bwd_ref(*win),
                 "QKV_WINDOWS_BWD", None, "library", 0),
            Case("flash_qkv_packed_global_bwd", "global backward", [B, N, 3 * NH * HD],
                 lambda: fa.flash_qkv_packed_global_bwd(*glob),
                 lambda: fa.flash_qkv_packed_global_bwd_ref(*glob[:7]),
                 "QKV_GLOBAL_BWD", None, "library", 0)]


def mlp_aug_cases(rn):
    """The MLP backward #6 at SAM ViT-H's training sites, batch 2 (global
    blocks 2 x 4096, interior windows 32 x 196, edge windows 2 x 1008 rows of
    1280, H 5120, gelu_tanh, no weight gradients, as the frozen encoder runs
    it; and the windows with the weight gradients, whose two products are
    torch.matmul), and the 'aug_flash' global attention #20 (q_aug, k_aug
    (32, 4096, 208), v (32, 4096, 80)) beside SDPA at scale 1 on the same
    features. Drawn after every other case; neither runs in a call of the
    reference configuration: `per_call` 0."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    D, H = 1280, 5120
    sg, sb = 1 + rn(D, std=0.1, dtype=torch.float32), rn(D, std=0.1, dtype=torch.float32)
    w1, b1, w2, b2 = rn(H, D, std=0.02), rn(H, std=0.02), rn(D, H, std=0.02), rn(D, std=0.02)
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    # dxn's tile width, the C entry's last argument, on a checkout whose #6
    # runs on the GEMM template
    dxn_width = {"dxn": -1} if hasattr(lin, "MLP_BWD_DB1_ROWS") else {}
    out = []
    for site, lead, weights in (("global backward", (2, 4096), False),
                                ("windows backward", (32, 196), False),
                                ("edge backward", (2, 1008), False),
                                ("windows backward, weight grads", (32, 196), True)):
        a = (rn(*lead, D), sg, sb, w1, b1, w2, b2, rn(*lead, D, std=0.05))
        out.append(Case("ln_mlp_residual_bt_bwd", site, [*lead, D, H],
                        lambda a=a, w=weights: lin.ln_mlp_residual_bt_bwd(*a, weights=w),
                        lambda a=a, w=weights: lin.ln_mlp_residual_bt_bwd_ref(*a, weights=w),
                        "LN_MLP_RESIDUAL_BWD", None, "library", 0, widths=dxn_width,
                        outputs=names))
    BB, N, dqk, dv = 32, 4096, 208, 80
    q, k, v = rn(BB, N, dqk, std=dqk ** -0.5), rn(BB, N, dqk), rn(BB, N, dv)
    out.append(Case("flash_attention_fullk", "aug_flash global", [BB, N, dqk, dv],
                    lambda: fa.flash_attention_fullk(q, k, v),
                    lambda: fa.flash_attention_fullk_ref(q, k, v), "ATTN_FULLK",
                    lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1.0),
                    "library", 0))
    return out


def relpos_heads_cases(smoke, rn):
    """#10 at SAM ViT-B's unfused 'flash' blocks, batch 2 (the windowed
    blocks' 600 problems of 196 tokens, 28 rel lanes; the global blocks' 24
    of 4096), beside SDPA with the bias rel @ sel materialised apart (as
    `chip_smoke.split_attention_kernels`); and #8/#9 at the padded carry's
    window 17 (`chip_smoke.proj_heads_case`) beside the product alone through
    torch.einsum, at each tile width on a checkout whose C entry takes one,
    and the same product on the template with x as plain (B T S, heads d)
    rows (#1's `linear_act`, bias only: pass "rows"), which tells the cost
    of the head-by-head K walk from the template's own. Drawn after every
    other case. Neither runs in a call of the reference
    configuration: `per_call` 0."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import _cuda
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    F, bf, dev = torch.nn.functional, torch.bfloat16, torch.device("cuda")
    out = []
    for site, BB, H in (("ViT-B windows", 2 * 25 * 12, 14), ("ViT-B global", 2 * 12, 64)):
        N = H * H
        a = (rn(BB, N, 64, std=0.125), rn(BB, N, 64), rn(BB, N, 64), rn(BB, N, 2 * H),
             fa.make_rel_scatter(H, H, bf, dev))
        bias = torch.matmul(a[3], a[4])
        out.append(Case("flash_attention_relpos", site, [BB, N, 64, 2 * H],
                        lambda a=a, H=H: fa.flash_attention_relpos(*a, H, H),
                        lambda a=a: fa.xla_attention_relpos(*a), "ATTN_RELPOS",
                        lambda a=a, bias=bias: F.scaled_dot_product_attention(
                            a[0], a[1], a[2], attn_mask=bias, scale=1.0),
                        "library", 0))
    args, _, gemm = smoke.proj_heads_case(rn)
    widths = {"gemm": -1} if len(_cuda.PROJ_HEADS.argtypes) > 12 else {}  # C entry takes bn
    x, w, b = args[:3]
    rows = x.permute(0, 2, 3, 1, 4).reshape(-1, w.shape[1]).contiguous()
    for name, kernel, a in (("proj_from_heads_res", "PROJ_HEADS_RES", args),
                            ("proj_from_heads", "PROJ_HEADS", args[:3])):
        out.append(Case(name, "padded windows 17", [2, 16, 16, 289, 80, 1280],
                        lambda f=getattr(lin, name), a=a: f(*a),
                        lambda a=a: lin.proj_from_heads_ref(*a), kernel, gemm, "gemm_library", 0,
                        widths, {"rows": lambda: lin.linear_act(rows, w, b)}))
    return out


def case_errors(smoke, got, want, names=("dqkv", "drel")):
    """The errors against the plain version; a backward's per output (by
    `names`; those the call does not compute left out), with the larger of
    each beside them."""
    if not isinstance(got, tuple):
        return smoke.errors(got, want)
    per = {n: smoke.errors(a, b) for n, a, b in zip(names, got, want) if b is not None}
    return {**{k: max(e[k] for e in per.values()) for k in ("max_abs_err", "max_rel", "mean_rel")},
            "per_output": per}


def kernel_launches_ms(call, iters=5):
    """Device ms of each launch of one `call`, in launch order: each of
    `iters` calls (after one more) traced on its own by torch.profiler, and
    each launch's time averaged over the traces that hold the most common
    number of launches: [kernel name with its template arguments, ms]; []
    where no trace holds device time."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    traces = []
    for _ in range(iters):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA and "cvlm" in e.name),
                     key=lambda e: e.time_range.start)
        traces.append([(re.sub(r"\(.*$", "", re.sub(
            r"\(anonymous namespace\)::|cvlm::|f32::|^void ", "", e.name)),
            e.time_range.elapsed_us() / 1e3) for e in evs])
    n = collections.Counter(len(t) for t in traces).most_common(1)[0][0]
    traces = [t for t in traces if len(t) == n]
    return [[traces[0][i][0], sum(t[i][1] for t in traces) / len(traces)] for i in range(n)]


def kernel_device_ms(call, iters=5):
    """Device ms a call of each kernel `call` launches, by kernel name
    (`kernel_launches_ms` summed over the launches of each name, template
    arguments dropped)."""
    out = {}
    for name, ms in kernel_launches_ms(call, iters):
        name = re.sub(r"<.*$", "", name)
        out[name] = out.get(name, 0.0) + ms
    return out


def padded_carry_cases(rn):
    """#12 at window 16 (16 windows of 256 tokens, rel window-major), #11
    at window 17 (16 windows of 289 tokens, rel (.., heads, 34)) and #19 on
    the 64 x 64 grid, batch 2, 16 heads x 80, each beside SDPA on views of
    the packed rows with the bias rel @ sel materialised apart (as
    `chip_smoke.padded_sites`). Drawn after every other case, so that the
    others' inputs lie as on a checkout without these cases. None of the
    three runs in a call of the reference configuration (window 14):
    `per_call` 0."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa

    B, NH, HD, dev, bf = 2, 16, 80, torch.device("cuda"), torch.bfloat16
    sam = HD ** -0.5

    def sdpa(q, k, v, bias):
        q, k, v, bias = (t.flatten(0, -4) for t in (q, k, v, bias))  # 4D, copied here
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=sam)

    win, nwin = 16, 16
    Nw = win * win
    qkv, rel = rn(B, nwin, Nw, 3 * NH * HD), rn(B, nwin, Nw, NH * 32)
    sel32 = fa.make_rel_scatter32(win, bf, dev)
    r = qkv.reshape(B, nwin, Nw, 3, NH, HD)
    q, k, v = (r[:, :, :, i].transpose(2, 3) for i in range(3))  # (B, nwin, NH, Nw, HD)
    bias = torch.matmul(rel.reshape(B, nwin, Nw, NH, 32).transpose(2, 3), sel32)
    out = [Case("flash_qkv_packed_windows", "padded windows 16", [B, nwin, Nw, 3 * NH * HD],
                lambda: fa.flash_qkv_packed_windows(qkv, rel, sel32, sam, NH, HD),
                lambda: fa.flash_qkv_packed_windows_ref(qkv, rel, sel32, sam, NH, HD),
                "QKV_WINDOWS_PADDED", sdpa(q, k, v, bias), "library", 0)]
    for name, kernel, site, lead, H in (
            ("flash_qkv_relpos_windows", "QKV_RELPOS_WINDOWS", "padded windows 17", (B, 16), 17),
            ("flash_qkv_relpos_global", "QKV_RELPOS_GLOBAL", "grid 64 (no path)", (B,), 64)):
        N = H * H
        qkv5, rel5 = rn(*lead, N, 3 * NH, HD), rn(*lead, N, NH, 2 * H)
        sel = fa.make_rel_scatter(H, H, bf, dev)
        q, k, v = (qkv5[..., i * NH:(i + 1) * NH, :].movedim(-2, 1) for i in range(3))
        bias = torch.matmul(rel5.movedim(-2, 1), sel)  # (B, NH, [nwin,] N, N)
        wrapper, plain = getattr(fa, name), getattr(fa, name + "_ref")
        out.append(Case(name, site, [*lead, N, 3 * NH, HD],
                        lambda w=wrapper, a=(qkv5, rel5, sel), H=H: w(*a, sam, H, H),
                        lambda p=plain, a=(qkv5, rel5, sel): p(*a, sam),
                        kernel, sdpa(q, k, v, bias), "library", 0))
    return out


@dataclass
class F32Case:
    name: str            # the fp32 instance's kernel name (its CudaKernel's)
    site: str
    call: Callable       # the wrapper on its inputs
    plain: Callable      # its plain version on the same inputs
    kernel: str = ""     # the CudaKernel's attribute in ops/_cuda.py ("": a backward)
    library: Optional[Callable] = None  # one PyTorch call for the same function
    flops: float = 0.0   # the products the function needs
    reads: tuple = ()    # the tensors it reads (the bound's bytes, with its output)


def f32_attention_cases(rn):
    """`F32Case`s of every user of csrc/attn_f32.cuh's loop at every shape of
    its paths, inputs drawn in a fixed order from `rn` (fp32; generated one
    case at a time, so that one case's tensors are freed before the next):
    #16 at MaPLe's 8 x 581 and the cascade's CLIP passes (1 and 2 x 581, 16
    heads x 64); #13, #15, #17 at SAM ViT-H batch 1 and 2; #20 at 'aug_flash'
    batch 1 and 2 (BB 16 and 32 x 4096, d_qk 208, dv 80); #12 at window 16,
    #11 at window 17 and #10 at SAM ViT-B's windows and global blocks, batch
    1 and 2; #19 at its check's shape (the 64 x 64 grid, batch 2); last the
    backwards #14 and #18 at batch 2. Library calls as chip_smoke.py's
    `sam_f32_kernels` and `route_f32_kernels` take them: fp32 SDPA, the bias
    rel @ sel built outside the timed call; #15's with the pad key as one
    more key; #20's at scale 1."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops.compact_window import (
        LPAD_LANE, NEG, CompactGeometry, edge_consts,
    )

    smoke = _smoke()
    F = torch.nn.functional
    f32, dev = torch.float32, torch.device("cuda")
    NH, HD, G, WIN = 16, 80, 64, 14
    sc = HD ** -0.5
    geom = CompactGeometry(G, G, WIN)
    nf, ne, R = geom.n_full, geom.n_edge, geom.R_u
    sel32, sel_g = fa.make_rel_scatter32(WIN, f32, dev), fa.make_rel_scatter(G, G, f32, dev)
    sel_e, kmask_e = edge_consts(geom, f32, dev)

    def sdpa(q, k, v, bias=None, scale=sc):
        q, k, v = (t.flatten(0, -4) for t in (q, k, v))  # 4D, copied here
        bias = bias.flatten(0, -4) if bias is not None else None
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)

    def packed_heads(qkv, heads, d):
        r = qkv.reshape(qkv.shape[:-1] + (3, heads, d))
        return [r[..., i, :, :].transpose(-3, -2) for i in range(3)]

    # MaPLe's #16 draws first, as it did before the cascade's rows were added
    for B, site in ((8, "MaPLe 8x581, 16 heads x 64"), (1, "cascade CLIP 1x581"),
                    (2, "cascade CLIP 2x581")):
        qkv = rn(B, 581, 3 * 1024)
        yield F32Case("flash_qkv_packed_plain_f32", site,
                      lambda a=qkv: fa.flash_qkv_packed_plain(a, 64 ** -0.5, 16, 64),
                      lambda a=qkv: fa.flash_qkv_packed_plain_ref(a, 64 ** -0.5, 16, 64),
                      "QKV_PACKED_PLAIN_F32", sdpa(*packed_heads(qkv, 16, 64), scale=0.125),
                      4.0 * B * 16 * 581 * 581 * 64, (qkv,))
    for B in (1, 2):
        qw, rw = rn(B * nf, WIN * WIN, 3 * NH * HD), rn(WIN * WIN, B * nf, NH * 32)
        bias = torch.matmul(rw.reshape(WIN * WIN, B * nf, NH, 32).permute(1, 2, 0, 3), sel32)
        yield F32Case("flash_qkv_packed_windows_s_f32", f"SAM ViT-H batch {B}",
                      lambda a=(qw, rw): fa.flash_qkv_packed_windows_s(*a, sel32, sc, NH, HD),
                      lambda a=(qw, rw): fa.flash_qkv_packed_windows_s_ref(*a, sel32, sc, NH, HD),
                      "QKV_WINDOWS_F32", sdpa(*packed_heads(qw, NH, HD), bias),
                      4.0 * B * nf * NH * (WIN * WIN) ** 2 * HD, (qw, rw))
        del qw, rw, bias
        rel = rn(B, ne, R, NH, 32)
        off = 0
        for grp in geom.edge_groups:  # dummy rows' pad-key logit, as the encoder clamps it
            rel[:, off:off + grp.n, grp.rows:, :, LPAD_LANE] = NEG
            off += grp.n
        ea = (rn(B, ne, R, 3 * NH * HD), rel.reshape(B, ne, R, NH * 32), sel_e,
              rn(NH, HD, std=0.5), kmask_e)
        yield F32Case("flash_qkv_packed_edge_f32", f"SAM ViT-H batch {B}",
                      lambda a=ea: fa.flash_qkv_packed_edge(*a, sc, NH, HD),
                      lambda a=ea: fa.flash_qkv_packed_edge_ref(*a, sc, NH, HD),
                      "QKV_EDGE_F32", smoke.sdpa_edge(*ea, NH, HD, sc),
                      2.0 * B * ne * NH * R * R * (2 * HD + 32), ea[:2])
        del rel, ea
        qg, rg = rn(B, G * G, 3 * NH * HD), rn(G * G, B, NH, 2 * G)
        bias = torch.matmul(rg.permute(1, 2, 0, 3), sel_g)
        yield F32Case("flash_qkv_packed_global_f32", f"SAM ViT-H batch {B}",
                      lambda a=(qg, rg): fa.flash_qkv_packed_global(*a, sel_g, sc, NH, HD, G, G),
                      lambda a=(qg, rg): fa.flash_qkv_packed_global_ref(*a, sel_g, sc, NH, HD),
                      "QKV_GLOBAL_F32", sdpa(*packed_heads(qg, NH, HD), bias),
                      4.0 * B * NH * (G * G) ** 2 * HD, (qg, rg))
        del qg, rg, bias
    for B in (1, 2):  # #20 at 'aug_flash'
        BB, N, dqk, dv = B * NH, G * G, 208, 80
        q, k, v = rn(BB, N, dqk, std=dqk ** -0.5), rn(BB, N, dqk), rn(BB, N, dv)
        yield F32Case("flash_attention_fullk_f32", f"ViT-H aug_flash batch {B}, {BB}x{N}x208/80",
                      lambda a=(q, k, v): fa.flash_attention_fullk(*a),
                      lambda a=(q, k, v): fa.flash_attention_fullk_ref(*a), "ATTN_FULLK_F32",
                      lambda a=(q, k, v): F.scaled_dot_product_attention(*a, scale=1.0),
                      2.0 * BB * N * N * (dqk + dv), (q, k, v))
        del q, k, v
    for B in (1, 2):  # #12 at window 16: 16 windows of 256 tokens, rel window-major
        nwin, win = 16, 16
        Nw = win * win
        qkv, rel = rn(B, nwin, Nw, 3 * NH * HD), rn(B, nwin, Nw, NH * 32)
        s32 = fa.make_rel_scatter32(win, f32, dev)
        q, k, v = packed_heads(qkv, NH, HD)  # (B, nwin, NH, Nw, HD)
        bias = torch.matmul(rel.reshape(B, nwin, Nw, NH, 32).transpose(2, 3), s32)
        yield F32Case("flash_qkv_packed_windows_f32", f"ViT-H window 16 batch {B}",
                      lambda a=(qkv, rel, s32): fa.flash_qkv_packed_windows(*a, sc, NH, HD),
                      lambda a=(qkv, rel, s32): fa.flash_qkv_packed_windows_ref(*a, sc, NH, HD),
                      "QKV_WINDOWS_PADDED_F32", sdpa(q, k, v, bias),
                      4.0 * B * nwin * NH * Nw * Nw * HD, (qkv, rel))
        del qkv, rel, q, k, v, bias
    # #11 at window 17 (batch 1 and 2), #19 on the 64 x 64 grid (its check's, batch 2)
    for name, kernel, site, lead, H in (
            ("flash_qkv_relpos_windows", "QKV_RELPOS_WINDOWS_F32", "ViT-H window 17 batch 1",
             (1, 16), 17),
            ("flash_qkv_relpos_windows", "QKV_RELPOS_WINDOWS_F32", "ViT-H window 17 batch 2",
             (2, 16), 17),
            ("flash_qkv_relpos_global", "QKV_RELPOS_GLOBAL_F32", "grid 64 batch 2 (no path)",
             (2,), 64)):
        N = H * H
        qkv5, rel5 = rn(*lead, N, 3 * NH, HD), rn(*lead, N, NH, 2 * H)
        sel = fa.make_rel_scatter(H, H, f32, dev)
        q, k, v = (qkv5[..., i * NH:(i + 1) * NH, :].movedim(-2, 1) for i in range(3))
        bias = torch.matmul(rel5.movedim(-2, 1), sel)  # (B, NH, [nwin,] N, N)
        wrapper, plain = getattr(fa, name), getattr(fa, name + "_ref")
        yield F32Case(name + "_f32", site,
                      lambda w=wrapper, a=(qkv5, rel5, sel), H=H: w(*a, sc, H, H),
                      lambda p=plain, a=(qkv5, rel5, sel): p(*a, sc), kernel,
                      sdpa(q, k, v, bias), 4.0 * qkv5.shape[:-3].numel() * NH * N * N * HD,
                      (qkv5, rel5))
        del qkv5, rel5, q, k, v, bias
    for B in (1, 2):  # #10 at SAM ViT-B's windows and global blocks (12 heads x 64)
        for label, BB, H in (("ViT-B windows", B * 25 * 12, 14), ("ViT-B global", B * 12, 64)):
            N, dh = H * H, 64
            q, k, v = rn(BB, N, dh, std=dh ** -0.5), rn(BB, N, dh), rn(BB, N, dh)
            rel, sel = rn(BB, N, 2 * H), fa.make_rel_scatter(H, H, f32, dev)
            bias = torch.matmul(rel, sel)
            a = (q, k, v, rel, sel)
            yield F32Case("flash_attention_relpos_f32", f"{label} batch {B}, {BB}x{N}x{dh}",
                          lambda a=a, H=H: fa.flash_attention_relpos(*a, H, H),
                          lambda a=a: fa.xla_attention_relpos(*a), "ATTN_RELPOS_F32",
                          lambda a=a, b=bias: F.scaled_dot_product_attention(
                              *a[:3], attn_mask=b, scale=1.0),
                          4.0 * BB * N * N * dh, (q, k, v, rel))
            del q, k, v, rel, bias, a
    B = 2
    qw, rw, gw = rn(B * nf, WIN * WIN, 3 * NH * HD), rn(WIN * WIN, B * nf, NH * 32), \
        rn(B * nf, NH * HD, WIN * WIN)
    # a checkout whose fp32 backward forms t = sum g o takes the forward's
    # output o: the fp32 forward kernel's, made outside the timed call
    bwd_o = "o" in inspect.signature(fa.flash_qkv_packed_global_bwd).parameters
    kw = {"o": fa.flash_qkv_packed_windows_s(qw, rw, sel32, sc, NH, HD)} if bwd_o else {}
    yield F32Case("flash_qkv_packed_windows_s_bwd_f32", "SAM ViT-H batch 2",
                  lambda: fa.flash_qkv_packed_windows_s_bwd(qw, rw, sel32, gw, sc, NH, HD, **kw),
                  None)
    del qw, rw, gw, kw
    qg, rg, gg = rn(B, G * G, 3 * NH * HD), rn(G * G, B, NH, 2 * G), rn(B, NH * HD, G * G)
    kg = {"o": fa.flash_qkv_packed_global(qg, rg, sel_g, sc, NH, HD, G, G)} if bwd_o else {}
    yield F32Case("flash_qkv_packed_global_bwd_f32", "SAM ViT-H batch 2",
                  lambda: fa.flash_qkv_packed_global_bwd(qg, rg, sel_g, gg, sc, NH, HD, G, G,
                                                         **kg), None)


def f32_attention(smoke, label, against, tiles):
    """One JSON line per `f32_attention_cases` case: the SHA-256 of its
    outputs' bytes, its idle-card median and queued times
    (`chip_smoke.time_ms`); for a forward also its error against the plain
    version and the plain version's idle-card median, the host's microseconds a call through the wrapper and through
    its CudaKernel alone (`entry_replay`), the library call's times, its
    bound against the fp32 CUDA-core peak and, on a checkout with the loop's
    tile plan (`ops/flash_attention.py f32_attn_plan`), the tile the call
    took, with `tiles` the queued time at each tile of F32_ATTN_TILES forced
    (those the instance cannot take: null); for the backwards each of their
    kernels' device ms a call (`kernel_device_ms`); with `against` (a JSONL
    file of another checkout's lines), whether the outputs are bit-equal to
    that checkout's."""
    import hashlib

    import torch
    from camouflaged_vlm_tpu_torch.ops import _cuda
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa

    other = {}
    if against:
        with open(against) as f:
            for ln in f:
                rec = json.loads(ln)
                if "sha256" in rec:
                    other[(rec["name"], rec["site"])] = rec["sha256"]
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    planned = hasattr(fa, "f32_attn_plan")
    picks = []
    if planned:
        plan = fa.f32_attn_plan
        fa.f32_attn_plan = lambda *a, **k: picks.append(plan(*a, **k)) or picks[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        for c in f32_attention_cases(rn):
            picks.clear()
            got = c.call()
            torch.cuda.synchronize()
            h = hashlib.sha256()
            for t in (got if isinstance(got, tuple) else (got,)):
                h.update(t.contiguous().cpu().numpy().tobytes())
            rec = dict(label=label, name=c.name, site=c.site, sha256=h.hexdigest())
            if c.kernel:
                rec.update(shape=list(got.shape), **smoke.errors(got, c.plain()),
                           **smoke.bound(c.flops, smoke.nbytes(*c.reads, got),
                                         smoke.PEAK_F32_FLOPS))
                if planned:
                    rec["tile"] = [list(fa.F32_ATTN_TILES[t]) for t in picks]
            rec.update(ms=smoke.time_ms(c.call), queued_ms=smoke.time_ms(c.call, queued=True))
            if c.kernel:
                _, replay = entry_replay(getattr(_cuda, c.kernel), c.call)
                rec.update(host_us=smoke.host_us(c.call), host_us_entry=smoke.host_us(replay()),
                           plain_ms=smoke.time_ms(c.plain),
                           library_ms=smoke.time_ms(c.library),
                           library_queued_ms=smoke.time_ms(c.library, queued=True))
                if planned and tiles:
                    rec["tiles_queued_ms"] = {}
                    for t in fa.F32_ATTN_TILES:
                        fa.F32_ATTN_TILE_FORCE = t
                        try:
                            ms = smoke.time_ms(c.call, queued=True)
                        except ValueError:  # a tile this instance does not take
                            ms = None
                        rec["tiles_queued_ms"][f"{t[0]}x{t[1]}"] = ms
                    fa.F32_ATTN_TILE_FORCE = None
            else:  # the backward's launches, each kernel's device ms
                rec["device_ms"] = kernel_device_ms(c.call)
            if against:
                rec["bit_equal_to"] = {against: other.get((c.name, c.site)) == rec["sha256"]}
            print(json.dumps(rec), flush=True)
            del got, c
            torch.cuda.empty_cache()


def global_bwd(smoke, label, against):
    """The bf16 #18 (`flash_qkv_packed_global_bwd`) at full width (16 heads x
    80) on chip_smoke's seeded inputs (`global_bwd_case`, numpy draws, case
    i from seed i): batch 2 at `GLOBAL_BWD_NARROW` (the register path on
    64 x 64, PERF.md's row 18; the general path at 128 and 32 lanes), then
    batch 1 on `WIDE_GRIDS` (past 128 lanes; a checkout that refuses them
    records its ValueError). One JSON line each: the SHA-256 of (dqkv,
    drel), the toolkit, and the idle-card median and queued times; with
    `against` (another checkout's lines), whether the outputs are bit-equal
    to that checkout's. The old checkout's hashes at GLOBAL_BWD_NARROW are
    chip_smoke's GLOBAL_BWD_PARENT."""
    import torch
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa

    other = {}
    if against:
        with open(against) as f:
            other = {(r["name"], r["site"]): r.get("sha256") for r in map(json.loads, f)
                     if "site" in r}
    toolkit = smoke.nvcc_release()
    grids = list(smoke.GLOBAL_BWD_NARROW) + [(1, G, G) for G in smoke.WIDE_GRIDS]
    for i, (B, H, W) in enumerate(grids):
        args = smoke.global_bwd_case(i, B, H, W)
        rec = dict(label=label, name="flash_qkv_packed_global_bwd", site=f"{B}x{H}x{W}",
                   lanes=H + W, toolkit=toolkit)
        try:
            got = fa.flash_qkv_packed_global_bwd(*args)
        except ValueError as e:  # a checkout whose #18 refuses the grid
            rec["refused"] = str(e)
        else:
            call = lambda: fa.flash_qkv_packed_global_bwd(*args)  # noqa: E731
            rec.update(sha256=smoke.outputs_sha256(got), ms=smoke.time_ms(call),
                       queued_ms=smoke.time_ms(call, queued=True))
            if against:
                rec["bit_equal_to"] = {against: other.get((rec["name"], rec["site"]))
                                       == rec["sha256"]}
            del got
        print(json.dumps(rec), flush=True)
        del args
        torch.cuda.empty_cache()


def f32_gemm_cases(smoke, rn):
    """(name, site, zero-argument call, plain call, library call or None,
    the products alone or None) of every user of csrc/sgemm_f32.cuh at
    every shape of its paths, inputs drawn in a fixed order from `rn`
    (fp32): the fp32 cascade's (`chip_smoke.f32_gemm_cases`: #1, #2, #4/#5,
    #7 at batch 2 and 1, the text tower's #4/#5), #3 at the global blocks
    at batch 2 and 1, MaPLe's (batch 8: #2, #7, #4/#5 and the backward #6 at
    the vision and text widths), #6 at SAM ViT-H's three row sets (batch 2
    and 1, dx; its library the composite of `chip_smoke.mlp_bwd_library`),
    #8 and #9 at window 17."""
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    def named(kernel):
        return kernel + "_f32"

    out = []
    for kernel, site, b, kfn, pfn, args, _, library, gemm in smoke.f32_gemm_cases(rn):
        out.append((named(kernel), f"{site} batch {b}", lambda f=kfn, a=args: f(*a),
                    lambda f=pfn, a=args: f(*a), library, gemm))
    for b in (2, 1):
        kfn, pfn, args, _, gemm = smoke.ln_gemm_case(rn, "ln_mask_linear_bt", (b, 4096), 1280,
                                                     3840, 1e-6, None)
        out.append((named("ln_mask_linear_bt"), f"global batch {b}",
                    lambda f=kfn, a=args: f(*a), lambda f=pfn, a=args: f(*a),
                    smoke.f32_library("ln_mask_linear_bt", args, 1e-6, None), gemm))
    B, S = smoke.MAPLE_B, smoke.MAPLE_S
    for kernel, lead, K, N in (("ln_linear_act_bt", (B, S), 1024, 3072),
                               ("ln_mlp_residual_bt", (B, S), 1024, 4096)):
        act = None if kernel == "ln_linear_act_bt" else "quick_gelu"
        kfn, pfn, args, _, gemm = smoke.ln_gemm_case(rn, kernel, lead, K, N, 1e-5, act)
        out.append((named(kernel), f"MaPLe {B}x{S}", lambda f=kfn, a=args: f(*a),
                    lambda f=pfn, a=args: f(*a), smoke.f32_library(kernel, args, 1e-5, act),
                    gemm))
    args, _, gemm = smoke.proj_rows_case(rn, (B, 1, 1024, S), 1024)
    out.append((named("proj_rows"), f"MaPLe {B}x{S}", lambda a=args: lin.proj_rows(*a),
                lambda a=args: lin.proj_rows_ref(*a),
                smoke.f32_library("proj_rows", args, 0, None), gemm))
    for site, lead, K, H, eps, act in (
            (f"MaPLe vision {B}x{S}", (B, S), 1024, 4096, 1e-5, "quick_gelu"),
            (f"MaPLe text {smoke.MAPLE_CLASSES}x77", (smoke.MAPLE_CLASSES, 77), 768, 3072, 1e-5,
             "quick_gelu"),
            ("SAM global batch 2", (2, 4096), 1280, 5120, 1e-6, "gelu_tanh"),
            ("SAM windows batch 2", (32, 196), 1280, 5120, 1e-6, "gelu_tanh"),
            ("SAM edge batch 2", (2, 1008), 1280, 5120, 1e-6, "gelu_tanh"),
            ("SAM global batch 1", (1, 4096), 1280, 5120, 1e-6, "gelu_tanh"),
            ("SAM windows batch 1", (16, 196), 1280, 5120, 1e-6, "gelu_tanh"),
            ("SAM edge batch 1", (1, 1008), 1280, 5120, 1e-6, "gelu_tanh")):
        _, _, args, *_ = smoke.ln_gemm_case(rn, "ln_mlp_residual_bt", lead, K, H, eps, act)
        a = args + (rn(*lead, K),)
        out.append((named("ln_mlp_residual_bt_bwd"), site,
                    lambda a=a, e=eps, c=act: lin.ln_mlp_residual_bt_bwd(
                        *a, eps=e, activation=c, weights=False)[0],
                    lambda a=a, e=eps, c=act: lin.ln_mlp_residual_bt_bwd_ref(
                        *a, eps=e, activation=c, weights=False)[0],
                    *smoke.mlp_bwd_library(a, eps, act)))
    args, *_ = smoke.proj_heads_case(rn, 2)
    for name, a in (("proj_from_heads_res", args), ("proj_from_heads", args[:3])):
        out.append((named(name), "window 17 batch 2", lambda f=getattr(lin, name), a=a: f(*a),
                    lambda a=a: lin.proj_from_heads_ref(*a), None, None))
    return out


def f32_gemm(smoke, label, against, tiles):
    """One JSON line per `f32_gemm_cases` case: the SHA-256 of its output's
    bytes, its error against the plain version, its idle-card median and
    queued times (`chip_smoke.time_ms`); on a checkout with the fp32 tile
    plan (`ops/linear.py f32_gemm_plan`) the plans the call took and, with
    `tiles`, the queued time at each of F32_TILES forced and, at the plans'
    tile, with every tile's K cut into 1 to 4 slices; the host's us a call
    through the wrapper and through its CudaKernel alone, and the library
    call's times (`chip_smoke.f32_library`) and of the products alone, each
    launch's device ms; where the caller offers more than one path
    (F32_PATHS), each path forced: both clocks, each launch's device ms and,
    with `tiles`, the queued time at each tile the path takes;
    with `against` (a JSONL file of another checkout's lines), whether the
    output is bit-equal to that checkout's."""
    import hashlib

    import torch
    from camouflaged_vlm_tpu_torch.ops import _cuda
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    other = {}
    if against:
        with open(against) as f:
            for ln in f:
                rec = json.loads(ln)
                if "sha256" in rec:
                    other[(rec["name"], rec["site"])] = rec["sha256"]
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, std=1.0, dtype=None):  # fp32 whatever dtype the case functions ask
        return torch.randn(*shape, generator=g, device="cuda") * std

    planned = hasattr(lin, "f32_gemm_plan")
    picks, offered = [], set()
    if planned:
        plan = lin.f32_gemm_plan

        def record(*a, **k):
            offered.update(k.get("paths", (0,)))
            picks.append(plan(*a, **k))
            return picks[-1]

        lin.f32_gemm_plan = record
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        for name, site, call, plain, library, gemm in f32_gemm_cases(smoke, rn):
            picks.clear()
            offered.clear()
            # the plans are cached per shape: cleared, so that `record` sees them
            for spec in ("_ln_linear_f32_spec", "_ln_mlp_f32_spec", "_ln_mlp_bwd_f32_spec"):
                if hasattr(lin, spec):
                    getattr(lin, spec).cache_clear()
            got = call()
            torch.cuda.synchronize()
            rec = dict(label=label, name=name, site=site, shape=list(got.shape),
                       sha256=hashlib.sha256(got.contiguous().cpu().numpy().tobytes()).hexdigest(),
                       **smoke.errors(got, plain()))
            rec["plans"] = [dict(tile=[p.bm, p.bn], tile_no=p.tile, tiles=p.tiles,
                                 splits=p.splits, tail=p.tail, flat=p.flat,
                                 path=getattr(p, "path", 0)) for p in picks]
            rec.update(ms=smoke.time_ms(call), queued_ms=smoke.time_ms(call, queued=True),
                       host_us=smoke.host_us(call))
            kernel = next((k for k in _cuda.KERNELS if k.name == name), None)
            if kernel is not None:  # the host's us through the CudaKernel alone
                _, replay = entry_replay(kernel, call)
                rec["host_us_entry"] = smoke.host_us(replay())
            if library is not None:
                rec.update(library_ms=smoke.time_ms(library),
                           library_queued_ms=smoke.time_ms(library, queued=True))
            if gemm is not None:
                rec.update(gemm_ms=smoke.time_ms(gemm),
                           gemm_queued_ms=smoke.time_ms(gemm, queued=True))
            rec["launches_device_ms"] = kernel_launches_ms(call)
            if len(offered) > 1:  # each path the caller offers, forced: both clocks,
                # each launch's device ms, whether its output is bit-equal to the
                # plan's, and with `tiles` the queued time at each tile number it takes
                rec["paths_ms"], rec["paths_bit_equal"], rec["paths_device_ms"] = {}, {}, {}
                for p in sorted(offered):
                    lin.F32_PATH_FORCE = p
                    out = call()
                    rec["paths_bit_equal"][p] = bool(torch.equal(out, got))
                    rec["paths_ms"][p] = [smoke.time_ms(call), smoke.time_ms(call, queued=True)]
                    rec["paths_device_ms"][p] = kernel_launches_ms(call)
                    if tiles:
                        for pp, t in lin.F32_PATH_RATE:
                            if pp != p:
                                continue
                            lin.F32_TILE_FORCE = t
                            bm, bn, occ = lin.f32_tile(t)[:3]
                            rec.setdefault("path_tiles_queued_ms", {})[
                                f"{p} {bm}x{bn}/{occ}"] = smoke.time_ms(call, queued=True)
                        lin.F32_TILE_FORCE = None
                    del out
                lin.F32_PATH_FORCE = None
            if planned and tiles:
                rec["tiles_queued_ms"] = {}
                for t in lin.F32_TILES:
                    lin.F32_TILE_FORCE = t
                    rec["tiles_queued_ms"]["x".join(map(str, t))] = smoke.time_ms(call,
                                                                                   queued=True)
                lin.F32_TILE_FORCE = None
                # the plans' tiles with every tile's K cut into 1 (none) to 4 slices
                t = {p["tile_no"] for p in rec["plans"]}
                if len(t) == 1:
                    t = t.pop()
                    lin.F32_TILE_FORCE = tuple(lin.F32_TILES[t]) if t < len(lin.F32_TILES) else t
                    rec["splits_queued_ms"] = {}
                    for n in (1, 2, 3, 4):
                        lin.F32_SPLIT_FORCE = n
                        rec["splits_queued_ms"][n] = smoke.time_ms(call, queued=True)
                    lin.F32_TILE_FORCE = lin.F32_SPLIT_FORCE = None
            if against:
                rec["bit_equal_to"] = {against: other.get((name, site)) == rec["sha256"]}
            print(json.dumps(rec), flush=True)
            del got
            torch.cuda.empty_cache()


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
SASS_REG = re.compile(r"\bR(\d+)\b")
SASS_LDS_REGS = {"LDS.128": 4, "LDS.U.128": 4, "LDS.64": 2, "LDS.U.64": 2}


def sass_functions(text: str) -> dict:
    """{mangled name: [(address, instruction), ...]} of a `cuobjdump -sass`
    listing, branch targets as addresses (labels resolved)."""
    funcs, cur, labels, pending = {}, None, {}, []
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            labels, pending = {}, []
            continue
        if cur is None:
            continue
        m = SASS_LABEL.match(ln)
        if m:
            pending.append(m.group(1))
            continue
        m = SASS_LINE.search(ln)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            cur.append([addr, m.group(2).strip(), labels])
    out = {}
    for name, ins in funcs.items():
        res = []
        for addr, txt, labels in ins:
            t = re.search(r"`\((\.L_x_\d+)\)", txt)
            if t and t.group(1) in labels:
                txt = txt.replace(t.group(0), hex(labels[t.group(1)]))
            res.append((addr, txt))
        out[name] = res
    return out


def _opcode(txt: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", txt).split()[0]


def _operands(txt: str) -> list:
    body = re.sub(r"^@!?U?P\w+\s+", "", txt).split(None, 1)
    return [o.strip() for o in body[1].split(",")] if len(body) > 1 else []


def sass_loop_counts(ins: list) -> dict:
    """Counts over a function's main loop: the backward branch whose range
    holds the most FFMAs (the k-tile loop of the GEMM). The FFMAs, the
    shared-memory loads by width and every other instruction by opcode, per
    pass of the loop, and for each LDS the instructions between it and the
    first instruction that reads one of its registers (wrapping round the
    loop: a load for the next pass is consumed there)."""
    best = None
    for i, (addr, txt) in enumerate(ins):
        if _opcode(txt) != "BRA":
            continue
        t = re.search(r"0x([0-9a-f]+)\s*$", txt)
        if not t or int(t.group(1), 16) > addr:
            continue
        start = next(j for j, (a, _) in enumerate(ins) if a >= int(t.group(1), 16))
        body = ins[start:i + 1]
        n = sum(1 for _, x in body if _opcode(x) == "FFMA")
        if best is None or n > best[0] or (n == best[0] and len(body) < len(best[1])):
            best = (n, body)
    if best is None:
        return {}
    body = [txt for _, txt in best[1]]
    ops = [_opcode(x) for x in body]
    counts = {}
    for op in ops:
        counts[op] = counts.get(op, 0) + 1
    dists = []
    for i, op in enumerate(ops):
        if not op.startswith("LDS"):
            continue
        dst = SASS_REG.search((_operands(body[i]) or [""])[0])
        if dst is None:
            continue
        r0 = int(dst.group(1))
        regs = {f"R{r0 + k}" for k in range(SASS_LDS_REGS.get(op, 1))}
        for d in range(1, len(body) + 1):
            j = (i + d) % len(body)
            reads = _operands(body[j]) if ops[j].startswith(("ST", "RED", "ATOM")) else \
                _operands(body[j])[1:]
            if regs & {f"R{r}" for o in reads for r in SASS_REG.findall(o)}:
                dists.append(d - 1)
                break
    dists.sort()
    lds = {op: n for op, n in counts.items() if op.startswith("LDS")}
    other = {op: n for op, n in counts.items() if op != "FFMA" and not op.startswith("LDS")}
    return dict(instructions=len(body), ffma=counts.get("FFMA", 0), lds=lds,
                other=sum(other.values()),
                other_by_opcode=dict(sorted(other.items(), key=lambda kv: -kv[1])),
                lds_to_use=dict(min=dists[0], median=dists[len(dists) // 2],
                                mean=sum(dists) / len(dists), max=dists[-1],
                                under_8=sum(1 for d in dists if d < 8)) if dists else None)


def sass(label: str, patterns: list) -> None:
    """`cuobjdump -sass` of the built library: one JSON line per pattern
    (a regex on the mangled name; the first function that matches) with
    its main loop's counts (`sass_loop_counts`); the functions' listings
    into chiprun_out/kernel_timing/sass_<label>.txt."""
    from camouflaged_vlm_tpu_torch.ops import _cuda

    lib = _cuda.build()
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs = sass_functions(text)
    out_dir = os.path.join("chiprun_out", "kernel_timing")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"sass_{label}.txt"), "w") as f:
        for pat in patterns:
            name = next((n for n in funcs if re.search(pat, n)), None)
            rec = dict(label=label, pattern=pat, function=name)
            if name is not None:
                f.write(f"Function : {name}\n" + "".join(
                    f"/*{a:04x}*/ {t} ;\n" for a, t in funcs[name]))
                f.flush()
                rec.update(sass_loop_counts(funcs[name]))
            print(json.dumps(rec), flush=True)


def padded_calls(smoke, label):
    """The repo's ViT-H yaml at windows 16 (#12) and 17 (#11 + #8), and the
    port's ViT-B yaml (unfused 'flash', #10): the cascade call cut into
    stages at batch 1 and 2, and the card's busy time in a torch.profiler
    trace of one batch-2 call (`chip_smoke.config_stage_times`)."""
    from camouflaged_vlm_tpu_torch.config import cascade_config_from_yaml

    work = os.path.join(HERE, "build", "kernel_timing_yaml")
    os.makedirs(work, exist_ok=True)
    for win in (16, 17):
        cfg = cascade_config_from_yaml(smoke.window_yaml(win, work))[0]
        smoke.config_stage_times(cfg, f"{label} window {win}", trace=(2,))
    cfg = cascade_config_from_yaml(os.path.join(HERE, smoke.VIT_B_YAML))[0]
    smoke.config_stage_times(cfg, f"{label} ViT-B", trace=(2,))


def main() -> None:
    # run as a script, this file's directory comes first on sys.path, where
    # cli/profile.py would shadow the standard library's profile module
    # (torch imports cProfile, which imports it)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose package to time")
    ap.add_argument("--label", default=None)
    ap.add_argument("--padded-calls", action="store_true",
                    help="time the window-16, window-17 and ViT-B cascade calls instead of "
                    "the kernels")
    ap.add_argument("--f32-attention", action="store_true",
                    help="hash and time the fp32 instances on csrc/attn_f32.cuh instead")
    ap.add_argument("--f32-gemm", action="store_true",
                    help="hash and time the users of csrc/sgemm_f32.cuh instead")
    ap.add_argument("--tiles", action="store_true",
                    help="with --f32-gemm or --f32-attention: also time each fp32 tile, forced")
    ap.add_argument("--global-bwd", action="store_true",
                    help="hash and time the bf16 global attention backward #18 instead")
    ap.add_argument("--against", default=None,
                    help="with --f32-attention, --f32-gemm or --global-bwd: another checkout's "
                    "JSON lines to compare with")
    ap.add_argument("--sass", nargs="+", default=None, metavar="REGEX",
                    help="count the main loop's instructions of the functions whose mangled "
                    "names match, from cuobjdump -sass of the built library, instead")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    smoke = _smoke()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing: no CUDA device")
    from camouflaged_vlm_tpu_torch.ops import _cuda
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    label = args.label or root
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    usage = ptxas_usage(_cuda.build_info.get("log", ""))
    print(json.dumps({"label": label, "card": smi, "build_s": build_s, "ptxas": usage}),
          flush=True)
    if args.sass:
        sass(args.label or "sass", args.sass)
        return
    if args.padded_calls:
        padded_calls(smoke, label)
        return
    if args.f32_attention:
        f32_attention(smoke, label, args.against, args.tiles)
        return
    if args.f32_gemm:
        f32_gemm(smoke, label, args.against, args.tiles)
        return
    if args.global_bwd:
        global_bwd(smoke, label, args.against)
        return

    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    widths = sorted(getattr(lin, "GEMM_TILE_COST", {}))  # a checkout before the template: none
    host_ms = {}
    with torch.no_grad():
        for c in cases(smoke, rn, bool(widths)):
            got, replay = entry_replay(getattr(_cuda, c.kernel), c.call)
            torch.cuda.synchronize()
            lib = c.library_key
            rec = dict(label=label, name=c.name, site=c.site, shape=c.shape,
                       **case_errors(smoke, got, c.plain(), c.outputs),
                       ms=smoke.time_ms(c.call), queued_ms=smoke.time_ms(c.call, queued=True),
                       host_us=smoke.host_us(c.call), host_us_entry=smoke.host_us(replay()))
            if c.library is not None:
                rec.update({f"{lib}_ms": smoke.time_ms(c.library),
                            f"{lib}_queued_ms": smoke.time_ms(c.library, queued=True)})
            else:  # a backward: its kernels' device times, and the plain version's
                rec.update(kernels_device_ms=kernel_device_ms(c.call),
                           plain_ms=smoke.time_ms(c.plain))
            if widths and c.widths:
                rec["queued_ms_tile_n"] = {
                    f"{p} {bn}": smoke.time_ms(replay({pos: bn}), queued=True)
                    for p, pos in c.widths.items() for bn in widths}
                rec["passes_queued_ms"] = {p: smoke.time_ms(fn, queued=True)
                                           for p, fn in c.passes.items()}
            host_ms[c.name] = host_ms.get(c.name, 0.0) + c.per_call * rec["host_us"] / 1e3
            del got
            print(json.dumps(rec), flush=True)
    print(json.dumps({"label": label, "host_ms_per_cascade_call": host_ms,
                      "sum": sum(host_ms.values())}), flush=True)


if __name__ == "__main__":
    main()
