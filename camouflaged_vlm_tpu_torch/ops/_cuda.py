"""Build, load and launch the hand-written Hopper kernels (`csrc/*.cu`).

The sources are compiled at first use with `nvcc` for `sm_90a` (one
process per source, in parallel) and linked into one shared library with a
plain C interface under `<repo>/build/kernels/` (named by a hash of the
sources, so an edit rebuilds), bound with `ctypes`. Nothing here runs at import: the CPU tests import every module,
and a CPU-only machine need not have `nvcc`.

Each kernel is a `CudaKernel`: calling it launches the C entry point on
PyTorch's current stream, raises if the launch returned a CUDA error, and
adds one to its `launches` count — the count a run reads to show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c"]

# a launch's torch.profiler range while a profiler is on: this + its name
PROFILE_RANGE = "cvlm::"
# activation codes of csrc/common.cuh
ACTIVATIONS = {None: 0, "gelu": 1, "gelu_tanh": 2, "quick_gelu": 3}

_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def build() -> Path:
    """Compile csrc/*.cu into build/kernels/libcvlm_<hash>.so (once per
    source hash) and return its path: one nvcc per source, all started
    together, then one link. Raises with nvcc's output on failure."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode() + f.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libcvlm_{tag}.so"
    log_path = lib_path.with_suffix(".log")  # nvcc's output, ptxas -v included
    if lib_path.exists():
        if "log" not in build_info and log_path.exists():
            build_info.update(seconds=0.0, command="(built earlier)", log=log_path.read_text())
        return lib_path
    obj_dir = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        obj, log = obj_dir / f"{src.stem}.o", obj_dir / f"{src.stem}.log"
        cmd = [nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
        with open(log, "w") as f:
            jobs.append((cmd, obj, log,
                         subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for cmd, obj, log, proc in jobs:
        rc = proc.wait()
        logs.append(" ".join(cmd) + "\n" + log.read_text())
        if rc != 0:
            failed.append(f"nvcc failed ({rc}):\n{logs[-1]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", *ARCH, "-o", str(tmp), *(str(j[1]) for j in jobs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    log_path.write_text("\n".join(logs))
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0,
                      command=" ".join(link), log="\n".join(logs))
    return lib_path


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.cvlm_error_string.argtypes = [ctypes.c_int]
        lib.cvlm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class CudaKernel:
    """One C entry point of the kernel library, with its launch count."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [P]  # the stream comes last
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        if torch.autograd._profiler_enabled():  # its launch under its name in a trace
            with torch.profiler.record_function(PROFILE_RANGE + self.name):
                err = self._fn(*args, stream)
        else:
            err = self._fn(*args, stream)
        if err != 0:
            msg = library().cvlm_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


# One entry per wrapper (and TPU kernel replaced). The first five run on the
# persistent TMA + wgmma GEMM of csrc/gemm_sm90.cuh: the plain product
# (csrc/linear.cu); the LN row pass then the GEMM (csrc/ln_linear.cu: LN, and
# LN with a row mask); the LN row pass, fc1 and fc2 with the residual
# (csrc/ln_mlp_residual.cu); the out-projection of a d-major attention output,
# read MN-major (csrc/proj_rows.cu). Each entry queues all its passes and
# counts once. The attention kernels write their d-major output with a row
# stride (the last int) that the wrappers round up for proj_rows.
LINEAR_ACT = CudaKernel("linear_act", "cvlm_linear", [P, P, P, P, I, I, I, I, I])
LN_LINEAR = CudaKernel("ln_linear_act_bt", "cvlm_ln_linear",
                       [P, P, P, P, P, P, P, I, I, I, F, I, I])
LN_MASK_LINEAR = CudaKernel(
    "ln_mask_linear_bt", "cvlm_ln_mask_linear", [P, P, P, P, P, P, P, P, I, I, I, I, I, F, I]
)
LN_MLP_RESIDUAL = CudaKernel(
    "ln_mlp_residual_bt", "cvlm_ln_mlp_residual",
    [P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, I, I, I, I],
)
# The same function in float32 (csrc/ln_mlp_residual_f32.cu: the LN row pass,
# fc1 and fc2 as tiled FFMA products on the CUDA cores), for the CLIP text
# tower of the bank precompute; its own count. The fp32 instances on
# csrc/sgemm_f32.cuh take each product's plan (ops/linear.py f32_gemm_plan:
# tile, k slices, split tail) and a split-K scratch pointer (or None).
LN_MLP_RESIDUAL_F32 = CudaKernel(
    "ln_mlp_residual_bt_f32", "cvlm_ln_mlp_residual_f32",
    [P] * 12 + [I, I, I, I, F] + [I] * 9,
)
PROJ_ROWS = CudaKernel("proj_rows", "cvlm_proj_rows", [P, P, P, P, P, I, I, L, L, I, I, I, I])
# The fp32 instances of MaPLe training's path (the CLIP vision blocks' LN1 +
# qkv, attention and out-projection, and the MLP backward at both towers'
# widths), tiled FFMA products and a flash loop on the CUDA cores
# (csrc/sgemm_f32.cuh; csrc/ln_linear_f32.cu, csrc/qkv_packed_plain_f32.cu,
# csrc/proj_rows_f32.cu, csrc/ln_mlp_residual_bwd_f32.cu), each with its
# own count.
LN_LINEAR_F32 = CudaKernel("ln_linear_act_bt_f32", "cvlm_ln_linear_f32",
                           [P] * 9 + [I, I, I, F, I, I, I, I, I])
QKV_PACKED_PLAIN_F32 = CudaKernel("flash_qkv_packed_plain_f32", "cvlm_qkv_packed_plain_f32",
                                  [P, P, I, I, I, I, I, F, I])
PROJ_ROWS_F32 = CudaKernel("proj_rows_f32", "cvlm_proj_rows_f32",
                           [P] * 6 + [I, I, L, L] + [I] * 6)
LN_MLP_RESIDUAL_BWD_F32 = CudaKernel("ln_mlp_residual_bt_bwd_f32", "cvlm_ln_mlp_residual_bwd_f32",
                                     [P] * 16 + [I, I, I, I, F] + [I] * 9)
# The fp32 instances of SAM's kernels on the cascade's path at --dtype
# float32 (the reference configuration): the patch embed (csrc/linear_f32.cu),
# LN1 + row mask + qkv of the global blocks (csrc/ln_linear_f32.cu), and the
# interior windows, edge windows and global attention on the fp32 flash loop
# of csrc/attn_f32.cuh (csrc/qkv_windows_f32.cu, csrc/qkv_packed_global_f32.cu);
# each with its own count. The loop's entries take the tile of
# ops/flash_attention.py f32_attn_plan as their last int.
LINEAR_ACT_F32 = CudaKernel("linear_act_f32", "cvlm_linear_f32", [P] * 5 + [I] * 7)
LN_MASK_LINEAR_F32 = CudaKernel("ln_mask_linear_bt_f32", "cvlm_ln_mask_linear_f32",
                                [P] * 10 + [I, I, I, I, I, F, I, I, I, I])
QKV_WINDOWS_F32 = CudaKernel("flash_qkv_packed_windows_s_f32", "cvlm_qkv_packed_windows_s_f32",
                             [P, P, P, I, I, I, I, F, I, I])
QKV_EDGE_F32 = CudaKernel("flash_qkv_packed_edge_f32", "cvlm_qkv_packed_edge_f32",
                          [P, P, P, P, P, P, I, I, I, I, I, F, I, I])
QKV_GLOBAL_F32 = CudaKernel("flash_qkv_packed_global_f32", "cvlm_qkv_packed_global_f32",
                            [P, P, P, I, I, I, I, I, I, I, F, I])
QKV_PACKED_PLAIN = CudaKernel(
    "flash_qkv_packed_plain", "cvlm_qkv_packed_plain", [P, P, I, I, I, I, I, F]
)
# the windows' attention, all on the whole-window TMA + wgmma kernel of
# csrc/qkv_packed_windows_s.cu: the compact carry's interior (#13, rel
# position-major) and edge windows (#15, rel window-major), and the padded
# carry's (#12, rel window-major)
_QKV_WINDOWS_ARGS = [P, P, P, I, I, I, I, F, I]
QKV_WINDOWS = CudaKernel("flash_qkv_packed_windows_s", "cvlm_qkv_packed_windows_s",
                         _QKV_WINDOWS_ARGS)
QKV_WINDOWS_PADDED = CudaKernel("flash_qkv_packed_windows", "cvlm_qkv_packed_windows",
                                _QKV_WINDOWS_ARGS)
QKV_EDGE = CudaKernel(
    "flash_qkv_packed_edge", "cvlm_qkv_packed_edge", [P, P, P, P, P, P, I, I, I, I, I, F, I]
)
QKV_GLOBAL = CudaKernel(
    "flash_qkv_packed_global", "cvlm_qkv_packed_global", [P, P, P, I, I, I, I, I, I, I, F]
)
# The hand-written backward kernels (training): the fused MLP's (#6: the LN
# row pass, a dual GEMM for dh, dxn = dh . W1 on the GEMM template and the
# LN-backward rows, per row panel, counted once a call), and one
# attention backward (csrc/attn_bwd.cu: a prep pass, then a query-parallel
# and a key-parallel TMA + wgmma pass, counted once a call) for the windows
# (#14) and the global blocks (#18), each with its own count.
LN_MLP_RESIDUAL_BWD = CudaKernel(
    "ln_mlp_residual_bt_bwd", "cvlm_ln_mlp_residual_bwd", [P] * 16 + [I, I, I, I, F, I, I, I],
)
_ATTN_BWD_ARGS = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F]
QKV_WINDOWS_BWD = CudaKernel("flash_qkv_packed_windows_s_bwd", "cvlm_attn_bwd", _ATTN_BWD_ARGS)
QKV_GLOBAL_BWD = CudaKernel("flash_qkv_packed_global_bwd", "cvlm_attn_bwd", _ATTN_BWD_ARGS)
# Their fp32 instances (csrc/attn_bwd_f32.cu: the rows' statistics, then a
# key-parallel and a query-parallel kernel a chunk of (problem, head) pairs
# at a time, FFMA on the CUDA cores, counted once a call), the train CLI's
# backward at --dtype float32
QKV_WINDOWS_BWD_F32 = CudaKernel("flash_qkv_packed_windows_s_bwd_f32",
                                 "cvlm_qkv_packed_windows_s_bwd_f32",
                                 [P] * 9 + [I, I, I, I, I, I, F])
QKV_GLOBAL_BWD_F32 = CudaKernel("flash_qkv_packed_global_bwd_f32",
                                "cvlm_qkv_packed_global_bwd_f32",
                                [P] * 9 + [I, I, I, I, I, I, I, I, F])

# Attention over split q, k, v: SAM's unfused 'flash' path (#10, rel-pos
# bias; the split front end of csrc/qkv_relpos.cu's one pass) and the
# 'aug_flash' global blocks (#20; csrc/attn_fullk.cu). Both TMA + wgmma.
ATTN_RELPOS = CudaKernel("flash_attention_relpos", "cvlm_attn_relpos",
                         [P, P, P, P, P, I, I, I, I, I, I])
ATTN_FULLK = CudaKernel("flash_attention_fullk", "cvlm_attn_fullk", [P, P, P, P, I, I, I, I])
# The one-pass TMA + wgmma attention read in place from the packed qkv,
# written head-leading (csrc/qkv_relpos.cu): fused 'flash' windows with
# H+W > 32 (#11) and its one-window form (#19); and the out-projection of
# that head-leading output (csrc/proj_rows.cu, the GEMM template with a
# head-leading A; the last int is the tile width) with (#8) and without (#9)
# the residual. Each has its own count.
_QKV_RELPOS_ARGS = [P, P, P, I, I, I, I, I, I, F]
QKV_RELPOS_WINDOWS = CudaKernel("flash_qkv_relpos_windows", "cvlm_qkv_relpos",
                                _QKV_RELPOS_ARGS)
QKV_RELPOS_GLOBAL = CudaKernel("flash_qkv_relpos_global", "cvlm_qkv_relpos", _QKV_RELPOS_ARGS)
_PROJ_HEADS_ARGS = [P, P, P, P, P, I, I, I, I, I, I, I, I]
PROJ_HEADS_RES = CudaKernel("proj_from_heads_res", "cvlm_proj_from_heads", _PROJ_HEADS_ARGS)
PROJ_HEADS = CudaKernel("proj_from_heads", "cvlm_proj_from_heads", _PROJ_HEADS_ARGS)
# Their fp32 instances, the routes of the other configurations at --dtype
# float32 (SAM ViT-B's unfused 'flash', 'aug_flash', the padded carry at
# windows 15-16 and >= 17): the fp32 flash loop of csrc/attn_f32.cuh with the
# loop's strides handed in (the P argument after the output: a `layouts`
# array, ops/flash_attention.py f32_split_layout / f32_packed_layout) for
# #10, #11 and #19 (csrc/qkv_relpos_f32.cu, one C entry over split or packed
# rows), #12 (csrc/qkv_windows_f32.cu) and #20 (csrc/attn_fullk_f32.cu); and
# the tiled FFMA product with a head-leading A for #8 and #9
# (csrc/proj_rows_f32.cu, arguments from ops/linear.py
# proj_heads_f32_layout). Each has its own count.
_RELPOS_F32_ARGS = [P, P, P, P, P, P, I, I, I, I, I, F, I]
ATTN_RELPOS_F32 = CudaKernel("flash_attention_relpos_f32", "cvlm_attn_relpos_f32",
                             _RELPOS_F32_ARGS)
QKV_RELPOS_WINDOWS_F32 = CudaKernel("flash_qkv_relpos_windows_f32", "cvlm_attn_relpos_f32",
                                    _RELPOS_F32_ARGS)
QKV_RELPOS_GLOBAL_F32 = CudaKernel("flash_qkv_relpos_global_f32", "cvlm_attn_relpos_f32",
                                   _RELPOS_F32_ARGS)
QKV_WINDOWS_PADDED_F32 = CudaKernel("flash_qkv_packed_windows_f32", "cvlm_qkv_packed_windows_f32",
                                    [P, P, P, P, P, P, I, I, I, I, F, I])
ATTN_FULLK_F32 = CudaKernel("flash_attention_fullk_f32", "cvlm_attn_fullk_f32",
                            [P, P, P, P, P, I, I, I, I, I])
_PROJ_HEADS_F32_ARGS = [P] * 6 + [I, I, I, L, I, I, I, I, I]
PROJ_HEADS_RES_F32 = CudaKernel("proj_from_heads_res_f32", "cvlm_proj_from_heads_f32",
                                _PROJ_HEADS_F32_ARGS)
PROJ_HEADS_F32 = CudaKernel("proj_from_heads_f32", "cvlm_proj_from_heads_f32",
                            _PROJ_HEADS_F32_ARGS)
KERNELS = (LINEAR_ACT, LN_LINEAR, LN_MASK_LINEAR, LN_MLP_RESIDUAL, PROJ_ROWS,
           QKV_PACKED_PLAIN, QKV_WINDOWS, QKV_EDGE, QKV_GLOBAL,
           LN_MLP_RESIDUAL_BWD, QKV_WINDOWS_BWD, QKV_GLOBAL_BWD, ATTN_RELPOS, ATTN_FULLK,
           QKV_WINDOWS_PADDED, QKV_RELPOS_WINDOWS, QKV_RELPOS_GLOBAL, PROJ_HEADS_RES, PROJ_HEADS,
           LN_MLP_RESIDUAL_F32, LN_LINEAR_F32, QKV_PACKED_PLAIN_F32, PROJ_ROWS_F32,
           LN_MLP_RESIDUAL_BWD_F32, LINEAR_ACT_F32, LN_MASK_LINEAR_F32, QKV_WINDOWS_F32,
           QKV_EDGE_F32, QKV_GLOBAL_F32, QKV_WINDOWS_BWD_F32, QKV_GLOBAL_BWD_F32,
           ATTN_RELPOS_F32, QKV_RELPOS_WINDOWS_F32, QKV_RELPOS_GLOBAL_F32, QKV_WINDOWS_PADDED_F32,
           ATTN_FULLK_F32, PROJ_HEADS_RES_F32, PROJ_HEADS_F32)


@functools.lru_cache(maxsize=256)
def layouts(values: tuple) -> ctypes.Array:
    """A strided entry's layout argument: the element strides as a C array
    of long long (read by the C entry at launch, so a captured graph keeps
    the values, not the array), one array per distinct layout (the C side
    only reads it)."""
    return (ctypes.c_longlong * len(values))(*values)


def has_f32_instance(name: str) -> bool:
    """Whether the kernel a wrapper launches under `name` (the name its
    launch count carries, as `use_kernel` receives it) has an fp32 instance,
    named `<name>_f32`."""
    return any(k.name == name + "_f32" for k in KERNELS)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def attn_bwd_smem(d: int, H: int, W: int, L: int, lpc: int) -> dict:
    """What `cvlm_attn_bwd` launches at these shapes, from the library
    itself (`cvlm_attn_bwd_smem`): its bias path, and its query and key
    passes' dynamic shared memory and ring stages."""
    out = (ctypes.c_longlong * 5)()
    fn = library().cvlm_attn_bwd_smem
    fn.argtypes = [I, I, I, I, I, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    if fn(d, H, W, L, lpc, out):
        raise ValueError(f"cvlm_attn_bwd_smem: no kernel at d={d}, lpc={lpc}")
    return {"path": "register" if out[0] else "general", "query_smem": out[1],
            "query_stages": out[2], "key_smem": out[3], "key_stages": out[4]}


# csrc/attn_bwd_f32.cu's tiles: 128 query rows (stats and query kernels) or
# keys (key kernel); key-kernel steps of 32 queries, query-kernel steps of
# 64 keys; at most 130 rel slots a key tile; rel_w sums in shared memory up
# to 128 lanes (in registers at W = 64)
ATTN_BWD_F32_TILE, ATTN_BWD_F32_SLOTS, ATTN_BWD_F32_WS = 128, 130, 128
ATTN_BWD_F32_KEY_STEP, ATTN_BWD_F32_QUERY_STEP = 32, 64
SMEM_MAX = 232448  # dynamic shared memory a block may have on the H100


def attn_bwd_f32_smem(d: int, W: int) -> dict:
    """What `csrc/attn_bwd_f32.cu` launches at head dim d on a grid W keys
    wide: each kernel's dynamic shared memory in bytes (the same at every H
    and W; `cvlm_attn_bwd_f32_smem` gives the library's own) and where the
    query kernel sums the rel_w lanes ("registers" at W = 64, where a
    query-kernel step is one grid row; "shared" up to ATTN_BWD_F32_WS lanes;
    else "drel", the output rows the block owns)."""
    if d not in (64, 80):
        raise ValueError(f"attn_bwd_f32_smem: no kernel at d={d}")
    t, ldq, ldr = ATTN_BWD_F32_TILE, d + 4, ATTN_BWD_F32_SLOTS + 1
    ks, qs, ldp = ATTN_BWD_F32_KEY_STEP, ATTN_BWD_F32_QUERY_STEP, t + 4
    return {"stats": 4 * (3 * t * ldq + t * ldr + t) + 4 * t,
            "key": 4 * (2 * t * ldq + 4 * ks * ldq + 2 * ks * ldp + 2 * ks * ldr) + 16 * 2 * ks
            + 4 * (t + ATTN_BWD_F32_SLOTS + 2),
            "query": 4 * (2 * (qs * ldp + qs * ldq) + ATTN_BWD_F32_WS * ldp),
            "rel_w": ("registers" if W == qs else "shared" if W <= ATTN_BWD_F32_WS
                      else "drel")}


def attn_bwd_f32_smem_library(d: int) -> dict:
    """The library's own sizes of `attn_bwd_f32_smem` (`cvlm_attn_bwd_f32_smem`)."""
    out = (ctypes.c_longlong * 3)()
    fn = library().cvlm_attn_bwd_f32_smem
    fn.argtypes = [I, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    if fn(d, out):
        raise ValueError(f"cvlm_attn_bwd_f32_smem: no kernel at d={d}")
    return {"stats": out[0], "key": out[1], "query": out[2]}


def attn_fullk_smem(d: int, dv: int) -> dict:
    """What `cvlm_attn_fullk` launches at depth d and dv, from the library
    itself (`cvlm_attn_fullk_smem`): the kernel's depth, its ring stages and
    its dynamic shared memory."""
    out = (ctypes.c_longlong * 3)()
    fn = library().cvlm_attn_fullk_smem
    fn.argtypes = [I, I, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    if fn(d, dv, out):
        raise ValueError(f"cvlm_attn_fullk_smem: no kernel at d={d}, dv={dv}")
    return {"depth": out[0], "stages": out[1], "smem": out[2]}


RELPOS_MODES = {0: "table", 1: "register", 2: "tensor_core"}


def attn_relpos_smem(H: int, W: int, d: int) -> dict:
    """What `cvlm_attn_relpos` (#10) and `cvlm_qkv_relpos` (#11, #19) launch
    on an H x W grid at depth d, from the library itself
    (`cvlm_attn_relpos_smem`): the bias mode (rel_w in "register"s, on the
    "tensor_core"s or gathered from the code "table"), whether k and v are
    resident, the consumer warpgroups and the dynamic shared memory."""
    out = (ctypes.c_longlong * 4)()
    fn = library().cvlm_attn_relpos_smem
    fn.argtypes = [I, I, I, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    if fn(H, W, d, out):
        raise ValueError(f"cvlm_attn_relpos_smem: no kernel at H={H}, W={W}, d={d}")
    return {"mode": RELPOS_MODES[out[0]], "resident": bool(out[1]), "warpgroups": out[2],
            "smem": out[3]}


def attn_f32_smem(dqk: int, dv: int, bias: str, tile: int, lanes: int = 0) -> int:
    """The dynamic shared memory (bytes) a block of csrc/attn_f32.cuh's loop
    takes at (dqk, dv), bias ("none", "sep", "edge"), tile (an index into
    ops/flash_attention.py F32_ATTN_TILES) and rel lanes, from the library
    itself (`cvlm_attn_f32_smem`, as the launches size it)."""
    fn = library().cvlm_attn_f32_smem
    fn.argtypes = [I, I, I, I, I]
    fn.restype = ctypes.c_longlong
    smem = fn(dqk, dv, {"none": 0, "sep": 1, "edge": 2}[bias], tile, lanes)
    if smem < 0:
        raise ValueError(f"cvlm_attn_f32_smem: no instance at d_qk={dqk}, dv={dv}, {bias}, "
                         f"tile {tile}")
    return smem


def mlp_bwd_smem() -> dict:
    """The MLP backward's dual GEMM, from the library itself
    (`cvlm_ln_mlp_residual_bwd_smem`): its ring stages and dynamic shared
    memory."""
    out = (ctypes.c_longlong * 2)()
    fn = library().cvlm_ln_mlp_residual_bwd_smem
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    fn(out)
    return {"stages": out[0], "smem": out[1]}


# --------------------------------------------------------------- dispatch


def use_kernel(name: str, *tensors: Optional[torch.Tensor], strided: int = 0) -> bool:
    """False when every tensor lies on the CPU (the caller runs the plain
    version); True when all lie on one CUDA device and the kernel can take
    them (contiguous, 32-byte aligned). The first `strided` tensors may be
    strided views, whose strides the wrapper checks itself. Raises on
    anything else — a CUDA tensor never falls back to the plain version.
    Gradients go through the wrappers' autograd Functions
    (`ops/autograd.py`), whose forward calls the kernel under no grad."""
    ts = [t for t in tensors if t is not None]
    devices = {t.device for t in ts}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: tensors on mixed or unsupported devices {devices}")
    for i, t in enumerate(tensors):
        if t is not None and i >= strided and not t.is_contiguous():
            raise ValueError(f"{name}: CUDA kernel needs contiguous tensors")
    for t in ts:
        if t.data_ptr() % 32 != 0:
            raise ValueError(f"{name}: CUDA kernel needs 32-byte aligned tensors")
    return True


_sm_counts: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's number of streaming multiprocessors (cached per device)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def check_dtype(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: CUDA kernel takes {dtype}, got {t.dtype}")
