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
    if lib_path.exists():
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


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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
        err = self._fn(*args, stream)
        if err != 0:
            msg = library().cvlm_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


# One entry per wrapper (and TPU kernel replaced); the first three are the
# instantiations of csrc/ln_linear.cu: no LN, LN, LN with a row mask.
_LN_LINEAR_ARGS = [P, P, P, P, P, P, I, I, I, F, I, I]
LINEAR_ACT = CudaKernel("linear_act", "cvlm_ln_linear", _LN_LINEAR_ARGS)
LN_LINEAR = CudaKernel("ln_linear_act_bt", "cvlm_ln_linear", _LN_LINEAR_ARGS)
LN_MASK_LINEAR = CudaKernel(
    "ln_mask_linear_bt", "cvlm_ln_mask_linear", [P, P, P, P, P, P, P, I, I, I, I, I, F]
)
LN_MLP_RESIDUAL = CudaKernel(
    "ln_mlp_residual_bt", "cvlm_ln_mlp_residual", [P, P, P, P, P, P, P, P, I, I, I, F, I]
)
PROJ_ROWS = CudaKernel("proj_rows", "cvlm_proj_rows", [P, P, P, P, P, I, I, I, I])
QKV_PACKED_PLAIN = CudaKernel(
    "flash_qkv_packed_plain", "cvlm_qkv_packed_plain", [P, P, I, I, I, I, F]
)
QKV_WINDOWS = CudaKernel(
    "flash_qkv_packed_windows_s", "cvlm_qkv_packed_windows", [P, P, P, I, I, I, I, F]
)
QKV_EDGE = CudaKernel(
    "flash_qkv_packed_edge", "cvlm_qkv_packed_edge", [P, P, P, P, P, P, I, I, I, I, I, F]
)
QKV_GLOBAL = CudaKernel(
    "flash_qkv_packed_global", "cvlm_qkv_packed_global", [P, P, P, I, I, I, I, I, I, F]
)
# The hand-written backward kernels (training): the fused MLP's (#6), and one
# attention backward (csrc/attn_bwd.cu) for the windows (#14) and the
# global blocks (#18), each with its own count.
LN_MLP_RESIDUAL_BWD = CudaKernel(
    "ln_mlp_residual_bt_bwd", "cvlm_ln_mlp_residual_bwd",
    [P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, F, I],
)
_ATTN_BWD_ARGS = [P, P, P, P, P, P, I, I, I, I, I, I, I, F]
QKV_WINDOWS_BWD = CudaKernel("flash_qkv_packed_windows_s_bwd", "cvlm_attn_bwd", _ATTN_BWD_ARGS)
QKV_GLOBAL_BWD = CudaKernel("flash_qkv_packed_global_bwd", "cvlm_attn_bwd", _ATTN_BWD_ARGS)
# Attention over split q, k, v (csrc/attn_split.cuh): SAM's unfused 'flash'
# path (#10, rel-pos bias) and the 'aug_flash' global blocks (#20).
ATTN_RELPOS = CudaKernel("flash_attention_relpos", "cvlm_attn_relpos",
                         [P, P, P, P, P, I, I, I, I, I, I])
ATTN_FULLK = CudaKernel("flash_attention_fullk", "cvlm_attn_fullk", [P, P, P, P, I, I, I, I])
KERNELS = (LINEAR_ACT, LN_LINEAR, LN_MASK_LINEAR, LN_MLP_RESIDUAL, PROJ_ROWS,
           QKV_PACKED_PLAIN, QKV_WINDOWS, QKV_EDGE, QKV_GLOBAL,
           LN_MLP_RESIDUAL_BWD, QKV_WINDOWS_BWD, QKV_GLOBAL_BWD, ATTN_RELPOS, ATTN_FULLK)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


# --------------------------------------------------------------- dispatch


def use_kernel(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """False when every tensor lies on the CPU (the caller runs the plain
    version); True when all lie on one CUDA device and the kernel can take
    them (contiguous, 32-byte aligned). Raises on anything else — a CUDA
    tensor never falls back to the plain version. Gradients go through the
    wrappers' autograd Functions (`ops/autograd.py`), whose forward calls
    the kernel under no grad."""
    ts = [t for t in tensors if t is not None]
    devices = {t.device for t in ts}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: tensors on mixed or unsupported devices {devices}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name}: CUDA kernel needs contiguous tensors")
        if t.data_ptr() % 32 != 0:
            raise ValueError(f"{name}: CUDA kernel needs 32-byte aligned tensors")
    return True


def check_dtype(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: CUDA kernel takes {dtype}, got {t.dtype}")
