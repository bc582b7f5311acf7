"""ctypes binding of libcvtpre, the native host preprocessing (`csrc/preproc`).

The port's counterpart of `camouflaged_vlm_tpu/data/native.py`: a small
plain-C library (`camouflaged_vlm_tpu_torch/csrc/preproc`, the port's own
copy of the JAX package's) that decodes JPEG and PNG, resamples with
Pillow's 8-bit NEAREST / BILINEAR / BICUBIC arithmetic and normalises in one
fused pass. Each call drops the GIL (ctypes releases it around a foreign
call), so the loaders' thread pools and the server's request handlers run
it on every core where the PIL + numpy path serialises on array
conversions. Every routine is bit-exact with the PIL path in
`data/transforms.py` (tests/test_torch_native_preproc.py).

The library is compiled at first use with `g++` (-O3 -fPIC -std=c++17, as
the JAX package's Makefile) into `<repo>/build/native/`, in two parts named
by a hash of their sources and flags, so an edit rebuilds: the core
(resample + pixops), which needs libstdc++ alone, and the decoder (decode,
-ljpeg -lpng -lz). The decoder is built only where the host has those
libraries' headers and shared libraries (where no decoder built for these
sources loads, `_probe` compiles, links and loads one call into each);
elsewhere PIL decodes and `status()` says so and why. Nothing is built at
import: the CPU tests import every module. A failed build raises with the
compiler's output.

`CVLM_NATIVE_PREPROC=0` (or false / off) chooses PIL, as in the JAX package;
it is the only way to choose PIL for the whole path. `status()` says which
path runs and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

NEAREST = 0
BILINEAR = 1
BICUBIC = 2

_OK = 0
_UNSUPPORTED = 1

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc" / "preproc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17")
# each part's sources and libraries: the decoder's L output calls pixops' luma
PARTS = {
    "core": (("resample.cc", "pixops.cc"), ()),
    "decoder": (("decode.cc", "pixops.cc"), ("-ljpeg", "-lpng", "-lz")),
}
ENV_SWITCH = "CVLM_NATIVE_PREPROC"
# one call into each of the decoder's libraries: what `_probe` compiles,
# links and loads
_PROBE_SOURCE = """#include <cstdio>
#include <jpeglib.h>
#include <png.h>
#include <zlib.h>
extern "C" int cvt_probe() {
  jpeg_error_mgr e;
  jpeg_std_error(&e);
  return (int)png_access_version_number() + (zlibVersion() != nullptr);
}
"""

_parts: dict = {}  # part -> loaded CDLL; "decoder" -> None where the host lacks it
_lock = threading.Lock()
build_info: dict = {}  # part -> {"seconds", "command"} of a build in this process
decoder_missing = ""  # why the decoder is not built on this host ("" where it is)


class _CvtImage(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
    ]


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = (
    ("cvt_decode", ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t, _I,
                                  ctypes.POINTER(_CvtImage)]),
    ("cvt_free", None, [_P]),
    ("cvt_resize", ctypes.c_int, [_P, _I, _I, _I, _P, _I, _I, _I]),
    ("cvt_rgb2l", None, [_P, ctypes.c_int64, _P]),
    ("cvt_rot90ccw", None, [_P, _I, _I, _I, _P]),
    ("cvt_fliplr", None, [_P, _I, _I, _I]),
    ("cvt_normalize", None, [_P, ctypes.c_int64, _I, _P, _P, _P]),
)


def enabled() -> bool:
    """The native path runs unless CVLM_NATIVE_PREPROC is 0, false or off."""
    env = os.environ.get(ENV_SWITCH)
    return env is None or env.strip().lower() not in ("0", "false", "off")


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("native preprocessing: no C++ compiler (g++) found to build "
                           f"{SRC_DIR}; set {ENV_SWITCH}=0 to run the PIL path")
    return found


def _tag(part: str) -> str:
    _, libs = PARTS[part]
    digest = hashlib.sha256(" ".join((part,) + CXXFLAGS + libs).encode())
    for f in sorted(SRC_DIR.glob("*")):
        if f.suffix in (".cc", ".h"):
            digest.update(f.name.encode() + f.read_bytes())
    return digest.hexdigest()[:16]


def build_command(part: str, out: Path, sources=None) -> list:
    """The one g++ command that builds `part` at `out`: the port's own
    sources (or `sources`, the probe's), no include path beyond their
    directory."""
    own, libs = PARTS[part]
    srcs = [str(SRC_DIR / f) for f in own] if sources is None else list(sources)
    return [_cxx(), *CXXFLAGS, "-shared", "-o", str(out), *srcs, *libs]


def library_path(part: str) -> Path:
    return BUILD_DIR / f"libcvtpre_{part}_{_tag(part)}.so"


def _compile(cmd: list, out: Path) -> subprocess.CompletedProcess:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode == 0:
        os.replace(cmd[cmd.index("-o") + 1], out)
    return proc


def build(part: str = "core") -> Path:
    """Compile `part` into build/native/libcvtpre_<part>_<hash>.so (once per
    source hash) and return its path. Raises with g++'s output on failure."""
    lib_path = library_path(part)
    if lib_path.exists():
        return lib_path
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = build_command(part, tmp)
    t0 = time.perf_counter()
    proc = _compile(cmd, lib_path)
    if proc.returncode != 0:
        raise RuntimeError(f"native preprocessing: g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    build_info[part] = dict(seconds=time.perf_counter() - t0, command=" ".join(cmd))
    return lib_path


def _probe() -> str:
    """'' where this host can build and load the decoder (libjpeg, libpng and
    zlib: their headers compile, the libraries link and load), else why not:
    the compiler's or the loader's first complaint."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"probe.{os.getpid()}.{threading.get_ident()}.cc"
    out = src.with_suffix(".so")
    src.write_text(_PROBE_SOURCE)
    try:
        cmd = build_command("decoder", out.with_suffix(".so.tmp"), sources=[src])
        proc = _compile(cmd, out)
        if proc.returncode != 0:
            lines = [ln for ln in (proc.stderr or proc.stdout).splitlines() if "error" in ln]
            return (lines or ["g++ failed"])[0].strip()
        try:
            ctypes.CDLL(str(out)).cvt_probe()
        except OSError as e:
            return str(e)
        return ""
    finally:
        for f in (src, out):
            f.unlink(missing_ok=True)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, restype, argtypes in _SIGNATURES:
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def library() -> ctypes.CDLL:
    """The core part (resample, luma, rot90, flip, normalise), built at the
    first call (thread-safe)."""
    lib = _parts.get("core")
    if lib is None:
        with _lock:
            if "core" not in _parts:
                _parts["core"] = _load_built("core") or _load(build("core"))
            lib = _parts["core"]
    return lib


def decoder() -> Optional[ctypes.CDLL]:
    """The decoder part: the one built for these sources where it loads,
    else built at the first call where the host has what it needs
    (`_probe`: a build directory copied from another host may hold a
    decoder whose libraries this host lacks, which then fails to load);
    None elsewhere (`decoder_missing` says why)."""
    if "decoder" not in _parts:
        with _lock:
            if "decoder" not in _parts:
                _parts["decoder"] = _load_decoder()
    return _parts["decoder"]


def _load_built(part: str) -> Optional[ctypes.CDLL]:
    """`part` as built for these sources, where it is and loads here; a
    library that does not load (built on a host with other libraries, its
    build directory copied here) is removed, to be rebuilt."""
    path = library_path(part)
    if path.exists():
        try:
            return _load(path)
        except OSError:
            path.unlink(missing_ok=True)
    return None


def _load_decoder() -> Optional[ctypes.CDLL]:
    global decoder_missing
    lib = _load_built("decoder")
    if lib is None:
        decoder_missing = _probe()
        lib = None if decoder_missing else _load(build("decoder"))
    return lib


def status() -> str:
    """Which host preprocessing runs, and why; builds the library when the
    native path is on (so a build failure shows at start-up)."""
    if not enabled():
        return f"PIL ({ENV_SWITCH}={os.environ.get(ENV_SWITCH)})"
    names = [Path(library()._name).name]
    dec = decoder()
    if dec is not None:
        names.append(Path(dec._name).name)
    parts = ("decode + resample + pixops" if dec is not None else
             f"resample + pixops; decode through PIL: this host lacks the decoder's libjpeg / "
             f"libpng / zlib ({decoder_missing})")
    return (f"native (libcvtpre: {parts}; {', '.join(names)} built from "
            f"{SRC_DIR.parent.parent.name}/csrc/preproc; {ENV_SWITCH}=0 chooses PIL)")


def _pil_decode(data: bytes, channels: int) -> np.ndarray:
    from PIL import Image

    im = Image.open(io.BytesIO(data)).convert("RGB" if channels == 3 else "L")
    return np.asarray(im).reshape(im.size[1], im.size[0], channels)


def decode(data: bytes, channels: int) -> Optional[np.ndarray]:
    """Decode JPEG/PNG bytes to (H, W, channels) uint8, PIL convert("RGB"/"L")
    semantics. None when the container is outside the decoder (16-bit PNG,
    CMYK JPEG): the caller falls back to PIL. Raises on corrupt data. On a
    host without the decoder (`decoder_missing`) PIL decodes, as `status()`
    says."""
    lib = decoder()
    if lib is None:
        return _pil_decode(data, channels)
    img = _CvtImage()
    rc = lib.cvt_decode(data, len(data), channels, ctypes.byref(img))
    if rc == _UNSUPPORTED:
        return None
    if rc != _OK:
        raise ValueError(f"cvt_decode failed (status {rc})")
    try:
        n = int(img.height) * int(img.width) * int(img.channels)
        arr = np.ctypeslib.as_array(img.data, shape=(n,)).copy()
    finally:
        lib.cvt_free(img.data)
    return arr.reshape(int(img.height), int(img.width), int(img.channels))


def decode_file(path: str, channels: int) -> Optional[np.ndarray]:
    with open(path, "rb") as f:
        return decode(f.read(), channels)


def resize(arr: np.ndarray, size: Tuple[int, int], filter: int) -> np.ndarray:
    """PIL Image.resize((w, h), filter) on a (H, W, C) or (H, W) uint8 array."""
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, ch = arr.shape
    dw, dh = size
    out = np.empty((dh, dw, ch), np.uint8)
    rc = library().cvt_resize(arr.ctypes.data, w, h, ch, out.ctypes.data, dw, dh, filter)
    if rc != _OK:
        raise ValueError(f"cvt_resize failed (status {rc})")
    return out[:, :, 0] if squeeze else out


def rgb2l(arr: np.ndarray) -> np.ndarray:
    """PIL convert("L") on a (H, W, 3) uint8 array."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, _ = arr.shape
    out = np.empty((h, w), np.uint8)
    library().cvt_rgb2l(arr.ctypes.data, h * w, out.ctypes.data)
    return out


def rot90ccw(arr: np.ndarray) -> np.ndarray:
    """np.rot90(arr, 1) for (H, W, C) uint8 (contiguous output)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, ch = arr.shape
    out = np.empty((w, h, ch), np.uint8)
    library().cvt_rot90ccw(arr.ctypes.data, w, h, ch, out.ctypes.data)
    return out


def fliplr(arr: np.ndarray) -> np.ndarray:
    """PIL FLIP_LEFT_RIGHT, returning a new contiguous array."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8).copy()
    h, w, ch = arr.shape
    library().cvt_fliplr(arr.ctypes.data, w, h, ch)
    return arr


def normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    """(arr / 255 - mean) / std in fp32, fused (the transforms' op order)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, ch = arr.shape
    mean = np.ascontiguousarray(np.broadcast_to(mean, (ch,)), np.float32)
    std = np.ascontiguousarray(np.broadcast_to(std, (ch,)), np.float32)
    out = np.empty((h, w, ch), np.float32)
    library().cvt_normalize(arr.ctypes.data, h * w, ch, mean.ctypes.data, std.ctypes.data,
                            out.ctypes.data)
    return out
