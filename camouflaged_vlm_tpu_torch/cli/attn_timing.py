"""Time the TMA + wgmma attention kernels of one checkout on the card.

  python camouflaged_vlm_tpu_torch/cli/attn_timing.py [--root DIR] [--label NAME]

Imports `camouflaged_vlm_tpu_torch` from the checkout at --root (default:
this one), builds its kernels there, and times #16 (CLIP, (2, 581, 3072),
16 heads x 64), #13 (SAM ViT-H windows, (32, 196, 3840), rel (196, 32,
512)) and #17 (SAM ViT-H global, (2, 4096, 3840), rel (4096, 2, 16, 128))
at the main path's bf16 shapes: the idle-card median and the queued time
(`chip_smoke.time_ms`), the host's cost of one launch (the enqueue time of
20 calls behind a device-side wait: through the Python wrapper, and through
the C entry point alone), the error against the plain version, SDPA's time
on the same inputs, and the registers and shared memory ptxas gave each
attention kernel. Two checkouts compare on one card in one call when their
runs alternate (parent, change, change, parent); each prints one JSON line
per kernel, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _smoke():
    """This checkout's chip_smoke.py, for its timing helpers."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_usage(log: str) -> dict:
    """Registers, spills and static shared memory of each attention kernel
    instantiation in an nvcc -Xptxas -v log."""
    out, lines = {}, log.splitlines()
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(_ZN4cvlm\d+(attn_stream_kernel"
                      r"|qkv_windows_s_kernel|qkv_global_kernel|attn_rows_kernel)\S*)'", ln)
        if m:
            out[m.group(1)] = "; ".join(x.strip() for x in lines[i + 1:i + 4]
                                        if "Used" in x or "spill" in x)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose package to time")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    smoke = _smoke()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attn_timing: no CUDA device")
    from camouflaged_vlm_tpu_torch.ops import _cuda
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa

    label = args.label or root
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    usage = ptxas_usage(_cuda.build_info.get("log", ""))
    print(json.dumps({"label": label, "card": smi, "build_s": build_s, "ptxas": usage}),
          flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    bf, F = torch.bfloat16, torch.nn.functional

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(bf)

    def sdpa(qkv, heads, d, scale, bias=None):
        r = qkv.reshape(qkv.shape[:-1] + (3, heads, d))
        q, k, v = (r[..., i, :, :].transpose(-3, -2) for i in range(3))
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)

    B, NH, HD, WIN, G = 2, 16, 80, 14, 64
    sam = HD ** -0.5
    qkv_clip = rn(B, 581, 3 * 1024)
    qkv_win, rel_win = rn(32, WIN * WIN, 3 * 1280), rn(WIN * WIN, 32, NH * 32)
    sel32 = fa.make_rel_scatter32(WIN, bf, torch.device("cuda"))
    qkv_glob, rel_glob = rn(B, G * G, 3 * 1280), rn(G * G, B, NH, 2 * G)
    sel_glob = fa.make_rel_scatter(G, G, bf, torch.device("cuda"))
    bias_win = torch.matmul(rel_win.reshape(WIN * WIN, 32, NH, 32).permute(1, 2, 0, 3), sel32)
    bias_glob = torch.matmul(rel_glob.permute(1, 2, 0, 3), sel_glob)
    out_clip = torch.empty(B, 1024, 581, dtype=bf, device="cuda")
    out_win = torch.empty(32, 1280, WIN * WIN, dtype=bf, device="cuda")
    out_glob = torch.empty(B, 1280, G * G, dtype=bf, device="cuda")
    # the parent checkout's #13 entry point took one more int (0: rel position-major)
    win_extra = [0] * (len(_cuda.QKV_WINDOWS.argtypes) - 9)
    cases = [
        ("flash_qkv_packed_plain", lambda: fa.flash_qkv_packed_plain(qkv_clip, 0.125, 16, 64),
         lambda: fa.flash_qkv_packed_plain_ref(qkv_clip, 0.125, 16, 64),
         lambda: _cuda.QKV_PACKED_PLAIN(qkv_clip.data_ptr(), out_clip.data_ptr(), B, 581, 16,
                                        64, 0.125),
         sdpa(qkv_clip, 16, 64, 0.125)),
        ("flash_qkv_packed_windows_s",
         lambda: fa.flash_qkv_packed_windows_s(qkv_win, rel_win, sel32, sam, NH, HD),
         lambda: fa.flash_qkv_packed_windows_s_ref(qkv_win, rel_win, sel32, sam, NH, HD),
         lambda: _cuda.QKV_WINDOWS(qkv_win.data_ptr(), rel_win.data_ptr(), out_win.data_ptr(),
                                   32, WIN, NH, HD, sam, *win_extra),
         sdpa(qkv_win, NH, HD, sam, bias_win)),
        ("flash_qkv_packed_global",
         lambda: fa.flash_qkv_packed_global(qkv_glob, rel_glob, sel_glob, sam, NH, HD, G, G),
         lambda: fa.flash_qkv_packed_global_ref(qkv_glob, rel_glob, sel_glob, sam, NH, HD),
         lambda: _cuda.QKV_GLOBAL(qkv_glob.data_ptr(), rel_glob.data_ptr(), out_glob.data_ptr(),
                                  B, G * G, G, G, NH, HD, sam),
         sdpa(qkv_glob, NH, HD, sam, bias_glob)),
    ]
    with torch.no_grad():
        for name, kfn, pfn, entry, lib in cases:
            got = kfn()
            torch.cuda.synchronize()
            e = smoke.errors(got, pfn())
            rec = dict(label=label, name=name, **e,
                       ms=smoke.time_ms(kfn), queued_ms=smoke.time_ms(kfn, queued=True),
                       library_ms=smoke.time_ms(lib),
                       library_queued_ms=smoke.time_ms(lib, queued=True),
                       host_us_wrapper=smoke.host_us(kfn), host_us_entry=smoke.host_us(entry),
                       host_us_library=smoke.host_us(lib))
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
