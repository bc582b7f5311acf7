"""Time the arrangements of the padded carry's attention kernels on the card.

  python -m camouflaged_vlm_tpu_torch.cli.attn_variants [--rounds 2]

Builds `csrc/variants/attn_variants.cu` (every arrangement of #12's
whole-window kernel and of #11/#19's one-pass kernel, instantiated from the
package's own sources) into its own library under build/, and times each at
the full-width bf16 shapes of `chip_smoke.padded_sites`, batch 2, 16 heads x
80: #12 at window 16 with one or two q' stages; #11 at window 17 and #19 on
the 64 x 64 grid, streaming or with k and v resident, with 1-3 consumer
warpgroups and the bias gathered from a code table, held in registers or
on the tensor cores; and the attention backward #18 on the 64 x 64 grid
(its training shape, g d-major) through the query pass's register path,
the dispatcher's pick, or the general path (bias and drel through the key
code). One JSON line each, the rounds alternating variants: the queued and
idle-card times (`chip_smoke.time_ms`) and the error against the plain
version (per output for the backward); the first line gives the card's
name and power limit and ptxas' registers, spills and barriers of every
instantiation.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(HERE, "camouflaged_vlm_tpu_torch", "csrc", "variants", "attn_variants.cu")
LIBRARY = os.path.join(HERE, "build", "variants", "libattn_variants.so")
# cvlm_variant_relpos's index -> (warpgroups, bias, k/v)
RELPOS_VARIANTS = [(1, "table", "streaming"), (2, "table", "streaming"), (1, "tc", "streaming"),
                   (2, "table", "resident"), (3, "table", "resident"), (2, "tc", "resident"),
                   (3, "tc", "resident"), (1, "register", "streaming"),
                   (2, "register", "streaming")]


def build():
    """nvcc the variants into LIBRARY; returns ptxas' usage per kernel."""
    from camouflaged_vlm_tpu_torch.cli.kernel_timing import ptxas_usage
    from camouflaged_vlm_tpu_torch.ops import _cuda

    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    cmd = [_cuda._nvcc(), *_cuda.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
           "-v", "-shared", "-o", LIBRARY, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"attn_variants: nvcc failed\n{proc.stdout}{proc.stderr}")
    usage = ptxas_usage(proc.stdout + proc.stderr)
    return {k: v for k, v in usage.items()
            if "qkv_relpos_kernel" in k or "qkv_windows_s_kernelILi80ELi256ELb0" in k
            or "attn_bwd_query_kernelILi80ELi128E" in k}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attn_variants: no CUDA device")
    from camouflaged_vlm_tpu_torch.cli.kernel_timing import _smoke, case_errors
    from camouflaged_vlm_tpu_torch.ops import flash_attention as fa
    from camouflaged_vlm_tpu_torch.ops import linear as lin

    smoke = _smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    usage = build()
    print(json.dumps({"card": smi, "build_s": time.perf_counter() - t0, "ptxas": usage}),
          flush=True)
    lib = ctypes.CDLL(LIBRARY)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cvlm_variant_windows.argtypes = [I, P, P, P, I, I, I, F, I, P]
    lib.cvlm_variant_relpos.argtypes = [I, P, P, P, I, I, I, I, I, F, P]
    lib.cvlm_variant_attn_bwd.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P]

    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run(kernel, variant, launch, out, want):
        rc = launch()
        torch.cuda.synchronize()
        if rc:
            raise SystemExit(f"attn_variants: {kernel} {variant}: CUDA error {rc}")
        print(json.dumps(dict(kernel=kernel, variant=variant,
                              queued_ms=smoke.time_ms(launch, queued=True),
                              ms=smoke.time_ms(launch), **case_errors(smoke, out, want))),
              flush=True)

    B, NH, HD, dev = 2, 16, 80, torch.device("cuda")
    scale = HD ** -0.5
    with torch.no_grad():
        win, nwin = 16, 16
        Nw = win * win
        qkv, rel = rn(B, nwin, Nw, 3 * NH * HD), rn(B, nwin, Nw, NH * 32)
        sel32 = fa.make_rel_scatter32(win, torch.bfloat16, dev)
        want = fa.flash_qkv_packed_windows_ref(qkv, rel, sel32, scale, NH, HD)
        out = lin.dmajor_empty(B, nwin, NH * HD, Nw, dtype=torch.bfloat16, device=dev)
        for _ in range(args.rounds):
            for qst in (2, 1):
                run("#12 window 16", f"{qst} q' stages", lambda qst=qst: lib.cvlm_variant_windows(
                    qst, qkv.data_ptr(), rel.data_ptr(), out.data_ptr(), B * nwin, win, NH,
                    scale, out.stride(-2), stream()), out, want)
        del qkv, rel, want, out
        for kernel, lead, H, variants in (("#11 window 17", (B, 16), 17, (0, 1, 2, 3, 4, 5, 6)),
                                          ("#19 grid 64", (B, 1), 64, (7, 8, 1))):
            N = H * H
            qkv, rel = rn(*lead, N, 3 * NH, HD), rn(*lead, N, NH, 2 * H)
            sel = fa.make_rel_scatter(H, H, torch.bfloat16, dev)
            want = fa.flash_qkv_relpos_windows_ref(qkv, rel, sel, scale)
            out = torch.empty_like(want)
            for _ in range(args.rounds):
                for v in variants:
                    nwg, bias, kv = RELPOS_VARIANTS[v]
                    run(kernel, f"{kv}, {nwg} warpgroups, bias {bias}",
                        lambda v=v: lib.cvlm_variant_relpos(
                            v, qkv.data_ptr(), rel.data_ptr(), out.data_ptr(), *lead, H, H, NH,
                            scale, stream()), out, want)
            del qkv, rel, want, out

        H = 64
        N = H * H
        qkv, rel, gy = rn(B, N, 3 * NH * HD), rn(N, B, NH, 2 * H), rn(B, NH * HD, N) * 0.05
        sel = fa.make_rel_scatter(H, H, torch.bfloat16, dev)
        want = fa.flash_qkv_packed_global_bwd_ref(qkv, rel, sel, gy, scale, NH, HD)
        _, ntp, aux, stats, code = fa.attn_bwd_scratch(qkv, B, N, H, H, 2 * H, NH, HD)
        out = (torch.empty_like(qkv), torch.empty_like(rel))
        for _ in range(args.rounds):
            for reg in (1, 0):
                run("#18 global backward", "register path" if reg else "general path",
                    lambda reg=reg: lib.cvlm_variant_attn_bwd(
                        reg, qkv.data_ptr(), rel.data_ptr(), gy.data_ptr(), out[0].data_ptr(),
                        out[1].data_ptr(), aux.data_ptr(), stats.data_ptr(), code.data_ptr(), B,
                        N, ntp, H, 2 * H, NH, scale, stream()), out, want)


if __name__ == "__main__":
    main()
