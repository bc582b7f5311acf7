"""The port's profiler (`utils/profiling.py`, `cli/profile.py`) against the
JAX package's, on the CPU.

`Timeline.report()` prints the JAX package's string for the same sections;
the profile CLI takes JAX's flags plus the port's `--device`, `--seed` and
checkpoint flags, prints JAX's line names and writes its traces; on the CPU
its breakdown says that the trace holds no device events. The breakdown's
attribution (a launch's `record_function` range or aten op, a replay's
kernels matched to an eager trace's in launch order, the families) is held
on hand-built trace events, since no CPU trace has device events. Exact
equality throughout: strings, option sets and sums of the same floats.
"""

import argparse
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from camouflaged_vlm_tpu.utils import profiling as j_profiling  # noqa: E402

from camouflaged_vlm_tpu_torch.cli import profile  # noqa: E402
from camouflaged_vlm_tpu_torch.utils import profiling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT_FLAGS = {"--sam-ckpt", "--clip-ckpt", "--maple-ckpt", "--cascade-ckpt",
                    "--text-bank"}


def test_timeline_report_is_jax_report():
    sections = {"encode": 0.0123, "classify": 0.25, "decode": 0.0031, "upsample": 0.0004}
    ours, theirs = profiling.Timeline(), j_profiling.Timeline()
    ours.sections, theirs.sections = dict(sections), dict(sections)
    assert ours.report() == theirs.report()
    tl = profiling.Timeline()
    with tl.section("a"):
        pass
    with tl.section("a"):
        pass
    assert list(tl.sections) == ["a"] and tl.sections["a"] >= 0
    assert tl.barrier((torch.ones(3, dtype=torch.bfloat16), None)) == 3.0
    assert tl.barrier({"x": [torch.arange(4)]}) == 6.0


def _jax_option_strings(monkeypatch):
    """The option strings of JAX's profile CLI, whose parser lives inside
    main(): its parse_args is stopped there."""
    from camouflaged_vlm_tpu.cli import profile as jprofile

    seen = {}

    class Stop(Exception):
        pass

    def stop(self, *a, **k):
        seen["parser"] = self
        raise Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    monkeypatch.setattr(sys, "argv", ["profile"])
    with pytest.raises(Stop):
        jprofile.main()
    monkeypatch.undo()
    return seen["parser"]


def _options(parser):
    return {s: a for a in parser._actions for s in a.option_strings if s not in ("-h", "--help")}


def test_profile_cli_flags_are_jax_flags(monkeypatch):
    jax_opts = _options(_jax_option_strings(monkeypatch))
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def keep(self, *a, **k):
        captured["parser"] = self
        return real(self, *a, **k)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", keep)
    args = profile.parse_args([])
    ours = _options(captured["parser"])
    assert set(ours) == set(jax_opts) | {"--device", "--seed"} | CHECKPOINT_FLAGS
    for s, a in jax_opts.items():  # JAX's defaults, the trace directory's name
        if s == "--trace-dir":
            assert args.trace_dir.endswith("camouflaged-vlm-trace")
        else:
            assert ours[s].default == a.default, s
    assert args.device == "cuda" and args.seed == 0


def test_profile_cli_on_cpu_prints_jax_lines_and_writes_traces(tmp_path, capsys):
    out = profile.main(["--tiny", "--device", "cpu", "--iters", "1", "--warmup", "0",
                        "--stages", "--trace", "--batch", "1", "--dtype", "float32",
                        "--trace-dir", str(tmp_path)])
    text = capsys.readouterr().out
    for name in ("sam encoder", "clip classify (1 pass)", "FULL fused cascade",
                 "throughput:"):
        assert any(line.startswith(name) for line in text.splitlines()), name
    assert set(out["seconds"]) == {"sam encoder", "clip classify (1 pass)",
                                   "FULL fused cascade"}
    for path in out["traces"]:
        assert path.startswith(str(tmp_path)) and (tmp_path / path.split("/")[-1]).stat().st_size
    # the CPU's traces hold no device event, and the breakdown invents none
    for b in (out["replay"], out["eager"]):
        assert b["events"] == 0 and b["total_ms"] == 0 and not b["kernels"]
    assert "holds no device events" in text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profile.main(["--tiny"])


# ------------------------------------------------ the breakdown's reading


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


def _event(name, device, start, end, id=0, parent=None):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, id=id, cpu_parent=parent, time_range=_Range(start, end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


class _Trace:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


GEMM = "void (anonymous namespace)::gemm_tma_kernel<128, 1, false>(CUtensorMap_st)"
CUBLAS = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_cublas"
FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >()"
UPS = "void at::native::upsample_bilinear2d_out_frame<float, float>(int)"


def _eager_trace():
    """An eager call: a port kernel launched under its range (and the
    range's device span, which is no kernel), a cuBLAS GEMM
    under aten::linear > aten::addmm, a fill under aten::full, a copy, and
    an upsample whose launch has no op around it."""
    ev = []
    rng = _event("cvlm::ln_linear_act_bt", False, 0, 10, id=11)
    linear = _event("aten::linear", False, 10, 30, id=12)
    addmm = _event("aten::addmm", False, 11, 29, id=13, parent=linear)
    full = _event("aten::full", False, 30, 40, id=14)
    ev += [rng, linear, addmm, full]
    launches = [("cuLaunchKernelEx", rng, 101), ("cudaLaunchKernel", addmm, 102),
                ("cudaLaunchKernel", full, 103), ("cudaMemcpyAsync", None, 104),
                ("cudaLaunchKernel", None, 105)]
    for i, (n, parent, cid) in enumerate(launches):
        ev.append(_event(n, False, 1 + 10 * i, 2 + 10 * i, id=cid, parent=parent))
    # the device span the profiler shows for the launch's range: no kernel
    ev.append(_event("cvlm::ln_linear_act_bt", True, 100, 140))
    for name, cid, (a, b) in ((GEMM, 101, (100, 140)), (CUBLAS, 102, (140, 150)),
                              (FILL, 103, (150, 152)), ("Memcpy HtoD (Pageable -> Device)", 104,
                                                        (152, 160)), (UPS, 105, (160, 165))):
        ev.append(_event(name, True, a, b, id=cid))
    return _Trace(ev)


def test_breakdown_attributes_eager_launches_and_sums_to_total():
    b = profiling.device_breakdown(_eager_trace())
    assert b["events"] == 5
    assert b["families"] == {"port kernels": 0.040, "cuBLAS": 0.010, "cuDNN": 0.0,
                             "aten": 0.002 + 0.005, "copies and fills": 0.008, "other": 0.0}
    assert sum(b["families"].values()) == b["total_ms"]
    assert sum(b["shares"].values()) == pytest.approx(1.0, abs=1e-12)
    assert b["busy_ms"] == pytest.approx(0.065)
    labels = {label: (fam, n) for fam, label, _, n in b["kernels"]}
    assert labels["ln_linear_act_bt"] == ("port kernels", 1)
    assert labels["aten::full"] == ("aten", 1)  # the outermost aten op
    assert labels["upsample_bilinear2d_out_frame"] == ("aten", 1)  # no op: its name
    # library kernels by the aten op that launched them
    assert b["aten_ops"] == {"aten::linear": pytest.approx(0.010),
                             "aten::full": pytest.approx(0.002)}
    lines = profiling.format_breakdown(b)
    assert lines[0].startswith("device time 0.065 ms a call in 5 device events")


def test_breakdown_of_a_replay_takes_the_eager_owners_in_launch_order():
    eager = _eager_trace()
    like = profiling.attribute(eager)
    # two replays: the eager call's kernels, one graph launch, no CPU op;
    # the second replay has one kernel more, which no owner pairs
    ev = [_event("cudaGraphLaunch", False, 0, 1, id=900)]
    extra = ("void splitKreduce_kernel<32, 16>()", (57, 58))
    for r in range(2):
        t = 1000 * r
        kernels = ((GEMM, (0, 40)), (CUBLAS, (40, 50)), (FILL, (50, 52)), (UPS, (52, 57)))
        for name, (a, b) in kernels + ((extra,) if r else ()):
            ev.append(_event(name, True, t + a, t + b, id=900))
    rep = profiling.device_breakdown(_Trace(ev), like=like)
    assert rep["matched"] == 8 / 9
    labels = {label: n for _, label, _, n in rep["kernels"]}
    assert labels["ln_linear_act_bt"] == 2 and labels["aten::full"] == 2
    assert labels["splitKreduce_kernel"] == 1
    assert rep["aten_ops"]["aten::linear"] == pytest.approx(0.020)
    assert rep["total_ms"] == pytest.approx(rep["busy_ms"])  # one stream, no overlap
    # without an eager trace: no owners, the families by name only
    alone = profiling.device_breakdown(_Trace(ev))
    assert alone["matched"] is None and alone["families"] == rep["families"]
    assert {label for _, label, _, _ in alone["kernels"]} == {
        "gemm_tma_kernel", CUBLAS, "vectorized_elementwise_kernel",
        "upsample_bilinear2d_out_frame", "splitKreduce_kernel"}
    assert alone["aten_ops"] == {}


def test_align_pairs_repeated_calls_and_resyncs():
    call = ["a", "b", "c", "d"]
    assert profiling.align(list("abcdabcd"), call) == {i: i % 4 for i in range(8)}
    # a kernel missing in the second call, one extra in the third
    got = profiling.align(list("abcdacdabxcd"), call)
    assert got == {0: 0, 1: 1, 2: 2, 3: 3, 4: 0, 5: 2, 6: 3, 7: 0, 8: 1, 10: 2, 11: 3}
    assert profiling.align(["x"], []) == {}


def test_a_cli_script_keeps_the_standard_profile_module():
    """`cli/kernel_timing.py` runs as a script (`python .../cli/kernel_timing.py`),
    which puts `cli/` first on sys.path, where `cli/profile.py` would shadow
    the standard library's `profile` (torch imports cProfile, which imports
    it): its main() takes its own directory off the path first."""
    cli = os.path.join(REPO, "camouflaged_vlm_tpu_torch", "cli")
    code = (
        "import runpy, sys\n"
        f"sys.path.insert(0, {cli!r})\n"
        "sys.argv = ['kernel_timing.py', '--help']\n"
        "try:\n"
        f"    runpy.run_path({os.path.join(cli, 'kernel_timing.py')!r}, run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "import cProfile, profile\n"
        "print('PROFILE', profile.__file__)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    path = proc.stdout.split("PROFILE")[1].strip()
    assert os.path.dirname(path) != cli, path
