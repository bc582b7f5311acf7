"""The port's bench, engine-only throughput CLI and capture-safe scalar
multiply, on the CPU.

`cli/bench.py`'s copy of `cascade_flops_per_image` equals the root
`bench.py`'s (the JAX bench; loaded from its file, nothing run). Its JSON
lines, checked with a stubbed clock on the tiny configuration: one
per-batch line per batch in sweep order, then the headline, whose rate and
latency follow from the clock; MFU against 989 TFLOP/s from the FLOP
count. `--device cuda` without a card raises. `cli/serve_throughput.py`
runs on the CPU. `ops/layers.scaled` is bit-equal to JAX's weak-typed
scalar multiply in bf16 and fp32.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from camouflaged_vlm_tpu_torch.cli import bench, serve_throughput  # noqa: E402
from camouflaged_vlm_tpu_torch.ops.layers import scaled  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_cascade_flops_match_the_root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    assert bench.cascade_flops_per_image() == root.cascade_flops_per_image()
    assert 6e12 < bench.cascade_flops_per_image() < 7e12


def test_bench_lines_with_a_stubbed_clock(monkeypatch, capsys):
    """Every clock read advances 0.25 s: a steady-state window of `iters`
    calls reads the clock twice (0.25 s / iters a call), a latency sample
    twice (250 ms)."""
    ticks = iter(np.arange(0.0, 1e6, 0.25))
    monkeypatch.setattr(bench, "clock", lambda: float(next(ticks)))
    iters = 4
    out = bench.main(["--tiny", "--device", "cpu", "--dtype", "float32", "--batches", "2,1,3",
                      "--iters", str(iters), "--warmup", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.strip()]
    assert [list(x["per_batch_update"]) for x in lines[:-1]] == [["2"], ["1"], ["3"]]
    for x in lines[:-1]:
        (b, rec), = x["per_batch_update"].items()
        b = int(b)
        assert rec["batch"] == b and rec["device"] == "cpu"
        for kind in ("graph", "eager"):
            assert rec[f"{kind}_ms_per_call"] == pytest.approx(250.0 / iters)
            assert rec[f"{kind}_images_per_sec"] == pytest.approx(b * iters / 0.25)
            assert rec[f"{kind}_latency_ms"] == pytest.approx(250.0)
        # on the CPU the "graph" is the same eager call: the same outputs
        assert rec["graph_vs_eager_max_abs"] == {"probs": 0.0, "pred": 0.0, "logits": 0.0}
        assert rec["launches_at_capture"] is None and rec["peak_memory_gib"] is None
    head = lines[-1]
    assert head == out["headline"]
    assert head["metric"] == "cascade_images_per_sec" and head["batch"] == 3
    assert head["value"] == pytest.approx(3 * iters / 0.25)
    assert head["latency_ms_batch1"] == pytest.approx(250.0)
    assert head["device"] == "cpu" and head["card"] is None and "eager on the CPU" in head["unit"]
    # no FLOP count for the tiny configuration, no device memory on the CPU
    assert head["achieved_tflops"] is None and head["mfu"] is None
    assert head["peak_memory_gib"] is None and head["memory_reserved_gib"] is None


def test_headline_mfu_against_the_h100_peak():
    rec = lambda b, ips, lat, peak: dict(  # noqa: E731
        batch=b, graph_images_per_sec=ips, eager_images_per_sec=ips / 2, graph_latency_ms=lat,
        eager_latency_ms=3 * lat, peak_memory_gib=peak)
    per_batch = {8: rec(8, 40.0, 200.0, 3.0), 1: rec(1, 30.0, 33.0, 2.3),
                 32: rec(32, 41.0, 780.0, 5.5)}
    flops = bench.cascade_flops_per_image()
    head = bench.headline(per_batch, "bfloat16", {"inp_size": 1024, "device": "gpu",
                                                  "card": "H100, 700.00 W"}, flops, 7.25)
    assert head["batch"] == 32 and head["value"] == 41.0 and head["eager_images_per_sec"] == 20.5
    assert head["latency_ms_batch1"] == 33.0 and head["eager_latency_ms_batch1"] == 99.0
    assert head["achieved_tflops"] == pytest.approx(flops * 41.0 / 1e12)
    assert head["mfu"] == pytest.approx(flops * 41.0 / 1e12 / 989.0)
    assert head["peak_memory_gib"] == 5.5 and head["memory_reserved_gib"] == 7.25
    assert "one CUDA graph per batch" in head["unit"] and head["card"] == "H100, 700.00 W"


def test_bench_and_engine_cli_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench.main, serve_throughput.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--tiny"])


def test_serve_throughput_engine_only_on_the_cpu(capsys):
    rep = serve_throughput.main(["--tiny", "--device", "cpu", "--dtype", "float32",
                                 "--requests", "8", "--buckets", "1,4"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["serve_engine_only"]["n_images"] == 8
    assert rep["return_mask"] is False and rep["staged"] is True
    assert rep["buckets"] == [1, 4] and rep["device"] == "cpu" and rep["card"] is None
    assert rep["images_per_sec"] > 0 and rep["program_only_images_per_sec"] > 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [16, 64, 80])
def test_scaled_is_jax_weak_typed_multiply(dtype, d):
    """x * d**-0.5 on the attention inputs' shapes, bit for bit."""
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 13, 32))).astype(np.float32)
    want = np.asarray((jnp.asarray(x).astype(dtype) * d ** -0.5).astype(jnp.float32))
    got = scaled(torch.from_numpy(x).to(getattr(torch, dtype)), d ** -0.5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
