"""The port's serving engine and HTTP front end, on the CPU.

The tiny cascade in both packages on the same weights (JAX params drawn
with numpy over `jax.eval_shape`'s tree, converted by the port's
`io/convert.py`), behind each package's `InferenceEngine` with buckets
(1, 2, 4): the same requests give equal predicted classes, logits within
1e-4 relative (fp32 on both sides, summation order only, as in
test_torch_cascade.py), float16 masks within 1e-3 absolute (the float16
rounding of probabilities that differ by ~1e-6 can land one float16 step,
<= 4.9e-4 below 1, apart) and uint8 masks within 1 (a probability that
close to a rounding boundary of round(p * 255) can fall either side).

Then the counterparts of tests/test_serve.py's behaviour tests on the
port's engine alone. Left out: the JAX engine's two data-parallel tests
(`test_data_parallel_*`): the port's engine has no mesh yet (multi-device
serving is a later item of the port).
"""

import base64
import http.client
import io
import json
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from camouflaged_vlm_tpu.factory import make_bank_inputs as j_make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu.models import CascadeConfig as JCascadeConfig  # noqa: E402
from camouflaged_vlm_tpu.models import OVCOSCascade as JCascade  # noqa: E402
from camouflaged_vlm_tpu.serve import InferenceEngine as JInferenceEngine  # noqa: E402
from camouflaged_vlm_tpu.serve import ServeConfig as JServeConfig  # noqa: E402

from camouflaged_vlm_tpu_torch.cli import serve as serve_cli  # noqa: E402
from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu_torch.io.convert import load_jax_params  # noqa: E402
from camouflaged_vlm_tpu_torch.models import CascadeConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.serve import InferenceEngine, ServeConfig, bench_engine  # noqa: E402

CLASSNAMES = ["cat", "owl", "snow leopard", "scorpionfish"]


def random_params(shapes, seed=0):
    """numpy params over an eval_shape tree: LayerNorm scales near 1, the
    logit scale at its init, everything else N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        name = str(path[-1].key)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)
        if name == "logit_scale":
            return np.full(sd.shape, np.log(1 / 0.07), np.float32)
        return (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, cfg, params, bank) and (port model, cfg, bank) on the
    same weights."""
    jcfg = JCascadeConfig.tiny()
    jmodel = JCascade(jcfg)
    jbank = j_make_bank_inputs(jcfg, CLASSNAMES, seed=0)
    S, C = jcfg.inp_size, jcfg.clip_size
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, S, S, 3)), jnp.zeros((1, C, C, 3)),
                              jnp.zeros((1, C, C, 1)), jbank["prefix"], jbank["suffix"],
                              jbank["eot_indices"], jbank["bank_features"],
                              method=jmodel.infer_cascade),
        jax.random.PRNGKey(0))
    params = random_params(shapes, seed=4)
    cfg = CascadeConfig.tiny()
    model = build_cascade(cfg, "cpu")
    load_jax_params(model, params, cfg)
    bank = make_bank_inputs(cfg, CLASSNAMES, seed=0)
    return (jmodel, jcfg, jax.tree.map(jnp.asarray, params), jbank), (model, cfg, bank)


def _make_engine(pair, **kw):
    model, cfg, bank = pair[1]
    serve_cfg = ServeConfig(**{"buckets": (1, 2, 4), "max_delay_ms": 200.0, **kw})
    return InferenceEngine(model, cfg, bank, CLASSNAMES, serve_cfg)


def _rand_inputs(cfg, rng, n):
    inp = rng.integers(0, 256, (n, cfg.inp_size, cfg.inp_size, 3), dtype=np.uint8)
    cimg = rng.integers(0, 256, (n, cfg.clip_size, cfg.clip_size, 3), dtype=np.uint8)
    return inp, cimg


def _submit_concurrently(eng, inp, cimg):
    futures = [None] * len(inp)
    threads = [threading.Thread(
        target=lambda i=i: futures.__setitem__(i, eng.submit(inp[i], cimg[i])))
        for i in range(len(inp))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return futures


def _direct(eng, inp, cimg):
    """The engine's batch-1 program on one request, as numpy."""
    probs, pred, score = eng._graph_for(1)(torch.from_numpy(inp[None]),
                                           torch.from_numpy(cimg[None]))
    return probs.numpy()[0], int(pred[0]), score.float().numpy()[0]


@pytest.mark.parametrize("mask_dtype", ["float16", "uint8"])
def test_engine_matches_jax_engine(pair, mask_dtype):
    """Three requests submitted together coalesce into one padded bucket-4
    batch in both engines; each request's results agree."""
    (jmodel, jcfg, jparams, jbank), (model, cfg, bank) = pair
    scfg = dict(buckets=(1, 2, 4), max_delay_ms=300.0, mask_dtype=mask_dtype)
    jeng = JInferenceEngine(jmodel, jcfg, jparams, jbank, CLASSNAMES, JServeConfig(**scfg))
    eng = InferenceEngine(model, cfg, bank, CLASSNAMES, ServeConfig(**scfg))
    try:
        inp, cimg = _rand_inputs(jcfg, np.random.default_rng(11), 3)
        want = [f.result(timeout=300) for f in [jeng.submit(inp[i], cimg[i]) for i in range(3)]]
        got = [f.result(timeout=300) for f in [eng.submit(inp[i], cimg[i]) for i in range(3)]]
        assert eng.stats()["batches"] == jeng.stats()["batches"] == 1
        assert eng.stats()["batched_images"] == 4
        for (p, d, s), (jp, jd, js) in zip(got, want):
            assert d == jd
            js = np.asarray(js, np.float64)
            np.testing.assert_allclose(s, js, rtol=1e-4, atol=1e-4 * np.abs(js).max())
            assert p.dtype == np.asarray(jp).dtype and p.shape == np.asarray(jp).shape
            diff = np.abs(p.astype(np.float64) - np.asarray(jp, np.float64)).max()
            assert diff <= (1.0 if mask_dtype == "uint8" else 1e-3), diff
        # the run is not degenerate: the masks vary and the classes separate
        assert np.asarray(want[0][0], np.float64).std() > 1e-3
        assert float(np.ptp(np.asarray(want[0][2]))) > 1e-2
    finally:
        jeng.close()
        eng.close()


def test_batched_padded_matches_direct(pair, rng):
    """3 concurrent requests coalesce into one bucket-4 (padded) batch whose
    per-request results equal the batch-1 program on each request."""
    cfg = pair[1][1]
    eng = _make_engine(pair)
    try:
        inp, cimg = _rand_inputs(cfg, rng, 3)
        results = [f.result(timeout=120) for f in _submit_concurrently(eng, inp, cimg)]
        for i, (probs, pred, score) in enumerate(results):
            p1, d1, s1 = _direct(eng, inp[i], cimg[i])
            np.testing.assert_allclose(probs.astype(np.float32), p1.astype(np.float32),
                                       atol=2e-3)
            assert pred == d1
            np.testing.assert_allclose(score, s1, rtol=1e-4, atol=1e-5)
        s = eng.stats()
        assert s["requests"] == 3
        assert s["batches"] < 3  # coalesced
        assert s["batched_images"] >= 4  # a 3-request batch ran at bucket 4
        assert s["pad_fraction"] > 0
    finally:
        eng.close()


def test_bucket_selection(pair):
    eng = _make_engine(pair)
    try:
        assert [eng._bucket_for(n) for n in (1, 2, 3, 4, 5)] == [1, 2, 4, 4, 4]
    finally:
        eng.close()


def test_default_buckets_and_checks():
    cfg = ServeConfig()
    assert cfg.buckets == (1, 4, 16, 32) and cfg.max_delay_ms == 10.0
    assert (cfg.queue_capacity, cfg.mask_dtype, cfg.max_inflight, cfg.return_mask) == (
        256, "float16", 2, True)
    for bad in (dict(buckets=()), dict(buckets=(4, 1)), dict(mask_dtype="float32"),
                dict(max_inflight=0)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)


def test_large_bucket_coalesces_and_matches_direct(pair, rng):
    """A burst bigger than the small buckets rides the 32 bucket (padded)
    and every request still gets its own result."""
    cfg = pair[1][1]
    eng = _make_engine(pair, buckets=(1, 32), max_delay_ms=300.0)
    try:
        n = 20
        inp, cimg = _rand_inputs(cfg, rng, n)
        results = [f.result(timeout=300) for f in _submit_concurrently(eng, inp, cimg)]
        s = eng.stats()
        assert s["requests"] == n and s["batches"] < n
        assert s["batched_images"] >= 32, s
        for i in (0, n // 2, n - 1):
            probs, pred, score = results[i]
            p1, d1, s1 = _direct(eng, inp[i], cimg[i])
            np.testing.assert_allclose(probs.astype(np.float32), p1.astype(np.float32),
                                       atol=2e-3)
            assert pred == d1
    finally:
        eng.close()


def test_predict_pil_shapes(pair, rng):
    eng = _make_engine(pair, max_delay_ms=1.0)
    try:
        img = Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8))
        out = eng.predict_pil(img, timeout=120)  # the mask at the original size
        assert out["class"] in CLASSNAMES
        assert out["mask"].shape == (50, 70) and out["mask"].dtype == np.uint8
        assert isinstance(out["score"], float)
        out2 = eng.predict_pil(img, timeout=120, want_mask=False)
        assert "mask" not in out2 and out2["class_id"] == out["class_id"]
    finally:
        eng.close()


def test_predict_bytes_matches_pil(pair, rng):
    eng = _make_engine(pair, max_delay_ms=1.0)
    try:
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)).save(buf, "PNG")
        a = eng.predict_bytes(buf.getvalue(), timeout=120)
        b = eng.predict_pil(Image.open(io.BytesIO(buf.getvalue())), timeout=120)
        assert a["class_id"] == b["class_id"] and a["score"] == b["score"]
        assert a["mask"].shape == (50, 70) and a["mask"].dtype == np.uint8
        assert np.array_equal(a["mask"], b["mask"])
        with pytest.raises((ValueError, OSError)):
            eng.predict_bytes(b"not an image at all", timeout=120)
    finally:
        eng.close()


def test_uint8_mask_matches_float16(pair, rng):
    """mask_dtype='uint8' returns round(p * 255) of the float16 path."""
    cfg = pair[1][1]
    eng8 = _make_engine(pair, mask_dtype="uint8", max_delay_ms=1.0)
    eng16 = _make_engine(pair, max_delay_ms=1.0)
    try:
        inp, cimg = _rand_inputs(cfg, rng, 1)
        p8, d8, _ = eng8.submit(inp[0], cimg[0]).result(timeout=120)
        p16, d16, _ = eng16.submit(inp[0], cimg[0]).result(timeout=120)
        assert p8.dtype == np.uint8 and p16.dtype == np.float16
        np.testing.assert_allclose(p8.astype(np.float32),
                                   np.round(p16.astype(np.float32) * 255), atol=1.0)
        assert d8 == d16
        img = Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
        out = eng8.predict_pil(img, timeout=120)
        assert out["mask"].shape == (30, 40) and out["mask"].dtype == np.uint8
    finally:
        eng8.close()
        eng16.close()


def test_close_drains_then_rejects(pair, rng):
    """Requests queued before close() still resolve; submits after raise."""
    eng = _make_engine(pair, max_delay_ms=500.0)
    inp, cimg = _rand_inputs(pair[1][1], rng, 2)
    futs = [eng.submit(inp[i], cimg[i]) for i in range(2)]
    eng.close()
    for f in futs:
        probs, _, _ = f.result(timeout=120)  # drained, not dropped
        assert probs.ndim == 2
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(inp[0], cimg[0])
    assert not eng._worker.is_alive() and not eng._completer.is_alive()


def test_concurrent_submit_close_race(pair, rng):
    """Submits racing close() from more threads than this host has cores,
    with a short switch interval: every future either resolves (queued
    before the drain sentinel) or submit() raises; none hangs."""
    eng = _make_engine(pair, max_delay_ms=1.0)
    inp, cimg = _rand_inputs(pair[1][1], rng, 1)
    results = []
    lock = threading.Lock()

    def hammer():
        for _ in range(8):
            try:
                fut = eng.submit(inp[0], cimg[0])
            except RuntimeError:
                with lock:
                    results.append(("rejected", None))
                continue
            with lock:
                results.append(("accepted", fut))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(12)]
        for t in threads:
            t.start()
        eng.close()  # races the hammers
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 96
    for kind, fut in results:
        if kind == "accepted":
            probs, _, _ = fut.result(timeout=120)  # must resolve
            assert probs.ndim == 2
    assert eng.stats()["requests"] == sum(k == "accepted" for k, _ in results)


def test_warmup_sets_ready(pair):
    eng = _make_engine(pair, buckets=(1,))
    try:
        assert not eng.ready()
        eng.warmup()
        assert eng.ready() and set(eng._graphs) == {1}
        assert eng._graphs[1].graph is None  # on the CPU the program runs eagerly
    finally:
        eng.close()


def test_http_server_end_to_end(pair, rng):
    eng = _make_engine(pair, max_delay_ms=1.0, buckets=(1, 2))
    server, thread = serve_cli.serve_forever(eng, "127.0.0.1", 0, quiet=True)
    conn = None
    try:
        port = server.server_address[1]
        for _ in range(600):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("GET", "/healthz")
            r = conn.getresponse()
            r.read()
            if r.status == 200:
                break
            time.sleep(0.05)
        else:
            raise AssertionError("server never became ready")

        conn.request("GET", "/classnames")
        assert json.loads(conn.getresponse().read()) == CLASSNAMES

        img = Image.fromarray(rng.integers(0, 256, (40, 60, 3), dtype=np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="JPEG")
        conn.request("POST", "/predict", body=buf.getvalue())
        r = conn.getresponse()
        assert r.status == 200
        resp = json.loads(r.read())
        assert resp["class"] in CLASSNAMES and resp["latency_ms"] >= 0
        mask = Image.open(io.BytesIO(base64.b64decode(resp["mask_png_b64"])))
        assert mask.size == (60, 40)

        conn.request("POST", "/predict?mask=0", body=buf.getvalue())
        resp = json.loads(conn.getresponse().read())
        assert "mask_png_b64" not in resp and resp["class"] in CLASSNAMES

        conn.request("POST", "/predict", body=b"not an image")  # malformed -> 400
        r = conn.getresponse()
        assert r.status == 400
        r.read()

        # an unknown POST path drains its body, so the keep-alive
        # connection stays in sync
        conn.request("POST", "/segment", body=buf.getvalue())
        r = conn.getresponse()
        assert r.status == 404
        r.read()
        conn.request("POST", "/predict?mask=0", body=buf.getvalue())
        r = conn.getresponse()
        assert r.status == 200
        assert json.loads(r.read())["class"] in CLASSNAMES

        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["requests"] >= 2 and stats["ready"]

        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        assert "cvlm_requests_total" in text and "cvlm_ready 1" in text
    finally:
        if conn is not None:
            conn.close()
        server.shutdown()
        eng.close()
        server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_bench_engine_staged_classification_only(pair, rng):
    """`bench_engine` drives the real batcher and completion threads with a
    shape-keyed input cache behind `_put`, removed afterwards; a
    return_mask=False engine resolves futures as (None, class_id, logits)."""
    cfg = pair[1][1]
    eng = _make_engine(pair, return_mask=False, max_delay_ms=5.0)
    try:
        eng.warmup()
        rep = bench_engine(eng, n_images=12, stage_inputs=True, pool=2)
        assert "_put" not in vars(eng)  # the staging wrapper is gone
        assert rep["images_per_sec"] > 0 and rep["n_images"] == 12
        assert rep["staged"] is True and rep["return_mask"] is False
        assert sum(rep["batch_size_hist"].values()) >= 1
        assert rep["bucket_latency_ms"]

        inp, cimg = _rand_inputs(cfg, rng, 1)
        probs, cls_id, score = eng.submit(inp[0], cimg[0]).result(timeout=120)
        assert probs is None and 0 <= cls_id < len(CLASSNAMES)
        assert score.shape == (len(CLASSNAMES),)

        img = Image.fromarray(inp[0])
        with pytest.raises(RuntimeError, match="return_mask"):
            eng.predict_pil(img, timeout=120, want_mask=True)
        assert eng.predict_pil(img, timeout=120, want_mask=False)["class"] in CLASSNAMES
    finally:
        eng.close()


def test_bench_engine_unstaged_masked(pair):
    """bench_engine without staging: every batch takes the host path."""
    eng = _make_engine(pair, max_delay_ms=5.0)
    try:
        eng.warmup()
        rep = bench_engine(eng, n_images=6, stage_inputs=False, pool=2)
        assert rep["images_per_sec"] > 0 and rep["staged"] is False
        assert rep["return_mask"] is True
        assert eng.stats()["requests"] == 6
    finally:
        eng.close()


def test_serve_cli_builds_on_the_cpu_and_refuses_a_missing_card(monkeypatch):
    """The CLI's engine on the CPU (tiny, fp32) answers a request; with
    --device cuda and no card it raises before building anything."""
    args = serve_cli.parse_args(["--tiny", "--device", "cpu", "--dtype", "float32",
                                 "--buckets", "1,2", "--classnames", "cat,owl"])
    eng = serve_cli.build_engine(args)
    try:
        assert eng.serve_cfg.buckets == (1, 2) and eng.serve_cfg.mask_dtype == "uint8"
        img = Image.fromarray(np.zeros((20, 30, 3), np.uint8))
        assert eng.predict_pil(img, timeout=120)["class"] in ("cat", "owl")
    finally:
        eng.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.build_engine(serve_cli.parse_args(["--tiny"]))


def test_serve_cli_checkpoint_flags_assemble_as_jax_cli(tmp_path, monkeypatch):
    """The CLI with the reference's four files builds the engine's model and
    class bank that JAX's serve CLI assembles from the same flags, bit for
    bit (both run up to the engine; JAX's init is the port's seeded random
    weights, `tests/_torch_ckpt_files.py`)."""
    from _torch_ckpt_files import (
        Stop,
        assert_bank_equal,
        assert_state_equal,
        jax_state_dict,
        run_jax_cli,
        write_reference_files,
    )

    from camouflaged_vlm_tpu.cli import serve as j_serve_cli

    classes = ["cat", "owl", "bat"]
    files = write_reference_files(tmp_path, classes)
    flags = ["--tiny", "--dtype", "float32", "--classnames", ",".join(classes),
             "--sam-ckpt", files["sam.pth"], "--clip-ckpt", files["clip_renamed.pt"],
             "--maple-ckpt", files["maple_bare.pth.tar"], "--text-bank", files["bank.pth"]]
    _, _, params, jbank = run_jax_cli(j_serve_cli, flags, monkeypatch)["assembled"]
    seen = {}

    def stop(model, cfg, bank, classnames, serve_cfg):
        seen.update(model=model, bank=bank, classnames=classnames)
        raise Stop

    monkeypatch.setattr(serve_cli, "InferenceEngine", stop)
    with pytest.raises(Stop):
        serve_cli.build_engine(serve_cli.parse_args(flags + ["--device", "cpu"]))
    assert seen["classnames"] == classes
    assert_state_equal(seen["model"].state_dict(), jax_state_dict(params))
    assert_bank_equal(seen["bank"], jbank)
