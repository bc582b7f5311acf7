"""The port's native host preprocessing (`data/native.py`, `csrc/preproc`).

The port builds its own copy of the C library from
`camouflaged_vlm_tpu_torch/csrc/preproc` into `build/native/` and must be
byte-equal, op by op and sample by sample, to the port's PIL path and to the
JAX package's transforms and loader on the same inputs: decode (JPEG, PNG,
palette, RGBA, grey), the three resample filters, luma, rot90, flip,
normalise; each of the three iterators' samples, the rot90 fix-up and the
16-bit-PNG fallback (counted); `predict_bytes` native against PIL. Skips
only where no `g++` is found; a failed build fails.
"""

import io
import shutil

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

if shutil.which("g++") is None:  # pragma: no cover
    pytest.skip("no g++ to build the native preprocessing", allow_module_level=True)

from camouflaged_vlm_tpu.data import loader as JL  # noqa: E402
from camouflaged_vlm_tpu.data import transforms as JT  # noqa: E402

from camouflaged_vlm_tpu_torch.data import loader as L  # noqa: E402
from camouflaged_vlm_tpu_torch.data import native as nat  # noqa: E402
from camouflaged_vlm_tpu_torch.data import native_pipeline as npp  # noqa: E402
from camouflaged_vlm_tpu_torch.data import transforms as T  # noqa: E402
from camouflaged_vlm_tpu_torch.data.ovcamo import OVCamoIndex, OVCamoSample  # noqa: E402

RNG = np.random.default_rng(7)


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("CVLM_NATIVE_PREPROC", raising=False)


def _png(arr, **kw):
    im = Image.fromarray(arr) if isinstance(arr, np.ndarray) else arr
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def _jpg(arr, quality=85):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _pil(data, mode):
    return np.asarray(Image.open(io.BytesIO(data)).convert(mode))


# ---------------------------------------------------------------- the build


def test_library_builds_from_the_port_sources_into_build_native():
    """Both parts build into build/native/ from the port's sources; this host
    has the decoder's libraries, so the status names decode too."""
    for part in ("core", "decoder"):
        path = nat.build(part)
        assert path.parent == nat.BUILD_DIR and path.name.startswith(f"libcvtpre_{part}_")
    assert nat.BUILD_DIR.parts[-2:] == ("build", "native")
    assert nat.SRC_DIR.parts[-3:] == ("camouflaged_vlm_tpu_torch", "csrc", "preproc")
    sources = {f for part in nat.PARTS.values() for f in part[0]}
    assert sources == {"decode.cc", "resample.cc", "pixops.cc"}
    assert {p.name for p in nat.SRC_DIR.glob("*")} == {"cvtpre.h", *sources}
    assert nat._probe() == "" and nat.decoder() is not None
    assert nat.status().startswith("native (libcvtpre: decode + resample + pixops; ")


def test_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    monkeypatch.setattr(nat, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nat, "CXXFLAGS", nat.CXXFLAGS + ("-DCVT_BROKEN", "-include",
                                                         "no_such_header_cvt.h"))
    for part in ("core", "decoder"):
        with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*no_such_header_cvt.h"):
            nat.build(part)


def test_a_host_without_the_decoders_libraries(monkeypatch, tmp_path):
    """Where the probe finds no libjpeg / libpng / zlib to build and load
    the decoder with, PIL decodes (the same bytes), the core part still
    resamples natively, and the status says so and why; where it finds
    them, a decoder that does not build raises."""
    monkeypatch.setattr(nat, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nat, "_parts", {})
    monkeypatch.setattr(nat, "decoder_missing", "")
    monkeypatch.setattr(nat, "_PROBE_SOURCE", "#include <no_such_jpeglib_cvt.h>\n")
    assert "no_such_jpeglib_cvt.h" in nat._probe()
    assert nat.decoder() is None and "no_such_jpeglib_cvt.h" in nat.decoder_missing
    line = nat.status()
    assert line.startswith("native (libcvtpre: resample + pixops; decode through PIL: this "
                           "host lacks the decoder's libjpeg / libpng / zlib (") and \
        "no_such_jpeglib_cvt.h" in line
    arr = RNG.integers(0, 256, (21, 34, 3), np.uint8)
    for data in (_png(arr), _jpg(arr)):
        for ch, mode in ((3, "RGB"), (1, "L")):
            got = nat.decode(data, ch)
            assert np.array_equal(got if ch == 3 else got[:, :, 0], _pil(data, mode))
    assert np.array_equal(nat.resize(arr, (50, 40), nat.BICUBIC),
                          np.asarray(Image.fromarray(arr).resize((50, 40), Image.BICUBIC)))
    assert not list(tmp_path.glob("libcvtpre_decoder_*"))
    monkeypatch.setattr(nat, "_parts", {})
    monkeypatch.setattr(nat, "_PROBE_SOURCE", "extern \"C\" int cvt_probe() { return 0; }\n")
    monkeypatch.setitem(nat.PARTS, "decoder", (("decode.cc", "no_such_source_cvt.cc"),
                                               nat.PARTS["decoder"][1]))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*no_such_source_cvt.cc"):
        nat.decoder()


def test_the_probe_runs_only_where_no_decoder_loads(monkeypatch, tmp_path):
    """A decoder built for these sources that loads is used as it is, with
    no probe; one that does not load (built on a host with other libraries,
    its build directory copied here) is probed for and rebuilt; so is a
    core part that does not load."""
    monkeypatch.setattr(nat, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nat, "_parts", {})
    path = nat.build("decoder")
    monkeypatch.setattr(nat, "_probe", lambda: pytest.fail("probed with a decoder that loads"))
    assert nat.decoder() is not None and nat.decoder()._name == str(path)
    monkeypatch.setattr(nat, "BUILD_DIR", tmp_path / "copied")
    monkeypatch.setattr(nat, "_parts", {})
    path = nat.library_path("decoder")
    path.parent.mkdir()
    path.write_bytes(b"not a shared object")
    probes = []
    monkeypatch.setattr(nat, "_probe", lambda: probes.append(1) or "")
    lib = nat.decoder()
    assert probes == [1] and lib is not None and lib._name == str(path)
    arr = RNG.integers(0, 256, (9, 13, 3), np.uint8)
    assert np.array_equal(nat.decode(_png(arr), 3), arr)
    path = nat.library_path("core")
    path.write_bytes(b"not a shared object")
    assert nat.library()._name == str(path)
    assert np.array_equal(nat.fliplr(arr), arr[:, ::-1])


def test_switch_chooses_pil_and_nothing_else(monkeypatch):
    for off in ("0", "false", "OFF"):
        monkeypatch.setenv("CVLM_NATIVE_PREPROC", off)
        assert not nat.enabled()
        assert nat.status() == f"PIL (CVLM_NATIVE_PREPROC={off})"
    for on in ("1", "yes"):
        monkeypatch.setenv("CVLM_NATIVE_PREPROC", on)
        assert nat.enabled() and npp.available()


# ---------------------------------------------------------------- decode


@pytest.mark.parametrize("kind", ["png_rgb", "png_gray", "png_palette", "png_rgba", "jpeg_rgb",
                                  "jpeg_gray"])
def test_decode_equals_pil_and_jax(kind):
    if kind == "png_rgb":
        data = _png(RNG.integers(0, 256, (37, 53, 3), np.uint8))
    elif kind == "png_gray":
        data = _png(RNG.integers(0, 256, (20, 31), np.uint8))
    elif kind == "png_palette":
        data = _png(Image.fromarray(RNG.integers(0, 256, (16, 17, 3), np.uint8)).convert(
            "P", palette=Image.ADAPTIVE))
    elif kind == "png_rgba":
        data = _png(Image.fromarray(RNG.integers(0, 256, (12, 19, 4), np.uint8), "RGBA"))
    elif kind == "jpeg_rgb":
        data = _jpg(RNG.integers(0, 256, (48, 64, 3), np.uint8))
    else:
        buf = io.BytesIO()
        Image.fromarray(RNG.integers(0, 256, (33, 27), np.uint8), "L").save(buf, "JPEG",
                                                                           quality=92)
        data = buf.getvalue()
    for ch, mode in ((3, "RGB"), (1, "L")):
        got = nat.decode(data, ch)
        assert got.dtype == np.uint8 and got.shape[2] == ch
        assert np.array_equal(got if ch == 3 else got[:, :, 0], _pil(data, mode)), (kind, mode)


def test_decode_16bit_png_is_unsupported_and_corrupt_data_raises():
    im = Image.fromarray(RNG.integers(0, 65536, (8, 9), np.int32), mode="I")
    assert nat.decode(_png(im), 1) is None and nat.decode(_png(im), 3) is None
    with pytest.raises(ValueError, match="cvt_decode"):
        nat.decode(_png(RNG.integers(0, 256, (8, 9, 3), np.uint8))[:60], 3)


# ---------------------------------------------------------------- resample


@pytest.mark.parametrize("filt,pil", [(nat.NEAREST, Image.NEAREST),
                                      (nat.BILINEAR, Image.BILINEAR),
                                      (nat.BICUBIC, Image.BICUBIC)])
def test_resize_equals_pil(filt, pil):
    rng = np.random.default_rng(filt)
    for _ in range(12):
        sw, sh = int(rng.integers(3, 500)), int(rng.integers(3, 500))
        dw, dh = int(rng.integers(3, 700)), int(rng.integers(3, 700))
        ch = int(rng.choice([1, 3]))
        src = rng.integers(0, 256, (sh, sw, ch), np.uint8)
        ref = np.asarray(Image.fromarray(src[:, :, 0] if ch == 1 else src).resize((dw, dh), pil))
        got = nat.resize(src, (dw, dh), filt)
        assert np.array_equal(got[:, :, 0] if ch == 1 else got, ref), (filt, sw, sh, dw, dh)
        assert np.array_equal(nat.resize(src[:, :, 0], (dw, dh), filt), ref if ch == 1
                              else np.asarray(Image.fromarray(src[:, :, 0]).resize((dw, dh), pil)))


@pytest.mark.parametrize("sw,sh", [(640, 480), (480, 640), (700, 500)])
def test_resize_at_the_pipelines_shapes(sw, sh):
    src = RNG.integers(0, 256, (sh, sw, 3), np.uint8)
    pim = Image.fromarray(src)
    short = (336, int(sh * 336 / sw)) if sw <= sh else (int(sw * 336 / sh), 336)
    for size, nf, pf in (((1024, 1024), nat.BILINEAR, Image.BILINEAR),
                         ((1024, 1024), nat.NEAREST, Image.NEAREST),
                         ((1280, 1280), nat.BILINEAR, Image.BILINEAR),
                         (short, nat.BICUBIC, Image.BICUBIC)):
        assert np.array_equal(nat.resize(src, size, nf), np.asarray(pim.resize(size, pf)))


# ---------------------------------------------------------------- pixel ops


def test_luma_rot90_flip_normalise_equal_pil_and_jax():
    arr = RNG.integers(0, 256, (41, 29, 3), np.uint8)
    im = Image.fromarray(arr)
    assert np.array_equal(nat.rgb2l(arr), np.asarray(im.convert("L")))
    assert np.array_equal(nat.rot90ccw(arr), np.rot90(arr))
    rot = T.maybe_rot90_to_match(im, Image.fromarray(arr[:29, :, 0].T.copy()))
    assert np.array_equal(nat.rot90ccw(arr), np.asarray(rot))
    assert np.array_equal(nat.fliplr(arr), np.asarray(im.transpose(Image.FLIP_LEFT_RIGHT)))
    ref = (arr.astype(np.float32) / 255.0 - T.IMAGENET_MEAN) / T.IMAGENET_STD
    assert np.array_equal(nat.normalize(arr, T.IMAGENET_MEAN, T.IMAGENET_STD), ref)
    assert np.array_equal(ref, (np.asarray(im, np.float32) / 255.0 - JT.IMAGENET_MEAN)
                          / JT.IMAGENET_STD)


def _rand_img_mask(w, h, mw=None, mh=None, rng=RNG):
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    mask = ((rng.random((mh or h, mw or w)) > 0.5) * 255).astype(np.uint8)
    return img, mask


def test_transforms_on_arrays_equal_pil_and_jax():
    img, mask = _rand_img_mask(123, 87)
    pimg, pmask = Image.fromarray(img), Image.fromarray(mask, "L")
    for name, args, pargs in (
        ("sam_image_transform", (img, 64), (pimg, 64)),
        ("sam_image_resized_u8", (img, 64), (pimg, 64)),
        ("mask_to_target", (mask[:, :, None], 64), (pmask, 64)),
        ("clip_image_transform", (img, 56), (pimg, 56)),
        ("clip_image_resized_u8", (img, 56), (pimg, 56)),
        ("clip_alpha_transform", (mask[:, :, None], 56), (pmask, 56)),
    ):
        got = getattr(npp, name)(*args)
        assert np.array_equal(got, getattr(T, name)(*pargs)), name
        assert np.array_equal(got, getattr(JT, name)(*pargs)), name


# ---------------------------------------------------------------- samples


def _write_sample(tmp_path, img, mask, i=0, img_fmt="JPEG", cls=("cat", 3)):
    ip = str(tmp_path / f"img{i}.{'jpg' if img_fmt == 'JPEG' else 'png'}")
    mp = str(tmp_path / f"mask{i}.png")
    Image.fromarray(img).save(ip, img_fmt)
    Image.fromarray(mask, "L").save(mp, "PNG")
    return OVCamoSample(class_label=cls[0], class_id=cls[1], image_path=ip, mask_path=mp)


def _jax_sample(s):
    from camouflaged_vlm_tpu.data.ovcamo import OVCamoSample as JSample

    return JSample(class_label=s.class_label, class_id=s.class_id, image_path=s.image_path,
                   mask_path=s.mask_path)


def _same_eval_sample(a, b):
    for f in ("inp", "gt", "clip_image"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.clip_mask is None) == (b.clip_mask is None)
    if a.clip_mask is not None:
        assert np.array_equal(a.clip_mask, b.clip_mask)
    assert tuple(a.orig_size) == tuple(b.orig_size)


@pytest.mark.parametrize("case", ["jpeg", "png", "rot90", "png16"])
def test_eval_sample_equals_pil_and_jax(tmp_path, case):
    L.reset_pil_fallbacks()
    if case == "png16":  # the decoder refuses it: PIL, counted
        ip, mp = str(tmp_path / "img16.png"), str(tmp_path / "mask16.png")
        Image.fromarray(RNG.integers(0, 65535, (40, 50), np.int32), mode="I").save(ip)
        Image.fromarray(((RNG.random((40, 50)) > 0.5) * 255).astype(np.uint8), "L").save(mp)
        s = OVCamoSample(class_label="c", class_id=0, image_path=ip, mask_path=mp)
    elif case == "rot90":  # image and mask sizes differ: the rot90 fix-up
        s = _write_sample(tmp_path, _rand_img_mask(100, 130)[0], _rand_img_mask(130, 100)[1])
    else:
        s = _write_sample(tmp_path, *_rand_img_mask(130, 100),
                          img_fmt="JPEG" if case == "jpeg" else "PNG")
    for raw in (False, True):
        a = L._load_eval_sample(s, 64, 56, raw_uint8=raw, use_native=True)
        _same_eval_sample(a, L._load_eval_sample(s, 64, 56, raw_uint8=raw, use_native=False))
        _same_eval_sample(a, JL._load_eval_sample(_jax_sample(s), 64, 56, raw_uint8=raw,
                                                  use_native=False))
    assert L.pil_fallbacks() == (2 if case == "png16" else 0)


def _index(tmp_path, n=4, rot_last=True):
    samples = [_write_sample(tmp_path, *_rand_img_mask(90 + 7 * i, 70 + 5 * i), i=i,
                             img_fmt="JPEG" if i % 2 else "PNG", cls=(f"c{i % 2}", i % 2))
               for i in range(n)]
    if rot_last:  # one sample through the rot90 fix-up
        samples[-1] = _write_sample(tmp_path, _rand_img_mask(60, 80)[0],
                                    _rand_img_mask(80, 60)[1], i=n, cls=("c1", 1))
    return samples


def _batches(fn, native, monkeypatch, *args, **kw):
    monkeypatch.setenv("CVLM_NATIVE_PREPROC", "1" if native else "0")
    return list(fn(*args, **kw))


@pytest.mark.parametrize("which", ["eval", "train", "maple"])
def test_iterators_equal_pil_and_jax(tmp_path, monkeypatch, which):
    from camouflaged_vlm_tpu.data.ovcamo import OVCamoIndex as JIndex

    samples = _index(tmp_path)
    index = OVCamoIndex(split="train", classes=["c0", "c1"], samples=samples)
    jindex = JIndex(split="train", classes=["c0", "c1"], samples=[_jax_sample(s) for s in samples])
    if which == "eval":
        runs = [_batches(mod.iter_eval_batches, nat_on, monkeypatch, idx, 2, 64, 56,
                         num_workers=2, raw_uint8=raw)
                for raw in (False, True)
                for mod, idx, nat_on in ((L, index, True), (L, index, False), (JL, jindex, False))]
        for k in range(2):
            a, b, c = runs[3 * k: 3 * k + 3]
            assert len(a) == len(b) == len(c) == 2
            for ba, bb, bc in zip(a, b, c):
                for x, y, z in zip(ba, bb, bc):
                    _same_eval_sample(x, y)
                    _same_eval_sample(x, z)
        return
    fn = "iter_train_batches" if which == "train" else "iter_maple_train_batches"
    kw = dict(inp_size=64, clip_size=56) if which == "train" else dict(clip_size=56)
    # seed 11 draws flips for both orientations over the four samples
    a, b, c = (_batches(getattr(mod, fn), nat_on, monkeypatch, idx, 2,
                        np.random.default_rng(11), num_workers=2, **kw)
               for mod, idx, nat_on in ((L, index, True), (L, index, False), (JL, jindex, False)))
    assert len(a) == len(b) == len(c) == 2
    for ba, bb, bc in zip(a, b, c):
        assert ba.keys() == bb.keys() == bc.keys()
        for k in ba:
            assert ba[k].dtype == bb[k].dtype and np.array_equal(ba[k], bb[k]), k
            assert np.array_equal(ba[k], bc[k]), k


# ---------------------------------------------------------------- the server


@pytest.fixture(scope="module")
def engine():
    from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs
    from camouflaged_vlm_tpu_torch.models import CascadeConfig
    from camouflaged_vlm_tpu_torch.serve import InferenceEngine, ServeConfig

    cfg = CascadeConfig.tiny()
    torch.manual_seed(0)
    model = build_cascade(cfg, "cpu")
    classes = ["cat", "owl", "snow leopard"]
    bank = make_bank_inputs(cfg, classes, seed=0)
    eng = InferenceEngine(model, cfg, bank, classes,
                          ServeConfig(buckets=(1, 2), max_delay_ms=1.0))
    yield eng
    eng.close()


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_predict_bytes_native_equals_pil(engine, monkeypatch, fmt):
    buf = io.BytesIO()
    Image.fromarray(RNG.integers(0, 256, (50, 70, 3), np.uint8)).save(buf, fmt)
    n0 = engine.stats()["pil_fallbacks"]  # the engine is shared by the cases
    a = engine.predict_bytes(buf.getvalue(), timeout=120)
    monkeypatch.setenv("CVLM_NATIVE_PREPROC", "0")
    b = engine.predict_bytes(buf.getvalue(), timeout=120)
    assert a.keys() == b.keys() and a["class_id"] == b["class_id"] and a["score"] == b["score"]
    assert a["mask"].shape == (50, 70) and a["mask"].dtype == np.uint8
    assert np.array_equal(a["mask"], b["mask"])
    assert engine.stats()["pil_fallbacks"] == n0
    monkeypatch.delenv("CVLM_NATIVE_PREPROC")
    im16 = _png(Image.fromarray(RNG.integers(0, 65535, (20, 30), np.int32), mode="I"))
    c = engine.predict_bytes(im16, timeout=120)  # the decoder refuses it: PIL, counted
    d = engine.predict_pil(Image.open(io.BytesIO(im16)), timeout=120)
    assert c["class_id"] == d["class_id"] and np.array_equal(c["mask"], d["mask"])
    assert engine.stats()["pil_fallbacks"] == n0 + 1


# ---------------------------------------------------------------- the CLIs


def test_cli_lines_say_which_path_runs_and_count_fallbacks(monkeypatch, tmp_path):
    """The start-up line every CLI that loads images prints (the path and
    why; it also zeroes the count), and the end line with the samples the
    native path sent through PIL."""
    from camouflaged_vlm_tpu_torch.cli.common import fallback_line, preproc_line

    line = preproc_line("eval")
    assert line.startswith("[eval] host preprocessing: native (libcvtpre")
    assert "CVLM_NATIVE_PREPROC=0 chooses PIL" in line
    ip, mp = str(tmp_path / "i16.png"), str(tmp_path / "m.png")
    Image.fromarray(RNG.integers(0, 65535, (9, 11), np.int32), mode="I").save(ip)
    Image.fromarray(np.zeros((9, 11), np.uint8), "L").save(mp)
    s = OVCamoSample(class_label="c", class_id=0, image_path=ip, mask_path=mp)
    L._load_eval_sample(s, 32, 28, use_native=True)
    assert fallback_line("eval") == ("[eval] host preprocessing: 1 sample(s) through PIL "
                                     "(containers the native decoder does not take)")
    assert preproc_line("eval") and L.pil_fallbacks() == 0
    monkeypatch.setenv("CVLM_NATIVE_PREPROC", "0")
    assert preproc_line("train") == "[train] host preprocessing: PIL (CVLM_NATIVE_PREPROC=0)"
    assert fallback_line("train") == "[train] host preprocessing: every sample through PIL"
