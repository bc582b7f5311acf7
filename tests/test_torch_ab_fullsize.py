"""`ab_fullsize_torch.py`'s A/B of the port against the JAX package, at small
widths, on the CPU.

The script's own legs run in this process through the same code as its
full-size run (`--small`: SAM 128 wide with 8 heads, or 64 with 4, a
windowed and a global block, every windowed grid with edge windows; CLIP 128
wide; CLIP and the decoder's two-way transformer 2 layers deep in route 1's
inference and the MaPLe leg, 1 elsewhere; the 61 test classes): the six
routes' taps, one cascade train step, one MaPLe step and the text bank, each
held to the script's bounds (every tap 1e-4 mean relative, the probabilities
5e-3 max abs, the class logits 1e-3 of their range and the same class; the
loss 1e-5 and the gradients 1e-3 relative L2, under 1e-5 of the largest leaf
1e-8 of it absolute; MaPLe's loss 1e-5 and prompt gradients 1e-4; the bank
1e-4). The JAX sides run on three threads, started together, so that XLA
compiles one leg while Python traces another. Then the weight draw (two
draws bit-equal, a subset equal to the whole, strict loads into both
packages), the comparisons' own refusals, and the committed JAX golden that
`chip_smoke.py`'s [jax_golden] holds the card to, with the fingerprint of
what it was drawn from.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _ab_fullsize_jax as abj  # noqa: E402
import ab_fullsize_torch as ab  # noqa: E402

SMALL_TAPS = {"patch_embed", "prompt_features", "block_0", "block_1", "neck", "text_features",
              "clip1_image_feat", "sparse", "mask_lowres", "probs", "alpha", "clip2_image_feat",
              "class_logits"}


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ab_fullsize"))


@pytest.fixture(scope="module")
def jax_sides(out_dir):
    """{(leg, route): future of the JAX side}, every leg of the small run."""
    pairs = ab._legs(ab.LEGS, list(ab.ROUTES))
    with abj.pallas_interpret(), ThreadPoolExecutor(3) as pool:
        futures = {(leg, route): pool.submit(ab.run_side, abj.JAX_LEGS[leg], leg, route, True,
                                             out_dir) for leg, route in pairs}
        yield futures
        for f in futures.values():
            f.cancel()


@pytest.fixture(scope="module")
def sides(jax_sides, out_dir):
    """(leg, route) -> (JAX side, port side), each run once."""
    done = {}

    def get(leg, route):
        if (leg, route) not in done:
            torch_side = ab.run_side(ab.TORCH_LEGS[leg], leg, route, True, out_dir)
            done[leg, route] = jax_sides[leg, route].result(), torch_side
        return done[leg, route]

    return get


@pytest.mark.parametrize("route", list(ab.ROUTES))
def test_infer_route_matches_jax(route, sides):
    """Each route's taps within the bounds; the mask covers 5-95% of every
    image; JAX's rel cache refuses window 17 (its make_rcomb assert) and the
    route runs without it."""
    report = ab.compare_infer(route, *sides("infer", route))
    assert report["pass"], report["fails"]
    assert set(report["taps"]) == SMALL_TAPS
    assert len(report["pred"]["jax"]) == ab.ROUTES[route]["batch"]
    meta = report["jax_meta"]
    assert meta["unused"] == meta["unfilled"] == 0
    assert meta["jax_rel_cache"] == (route != "vit_h_flash_win17")
    if route == "vit_h_flash_win17":
        assert "make_rcomb" in meta["jax_rel_cache_error"]
    # the self-gap is the size of fp32 rounding, below the bound
    assert max(r["self_mean_rel"] for r in report["taps"].values() if "self_mean_rel" in r) < 1e-5


def test_train_step_matches_jax(sides):
    """The loss and every trainable gradient; the leaves under the floor are
    the decoder's q/k projections and the unused hypernetworks 1-3, whose
    gradient is exactly zero on both sides."""
    report = ab.compare_train("vit_h_flash", *sides("train", ab.ROUTE_1))
    assert report["pass"], report["fails"]
    assert report["grads"]["n"] > 100 and not report["jax_meta"]["remat"]  # full size only
    # the IoU head and hypernetworks 1-3: three layers, a weight and a bias each
    assert report["grads"]["under_floor"]["exact_zero"] == 4 * 3 * 2


def test_maple_step_and_text_bank_match_jax(sides):
    report = ab.compare_maple("vit_h_flash", *sides("maple", ab.ROUTE_1))
    assert report["pass"], report["fails"]
    assert report["bank"]["shape"] == [61, ab.SMALL_CLIP["embed_dim"]]
    # ctx and its projection, and a prompt and projection for each deeper layer
    assert report["grads"]["n"] == 3 + 3 * (ab.SMALL_CLIP["prompt_depth"] - 1)


def test_weight_draw_is_seeded_and_loads_strictly_into_both(out_dir):
    """Two draws are bit-equal and a subset draws the same values; the draw
    loads with strict=True into the port and through JAX's converter with
    no missing, unused or unfilled key; a stray or a missing key raises."""
    import jax

    cfg = ab.port_config("vit_h_flash", True, out_dir)
    shapes = ab.port_shapes(cfg)
    a, b = ab.draw_weights(shapes), ab.draw_weights(shapes)
    assert set(a) == set(shapes) and all(np.array_equal(a[k], b[k]) for k in a)
    sub = ab.draw_weights(shapes, keys=[k for k in shapes if k.startswith("clip_model.")])
    assert sub and all(np.array_equal(sub[k], a[k]) for k in sub)
    assert not np.array_equal(a["image_encoder.blocks.0.attn.qkv.weight"],
                              ab.draw_weights(shapes, seed=ab.WEIGHT_SEED + 1)[
                                  "image_encoder.blocks.0.attn.qkv.weight"])
    model = ab.load_port_cascade(cfg, a, rel_cache=False)
    for k, v in model.state_dict().items():
        assert np.array_equal(v.numpy(), a[k]), k

    jcfg = abj.jax_config("vit_h_flash", True, out_dir)
    jmodel = abj.OVCOSCascade(jcfg)
    bank = abj.make_bank_inputs(jcfg, ["cat", "owl"], seed=ab.BANK_SEED)
    inputs = ab.make_inputs(jcfg.inp_size, jcfg.clip_size, 1)
    jshapes = jax.eval_shape(lambda k: jmodel.init(k, *inputs, *(bank[n] for n in abj.BANK_KEYS),
                                                   method=jmodel.infer_cascade),
                             jax.random.PRNGKey(0))["params"]
    _, meta = abj.load_params(jcfg, jshapes, a)
    assert meta == {"keys": len(a), "missing": 0, "unused": 0, "unfilled": 0}
    with pytest.raises(KeyError, match="unused"):
        abj.load_params(jcfg, jshapes, {**a, "image_encoder.stray": a["pe_layer.positional_"
                                                                       "encoding_gaussian_matrix"]})
    with pytest.raises(KeyError, match="missing"):
        abj.load_params(jcfg, jshapes, {k: v for k, v in a.items() if "neck" not in k})


def test_compare_refuses_a_departure(sides):
    """The comparisons are not vacuous. Inference: one tap off by 2e-4, a
    flipped class and a flat mask each fail. Train step and MaPLe: the loss
    moved by 2e-5, one gradient scaled by 1 + 2e-3 and one zeroed each fail,
    the train step's on its smallest leaf above the floor."""
    j, t = sides("infer", "vit_h_flash")
    moved = dict(t, block_1=t["block_1"] * np.float32(1 + 2e-4))
    assert any(f.startswith("block_1") for f in ab.compare_infer("r", j, moved)["fails"])
    flipped = dict(t, pred=(t["pred"] + 1) % 61)
    assert any("class" in f for f in ab.compare_infer("r", j, flipped)["fails"])
    flat = dict(j, probs=np.full_like(j["probs"], 0.25))
    assert any("coverage" in f for f in ab.compare_infer("r", flat, t)["fails"])

    for leg, compare in (("train", ab.compare_train), ("maple", ab.compare_maple)):
        j, t = sides(leg, ab.ROUTE_1)
        grads = ab._grads(j)
        _, _, under = ab.grad_gaps(grads, grads)
        leaf = min((k for k in grads if k not in under), key=lambda k: np.linalg.norm(grads[k]))
        assert compare("r", j, t)["pass"]
        for bad in (dict(t, loss=t["loss"] * (1 + 2e-5)),
                    dict(t, **{f"grad/{leaf}": t[f"grad/{leaf}"] * np.float32(1 + 2e-3)}),
                    dict(t, **{f"grad/{leaf}": np.zeros_like(t[f"grad/{leaf}"])})):
            assert not compare("r", j, bad)["pass"], (leg, leaf)


def test_golden_reads_back_at_its_shapes(out_dir):
    """The committed JAX golden (route 1, batch 1, full size) holds what
    [jax_golden] reads, at the shapes its meta records, under 2 MB, from the
    script's seeds and from what this code draws (its fingerprint of the
    weights, image, bank and configuration); the class is the argmax of its
    logits."""
    entries, meta = ab.read_golden()
    digest = ab.draw_digest(out_dir=out_dir)
    ab.check_golden_digest(meta, digest)
    moved = dict(digest, weights=dict(digest["weights"], **{
        ab.DIGEST_KEYS[1]: [v * (1 + 1e-6) for v in digest["weights"][ab.DIGEST_KEYS[1]]]}))
    for stale in (moved, dict(digest, config_sha256="0")):
        with pytest.raises(ValueError, match="--write-golden"):
            ab.check_golden_digest(meta, stale)
    assert os.path.getsize(ab.GOLDEN) <= 2 * 2 ** 20
    assert {k: list(v.shape) for k, v in entries.items()} == meta["shapes"] == {
        "class_logits": [61], "pred": [1], "mask_lowres": [256, 256],
        "embedding_slice": [8, 64, 64], "embedding_mean": [], "embedding_norm": []}
    assert (meta["weight_seed"], meta["image_seed"], meta["bank_seed"], meta["hyper_scale"]) == (
        ab.WEIGHT_SEED, ab.IMAGE_SEED, ab.BANK_SEED, ab.HYPER_SCALE)
    assert int(entries["pred"][0]) == int(np.argmax(entries["class_logits"]))
    assert all(np.isfinite(v).all() for v in entries.values())
    gaps = ab.golden_gaps(entries, entries)
    assert gaps["class_logits"]["max_abs"] == 0.0 and gaps["pred"][0] == gaps["pred"][1]
