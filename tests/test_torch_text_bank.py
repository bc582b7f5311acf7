"""The port's text-bank precompute against the JAX package's, on the CPU.

The template sets are a copy (held equal). On a tiny random CLIP, written
as an OpenAI-layout TorchScript archive in fp16 and read by each package's
own loader and converter, the per-template bank, the CuPL-JSON bank and the
ensembling chain match JAX's within 1e-5 relative (both fp32; the plain
text towers differ in fp32 summation order only), as do both CLIs' `.npy`
banks with `AlphaClipConfig.vit_l_14_336` monkeypatched to the tiny
configuration in both packages. The port encodes each class's prompts as
they are, JAX pads their count to a power of two: the bank is the same
either way.
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ckpt_files import TOKEN_SEED, tiny_shapes  # noqa: E402

from camouflaged_vlm_tpu.cli import precompute_text_bank as j_bank  # noqa: E402
from camouflaged_vlm_tpu.data.templates import TEMPLATE_SETS as J_TEMPLATE_SETS  # noqa: E402
from camouflaged_vlm_tpu.io import load_openai_clip_state_dict as j_load_clip  # noqa: E402
from camouflaged_vlm_tpu.io.convert import convert_openai_clip as j_convert_clip  # noqa: E402
from camouflaged_vlm_tpu.models.clip import AlphaClipConfig as JClipConfig  # noqa: E402

from camouflaged_vlm_tpu_torch.cli import precompute_text_bank as bank_cli  # noqa: E402
from camouflaged_vlm_tpu_torch.data.templates import TEMPLATE_SETS  # noqa: E402
from camouflaged_vlm_tpu_torch.io import synthetic  # noqa: E402
from camouflaged_vlm_tpu_torch.io.convert import CLIP_TEXT, convert_openai_clip  # noqa: E402
from camouflaged_vlm_tpu_torch.io.torch_loader import load_openai_clip_state_dict  # noqa: E402
from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig  # noqa: E402

NAMES = ["cat", "sea_horse", "owl"]
RTOL = 1e-5


def close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A tiny OpenAI-layout archive (fp16) with seeded random weights."""
    clip = AlphaClipConfig.tiny()
    src = synthetic.random_state_dict(tiny_shapes(), 11, std=0.1)
    rng = np.random.default_rng(TOKEN_SEED)
    tok = torch.from_numpy(rng.standard_normal(
        (clip.vocab_size, clip.transformer_width), dtype=np.float32) * np.float32(0.1))
    path = str(tmp_path_factory.mktemp("clip") / "clip.pt")
    synthetic.save_torchscript(synthetic.openai_clip_file_state_dict(src, clip, tok), path)
    return path


@pytest.fixture(scope="module")
def encoders(archive):
    """(JAX's encode_prompts, its text params and token embedding, the
    port's encode_prompts), each from its own package's reading of the
    archive."""
    jcfg = JClipConfig.tiny()
    tree, jtok, _ = j_convert_clip(j_load_clip(archive), jcfg)
    jtext = tree["clip_model"]["text_encoder"]
    cfg = AlphaClipConfig.tiny()
    entries, tok, _ = convert_openai_clip(load_openai_clip_state_dict(archive), cfg)
    np.testing.assert_array_equal(tok, jtok)
    text = {k[len(CLIP_TEXT):]: v for k, v in entries.items() if k.startswith(CLIP_TEXT)}
    enc = bank_cli.make_encoder(bank_cli.build_text_tower(cfg, text, "cpu"), tok)
    return j_bank._make_encoder(jcfg, jtext, jtok), (jcfg, jtext, jtok), enc


def test_template_sets_are_jax_s():
    assert TEMPLATE_SETS == J_TEMPLATE_SETS
    assert {k: len(v) for k, v in TEMPLATE_SETS.items()} == {
        "camoprompts": 6, "imagenet80": 80, "attributes": 47}


@pytest.mark.parametrize("mode", ["camoprompts", "imagenet80"])
def test_encode_text_features_matches_jax(encoders, mode):
    jenc, (jcfg, jtext, jtok), enc = encoders
    want = j_bank.encode_text_features(jcfg, jtext, jtok, NAMES, TEMPLATE_SETS[mode],
                                       encode_prompts=jenc)
    got = bank_cli.encode_text_features(enc, NAMES, TEMPLATE_SETS[mode])
    close(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)


def test_gpt_bank_and_ensemble_match_jax(encoders, tmp_path):
    """A CuPL JSON (keys matched lowercase, underscores as spaces; lists of
    3 and 5 prompts), its bank and the pairwise chain after camoprompts; a
    class missing from the JSON raises before any encoding, in both."""
    jenc, (jcfg, jtext, jtok), enc = encoders
    gpt = {"Cat": [f"a cat {i}." for i in range(3)],
           "sea horse": [f"a sea horse, {i}." for i in range(5)],
           "owl": [f"an owl number {i}." for i in range(3)]}
    path = tmp_path / "cupl.json"
    path.write_text(json.dumps(gpt))
    want = j_bank.encode_gpt_bank(jcfg, jtext, jtok, NAMES, str(path), encode_prompts=jenc)
    got = bank_cli.encode_gpt_bank(enc, NAMES, str(path))
    close(got, want)
    camo = bank_cli.encode_text_features(enc, NAMES, TEMPLATE_SETS["camoprompts"])
    close(bank_cli.combine_banks([camo, got]), j_bank.combine_banks([camo, want]))
    with pytest.raises(KeyError, match="lacks prompts for 1 classes"):
        bank_cli.encode_gpt_bank(enc, NAMES + ["moth"], str(path))
    with pytest.raises(KeyError, match="lacks prompts for 1 classes"):
        j_bank.encode_gpt_bank(jcfg, jtext, jtok, NAMES + ["moth"], str(path),
                               encode_prompts=jenc)


def test_bank_is_the_same_with_the_power_of_two_padding(encoders):
    """JAX's padded prompt count (camoprompts: 6 -> 8 prompts) against the
    port's 6: the rows are independent."""
    _, _, enc = encoders

    def padded(prompts):
        n = len(prompts)
        return enc(list(prompts) + [prompts[0]] * ((1 << (n - 1).bit_length()) - n))[:n]

    np.testing.assert_allclose(
        bank_cli.encode_text_features(padded, NAMES, TEMPLATE_SETS["camoprompts"]),
        bank_cli.encode_text_features(enc, NAMES, TEMPLATE_SETS["camoprompts"]), rtol=1e-6,
        atol=1e-7)


def test_cli_matches_jax_cli(archive, tmp_path, monkeypatch):
    """Both main()s on the tiny archive (`vit_l_14_336` -> tiny in both
    packages), camoprompts and imagenet80 ensembled in the reference's order
    whatever order the flag gives; the port on the CPU."""
    monkeypatch.setattr(JClipConfig, "vit_l_14_336", classmethod(lambda cls: cls.tiny()))
    monkeypatch.setattr(AlphaClipConfig, "vit_l_14_336", classmethod(lambda cls: cls.tiny()))
    jout, out = tmp_path / "jax.npy", tmp_path / "port.npy"
    flags = ["--clip-ckpt", archive, "--templates", "camoprompts,imagenet80",
             "--classnames", ",".join(NAMES)]
    monkeypatch.setattr(sys, "argv", ["precompute_text_bank", *flags, "--out", str(jout)])
    j_bank.main()
    got = bank_cli.main([*flags, "--out", str(out), "--device", "cpu"])
    close(np.load(out), np.load(jout))
    np.testing.assert_array_equal(np.load(out), got)
    assert got.shape == (len(NAMES), AlphaClipConfig.tiny().embed_dim)
    with pytest.raises(SystemExit):
        bank_cli.main(["--clip-ckpt", archive, "--templates", "camo", "--out", str(out)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bank_cli.main([*flags, "--out", str(out)])
