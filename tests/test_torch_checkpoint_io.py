"""The port's checkpoint interop against the JAX package's, on the CPU.

Each of the reference's formats is written here from numpy-seeded tensors
at the tiny config's shapes (`tests/_torch_ckpt_files.py`): the SAM `.pth`
with extra keys to ignore, a cascade `.pth`, OpenAI TorchScript archives in
fp16 (either in-proj naming, no conv1_alpha), dassl `.pth.tar` files
(wrapped and bare), and `.npy` / `.pth` banks. JAX's `assemble_cascade`
(tiny, float32) and the port's build + `cli.common.load_checkpoints` read
the same files from the same starting weights (JAX's init replaced by the
port's seeded random weights); the port's whole state dict must equal
`state_dict_from_jax_params` of JAX's params bit for bit, and so must the
class bank's inputs. In bfloat16 every parameter must be equal too: each
file's value rounded once, as JAX casts after the last merge, and
`no_mask_embed.weight` ((1, D) in the port, (D,) in JAX) kept in fp32 by
both. The decoder's Gaussian PE matrix, a buffer that no file sets and the
port never casts (JAX rounds it: a JAX fault, ROADMAP.md), is not a
parameter and not compared there.
Also pinned: what raises (a MaPLe file with no matching key, a shape
mismatch, a missing path, a model-zoo name or a URL), and the export of a
train checkpoint against JAX's exporter, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_ckpt_files import (  # noqa: E402
    assert_bank_equal,
    assert_state_equal,
    jax_state_dict,
    same_init_in_jax,
    write_reference_files,
)

from camouflaged_vlm_tpu.cli.common import assemble_cascade as j_assemble  # noqa: E402
from camouflaged_vlm_tpu.io.convert import export_cascade_checkpoint as j_export  # noqa: E402
from camouflaged_vlm_tpu.models import CascadeConfig as JCascadeConfig  # noqa: E402

from camouflaged_vlm_tpu_torch.cli import export_checkpoint  # noqa: E402
from camouflaged_vlm_tpu_torch.cli.common import load_checkpoints  # noqa: E402
from camouflaged_vlm_tpu_torch.factory import build_cascade  # noqa: E402
from camouflaged_vlm_tpu_torch.io import synthetic, torch_loader  # noqa: E402
from camouflaged_vlm_tpu_torch.io.checkpoint import save_checkpoint  # noqa: E402
from camouflaged_vlm_tpu_torch.io.convert import load_jax_params  # noqa: E402
from camouflaged_vlm_tpu_torch.models import CascadeConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.train import make_optimizer, trainable_parameters  # noqa: E402

CLASSES = ["cat", "owl", "bat"]
JAX_KW = {"sam": "sam_ckpt", "clip": "clip_ckpt", "maple": "maple_ckpt",
          "cascade": "cascade_ckpt", "bank": "text_bank_path"}
CASES = {
    "sam": {"sam": "sam.pth"},
    "clip": {"clip": "clip.pt"},
    "clip_renamed": {"clip": "clip_renamed.pt"},
    "maple": {"maple": "maple.pth.tar"},
    "maple_bare": {"maple": "maple_bare.pth.tar"},
    "bank_npy": {"bank": "bank.npy"},
    "bank_pth": {"bank": "bank.pth"},
    "all_four": {"clip": "clip.pt", "maple": "maple.pth.tar", "sam": "sam.pth",
                 "bank": "bank.npy"},
    "cascade_last": {"clip": "clip_renamed.pt", "maple": "maple_bare.pth.tar",
                     "sam": "sam.pth", "cascade": "cascade.pth", "bank": "bank.pth"},
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_reference_files(tmp_path_factory.mktemp("ckpt"), CLASSES)


def _both(files, case, monkeypatch, dtype=torch.float32):
    """(JAX's state dict and bank, the port's model and bank) from the same
    files."""
    named = {k: files[v] for k, v in CASES[case].items()}
    same_init_in_jax(monkeypatch)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, _, params, jbank = j_assemble(CLASSES, tiny=True, dtype=jdt, seed=0,
                                     **{JAX_KW[k]: v for k, v in named.items()})
    model = build_cascade(CascadeConfig.tiny(dtype=dtype), "cpu", 0)
    make_bank = load_checkpoints(model, CascadeConfig.tiny(dtype=dtype), seed=0,
                                 **{f"{k}_ckpt": v for k, v in named.items() if k != "bank"})
    bank = make_bank(CLASSES, named.get("bank"))
    return jax_state_dict(params), jbank, model, bank


@pytest.mark.parametrize("case", sorted(CASES))
def test_files_load_as_jax_assembles_them(files, case, monkeypatch):
    """Every format alone, and together in the reference's order: the port's
    whole state dict and bank inputs equal JAX's, bit for bit, and a file
    that was given changed the weights it holds."""
    want, jbank, model, bank = _both(files, case, monkeypatch)
    got = model.state_dict()
    assert_state_equal(got, want)
    assert_bank_equal(bank, jbank)
    fresh = build_cascade(CascadeConfig.tiny(), "cpu", 0).state_dict()
    probe = {"sam": "image_encoder.blocks.0.attn.qkv.weight",
             "clip": "clip_model.text_encoder.transformer.resblocks.0.mlp.c_fc.weight",
             "maple": "clip_model.prompt_learner.ctx", "cascade": "sam_visual_proj.1.weight"}
    for kind in CASES[case]:
        if kind in probe:
            assert not torch.equal(got[probe[kind]], fresh[probe[kind]]), kind
    if "clip" in CASES[case] and "cascade" not in CASES[case]:  # not in the archive: zeros
        w = got["clip_model.image_encoder.conv1_alpha.weight"]
        assert w.abs().max() == 0 and not torch.equal(w, fresh[
            "clip_model.image_encoder.conv1_alpha.weight"])


def test_files_load_as_jax_assembles_them_in_bfloat16(files, monkeypatch):
    """In bfloat16 every parameter equals JAX's cast after the last merge
    (fp16 and fp32 file values rounded once to bfloat16; no_mask_embed in
    fp32 in both)."""
    want, jbank, model, bank = _both(files, "all_four", monkeypatch, torch.bfloat16)
    got = dict(model.named_parameters())
    assert got["image_encoder.blocks.0.attn.qkv.weight"].dtype == torch.bfloat16
    assert got["no_mask_embed.weight"].dtype == torch.float32
    assert_state_equal(got, want, keys=list(got))
    assert_bank_equal(bank, jbank)


def test_what_raises(files, tmp_path):
    cfg = CascadeConfig.tiny()
    model = build_cascade(cfg, "cpu", 0)
    bad = tmp_path / "unrelated.pth.tar"
    torch.save({"state_dict": {"visual.conv1.weight": torch.zeros(1)}, "epoch": 1}, bad)
    with pytest.raises(ValueError, match="matched no prompt-learner keys"):
        load_checkpoints(model, cfg, maple_ckpt=str(bad))
    sd = torch_loader.load_torch_state_dict(files["sam.pth"])
    sd["image_encoder.pos_embed"] = torch.zeros(1, 3, 3, 8)
    wrong = tmp_path / "sam_wrong_shape.pth"
    torch.save(sd, wrong)
    before = model.state_dict()["image_encoder.blocks.0.norm1.weight"].clone()
    with pytest.raises(ValueError, match="shape mismatch at image_encoder.pos_embed"):
        load_checkpoints(model, cfg, sam_ckpt=str(wrong))
    # checked before anything is copied
    assert torch.equal(model.state_dict()["image_encoder.blocks.0.norm1.weight"], before)
    for path in (str(tmp_path / "missing.pth"), "ViT-L/14@336px",
                 "https://example.com/ViT-L-14-336px.pt"):
        with pytest.raises(FileNotFoundError, match="no such file"):
            load_checkpoints(model, cfg, clip_ckpt=path)
    make_bank = load_checkpoints(model, cfg)
    with pytest.raises(FileNotFoundError, match="--text-bank"):
        make_bank(CLASSES, str(tmp_path / "missing.npy"))


def test_readers_keep_the_file_types_on_the_cpu(files):
    """The OpenAI archive's tensors stay fp16 on the CPU, without its three
    integers; the dassl reader returns the other entries beside the state
    dict."""
    sd = torch_loader.load_openai_clip_state_dict(files["clip.pt"])
    assert sd["visual.conv1.weight"].dtype == torch.float16
    assert all(v.device.type == "cpu" for v in sd.values())
    assert not {"input_resolution", "context_length", "vocab_size"} & set(sd)
    msd, extras = torch_loader.load_dassl_checkpoint(files["maple.pth.tar"])
    assert extras["epoch"] == 7 and "prompt_learner.ctx" in msd


def test_export_checkpoint_matches_jax_exporter(files, tmp_path, monkeypatch):
    """A port train checkpoint of JAX-assembled params, exported, equals
    JAX's `export_cascade_checkpoint` of the same params: the same keys in
    the same order, fp32, bit for bit."""
    same_init_in_jax(monkeypatch)
    _, _, params, _ = j_assemble(CLASSES, tiny=True, dtype=jnp.float32, seed=0,
                                 sam_ckpt=files["sam.pth"], clip_ckpt=files["clip.pt"])
    cfg = CascadeConfig.tiny()
    model = build_cascade(cfg, "cpu", 1)
    load_jax_params(model, jax.tree.map(np.asarray, params), cfg)
    ckpt = tmp_path / "ckpt_last.pt"
    save_checkpoint(str(ckpt), model, make_optimizer(trainable_parameters(model), 1e-3, 0.01), 3)
    out = tmp_path / "model.pth"
    got = export_checkpoint.main(["--checkpoint", str(ckpt), "--out", str(out), "--tiny",
                                  "--strict"])
    want, missing = j_export(jax.tree.map(np.asarray, params), JCascadeConfig.tiny(), strict=True)
    assert not missing
    written = torch.load(out, weights_only=True)
    assert list(written) == list(got) == list(want)
    for k, v in want.items():
        assert written[k].dtype == torch.float32
        np.testing.assert_array_equal(written[k].numpy(), v, err_msg=k)


def test_synthetic_archive_round_trips(tmp_path):
    """`save_torchscript` writes what the OpenAI reader reads back."""
    sd = {"visual.conv1.weight": torch.ones(2, 3, 1, 1, dtype=torch.float16),
          "transformer.resblocks.0.attn.in_proj_weight": torch.arange(6.0).reshape(3, 2),
          "vocab_size": torch.tensor(10)}
    path = str(tmp_path / "a.pt")
    synthetic.save_torchscript(sd, path)
    back = torch_loader.load_openai_clip_state_dict(path)
    assert set(back) == set(sd) - {"vocab_size"}
    for k, v in back.items():
        assert v.dtype == sd[k].dtype and torch.equal(v, sd[k])
