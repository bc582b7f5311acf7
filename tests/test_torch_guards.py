"""Guards of the PyTorch port: nothing runs quietly somewhere it was not asked
to, and unported options fail loudly. Plus the demo CLI end to end on the
CPU at the tiny size."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from camouflaged_vlm_tpu_torch.cli import demo  # noqa: E402
from camouflaged_vlm_tpu_torch.factory import build_cascade  # noqa: E402
from camouflaged_vlm_tpu_torch.models import (  # noqa: E402
    CascadeConfig,
    ImageEncoderViT,
    OVCOSCascade,
    SamEncoderConfig,
)
from camouflaged_vlm_tpu_torch.ops import flash_attention, linear  # noqa: E402


@pytest.fixture
def image_path(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "scorpionfish.png"
    Image.fromarray(rng.integers(0, 255, (90, 120, 3), dtype=np.uint8)).save(path)
    return str(path)


@pytest.fixture
def no_cuda(monkeypatch):
    """Behave as a host without a GPU, whatever this host has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("impl", ["flash", "aug_flash", "aug_xla"])
def test_unported_attn_impl_raises(impl):
    """'flash' at 4 heads would take the JAX package's unfused path (TPU
    site #10, not ported); the aug_* ablations are not ported at all."""
    match = "site #10" if impl == "flash" else "reference"
    with pytest.raises(NotImplementedError, match=match):
        ImageEncoderViT(SamEncoderConfig.tiny(attn_impl=impl))


def test_flash_names_its_roadmap_item():
    assert SamEncoderConfig().attn_impl == "flash"  # the JAX package's default
    assert CascadeConfig.full().encoder.attn_impl == "flash"
    assert CascadeConfig.tiny().encoder.attn_impl == "reference"  # 4 heads
    with torch.device("meta"):  # the ViT-H cascade on 'flash' builds
        OVCOSCascade(CascadeConfig.full())
    ImageEncoderViT(SamEncoderConfig.tiny(attn_impl="flash", embed_dim=64, num_heads=8))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ImageEncoderViT(SamEncoderConfig.tiny(attn_impl="flash", num_heads=4))
    with pytest.raises(NotImplementedError, match="site #12"):  # window > 14
        ImageEncoderViT(SamEncoderConfig.tiny(attn_impl="flash", embed_dim=64, num_heads=8,
                                              img_size=320, window_size=16))


def test_demo_cuda_without_gpu_raises(image_path, tmp_path, no_cuda):
    argv = ["--image", image_path, "--out-dir", str(tmp_path / "out"), "--tiny",
            "--device", "cuda"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(argv)
    assert not (tmp_path / "out").exists()


def test_model_on_cuda_without_gpu_raises(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cascade(CascadeConfig.tiny(), "cuda")


def test_kernel_wrappers_refuse_non_cpu_tensors():
    """Only CPU tensors take the plain versions; any other device must reach
    a kernel or raise (meta tensors stand in for a device without one)."""
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    calls = [
        lambda: linear.linear_act(m(4, 8), m(6, 8), m(6)),
        lambda: linear.ln_linear_act_bt(m(1, 4, 8), m(8), m(8), m(6, 8), m(6)),
        lambda: linear.ln_mlp_residual_bt(m(1, 4, 8), m(8), m(8), m(16, 8), m(16),
                                          m(8, 16), m(8)),
        lambda: linear.proj_rows(m(1, 1, 8, 4), m(6, 8), m(6)),
        lambda: flash_attention.flash_qkv_packed_plain(m(1, 4, 48), 0.25, 2, 8),
        lambda: linear.ln_mask_linear_bt(m(2, 4, 8), m(8), m(8), m(1, 4, 1), m(6, 8), m(6)),
        lambda: flash_attention.flash_qkv_packed_windows_s(m(2, 4, 48), m(4, 2, 64),
                                                           m(32, 4), 0.25, 2, 8),
        lambda: flash_attention.flash_qkv_packed_edge(m(1, 2, 4, 48), m(1, 2, 4, 64),
                                                      m(2, 32, 4), m(2, 8), m(2, 1, 4),
                                                      0.25, 2, 8),
        lambda: flash_attention.flash_qkv_packed_global(m(1, 4, 48), m(4, 1, 2, 4), m(4, 4),
                                                        0.25, 2, 8, 2, 2),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported devices"):
            call()


def test_demo_cli_runs_on_cpu(image_path, tmp_path, capsys):
    out = tmp_path / "out"
    demo.main(["--image", image_path, "--out-dir", str(out), "--tiny", "--device", "cpu",
               "--dtype", "float32", "--classnames", "cat,owl,slug"])
    printed = capsys.readouterr().out
    cls = printed.split("predicted class: ")[1].splitlines()[0]
    assert cls in ("cat", "owl", "slug")
    overlay = out / f"[{cls}]scorpionfish.png"
    mask = out / "mask_scorpionfish.png"
    assert overlay.exists() and mask.exists()
    assert Image.open(overlay).size == (120, 90) and Image.open(mask).size == (120, 90)


def test_demo_session_predicts_a_batch_on_cpu(image_path):
    args = demo.parse_args(["--image", image_path, "--tiny", "--device", "cpu",
                            "--dtype", "float32"])
    session = demo.DemoSession(args)
    assert len(session.classnames) == 61  # the OVCamo test split by default
    img = Image.open(image_path)
    probs, pred, logits = session.predict([img, img.transpose(Image.FLIP_LEFT_RIGHT)])
    assert probs.shape == (2, 64, 64) and logits.shape == (2, 61)
    assert np.isfinite(probs).all() and probs.min() >= 0 and probs.max() <= 1
    assert ((pred >= 0) & (pred < 61)).all()
