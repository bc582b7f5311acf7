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
    """The paths that raised before TPU kernels #10 and #20 were ported
    ('flash' at 4 heads takes the JAX package's unfused path, the aug_*
    paths the augmented features) now build and run; an unknown
    implementation raises."""
    enc = ImageEncoderViT(SamEncoderConfig.tiny(attn_impl=impl))
    with torch.no_grad():
        y, interm = enc(torch.randn(1, 64, 64, 3))
    assert y.shape == (1, 4, 4, 32) and bool(torch.isfinite(y).all()) and len(interm) == 2
    assert not enc.fused
    with pytest.raises(ValueError, match="attn_impl"):
        ImageEncoderViT(SamEncoderConfig.tiny(attn_impl=impl + "_typo"))


def test_flash_names_its_roadmap_item():
    assert SamEncoderConfig().attn_impl == "flash"  # the JAX package's default
    assert CascadeConfig.full().encoder.attn_impl == "flash"
    assert CascadeConfig.tiny().encoder.attn_impl == "flash"  # 4 heads: unfused, as in JAX
    with torch.device("meta"):  # the ViT-H cascade on 'flash' builds
        OVCOSCascade(CascadeConfig.full())
    assert ImageEncoderViT(SamEncoderConfig.tiny(attn_impl="flash", embed_dim=64,
                                                 num_heads=8)).fused
    assert not ImageEncoderViT(SamEncoderConfig.tiny(attn_impl="flash", num_heads=4)).fused
    # fused 'flash' with a window > 14: the padded carry, as in the JAX package
    # (#12 at H+W <= 32, #11 beyond); nothing raises for a geometry JAX runs
    for win, route in ((16, "packed"), (17, "relpos")):
        enc = ImageEncoderViT(SamEncoderConfig.tiny(attn_impl="flash", embed_dim=64,
                                                    num_heads=8, img_size=320, window_size=win))
        assert enc.fused and not enc.compact
        assert enc.blocks[0].attn.fused_route == route
        assert enc.blocks[0].attn.num_windows == 4  # grid 20 padded to 2 x 2 windows
        with torch.no_grad():
            y, interm = enc(torch.randn(1, 320, 320, 3))
        assert y.shape == (1, 20, 20, 32) and bool(torch.isfinite(y).all())
    # unfused 'flash' takes a window > 14 in the padded carry (#10, no #12)
    ImageEncoderViT(SamEncoderConfig.tiny(attn_impl="flash", img_size=320, window_size=16))


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
        lambda: flash_attention.flash_attention_relpos(m(2, 4, 16), m(2, 4, 16), m(2, 4, 16),
                                                       m(2, 4, 4), m(4, 4), 2, 2),
        lambda: flash_attention.flash_attention_fullk(m(2, 4, 16), m(2, 4, 16), m(2, 4, 16)),
        lambda: flash_attention.flash_qkv_packed_windows(m(1, 2, 4, 48), m(1, 2, 4, 64),
                                                         m(32, 4), 0.25, 2, 8),
        lambda: flash_attention.flash_qkv_relpos_windows(m(1, 2, 4, 6, 8), m(1, 2, 4, 2, 4),
                                                         m(4, 4), 0.25, 2, 2),
        lambda: flash_attention.flash_qkv_relpos_global(m(1, 4, 6, 8), m(1, 4, 2, 4), m(4, 4),
                                                        0.25, 2, 2),
        lambda: linear.proj_from_heads_res(m(1, 2, 1, 4, 8), m(6, 16), m(6), m(1, 1, 4, 6)),
        lambda: linear.proj_from_heads(m(1, 2, 1, 4, 8), m(6, 16), m(6)),
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


@pytest.mark.parametrize("cli", ["demo", "evaluate", "serve", "train", "bench",
                                 "serve_throughput"])
def test_float32_on_the_card_refuses_before_the_build(cli, image_path, tmp_path, no_cuda):
    """--device cuda --dtype float32 refuses at once, naming the kernels with
    no fp32 instance yet (before the card is even looked for, so this runs
    on any host), rather than a TypeError inside a kernel wrapper, and not
    the CLIP kernels that have one (#2, #16, #7, #4/#5 and #6: MaPLe
    training's, whose CLI runs fp32 on the card); bfloat16 goes on to the
    card check."""
    import importlib

    from camouflaged_vlm_tpu_torch.cli.common import NO_FP32_KERNEL

    mod = importlib.import_module(f"camouflaged_vlm_tpu_torch.cli.{cli}")
    info = tmp_path / "dataset_info.yaml"
    info.write_text("{}")
    extra = {"demo": ["--image", image_path, "--out-dir", str(tmp_path / "out")],
             "evaluate": ["--dataset-info", str(info), "--output-dir", str(tmp_path / "out")],
             "train": ["--dataset-info", str(info), "--save-dir", str(tmp_path / "out")]}
    argv = ["--tiny", "--device", "cuda", *extra.get(cli, [])]
    run = (lambda a: mod.build_engine(mod.parse_args(a))) if cli == "serve" else mod.main
    with pytest.raises(NotImplementedError) as err:
        run(argv + ["--dtype", "float32"])
    msg = str(err.value)
    assert msg.startswith("--device cuda with float32") and "ROADMAP.md Queue 2" in msg
    assert all(k in msg for k in NO_FP32_KERNEL)
    assert not any(k in msg for k in ("#2 ", "#4", "#6 ", "#7 ", "#16 "))
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(argv + ["--dtype", "bfloat16"])
