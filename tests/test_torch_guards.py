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


# (CLI, configuration) at --dtype float32 on the card: every configuration of
# the repo (the reference one, CascadeConfig.full with no --config or --tiny;
# --tiny; the ViT-B yaml; ViT-H on 'aug_flash' and at windows 16 and 17) has
# every fp32 instance its routes launch, the train CLI's backwards (#6, #14,
# #18) included, so none is refused
REF = "reference"
GUARD_CASES = [
    pytest.param("demo", REF, id="demo"),
    pytest.param("evaluate", REF, id="evaluate"),
    pytest.param("serve", REF, id="serve"),
    pytest.param("bench", REF, id="bench"),
    pytest.param("serve_throughput", REF, id="serve_throughput"),
    pytest.param("train", REF, id="train"),
    pytest.param("demo", "tiny", id="demo-tiny"),
    pytest.param("bench", "tiny", id="bench-tiny"),
    pytest.param("serve_throughput", "tiny", id="serve_throughput-tiny"),
    pytest.param("evaluate", "vit_b", id="evaluate-vit_b"),
    pytest.param("serve", "vit_b", id="serve-vit_b"),
    pytest.param("evaluate", "aug_flash", id="evaluate-aug_flash"),
    pytest.param("evaluate", "win16", id="evaluate-win16"),
    pytest.param("evaluate", "win17", id="evaluate-win17"),
    pytest.param("train", "win16", id="train-win16"),
]
VIT_H_YAML = "configs/ovcos-sam-vit-h-maskdecoder-edge.yaml"
VIT_B_YAML = "camouflaged_vlm_tpu_torch/configs/ovcos-sam-vit-b-maskdecoder-edge.yaml"


def _config_flags(config, tmp_path):
    """The flags that select `config`: nothing for the reference one,
    --tiny, the port's ViT-B yaml, or the repo's ViT-H yaml with one
    encoder field changed, written under tmp_path."""
    import yaml

    if config == REF:
        return []
    if config == "tiny":
        return ["--tiny"]
    if config == "vit_b":
        return ["--config", VIT_B_YAML]
    raw = yaml.safe_load(open(VIT_H_YAML))
    if config == "aug_flash":
        raw["model"]["encoder"]["attn_impl"] = "aug_flash"
    else:
        raw["model"]["encoder"]["window_size"] = int(config[3:])
    path = tmp_path / f"{config}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return ["--config", str(path)]


def _cli_run(cli, config, image_path, tmp_path):
    """The CLI's entry (the serve CLI's engine build) and its argv at
    --device cuda for `config`, the dtype left to add."""
    import importlib

    mod = importlib.import_module(f"camouflaged_vlm_tpu_torch.cli.{cli}")
    info = tmp_path / "dataset_info.yaml"
    info.write_text("{}")
    extra = {"demo": ["--image", image_path, "--out-dir", str(tmp_path / "out")],
             "evaluate": ["--dataset-info", str(info), "--output-dir", str(tmp_path / "out")],
             "train": ["--dataset-info", str(info), "--save-dir", str(tmp_path / "out")]}
    argv = [*_config_flags(config, tmp_path), "--device", "cuda", *extra.get(cli, [])]
    run = (lambda a: mod.build_engine(mod.parse_args(a))) if cli == "serve" else mod.main
    return run, argv


@pytest.mark.parametrize("cli,config", GUARD_CASES)
def test_float32_on_the_card_refuses_before_the_build(cli, config, image_path, tmp_path,
                                                      no_cuda):
    """--device cuda --dtype float32 goes on to the card check, as bfloat16
    always does, for every CLI on every configuration of the repo: no route
    launches a kernel without an fp32 instance, so the guard refuses none
    (`test_float32_guard_names_a_hidden_instance` holds its refusal); on a
    host without a card both stop there, before anything is built or
    written."""
    run, argv = _cli_run(cli, config, image_path, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(argv + ["--dtype", "float32"])
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(argv + ["--dtype", "bfloat16"])


@pytest.mark.parametrize("cli,config,hidden", [
    ("evaluate", "vit_b", "flash_attention_relpos"),
    ("train", "win17", "proj_from_heads_res"),
])
def test_float32_guard_names_a_hidden_instance(cli, config, hidden, image_path, tmp_path,
                                               monkeypatch, no_cuda):
    """With one route's fp32 instance hidden (`_cuda.has_f32_instance` false
    for it), --device cuda --dtype float32 refuses at once, before the card
    is looked for, naming exactly that kernel in the guard's message, rather
    than a TypeError inside a kernel wrapper; bfloat16 goes on to the card
    check."""
    from camouflaged_vlm_tpu_torch.cli.common import TPU_KERNEL
    from camouflaged_vlm_tpu_torch.ops import _cuda

    has = _cuda.has_f32_instance
    monkeypatch.setattr(_cuda, "has_f32_instance", lambda name: name != hidden and has(name))
    run, argv = _cli_run(cli, config, image_path, tmp_path)
    with pytest.raises(NotImplementedError) as err:
        run(argv + ["--dtype", "float32"])
    assert str(err.value) == (
        "--device cuda with float32: this configuration's path launches kernels with no fp32 "
        f"instance yet: {TPU_KERNEL[hidden]} {hidden} (ROADMAP.md Queue 2). Run --dtype "
        "bfloat16 on the card, or float32 with --device cpu.")
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(argv + ["--dtype", "bfloat16"])


@pytest.fixture
def kernel_names(monkeypatch):
    """The names `_cuda.use_kernel` receives (on the CPU too, where each
    wrapper then takes its plain version)."""
    from camouflaged_vlm_tpu_torch.ops import _cuda

    names = set()
    use = _cuda.use_kernel

    def record(name, *tensors, **kw):
        names.add(name)
        return use(name, *tensors, **kw)

    monkeypatch.setattr(_cuda, "use_kernel", record)
    return names


def _tiny_fp32(**enc):
    import dataclasses

    cfg = SamEncoderConfig.tiny(**{"attn_impl": "flash", "num_heads": 8, **enc})
    return dataclasses.replace(CascadeConfig.tiny(dtype=torch.float32), inp_size=cfg.img_size,
                               encoder=cfg)


def test_fp32_guard_holds_to_the_routes(kernel_names):
    """The guard's model of the routes (`common.cascade_kernels`) against
    the kernels the model calls: the tiny fused compact cascade (8 heads,
    grid 24 with window 5: interior and edge windows, global blocks of 576
    tokens on #17) in fp32 on the CPU calls exactly the guard's kernels,
    each with an fp32 instance, so the guard passes it; with a backward it
    adds #6, #14 and #18, each with an fp32 instance too, so the guard
    passes the train CLI as well."""
    from camouflaged_vlm_tpu_torch.cli.common import cascade_kernels, fp32_missing_kernels
    from camouflaged_vlm_tpu_torch.factory import make_bank_inputs
    from camouflaged_vlm_tpu_torch.ops import _cuda

    cfg = _tiny_fp32(img_size=384, window_size=5)
    model = build_cascade(cfg, "cpu", seed=0)
    rng = np.random.default_rng(0)
    bank = make_bank_inputs(cfg, ["cat", "owl"], seed=0, device="cpu")
    C = cfg.clip_size
    with torch.no_grad():
        model.infer_cascade(torch.from_numpy(rng.standard_normal((1, 384, 384, 3),
                                                                 dtype=np.float32)),
                            torch.from_numpy(rng.standard_normal((1, C, C, 3), dtype=np.float32)),
                            torch.ones(1, C, C, 1), bank["prefix"], bank["suffix"],
                            bank["eot_indices"], bank["bank_features"])
    assert kernel_names == set(cascade_kernels(cfg))
    assert all(_cuda.has_f32_instance(k) for k in kernel_names)
    assert fp32_missing_kernels(cfg) == []
    kernel_names.clear()
    model.image_encoder.requires_grad_(True)
    y, interm = model.image_encoder(torch.from_numpy(rng.standard_normal((1, 384, 384, 3),
                                                                        dtype=np.float32)))
    (y.sum() + sum(t.sum() for t in interm)).backward()
    assert fp32_missing_kernels(cfg, training=True) == []
    backward = {"ln_mlp_residual_bt_bwd", "flash_qkv_packed_windows_s_bwd",
                "flash_qkv_packed_global_bwd"}
    assert set(cascade_kernels(cfg, training=True)) - set(cascade_kernels(cfg)) == backward
    assert backward <= kernel_names
    assert all(_cuda.has_f32_instance(k) for k in backward)


def test_train_cli_turns_tf32_off_in_float32_on_the_card(monkeypatch, tmp_path):
    """The train CLI at --dtype float32 on the card turns TF32 off
    (`common.exact_fp32_on_card`) right after its device check, before it
    builds or reads anything, so the plain-VJP backwards' matmuls, the
    decoder and the neck's convolutions run full fp32 as the kernels do."""
    from camouflaged_vlm_tpu_torch.cli import common, train

    class Stop(Exception):
        pass

    calls = []

    def record(device, cfg):
        common.exact_fp32_on_card(device, cfg)
        calls.append((device, cfg.encoder.dtype, cfg.decoder.dtype, cfg.clip.dtype))
        raise Stop

    monkeypatch.setattr(train, "exact_fp32_on_card", record)
    monkeypatch.setattr(train, "device_or_raise", torch.device)  # a host without a card too
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    info = tmp_path / "dataset_info.yaml"
    info.write_text("{}")
    with pytest.raises(Stop):
        train.main(["--dataset-info", str(info), "--save-dir", str(tmp_path / "out"),
                    "--device", "cuda", "--dtype", "float32"])
    assert calls == [("cuda", torch.float32, torch.float32, torch.float32)]
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("enc,missing", [
    (dict(num_heads=4), ["#10"]),                                   # unfused 'flash'
    (dict(attn_impl="aug_flash", img_size=512), ["#20"]),           # global blocks of 1024
    (dict(img_size=320, window_size=16), ["#8", "#11", "#12"]),     # padded carry, grid 20
    (dict(img_size=320, window_size=17), ["#8", "#11"]),
])
def test_fp32_guard_names_what_the_refused_routes_call(kernel_names, monkeypatch, enc, missing):
    """The four routes off the reference configuration's (tiny widths, fp32
    on the CPU): the kernels the whole cascade calls are exactly the guard's
    (`cascade_kernels`), each with an fp32 instance, so the guard passes
    them; with the instances of the route's own kernels (`missing`: #10;
    #20; #12, #11 + #8 of the padded carry and its global blocks of 400
    tokens, H + W = 40; #11 + #8) hidden, it names exactly those."""
    from camouflaged_vlm_tpu_torch.cli.common import (
        TPU_KERNEL,
        cascade_kernels,
        fp32_missing_kernels,
    )
    from camouflaged_vlm_tpu_torch.factory import make_bank_inputs
    from camouflaged_vlm_tpu_torch.ops import _cuda

    cfg = _tiny_fp32(**enc)
    model = build_cascade(cfg, "cpu", seed=0)
    rng = np.random.default_rng(0)
    bank = make_bank_inputs(cfg, ["cat", "owl"], seed=0, device="cpu")
    C, S = cfg.clip_size, cfg.inp_size
    with torch.no_grad():
        model.infer_cascade(torch.from_numpy(rng.standard_normal((1, S, S, 3), dtype=np.float32)),
                            torch.from_numpy(rng.standard_normal((1, C, C, 3), dtype=np.float32)),
                            torch.ones(1, C, C, 1), bank["prefix"], bank["suffix"],
                            bank["eot_indices"], bank["bank_features"])
    assert kernel_names == set(cascade_kernels(cfg))
    assert all(_cuda.has_f32_instance(k) for k in kernel_names)
    assert fp32_missing_kernels(cfg) == [] and fp32_missing_kernels(cfg, training=True) == []
    own = {k for k in kernel_names if TPU_KERNEL[k] in missing}
    has = _cuda.has_f32_instance
    monkeypatch.setattr(_cuda, "has_f32_instance", lambda name: name not in own and has(name))
    assert [m.split()[0] for m in fp32_missing_kernels(cfg)] == missing
