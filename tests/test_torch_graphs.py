"""Capture safety of the port's inference path and the CUDA graph helper.

On the CPU: `graphs.GraphedCall` calls its function eagerly; the cascade
call (`infer_cascade_with_text`, the fused 'flash' SAM path of an 8-head
small configuration, which walks the same Python as the full-width one)
makes no op that reads a tensor's value on the host, and none that builds
a tensor from host data, once it has run once (its device constants are
cached); a device constant first built while a stream captures raises;
the factory's build in the compute type gives bit-for-bit the weights of
an fp32 build cast afterwards.

On a card (`gpu` marker; skips here):
    python -m pytest --noconftest -m gpu tests/test_torch_graphs.py -q
the small cascade captured at batch 2 replays bit-equal to its eager call,
and the captured launches equal the eager call's.

No JAX import here, so that the file runs on the card's host.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from camouflaged_vlm_tpu_torch import factory  # noqa: E402
from camouflaged_vlm_tpu_torch.graphs import GraphedCall  # noqa: E402
from camouflaged_vlm_tpu_torch.models import (  # noqa: E402
    CascadeConfig,
    OVCOSCascade,
    SamEncoderConfig,
)
from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import _cuda, constants  # noqa: E402

CLASSES = ["cat", "owl", "bat", "moth", "slug"]


def small_config(dtype):
    """SAM on fused 'flash' (8 heads x 16, grid 10, window 4: interior,
    edge and corner windows on the compact carry), CLIP 8 heads x 16."""
    clip = AlphaClipConfig.tiny(dtype=dtype, vision_width=128, vision_heads=8,
                                transformer_width=128)
    enc = SamEncoderConfig.tiny(dtype=dtype, attn_impl="flash", img_size=160, embed_dim=128,
                                num_heads=8, window_size=4, prompt_scale_factor=16)
    return dataclasses.replace(CascadeConfig.tiny(dtype=dtype), inp_size=enc.img_size,
                               encoder=enc, clip=clip)


def small_call(device, dtype, B=2):
    cfg = small_config(dtype)
    model = factory.attach_rel_cache(factory.build_cascade(cfg, device, seed=5))
    bank = factory.make_bank_inputs(cfg, CLASSES, seed=5, device=device)
    tf = model.encode_class_text_features(bank["prefix"], bank["suffix"], bank["eot_indices"],
                                          bank["bank_features"])
    g = torch.Generator().manual_seed(5)
    inp = torch.randn(B, cfg.inp_size, cfg.inp_size, 3, generator=g).to(device)
    cimg = torch.randn(B, cfg.clip_size, cfg.clip_size, 3, generator=g).to(device)

    def call(inp, cimg):
        cmask = torch.full((inp.shape[0], cfg.clip_size, cfg.clip_size, 1), 1.9230769,
                           device=inp.device)
        return model.infer_cascade_with_text(inp, cimg, cmask, tf)

    return cfg, call, inp, cimg


# ops that read a tensor's value on the host (a device synchronisation, and
# illegal under capture) or build a tensor from host data (a copy from
# pageable memory on a card)
HOST_OPS = ("_local_scalar_dense", "is_nonzero", "nonzero", "equal", "allclose",
            "masked_select", "unique", "lift_fresh", "scalar_tensor", "_to_copy")


class RecordOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] == "_to_copy":
            src = args[0].device
            dst = (kwargs or {}).get("device") or src
            if torch.device(dst) == src:
                return out  # a cast on one device
        self.ops.append(func.__name__)
        return out


def test_cascade_call_reads_nothing_on_the_host():
    _, call, inp, cimg = small_call("cpu", torch.float32)
    call(inp, cimg)  # builds the cached device constants
    with RecordOps() as rec:
        probs, pred, score = call(inp, cimg)
    bad = sorted({op for op in rec.ops if op.split(".")[0] in HOST_OPS})
    assert not bad, bad
    assert len(rec.ops) > 500 and probs.shape[0] == pred.shape[0] == score.shape[0] == 2


def test_device_constant_refuses_a_capture(monkeypatch):
    a = np.arange(6, dtype=np.float32)
    assert torch.equal(constants.device_constant(a, "cpu", torch.float64),
                       torch.arange(6, dtype=torch.float64))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert constants.device_constant(a, "cpu").dtype == torch.float32  # the CPU never captures
    with pytest.raises(RuntimeError, match="during CUDA graph capture"):
        constants.device_constant(a, "cuda")


def test_graphed_call_runs_eagerly_on_the_cpu():
    calls = []

    def fn(x, y):
        calls.append(torch.is_grad_enabled())
        return x + y, x * y

    x, y = torch.ones(3, requires_grad=True), torch.full((3,), 2.0)
    g = GraphedCall(fn, x, y)
    assert g.graph is None and g.launches is None and calls == []  # no warm-up on the CPU
    s, p = g(x, y)
    assert torch.equal(s, torch.full((3,), 3.0)) and torch.equal(p, torch.full((3,), 2.0))
    assert calls == [False] and not s.requires_grad  # under no grad, like the capture


def _old_build(cfg, seed):
    """The build before weights were allocated in the compute type: fp32
    fill, then the cast."""
    with torch.device("meta"):
        model = OVCOSCascade(cfg)
    model = model.to_empty(device="cpu")
    factory.init_random_(model, torch.Generator().manual_seed(seed))
    factory.cast_weights_(model, cfg.encoder.dtype)
    return model


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_build_in_compute_type_is_bit_equal_tiny(dtype):
    cfg = CascadeConfig.tiny(dtype=dtype)
    new = factory.build_cascade(cfg, "cpu", seed=3).state_dict()
    old = _old_build(cfg, 3).state_dict()
    assert new.keys() == old.keys()
    for k in old:
        assert new[k].dtype == old[k].dtype and torch.equal(new[k], old[k]), k
    assert sum(t.dtype == dtype for t in new.values()) > 100


def test_build_in_compute_type_full_width():
    """The full width on `meta` (every tensor's type and shape as the cast
    build's: rank >= 2 parameters in bf16 but `factory.FP32_WEIGHTS`, the
    rest fp32), then one
    full-width SAM ViT-H block and one CLIP ViT-L block filled both ways on
    the CPU, bit for bit."""
    cfg = CascadeConfig.full(dtype=torch.bfloat16)
    with torch.device("meta"):
        model = OVCOSCascade(cfg)
    factory.cast_weights_(model, torch.bfloat16)
    for name, p in model.named_parameters():
        cast = p.ndim >= 2 and name not in factory.FP32_WEIGHTS
        assert p.dtype == (torch.bfloat16 if cast else torch.float32), name
    assert model.no_mask_embed.weight.dtype == torch.float32
    assert all(b.dtype == torch.float32 for b in model.buffers())

    def blocks(order):
        with torch.device("meta"):
            m = OVCOSCascade(cfg)
        out = []
        for sub in (m.image_encoder.blocks[0], m.clip_model.image_encoder.transformer.resblocks[0]):
            if order == "new":
                factory.cast_weights_(sub, torch.bfloat16)
            sub.to_empty(device="cpu")
            factory.init_random_(sub, torch.Generator().manual_seed(7))
            if order == "old":
                factory.cast_weights_(sub, torch.bfloat16)
            out.append(sub.state_dict())
        return out

    for got, want in zip(blocks("new"), blocks("old")):
        assert got.keys() == want.keys()
        assert sum(t.dtype == torch.bfloat16 for t in want.values()) >= 4
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.gpu
def test_graphed_small_cascade_equals_eager_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and graphs run only on the GPU")
    cfg, call, inp, cimg = small_call("cuda", torch.bfloat16)
    with torch.no_grad():
        _cuda.reset_launches()
        eager = [t.clone() for t in call(inp, cimg)]
        eager_launches = _cuda.launch_counts()
        g = GraphedCall(call, inp, cimg)
        assert g.launches == eager_launches and sum(eager_launches.values()) > 20
        for _ in range(2):
            before = _cuda.launch_counts()
            out = g(inp, cimg)
            torch.cuda.synchronize()
            assert _cuda.launch_counts() == before  # a replay launches nothing from the host
            for a, b in zip(out, eager):
                assert a.dtype == b.dtype and torch.equal(a, b)
        # new inputs go through the static buffers
        inp2 = torch.flip(inp, dims=[0]).contiguous()
        cimg2 = torch.flip(cimg, dims=[0]).contiguous()
        want = [t.clone() for t in call(inp2, cimg2)]
        for a, b in zip(g(inp2, cimg2), want):
            assert torch.equal(a, b)
