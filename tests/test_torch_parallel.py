"""The port's multi-device layer (`camouflaged_vlm_tpu_torch/parallel/`) on the CPU.

The rules first, in this process: every parameter's partition kind against
the JAX package's `param_partition_spec` (tiny and full cascade), the
head-aligned shards of the packed projections, the residual-free form of
the fused MLP, the refusals. Then gloo process groups of 2 and 4 ranks
(`graft_entry_torch.spawn_ranks`; what the ranks run is
`tests/_torch_parallel_cases.py`), each started once for all its cases:

  2 ranks: the train step on (2, 1) and (1, 2) meshes, with accumulation,
      the balanced BCE and remat cases; a (2, 1) checkpoint resumed on
      (1, 2); evaluate() data- and tensor-parallel; the serving engine on
      (2, 1); the train CLI with --distributed;
  4 ranks: the (2, 2) train step of an 8-head slice (SAM fused on the
      compact carry with edge windows, 8-head CLIP) against one process and
      against the JAX package's one-device step on the same weights.

Tolerances: the steps as the JAX dry run (`__graft_entry__.py`): |dloss| <
1e-5, updated parameters within 1e-4; the (2, 2) step against JAX as
`tests/test_torch_train.py` (loss 1e-5 relative, gradients 1e-4 relative
with a floor of 1e-4 of the leaf's largest magnitude plus 1e-8); evaluate's
metrics within 1e-6 data-parallel and 5e-4 tensor-parallel (as
`tests/test_data_pipeline.py`); the engine as `tests/test_serve.py`.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _torch_parallel_cases as cases  # noqa: E402
import graft_entry_torch as g  # noqa: E402
from camouflaged_vlm_tpu import train as jtrain  # noqa: E402
from camouflaged_vlm_tpu.factory import make_bank_inputs as j_make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu.models import CascadeConfig as JCascadeConfig  # noqa: E402
from camouflaged_vlm_tpu.models import OVCOSCascade as JCascade  # noqa: E402
from camouflaged_vlm_tpu.models import sam_encoder as j_sam  # noqa: E402
from camouflaged_vlm_tpu.models.clip import AlphaClipConfig as JClipConfig  # noqa: E402
from camouflaged_vlm_tpu.parallel.sharding import param_partition_spec  # noqa: E402
from camouflaged_vlm_tpu.train.train_step import combine_params, partition_params  # noqa: E402

from camouflaged_vlm_tpu_torch.factory import build_cascade, make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu_torch.io.convert import (  # noqa: E402
    _inverse_transform,
    cascade_key_map,
    state_dict_from_jax_params,
)
from camouflaged_vlm_tpu_torch.models import (  # noqa: E402
    CascadeConfig,
    OVCOSCascade,
    SamEncoderConfig,
)
from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import linear  # noqa: E402
from camouflaged_vlm_tpu_torch.parallel import check_tp_config, param_partition_kind  # noqa: E402
from camouflaged_vlm_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from camouflaged_vlm_tpu_torch.parallel.sharding import shard_tensor, unshard_tensor  # noqa: E402
from camouflaged_vlm_tpu_torch.serve import InferenceEngine, ServeConfig  # noqa: E402

ENC_8 = dict(img_size=80, embed_dim=64, num_heads=8, prompt_scale_factor=8)
CLIP_8x16 = dict(vision_width=128, vision_heads=8)
EVAL_KEYS = ("sm", "wfm", "mae", "avgiou", "ori_mae", "accuracy")


def close(got, want, rtol, floor=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max() + floor)


def gap(a, b):
    assert set(a) == set(b)
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


# ----------------------------------------------------------------- the rules


def _jax_kind(path, ndim):
    spec = param_partition_spec(path, ndim)
    return {P(): None, P(None, "model"): "column", P("model"): "column",
            P("model", None): "row"}[spec]


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_partition_kind_matches_jax_rules(size):
    """Every parameter of the cascade (the full one built on the meta
    device) has the partition kind of the JAX package's rule for its flax
    path (the converter's map between the two names)."""
    cfg = CascadeConfig.tiny() if size == "tiny" else CascadeConfig.full()
    with torch.device("meta"):
        model = OVCOSCascade(cfg)
    params = dict(model.named_parameters())
    kinds = {"column": 0, "row": 0, None: 0}
    seen = set()
    for tk, fp, _ in cascade_key_map(cfg):
        if tk not in params:  # pe_layer's Gaussian matrix: a buffer, replicated
            assert param_partition_kind(tk) is None
            continue
        kind = param_partition_kind(tk)
        assert kind == _jax_kind(fp, params[tk].ndim), (tk, fp)
        kinds[kind] += 1
        seen.add(tk)
    assert seen == set(params)
    depth = cfg.encoder.depth + cfg.clip.vision_layers + cfg.clip.transformer_layers
    # per block: qkv weight + bias, MLP-up weight + bias (column), out-proj and
    # MLP-down weights (row); the decoder: 5 attentions a layer + the final one
    dec_attn = 5 * cfg.decoder.transformer.depth + 1
    assert kinds["column"] == 4 * depth + 6 * dec_attn + 2 * cfg.decoder.transformer.depth
    assert kinds["row"] == 2 * depth + dec_attn + cfg.decoder.transformer.depth


@pytest.mark.parametrize("n", [2, 4])
def test_head_aligned_shards_gather_to_the_identity(n):
    """Sharding every tensor of the tiny cascade's state over n model ranks
    and gathering the shards back is the identity; each rank's packed qkv /
    in_proj shard is [q | k | v] of its own whole heads."""
    model = build_cascade(CascadeConfig.tiny(), "cpu", seed=4)
    sd = model.state_dict()
    packed = 0
    for name, t in sd.items():
        shards = [shard_tensor(t, name, n, m) for m in range(n)]
        assert torch.equal(unshard_tensor(shards, name), t), name
        if name.endswith(("qkv.weight", "in_proj.weight", "in_proj_weight")):
            packed += 1
            D = t.shape[0] // 3
            for m, s in enumerate(shards):
                for part in range(3):  # q, k, v of heads [m h/n, (m+1) h/n)
                    want = t[part * D + m * D // n: part * D + (m + 1) * D // n]
                    assert torch.equal(s[part * D // n:(part + 1) * D // n], want), name
    cfg = CascadeConfig.tiny()  # one a SAM, CLIP vision and CLIP text block
    assert packed == cfg.encoder.depth + cfg.clip.vision_layers + cfg.clip.transformer_layers


def test_tp_config_refuses_widths_it_cannot_split():
    check_tp_config(CascadeConfig.full(), 4)
    with pytest.raises(ValueError, match=r"CLIP text heads \(12\)"):
        check_tp_config(CascadeConfig.full(), 8)
    with pytest.raises(ValueError, match=r"SAM heads \(4\)"):
        check_tp_config(CascadeConfig.tiny(), 3)
    from camouflaged_vlm_tpu_torch.cli import train as train_cli

    with pytest.raises(SystemExit):
        train_cli.parse_args(["--dataset-info", "x.yaml", "--n-model", "2"])


def _mlp_inputs(seed=0, B=2, S=5, K=16, H=32):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s, std=1.0: torch.randn(*s, generator=gen) * std  # noqa: E731
    return (r(B, S, K), 1 + 0.1 * r(K), 0.1 * r(K), r(H, K, std=0.2), r(H, std=0.1),
            r(K, H, std=0.2), r(K, std=0.1))


@pytest.mark.parametrize("activation", ["gelu_tanh", "quick_gelu"])
def test_ln_mlp_without_residual_is_the_residual_form_minus_x(activation):
    """The plain `ln_mlp_residual_bt` with residual=False equals the
    residual form minus x; its backward equals the residual form's minus g
    in dx, the weight side unchanged; and the autograd Function takes the
    flag to both."""
    a = _mlp_inputs()
    x, g = a[0], torch.randn(a[0].shape, generator=torch.Generator().manual_seed(9))
    kw = dict(eps=1e-6, activation=activation)
    full = linear.ln_mlp_residual_bt_ref(*a, **kw)
    part = linear.ln_mlp_residual_bt_ref(*a, residual=False, **kw)
    close(part, full - x, 1e-6, floor=1e-7)
    gf = linear.ln_mlp_residual_bt_bwd_ref(*a, g, **kw)
    gp = linear.ln_mlp_residual_bt_bwd_ref(*a, g, residual=False, **kw)
    close(gp[0], gf[0] - g, 1e-6, floor=1e-7)
    for u, v in zip(gp[1:], gf[1:]):
        assert torch.equal(u, v)
    leaves = [t.clone().requires_grad_(True) for t in a]
    out = linear.ln_mlp_residual_bt(*leaves, residual=False, **kw)
    close(out.detach(), part, 0.0)
    got = torch.autograd.grad(out, leaves, g)
    for u, v in zip(got, gp):
        close(u, v, 1e-6, floor=1e-7)
    # in bf16 the partial is fp32 and unrounded: x added to it and rounded
    # once is the residual form, bit for bit
    ab = [a[0].bfloat16(), a[1], a[2], *(t.bfloat16() for t in a[3:])]
    part16 = linear.ln_mlp_residual_bt_ref(*ab, residual=False, **kw)
    assert part16.dtype == torch.float32
    full16 = linear.ln_mlp_residual_bt_ref(*ab, **kw)
    assert torch.equal((part16 + ab[0].float()).bfloat16(), full16)


def test_data_parallel_rejects_indivisible_buckets():
    """A bucket the data axis does not divide is refused at construction
    (before any collective), as the JAX engine refuses it."""
    cfg = CascadeConfig.tiny()
    mesh = Mesh(n_data=2, n_model=1, data_rank=0, model_rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        InferenceEngine(build_cascade(cfg, "cpu"), cfg,
                        make_bank_inputs(cfg, cases.CLASSNAMES), cases.CLASSNAMES,
                        ServeConfig(buckets=(1, 4)), mesh=mesh)


# ------------------------------------------------------------ two ranks


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo

    root = tmp_path_factory.mktemp("ovcamo")
    return write_synthetic_ovcamo(str(root), n_train=4, n_test=3,
                                  sizes=((60, 80), (64, 64), (90, 70)))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, dataset):
    work = tmp_path_factory.mktemp("two_ranks")
    ranks = g.spawn_ranks(2, cases.two_rank_cases, str(work), dataset)
    return {"work": str(work), "rank1": ranks[1], **ranks[0]}


@pytest.mark.parametrize("case", list(cases.STEP_CASES))
def test_train_step_on_two_ranks_matches_one_process(two_ranks, case):
    """The (2, 1) and (1, 2) train steps (with accumulation, the balanced
    BCE and remat) against the same step in one process: the counterparts
    of test_multihost.py's and test_train.py's dp-mesh equalities."""
    _, _, kw, remat = cases.STEP_CASES[case]
    cfg = cases.tiny(remat)
    ref = g.train_step_case(cfg, g.dryrun_batch(cfg, cases.STEP_ROWS), **kw)
    got = two_ranks[case]
    assert abs(got["metrics"][0]["loss"] - ref["metrics"][0]["loss"]) < g.DLOSS_BOUND
    assert gap(got["params"], ref["params"]) < g.DPARAMS_BOUND
    # the step moved the trainable parameters, the prompt generator's too
    start = build_cascade(cfg, "cpu", 0).state_dict()
    name = "image_encoder.prompt_generator.lightweight_mlp_0.0.weight"
    assert float(np.abs(got["params"][name] - start[name].numpy()).max()) > 1e-6


def test_checkpoint_of_one_mesh_resumes_on_another(two_ranks):
    """A (2, 1) run's checkpoint (the full state, rank 0's file) restored on
    (1, 2) continues the run: its second step equals one process's."""
    cfg = cases.tiny()
    ref = g.train_step_case(cfg, g.dryrun_batch(cfg, cases.STEP_ROWS), steps=2)
    assert two_ranks["resume"]["start"] == 1
    assert gap(two_ranks["resume"]["params"], ref["params"]) < g.DPARAMS_BOUND
    saved = torch.load(os.path.join(two_ranks["work"], "ckpt_resume.pt"), weights_only=True)
    want = build_cascade(cfg, "cpu").state_dict()
    assert {k: v.shape for k, v in saved["model"].items()} == {k: v.shape
                                                              for k, v in want.items()}


@pytest.mark.parametrize("mesh,tol", [("dp", 1e-6), ("tp", 5e-4)])
def test_data_parallel_eval_matches_single_device(two_ranks, dataset, mesh, tol):
    """evaluate() on (2, 1) (a short last batch padded) and on (1, 2)
    equals one device's, the counterpart of test_data_pipeline.py's."""
    import yaml

    from camouflaged_vlm_tpu_torch.cli.evaluate import evaluate
    from camouflaged_vlm_tpu_torch.data.ovcamo import OVCamoIndex

    cfg = cases.tiny()
    with open(dataset) as f:
        index = OVCamoIndex.from_dataset_info(yaml.safe_load(f), "test")
    single = evaluate(build_cascade(cfg, "cpu", 0), cfg, make_bank_inputs(cfg, index.classes),
                      index, batch_size=2, num_workers=2)
    got = two_ranks[f"evaluate_{mesh}"]
    assert got["images"] == single["images"] == len(index) == 3
    for key in EVAL_KEYS:
        assert abs(single[key] - got[key]) <= tol, (key, single[key], got[key])


def test_data_parallel_engine_matches_single(two_ranks):
    """Four requests on one sharded bucket of a (2, 1) engine give the
    single-device engine's results."""
    cfg = cases.tiny()
    got = two_ranks["engine"]
    assert got["batches"] == 1  # all four rode one sharded batch
    eng = InferenceEngine(build_cascade(cfg, "cpu", 0), cfg,
                          make_bank_inputs(cfg, cases.CLASSNAMES), cases.CLASSNAMES,
                          ServeConfig(buckets=(1,), max_delay_ms=1.0))
    try:
        inp, cimg = cases.rand_requests(cfg, 4)
        for i, (probs, pred, score) in enumerate(got["results"]):
            p1, d1, s1 = eng.submit(inp[i], cimg[i]).result(timeout=120)
            np.testing.assert_allclose(probs.astype(np.float32), p1.astype(np.float32),
                                       atol=2e-3)
            assert pred == d1
            np.testing.assert_allclose(score, s1, rtol=1e-4, atol=1e-5)
    finally:
        eng.close()


def test_distributed_train_cli_matches_one_process(two_ranks, dataset, tmp_path, monkeypatch):
    """The train CLI with --distributed on two ranks (a (2, 1) mesh) trains
    as one process does; rank 0 alone logs and writes TensorBoard scalars,
    one checkpoint of each kind."""
    from camouflaged_vlm_tpu_torch.cli import train as cli

    got = two_ranks["train_cli"]
    assert "data=2, model=1" in got["mesh"]
    assert got["writers"] == [3] and two_ranks["rank1"]["train_cli"]["writers"] == []
    monkeypatch.setattr(cli, "tensorboard_writer", cases.WriterStub)
    out = cli.main(cases.train_cli_args(dataset, str(tmp_path / "one")))
    ref = {n: p.detach().numpy() for n, p in out["model"].named_parameters() if p.requires_grad}
    assert gap(got["params"], ref) < g.DPARAMS_BOUND
    assert abs(got["val_mae"] - out["validations"][0]["mae"]) < 1e-6
    save = os.path.join(two_ranks["work"], "cli")
    assert sorted(f for f in os.listdir(save) if f.endswith(".pt")) == ["ckpt_best.pt",
                                                                        "ckpt_last.pt"]
    log = open(os.path.join(save, "log.txt")).read()
    assert log.count("epoch 1/1 ") == 1 and "[train] mesh data=2 x model=1 (gloo)" in log


# ----------------------------------------------------------- four ranks


@pytest.fixture(scope="module")
def slice_2x2():
    """The 8-head slice in both packages on the same weights (the JAX
    params drawn with numpy, converted), a batch of 2, and the (2, 2) step
    on four ranks."""
    jenc = j_sam.SamEncoderConfig.tiny(attn_impl="flash", **ENC_8)
    jcfg = dataclasses.replace(JCascadeConfig.tiny(), inp_size=jenc.img_size, encoder=jenc,
                               clip=JClipConfig.tiny(**CLIP_8x16))
    jmodel = JCascade(jcfg)
    jbank = j_make_bank_inputs(jcfg, cases.CLASSNAMES)
    bank = (jbank["prefix"], jbank["suffix"], jbank["eot_indices"], jbank["bank_features"])
    cfg = dataclasses.replace(CascadeConfig.tiny(), inp_size=jenc.img_size,
                              encoder=SamEncoderConfig.tiny(attn_impl="flash", **ENC_8),
                              clip=AlphaClipConfig.tiny(**CLIP_8x16))
    batch = g.dryrun_batch(cfg, 2, seed=1)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, batch["inp"], batch["clip_image"], batch["clip_mask"], *bank,
                              method=jmodel.infer_cascade), jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)

    def fill(path, sd):
        if str(path[-1].key) == "scale":
            return (1.0 + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)
        if str(path[-1].key) == "logit_scale":
            return np.full(sd.shape, np.log(1 / 0.07), np.float32)
        return (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    state = state_dict_from_jax_params(params, cfg)
    got = g.spawn_ranks(4, cases.four_rank_step, cfg, batch, state)[0]
    return jmodel, params, bank, cfg, batch, state, got


def test_2x2_train_step_matches_one_process(slice_2x2):
    _, _, _, cfg, batch, state, got = slice_2x2
    ref = g.train_step_case(cfg, batch, classnames=cases.CLASSNAMES, state=state)
    assert abs(got["metrics"][0]["loss"] - ref["metrics"][0]["loss"]) < g.DLOSS_BOUND
    assert gap(got["params"], ref["params"]) < g.DPARAMS_BOUND


def test_2x2_train_step_matches_jax_one_device(slice_2x2):
    """The (2, 2) step's loss and its synchronised trainable gradients
    against the JAX package's value_and_grad on one device, same weights
    and batch (the fused SAM path sharded head-aligned, 4 heads a rank)."""
    jmodel, params, bank, cfg, batch, _, got = slice_2x2
    jtf = jmodel.apply(params, *bank, method=jmodel.encode_class_text_features)
    trainable, frozen = partition_params(jax.tree.map(jnp.asarray, params))

    def loss(t):
        masks, edges = jmodel.apply(combine_params(t, frozen), batch["inp"],
                                    batch["clip_image"], batch["clip_mask"], jtf,
                                    method=jmodel.forward_with_text)
        return jtrain.segmentation_loss(masks, edges, batch["gt"], "iou")[0]

    jl, jg = jax.jit(jax.value_and_grad(loss))(trainable)
    close(got["metrics"][0]["loss"], jl, 1e-5)
    seen = 0
    for tk, fp, kind in cascade_key_map(cfg):
        key = ("params",) + tuple(fp.split("/"))
        if tk in got["grads"]:
            assert key in jg, tk
            close(got["grads"][tk], _inverse_transform(kind, np.asarray(jg[key], np.float32)),
                  1e-4, floor=1e-8)
            seen += 1
    assert seen == len(got["grads"]) > 40
