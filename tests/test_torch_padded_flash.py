"""SAM's fused 'flash' path off the compact carry in the PyTorch port against
the JAX package, on the CPU.

With num_heads % 8 == 0 and a window the compact layout cannot hold (15 or
more), the windowed blocks run in the padded window carry; global blocks of
at most 512 tokens leave the global kernel (#17). Both packages then take
the same branches (`Attention.fused_route`): H+W <= 32 through the padded
windows kernel (#12, `flash_qkv_packed_windows`), H+W > 32 through the
head-leading kernel (#11, `flash_qkv_relpos_windows`) and its out-projection
with the residual (#8, `proj_from_heads_res`). Here: the plain versions of
#12, #11, #8, #9 against the JAX wrappers (their `ref` on the CPU), #19's
against the JAX kernel in Pallas interpret mode, the 8-head encoder at four
geometries (window 16 and 15 at 256 px, 17 at 288 px, 4 at 320 px) with and
without the rel cache, the tiny cascade and one train step at window 17,
and `evaluate()` at window 16 (JAX's rel cache asserts H+W <= 32, so its
evaluate cannot run window 17).

Tolerances, relative to the output's largest magnitude: ops 1e-5 (fp32 on
both sides, differing only in summation order); encoders, the cascade and
the train step 1e-4 (the same through two blocks, the decoder and the
backward; gradients with an absolute floor of 1e-8 as in
`tests/test_torch_train.py`); `evaluate()` as `tests/test_torch_eval.py`
holds it (classification exact, mask metrics 5e-3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from camouflaged_vlm_tpu import train as jtrain  # noqa: E402
from camouflaged_vlm_tpu.cli import evaluate as j_evaluate  # noqa: E402
from camouflaged_vlm_tpu.data import ovcamo as j_ovcamo  # noqa: E402
from camouflaged_vlm_tpu.factory import attach_rel_cache as j_attach_rel_cache  # noqa: E402
from camouflaged_vlm_tpu.factory import make_bank_inputs as j_make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu.models import CascadeConfig as JCascadeConfig  # noqa: E402
from camouflaged_vlm_tpu.models import OVCOSCascade as JCascade  # noqa: E402
from camouflaged_vlm_tpu.models import sam_encoder as j_sam  # noqa: E402
from camouflaged_vlm_tpu.ops import flash_attention as j_fa  # noqa: E402
from camouflaged_vlm_tpu.ops import linear as j_lin  # noqa: E402
from camouflaged_vlm_tpu.train.train_step import combine_params, partition_params  # noqa: E402

from camouflaged_vlm_tpu_torch import train  # noqa: E402
from camouflaged_vlm_tpu_torch.cli import evaluate  # noqa: E402
from camouflaged_vlm_tpu_torch.data import ovcamo  # noqa: E402
from camouflaged_vlm_tpu_torch.data.synthetic import write_synthetic_ovcamo  # noqa: E402
from camouflaged_vlm_tpu_torch.factory import (  # noqa: E402
    attach_rel_cache,
    build_cascade,
    make_bank_inputs,
)
from camouflaged_vlm_tpu_torch.io.convert import (  # noqa: E402
    _inverse_transform,
    cascade_key_map,
    load_jax_params,
)
from camouflaged_vlm_tpu_torch.models import CascadeConfig, SamEncoderConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.models import sam_encoder  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import linear as lin  # noqa: E402

OP_RTOL, MODULE_RTOL = 1e-5, 1e-4
HEADS, HD = 8, 8
CLASSES = ["cat", "owl", "bat", "moth"]
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
J = jnp.asarray


def close(got, want, rtol, floor=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max() + floor)


def rnd(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------------ the kernels


@pytest.mark.parametrize("B,nwin,win", [(2, 3, 4), (1, 2, 16)])
def test_flash_qkv_packed_windows_matches_jax(rng, B, nwin, win):
    """#12's plain version: window-major rel, 32 lanes per head."""
    Nw = win * win
    qkv, rel = rnd(rng, B, nwin, Nw, 3 * HEADS * HD), rnd(rng, B, nwin, Nw, HEADS * 32)
    sel32 = fa.make_rel_scatter32(win)
    want = j_fa.flash_qkv_packed_windows(J(qkv), J(rel), J(sel32.numpy()), HD ** -0.5, HEADS, HD)
    got = fa.flash_qkv_packed_windows(T(qkv), T(rel), sel32, HD ** -0.5, HEADS, HD)
    close(got, want, OP_RTOL)


@pytest.mark.parametrize("B,nwin,H,W", [(1, 2, 17, 17), (2, 3, 5, 6)])
def test_flash_qkv_relpos_windows_matches_jax(rng, B, nwin, H, W):
    """#11's plain version: the 5D qkv view, rel per head, head-leading out."""
    N = H * W
    qkv = rnd(rng, B, nwin, N, 3 * HEADS, HD)
    rel = rnd(rng, B, nwin, N, HEADS, H + W, scale=0.5)
    sel = fa.make_rel_scatter(H, W)
    want = j_fa.flash_qkv_relpos_windows(J(qkv), J(rel), J(sel.numpy()), HD ** -0.5)
    close(fa.flash_qkv_relpos_windows(T(qkv), T(rel), sel, HD ** -0.5, H, W), want, OP_RTOL)


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels (attention and linear) in
    interpret mode on the CPU."""
    orig = j_fa.pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*args, **kw)

    monkeypatch.setattr(j_fa.pl, "pallas_call", interp)
    monkeypatch.setattr(j_fa, "_on_cpu", lambda: False)
    monkeypatch.setattr(j_lin, "_on_cpu", lambda: False)


@pytest.mark.parametrize("H,W,block_q", [(8, 8, 32), (6, 10, 32)])
def test_flash_qkv_relpos_global_matches_jax_kernel(rng, interpret, H, W, block_q):
    """#19's plain version against the TPU kernel (two head groups; query
    tiles of 32, or one tile where 32 does not divide N)."""
    heads, d = 4, 16
    N = H * W
    qkv = rnd(rng, 2, N, 3 * heads, d)
    rel = rnd(rng, 2, N, heads, H + W, scale=0.5)
    sel = fa.make_rel_scatter(H, W)
    want = j_fa.flash_qkv_relpos_global(J(qkv), J(rel), J(sel.numpy()), d ** -0.5,
                                        block_q=block_q, head_group=2)
    close(fa.flash_qkv_relpos_global(T(qkv), T(rel), sel, d ** -0.5, H, W), want, OP_RTOL)


def one_pass_relpos(qkv, rel, scale, H, W, tile=64):
    """`csrc/qkv_relpos.cu`'s formulation of #11 in bf16: q * bf16(scale)
    rounded to bf16 (scale None: q as given, #10's split front end, whose q
    arrives scaled); per 64-key tile the fp32 scores plus the fp32 sum of
    the key's two bf16 rel lanes (k // W, H + k % W); the online softmax
    (running max and sum in fp32); P = exp(s - m_running) rounded to bf16
    unnormalised, O += P V in fp32; O / l rounded to bf16 at the end.
    qkv (B, nwin, N, 3*heads, d), rel (B, nwin, N, heads, H+W) ->
    (B, heads, nwin, N, d)."""
    bf = torch.bfloat16
    heads = qkv.shape[-2] // 3
    q, k, v = (qkv[..., i * heads:(i + 1) * heads, :].movedim(-2, 2).float()
               for i in range(3))  # (B, nwin, heads, N, d)
    if scale is not None:
        q = (q * torch.tensor(scale, dtype=bf).float()).to(bf).float()
    key = torch.arange(H * W)
    relh = rel.movedim(-2, 2).float()
    bias = relh[..., key // W] + relh[..., H + key % W]  # (B, nwin, heads, N, N)
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for t in range(0, H * W, tile):
        s = q @ k[..., t:t + tile, :].transpose(-1, -2) + bias[..., t:t + tile]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + p.to(bf).float() @ v[..., t:t + tile, :]
        m = m_new
    return (o / l).to(bf).transpose(1, 2)


def kernel_rel_err(got, want):
    """max|d| / max|ref| and mean|d| / mean|ref|, the card's kernel gate."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    return d.max() / np.abs(want).max(), d.mean() / np.abs(want).mean()


@pytest.mark.parametrize("H,W,nwin", [(17, 17, 2), (20, 20, 1)])
def test_one_pass_relpos_rounding_matches_jax(rng, interpret, H, W, nwin):
    """Moving the one rounding point (P rounded unnormalised, O divided by
    the fp32 row sum at the end) keeps #11/#19 inside the card's gate of
    1e-2 max and mean relative (chip_smoke.KERNEL_REL_BOUND), in bf16
    against the JAX package: at window 17 (289 keys: four 64-key tiles and
    a ragged one) through `flash_qkv_relpos_windows` (its XLA reference on
    the CPU), and on a 20 x 20 grid (400 keys) through
    `flash_qkv_relpos_global` (the TPU kernel in interpret mode)."""
    heads, d = 2, 80
    N = H * W
    qkv = rnd(rng, 1, nwin, N, 3 * heads, d).astype(jnp.bfloat16)
    rel = rnd(rng, 1, nwin, N, heads, H + W, scale=0.5).astype(jnp.bfloat16)
    sel = fa.make_rel_scatter(H, W).numpy()
    scale = d ** -0.5
    got = one_pass_relpos(T(qkv.astype(np.float32)).to(torch.bfloat16),
                          T(rel.astype(np.float32)).to(torch.bfloat16), scale, H, W)
    if nwin > 1:
        want = j_fa.flash_qkv_relpos_windows(J(qkv), J(rel), J(sel, jnp.bfloat16), scale)
    else:
        want = j_fa.flash_qkv_relpos_global(J(qkv[:, 0]), J(rel[:, 0]), J(sel, jnp.bfloat16),
                                            scale)[:, :, None]
    assert want.dtype == jnp.bfloat16 and got.shape == want.shape
    max_rel, mean_rel = kernel_rel_err(got.float().numpy(), want.astype(jnp.float32))
    assert max_rel < 1e-2 and mean_rel < 1e-2, (max_rel, mean_rel)


@pytest.mark.parametrize("H,W", [(14, 14), (8, 64), (5, 6)])
def test_one_pass_relpos_split_matches_jax_kernel(rng, interpret, H, W):
    """#10 on the split front end of the same one pass: q, k, v (BB, N, 64)
    apart and q pre-scaled (no q rounding), seen as the packed form with
    heads = nwin = 1, in bf16 against the TPU kernel `flash_attention_relpos`
    in interpret mode, inside the card's gate of 1e-2 max and mean relative:
    ViT-B's 14 x 14 windows (the bias on the tensor cores, 196 keys: three
    64-key tiles and a ragged one), an 8 x 64 grid (W the key tile: rel_w in
    registers) and a ragged 5 x 6 grid. (`one_pass_relpos`, extended with
    scale None.)"""
    BB, d, N = 3, 64, H * W
    bf = torch.bfloat16
    q = rnd(rng, BB, N, d, scale=d ** -0.5).astype(jnp.bfloat16)
    k, v = (rnd(rng, BB, N, d).astype(jnp.bfloat16) for _ in range(2))
    rel = rnd(rng, BB, N, H + W, scale=0.5).astype(jnp.bfloat16)
    sel = fa.make_rel_scatter(H, W).numpy()
    tq, tk, tv, trel = (T(a.astype(np.float32)).to(bf) for a in (q, k, v, rel))
    got = one_pass_relpos(torch.stack((tq, tk, tv), dim=-2)[:, None], trel[:, None, :, None],
                          None, H, W).reshape(BB, N, d)
    want = j_fa.flash_attention_relpos(J(q), J(k), J(v), J(rel), J(sel, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16 and got.shape == want.shape
    max_rel, mean_rel = kernel_rel_err(got.float().numpy(), want.astype(jnp.float32))
    assert max_rel < 1e-2 and mean_rel < 1e-2, (max_rel, mean_rel)


def head_split_k_walk(x, w, b, res=None):
    """`csrc/gemm_sm90.cuh`'s K walk of #8/#9 (the head-leading A) in torch,
    k steps of 64 columns: each head's first d // 64 steps of 64 columns,
    then the k16 slices of the heads' last d % 64 columns (zero-filled past
    d), four a step wherever their heads lie; products summed in fp32 from
    the bf16 operands, step by step; bias (and residual) added to the fp32
    sum, one rounding. x (B, heads, T, S, d), w (N, heads*d) -> (B, T, S, N)."""
    B, heads, T_, S, d = x.shape
    N = w.shape[0]
    rows = x.reshape(B, heads, T_ * S, d).float()
    wh = w.float().reshape(N, heads, d)
    acc = torch.zeros(B, T_ * S, N)
    for h in range(heads):
        for j0 in range(0, d // 64 * 64, 64):
            acc += rows[:, h, :, j0:j0 + 64] @ wh[:, h, j0:j0 + 64].T
    slices = [(h, j0) for h in range(heads) for j0 in range(d // 64 * 64, d, 16)]
    for q0 in range(0, len(slices), 4):
        a, wt = torch.zeros(B, T_ * S, 4, 16), torch.zeros(N, 4, 16)
        for i, (h, j0) in enumerate(slices[q0:q0 + 4]):
            n = min(16, d - j0)
            a[:, :, i, :n] = rows[:, h, :, j0:j0 + n]
            wt[:, i, :n] = wh[:, h, j0:j0 + n]
        acc += a.reshape(B, T_ * S, 64) @ wt.reshape(N, 64).T
    acc += b.float()
    if res is not None:
        acc += res.float().reshape(B, T_ * S, N)
    return acc.to(x.dtype).reshape(B, T_, S, N)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("d", [80, 64, 8])
def test_head_split_k_walk_matches_jax_kernel(rng, interpret, d, residual):
    """The kernel's walk of #8 (with the residual) and #9 in bf16 against the
    TPU kernels `proj_from_heads_res` / `proj_from_heads` in interpret mode,
    inside the card's gate of 1e-2 max and mean relative: d = 80 (a step of
    64 columns a head, then the three heads' last 16 as k16 slices in one
    step, a quarter of it zeros), 64 (one step a head) and 8 (one slice a
    head, half of it zero fill)."""
    B, heads, T_, S, N = 2, 3, 2, 37, 24
    bf = torch.bfloat16
    x = rnd(rng, B, heads, T_, S, d).astype(jnp.bfloat16)
    kernel = rnd(rng, heads * d, N, scale=0.1).astype(jnp.bfloat16)
    b = rnd(rng, N, scale=0.1).astype(jnp.bfloat16)
    res = rnd(rng, B, T_, S, N).astype(jnp.bfloat16) if residual else None
    t = lambda a: T(a.astype(np.float32)).to(bf)  # noqa: E731
    w_j = J(kernel).reshape(heads, d, N)
    got = head_split_k_walk(t(x), t(kernel).T, t(b), None if res is None else t(res))
    if residual:
        want = j_lin.proj_from_heads_res(J(x), w_j, J(b)[None], J(res))
    else:
        want = j_lin.proj_from_heads(J(x), w_j, J(b)[None])
    assert want.dtype == jnp.bfloat16 and got.shape == want.shape
    max_rel, mean_rel = kernel_rel_err(got.float().numpy(), want.astype(jnp.float32))
    assert max_rel < 1e-2 and mean_rel < 1e-2, (max_rel, mean_rel)


@pytest.mark.parametrize("residual", [True, False])
def test_proj_from_heads_matches_jax(rng, residual):
    """#8 (with the residual) and #9: the port's (out, heads*d) nn.Linear
    weight against JAX's (heads, d, out) view of the same kernel."""
    B, T_, S, out = 2, 3, 17, 24
    x, kernel, b = rnd(rng, B, HEADS, T_, S, HD), rnd(rng, HEADS * HD, out), rnd(rng, out)
    w_j = J(kernel.reshape(HEADS, HD, out))
    if residual:
        res = rnd(rng, B, T_, S, out)
        want = j_lin.proj_from_heads_res(J(x), w_j, J(b[None]), J(res))
        got = lin.proj_from_heads_res(T(x), T(kernel.T), T(b), T(res))
    else:
        want = j_lin.proj_from_heads(J(x), w_j, J(b[None]))
        got = lin.proj_from_heads(T(x), T(kernel.T), T(b))
    close(got, want, OP_RTOL)


def test_rel_packed32_matches_jax(rng):
    H = W = 16
    q = rnd(rng, 2, 3, H, W, HEADS, HD)
    rh, rw = rnd(rng, 2 * H - 1, HD), rnd(rng, 2 * W - 1, HD)
    jrel, jsel = j_sam.rel_packed32(J(q), J(rh), J(rw), H, W)
    rcomb = sam_encoder.make_rcomb(H, W, T(rh), T(rw), torch.float32)
    for tables in (None, rcomb):
        rel, sel = sam_encoder.rel_packed32(T(q), T(rh), T(rw), H, W, rcomb=tables)
        close(rel, jrel, OP_RTOL)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))


# -------------------------------------------------- encoder and cascade


def random_params(shapes, seed=0):
    """numpy params over an eval_shape tree: LayerNorm scales near 1, the
    logit scale at its init, the rel-pos tables large enough for the bias to
    matter, everything else N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        name = str(path[-1].key)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)
        if name == "logit_scale":
            return np.full(sd.shape, np.log(1 / 0.07), np.float32)
        if name.startswith("rel_pos"):
            return (0.5 * rng.standard_normal(sd.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def fused_encoder(img_size, window_size):
    """The 8-head fused 'flash' SAM of two blocks, the second global."""
    return dict(attn_impl="flash", embed_dim=64, num_heads=HEADS, prompt_scale_factor=8,
                depth=2, global_attn_indexes=(1,), img_size=img_size, window_size=window_size)


def make_pair(enc, seed=2, B=2):
    """(JAX cascade config, model and params, the port's config and cascade
    with the params loaded strictly, inputs, bank)."""
    jenc = j_sam.SamEncoderConfig.tiny(**enc)
    jcfg = dataclasses.replace(JCascadeConfig.tiny(), inp_size=jenc.img_size, encoder=jenc)
    jmodel = JCascade(jcfg)
    jbank = j_make_bank_inputs(jcfg, CLASSES, seed=3)
    bank = (jbank["prefix"], jbank["suffix"], jbank["eot_indices"], jbank["bank_features"])
    rng = np.random.default_rng(seed)
    inputs = (
        rng.standard_normal((B, jcfg.inp_size, jcfg.inp_size, 3)).astype(np.float32),
        rng.standard_normal((B, jcfg.clip_size, jcfg.clip_size, 3)).astype(np.float32),
        np.full((B, jcfg.clip_size, jcfg.clip_size, 1), 1.923, np.float32),
    )
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, *inputs, *bank, method=jmodel.infer_cascade),
        jax.random.PRNGKey(0))
    params = random_params(shapes, seed)
    cfg = dataclasses.replace(CascadeConfig.tiny(), inp_size=jenc.img_size,
                              encoder=SamEncoderConfig.tiny(**enc))
    model = build_cascade(cfg, "cpu")
    load_jax_params(model, params, cfg)
    return jcfg, jmodel, params, cfg, model, inputs, bank


class _Counting:
    """Counts the calls of a kernel wrapper that the encoder makes."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


WRAPPERS = ("flash_qkv_packed_windows_s", "flash_qkv_packed_windows",
            "flash_qkv_relpos_windows", "proj_from_heads_res", "flash_qkv_packed_global")
# (id, img_size, window, the windowed block's route, the global block's,
#  calls of each wrapper in one encoder pass)
GEOMETRIES = [
    ("window 16, 256 px", 256, 16, "packed", "packed", (0, 2, 0, 0, 0)),
    ("window 15, 256 px (padded, masked)", 256, 15, "packed", "packed", (0, 2, 0, 0, 0)),
    ("window 17, 288 px", 288, 17, "relpos", "relpos", (0, 0, 2, 2, 0)),
    ("window 4, 320 px (compact)", 320, 4, "compact", "relpos", (1, 0, 1, 1, 0)),
]


@pytest.mark.parametrize("name,img,win,route_w,route_g,calls", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_fused_encoder_matches_jax(monkeypatch, name, img, win, route_w, route_g, calls):
    """The port's fused 'flash' encoder against JAX's on the same converted
    weights (loaded strictly: the rel-pos shapes follow the window and the
    grid), without and with the rel cache; JAX's with its cache too where
    it can build one (window <= 16). Each block takes JAX's branch."""
    jcfg, jmodel, params, cfg, model, inputs, _ = make_pair(fused_encoder(img, win))
    enc = model.image_encoder
    assert [b.attn.fused_route for b in enc.blocks] == [route_w, route_g]
    hd = cfg.encoder.embed_dim // cfg.encoder.num_heads
    grid = img // cfg.encoder.patch_size
    assert tuple(enc.blocks[0].attn.rel_pos_h.shape) == (2 * win - 1, hd)
    assert tuple(enc.blocks[1].attn.rel_pos_w.shape) == (2 * grid - 1, hd)
    run = jax.jit(lambda v, a: jmodel.apply(
        v, a, method=lambda m, a: m.image_encoder(a, interm=True)))
    want, want_interm = run(params, inputs[0])
    if win <= 16:
        close(run(j_attach_rel_cache(params, jcfg), inputs[0])[0], want, MODULE_RTOL)
    else:  # the JAX fault the port does not copy
        with pytest.raises(AssertionError):
            j_attach_rel_cache(params, jcfg)
    counters = {w: _Counting(getattr(sam_encoder, w)) for w in WRAPPERS}
    for w, c in counters.items():
        monkeypatch.setattr(sam_encoder, w, c)
    with torch.no_grad():
        for cached in (False, True):
            if cached:
                attach_rel_cache(model)
            got, interm = enc(T(inputs[0]))
            close(got, want, MODULE_RTOL)
            assert len(interm) == len(want_interm) == 1
            close(interm[0], want_interm[0], MODULE_RTOL)
    assert all(b.attn.rel_cache is not None for b in enc.blocks)
    assert tuple(counters[w].calls for w in WRAPPERS) == tuple(2 * c for c in calls)
    assert float(np.asarray(want).std()) > 1e-2


def test_window_17_cascade_matches_jax():
    """The tiny cascade at window 17 (#11 and #8 in both blocks) through
    `infer_cascade_with_text`, the rel cache attached."""
    _, jmodel, params, cfg, model, inputs, bank = make_pair(fused_encoder(288, 17))
    jtf = jmodel.apply(params, *bank, method=jmodel.encode_class_text_features)
    jprobs, jpred, jlogits = jax.jit(lambda p, *a: jmodel.apply(
        p, *a, method=jmodel.infer_cascade_with_text))(params, *inputs, jtf)
    attach_rel_cache(model)
    with torch.no_grad():
        tf = model.encode_class_text_features(*map(T, bank))
        probs, pred, logits = model.infer_cascade_with_text(*map(T, inputs), tf)
    close(probs, jprobs, MODULE_RTOL)
    close(logits, jlogits, MODULE_RTOL)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    assert float(np.asarray(jprobs).std()) > 1e-3


def test_window_17_train_step_matches_jax():
    """Loss and every trainable gradient of forward_with_text + the loss at
    window 17: the plain VJPs of #11 and #8 (with the residual) and of the
    LN+mask+qkv kernel against JAX's `value_and_grad`."""
    _, jmodel, params, cfg, model, inputs, bank = make_pair(fused_encoder(288, 17))
    S = cfg.inp_size
    yy, xx = np.mgrid[:S, :S]
    gt = np.stack([((yy - 100 - 40 * i) ** 2 + (xx - 140) ** 2 < 5000) for i in range(2)])
    gt = gt[..., None].astype(np.float32)
    jtf = jmodel.apply(params, *bank, method=jmodel.encode_class_text_features)
    trainable, frozen = partition_params(jax.tree.map(jnp.asarray, params))

    def loss(t):
        masks, edges = jmodel.apply(combine_params(t, frozen), *inputs, jtf,
                                    method=jmodel.forward_with_text)
        return jtrain.segmentation_loss(masks, edges, gt, "iou")[0]

    jl, jg = jax.jit(jax.value_and_grad(loss))(trainable)
    tbank = make_bank_inputs(cfg, CLASSES, seed=3)
    tf = model.encode_class_text_features(tbank["prefix"], tbank["suffix"],
                                          tbank["eot_indices"], tbank["bank_features"])
    attach_rel_cache(model)  # as the train CLI does: the rel-pos parameters are frozen
    params_t = train.trainable_parameters(model)
    masks, edges = model.forward_with_text(*map(T, inputs), tf)
    total, _ = train.segmentation_loss(masks, edges, T(gt))
    total.backward()
    close(total, jl, 1e-5)
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert len(grads) == len(params_t)
    seen = 0
    for tk, fp, kind in cascade_key_map(cfg):
        key = ("params",) + tuple(fp.split("/"))
        assert (key in jg) == (tk in grads), tk
        if tk in grads:
            want = _inverse_transform(kind, np.asarray(jg[key], np.float32))
            got = grads[tk] if grads[tk] is not None else torch.zeros(want.shape)
            close(got, want, MODULE_RTOL, floor=1e-8)
            seen += 1
    assert seen > 40
    pg = grads["image_encoder.prompt_generator.lightweight_mlp_0.0.weight"]
    assert float(pg.abs().max()) > 1e-6  # through both blocks, #11's and #8's VJPs included


def test_evaluate_at_window_16_matches_jax(tmp_path):
    """The port's `evaluate()` against JAX's (both attach their rel cache) on
    a synthetic test split of 3 images, batch 2, the tiny cascade with the
    8-head SAM at window 16 (the padded carry, #12 in both blocks), fp32."""
    info = yaml.safe_load(open(write_synthetic_ovcamo(
        str(tmp_path / "ovcamo"), n_train=0, n_test=3, sizes=((60, 80), (64, 64), (90, 70)))))
    jidx = j_ovcamo.OVCamoIndex.from_dataset_info(info, "test")
    idx = ovcamo.OVCamoIndex.from_dataset_info(info, "test")
    enc = fused_encoder(256, 16)
    jenc = j_sam.SamEncoderConfig.tiny(**enc)
    jcfg = dataclasses.replace(JCascadeConfig.tiny(), inp_size=256, encoder=jenc)
    jmodel = JCascade(jcfg)
    jbank = j_make_bank_inputs(jcfg, jidx.classes, seed=0)
    S, C = jcfg.inp_size, jcfg.clip_size
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, S, S, 3)), jnp.zeros((1, C, C, 3)),
                              jnp.zeros((1, C, C, 1)), jbank["prefix"], jbank["suffix"],
                              jbank["eot_indices"], jbank["bank_features"],
                              method=jmodel.infer_cascade),
        jax.random.PRNGKey(0))
    params = random_params(shapes, seed=5)
    want = j_evaluate.evaluate(jmodel, jcfg, jax.tree.map(jnp.asarray, params), jbank, jidx,
                               batch_size=2, num_workers=2, mask_dtype="float32")
    cfg = dataclasses.replace(CascadeConfig.tiny(), inp_size=256,
                              encoder=SamEncoderConfig.tiny(**enc))
    model = build_cascade(cfg, "cpu")
    load_jax_params(model, params, cfg)
    got = evaluate.evaluate(model, cfg, make_bank_inputs(cfg, idx.classes, seed=0), idx,
                            batch_size=2, num_workers=2, mask_dtype="float32")
    assert all(b.attn.rel_cache is not None for b in model.image_encoder.blocks)
    assert set(got) == set(want)
    assert got["images"] == want["images"] == 3
    for k in ("accuracy", "error_rate", "top5", "macro_f1"):
        assert got[k] == want[k], k
    for k in set(want) - {"images", "images_per_sec", "accuracy", "error_rate", "top5",
                          "macro_f1"}:
        assert abs(got[k] - want[k]) <= 5e-3, (k, got[k], want[k])
    assert 0 < want["ori_sm"] < 1
