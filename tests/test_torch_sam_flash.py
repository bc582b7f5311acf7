"""SAM's 'flash' path in the PyTorch port against the JAX package, on the CPU.

The compact window layout, the rel-factor builders, the plain versions of
the three attention kernels, the encoder and the tiny cascade, all on the
same numpy-drawn inputs and parameters, in fp32. On the CPU the JAX kernel
wrappers run their XLA `ref` formulation, so these tests pin the plain
versions, which the CUDA kernels are held to on the card, to the JAX
package. Every SAM config here has 8 heads (the fused path needs
num_heads % 8 == 0) and a grid with right, bottom and corner edge windows
(grid 5, window 2; grid 10, window 4; grid 9 x 12, window 5).

Tolerances, relative to the output's largest magnitude: data movement is
bit-equal; ops 1e-5 (fp32 on both sides, differing only in summation order);
modules and the slice 1e-4 (the same through several blocks). Both
packages route the global blocks of these grids (at most 512 tokens, H+W
<= 32) through the padded windows kernel (site #12);
`tests/test_torch_padded_flash.py` covers that branch and the padded carry.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from camouflaged_vlm_tpu.factory import attach_rel_cache as j_attach_rel_cache  # noqa: E402
from camouflaged_vlm_tpu.factory import make_bank_inputs as j_make_bank_inputs  # noqa: E402
from camouflaged_vlm_tpu.models import CascadeConfig as JCascadeConfig  # noqa: E402
from camouflaged_vlm_tpu.models import OVCOSCascade as JCascade  # noqa: E402
from camouflaged_vlm_tpu.models import sam_encoder as j_sam  # noqa: E402
from camouflaged_vlm_tpu.models.clip import AlphaClipConfig as JClipConfig  # noqa: E402
from camouflaged_vlm_tpu.ops import compact_window as j_cw  # noqa: E402
from camouflaged_vlm_tpu.ops import flash_attention as j_fa  # noqa: E402
from camouflaged_vlm_tpu.ops import linear as j_lin  # noqa: E402

from camouflaged_vlm_tpu_torch.factory import attach_rel_cache, build_cascade  # noqa: E402
from camouflaged_vlm_tpu_torch.io.convert import load_jax_params  # noqa: E402
from camouflaged_vlm_tpu_torch.models import CascadeConfig, SamEncoderConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.models import sam_encoder  # noqa: E402
from camouflaged_vlm_tpu_torch.models.clip import AlphaClipConfig  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import compact_window as cw  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import linear  # noqa: E402

OP_RTOL, MODULE_RTOL = 1e-5, 1e-4
GEOMS = [(5, 5, 2), (10, 10, 4), (9, 12, 5)]
HEADS, HD = 8, 8
# 8 heads x d 8 for SAM; CLIP 8 x 16 so the JAX side takes its fused branch
ENC_8 = dict(img_size=80, embed_dim=64, num_heads=8, prompt_scale_factor=8)
CLIP_8x16 = dict(vision_width=128, vision_heads=8)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
J = jnp.asarray


def close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def rnd(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def jitted(fn, n_arrays):
    """`fn` compiled once, its arguments after the first `n_arrays` static: a
    small program compiles faster than JAX dispatches it op by op."""
    def call(*args):
        static = tuple(args[n_arrays:])
        return jax.jit(lambda *a: fn(*a, *static))(*args[:n_arrays])
    return call


# ------------------------------------------------------- compact layout


@pytest.mark.parametrize("H,W,win", GEOMS + [(8, 6, 2), (7, 9, 3)])
def test_compact_partition_matches_jax(rng, H, W, win):
    geom, jgeom = cw.CompactGeometry(H, W, win), j_cw.CompactGeometry(H, W, win)
    assert (geom.n_full, geom.n_edge, geom.R_u, geom.E) == (
        jgeom.n_full, jgeom.n_edge, jgeom.R_u, jgeom.E)
    x = rnd(rng, 2, H, W, 6)
    jf, je = j_cw.compact_partition(J(x), jgeom)
    xf, xe = cw.compact_partition(T(x), geom)
    np.testing.assert_array_equal(xf.numpy(), np.asarray(jf))
    assert (xe is None) == (je is None)
    if xe is not None:
        np.testing.assert_array_equal(xe.numpy(), np.asarray(je))
    np.testing.assert_array_equal(cw.compact_unpartition(xf, xe, geom).numpy(), x)
    if geom.has_edge:
        sel, km = cw.edge_consts(geom, torch.float32)
        jsel, jkm = j_cw.edge_consts(jgeom, jnp.float32)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(km.numpy(), np.asarray(jkm))


def test_vit_h_geometry():
    g = cw.CompactGeometry(64, 64, 14)
    assert (g.n_full, g.n_edge, g.R_u, g.E) == (16, 9, 112, 1008)
    assert [(grp.n, grp.nr, grp.nc) for grp in g.edge_groups] == [(4, 14, 8), (4, 8, 14),
                                                                   (1, 8, 8)]
    assert 16 * 196 + g.E == 4144


def _rel_params(rng, win, hd=HD):
    return rnd(rng, 2 * win - 1, hd, scale=0.5), rnd(rng, 2 * win - 1, hd, scale=0.5)


@pytest.mark.parametrize("H,W,win", GEOMS)
def test_edge_rel_lpad_matches_jax(rng, H, W, win):
    """The port's exact-LSE edge rel against JAX's uncached `edge_rel_lpad`
    and its cached `edge_rel_fast` (real rows: the cached path writes -1e30
    into the dummy rows' pad-key lane, the uncached one 0)."""
    geom, jgeom = cw.CompactGeometry(H, W, win), j_cw.CompactGeometry(H, W, win)
    rh, rw = _rel_params(rng, win)
    qkv = rnd(rng, 2, geom.E, 3 * HEADS * HD)
    kb = rnd(rng, HEADS, HD)
    scale = HD ** -0.5
    q = qkv[:, :, : HEADS * HD].reshape(2, geom.E, HEADS, HD)
    got = cw.edge_rel_lpad(T(q), sam_encoder.make_rcomb(win, win, T(rh), T(rw), torch.float32),
                           T(kb), scale, geom)
    want = jitted(j_cw.edge_rel_lpad, 3)(
        J(q), j_sam.make_rcomb(win, win, J(rh), J(rw), jnp.float32), J(kb), scale, jgeom)
    close(got, want, OP_RTOL)
    tables = j_sam.make_redge_tables(win, J(rh), J(rw), HD, jnp.float32, jgeom)
    fast = np.asarray(jitted(j_cw.edge_rel_fast, 3)(J(qkv), tables, J(kb), scale, jgeom,
                                                    HEADS, HD))
    got4 = got.reshape(2, geom.n_edge, geom.R_u, HEADS * 32).numpy()
    off = 0
    for g in geom.edge_groups:
        close(got4[:, off : off + g.n, : g.rows], fast[:, off : off + g.n, : g.rows], OP_RTOL)
        off += g.n


def test_rel_smajor_windows_matches_jax(rng):
    win = 4
    rh, rw = _rel_params(rng, win)
    qkv = rnd(rng, 6, win * win, 3 * HEADS * HD)
    rcomb = sam_encoder.make_rcomb(win, win, T(rh), T(rw), torch.float32)
    close(rcomb, j_sam.make_rcomb(win, win, J(rh), J(rw), jnp.float32), 0)
    rblk = j_sam.make_rblk(win, J(rh), J(rw), HD, jnp.float32)
    jwant, jsel = j_sam.rel_smajor_windows(J(qkv), J(rh), J(rw), win, HEADS, HD)
    jcached, _ = j_sam.rel_smajor_windows(J(qkv), J(rh), J(rw), win, HEADS, HD, rblk=rblk)
    for tables in (None, rcomb):
        got, sel = sam_encoder.rel_smajor_windows(T(qkv), T(rh), T(rw), win, HEADS, HD,
                                                  rcomb=tables)
        close(got, jwant, OP_RTOL)
        close(got, jcached, OP_RTOL)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))


def test_rel_smajor_global_matches_jax(rng):
    H, W = 5, 7
    rh, rw = rnd(rng, 2 * H - 1, HD), rnd(rng, 2 * W - 1, HD)
    q = rnd(rng, 2, H, W, HEADS, HD)
    jwant, jsel = j_sam.rel_smajor_global(J(q), J(rh), J(rw), H, W)
    rcg = j_sam.make_rcomb(H, W, J(rh), J(rw), jnp.float32, lanes=H + W)
    jcached, _ = j_sam.rel_smajor_global(J(q), J(rh), J(rw), H, W, rcg=rcg)
    tables = sam_encoder.global_rel_tables(H, W, T(rh), T(rw), torch.float32)
    for t in (None, tables):
        got, sel = sam_encoder.rel_smajor_global(T(q), T(rh), T(rw), H, W, tables=t)
        close(got, jwant, OP_RTOL)
        close(got, jcached, OP_RTOL)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))


# ------------------------------------------------- the kernels' plain versions


def test_flash_qkv_packed_windows_s_matches_jax(rng):
    win, BW = 4, 6
    S = win * win
    qkv, rel_s = rnd(rng, BW, S, 3 * HEADS * HD), rnd(rng, S, BW, HEADS * 32)
    sel32 = fa.make_rel_scatter32(win)
    want = jitted(j_fa.flash_qkv_packed_windows_s, 3)(J(qkv), J(rel_s), J(sel32.numpy()),
                                                      HD ** -0.5, HEADS, HD)
    close(fa.flash_qkv_packed_windows_s(T(qkv), T(rel_s), sel32, HD ** -0.5, HEADS, HD),
          want, OP_RTOL)


def _edge_case(rng, H, W, win, heads=HEADS, hd=HD):
    """Inputs of the edge attention as the encoder builds them: rel from
    `edge_rel_lpad` (real pad-key logits), the qkv bias as pad value."""
    geom = cw.CompactGeometry(H, W, win)
    rh, rw = _rel_params(rng, win, hd)
    qkv = rnd(rng, 2, geom.E, 3 * heads * hd)
    bias = rnd(rng, 3 * heads * hd)
    dim = heads * hd
    q = T(qkv[:, :, :dim].reshape(2, geom.E, heads, hd))
    rcomb = sam_encoder.make_rcomb(win, win, T(rh), T(rw), torch.float32)
    rel = cw.edge_rel_lpad(q, rcomb, T(bias[dim : 2 * dim].reshape(heads, hd)), hd ** -0.5,
                           geom)
    sel, kmask = cw.edge_consts(geom, torch.float32)
    n, R = geom.n_edge, geom.R_u
    args = (T(qkv.reshape(2, n, R, -1)), rel.reshape(2, n, R, heads * 32), sel,
            T(bias[2 * dim :].reshape(heads, hd)), kmask, hd ** -0.5, heads, hd)
    return geom, args, (qkv, bias, rh, rw)


@pytest.mark.parametrize("H,W,win", GEOMS)
def test_flash_qkv_packed_edge_matches_jax(rng, H, W, win):
    _, args, _ = _edge_case(rng, H, W, win)
    jargs = [J(a.numpy()) if isinstance(a, torch.Tensor) else a for a in args]
    close(fa.flash_qkv_packed_edge(*args), jitted(j_fa.flash_qkv_packed_edge, 5)(*jargs),
          OP_RTOL)


@pytest.mark.parametrize("H,W,win", GEOMS)
def test_flash_qkv_packed_edge_matches_literal_windows(rng, H, W, win):
    """The virtual pad key against literally padded windows (pad k/v = the
    qkv bias), on the real query rows; the port's oracle against JAX's."""
    geom, args, (qkv, bias, rh, rw) = _edge_case(rng, H, W, win)
    n, R = geom.n_edge, geom.R_u
    got = fa.flash_qkv_packed_edge(*args).reshape(2, n, HEADS, HD, R)
    lit = cw.edge_attention_literal(T(qkv), T(bias), T(rh), T(rw), HD ** -0.5, HEADS, geom)
    jlit = jitted(j_cw.edge_attention_literal, 4)(J(qkv), J(bias), J(rh), J(rw), HD ** -0.5,
                                                  HEADS, j_cw.CompactGeometry(H, W, win))
    close(lit, jlit, OP_RTOL)
    lit = lit.reshape(2, HEADS, n, R, HD).permute(0, 2, 1, 4, 3)  # (B, n, heads, d, R)
    off = 0
    for g in geom.edge_groups:
        close(got[:, off : off + g.n, ..., : g.rows], lit[:, off : off + g.n, ..., : g.rows],
              OP_RTOL)
        off += g.n


@pytest.mark.parametrize("H,W", [(5, 5), (6, 10)])
def test_flash_qkv_packed_global_matches_jax(rng, H, W):
    N = H * W
    qkv, rel = rnd(rng, 2, N, 3 * HEADS * HD), rnd(rng, N, 2, HEADS, H + W)
    sel = fa.make_rel_scatter(H, W)
    want = jitted(j_fa.flash_qkv_packed_global, 3)(J(qkv), J(rel), J(sel.numpy()),
                                                   HD ** -0.5, HEADS, HD, H, W)
    close(fa.flash_qkv_packed_global(T(qkv), T(rel), sel, HD ** -0.5, HEADS, HD, H, W), want,
          OP_RTOL)


# the head dims of the fp32 kernels (csrc/attn_f32.cuh): CLIP ViT-L/14's
# and SAM ViT-H's, at 2 heads
KERNEL_HDS = (64, 80)


@pytest.mark.parametrize("hd", KERNEL_HDS)
def test_flash_qkv_packed_windows_s_matches_jax_at_kernel_head_dims(rng, hd):
    """#13's plain version, the fp32 kernel's rounding reference, against
    JAX at the head dims the fp32 kernel takes (window 4 and 7)."""
    for win, BW in ((4, 3), (7, 2)):
        S = win * win
        qkv, rel_s = rnd(rng, BW, S, 3 * 2 * hd), rnd(rng, S, BW, 2 * 32)
        sel32 = fa.make_rel_scatter32(win)
        want = jitted(j_fa.flash_qkv_packed_windows_s, 3)(J(qkv), J(rel_s), J(sel32.numpy()),
                                                          hd ** -0.5, 2, hd)
        close(fa.flash_qkv_packed_windows_s(T(qkv), T(rel_s), sel32, hd ** -0.5, 2, hd), want,
              OP_RTOL)


@pytest.mark.parametrize("hd", KERNEL_HDS)
@pytest.mark.parametrize("H,W,win", [(10, 10, 4), (9, 12, 5)])
def test_flash_qkv_packed_edge_matches_jax_at_kernel_head_dims(rng, H, W, win, hd):
    """#15's plain version against JAX at the fp32 kernel's head dims, the
    encoder's real pad-key logits and the corner's dummy keys."""
    _, args, _ = _edge_case(rng, H, W, win, heads=2, hd=hd)
    jargs = [J(a.numpy()) if isinstance(a, torch.Tensor) else a for a in args]
    close(fa.flash_qkv_packed_edge(*args), jitted(j_fa.flash_qkv_packed_edge, 5)(*jargs),
          OP_RTOL)


@pytest.mark.parametrize("hd", KERNEL_HDS)
@pytest.mark.parametrize("H,W", [(5, 5), (6, 10)])
def test_flash_qkv_packed_global_matches_jax_at_kernel_head_dims(rng, H, W, hd):
    """#17's plain version against JAX at the fp32 kernel's head dims."""
    N = H * W
    qkv, rel = rnd(rng, 2, N, 3 * 2 * hd), rnd(rng, N, 2, 2, H + W)
    sel = fa.make_rel_scatter(H, W)
    want = jitted(j_fa.flash_qkv_packed_global, 3)(J(qkv), J(rel), J(sel.numpy()),
                                                   hd ** -0.5, 2, hd, H, W)
    close(fa.flash_qkv_packed_global(T(qkv), T(rel), sel, hd ** -0.5, 2, hd, H, W), want,
          OP_RTOL)


@pytest.mark.parametrize("H,W,win", GEOMS + [(64, 64, 14)])
def test_edge_sel_leaves_the_pad_key_lane_empty(H, W, win):
    """The edge kernel adds rel @ sel on the tensor cores, as [q*scale |
    rel] . [k | the key's column of sel]; rel's lane LPAD_LANE carries the
    pad key's logit, so it adds to no score only while sel's row LPAD_LANE
    is zero (the compact carry's windows of <= 14 fill lanes < 28)."""
    sel, _ = cw.edge_consts(cw.CompactGeometry(H, W, win), torch.float32)
    assert sel.shape[1] == cw.REL_LANES and not sel[:, cw.LPAD_LANE].any()


@pytest.mark.parametrize("name", ["plain", "windows_s", "edge", "windows", "global"])
def test_dmajor_outputs_as_padded_views_match_jax(rng, name):
    """Each d-major producer's output (#16, #13, #15, #12, #17) written into
    the layout its CUDA wrapper returns (`linear.dmajor_empty`: the view of
    rows whose stride is rounded up to 8) equals JAX's; the consumer's
    reshape of it (models/sam_encoder.py, models/clip/model.py) stays a view
    of the same memory, no copy; and proj_rows reads it as JAX's proj_rows
    reads JAX's output."""
    scale = HD ** -0.5
    if name == "plain":  # CLIP: (B, S, 3C) -> (B, C, S) -> (B, 1, C, S)
        h, d, S = 8, 16, 37
        qkv = rnd(rng, 2, S, 3 * h * d)
        got = fa.flash_qkv_packed_plain(T(qkv), d ** -0.5, h, d)
        want = jitted(j_fa.flash_qkv_packed_plain, 1)(J(qkv), d ** -0.5, h, d)
        lead = lambda o: o.reshape(2, 1, h * d, S)  # noqa: E731
    elif name == "windows_s":  # (B*nf, C, S) -> (B, nf, C, S)
        win, BW = 5, 6
        S = win * win
        qkv, rel_s = rnd(rng, BW, S, 3 * HEADS * HD), rnd(rng, S, BW, HEADS * 32)
        sel32 = fa.make_rel_scatter32(win)
        got = fa.flash_qkv_packed_windows_s(T(qkv), T(rel_s), sel32, scale, HEADS, HD)
        want = jitted(j_fa.flash_qkv_packed_windows_s, 3)(J(qkv), J(rel_s), J(sel32.numpy()),
                                                          scale, HEADS, HD)
        lead = lambda o: o.reshape(2, 3, HEADS * HD, S)  # noqa: E731
    elif name == "edge":  # (B, n, C, R), as it is
        _, args, _ = _edge_case(rng, 9, 12, 5)
        got = fa.flash_qkv_packed_edge(*args)
        jargs = [J(a.numpy()) if isinstance(a, torch.Tensor) else a for a in args]
        want = jitted(j_fa.flash_qkv_packed_edge, 5)(*jargs)
        lead = lambda o: o  # noqa: E731
    elif name == "windows":  # the padded carry: (B, nwin, C, Nw), as it is
        win, Nw = 5, 25
        qkv, rel = rnd(rng, 2, 3, Nw, 3 * HEADS * HD), rnd(rng, 2, 3, Nw, HEADS * 32)
        sel32 = fa.make_rel_scatter32(win)
        got = fa.flash_qkv_packed_windows(T(qkv), T(rel), sel32, scale, HEADS, HD)
        want = j_fa.flash_qkv_packed_windows(J(qkv), J(rel), J(sel32.numpy()), scale, HEADS, HD)
        lead = lambda o: o  # noqa: E731
    else:  # global: (B, C, N) -> (B, 1, C, N)
        H, W = 5, 7
        N = H * W
        qkv, rel = rnd(rng, 2, N, 3 * HEADS * HD), rnd(rng, N, 2, HEADS, H + W)
        sel = fa.make_rel_scatter(H, W)
        got = fa.flash_qkv_packed_global(T(qkv), T(rel), sel, scale, HEADS, HD, H, W)
        want = jitted(j_fa.flash_qkv_packed_global, 3)(J(qkv), J(rel), J(sel.numpy()), scale,
                                                       HEADS, HD, H, W)
        lead = lambda o: o.reshape(2, 1, HEADS * HD, N)  # noqa: E731
    view = linear.dmajor_empty(*got.shape, dtype=got.dtype, device=got.device).copy_(got)
    S = view.shape[-1]
    assert S % 8 and not view.is_contiguous() and view.stride(-2) == -(-S // 8) * 8
    close(view, want, OP_RTOL)
    x = lead(view)
    assert x.data_ptr() == view.data_ptr() and x.stride()[-2:] == view.stride()[-2:]
    assert x.untyped_storage().data_ptr() == view.untyped_storage().data_ptr()
    K = x.shape[-2]
    w, b, res = rnd(rng, K, 24, scale=0.2), rnd(rng, 24), rnd(rng, *x.shape[:2], S, 24)
    jwant = j_lin.proj_rows(jnp.reshape(want, x.shape), J(w), J(b[None]), J(res))
    close(linear.proj_rows(x, T(w.T.copy()), T(b), T(res)), jwant, OP_RTOL)


# ------------------------------------------------------ encoder and slice


def random_params(shapes, seed=0):
    """numpy params over an eval_shape tree: LayerNorm scales near 1, the
    logit scale at its init, everything else N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        name = str(path[-1].key)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)
        if name == "logit_scale":
            return np.full(sd.shape, np.log(1 / 0.07), np.float32)
        return (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def flash_pair():
    """The tiny cascade with an 8-head SAM on 'flash' (grid 5, window 2: right,
    bottom and corner edge windows) in both packages, same parameters."""
    jcfg = JCascadeConfig.tiny()
    jenc = j_sam.SamEncoderConfig.tiny(attn_impl="flash", **ENC_8)
    jcfg = dataclasses.replace(jcfg, inp_size=jenc.img_size, encoder=jenc,
                               clip=JClipConfig.tiny(**CLIP_8x16))
    jmodel = JCascade(jcfg)
    jbank = j_make_bank_inputs(jcfg, ["cat", "owl", "bat", "moth"], seed=3)
    rng = np.random.default_rng(1)
    B = 2
    inputs = (
        rng.standard_normal((B, jcfg.inp_size, jcfg.inp_size, 3)).astype(np.float32),
        rng.standard_normal((B, jcfg.clip_size, jcfg.clip_size, 3)).astype(np.float32),
        np.full((B, jcfg.clip_size, jcfg.clip_size, 1), 1.923, np.float32),
    )
    bank = (jbank["prefix"], jbank["suffix"], jbank["eot_indices"], jbank["bank_features"])
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, *inputs, *bank, method=jmodel.infer_cascade),
        jax.random.PRNGKey(0),
    )
    params = random_params(shapes, seed=2)
    cfg = dataclasses.replace(
        CascadeConfig.tiny(), inp_size=jenc.img_size,
        encoder=SamEncoderConfig.tiny(attn_impl="flash", **ENC_8),
        clip=AlphaClipConfig.tiny(**CLIP_8x16),
    )
    model = build_cascade(cfg, "cpu")
    load_jax_params(model, params, cfg)
    ref_cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, attn_impl="reference"))
    ref_model = build_cascade(ref_cfg, "cpu")
    load_jax_params(ref_model, params, ref_cfg)
    return jcfg, jmodel, params, model, ref_model, inputs, bank


def test_sam_encoder_flash_matches_jax_and_reference(flash_pair):
    """The port's 'flash' encoder, without and with the rel cache, against
    JAX's 'flash' encoder (without and with its 'relcache' collection) and
    against the port's own 'reference' encoder; the interm outputs too."""
    jcfg, jmodel, params, model, ref_model, inputs, _ = flash_pair
    x = inputs[0]
    run = jax.jit(lambda v, a: jmodel.apply(
        v, a, method=lambda m, a: m.image_encoder(a, interm=True)))
    want, want_interm = run(params, x)
    want_c, _ = run(j_attach_rel_cache(params, jcfg), x)
    close(want_c, want, MODULE_RTOL)
    enc = model.image_encoder
    with torch.no_grad():
        ref, _ = ref_model.image_encoder(T(x))
        for cached in (False, True):
            for blk in enc.blocks:
                blk.attn.rel_cache = None
            if cached:
                attach_rel_cache(model)
            got, interm = enc(T(x))
            close(got, want, MODULE_RTOL)
            close(got, ref, MODULE_RTOL)
            assert len(interm) == len(want_interm) == 2
            for g, w in zip(interm, want_interm):
                close(g, w, MODULE_RTOL)
    assert float(np.asarray(want).std()) > 1e-2  # not degenerate


def test_infer_cascade_flash_matches_jax(flash_pair):
    _, jmodel, params, model, _, inputs, bank = flash_pair
    jprobs, jpred, jlogits = jax.jit(
        lambda p, *a: jmodel.apply(p, *a, method=jmodel.infer_cascade)
    )(params, *inputs, *bank)
    attach_rel_cache(model)
    probs, pred, logits = model.infer_cascade(*map(T, inputs), *map(T, bank))
    close(probs, jprobs, MODULE_RTOL)
    close(logits, jlogits, MODULE_RTOL)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    assert float(np.asarray(jprobs).std()) > 1e-3


def test_stale_rel_cache_raises(flash_pair):
    """A cache built before a state-dict load is stale: the encoder raises
    instead of running on old tables."""
    *_, model, _, inputs, _ = flash_pair
    attach_rel_cache(model)
    model.load_state_dict(model.state_dict(), strict=True)
    with pytest.raises(RuntimeError, match="stale rel cache"), torch.no_grad():
        model.image_encoder(T(inputs[0]))
    attach_rel_cache(model)
    with torch.no_grad():
        model.image_encoder(T(inputs[0]))


def test_demo_session_attaches_rel_cache_after_loading(tmp_path, monkeypatch):
    """The demo's session loads `--cascade-ckpt`, then attaches the cache, so
    the tables come from the loaded weights."""
    from PIL import Image

    from camouflaged_vlm_tpu_torch.cli import demo

    cfg = dataclasses.replace(CascadeConfig.tiny(),
                              encoder=SamEncoderConfig.tiny(attn_impl="flash", **ENC_8),
                              inp_size=80)
    other = build_cascade(cfg, "cpu", seed=7)
    ckpt = tmp_path / "model.pth"
    torch.save(other.state_dict(), ckpt)
    img = tmp_path / "img.png"
    Image.fromarray(np.zeros((40, 50, 3), np.uint8)).save(img)
    args = demo.parse_args(["--image", str(img), "--tiny", "--device", "cpu", "--dtype",
                            "float32", "--cascade-ckpt", str(ckpt), "--classnames", "cat,owl"])
    monkeypatch.setattr(demo, "build_tiny_cascade",
                        lambda dt, dev, seed: (build_cascade(cfg, dev, seed), cfg))
    session = demo.DemoSession(args)
    attn = session.model.image_encoder.blocks[0].attn
    tables, _ = attn.rel_cache
    np.testing.assert_array_equal(tables.numpy(), attn.build_rel_tables().numpy())
    np.testing.assert_array_equal(
        attn.rel_pos_h.detach().numpy(),
        other.image_encoder.blocks[0].attn.rel_pos_h.detach().numpy())
    probs, _, _ = session.predict([Image.open(img)])
    assert probs.shape == (1, 80, 80) and np.isfinite(probs).all()
