"""The strides the fp32 kernels of #8/#9, #10, #11, #12, #19 and #20 take from
their wrappers' helpers (`flash_attention.f32_split_layout`,
`f32_packed_layout`, `linear.proj_heads_f32_layout`, `heads_a_offset`),
held on the CPU to `Tensor.stride()` and to indexing of the tensors the
wrappers hand in: the element each (problem, head, token, column) of q, k,
v, rel and the output lands on is the one the plain version reads or
writes there. The kernels themselves run only on the card
(tests/test_torch_kernels.py)."""

import pytest

torch = pytest.importorskip("torch")

from camouflaged_vlm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from camouflaged_vlm_tpu_torch.ops import linear as lin  # noqa: E402


def _fields(layout):
    assert len(layout) == len(fa.F32_LAYOUT_FIELDS)
    return dict(zip(fa.F32_LAYOUT_FIELDS, layout))


def _arange(*shape):
    return torch.arange(torch.Size(shape).numel(), dtype=torch.float64).reshape(shape)


def _operand(flat, base, sp, sh, st, P, heads, S, width):
    """flat[base + p sp + h sh + t st + c] as (P, heads, S, width): what the
    loop reads for q, k or v (attn_f32.cuh)."""
    p, h, t, c = (torch.arange(n).reshape([-1 if i == j else 1 for j in range(4)])
                  for i, n in enumerate((P, heads, S, width)))
    return flat[base + p * sp + h * sh + t * st + c]


def _rel(flat, f, P, heads, S, lanes):
    p, h, t, c = (torch.arange(n).reshape([-1 if i == j else 1 for j in range(4)])
                  for i, n in enumerate((P, heads, S, lanes)))
    return flat[p * f["rp"] + h * f["lph"] + t * f["rq"] + c]


def _out(flat, f, P, heads, S, width, dmajor):
    """The elements the loop writes problem p, head h, query t, column c to."""
    p, h, t, c = (torch.arange(n).reshape([-1 if i == j else 1 for j in range(4)])
                  for i, n in enumerate((P, heads, S, width)))
    start = (p // f["opn"]) * f["og"] + (p % f["opn"]) * f["ow"] + h * f["oh"]
    return flat[start + (c * f["ldo"] + t if dmajor else t * f["ldo"] + c)]


@pytest.mark.parametrize("BB,N,dqk,dv,lanes", [(6, 196, 64, 64, 28),    # #10, ViT-B windows
                                               (2, 289, 80, 80, 34),    # #10 at d 80, ragged
                                               (3, 256, 208, 80, 0),    # #20, ViT-H aug_flash
                                               (2, 100, 128, 64, 0)])   # #20, the small cascade
def test_split_layout_holds_to_strides_and_indexing(BB, N, dqk, dv, lanes):
    f = _fields(fa.f32_split_layout(BB, N, dqk, dv, lanes))
    q, v, rel, out = _arange(BB, N, dqk), _arange(BB, N, dv), _arange(BB, N, lanes), \
        _arange(BB, N, dv)
    assert (f["qp"], f["qt"]) == q.stride()[:2] and (f["kp"], f["kt"]) == q.stride()[:2]
    assert (f["vp"], f["vt"]) == v.stride()[:2] and f["qh"] == f["kh"] == f["vh"] == 0
    assert (f["og"], f["ldo"]) == out.stride()[:2] and f["opn"] == 1 and f["lph"] == 0
    for name, t, w in (("q", q, dqk), ("k", q, dqk), ("v", v, dv)):
        got = _operand(t.flatten(), 0, f[name + "p"], f[name + "h"], f[name + "t"], BB, 1, N, w)
        assert torch.equal(got, t[:, None])
    if lanes:  # #10's rel; #20 has none (zero strides)
        assert (f["rp"], f["rq"]) == rel.stride()[:2]
        assert torch.equal(_rel(rel.flatten(), f, BB, 1, N, lanes), rel[:, None])
    else:
        assert f["rp"] == f["rq"] == 0
    assert torch.equal(_out(out.flatten(), f, BB, 1, N, dv, False), out[:, None])


@pytest.mark.parametrize("B,nwin,H,W,heads,d", [(2, 16, 17, 17, 4, 80),   # #11, window 17
                                                (2, 3, 5, 6, 2, 64),
                                                (2, 1, 8, 8, 3, 80)])     # #19, one window
def test_packed_layout_holds_to_strides_and_indexing(B, nwin, H, W, heads, d):
    """#11 and #19: the 5D view of the packed qkv rows, rel per head, the
    output head-leading (B, heads, nwin, N, d)."""
    N, L = H * W, H + W
    offsets, layout = fa.f32_packed_layout(B, nwin, N, heads, d, L)
    f = _fields(layout)
    qkv, rel, out = _arange(B, nwin, N, 3 * heads, d), _arange(B, nwin, N, heads, L), \
        _arange(B, heads, nwin, N, d)
    assert qkv.stride(0) == nwin * f["qp"] and (f["qp"], f["qt"], f["qh"]) == qkv.stride()[1:4]
    assert rel.stride(0) == nwin * f["rp"] and (f["rp"], f["rq"], f["lph"]) == rel.stride()[1:4]
    assert (f["og"], f["ow"], f["oh"], f["ldo"]) == (out.stride(0), out.stride(2),
                                                     out.stride(1), out.stride(3))
    P, flat = B * nwin, qkv.flatten()
    for i, name in enumerate("qkv"):
        got = _operand(flat, offsets[i], f[name + "p"], f[name + "h"], f[name + "t"], P, heads,
                       N, d)
        want = qkv[:, :, :, i * heads:(i + 1) * heads].reshape(P, N, heads, d).transpose(1, 2)
        assert torch.equal(got, want)
    assert torch.equal(_rel(rel.flatten(), f, P, heads, N, L),
                       rel.reshape(P, N, heads, L).transpose(1, 2))
    assert torch.equal(_out(out.flatten(), f, P, heads, N, d, False),
                       out.transpose(1, 2).reshape(P, heads, N, d))
    if nwin == 1:  # #19 takes the 4D (B, N, 3 heads, d) rows: the same memory
        assert qkv[:, 0].stride()[:2] == (f["qp"], f["qt"])


@pytest.mark.parametrize("B,nwin,win,heads,d", [(2, 16, 16, 4, 80), (1, 4, 15, 2, 64),
                                                (2, 3, 5, 2, 80)])
def test_padded_windows_layout_holds_to_strides_and_indexing(B, nwin, win, heads, d):
    """#12: the packed rows (B, nwin, Nw, 3 heads d), rel window-major (B,
    nwin, Nw, heads 32), the output d-major in `dmajor_empty`'s padded rows."""
    Nw = win * win
    out = lin.dmajor_empty(B, nwin, heads * d, Nw, dtype=torch.float64, device="cpu")
    out.copy_(_arange(B, nwin, heads * d, Nw))
    offsets, layout = fa.f32_packed_layout(B, nwin, Nw, heads, d, 32, ldo=out.stride(-2))
    f = _fields(layout)
    qkv, rel = _arange(B, nwin, Nw, 3 * heads * d), _arange(B, nwin, Nw, heads * 32)
    assert (f["qp"], f["qt"]) == qkv.stride()[1:3] and qkv.stride(0) == nwin * f["qp"]
    assert (f["rp"], f["rq"]) == rel.stride()[1:3] and f["lph"] == 32
    assert (f["og"], f["ldo"]) == (out.stride(1), out.stride(2)) and f["opn"] == 1
    assert f["oh"] == d * out.stride(2) and out.stride(0) == nwin * f["og"]
    P = B * nwin
    rows = qkv.reshape(P, Nw, 3, heads, d)
    for i, name in enumerate("qkv"):
        got = _operand(qkv.flatten(), offsets[i], f[name + "p"], f[name + "h"], f[name + "t"], P,
                       heads, Nw, d)
        assert torch.equal(got, rows[:, :, i].transpose(1, 2))
    assert torch.equal(_rel(rel.flatten(), f, P, heads, Nw, 32),
                       rel.reshape(P, Nw, heads, 32).transpose(1, 2))
    flat = out.as_strided((out.untyped_storage().nbytes() // out.element_size(),), (1,))
    want = out.reshape(P, heads, d, Nw).transpose(2, 3)
    assert torch.equal(_out(flat, f, P, heads, Nw, d, True), want)


@pytest.mark.parametrize("B,heads,T,S,d", [(2, 16, 16, 289, 80), (1, 3, 2, 7, 8),
                                           (2, 2, 3, 5, 64)])
def test_proj_heads_layout_holds_to_strides_and_indexing(B, heads, T, S, d):
    """#8/#9: the head-leading A (row m = t S + s of image b, column k = h d +
    j) the fp32 product reads x (B, heads, T, S, d) as, against the rows the
    plain version builds (x permuted to (B, T, S, heads d))."""
    lay = lin.proj_heads_f32_layout(B, heads, T, S, d)
    x = _arange(B, heads, T, S, d)
    assert (lay["G"], lay["M"], lay["K"]) == (B, T * S, heads * d)
    assert lay["sa"] == x.stride(0) and lay["M"] * lay["d"] == x.stride(1)
    assert lay["d"] == x.stride(3)
    rows = x.permute(0, 2, 3, 1, 4).reshape(B, T * S, heads * d)
    g, m, k = (torch.arange(n).reshape([-1 if i == j else 1 for j in range(3)])
               for i, n in enumerate((B, T * S, heads * d)))
    idx = lin.heads_a_offset(g, m, k, lay["M"], lay["d"], lay["sa"])
    assert torch.equal(x.flatten()[idx], rows)
