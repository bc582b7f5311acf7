"""The MLP backward kernel's algorithm (`csrc/ln_mlp_residual_bwd.cu`, TPU
kernel #6) and its wrapper, on the CPU.

The kernel runs only on the card; here its four passes are emulated in
torch, in the working types, per row panel of `linear.mlp_panel_rows`: the
LN row pass (bf16 xn, fp32 mean and rstd), the dual GEMM (fp32 pre1 = xn .
W1^T + b1 and dh_pre = g . W2, dh = act'(pre1) dh_pre rounded to bf16, db1
partials from the fp32 dh per 64 rows), dxn = dh . W1 in fp32, and the
LN-backward rows (dx rounded once, dgamma/dbeta partials per 32 rows),
the partials written where the kernel writes them in buffers of the
wrapper's sizes. That emulation is held, in bf16, to the VJP of the JAX
package's `ln_mlp_residual_bt` through its own backward kernel run in
Pallas interpret mode, with the card's kernel gate (max|d| / max|ref| and
mean|d| / mean|ref| below 1e-2: bf16 rounds each output once, 2^-8
relative, and summation orders differ), and to the port's plain backward,
which the card holds the kernel to, within one bf16 rounding (no rounding
point moves against it). Widths include K = 96 and K = 200, which are not
multiples of 128, and panels that split M raggedly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from camouflaged_vlm_tpu.ops import linear as j_lin  # noqa: E402

from camouflaged_vlm_tpu_torch.ops import linear  # noqa: E402

GATE = 1e-2  # the card's kernel gate (chip_smoke.KERNEL_REL_BOUND)
ULP = 2.0 ** -7  # one bf16 rounding of the largest value, relative to it
BF = torch.bfloat16
NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


def rel_err(got, want):
    """max|d| / max|ref| and mean|d| / mean|ref|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    return d.max() / np.abs(want).max(), d.mean() / np.abs(want).mean()


def kernel_bwd_emulation(x, gamma, beta, w1, b1, w2, b2, g, eps, activation, weights):
    """csrc/ln_mlp_residual_bwd.cu's backward in torch: x, g (..., K), w1 (H,
    K), w2 (K, H), biases bf16, gamma/beta fp32 -> the seven gradients of
    `linear.ln_mlp_residual_bt_bwd` (the weight side None without
    `weights`). fp32 arithmetic on the bf16 values, per row panel."""
    K, H = x.shape[-1], w1.shape[0]
    M = x.numel() // K
    x2, g2 = x.reshape(M, K), g.reshape(M, K)
    rows = linear.mlp_panel_rows(M, H)
    w1f, w2f, b1f = w1.float(), w2.float(), b1.float()
    dx = torch.empty_like(x2)
    # the wrapper's partial buffers, NaN until the kernel's passes write them
    dga = torch.full((-(-M // linear.MLP_BWD_LN_ROWS), K), float("nan"))
    dbe = torch.full_like(dga, float("nan"))
    db1 = torch.full((2 * -(-M // linear.GEMM_BM), H), float("nan"))
    xn_all, dh_all, hact_all = [], [], []
    for r0 in range(0, M, rows):
        xs, gs = x2[r0:r0 + rows].float(), g2[r0:r0 + rows]
        m = xs.shape[0]
        # 1. the LN row pass: statistics in fp32, xn rounded to bf16
        mu = xs.mean(-1, keepdim=True)
        rstd = 1.0 / torch.sqrt((xs - mu).square().mean(-1, keepdim=True) + eps)
        xhat = (xs - mu) * rstd
        xn = (xhat * gamma + beta).to(BF)
        # 2. the dual GEMM: two fp32 accumulators over K, then the epilogue
        pre = xn.float() @ w1f.T + b1f
        dpre = gs.float() @ w2f
        hact, dact = linear.act_and_grad(pre, activation)
        dh = dact * dpre
        for t in range(0, m, linear.MLP_BWD_DB1_ROWS):  # per consumer warpgroup's 64 rows
            db1[(r0 + t) // linear.MLP_BWD_DB1_ROWS] = dh[t:t + linear.MLP_BWD_DB1_ROWS].sum(0)
        if m % linear.GEMM_BM and m % linear.GEMM_BM <= linear.MLP_BWD_DB1_ROWS:
            # the last tile's second warpgroup holds no row: it writes zeros
            db1[(r0 + m - m % linear.GEMM_BM) // linear.MLP_BWD_DB1_ROWS + 1] = 0.0
        dhb = dh.to(BF)
        # 3. dxn = dh . W1 in fp32
        dxn = dhb.float() @ w1f
        # 4. the LN-backward rows
        dxhat = dxn * gamma
        m1 = dxhat.mean(-1, keepdim=True)
        m2 = (dxhat * xhat).mean(-1, keepdim=True)
        dx[r0:r0 + m] = (rstd * (dxhat - m1 - xhat * m2) + gs.float()).to(BF)
        for t in range(0, m, linear.MLP_BWD_LN_ROWS):
            i = (r0 + t) // linear.MLP_BWD_LN_ROWS
            dga[i] = (dxn * xhat)[t:t + linear.MLP_BWD_LN_ROWS].sum(0)
            dbe[i] = dxn[t:t + linear.MLP_BWD_LN_ROWS].sum(0)
        xn_all.append(xn)
        dh_all.append(dhb)
        hact_all.append(hact.to(BF))
    dx = dx.reshape(x.shape)
    if not weights:
        return dx, None, None, None, None, None, None
    # every partial row written, none past the buffers (sized as the wrapper sizes them)
    assert not (dga.isnan().any() or dbe.isnan().any() or db1.isnan().any())
    xn, dhb, hact = torch.cat(xn_all), torch.cat(dh_all), torch.cat(hact_all)
    return (dx, dga.sum(0), dbe.sum(0), (dhb.float().T @ xn.float()).to(w1.dtype),
            db1.sum(0).to(b1.dtype), (g2.float().T @ hact.float()).to(w2.dtype),
            g2.float().sum(0).to(b2.dtype))


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels (here the MLP's forward and its
    backward kernel) in interpret mode on the CPU."""
    orig, kernels = j_lin.pl.pallas_call, []

    def interp(kernel, *args, **kw):
        kernels.append(getattr(kernel, "func", kernel).__name__)
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(kernel, *args, **kw)

    monkeypatch.setattr(j_lin.pl, "pallas_call", interp)
    monkeypatch.setattr(j_lin, "_on_cpu", lambda: False)
    return kernels


def _inputs(seed, B, S, K, H):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return dict(x=r(B, S, K, scale=2.0), gamma=1 + r(K, scale=0.1), beta=r(K, scale=0.1),
                w1=r(H, K, scale=0.1), b1=r(H, scale=0.1), w2=r(K, H, scale=0.05),
                b2=r(K, scale=0.1), g=r(B, S, K))


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("B,S,K,H,activation,scratch", [
    (2, 37, 96, 136, "gelu_tanh", None),      # K, H not multiples of 128
    (1, 150, 200, 264, "gelu", 128 * 264),    # ragged panels: 128 + 22 rows
    (3, 70, 32, 128, "quick_gelu", 128 * 128),  # 210 rows: panels of 128 + 82
])
def test_kernel_emulation_matches_jax_vjp(interpret, monkeypatch, weights, B, S, K, H,
                                          activation, scratch):
    if scratch is not None:  # a hidden scratch that forces row panels
        monkeypatch.setattr(linear, "MLP_SCRATCH_ELEMS", scratch)
        assert linear.mlp_panel_rows(B * S, H) < B * S
    a = _inputs(B * S + K, B, S, K, H)
    bf = {k: torch.from_numpy(v).to(BF) for k, v in a.items() if k not in ("gamma", "beta")}
    gamma, beta = torch.from_numpy(a["gamma"]), torch.from_numpy(a["beta"])
    args = (bf["x"], gamma, beta, bf["w1"], bf["b1"], bf["w2"], bf["b2"], bf["g"])
    got = kernel_bwd_emulation(*args, 1e-6, activation, weights)

    # the JAX package's VJP through its backward kernel, in bf16 (JAX layouts:
    # gamma/beta/biases (1, n), w1 (K, H), w2 (H, K))
    J = lambda t: jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)  # noqa: E731
    jargs = (J(bf["x"]), jnp.asarray(a["gamma"])[None], jnp.asarray(a["beta"])[None],
             J(bf["w1"]).T, J(bf["b1"])[None], J(bf["w2"]).T, J(bf["b2"])[None])
    _, pull = jax.vjp(lambda *p: j_lin.ln_mlp_residual_bt(*p, eps=1e-6, activation=activation),
                      *jargs)
    want = pull(J(bf["g"]))
    assert "_ln_mlp_residual_bwd_kernel" in interpret  # the TPU kernel #6 itself ran
    to_port = [lambda v: v, lambda v: v[0], lambda v: v[0], lambda v: v.T, lambda v: v[0],
               lambda v: v.T, lambda v: v[0]]
    plain = linear.ln_mlp_residual_bt_bwd_ref(*args, eps=1e-6, activation=activation,
                                              weights=weights)
    for name, gt, f, wt, pt in zip(NAMES, got, to_port, want, plain):
        if gt is None:
            assert not weights and name != "dx" and pt is None
            continue
        ref = np.asarray(f(wt), np.float32)
        mx, mean = rel_err(gt.float().numpy(), ref)
        assert mx < GATE and mean < GATE, (name, mx, mean)
        # the port's plain backward: the same rounding points
        mx, mean = rel_err(gt.float().numpy(), pt.float().numpy())
        assert mx <= ULP and mean < 1e-3, (name, mx, mean)


@pytest.mark.parametrize("B,S,K,H,activation,weights", [
    (2, 37, 96, 136, "gelu_tanh", False),
    (2, 37, 96, 136, "gelu_tanh", True),
    (1, 150, 200, 264, "quick_gelu", True),
])
def test_wrapper_runs_the_plain_version_on_cpu(B, S, K, H, activation, weights):
    """CPU tensors take the plain backward, output for output (bit-equal),
    with the weight side None without `weights`."""
    a = _inputs(B * S + H, B, S, K, H)
    args = [torch.from_numpy(a[k]).to(BF) if k not in ("gamma", "beta") else
            torch.from_numpy(a[k]) for k in ("x", "gamma", "beta", "w1", "b1", "w2", "b2", "g")]
    got = linear.ln_mlp_residual_bt_bwd(*args, eps=1e-6, activation=activation, weights=weights)
    want = linear.ln_mlp_residual_bt_bwd_ref(*args, eps=1e-6, activation=activation,
                                             weights=weights)
    assert len(got) == len(want) == len(NAMES)
    for name, gt, wt in zip(NAMES, got, want):
        if wt is None:
            assert gt is None and not weights and name != "dx", name
        else:
            assert gt.dtype == wt.dtype and torch.equal(gt, wt), name
    # SAM's global blocks at batch 2 run in two panels of 4096 rows
    assert linear.mlp_panel_rows(8192, 5120) == 4096
