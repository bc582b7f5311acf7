"""The 'aug_flash' global attention kernel's algorithm (`csrc/attn_fullk.cu`,
TPU kernel #20), on the CPU.

The kernel runs only on the card; here its one pass is emulated in torch,
in the working types: q and k padded with zero features to the kernel's
depth (64, 128, 192, 208 or 256), the keys in tiles of 64 (the last one
ragged), fp32 scores in log2 units, the online row max and sum, O rescaled
by exp2(m_old - m_new), P rounded to bf16 unnormalised for P . V with fp32
accumulation, and O times 1 / l rounded once at the end. That emulation is
held, in bf16, to the JAX package's `flash_attention_fullk` run in Pallas
interpret mode and to the port's plain version, with the card's kernel gate
(max|d| / max|ref| and mean|d| / mean|ref| below 1e-2): the one pass moves
one rounding point against both, which normalise P in fp32 before its
rounding, and bf16 rounds the output once (2^-8 relative). Token counts
that are not multiples of 64 are included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from camouflaged_vlm_tpu.ops import flash_attention as j_fa  # noqa: E402

from camouflaged_vlm_tpu_torch.ops import flash_attention as fa  # noqa: E402

GATE = 1e-2  # the card's kernel gate (chip_smoke.KERNEL_REL_BOUND)
LOG2E = 1.4426950408889634
KEY_TILE = 64  # csrc/attn_sm90.cuh ST_KT
DEPTHS = (64, 128, 192, 208, 256)  # csrc/attn_fullk.cu dispatch_fullk
BF = torch.bfloat16


def rel_err(got, want):
    """max|d| / max|ref| and mean|d| / mean|ref|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    return d.max() / np.abs(want).max(), d.mean() / np.abs(want).mean()


def kernel_fullk_emulation(q, k, v):
    """csrc/attn_fullk.cu in torch: q, k (BB, N, d), v (BB, N, dv) bf16 ->
    (BB, N, dv) bf16. fp32 arithmetic on the bf16 values."""
    BB, N, d = q.shape
    dq = next(x for x in DEPTHS if x >= d)  # the template depth; TMA fills zeros past d
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, dq - d))  # noqa: E731
    qf, kf, vf = pad(q), pad(k), v.float()
    m = torch.full((BB, N), -float("inf"))
    l, o = torch.zeros(BB, N), torch.zeros(BB, N, v.shape[-1])
    for t in range(0, N, KEY_TILE):
        s = (qf @ kf[:, t:t + KEY_TILE].transpose(1, 2)) * LOG2E
        mn = torch.maximum(m, s.amax(-1))
        corr, p = torch.exp2(m - mn), torch.exp2(s - mn[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + p.to(BF).float() @ vf[:, t:t + KEY_TILE]
        m = mn
    return (o * (1.0 / l)[..., None]).to(BF)


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    orig, kernels = j_fa.pl.pallas_call, []

    def interp(kernel, *args, **kw):
        kernels.append(getattr(kernel, "func", kernel).__name__)
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(kernel, *args, **kw)

    monkeypatch.setattr(j_fa.pl, "pallas_call", interp)
    monkeypatch.setattr(j_fa, "_on_cpu", lambda: False)
    return kernels


@pytest.mark.parametrize("BB,N,dqk,dv,block_q", [
    (2, 256, 208, 80, 128),   # ViT-H's features (80 + 64 + 64), four key tiles
    (3, 196, 96, 64, 196),    # a ragged last key tile (196 = 3 x 64 + 4); depth 96 -> 128
    (1, 100, 48, 80, 100),    # depth 48 -> 64, 100 = 64 + 36 keys
    (2, 130, 256, 64, 130),   # the deepest features, 130 = 2 x 64 + 2
])
def test_kernel_emulation_matches_jax_kernel(interpret, BB, N, dqk, dv, block_q):
    rng = np.random.default_rng(BB * N + dqk)
    r = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * scale).astype(np.float32)).to(BF)
    q, k, v = r(BB, N, dqk, scale=2 * dqk ** -0.5), r(BB, N, dqk), r(BB, N, dv)
    got = kernel_fullk_emulation(q, k, v).float().numpy()
    J = lambda t: jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)  # noqa: E731
    want = j_fa.flash_attention_fullk(J(q), J(k), J(v), block_q=block_q)
    assert interpret == ["_kernel"]  # the TPU kernel #20 itself ran
    for ref in (np.asarray(want, np.float32), fa.flash_attention_fullk_ref(q, k, v).float()):
        mx, mean = rel_err(got, ref)
        assert mx < GATE and mean < GATE, (mx, mean)
