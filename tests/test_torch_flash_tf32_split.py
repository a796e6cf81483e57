"""Why the float32 flash kernels split each operand into two TF32 terms.

The float32 flash kernels run both products (and, in the backward, all
five) on the tensor cores as TF32 ``mma.sync``, whose operands keep 10 of
float32's 23 mantissa bits (``cvt.rna.tf32.f32``: round to nearest, ties
away from zero).  One TF32 term moves an output by about 2^-11 of its
size, far beyond the 1e-5 the float32 forward is held to; split as hi =
tf32(x) and lo = tf32(x - hi), the three products lo.hi + hi.lo + hi.hi
(3xTF32, summed in float32, the small terms first) keep about 22 bits.

This emulates the kernels' arithmetic on the CPU in their tile order, on
seeded inputs at S = T = 256, 2 heads, causal, (Dqk, Dv) = (128, 128) and
(192, 128): the forward walks 32-key tiles with the online softmax in log2
units and P re-split for P V; the dK/dV kernel's dK = scale sum dS^T q runs
over steps of 32 q rows (16 at (192, 128)) from the emulated forward's lse
and output.  The forward is held against the reference's Pallas kernel in
interpret mode (it takes one head dim: at (192, 128) v is padded with zero
columns to 192 and the first 128 output columns compared) and against its
``attention_ref``; dK against autograd through the port's plain version.
With three terms every output holds the tolerance; with one, many break it.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention.flash_attention import flash_attention_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402

FWD_TOL = 1e-5       # chip_smoke.TOL["f32"]: max abs error of the forward
BWD_REL = 1e-4       # chip_smoke.BWD_REL["f32"]: times max(1, max |plain|)
KEYS = 32            # keys per K/V tile (csrc/flash_attention.cu, tc::kKeys)
LOG2E = 1.4426950408889634
S, H = 256, 2


def _tf32(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest, ties away
    from zero (add half of the dropped part to the magnitude, then cut)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, terms):
    """a @ b in float32 with both operands as one TF32 term or as hi + lo
    (lo.hi + hi.lo + hi.hi, the small terms first).  A product of two TF32
    values is exact in float32, as in the tensor core."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _forward(q, k, v, terms):
    """(out, lse) of causal attention as the forward kernel computes them:
    q (H, S, Dqk), k (H, T, Dqk), v (H, T, Dv) float32."""
    scale_log2 = LOG2E / math.sqrt(q.shape[-1])
    rows = torch.arange(q.shape[1])[:, None]
    m = torch.full(q.shape[:2], float("-inf"))
    l = torch.zeros(q.shape[:2])
    o = torch.zeros(*q.shape[:2], v.shape[-1])
    for n0 in range(0, k.shape[1], KEYS):
        s = _mm(q, k[:, n0:n0 + KEYS].transpose(1, 2), terms) * scale_log2
        s = s.masked_fill(n0 + torch.arange(KEYS)[None, :] > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == float("-inf"), torch.zeros(()), m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _mm(p, v[:, n0:n0 + KEYS], terms)
        m = m_new
    return o / l.clamp_min(1e-30)[..., None], m / LOG2E + torch.log(l)


def _dk(q, k, v, do, out, lse, terms):
    """dK as the dK/dV kernel computes it, over steps of q rows."""
    dqk, dv = q.shape[-1], v.shape[-1]
    step = 16 if dqk + dv > 256 else 32
    scale = 1.0 / math.sqrt(dqk)
    delta = (do * out).sum(-1)
    keys = torch.arange(k.shape[1])[:, None]
    dk = torch.zeros_like(k)
    for m0 in range(0, q.shape[1], step):
        rows = slice(m0, m0 + step)
        st = _mm(k, q[:, rows].transpose(1, 2), terms)  # S^T: keys x rows
        pt = torch.exp2(st * (scale * LOG2E) - lse[:, None, rows] * LOG2E)
        pt = pt.masked_fill(keys > m0 + torch.arange(step)[None, :], 0.0)
        dpt = _mm(v, do[:, rows].transpose(1, 2), terms)
        dst = pt * (dpt - delta[:, None, rows])
        dk = dk + _mm(dst, q[:, rows], terms)
    return dk * scale


def _inputs(dqk, dv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((H, S, d), dtype=np.float32) for d in (dqk, dqk, dv, dv)]


@pytest.mark.parametrize("dqk, dv", [(128, 128), (192, 128)])
def test_one_tf32_term_breaks_the_forward_tolerance_and_three_hold_it(dqk, dv):
    q, k, v, _ = _inputs(dqk, dv)
    vp = np.pad(v, ((0, 0), (0, 0), (0, dqk - dv)))  # the Pallas kernel's one head dim
    pallas = np.asarray(flash_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(vp), causal=True, interpret=True))[..., :dv]
    ref = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    beyond = {}
    for terms in (1, 3):
        got = _forward(*(torch.from_numpy(x) for x in (q, k, v)), terms)[0].numpy()
        for name, want in (("pallas", pallas), ("attention_ref", ref)):
            beyond[terms, name] = int((np.abs(got - want) > FWD_TOL).sum())
    assert beyond[3, "pallas"] == beyond[3, "attention_ref"] == 0, beyond
    assert beyond[1, "pallas"] > 100 and beyond[1, "attention_ref"] > 100, beyond


@pytest.mark.parametrize("dqk, dv", [(128, 128), (192, 128)])
def test_one_tf32_term_breaks_the_dk_tolerance_and_three_hold_it(dqk, dv):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(dqk, dv, seed=1))
    leaves = [x.transpose(0, 1)[None].clone().requires_grad_() for x in (q, k, v)]
    attention_ref(*leaves, causal=True).backward(do.transpose(0, 1)[None])
    want = leaves[1].grad[0].transpose(0, 1)
    tol = BWD_REL * max(1.0, want.abs().max().item())
    beyond = {}
    for terms in (1, 3):
        out, lse = _forward(q, k, v, terms)
        got = _dk(q, k, v, do, out, lse, terms)
        beyond[terms] = int(((got - want).abs() > tol).sum())
    assert beyond[3] == 0 and beyond[1] > 100, beyond
