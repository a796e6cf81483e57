"""Why the bf16 flash backward feeds P and dS to its products in one bf16 term.

The backward kernel's dV += P^T dO, dK += dS^T Q and dQ += dS K products
take P and dS from registers in bfloat16, and it forms dS = P (dP - delta)
from the rounded P.  The forward splits P into hi + lo terms because its
tolerance is 1e-2 absolute, below one output ulp where |o| >= 2.  The
gradients are held to 2e-2 * max(1, max |plain|) (``chip_smoke.BWD_REL``),
relative to their largest entry, and one bf16 term of P and of dS moves
each gradient by a sum of 8-bit roundings that stays far inside that: no
hi/lo split is needed, and each product runs once.

This emulates the kernel's rounding on the CPU in float64 at olmo-1b's
head shape (S=512, D=128, causal, 4 heads, seeded bf16 inputs): P and dS
rounded to one bf16 term, delta from the forward's bf16 output, the
gradients stored in bf16, against the exact float64 gradients.  Each of
dq, dk and dv stays within half of its tolerance.  Imports torch only.
"""
import math

import pytest

torch = pytest.importorskip("torch")

BWD_REL = 2e-2       # the bf16 backward's tolerance (chip_smoke.BWD_REL["bf16"])


def _bf16(x):
    return x.to(torch.bfloat16).double()


def _gradients(s=512, h=4, d=128, seed=0):
    """(exact, emulated) dq, dk, dv, each (h, s, d) in float64."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((h, s, d), generator=gen).to(torch.bfloat16).double()
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(s)
    scores = torch.einsum("hsd,htd->hst", q, k) * scale
    scores = scores.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - lse)
    out = torch.einsum("hst,htd->hsd", p, v)
    dp = torch.einsum("hsd,htd->hst", do, v)

    def grads(p_used, delta, round_ds, store):
        ds = p_used * (dp - delta)
        ds = round_ds(ds)
        dq = torch.einsum("hst,htd->hsd", ds, k) * scale
        dk = torch.einsum("hst,hsd->htd", ds, q) * scale
        dv = torch.einsum("hst,hsd->htd", p_used, do)
        return [store(g) for g in (dq, dk, dv)]

    exact = grads(p, (do * out).sum(-1, keepdim=True), lambda x: x, lambda x: x)
    emulated = grads(_bf16(p), (do * _bf16(out)).sum(-1, keepdim=True), _bf16, _bf16)
    return exact, emulated


def test_one_bf16_term_of_p_and_ds_keeps_the_gradients_within_half_the_tolerance():
    exact, emulated = _gradients()
    for name, want, got in zip(("dq", "dk", "dv"), exact, emulated):
        tol = BWD_REL * max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        assert err <= 0.5 * tol, f"{name}: {err:.3e} > half of {tol:.3e}"
        assert err > 0.0, name  # the rounding is really emulated
