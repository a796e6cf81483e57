"""Why the bf16 flash kernel feeds P to its second product in two bf16 terms.

The kernel's P V product takes P from registers in bfloat16.  Rounded to
one bf16 term (8 bits), P moves an output by about 2^-9 of its size; where
|o| >= 2 one bf16 ulp of the output is 2^-6 = 0.0156, above the 1e-2
tolerance the kernel is held to, so an output that lands on the other side
of a rounding step fails the check.  Split as hi = bf16(p) plus
lo = bf16(p - hi), P keeps about 16 bits.

This emulates the rounding on the CPU in float64 at olmo-1b's main shape
(B=1, S=512, H=16, D=128, causal, seeded bf16 inputs): one output in a
million lies beyond 1e-2 with one term, none with two, and the expected
number of outputs a rounding step apart (the sum of |o_P - o| / ulp over
outputs where the ulp exceeds the tolerance) falls by about 1000x.
Imports torch only.
"""
import math

import pytest

torch = pytest.importorskip("torch")

TOL = 1e-2           # the bf16 kernel's tolerance (chip_smoke.TOL["bf16"])
ULP_ABOVE_TWO = 2.0 ** -6


def _outputs(s=512, h=16, d=128, seed=0):
    """The exact causal attention output and the outputs with P rounded to
    one and to two bf16 terms, all in float64 before the output rounding."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((s, h, d), generator=gen).to(torch.bfloat16).double()
               for _ in range(3))
    scores = torch.einsum("shd,thd->hst", q, k) / math.sqrt(d)
    pos = torch.arange(s)
    scores = scores.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    hi = p.to(torch.bfloat16).double()
    lo = (p - hi).to(torch.bfloat16).double()
    return [torch.einsum("hst,thd->hsd", pu, v) / denom for pu in (p, hi, hi + lo)]


def test_p_in_one_bf16_term_misses_the_tolerance_and_two_terms_hold_it():
    exact, one, two = _outputs()
    rounded = exact.to(torch.bfloat16).double()
    beyond = [int(((o.to(torch.bfloat16).double() - rounded).abs() > TOL).sum())
              for o in (one, two)]
    assert beyond[0] >= 1 and beyond[1] == 0, beyond

    coarse = exact.abs() >= 2.0  # where one output ulp exceeds the tolerance
    expected = [((o - exact).abs()[coarse] / ULP_ABOVE_TWO).sum().item() for o in (one, two)]
    assert expected[0] > 0.5 and expected[1] < 0.01, expected
