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

float16 keeps 11 bits, and its kernels are held to ``TOL_F16`` = 2e-3,
one float16 step (ulp) at |o| < 4: float32 sums in another order can flip
an output's rounding by one step, so no tighter absolute bound holds.
With P in one float16 term about 40 % of the outputs land a float16 step
off the exact output rounded, against under 0.1 % with two terms; where
|o| >= 4 a step is 2^-8 = 0.0039, above the tolerance.  At olmo-1b's shape
with v at twice the unit scale (outputs up to |o| ~ 7.3), one term puts
outputs beyond 2e-3 and two terms none, and the expected number of
outputs a step apart falls by about 3000x: the float16 kernels take P in
two terms, as the bf16 ones do.
Imports torch only.
"""
import math

import pytest

torch = pytest.importorskip("torch")

TOL = 1e-2           # the bf16 kernel's tolerance (chip_smoke.TOL["bf16"])
ULP_ABOVE_TWO = 2.0 ** -6
TOL_F16 = 2e-3       # the float16 kernels' tolerance (chip_smoke.TOL["f16"])
F16_ULP_ABOVE_FOUR = 2.0 ** -8


def _outputs(s=512, h=16, d=128, seed=0, dtype=torch.bfloat16, v_scale=1.0):
    """The exact causal attention output and the outputs with P rounded to
    one and to two terms of ``dtype``, all in float64 before the output
    rounding; v is drawn at ``v_scale`` times the unit scale."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((s, h, d), generator=gen).to(dtype).double() for _ in range(3))
    v = v * v_scale  # a power of two: exact in dtype
    scores = torch.einsum("shd,thd->hst", q, k) / math.sqrt(d)
    pos = torch.arange(s)
    scores = scores.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    hi = p.to(dtype).double()
    lo = (p - hi).to(dtype).double()
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


def test_p_in_one_f16_term_misses_the_tolerance_and_two_terms_hold_it():
    exact, one, two = _outputs(dtype=torch.float16, v_scale=2.0)
    rounded = exact.to(torch.float16).double()
    off = [(o.to(torch.float16).double() - rounded).abs() for o in (one, two)]
    beyond = [int((dev > TOL_F16).sum()) for dev in off]
    assert beyond[0] >= 1 and beyond[1] == 0, beyond
    stepped = [float((dev > 0).double().mean()) for dev in off]
    assert stepped[0] > 0.2 and stepped[1] < 1e-3, stepped

    coarse = exact.abs() >= 4.0  # where one float16 step exceeds the tolerance
    expected = [((o - exact).abs()[coarse] / F16_ULP_ABOVE_FOUR).sum().item() for o in (one, two)]
    assert expected[0] > 0.5 and expected[1] < 0.01, expected
