"""Flash attention's reach on the CPU route: what the Pallas kernel takes,
the port's ``flash_attention`` takes too.

The Pallas kernel takes any head dim and any float dtype, casting each
block to float32 and returning q's dtype.  The port's CPU route (its plain
version, which computes in float32 whatever dtypes q, k and v have) is
held against ``repro.kernels.flash_attention.flash_attention`` in
interpret mode on the same seeded inputs at head dims 8, 40, 96, 100, 160
and 256, in float32 and float16, with GQA, a window, and q, k, v in three
dtypes.  The MLA-like pair (96, 64), which ``repro.models.common
.full_attention`` takes and the Pallas kernel (one head dim) does not, is
held against ``full_attention``.  Every case's gradients, each in its
input's dtype, are held against ``jax.grad`` of
``repro.kernels.flash_attention.ref.attention_ref`` on the same values
widened, through autograd and through ``flash_attention_backward``.  The
CUDA route's limits (``reach_error``: head dims past ``MAX_HEAD_DIM``,
float64) are named, and its padding of a call's head dims to an instance
(zero channels) is held to the unpadded function on the plain versions.

Tolerances (the rule of ``tests/test_torch_kernel_reach.py``): float32
outputs max abs err <= 1e-5 * max(1, max |ref|), gradients 1e-4 * max(1,
max |ref|); a float16 or bfloat16 output or gradient must equal the
reference rounded to its dtype or lie one step of that dtype away, beyond
that same float32 tolerance.  The CUDA kernels are held against the plain
versions on the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.models.common import full_attention as jax_full_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_backward_ref, attention_lse_ref, attention_ref, flash_attention,
    flash_attention_backward, ops)

REL = 1e-5
GRAD_REL = 1e-4
F32, BF16, F16 = "float32", "bfloat16", "float16"
BITS16 = {torch.bfloat16: 8, torch.float16: 11}  # significand bits, the implicit one included

# b, s, h, kv, d, causal, window, dtypes of (q, k, v)
CASES = {
    "d8-f32": (2, 24, 2, 2, 8, True, None, (F32,) * 3),
    "d8-f16": (2, 24, 2, 2, 8, True, None, (F16,) * 3),
    "d40-f16-gqa": (1, 30, 4, 2, 40, True, None, (F16,) * 3),
    "d96-f32-window": (1, 40, 2, 2, 96, True, 12, (F32,) * 3),
    "d100-f16": (1, 20, 2, 2, 100, True, None, (F16,) * 3),
    "d160-f32": (1, 20, 2, 2, 160, False, None, (F32,) * 3),
    "d160-f16-gqa-window": (1, 24, 4, 1, 160, True, 8, (F16,) * 3),
    "d256-f32": (1, 20, 2, 2, 256, True, None, (F32,) * 3),
    "d256-f16": (1, 20, 2, 2, 256, True, None, (F16,) * 3),
    "mixed-d40": (1, 20, 2, 2, 40, True, None, (F16, F32, BF16)),
}
MLA_CASE = (1, 24, 2, 2, 96, 64)  # b, s, h, kv, dqk, dv: causal, float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread: the suite runs beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, s, h, kv, dqk, dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dqk), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, dqk), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, dv), dtype=np.float32)
    do = rng.standard_normal((b, s, h, dv), dtype=np.float32)
    return (q, k, v), do


def _case_inputs(name):
    b, s, h, kv, d, causal, window, dtypes = CASES[name]
    x, do = _inputs(b, s, h, kv, d, d, seed=d * 100 + h + s)
    return x, do, dtypes


def _np(x):
    """A JAX or torch array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel):
    """The float32 rule for float32 ``got``; a 16-bit ``got`` equal to
    ``want`` rounded to its dtype or one step of it away (its ulp, at
    least the smallest subnormal's), beyond the float32 tolerance."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    tol = rel * max(1.0, float(np.abs(w).max()))
    if got.dtype in BITS16:
        r16 = torch.from_numpy(w).to(got.dtype).float()
        _, e = torch.frexp(r16)
        ulp = torch.where(r16 == 0, torch.zeros_like(r16),
                          torch.ldexp(torch.ones_like(r16), e - BITS16[got.dtype]))
        ulp = ulp.clamp(min=torch.finfo(got.dtype).smallest_normal * torch.finfo(got.dtype).eps)
        excess = ((torch.from_numpy(g) - r16).abs() - tol).clamp(min=0.0)
        steps = float((excess / ulp).max())
        assert steps <= 1.0, f"{steps:.2f} {got.dtype} steps off the reference rounded"
        return
    err = float(np.abs(g - w).max())
    assert err <= tol, f"max abs err {err:.3e} > {tol:.3e}"


def _jax_attention(q, k, v, *, causal, window):
    """The reference's plain attention in model layout with GQA: each kv
    head repeated over its group, (B, S, H, D) folded to (B H, S, D)."""
    b, s, h, dqk = q.shape
    rep = h // k.shape[2]
    k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)

    def fold(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], x.shape[3])

    out = jax_attention_ref(fold(q), fold(k), fold(v), causal=causal, window=window)
    return out.reshape(b, h, s, v.shape[3]).transpose(0, 2, 1, 3)


def _jax_grads(x, do, causal, window):
    """jax.grad of the plain attention on ``x`` widened to float32 (one
    compiled program: op by op, the first call of each shape costs
    seconds)."""
    def loss(q, k, v, do):
        return jnp.sum(_jax_attention(q, k, v, causal=causal, window=window) * do)

    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
    return grad(*[jnp.asarray(a) for a in x], jnp.asarray(do))


@pytest.fixture(scope="module")
def refs():
    """Each case's Pallas kernel output in interpret mode, and jax.grad of
    the plain attention, on the case's inputs (each in its dtype, widened
    for the gradient)."""
    out = {}
    for name, case in CASES.items():
        b, s, h, kv, d, causal, window, dtypes = case
        x, do, _ = _case_inputs(name)
        jx = [jnp.asarray(a).astype(getattr(jnp, dt)) for a, dt in zip(x, dtypes)]
        fwd = jax_flash_attention(*jx, causal=causal, window=window, interpret=True)
        wide = [_np(a) for a in jx]
        out[name] = (fwd, _jax_grads(wide, do, causal, window))
    return out


def _torch_inputs(x, dtypes):
    return [torch.from_numpy(a).to(getattr(torch, dt)) for a, dt in zip(x, dtypes)]


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_pallas_interpret(refs, name):
    b, s, h, kv, d, causal, window, dtypes = CASES[name]
    x, _, _ = _case_inputs(name)
    out = flash_attention(*_torch_inputs(x, dtypes), causal=causal, window=window)
    want = refs[name][0]
    assert out.dtype == getattr(torch, dtypes[0])
    assert str(jnp.asarray(want).dtype) == dtypes[0]
    _close(out, want, REL)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax_grad(refs, name):
    """Through autograd, and through ``flash_attention_backward`` from the
    float32 forward's output and the log-sum-exp: each gradient in its
    input's dtype."""
    b, s, h, kv, d, causal, window, dtypes = CASES[name]
    x, do, _ = _case_inputs(name)
    leaves = [t.requires_grad_() for t in _torch_inputs(x, dtypes)]
    out = flash_attention(*leaves, causal=causal, window=window)
    do_t = torch.from_numpy(do).to(out.dtype)
    grads = torch.autograd.grad(out, leaves, do_t)
    q, k, v = (t.detach() for t in leaves)
    # The output unrounded (the float32 copies' forward): delta = rowsum(dO
    # O) from a rounded O would move dq and dk off the exact gradient.
    out32 = attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    direct = flash_attention_backward(q, k, v, out32, lse, do_t, causal=causal, window=window)
    want = _jax_grads([_np(t) for t in leaves], _np(do_t), causal, window)
    for g, dg, w, leaf in zip(grads, direct, want, leaves):
        assert g.dtype == dg.dtype == leaf.dtype
        _close(g, w, GRAD_REL)
        _close(dg, w, GRAD_REL)


def test_unequal_head_dims_match_full_attention():
    """(96, 64), which the port's MLA route can send, against the
    reference model's ``full_attention`` (forward) and jax.grad of the
    plain attention (its gradients)."""
    b, s, h, kv, dqk, dv = MLA_CASE
    x, do = _inputs(b, s, h, kv, dqk, dv, seed=96)
    leaves = [torch.from_numpy(a).requires_grad_() for a in x]
    out = flash_attention(*leaves)
    _close(out, jax_full_attention(*[jnp.asarray(a) for a in x], causal=True), REL)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(grads, _jax_grads(x, do, True, None)):
        _close(g, w, GRAD_REL)


@pytest.mark.parametrize("dims, inst", [
    ((8, 8), (16, 16)), ((16, 16), (16, 16)), ((24, 24), (32, 32)), ((40, 32), (48, 32)),
    ((40, 40), (64, 64)), ((96, 64), (128, 128)), ((100, 100), (128, 128)),
    ((160, 128), (192, 128)), ((160, 160), (256, 256)), ((200, 100), (256, 256)),
    ((256, 256), (256, 256)), ((1, 256), (256, 256)),
])
def test_a_call_runs_on_the_smallest_instance_that_holds_it(dims, inst):
    for dtype in ops.DTYPES:
        assert ops.reach_error(dtype, *dims) is None
        assert ops.instance(dtype, *dims) == inst
        assert inst in ops.HEAD_DIMS[dtype]
    wgmma = inst in ((64, 64), (128, 128), (192, 128))
    assert ops.uses_wgmma(torch.float16, *dims) == wgmma == ops.uses_wgmma(torch.bfloat16, *dims)
    assert not ops.uses_wgmma(torch.float32, *dims)


@pytest.mark.parametrize("dtype, dims, limit", [
    (torch.float32, (257, 64), "MAX_HEAD_DIM"),
    (torch.float16, (64, 257), "MAX_HEAD_DIM"),
    (torch.bfloat16, (320, 320), "MAX_HEAD_DIM"),
    (torch.float64, (64, 64), "DTYPES"),
])
def test_reach_error_names_its_limit(dtype, dims, limit):
    assert limit in ops.reach_error(dtype, *dims)


def test_cuda_route_refuses_outside_the_reach():
    """A call the kernels do not take raises on the CUDA route, naming the
    limit (the check runs before any tensor is read, so meta tensors
    show it here); the CPU route computes both."""
    q = torch.empty((1, 8, 2, 257), device="meta")
    with pytest.raises(ValueError, match="MAX_HEAD_DIM"):
        ops._cuda_checks(q, q, q)
    q64 = torch.empty((1, 8, 2, 64), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="DTYPES"):
        ops._cuda_checks(q64, q64, q64)
    x = torch.randn((1, 8, 2, 257), dtype=torch.float64)
    assert flash_attention(x, x, x).dtype == torch.float64


@pytest.mark.parametrize("dqk, dv", [(8, 8), (40, 40), (96, 64), (160, 160)])
def test_zero_channel_padding_keeps_the_function(dqk, dv):
    """The CUDA op body runs a call on its instance's head dims, q, k and
    v padded by zero channels (``_padded``), with the caller's scale, and
    keeps its own columns (``_own``): on the plain versions the padded
    call gives the unpadded call's output, log-sum-exp and gradients."""
    x, do = _inputs(1, 20, 4, 2, dqk, dv, seed=dqk + dv)
    q, k, v = (torch.from_numpy(a) for a in x)
    do = torch.from_numpy(do)
    di, dvi = ops.instance(torch.float32, dqk, dv)
    scale = 1.0 / math.sqrt(dqk)
    pq, pk, pv, pdo = ops._padded(q, di), ops._padded(k, di), ops._padded(v, dvi), ops._padded(do, dvi)
    assert (pq.shape[3], pv.shape[3]) == (di, dvi)
    out = attention_ref(q, k, v)
    p_out = attention_ref(pq, pk, pv, softmax_scale=scale)
    assert not p_out[..., dv:].any()
    _close(ops._own(p_out, dv), out, REL)
    lse = attention_lse_ref(q, k)
    _close(attention_lse_ref(pq, pk, softmax_scale=scale), lse, REL)
    want = attention_backward_ref(q, k, v, out, lse, do)
    got = attention_backward_ref(pq, pk, pv, p_out, lse, pdo, softmax_scale=scale)
    for g, w, width in zip(got, want, (dqk, dqk, dv)):
        _close(ops._own(g, width), w, GRAD_REL)
