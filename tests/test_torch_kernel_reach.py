"""The selective scan's and the WKV kernel's reach on the CPU routes: what
the Pallas kernels take, the port's ``ssm_scan`` and ``wkv`` take too.

Each port entry on CPU tensors (its plain version on inputs widened to
float32 first) is held against the JAX package's Pallas kernel in
interpret mode on the same inputs: bfloat16 and float16 inputs (y or out
in the input's dtype, the state float32), state sizes from 1 to past the
64 of one launch, a chunk of 256 over a padded T, mixed dtypes; head sizes
from 8 to 96, chunks of 100 and 128.  Their gradients on bfloat16 and
float16 inputs are held against ``jax.grad`` of the reference's plain forms
(``repro.models.hymba.selective_scan``, ``repro.models.rwkv6.wkv_chunked``)
on the same values widened.  hymba-1.5b's scan call site, which hands the
kernel the config's bf16 tensors, gives the logits and parameter gradients
of the float32-copy call site before it, bit for bit.

Tolerances: float32 outputs and every state max abs err <= REL * max(1,
max |ref|) (REL = 1e-5 for the forwards, the kernel files' own; 1e-4 for
the gradients, the backward files'); a bfloat16 or float16 output or
gradient must equal the reference rounded to its dtype or lie one step of
that dtype (its ulp) away, beyond that same float32 tolerance.  The CUDA kernels are held
against the plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6_wkv import wkv as jax_wkv  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan  # noqa: E402
from repro.models.hymba import selective_scan as jax_selective_scan  # noqa: E402
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked  # noqa: E402
from repro_torch.configs import get_api  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import wkv  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402

REL = 1e-5
GRAD_REL = 1e-4

# b, t, d, n, chunk, dtypes of (u, dt, b_t, c_t, log_a)
F32, BF16, F16 = "float32", "bfloat16", "float16"
SCAN_CASES = {
    "bf16-n16-d37": (2, 40, 37, 16, 16, (BF16,) * 5),
    "f16-n16-d37": (2, 40, 37, 16, 16, (F16,) * 5),
    "f16-n5": (1, 30, 8, 5, 16, (F16,) * 5),
    "f32-n1": (1, 30, 8, 1, 16, (F32,) * 5),
    "f32-n5": (1, 30, 8, 5, 16, (F32,) * 5),
    "f32-n12": (1, 30, 8, 12, 16, (F32,) * 5),
    "f32-n24": (1, 30, 8, 24, 16, (F32,) * 5),
    "f32-n40": (1, 30, 8, 40, 16, (F32,) * 5),
    "f32-n72": (1, 30, 8, 72, 16, (F32,) * 5),
    "f32-chunk256-t300": (1, 300, 8, 16, 256, (F32,) * 5),
    "mixed": (2, 40, 16, 16, 16, (BF16, F32, BF16, F32, F32)),
    "mixed-f16": (2, 40, 16, 16, 16, (F16, F32, BF16, F16, F32)),
}
# b, t, h, k, chunk, dtype.  Past chunk 64 the log-decays are drawn weaker
# (``_wkv_inputs``): the chunked form's mid-point factors exp(L_C / 2) at
# chunk 128 under decays of e^-1.6 a step would pass float32's range, in
# the reference's form as in the port's.
WKV_CASES = {
    "bf16-k64": (1, 40, 2, 64, 16, BF16),
    "f16-k64": (1, 40, 2, 64, 16, F16),
    "f16-k20": (1, 40, 2, 20, 16, F16),
    "f32-k8": (1, 40, 2, 8, 16, F32),
    "f32-k20": (1, 40, 2, 20, 16, F32),
    "f32-k48": (1, 40, 2, 48, 16, F32),
    "f32-k96": (1, 40, 2, 96, 16, F32),
    "f32-chunk100-t300": (1, 300, 1, 16, 100, F32),
    "f32-chunk128-t300": (1, 300, 1, 16, 128, F32),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread: the suite runs beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _np(x):
    """A JAX or torch array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


# Significand bits of each 16-bit dtype (the implicit one included).
BITS16 = {torch.bfloat16: 8, torch.float16: 11}


def _close(got, want, rel=REL):
    """The float32 rule for float32 ``got``; for bfloat16 or float16 ``got``
    each element equal to ``want`` rounded to that dtype or one step of it
    (its ulp, at least the smallest subnormal's) away, beyond the float32
    tolerance."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    tol = rel * max(1.0, float(np.abs(w).max()))
    if isinstance(got, torch.Tensor) and got.dtype in BITS16:
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


def _scan_inputs(case):
    b, t, d, n, chunk, dtypes = case
    rng = np.random.default_rng(d * 1000 + n)
    u = rng.standard_normal((b, t, d)).astype(np.float32)
    dt = (np.exp(rng.standard_normal((b, t, d)) * 0.5) * 0.3).astype(np.float32)
    bt, ct = (rng.standard_normal((b, t, n)).astype(np.float32) for _ in range(2))
    log_a = (rng.standard_normal((d, n)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((b, t, d)).astype(np.float32)
    dh = rng.standard_normal((b, d, n)).astype(np.float32)
    return (u, dt, bt, ct, log_a), dtypes, dy, dh


def _wkv_inputs(case):
    b, t, h, k, chunk, dtype = case
    rng = np.random.default_rng(k * 1000 + chunk)
    r, kk, v = ((rng.standard_normal((b, t, h, k)) * 0.5).astype(np.float32) for _ in range(3))
    shift = 0.0 if chunk <= 64 else 2.5  # mean log-decay about -1.6 or -0.13 a step
    lw = (-np.exp(rng.standard_normal((b, t, h, k)) - shift)).astype(np.float32)
    u = (rng.standard_normal((h, k)) * 0.2).astype(np.float32)
    dout = rng.standard_normal((b, t, h, k)).astype(np.float32)
    ds = rng.standard_normal((b, h, k, k)).astype(np.float32)
    return (r, kk, v, lw, u), dtype, dout, ds


@pytest.fixture(scope="module")
def scan_refs():
    """Each scan case's Pallas kernel output in interpret mode (y, h)."""
    refs = {}
    for name, case in SCAN_CASES.items():
        x, dtypes, _, _ = _scan_inputs(case)
        jx = [_to_jax(a, dt) for a, dt in zip(x, dtypes)]
        refs[name] = jax_ssm_scan(*jx, chunk=case[4], d_block=case[2], interpret=True)
    return refs


@pytest.fixture(scope="module")
def wkv_refs():
    """Each WKV case's Pallas kernel output in interpret mode (out, state)."""
    refs = {}
    for name, case in WKV_CASES.items():
        x, dtype, _, _ = _wkv_inputs(case)
        refs[name] = jax_wkv(*[_to_jax(a, dtype) for a in x], chunk=case[4], interpret=True)
    return refs


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_scan_matches_pallas_interpret(scan_refs, name):
    case = SCAN_CASES[name]
    x, dtypes, _, _ = _scan_inputs(case)
    y, h = ssm_scan(*[_to_torch(a, dt) for a, dt in zip(x, dtypes)], chunk=case[4])
    want_y, want_h = scan_refs[name]
    assert y.dtype == getattr(torch, dtypes[0]) and h.dtype == torch.float32
    assert str(jnp.asarray(want_y).dtype) == dtypes[0]
    _close(y, want_y)
    _close(h, want_h)


@pytest.mark.parametrize("name", list(WKV_CASES))
def test_wkv_matches_pallas_interpret(wkv_refs, name):
    case = WKV_CASES[name]
    x, dtype, _, _ = _wkv_inputs(case)
    out, state = wkv(*[_to_torch(a, dtype) for a in x], chunk=case[4])
    want_out, want_state = wkv_refs[name]
    assert out.dtype == getattr(torch, dtype) and state.dtype == torch.float32
    assert str(jnp.asarray(want_out).dtype) == dtype
    _close(out, want_out)
    _close(state, want_state)


def _scan_gradients_match_jax_grad(name, dtype):
    """Every gradient of ``ssm_scan`` on the case's inputs (each in its
    input's dtype) against ``jax.grad`` of the reference's plain chunked
    scan on the same values widened."""
    case = SCAN_CASES[name]
    x, dtypes, dy, dh = _scan_inputs(case)
    leaves = [_to_torch(a, dt).requires_grad_() for a, dt in zip(x, dtypes)]
    dy_t = _to_torch(dy, dtype)
    y, h = ssm_scan(*leaves, chunk=case[4])
    grads = torch.autograd.grad((y, h), leaves, (dy_t, torch.from_numpy(dh)))

    def loss(u, dt, bt, ct, log_a):
        yy, hh = jax_selective_scan(u, dt, log_a, bt, ct, chunk=case[4])
        return jnp.sum(yy * jnp.asarray(_np(dy_t))) + jnp.sum(hh * dh)

    wide = [jnp.asarray(_np(leaf)) for leaf in leaves]
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*wide)
    for g, w in zip(grads, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, GRAD_REL)


def _wkv_gradients_match_jax_grad(name):
    """Every gradient of ``wkv`` on the case's inputs against ``jax.grad``
    of the reference's ``wkv_chunked`` on the same values widened."""
    case = WKV_CASES[name]
    x, dtype, dout, ds = _wkv_inputs(case)
    leaves = [_to_torch(a, dtype).requires_grad_() for a in x]
    dout_t = _to_torch(dout, dtype)
    out, state = wkv(*leaves, chunk=case[4])
    grads = torch.autograd.grad((out, state), leaves, (dout_t, torch.from_numpy(ds)))

    def loss(r, k, v, lw, u):
        o, s = jax_wkv_chunked(r, k, v, lw, u, chunk=case[4])
        return jnp.sum(o * jnp.asarray(_np(dout_t))) + jnp.sum(s * ds)

    wide = [jnp.asarray(_np(leaf)) for leaf in leaves]
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*wide)
    for g, w in zip(grads, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, GRAD_REL)


def test_scan_gradients_on_bf16_inputs_match_jax_grad():
    _scan_gradients_match_jax_grad("bf16-n16-d37", BF16)


def test_wkv_gradients_on_bf16_inputs_match_jax_grad():
    _wkv_gradients_match_jax_grad("bf16-k64")


def test_scan_gradients_on_f16_inputs_match_jax_grad():
    """float16, which the parent's wrapper refused on every device."""
    _scan_gradients_match_jax_grad("f16-n16-d37", F16)


def test_wkv_gradients_on_f16_inputs_match_jax_grad():
    _wkv_gradients_match_jax_grad("f16-k64")


@pytest.mark.parametrize("n", [1, 5, 8, 12, 16, 24, 40, 64, 72, 130])
def test_every_state_size_is_inside_the_reach(n):
    """Any N runs on an instance (past 64 as groups of 64), in float32,
    bfloat16 and float16; float64 stays outside, named."""
    assert ssm_ops.reach_error(torch.float32, n, 256) is None
    assert ssm_ops.reach_error(torch.bfloat16, n, 1) is None
    assert ssm_ops.reach_error(torch.float16, n, 64) is None
    assert "DTYPES" in ssm_ops.reach_error(torch.float64, n, 64)
    groups = ssm_ops._groups(n)
    assert [g.stop - g.start for g, _ in groups] == [min(64, n - s) for s in range(0, n, 64)]
    assert all(cols.stop - cols.start == ssm_ops.instance(g.stop - g.start) for g, cols in groups)


@pytest.mark.parametrize("k, chunk, why", [
    (8, 128, None), (20, 100, None), (64, 128, None), (96, 64, None), (128, 64, None),
    (128, 65, "MAX_CHUNK_K128"), (129, 16, "HEAD_SIZES"), (64, 129, "MAX_CHUNK"),
])
def test_wkv_reach_names_its_limits(k, chunk, why):
    got = wkv_ops.reach_error(torch.float32, k, chunk)
    assert (got is None) if why is None else (why in got)
    assert wkv_ops.reach_error(torch.bfloat16, k, chunk) == got
    assert wkv_ops.reach_error(torch.float16, k, chunk) == got
    assert "DTYPES" in wkv_ops.reach_error(torch.float64, k, chunk)


def test_hymba_bf16_call_site_matches_the_float32_copies_bit_for_bit():
    """Reduced hymba-1.5b in its own bf16: the scan handed the bf16 tensors
    (the default call site) and the call site before it (float32 copies of
    u, dt, b_t, c_t and log_a, y cast back), through the ``scan`` seam,
    give the same logits and parameter gradients bit for bit."""
    api = get_api("hymba-1.5b", reduced=True)
    assert api.cfg.compute_dtype == torch.bfloat16
    model = api.init(0, device="cpu")
    tokens = torch.randint(0, api.cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(3))
    params = [p.requires_grad_() for p in model.parameters()]

    def float_copies(u, dt, b_t, c_t, log_a, chunk):
        y, h = ssm_scan(u.float(), dt.float(), b_t.float(), c_t.float(), log_a.float(),
                        chunk=chunk)
        return y.to(u.dtype), h

    seen = []

    def recorded(u, dt, b_t, c_t, log_a, chunk):
        seen.append({x.dtype for x in (u, dt, b_t, c_t, log_a)})
        return ssm_scan(u, dt, b_t, c_t, log_a, chunk=chunk)

    results = []
    for seam in (recorded, float_copies):
        logits = model.train_forward(tokens, scan=seam)
        loss = logits.float().square().mean()
        results.append((logits.detach(), torch.autograd.grad(loss, params)))
    assert seen and all(s == {torch.bfloat16} for s in seen)
    (new_logits, new_grads), (old_logits, old_grads) = results
    assert torch.equal(new_logits, old_logits)
    assert all(torch.equal(a, b) for a, b in zip(new_grads, old_grads))
    with torch.no_grad():
        assert torch.equal(model.train_forward(tokens), new_logits)


@pytest.mark.parametrize("k", [20, 96])
def test_wkv_zero_channel_padding_keeps_each_channel(k):
    """The CUDA wrapper runs a head size short of its instance on copies
    padded by zero channels (``_rows``; a state by ``_square``) and keeps
    its own channels (``_channels``): on the plain versions the padded call
    gives the unpadded call's out, state and gradients, and the padded
    channels' state rows and columns stay 0."""
    case = (1, 40, 2, k, 16, F32)
    x, dtype, dout, ds = _wkv_inputs(case)
    r, kk, v, lw, u = (_to_torch(a, dtype) for a in x)
    ki = wkv_ops.instance(k)
    padded = [wkv_ops._rows(t, ki) for t in (r, kk, v, lw, u)]
    assert all(t.shape[-1] == ki for t in padded)
    out, state = wkv_ops.wkv_chunked(r, kk, v, lw, u, chunk=case[4])
    p_out, p_state = wkv_ops.wkv_chunked(*padded, chunk=case[4])
    assert not p_state[..., k:, :].any() and not p_state[..., :, k:].any()
    _close(wkv_ops._channels(p_out, k), out)
    _close(wkv_ops._channels(p_state, k, 2), state)
    d_out, d_state = torch.from_numpy(dout), torch.from_numpy(ds)
    want = wkv_ops.wkv_backward_ref(r, kk, v, lw, u, d_out, d_state)
    got = wkv_ops.wkv_backward_ref(*padded, wkv_ops._rows(d_out, ki),
                                   wkv_ops._square(d_state, ki))
    for g, w in zip(got, want):
        _close(wkv_ops._channels(g, k), w, GRAD_REL)


@pytest.mark.parametrize("entry", ["wkv", "ssm_scan"])
def test_cuda_route_names_a_dtype_it_does_not_take(entry):
    """The dtype check lives in the CUDA route's ``reach_error``: float64
    is refused there, named, while the CPU route takes it as the reference
    does (the plain version widens every input)."""
    if entry == "wkv":
        ops, args = wkv_ops, (torch.float64, 64, 16)
    else:
        ops, args = ssm_ops, (torch.float64, 16, 16)
    assert "DTYPES" in ops.reach_error(*args)
    if entry == "wkv":
        x, _, _, _ = _wkv_inputs(WKV_CASES["f32-k8"])
        out, state = wkv(*[torch.from_numpy(a).double() for a in x], chunk=16)
    else:
        x, _, _, _ = _scan_inputs(SCAN_CASES["f32-n5"])
        out, state = ssm_scan(*[torch.from_numpy(a).double() for a in x], chunk=16)
    assert out.dtype == torch.float64 and state.dtype == torch.float32
