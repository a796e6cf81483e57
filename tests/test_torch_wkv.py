"""Port WKV recurrence vs the JAX package.

The port's ``wkv`` on CPU tensors (its plain version, the chunked form) is
held against the JAX Pallas kernel in interpret mode and against JAX's
step-by-step ``wkv_scan_ref``; the port's ``wkv_scan_ref`` and
``wkv_chunked`` with an initial state against their JAX counterparts.
Tolerance: max abs err <= 1e-5 * max(1, max |ref|), out and state — float32
sums in another order, through decay factors up to exp(chunk * 4.6 / 2).
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6_wkv import wkv as jax_wkv  # noqa: E402
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked  # noqa: E402
from repro.models.rwkv6 import wkv_scan_ref as jax_wkv_scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import LOG_DECAY_MIN, wkv, wkv_chunked, wkv_scan_ref  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

REL = 1e-5

CASES = [
    # b, t, h, k, chunk
    (1, 64, 2, 64, 32),
    (2, 100, 2, 64, 32),    # ragged T, B > 1
    (1, 96, 3, 32, 16),
    (2, 40, 2, 16, 64),     # T < chunk
    (1, 130, 2, 64, 64),    # ragged T, chunk 64
    (2, 70, 2, 32, 32),     # ragged T, B > 1, K 32
]
CASE_IDS = [f"b{b}-t{t}-h{h}-k{k}-c{c}" for b, t, h, k, c in CASES]


def _inputs(b, t, h, k, seed=0):
    rng = np.random.default_rng(seed)
    r, kk, v = ((rng.standard_normal((b, t, h, k)) * 0.5).astype(np.float32) for _ in range(3))
    lw = (-np.exp(rng.standard_normal((b, t, h, k)))).astype(np.float32)
    u = (rng.standard_normal((h, k)) * 0.2).astype(np.float32)
    s0 = rng.standard_normal((b, h, k, k)).astype(np.float32)
    return r, kk, v, lw, u, s0


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = REL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max abs err {err:.3e} > {tol:.3e}"


@pytest.fixture(autouse=True)
def _count_from_zero():
    wkv.launches = 0
    yield
    wkv.launches = 0


@pytest.mark.parametrize("b,t,h,k,chunk", CASES, ids=CASE_IDS)
def test_plain_version_matches_pallas_interpret(b, t, h, k, chunk):
    r, kk, v, lw, u, _ = _inputs(b, t, h, k)
    want_out, want_state = jax_wkv(*map(jnp.asarray, (r, kk, v, lw, u)), chunk=chunk)
    out, state = wkv(*map(torch.from_numpy, (r, kk, v, lw, u)), chunk=chunk)
    assert out.dtype == state.dtype == torch.float32
    _close(out.numpy(), want_out)
    _close(state.numpy(), want_state)
    assert wkv.launches == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("b,t,h,k,chunk", CASES, ids=CASE_IDS)
def test_plain_version_matches_jax_scan_oracle(b, t, h, k, chunk):
    r, kk, v, lw, u, _ = _inputs(b, t, h, k, seed=1)
    lw_clamped = np.clip(lw, LOG_DECAY_MIN, 0.0)
    want_out, want_state = jax_wkv_scan_ref(*map(jnp.asarray, (r, kk, v, lw_clamped, u)))
    out, state = wkv(*map(torch.from_numpy, (r, kk, v, lw, u)), chunk=chunk)
    _close(out.numpy(), want_out)
    _close(state.numpy(), want_state)


@pytest.mark.parametrize("b,t,h,k,chunk", CASES[:4], ids=CASE_IDS[:4])
def test_carried_state_matches_jax(b, t, h, k, chunk):
    """The decode path's scan and the chunked form, both from a given s0."""
    r, kk, v, lw, u, s0 = _inputs(b, t, h, k, seed=2)
    jargs = list(map(jnp.asarray, (r, kk, v, lw, u)))
    targs = list(map(torch.from_numpy, (r, kk, v, lw, u)))
    want = jax_wkv_scan_ref(*jargs, s0=jnp.asarray(s0))
    got = wkv_scan_ref(*targs, s0=torch.from_numpy(s0))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    want = jax_wkv_chunked(*jargs, chunk=chunk, s0=jnp.asarray(s0))
    got = wkv_chunked(*targs, chunk=chunk, s0=torch.from_numpy(s0))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_scan_keeps_bfloat16_output_dtype():
    """Decode in a bf16 model feeds bf16 r/k/v: out keeps r's dtype, the
    state stays float32, as in the reference."""
    r, kk, v, lw, u, _ = _inputs(1, 3, 2, 16, seed=3)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    out, state = wkv_scan_ref(bf(r), bf(kk), bf(v), torch.from_numpy(lw), torch.from_numpy(u))
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32


@pytest.mark.parametrize(
    "shapes, dtype, kwargs",
    [
        (((1, 8, 2, 16),) * 3 + ((1, 8, 2, 8),) + ((2, 16),), torch.float32, {}),  # log_w shape
        (((1, 8, 2, 16),) * 4 + ((3, 16),), torch.float32, {}),                    # u shape
        (((8, 2, 16),) * 4 + ((2, 16),), torch.float32, {}),                       # rank
        (((1, 0, 2, 16),) * 4 + ((2, 16),), torch.float32, {}),                    # T = 0
        (((1, 8, 2, 16),) * 4 + ((2, 16),), torch.bfloat16, {}),                   # dtype
        (((1, 8, 2, 16),) * 4 + ((2, 16),), torch.float32, {"chunk": 0}),
    ],
    ids=["log_w-shape", "u-shape", "rank", "empty-T", "bf16", "chunk-0"],
)
def test_wrapper_rejects_bad_calls(shapes, dtype, kwargs):
    r, k, v, lw, u = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises(ValueError):
        wkv(r, k, v, lw, u, **kwargs)
