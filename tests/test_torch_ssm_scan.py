"""Port selective scan vs the JAX package.

The port's ``ssm_scan`` on CPU tensors (its plain version, the step-by-step
``selective_scan_ref``) is held against the JAX Pallas kernel in interpret
mode and against JAX's ``selective_scan_ref`` and chunked
``selective_scan``; the port's ``selective_scan_ref`` with a carried state
against its JAX counterparts.  Tolerance: max abs err <= 1e-5 * max(1,
max |ref|), y and final state — float32 sums in another order.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan  # noqa: E402
from repro.models.hymba import selective_scan as jax_selective_scan  # noqa: E402
from repro.models.hymba import selective_scan_ref as jax_selective_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import selective_scan_ref, ssm_scan  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

REL = 1e-5

CASES = [
    # b, t, d, n, chunk
    (1, 64, 32, 16, 16),
    (2, 40, 48, 8, 16),     # ragged T, B > 1, N 8
    (1, 100, 64, 16, 32),   # ragged T
    (2, 7, 16, 16, 8),      # T < chunk
    (1, 130, 40, 8, 64),    # ragged T, D not a power of two
]
CASE_IDS = [f"b{b}-t{t}-d{d}-n{n}-c{c}" for b, t, d, n, c in CASES]


def _inputs(b, t, d, n, seed=0, *, strong=False):
    """dt > 0 as softplus gives it, A = -exp(log_a) < 0; ``strong`` draws
    large decays (dt * |A| up to ~50), the state forgets within a step."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, d)).astype(np.float32)
    scale = 3.0 if strong else 0.3
    dt = (np.exp(rng.standard_normal((b, t, d)) * 0.5) * scale).astype(np.float32)
    bt, ct = (rng.standard_normal((b, t, n)).astype(np.float32) for _ in range(2))
    log_a = (rng.standard_normal((d, n)) * (1.0 if strong else 0.5)).astype(np.float32)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32)
    return u, dt, bt, ct, log_a, h0


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = REL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max abs err {err:.3e} > {tol:.3e}"


@pytest.fixture(autouse=True)
def _count_from_zero():
    ssm_scan.launches = 0
    yield
    ssm_scan.launches = 0


@pytest.mark.parametrize("b,t,d,n,chunk", CASES, ids=CASE_IDS)
def test_plain_version_matches_pallas_interpret(b, t, d, n, chunk):
    u, dt, bt, ct, log_a, _ = _inputs(b, t, d, n)
    want_y, want_h = jax_ssm_scan(
        *map(jnp.asarray, (u, dt, bt, ct, log_a)), chunk=chunk, d_block=d, interpret=True
    )
    y, h = ssm_scan(*map(torch.from_numpy, (u, dt, bt, ct, log_a)), chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    _close(y.numpy(), want_y)
    _close(h.numpy(), want_h)
    assert ssm_scan.launches == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("strong", [False, True], ids=["moderate", "strong-decay"])
@pytest.mark.parametrize("b,t,d,n,chunk", CASES, ids=CASE_IDS)
def test_plain_version_matches_jax_scans(b, t, d, n, chunk, strong):
    u, dt, bt, ct, log_a, _ = _inputs(b, t, d, n, seed=1, strong=strong)
    got = ssm_scan(*map(torch.from_numpy, (u, dt, bt, ct, log_a)), chunk=chunk)
    jargs = list(map(jnp.asarray, (u, dt, log_a, bt, ct)))
    for want in (jax_selective_scan_ref(*jargs), jax_selective_scan(*jargs, chunk=chunk)):
        for g, w in zip(got, want):
            _close(g.numpy(), w)


@pytest.mark.parametrize("b,t,d,n,chunk", CASES[:4], ids=CASE_IDS[:4])
def test_carried_state_matches_jax(b, t, d, n, chunk):
    """The decode path's scan from a given h0, against both JAX forms."""
    u, dt, bt, ct, log_a, h0 = _inputs(b, t, d, n, seed=2)
    jargs = list(map(jnp.asarray, (u, dt, log_a, bt, ct)))
    got = selective_scan_ref(*map(torch.from_numpy, (u, dt, log_a, bt, ct)),
                             h0=torch.from_numpy(h0))
    for want in (jax_selective_scan_ref(*jargs, h0=jnp.asarray(h0)),
                 jax_selective_scan(*jargs, chunk=chunk, h0=jnp.asarray(h0))):
        for g, w in zip(got, want):
            _close(g.numpy(), w)


def test_scan_keeps_bfloat16_output_dtype():
    """Decode in a bf16 model feeds bf16 u/dt/B/C: y keeps u's dtype, the
    state stays float32, as in the reference."""
    u, dt, bt, ct, log_a, _ = _inputs(1, 3, 8, 16, seed=3)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    y, h = selective_scan_ref(bf(u), bf(dt), bf(log_a), bf(bt), bf(ct))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


@pytest.mark.parametrize(
    "shapes, dtype, kwargs",
    [
        (((1, 8, 4), (1, 8, 5), (1, 8, 16), (1, 8, 16), (4, 16)), torch.float32, {}),  # dt shape
        (((1, 8, 4), (1, 8, 4), (1, 8, 16), (1, 8, 8), (4, 16)), torch.float32, {}),   # c_t shape
        (((1, 8, 4), (1, 8, 4), (1, 7, 16), (1, 7, 16), (4, 16)), torch.float32, {}),  # b_t T
        (((1, 8, 4), (1, 8, 4), (1, 8, 16), (1, 8, 16), (4, 8)), torch.float32, {}),   # log_a
        (((8, 4),) * 2 + ((8, 16),) * 2 + ((4, 16),), torch.float32, {}),              # rank
        (((1, 0, 4),) * 2 + ((1, 0, 16),) * 2 + ((4, 16),), torch.float32, {}),        # T = 0
        (((1, 8, 4),) * 2 + ((1, 8, 16),) * 2 + ((4, 16),), torch.bfloat16, {}),       # dtype
        (((1, 8, 4),) * 2 + ((1, 8, 16),) * 2 + ((4, 16),), torch.float32, {"chunk": 0}),
    ],
    ids=["dt-shape", "c_t-shape", "b_t-T", "log_a-shape", "rank", "empty-T", "bf16", "chunk-0"],
)
def test_wrapper_rejects_bad_calls(shapes, dtype, kwargs):
    u, dt, bt, ct, log_a = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises(ValueError):
        ssm_scan(u, dt, bt, ct, log_a, **kwargs)
