"""Port WKV recurrence vs the JAX package.

The port's ``wkv`` on CPU tensors (its plain version, the chunked form) is
held against the JAX Pallas kernel in interpret mode and against JAX's
step-by-step ``wkv_scan_ref``; the port's ``wkv_scan_ref`` and
``wkv_chunked`` with an initial state against their JAX counterparts.  The
plain version of the kernel's two passes, ``wkv_chunk_states`` (the state
entering each chunk) and ``wkv_chunk_output`` (every chunk's output from
it), is held against ``wkv_chunked``, the JAX scan oracle and, chunk by
chunk, the final state of the Pallas kernel run on the tokens before it.
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
from repro_torch.kernels.rwkv6_wkv import (  # noqa: E402
    LOG_DECAY_MIN, wkv, wkv_chunk_output, wkv_chunk_states, wkv_chunked, wkv_scan_ref,
)
from repro_torch.kernels.rwkv6_wkv import ops  # noqa: E402

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


@pytest.mark.parametrize("b,t,h,k,chunk", CASES, ids=CASE_IDS)
def test_chunk_states_match_pallas_on_each_prefix(b, t, h, k, chunk):
    """S_c, the state entering chunk c, is the final state of the Pallas
    kernel run on the first c * C tokens (zero for c = 0); the state after
    the last chunk is its final state on all T."""
    r, kk, v, lw, u, _ = _inputs(b, t, h, k, seed=4)
    c = min(chunk, t)
    states, final = wkv_chunk_states(*map(torch.from_numpy, (kk, v, lw)), chunk=chunk)
    n_chunks = -(-t // c)
    assert states.shape == (b, h, n_chunks, k, k) and states.dtype == torch.float32
    assert not states[:, :, 0].any()
    for i in range(1, n_chunks):
        prefix = (jnp.asarray(x[:, : i * c]) for x in (r, kk, v, lw))
        _, want = jax_wkv(*prefix, jnp.asarray(u), chunk=c)
        _close(states[:, :, i].numpy(), want)
    _, want = jax_wkv(*map(jnp.asarray, (r, kk, v, lw, u)), chunk=chunk)
    _close(final.numpy(), want)


@pytest.mark.parametrize("b,t,h,k,chunk", CASES, ids=CASE_IDS)
def test_chunk_output_matches_chunked_and_scan_oracle(b, t, h, k, chunk):
    """The second pass's output, from the first pass's states, equals the
    sequential chunked form and the JAX step-by-step oracle."""
    r, kk, v, lw, u, _ = _inputs(b, t, h, k, seed=5)
    targs = list(map(torch.from_numpy, (r, kk, v, lw, u)))
    states, final = wkv_chunk_states(*targs[1:4], chunk=chunk)
    out = wkv_chunk_output(*targs, states, chunk=chunk)
    want_out, want_state = wkv_chunked(*targs, chunk=chunk)
    _close(out.numpy(), want_out.numpy())
    _close(final.numpy(), want_state.numpy())
    lw_clamped = np.clip(lw, LOG_DECAY_MIN, 0.0)
    want_out, want_state = jax_wkv_scan_ref(*map(jnp.asarray, (r, kk, v, lw_clamped, u)))
    _close(out.numpy(), want_out)
    _close(final.numpy(), want_state)


def test_chunk_states_carry_an_initial_state():
    r, kk, v, lw, u, s0 = _inputs(2, 70, 2, 32, seed=6)
    targs = list(map(torch.from_numpy, (r, kk, v, lw, u)))
    states, final = wkv_chunk_states(*targs[1:4], chunk=32, s0=torch.from_numpy(s0))
    assert torch.equal(states[:, :, 0], torch.from_numpy(s0))
    want_out, want_state = wkv_chunked(*targs, chunk=32, s0=torch.from_numpy(s0))
    _close(wkv_chunk_output(*targs, states, chunk=32).numpy(), want_out.numpy())
    _close(final.numpy(), want_state.numpy())


def test_scores_form_overflows_at_chunk_64_under_strong_decay():
    """Every log-decay at the floor: the mid-point exponents reach
    +-chunk * 4.6 / 2, inside float32 at chunk 32 (73.6) and past it at
    chunk 64 (147.2), where the reference's chunked form and Pallas kernel,
    and the port's plain versions with them, give non-finite outputs.  The
    states (formed as k * exp(L_C - L_t)) stay finite."""
    r, kk, v, _, u, _ = _inputs(1, 128, 2, 64, seed=8)
    lw = np.full_like(r, LOG_DECAY_MIN)
    targs = list(map(torch.from_numpy, (r, kk, v, lw, u)))
    for chunk, finite in ((32, True), (64, False)):
        out, _ = wkv_chunked(*targs, chunk=chunk)
        jax_out, _ = jax_wkv(*map(jnp.asarray, (r, kk, v, lw, u)), chunk=chunk)
        states, final = wkv_chunk_states(*targs[1:4], chunk=chunk)
        pass_out = wkv_chunk_output(*targs, states, chunk=chunk)
        assert bool(torch.isfinite(out).all()) is finite
        assert bool(np.isfinite(np.asarray(jax_out)).all()) is finite
        assert bool(torch.isfinite(pass_out).all()) is finite
        assert torch.isfinite(states).all() and torch.isfinite(final).all()
    assert torch.isfinite(wkv_scan_ref(*targs)[0]).all()


def test_entry_args_block_matches_the_c_struct():
    """ops.py packs the C entry's arguments into one block; its size is the
    one the source's static_assert holds ``EntryArgs`` to."""
    import re

    match = re.search(r"static_assert\(sizeof\(EntryArgs\) == (\d+)", ops.SOURCE.read_text())
    assert match and ops._ENTRY_ARGS.size == int(match.group(1))


@pytest.mark.parametrize(
    "shape, strides, ptr_mod_16, bad",
    [
        ((1, 8, 2, 64), (1024, 128, 64, 1), 0, False),
        ((1, 8, 2, 64), (1024, 128, 64, 1), 4, True),       # base off 16 bytes
        ((1, 8, 2, 64), (1024, 128, 1, 2), 0, True),        # channel dim strided
        ((2, 8, 2, 64), (1026, 128, 64, 1), 0, True),       # batch stride 1026
        ((1, 8, 2, 64), (1026, 128, 64, 1), 0, False),      # ... of a size-1 dim
        ((1, 8, 2, 64), (4096, 512, 66, 1), 0, True),       # head stride 66
    ],
    ids=["dense", "misaligned", "channel-strided", "batch-stride", "size-1-dim", "head-stride"],
)
def test_layout_rule(shape, strides, ptr_mod_16, bad):
    assert (ops.layout_error(shape, strides, ptr_mod_16) is not None) is bad


# ---------------------------------------------------------------------------
# The plain form of the backward kernel's chunked design
# (``wkv_backward_chunked``) against ``jax.grad`` of the reference's
# ``wkv_chunked`` and against ``wkv_backward_ref``.  Tolerance: max abs err
# <= 1e-4 * max(1, max |g|) per output, the backward oracles' own (float32
# sums in another order; dlog_w's cumulative form sums over all of T).
# ---------------------------------------------------------------------------
from test_torch_train_rwkv6 import (  # noqa: E402,F401  (its checks and fixtures)
    _close as _grad_close, wkv_inputs, wkv_jax_grads,
)

from repro_torch.kernels.rwkv6_wkv import (  # noqa: E402
    BACKWARD_CHUNK, wkv_backward_chunked, wkv_backward_ref,
)

@pytest.fixture(scope="module")
def strong_wkv():
    """Strong decay (log-decays in [-4.6, -3.45], a few below the clamp,
    whose gradient is zero), K = 64, T = 45 (a chunk of 32 and a ragged
    13), a final-state gradient: the inputs and ``jax.grad`` of the
    reference's ``wkv_chunked`` (chunk 32, inside its float32 range)."""
    r, kk, v, _, u, _ = _inputs(2, 45, 2, 64, seed=23)
    rng = np.random.default_rng(24)
    lw = (LOG_DECAY_MIN * (1.0 - 0.25 * rng.random(r.shape))).astype(np.float32)
    lw[:, ::7, :, :8] = LOG_DECAY_MIN - 0.5
    d_out = rng.standard_normal(r.shape).astype(np.float32)
    d_state = rng.standard_normal((2, 2, 64, 64)).astype(np.float32)

    def f(*xs):
        out, s = jax_wkv_chunked(*xs, chunk=32)
        return jnp.sum(out * d_out) + jnp.sum(s * d_state)

    want = [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=tuple(range(5))))(
        r, kk, v, lw, u)]
    return (r, kk, v, lw, u), d_out, d_state, want


@pytest.mark.parametrize("final", ["zero", "nonzero"])
def test_backward_chunked_matches_jax_grad_and_the_plain_backward(wkv_inputs, wkv_jax_grads,
                                                                  final):
    """Moderate decays, K = 16, T = 37 (ragged against chunks of 32)."""
    args, d_out, d_state = wkv_inputs
    targs = [torch.from_numpy(x) for x in args]
    ds = torch.from_numpy(d_state) if final == "nonzero" else None
    got = wkv_backward_chunked(*targs, torch.from_numpy(d_out), ds)
    _grad_close([g.numpy() for g in got], wkv_jax_grads[final])
    _grad_close([g.numpy() for g in got],
                [w.numpy() for w in wkv_backward_ref(*targs, torch.from_numpy(d_out), ds)])


@pytest.mark.parametrize("chunk", [BACKWARD_CHUNK, 16])
def test_backward_chunked_under_strong_decay(strong_wkv, chunk):
    """Strong decay, ragged T and a final-state gradient, at the kernel's
    chunk and at 16: finite, and the decomposition does not change the
    function."""
    args, d_out, d_state, want = strong_wkv
    targs = [torch.from_numpy(x) for x in args]
    d_out_t, ds = torch.from_numpy(d_out), torch.from_numpy(d_state)
    got = wkv_backward_chunked(*targs, d_out_t, ds, chunk=chunk)
    assert all(torch.isfinite(g).all() for g in got)
    _grad_close([g.numpy() for g in got], want)
    _grad_close([g.numpy() for g in got],
                [w.numpy() for w in wkv_backward_ref(*targs, d_out_t, ds)])
    assert float(got[3][:, ::7, :, :8].abs().max()) == 0.0  # outside the clamp


def test_backward_entry_and_chunk_match_the_cuda_source():
    """ops.py packs the backward entry's arguments into one block whose size
    the source's static_assert holds ``EntryArgs`` to, and the plain form's
    chunk is the kernel's."""
    import re

    src = ops.BACKWARD_SOURCE.read_text()
    size = re.search(r"static_assert\(sizeof\(EntryArgs\) == (\d+)", src)
    chunk = re.search(r"constexpr int kChunk = (\d+);", src)
    assert size and ops._BACKWARD_ARGS.size == int(size.group(1))
    assert chunk and BACKWARD_CHUNK == int(chunk.group(1))
