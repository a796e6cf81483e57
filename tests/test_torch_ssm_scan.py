"""Port selective scan vs the JAX package.

The port's ``ssm_scan`` on CPU tensors (its plain version, the step-by-step
``selective_scan_ref``) is held against the JAX Pallas kernel in interpret
mode and against JAX's ``selective_scan_ref`` and chunked
``selective_scan``; the port's ``selective_scan_ref`` with a carried state
against its JAX counterparts.  Tolerance: max abs err <= 1e-5 * max(1,
max |ref|), y and final state — float32 sums in another order.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  The plain version of
the kernel's segment structure, ``selective_scan_segments``, is held here:
the state entering segment s against the Pallas kernel's final state on the
first s * L tokens, and the assembled y against the JAX scans.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan  # noqa: E402
from repro.models.hymba import selective_scan as jax_selective_scan  # noqa: E402
from repro.models.hymba import selective_scan_ref as jax_selective_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    SEGMENT_STEPS, selective_scan_ref, selective_scan_segments, ssm_scan,
)

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


def test_wrapper_takes_float16_as_the_reference_does():
    """float16, which the Pallas kernel widens, runs on the CPU route: y in
    u's dtype, the state float32, the values of the float32 call."""
    u, dt, bt, ct, log_a, _ = _inputs(1, 20, 8, 16, seed=3)
    half = [torch.from_numpy(x).half() for x in (u, dt, bt, ct, log_a)]
    y, h = ssm_scan(*half, chunk=8)
    want_y, want_h = ssm_scan(*[x.float() for x in half], chunk=8)
    assert y.dtype == torch.float16 and h.dtype == torch.float32
    assert torch.equal(y, want_y.half()) and torch.equal(h, want_h)


@pytest.mark.parametrize(
    "shapes, dtype, kwargs",
    [
        (((1, 8, 4), (1, 8, 5), (1, 8, 16), (1, 8, 16), (4, 16)), torch.float32, {}),  # dt shape
        (((1, 8, 4), (1, 8, 4), (1, 8, 16), (1, 8, 8), (4, 16)), torch.float32, {}),   # c_t shape
        (((1, 8, 4), (1, 8, 4), (1, 7, 16), (1, 7, 16), (4, 16)), torch.float32, {}),  # b_t T
        (((1, 8, 4), (1, 8, 4), (1, 8, 16), (1, 8, 16), (4, 8)), torch.float32, {}),   # log_a
        (((8, 4),) * 2 + ((8, 16),) * 2 + ((4, 16),), torch.float32, {}),              # rank
        (((1, 0, 4),) * 2 + ((1, 0, 16),) * 2 + ((4, 16),), torch.float32, {}),        # T = 0
        (((1, 8, 4),) * 2 + ((1, 8, 16),) * 2 + ((4, 16),), torch.float32, {"chunk": 0}),
    ],
    ids=["dt-shape", "c_t-shape", "b_t-T", "log_a-shape", "rank", "empty-T", "chunk-0"],
)
def test_wrapper_rejects_bad_calls(shapes, dtype, kwargs):
    u, dt, bt, ct, log_a = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises(ValueError):
        ssm_scan(u, dt, bt, ct, log_a, **kwargs)


SEG_CASES = [
    # b, t, d, seg
    (1, 64, 32, SEGMENT_STEPS),    # whole segments
    (2, 45, 24, SEGMENT_STEPS),    # ragged T, B > 1
    (1, 5, 16, SEGMENT_STEPS),     # T below one segment
    (1, 50, 40, 16),               # ragged T, longer segments
]
SEG_IDS = [f"b{b}-t{t}-d{d}-seg{L}" for b, t, d, L in SEG_CASES]


@pytest.mark.parametrize("strong", [False, True], ids=["moderate", "strong-decay"])
@pytest.mark.parametrize("b,t,d,seg", SEG_CASES, ids=SEG_IDS)
def test_segment_states_match_pallas_on_each_prefix(b, t, d, seg, strong):
    """The state entering segment s is the Pallas kernel's final state on
    the first s * seg tokens (zero for s = 0)."""
    u, dt, bt, ct, log_a, _ = _inputs(b, t, d, 16, seed=4, strong=strong)
    _, _, states = selective_scan_segments(
        *map(torch.from_numpy, (u, dt, log_a, bt, ct)), seg=seg)
    assert states.shape == (b, -(-t // seg), d, 16)
    assert not states[:, 0].any()
    for s in range(1, states.shape[1]):
        k = s * seg
        _, want_h = jax_ssm_scan(*(jnp.asarray(x[:, :k]) for x in (u, dt, bt, ct)),
                                 jnp.asarray(log_a), chunk=seg, d_block=d, interpret=True)
        _close(states[:, s].numpy(), want_h)


@pytest.mark.parametrize("strong", [False, True], ids=["moderate", "strong-decay"])
@pytest.mark.parametrize("b,t,d,seg", SEG_CASES, ids=SEG_IDS)
def test_segment_assembly_matches_jax_scans(b, t, d, seg, strong):
    """y from segment-local scans plus the carried state, and the final
    state, against JAX's ``selective_scan``, its ``selective_scan_ref`` and
    the port's step-by-step oracle."""
    u, dt, bt, ct, log_a, _ = _inputs(b, t, d, 16, seed=5, strong=strong)
    targs = list(map(torch.from_numpy, (u, dt, log_a, bt, ct)))
    y, h, _ = selective_scan_segments(*targs, seg=seg)
    assert y.dtype == h.dtype == torch.float32 and y.shape == (b, t, d)
    jargs = list(map(jnp.asarray, (u, dt, log_a, bt, ct)))
    for want in (jax_selective_scan(*jargs, chunk=seg), jax_selective_scan_ref(*jargs),
                 selective_scan_ref(*targs)):
        _close(y.numpy(), want[0])
        _close(h.numpy(), want[1])


def test_entry_args_block_and_segment_match_the_cuda_source():
    """ops.py packs the C entry's arguments into one block whose size the
    source's static_assert holds ``EntryArgs`` to, and the plain segment
    structure uses the kernel's segment length."""
    import re

    from repro_torch.kernels.ssm_scan import ops

    src = ops.SOURCE.read_text()
    size = re.search(r"static_assert\(sizeof\(EntryArgs\) == (\d+)", src)
    seg = re.search(r"constexpr int kSeg = (\d+);", src)
    assert size and ops._ENTRY_ARGS.size == int(size.group(1))
    assert seg and SEGMENT_STEPS == int(seg.group(1))


# ---------------------------------------------------------------------------
# The plain form of the backward kernel's segment design
# (``ssm_scan_backward_segments``) against ``jax.grad`` of the reference's
# ``selective_scan`` and against ``ssm_scan_backward_ref``.  Tolerance: max
# abs err <= 1e-4 * max(1, max |g|) per output, the backward oracles' own
# (float32 sums in another order).
# ---------------------------------------------------------------------------
from test_torch_train_hymba import (  # noqa: E402,F401  (its checks and fixtures)
    _close as _grad_close, scan_inputs, scan_jax_grads,
)

from repro_torch.kernels.ssm_scan import (  # noqa: E402
    BACKWARD_SEGMENT_STEPS, ssm_scan_backward_ref, ssm_scan_backward_segments,
)
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402

@pytest.fixture(scope="module")
def strong_scan():
    """Strong decays (dt |A| up to ~50), T = 45 (five segments of 8 and a
    ragged 5), N = 16, a final-state gradient: the inputs and ``jax.grad``
    of the reference's ``selective_scan`` (chunk 16)."""
    u, dt, bt, ct, log_a, _ = _inputs(2, 45, 5, 16, seed=17, strong=True)
    rng = np.random.default_rng(18)
    dy = rng.standard_normal(u.shape).astype(np.float32)
    dh = rng.standard_normal((2, 5, 16)).astype(np.float32)

    def f(u, dt, b_t, c_t, log_a):
        y, h = jax_selective_scan(u, dt, log_a, b_t, c_t, chunk=16)
        return jnp.sum(y * dy) + jnp.sum(h * dh)

    want = [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=tuple(range(5))))(
        u, dt, bt, ct, log_a)]
    return (u, dt, bt, ct, log_a), dy, dh, want


@pytest.mark.parametrize("final", ["zero", "nonzero"])
def test_backward_segments_match_jax_grad_and_the_plain_backward(scan_inputs, scan_jax_grads,
                                                                  final):
    """Moderate decays, T = 37 (ragged against segments of 8), N = 4."""
    args, dy, dh = scan_inputs
    targs = [torch.from_numpy(x) for x in args]
    dh_t = torch.from_numpy(dh) if final == "nonzero" else None
    got = ssm_scan_backward_segments(*targs, torch.from_numpy(dy), dh_t)
    _grad_close([g.numpy() for g in got], scan_jax_grads[final])
    _grad_close([g.numpy() for g in got],
                [w.numpy() for w in ssm_scan_backward_ref(*targs, torch.from_numpy(dy), dh_t)])


@pytest.mark.parametrize("seg", [BACKWARD_SEGMENT_STEPS, 5])
def test_backward_segments_under_strong_decay(strong_scan, seg):
    """Strong decay, ragged T and a final-state gradient, at the kernel's
    segment length and at one that divides nothing: the decomposition does
    not change the function."""
    args, dy, dh, want = strong_scan
    targs = [torch.from_numpy(x) for x in args]
    dy_t, dh_t = torch.from_numpy(dy), torch.from_numpy(dh)
    got = ssm_scan_backward_segments(*targs, dy_t, dh_t, seg=seg)
    _grad_close([g.numpy() for g in got], want)
    _grad_close([g.numpy() for g in got],
                [w.numpy() for w in ssm_scan_backward_ref(*targs, dy_t, dh_t)])


@pytest.fixture(scope="module")
def reduced_scan():
    """The reduced hymba-1.5b config's state size N = 8 (the CUDA kernels'
    other instance), 12 channels, T = 45 (five segments of 8 and a ragged
    5), a final-state gradient: the inputs and ``jax.grad`` of the
    reference's ``selective_scan`` at the config's chunk, 8."""
    u, dt, bt, ct, log_a, _ = _inputs(2, 45, 12, 8, seed=33)
    rng = np.random.default_rng(34)
    dy = rng.standard_normal(u.shape).astype(np.float32)
    dh = rng.standard_normal((2, 12, 8)).astype(np.float32)

    def f(u, dt, b_t, c_t, log_a):
        y, h = jax_selective_scan(u, dt, log_a, b_t, c_t, chunk=8)
        return jnp.sum(y * dy) + jnp.sum(h * dh)

    want = [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=tuple(range(5))))(
        u, dt, bt, ct, log_a)]
    return (u, dt, bt, ct, log_a), dy, dh, want


@pytest.mark.parametrize("seg", [BACKWARD_SEGMENT_STEPS, 5])
def test_backward_segments_at_the_reduced_state_size(reduced_scan, seg):
    """N = 8: the backward kernel's segment form, at its segment length and
    at 5, against ``jax.grad`` of the reference and the plain backward."""
    args, dy, dh, want = reduced_scan
    targs = [torch.from_numpy(x) for x in args]
    dy_t, dh_t = torch.from_numpy(dy), torch.from_numpy(dh)
    got = ssm_scan_backward_segments(*targs, dy_t, dh_t, seg=seg)
    _grad_close([g.numpy() for g in got], want)
    _grad_close([g.numpy() for g in got],
                [w.numpy() for w in ssm_scan_backward_ref(*targs, dy_t, dh_t)])


def _constants(src):
    """The file-scope ``constexpr int`` constants of a CUDA source (those at
    the start of a line; the ones inside a template follow its state size),
    evaluated in order."""
    import re

    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def test_backward_entry_and_constants_match_the_cuda_sources():
    """ops.py packs the backward entry's arguments into one block whose size
    the source's static_assert holds ``EntryArgs`` to; the plain form's
    segment length and the tile of the forward's kept states are the
    kernels'."""
    import re

    bwd = ssm_ops.BACKWARD_SOURCE.read_text()
    size = re.search(r"static_assert\(sizeof\(EntryArgs\) == (\d+)", bwd)
    assert size and ssm_ops._BACKWARD_ARGS.size == int(size.group(1))
    consts = _constants(bwd)
    assert consts["kSeg"] == BACKWARD_SEGMENT_STEPS
    forward = _constants(ssm_ops.SOURCE.read_text())
    assert consts["kTile"] == ssm_ops.BACKWARD_TILE == forward["kBwdTile"]


@pytest.mark.parametrize("b,t,d", [(40, 512, 3200), (2, 301, 203), (1, 5, 16), (3, 64, 129)])
def test_backward_scratch_formula_matches_its_layout(b, t, d):
    """``ssm_scan_backward_scratch`` (read from the source and evaluated)
    sizes the layout the entry cuts the buffer into, at the instance each
    state size of a launch runs on (``instance``; every ``STATE_SIZES``
    entry among them): the blocks' dB/dC partials (B, T, blocks, 2N) and
    dlog_a's batch rows (B, D, N), N the instance's."""
    import re

    src = ssm_ops.BACKWARD_SOURCE.read_text()
    env = _constants(src)
    body = re.search(r"long long ssm_scan_backward_scratch\(([^)]*)\) \{(.*?)\n\}", src, re.S)
    sizes = {ssm_ops.instance(n) for n in (1, 5, 8, 12, 16, 24, 40, 64)}
    assert sizes == set(ssm_ops.STATE_SIZES)
    for n in sorted(sizes):
        scope = dict(env, B=b, T=t, D=d, N=n)
        for stmt in body.group(2).split(";"):
            stmt = " ".join(stmt.replace("(long long)", "").replace("const long long ", "").split())
            if not stmt:
                continue
            stmt = re.sub(r"\((\w+) \? (.+?) : (.+)\)$", r"(\2 if \1 else \3)", stmt)
            exec(stmt.replace("/", "//").replace("return ", "result = "), {}, scope)
        blocks = -(-d // env["kBlockChannels"])
        layout = b * t * blocks * 2 * n + b * d * n
        assert scope["result"] == layout
