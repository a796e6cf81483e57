"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one; on the card run
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Imports torch only, so it runs where JAX is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import (  # noqa: E402
    LOG_DECAY_MIN, wkv, wkv_chunk_states, wkv_chunked, wkv_with_chunk_states,
)
from repro_torch.kernels.ssm_scan import selective_scan_ref, ssm_scan  # noqa: E402

pytestmark = pytest.mark.gpu

# Tolerances: float32 differs from the plain version by sum order only;
# bfloat16 adds one rounding of the output (2^-8 relative).
ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

CASES = [
    # b, s, t, h, kv, causal, window, kv_len
    (1, 128, 128, 16, 16, True, None, None),
    (2, 100, 100, 4, 4, True, None, None),     # ragged S, T
    (1, 300, 300, 8, 2, True, 64, None),       # GQA + window
    (2, 64, 192, 4, 4, False, None, None),     # non-causal, cross lengths
    (1, 128, 200, 4, 2, False, None, 150),     # kv_len mask
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check_against_plain(device, dtype, b, s, t, h, kv, d, causal, window, kv_len, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((b, t, kv, d), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((b, t, kv, d), dtype=np.float32))
    q, k, v = (x.to(device, dtype) for x in (q, k, v))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len)
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,causal,window,kv_len", CASES)
def test_kernel_matches_plain_version(cuda_device, dtype, d, b, s, t, h, kv, causal, window,
                                      kv_len):
    _check_against_plain(cuda_device, dtype, b, s, t, h, kv, d, causal, window, kv_len)


# The bf16 kernel's edges: 64 q rows per block and tiles of 64 keys, at
# both head dims.  kv_len 97 ends 33 keys into the second tile; the window
# of 100 puts its lower edge 36 keys into a tile for every 64-row block.
BF16_EDGE_CASES = [
    # b, s, t, h, kv, d, causal, window, kv_len
    (1, 2048, 2048, 16, 16, 128, True, None, None),   # olmo-1b S=2048
    (1, 256, 256, 4, 4, 128, False, None, 97),        # kv_len ends inside a tile
    (1, 256, 256, 4, 4, 64, True, None, 97),
    (1, 20, 10, 4, 2, 64, False, None, None),         # T shorter than one tile
    (2, 333, 333, 8, 2, 64, True, 100, None),         # window edge inside tiles
]


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window,kv_len", BF16_EDGE_CASES)
def test_bf16_kernel_at_tile_edges(cuda_device, b, s, t, h, kv, d, causal, window, kv_len):
    _check_against_plain(cuda_device, torch.bfloat16, b, s, t, h, kv, d, causal, window, kv_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_reads_strided_inputs(cuda_device, dtype):
    """q/k/v as views into a fused (B, S, 3, H, D) buffer: read in place."""
    qkv = torch.randn(1, 96, 3, 4, 128, device=cuda_device).to(dtype)
    q, k, v = qkv.unbind(dim=2)
    got = flash_attention(q, k, v)
    want = attention_ref(q, k, v)
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


@pytest.mark.parametrize("offset", ["base", "stride"])
def test_bf16_kernel_rejects_misaligned_views(cuda_device, offset):
    """TMA reads 16-byte aligned rows: a view it cannot read raises and is
    never launched."""
    if offset == "base":
        x = torch.zeros(8 * 4 * 128 + 1, device=cuda_device, dtype=torch.bfloat16)
        x = x[1:].view(1, 8, 4, 128)
    else:
        x = torch.zeros(1, 8, 4, 129, device=cuda_device, dtype=torch.bfloat16)[..., 1:]
    before = flash_attention.launches
    with pytest.raises(ValueError, match="cannot read"):
        flash_attention(x, x, x)
    assert flash_attention.launches == before


# hymba-1.5b's attention: head dim 64, H=25 over KV=5, window 1024 on most layers.
D64_CASES = [
    # b, s, h, kv, window
    (1, 300, 25, 5, None),
    (1, 300, 25, 5, 64),
    (2, 130, 4, 2, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,window", D64_CASES)
def test_kernel_matches_plain_version_at_head_dim_64(cuda_device, dtype, b, s, h, kv, window):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((b, s, h, 64), generator=gen, device=cuda_device).to(dtype)
    k, v = (torch.randn((b, s, kv, 64), generator=gen, device=cuda_device).to(dtype)
            for _ in range(2))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=True, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


@pytest.mark.parametrize("d, dtype", [(96, torch.float32), (128, torch.float16)])
def test_kernel_rejects_what_it_does_not_take(cuda_device, d, dtype):
    q = torch.zeros(1, 8, 2, d, device=cuda_device, dtype=dtype)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


# WKV: float32 through decay factors up to exp(chunk * 4.6 / 2) and sums in
# another order; max abs err <= 1e-4 * max(1, max |plain|), out and state.
WKV_REL = 1e-4
WKV_CASES = [
    # b, t, h, chunk
    (1, 1024, 64, 32),   # rwkv6-7b forward
    (1, 300, 64, 32),    # ragged last chunk
    (4, 256, 8, 32),
    (1, 200, 4, 64),
    (2, 10, 4, 32),      # T < chunk
    (1, 1, 2, 32),       # one token
]


def _wkv_inputs(b, t, h, device, k=64, seed=0, strong=False):
    rng = np.random.default_rng(seed)
    r, kk, v = ((rng.standard_normal((b, t, h, k)) * 0.5).astype(np.float32) for _ in range(3))
    if strong:  # every log-decay clamps to the floor: mid-point exponents +-chunk * 2.3
        lw = (LOG_DECAY_MIN - np.abs(rng.standard_normal((b, t, h, k)))).astype(np.float32)
    else:
        lw = (-np.exp(rng.standard_normal((b, t, h, k)))).astype(np.float32)
    u = (rng.standard_normal((h, k)) * 0.2).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (r, kk, v, lw, u)]


def _wkv_close(got, want):
    tol = WKV_REL * max(1.0, want.abs().max().item())
    assert got.shape == want.shape and (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("b,t,h,chunk", WKV_CASES)
def test_wkv_kernel_matches_plain_version(cuda_device, b, t, h, chunk):
    args = _wkv_inputs(b, t, h, cuda_device)
    before = wkv.launches
    out, state = wkv(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv.launches == before + 1
    want_out, want_state = wkv_chunked(*args, chunk=chunk)
    _wkv_close(out, want_out)
    _wkv_close(state, want_state)


@pytest.mark.parametrize("b,t,h,chunk,strong",
                         [case + (False,) for case in WKV_CASES] + [(1, 1024, 64, 32, True)])
def test_wkv_kernel_passes_match_plain_versions(cuda_device, b, t, h, chunk, strong):
    """Each pass on its own: the first pass's states entering each chunk
    against ``wkv_chunk_states``, then out and the final state; the last
    row puts every log-decay at the floor (strong decay)."""
    args = _wkv_inputs(b, t, h, cuda_device, seed=1, strong=strong)
    out, state, states = wkv_with_chunk_states(*args, chunk=chunk)
    torch.cuda.synchronize()
    _wkv_close(states, wkv_chunk_states(*args[1:4], chunk=chunk)[0])
    want_out, want_state = wkv_chunked(*args, chunk=chunk)
    _wkv_close(out, want_out)
    _wkv_close(state, want_state)


def test_wkv_kernel_reads_strided_inputs(cuda_device):
    """r/k/v/log_w as views into a fused (B, T, 4, H, K) buffer."""
    buf = torch.randn(2, 150, 4, 4, 64, device=cuda_device) * 0.5
    r, k, v, lw = buf.unbind(dim=2)
    lw = -lw.abs()
    u = torch.randn(4, 64, device=cuda_device) * 0.2
    out, state = wkv(r, k, v, lw, u, chunk=32)
    want_out, want_state = wkv_chunked(r, k, v, lw, u, chunk=32)
    _wkv_close(out, want_out)
    _wkv_close(state, want_state)


@pytest.mark.parametrize("k, dtype, chunk", [(32, torch.float32, 32), (64, torch.bfloat16, 32),
                                             (64, torch.float32, 128)])
def test_wkv_kernel_rejects_what_it_does_not_take(cuda_device, k, dtype, chunk):
    x = torch.zeros(1, 200, 2, k, device=cuda_device, dtype=dtype)
    u = torch.zeros(2, k, device=cuda_device, dtype=dtype)
    with pytest.raises(ValueError):
        wkv(x, x, x, x, u, chunk=chunk)


def test_wkv_kernel_rejects_misaligned_rows(cuda_device):
    """The kernel copies rows as 16-byte vectors: a view one float off its
    allocation's start is refused, not read out of line."""
    x = torch.zeros(1 * 20 * 2 * 64 + 1, device=cuda_device)[1:].view(1, 20, 2, 64)
    u = torch.zeros(2, 64, device=cuda_device)
    with pytest.raises(ValueError):
        wkv(x, x, x, x, u)


# Selective scan: float32 sums in another order over N = 16 lanes; y and
# the final state within 1e-5 * max(1, max |plain|).
SSM_REL = 1e-5
SSM_CASES = [
    # b, t, d, chunk
    (1, 1024, 3200, 128),   # hymba-1.5b forward at 1024 tokens
    (1, 300, 3200, 128),    # ragged last tile
    (4, 256, 256, 64),
    (1, 200, 203, 128),     # D does not fill the last 8-channel tile
    (2, 10, 64, 128),       # T < chunk
    (1, 1, 16, 128),        # one token
    (1, 1021, 3200, 128),   # no whole last 8-step segment
    (1, 5, 3200, 128),      # T below one segment
    (1, 57, 3200, 128),     # one step past the first tile (7 segments of 8 at B=1)
    (4, 256, 3200, 128),    # one segment per tile (97 channels a block)
    (3, 13, 203, 64),       # B > 1, ragged T and D
]


def _ssm_inputs(b, t, d, device, n=16, seed=0, strong=False):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device)

    u = rand(b, t, d)
    dt = torch.exp(rand(b, t, d) * 0.5) * (3.0 if strong else 0.3)
    bt, ct = rand(b, t, n), rand(b, t, n)
    log_a = rand(d, n) * (1.0 if strong else 0.5)
    return u, dt, bt, ct, log_a


def _ssm_close(got, want):
    tol = SSM_REL * max(1.0, want.abs().max().item())
    assert got.shape == want.shape and (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("strong", [False, True], ids=["moderate", "strong-decay"])
@pytest.mark.parametrize("b,t,d,chunk", SSM_CASES)
def test_ssm_kernel_matches_plain_version(cuda_device, b, t, d, chunk, strong):
    u, dt, bt, ct, log_a = _ssm_inputs(b, t, d, cuda_device, strong=strong)
    before = ssm_scan.launches
    y, h = ssm_scan(u, dt, bt, ct, log_a, chunk=chunk)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    want_y, want_h = selective_scan_ref(u, dt, log_a, bt, ct)
    _ssm_close(y, want_y)
    _ssm_close(h, want_h)


def test_ssm_kernel_reads_strided_inputs(cuda_device):
    """u/dt as views into a (B, T, 2, D) buffer and B/C as the halves of one
    (B, T, 2N) projection, as the model slices them."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    ud = torch.randn((2, 150, 2, 72), generator=gen, device=cuda_device)
    u, dt = ud[:, :, 0], ud[:, :, 1].abs() * 0.3
    bc = torch.randn((2, 150, 32), generator=gen, device=cuda_device)
    bt, ct = bc[..., :16], bc[..., 16:]
    log_a = torch.randn((72, 16), generator=gen, device=cuda_device) * 0.5
    y, h = ssm_scan(u, dt, bt, ct, log_a, chunk=64)
    want_y, want_h = selective_scan_ref(u, dt, log_a, bt, ct)
    _ssm_close(y, want_y)
    _ssm_close(h, want_h)


def test_ssm_kernel_reads_unaligned_inputs(cuda_device):
    """Views one float off 16-byte boundaries take the 4-byte copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    t, d = 77, 50

    def view(*shape):
        flat = torch.randn(int(np.prod(shape)) + 1, generator=gen, device=cuda_device)
        return flat[1:].view(*shape)

    u, dt, bt, ct = view(2, t, d), view(2, t, d).abs() * 0.3, view(2, t, 16), view(2, t, 16)
    log_a = torch.randn((d, 16), generator=gen, device=cuda_device) * 0.5
    y, h = ssm_scan(u, dt, bt, ct, log_a, chunk=64)
    want_y, want_h = selective_scan_ref(u, dt, log_a, bt, ct)
    _ssm_close(y, want_y)
    _ssm_close(h, want_h)


@pytest.mark.parametrize("n, dtype, chunk, transpose", [
    (8, torch.float32, 64, False),       # state size
    (16, torch.bfloat16, 64, False),     # dtype
    (16, torch.float32, 256, False),     # chunk above 128
    (16, torch.float32, 64, True),       # channel dim not contiguous
])
def test_ssm_kernel_rejects_what_it_does_not_take(cuda_device, n, dtype, chunk, transpose):
    u = torch.zeros(1, 300, 32, device=cuda_device, dtype=dtype)
    if transpose:
        u = torch.zeros(1, 32, 300, device=cuda_device, dtype=dtype).transpose(1, 2)
    bt = torch.zeros(1, 300, n, device=cuda_device, dtype=dtype)
    log_a = torch.zeros(32, n, device=cuda_device, dtype=dtype)
    with pytest.raises(ValueError):
        ssm_scan(u, u, bt, bt, log_a, chunk=chunk)


# ---------------------------------------------------------------------------
# flash attention's backward and the training forward
# ---------------------------------------------------------------------------

# Relative to max(1, max |plain|): float32 differs by sum order; bfloat16
# gradients carry the forward's bf16 output (delta) and one output rounding.
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _bwd_inputs(device, dtype, b, s, t, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d)]
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
            for shape in shapes]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,causal,window,kv_len", CASES)
def test_backward_kernel_matches_autograd_through_plain(cuda_device, dtype, d, b, s, t, h, kv,
                                                        causal, window, kv_len):
    from repro_torch.kernels.flash_attention import flash_attention_backward

    q, k, v, do = _bwd_inputs(cuda_device, dtype, b, s, t, h, kv, d)
    mask = dict(causal=causal, window=window, kv_len=kv_len)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (flash_attention.launches, flash_attention_backward.launches)
    flash_attention(*leaves, **mask).backward(do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_backward.launches) == (
        before[0] + 1, before[1] + 1)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    attention_ref(*plain, **mask).backward(do)
    for name, got, want in zip(("dq", "dk", "dv"), leaves, plain):
        assert got.grad.dtype == dtype and got.grad.shape == want.grad.shape
        err = (got.grad.float() - want.grad.float()).abs().max().item()
        tol = BWD_REL[dtype] * max(1.0, want.grad.float().abs().max().item())
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_lse_matches_plain_and_leaves_output_unchanged(cuda_device, dtype, d):
    from repro_torch.kernels.flash_attention import attention_lse_ref, ops

    q, k, v, _ = _bwd_inputs(cuda_device, dtype, 2, 200, 200, 8, 2, d)
    scale = 1.0 / d ** 0.5
    for window, kv_len in ((None, None), (64, None), (None, 150)):
        out, lse = ops._forward(q, k, v, True, window, scale, kv_len, with_lse=True)
        plain_out, none = ops._forward(q, k, v, True, window, scale, kv_len, with_lse=False)
        torch.cuda.synchronize()
        assert none is None and torch.equal(out, plain_out)
        want = attention_lse_ref(q, k, causal=True, window=window, kv_len=kv_len)
        assert (lse - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


def test_training_forward_gradient_matches_plain_attention(cuda_device):
    """A small float32 dense model at head dim 64, remat on: the gradient of
    its loss through the CUDA kernels equals the one with the plain
    attention passed through the layers' ``attend`` seam."""
    import dataclasses
    import functools

    from repro_torch.configs import olmo_1b
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.models import common
    from repro_torch.models.registry import build_api

    cfg = dataclasses.replace(olmo_1b.reduced(), head_dim=64, d_model=256, remat=True)
    model = build_api("olmo-1b", cfg).init(0, device=cuda_device).requires_grad_(True)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 96)), device=cuda_device)
    grads = {}
    for name, attend in (("kernel", None),
                         ("plain", functools.partial(attention_ref, causal=True))):
        before = (flash_attention.launches, flash_attention_backward.launches)
        logits = model.train_forward(tokens[:, :-1], attend=attend)
        loss, _ = common.weighted_cross_entropy(logits, tokens[:, 1:])
        grads[name] = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        launched = (flash_attention.launches - before[0],
                    flash_attention_backward.launches - before[1])
        # remat: each layer's forward runs again in the backward pass.
        assert launched == ((2 * cfg.n_layers, cfg.n_layers) if name == "kernel" else (0, 0))
    for got, want in zip(grads["kernel"], grads["plain"]):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol
