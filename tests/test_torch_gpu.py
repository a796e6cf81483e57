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
    LOG_DECAY_MIN, wkv, wkv_backward, wkv_backward_ref, wkv_chunk_states, wkv_chunked,
    wkv_with_chunk_states,
)
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    selective_scan_ref, ssm_scan, ssm_scan_backward, ssm_scan_backward_ref, ssm_scan_tile_states,
)

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


def _check_backward(device, dtype, d, b, s, t, h, kv, causal, window, kv_len):
    from repro_torch.kernels.flash_attention import flash_attention_backward

    q, k, v, do = _bwd_inputs(device, dtype, b, s, t, h, kv, d)
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
@pytest.mark.parametrize("b,s,t,h,kv,causal,window,kv_len", CASES)
def test_backward_kernel_matches_autograd_through_plain(cuda_device, dtype, d, b, s, t, h, kv,
                                                        causal, window, kv_len):
    _check_backward(cuda_device, dtype, d, b, s, t, h, kv, causal, window, kv_len)


# The bf16 backward's edges: dK/dV blocks of 128 keys (two warpgroups of
# 64), dQ blocks of 128 q rows, 64-row streamed tiles.
BWD_BF16_EDGE_CASES = [
    # b, s, t, h, kv, d, causal, window, kv_len
    (1, 200, 200, 4, 4, 128, True, None, None),   # S, T not multiples of 64
    (1, 130, 130, 4, 4, 128, True, None, None),   # 2 rows in the last block's tile
    (1, 50, 40, 4, 4, 128, False, None, None),    # a block's second warpgroup past T and S
    (1, 96, 250, 4, 4, 64, False, None, 233),     # kv_len inside the last tile
    (2, 333, 333, 8, 2, 64, True, 100, None),     # window edge inside tiles
    (1, 300, 300, 10, 2, 64, True, None, None),   # GQA 5:1 at D=64
]


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window,kv_len", BWD_BF16_EDGE_CASES)
def test_bf16_backward_at_tile_edges(cuda_device, b, s, t, h, kv, d, causal, window, kv_len):
    _check_backward(cuda_device, torch.bfloat16, d, b, s, t, h, kv, causal, window, kv_len)


def _bf16_backward(device, do, d=128, b=2, s=333, h=8, kv=2, window=None):
    from repro_torch.kernels.flash_attention import flash_attention_backward, ops

    q, k, v, _ = _bwd_inputs(device, torch.bfloat16, b, s, s, h, kv, d)
    out, lse = ops._forward(q, k, v, True, window, 1.0 / d ** 0.5, None, with_lse=True)
    return flash_attention_backward(q, k, v, out, lse, do, causal=True, window=window)


@pytest.mark.parametrize("d, window", [(128, None), (64, 100)])
def test_bf16_backward_gives_the_same_bits_on_two_calls(cuda_device, d, window):
    """No atomics: dK/dV sum a GQA group inside one block, dQ has its own kernel."""
    do = _bwd_inputs(cuda_device, torch.bfloat16, 2, 333, 333, 8, 2, d, seed=1)[3]
    first = _bf16_backward(cuda_device, do, d=d, window=window)
    second = _bf16_backward(cuda_device, do, d=d, window=window)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("pad", [8, 1])
def test_bf16_backward_reads_a_non_contiguous_dout(cuda_device, pad):
    """dO as a view whose rows are (128 + pad) elements apart: TMA reads pad
    8 in place, and pad 1 (258-byte rows) is copied first; both give the
    bits of a contiguous dO."""
    dense = _bwd_inputs(cuda_device, torch.bfloat16, 2, 333, 333, 8, 2, 128, seed=1)[3]
    buf = torch.zeros((2, 333, 8, 128 + pad), device=cuda_device, dtype=torch.bfloat16)
    view = buf[..., :128]
    view.copy_(dense)
    assert not view.is_contiguous()
    for name, x, y in zip(("dq", "dk", "dv"), _bf16_backward(cuda_device, view),
                          _bf16_backward(cuda_device, dense)):
        assert torch.equal(x, y), name


def test_bf16_backward_rejects_a_misaligned_q(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention_backward, ops

    q, k, v, do = _bwd_inputs(cuda_device, torch.bfloat16, 1, 64, 64, 4, 4, 128)
    out, lse = ops._forward(q, k, v, True, None, 1.0 / 128 ** 0.5, None, with_lse=True)
    buf = torch.zeros(q.numel() + 1, device=cuda_device, dtype=torch.bfloat16)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    before = flash_attention_backward.launches
    with pytest.raises(ValueError, match="cannot read q"):
        flash_attention_backward(shifted, k, v, out, lse, do)
    assert flash_attention_backward.launches == before


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



def _sweep_cluster(rng, n):
    from repro_torch.core.perf_model import ClusterPerfModel, CommModel, NodePerfModel

    nodes = tuple(
        NodePerfModel(q=float(rng.uniform(1e-4, 8e-3)), s=float(rng.uniform(0.0, 0.02)),
                      k=float(rng.uniform(1e-4, 8e-3)), m=float(rng.uniform(0.0, 0.02)))
        for _ in range(n))
    comm = CommModel(t_o=float(10.0 ** rng.uniform(-4, -1)), t_u=float(rng.uniform(0.0, 0.02)),
                     gamma=float(rng.uniform(0.02, 0.6)))
    return ClusterPerfModel(nodes=nodes, comm=comm)


@pytest.mark.parametrize("n", [2, 3, 16, 64, 256])
def test_device_sweep_matches_cpu_port_and_oracle(cuda_device, n):
    """The float32 sweep on the card against the same sweep on the CPU and
    the NumPy float64 oracle, cold and warm: t_stars and opt_perfs within
    1e-5 relative (float32 sums over the nodes in another order)."""
    from repro_torch.core.optperf import solve_optperf_batch
    from repro_torch.core.optperf_torch import solve_optperf_batch_jax

    for seed in range(4):
        rng = np.random.default_rng(1000 * n + seed)
        model = _sweep_cluster(rng, n)
        cands = np.unique(np.round(rng.uniform(8, 8192, size=5)))
        oracle = solve_optperf_batch(model, cands)
        for warm in (None, oracle.t_stars * (1.0 + 1e-4)):
            gpu = solve_optperf_batch_jax(model, cands, warm_start=warm, device=cuda_device)
            cpu = solve_optperf_batch_jax(model, cands, warm_start=warm, device="cpu")
            for other in (cpu, oracle):
                for field in ("t_stars", "opt_perfs"):
                    got, want = getattr(gpu, field), getattr(other, field)
                    assert np.max(np.abs(got - want) / want) <= 1e-5
            np.testing.assert_allclose(gpu.batches.sum(axis=1), cands, rtol=1e-12)


def test_device_sweep_issues_no_host_sync(cuda_device):
    """The cold sweep, partition and node times as the fused epoch calls
    them, under ``set_sync_debug_mode("error")``: a host sync raises."""
    from repro_torch.core import optperf_torch
    from repro_torch.core.optperf import _problem_from_model, solve_optperf_batch

    model = _sweep_cluster(np.random.default_rng(3), 3)
    dc = optperf_torch.device_coeffs(model, device=cuda_device)
    cands_np = np.array([16.0, 32.0, 64.0])
    cand = torch.as_tensor(cands_np, dtype=torch.float32, device=cuda_device)
    lo0 = torch.as_tensor(float(_problem_from_model(model)[1]), dtype=torch.float32,
                          device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t_stars, iters = optperf_torch.solve_optperf_sweep_device(dc, cand, lo0)
        parts = optperf_torch.device_partition(dc, t_stars[:, None], cand)
        opt_perfs = optperf_torch.device_node_times(dc, parts).amax(dim=-1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = solve_optperf_batch(model, cands_np)
    got = opt_perfs.cpu().numpy().astype(np.float64)
    assert iters == 64
    assert np.max(np.abs(got - want.opt_perfs) / want.opt_perfs) <= 1e-5
    with pytest.raises(ValueError):  # a CPU value is never copied into the sweep
        optperf_torch.solve_optperf_sweep_device(dc, torch.as_tensor(cands_np), lo0)


def test_fused_epoch_runs_without_host_sync(cuda_device):
    """A reduced dense model at head dim 64 (float32, remat on) trains on
    the card through ``EpochLoop(fused=True)``: every fused epoch runs its
    steps, GNS EMA and sweep under ``set_sync_debug_mode("error")``
    (``execute_fused`` sets it), ships 12 values and pulls 13, and plans as
    the two-program loop on the same seeds."""
    import dataclasses

    from repro_torch.configs import olmo_1b
    from repro_torch.core.controller import FUSED_CERT_TOL, CannikinController
    from repro_torch.core.simulator import SimulatedCluster, cluster_A
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.models.registry import build_api
    from repro_torch.optim.optimizers import constant_schedule, sgd
    from repro_torch.runtime.backend import EpochLoop, RealBackend

    cfg = dataclasses.replace(olmo_1b.reduced(), head_dim=64, d_model=256, remat=True)
    api = build_api("olmo-1b", cfg)

    def run(fused):
        profiles, comm = cluster_A()
        sim = SimulatedCluster(profiles, comm, noise=0.01, seed=0)
        backend = RealBackend(api, sgd(constant_schedule(0.3)),
                              SyntheticLM(vocab=cfg.vocab, seq_len=64, seed=0),
                              cluster=sim, seed=0, device=cuda_device)
        ctrl = CannikinController(sim.n, batch_candidates=[12, 24, 36], ref_batch=12,
                                  device=cuda_device)
        loop = EpochLoop(ctrl, backend, steps_per_epoch=2, fused=fused)
        transfers = []
        for _ in range(5):
            before = backend.transfers.snapshot()
            loop.run_epoch()
            after = backend.transfers.snapshot()
            transfers.append((after["h2d"] - before["h2d"], after["d2h"] - before["d2h"]))
        return ctrl, loop, transfers

    launches = flash_attention_backward.launches
    ctrl_two, loop_two, _ = run(False)
    ctrl, loop, transfers = run(True)
    assert flash_attention_backward.launches > launches
    assert [r.plan.batch_policy for r in loop.history][2:] == [
        "cannikin-gns", "cannikin-gns+fused", "cannikin-gns+fused"]
    assert transfers[2:] == [(12, 13)] * 3
    for a, b in zip(loop_two.history, loop.history):
        assert (a.total_batch, a.batches) == (b.total_batch, b.batches)
        assert b.lr_scale == pytest.approx(a.lr_scale, rel=1e-6)
        assert np.isfinite(b.mean_loss)
    s = ctrl.stats
    assert s.fused_plans == 2 and s.fused_cert_failures == 0
    assert s.fused_max_rel_err <= FUSED_CERT_TOL


def test_fused_epoch_raises_on_a_host_sync(cuda_device):
    """``execute_fused`` runs its device part under
    ``set_sync_debug_mode("error")``: a step that reads a value back raises
    there, and the caller's mode is restored."""
    import dataclasses

    from repro_torch.configs import olmo_1b
    from repro_torch.core.controller import CannikinController
    from repro_torch.core.simulator import SimulatedCluster, cluster_A
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.registry import build_api
    from repro_torch.optim.optimizers import constant_schedule, sgd
    from repro_torch.runtime.backend import EpochLoop, RealBackend

    cfg = dataclasses.replace(olmo_1b.reduced(), head_dim=64, d_model=256, remat=True)
    profiles, comm = cluster_A()
    sim = SimulatedCluster(profiles, comm, noise=0.01, seed=0)
    backend = RealBackend(build_api("olmo-1b", cfg), sgd(constant_schedule(0.3)),
                          SyntheticLM(vocab=cfg.vocab, seq_len=64, seed=0), cluster=sim,
                          device=cuda_device)
    ctrl = CannikinController(sim.n, batch_candidates=[12, 24], ref_batch=12,
                              device=cuda_device)
    loop = EpochLoop(ctrl, backend, steps_per_epoch=1, fused=True)
    loop.run(2)                                   # bootstrap: the two-program path
    step = backend._step

    def syncing_step(*args):
        out = step(*args)
        float(out[0])                             # a host read of the loss
        return out

    backend._step = syncing_step
    backend._fused_cache.clear()
    with pytest.raises(RuntimeError, match="synchroniz"):
        loop.run_epoch()
    assert torch.cuda.get_sync_debug_mode() == 0


def test_sharded_backend_over_a_nccl_world_of_one(cuda_device):
    """``RealBackend(sharded=True)`` with no default process group runs over
    a NCCL world of one: against the unsharded backend on the same seeds,
    the same parameter, momentum, |g_i|^2 and |g|^2 bits through two
    bootstrap epochs and a fused adaptive one (no host sync there), and
    one flash forward per layer fewer per step (no whole-batch loss
    forward)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import olmo_1b
    from repro_torch.core.controller import CannikinController
    from repro_torch.core.simulator import SimulatedCluster, cluster_A
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.registry import build_api
    from repro_torch.optim.optimizers import constant_schedule, sgd
    from repro_torch.runtime.backend import EpochLoop, RealBackend

    assert not dist.is_initialized()
    cfg = dataclasses.replace(olmo_1b.reduced(), head_dim=64, d_model=256, remat=True)
    api = build_api("olmo-1b", cfg)

    def run(sharded):
        profiles, comm = cluster_A()
        sim = SimulatedCluster(profiles, comm, noise=0.01, seed=0)
        backend = RealBackend(api, sgd(constant_schedule(0.3)),
                              SyntheticLM(vocab=cfg.vocab, seq_len=64, seed=0),
                              cluster=sim, seed=0, device=cuda_device, sharded=sharded)
        ctrl = CannikinController(sim.n, batch_candidates=[12, 24, 36], ref_batch=12,
                                  device=cuda_device)
        loop = EpochLoop(ctrl, backend, steps_per_epoch=2, fused=True)
        before = flash_attention.launches
        loop.run(3)
        torch.cuda.synchronize()
        obs = [o for r in (loop.last_result,) for o in r.grad_observations]
        return backend, loop, flash_attention.launches - before, obs

    plain, plain_loop, plain_fwd, plain_obs = run(False)
    sharded, loop, fwd, obs = run(True)
    mesh = sharded._mesh
    assert (mesh.shards, mesh.world, mesh.nodes) == (1, 1, (0, 1, 2))
    assert isinstance(mesh.group, dist.ProcessGroupNCCL)
    assert [r.plan.batch_policy for r in loop.history] == [None, None, "cannikin-gns"]
    assert [r.batches for r in loop.history] == [r.batches for r in plain_loop.history]
    assert [(o.local_sqnorms, o.global_sqnorm) for o in obs] == [
        (o.local_sqnorms, o.global_sqnorm) for o in plain_obs]
    for k, p in plain.named.items():
        assert torch.equal(p, sharded.named[k]), k
        assert torch.equal(plain.opt_state.momentum[k], sharded.opt_state.momentum[k]), k
    per_node = 2 * cfg.n_layers  # remat
    steps = 3 * 2
    assert plain_fwd == steps * (3 * per_node + cfg.n_layers)
    assert fwd == steps * 3 * per_node
    for a, b in zip(plain_loop.history, loop.history):
        assert b.mean_loss == pytest.approx(a.mean_loss, rel=1e-5)


@pytest.mark.parametrize("n_jobs,n_nodes,seed", [(3, 12, 0), (8, 32, 1)])
def test_scheduler_device_engine_matches_host_engine(cuda_device, n_jobs, n_nodes, seed):
    """``Scheduler(engine="jax")`` solving on the card against the host
    NumPy engine: the same node assignments, aggregate goodput within 1e-5
    relative (float32 sweep, float64 certification), and no block handed to
    the scalar oracle by a failing device solve."""
    from repro_torch.core.scheduler import Scheduler, random_jobs

    allocs = {}
    for engine, device in (("jax", cuda_device), ("batched", None)):
        s = Scheduler(n_nodes, engine=engine, device=device)
        for job in random_jobs(n_jobs, n_nodes, seed):
            allocs[engine] = s.add_job(job)
        assert s.fallback_blocks == 0
    assert allocs["jax"].assignment == allocs["batched"].assignment
    assert allocs["jax"].aggregate_goodput == pytest.approx(
        allocs["batched"].aggregate_goodput, rel=1e-5)


# ---------------------------------------------------------------------------
# the WKV and selective-scan backwards
# ---------------------------------------------------------------------------

# float32 sums in another order: each gradient within 1e-4 * max(1, max |plain|).
BWD_KERNEL_REL = 1e-4


def _bwd_close(got, want):
    for g, w in zip(got, want):
        tol = BWD_KERNEL_REL * max(1.0, w.abs().max().item())
        assert g.shape == w.shape and (g - w).abs().max().item() <= tol


@pytest.mark.parametrize("b,t,h,chunk,with_ds", [
    (1, 70, 2, 32, True),      # small, ragged T
    (8, 512, 64, 32, False),   # a training slice of rwkv6-7b (one node at b=8)
])
def test_wkv_backward_kernel_matches_plain_backward(cuda_device, b, t, h, chunk, with_ds):
    r, k, v, lw, u = _wkv_inputs(b, t, h, cuda_device, seed=2)
    d_out = torch.randn_like(r)
    d_state = torch.randn(b, h, 64, 64, device=cuda_device) if with_ds else None
    _, state = wkv(r, k, v, lw, u, chunk=chunk)
    before = wkv_backward.launches
    got = wkv_backward(r, k, v, lw, u, state, d_out, d_state, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv_backward.launches == before + 1
    _bwd_close(got, wkv_backward_ref(r, k, v, lw, u, d_out, d_state))


def test_wkv_backward_kernel_under_autograd_gives_the_same_bits_twice(cuda_device):
    """``wkv`` on leaves that require grad launches the forward and the
    backward kernel; no atomics, so two backward passes agree bitwise, and
    they match the plain backward."""
    leaves = [x.requires_grad_() for x in _wkv_inputs(2, 200, 4, cuda_device, seed=3)]
    d_out = torch.randn_like(leaves[0])
    grads = []
    for _ in range(2):
        before = wkv_backward.launches
        out, _ = wkv(*leaves, chunk=32)
        grads.append(torch.autograd.grad(out, leaves, d_out))
        assert wkv_backward.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    plain = [x.detach() for x in leaves]
    _bwd_close(grads[0], wkv_backward_ref(*plain, d_out))


@pytest.mark.parametrize("k, chunk", [(32, 32), (64, 128)])
def test_wkv_backward_kernel_rejects_what_it_does_not_take(cuda_device, k, chunk):
    x = torch.zeros(1, 200, 2, k, device=cuda_device)
    u = torch.zeros(2, k, device=cuda_device)
    state = torch.zeros(1, 2, k, k, device=cuda_device)
    with pytest.raises(ValueError):
        wkv_backward(x, x, x, x, u, state, x, chunk=chunk)


@pytest.mark.parametrize("b,t,d,strong,with_dh", [
    (2, 301, 203, False, True),    # small, ragged T and D
    (8, 512, 3200, False, False),  # a training slice of hymba-1.5b (one node at b=8)
    (1, 100, 3200, True, True),    # strong decay
])
def test_ssm_backward_kernel_matches_plain_backward(cuda_device, b, t, d, strong, with_dh):
    u, dt, bt, ct, log_a = _ssm_inputs(b, t, d, cuda_device, seed=5, strong=strong)
    dy = torch.randn_like(u)
    dh = torch.randn(b, d, 16, device=cuda_device) if with_dh else None
    before = ssm_scan_backward.launches
    got = ssm_scan_backward(u, dt, bt, ct, log_a, dy, dh, chunk=128)
    torch.cuda.synchronize()
    assert ssm_scan_backward.launches == before + 1
    _bwd_close(got, ssm_scan_backward_ref(u, dt, bt, ct, log_a, dy, dh))


def test_ssm_backward_kernel_under_autograd_gives_the_same_bits_twice(cuda_device):
    leaves = [x.requires_grad_() for x in _ssm_inputs(2, 257, 500, cuda_device, seed=6)]
    dy = torch.randn_like(leaves[0])
    grads = []
    for _ in range(2):
        before = ssm_scan_backward.launches
        y, _ = ssm_scan(*leaves, chunk=128)
        grads.append(torch.autograd.grad(y, leaves, dy))
        assert ssm_scan_backward.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    plain = [x.detach() for x in leaves]
    _bwd_close(grads[0], ssm_scan_backward_ref(*plain, dy))


@pytest.mark.parametrize("n, chunk", [(8, 64), (16, 256)])
def test_ssm_backward_kernel_rejects_what_it_does_not_take(cuda_device, n, chunk):
    u = torch.zeros(1, 300, 32, device=cuda_device)
    bt = torch.zeros(1, 300, n, device=cuda_device)
    log_a = torch.zeros(32, n, device=cuda_device)
    with pytest.raises(ValueError):
        ssm_scan_backward(u, u, bt, bt, log_a, u, chunk=chunk)


# The backwards' second designs at their edges: the scan's 8-step segments,
# 64-step tiles, 8-channel sub-blocks and 128-channel blocks (with the
# forward's tile states given and formed by the wrapper), the WKV
# backward's 32-step chunks at
# the forward's chunks 32 and 64; each against the plain backward and
# repeated bit for bit.
@pytest.mark.parametrize("b,t,d,strong,with_dh", [
    (2, 64, 128, False, True),     # one tile, one block exactly
    (1, 65, 136, False, False),    # one step past a tile; D past a block
    (2, 128, 131, True, True),     # two tiles; D not a multiple of a sub-block
    (1, 7, 9, False, True),        # below one segment; D past one sub-block
    (3, 200, 264, False, False),   # ragged tiles, three blocks
])
def test_ssm_backward_kernel_at_segment_and_tile_edges(cuda_device, b, t, d, strong, with_dh):
    u, dt, bt, ct, log_a = _ssm_inputs(b, t, d, cuda_device, seed=7, strong=strong)
    dy = torch.randn_like(u)
    dh = torch.randn(b, d, 16, device=cuda_device) if with_dh else None
    want = ssm_scan_backward_ref(u, dt, bt, ct, log_a, dy, dh)
    _, _, tiles = ssm_scan_tile_states(u, dt, bt, ct, log_a, chunk=128)
    for kw in ({"tiles": tiles}, {}):
        got = ssm_scan_backward(u, dt, bt, ct, log_a, dy, dh, chunk=128, **kw)
        again = ssm_scan_backward(u, dt, bt, ct, log_a, dy, dh, chunk=128, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        _bwd_close(got, want)


@pytest.mark.parametrize("b,t,h,chunk,with_ds", [
    (2, 32, 4, 32, True),      # one chunk exactly
    (1, 33, 4, 32, False),     # one step past a chunk
    (2, 63, 4, 64, True),      # the forward's chunk 64: two chunks here, ragged
    (1, 64, 4, 64, False),
    (2, 65, 4, 64, True),
    (1, 100, 4, 32, False),
])
def test_wkv_backward_kernel_at_chunk_edges(cuda_device, b, t, h, chunk, with_ds):
    r, k, v, lw, u = _wkv_inputs(b, t, h, cuda_device, seed=8)
    d_out = torch.randn_like(r)
    d_state = torch.randn(b, h, 64, 64, device=cuda_device) if with_ds else None
    _, state = wkv(r, k, v, lw, u, chunk=chunk)
    got = wkv_backward(r, k, v, lw, u, state, d_out, d_state, chunk=chunk)
    again = wkv_backward(r, k, v, lw, u, state, d_out, d_state, chunk=chunk)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _bwd_close(got, wkv_backward_ref(r, k, v, lw, u, d_out, d_state))
