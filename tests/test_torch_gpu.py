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
# bfloat16 adds one rounding of the output (2^-8 relative); float16's 2e-3
# is one float16 step at |o| < 4 (tests/test_torch_flash_p_rounding.py).
ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}

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


def _dims(d):
    """(Dqk, Dv) of a head dim or a pair."""
    return d if isinstance(d, tuple) else (d, d)


def _check_against_plain(device, dtype, b, s, t, h, kv, d, causal, window, kv_len, seed=0):
    dqk, dv = _dims(d)
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, s, h, dqk), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((b, t, kv, dqk), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((b, t, kv, dv), dtype=np.float32))
    q, k, v = (x.to(device, dtype) for x in (q, k, v))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len)
    assert got.dtype == dtype and got.shape == (b, s, h, dv)
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


@pytest.mark.parametrize("d, dtype, limit", [(257, torch.float32, "MAX_HEAD_DIM"),
                                             (320, torch.float16, "MAX_HEAD_DIM"),
                                             (64, torch.float64, "DTYPES")])
def test_kernel_rejects_what_it_does_not_take(cuda_device, d, dtype, limit):
    """Past the reach (``reach_error``): a head dim over 256, float64."""
    q = torch.zeros(1, 8, 2, d, device=cuda_device, dtype=dtype)
    before = flash_attention.launches
    with pytest.raises(ValueError, match=limit):
        flash_attention(q, q, q)
    assert flash_attention.launches == before


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


@pytest.mark.parametrize("k, dtype, chunk", [(160, torch.float32, 32), (64, torch.float64, 32),
                                             (64, torch.float32, 256), (128, torch.float32, 96)])
def test_wkv_kernel_rejects_what_it_does_not_take(cuda_device, k, dtype, chunk):
    """Past the reach: a head size over 128, float64, a chunk over 128, a
    chunk over 64 at the 128 instance."""
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
    (0, torch.float32, 64, False),       # no states
    (16, torch.float64, 64, False),      # dtype
    (16, torch.float32, 0, False),       # chunk 0
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
# gradients carry the forward's bf16 output (delta) and one output
# rounding; float16, with 3 more bits than bfloat16, bf16's bound over 8.
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2.5e-3}


def _bwd_inputs(device, dtype, b, s, t, h, kv, d, seed=0):
    dqk, dv = _dims(d)
    rng = np.random.default_rng(seed)
    shapes = [(b, s, h, dqk), (b, t, kv, dqk), (b, t, kv, dv), (b, s, h, dv)]
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
    out, lse = ops._forward(q, k, v, True, window, 1.0 / _dims(d)[0] ** 0.5, None,
                            with_lse=True)
    return flash_attention_backward(q, k, v, out, lse, do, causal=True, window=window)


@pytest.mark.parametrize("d, window", [(128, None), (64, 100), ((192, 128), None)])
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


@pytest.mark.parametrize("k, chunk", [(160, 32), (128, 96)])
def test_wkv_backward_kernel_rejects_what_it_does_not_take(cuda_device, k, chunk):
    """Past the reach: a head size over 128, a chunk over 64 at the 128
    instance."""
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


@pytest.mark.parametrize("n, chunk", [(0, 64), (16, 0)])
def test_ssm_backward_kernel_rejects_what_it_does_not_take(cuda_device, n, chunk):
    """Past the reach: no states, chunk 0."""
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


# Mixtral's attention: GQA 32/8 at D=128 with its sliding window of 4096,
# forward at S=8192 (the window cuts the keys) and backward at the training
# slice's heads.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_mixtral_shapes(cuda_device, dtype):
    _check_against_plain(cuda_device, dtype, 1, 8192, 8192, 32, 8, 128, True, 4096, None)


@pytest.mark.parametrize("s, window", [(512, 4096), (640, 256)])
def test_backward_kernel_at_mixtral_heads(cuda_device, s, window):
    _check_backward(cuda_device, torch.bfloat16, 128, 2, s, s, 32, 8, True, window, None)


def test_mixtral_forward_and_gradient_on_the_card(cuda_device):
    """A small float32 Mixtral (head dim 128, window 64 inside 96 tokens,
    remat on): the forward launches flash once a layer and equals the one
    with the plain attention through the ``attend`` seam, stats included;
    the loss's gradient through the kernels equals the plain one's."""
    import dataclasses
    import functools

    from repro_torch.configs import mixtral_8x7b
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.models.registry import build_api

    cfg = dataclasses.replace(
        mixtral_8x7b.reduced(), head_dim=128, window=64, decode_window=64, remat=True,
        capacity_factor=1.25, param_dtype=torch.float32, compute_dtype=torch.float32)
    api = build_api("mixtral-8x7b", cfg)
    model = api.init(0, device=cuda_device).requires_grad_(True)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 97)), device=cuda_device)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "weights": torch.ones(2, device=cuda_device)}
    before = flash_attention.launches
    logits, stats = model(batch["tokens"])
    assert flash_attention.launches == before + cfg.n_layers
    plain = functools.partial(attention_ref, causal=True, window=cfg.window)
    with torch.no_grad():
        ref_logits, ref_stats = model.train_forward(batch["tokens"], attend=plain)
    assert (logits - ref_logits).abs().max().item() <= 1e-4
    assert float(stats["drop_frac"]) == float(ref_stats["drop_frac"])
    grads = {}
    for name, attend in (("kernel", None), ("plain", plain)):
        before = (flash_attention.launches, flash_attention_backward.launches)
        model.train_forward = functools.partial(type(model).train_forward, model, attend=attend)
        loss, aux = api.loss(model, batch)
        grads[name] = torch.autograd.grad(loss, list(model.parameters()))
        del model.train_forward
        torch.cuda.synchronize()
        launched = (flash_attention.launches - before[0],
                    flash_attention_backward.launches - before[1])
        assert launched == ((2 * cfg.n_layers, cfg.n_layers) if name == "kernel" else (0, 0))
    for got, want in zip(grads["kernel"], grads["plain"]):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol


def test_bf16_flash_launches_from_a_thread_with_no_cuda_context(cuda_device):
    """A thread that has made no CUDA runtime call has no current context,
    and TMA's driver-side encoder fails there (CUDA_ERROR_INVALID_CONTEXT).
    Autograd's device thread is such a thread when flash is the first node
    its backward pass reaches and the caching allocator serves every
    tensor without a cudaMalloc.  The C entries bind the device's primary
    context first: the forward and the backward from a fresh thread, every
    allocation cached, give the main thread's bits."""
    import threading

    from repro_torch.kernels.flash_attention import flash_attention_backward, ops

    q, k, v, do = _bwd_inputs(cuda_device, torch.bfloat16, 2, 512, 512, 32, 8, 128)
    out, lse = ops._forward(q, k, v, True, None, 128 ** -0.5, None, with_lse=True)
    want = flash_attention_backward(q, k, v, out, lse, do, causal=True)
    # Free blocks in both of the allocator's pools for the thread's tensors.
    blocks = [torch.empty(n, dtype=torch.uint8, device=cuda_device) for n in [64 << 20] + [1 << 20] * 8]
    del blocks
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            got["out"] = flash_attention(q, k, v, causal=True)
            got["grads"] = flash_attention_backward(q, k, v, out, lse, do, causal=True)
            torch.cuda.synchronize()
        except Exception as err:  # handed to the main thread's assert
            got["error"] = err

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive(), "the thread's launches did not return"
    assert "error" not in got, got.get("error")
    assert torch.equal(got["out"], out)
    assert all(torch.equal(a, b) for a, b in zip(got["grads"], want))


# DeepSeek-V2's MLA: q and k at 192, v at 128 (bf16 and float32), and the
# instances at the reduced configs' head dims: float32 (32, 32) (reduced
# olmo-1b) and (48, 32) (reduced deepseek), bf16 (32, 32) (reduced
# llama3-8b, on the scalar body).
MLA_DIMS = [((192, 128), torch.bfloat16), ((192, 128), torch.float32),
            ((32, 32), torch.float32), ((48, 32), torch.float32),
            ((32, 32), torch.bfloat16)]
MLA_CASES = [
    # b, s, t, h, kv, causal, window, kv_len
    (1, 200, 200, 8, 8, True, None, None),     # ragged S, T
    (2, 130, 130, 8, 2, True, 64, None),       # GQA + window
    (1, 96, 250, 4, 4, False, None, 233),      # kv_len inside the last tile
]


@pytest.mark.parametrize("d, dtype", MLA_DIMS, ids=lambda x: str(x).replace("torch.", ""))
@pytest.mark.parametrize("b,s,t,h,kv,causal,window,kv_len", MLA_CASES)
def test_kernel_at_mla_and_reduced_head_dims(cuda_device, d, dtype, b, s, t, h, kv, causal,
                                             window, kv_len):
    _check_against_plain(cuda_device, dtype, b, s, t, h, kv, d, causal, window, kv_len)


@pytest.mark.parametrize("d, dtype", MLA_DIMS, ids=lambda x: str(x).replace("torch.", ""))
@pytest.mark.parametrize("b,s,t,h,kv,causal,window,kv_len", MLA_CASES)
def test_backward_kernel_at_mla_and_reduced_head_dims(cuda_device, d, dtype, b, s, t, h, kv,
                                                      causal, window, kv_len):
    _check_backward(cuda_device, dtype, d, b, s, t, h, kv, causal, window, kv_len)


def test_kernel_at_deepseek_heads(cuda_device):
    """The published MLA attention: 128 heads at (192, 128), S=1024, bf16."""
    _check_against_plain(cuda_device, torch.bfloat16, 1, 1024, 1024, 128, 128, (192, 128),
                         True, None, None)
    _check_backward(cuda_device, torch.bfloat16, (192, 128), 2, 512, 512, 128, 128, True,
                    None, None)


def _deepseek_on_card(device, **overrides):
    """A small float32 DeepSeek-V2 with the published MLA head dims (q/k
    128 + 64, v 128): 3 layers (dense + 2 MoE), remat on."""
    import dataclasses

    from repro_torch.configs import deepseek_v2_236b
    from repro_torch.models.registry import build_api

    cfg = dataclasses.replace(
        deepseek_v2_236b.reduced(), n_layers=3, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128, kv_lora_rank=64, remat=True, param_dtype=torch.float32,
        compute_dtype=torch.float32, **overrides)
    api = build_api("deepseek-v2-236b", cfg)
    return api, api.init(0, device=device)


def test_deepseek_forward_and_gradient_on_the_card(cuda_device):
    """The forward launches flash once a layer at (192, 128) and equals the
    one with the plain attention through the ``attend`` seam, stats
    included (capacity factor 1.25: routings drop); the loss's gradient
    through the kernels equals the plain one's."""
    import functools

    from repro_torch.kernels.flash_attention import flash_attention_backward

    api, model = _deepseek_on_card(cuda_device, capacity_factor=1.25)
    model.requires_grad_(True)
    cfg = api.cfg
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 97)), device=cuda_device)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "weights": torch.ones(2, device=cuda_device)}
    before = flash_attention.launches
    logits, stats = model(batch["tokens"])
    assert flash_attention.launches == before + cfg.n_layers
    plain = functools.partial(attention_ref, causal=True)
    with torch.no_grad():
        ref_logits, ref_stats = model.train_forward(batch["tokens"], attend=plain)
    assert (logits - ref_logits).abs().max().item() <= 1e-4
    assert float(stats["drop_frac"]) == float(ref_stats["drop_frac"]) > 0
    grads = {}
    for name, attend in (("kernel", None), ("plain", plain)):
        before = (flash_attention.launches, flash_attention_backward.launches)
        model.train_forward = functools.partial(type(model).train_forward, model, attend=attend)
        loss, _ = api.loss(model, batch)
        grads[name] = torch.autograd.grad(loss, list(model.parameters()))
        del model.train_forward
        torch.cuda.synchronize()
        launched = (flash_attention.launches - before[0],
                    flash_attention_backward.launches - before[1])
        assert launched == ((2 * cfg.n_layers, cfg.n_layers) if name == "kernel" else (0, 0))
    for got, want in zip(grads["kernel"], grads["plain"]):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol


def test_deepseek_absorbed_decode_matches_the_forward_on_the_card(cuda_device):
    """Dropless (capacity factor = experts / top-k): the kernel forward and
    the absorbed decode stepped over the latent cache give one function."""
    api, model = _deepseek_on_card(cuda_device, capacity_factor=2.0)
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, api.cfg.vocab, (1, 80)), device=cuda_device)
    logits, stats = model(tokens)
    assert float(stats["drop_frac"]) == 0.0
    cache = api.init_cache(1, 80, device=cuda_device)
    before = flash_attention.launches
    rows = [api.decode_step(model, cache, tokens[:, p:p + 1], p)[0] for p in range(80)]
    assert flash_attention.launches == before
    assert (torch.cat(rows, dim=1) - logits).abs().max().item() <= 1e-4


# Whisper's non-causal attentions: the cross-attention's S=375 queries
# against T=1500 frames (ragged in both), the encoder's S = T = 1500, and S
# and T both under one tile.  In the backward, the rows past S of the last
# q tile are zero-filled by TMA; their lse and delta must not turn P^T dO
# into inf * 0.
NONCAUSAL_CASES = [
    # b, s, t, h
    (2, 375, 1500, 4),
    (1, 1500, 1500, 2),
    (2, 37, 50, 4),
]


@pytest.mark.parametrize("d, dtype", [(32, torch.float32), (64, torch.bfloat16)],
                         ids=["f32-32", "bf16-64"])
@pytest.mark.parametrize("b,s,t,h", NONCAUSAL_CASES)
def test_noncausal_cross_lengths_forward_and_backward(cuda_device, d, dtype, b, s, t, h):
    _check_against_plain(cuda_device, dtype, b, s, t, h, h, d, False, None, None)
    _check_backward(cuda_device, dtype, d, b, s, t, h, h, False, None, None)


def _whisper_on_card(device):
    """Reduced whisper-large-v3 in float32 (2 + 2 layers, 4 heads of 32),
    remat on."""
    import dataclasses

    from repro_torch.configs import whisper_large_v3
    from repro_torch.models.registry import build_api

    cfg = dataclasses.replace(whisper_large_v3.reduced(), remat=True,
                              param_dtype=torch.float32, compute_dtype=torch.float32)
    api = build_api("whisper-large-v3", cfg)
    return api, api.init(0, device=device)


def test_whisper_forward_decode_and_gradient_on_the_card(cuda_device):
    """The forward launches flash once an attention (the encoder's and the
    cross non-causal at 100 frames, the decoder's causal) and equals the
    plain attention through the three seams and the stepped decode over
    the primed cache; the loss's gradient through the kernels equals the
    plain seams' (remat: each layer's attentions launched twice)."""
    import functools

    from repro_torch.kernels.flash_attention import flash_attention_backward

    api, model = _whisper_on_card(cuda_device)
    cfg = api.cfg
    n = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 38)), device=cuda_device)
    audio = torch.from_numpy(rng.standard_normal((2, 100, cfg.d_model), dtype=np.float32))
    batch = {"audio_embed": audio.to(cuda_device), "tokens": tokens[:, :-1],
             "labels": tokens[:, 1:], "weights": torch.tensor([1.0, 0.5], device=cuda_device)}
    seams = {"enc_attend": functools.partial(attention_ref, causal=False),
             "self_attend": functools.partial(attention_ref, causal=True),
             "cross_attend": functools.partial(attention_ref, causal=False)}
    before = flash_attention.launches
    logits = api.logits(model, batch)
    assert flash_attention.launches == before + n
    with torch.no_grad():
        plain = model.train_forward(batch["audio_embed"], batch["tokens"], **seams)
    assert (logits - plain).abs().max().item() <= 1e-4
    enc = model.encode(batch["audio_embed"])
    cache = model.prime_cache(api.init_cache(2, 37, device=cuda_device), enc)
    before = flash_attention.launches
    rows = [api.decode_step(model, cache, batch["tokens"][:, p:p + 1], p)[0] for p in range(37)]
    assert flash_attention.launches == before
    assert (torch.cat(rows, dim=1) - logits).abs().max().item() <= 1e-4
    model.requires_grad_(True)
    grads = {}
    for name, seam in (("kernel", {}), ("plain", seams)):
        before = (flash_attention.launches, flash_attention_backward.launches)
        model.train_forward = functools.partial(type(model).train_forward, model, **seam)
        loss, _ = api.loss(model, batch)
        grads[name] = torch.autograd.grad(loss, list(model.parameters()))
        del model.train_forward
        torch.cuda.synchronize()
        launched = (flash_attention.launches - before[0],
                    flash_attention_backward.launches - before[1])
        assert launched == ((2 * n, n) if name == "kernel" else (0, 0))
    for got, want in zip(grads["kernel"], grads["plain"]):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol


# ---------------------------------------------------------------------------
# The reduced configs' instances: flash's scalar body at (16, 16) (hymba-1.5b,
# 5 q heads over 1 KV head) in bf16 and float32 and at (48, 32) in bf16
# (deepseek-v2-236b's MLA); the WKV kernels at K = 32 (rwkv6-7b); the scan
# kernels at N = 8 (hymba-1.5b), each forward and backward against its
# plain version.
# ---------------------------------------------------------------------------
REDUCED_FLASH_CASES = [
    # b, s, t, h, kv, d, causal, window, kv_len
    (2, 100, 100, 5, 1, 16, True, None, None),        # GQA 5/1, ragged S
    (2, 100, 100, 5, 1, 16, True, 16, None),          # ... inside hymba's window of 16
    (4, 32, 32, 5, 1, 16, True, None, None),          # a reduced node slice
    (2, 70, 70, 4, 4, (48, 32), True, None, None),    # MLA, causal
    (1, 45, 90, 4, 4, (48, 32), False, None, 77),     # MLA, non-causal, kv_len, S != T
]


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window,kv_len", REDUCED_FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_flash_instances_match_plain(cuda_device, dtype, b, s, t, h, kv, d, causal,
                                             window, kv_len):
    _check_against_plain(cuda_device, dtype, b, s, t, h, kv, d, causal, window, kv_len)
    _check_backward(cuda_device, dtype, d, b, s, t, h, kv, causal, window, kv_len)


# ---------------------------------------------------------------------------
# The mma.sync kernels (csrc/flash_attention.cu, tc::): float32 at every
# (Dqk, Dv) pair and bf16 and float16 at (16, 16), (32, 32), (48, 32) and
# (256, 256), forward and backward, across their 32-row tiles' edges.
# ---------------------------------------------------------------------------
MMA_INSTANCES = ([(torch.float32, d) for d in (16, 32, (48, 32), 64, 128, (192, 128), 256)]
                 + [(torch.bfloat16, d) for d in (16, 32, (48, 32), 256)]
                 + [(torch.float16, d) for d in (16, 32, (48, 32), 256)])
MMA_CASES = [
    # b, s, t, h, kv, causal, window, kv_len
    (1, 300, 300, 4, 2, True, None, None),      # ragged S=300, GQA 2/1
    (1, 96, 250, 4, 4, False, None, 233),       # kv_len < T, non-causal S != T
    (1, 100, 40, 4, 4, False, None, None),      # non-causal, S > T
    (2, 130, 130, 4, 4, True, 40, None),        # windowed
    (2, 70, 70, 5, 1, True, None, None),        # GQA 5/1
]


def _mma_id(x):
    return str(x).replace("torch.", "").replace(" ", "")


@pytest.mark.parametrize("dtype, d", MMA_INSTANCES, ids=_mma_id)
@pytest.mark.parametrize("b,s,t,h,kv,causal,window,kv_len", MMA_CASES)
def test_mma_instances_match_plain_forward_and_backward(cuda_device, dtype, d, b, s, t, h, kv,
                                                        causal, window, kv_len):
    _check_against_plain(cuda_device, dtype, b, s, t, h, kv, d, causal, window, kv_len)
    _check_backward(cuda_device, dtype, d, b, s, t, h, kv, causal, window, kv_len)


@pytest.mark.parametrize("dtype, d", MMA_INSTANCES, ids=_mma_id)
def test_mma_backward_gives_the_same_bits_on_two_calls(cuda_device, dtype, d):
    """No atomics: dK/dV sum a GQA group inside one block, dQ has its own kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_backward, ops

    q, k, v, do = _bwd_inputs(cuda_device, dtype, 2, 300, 300, 8, 2, d, seed=2)
    out, lse = ops._forward(q, k, v, True, None, 1.0 / _dims(d)[0] ** 0.5, None, with_lse=True)
    first = flash_attention_backward(q, k, v, out, lse, do)
    second = flash_attention_backward(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("dtype, d", [(torch.float32, 32), (torch.bfloat16, 16)], ids=_mma_id)
@pytest.mark.parametrize("offset", ["base", "stride"])
def test_mma_kernels_copy_views_that_break_the_16_byte_rule(cuda_device, dtype, d, offset):
    """The mma.sync kernels read 16-byte rows: a view off a 16-byte base, or
    with rows (d + 1) elements apart, is refused by the C entry and copied,
    and gives the bits of contiguous inputs, forward and backward."""
    from repro_torch.kernels.flash_attention import flash_attention_backward, ops

    dense = _bwd_inputs(cuda_device, dtype, 1, 70, 70, 4, 4, d)

    def misaligned(x):
        if offset == "base":
            view = torch.zeros(x.numel() + 1, device=cuda_device, dtype=dtype)[1:].view(x.shape)
        else:
            view = torch.zeros(*x.shape[:3], d + 1, device=cuda_device, dtype=dtype)[..., :d]
        view.copy_(x)
        return view

    views = [misaligned(x) for x in dense]
    scale = 1.0 / d ** 0.5
    got = ops._forward(*views[:3], True, None, scale, None, with_lse=True)
    want = ops._forward(*dense[:3], True, None, scale, None, with_lse=True)
    grads = flash_attention_backward(*views[:3], *got, views[3])
    want_grads = flash_attention_backward(*dense[:3], *want, dense[3])
    torch.cuda.synchronize()
    for name, x, y in zip(("out", "lse", "dq", "dk", "dv"), (*got, *grads), (*want, *want_grads)):
        assert torch.equal(x, y), name


def test_launches_by_instance_counts_one_entry_a_call(cuda_device):
    """Each forward and each backward call adds one to its instance's count
    and to nothing else's."""
    from repro_torch.kernels.flash_attention import flash_attention_backward

    for dtype, d in MMA_INSTANCES:
        dqk, dv = _dims(d)
        key = ({torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}[dtype],
               dqk, dv)
        q, k, v, do = _bwd_inputs(cuda_device, dtype, 1, 40, 40, 4, 4, d)
        before = (dict(flash_attention.launches_by_instance),
                  dict(flash_attention_backward.launches_by_instance))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        flash_attention(*leaves).backward(do)
        torch.cuda.synchronize()
        for fn, was in zip((flash_attention, flash_attention_backward), before):
            now = dict(fn.launches_by_instance)
            assert now.get(key, 0) == was.get(key, 0) + 1, (fn.__name__, key)
            assert {x: n for x, n in now.items() if x != key} == {
                x: n for x, n in was.items() if x != key}, fn.__name__


@pytest.mark.parametrize("b,t,h,chunk,strong", [
    (4, 32, 4, 16, False),     # a reduced rwkv6-7b node slice
    (2, 300, 4, 16, False),    # ragged T at the config's chunk
    (1, 77, 4, 32, True),      # ragged T at chunk 32, every log-decay at the floor
    (3, 10, 2, 32, False),     # T < chunk
])
def test_wkv_kernels_at_head_size_32(cuda_device, b, t, h, chunk, strong):
    args = _wkv_inputs(b, t, h, cuda_device, k=32, seed=9, strong=strong)
    out, state, states = wkv_with_chunk_states(*args, chunk=chunk)
    torch.cuda.synchronize()
    _wkv_close(states, wkv_chunk_states(*args[1:4], chunk=chunk)[0])
    want_out, want_state = wkv_chunked(*args, chunk=chunk)
    _wkv_close(out, want_out)
    _wkv_close(state, want_state)
    d_out = torch.randn_like(args[0])
    d_state = torch.randn(b, h, 32, 32, device=cuda_device)
    got = wkv_backward(*args, state, d_out, d_state, chunk=chunk)
    again = wkv_backward(*args, state, d_out, d_state, chunk=chunk)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _bwd_close(got, wkv_backward_ref(*args, d_out, d_state))


@pytest.mark.parametrize("b,t,d,chunk,strong", [
    (4, 32, 128, 8, False),     # a reduced hymba-1.5b node slice (d_inner 128)
    (2, 301, 128, 64, False),   # ragged T, chunk 64
    (2, 77, 203, 8, True),      # D not a multiple of a block or sub-block, strong decay
    (1, 5, 9, 64, False),       # below one segment
])
def test_ssm_kernels_at_state_size_8(cuda_device, b, t, d, chunk, strong):
    u, dt, bt, ct, log_a = _ssm_inputs(b, t, d, cuda_device, n=8, seed=10, strong=strong)
    y, h, tiles = ssm_scan_tile_states(u, dt, bt, ct, log_a, chunk=chunk)
    torch.cuda.synchronize()
    want_y, want_h = selective_scan_ref(u, dt, log_a, bt, ct)
    _ssm_close(y, want_y)
    _ssm_close(h, want_h)
    dy = torch.randn_like(u)
    dh = torch.randn(b, d, 8, device=cuda_device)
    got = ssm_scan_backward(u, dt, bt, ct, log_a, dy, dh, chunk=chunk, tiles=tiles)
    again = ssm_scan_backward(u, dt, bt, ct, log_a, dy, dh, chunk=chunk, tiles=tiles)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _bwd_close(got, ssm_scan_backward_ref(u, dt, bt, ct, log_a, dy, dh))


# ---------------------------------------------------------------------------
# The SSM kernels' reach: bf16 inputs, any state size, any chunk; WKV head
# sizes up to 128 and chunks up to 128.  Forward and backward through the
# public entries against the plain versions on the inputs widened to
# float32 (float32 outputs within the float32 tolerance; a bf16 output or
# gradient the plain value rounded or one bf16 step away); a bf16 call's
# outputs and gradients equal the float32-copy call's rounded, bit for bit.
# ---------------------------------------------------------------------------


def _steps16(got, want, tol):
    """How many steps (ulps) of ``got``'s 16-bit dtype ``got`` lies from
    ``want`` rounded to it, beyond ``tol``."""
    bits = {torch.bfloat16: 8, torch.float16: 11}[got.dtype]  # the implicit one in
    info = torch.finfo(got.dtype)
    r16 = want.to(got.dtype).float()
    _, e = torch.frexp(r16)
    ulp = torch.where(r16 == 0, torch.zeros_like(r16),
                      torch.ldexp(torch.ones_like(r16), e - bits))
    ulp = ulp.clamp(min=info.smallest_normal * info.eps)  # the smallest subnormal
    excess = ((got.float() - r16).abs() - tol).clamp(min=0.0)
    return (excess / ulp).max().item()


def _reach_close(got, want, rel):
    """The float32 tolerance for float32 ``got``; for bfloat16 or float16
    ``got`` the plain value rounded, or one step of that dtype away."""
    want = want.float()
    tol = rel * max(1.0, want.abs().max().item())
    assert got.shape == want.shape
    if got.dtype in (torch.bfloat16, torch.float16):
        assert _steps16(got, want, tol) <= 1.0
    else:
        assert (got - want).abs().max().item() <= tol


def _reach_grads(fn, leaves, outs_grad):
    outs = fn(*leaves)
    return outs, torch.autograd.grad(outs, leaves, outs_grad)


@pytest.mark.parametrize("b,t,d,n,chunk,dtypes", [
    (2, 300, 64, 16, 64, ("bf16",) * 5),                      # TMA in bf16
    (2, 300, 203, 16, 64, ("bf16",) * 5),                     # odd rows: plain loads
    (1, 77, 48, 5, 64, ("f32",) * 5),                         # N = 5 on the 8 instance
    (1, 77, 48, 24, 64, ("f32",) * 5),                        # the 32 instance
    (1, 77, 48, 64, 64, ("f32",) * 5),                        # the 64 instance
    (1, 77, 48, 72, 64, ("f32",) * 5),                        # two groups, 64 + 8
    (1, 77, 48, 130, 64, ("bf16",) * 5),                      # three groups in bf16
    (1, 300, 48, 16, 256, ("f32",) * 5),                      # chunk 256
    (2, 100, 64, 16, 64, ("bf16", "f32", "bf16", "f32", "bf16")),  # mixed dtypes
])
def test_ssm_reach_matches_plain_version(cuda_device, b, t, d, n, chunk, dtypes):
    kinds = {"f32": torch.float32, "bf16": torch.bfloat16}
    u, dt, bt, ct, log_a = _ssm_inputs(b, t, d, cuda_device, n=n, seed=21)
    x = [a.to(kinds[k]) for a, k in zip((u, dt, bt, ct, log_a), dtypes)]
    dy = torch.randn(b, t, d, device=cuda_device).to(x[0].dtype)
    dh = torch.randn(b, d, n, device=cuda_device)

    def call(*leaves):
        return ssm_scan(*leaves, chunk=chunk)

    leaves = [a.clone().requires_grad_() for a in x]
    before = dict(ssm_scan.launches_by_instance)
    (y, h), grads = _reach_grads(call, leaves, (dy, dh))
    (_, _), again = _reach_grads(call, leaves, (dy, dh))
    torch.cuda.synchronize()
    assert y.dtype == x[0].dtype and h.dtype == torch.float32
    assert all(g.dtype == a.dtype for g, a in zip(grads, x))
    assert all(torch.equal(g, a) for g, a in zip(grads, again))
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    # Two dtypes, or groups past 64 states: float32 copies.
    common = "bf16" if set(dtypes[:4]) == {"bf16"} and n <= ssm_ops.GROUP else "f32"
    for g, _ in ssm_ops._groups(n):
        key = (common, ssm_ops.instance(g.stop - g.start))
        assert ssm_scan.launches_by_instance[key] > before.get(key, 0), key
    wide = [a.float() for a in x]
    want_y, want_h = selective_scan_ref(wide[0], wide[1], wide[4], wide[2], wide[3])
    _reach_close(y, want_y, SSM_REL)
    _reach_close(h, want_h, SSM_REL)
    want = ssm_scan_backward_ref(*wide, dy.float(), dh)
    for g, w in zip(grads, want):
        _reach_close(g, w, BWD_KERNEL_REL)
    if set(dtypes) == {"bf16"}:
        leaves32 = [a.float().requires_grad_() for a in x]
        (y32, h32), grads32 = _reach_grads(call, leaves32, (dy.float(), dh))
        assert torch.equal(y, y32.to(torch.bfloat16)) and torch.equal(h, h32)
        assert all(torch.equal(g, g32.to(torch.bfloat16)) for g, g32 in zip(grads, grads32))


@pytest.mark.parametrize("b,t,h,k,chunk,dtype", [
    (2, 300, 4, 64, 64, torch.bfloat16),     # plain loads, widened
    (2, 300, 4, 20, 32, torch.bfloat16),     # bf16 on the 32 instance, zero-padded
    (2, 300, 4, 20, 32, torch.float32),      # the 32 instance, zero-padded
    (1, 200, 2, 96, 64, torch.float32),      # the 128 instance, zero-padded
    (1, 200, 2, 128, 48, torch.float32),     # the 128 instance
    (1, 300, 2, 64, 128, torch.float32),     # 128-row tiles
    (2, 300, 2, 32, 100, torch.float32),     # chunk 100 on 128-row tiles at K = 32
])
def test_wkv_reach_matches_plain_version(cuda_device, b, t, h, k, chunk, dtype):
    r, kk, v, lw, u = _wkv_inputs(b, t, h, cuda_device, k=k, seed=22)
    if chunk > 64:  # keep the mid-point factors exp(L_C / 2) inside float32
        lw = lw * 0.1
    x = [a.to(dtype) for a in (r, kk, v, lw, u)]
    d_out = torch.randn(b, t, h, k, device=cuda_device).to(dtype)
    d_state = torch.randn(b, h, k, k, device=cuda_device)

    def call(*leaves):
        return wkv(*leaves, chunk=chunk)

    leaves = [a.clone().requires_grad_() for a in x]
    (out, state), grads = _reach_grads(call, leaves, (d_out, d_state))
    (_, _), again = _reach_grads(call, leaves, (d_out, d_state))
    torch.cuda.synchronize()
    assert out.dtype == dtype and state.dtype == torch.float32
    assert all(g.dtype == dtype for g in grads)
    assert all(torch.equal(g, a) for g, a in zip(grads, again))
    wide = [a.float() for a in x]
    want_out, want_state = wkv_chunked(*wide, chunk=chunk)
    _reach_close(out, want_out, WKV_REL)
    _reach_close(state, want_state, WKV_REL)
    for g, w in zip(grads, wkv_backward_ref(*wide, d_out.float(), d_state)):
        _reach_close(g, w, BWD_KERNEL_REL)
    if dtype == torch.bfloat16:
        leaves32 = [a.float().requires_grad_() for a in x]
        (o32, s32), grads32 = _reach_grads(call, leaves32, (d_out.float(), d_state))
        assert torch.equal(out, o32.to(dtype)) and torch.equal(state, s32)
        assert all(torch.equal(g, g32.to(dtype)) for g, g32 in zip(grads, grads32))


def test_wkv_bf16_view_off_its_rows_runs_on_a_copy(cuda_device):
    """bf16 r/k/v/log_w read as views 2 bytes off an 8-byte boundary (the
    last 64 channels of 65) run the same kernel on contiguous copies: the
    contiguous call's bits, forward and backward."""
    r, kk, v, lw, u = _wkv_inputs(1, 100, 2, cuda_device, k=65, seed=24)
    views = [a.to(torch.bfloat16)[..., 1:] for a in (r, kk, v, lw)]
    assert all(a.data_ptr() % 8 for a in views)
    uu = u[:, 1:].contiguous()
    d_out = torch.randn(1, 100, 2, 64, device=cuda_device).to(torch.bfloat16)
    results = []
    for x in (views, [a.contiguous() for a in views]):
        leaves = [a.detach().requires_grad_() for a in (*x, uu)]
        d_state = torch.zeros(1, 2, 64, 64, device=cuda_device)
        results.append(_reach_grads(lambda *a: wkv(*a, chunk=32), leaves, (d_out, d_state)))
    ((out, state), grads), ((out_c, state_c), grads_c) = results
    assert torch.equal(out, out_c) and torch.equal(state, state_c)
    assert all(torch.equal(g, c) for g, c in zip(grads, grads_c))


def test_reach_launches_count_by_dtype_and_instance(cuda_device):
    """launches_by_instance keys are (dtype name, the instance's size)."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    u, dt, bt, ct, log_a = _ssm_inputs(1, 40, 32, cuda_device, n=24, seed=23)
    before = dict(ssm_scan.launches_by_instance)
    ssm_scan(*(a.bfloat16() for a in (u, dt, bt, ct, log_a)), chunk=64)
    assert ssm_scan.launches_by_instance[("bf16", 32)] == before.get(("bf16", 32), 0) + 1
    assert ssm_ops.instance(24) == 32
    r, kk, v, lw, uu = _wkv_inputs(1, 40, 2, cuda_device, k=96, seed=23)
    before = dict(wkv.launches_by_instance)
    wkv(r, kk, v, lw, uu, chunk=32)
    assert wkv.launches_by_instance[("f32", 128)] == before.get(("f32", 128), 0) + 1
    assert wkv_ops.instance(96) == 128


def test_hymba_bf16_call_site_on_the_card_matches_the_float32_copies(cuda_device):
    """Reduced hymba-1.5b (bf16): the kernels handed the bf16 tensors give
    the logits and gradients of the float32-copy call site, bit for bit."""
    from repro_torch.configs import get_api

    api = get_api("hymba-1.5b", reduced=True)
    model = api.init(0, device="cuda")
    tokens = torch.randint(0, api.cfg.vocab, (2, 32), device=cuda_device,
                           generator=torch.Generator(device=cuda_device).manual_seed(3))
    params = [p.requires_grad_() for p in model.parameters()]

    def float_copies(u, dt, b_t, c_t, log_a, chunk):
        y, h = ssm_scan(u.float(), dt.float(), b_t.float(), c_t.float(), log_a.float(),
                        chunk=chunk)
        return y.to(u.dtype), h

    results = []
    for seam in (None, float_copies):
        logits = model.train_forward(tokens, scan=seam)
        results.append((logits.detach(), torch.autograd.grad(logits.float().square().mean(),
                                                             params)))
    (a_logits, a_grads), (b_logits, b_grads) = results
    assert torch.equal(a_logits, b_logits)
    assert all(torch.equal(x, y) for x, y in zip(a_grads, b_grads))


# ---------------------------------------------------------------------------
# The flash reach and float16: float16 in the three kernels, forward and
# backward (flash on the wgmma kernels at (64, 64), (128, 128), (192, 128)
# and on the mma.sync ones at the other pairs); flash at every (Dqk, Dv) up
# to 256, run on the smallest instance that holds it with zero channels;
# q, k, v (and the SSM inputs) in more than one dtype on float32 copies.
# ---------------------------------------------------------------------------
F16_EDGE_CASES = BF16_EDGE_CASES + [
    (1, 300, 300, 8, 2, (192, 128), True, None, None),   # the MLA instance
]


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window,kv_len", F16_EDGE_CASES)
def test_f16_kernel_at_tile_edges(cuda_device, b, s, t, h, kv, d, causal, window, kv_len):
    _check_against_plain(cuda_device, torch.float16, b, s, t, h, kv, d, causal, window, kv_len)


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window,kv_len", BWD_BF16_EDGE_CASES)
def test_f16_backward_at_tile_edges(cuda_device, b, s, t, h, kv, d, causal, window, kv_len):
    _check_backward(cuda_device, torch.float16, d, b, s, t, h, kv, causal, window, kv_len)


@pytest.mark.parametrize("d", [64, 128, (192, 128), 32, 256, 100])
def test_f16_backward_gives_the_same_bits_on_two_calls(cuda_device, d):
    """No atomics, on the wgmma and the mma.sync instances and a padded call."""
    from repro_torch.kernels.flash_attention import flash_attention_backward, ops

    q, k, v, do = _bwd_inputs(cuda_device, torch.float16, 2, 333, 333, 8, 2, d, seed=3)
    out, lse = ops._forward(q, k, v, True, None, 1.0 / _dims(d)[0] ** 0.5, None, with_lse=True)
    first = flash_attention_backward(q, k, v, out, lse, do)
    second = flash_attention_backward(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("offset", ["base", "stride"])
def test_f16_kernel_rejects_misaligned_views(cuda_device, offset):
    """The float16 wgmma kernels read through TMA tensor maps: a view off
    16-byte rows raises with TMA's reason and is never launched."""
    if offset == "base":
        x = torch.zeros(8 * 4 * 128 + 1, device=cuda_device, dtype=torch.float16)
        x = x[1:].view(1, 8, 4, 128)
    else:
        x = torch.zeros(1, 8, 4, 129, device=cuda_device, dtype=torch.float16)[..., 1:]
    before = flash_attention.launches
    with pytest.raises(ValueError, match="f16 wgmma kernel cannot read .*TMA refused"):
        flash_attention(x, x, x)
    assert flash_attention.launches == before


PADDED_DIMS = [8, 40, 96, 100, 160, 256, (96, 64), (200, 100)]
PADDED_CASES = [
    # b, s, t, h, kv, causal, window, kv_len
    (2, 300, 300, 4, 2, True, None, None),      # GQA 2/1, ragged S
    (1, 130, 130, 4, 4, True, 40, None),        # windowed
    (1, 96, 250, 4, 4, False, None, 233),       # non-causal, S != T, kv_len
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda x: str(x).replace("torch.", ""))
@pytest.mark.parametrize("d", PADDED_DIMS, ids=_mma_id)
@pytest.mark.parametrize("b,s,t,h,kv,causal,window,kv_len", PADDED_CASES)
def test_every_head_dim_up_to_256_matches_plain(cuda_device, dtype, d, b, s, t, h, kv, causal,
                                                window, kv_len):
    """A call off the instance table runs on the smallest instance that
    holds it (``ops.instance``), q/k and v padded by zero channels, with the
    caller's scale; (256, 256) is an instance of its own."""
    from repro_torch.kernels.flash_attention import flash_attention_backward, ops

    names = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
    key = (names[dtype], *ops.instance(dtype, *_dims(d)))
    before = (flash_attention.launches_by_instance[key],
              flash_attention_backward.launches_by_instance[key])
    _check_against_plain(cuda_device, dtype, b, s, t, h, kv, d, causal, window, kv_len)
    _check_backward(cuda_device, dtype, d, b, s, t, h, kv, causal, window, kv_len)
    assert flash_attention.launches_by_instance[key] == before[0] + 2
    assert flash_attention_backward.launches_by_instance[key] == before[1] + 1


def test_flash_mixed_dtypes_run_on_float32_copies(cuda_device):
    """q float16, k float32, v bfloat16: the float32 kernel on copies, the
    output in q's dtype and each gradient in its input's, equal to the
    float32 call on the same values cast."""
    from repro_torch.kernels.flash_attention import flash_attention_backward

    q, k, v, do = _bwd_inputs(cuda_device, torch.float32, 2, 300, 300, 4, 2, 96, seed=4)
    x = [q.half(), k, v.bfloat16()]
    before = (flash_attention.launches_by_instance[("f32", 128, 128)],
              flash_attention_backward.launches_by_instance[("f32", 128, 128)])
    leaves = [a.clone().requires_grad_() for a in x]
    out = flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do.half())
    wide = [a.float().requires_grad_() for a in x]
    want = flash_attention(*wide)
    want_grads = torch.autograd.grad(want, wide, do.half().float())
    torch.cuda.synchronize()
    assert flash_attention.launches_by_instance[("f32", 128, 128)] == before[0] + 2
    assert flash_attention_backward.launches_by_instance[("f32", 128, 128)] == before[1] + 2
    assert out.dtype == torch.float16 and torch.equal(out, want.half())
    for g, w, a in zip(grads, want_grads, x):
        assert g.dtype == a.dtype and torch.equal(g, w.to(a.dtype))
    plain = attention_ref(*[a.float() for a in x])
    assert (out.float() - plain).abs().max().item() <= ATOL[torch.float16]


@pytest.mark.parametrize("b,t,d,n,chunk,dtypes", [
    (2, 300, 64, 16, 64, ("f16",) * 5),                       # TMA in float16
    (2, 300, 203, 16, 64, ("f16",) * 5),                      # odd rows: plain loads
    (4, 32, 128, 8, 8, ("f16",) * 5),                         # reduced hymba's node slice
    (1, 77, 48, 5, 64, ("f16",) * 5),                         # N = 5 on the 8 instance
    (1, 77, 48, 32, 64, ("f16",) * 5),                        # the 32 instance
    (1, 77, 48, 64, 64, ("f16",) * 5),                        # the 64 instance
    (2, 100, 64, 16, 64, ("f16", "f32", "bf16", "f16", "f32")),  # mixed dtypes
])
def test_ssm_f16_matches_plain_version(cuda_device, b, t, d, n, chunk, dtypes):
    """float16 (and float16 among mixed dtypes) forward and backward through
    ``ssm_scan``: the plain version on the inputs widened under the float16
    rule, two backward calls the same bits, and a float16 call's outputs
    and gradients the float32-copy call's rounded, bit for bit."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    kinds = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    u, dt, bt, ct, log_a = _ssm_inputs(b, t, d, cuda_device, n=n, seed=31)
    x = [a.to(kinds[k]) for a, k in zip((u, dt, bt, ct, log_a), dtypes)]
    dy = torch.randn(b, t, d, device=cuda_device).to(x[0].dtype)
    dh = torch.randn(b, d, n, device=cuda_device)

    def call(*leaves):
        return ssm_scan(*leaves, chunk=chunk)

    leaves = [a.clone().requires_grad_() for a in x]
    before = dict(ssm_scan.launches_by_instance)
    (y, h), grads = _reach_grads(call, leaves, (dy, dh))
    (_, _), again = _reach_grads(call, leaves, (dy, dh))
    torch.cuda.synchronize()
    assert y.dtype == x[0].dtype and h.dtype == torch.float32
    assert all(g.dtype == a.dtype for g, a in zip(grads, x))
    assert all(torch.equal(g, a) for g, a in zip(grads, again))
    common = "f16" if set(dtypes[:4]) == {"f16"} else "f32"
    key = (common, ssm_ops.instance(n))
    assert ssm_scan.launches_by_instance[key] > before.get(key, 0), key
    wide = [a.float() for a in x]
    want_y, want_h = selective_scan_ref(wide[0], wide[1], wide[4], wide[2], wide[3])
    _reach_close(y, want_y, SSM_REL)
    _reach_close(h, want_h, SSM_REL)
    for g, w in zip(grads, ssm_scan_backward_ref(*wide, dy.float(), dh)):
        _reach_close(g, w, BWD_KERNEL_REL)
    if common == "f16":
        leaves32 = [a.float().requires_grad_() for a in x]
        (y32, h32), grads32 = _reach_grads(call, leaves32, (dy.float(), dh))
        assert torch.equal(y, y32.half()) and torch.equal(h, h32)
        assert all(torch.equal(g, g32.to(a.dtype)) for g, g32, a in zip(grads, grads32, x))


@pytest.mark.parametrize("b,t,h,k,chunk,dtypes", [
    (2, 300, 4, 64, 64, ("f16",) * 5),                   # 8-byte loads, widened
    (4, 32, 4, 32, 16, ("f16",) * 5),                    # reduced rwkv6's node slice
    (2, 300, 4, 20, 32, ("f16",) * 5),                   # the 32 instance, zero-padded
    (1, 200, 2, 128, 48, ("f16",) * 5),                  # the 128 instance
    (2, 100, 2, 64, 32, ("f16", "f32", "f16", "bf16", "f32")),  # mixed dtypes
])
def test_wkv_f16_matches_plain_version(cuda_device, b, t, h, k, chunk, dtypes):
    kinds = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    args = _wkv_inputs(b, t, h, cuda_device, k=k, seed=32)
    x = [a.to(kinds[kd]) for a, kd in zip(args, dtypes)]
    d_out = torch.randn(b, t, h, k, device=cuda_device).to(x[0].dtype)
    d_state = torch.randn(b, h, k, k, device=cuda_device)

    def call(*leaves):
        return wkv(*leaves, chunk=chunk)

    leaves = [a.clone().requires_grad_() for a in x]
    (out, state), grads = _reach_grads(call, leaves, (d_out, d_state))
    (_, _), again = _reach_grads(call, leaves, (d_out, d_state))
    torch.cuda.synchronize()
    assert out.dtype == x[0].dtype and state.dtype == torch.float32
    assert all(g.dtype == a.dtype for g, a in zip(grads, x))
    assert all(torch.equal(g, a) for g, a in zip(grads, again))
    wide = [a.float() for a in x]
    want_out, want_state = wkv_chunked(*wide, chunk=chunk)
    _reach_close(out, want_out, WKV_REL)
    _reach_close(state, want_state, WKV_REL)
    for g, w in zip(grads, wkv_backward_ref(*wide, d_out.float(), d_state)):
        _reach_close(g, w, BWD_KERNEL_REL)
    if set(dtypes) == {"f16"}:
        leaves32 = [a.float().requires_grad_() for a in x]
        (o32, s32), grads32 = _reach_grads(call, leaves32, (d_out.float(), d_state))
        assert torch.equal(out, o32.half()) and torch.equal(state, s32)
        assert all(torch.equal(g, g32.half()) for g, g32 in zip(grads, grads32))


def test_f16_launches_count_by_dtype_and_instance(cuda_device):
    """launches_by_instance keys read ("f16", ...) for float16 calls."""
    from repro_torch.kernels.flash_attention import ops

    q, k, v, do = _bwd_inputs(cuda_device, torch.float16, 1, 40, 40, 4, 4, 40)
    before = flash_attention.launches_by_instance[("f16", 64, 64)]
    flash_attention(q, k, v)
    assert flash_attention.launches_by_instance[("f16", 64, 64)] == before + 1
    assert ops.uses_wgmma(torch.float16, 40, 40)
    u, dt, bt, ct, log_a = _ssm_inputs(1, 40, 32, cuda_device, n=16, seed=33)
    before = ssm_scan.launches_by_instance[("f16", 16)]
    ssm_scan(*(a.half() for a in (u, dt, bt, ct, log_a)), chunk=64)
    assert ssm_scan.launches_by_instance[("f16", 16)] == before + 1
    r, kk, vv, lw, uu = _wkv_inputs(1, 40, 2, cuda_device, k=64, seed=33)
    before = wkv.launches_by_instance[("f16", 64)]
    wkv(*(a.half() for a in (r, kk, vv, lw, uu)), chunk=32)
    assert wkv.launches_by_instance[("f16", 64)] == before + 1
