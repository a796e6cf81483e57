"""Port flash attention vs the JAX package.

The port's ``flash_attention`` on CPU tensors (its plain version) is held
against the JAX Pallas kernel in interpret mode and against the JAX
``attention_ref``, float32, atol 1e-5 (float32 sums in another order).  At
the MLA head dims, where v's differs from q's and k's ((48, 32): reduced
deepseek-v2-236b; (192, 128): the published one), the Pallas kernel takes
one head dim, so the plain version is held against the reference model's
``common.full_attention``, which takes both.  The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.flash_attention.flash_attention import flash_attention_kernel  # noqa: E402
from repro.models.common import full_attention as jax_full_attention  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

ATOL = 1e-5

CASES = [
    # b, s, t, h, kv, d, causal, window
    (2, 128, 128, 4, 4, 64, True, None),
    (2, 100, 100, 2, 2, 64, True, None),    # S, T not block multiples
    (1, 256, 256, 4, 4, 64, True, 64),      # sliding window
    (2, 64, 192, 2, 2, 32, False, None),    # non-causal, cross lengths
    (1, 128, 128, 8, 2, 128, True, None),   # GQA rep 4, the kernel's head dim
    (1, 70, 130, 8, 2, 32, True, None),     # GQA with ragged S and T
    (1, 150, 150, 4, 2, 64, True, 40),      # GQA + window + ragged
    (2, 70, 70, 5, 1, 16, True, None),      # reduced hymba-1.5b: d 16, GQA 5/1
    (2, 70, 70, 5, 1, 16, True, 16),        # ... and its window of 16
]


MLA_CASES = [
    # b, s, t, h, kv, dqk, dv, causal, kv_len
    (2, 40, 40, 4, 4, 48, 32, True, None),       # reduced deepseek, causal
    (1, 33, 50, 4, 4, 48, 32, False, 37),        # non-causal, kv_len, S != T
    (1, 48, 48, 8, 2, 192, 128, True, None),     # the published dims, GQA
    (1, 40, 66, 2, 2, 192, 128, False, 50),      # non-causal, kv_len
]


def _inputs(b, s, t, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, t, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, t, kv, d), dtype=np.float32)
    return q, k, v


def _fold(x, b, h, d):
    return x.transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], d)


@pytest.fixture(autouse=True)
def _count_from_zero():
    flash_attention.launches = 0
    yield
    flash_attention.launches = 0


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window", CASES)
def test_plain_version_matches_pallas_interpret(b, s, t, h, kv, d, causal, window):
    q, k, v = _inputs(b, s, t, h, kv, d)
    want = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=causal, window=window, block_q=64, block_k=64,
    )
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window,
    )
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert flash_attention.launches == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window", CASES)
def test_plain_version_matches_jax_ref(b, s, t, h, kv, d, causal, window):
    q, k, v = _inputs(b, s, t, h, kv, d, seed=1)
    rep = h // kv
    kr, vr = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    want = jax_attention_ref(
        jnp.asarray(_fold(q, b, h, d)), jnp.asarray(_fold(kr, b, h, d)),
        jnp.asarray(_fold(vr, b, h, d)), causal=causal, window=window,
    )
    want = np.asarray(want).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    got = attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kv_len", [0, 1, 77, 128])
def test_kv_len_matches_pallas_kernel(kv_len):
    """The runtime kv_len mask, against the Pallas kernel's own kv_len."""
    b, s, t, h, d = 1, 128, 128, 2, 64
    q, k, v = _inputs(b, s, t, h, h, d, seed=2)
    want = flash_attention_kernel(
        jnp.asarray(_fold(q, b, h, d)), jnp.asarray(_fold(k, b, h, d)),
        jnp.asarray(_fold(v, b, h, d)), causal=False, block_q=64, block_k=64,
        kv_len=kv_len,
    )
    want = np.asarray(want).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=False, kv_len=kv_len,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if kv_len == 0:
        assert not got.any()  # rows with no valid key give zeros


@pytest.mark.parametrize("b,s,t,h,kv,dqk,dv,causal,kv_len", MLA_CASES)
def test_plain_version_at_mla_dims_matches_full_attention(b, s, t, h, kv, dqk, dv, causal,
                                                          kv_len):
    """``kv_len`` enters the reference as keys sliced off (it has no such
    mask); its KV chunk is 32, so the chunked online softmax runs."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for shape in ((b, s, h, dqk), (b, t, kv, dqk), (b, t, kv, dv)))
    n = t if kv_len is None else kv_len
    reference = jax.jit(functools.partial(jax_full_attention, causal=causal, kv_chunk=32))
    want = reference(jnp.asarray(q), jnp.asarray(k[:, :n]), jnp.asarray(v[:, :n]))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, kv_len=kv_len)
    assert got.shape == (b, s, h, dv) and flash_attention.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "shapes, kwargs",
    [
        (((1, 8, 4, 32), (1, 8, 3, 32), (1, 8, 3, 32)), {}),        # H % KV
        (((1, 8, 4, 32), (1, 8, 2, 32), (1, 9, 2, 32)), {}),        # k/v mismatch
        (((1, 8, 4, 32), (1, 8, 2, 16), (1, 8, 2, 16)), {}),        # head dims
        (((1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32)), {"kv_len": 9}),
        (((1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32)), {"window": 0}),
    ],
)
def test_wrapper_rejects_bad_calls(shapes, kwargs):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kwargs)
