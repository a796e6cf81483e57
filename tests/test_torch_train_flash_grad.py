"""Flash attention's gradient in the port vs ``jax.grad`` through the reference.

On the CPU the port's ``flash_attention`` is its plain version under
autograd; its dQ, dK and dV are held against ``jax.grad`` through the JAX
package's ``attention_ref`` (GQA by repeating k/v, ``kv_len`` by slicing
them), float32, at head dims 64 and 128 with every mask the kernel takes,
atol 1e-5; at the MLA head dims (q/k 48 or 192, v 32 or 128) against
``jax.grad`` through the reference model's ``common.full_attention``
(``kv_len`` by slicing), and with a window through ``attention_ref``.  The plain versions of what the CUDA training path adds —
each row's log-sum-exp and the backward kernel's formulas
(``attention_backward_ref``, which ``flash_attention_backward`` runs on
CPU tensors) — are held to the same oracle.  The CUDA kernels themselves
are held against autograd through ``attention_ref`` on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.models.common import full_attention as jax_full_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_backward_ref,
    attention_lse_ref,
    flash_attention,
    flash_attention_backward,
    ops,
)

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

ATOL = 1e-5

CASES = [
    # b, s, t, h, kv, d, causal, window, kv_len
    (2, 40, 40, 4, 4, 64, True, None, None),     # causal MHA
    (1, 70, 70, 8, 2, 64, True, None, None),     # GQA 4:1 (llama3-8b's ratio)
    (1, 72, 72, 4, 2, 64, True, 16, None),       # window + GQA
    (1, 33, 50, 4, 4, 64, False, None, 37),      # kv_len, non-causal, S != T
    (2, 40, 40, 4, 4, 128, True, None, None),    # head dim 128
    (1, 66, 66, 8, 2, 128, True, 24, None),      # window + GQA at 128
    (1, 48, 48, 4, 1, 128, True, None, 30),      # kv_len + causal + GQA
]


# The MLA head dims: b, s, t, h, kv, (dqk, dv), causal, window, kv_len.
MLA_CASES = [
    (2, 40, 40, 4, 4, (48, 32), True, None, None),      # reduced deepseek, causal
    (1, 33, 50, 4, 4, (48, 32), False, None, 37),       # kv_len, non-causal, S != T
    (1, 48, 48, 8, 2, (192, 128), True, None, 30),      # the published dims: kv_len + GQA
    (1, 70, 70, 4, 2, (192, 128), True, 24, None),      # window + GQA
]


def _inputs(b, s, t, h, kv, d, seed=0):
    dqk, dv = d if isinstance(d, tuple) else (d, d)
    rng = np.random.default_rng(seed)
    shapes = [(b, s, h, dqk), (b, t, kv, dqk), (b, t, kv, dv), (b, s, h, dv)]
    return [rng.standard_normal(shape, dtype=np.float32) for shape in shapes]


def _jax_attention(q, k, v, *, causal, window, kv_len):
    """Model-layout attention through the reference's folded oracle."""
    b, s, h, d = q.shape
    t = k.shape[1] if kv_len is None else kv_len
    k, v = k[:, :t], v[:, :t]
    rep = h // k.shape[2]
    k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)

    def fold(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], x.shape[-1])

    out = jax_attention_ref(fold(q), fold(k), fold(v), causal=causal, window=window)
    return out.reshape(b, h, s, v.shape[-1]).transpose(0, 2, 1, 3)


def _jax_mla_attention(q, k, v, *, causal, window, kv_len):
    """The reference model's attention, which takes v's own head dim; it
    has no window, so a window goes through the folded oracle."""
    if window is not None:
        return _jax_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    t = k.shape[1] if kv_len is None else kv_len
    return jax_full_attention(q, k[:, :t], v[:, :t], causal=causal, kv_chunk=32)


def _jax_grads(q, k, v, do, attention=_jax_attention, jit=False, **mask):
    def f(q, k, v):
        return jnp.sum(attention(q, k, v, **mask) * do)

    grad = jax.grad(f, argnums=(0, 1, 2))
    return [np.asarray(g) for g in (jax.jit(grad) if jit else grad)(q, k, v)]


def _assert_close(got, want, names=("dq", "dk", "dv")):
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window,kv_len", CASES)
def test_autograd_flash_matches_jax_grad(b, s, t, h, kv, d, causal, window, kv_len):
    q, k, v, do = _inputs(b, s, t, h, kv, d)
    mask = dict(causal=causal, window=window, kv_len=kv_len)
    want = _jax_grads(q, k, v, do, **mask)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attention(qt, kt, vt, **mask)
    out.backward(torch.from_numpy(do))
    _assert_close((qt.grad, kt.grad, vt.grad), want)


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window,kv_len", CASES)
def test_backward_formulas_match_jax_grad(b, s, t, h, kv, d, causal, window, kv_len):
    """The plain version of the backward kernel (P from the saved lse,
    delta = rowsum(dO O), dS, the GQA sums) gives jax.grad's gradients."""
    q, k, v, do = _inputs(b, s, t, h, kv, d, seed=1)
    mask = dict(causal=causal, window=window, kv_len=kv_len)
    want = _jax_grads(q, k, v, do, **mask)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    out = flash_attention(qt, kt, vt, **mask)
    lse = attention_lse_ref(qt, kt, **mask)
    got = flash_attention_backward(qt, kt, vt, out, lse, dot, **mask)
    _assert_close(got, want)
    _assert_close(attention_backward_ref(qt, kt, vt, out, lse, dot, **mask), want)


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window,kv_len", MLA_CASES)
def test_mla_dims_autograd_and_formulas_match_jax_grad(b, s, t, h, kv, d, causal, window,
                                                       kv_len):
    """At a v head dim unlike q's and k's: autograd through the plain
    version and the backward kernel's formulas (dv at v's dim) both give
    ``jax.grad`` through the reference model's attention."""
    q, k, v, do = _inputs(b, s, t, h, kv, d, seed=3)
    mask = dict(causal=causal, window=window, kv_len=kv_len)
    want = _jax_grads(q, k, v, do, attention=_jax_mla_attention, jit=True, **mask)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attention(qt, kt, vt, **mask)
    out.backward(torch.from_numpy(do))
    _assert_close((qt.grad, kt.grad, vt.grad), want)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    lse = attention_lse_ref(qt, kt, **mask)
    got = flash_attention_backward(qt, kt, vt, out.detach(), lse, dot, **mask)
    assert got[2].shape == (b, t, kv, d[1])
    _assert_close(got, want)


def test_lse_matches_logsumexp_and_dead_rows_are_minus_inf():
    b, s, t, h, kv, d = 1, 20, 20, 4, 2, 64
    q, k, _, _ = _inputs(b, s, t, h, kv, d, seed=2)
    scale = 1.0 / np.sqrt(d)
    kr = np.repeat(k, h // kv, axis=2)
    scores = np.einsum("bshd,bthd->bhst", q.astype(np.float64) * scale, kr)
    scores = np.where(np.tril(np.ones((s, t), bool)), scores, -np.inf)
    want = np.asarray(jax.nn.logsumexp(jnp.asarray(scores), axis=-1))
    got = attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # kv_len 0 leaves every row without a valid key: lse -inf, zero gradients.
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    dead = attention_lse_ref(qt, kt, causal=False, kv_len=0)
    assert torch.isneginf(dead).all()
    out = flash_attention(qt, kt, kt, causal=False, kv_len=0)
    grads = flash_attention_backward(qt, kt, kt, out, dead, torch.ones_like(qt),
                                     causal=False, kv_len=0)
    assert all(torch.equal(g, torch.zeros_like(g)) for g in grads)


def test_backward_entry_args_block_matches_the_c_struct():
    """ops.py packs the backward entry's arguments into one block; its size
    is the one the source's static_assert holds ``BwdEntryArgs`` to."""
    match = re.search(r"static_assert\(sizeof\(BwdEntryArgs\) == (\d+)", ops.SOURCE.read_text())
    assert match and ops._BWD_ARGS.size == int(match.group(1))
