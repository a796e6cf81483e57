"""Port dense model vs the JAX package, from identical weights.

Weights come from the JAX ``api.init(PRNGKey(0))``, go to numpy and cross
through :mod:`repro_torch.bridge`.  Reduced olmo-1b is float32 in both
packages; reduced llama3-8b is bfloat16 there, so the test builds float32
variants of it on both sides.  Tolerances: logits atol 1e-4 and cache K/V
atol 1e-5 (float32 through two layers with sums in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_api as jax_get_api  # noqa: E402
from repro.models.registry import build_api as jax_build_api  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.configs import get_api  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models.registry import build_api  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5
ARCHS = ["olmo-1b", "llama3-8b"]


def _f32_pair(arch, **overrides):
    """(jax api, port api) for the reduced arch in float32."""
    jax_api = jax_get_api(arch, reduced=True)
    port_api = get_api(arch, reduced=True)
    jcfg = dataclasses.replace(
        jax_api.cfg, param_dtype=jnp.float32, compute_dtype=jnp.float32, **overrides
    )
    pcfg = dataclasses.replace(
        port_api.cfg, param_dtype=torch.float32, compute_dtype=torch.float32, **overrides
    )
    return jax_build_api(arch, jcfg), build_api(arch, pcfg)


def _bridged(arch, **overrides):
    jax_api, port_api = _f32_pair(arch, **overrides)
    params = jax_api.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = port_api.load(state_dict_from_tree(tree), device="cpu")
    return jax_api, params, port_api, model


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    torch.backends.cuda.matmul.allow_tf32 = False
    return _bridged(request.param)


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


def test_bridge_fills_every_parameter(pair):
    jax_api, params, port_api, model = pair
    tree = jax.tree_util.tree_map(np.asarray, params)
    sd = state_dict_from_tree(tree)
    assert set(sd) == set(model.state_dict())
    wq = np.asarray(params["layers"]["attn"]["wq"])
    np.testing.assert_array_equal(model.layers[1].attn["wq"].numpy(), wq[1])
    assert port_api.param_count() == jax_api.param_count()


def test_bridge_keeps_bfloat16_exactly():
    """Reduced llama3-8b is bfloat16 in the JAX package: its leaves cross
    the bridge bit for bit."""
    jax_api = jax_get_api("llama3-8b", reduced=True)
    params = jax_api.init(jax.random.PRNGKey(0))
    sd = state_dict_from_tree(jax.tree_util.tree_map(np.asarray, params))
    want = np.asarray(params["layers"]["mlp"]["w_up"][1]).astype(np.float32)
    got = sd["layers.1.mlp.w_up"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    model = get_api("llama3-8b", reduced=True).load(sd, device="cpu")
    assert model.layers[1].mlp["w_up"].dtype == torch.bfloat16


def test_forward_logits_match(pair):
    jax_api, params, port_api, model = pair
    toks = _tokens(2, 24, jax_api.cfg.vocab)
    want = np.asarray(jax_api.logits(params, {"tokens": jnp.asarray(toks)}))
    got = port_api.logits(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_prefill_and_decode_match(pair):
    """Fused prefill logits and cache K/V, then decode_step continued from
    that cache for several positions."""
    jax_api, params, port_api, model = pair
    b, s, t, steps = 2, 12, 32, 4
    toks = _tokens(b, s + steps, jax_api.cfg.vocab, seed=2)
    jl, jcache = jax_api.prefill(params, jax_api.init_cache(b, t), jnp.asarray(toks[:, :s]))
    pl, pcache = port_api.prefill(
        model, port_api.init_cache(b, t, device="cpu"), torch.from_numpy(toks[:, :s])
    )
    assert pcache["pos"] == int(jcache["pos"]) == s
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            pcache[name].numpy(), np.asarray(jcache[name]), atol=KV_ATOL, rtol=0
        )
    for p in range(s, s + steps):
        jl, jcache = jax_api.decode_step(
            params, jcache, jnp.asarray(toks[:, p : p + 1]), jnp.int32(p)
        )
        pl, pcache = port_api.decode_step(model, pcache, torch.from_numpy(toks[:, p : p + 1]), p)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    assert pcache["pos"] == s + steps
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]), atol=KV_ATOL, rtol=0)


def test_fused_prefill_matches_own_stepped_loop(pair):
    """Mirrors the reference's fused-vs-stepped check in test_serving.py."""
    _, _, port_api, model = pair
    b, s, t = 2, 12, 32
    toks = torch.from_numpy(_tokens(b, s, port_api.cfg.vocab, seed=3))
    flash_attention.launches = 0
    fused_logits, fused = port_api.prefill(model, port_api.init_cache(b, t, device="cpu"), toks)
    assert flash_attention.launches == 0  # CPU tensors take the plain version
    stepped = port_api.init_cache(b, t, device="cpu")
    rows = []
    for p in range(s):
        lg, stepped = port_api.decode_step(model, stepped, toks[:, p : p + 1], p)
        rows.append(lg)
    assert fused["pos"] == stepped["pos"] == s
    np.testing.assert_allclose(
        fused_logits.numpy(), torch.cat(rows, dim=1).numpy(), atol=2e-4, rtol=0
    )
    np.testing.assert_allclose(
        fused["k"][:, :, :s].numpy(), stepped["k"][:, :, :s].numpy(), atol=2e-5, rtol=0
    )
    n1, _ = port_api.decode_step(model, fused, toks[:, :1], s)
    n2, _ = port_api.decode_step(model, stepped, toks[:, :1], s)
    np.testing.assert_allclose(n1.numpy(), n2.numpy(), atol=2e-4, rtol=0)


def test_prefill_rejects_undersized_cache(pair):
    _, _, port_api, model = pair
    toks = torch.zeros((1, 16), dtype=torch.long)
    with pytest.raises(ValueError):
        port_api.prefill(model, port_api.init_cache(1, 8, device="cpu"), toks)


def test_ring_cache_decode_matches():
    """The ring-cache branch: a cache of decode_window entries, stepped past
    its length so writes wrap."""
    over = dict(decode_window=8, max_full_cache=16)
    jax_api, params, port_api, model = _bridged("olmo-1b", **over)
    seq = 24
    jcache = jax_api.init_cache(1, seq)
    pcache = port_api.init_cache(1, seq, device="cpu")
    assert pcache["k"].shape[2] == jcache["k"].shape[2] == 8
    toks = _tokens(1, 14, jax_api.cfg.vocab, seed=4)
    for p in range(toks.shape[1]):
        jl, jcache = jax_api.decode_step(
            params, jcache, jnp.asarray(toks[:, p : p + 1]), jnp.int32(p)
        )
        pl, pcache = port_api.decode_step(model, pcache, torch.from_numpy(toks[:, p : p + 1]), p)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(pcache["v"].numpy(), np.asarray(jcache["v"]), atol=KV_ATOL, rtol=0)
    with pytest.raises(ValueError):
        port_api.prefill(model, port_api.init_cache(1, seq, device="cpu"), torch.zeros((1, 12), dtype=torch.long))


@pytest.mark.parametrize(
    "variant",
    [
        {"qk_norm": True},
        {"act": "relu2"},
        {"act": "gelu"},
        {"tie_embeddings": True},
        {"window": 5},
    ],
    ids=lambda v: "-".join(f"{k}={v[k]}" for k in v),
)
def test_config_branches_match(variant):
    """The DenseConfig branches the two ported archs leave unused (QK-norm,
    non-SwiGLU MLPs, tied embeddings, sliding-window attention), on reduced
    olmo-1b: forward, fused prefill and decode against the JAX package."""
    jax_api, params, port_api, model = _bridged("olmo-1b", **variant)
    b, s, t = 1, 14, 24
    toks = _tokens(b, s + 2, jax_api.cfg.vocab, seed=5)
    want = np.asarray(jax_api.logits(params, {"tokens": jnp.asarray(toks)}))
    got = port_api.logits(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)
    jl, jcache = jax_api.prefill(params, jax_api.init_cache(b, t), jnp.asarray(toks[:, :s]))
    pl, pcache = port_api.prefill(
        model, port_api.init_cache(b, t, device="cpu"), torch.from_numpy(toks[:, :s])
    )
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    for p in range(s, s + 2):
        jl, jcache = jax_api.decode_step(
            params, jcache, jnp.asarray(toks[:, p : p + 1]), jnp.int32(p)
        )
        pl, pcache = port_api.decode_step(model, pcache, torch.from_numpy(toks[:, p : p + 1]), p)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]), atol=KV_ATOL, rtol=0)


def test_prefill_cache_stepped_branch_matches_fused(pair):
    """``prefill_cache`` steps the decode loop for a family without fused
    prefill; both branches leave the same last logits and cache."""
    from repro_torch.serving import prefill_cache

    _, _, port_api, model = pair

    class SteppedOnly:
        def __init__(self, api):
            self.api = api

        def supports_prefill(self):
            return False

        def decode_step(self, *args):
            return self.api.decode_step(*args)

    toks = torch.from_numpy(_tokens(1, 10, port_api.cfg.vocab, seed=6))
    fused_last, fused = prefill_cache(
        port_api, model, port_api.init_cache(1, 16, device="cpu"), toks
    )
    stepped_last, stepped = prefill_cache(
        SteppedOnly(port_api), model, port_api.init_cache(1, 16, device="cpu"), toks
    )
    assert fused_last.shape == stepped_last.shape == (1, 1, port_api.cfg.vocab)
    assert fused["pos"] == stepped["pos"] == 10
    np.testing.assert_allclose(fused_last.numpy(), stepped_last.numpy(), atol=2e-4, rtol=0)
    np.testing.assert_allclose(fused["v"].numpy(), stepped["v"].numpy(), atol=2e-5, rtol=0)
