"""Port rwkv6 model vs the JAX package, from identical weights.

Reduced rwkv6-7b is bfloat16 in both packages, so the tests build float32
variants of it on both sides.  Weights come from the JAX init, whose
zero-initialised leaves (token-shift mixes ``mu_*``, decay base ``w0``,
bonus ``u``) are replaced with seeded numpy values so that the token shift,
the decay offset and the bonus term all carry weight; they go to both
packages through numpy and :mod:`repro_torch.bridge`.  Tolerances: logits
atol 1e-4, WKV state and shift registers atol 1e-5 (float32 through two
layers with sums in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import serving as jax_serving  # noqa: E402
from repro.configs import get_api as jax_get_api  # noqa: E402
from repro.models.registry import build_api as jax_build_api  # noqa: E402
from repro.runtime.events import NodeLeave as JaxNodeLeave  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.configs import get_api  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import wkv  # noqa: E402
from repro_torch.models.registry import build_api  # noqa: E402
from repro_torch.runtime.events import NodeLeave  # noqa: E402
from repro_torch.serving import prefill_cache  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

ARCH = "rwkv6-7b"
LOGIT_ATOL = 1e-4
STATE_ATOL = 1e-5
CACHE_KEYS = ("wkv", "time_shift", "chan_shift")


def _f32_pair(**overrides):
    jax_api = jax_get_api(ARCH, reduced=True)
    port_api = get_api(ARCH, reduced=True)
    jcfg = dataclasses.replace(
        jax_api.cfg, param_dtype=jnp.float32, compute_dtype=jnp.float32, **overrides
    )
    pcfg = dataclasses.replace(port_api.cfg, param_dtype=torch.float32, compute_dtype=torch.float32)
    return jax_build_api(ARCH, jcfg), build_api(ARCH, pcfg)


def _seeded_tree(jax_api):
    """The JAX init as numpy, with the zero-initialised leaves seeded."""
    tree = jax.tree_util.tree_map(np.asarray, jax_api.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    layers = tree["layers"]
    for group, names in (("time", ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g")),
                         ("chan", ("mu_ck", "mu_cr"))):
        for name in names:
            layers[group][name] = rng.uniform(0, 1, layers[group][name].shape).astype(np.float32)
    for name, scale in (("w0", 0.5), ("u", 0.5)):
        leaf = layers["time"][name]
        layers["time"][name] = (rng.standard_normal(leaf.shape) * scale).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def pair():
    jax_api, port_api = _f32_pair()
    tree = _seeded_tree(jax_api)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = port_api.load(state_dict_from_tree(tree), device="cpu")
    return jax_api, params, port_api, model, tree


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


@pytest.fixture(autouse=True)
def _count_from_zero():
    wkv.launches = 0
    yield
    wkv.launches = 0


def test_bridge_loads_strictly(pair):
    jax_api, _, port_api, model, tree = pair
    sd = state_dict_from_tree(tree)
    assert set(sd) == set(model.state_dict())
    assert len(sd) == 3 + port_api.cfg.n_layers * (15 + 5 + 2)  # embed, final_norm, lm_head
    np.testing.assert_array_equal(model.layers[1].time["w_r"].numpy(), tree["layers"]["time"]["w_r"][1])
    np.testing.assert_array_equal(model.layers[0].chan["mu_ck"].numpy(), tree["layers"]["chan"]["mu_ck"][0])
    assert port_api.param_count() == jax_api.param_count()
    del sd["layers.1.time.u"]
    with pytest.raises(RuntimeError):
        port_api.load(sd, device="cpu")


def test_full_width_schema_matches_reference():
    """rwkv6-7b at full width: same leaves and parameter count (~7.5e9),
    counted from the schema without allocating."""
    jax_api, port_api = jax_get_api(ARCH), get_api(ARCH)
    assert port_api.param_count() == jax_api.param_count()
    assert 6e9 < port_api.param_count() < 9e9
    assert port_api.cfg.n_heads == 64 and port_api.cfg.wkv_chunk == 32
    assert port_api.family == "ssm" and not port_api.supports_prefill()


@pytest.mark.parametrize("use_kernel", [False, True], ids=["jnp-chunked", "pallas-interpret"])
def test_forward_logits_match(pair, use_kernel):
    _, params, port_api, model, _ = pair
    jax_api, _ = _f32_pair(use_kernel=use_kernel)
    toks = _tokens(2, 40, jax_api.cfg.vocab)
    want = np.asarray(jax_api.logits(params, {"tokens": jnp.asarray(toks)}))
    got = port_api.logits(model, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)
    assert wkv.launches == 0  # CPU tensors take the plain version


def test_decode_loop_matches(pair):
    """decode_step from an empty state, logits at every position and the
    final WKV state and shift registers."""
    jax_api, params, port_api, model, _ = pair
    b, steps = 2, 20
    toks = _tokens(b, steps, jax_api.cfg.vocab, seed=2)
    jcache = jax_api.init_cache(b, 32)
    pcache = port_api.init_cache(b, 32, device="cpu")
    for name in CACHE_KEYS:
        assert tuple(pcache[name].shape) == jcache[name].shape
    for p in range(steps):
        jl, jcache = jax_api.decode_step(params, jcache, jnp.asarray(toks[:, p : p + 1]), jnp.int32(p))
        pl, pcache = port_api.decode_step(model, pcache, torch.from_numpy(toks[:, p : p + 1]), p)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    assert pcache["pos"] == int(jcache["pos"]) == steps
    for name in CACHE_KEYS:
        np.testing.assert_allclose(
            pcache[name].numpy(), np.asarray(jcache[name]), atol=STATE_ATOL, rtol=0
        )


def test_forward_matches_own_stepped_loop(pair):
    """The chunked full-sequence forward and the step-by-step decode loop
    give the same logits; ``prefill_cache`` takes the stepped branch."""
    _, _, port_api, model, _ = pair
    b, s = 2, 37
    toks = torch.from_numpy(_tokens(b, s, port_api.cfg.vocab, seed=3))
    full = port_api.logits(model, {"tokens": toks})
    cache = port_api.init_cache(b, s, device="cpu")
    rows = []
    for p in range(s):
        lg, cache = port_api.decode_step(model, cache, toks[:, p : p + 1], p)
        rows.append(lg)
    np.testing.assert_allclose(full.numpy(), torch.cat(rows, dim=1).numpy(), atol=LOGIT_ATOL, rtol=0)
    last, stepped = prefill_cache(port_api, model, port_api.init_cache(b, s, device="cpu"), toks)
    assert stepped["pos"] == s and last.shape == (b, 1, port_api.cfg.vocab)
    np.testing.assert_array_equal(last.numpy(), rows[-1].numpy())
    np.testing.assert_array_equal(stepped["wkv"].numpy(), cache["wkv"].numpy())


def test_no_fused_prefill(pair):
    _, _, port_api, model, _ = pair
    assert not port_api.supports_prefill()
    with pytest.raises(NotImplementedError):
        port_api.prefill(model, port_api.init_cache(1, 8, device="cpu"), torch.zeros((1, 4)))


def test_seeded_init_is_deterministic():
    api = get_api(ARCH, reduced=True)
    a, b, c = api.init(0, device="cpu"), api.init(0, device="cpu"), api.init(1, device="cpu")
    assert a.layers[1].time["w_k"].dtype == torch.bfloat16
    assert torch.equal(a.layers[1].time["w_k"], b.layers[1].time["w_k"])
    assert not torch.equal(a.layers[1].time["w_k"], c.layers[1].time["w_k"])
    assert not a.layers[0].time["u"].any() and a.layers[0].time["ln_x"].eq(1).all()


def _recording(base):
    class Recording(base):
        """Keeps each request's final token stream at completion."""

        streams = None

        def release(self, ar):
            if self.streams is None:
                self.streams = {}
            self.streams[ar.rid] = list(ar.tokens)
            super().release(ar)

    return Recording


def test_real_engine_streams_match_reference_under_churn(pair):
    """Reduced rwkv6 (float32) under both serving stacks: prompts step the
    decode loop, a node leaves mid-run, and every request's token stream
    equals the JAX engine's."""
    jax_api, params, port_api, model, _ = pair

    def run(pkg, engine, leave):
        wl = pkg.generate_requests(
            8, seed=5, rate=50.0, prompt_min=8, prompt_max=8,
            gen_min=2, gen_max=6, gen_mean=4, token_budget=10.0,
        )
        coeffs = {0: (0.01, 0.01), 1: (0.01, 0.01)}
        rt = pkg.ServingRuntime(
            engine, pkg.ServingAllocator(dict(coeffs), total_slots=4), wl,
            nodes=[0, 1], config=pkg.ServingConfig(total_slots=4),
        )
        rt.post(leave(time=wl.requests[2].arrival, nodes=(1,)))
        return wl, rt.run(), engine.streams

    jax_engine = _recording(jax_serving.RealServingEngine)(jax_api, params, max_len=32)
    port_engine = _recording(serving.RealServingEngine)(port_api, model, max_len=32, device="cpu")
    wl, want_rep, want = run(jax_serving, jax_engine, JaxNodeLeave)
    _, rep, got = run(serving, port_engine, NodeLeave)
    assert rep.summary["dropped"] == 0 and want_rep.summary["dropped"] == 0
    assert rep.summary["completed"] == 8
    assert rep.counters["leaves"] == 1
    for req in wl:
        assert len(got[req.rid]) == req.gen_len
        assert all(0 <= t < port_api.cfg.vocab for t in got[req.rid])
    assert got == want
    assert wkv.launches == 0  # serving steps the decode loop
