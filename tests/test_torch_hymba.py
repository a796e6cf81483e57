"""Port hymba model vs the JAX package, from identical weights.

Reduced hymba-1.5b is bfloat16 with 2 layers in both packages, so every
layer is global ((0, 1, 1)); the tests build float32 4-layer variants on
both sides, whose global layers are (0, 2, 3), so layer 1 runs the
sliding window (16).  Weights come from the JAX init, whose zero- or
one-initialised leaves (``log_a``, ``dt_bias``, ``conv_b``, ``d_skip`` and
the norm scales) are replaced with seeded numpy values so that each
carries weight; they go to both packages through numpy and
:mod:`repro_torch.bridge`.  Tolerances: logits atol 1e-4, caches atol
1e-5 (float32 through four layers with sums in another order).

The reference's forward and its stepped decode agree only inside the
window: decode attends a ring cache of ``min(window, seq_len)`` entries in
every layer.  The port keeps that, so the forward-vs-stepped check stays
inside the window, while the checks against JAX run past it.
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
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.models.registry import build_api  # noqa: E402
from repro_torch.runtime.events import NodeLeave  # noqa: E402
from repro_torch.serving import prefill_cache  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

ARCH = "hymba-1.5b"
N_LAYERS = 4
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
CACHE_KEYS = ("k", "v", "ssm", "conv")


def _f32_pair(**overrides):
    jax_api = jax_get_api(ARCH, reduced=True)
    port_api = get_api(ARCH, reduced=True)
    jcfg = dataclasses.replace(
        jax_api.cfg, n_layers=N_LAYERS, param_dtype=jnp.float32, compute_dtype=jnp.float32,
        **overrides,
    )
    port_overrides = {k: v for k, v in overrides.items() if k != "use_kernel"}
    pcfg = dataclasses.replace(
        port_api.cfg, n_layers=N_LAYERS, param_dtype=torch.float32,
        compute_dtype=torch.float32, **port_overrides,
    )
    return jax_build_api(ARCH, jcfg), build_api(ARCH, pcfg)


def _seeded_tree(jax_api):
    """The JAX init as numpy, with the zero- and one-initialised leaves seeded."""
    tree = jax.tree_util.tree_map(np.asarray, jax_api.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    layers = tree["layers"]
    ssm = layers["ssm"]
    ssm["log_a"] = (rng.standard_normal(ssm["log_a"].shape) * 0.5).astype(np.float32)
    ssm["dt_bias"] = rng.uniform(-2.0, 0.5, ssm["dt_bias"].shape).astype(np.float32)
    ssm["conv_b"] = (rng.standard_normal(ssm["conv_b"].shape) * 0.2).astype(np.float32)
    ssm["d_skip"] = rng.uniform(0.5, 1.5, ssm["d_skip"].shape).astype(np.float32)
    for name in ("attn_scale", "ssm_scale", "in_norm", "mlp_norm"):
        layers[name] = rng.uniform(0.5, 1.5, layers[name].shape).astype(np.float32)
    tree["final_norm"] = rng.uniform(0.5, 1.5, tree["final_norm"].shape).astype(np.float32)
    return tree


def _pair(**overrides):
    jax_api, port_api = _f32_pair(**overrides)
    tree = _seeded_tree(jax_api)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = port_api.load(state_dict_from_tree(tree), device="cpu")
    return jax_api, params, port_api, model, tree


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


@pytest.fixture(autouse=True)
def _count_from_zero():
    flash_attention.launches = ssm_scan.launches = 0
    yield
    flash_attention.launches = ssm_scan.launches = 0


def test_reduced_variant_runs_windowed_layers(pair):
    _, _, port_api, _, _ = pair
    cfg = port_api.cfg
    assert cfg.global_layers() == (0, 2, 3) and cfg.window == 16
    assert get_api(ARCH, reduced=True).cfg.global_layers() == (0, 1, 1)


def test_bridge_loads_strictly(pair):
    jax_api, _, port_api, model, tree = pair
    sd = state_dict_from_tree(tree)
    assert set(sd) == set(model.state_dict())
    assert len(sd) == 3 + N_LAYERS * (4 + 10 + 3 + 4)  # embed, final_norm, lm_head
    np.testing.assert_array_equal(model.layers[1].ssm["log_a"].numpy(), tree["layers"]["ssm"]["log_a"][1])
    np.testing.assert_array_equal(model.layers[3].attn["wk"].numpy(), tree["layers"]["attn"]["wk"][3])
    np.testing.assert_array_equal(model.layers[2].ssm_scale.numpy(), tree["layers"]["ssm_scale"][2])
    assert port_api.param_count() == jax_api.param_count()
    del sd["layers.2.ssm.d_skip"]
    with pytest.raises(RuntimeError):
        port_api.load(sd, device="cpu")


def test_full_width_schema_matches_reference():
    """hymba-1.5b at full width: same leaves and parameter count,
    1,662,264,000, counted from the schema without allocating."""
    jax_api, port_api = jax_get_api(ARCH), get_api(ARCH)
    assert port_api.param_count() == jax_api.param_count() == 1_662_264_000
    cfg = port_api.cfg
    assert (cfg.inner, cfg.dtr, cfg.head_dim, cfg.ssm_chunk) == (3200, 100, 64, 128)
    assert cfg.global_layers() == (0, 16, 31) and cfg.window == 1024
    assert port_api.family == "hybrid" and not port_api.supports_prefill()


@pytest.mark.parametrize("use_kernel", [False, True], ids=["jnp-chunked", "pallas-interpret"])
def test_forward_logits_match(pair, use_kernel):
    """T = 40, past the window of 16: the windowed layer masks old keys."""
    _, params, port_api, model, _ = pair
    jax_api, _ = _f32_pair(use_kernel=use_kernel)
    toks = _tokens(2, 40, jax_api.cfg.vocab)
    want = np.asarray(jax_api.logits(params, {"tokens": jnp.asarray(toks)}))
    got = port_api.logits(model, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)
    assert flash_attention.launches == ssm_scan.launches == 0  # CPU: plain versions


def test_forward_with_meta_tokens_matches():
    jax_api, params, port_api, model, tree = _pair(n_meta_tokens=2)
    assert tree["meta_tokens"].shape == (2, port_api.cfg.d_model)
    np.testing.assert_array_equal(model.meta_tokens.numpy(), tree["meta_tokens"])
    toks = _tokens(2, 24, jax_api.cfg.vocab, seed=4)
    want = np.asarray(jax_api.logits(params, {"tokens": jnp.asarray(toks)}))
    got = port_api.logits(model, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape == (2, 24, jax_api.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_decode_loop_matches(pair):
    """decode_step from an empty cache over 40 steps, past the ring's wrap
    at 16: logits at every position and every cache leaf."""
    jax_api, params, port_api, model, _ = pair
    b, steps = 2, 40
    toks = _tokens(b, steps, jax_api.cfg.vocab, seed=2)
    jcache = jax_api.init_cache(b, steps)
    pcache = port_api.init_cache(b, steps, device="cpu")
    for name in CACHE_KEYS:
        assert tuple(pcache[name].shape) == jcache[name].shape
    assert pcache["k"].shape[2] == 16
    jax_step = jax.jit(jax_api.decode_step)
    for p in range(steps):
        jl, jcache = jax_step(params, jcache, jnp.asarray(toks[:, p : p + 1]), jnp.int32(p))
        pl, pcache = port_api.decode_step(model, pcache, torch.from_numpy(toks[:, p : p + 1]), p)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    assert pcache["pos"] == int(jcache["pos"]) == steps
    for name in CACHE_KEYS:
        np.testing.assert_allclose(
            pcache[name].numpy(), np.asarray(jcache[name]), atol=CACHE_ATOL, rtol=0
        )


def test_forward_matches_own_stepped_loop(pair):
    """Inside the window the full-sequence forward and the stepped decode
    loop give the same logits; ``prefill_cache`` takes the stepped branch."""
    _, _, port_api, model, _ = pair
    b, s = 2, port_api.cfg.window
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
    for name in CACHE_KEYS:
        np.testing.assert_array_equal(stepped[name].numpy(), cache[name].numpy())


def test_no_fused_prefill(pair):
    _, _, port_api, model, _ = pair
    assert not port_api.supports_prefill()
    with pytest.raises(NotImplementedError):
        port_api.prefill(model, port_api.init_cache(1, 8, device="cpu"), torch.zeros((1, 4)))


def test_seeded_init_is_deterministic():
    api = get_api(ARCH, reduced=True)
    a, b, c = api.init(0, device="cpu"), api.init(0, device="cpu"), api.init(1, device="cpu")
    assert a.layers[1].ssm["w_in"].dtype == torch.bfloat16
    assert torch.equal(a.layers[1].ssm["w_in"], b.layers[1].ssm["w_in"])
    assert torch.equal(a.layers[0].attn["wq"], b.layers[0].attn["wq"])
    assert not torch.equal(a.layers[1].ssm["w_in"], c.layers[1].ssm["w_in"])
    assert not a.layers[0].ssm["log_a"].any() and a.layers[0].ssm["d_skip"].eq(1).all()


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
    """Reduced hymba (float32) under both serving stacks: prompts step the
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
    assert flash_attention.launches == ssm_scan.launches == 0  # serving steps the decode loop
