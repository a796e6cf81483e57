"""The port's Mixtral vs the JAX package's, from identical weights.

Reduced mixtral-8x7b (2 layers, 4 experts top-2, window 32) in float32
variants on both sides (the reduced config is bfloat16), weights drawn
with numpy at the reference's init scales in the reference's tree
(``tests/_torch_numpy_init.py``) crossing through :mod:`repro_torch.bridge`,
TF32 off, one CPU thread.
The reference's full-sequence forward runs op by op (``jax.disable_jit``),
so its stats round as the port's do: a compiled layer body fuses ``1 -
mean(keep)`` into one multiply-add and moves ``drop_frac`` by an ulp.

* forward logits within 1e-4; ``lb_loss`` and ``z_loss`` within 1e-6
  relative, ``drop_frac`` ``==``: at the reduced config's dropless
  ``capacity_factor`` 8.0 and at the published 1.25, where tokens drop;
* the stepped decode past the window (the cache a ring of 32): logits
  within 1e-4 at every step, cache K/V within 1e-5;
* ``ModelApi.loss`` with per-sample weights, aux terms included, within
  1e-5 relative, and its gradient against ``jax.grad`` of the
  reference's loss, every leaf within 1e-4 x max(1, max |g|), with and
  without remat;
* ``param_count`` and ``active_param_count`` ``==`` at the reduced and
  the published configs; the bridge round trip, strict.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_api as jax_get_api  # noqa: E402
from repro.models.registry import build_api as jax_build_api  # noqa: E402
from _torch_numpy_init import numpy_params  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.configs import get_api  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.registry import build_api  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

ARCH = "mixtral-8x7b"
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5
STAT_RTOL = 1e-6
LOSS_REL = 1e-5
GRAD_REL = 1e-4  # x max(1, max |g|), per leaf
B, S = 2, 40     # S past the reduced window of 32
DECODE_STEPS = 40


def _f32_pair(**overrides):
    jax_api = jax_get_api(ARCH, reduced=True)
    port_api = get_api(ARCH, reduced=True)
    jcfg = dataclasses.replace(
        jax_api.cfg, param_dtype=jnp.float32, compute_dtype=jnp.float32, **overrides)
    pcfg = dataclasses.replace(
        port_api.cfg, param_dtype=torch.float32, compute_dtype=torch.float32, **overrides)
    return jax_build_api(ARCH, jcfg), build_api(ARCH, pcfg)


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


@pytest.fixture(scope="module", autouse=True)
def _cpu_settings():
    """TF32 off, and one CPU thread for the module: the small ops run
    faster on one thread than on threads contending with the suite's
    other workers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    tree = numpy_params(_f32_pair()[0], seed=0)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def _models(weights, **overrides):
    params, tree = weights
    jax_api, api = _f32_pair(**overrides)
    return jax_api, params, api, api.load(state_dict_from_tree(tree), device="cpu")


@pytest.fixture(scope="module")
def forwards(weights):
    """The reference's forward (logits, stats), op by op, at each
    capacity factor (computed once)."""
    out = {}
    toks = _tokens(B, S, 512)
    for cf in (8.0, 1.25):
        jax_api, params, _, _ = _models(weights, capacity_factor=cf)
        with jax.disable_jit():
            logits, stats = jax_api._module.forward(params, jax_api.cfg, jnp.asarray(toks))
        out[cf] = (np.asarray(logits), {k: float(v) for k, v in stats.items()})
    return toks, out


@pytest.mark.parametrize("cf", [8.0, 1.25], ids=["dropless", "published-capacity"])
def test_forward_matches_reference(weights, forwards, cf):
    toks, out = forwards
    want, want_stats = out[cf]
    _, _, api, model = _models(weights, capacity_factor=cf)
    logits, stats = model(torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), want, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(api.logits(model, {"tokens": toks}).numpy(), logits.numpy(),
                               atol=0, rtol=0)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(stats[key]), want_stats[key], rtol=STAT_RTOL,
                                   err_msg=key)
    assert float(stats["drop_frac"]) == want_stats["drop_frac"]
    assert (want_stats["drop_frac"] > 0) == (cf == 1.25)


def test_stepped_decode_past_the_window_matches_reference(weights):
    """A cache of ``decode_window`` entries (a ring) stepped past its
    length, so writes wrap and decode attends with no window mask."""
    jax_api, params, api, model = _models(weights)
    seq = DECODE_STEPS + 8
    jcache = jax_api.init_cache(1, seq)
    pcache = api.init_cache(1, seq, device="cpu")
    assert pcache["k"].shape == jcache["k"].shape
    assert pcache["k"].shape[2] == api.cfg.decode_window == 32
    toks = _tokens(1, DECODE_STEPS, api.cfg.vocab, seed=4)
    step = jax.jit(jax_api.decode_step)
    for p in range(DECODE_STEPS):
        jl, jcache = step(params, jcache, jnp.asarray(toks[:, p:p + 1]), jnp.int32(p))
        pl, pcache = api.decode_step(model, pcache, torch.from_numpy(toks[:, p:p + 1]), p)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {p}")
    assert pcache["pos"] == DECODE_STEPS
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]), atol=KV_ATOL, rtol=0)
    np.testing.assert_allclose(pcache["v"].numpy(), np.asarray(jcache["v"]), atol=KV_ATOL, rtol=0)


def test_short_cache_holds_the_context_and_no_prefill(weights):
    """``seq_len`` under the decode window: a full cache of ``seq_len``
    entries (the reference's rule); like the reference, no fused prefill."""
    jax_api, _, api, model = _models(weights)
    assert api.init_cache(2, 20, device="cpu")["k"].shape == jax_api.init_cache(2, 20)["k"].shape
    assert not api.supports_prefill() and not jax_api.supports_prefill()
    with pytest.raises(NotImplementedError):
        api.prefill(model, api.init_cache(1, 8, device="cpu"),
                    torch.zeros((1, 4), dtype=torch.long))


@pytest.fixture(scope="module")
def loss_case(weights):
    """The reference's loss, aux and gradient (computed once)."""
    jax_api, params, _, _ = _models(weights)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 512, (3, 24)).astype(np.int32),
             "labels": rng.integers(0, 512, (3, 24)).astype(np.int32),
             "weights": np.asarray([1.0, 0.5, 0.0], np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_api.loss(p, jbatch), has_aux=True))(params)
    want = state_dict_from_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    return batch, float(jloss), {k: float(v) for k, v in jaux.items()}, want


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_gradient_match_reference(weights, loss_case, remat):
    batch, jloss, jaux, want = loss_case
    _, _, api, model = _models(weights, remat=remat)
    model.requires_grad_(True)
    loss, aux = api.loss(model, batch)
    assert set(aux) == set(jaux) == {"lb_loss", "z_loss", "drop_frac", "ce_loss"}
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=LOSS_REL)
    np.testing.assert_allclose(float(aux["ce_loss"].detach()), jaux["ce_loss"], rtol=LOSS_REL)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[key].detach()), jaux[key], rtol=LOSS_REL,
                                   err_msg=key)
    # The aux terms enter with the reference's weights.
    assert float(aux["lb_loss"].detach()) > 0 and float(aux["z_loss"].detach()) > 0
    assert (registry.MOE_LB_WEIGHT, registry.MOE_Z_WEIGHT) == (0.01, 1e-3)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    assert set(names) == set(want)
    for name in names:
        w = want[name].numpy()
        tol = GRAD_REL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(grads[name].numpy(), w, atol=tol, rtol=0, err_msg=name)


def test_attend_seam_takes_the_plain_attention(weights, loss_case):
    """``train_forward(attend=...)`` replaces the flash call (the seam the
    card's gradient check uses) and gives the same logits and stats."""
    batch = loss_case[0]
    _, _, api, model = _models(weights)

    def plain(q, k, v):
        return attention_ref(q, k, v, causal=True, window=api.cfg.window)

    with torch.no_grad():
        default, dstats = model.train_forward(batch["tokens"])
        seam, sstats = model.train_forward(batch["tokens"], attend=plain)
    assert torch.equal(default, seam)
    assert all(torch.equal(dstats[k], sstats[k]) for k in dstats)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "published"])
def test_param_counts_match_reference(reduced):
    jax_api, api = jax_get_api(ARCH, reduced=reduced), get_api(ARCH, reduced=reduced)
    assert api.param_count() == jax_api.param_count()
    assert api.active_param_count() == jax_api.active_param_count()
    assert api.active_param_count() < api.param_count()


def test_bridge_round_trip_is_strict(weights):
    _, tree = weights
    _, _, _, model = _models(weights)
    sd = state_dict_from_tree(tree)
    assert set(model.state_dict()) == set(sd)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())
    assert model.layers[0].moe["w_gate"].shape == (4, 128, 256)
    assert "shared" not in model.layers[0].moe
    with pytest.raises(RuntimeError):
        model.load_state_dict({k: v for k, v in sd.items() if k != "layers.1.moe.router"})
