"""The port's DeepSeek-V2 vs the JAX package's, from identical weights.

Reduced deepseek-v2-236b (2 layers: the dense layer 0 and one MoE layer of
4 experts top-2 with a shared expert; MLA at q/k 48, v 32) in float32
variants on both sides (the reduced config is bfloat16), weights drawn with
numpy at the reference's init scales in the reference's tree
(``tests/_torch_numpy_init.py``) crossing through
:mod:`repro_torch.bridge`, TF32 off, one CPU thread.  The reference's
full-sequence forward runs op by op (``jax.disable_jit``), so its stats
round as the port's do.  Tolerances are the Mixtral files' for the same
quantities:

* forward logits within 1e-4; ``lb_loss`` and ``z_loss`` within 1e-6
  relative, ``drop_frac`` ``==``: at the reduced config's dropless
  ``capacity_factor`` 8.0 and at the published 1.25, where routings drop;
* the absorbed decode stepped against the reference's: logits within 1e-4
  at every step, the latent caches ``c`` and ``kr`` within 1e-5;
* the port's forward against its own stepped decode (1e-4);
* ``ModelApi.loss`` with per-sample weights, aux terms included, within
  1e-5 relative, and its gradient against ``jax.grad`` of the reference's
  loss, every leaf within 1e-4 x max(1, max |g|), with and without remat;
* ``param_count`` and ``active_param_count`` ``==`` at the reduced and
  the published configs (schema only); the bridge round trip, strict.
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
from repro_torch.models.registry import build_api  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

ARCH = "deepseek-v2-236b"
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
STAT_RTOL = 1e-6
LOSS_REL = 1e-5
GRAD_REL = 1e-4  # x max(1, max |g|), per leaf
B, S = 2, 40
DECODE_STEPS = 12


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


def test_absorbed_decode_matches_reference(weights):
    """The absorbed decode stepped from an empty latent cache: logits at
    every step and the ``c`` / ``kr`` caches after the last."""
    jax_api, params, api, model = _models(weights)
    seq = DECODE_STEPS + 4
    jcache = jax_api.init_cache(1, seq)
    pcache = api.init_cache(1, seq, device="cpu")
    for key in ("c", "kr"):
        assert pcache[key].shape == jcache[key].shape
    assert pcache["c"].shape[-1] + pcache["kr"].shape[-1] == 32 + 16
    toks = _tokens(1, DECODE_STEPS, api.cfg.vocab, seed=4)
    step = jax.jit(jax_api.decode_step)
    for p in range(DECODE_STEPS):
        jl, jcache = step(params, jcache, jnp.asarray(toks[:, p:p + 1]), jnp.int32(p))
        pl, pcache = api.decode_step(model, pcache, torch.from_numpy(toks[:, p:p + 1]), p)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {p}")
    assert pcache["pos"] == DECODE_STEPS
    for key in ("c", "kr"):
        np.testing.assert_allclose(pcache[key].numpy(), np.asarray(jcache[key]),
                                   atol=CACHE_ATOL, rtol=0, err_msg=key)


def test_forward_matches_its_own_stepped_decode(weights, forwards):
    """The full MLA forward (q/k at 48, v at 32 through the flash entry)
    and the absorbed decode compute one function; no fused prefill."""
    toks = forwards[0]
    _, _, api, model = _models(weights)
    logits, _ = model(torch.from_numpy(toks))
    cache = api.init_cache(B, S, device="cpu")
    rows = []
    for p in range(S):
        lg, cache = api.decode_step(model, cache, torch.from_numpy(toks[:, p:p + 1]), p)
        rows.append(lg)
    np.testing.assert_allclose(torch.cat(rows, dim=1).numpy(), logits.numpy(),
                               atol=LOGIT_ATOL, rtol=0)
    assert not api.supports_prefill()
    with pytest.raises(IndexError):
        api.decode_step(model, cache, torch.from_numpy(toks[:, :1]), S)


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
    for key in ("ce_loss", "lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[key].detach()), jaux[key], rtol=LOSS_REL,
                                   err_msg=key)
    assert float(aux["lb_loss"].detach()) > 0 and float(aux["z_loss"].detach()) > 0
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    assert set(names) == set(want)
    for name in names:
        w = want[name].numpy()
        tol = GRAD_REL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(grads[name].numpy(), w, atol=tol, rtol=0, err_msg=name)


def test_attend_seam_takes_the_plain_attention(weights, loss_case):
    """``train_forward(attend=...)`` replaces the flash call with one that
    takes q, k at ``qk_dim`` and v at ``v_head_dim`` (the seam the card's
    gradient check uses) and gives the same logits and stats."""
    batch = loss_case[0]
    _, _, api, model = _models(weights)
    shapes = []

    def plain(q, k, v):
        shapes.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return attention_ref(q, k, v, causal=True)

    with torch.no_grad():
        default, dstats = model.train_forward(batch["tokens"])
        seam, sstats = model.train_forward(batch["tokens"], attend=plain)
    assert shapes == [(48, 48, 32)] * api.cfg.n_layers
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
    assert model.dense_layer.mlp["w_gate"].shape == (128, 256)
    assert model.layers[0].moe["w_gate"].shape == (4, 128, 64)
    assert model.layers[0].moe["shared"]["w_gate"].shape == (128, 64)
    assert len(model.layers) == 1
    with pytest.raises(RuntimeError):
        model.load_state_dict({k: v for k, v in sd.items() if k != "dense_layer.attn.w_uk"})
