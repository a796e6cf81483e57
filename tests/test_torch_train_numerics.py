"""The port's training numerics vs the JAX package, float32 on the CPU.

``guard_weights``, ``local_estimates``, ``global_norm``, ``sgd`` and
``adamw`` within 1e-6 (float32 sums in another order), and the guard's
all-valid branch bitwise (it must return the weight vector itself);
``weighted_cross_entropy``, ``ModelApi.loss`` and its gradient on
bridged reduced olmo-1b within 1e-5.  Optimizer states cross from the
reference through numpy (``bridge.state_dict_from_tree``), so both
packages continue from one state.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_api as jax_get_api  # noqa: E402
from repro.core.aggregation import guard_weights as jax_guard  # noqa: E402
from repro.core.gns import local_estimates as jax_local_estimates  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.configs import get_api  # noqa: E402
from repro_torch.core.aggregation import guard_weights  # noqa: E402
from repro_torch.core.gns import local_estimates  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.optim import optimizers as popt  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

TOL = 1e-6
LOSS_TOL = 1e-5

GUARD_CASES = {
    "all valid": [1.0, 2.0, 3.0, 4.0],
    "one NaN": [1.0, float("nan"), 3.0, 4.0],
    "one inf": [1.0, 2.0, float("inf"), 4.0],
    "one outlier": [1.0, 2.0, 3.0, 1e6],
    # median 2.5 (mean of the middle two): 22000 < 1e4 * 2.5 is valid; the
    # lower middle value (2.0) would put it past the limit.
    "even-count median": [1.0, 2.0, 3.0, 22000.0],
    "all invalid": [float("nan"), float("inf"), float("nan"), float("nan")],
}


@pytest.mark.parametrize("name", list(GUARD_CASES))
def test_guard_weights_matches_reference(name):
    sq = np.asarray(GUARD_CASES[name], np.float32)
    r = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    jw, jv = jax_guard(jnp.asarray(sq), jnp.asarray(r))
    r_t = torch.from_numpy(r)
    pw, pv = guard_weights(torch.from_numpy(sq), r_t)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=TOL, atol=0)
    if name in ("all valid", "even-count median"):
        assert pv.all() and torch.equal(pw, r_t)  # bitwise the weight vector


def test_local_estimates_match_reference():
    rng = np.random.default_rng(0)
    sq = rng.uniform(1.0, 5.0, 6).astype(np.float32)
    b = np.asarray([8, 16, 4, 32, 12, 8], np.float32)
    jg, js = jax_local_estimates(jnp.asarray(sq), jnp.float32(2.0), jnp.asarray(b),
                                 jnp.float32(b.sum()))
    pg_, ps_ = local_estimates(torch.from_numpy(sq), torch.tensor(2.0),
                               torch.from_numpy(b), torch.tensor(float(b.sum())))
    np.testing.assert_allclose(pg_.numpy(), np.asarray(jg), rtol=TOL)
    np.testing.assert_allclose(ps_.numpy(), np.asarray(js), rtol=TOL)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "embed": (rng.standard_normal((16, 8)) * scale).astype(np.float32),
        "w": (rng.standard_normal((8, 4, 3)) * scale).astype(np.float32),
        "bias": (rng.standard_normal((5,)) * scale).astype(np.float32),
    }


def _torch_tree(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def test_global_norm_and_clip_match_reference():
    tree = _tree(0, scale=3.0)
    want = float(jopt.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = popt.global_norm(_torch_tree(tree))
    np.testing.assert_allclose(float(got), want, rtol=TOL)
    jclip, _ = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()}, 1.0)
    pclip, _ = popt.clip_by_global_norm(_torch_tree(tree), 1.0)
    for key in tree:
        np.testing.assert_allclose(pclip[key].numpy(), np.asarray(jclip[key]), rtol=TOL,
                                   atol=TOL)


OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(m.constant_schedule(0.05), weight_decay=0.01), "SGDState"),
    "adamw": (lambda m: m.adamw(m.cosine_schedule(0.01, 2, 10)), "AdamWState"),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_reference(name):
    """One reference update first (non-zero moments), its state carried
    over through numpy, then three updates in both packages with lr_scale
    1.7 and a clipped gradient."""
    make, state_cls = OPTIMIZERS[name]
    jo, po = make(jopt), make(popt)
    jparams = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    jstate = jo.init(jparams)
    jparams, jstate = jo.update({k: jnp.asarray(v) for k, v in _tree(1).items()}, jstate,
                                jparams, jnp.float32(1.0))
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    pstate = getattr(popt, state_cls)(*(
        state_dict_from_tree(field) if isinstance(field, dict) else int(field)
        for field in np_state))
    pparams = {k: torch.tensor(np.asarray(v)) for k, v in jparams.items()}
    for step in range(3):
        grads = _tree(10 + step, scale=0.5 + step)
        jparams, jstate = jo.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                    jparams, jnp.float32(1.7))
        pparams, pstate = po.update(_torch_tree(grads), pstate, pparams, 1.7)
    assert pstate.step == int(jstate.step)
    for key in pparams:
        np.testing.assert_allclose(pparams[key].numpy(), np.asarray(jparams[key]), rtol=TOL,
                                   atol=TOL)
    for field in range(len(pstate) - 1):
        for key in pparams:
            np.testing.assert_allclose(pstate[field][key].numpy(),
                                       np.asarray(jstate[field][key]), rtol=TOL, atol=TOL)


def test_weighted_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 6, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (4, 6)).astype(np.int32)
    weights = np.broadcast_to(np.asarray([1, 0.5, 0, 2], np.float32)[:, None], (4, 6))
    for w in (None, weights):
        jl, jw = jax_common.weighted_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels), None if w is None else jnp.asarray(w))
        pl, pw = common.weighted_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if w is None else torch.from_numpy(np.ascontiguousarray(w)))
        np.testing.assert_allclose(float(pl), float(jl), rtol=LOSS_TOL)
        assert float(pw) == float(jw)


@pytest.fixture(scope="module")
def olmo_pair():
    jax_api = jax_get_api("olmo-1b", reduced=True)
    api = get_api("olmo-1b", reduced=True)
    params = jax_api.init(jax.random.PRNGKey(0))
    model = api.load(state_dict_from_tree(jax.tree_util.tree_map(np.asarray, params)),
                     device="cpu").requires_grad_(True)
    return jax_api, params, api, model


def _batch(vocab, b=3, s=12, seed=5):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "weights": np.asarray([1.0, 1.0, 0.0], np.float32)[:b]}


@pytest.mark.parametrize("weighted", [True, False])
def test_model_loss_and_gradient_match_reference(olmo_pair, weighted):
    """``ModelApi.loss`` and one node's gradient of it (the per-node step
    of ``RealBackend``) from bridged weights; pads weigh 0."""
    jax_api, params, api, model = olmo_pair
    batch = _batch(api.cfg.vocab)
    if not weighted:
        batch.pop("weights")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jax_api.loss(p, jbatch)[0])(params)
    ploss, _ = api.loss(model, batch)
    names = [n for n, _ in model.named_parameters()]
    pgrads = dict(zip(names, torch.autograd.grad(ploss, list(model.parameters()))))
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=LOSS_TOL)
    want = state_dict_from_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, g in pgrads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=LOSS_TOL, rtol=0,
                                   err_msg=name)


def test_remat_gives_the_same_gradient(olmo_pair):
    """``cfg.remat`` (``torch.utils.checkpoint`` per layer) recomputes the
    layers in the backward pass and changes nothing in the result."""
    _, _, api, model = olmo_pair
    batch = _batch(api.cfg.vocab)
    grads = {}
    for remat in (False, True):
        model.cfg = dataclasses.replace(api.cfg, remat=remat)
        loss, _ = api.loss(model, batch)
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
    model.cfg = api.cfg
    for g0, g1 in zip(grads[False], grads[True]):
        assert torch.equal(g0, g1)
