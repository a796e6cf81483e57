"""The step builders (``repro_torch.train.step``), the ``repro_torch.train``
exports and ``HeteroTrainer``'s surface, against the JAX package.

``build_train_step`` runs bridged reduced olmo-1b (float32) on the CPU on
the batch of ``tests/test_train_substrate.py::
test_microbatch_accumulation_matches_full_batch`` (B=8, S=16, uneven
per-sample weights, SGD at lr 0.5 without momentum or clipping), with
that test's tolerances: losses within 1e-4 relative, parameters within
rtol 2e-2 / atol 3e-3.  The serve and prefill steps are thin wrappers, so
they give ``api.decode_step``'s and ``api.logits``' values exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.train as jax_train  # noqa: E402
import repro_torch.train as port_train  # noqa: E402
from repro.configs import get_api as jax_get_api  # noqa: E402
from repro.core.simulator import SimulatedCluster as JaxCluster  # noqa: E402
from repro.core.simulator import cluster_A as jax_cluster_A  # noqa: E402
from repro.data import SyntheticLM as JaxLM  # noqa: E402
from repro.optim import sgd as jax_sgd, constant_schedule as jax_constant  # noqa: E402
from repro.runtime import make_partition_policy as jax_policy  # noqa: E402
from repro.train.step import build_train_step as jax_build_train_step  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.configs import get_api  # noqa: E402
from repro_torch.core.simulator import SimulatedCluster, cluster_A  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.optim import constant_schedule, sgd  # noqa: E402
from repro_torch.runtime import make_partition_policy  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    build_prefill_step, build_serve_step, build_train_step,
)

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

B, S = 8, 16
WEIGHTS = np.array([1.0, 2.0, 1.0, 0.5, 1.0, 1.0, 3.0, 1.0], np.float32)


@pytest.fixture(scope="module")
def reference():
    """The reference's initial weights and its step's results at
    microbatches 1 and 4."""
    api = jax_get_api("olmo-1b", reduced=True)
    params = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {
        "tokens": rng.integers(0, api.cfg.vocab, (B, S), dtype=np.int32),
        "labels": rng.integers(0, api.cfg.vocab, (B, S), dtype=np.int32),
        "weights": WEIGHTS,
    }
    opt = jax_sgd(jax_constant(0.5), momentum=0.0, max_grad_norm=None)
    out = {}
    for mb in (1, 4):
        step = jax.jit(jax_build_train_step(api, opt, microbatches=mb))
        p, _, m = step(params, opt.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
        out[mb] = (state_dict_from_tree(jax.tree_util.tree_map(np.asarray, p)),
                   {k: float(v) for k, v in m.items()})
    return dict(init=state_dict_from_tree(jax.tree_util.tree_map(np.asarray, params)),
                batch=batch, out=out)


def _model(weights):
    api = get_api("olmo-1b", reduced=True)
    model = api.init(0, device="cpu")
    model.load_state_dict(weights)
    return api, model.requires_grad_(True)


def test_exports_match_reference():
    assert port_train.__all__ == jax_train.__all__
    for name in port_train.__all__:
        assert callable(getattr(port_train, name)), name


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_reference(reference, microbatches):
    api, model = _model(reference["init"])
    opt = sgd(constant_schedule(0.5), momentum=0.0, max_grad_norm=None)
    step = build_train_step(api, opt, microbatches=microbatches)
    state = opt.init(dict(model.named_parameters()))
    batch = {k: torch.from_numpy(v) for k, v in reference["batch"].items()}
    params, state, metrics = step(model, state, batch)
    assert params is model and state.step == 1
    want_params, want = reference["out"][microbatches]
    assert sorted(metrics) == sorted(want) == ["aux/ce_loss", "grad_norm", "loss"]
    for key in ("loss", "grad_norm", "aux/ce_loss"):
        assert float(metrics[key]) == pytest.approx(want[key], rel=1e-4), key
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(),
                                   rtol=2e-2, atol=3e-3)
    # The accumulated step against the port's own unaccumulated one.
    if microbatches > 1:
        _, one = reference["out"][1]
        assert float(metrics["loss"]) == pytest.approx(one["loss"], rel=1e-4)


def test_train_step_options(reference):
    api, model = _model(reference["init"])
    opt = sgd(constant_schedule(0.5), momentum=0.0, max_grad_norm=None)
    batch = {k: torch.from_numpy(v) for k, v in reference["batch"].items() if k != "weights"}
    _, _, metrics = build_train_step(api, opt, with_metrics=False)(
        model, opt.init(dict(model.named_parameters())), batch)
    assert list(metrics) == ["loss"] and torch.isfinite(metrics["loss"])
    with pytest.raises(ValueError, match="not divisible"):
        build_train_step(api, opt, microbatches=3)(
            model, opt.init(dict(model.named_parameters())), batch)
    # microbatch_shardings lays out a DTensor batch's microbatches (the dry
    # run's); plain tensors take no layout, and the step is the same.
    losses = []
    for shardings in (None, {"tokens": None, "labels": None}):
        _, fresh = _model(reference["init"])
        _, _, out = build_train_step(api, opt, microbatches=2, with_metrics=False,
                                     microbatch_shardings=shardings)(
            fresh, opt.init(dict(fresh.named_parameters())), batch)
        losses.append(out["loss"])
    assert torch.equal(losses[0], losses[1])


def test_serve_and_prefill_steps_are_the_api(reference):
    api, model = _model(reference["init"])
    tokens = torch.from_numpy(reference["batch"]["tokens"][:2]).long()
    with torch.no_grad():
        assert torch.equal(build_prefill_step(api)(model, {"tokens": tokens}),
                           api.logits(model, {"tokens": tokens}))
        caches = [api.init_cache(2, S, device="cpu") for _ in range(2)]
        for pos in range(3):
            got, caches[0] = build_serve_step(api)(model, caches[0], tokens[:, pos:pos + 1], pos)
            want, caches[1] = api.decode_step(model, caches[1], tokens[:, pos:pos + 1], pos)
            assert torch.equal(got, want)


def _trainers(policy_name, adaptive):
    """The reference's and the port's HeteroTrainer over cluster_A with one
    baseline partition policy (2 steps per epoch, seq 16)."""
    out = []
    for port in (False, True):
        cl, lm, pol, api, opt, trainer_cls = (
            (cluster_A, SyntheticLM, make_partition_policy, get_api, sgd(constant_schedule(0.3)),
             port_train.HeteroTrainer) if port else
            (jax_cluster_A, JaxLM, jax_policy, jax_get_api, jax_sgd(jax_constant(0.3)),
             jax_train.HeteroTrainer))
        sim_cls = SimulatedCluster if port else JaxCluster
        profiles, comm = cl()
        sim = sim_cls(profiles, comm, noise=0.0, seed=0)
        policy = pol(policy_name, sim.n, candidates=[24, 48], ref_batch=24, adaptive=adaptive)
        api_ = api("olmo-1b", reduced=True)
        kw = {"device": "cpu"} if port else {}
        out.append(trainer_cls(api_, opt, sim, policy, lm(vocab=api_.cfg.vocab, seq_len=16,
                                                          seed=0), steps_per_epoch=2, **kw))
    return out


@pytest.mark.parametrize("policy_name,adaptive", [("even", False), ("lb-bsp", False),
                                                  ("cannikin", True)])
def test_hetero_trainer_fixed_total_surface(policy_name, adaptive):
    ref, port = _trainers(policy_name, adaptive)
    assert port.policy_total_batch() == ref.policy_total_batch()
    for total in (12, 36):
        ref.set_fixed_total(total)
        port.set_fixed_total(total)
        assert port._fixed_total == ref._fixed_total == total
        assert port.loop.fixed_total == ref.loop.fixed_total == total
        assert port.policy_total_batch() == ref.policy_total_batch()


@pytest.fixture
def one_thread():
    """Multi-threaded CPU BLAS differs in the last bits from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_hetero_trainer_params_and_opt_state_setters(reference, one_thread):
    _, port = _trainers("even", False)
    _, other = _trainers("even", False)
    api, model = _model(reference["init"])
    port.params = model
    assert port.params is model and port.backend.params is model
    assert all(a is b for a, b in zip(port.backend.named.values(), model.parameters()))
    state = port.optimizer.init(dict(model.named_parameters()))
    port.opt_state = state
    assert port.opt_state is state and port.backend.opt_state is state
    port.set_fixed_total(24)
    other.backend.params.load_state_dict(reference["init"])
    other.set_fixed_total(24)
    a, b = port.run_epoch(), other.run_epoch()
    assert (a.batches, a.mean_loss) == (b.batches, b.mean_loss)
    for p, q in zip(model.parameters(), other.backend.params.parameters()):
        assert torch.equal(p, q)
