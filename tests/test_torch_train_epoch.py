"""The training slice as a whole: the port's ``HeteroTrainer``/``EpochLoop``
over ``RealBackend`` vs the JAX package's, on the CPU.

Reduced olmo-1b (float32) from the reference's ``PRNGKey(0)`` weights,
bridged; ``cluster_B`` timing (16 nodes, noise 0.01, seed 0);
``CannikinController(16, batch_candidates=[64, 128, 256], ref_batch=64)``;
``SyntheticLM(seq_len=24, seed=0)``; ``sgd(constant_schedule(0.3))``; 4
steps per epoch, 3 epochs (two bootstrap epochs, then OptPerf).  Plans,
the simulated clock and the h2d/d2h counts must be equal; losses, |g_i|^2,
|g|^2 and b_noise within 1e-4 relative (float32 sums in another order,
carried through 12 SGD steps); each plan's ``lr_scale`` is a function of
the GNS estimate, so it is held to the same 1e-4.  A poisoned node (NaN
gradient factor) is excluded by the guard in both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_api as jax_get_api  # noqa: E402
from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core.controller import CannikinController as JaxController  # noqa: E402
from repro.core.scheduler import JobSpec as JaxJobSpec  # noqa: E402
from repro.core.simulator import SimulatedCluster as JaxCluster  # noqa: E402
from repro.core.simulator import cluster_A as jax_cluster_A  # noqa: E402
from repro.core.simulator import cluster_B as jax_cluster_B  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.optim.optimizers import constant_schedule as jax_constant  # noqa: E402
from repro.optim.optimizers import sgd as jax_sgd  # noqa: E402
from repro.runtime.backend import SimBackend as JaxSimBackend  # noqa: E402
from repro.runtime.backend import run_backend_epoch as jax_run_backend_epoch  # noqa: E402
from repro.train.hetero import HeteroTrainer as JaxHeteroTrainer  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.configs import get_api  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core.controller import CannikinController  # noqa: E402
from repro_torch.core.scheduler import JobSpec  # noqa: E402
from repro_torch.core.simulator import SimulatedCluster, cluster_A, cluster_B  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.optim.optimizers import constant_schedule, sgd  # noqa: E402
from repro_torch.runtime.backend import RealBackendConfig, SimBackend, make_backend  # noqa: E402
from repro_torch.train.hetero import HeteroTrainer  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

REL = 1e-4
STEPS = 4


class Poison:
    """A ``GradientPoison``-style injector: node ``node``'s gradient factor
    is NaN, every other exactly 1.0; timing untouched."""

    def __init__(self, node):
        self.node = node

    def poison_factors(self, node_ids):
        out = np.ones(len(node_ids), np.float32)
        out[list(node_ids).index(self.node)] = np.nan
        return out

    def perturb(self, job, node_ids, epoch_seconds, measurements):
        return epoch_seconds, measurements


def _pair(injector=None, policy_cls=None):
    """(reference trainer, port trainer) from the same weights, under a
    ``CannikinController`` or, given ``policy_cls`` (a baseline's name in
    ``core/baselines.py``), that baseline at a fixed total batch of 64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    jax_api, api = jax_get_api("olmo-1b", reduced=True), get_api("olmo-1b", reduced=True)
    trainers = []
    for api_, cluster, ctl, base, lm, opt, trainer_cls, kw in (
        (jax_api, (JaxCluster, jax_cluster_B), JaxController, jax_baselines, JaxSyntheticLM,
         jax_sgd(jax_constant(0.3)), JaxHeteroTrainer, {}),
        (api, (SimulatedCluster, cluster_B), CannikinController, baselines, SyntheticLM,
         sgd(constant_schedule(0.3)), HeteroTrainer, {"device": "cpu"}),
    ):
        profiles, comm = cluster[1]()
        sim = cluster[0](profiles, comm, noise=0.01, seed=0)
        if policy_cls is None:
            policy = ctl(sim.n, batch_candidates=[64, 128, 256], ref_batch=64)
        else:
            policy = getattr(base, policy_cls)(sim.n)
        data = lm(vocab=api_.cfg.vocab, seq_len=24, seed=0)
        trainers.append(trainer_cls(api_, opt, sim, policy, data, steps_per_epoch=STEPS, **kw))
        if policy_cls is not None:
            trainers[-1].set_fixed_total(64)
    jtr, ptr = trainers
    tree = jax.tree_util.tree_map(np.asarray, jtr.backend.params)
    ptr.backend.params.load_state_dict(state_dict_from_tree(tree))
    jtr.backend.injector = ptr.backend.injector = injector
    return jtr, ptr


def _epoch(jtr, ptr):
    """One epoch in both: the reference through the same cycle its
    ``EpochLoop`` runs, the port through ``HeteroTrainer``."""
    jrec, jres = jax_run_backend_epoch(jtr.policy, jtr.backend, steps=STEPS,
                                       epoch_index=len(jtr.history))
    jtr.history.append(jrec)
    prec = ptr.run_epoch()
    return jrec, jres, prec, ptr.loop.last_result


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=REL, atol=0, equal_nan=True)


@pytest.fixture(scope="module")
def three_epochs():
    jtr, ptr = _pair()
    return jtr, ptr, [_epoch(jtr, ptr) for _ in range(3)]


def test_plans_clock_and_transfers_equal(three_epochs):
    jtr, ptr, epochs = three_epochs
    for jrec, jres, prec, pres in epochs:
        assert (prec.epoch, prec.phase, prec.total_batch, prec.batches) == (
            jrec.epoch, jrec.phase, jrec.total_batch, jrec.batches)
        assert prec.predicted_batch_time == jrec.predicted_batch_time
        assert prec.sim_seconds == jrec.epoch_seconds
        assert prec.measured_batch_time == jrec.measured_batch_time
        _close(prec.lr_scale, jrec.lr_scale)
        assert pres.grad_anomalies == jres.grad_anomalies == (0,) * 16
    assert [e[2].phase for e in epochs] == ["bootstrap", "bootstrap", "optperf"]
    assert ptr.sim_time == jtr.backend.sim_time
    assert ptr.backend.transfers.snapshot() == jtr.backend.transfers.snapshot()
    assert ptr.backend.steps_done == jtr.backend.steps_done == 3 * STEPS


def test_losses_sqnorms_and_noise_scale_close(three_epochs):
    _, ptr, epochs = three_epochs
    for jrec, jres, prec, pres in epochs:
        _close(pres.losses, jres.losses)
        for jobs, pobs in zip(jres.grad_observations, pres.grad_observations):
            _close(pobs.local_sqnorms, jobs.local_sqnorms)
            _close(pobs.global_sqnorm, jobs.global_sqnorm)
            assert pobs.batches == jobs.batches and pobs.valid == jobs.valid
        _close(prec.mean_loss, jrec.mean_loss)
        _close(prec.b_noise, jrec.b_noise)
        _close(pres.b_noise, jres.b_noise)
    assert np.isfinite(epochs[-1][2].b_noise)
    assert epochs[-1][2].mean_loss < epochs[0][2].mean_loss


def test_poisoned_node_is_excluded_in_both():
    jtr, ptr = _pair(injector=Poison(3))
    jrec, jres, prec, pres = _epoch(jtr, ptr)
    want = tuple(STEPS if i == 3 else 0 for i in range(16))
    assert jres.grad_anomalies == pres.grad_anomalies == want
    for jobs, pobs in zip(jres.grad_observations, pres.grad_observations):
        assert pobs.valid == jobs.valid == tuple(i != 3 for i in range(16))
        assert np.isnan(pobs.local_sqnorms[3])
        _close(pobs.global_sqnorm, jobs.global_sqnorm)
    _close(pres.losses, jres.losses)
    assert ptr.backend.anomalous_steps == jtr.backend.anomalous_steps == STEPS
    # Guarded steps feed no GNS observation, in the backend and the controller.
    assert ptr.backend.gns.count == jtr.backend.gns.count == 0
    assert ptr.policy.gns.count == jtr.policy.gns.count == 0


@pytest.mark.parametrize("policy_cls", ["EvenPartition", "LBBSPPartition"])
def test_baseline_policies_train_alike(policy_cls):
    """The example's baselines drive the same trainer: equal partitions and
    clocks, losses within 1e-4."""
    jtr, ptr = _pair(policy_cls=policy_cls)
    for _ in range(2):
        jrec, prec = jtr.run_epoch(), ptr.run_epoch()
        assert (prec.phase, prec.total_batch, prec.batches, prec.sim_seconds) == (
            jrec.phase, jrec.total_batch, jrec.batches, jrec.sim_seconds)
        _close(prec.mean_loss, jrec.mean_loss)
    assert ptr.history[-1].batches != ptr.history[0].batches or policy_cls == "EvenPartition"


def test_snapshot_round_trip_replays_bitwise(tmp_path):
    """In memory and through a checkpoint file: the epoch after a restore
    gives the same losses, bit for bit."""
    _, ptr = _pair()
    backend = ptr.backend
    state = backend.snapshot()
    path = str(tmp_path / "backend.ckpt.npz")
    backend.checkpoint(path)
    first = backend.execute([4] * 16, 2).losses
    backend.load_snapshot(state)
    assert backend.execute([4] * 16, 2).losses == first
    backend.restore(path)
    assert backend.execute([4] * 16, 2).losses == first
    assert backend.steps_done == 2


def test_sim_backend_and_factory_match_reference():
    """``SimBackend`` configured from a ``JobSpec`` replays the reference's
    measurement stream; ``make_backend("real")`` builds reduced olmo-1b."""
    out = []
    for cluster, spec_cls, backend in ((jax_cluster_A, JaxJobSpec, JaxSimBackend(noise=0.02)),
                                       (cluster_A, JobSpec, SimBackend(noise=0.02))):
        profiles, comm = cluster()
        nodes = tuple(p.model() for p in profiles)
        spec = spec_cls(name="j", node_models=nodes, comm=comm, total_batch=96,
                        b_noise=100.0, ref_batch=64)
        backend.configure(spec, [0, 2], seed=4)
        res = backend.execute([40, 56], 3)
        out.append((res.epoch_seconds, [m.node_times for m in res.measurements]))
    assert out[0] == out[1]
    real = make_backend("real", real_config=RealBackendConfig(device="cpu"))
    assert real.kind == "real" and real.device.type == "cpu"
    assert real.params.cfg.name == "olmo-1b-reduced"
