"""The cluster runtime over real gradients: the port's ``ClusterRuntime``
and ``replay`` vs the JAX package's, on the CPU.

Reduced olmo-1b (float32, seq 16) on a 3-node job under
``FaultPlan.chaos_real(3, seed=0)``, its solver stall lengthened from
0.05 to 0.6 s so that the watchdog's wall-clock deadline (half the
shortest stall) is 0.3 s, which a loaded CPU's ordinary solves do not
reach: a stalled first solve (the watchdog degrades the ``"jax"`` engine
once), NaN gradients from one node in
epochs 1-2 (the guard excludes it in epoch 2, when the job runs; the
health monitor sees it), and the second checkpoint write corrupted on
disk, so the second resume rolls back one generation.  The trace preempts
the job twice, with one epoch after each event.  Each backend the runtime
builds starts from the reference's ``PRNGKey(seed)`` weights, bridged.
Allocations, excluded nodes per epoch, degradations, rollbacks and fault
telemetry must be equal; losses within 1e-5 relative (float32 sums in
another order over 6 SGD steps).  Then the preempt/resume round
trip of the port alone: bitwise equal to an unpreempted run.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.runtime as ref  # noqa: E402
import repro_torch.runtime as port  # noqa: E402
from repro.configs import get_api as jax_get_api  # noqa: E402
from repro.core.perf_model import CommModel as RefCommModel  # noqa: E402
from repro.core.scheduler import JobSpec as RefJobSpec  # noqa: E402
from repro.core.simulator import GPU_CATALOG as REF_GPU_CATALOG  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.core.gns import GNSState  # noqa: E402
from repro_torch.core.perf_model import CommModel  # noqa: E402
from repro_torch.core.scheduler import JobSpec  # noqa: E402
from repro_torch.core.simulator import GPU_CATALOG  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

REL = 1e-5
N_NODES = 3


def _spec(job_spec, comm, catalog):
    """The reference tests' tiny real job: 3 heterogeneous nodes, total 12."""
    return job_spec(
        name="rj",
        node_models=tuple(catalog[n].model() for n in ("a100", "v100", "rtx6000")),
        comm=comm(t_o=0.04, t_u=0.008, gamma=0.15),
        total_batch=12,
        b_noise=500.0,
        ref_batch=12,
        backend="real",
    )


def _recording(backend, log):
    """Log each epoch's (fault epoch, excluded-step counts per node, losses)."""
    execute = backend.execute

    def run(batches, steps, **kw):
        res = execute(batches, steps, **kw)
        log.append((backend.injector.epoch if backend.injector else None,
                    tuple(res.grad_anomalies), tuple(res.losses)))
        return res

    backend.execute = run
    return backend


@dataclasses.dataclass
class RefConfig(ref.RealBackendConfig):
    log: list = None

    def build(self, *, noise=0.0, seed=0, injector=None):
        return _recording(super().build(noise=noise, seed=seed, injector=injector), self.log)


@dataclasses.dataclass
class PortConfig(port.RealBackendConfig):
    """The port's recipe with the reference's initial weights for ``seed``."""

    log: list = None

    def build(self, *, noise=0.0, seed=0, injector=None):
        backend = super().build(noise=noise, seed=seed, injector=injector)
        tree = jax.tree_util.tree_map(
            np.asarray, jax_get_api(self.arch, reduced=True).init(jax.random.PRNGKey(seed)))
        backend.params.load_state_dict(state_dict_from_tree(tree))
        return _recording(backend, self.log)


def _chaos_plan(mod):
    plan = mod.FaultPlan.chaos_real(N_NODES, seed=0)
    stall = dataclasses.replace(plan.solver_stalls[0], delay=0.6)
    return dataclasses.replace(plan, solver_stalls=(stall,))


def _replay(mod, spec, cfg, ckpt_dir, **kw):
    trace = (mod.Trace().arrive(spec, 0.0).preempt("rj", 1.0).arrive(spec, 2.0)
             .preempt("rj", 3.0).arrive(spec, 4.0))
    return mod.replay(
        trace, N_NODES, policy="cannikin", engine="jax", epochs_per_event=1, steps=2,
        noise=0.0, seed=0, real_backend=cfg, checkpoint_dir=str(ckpt_dir),
        faults=_chaos_plan(mod), invariants=True, **kw)


def _view(rep):
    rt = rep.runtime
    h = rt.handles["rj"]
    return dict(
        records=[(r.time, r.label, dict(r.allocation.assignment)) for r in rep.records],
        plans=[(e.phase, e.total_batch, e.batches) for e in h.records],
        counters=rt.counters(),
        telemetry=json.dumps(rt.fault_telemetry(), sort_keys=True, default=str),
        detections=rt.health.detections if rt.health else None,
        handle=(h.state, h.preemptions, h.restores, h.ckpt_rollbacks, h.ckpt_fallbacks,
                h.epochs_run, h.sim_time),
        violations=len(rt.invariant_violations),
    )


@pytest.fixture(scope="module")
def chaos_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chaos")
    ref_log, port_log = [], []
    want = _replay(ref, _spec(RefJobSpec, RefCommModel, REF_GPU_CATALOG),
                   RefConfig(arch="olmo-1b", seq_len=16, lr=0.3, log=ref_log), tmp / "ref")
    got = _replay(port, _spec(JobSpec, CommModel, GPU_CATALOG),
                  PortConfig(arch="olmo-1b", seq_len=16, lr=0.3, device="cpu", log=port_log),
                  tmp / "port", device="cpu")
    return got, want, port_log, ref_log


def test_chaos_real_replay_decisions_equal_reference(chaos_pair):
    got, want, _, _ = chaos_pair
    g, w = _view(got), _view(want)
    assert g == w
    assert _view(got.baseline) == _view(want.baseline)
    assert g["violations"] == 0
    assert g["counters"]["solver_timeouts"] == 1
    assert g["counters"]["engine_degradations"] == 1
    assert "engine_degradations" not in _view(got.baseline)["counters"]
    # Two preemptions: the second generation is corrupted on disk, so the
    # second resume rolls back to the first.
    assert g["handle"][1:5] == (2, 2, 1, 0)


def test_chaos_real_poisoned_node_excluded_in_its_window(chaos_pair):
    got, _, port_log, ref_log = chaos_pair
    plan = got.runtime.injector.plan
    poison = plan.poisons[0]
    window = range(poison.at_epoch, poison.at_epoch + poison.duration)
    # The faulted run logs first after its twin: the twin's epochs carry no
    # injector.
    faulted = [e for e in port_log if e[0] is not None]
    assert [e[:2] for e in port_log] == [e[:2] for e in ref_log]
    hit = [e for e in faulted if e[0] in window]
    assert hit, "the job never ran inside the poison window"
    for epoch, anomalies, _ in faulted:
        want = 2 if epoch in window else 0
        assert anomalies[poison.node] == want and sum(anomalies) == want, (epoch, anomalies)
    for (_, _, lp), (_, _, lr) in zip(port_log, ref_log):
        assert all(np.isfinite(lp))
        np.testing.assert_allclose(lp, lr, rtol=REL, atol=0)


def _drive(preempt, ckpt_dir):
    """The reference test's ``_drive``: one real 3-node job, 2x2 epochs,
    then (with ``preempt``) preempt, zero the live state, resume, 2x2 more."""
    rt = port.ClusterRuntime(
        3, policy="cannikin", seed=0,
        real_backend=port.RealBackendConfig(arch="olmo-1b", seq_len=16, lr=0.3,
                                            device="cpu"),
        checkpoint_dir=str(ckpt_dir) if preempt else None)
    spec = _spec(JobSpec, CommModel, GPU_CATALOG)
    handle = rt.submit(spec, at=0.0)
    rt.run()
    rt.advance(epochs=2, steps=2)
    if preempt:
        rt.preempt(spec.name, at=1.0)
        rt.run()
        assert handle.state == port.JobState.PREEMPTED
        assert os.path.exists(handle.checkpoint_path)
        with torch.no_grad():
            for p in handle.backend.named.values():
                p.zero_()
        handle.backend.gns = GNSState()
        handle.backend.steps_done = 0
        rt.submit(spec, at=2.0)
        rt.run()
        assert handle.state == port.JobState.RUNNING
    rt.advance(epochs=2, steps=2)
    return handle


@pytest.fixture
def one_thread():
    """The CPU's BLAS splits some products (here the b=19 node's) across
    threads differently from call to call, so two identical runs differ in
    the last bits; one thread keeps each sum in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_preempt_resume_round_trip_bitwise(tmp_path, one_thread):
    plain = _drive(False, tmp_path)
    resumed = _drive(True, tmp_path)
    assert plain.epochs_run == resumed.epochs_run == 4
    assert resumed.preemptions == resumed.restores == 1
    assert [r.batches for r in plain.records] == [r.batches for r in resumed.records]
    assert [r.mean_loss for r in plain.records] == [r.mean_loss for r in resumed.records]
    for name, p in plain.backend.named.items():
        assert torch.equal(p, resumed.backend.named[name]), name
    for a, b in zip(plain.backend.opt_state.momentum.values(),
                    resumed.backend.opt_state.momentum.values()):
        assert torch.equal(a, b)
    assert plain.backend.gns == resumed.backend.gns
    assert plain.backend.steps_done == resumed.backend.steps_done


def test_real_backend_config_cuts_depth_and_keeps_widths():
    """``RealBackendConfig.n_layers`` builds the arch's config at that depth
    with its widths; None keeps the config's own depth."""
    from repro_torch.configs import get_api

    full = port.RealBackendConfig(arch="olmo-1b", seq_len=8, device="cpu").build()
    cut = port.RealBackendConfig(arch="olmo-1b", seq_len=8, device="cpu", n_layers=1).build()
    assert full.api.cfg == get_api("olmo-1b", reduced=True).cfg
    assert cut.api.cfg == dataclasses.replace(full.api.cfg, n_layers=1)
    n_params = sum(p.numel() for p in cut.named.values())
    assert n_params == cut.api.param_count() < full.api.param_count()
