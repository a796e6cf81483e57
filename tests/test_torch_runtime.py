"""The cluster runtime on the timing simulator: the port's
``repro_torch.runtime`` vs the JAX package's ``repro.runtime``, on the CPU.

Everything here runs on the host engines and the simulator, which are the
same NumPy code in both packages, so results must be equal, not close:
the golden pin of the reference's own tests, reconcile records and
summaries of every allocation policy, chaos replays' fault telemetry and
goodput retention, the watchdog's degradation chain, the invariant
checker and every event's ``describe`` string.  The ``"jax"`` engine runs
the port's torch sweep on ``device="cpu"``.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.runtime as ref  # noqa: E402
import repro_torch.core.scheduler as sched_mod  # noqa: E402
import repro_torch.runtime as port  # noqa: E402
from repro.core.scheduler import random_jobs as ref_random_jobs  # noqa: E402
from repro_torch.core.scheduler import random_jobs  # noqa: E402

N_NODES = 12

# The reference's golden replay (``tests/test_backend.py``):
# synthetic_trace(3, 12, seed=0), cannikin, 2 epochs per event, 2 steps,
# noise 0.01, seed 0.
GOLDEN_AGG_GOODPUT = 2125.4784947969247
GOLDEN_AGG_FRACTION = 1.0928105167204858
GOLDEN_ASSIGNMENT = {"job1": (1, 5, 7, 8, 9, 10), "job2": (0, 2, 3, 4, 6)}
GOLDEN_EPOCHS = {"job0": 6, "job1": 8, "job2": 6}
GOLDEN_COUNTERS = {
    "allocations": 5,
    "warm_rounds": 28,
    "cold_rounds": 3,
    "solved_rows": 372,
    "cached_rows": 396,
}
GOLDEN_SIM_TIME = {
    "job0": 2.780991958839693,
    "job1": 15.168174637445608,
    "job2": 33.567468442725044,
}


def _summary(rep):
    return json.dumps(rep.summary(), sort_keys=True, default=str)


def _records(rep):
    return [
        (r.time, r.label, dict(r.allocation.assignment), dict(r.allocation.goodputs),
         dict(r.allocation.fractions))
        for r in rep.records
    ]


def _epochs(rep):
    return {
        name: [(e.epoch, e.phase, e.total_batch, e.batches, e.epoch_seconds,
                e.predicted_batch_time, e.lr_scale) for e in h.records]
        for name, h in rep.runtime.handles.items()
    }


def test_golden_replay_pin():
    trace, _ = port.synthetic_trace(3, N_NODES, seed=0)
    rep = port.replay(trace, N_NODES, policy="cannikin", epochs_per_event=2, steps=2,
                      noise=0.01, seed=0)
    assert rep.aggregate_goodput == GOLDEN_AGG_GOODPUT
    assert rep.aggregate_fraction == GOLDEN_AGG_FRACTION
    assert dict(rep.runtime.allocation.assignment) == GOLDEN_ASSIGNMENT
    assert rep.epochs == GOLDEN_EPOCHS
    assert rep.runtime.counters() == GOLDEN_COUNTERS
    assert {n: h.sim_time for n, h in rep.runtime.handles.items()} == GOLDEN_SIM_TIME


@pytest.mark.parametrize("seed", range(3))
def test_compare_policies_equal_reference(seed):
    kw = dict(epochs_per_event=2, steps=2, noise=0.01, seed=seed)
    trace, _ = port.synthetic_trace(3, N_NODES, seed=seed, refit=True)
    ref_trace, _ = ref.synthetic_trace(3, N_NODES, seed=seed, refit=True)
    got = port.compare_policies(trace, N_NODES, **kw)
    want = ref.compare_policies(ref_trace, N_NODES, **kw)
    assert list(got) == list(want) == ["cannikin", "static", "fair-share"]
    for name in got:
        assert _records(got[name]) == _records(want[name]), name
        assert _epochs(got[name]) == _epochs(want[name]), name
        assert _summary(got[name]) == _summary(want[name]), name
    assert port.format_summary(got) == ref.format_summary(want)


def test_batch_policy_axis_equal_reference():
    kw = dict(epochs_per_event=2, steps=2, noise=0.01, seed=1,
              batch_policies=("fixed", "geodamp", "adadamp"))
    trace, _ = port.synthetic_trace(2, 8, seed=1, arrival="poisson", size_dist="lognormal")
    ref_trace, _ = ref.synthetic_trace(2, 8, seed=1, arrival="poisson",
                                       size_dist="lognormal")
    got = port.compare_policies(trace, 8, **kw)
    want = ref.compare_policies(ref_trace, 8, **kw)
    assert port.rank_batch_policies(got) == ref.rank_batch_policies(want)
    assert port.format_batch_policy_summary(got) == ref.format_batch_policy_summary(want)
    for name in got:
        assert _summary(got[name]) == _summary(want[name]), name


@pytest.mark.parametrize("plan", ["chaos", "chaos-small"])
def test_chaos_replay_telemetry_equal_reference(plan, tmp_path):
    out = []
    for mod in (port, ref):
        trace, _ = mod.synthetic_trace(3, N_NODES, seed=0)
        rep = mod.replay(
            trace, N_NODES, policy="cannikin", epochs_per_event=4, steps=2, noise=0.01,
            seed=0, faults=mod.make_fault_plan(plan, N_NODES, seed=0),
            checkpoint_dir=str(tmp_path / mod.__name__), invariants=True,
        )
        rt = rep.runtime
        out.append(dict(
            telemetry=json.dumps(rt.fault_telemetry(), sort_keys=True, default=str),
            retention=rep.goodput_retention,
            detections=rt.health.detections,
            injected=rt.injector.injected,
            recovery=rt.recovery_log,
            records=_records(rep),
            summary=_summary(rep),
            violations=len(rt.invariant_violations),
        ))
    got, want = out
    assert got == want
    assert got["violations"] == 0
    assert 0 < got["retention"] <= 1


def _chaos_real(mod, n):
    """``FaultPlan.chaos_real`` with its solver stall lengthened from 0.05
    to 0.6 s: the watchdog's wall-clock deadline (half the shortest stall)
    becomes 0.3 s, which a loaded CPU's ordinary solves do not reach."""
    plan = mod.FaultPlan.chaos_real(n, seed=0)
    stall = dataclasses.replace(plan.solver_stalls[0], delay=0.6)
    return dataclasses.replace(plan, solver_stalls=(stall,))


def test_device_engine_replay_degrades_once_on_the_injected_stall():
    """``chaos_real`` over the simulator with the ``"jax"`` engine on the
    CPU: the stalled first solve trips the watchdog, the policy drops to
    ``"batched"`` once, and the fault-free twin never degrades; every
    allocation equals the reference's replay on its own ``"jax"``
    engine."""
    kw = dict(policy="cannikin", engine="jax", epochs_per_event=1, steps=2, noise=0.01,
              seed=0, invariants=True)
    trace, _ = port.synthetic_trace(2, 4, seed=0)
    ref_trace, _ = ref.synthetic_trace(2, 4, seed=0)
    got = port.replay(trace, 4, faults=_chaos_real(port, 4), device="cpu", **kw)
    want = ref.replay(ref_trace, 4, faults=_chaos_real(ref, 4), **kw)
    c = got.runtime.counters()
    assert c["solver_timeouts"] == 1 and c["engine_degradations"] == 1
    assert got.runtime.policy.scheduler.engine == "batched"
    assert "engine_degradations" not in got.baseline.runtime.counters()
    assert got.baseline.runtime.policy.scheduler.engine == "jax"
    assert got.baseline.runtime.policy.scheduler.fallback_blocks == 0
    assert got.runtime.invariant_violations == []
    assert [(r[1], r[2]) for r in _records(got)] == [(r[1], r[2]) for r in _records(want)]
    assert ([(r[1], r[2]) for r in _records(got.baseline)]
            == [(r[1], r[2]) for r in _records(want.baseline)])
    host = port.replay(trace, 4, policy="cannikin", engine="batched", seed=0)
    assert ([r[2] for r in _records(got.baseline)] == [r[2] for r in _records(host)])


def test_watchdog_timeout_walks_the_degradation_chain():
    calls = {"n": 0}

    def stall_once():
        calls["n"] += 1
        return 0.02 if calls["n"] == 1 else 0.0

    wd = port.Watchdog(solve_deadline=0.002, stall_hook=stall_once)
    pol = port.CannikinPolicy(8, engine="jax", watchdog=wd, device="cpu")
    spec = random_jobs(1, 8, seed=0)[0]
    alloc = pol.add_job(spec)
    assert wd.solver_timeouts == 1
    assert pol.engine_degradations == 1 and pol.scheduler.engine == "batched"
    want = ref.CannikinPolicy(8, engine="batched").add_job(ref_random_jobs(1, 8, seed=0)[0])
    assert alloc.assignment == want.assignment
    assert pol.counters()["solver_timeouts"] == 1
    with pytest.raises(port.DeadlineExceeded):
        port.Watchdog(solve_deadline=0.001, stall_hook=lambda: 0.01).guard_solve(lambda: 1)
    rt = port.ClusterRuntime(4, faults=port.FaultPlan(
        solver_stalls=(port.SolverStall(at_epoch=0, delay=0.05),)))
    assert rt.watchdog.solve_deadline == pytest.approx(0.025)


def test_degradation_serves_last_known_good(monkeypatch):
    spec = random_jobs(1, 8, seed=0)[0]
    pol = port.CannikinPolicy(8, engine="batched")
    good = pol.add_job(spec)

    def boom(*a, **kw):
        raise RuntimeError("solver dead")

    monkeypatch.setattr(sched_mod, "_allocate_arrays", boom)
    monkeypatch.setattr(sched_mod, "_allocate_scalar", boom)
    assert pol.reallocate() is good
    assert pol.last_known_good_served == 1 and pol.scheduler.engine == "scalar"
    with pytest.raises(ValueError):
        pol.add_job(spec)


def _sim_runtime(mod, jobs):
    rt = mod.ClusterRuntime(8, policy="cannikin", seed=0, health=True, invariants=True)
    for spec in jobs:
        rt.submit(spec, at=0.0)
    rt.run()
    rt.advance(epochs=1, steps=2)
    return rt


def _break(mod, rt):
    """The reference's hand-broken states: a doubly assigned node, then a
    quarantined node with no re-admission and a backoff past its cap."""
    checker = rt.invariant_checker
    a, b = list(rt.allocation.assignment)[:2]
    stolen = rt.allocation.assignment[b][0]
    rt.allocation.assignment[a] = tuple(rt.allocation.assignment[a]) + (stolen,)
    first = sorted(v.invariant for v in checker.check("tamper:double-assign"))
    rt.allocation.assignment[a] = tuple(
        n for n in rt.allocation.assignment[a] if n != stolen)
    h = rt.health.node(0)
    h.transition(0, mod.NodeState.QUARANTINED)
    h.release_epoch = None
    h.backoff = 2 * rt.health.config.backoff_max
    second = sorted(v.invariant for v in checker.check("tamper:quarantine"))
    return first, second, [str(v) for v in rt.invariant_violations]


def test_invariant_checker_clean_and_broken_equal_reference():
    rt = _sim_runtime(port, random_jobs(2, 8, seed=0))
    want_rt = _sim_runtime(ref, ref_random_jobs(2, 8, seed=0))
    assert rt.invariant_checker.checks_run == want_rt.invariant_checker.checks_run > 0
    rt.invariant_checker.assert_clean()
    got, want = _break(port, rt), _break(ref, want_rt)
    assert got == want
    assert "disjoint-assignment" in got[0]
    assert {"quarantine-liveness", "backoff-cap"} <= set(got[1])
    with pytest.raises(AssertionError):
        rt.invariant_checker.assert_clean()


def _events(mod, spec):
    return [
        mod.JobArrival(time=0.0, spec=spec),
        mod.JobCompletion(time=1.0, job="job0"),
        mod.Preemption(time=2.0, job="job0"),
        mod.ModelRefit(time=3.0, job="job0", rel=0.2, seed=4),
        mod.ModelRefit(time=3.5, job="job0", spec=spec),
        mod.NodeJoin(time=4.0, nodes=(1, 2)),
        mod.NodeLeave(time=5.0, nodes=(3,)),
        mod.Event(time=6.0),
    ]


def test_event_describe_strings_and_fields_equal_reference():
    got = _events(port, random_jobs(1, 4, seed=0)[0])
    want = _events(ref, ref_random_jobs(1, 4, seed=0)[0])
    assert [port.describe(e) for e in got] == [ref.describe(e) for e in want]
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert [f.name for f in g.__dataclass_fields__.values()] == [
            f.name for f in w.__dataclass_fields__.values()]
    assert port.__all__ == ref.__all__


def test_lifecycle_preempt_resume_complete_equal_reference():
    out = []
    for mod, jobs in ((port, random_jobs(3, 8, seed=2)), (ref, ref_random_jobs(3, 8, seed=2))):
        rt = mod.ClusterRuntime(8, policy="cannikin", seed=0, noise=0.01)
        for i, spec in enumerate(jobs):
            rt.submit(spec, at=float(i))
        rt.run()
        rt.advance(epochs=2, steps=2)
        rt.preempt(jobs[0].name)
        rt.refit(jobs[1].name, rel=0.1, seed=1)
        rt.node_leave([5])
        rt.run()
        rt.advance(epochs=1, steps=2)
        rt.submit(jobs[0])
        rt.node_join([5])
        rt.complete(jobs[2].name)
        rt.run()
        rt.advance(epochs=2, steps=2)
        out.append((
            [(r.label, dict(r.allocation.assignment)) for r in rt.records],
            {n: (h.state, h.nodes, h.epochs_run, h.sim_time, h.preemptions, h.restores,
                 h.reallocations) for n, h in rt.handles.items()},
            rt.counters(),
        ))
    assert out[0] == out[1]
