"""The multi-job scheduler: the port's ``core/scheduler.py`` vs the JAX
package's, on the CPU.

The host engines (``"batched"`` NumPy, ``"scalar"`` oracle) are the same
NumPy code in both packages, so allocations, goodputs, fractions and the
incremental ``Scheduler``'s counters must be equal.  The ``"jax"`` engine
is the port's torch sweep on ``device="cpu"`` against the reference's jit
sweep, both float32: node assignments equal, aggregate goodput within
1e-5 relative (the emitted goodputs are re-solved on the host, so they
come out equal in practice).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import scheduler as ref  # noqa: E402
from repro.runtime.runtime import drift_spec as ref_drift_spec  # noqa: E402
from repro_torch.core import scheduler as port  # noqa: E402
from repro_torch.runtime.runtime import drift_spec  # noqa: E402

JAX_REL = 1e-5
CASES = [(1, 4, 0), (2, 6, 3), (3, 12, 0), (4, 10, 5), (5, 16, 2), (8, 32, 1)]
COUNTERS = ("allocations", "warm_rounds", "cold_rounds", "solved_rows", "cached_rows")


def _plain(alloc):
    return (dict(alloc.assignment), dict(alloc.goodputs), dict(alloc.fractions))


def _counters(s):
    return {k: getattr(s, k) for k in COUNTERS}


@pytest.mark.parametrize("engine", ["batched", "scalar"])
@pytest.mark.parametrize("n_jobs,n_nodes,seed", CASES)
def test_allocate_host_engines_equal_reference(engine, n_jobs, n_nodes, seed):
    want = ref.allocate(ref.random_jobs(n_jobs, n_nodes, seed), n_nodes, engine=engine)
    got = port.allocate(port.random_jobs(n_jobs, n_nodes, seed), n_nodes, engine=engine)
    assert _plain(got) == _plain(want)
    assert got.aggregate_goodput == want.aggregate_goodput
    assert got.aggregate_fraction == want.aggregate_fraction


@pytest.mark.parametrize("n_jobs,n_nodes,seed", CASES)
def test_allocate_device_engine_on_cpu_matches_reference(n_jobs, n_nodes, seed):
    want = ref.allocate(ref.random_jobs(n_jobs, n_nodes, seed), n_nodes, engine="jax")
    got = port.allocate(port.random_jobs(n_jobs, n_nodes, seed), n_nodes, engine="jax",
                        device="cpu")
    host = port.allocate(port.random_jobs(n_jobs, n_nodes, seed), n_nodes, engine="batched")
    assert got.assignment == want.assignment == host.assignment
    assert got.aggregate_goodput == pytest.approx(want.aggregate_goodput, rel=JAX_REL)
    assert got.aggregate_goodput == pytest.approx(host.aggregate_goodput, rel=JAX_REL)


def test_device_engine_binds_the_torch_sweep_and_counts_no_fallback():
    s = port.Scheduler(12, engine="jax", device="cpu")
    for job in port.random_jobs(3, 12, seed=0):
        s.add_job(job)
    assert s.warm_rounds > 0 and s.fallback_blocks == 0
    solver = port._stacked_solver("jax", "cpu")
    assert solver.func.__module__ == "repro_torch.core.optperf_torch"
    assert solver.keywords == {"device": torch.device("cpu")}
    assert port._stacked_solver("batched") is port.solve_optperf_stacked


def test_device_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    with pytest.raises(RuntimeError):
        port.allocate(port.random_jobs(2, 6, seed=0), 6, engine="jax")


def _churn(mod, drift, engine, **kw):
    """Arrivals one by one, a refit, a node leave and join, a departure:
    the allocation after each event and the counters at the end."""
    n = 12
    jobs = mod.random_jobs(4, n, seed=7)
    s = mod.Scheduler(n, engine=engine, **kw)
    out = [_plain(s.add_job(j)) for j in jobs]
    out.append(_plain(s.update_job(drift(jobs[1], 0.2, 3))))
    out.append(_plain(s.node_leave([3, 11])))
    out.append(_plain(s.node_join([3])))
    out.append(_plain(s.remove_job(jobs[0].name)))
    out.append(_plain(s.add_job(dataclasses.replace(jobs[0], name="again"))))
    return out, _counters(s), s.down_nodes


@pytest.mark.parametrize("engine", ["batched", "scalar"])
def test_scheduler_incremental_churn_equals_reference(engine):
    want = _churn(ref, ref_drift_spec, engine)
    got = _churn(port, drift_spec, engine)
    assert got == want


def test_scheduler_incremental_churn_device_engine():
    want, want_counters, _ = _churn(ref, ref_drift_spec, "jax")
    got, got_counters, _ = _churn(port, drift_spec, "jax", device="cpu")
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        total_g, total_w = sum(g[1].values()), sum(w[1].values())
        assert total_g == pytest.approx(total_w, rel=JAX_REL)
    assert got_counters == want_counters


def test_scheduler_errors_and_aggregate_equal_reference():
    jobs = port.random_jobs(2, 6, seed=0)
    s = port.Scheduler(6)
    s.add_job(jobs[0])
    with pytest.raises(ValueError):
        s.add_job(jobs[0])
    with pytest.raises(KeyError):
        s.remove_job("nope")
    with pytest.raises(ValueError):
        s.node_leave([6])
    with pytest.raises(ValueError):
        port.Scheduler(6, engine="nope")
    with pytest.raises(ValueError):
        port.allocate(jobs, 6, unavailable=[-1])
    assert port.allocate([], 6).assignment == {}
    alloc = port.allocate(jobs, 6)
    want = ref.allocate(ref.random_jobs(2, 6, seed=0), 6)
    assert port.aggregate_goodput(jobs, alloc) == ref.aggregate_goodput(
        ref.random_jobs(2, 6, seed=0), want)
