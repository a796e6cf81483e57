"""The port's training control plane vs the JAX package: numpy modules, `==`.

``core/{simulator,goodput,batch_policy,controller,baselines}.py``,
``core/scheduler.py::JobSpec`` and ``data/pipeline.py`` are copied
verbatim, so on the seeded inputs of the reference's own tests
(``test_simulator.py``, ``test_goodput.py``, ``test_batch_policy.py``,
``test_controller.py`` and ``test_optperf_batch.py``'s plan parity) they
must give equal results, not close ones.  Engine "jax" (the on-device
sweep) plans as the reference's does, on the CPU when asked.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import baselines as jb  # noqa: E402
from repro.core import batch_policy as jbp  # noqa: E402
from repro.core import controller as jc  # noqa: E402
from repro.core import scheduler as js  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.data import pipeline as jp  # noqa: E402
from repro_torch.core import baselines as pb  # noqa: E402
from repro_torch.core import batch_policy as pbp  # noqa: E402
from repro_torch.core import controller as pc  # noqa: E402
from repro_torch.core import goodput as pg  # noqa: E402
from repro_torch.core import optperf as po  # noqa: E402
from repro_torch.core import scheduler as ps  # noqa: E402
from repro_torch.core import simulator as psim  # noqa: E402
from repro_torch.data import pipeline as pp  # noqa: E402
from repro_torch.runtime.transfers import TransferCounter  # noqa: E402

# ``repro.core`` re-exports a function named ``goodput`` over the submodule.
jg = importlib.import_module("repro.core.goodput")

CLUSTERS = ("cluster_A", "cluster_B", "cluster_C")


def _astuple(x):
    return dataclasses.astuple(x)


def _sims(name, noise, seed, **kw):
    jprof, jcomm = getattr(jsim, name)(**kw)
    pprof, pcomm = getattr(psim, name)(**kw)
    return (jsim.SimulatedCluster(jprof, jcomm, noise=noise, seed=seed),
            psim.SimulatedCluster(pprof, pcomm, noise=noise, seed=seed))


@pytest.mark.parametrize("name", CLUSTERS)
def test_cluster_profiles_equal(name):
    jprof, jcomm = getattr(jsim, name)()
    pprof, pcomm = getattr(psim, name)()
    assert [_astuple(p) for p in jprof] == [_astuple(p) for p in pprof]
    assert _astuple(jcomm) == _astuple(pcomm)
    assert {k: _astuple(v) for k, v in jsim.GPU_CATALOG.items()} == {
        k: _astuple(v) for k, v in psim.GPU_CATALOG.items()}


@pytest.mark.parametrize("name,noise,seed", [("cluster_A", 0.05, 0), ("cluster_B", 0.01, 1),
                                             ("cluster_C", 0.0, 0)])
def test_simulated_epochs_equal(name, noise, seed):
    jsc, psc = _sims(name, noise, seed)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        batches = [int(b) for b in rng.integers(1, 64, jsc.n)]
        jt, jms = jsc.run_epoch(batches, 4)
        pt, pms = psc.run_epoch(batches, 4)
        assert jt == pt
        assert [_astuple(m) for m in jms] == [_astuple(m) for m in pms]
    assert _astuple(jsc.perturbed(0.1, seed=3).true_model().comm) == _astuple(
        psc.perturbed(0.1, seed=3).true_model().comm)
    jd = jsim.drift_model(jsc.true_model(), 0.2, 5)
    pd = psim.drift_model(psc.true_model(), 0.2, 5)
    assert [_astuple(x) for x in jd.nodes] == [_astuple(x) for x in pd.nodes]


def test_goodput_curve_and_selector_equal():
    jsc, psc = _sims("cluster_A", 0.0, 0)
    jm, pm = jsc.true_model(), psc.true_model()
    cands = [64, 128, 256, 512, 1024]
    for b_noise in (50.0, 500.0, 5000.0, float("inf")):
        jcur = jg.goodput_curve(jm, cands, b_noise, 64)
        pcur = pg.goodput_curve(pm, cands, b_noise, 64)
        np.testing.assert_array_equal(jcur.goodputs, pcur.goodputs)
        assert jg.goodput(jm, 256, b_noise, 64)[0] == pg.goodput(pm, 256, b_noise, 64)[0]
        assert jg.adascale_gain(b_noise, 256, 64) == pg.adascale_gain(b_noise, 256, 64)
        assert jg.sqrt_lr_scale(256, 64) == pg.sqrt_lr_scale(256, 64)
    jsel = jg.BatchSizeSelector(candidates=tuple(cands), ref_batch=64)
    psel = pg.BatchSizeSelector(candidates=tuple(cands), ref_batch=64)
    for b_noise in (100.0, 120.0, 2000.0, 30.0):
        jb_, jsol, jgp = jsel.select(jm, b_noise)
        pb_, psol, pgp = psel.select(pm, b_noise)
        assert (jb_, jsol.batches, jgp) == (pb_, psol.batches, pgp)
    assert (jsel.full_sweeps, jsel.incremental_updates) == (
        psel.full_sweeps, psel.incremental_updates)


def test_jax_sweep_engine_raises():
    """Engine "jax" is the on-device sweep: it runs on the card unless
    ``device="cpu"`` is asked for, so without a card it raises; nothing
    falls back to the NumPy engine in its place."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device sweep runs there")
    _, psc = _sims("cluster_A", 0.0, 0)
    model = psc.true_model()
    sel = pg.BatchSizeSelector(candidates=(64, 128), ref_batch=64, engine="jax")
    with pytest.raises((RuntimeError, AssertionError)):
        sel.select(model, 100.0)
    with pytest.raises((RuntimeError, AssertionError)):
        pg.goodput_curve(model, [64, 128], 100.0, 64, engine="jax")
    assert sel.full_sweeps == 1 and not sel._optperf_cache


@pytest.mark.parametrize("seed", [0, 1])
def test_jax_sweep_engine_plans_like_batched(seed):
    """``test_controller_plans_equal``'s scenario with ``sweep_engine="jax"``
    in both packages (the port's sweep on the CPU): plans equal the
    reference's, and equal the port's own NumPy engine's."""
    out = {}
    for key, sim_mod, ctl_mod, kw in (("ref", jsim, jc, {}),
                                      ("port", psim, pc, {"device": "cpu"}),
                                      ("batched", psim, pc, None)):
        profiles, comm = sim_mod.cluster_B()
        sim = sim_mod.SimulatedCluster(profiles, comm, noise=0.01, seed=seed)
        engine = {} if kw is None else {"sweep_engine": "jax", **kw}
        ctrl = ctl_mod.CannikinController(
            sim.n, batch_candidates=[128, 256, 512, 1024, 2048, 4096], ref_batch=128, **engine)
        plans = []
        for _ in range(6):
            plan = ctrl.plan_epoch()
            _, ms = sim.run_epoch(list(plan.batches), steps=5)
            ctrl.observe_epoch(ms)
            ctrl.observe_gradients([4.0] * sim.n, 3.0, list(plan.batches))
            plans.append(_plan(plan))
        out[key] = (plans, ctrl.stats.full_sweeps, ctrl.stats.cold_sweeps,
                    ctrl.stats.warm_sweeps)
    assert out["port"] == out["ref"] == out["batched"]
    _, psc = _sims("cluster_A", 0.0, 0)
    jsc, _ = _sims("cluster_A", 0.0, 0)
    pcurve = pg.goodput_curve(psc.true_model(), [64, 128, 256], 100.0, 64, engine="jax",
                              device="cpu")
    jcurve = jg.goodput_curve(jsc.true_model(), [64, 128, 256], 100.0, 64, engine="jax")
    np.testing.assert_allclose(pcurve.goodputs, jcurve.goodputs, rtol=1e-5)
    assert pcurve.solutions.method == jcurve.solutions.method == "waterfill/jax"


@pytest.mark.parametrize("name", ["cannikin-gns", "fixed", "adadamp", "padadamp", "geodamp"])
def test_batch_policies_equal(name):
    assert sorted(pbp.BATCH_POLICIES) == sorted(jbp.BATCH_POLICIES)
    jsc, psc = _sims("cluster_A", 0.0, 0)
    candidates = [64, 128, 512]
    jpol = jbp.make_batch_policy(name, candidates=candidates, ref_batch=64)
    ppol = pbp.make_batch_policy(name, candidates=candidates, ref_batch=64)
    jbounds, pbounds = jbp.BatchBounds(64, 512), pbp.BatchBounds(64, 512)
    for e in range(6):
        for pol, mod in ((jpol, jbp), (ppol, pbp)):
            pol.observe(mod.PolicyTelemetry(epoch=e, total_batch=64, mean_loss=3.0 / (e + 1),
                                            b_noise=1000.0 / (e + 1)))
        jprop = jpol.propose(jsc.true_model(), jbounds)
        pprop = ppol.propose(psc.true_model(), pbounds)
        assert (jprop.total_batch, jprop.lr_scale) == (pprop.total_batch, pprop.lr_scale)
    jstate, pstate = jpol.state(), ppol.state()
    assert set(jstate) == set(pstate)
    for key in jstate:
        np.testing.assert_array_equal(np.asarray(jstate[key]), np.asarray(pstate[key]))


def _plan(plan):
    return (plan.epoch, plan.total_batch, plan.batches, plan.lr_scale,
            plan.predicted_batch_time, plan.phase, plan.batch_policy)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_plans_equal(seed):
    """``test_optperf_batch.py``'s plan-parity scenario, run through both
    packages: identical plans every epoch."""
    out = {}
    for sim_mod, ctl_mod in ((jsim, jc), (psim, pc)):
        profiles, comm = sim_mod.cluster_B()
        sim = sim_mod.SimulatedCluster(profiles, comm, noise=0.01, seed=seed)
        ctrl = ctl_mod.CannikinController(
            sim.n, batch_candidates=[128, 256, 512, 1024, 2048, 4096], ref_batch=128)
        plans = []
        for _ in range(8):
            plan = ctrl.plan_epoch()
            _, ms = sim.run_epoch(list(plan.batches), steps=5)
            ctrl.observe_epoch(ms)
            ctrl.observe_gradients([4.0] * sim.n, 3.0, list(plan.batches))
            plans.append(_plan(plan))
        out[ctl_mod] = (plans, ctrl.gns, ctrl.stats.full_sweeps, ctrl.stats.warm_sweeps)
    assert out[jc][0] == out[pc][0]
    assert _astuple(out[jc][1]) == _astuple(out[pc][1])
    assert out[jc][2:] == out[pc][2:]


def test_controller_bounds_and_elastic_membership_equal():
    """``test_controller.py``'s cluster_A scenarios: local bounds, fixed
    batch, then nodes leaving and joining mid-run."""
    out = {}
    for sim_mod, ctl_mod in ((jsim, jc), (psim, pc)):
        profiles, comm = sim_mod.cluster_A()
        sim = sim_mod.SimulatedCluster(profiles, comm, noise=0.005, seed=0)
        ctrl = ctl_mod.CannikinController(
            sim.n, batch_candidates=[64, 128, 256, 512], ref_batch=64, min_local=8,
            max_local=200)
        plans = []
        for epoch in range(9):
            if epoch == 5:
                ctrl.remove_nodes([2])
                profiles2, comm2 = sim_mod.cluster_A()
                sim = sim_mod.SimulatedCluster(profiles2[:2], comm2, noise=0.005, seed=1)
            if epoch == 7:
                ctrl.add_nodes(1)
                sim = sim_mod.SimulatedCluster(profiles, comm, noise=0.005, seed=2)
            plan = ctrl.plan_epoch()
            _, ms = sim.run_epoch(list(plan.batches), steps=3)
            ctrl.observe_epoch(ms)
            ctrl.observe_gradients([5.0 + i for i in range(sim.n)], 2.0, list(plan.batches))
            plans.append(_plan(plan))
        out[ctl_mod] = plans
    assert out[jc] == out[pc]


def test_fused_context_after_the_model_is_fitted():
    """No fused context during bootstrap; once the model is fitted, one on
    the asked device with the candidate grid and the water-fill lower
    bracket of the refit model; none again after the membership changes."""
    profiles, comm = psim.cluster_A()
    sim = psim.SimulatedCluster(profiles, comm, noise=0.005, seed=0)
    ctrl = pc.CannikinController(sim.n, batch_candidates=[64, 128, 256], ref_batch=64)
    for epoch in range(3):
        plan = ctrl.plan_epoch()  # run_backend_epoch asks after planning
        assert plan.phase == ("bootstrap" if epoch < 2 else "optperf")
        ctx = ctrl.fused_context(device="cpu")
        assert (ctx is None) == (epoch < 2)
        _, ms = sim.run_epoch(list(plan.batches), steps=3)
        ctrl.observe_epoch(ms)
        ctrl.observe_gradients([5.0, 6.0, 7.0], 2.0, list(plan.batches))
    model = ctrl.cluster_model()
    ctx = ctrl.fused_context(device="cpu")
    assert ctx is not None and ctx.model is model and ctx.ref_batch == 64.0
    assert ctx.coeffs.alphas.device.type == "cpu" and ctx.coeffs.alphas.dtype == torch.float32
    np.testing.assert_array_equal(ctx.candidates_np, [64.0, 128.0, 256.0])
    np.testing.assert_array_equal(ctx.candidates.numpy(), [64.0, 128.0, 256.0])
    assert ctx.lo0 == float(po._problem_from_model(model)[1])
    assert ctrl.fused_context(device="cpu") is ctx
    ctrl.remove_nodes([1])
    assert ctrl.fused_context(device="cpu") is None
    fixed = pc.CannikinController(sim.n, batch_candidates=[64], ref_batch=64, adaptive=False)
    assert fixed.fused_context(device="cpu") is None


def test_baselines_equal():
    out = {}
    for sim_mod, mod in ((jsim, jb), (psim, pb)):
        profiles, comm = sim_mod.cluster_B()
        sim = sim_mod.SimulatedCluster(profiles, comm, noise=0.01, seed=0)
        even, lb = mod.EvenPartition(sim.n), mod.LBBSPPartition(sim.n, delta=5)
        last, parts = None, []
        for epoch in range(6):
            total = 512 if epoch < 4 else 256
            parts.append(even.partition(total, epoch, last))
            batches = lb.partition(total, epoch, last)
            parts.append(batches)
            _, ms = sim.run_epoch(batches, steps=2)
            last = ms[-1]
        out[mod] = parts
    assert out[jb] == out[pb]


def test_synthetic_stream_and_partitioner_equal():
    jdata = jp.SyntheticLM(vocab=512, seq_len=24, seed=0)
    pdata = pp.SyntheticLM(vocab=512, seq_len=24, seed=0)
    for step in (0, 1, 7):
        jbatch, pbatch = jdata.batch(step, 64), pdata.batch(step, 64)
        for key in ("tokens", "labels"):
            assert jbatch[key].dtype == pbatch[key].dtype
            assert jbatch[key].tobytes() == pbatch[key].tobytes()
    sizes = [30, 20, 14]
    jpad, jw = jp.HeteroBatchPartitioner.padded(jbatch, sizes)
    ppad, pw = pp.HeteroBatchPartitioner.padded(pbatch, sizes)
    assert jw.tobytes() == pw.tobytes()
    for key in ("tokens", "labels"):
        assert jpad[key].tobytes() == ppad[key].tobytes()
    jsplit = jp.HeteroBatchPartitioner.split(jbatch, sizes)
    psplit = pp.HeteroBatchPartitioner.split(pbatch, sizes)
    assert [(n.node, n.start, n.size, n.ratio, n.tokens.tobytes()) for n in jsplit] == [
        (n.node, n.start, n.size, n.ratio, n.tokens.tobytes()) for n in psplit]
    with pdata.stream(8, start=2, steps=3) as stream:
        got = [b["tokens"].tobytes() for b in stream]
    assert got == [jdata.batch(s, 8)["tokens"].tobytes() for s in (2, 3, 4)]


def test_jobspec_goodput_equal():
    specs = []
    for sim_mod, mod in ((jsim, js), (psim, ps)):
        profiles, comm = sim_mod.cluster_A()
        model = sim_mod.SimulatedCluster(profiles, comm).true_model()
        specs.append(mod.JobSpec(name="j", node_models=model.nodes, comm=comm,
                                 total_batch=256, b_noise=300.0, ref_batch=64))
    for nodes in ((0, 1, 2), (0, 2), (1,)):
        assert specs[0].goodput(nodes) == specs[1].goodput(nodes)
    assert specs[0].efficiency == specs[1].efficiency
    assert specs[0].solo_goodput() == specs[1].solo_goodput()


def test_transfer_counter():
    tc = TransferCounter()
    tc.count_h2d(3)
    tc.count_d2h()
    assert tc.snapshot() == {"h2d": 3, "d2h": 1, "total": 4}
    tc.reset()
    assert tc.total == 0
