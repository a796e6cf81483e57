"""The port's on-device OptPerf sweep (``core/optperf_torch.py``) vs the JAX
package's (``core/optperf_jax.py``, called directly: its own test module
does not collect on this image) and the NumPy float64 oracle
(``core/optperf.py``), on the CPU.

Both device sweeps run in float32.  ``t_stars`` agree within 1e-5 relative
with the reference and the oracle at every cluster size.  Where both
engines add a row's nodes in the same order (n = 2 and 3 here, the fused
path's size), their float32 sums are the same bits, so ``t_stars``, the
finalized batches and ``iterations`` are equal.  For longer rows torch and
XLA reduce in different orders, ``t_stars`` move by a few float32 ulps
(under 1e-6 relative), the float64 finalizer turns that into batches
within 1e-5 relative, and ``iterations`` may differ by one: a float64
polish step on either side of the certification boundary, or in a warm
sweep one bisection trip on either side of the convergence test.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import optperf as jo  # noqa: E402
from repro.core import optperf_jax as jx  # noqa: E402
from repro.core import perf_model as jpm  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro_torch.core import optperf as po  # noqa: E402
from repro_torch.core import optperf_torch as pt  # noqa: E402
from repro_torch.core import perf_model as ppm  # noqa: E402
from repro_torch.core.controller import CannikinController  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

pg = importlib.import_module("repro_torch.core.goodput")

REL = 1e-5
SIZES = [2, 3, 16, 64, 256]
SAME_ORDER = (2, 3)  # sizes at which torch and XLA sum a row in one order


def _cluster(rng, n):
    """The same random cluster in both packages (the reference tests' draw)."""
    nodes = [dict(q=float(rng.uniform(1e-4, 8e-3)), s=float(rng.uniform(0.0, 0.02)),
                  k=float(rng.uniform(1e-4, 8e-3)), m=float(rng.uniform(0.0, 0.02)))
             for _ in range(n)]
    comm = dict(t_o=float(10.0 ** rng.uniform(-4, -1)), t_u=float(rng.uniform(0.0, 0.02)),
                gamma=float(rng.uniform(0.02, 0.6)))
    return (jpm.ClusterPerfModel(nodes=tuple(jpm.NodePerfModel(**d) for d in nodes),
                                 comm=jpm.CommModel(**comm)),
            ppm.ClusterPerfModel(nodes=tuple(ppm.NodePerfModel(**d) for d in nodes),
                                 comm=ppm.CommModel(**comm)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _hold(port, ref, oracle, n, totals, iter_slack):
    assert _rel(port.t_stars, ref.t_stars) <= REL
    assert _rel(port.t_stars, oracle.t_stars) <= REL
    assert _rel(port.opt_perfs, oracle.opt_perfs) <= REL
    np.testing.assert_allclose(port.batches.sum(axis=1), totals, rtol=1e-12)
    if n in SAME_ORDER:
        np.testing.assert_array_equal(port.t_stars, ref.t_stars)
        np.testing.assert_array_equal(port.batches, ref.batches)
        assert port.iterations == ref.iterations
    else:
        scale = np.asarray(totals, np.float64)[:, None]
        assert float(np.max(np.abs(port.batches - ref.batches) / scale)) <= REL
        assert abs(port.iterations - ref.iterations) <= iter_slack


@pytest.mark.parametrize("n", SIZES)
def test_cold_sweep_matches_reference_and_oracle(n):
    for seed in range(5):
        rng = np.random.default_rng(1000 * n + seed)
        jm, pm = _cluster(rng, n)
        cands = np.unique(np.round(rng.uniform(8, 8192, size=5)))
        ref = jx.solve_optperf_batch_jax(jm, cands)
        port = pt.solve_optperf_batch_jax(pm, cands, device="cpu")
        assert port.method == ref.method == "waterfill/jax"
        _hold(port, ref, jo.solve_optperf_batch(jm, cands), n, cands, iter_slack=1)


@pytest.mark.parametrize("factor", [1.0 + 1e-4, 1.2, 10.0], ids=["near", "drifted", "stale"])
@pytest.mark.parametrize("n", SIZES)
def test_warm_sweep_matches_reference_and_oracle(n, factor):
    """Warm seeds near the optimum, 20 % off, and 10x off (a stale seed the
    sweep resets and re-converges from)."""
    for seed in range(3):
        rng = np.random.default_rng(1000 * n + seed)
        jm, pm = _cluster(rng, n)
        cands = np.unique(np.round(rng.uniform(8, 8192, size=5)))
        warm = jo.solve_optperf_batch(jm, cands).t_stars * factor
        ref = jx.solve_optperf_batch_jax(jm, cands, warm_start=warm)
        port = pt.solve_optperf_batch_jax(pm, cands, warm_start=warm, device="cpu")
        assert port.method == ref.method == "waterfill/jax+warm"
        _hold(port, ref, jo.solve_optperf_batch(jm, cands), n, cands, iter_slack=1)


def test_warm_start_shape_mismatch_raises():
    _, pm = _cluster(np.random.default_rng(0), 4)
    with pytest.raises(ValueError):
        pt.solve_optperf_batch_jax(pm, [64.0, 128.0], warm_start=np.ones(3), device="cpu")


def test_float64_sweep_matches_oracle():
    jm, pm = _cluster(np.random.default_rng(5), 16)
    cands = np.array([64.0, 512.0, 4096.0])
    port = pt.solve_optperf_batch_jax(pm, cands, dtype=torch.float64, device="cpu")
    assert _rel(port.opt_perfs, jo.solve_optperf_batch(jm, cands).opt_perfs) <= 1e-9


@pytest.mark.parametrize("n", [3, 16])
def test_sweep_partition_and_node_times_match_reference(n):
    """The fused epoch's device calls, as its program makes them: the cold
    sweep, the partition at each candidate's t_star and the realized
    OptPerf (max node time), against the same calls of the reference."""
    jm, pm = _cluster(np.random.default_rng(42 + n), n)
    cands = np.array([16.0, 32.0, 64.0, 300.0])
    _, lo0 = po._problem_from_model(pm)
    jdc = jx.device_coeffs(jm)
    jt, jiters = jx.solve_optperf_sweep_device(jdc, jax.numpy.asarray(cands, "float32"), lo0)
    jparts = jx.device_partition(jdc, jt[:, None], jax.numpy.asarray(cands, "float32"))
    jtimes = jx.device_node_times(jdc, jparts)

    pdc = pt.device_coeffs(pm, device="cpu")
    cand = torch.as_tensor(cands, dtype=torch.float32)
    pts, piters = pt.solve_optperf_sweep_device(pdc, cand, torch.tensor(lo0, dtype=torch.float32))
    pparts = pt.device_partition(pdc, pts[:, None], cand)
    ptimes = pt.device_node_times(pdc, pparts)

    assert piters == int(jiters) == 64
    # Partitions are compared relative to their candidate total: a node
    # near its clamp holds a small difference of large times.
    scales = (np.asarray(jt), cands[:, None], np.asarray(jtimes))
    for got, want, scale in zip((pts, pparts, ptimes), (jt, jparts, jtimes), scales):
        got, want = got.numpy(), np.asarray(want)
        if n in SAME_ORDER:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.max(np.abs(got - want) / scale) <= REL
    # Against float64 host math on the same t_stars.
    c = pm.coeffs
    t = pts.numpy().astype(np.float64)[:, None]
    b = np.maximum(np.minimum((t - pm.comm.t_u - c.cs) / c.alphas,
                              (t - pm.comm.t_comm - c.ds) / c.betas), 0.0)
    b = b * (cands[:, None] / b.sum(axis=1, keepdims=True))
    assert np.max(np.abs(pparts.numpy() - b) / cands[:, None]) <= REL
    times = np.stack([pm.node_times(row) for row in b])
    assert _rel(ptimes.numpy(), times) <= REL


def test_degenerate_beta_node_on_device():
    """q = 0, gamma = 0 makes beta = 0 (syncStart flat in b): the device
    sweep's +-inf handling matches the reference and the host engine."""
    nodes = [dict(q=0.0, s=0.01, k=2e-3, m=0.01), dict(q=1e-3, s=0.0, k=1e-3, m=0.0)]
    comm = dict(t_o=0.02, t_u=0.005, gamma=0.0)
    jm = jpm.ClusterPerfModel(nodes=tuple(jpm.NodePerfModel(**d) for d in nodes),
                              comm=jpm.CommModel(**comm))
    pm = ppm.ClusterPerfModel(nodes=tuple(ppm.NodePerfModel(**d) for d in nodes),
                              comm=ppm.CommModel(**comm))
    cands = np.asarray([64.0, 512.0])
    port = pt.solve_optperf_batch_jax(pm, cands, device="cpu")
    np.testing.assert_array_equal(port.t_stars, jx.solve_optperf_batch_jax(jm, cands).t_stars)
    assert _rel(port.opt_perfs, jo.solve_optperf_batch(jm, cands).opt_perfs) <= REL


# ---------------------------------------------------------------------------
# export caches: stamps, eviction, the LRU bound
# ---------------------------------------------------------------------------


def test_device_coeffs_cached_and_keyed_on_dtype():
    _, pm = _cluster(np.random.default_rng(7), 6)
    a = pt.device_coeffs(pm, device="cpu")
    assert pt.device_coeffs(pm, device="cpu") is a
    assert a.alphas.dtype == torch.float32 and a.alphas.shape == (6,)
    c = pt.device_coeffs(pm, dtype=torch.float64, device="cpu")
    assert c is not a and c.alphas.dtype == torch.float64
    np.testing.assert_allclose(c.alphas.numpy(), pm.coeffs.alphas, rtol=1e-15)
    assert pt.evict_device_coeffs(pm) == 2
    assert pt.evict_device_coeffs(pm) == 0
    assert pt.device_coeffs(pm, device="cpu") is not a


def test_inplace_refresh_trips_model_stamp():
    """The reference's stale-cache scenario in both packages: nodes refitted
    in place (bypassing the frozen dataclass) with the host memos dropped
    but the device export not evicted.  The stamp recorded at export time
    trips a re-export, and both sweeps solve the new numbers alike."""
    jm, pm = _cluster(np.random.default_rng(11), 5)
    cands = np.asarray([64.0, 256.0, 1024.0])
    before = pt.solve_optperf_batch_jax(pm, cands, device="cpu")
    stale = pt.device_coeffs(pm, device="cpu")
    assert pt.model_stamp(pm) == jx.model_stamp(jm)
    for model in (jm, pm):
        for node in model.nodes:
            object.__setattr__(node, "q", node.q * 2.0)
            object.__setattr__(node, "k", node.k * 2.0)
        for slot in ("coeffs", "_optperf_problem", "_validated"):
            model.__dict__.pop(slot, None)
    after = pt.solve_optperf_batch_jax(pm, cands, device="cpu")
    assert pt.device_coeffs(pm, device="cpu") is not stale
    assert _rel(after.opt_perfs, po.solve_optperf_batch(pm, cands).opt_perfs) <= REL
    assert float(np.min(after.opt_perfs / before.opt_perfs)) > 1.3
    np.testing.assert_array_equal(after.t_stars, jx.solve_optperf_batch_jax(jm, cands).t_stars)


def test_export_cache_is_lru_bounded():
    pt._DEVICE_COEFFS.clear()
    rng = np.random.default_rng(13)
    models = [_cluster(rng, 2)[1] for _ in range(pt._DEVICE_COEFFS_LIMIT + 5)]
    first = pt.device_coeffs(models[0], device="cpu")
    for m in models[1:]:
        pt.device_coeffs(m, device="cpu")
        pt.device_coeffs(models[0], device="cpu")  # keep the first one fresh
    assert len(pt._DEVICE_COEFFS) == pt._DEVICE_COEFFS_LIMIT
    assert pt.device_coeffs(models[0], device="cpu") is first
    assert (models[1], "float32", "cpu") not in pt._DEVICE_COEFFS


def test_controller_evicts_exports_on_membership_change():
    """``sweep_engine="jax"`` prefetches the refit model's export; removing
    or adding nodes evicts it and drops any staged fused state."""
    from repro_torch.core.simulator import SimulatedCluster, cluster_A

    profiles, comm = cluster_A()
    sim = SimulatedCluster(profiles, comm, noise=0.01, seed=0)
    ctrl = CannikinController(sim.n, batch_candidates=[64, 128, 256], ref_batch=64,
                              sweep_engine="jax", device="cpu")
    for _ in range(3):
        plan = ctrl.plan_epoch()
        _, ms = sim.run_epoch(list(plan.batches), steps=3)
        ctrl.observe_epoch(ms)
        ctrl.observe_gradients([5.0, 6.0, 7.0], 2.0, list(plan.batches))
    model = ctrl.cluster_model()
    assert any(key[0] is model for key in pt._DEVICE_COEFFS)
    ctx = ctrl.fused_context()
    assert ctx is not None and ctx.coeffs.alphas.device.type == "cpu"
    ctrl.remove_nodes([2])
    assert not any(key[0] is model for key in pt._DEVICE_COEFFS)
    assert ctrl._fused_ctx is None and ctrl._fused_pending is None


# ---------------------------------------------------------------------------
# the stacked pair
# ---------------------------------------------------------------------------


def _ragged(rng, rows):
    """``test_optperf_stacked_jax.py``'s ragged padded stack (row sizes
    log-uniform in [2, 256]), built in both packages from one draw."""
    sizes = np.unique(np.round(2.0 ** rng.uniform(1.0, 8.0, size=rows)).astype(int))
    rng.shuffle(sizes)
    pairs = [_cluster(rng, int(n)) for n in sizes[:rows]]
    while len(pairs) < rows:
        pairs.append(_cluster(rng, int(rng.integers(2, 17))))
    totals = rng.uniform(32.0, 8192.0, size=rows)
    return (jpm.StackedClusterModel.from_models([p[0] for p in pairs]),
            ppm.StackedClusterModel.from_models([p[1] for p in pairs]), totals)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_stacked_matches_reference_on_ragged_clusters(warm):
    for seed in range(10):
        rng = np.random.default_rng(9000 + seed)
        jstack, pstack, totals = _ragged(rng, rows=10)
        oracle = jo.solve_optperf_stacked(jstack, totals)
        kw = {"warm_start": oracle.t_stars * 1.05} if warm else {}
        ref = jx.solve_optperf_stacked_jax(jstack, totals, **kw)
        port = pt.solve_optperf_stacked_jax(pstack, totals, device="cpu", **kw)
        assert port.method == ref.method
        assert _rel(port.t_stars, ref.t_stars) <= REL
        assert _rel(port.opt_perfs, oracle.opt_perfs) <= REL
        np.testing.assert_array_equal(port.node_mask, ref.node_mask)
        np.testing.assert_allclose(port.batches.sum(axis=1), totals, rtol=1e-12)
        assert not np.any(port.batches[~port.node_mask])
        assert abs(port.iterations - ref.iterations) <= 1


def test_stacked_export_cached_and_stamp_rechecked():
    """A stack's export is cached on the instance; refreshing its arrays in
    place without ``invalidate_device_cache()`` trips the stamp."""
    _, pstack, totals = _ragged(np.random.default_rng(83), rows=4)
    mutable = {name: np.array(getattr(pstack, name))
               for name in ("alphas", "cs", "betas", "ds", "ks", "ms")}
    stack = ppm.StackedClusterModel(t_o=pstack.t_o, t_u=pstack.t_u, gamma=pstack.gamma,
                                    mask=pstack.mask, **mutable)
    stale = pt.stacked_device_coeffs(stack, device="cpu")
    assert pt.stacked_device_coeffs(stack, device="cpu") is stale
    assert stale.t_u.shape == (4, 1) and stale.mask.dtype == torch.bool
    before = pt.solve_optperf_stacked_jax(stack, totals, device="cpu")
    for name in ("alphas", "cs", "betas", "ds"):
        mutable[name] *= 2.0
    after = pt.solve_optperf_stacked_jax(stack, totals, device="cpu")
    assert pt.stacked_device_coeffs(stack, device="cpu") is not stale
    assert _rel(after.opt_perfs, po.solve_optperf_stacked(stack, totals).opt_perfs) <= REL
    assert float(np.min(after.opt_perfs / before.opt_perfs)) > 1.5
    with pytest.raises(ValueError):
        pt.solve_optperf_stacked_jax(stack, totals[:2], device="cpu")


def test_stacked_scheduler_rows_match_reference():
    """A scheduler round's stack: the reference's ``random_jobs`` on the GPU
    catalog, each job on a node subset of its own size, solved by both
    stacked device engines."""
    jobs = jsched.random_jobs(6, 8, seed=2)
    models = [jpm.ClusterPerfModel(nodes=job.node_models[: 2 + j], comm=job.comm)
              for j, job in enumerate(jobs)]
    jstack = jpm.StackedClusterModel.from_models(models)
    pstack = ppm.StackedClusterModel(**{f: np.array(getattr(jstack, f))
                                        for f in ("alphas", "cs", "betas", "ds", "ks", "ms",
                                                  "t_o", "t_u", "gamma", "mask")})
    totals = np.array([float(job.total_batch) for job in jobs])
    ref = jx.solve_optperf_stacked_jax(jstack, totals)
    port = pt.solve_optperf_stacked_jax(pstack, totals, device="cpu")
    assert _rel(port.t_stars, ref.t_stars) <= REL
    assert _rel(port.opt_perfs, jo.solve_optperf_stacked(jstack, totals).opt_perfs) <= REL


# ---------------------------------------------------------------------------
# the "jax" engine name: the on-device sweep behind goodput and the selector
# ---------------------------------------------------------------------------


def test_goodput_curve_jax_engine_matches_reference():
    jm, pm = _cluster(np.random.default_rng(21), 8)
    cands = [64, 128, 256, 512, 1024]
    jg = importlib.import_module("repro.core.goodput")
    ref = jg.goodput_curve(jm, cands, 300.0, 64, engine="jax")
    port = pg.goodput_curve(pm, cands, 300.0, 64, engine="jax", device="cpu")
    assert port.solutions.method == "waterfill/jax"
    assert _rel(port.goodputs, ref.goodputs) <= REL
    assert port.best_index() == ref.best_index()


def test_selector_jax_engine_plans_like_batched():
    _, pm = _cluster(np.random.default_rng(17), 8)
    cands = (64, 128, 256, 512)
    out = {}
    for engine in ("batched", "jax"):
        sel = pg.BatchSizeSelector(candidates=cands, ref_batch=64, engine=engine, device="cpu")
        out[engine] = [(b, sol.batches) for b, sol, _ in
                       (sel.select(pm, bn) for bn in (100.0, 2000.0, 30.0))]
        out[engine + "_sweeps"] = (sel.full_sweeps, sel.cold_sweeps, sel.warm_sweeps)
    assert out["jax"] == out["batched"]
    assert out["jax_sweeps"] == out["batched_sweeps"]
