"""Port serving stack vs the JAX package.

* ``SimServingEngine`` runs on the two-speed-class cluster of
  ``tests/test_serving.py``: the port's fingerprint and summary equal the
  reference's (``==``), which holds optperf, perf_model, allocator, queue,
  metrics and the event loop to bit-identity.
* ``RealServingEngine`` on reduced olmo-1b, with weights bridged from the
  JAX init, serves a seeded workload through a ``NodeLeave`` with zero
  drops, and every request's token stream equals the JAX engine's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serving as jax_serving  # noqa: E402
from repro.runtime.events import NodeJoin as JaxNodeJoin  # noqa: E402
from repro.runtime.events import NodeLeave as JaxNodeLeave  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.runtime.events import NodeJoin, NodeLeave  # noqa: E402

TWO_CLASS = {i: (0.004, 0.03) for i in range(3)}
TWO_CLASS.update({i: (0.032, 0.03) for i in range(3, 8)})
GATE_WORKLOAD = dict(seed=7, rate=56.0, gen_mean=8, gen_max=64,
                     token_budget=0.12, ttft_slack=1.0)


def _run_two_class(pkg, leave, join, mode, n=400, churn=False):
    wl = pkg.generate_requests(n, **GATE_WORKLOAD)
    engine = pkg.SimServingEngine(dict(TWO_CLASS))
    alloc = pkg.ServingAllocator(dict(TWO_CLASS), total_slots=32, mode=mode)
    cfg = pkg.ServingConfig(total_slots=32, resolve_every=1.0)
    rt = pkg.ServingRuntime(engine, alloc, wl, nodes=list(range(8)), config=cfg)
    if churn:
        rt.post(leave(time=wl.requests[50].arrival, nodes=(0, 4)))
        rt.post(join(time=wl.requests[200].arrival, nodes=(0,)))
    return rt.run()


@pytest.mark.parametrize(
    "mode, churn", [("optperf", False), ("uniform", False), ("optperf", True)]
)
def test_sim_runtime_bit_identical_to_reference(mode, churn):
    want = _run_two_class(jax_serving, JaxNodeLeave, JaxNodeJoin, mode, churn=churn)
    got = _run_two_class(serving, NodeLeave, NodeJoin, mode, churn=churn)
    assert got.fingerprint == want.fingerprint
    assert got.summary == want.summary
    assert got.counters == want.counters
    assert got.allocations == want.allocations
    assert got.summary["dropped"] == 0


def test_workload_generator_identical_to_reference():
    kw = dict(seed=3, arrival="bursty", prompt_min=4, prompt_max=32, gen_min=2, gen_max=16)
    want = jax_serving.generate_requests(60, **kw)
    got = serving.generate_requests(60, **kw)
    fields = lambda r: (r.rid, r.arrival, r.prompt_len, r.gen_len, r.deadline)  # noqa: E731
    assert [fields(r) for r in got] == [fields(r) for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.prompt_tokens(512), b.prompt_tokens(512))


def test_churn_events_describe_like_reference():
    from repro.runtime.events import describe as jax_describe
    from repro_torch.runtime.events import describe

    for port_ev, ref_ev in [
        (NodeLeave(time=1.0, nodes=(1, 2)), JaxNodeLeave(time=1.0, nodes=(1, 2))),
        (NodeJoin(time=2.0, nodes=(3,)), JaxNodeJoin(time=2.0, nodes=(3,))),
    ]:
        assert describe(port_ev) == jax_describe(ref_ev)


def _recording(base):
    class Recording(base):
        """Keeps each request's final token stream at completion."""

        streams = None

        def release(self, ar):
            if self.streams is None:
                self.streams = {}
            self.streams[ar.rid] = list(ar.tokens)
            super().release(ar)

    return Recording


@pytest.mark.slow
def test_real_engine_streams_match_reference_under_churn():
    jax = pytest.importorskip("jax")
    from repro.configs import get_api as jax_get_api
    from repro_torch.bridge import state_dict_from_tree
    from repro_torch.configs import get_api

    jax_api = jax_get_api("olmo-1b", reduced=True)
    params = jax_api.init(jax.random.PRNGKey(0))
    port_api = get_api("olmo-1b", reduced=True)
    model = port_api.load(
        state_dict_from_tree(jax.tree_util.tree_map(np.asarray, params)), device="cpu"
    )

    def run(pkg, engine, leave):
        wl = pkg.generate_requests(
            8, seed=5, rate=50.0, prompt_min=8, prompt_max=8,
            gen_min=2, gen_max=6, gen_mean=4, token_budget=10.0,
        )
        coeffs = {0: (0.01, 0.01), 1: (0.01, 0.01)}
        rt = pkg.ServingRuntime(
            engine, pkg.ServingAllocator(dict(coeffs), total_slots=4), wl,
            nodes=[0, 1], config=pkg.ServingConfig(total_slots=4),
        )
        rt.post(leave(time=wl.requests[2].arrival, nodes=(1,)))
        return wl, rt.run(), engine.streams

    jax_engine = _recording(jax_serving.RealServingEngine)(jax_api, params, max_len=32)
    port_engine = _recording(serving.RealServingEngine)(port_api, model, max_len=32, device="cpu")
    wl, want_rep, want = run(jax_serving, jax_engine, JaxNodeLeave)
    _, rep, got = run(serving, port_engine, NodeLeave)
    assert rep.summary["dropped"] == 0 and want_rep.summary["dropped"] == 0
    assert rep.summary["completed"] == 8
    assert rep.counters["leaves"] == 1
    for req in wl:
        assert len(got[req.rid]) == req.gen_len
        assert all(0 <= t < port_api.cfg.vocab for t in got[req.rid])
    assert got == want
