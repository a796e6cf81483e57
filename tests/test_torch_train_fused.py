"""The fused adaptive epoch (``RealBackend.execute_fused`` under
``EpochLoop(fused=True)``) on the CPU: against the port's own two-program
path and against the JAX package's fused epoch.

The reference's ``tests/test_fused_backend.py`` setup: reduced olmo-1b
(float32), 3 nodes (a100, v100, rtx6000 from ``GPU_CATALOG``), seq 16,
candidates 12/24/36 around ref batch 12, SGD at lr 0.3, 7 epochs of 3
steps; two bootstrap epochs, one planned on the host that stages the first
proposal, then four consuming staged proposals.  The port starts from the
reference's ``PRNGKey(0)`` weights, bridged.

Tolerances, port fused vs reference fused: plans (total, per-node batches,
proposal index, transfer counts, certification counts) equal; the sweep's
``t_stars``, ``goodputs`` and winning partition within 1e-5 relative (the
certification bar); the device GNS EMA, its noise scale, losses and
``lr_scale`` within 1e-4 relative, the bar of ``test_torch_train_epoch.py``:
float32 per-node sq-norms summed in another order, carried through the SGD
steps, and differenced in the Theorem-4.1 estimates.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.controller import CannikinController as JaxController  # noqa: E402
from repro.core.perf_model import CommModel as JaxCommModel  # noqa: E402
from repro.core.scheduler import JobSpec as JaxJobSpec  # noqa: E402
from repro.core.simulator import GPU_CATALOG as JAX_GPU_CATALOG  # noqa: E402
from repro.runtime import EpochLoop as JaxEpochLoop  # noqa: E402
from repro.runtime import RealBackendConfig as JaxRealBackendConfig  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.core.controller import FUSED_CERT_TOL, CannikinController  # noqa: E402
from repro_torch.core.perf_model import CommModel  # noqa: E402
from repro_torch.core.scheduler import JobSpec  # noqa: E402
from repro_torch.core.simulator import GPU_CATALOG  # noqa: E402
from repro_torch.runtime.backend import EpochLoop, RealBackendConfig  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

N_EPOCHS = 7
STEPS = 3
REL = 1e-4
NODES = ("a100", "v100", "rtx6000")


def _build(port: bool, *, fused: bool):
    """(controller, backend, loop) in one package, its proposals recorded
    in ``controller.proposals`` as the loop stages them."""
    js, comm, catalog, config, ctl, loop_cls = (
        (JobSpec, CommModel, GPU_CATALOG, RealBackendConfig, CannikinController, EpochLoop)
        if port else
        (JaxJobSpec, JaxCommModel, JAX_GPU_CATALOG, JaxRealBackendConfig, JaxController,
         JaxEpochLoop))
    spec = js(name="fused-job", node_models=tuple(catalog[x].model() for x in NODES),
              comm=comm(t_o=0.04, t_u=0.008, gamma=0.15), total_batch=12, b_noise=500.0,
              ref_batch=12, backend="real")
    kw = {"device": "cpu"} if port else {}
    backend = config(arch="olmo-1b", seq_len=16, lr=0.3, **kw).build(noise=0.0, seed=0)
    backend.configure(spec, tuple(range(3)), seed=1)
    ctrl = ctl(3, batch_candidates=[12, 24, 36], ref_batch=12, adaptive=True, **kw)
    ctrl.proposals = []
    stage = ctrl.stage_fused_proposal

    def record(ctx, proposal):
        ctrl.proposals.append(proposal)
        stage(ctx, proposal)

    ctrl.stage_fused_proposal = record
    return ctrl, backend, loop_cls(ctrl, backend, steps_per_epoch=STEPS, fused=fused)


@pytest.fixture(scope="module")
def reference_weights():
    _, backend, _ = _build(False, fused=False)
    return state_dict_from_tree(jax.tree_util.tree_map(np.asarray, backend.params))


def _port_loop(weights, *, fused: bool):
    ctrl, backend, loop = _build(True, fused=fused)
    backend.params.load_state_dict(weights)
    loop.run(N_EPOCHS)
    return ctrl, backend, loop


@pytest.fixture(scope="module")
def port_runs(reference_weights):
    return {fused: _port_loop(reference_weights, fused=fused) for fused in (False, True)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def test_fused_plans_match_two_program_path(port_runs):
    """``test_fused_plans_match_two_program_path``, on the port: the same
    plan sequence as the two-program loop on the same seeds, every proposal
    certified within 1e-5, and the fused epoch built once."""
    ctrl_two, _, loop_two = port_runs[False]
    ctrl, backend, loop = port_runs[True]
    assert len(loop_two.history) == len(loop.history) == N_EPOCHS
    for a, b in zip(loop_two.history, loop.history):
        assert (a.total_batch, a.batches) == (b.total_batch, b.batches)
        # The fused plan's LR rule runs at the device (float32 EMA) noise
        # scale, the two-program plan's at the host float64 EMA.
        assert b.lr_scale == pytest.approx(a.lr_scale, rel=1e-6)
    assert [r.plan.batch_policy for r in loop.history] == (
        [None, None, "cannikin-gns"] + ["cannikin-gns+fused"] * 4)
    s = ctrl.stats
    assert s.fused_plans == 4 and s.fused_certifications == 5
    assert s.fused_cert_failures == 0 and s.fused_max_rel_err <= FUSED_CERT_TOL
    assert not ctrl._fused_disabled and not ctrl_two.proposals
    np.testing.assert_allclose([r.mean_loss for r in loop.history],
                               [r.mean_loss for r in loop_two.history], rtol=1e-5, atol=1e-6)
    assert list(backend._fused_cache) == [(3, 0)]


def test_fused_epoch_cuts_transfers_per_epoch(port_runs):
    """``test_fused_epoch_cuts_transfers_per_epoch``, on the port, with the
    counts themselves: a fused epoch ships 12 values and pulls 13 however
    many steps it runs; a two-program epoch 4 + 4 per step plus 2."""
    _, backend_two, loop_two = port_runs[False]
    _, backend, loop = port_runs[True]
    for lp in (loop_two, loop):
        lp.steps_per_epoch = 16
    backend_two.transfers.reset()
    backend.transfers.reset()
    loop_two.run_epoch()
    rec = loop.run_epoch()
    assert rec.plan.batch_policy.endswith("+fused")
    two, fused = backend_two.transfers.snapshot(), backend.transfers.snapshot()
    assert (fused["h2d"], fused["d2h"]) == (12, 13)
    assert (two["h2d"], two["d2h"]) == (4 * 16 + 2, 4 * 16)
    assert fused["total"] * 2 <= two["total"]


def test_fused_matches_reference_fused(reference_weights):
    """The port's fused loop against the reference's, from the same
    weights: equal plans and proposals, the sweep within 1e-5, the GNS EMA
    and losses within 1e-4."""
    jctrl, jbackend, jloop = _build(False, fused=True)
    pctrl, pbackend, ploop = _build(True, fused=True)
    pbackend.params.load_state_dict(reference_weights)
    jloop.run(N_EPOCHS)
    ploop.run(N_EPOCHS)

    for a, b in zip(jloop.history, ploop.history):
        assert (b.epoch, b.phase, b.total_batch, b.batches) == (
            a.epoch, a.phase, a.total_batch, a.batches)
        assert (b.plan.batch_policy if b.plan else None) == (
            a.plan.batch_policy if a.plan else None)
        assert b.epoch_seconds == a.epoch_seconds
        assert _rel(b.lr_scale, a.lr_scale) <= REL
        assert _rel(b.mean_loss, a.mean_loss) <= REL
        assert _rel(b.b_noise, a.b_noise) <= REL
    assert len(pctrl.proposals) == len(jctrl.proposals) == 5
    for a, b in zip(jctrl.proposals, pctrl.proposals):
        assert (b.best_index, b.total_batch, b.sweep_iters) == (
            a.best_index, a.total_batch, a.sweep_iters)
        assert _rel(b.t_stars, a.t_stars) <= 1e-5
        assert _rel(b.goodputs, a.goodputs) <= 1e-5
        assert float(np.max(np.abs(b.batches - a.batches))) <= 1e-5 * a.total_batch
        assert _rel(b.b_noise, a.b_noise) <= REL
    assert pbackend.gns.count == jbackend.gns.count == 3 * 7
    assert _rel([pbackend.gns.ema_g, pbackend.gns.ema_s],
                [jbackend.gns.ema_g, jbackend.gns.ema_s]) <= REL
    assert pbackend.transfers.snapshot() == jbackend.transfers.snapshot()
    assert pbackend.steps_done == jbackend.steps_done == N_EPOCHS * STEPS
    js, ps = jctrl.stats, pctrl.stats
    assert (ps.fused_plans, ps.fused_certifications, ps.fused_cert_failures) == (
        js.fused_plans, js.fused_certifications, js.fused_cert_failures)
    assert ps.fused_max_rel_err <= FUSED_CERT_TOL and js.fused_max_rel_err <= FUSED_CERT_TOL


def test_fused_context_lives_on_the_backend_device(port_runs):
    """``run_backend_epoch`` asks for the context on the backend's device;
    one built for another device is refused, never copied."""
    ctrl, backend, _ = port_runs[True]
    ctrl.cluster_model()  # refit, as the next plan_epoch would
    ctx = ctrl.fused_context(device=backend.device)
    assert ctx.coeffs.alphas.device == backend.device == ctx.candidates.device
    assert ctrl.fused_context(device=backend.device) is ctx

    meta = dataclasses.replace(ctx, candidates=ctx.candidates.to("meta"))
    with pytest.raises(ValueError, match="fused sweep context"):
        backend.execute_fused([4, 4, 4], 1, ctx=meta)
