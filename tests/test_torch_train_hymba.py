"""Training hymba in the port vs the JAX package, float32 on the CPU.

The 4-layer variant of reduced hymba-1.5b (``test_torch_hymba._pair``:
float32 on both sides, global layers (0, 2, 3), window 16, the zero- and
one-initialised leaves seeded) at seq 32, so the window binds in layer 1
and the scan runs four chunks of 8.  ``ModelApi.loss`` within 1e-5
relative and one node's gradient (per-sample weights as the mask) within
1e-4 x max(1, max |g|) per leaf against ``jax.grad`` of the reference's
loss; one two-program ``EpochLoop`` epoch on ``cluster_A`` whose plans and
simulated clock equal the reference's; a ``RealBackend`` checkpoint round
trip, bitwise.  The plain scan backward (``ssm_scan_backward_ref``, the
backward kernel's oracle) against torch autograd through
``selective_scan_ref`` and against ``jax.grad`` of the reference's
``selective_scan``: ragged T, the final state's gradient zero and nonzero,
moderate decays, within 1e-4 x max(1, max |g|) (float32 sums in another
order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.controller import CannikinController as JaxController  # noqa: E402
from repro.core.simulator import SimulatedCluster as JaxCluster  # noqa: E402
from repro.core.simulator import cluster_A as jax_cluster_A  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models.hymba import selective_scan as jax_selective_scan  # noqa: E402
from repro.optim.optimizers import constant_schedule as jax_constant  # noqa: E402
from repro.optim.optimizers import sgd as jax_sgd  # noqa: E402
from repro.runtime.backend import run_backend_epoch as jax_run_backend_epoch  # noqa: E402
from repro.train.hetero import HeteroTrainer as JaxHeteroTrainer  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.core.controller import CannikinController  # noqa: E402
from repro_torch.core.simulator import SimulatedCluster, cluster_A  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    selective_scan_ref, ssm_scan, ssm_scan_backward_ref,
)
from repro_torch.optim.optimizers import constant_schedule, sgd  # noqa: E402
from repro_torch.runtime.backend import RealBackendConfig  # noqa: E402
from repro_torch.train.hetero import HeteroTrainer  # noqa: E402
from test_torch_hymba import _f32_pair, _seeded_tree  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

SEQ = 32
LOSS_REL = 1e-5
GRAD_REL = 1e-4  # x max(1, max |g|), per leaf
STEPS = 1


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One CPU thread for the module: multi-threaded CPU BLAS differs in the
    last bits from run to run (the checkpoint round trip compares bits), and
    the plain recurrences' small ops run faster on one thread than on
    threads contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(vocab, b=3, seed=5):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, SEQ)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, SEQ)).astype(np.int32),
            "weights": np.asarray([1.0, 1.0, 0.0], np.float32)[:b]}


def _assert_grads_close(got, want, names):
    for name in names:
        w = want[name].numpy()
        tol = GRAD_REL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[name].numpy(), w, atol=tol, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def loss_case():
    """The reference's loss and gradient on bridged weights (computed once)
    and the port's model holding the same weights."""
    jax_api, api = _f32_pair()
    tree = _seeded_tree(jax_api)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    batch = _batch(api.cfg.vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jax_api.loss(p, jbatch)[0]))(params)
    want = state_dict_from_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    model = api.load(state_dict_from_tree(tree), device="cpu").requires_grad_(True)
    return api, model, batch, float(jloss), want


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_node_gradient_match_reference(loss_case, remat):
    """``ModelApi.loss`` and one node's gradient of it (``RealBackend``'s
    per-node step), with and without per-layer recomputation."""
    api, model, batch, jloss, want = loss_case
    assert api.supports_training()
    model.cfg = dataclasses.replace(api.cfg, remat=remat)
    try:
        loss, _ = api.loss(model, batch)
        names = [n for n, _ in model.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    finally:
        model.cfg = api.cfg
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=LOSS_REL)
    _assert_grads_close(grads, want, names)


def test_seams_take_the_plain_versions(loss_case):
    """``train_forward(attend=attention_ref, scan=...)`` replaces the
    flash-attention and scan entries (the seams the card's gradient check
    uses) and gives the same logits."""
    api, model, batch, _, _ = loss_case
    assert api.cfg.global_layers() == (0, 2, 3) and api.cfg.window < SEQ
    with torch.no_grad():
        default = model.train_forward(batch["tokens"])
        seam = model.train_forward(
            batch["tokens"], attend=attention_ref,
            scan=lambda u, dt, b_t, c_t, log_a, chunk: selective_scan_ref(u, dt, log_a, b_t, c_t))
    assert torch.equal(default, seam)


def _trainers():
    """(reference trainer, port trainer) of the 4-layer float32 hymba on
    cluster_A from the reference's weights."""
    jax_api, api = _f32_pair()
    trainers = []
    for api_, cluster, ctl, lm, opt, cls, kw in (
        (jax_api, (JaxCluster, jax_cluster_A), JaxController, JaxSyntheticLM,
         jax_sgd(jax_constant(0.3)), JaxHeteroTrainer, {}),
        (api, (SimulatedCluster, cluster_A), CannikinController, SyntheticLM,
         sgd(constant_schedule(0.3)), HeteroTrainer, {"device": "cpu"}),
    ):
        profiles, comm = cluster[1]()
        sim = cluster[0](profiles, comm, noise=0.01, seed=0)
        policy = ctl(sim.n, batch_candidates=[8, 16, 32], ref_batch=8)
        data = lm(vocab=api_.cfg.vocab, seq_len=SEQ, seed=0)
        trainers.append(cls(api_, opt, sim, policy, data, steps_per_epoch=STEPS, **kw))
    jtr, ptr = trainers
    tree = jax.tree_util.tree_map(np.asarray, jtr.backend.params)
    ptr.backend.params.load_state_dict(state_dict_from_tree(tree))
    return jtr, ptr


def test_two_program_epoch_plans_and_clock_equal_reference():
    jtr, ptr = _trainers()
    jrec, jres = jax_run_backend_epoch(jtr.policy, jtr.backend, steps=STEPS, epoch_index=0)
    prec = ptr.run_epoch()
    pres = ptr.loop.last_result
    assert (prec.epoch, prec.phase, prec.total_batch, prec.batches) == (
        jrec.epoch, jrec.phase, jrec.total_batch, jrec.batches)
    assert prec.sim_seconds == jrec.epoch_seconds
    assert ptr.sim_time == jtr.backend.sim_time
    assert pres.grad_anomalies == jres.grad_anomalies == (0, 0, 0)
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=1e-4)


def test_backend_checkpoint_round_trip_is_bitwise(tmp_path):
    """A runtime job's backend (``RealBackendConfig(arch=...)``: the reduced
    published config, bf16) through ``checkpoint`` / ``restore``: the epoch
    after a restore gives the same losses and parameters, bit for bit."""
    backend = RealBackendConfig(arch="hymba-1.5b", seq_len=SEQ, device="cpu").build(seed=0)
    assert backend.api.cfg.param_dtype == torch.bfloat16
    backend.cluster = SimulatedCluster(*cluster_A(), noise=0.0, seed=0)
    backend.execute([2, 2, 2], 1)
    path = str(tmp_path / "hymba.ckpt.npz")
    backend.checkpoint(path)
    first = backend.execute([3, 2, 1], 1)
    after = {k: v.detach().clone() for k, v in backend.named.items()}
    backend.restore(path)
    again = backend.execute([3, 2, 1], 1)
    assert again.losses == first.losses
    assert all(torch.equal(v, after[k]) for k, v in backend.named.items())


# ---------------------------------------------------------------------------
# the plain scan backward
# ---------------------------------------------------------------------------

B, T, D, N, CHUNK = 2, 37, 6, 4, 16   # T = 2 chunks of 16 and a ragged 5


@pytest.fixture(scope="module")
def scan_inputs():
    rng = np.random.default_rng(12)
    u = rng.standard_normal((B, T, D)).astype(np.float32)
    dt = (np.exp(rng.standard_normal((B, T, D)) * 0.5) * 0.3).astype(np.float32)
    b_t, c_t = (rng.standard_normal((B, T, N)).astype(np.float32) for _ in range(2))
    log_a = (rng.standard_normal((D, N)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((B, T, D)).astype(np.float32)
    dh = rng.standard_normal((B, D, N)).astype(np.float32)
    return (u, dt, b_t, c_t, log_a), dy, dh


@pytest.fixture(scope="module")
def scan_jax_grads(scan_inputs):
    """jax.grad of the reference's selective_scan, final-state gradient
    zero and nonzero (computed once), in ssm_scan's argument order."""
    (u, dt, b_t, c_t, log_a), dy, dh = scan_inputs

    def grads(dh_):
        def f(u, dt, b_t, c_t, log_a):
            y, h = jax_selective_scan(u, dt, log_a, b_t, c_t, chunk=CHUNK)
            return jnp.sum(y * dy) + jnp.sum(h * dh_)
        return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=tuple(range(5))))(
            u, dt, b_t, c_t, log_a)]

    return {"zero": grads(np.zeros_like(dh)), "nonzero": grads(dh)}


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=GRAD_REL * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("final", ["zero", "nonzero"])
def test_scan_backward_ref_matches_autograd_and_jax(scan_inputs, scan_jax_grads, final):
    args, dy, dh = scan_inputs
    leaves = [torch.from_numpy(x).requires_grad_() for x in args]
    dy_t = torch.from_numpy(dy)
    dh_t = torch.from_numpy(dh) if final == "nonzero" else None
    got = ssm_scan_backward_ref(*[x.detach() for x in leaves], dy_t, dh_t)
    u, dt, b_t, c_t, log_a = leaves
    y, h = selective_scan_ref(u, dt, log_a, b_t, c_t)
    loss = (y * dy_t).sum() + ((h * dh_t).sum() if dh_t is not None else 0.0)
    _close([g.numpy() for g in got], [g.numpy() for g in torch.autograd.grad(loss, leaves)])
    _close([g.numpy() for g in got], scan_jax_grads[final])


def test_ssm_scan_differentiates_through_the_plain_version_on_the_cpu(scan_inputs):
    """On CPU tensors ``ssm_scan`` is the plain recurrence under autograd."""
    args, dy, _ = scan_inputs
    leaves = [torch.from_numpy(x).requires_grad_() for x in args]
    y, _ = ssm_scan(*leaves, chunk=CHUNK)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    want = ssm_scan_backward_ref(*[x.detach() for x in leaves], torch.from_numpy(dy))
    _close([g.numpy() for g in got], [w.numpy() for w in want])
