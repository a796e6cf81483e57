"""Training rwkv6 in the port vs the JAX package, float32 on the CPU.

Reduced rwkv6-7b (float32 variants on both sides, the zero-initialised
leaves seeded: ``test_torch_rwkv6._seeded_tree``) at seq 32, so the WKV
recurrence runs two chunks of 16.  ``ModelApi.loss`` within 1e-5
relative and one node's gradient (per-sample weights as the mask) within
1e-4 x max(1, max |g|) per leaf against ``jax.grad`` of the reference's
loss; one two-program ``EpochLoop`` epoch on ``cluster_A`` whose plans and
simulated clock equal the reference's; a ``RealBackend`` checkpoint round
trip, bitwise.  The plain WKV backward (``wkv_backward_ref``, the backward
kernel's oracle) against torch autograd through ``wkv_chunked`` and
against ``jax.grad`` of the reference's ``wkv_chunked``: ragged T, the
final state's gradient zero and nonzero, moderate decays, within 1e-4 x
max(1, max |g|) (float32 sums in another order).
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
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked  # noqa: E402
from repro.optim.optimizers import constant_schedule as jax_constant  # noqa: E402
from repro.optim.optimizers import sgd as jax_sgd  # noqa: E402
from repro.runtime.backend import run_backend_epoch as jax_run_backend_epoch  # noqa: E402
from repro.train.hetero import HeteroTrainer as JaxHeteroTrainer  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.core.controller import CannikinController  # noqa: E402
from repro_torch.core.simulator import SimulatedCluster, cluster_A  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import wkv, wkv_backward_ref, wkv_chunked  # noqa: E402
from repro_torch.optim.optimizers import constant_schedule, sgd  # noqa: E402
from repro_torch.runtime.backend import RealBackendConfig  # noqa: E402
from repro_torch.train.hetero import HeteroTrainer  # noqa: E402
from test_torch_rwkv6 import _f32_pair, _seeded_tree  # noqa: E402

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


def test_scan_seam_takes_the_plain_version(loss_case):
    """``train_forward(scan=wkv_chunked)`` replaces the WKV entry (the seam
    the card's gradient check uses) and gives the same logits."""
    api, model, batch, _, _ = loss_case
    with torch.no_grad():
        default = model.train_forward(batch["tokens"])
        seam = model.train_forward(batch["tokens"], scan=wkv_chunked)
    assert torch.equal(default, seam)


def _trainers():
    """(reference trainer, port trainer) of reduced float32 rwkv6 on
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
    backend = RealBackendConfig(arch="rwkv6-7b", seq_len=SEQ, device="cpu").build(seed=0)
    assert backend.api.cfg.param_dtype == torch.bfloat16
    backend.cluster = SimulatedCluster(*cluster_A(), noise=0.0, seed=0)
    backend.execute([2, 2, 2], 1)
    path = str(tmp_path / "rwkv6.ckpt.npz")
    backend.checkpoint(path)
    first = backend.execute([3, 2, 1], 1)
    after = {k: v.detach().clone() for k, v in backend.named.items()}
    backend.restore(path)
    again = backend.execute([3, 2, 1], 1)
    assert again.losses == first.losses
    assert all(torch.equal(v, after[k]) for k, v in backend.named.items())


# ---------------------------------------------------------------------------
# the plain WKV backward
# ---------------------------------------------------------------------------

B, T, H, K, CHUNK = 2, 37, 3, 16, 16   # T = 2 chunks of 16 and a ragged 5


@pytest.fixture(scope="module")
def wkv_inputs():
    rng = np.random.default_rng(11)
    r, k, v = ((rng.standard_normal((B, T, H, K)) * 0.5).astype(np.float32) for _ in range(3))
    log_w = (-np.exp(rng.standard_normal((B, T, H, K)) * 0.5)).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.5).astype(np.float32)
    d_out = rng.standard_normal((B, T, H, K)).astype(np.float32)
    d_state = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return (r, k, v, log_w, u), d_out, d_state


@pytest.fixture(scope="module")
def wkv_jax_grads(wkv_inputs):
    """jax.grad of the reference's wkv_chunked, final-state gradient zero
    and nonzero (computed once)."""
    args, d_out, d_state = wkv_inputs

    def grads(ds):
        def f(*xs):
            out, s = jax_wkv_chunked(*xs, chunk=CHUNK)
            return jnp.sum(out * d_out) + jnp.sum(s * ds)
        return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=tuple(range(5))))(*args)]

    return {"zero": grads(np.zeros_like(d_state)), "nonzero": grads(d_state)}


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=GRAD_REL * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("final", ["zero", "nonzero"])
def test_wkv_backward_ref_matches_autograd_and_jax(wkv_inputs, wkv_jax_grads, final):
    args, d_out, d_state = wkv_inputs
    leaves = [torch.from_numpy(x).requires_grad_() for x in args]
    dout_t = torch.from_numpy(d_out)
    ds_t = torch.from_numpy(d_state) if final == "nonzero" else None
    got = wkv_backward_ref(*[x.detach() for x in leaves], dout_t, ds_t)
    out, s = wkv_chunked(*leaves, chunk=CHUNK)
    loss = (out * dout_t).sum() + ((s * ds_t).sum() if ds_t is not None else 0.0)
    _close([g.numpy() for g in got], [g.numpy() for g in torch.autograd.grad(loss, leaves)])
    _close([g.numpy() for g in got], wkv_jax_grads[final])


def test_wkv_differentiates_through_the_plain_version_on_the_cpu(wkv_inputs):
    """On CPU tensors ``wkv`` is the plain chunked form under autograd."""
    args, d_out, _ = wkv_inputs
    leaves = [torch.from_numpy(x).requires_grad_() for x in args]
    out, _ = wkv(*leaves, chunk=CHUNK)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(d_out))
    want = wkv_backward_ref(*[x.detach() for x in leaves], torch.from_numpy(d_out))
    _close([g.numpy() for g in got], [w.numpy() for w in want])
