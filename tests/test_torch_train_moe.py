"""Training reduced Mixtral and DeepSeek-V2 in the port vs the JAX package,
float32 on the CPU.

One two-program ``EpochLoop`` epoch on ``cluster_A`` (3 nodes, SGD at lr
0.3, seq 32) through the port's ``HeteroTrainer`` / ``RealBackend`` and
the reference's, from the reference trainer's weights (drawn with numpy
at the reference's init scales, ``tests/_torch_numpy_init.py``) in
float32 variants, TF32 off, one CPU thread: plans
and the simulated clock ``==``, no node excluded, losses within 1e-4
relative.  Each node's padded slice enters the MoE layer whole, as in the
reference: pad rows take capacity slots and count in the aux losses, so
at the published ``capacity_factor`` 1.25, where routings drop, the
losses agree only if the port drops the reference's routings.  Reduced
deepseek-v2-236b (the dense layer 0 and one MoE layer with a shared
expert, MLA at q/k 48, v 32) runs the same epoch at the published
capacity factor, where routings drop.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_api as jax_get_api  # noqa: E402
from repro.core.controller import CannikinController as JaxController  # noqa: E402
from repro.core.simulator import SimulatedCluster as JaxCluster  # noqa: E402
from repro.core.simulator import cluster_A as jax_cluster_A  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models.registry import build_api as jax_build_api  # noqa: E402
from repro.optim.optimizers import constant_schedule as jax_constant  # noqa: E402
from repro.optim.optimizers import sgd as jax_sgd  # noqa: E402
from repro.runtime.backend import run_backend_epoch as jax_run_backend_epoch  # noqa: E402
from repro.train.hetero import HeteroTrainer as JaxHeteroTrainer  # noqa: E402
from _torch_numpy_init import NumpyInitApi  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.configs import get_api  # noqa: E402
from repro_torch.core.controller import CannikinController  # noqa: E402
from repro_torch.core.simulator import SimulatedCluster, cluster_A  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models.registry import build_api  # noqa: E402
from repro_torch.optim.optimizers import constant_schedule, sgd  # noqa: E402
from repro_torch.train.hetero import HeteroTrainer  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

ARCH = "mixtral-8x7b"
SEQ = 32
STEPS = 1
LOSS_REL = 1e-4


def _f32_pair(cf, arch=ARCH):
    jax_api, api = jax_get_api(arch, reduced=True), get_api(arch, reduced=True)
    jcfg = dataclasses.replace(jax_api.cfg, param_dtype=jnp.float32,
                               compute_dtype=jnp.float32, capacity_factor=cf)
    pcfg = dataclasses.replace(api.cfg, param_dtype=torch.float32,
                               compute_dtype=torch.float32, capacity_factor=cf)
    return NumpyInitApi.of(jax_build_api(arch, jcfg)), build_api(arch, pcfg)


def _trainers(cf, arch=ARCH):
    """(reference trainer, port trainer) of reduced float32 ``arch`` on
    cluster_A from the reference's weights."""
    jax_api, api = _f32_pair(cf, arch)
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


@pytest.fixture(scope="module", autouse=True)
def _cpu_settings():
    """TF32 off, and one CPU thread for the module: the small ops run
    faster on one thread than on threads contending with the suite's
    other workers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _epoch_equals_reference(cf, arch=ARCH):
    jtr, ptr = _trainers(cf, arch)
    jrec, jres = jax_run_backend_epoch(jtr.policy, jtr.backend, steps=STEPS, epoch_index=0)
    api, drops = ptr.backend.api, []

    def loss(params, batch, **kw):  # records each node pass's drop fraction
        out = type(api).loss(api, params, batch, **kw)
        drops.append(float(out[1]["drop_frac"]))
        return out

    api.loss = loss
    prec = ptr.run_epoch()
    pres = ptr.loop.last_result
    assert (prec.epoch, prec.phase, prec.total_batch, prec.batches) == (
        jrec.epoch, jrec.phase, jrec.total_batch, jrec.batches)
    assert len(set(prec.batches)) > 1, "the nodes' slices must be padded"
    assert prec.sim_seconds == jrec.epoch_seconds
    assert ptr.sim_time == jtr.backend.sim_time
    assert pres.grad_anomalies == jres.grad_anomalies == (0, 0, 0)
    assert np.all(np.isfinite(pres.losses))
    assert len(drops) == 4 * STEPS  # three node passes and the whole-batch loss
    assert (max(drops) > 0) == (cf == 1.25)
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=LOSS_REL)


@pytest.mark.parametrize("cf", [8.0, 1.25], ids=["dropless", "published-capacity"])
def test_two_program_epoch_plans_clock_and_losses_equal_reference(cf):
    _epoch_equals_reference(cf)


def test_deepseek_epoch_plans_clock_and_losses_equal_reference():
    _epoch_equals_reference(1.25, "deepseek-v2-236b")
