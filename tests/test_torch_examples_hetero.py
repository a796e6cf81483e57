"""``examples_torch/hetero_cluster_training.py`` vs ``examples/``'s on the
CPU: each policy's ``build(name)`` (reduced olmo-1b on ``cluster_B``'s 16
nodes, from the reference's ``PRNGKey(0)`` weights, bridged) over 3
epochs of 4 steps.  Phases, totals, splits, predicted and measured batch
times, each epoch's simulated seconds and the trainer's ``sim_time`` are
equal; losses within 1e-4 relative (float32 sums in another order over 12
SGD steps), as in ``tests/test_torch_launch.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_examples import bridged_port_init, load, one_thread  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

REL = 1e-4
EPOCHS = 3


@pytest.fixture(scope="module")
def modules():
    return load("examples", "hetero_cluster_training"), load("examples_torch",
                                                              "hetero_cluster_training")


@pytest.fixture(scope="module")
def ref_steps():
    """The reference trainers' jitted steps by padded node batch, shared by
    the three policies: their steps are one function (the same model,
    optimizer and guard), so each shape compiles once in the module."""
    return {}


@pytest.mark.parametrize("name", ["cannikin", "even", "lb-bsp"])
def test_build_trains_as_the_reference(name, modules, ref_steps):
    ref, port = modules
    want_tr = ref.build(name)
    want_tr.backend._step_cache = ref_steps
    want = [want_tr.run_epoch() for _ in range(EPOCHS)]
    with one_thread(), bridged_port_init():
        got_tr = port.build(name, "cpu")
        got = [got_tr.run_epoch() for _ in range(EPOCHS)]
    for g, w in zip(got, want):
        for key in ("epoch", "phase", "total_batch", "batches", "predicted_batch_time",
                    "measured_batch_time", "sim_seconds"):
            assert getattr(g, key) == getattr(w, key), (g.epoch, key)
        assert np.isfinite(g.mean_loss)
        np.testing.assert_allclose(g.mean_loss, w.mean_loss, rtol=REL, atol=0)
    assert got_tr.sim_time == want_tr.sim_time
    phases = [g.phase for g in got]
    assert phases == (["bootstrap", "bootstrap", "optperf"] if name == "cannikin"
                      else [name] * EPOCHS)
    assert got_tr.backend.device.type == "cpu"
