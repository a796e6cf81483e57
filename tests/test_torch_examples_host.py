"""The host-only example scripts: ``examples_torch/`` vs ``examples/``.

``gns_heterogeneous.py`` (numpy), ``policy_zoo.py`` and
``runtime_trace.py`` (the simulator and the ``"batched"`` scheduler
engine, with and without ``--faults chaos-small``) print the reference's
bytes.  Scripts that touch a device raise without a card unless given
``--device cpu``.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_examples import load, printed  # noqa: E402

HOST = [
    ("gns_heterogeneous", []),
    ("policy_zoo", []),
    ("runtime_trace", []),
    ("runtime_trace", ["--faults", "chaos-small"]),
]


@pytest.mark.parametrize("name,argv", HOST, ids=[" ".join([n] + a) for n, a in HOST])
def test_host_script_prints_the_reference_bytes(name, argv):
    _, want = printed(load("examples", name).main, argv=argv)
    _, got = printed(load("examples_torch", name).main, argv=argv)
    assert got == want
    assert got.count("\n") >= 8
    if name == "runtime_trace":
        assert "all invariants OK" in got
        assert ("chaos invariants OK" in got) == bool(argv)
    if name == "policy_zoo":
        assert got.endswith("ok\n")


DEVICE_SCRIPTS = [
    ("serve_runtime", []),
    ("serve_batched", []),
    ("quickstart", []),
    ("preempt_resume", []),
    ("preempt_resume", ["--faults", "chaos-real"]),
    ("hetero_cluster_training", []),
]


@pytest.mark.parametrize("name,argv", DEVICE_SCRIPTS,
                         ids=[" ".join([n] + a) for n, a in DEVICE_SCRIPTS])
def test_device_script_raises_without_a_card(name, argv):
    """The default device is the card: without one, ``main`` raises before
    it prints anything, rather than taking the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        printed(load("examples_torch", name).main, argv)

