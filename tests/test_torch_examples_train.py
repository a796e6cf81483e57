"""The training example scripts: ``examples_torch/`` vs ``examples/`` on
the CPU (``--device cpu``).

``quickstart.py``: the reference's ``main`` runs once (60 AdamW steps,
the checkpoint, the greedy decode, the cluster runtime).  Reduced
llama3-8b is bf16 in both packages, so both scripts build it in float32
(``_torch_examples.float32_configs``), from one numpy draw in the
reference's layout (``tests/_torch_numpy_init.py``; the reference's eager
``PRNGKey`` init takes seconds here).  The port's ``train`` over the first
5 steps: losses and grad norms within 1e-5 relative; its checkpoint round
trip restores every tensor equal; its greedy decode from the reference's
trained parameters, bridged, gives the reference's 16 tokens; its
runtime part prints the reference's lines.

``preempt_resume.py``, both modes, whole ``main`` against whole ``main``
(reduced olmo-1b from the reference's ``PRNGKey(0)`` weights, bridged):
each epoch's (epoch, phase, B, split), the quarantine latency, the
watchdog's counters, the rollback count and every other line but the
losses and the checkpoint's path are equal; losses within 1e-4 relative.
The chaos plan's solver stall is lengthened from 0.05 to 0.6 s in both,
so that the watchdog's wall-clock deadline (half the stall) is one that a
loaded CPU's ordinary solves do not reach, as in
``tests/test_torch_runtime_real.py``.
"""
import contextlib
import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.runtime as ref_runtime  # noqa: E402
import repro.runtime.backend as ref_backend  # noqa: E402
import repro_torch.runtime as port_runtime  # noqa: E402
from _torch_examples import (  # noqa: E402
    bridged_port_init,
    float32_api,
    float32_configs,
    load,
    one_thread,
    printed,
    reference_init,
)
from _torch_numpy_init import numpy_params  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

QUICK_STEPS = 5


@functools.lru_cache(maxsize=None)
def llama_tree(arch, seed=0):
    return numpy_params(float32_api(arch, False), seed)


class _Jit:
    """``jax`` for the reference quickstart's module: ``jit`` keeps every
    output of the jitted train step."""

    def __init__(self, step_fns, outputs):
        self._step_fns, self._outputs = step_fns, outputs

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)
        if fn not in self._step_fns:
            return jitted

        def run(*args):
            out = jitted(*args)
            self._outputs.append(out)
            return out
        return run


@pytest.fixture(scope="module")
def quickstart():
    ref, port = load("examples", "quickstart"), load("examples_torch", "quickstart")
    step_fns, outputs = [], []
    build = ref.build_train_step

    def recorded_build(*args, **kw):
        step_fns.append(build(*args, **kw))
        return step_fns[-1]

    with pytest.MonkeyPatch.context() as mp, float32_configs(ref, port), \
            reference_init(llama_tree):
        mp.setattr(ref, "build_train_step", recorded_build)
        mp.setattr(ref, "jax", _Jit(step_fns, outputs))
        _, out = printed(ref.main)
    steps = [(float(m["loss"]), float(m["grad_norm"])) for _, _, m in outputs]
    trained = jax.tree_util.tree_map(np.asarray, outputs[-1][0])
    return ref, port, out, steps, trained


def _port_model(port):
    api = port.get_api("llama3-8b", reduced=True)
    return api, api.init(0, device="cpu").requires_grad_(True)


def test_quickstart_first_steps_match_reference(quickstart):
    ref, port, out, steps, _ = quickstart
    assert len(steps) == 60
    with one_thread(), float32_configs(ref, port), bridged_port_init(llama_tree):
        api, params = _port_model(port)
        data = SyntheticLM(vocab=api.cfg.vocab, seq_len=port.SEQ, seed=0)
        history, printed_steps = printed(port.train, api, params, data, QUICK_STEPS)
        _, line = printed(port.checkpoint_round_trip, params)
    assert len(history) == QUICK_STEPS and np.all(np.isfinite(history))
    np.testing.assert_allclose(history, steps[:QUICK_STEPS], rtol=1e-5, atol=0)
    assert printed_steps.startswith("step   0 loss=")
    want = next(x for x in out.splitlines() if x.startswith("checkpoint round-trip"))
    assert line.strip() == want


def test_quickstart_greedy_decode_from_the_reference_weights(quickstart):
    ref, port, out, _, trained = quickstart
    with one_thread(), float32_configs(ref, port):
        api = port.get_api("llama3-8b", reduced=True)
        model = api.load(state_dict_from_tree(trained), device="cpu")
        data = SyntheticLM(vocab=api.cfg.vocab, seq_len=port.SEQ, seed=0)
        (tokens, hits), text = printed(port.greedy_decode, api, model, data.rule)
    want = out.split("greedy decode:")[1].splitlines()
    assert text.splitlines() == ["greedy decode:" + want[0], want[1]]
    assert len(tokens) == 16 and hits >= 1


def test_quickstart_runtime_lines_match_reference(quickstart):
    _, port, out, _, _ = quickstart
    lines, text = printed(port.cluster_runtime)
    assert text == out[out.index("\ncluster runtime:"):]
    assert len(lines) == 4


def _stalled(mod):
    """``make_fault_plan`` with chaos-real's solver stall at 0.6 s."""
    make = mod.make_fault_plan

    def plan(name, n, seed=0):
        p = make(name, n, seed=seed)
        if name != "chaos-real":
            return p
        return dataclasses.replace(
            p, solver_stalls=(dataclasses.replace(p.solver_stalls[0], delay=0.6),))
    return plan


def _recording(mod, made):
    class Recording(mod.ClusterRuntime):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)
    return Recording


_REF_STEPS = {}  # a RealBackendConfig's fields -> its backends' steps by node batch


@contextlib.contextmanager
def _shared_reference_steps():
    """Within the block, the reference's backends built from equal
    ``RealBackendConfig``s share their jitted steps: the steps are one
    function (the same model, optimizer and guard; an injector changes
    only their inputs), so each shape compiles once in the module rather
    than once per backend (a resumed job builds a new one)."""
    build = ref_backend.RealBackendConfig.build

    def shared(self, **kw):
        backend = build(self, **kw)
        backend._step_cache = _REF_STEPS.setdefault(dataclasses.astuple(self), {})
        return backend

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_backend.RealBackendConfig, "build", shared)
        yield


@pytest.fixture(scope="module", params=[[], ["--faults", "chaos-real"]],
                ids=["preempt", "chaos-real"])
def preempt_runs(request):
    argv = request.param
    runs = []
    for mod, folder, extra in ((ref_runtime, "examples", []),
                               (port_runtime, "examples_torch", ["--device", "cpu"])):
        made = []
        with pytest.MonkeyPatch.context() as mp, one_thread(), bridged_port_init(), \
                _shared_reference_steps():
            mp.setattr(mod, "ClusterRuntime", _recording(mod, made))
            mp.setattr(mod, "make_fault_plan", _stalled(mod))
            script = load(folder, "preempt_resume")
            if folder == "examples":
                _, out = printed(script.main, argv=argv)
            else:
                _, out = printed(script.main, argv + extra)
        assert len(made) == 1
        runs.append((out, made[0].handles["job"], made[0]))
    return argv, runs[0], runs[1]


LOSS = re.compile(r" loss=(\S+)")


def _lines(out):
    """The printed lines, each loss and the checkpoint's folder cut out."""
    out = re.sub(r"/\S*/(job\.gen\d+\.ckpt\.npz)", r"\1", out)
    return [LOSS.sub(" loss=", x) for x in out.splitlines()]


def test_preempt_resume_matches_reference(preempt_runs):
    argv, (want, ref_handle, ref_rt), (got, handle, rt) = preempt_runs
    assert _lines(got) == _lines(want)
    assert [(r.epoch, r.phase, r.total_batch, r.batches) for r in handle.records] == \
        [(r.epoch, r.phase, r.total_batch, r.batches) for r in ref_handle.records]
    losses = [r.mean_loss for r in handle.records]
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, [r.mean_loss for r in ref_handle.records],
                               rtol=1e-4, atol=0)
    assert handle.ckpt_rollbacks == ref_handle.ckpt_rollbacks
    assert handle.preemptions == ref_handle.preemptions
    assert handle.backend.device.type == "cpu"
    if argv:
        assert handle.ckpt_rollbacks == 1
        assert rt.watchdog.counters() == ref_rt.watchdog.counters()
        assert rt.watchdog.solver_timeouts == 1
        latency = [re.search(r"quarantined (\d+) epoch", x) for x in (got, want)]
        assert latency[0].group(1) == latency[1].group(1)
        assert got.endswith("chaos-real invariants OK\n")
    else:
        assert got.endswith("all invariants OK\n")
        assert "restore verified: params + stream counters bit-exact" in got
