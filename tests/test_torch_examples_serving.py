"""The serving example scripts: ``examples_torch/`` vs ``examples/`` on the
CPU (``--device cpu``), from the reference's weights, bridged.

``serve_runtime.py``: lanes 1-2 (the simulator) print the reference's
bytes, same-seed fingerprints included.  Lane 3's tick times are measured,
so its allocations and wall may differ, but each request's generated
tokens must be equal (reduced olmo-1b from ``PRNGKey(0)``), with zero
drops and one leave.

``serve_batched.py``: for each arch, the first row of generated tokens,
the cache's shapes and the prefill mode are equal; the port's prompt
draw is patched to give the reference's prompts (``jax.random.randint``
of ``PRNGKey(1)``).  The four reduced
configs are bf16 in both packages; both scripts run them in float32
(``_torch_examples.float32_configs``), as the model tests do, since two
bf16 implementations part within a few greedy tokens.  Their weights are
drawn with numpy in the reference's layout (``tests/_torch_numpy_init.py``)
and given to both packages: the reference's eager ``PRNGKey`` init takes
5-15 s a model here.
"""
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.serving as ref_serving  # noqa: E402
import repro_torch.serving as port_serving  # noqa: E402
from _torch_examples import (  # noqa: E402
    bridged_port_init,
    float32_configs,
    load,
    one_thread,
    printed,
    reference_init,
)
from _torch_numpy_init import numpy_params  # noqa: E402
from repro.configs import get_api as ref_get_api  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane


def _recording(base):
    class Recording(base):
        """The engine, keeping each finished request's generated tokens."""

        streams = {}

        def release(self, ar):
            Recording.streams[ar.rid] = list(ar.tokens)
            super().release(ar)

    return Recording


@pytest.fixture(scope="module")
def serve_runtime_runs():
    ref_engine = _recording(ref_serving.RealServingEngine)
    port_engine = _recording(port_serving.RealServingEngine)
    with pytest.MonkeyPatch.context() as mp, one_thread(), bridged_port_init():
        mp.setattr(ref_serving, "RealServingEngine", ref_engine)
        mp.setattr(port_serving, "RealServingEngine", port_engine)
        _, want = printed(load("examples", "serve_runtime").main, argv=[])
        _, got = printed(load("examples_torch", "serve_runtime").main, ["--device", "cpu"])
    return got, want, port_engine.streams, ref_engine.streams


def test_serve_runtime_sim_lanes_print_the_reference_bytes(serve_runtime_runs):
    got, want, _, _ = serve_runtime_runs
    lanes = [x.split("[3]")[0] for x in (got, want)]
    assert lanes[0] == lanes[1]
    assert "same-seed fingerprint match" in lanes[0] and "requeued" in lanes[0]
    assert got.endswith("serving runtime demo OK\n")


def test_serve_runtime_real_lane_generates_the_reference_tokens(serve_runtime_runs):
    got, want, port_streams, ref_streams = serve_runtime_runs
    assert len(ref_streams) == 8
    assert port_streams == ref_streams
    real = [re.search(r"real .* dropped (\d+)  requeues (\d+)", x) for x in (got, want)]
    assert real[0].group(1) == real[1].group(1) == "0"
    lane = got.split("[3]")[1].splitlines()
    assert lane[0] == want.split("[3]")[1].splitlines()[0]
    toks = [re.search(r"(\d+) tokens in", x).group(1) for x in (got, want)]
    assert toks[0] == toks[1]


@functools.lru_cache(maxsize=None)
def numpy_tree(arch, seed=0):
    return numpy_params(ref_get_api(arch, reduced=True), seed)


ROW = re.compile(r"^(\S+) +batch=(\d+) gen=(\d+) .*\(prefill (\w+) .*first row: (\[.*\])$")


def _parse(out):
    lines = out.splitlines()
    m = ROW.match(lines[0])
    assert m, lines[0]
    return m.groups(), [x.strip() for x in lines[1:]]


@pytest.fixture(scope="module")
def serve_batched_modules():
    return load("examples", "serve_batched"), load("examples_torch", "serve_batched")


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b", "rwkv6-7b", "hymba-1.5b"])
def test_serve_batched_matches_reference(arch, serve_batched_modules):
    ref, port = serve_batched_modules
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 24), 0,
                                            ref_get_api(arch, reduced=True).cfg.vocab))

    def randint(low, high, size, **kw):  # the port's prompt draw: the reference's prompts
        assert (low, high, tuple(size)) == (0, ref_get_api(arch, reduced=True).cfg.vocab,
                                            prompts.shape)
        return torch.as_tensor(prompts, dtype=torch.int64)

    with one_thread(), float32_configs(ref, port), reference_init(numpy_tree), \
            bridged_port_init(numpy_tree), pytest.MonkeyPatch.context() as mp:
        _, want = printed(ref.serve, arch)
        mp.setattr(port.torch, "randint", randint)
        res, got = printed(port.serve, arch, device="cpu")
    (g_head, g_cache), (w_head, w_cache) = _parse(got), _parse(want)
    assert g_head == w_head
    assert g_cache == w_cache and len(g_cache) >= 2
    assert res["mode"] == ("fused" if arch == "llama3-8b" else "stepped")
    assert res["tokens"].shape == (4, 12)
