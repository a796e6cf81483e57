"""The training CLI: ``repro_torch.launch.train`` vs ``repro.launch.train``
on the same argv, in process, on the CPU.

The simulator modes print the same bytes and write the same ``--out``
JSON.  ``--mode hetero --backend real --device cpu`` (reduced olmo-1b,
float32) starts from the reference's ``PRNGKey(seed)`` weights, bridged,
and must plan the same phases, totals and splits on the same simulated
clock, with losses within 1e-4 relative (float32 sums in another order
over 8 SGD steps).
"""
import json
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.launch.train as ref_train  # noqa: E402
import repro_torch.launch.train as port_train  # noqa: E402
import repro_torch.runtime as port_runtime  # noqa: E402
from repro.configs import get_api as jax_get_api  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402

REL = 1e-4


def _run(mod, argv, capsys, monkeypatch):
    if mod is ref_train:
        monkeypatch.setattr(sys, "argv", ["train"] + argv)
        rc = mod.main()
    else:
        rc = mod.main(argv)
    assert rc == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--mode", "trace", "--backend", "sim", "--faults", "chaos", "--invariants"],
    ["--mode", "trace", "--backend", "sim", "--batch-policy", "all", "--trace-jobs", "2",
     "--trace-nodes", "8"],
    ["--mode", "hetero", "--backend", "sim", "--cluster", "B"],
    ["--mode", "hetero", "--backend", "sim", "--cluster", "C", "--policy", "lb-bsp",
     "--epochs", "4"],
], ids=["trace-chaos", "trace-batch-policies", "hetero-B", "hetero-C-lbbsp"])
def test_sim_modes_print_the_same(argv, tmp_path, capsys, monkeypatch):
    outs, files = [], []
    for mod in (ref_train, port_train):
        path = tmp_path / f"{mod.__name__}.json"
        outs.append(_run(mod, argv + ["--out", str(path)], capsys, monkeypatch))
        files.append(json.loads(path.read_text()))
    assert outs[0] == outs[1]
    assert files[0] == files[1]
    assert outs[1].count("\n") >= 4
    if "--invariants" in argv:
        assert "invariant_violations=0" in outs[1]


class BridgedRealBackend(port_runtime.RealBackend):
    """The port's backend from the reference's initial olmo-1b weights."""

    def __init__(self, api, *args, seed=0, **kw):
        super().__init__(api, *args, seed=seed, **kw)
        tree = jax.tree_util.tree_map(
            np.asarray, jax_get_api("olmo-1b", reduced=True).init(jax.random.PRNGKey(seed)))
        self.params.load_state_dict(state_dict_from_tree(tree))


LINE = re.compile(r"epoch +(\d+) \[(\w+) *\] B= *(\d+) split=(\[[\d, ]*\]) loss=\S+ "
                  r"batch_time=(\S+) pred=(\S+) sim_total=(\S+)")


def test_hetero_real_cpu_matches_reference(tmp_path, capsys, monkeypatch):
    argv = ["--mode", "hetero", "--backend", "real", "--cluster", "A", "--epochs", "4",
            "--steps-per-epoch", "2", "--seq-len", "16", "--ref-batch", "32"]
    ref_out = _run(ref_train, argv + ["--out", str(tmp_path / "ref.json")], capsys,
                   monkeypatch)
    monkeypatch.setattr(port_runtime, "RealBackend", BridgedRealBackend)
    port_out = _run(port_train, argv + ["--device", "cpu", "--out",
                                        str(tmp_path / "port.json")], capsys, monkeypatch)
    got = [LINE.match(x).groups() for x in port_out.splitlines()[1:]]
    want = [LINE.match(x).groups() for x in ref_out.splitlines()[1:]]
    assert got == want and len(got) == 4
    assert [g[1] for g in got] == ["bootstrap", "bootstrap", "optperf", "optperf"]
    assert port_out.splitlines()[0] == ref_out.splitlines()[0]
    got_rows = json.loads((tmp_path / "port.json").read_text())
    want_rows = json.loads((tmp_path / "ref.json").read_text())
    for g, w in zip(got_rows, want_rows):
        for key in ("epoch", "total_batch", "batches", "sim_seconds", "phase",
                    "predicted_batch_time", "measured_batch_time"):
            assert g[key] == w[key], key
        for key in ("mean_loss", "b_noise", "lr_scale"):
            np.testing.assert_allclose(float(g[key]), float(w[key]), rtol=REL, atol=0)
        assert np.isfinite(g["mean_loss"])


def _goodput_rows(out):
    """The summary table's rows: (policy, goodput, fraction, jobs, states)."""
    rows = [x.split() for x in out.splitlines()[2:] if x.strip()]
    return [(r[0], float(r[1]), float(r[2]), r[3], r[4]) for r in rows]


def test_trace_real_cpu_matches_reference(tmp_path, capsys, monkeypatch):
    """``--mode trace --backend real --device cpu`` (the module docstring's
    command, at 2 steps an epoch of 16 tokens to keep the test short; the
    reference's compiles take most of its time either way): the trace line
    and the summary's job and state columns are equal; the goodput
    figures, which the GNS estimate from the losses' gradients scales,
    within 1e-4 relative; the ``--out`` summaries' other fields equal."""
    import repro_torch.runtime.backend as port_backend

    argv = ["--mode", "trace", "--backend", "real", "--trace-jobs", "1", "--trace-nodes", "3",
            "--epochs-per-event", "2", "--ref-batch", "16", "--steps-per-epoch", "2",
            "--seq-len", "16"]
    ref_out = _run(ref_train, argv + ["--out", str(tmp_path / "ref.json")], capsys,
                   monkeypatch)
    monkeypatch.setattr(port_backend, "RealBackend", BridgedRealBackend)
    port_out = _run(port_train, argv + ["--device", "cpu", "--out",
                                        str(tmp_path / "port.json")], capsys, monkeypatch)
    assert port_out.splitlines()[:2] == ref_out.splitlines()[:2]
    assert port_out.splitlines()[0].startswith("# trace: ")
    got, want = _goodput_rows(port_out), _goodput_rows(ref_out)
    assert [(g[0], g[3], g[4]) for g in got] == [(w[0], w[3], w[4]) for w in want]
    assert [g[0] for g in got] == ["cannikin"]
    np.testing.assert_allclose([g[1:3] for g in got], [w[1:3] for w in want], rtol=REL,
                               atol=0.06)  # printed to 1 and 3 decimals
    got_js = json.loads((tmp_path / "port.json").read_text())
    want_js = json.loads((tmp_path / "ref.json").read_text())

    def close(g, w, path):
        if isinstance(w, dict):
            assert g.keys() == w.keys(), path
            for k in w:
                close(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, list):
            assert len(g) == len(w), path
            for i, (a, b) in enumerate(zip(g, w)):
                close(a, b, f"{path}/{i}")
        elif isinstance(w, float) and not isinstance(g, bool):
            np.testing.assert_allclose(g, w, rtol=REL, atol=0, err_msg=path)
        else:
            assert g == w, path

    close(got_js, want_js, "")
    assert got_js["cannikin"]["aggregate_goodput"] > 0


SPMD_LINE = re.compile(r"step +(\d+) loss=(\S+) \((\d+)ms\)")


def test_spmd_mode_and_missing_card_are_errors(capsys, monkeypatch):
    """``--mode spmd --device cpu`` prints the reference's per-step losses
    within 1e-5 relative, from the reference's weights, bridged.  At lr
    0.001: at the default 0.3, AdamW's first update moves every weight by
    about 0.3, the loss climbs from 6.8 to 15.8 in 3 steps, and float32
    roundoff grows about 100x per step (the reference's own ``--microbatches
    1`` and ``2`` differ by 3.5e-4 at step 2).  Without a card the default
    device raises, as a real hetero backend does; whisper-large-v3 raises the
    reference's exception (``KeyError``: no ``audio_embed`` in the batch)."""
    import repro.train.step as ref_step
    import repro_torch.models.registry as port_registry
    import repro_torch.train.step as port_step

    losses = {"ref": [], "port": []}
    jit = jax.jit

    def recorded(mod, key, build, compile_):
        def builder(*args, **kw):
            step = compile_(build(*args, **kw))

            def run(*xs):
                out = step(*xs)
                losses[key].append(float(out[2]["loss"]))
                return out
            return run
        monkeypatch.setattr(mod, "build_train_step", builder)

    recorded(ref_step, "ref", ref_step.build_train_step, jit)
    recorded(port_step, "port", port_step.build_train_step, lambda f: f)
    init = port_registry.ModelApi.init

    def bridged_init(self, seed=0, *, device=None):
        model = init(self, seed, device=device)
        tree = jax.tree_util.tree_map(
            np.asarray, jax_get_api(self.arch_id, reduced=True).init(jax.random.PRNGKey(seed)))
        model.load_state_dict(state_dict_from_tree(tree))
        return model

    monkeypatch.setattr(port_registry.ModelApi, "init", bridged_init)
    argv = ["--mode", "spmd", "--steps", "3", "--lr", "0.001", "--microbatches", "2"]
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda f, **kw: f)  # the recording wrapper jits the step
        ref_out = _run(ref_train, argv, capsys, monkeypatch)
    port_out = _run(port_train, argv + ["--device", "cpu"], capsys, monkeypatch)
    got = [SPMD_LINE.match(x).groups() for x in port_out.splitlines()]
    want = [SPMD_LINE.match(x).groups() for x in ref_out.splitlines()]
    assert [g[0] for g in got] == [w[0] for w in want] == ["0", "1", "2"]
    assert len(losses["port"]) == len(losses["ref"]) == 3
    assert all(np.isfinite(losses["port"]))
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5, atol=0)
    np.testing.assert_allclose([float(g[1]) for g in got], [float(w[1]) for w in want],
                               rtol=0, atol=1e-4)
    monkeypatch.undo()

    # rwkv6, mixtral and deepseek train (ROADMAP §1.8a-b): one reduced step
    # each, a finite loss.  whisper fails as the reference's run_spmd does:
    # SyntheticLM's batches carry no audio_embed.
    for arch in ("rwkv6-7b", "mixtral-8x7b", "deepseek-v2-236b"):
        out = _run(port_train, ["--mode", "spmd", "--arch", arch, "--steps", "1",
                                "--seq-len", "16", "--ref-batch", "4", "--device", "cpu"],
                   capsys, monkeypatch)
        steps = [SPMD_LINE.match(x) for x in out.splitlines()]
        assert [m.group(1) for m in steps if m] == ["0"]
        assert all(np.isfinite(float(m.group(2))) for m in steps if m)
    whisper = ["--mode", "spmd", "--arch", "whisper-large-v3", "--steps", "1", "--seq-len", "16",
               "--ref-batch", "4"]
    monkeypatch.setattr(sys, "argv", ["train"] + whisper)
    with pytest.raises(KeyError, match="audio_embed") as ref_err:
        ref_train.main()
    with pytest.raises(type(ref_err.value), match="audio_embed"):
        port_train.main(whisper + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port_train.main(["--mode", "spmd", "--steps", "1"])
        with pytest.raises(RuntimeError):
            port_train.main(["--mode", "hetero", "--backend", "real", "--epochs", "1"])
