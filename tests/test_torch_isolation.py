"""The port stands alone: no JAX, nothing of the JAX package.

``src/repro_torch/**/*.py``, ``chip_smoke.py``, ``tools/*.py`` and
``examples_torch/*.py`` import neither ``jax`` nor ``repro`` (as opposed
to ``repro_torch``); the port's
public modules import with both blocked; entry points without
``device="cpu"`` raise when there is no card.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py"))
              + sorted((ROOT / "examples_torch").glob("*.py")))
FORBIDDEN = ("jax", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted({root for root in _imported_roots(path) if root in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_modules_import_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.serving, repro_torch.models.dense, repro_torch.models.rwkv6\n"
        "import repro_torch.models.hymba\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.rwkv6_wkv\n"
        "import repro_torch.kernels.ssm_scan\n"
        "import repro_torch.bridge\n"
        "import repro_torch.configs\n"
        "import repro_torch.train, repro_torch.runtime.backend, repro_torch.optim\n"
        "import repro_torch.core.controller, repro_torch.core.baselines\n"
        "import repro_torch.core.optperf_torch, repro_torch.train.checkpoint\n"
        "import repro_torch.core.scheduler, repro_torch.data\n"
        "import repro_torch.runtime, repro_torch.runtime.runtime, repro_torch.runtime.trace\n"
        "import repro_torch.runtime.policy, repro_torch.runtime.faults\n"
        "import repro_torch.runtime.health, repro_torch.runtime.watchdog\n"
        "import repro_torch.runtime.invariants, repro_torch.runtime.events\n"
        "import repro_torch.launch, repro_torch.launch.train, repro_torch.launch.mesh\n"
        "import repro_torch.sharding, repro_torch.sharding.rules, repro_torch.train.step\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    from repro_torch.configs import get_api
    from repro_torch.serving import RealServingEngine

    api = get_api("olmo-1b", reduced=True)
    with pytest.raises(RuntimeError):
        api.init(0)
    with pytest.raises(RuntimeError):
        api.init_cache(1, 8)
    model = api.init(0, device="cpu")
    with pytest.raises(RuntimeError):
        RealServingEngine(api, model, max_len=16)
    assert RealServingEngine(api, model, max_len=16, device="cpu").device.type == "cpu"


def test_cluster_runtime_real_job_raises_without_a_card():
    """A real job's backend trains on its ``RealBackendConfig.device``,
    the card by default: admitting one without a card raises, and with
    ``device="cpu"`` the job runs."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    import dataclasses

    from repro_torch.core.scheduler import random_jobs
    from repro_torch.runtime import ClusterRuntime, RealBackendConfig

    spec = dataclasses.replace(random_jobs(1, 3, seed=0)[0], backend="real", total_batch=6)
    rt = ClusterRuntime(3, real_backend=RealBackendConfig(seq_len=8))
    rt.submit(spec)
    with pytest.raises(RuntimeError):
        rt.run()
    rt = ClusterRuntime(3, real_backend=RealBackendConfig(seq_len=8, device="cpu"))
    rt.submit(spec)
    rt.run()
    assert rt.handles[spec.name].backend.device.type == "cpu"
    # The device engine without a card: the policy's counted degradation
    # chain takes the host engine, never a silent one.
    rt = ClusterRuntime(3, engine="jax")
    rt.submit(dataclasses.replace(spec, backend="sim"))
    rt.run()
    assert rt.counters()["engine_degradations"] == 1
    assert rt.policy.scheduler.engine == "batched"
