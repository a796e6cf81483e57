"""Checkpoint files (``train/checkpoint.py`` and ``RealBackend.checkpoint`` /
``restore``) on the CPU, and the file layout against the JAX package's.

A backend's snapshot must come back bitwise (parameters, optimizer state,
GNS state, stream counters) and training must resume exactly where it
stopped.  Files are checked by their sha256 digest, kept in generations
with rollback past a corrupted head, and written atomically.  The layout
(keypath strings, the ``__dtypes__``/``__sha256__``/``__generation__`` tags,
bfloat16 stored as float32) is the reference's, so each package verifies and
restores the other's files, and the same tree gets the same digest.
"""
import dataclasses
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.core.perf_model import CommModel  # noqa: E402
from repro_torch.core.scheduler import JobSpec  # noqa: E402
from repro_torch.core.simulator import GPU_CATALOG  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models.registry import build_api  # noqa: E402
from repro_torch.optim.optimizers import constant_schedule, sgd  # noqa: E402
from repro_torch.runtime.backend import RealBackend  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

pytestmark = pytest.mark.slow  # imports JAX; excluded from the fast lane


def _backend(dtype):
    """Reduced olmo-1b on the CPU (``dtype`` parameters and compute) on a
    3-node catalog cluster."""
    cfg = dataclasses.replace(olmo_1b.reduced(), param_dtype=dtype, compute_dtype=dtype)
    api = build_api("olmo-1b", cfg)
    backend = RealBackend(api, sgd(constant_schedule(0.3)),
                          SyntheticLM(vocab=cfg.vocab, seq_len=16, seed=0), seed=0, device="cpu")
    spec = JobSpec(name="ckpt-job",
                   node_models=tuple(GPU_CATALOG[x].model() for x in ("a100", "v100", "rtx6000")),
                   comm=CommModel(t_o=0.04, t_u=0.008, gamma=0.15), total_batch=12,
                   b_noise=500.0, ref_batch=12, backend="real")
    backend.configure(spec, (0, 1, 2), seed=1)
    return backend


def _assert_same_state(a, b):
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert a["params"][k].dtype == b["params"][k].dtype
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert a["opt_state"].step == b["opt_state"].step
    for k in a["opt_state"].momentum:
        assert torch.equal(a["opt_state"].momentum[k], b["opt_state"].momentum[k]), k
    for group in ("gns", "counters"):
        for k, v in a[group].items():
            assert v == b[group][k] and np.asarray(v).dtype == np.asarray(b[group][k]).dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backend_checkpoint_round_trips_and_resumes(tmp_path, dtype):
    backend = _backend(dtype)
    backend.execute([4, 4, 4], 2)
    path = str(tmp_path / "run" / "backend.ckpt.npz")
    backend.checkpoint(path)
    saved = backend.snapshot()
    assert ckpt.verify_checkpoint(path) and jckpt.verify_checkpoint(path)
    assert not os.path.exists(path + ".tmp")
    first = backend.execute([6, 4, 2], 2)

    backend.restore(path)
    _assert_same_state(backend.snapshot(), saved)
    again = backend.execute([6, 4, 2], 2)
    assert again.losses == first.losses
    assert [o.local_sqnorms for o in again.grad_observations] == [
        o.local_sqnorms for o in first.grad_observations]
    assert backend.gns == _backend_after(dtype, path).gns


def _backend_after(dtype, path):
    """A fresh backend restored from ``path`` that then runs the same epoch:
    a new process resuming the run."""
    fresh = _backend(dtype)
    fresh.restore(path)
    fresh.execute([6, 4, 2], 2)
    return fresh


def test_manager_generations_and_rollback(tmp_path):
    backend = _backend(torch.float32)
    mgr = ckpt.CheckpointManager(str(tmp_path), "job", keep=2)
    snaps = []
    for _ in range(3):
        backend.execute([4, 4, 4], 1)
        snaps.append(backend.snapshot())
        mgr.save(snaps[-1])
    assert [g for g, _ in mgr.generations()] == [2, 3]
    assert ckpt.checkpoint_generation(mgr.latest_path) == 3

    # Corrupt the head's payload: its digest no longer matches.
    head = mgr.latest_path
    with np.load(head) as data:
        flat = {k: data[k] for k in data.files}
    key = next(k for k in flat if k.startswith("params/"))
    flat[key] = flat[key] + 1.0
    with open(head, "wb") as f:
        np.savez(f, **flat)
    assert not ckpt.verify_checkpoint(head) and not jckpt.verify_checkpoint(head)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(head, backend.snapshot())

    tree, gen, path = mgr.restore(backend.snapshot())
    assert gen == 2 and mgr.rollbacks == 1 and mgr.corrupt_generations == [head]
    _assert_same_state(tree, snaps[1])
    # A new manager over the same directory continues the sequence.
    again = ckpt.CheckpointManager(str(tmp_path), "job", keep=2)
    assert again.latest_generation == 3
    assert again.save(snaps[2]).endswith(".gen000004.ckpt.npz")

    # Every generation corrupt: nothing to roll back to.
    for _, p in again.generations():
        with open(p, "wb") as f:
            f.write(b"not a checkpoint")
    with pytest.raises(ckpt.CheckpointCorruptError):
        again.restore(backend.snapshot())


def test_failed_write_leaves_no_file(tmp_path):
    class FailingIO(ckpt.LocalIO):
        def replace(self, src, dst):
            raise OSError("disk full")

    mgr = ckpt.CheckpointManager(str(tmp_path), "job", keep=3, io=FailingIO())
    with pytest.raises(OSError):
        mgr.save({"a": np.ones(3)})
    assert os.listdir(tmp_path) == [] and mgr.latest_generation == 0


class _State(NamedTuple):
    mu: dict
    step: int


def _tree(bf16):
    """A nested tree of the shapes a training state has: dicts, a list, a
    named tuple, float32/int/bfloat16 arrays and scalars."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    emb = rng.standard_normal((5, 2)).astype(np.float32)
    return {
        "params": {"w": w, "emb": bf16(emb), "layers": [np.arange(6, dtype=np.int32),
                                                        rng.standard_normal(2).astype(np.float32)]},
        "opt": _State(mu={"w": np.zeros((4, 3), np.float32)}, step=7),
        "gns": {"ema_g": np.float64(0.25), "count": np.int64(3)},
    }


def _torch_bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _jax_bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


def _flat_equal(a, b):
    """Leaf by leaf, as float64 numpy (bfloat16 values are exact there)."""
    la = [np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float64)
          for x in jax.tree_util.tree_leaves(a)]
    lb = [np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float64)
          for x in jax.tree_util.tree_leaves(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_each_package_reads_the_others_files(tmp_path):
    port_tree, ref_tree = _tree(_torch_bf16), _tree(_jax_bf16)
    port_path, ref_path = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    ckpt.save(port_path, port_tree, generation=5)
    jckpt.save(ref_path, ref_tree, generation=5)
    with np.load(port_path) as p, np.load(ref_path) as r:
        assert sorted(p.files) == sorted(r.files)
        assert "opt/.mu/w" in p.files and "params/layers/1" in p.files
        assert bytes(p["__sha256__"]) == bytes(r["__sha256__"])
        assert bytes(p["__dtypes__"]) == bytes(r["__dtypes__"])
    for path in (port_path, ref_path):
        assert ckpt.verify_checkpoint(path) and jckpt.verify_checkpoint(path)
        assert ckpt.checkpoint_generation(path) == jckpt.checkpoint_generation(path) == 5

    from_ref = ckpt.restore(ref_path, port_tree)
    assert from_ref["params"]["emb"].dtype == torch.bfloat16
    assert isinstance(from_ref["opt"], _State) and from_ref["opt"].step == 7
    _flat_equal(from_ref, port_tree)
    from_port = jckpt.restore(port_path, ref_tree)
    assert from_port["params"]["emb"].dtype == jnp.bfloat16
    _flat_equal(from_port, ref_tree)
