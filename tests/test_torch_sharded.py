"""The node-sharded RealBackend (``RealBackend(sharded=True)``), the node
mesh (``launch/mesh.py``) and the sharding rules on the CPU, against the
JAX package's ``shard_map`` step on a genuinely split two-device mesh.

The reference's two-device mesh needs ``XLA_FLAGS`` before ``jax`` is
imported, so one subprocess per module computes every reference result
(``ORACLE``), started with the module and read by its last test.  The
port's world of two is two spawned CPU processes in a gloo group
(``tests/_torch_sharded_ranks.py``), each on one thread.

The setup is ``tests/test_fused_backend.py``'s: reduced olmo-1b
(float32), seq 16, SGD at lr 0.3, the catalog nodes a100, v100, rtx6000,
a5000, the plans ``[4, 4, 4, 4]``, ``[6, 4, 3, 3]``, ``[2, 6, 5, 3]`` of 2
steps each, from the reference's ``PRNGKey(0)`` weights, bridged.
Tolerances, sharded vs the reference's sharded step: the reference's own
sharded-vs-vmap bars (losses rtol 1e-6; parameters rtol 1e-5, atol 1e-6;
equal GNS ``count``, ``b_noise`` rel 1e-3).  A world of one sums the
nodes in the unsharded step's order, so its parameters, momentum, |g_i|^2
and |g|^2 are the same bits as the unsharded step's; only the loss is
composed another way (from the per-node means), within 1e-6 relative.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_sharded_ranks as ranks  # noqa: E402
from repro.configs import get_api as jax_get_api  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.sharding.rules import MeshRules as JaxMeshRules  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.step import node_step_specs as jax_node_step_specs  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.sharding.rules import MeshRules  # noqa: E402
from repro_torch.train.step import node_step_specs  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ORACLE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    import numpy as np
    from repro.core.perf_model import CommModel
    from repro.core.scheduler import JobSpec
    from repro.core.simulator import GPU_CATALOG
    from repro.runtime import RealBackendConfig

    nodes = ("a100", "v100", "rtx6000", "a5000")
    spec = JobSpec(name="sharded-job", node_models=tuple(GPU_CATALOG[x].model() for x in nodes),
                   comm=CommModel(t_o=0.04, t_u=0.008, gamma=0.15), total_batch=16,
                   b_noise=500.0, ref_batch=16, backend="real")
    b = RealBackendConfig(arch="olmo-1b", seq_len=16, lr=0.3, sharded=True).build(
        noise=0.0, seed=0)
    init = jax.tree_util.tree_map(np.asarray, b.params)
    b.configure(spec, (0, 1, 2, 3), seed=1)
    results = [b.execute(p, 2) for p in ([4, 4, 4, 4], [6, 4, 3, 3], [2, 6, 5, 3])]
    out = dict(
        init=init,
        devices=jax.device_count(),
        shards=int(b._mesh.devices.size),
        losses=[list(r.losses) for r in results],
        params=jax.tree_util.tree_map(np.asarray, b.params),
        gns=(b.gns.ema_g, b.gns.ema_s, b.gns.count, b.gns.b_noise),
        transfers=b.transfers.snapshot(),
    )
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module", autouse=True)
def oracle(tmp_path_factory):
    """The reference's subprocess, started when the module starts so that
    it runs beside the port's tests."""
    path = str(tmp_path_factory.mktemp("oracle") / "reference.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", ORACLE, path], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        yield proc, path
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
        proc.stderr.close()


@pytest.fixture(scope="module")
def reference(oracle):
    proc, path = oracle
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def weights():
    """The reference's ``PRNGKey(0)`` reduced olmo-1b, bridged (as its
    ``RealBackendConfig.build(seed=0)`` draws them)."""
    tree = jax_get_api("olmo-1b", reduced=True).init(jax.random.PRNGKey(0))
    return state_dict_from_tree(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Multi-threaded CPU BLAS differs in the last bits from run to run, so
    every comparison of bits runs on one thread, as the spawned ranks do."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def plain(weights):
    """The port's unsharded step on the plans, from the reference's weights."""
    return ranks.run_plans(ranks.backend(4, sharded=False, weights=weights))


@pytest.fixture(scope="module")
def plain_fused():
    """The port's unsharded fused loop (seeded weights)."""
    return ranks.fused_loop(sharded=False)


@pytest.fixture(scope="module")
def world2(weights, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("gloo2"))
    torch.save(weights, os.path.join(out_dir, "weights.pt"))
    return ranks.spawn(2, out_dir, ["plans", "uneven", "fused", "ckpt"])


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def test_node_shard_count_matches_reference():
    for n in range(1, 9):
        for devices in range(1, 9):
            assert mesh.node_shard_count(n, devices) == jmesh.node_shard_count(n, devices)
        # No default group here, and one local JAX device.
        assert mesh.node_shard_count(n) == jmesh.node_shard_count(n) == 1
    with pytest.raises(ValueError):
        mesh.node_shard_count(0)
    for arch in ("olmo-1b", "llama3-8b", "deepseek-v2-236b", "internlm2-20b"):
        for extent in (1, 16, 64):
            assert mesh.train_microbatches(arch, batch_extent=extent) == \
                jmesh.train_microbatches(arch, batch_extent=extent)


RULES = [
    dict(mesh_axes={"data": 16, "model": 16}),
    dict(mesh_axes={"pod": 2, "data": 16, "model": 16}, batch_axes=("pod", "data"),
         fsdp_axis="data", cache_seq_axes=("data", "model")),
    dict(mesh_axes={"nodes": 2}, node_axis="nodes"),
    dict(mesh_axes={"nodes": 3, "model": 4}, node_axis="nodes", experts_axis="model"),
]
SPECS = [
    (["batch", "seq", "embed"], (256, 4096, 2048)),
    (["embed", "heads", None], (2048, 16, 128)),
    (["kv_heads", "embed"], (5, 1600)),
    (["cache_seq", "kv_heads", None], (4096, 16, 128)),
    (["vocab", "embed"], (50304, 2048)),
    (["experts", "embed", "ff"], (8, 4096, 14336)),
    (["nodes", None, None], (4, 8, 16)),
    (["nodes", None], (3, 8)),
    (["nodes"], None),
    ([], None),
    ([None, "ssm_inner"], (2, 3200)),
]


@pytest.mark.parametrize("rules", RULES, ids=lambda r: "x".join(map(str, r["mesh_axes"].values())))
def test_mesh_rules_spec_matches_reference(rules):
    port, ref = MeshRules(**rules), JaxMeshRules(**rules)
    for logical, shape in SPECS:
        try:
            want = tuple(ref.spec(logical, shape, path="/".join(map(str, logical))))
        except KeyError:  # an axis this mesh has no entry for
            with pytest.raises(KeyError):
                port.spec(logical, shape)
            continue
        assert port.spec(logical, shape, path="/".join(map(str, logical))) == want
    assert [dataclasses.astuple(f) for f in port.fallbacks] == [
        dataclasses.astuple(f) for f in ref.fallbacks]
    assert port.fallback_report() == ref.fallback_report()
    assert port.batch_spec(2) == tuple(ref.batch_spec(2))
    if "nodes" in rules["mesh_axes"]:
        want = {k: tuple(v) for k, v in jax_node_step_specs(ref).items()}
        assert node_step_specs(port) == want
    with pytest.raises(KeyError):
        port.spec(["no-such-axis"])


def test_world_of_one_mesh_on_the_cpu():
    assert not torch.distributed.is_initialized()
    m = mesh.make_node_mesh(3, device="cpu")
    assert (m.shards, m.shard, m.nodes, m.rank, m.world) == (1, 0, (0, 1, 2), 0, 1)
    assert mesh.mesh_axis_sizes(m) == {"nodes": 1}
    x = torch.arange(5.0)
    assert torch.equal(m.all_reduce_(x.clone()), x)
    m.barrier()
    # One group per device, reused.
    assert mesh.make_node_mesh(6, device="cpu").group is m.group
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mesh.make_node_mesh(3)


def test_world_of_one_same_bits_as_unsharded(weights, plain):
    b = ranks.backend(4, sharded=True, weights=weights)
    sharded = ranks.run_plans(b)
    assert (b._mesh.shards, b._mesh.nodes, b._mesh.world) == (1, (0, 1, 2, 3), 1)
    assert ranks.same_arrays(sharded["params"], plain["params"])
    assert ranks.same_arrays(sharded["momentum"], plain["momentum"])
    for key in ("sq_i", "sq_g", "valid", "gns", "transfers"):
        assert sharded[key] == plain[key], key
    _close(sharded["losses"], plain["losses"], rtol=1e-6)


def test_world_of_one_fused_loop_same_bits(plain_fused):
    plain = plain_fused
    sharded = ranks.fused_loop(sharded=True)
    assert sharded["plans"] == plain["plans"]
    assert sharded["lr_scale"] == plain["lr_scale"] and sharded["stats"] == plain["stats"]
    assert ranks.same_arrays(sharded["params"], plain["params"])
    assert plain["cache"] == [(4, 0)] and sharded["cache"] == [(4, 1)]
    _close(sharded["mean_loss"], plain["mean_loss"], rtol=1e-6)


def test_gloo_world_of_two_matches_unsharded(world2, plain):
    got = world2[0]["plans"]
    # Each rank sums its two nodes; the group adds the two partials.
    _close(got["losses"], plain["losses"], rtol=1e-6)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, plain["params"][k], rtol=1e-5, atol=1e-6)
    # The first step's |g_i|^2 are each node's own from the same weights:
    # the same bits, gathered.  After it the replicas differ by the sum order.
    assert got["sq_i"][0][0] == plain["sq_i"][0][0] and got["valid"] == plain["valid"]
    _close(got["sq_i"], plain["sq_i"], rtol=1e-5)
    _close(got["sq_g"], plain["sq_g"], rtol=1e-5)
    assert got["gns"][2] == plain["gns"][2]


def test_rank_past_the_last_shard_joins_with_zeros(weights, world2):
    """Three nodes over two ranks: one shard (3 has no divisor 2), rank 1
    owns no node and adds zeros, so every value is the unsharded step's."""
    b = ranks.backend(3, sharded=False, weights=weights, total=12)
    plain = ranks.run_plans(b, ([4, 4, 4], [6, 4, 2]))
    assert world2[0]["uneven"]["mesh"] == (1, 0, (0, 1, 2), 2)
    assert world2[1]["uneven"]["mesh"] == (1, None, (), 2)
    for out in world2:
        got = out["uneven"]
        assert ranks.same_arrays(got["params"], plain["params"])
        assert ranks.same_arrays(got["momentum"], plain["momentum"])
        for key in ("sq_i", "sq_g", "valid", "gns"):
            assert got[key] == plain[key], key
        _close(got["losses"], plain["losses"], rtol=1e-6)


def test_sharded_fused_loop_world_of_two(world2, plain_fused):
    """``test_sharded_fused_loop_runs_and_certifies``, on two ranks: the
    plans of the port's unsharded fused loop, every proposal certified."""
    from repro_torch.core.controller import FUSED_CERT_TOL

    plain = plain_fused
    for out in world2:
        got = out["fused"]
        assert got["plans"] == plain["plans"]
        assert [p for _, _, p in got["plans"]] == (
            [None, None, "cannikin-gns"] + ["cannikin-gns+fused"] * 4)
        _close(got["lr_scale"], plain["lr_scale"], rtol=1e-6)
        _close(got["mean_loss"], plain["mean_loss"], rtol=1e-5, atol=1e-6)
        fused_plans, certifications, failures, worst = got["stats"]
        assert fused_plans == 4 and certifications == 5 and failures == 0
        assert worst <= FUSED_CERT_TOL
        assert got["cache"] == [(4, 2)]
    assert ranks.same_arrays(world2[0]["fused"]["params"], world2[1]["fused"]["params"])


def test_sharded_checkpoint_round_trip_read_by_reference(world2):
    outs = [out["ckpt"] for out in world2]
    for got in outs:
        assert got["same"] and got["host"]
    assert outs[0]["losses_after"] == outs[1]["losses_after"]
    path, saved = outs[0]["path"], outs[0]["saved"]
    assert jckpt.verify_checkpoint(path)
    assert not [f for f in os.listdir(os.path.dirname(path)) if f.endswith(".tmp")]

    from repro_torch.optim.optimizers import SGDState

    like = {
        "params": {k: np.zeros_like(v) for k, v in saved["params"].items()},
        "opt_state": SGDState(momentum={k: np.zeros_like(v)
                                        for k, v in saved["momentum"].items()}, step=0),
        "gns": {k: np.zeros_like(v) for k, v in saved["gns"].items()},
        "counters": {k: np.zeros_like(v) for k, v in saved["counters"].items()},
    }
    manager = jckpt.CheckpointManager(os.path.dirname(path), "sharded-job")
    tree, gen, got_path = manager.restore(like)
    assert (gen, got_path, manager.rollbacks) == (1, path, 0)
    assert ranks.same_arrays({k: np.asarray(v) for k, v in tree["params"].items()},
                             saved["params"])
    assert ranks.same_arrays({k: np.asarray(v) for k, v in tree["opt_state"].momentum.items()},
                             saved["momentum"])
    assert int(tree["opt_state"].step) == saved["step"]
    for group in ("gns", "counters"):
        for k, v in saved[group].items():
            assert np.asarray(tree[group][k]) == v and np.asarray(tree[group][k]).dtype == v.dtype


def test_gloo_world_of_two_matches_reference_two_device_mesh(reference, weights, world2):
    assert reference["devices"] == 2 and reference["shards"] == 2
    assert ranks.same_arrays({k: v.numpy() for k, v in weights.items()},
                             {k: v.numpy() for k, v in state_dict_from_tree(
                                 reference["init"]).items()})
    want_params = state_dict_from_tree(reference["params"])
    for rank, out in enumerate(world2):
        got = out["plans"]
        assert got["mesh"] == (2, rank, (2 * rank, 2 * rank + 1), 2)
        _close(got["losses"], reference["losses"], rtol=1e-6)
        assert got["params"].keys() == want_params.keys()
        for k, v in got["params"].items():
            np.testing.assert_allclose(v, want_params[k].numpy(), rtol=1e-5, atol=1e-6)
        ema_g, ema_s, count, b_noise = got["gns"]
        assert count == reference["gns"][2]
        assert b_noise == pytest.approx(reference["gns"][3], rel=1e-3)
        assert got["transfers"] == reference["transfers"]
    # The ranks hold one replica: every value the same bits on both.
    a, b = (out["plans"] for out in world2)
    assert ranks.same_arrays(a["params"], b["params"])
    assert ranks.same_arrays(a["momentum"], b["momentum"])
    for key in ("losses", "sq_i", "sq_g", "valid", "gns"):
        assert a[key] == b[key], key


def test_release_world_of_one_shuts_the_group_down():
    """``release_world_of_one`` shuts down and forgets the cached group; the
    next mesh builds a new one, which sums as the first did."""
    first = mesh.make_node_mesh(2, device="cpu")
    assert mesh.release_world_of_one() >= 1
    assert mesh.release_world_of_one() == 0
    fresh = mesh.make_node_mesh(2, device="cpu")
    assert fresh.group is not first.group
    x = torch.arange(4.0)
    assert torch.equal(fresh.all_reduce_(x.clone()), x)
    assert mesh.make_node_mesh(1, device="cpu").group is fresh.group
