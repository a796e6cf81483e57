"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.op_stats``)
against the reference's and against hand counts.

The port's side runs in one subprocess, started with the module: the dry
run takes a fake default process group, which may not share a process
with the other tests' groups.  There it traces, on fake CPU meshes,

  * the reference's tiny-mesh case (reduced llama3-8b's train step on a
    4 x 4 mesh), whose per-device argument bytes must equal the sum of the
    local shards the reference's specs imply;
  * the same step and its prefill on a one-rank mesh, whose matmul FLOPs
    must lie within 2 % of the reference's ``analyze_hlo`` count for the
    step compiled on one CPU device;
  * a plain matmul, its gradient and a sharded MLP under ``OpStatsMode``;
  * the CLI (``main``) on one full-width combination cut to one layer.

The kernels' custom ops are checked here directly, on fake CUDA tensors
(no mesh): their fake outputs have the plain versions' shapes, dtypes and
strides.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_api as ref_get_api  # noqa: E402
from repro.launch.hlo_stats import analyze_hlo  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import constant_schedule as ref_constant_schedule  # noqa: E402
from repro.sharding.rules import MeshRules as RefMeshRules  # noqa: E402
from repro.train.step import build_train_step as ref_build_train_step  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_backward_ref,
    attention_lse_ref,
    attention_ref,
)
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import wkv_backward_ref, wkv_chunked  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    selective_scan_ref,
    ssm_scan_backward_ref,
)
from repro_torch.models import moe  # noqa: E402
from repro_torch.sharding.context import sharding_context  # noqa: E402
from repro_torch.sharding.rules import MeshRules  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = dict(batch=8, seq=32)     # the reference's tiny-mesh case
PREFILL = dict(batch=2, seq=64)
FLOPS_REL = 0.02

_SCRIPT = r"""
import json, sys, tempfile
import torch
torch.set_num_threads(1)
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import InputShape, get_api
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh, make_rules
from repro_torch.launch.op_stats import OpStatsMode
from repro_torch.sharding.rules import MeshRules

out = {}
api = get_api("llama3-8b", reduced=True)
train = InputShape("tiny", %(seq)d, %(batch)d, "train")
prefill = InputShape("tiny", %(pseq)d, %(pbatch)d, "prefill")

mesh = make_fake_mesh((4, 4), ("data", "model"), device_type="cpu")
rules = MeshRules(mesh_axes={"data": 4, "model": 4}, batch_axes=("data",))
traced = dryrun.trace_step(api, train, mesh, rules, device="cpu")
out["tiny_mesh"] = dict(traced["memory"], microbatches=traced["microbatches"],
                        collectives=traced["stats"].collective_counts)

one = make_fake_mesh((1, 1), ("data", "model"), device_type="cpu")
for name, shape in (("train", train), ("prefill", prefill)):
    r = make_rules(one, api.arch_id, kind=shape.kind, global_batch=shape.global_batch)
    t = dryrun.trace_step(api, shape, one, r, device="cpu")
    out["one_" + name] = dict(matmul_flops=t["stats"].matmul_flops,
                              microbatches=t["microbatches"],
                              collective_bytes=t["stats"].collective_bytes)

with FakeTensorMode():
    a, b = torch.empty(64, 128), torch.empty(128, 32)
    w = torch.empty(128, 128, requires_grad=True)
    x = torch.empty(64, 128)
    m = OpStatsMode()
    with m:
        a @ b
    out["matmul"] = m.stats.as_dict()
    m = OpStatsMode()
    with m:
        ((x @ w) ** 2).sum()
    fwd = m.stats.matmul_flops
    m = OpStatsMode()
    with m:
        torch.autograd.grad(((x @ w) ** 2).sum(), [w])
    out["grad_ratio"] = m.stats.matmul_flops / fwd

    m = OpStatsMode()
    xs = DTensor.from_local(torch.empty(2, 64), mesh, [Shard(0), Replicate()], run_check=False)
    w1 = DTensor.from_local(torch.empty(64, 64), mesh, [Replicate(), Shard(1)], run_check=False)
    w2 = DTensor.from_local(torch.empty(64, 64), mesh, [Replicate(), Shard(0)], run_check=False)
    with m:
        y = (torch.relu(xs @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])
    out["sharded_mlp"] = dict(m.stats.as_dict(), out_local=list(y.to_local().shape))

with tempfile.TemporaryDirectory() as tmp:
    rc = dryrun.main(["--device", "cpu", "--arch", "llama3-8b", "--shape", "train_4k",
                      "--mesh", "single", "--layers", "1", "--out", tmp])
    rec = json.load(open(tmp + "/llama3-8b__train_4k__single__L1.json"))
    out["cli"] = dict(rc=rc, record=rec)
print("DRYRUN-JSON " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def port():
    script = _SCRIPT % dict(seq=TRAIN["seq"], batch=TRAIN["batch"], pseq=PREFILL["seq"],
                            pbatch=PREFILL["batch"])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=400)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("DRYRUN-JSON ")]
    assert lines, proc.stderr[-4000:]
    return json.loads(lines[-1][len("DRYRUN-JSON "):])


def _local_bytes(shape, spec, sizes, itemsize):
    n = 1
    for i, d in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        if axes is not None:
            axes = (axes,) if isinstance(axes, str) else axes
            d //= int(np.prod([sizes[a] for a in axes]))
        n *= d
    return n * itemsize


def _reference_argument_bytes(api, rules, batch, seq):
    """Per-device bytes of the parameters, AdamW's two float32 moments and
    the batch, from the reference's specs.  (The reference's optimizer
    state also holds a scalar step count, which the port keeps on the
    host.)"""
    sizes = rules.mesh_axes
    params = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0)))
    specs = api.specs(rules)
    leaves = jax.tree_util.tree_leaves(params)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    total = 0
    for p, s in zip(leaves, spec_leaves):
        total += _local_bytes(p.shape, tuple(s), sizes, p.dtype.itemsize)
        total += 2 * _local_bytes(p.shape, tuple(s), sizes, 4)
    for name, sds in api.train_batch_specs(batch, seq).items():
        spec = tuple(rules.batch_spec(extra_dims=len(sds.shape) - 1))
        total += _local_bytes(sds.shape, spec, sizes, sds.dtype.itemsize)
    return total


def test_tiny_mesh_argument_bytes_equal_reference_specs(port):
    api = ref_get_api("llama3-8b", reduced=True)
    rules = RefMeshRules(mesh_axes={"data": 4, "model": 4}, batch_axes=("data",))
    want = _reference_argument_bytes(api, rules, TRAIN["batch"], TRAIN["seq"])
    got = port["tiny_mesh"]
    assert got["argument_size_in_bytes"] == want
    assert got["microbatches"] == 2  # the reference's case: 8 rows over data 4
    assert got["temp_size_in_bytes"] > 0 and got["collectives"]["all-reduce"] > 0
    # The step updates the parameters and moments in place.
    assert got["alias_size_in_bytes"] == want - sum(
        _local_bytes(s.shape, tuple(rules.batch_spec(extra_dims=len(s.shape) - 1)),
                     rules.mesh_axes, s.dtype.itemsize)
        for s in api.train_batch_specs(TRAIN["batch"], TRAIN["seq"]).values())


@pytest.fixture(scope="module")
def reference_flops(port):
    """The reference's matmul FLOPs for the step and the prefill, each
    compiled once on one CPU device at the port's microbatch count."""
    api = ref_get_api("llama3-8b", reduced=True)
    params = api.init(jax.random.PRNGKey(0))
    opt = ref_adamw(ref_constant_schedule(1e-4))
    step = ref_build_train_step(api, opt, microbatches=port["one_train"]["microbatches"],
                                with_metrics=False)
    b, s = TRAIN["batch"], TRAIN["seq"]
    batch = {"tokens": jnp.zeros((b, s), jnp.int32), "labels": jnp.zeros((b, s), jnp.int32),
             "weights": jnp.ones((b,), jnp.float32)}
    train = jax.jit(lambda p, o, x: step(p, o, x)).lower(
        params, opt.init(params), batch).compile()
    pb, ps = PREFILL["batch"], PREFILL["seq"]
    prefill = jax.jit(lambda p, x: api.logits(p, x)[:, -1]).lower(
        params, {"tokens": jnp.zeros((pb, ps), jnp.int32)}).compile()
    return {"train": analyze_hlo(train.as_text()).matmul_flops,
            "prefill": analyze_hlo(prefill.as_text()).matmul_flops}


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_one_device_matmul_flops_near_reference(port, reference_flops, kind):
    got = port[f"one_{kind}"]
    assert got["collective_bytes"] == 0  # one rank moves nothing
    rel = abs(got["matmul_flops"] - reference_flops[kind]) / reference_flops[kind]
    assert rel <= FLOPS_REL, (got["matmul_flops"], reference_flops[kind], rel)


def test_op_stats_hand_counts(port):
    mm = port["matmul"]
    assert mm["matmul_flops"] == 2 * 64 * 128 * 32
    assert mm["flops"] == mm["matmul_flops"] and mm["collective_bytes"] == 0
    assert mm["unknown_trip_whiles"] == 0
    assert 2.0 <= port["grad_ratio"] <= 3.5  # the gradient's two products and the forward's


def test_op_stats_sharded_mlp_per_device(port):
    """x (8, 64) split 4 ways over data, w1 (64, 256) and w2 (256, 64)
    split 4 ways over model along the hidden dim: each rank's two products
    are (2 x 64) x (64 x 64); the model ranks' partial sums are reduced by
    one all-reduce of a rank's (2, 64) float32 rows."""
    mlp = port["sharded_mlp"]
    assert mlp["matmul_flops"] == 2 * (2 * 2 * 64 * 64)
    assert mlp["collective_counts"] == {"all-reduce": 1.0}
    assert mlp["collective_by_kind"] == {"all-reduce": 2 * 64 * 4.0}
    assert mlp["out_local"] == [2, 64]


def test_cli_record(port):
    cli = port["cli"]
    rec = cli["record"]
    assert cli["rc"] == 0 and rec["status"] == "ok", rec.get("traceback")
    assert set(rec["hlo"]) == {"flops", "matmul_flops", "bytes_accessed", "collective_bytes",
                               "collective_by_kind", "collective_counts",
                               "unknown_trip_whiles"}
    assert rec["hlo"]["unknown_trip_whiles"] == 0 and rec["hlo"]["matmul_flops"] > 0
    for key in ("arch", "shape", "mesh", "kind", "param_count", "memory", "cost_raw",
                "collectives_raw", "fallbacks", "trace_seconds"):
        assert key in rec
    assert rec["layers"] == 1 and rec["n_devices"] == 256
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "temp_size_in_bytes", "alias_size_in_bytes"}


# ---------------------------------------------------------------------------
# The kernels' custom ops on fake CUDA tensors
# ---------------------------------------------------------------------------


def _meta(x):
    return tuple(x.shape), x.dtype, x.stride()


def _same(fake, plain):
    assert [_meta(x) for x in fake] == [_meta(x) for x in plain]


@pytest.mark.parametrize("dtype,dims", [(dt, d) for dt, pairs in flash_ops.HEAD_DIMS.items()
                                        for d in pairs])
def test_flash_fake_matches_plain(dtype, dims):
    dqk, dv = dims
    shapes = ((2, 24, 4, dqk), (2, 40, 2, dqk), (2, 40, 2, dv))
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen).to(dtype) for s in shapes)
    out = attention_ref(q, k, v, causal=False)
    lse = attention_lse_ref(q, k, causal=False)
    grads = attention_backward_ref(q, k, v, out, lse, out, causal=False)
    with FakeTensorMode():
        fq, fk, fv = (torch.empty(s, dtype=dtype, device="cuda") for s in shapes)
        f_out, f_lse = flash_ops._forward_op(fq, fk, fv, False, None, 0.1, None, True)
        f_grads = flash_ops._backward_op(fq, fk, fv, f_out, f_lse, f_out, False, None, 0.1,
                                         None)
        assert f_out.device.type == "cuda"
    _same([f_out, f_lse], [out, lse])
    _same(f_grads, grads)


@pytest.mark.parametrize("t", [32, 45])
def test_wkv_fake_matches_plain(t):
    """rwkv6's layout at its head size 64 (4 heads here), chunk 32."""
    b, h, k = 2, 4, 64
    assert wkv_ops.reach_error(torch.float32, k, 32) is None
    gen = torch.Generator().manual_seed(1)
    r, kk, v = (torch.randn(b, t, h, k, generator=gen) * 0.1 for _ in range(3))
    log_w = -torch.rand(b, t, h, k, generator=gen)
    u = torch.randn(h, k, generator=gen) * 0.1
    out, state = wkv_chunked(r, kk, v, log_w, u, chunk=32)
    grads = wkv_backward_ref(r, kk, v, log_w, u, out, None)
    with FakeTensorMode():
        fr, fk, fv, fw = (torch.empty(b, t, h, k, device="cuda") for _ in range(4))
        fu = torch.empty(h, k, device="cuda")
        f_out, f_state, _ = wkv_ops._launch(fr, fk, fv, fw, fu, 32)
        f_grads = wkv_ops._launch_backward(fr, fk, fv, fw, fu, f_state, f_out, None, 32)
    _same([f_out, f_state], [out, state])
    _same(f_grads, grads)


@pytest.mark.parametrize("t", [64, 77])
def test_ssm_scan_fake_matches_plain(t):
    """hymba's layout at N = 16 (48 channels here)."""
    b, d, n = 2, 48, 16
    assert ssm_ops.reach_error(torch.float32, n, 64) is None
    gen = torch.Generator().manual_seed(2)
    u = torch.randn(b, t, d, generator=gen)
    dt = torch.rand(b, t, d, generator=gen) * 0.1
    bt, ct = (torch.randn(b, t, n, generator=gen) for _ in range(2))
    log_a = torch.randn(d, n, generator=gen) * 0.1
    y, h = selective_scan_ref(u, dt, log_a, bt, ct)
    grads = ssm_scan_backward_ref(u, dt, bt, ct, log_a, y, h)
    with FakeTensorMode():
        fu, fdt = (torch.empty(b, t, d, device="cuda") for _ in range(2))
        fb, fc = (torch.empty(b, t, n, device="cuda") for _ in range(2))
        fa = torch.empty(d, n, device="cuda")
        f_y, f_h, tiles = ssm_ops._launch(fu, fdt, fb, fc, fa, 64, True)
        f_grads = ssm_ops._launch_backward(fu, fdt, fb, fc, fa, f_y, f_h, 64, tiles)
    _same([f_y, f_h], [y, h])
    _same(f_grads, grads)
    assert tuple(tiles.shape) == (b, -(-t // ssm_ops.BACKWARD_TILE), d, n)


def test_custom_op_flop_formulas_count_the_bounds():
    """Each custom op's FLOP formula is its kernel bound's operation count."""
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode():
        q = torch.empty(2, 64, 4, 128, dtype=torch.bfloat16, device="cuda")
        kv = torch.empty(2, 64, 2, 128, dtype=torch.bfloat16, device="cuda")
        with FlopCounterMode(display=False) as fwd:
            out, lse = flash_ops._forward_op(q, kv, kv, True, None, 0.1, None, True)
        with FlopCounterMode(display=False) as bwd:
            flash_ops._backward_op(q, kv, kv, out, lse, out, True, None, 0.1, None)
        r = torch.empty(2, 40, 4, 64, device="cuda")
        with FlopCounterMode(display=False) as wkv_f:
            _, st, _ = wkv_ops._launch(r, r, r, r, torch.empty(4, 64, device="cuda"), 32)
        u = torch.empty(2, 40, 48, device="cuda")
        bt = torch.empty(2, 40, 16, device="cuda")
        with FlopCounterMode(display=False) as ssm_f:
            ssm_ops._launch(u, u, bt, bt, torch.empty(48, 16, device="cuda"), 64, False)
    pairs = 64 * 65 // 2  # causal, T = S
    assert flash_ops.attention_pairs(64, 64, True, None, None) == pairs
    assert fwd.get_total_flops() == 2 * (128 + 128) * 2 * 4 * pairs
    assert bwd.get_total_flops() == 2 * (3 * 128 + 2 * 128) * 2 * 4 * pairs
    assert wkv_f.get_total_flops() == 4 * 64 * 64 * 2 * 40 * 4
    assert ssm_f.get_total_flops() == 7 * 2 * 40 * 48 * 16
    assert flash_ops.attention_pairs(8, 8, True, 3, None) == 1 + 2 + 3 * 6
    assert flash_ops.attention_pairs(4, 10, False, None, 6) == 4 * 6


# ---------------------------------------------------------------------------
# MoE decode under a sharding context
# ---------------------------------------------------------------------------


def test_moe_decode_capacity_form_under_context():
    """Under a sharding context a decode-sized batch takes the capacity
    form at capacity = T (no drops), which equals the grouped decode path
    (``_selected_experts``) that runs without one."""
    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_model=32, d_ff=48,
                        capacity_factor=1.25, router_dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    lp = {"router": torch.randn(32, 8, generator=gen),
          "w_gate": torch.randn(8, 32, 48, generator=gen) * 0.1,
          "w_up": torch.randn(8, 32, 48, generator=gen) * 0.1,
          "w_down": torch.randn(8, 48, 32, generator=gen) * 0.1}
    x = torch.randn(4, 1, 32, generator=gen)
    assert 4 * cfg.top_k <= moe.DECODE_GATHER_MAX
    grouped, stats = moe.moe_apply(lp, x, cfg)
    rules = MeshRules(mesh_axes={"data": 16, "model": 16}, batch_axes=("data",))
    with sharding_context(None, rules):
        assert moe._capacity(cfg, 4) == 4
        capacity, c_stats = moe.moe_apply(lp, x, cfg)
    torch.testing.assert_close(capacity, grouped, rtol=1e-5, atol=1e-6)
    assert float(c_stats["drop_frac"]) == 0.0 and float(stats["drop_frac"]) == 0.0
