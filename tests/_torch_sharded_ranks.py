"""Rank bodies for the gloo tests of the node-sharded RealBackend
(``tests/test_torch_sharded.py``).

Each rank of a CPU world joins a gloo default group through a ``file://``
store, runs the same jobs on its own backend, and pickles what it saw to
``<out>/rank<r>.pkl``.  Imports torch and repro_torch only, so the
spawned processes start without JAX.
"""
from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

NODES = ("a100", "v100", "rtx6000", "a5000")
PLANS = ([4, 4, 4, 4], [6, 4, 3, 3], [2, 6, 5, 3])
FUSED_EPOCHS = 7
FUSED_STEPS = 3


def spec(n: int, total: int):
    from repro_torch.core.perf_model import CommModel
    from repro_torch.core.scheduler import JobSpec
    from repro_torch.core.simulator import GPU_CATALOG

    return JobSpec(name="sharded-job", node_models=tuple(GPU_CATALOG[x].model() for x in NODES[:n]),
                   comm=CommModel(t_o=0.04, t_u=0.008, gamma=0.15), total_batch=total,
                   b_noise=500.0, ref_batch=total, backend="real")


def backend(n: int, *, sharded: bool, weights=None, total: int = 16):
    """Reduced olmo-1b (float32) on the CPU, configured on ``n`` catalog
    nodes, from ``weights`` (a state_dict) when given."""
    from repro_torch.runtime.backend import RealBackendConfig

    b = RealBackendConfig(arch="olmo-1b", seq_len=16, lr=0.3, device="cpu",
                          sharded=sharded).build(noise=0.0, seed=0)
    if weights is not None:
        b.params.load_state_dict(weights)
    b.configure(spec(n, total), tuple(range(n)), seed=1)
    return b


def params_np(b):
    return {k: v.detach().numpy().copy() for k, v in b.named.items()}


def run_plans(b, plans=PLANS):
    """Every plan for 2 steps: losses, telemetry, final params and GNS."""
    results = [b.execute(p, 2) for p in plans]
    return dict(
        losses=[list(r.losses) for r in results],
        sq_i=[[list(o.local_sqnorms) for o in r.grad_observations] for r in results],
        sq_g=[[o.global_sqnorm for o in r.grad_observations] for r in results],
        valid=[[list(o.valid) for o in r.grad_observations] for r in results],
        params=params_np(b),
        momentum={k: v.numpy().copy() for k, v in b.opt_state.momentum.items()},
        gns=(b.gns.ema_g, b.gns.ema_s, b.gns.count, b.gns.b_noise),
        transfers=b.transfers.snapshot(),
    )


def fused_loop(*, sharded: bool, n: int = 4, total: int = 16, candidates=(16, 32)):
    """The reference's ``_run_loop(fused=True, sharded=..., n=4, total=16,
    candidates=(16, 32))``: 7 epochs of 3 steps from seeded weights."""
    from repro_torch.core.controller import CannikinController
    from repro_torch.runtime.backend import EpochLoop

    b = backend(n, sharded=sharded, total=total)
    ctrl = CannikinController(n, batch_candidates=list(candidates), ref_batch=total,
                              adaptive=True, device="cpu")
    loop = EpochLoop(ctrl, b, steps_per_epoch=FUSED_STEPS, fused=True)
    loop.run(FUSED_EPOCHS)
    s = ctrl.stats
    return dict(
        plans=[(r.total_batch, r.batches, r.plan.batch_policy if r.plan else None)
               for r in loop.history],
        lr_scale=[r.lr_scale for r in loop.history],
        mean_loss=[r.mean_loss for r in loop.history],
        stats=(s.fused_plans, s.fused_certifications, s.fused_cert_failures,
               s.fused_max_rel_err),
        cache=sorted(b._fused_cache),
        params=params_np(b),
    )


def checkpoint_round_trip(directory: str, weights):
    """Train, checkpoint (rank 0 writes), scramble, restore on every rank,
    compare bitwise, and train on."""
    b = backend(4, sharded=True, weights=weights)
    b.execute([4, 4, 4, 4], 2)
    saved = b.snapshot()
    path = os.path.join(directory, "sharded-job.gen000001.ckpt.npz")
    b.checkpoint(path)
    with torch.no_grad():
        for p in b.named.values():
            p.mul_(0.0)
    for m in b.opt_state.momentum.values():
        m.zero_()
    b.steps_done, b.sim_time = 0, 0.0
    b.restore(path)
    back = b.snapshot()
    same = (all(torch.equal(saved["params"][k], back["params"][k]) for k in saved["params"])
            and all(torch.equal(saved["opt_state"].momentum[k], back["opt_state"].momentum[k])
                    for k in saved["opt_state"].momentum)
            and saved["opt_state"].step == back["opt_state"].step
            and saved["gns"] == back["gns"] and saved["counters"] == back["counters"])
    host = all(t.device.type == "cpu" for t in saved["params"].values())
    after = b.execute([6, 4, 3, 3], 2)
    return dict(
        path=path, same=same, host=host, losses_after=list(after.losses),
        saved={"params": {k: v.numpy().copy() for k, v in saved["params"].items()},
               "momentum": {k: v.numpy().copy() for k, v in saved["opt_state"].momentum.items()},
               "step": saved["opt_state"].step, "gns": saved["gns"],
               "counters": saved["counters"]},
    )


def run(rank: int, world: int, init_file: str, out_dir: str, jobs) -> None:
    """One rank: join the gloo world, run ``jobs`` (names of the bodies
    above, with their arguments), pickle the results, leave the world."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        weights = None
        weights_path = os.path.join(out_dir, "weights.pt")
        if os.path.exists(weights_path):
            weights = torch.load(weights_path)
        out = {}
        for job in jobs:
            if job == "plans":
                b = backend(4, sharded=True, weights=weights)
                out[job] = run_plans(b)
                out[job]["mesh"] = (b._mesh.shards, b._mesh.shard, b._mesh.nodes, b._mesh.world)
            elif job == "uneven":
                b = backend(3, sharded=True, weights=weights, total=12)
                out[job] = run_plans(b, ([4, 4, 4], [6, 4, 2]))
                out[job]["mesh"] = (b._mesh.shards, b._mesh.shard, b._mesh.nodes, b._mesh.world)
            elif job == "fused":
                out[job] = fused_loop(sharded=True)
            elif job == "ckpt":
                out[job] = checkpoint_round_trip(out_dir, weights)
            else:
                raise ValueError(f"unknown job {job!r}")
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(world: int, out_dir: str, jobs) -> list:
    """Run ``jobs`` on a gloo world of ``world`` spawned CPU processes and
    return each rank's results."""
    import torch.multiprocessing as mp

    init_file = os.path.join(out_dir, "store")
    mp.spawn(run, args=(world, init_file, out_dir, tuple(jobs)), nprocs=world, join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def same_arrays(a, b) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
