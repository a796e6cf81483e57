"""Real-backend cluster runtime with checkpointed preemption/resume.

    python examples_torch/preempt_resume.py --backend real --epochs 2
    python examples_torch/preempt_resume.py --backend real --faults chaos-real

Submits one job whose :class:`JobSpec` names the ``real`` execution backend
(real gradients of a shrunk olmo-1b on ``--device``, default the CUDA
card, where each node step runs the flash-attention kernel's forward and
backward; heterogeneous timing simulated) to the event-driven
``ClusterRuntime``, trains ``--epochs``
epochs, injects a ``Preemption`` (the runtime checkpoints params/opt-state/
GNS state to checksummed generation files under ``<workdir>``), zeroes the
live parameters in place to prove the file matters, resumes via a fresh
``JobArrival``,
and trains ``--epochs`` more.  Asserts that the checkpoint file was written
and that resume restored the exact pre-preemption state, so CI can run it
as an end-to-end smoke.  Exits nonzero if any invariant breaks.

With ``--faults chaos-real`` the run instead exercises the integrity-
hardened real path end-to-end: a gradient-poisoned node must be excluded by
the anomaly guard and quarantined by the numerical-health channel, a
solver stall must trip the deadline watchdog into the engine-degradation
chain, and a corrupted checkpoint generation must roll back bit-exactly to
the newest valid generation on resume — all with the runtime invariant
checker on and reporting zero violations.
"""
import argparse
import math
import os
import tempfile

import _common  # noqa: F401  (sys.path bootstrap)

import torch

from repro_torch import resolve_device


def _make_spec(args):
    from repro_torch.core.perf_model import CommModel
    from repro_torch.core.scheduler import JobSpec
    from repro_torch.core.simulator import GPU_CATALOG

    return JobSpec(
        name="job",
        node_models=tuple(
            GPU_CATALOG[n].model() for n in ("a100", "v100", "rtx6000")
        ),
        comm=CommModel(t_o=0.04, t_u=0.008, gamma=0.15),
        total_batch=args.total_batch,
        b_noise=500.0,
        ref_batch=args.total_batch,
        backend=args.backend,
    )


def run_chaos_real(args) -> None:
    """The real-path chaos gate (CI's chaos-smoke real-backend lane)."""
    from repro_torch.runtime import (
        ClusterRuntime,
        JobState,
        NodeState,
        RealBackendConfig,
        make_fault_plan,
    )
    from repro_torch.train import checkpoint as ckpt

    spec = _make_spec(args)
    plan = make_fault_plan("chaos-real", 3, seed=0)
    poison = plan.poisons[0]
    print("=== chaos-real (integrity-hardened real path) ===")
    for line in plan.describe():
        print(f"inject: {line}")

    with tempfile.TemporaryDirectory() as workdir:
        rt = ClusterRuntime(
            3,
            policy="cannikin",
            seed=0,
            real_backend=RealBackendConfig(arch=args.arch, seq_len=16, lr=0.3,
                                           device=args.device),
            checkpoint_dir=workdir,
            faults=plan,
            invariants=True,
        )
        handle = rt.submit(spec, at=0.0)
        rt.run()  # the arrival solve is stalled -> watchdog -> degradation

        # Phase A: ride through the poison window (epochs 0..2).
        rt.advance(epochs=3, steps=args.steps)
        assert rt.health is not None
        h1 = rt.health.nodes[poison.node]
        assert h1.state == NodeState.QUARANTINED, (
            f"poisoned node {poison.node} not quarantined: {h1.state}"
        )
        assert poison.node not in handle.nodes, "quarantined node still held"
        quar = next(
            r for r in rt.recovery_log
            if r["action"] == "quarantine" and r["node"] == poison.node
        )
        latency = int(quar["epoch"]) - poison.at_epoch
        assert 0 <= latency <= 2, f"quarantine latency {latency} epochs > 2"
        anomalies = handle.last_result.grad_anomalies
        assert any(anomalies), "anomaly guard never excluded the poisoned node"
        print(f"poisoned node {poison.node} quarantined "
              f"{latency} epoch(s) after onset; per-node anomalous steps "
              f"this epoch: {list(anomalies)}")
        assert rt.watchdog is not None and rt.watchdog.solver_timeouts >= 1, (
            "solver stall never tripped the deadline watchdog"
        )
        print(f"watchdog: {rt.watchdog.counters()}")

        # Generation 1: a clean preemption checkpoint.
        rt.preempt(spec.name, at=10.0)
        rt.run()
        assert handle.state == JobState.PREEMPTED, handle.state
        gen1 = handle.checkpoint_path
        assert gen1 is not None and os.path.exists(gen1)
        assert ckpt.verify_checkpoint(gen1), "generation 1 failed verification"
        assert ckpt.checkpoint_generation(gen1) == 1
        print(f"gen 1 written + verified: {os.path.basename(gen1)}")

        rt.submit(spec, at=11.0)
        rt.run()
        rt.advance(epochs=2, steps=args.steps)  # epochs 3..4 (poison over)

        # Generation 2: the injector flips bytes in this write.
        rt.preempt(spec.name, at=20.0)
        rt.run()
        gen2 = handle.checkpoint_path
        assert gen2 is not None and gen2 != gen1
        assert rt.injector.corrupted_paths == [gen2]
        assert not ckpt.verify_checkpoint(gen2), "corrupted gen 2 verified?!"
        print(f"gen 2 written + corrupted: {os.path.basename(gen2)}")

        # Rollback oracle: what a bit-exact restore of gen 1 must produce.
        oracle = ckpt.restore(gen1, handle.backend.snapshot())
        oracle_leaves = dict(oracle["params"])

        # Clobber the live state: only a real on-disk restore can fix this.
        _zero(handle.backend.params)

        rt.submit(spec, at=21.0)
        rt.run()
        assert handle.state == JobState.RUNNING, handle.state
        assert handle.ckpt_rollbacks == 1, (
            f"expected exactly one rollback, got {handle.ckpt_rollbacks}"
        )
        post = _leaves(handle.backend.params)
        assert oracle_leaves.keys() <= post.keys()
        for name, a in oracle_leaves.items():
            assert torch.equal(a, post[name]), name
        print("resume rolled back to gen 1 bit-exactly")

        # Phase C: train on after recovery; the quarantined node has been
        # re-admitted (backoff expired) and must not be CRASHED/lost.
        rt.advance(epochs=2, steps=args.steps)
        assert handle.state == JobState.RUNNING
        assert all(
            math.isfinite(r.mean_loss) for r in handle.records
        ), "non-finite loss"
        assert rt.health.nodes[poison.node].state in (
            NodeState.PROBATION, NodeState.HEALTHY,
        ), f"poisoned node never re-admitted: {rt.health.nodes[poison.node].state}"

        assert rt.invariant_checker is not None
        assert rt.invariant_checker.checks_run > 0
        rt.invariant_checker.assert_clean()
        telemetry = rt.fault_telemetry()
        print(f"detected={telemetry['detected']} "
              f"recoveries={telemetry['recoveries']} "
              f"rollbacks={telemetry['checkpoint_rollbacks']} "
              f"invariants={telemetry['invariants']}")
        print(f"\nepochs={handle.epochs_run} preemptions={handle.preemptions} "
              f"— chaos-real invariants OK")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", default="real", choices=["sim", "real"])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--total-batch", type=int, default=12)
    ap.add_argument("--faults", default="none", choices=["none", "chaos-real"],
                    help="chaos-real: gradient poison + checkpoint corruption "
                         "+ solver stall with invariant checking")
    ap.add_argument("--device", default=None,
                    help="where the real backend trains (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.backend == "real":
        args.device = resolve_device(args.device)

    if args.faults == "chaos-real":
        if args.backend != "real":
            raise SystemExit("--faults chaos-real requires --backend real")
        run_chaos_real(args)
        return

    from repro_torch.runtime import ClusterRuntime, JobState, RealBackendConfig

    spec = _make_spec(args)

    with tempfile.TemporaryDirectory() as workdir:
        rt = ClusterRuntime(
            3,
            policy="cannikin",
            seed=0,
            real_backend=RealBackendConfig(arch=args.arch, seq_len=16, lr=0.3,
                                           device=args.device),
            checkpoint_dir=workdir,
        )
        handle = rt.submit(spec, at=0.0)
        rt.run()
        rt.advance(epochs=args.epochs, steps=args.steps)
        for r in handle.records:
            loss = "nan" if math.isnan(r.mean_loss) else f"{r.mean_loss:.4f}"
            print(f"epoch {r.epoch} [{r.phase:9s}] backend={r.backend} "
                  f"B={r.total_batch} split={list(r.batches)} loss={loss}")

        real = args.backend == "real"
        if real:
            pre_params = _leaves(handle.backend.params)
            pre_steps = handle.backend.steps_done

        print("\n-- injecting Preemption --")
        rt.preempt(spec.name, at=10.0)
        rt.run()
        assert handle.state == JobState.PREEMPTED, handle.state
        if real:
            assert handle.checkpoint_path is not None, "no checkpoint path"
            assert os.path.exists(handle.checkpoint_path), "checkpoint not written"
            size = os.path.getsize(handle.checkpoint_path) / 1e6
            print(f"checkpoint written: {handle.checkpoint_path} ({size:.1f} MB)")
            # Clobber the live state: only a real restore can fix this.
            _zero(handle.backend.params)
            handle.backend.steps_done = 0

        print("-- resuming (JobArrival) --")
        rt.submit(spec, at=11.0)
        rt.run()
        assert handle.state == JobState.RUNNING, handle.state
        if real:
            post_params = _leaves(handle.backend.params)
            assert pre_params.keys() == post_params.keys()
            for name, a in pre_params.items():
                assert torch.equal(a, post_params[name]), name
            assert handle.backend.steps_done == pre_steps
            print("restore verified: params + stream counters bit-exact")

        rt.advance(epochs=args.epochs, steps=args.steps)
        assert handle.epochs_run == 2 * args.epochs
        if real:
            assert all(
                math.isfinite(r.mean_loss) for r in handle.records
            ), "non-finite loss"
        print(f"\nepochs={handle.epochs_run} preemptions={handle.preemptions} "
              f"sim_time={handle.sim_time:.2f}s — all invariants OK")


def _leaves(model):
    """A copy of every tensor of ``model``'s ``state_dict``, by name."""
    return {name: t.detach().clone() for name, t in model.state_dict().items()}


def _zero(model) -> None:
    """Zero ``model``'s parameters in place."""
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()


if __name__ == "__main__":
    main()
