"""Multi-job churn through the ClusterRuntime front door (Pollux/Sia-style
cluster simulation).

    python examples_torch/runtime_trace.py
    python examples_torch/runtime_trace.py --faults chaos-small

Replays one synthetic 3-job trace — staggered arrivals, one departure, one
node failure — under all three allocation policies (cannikin / static /
fair-share) with two simulated training epochs between events, then prints
one comparable summary.  Exits nonzero if any invariant breaks, so CI can
run it as an end-to-end smoke.

With ``--faults chaos``/``chaos-small`` the cannikin replay additionally
runs under the named seeded :class:`~repro_torch.runtime.faults.FaultPlan`
— a node crash (silent stop), a transient straggler, a flapping node, a
measurement-noise spike — with the HealthMonitor detecting from telemetry
and the runtime self-healing through its own event alphabet: no
human-scripted recovery events anywhere in the trace.
"""
import argparse
import tempfile

import _common  # noqa: F401  (sys.path bootstrap)

from repro_torch.runtime import (
    FAULT_PLANS,
    compare_policies,
    format_summary,
    make_fault_plan,
    replay,
    synthetic_trace,
)

N_NODES = 12


def run_chaos(plan_name: str) -> None:
    """The chaos smoke: a faulted cannikin replay must self-heal."""
    trace, jobs = synthetic_trace(3, N_NODES, seed=0)
    plan = make_fault_plan(plan_name, N_NODES, seed=0)
    assert plan is not None
    print(f"\n=== chaos replay ({plan_name}) ===")
    for line in plan.describe():
        print(f"  inject: {line}")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        rep = replay(
            trace, N_NODES, policy="cannikin", epochs_per_event=6, steps=2,
            noise=0.01, seed=0, faults=plan, checkpoint_dir=ckpt_dir,
        )
    rt = rep.runtime
    telemetry = rt.fault_telemetry()
    assert telemetry is not None
    for r in rt.recovery_log:
        print(f"  recover: epoch={r['epoch']:>3} {r['action']:<14} "
              f"node={r['node']} jobs={list(r['jobs'])}")
    print(f"  detected: {telemetry['detected']}  "
          f"latency={telemetry['detection_latency_epochs']} epochs  "
          f"mttr={telemetry['mttr_epochs']} epochs")
    print(f"  goodput retention vs fault-free replay: "
          f"{rep.goodput_retention:.3f}")

    # Chaos invariants (CI smoke gate) ------------------------------------
    # Every job still completes or trains — zero human-scripted recovery.
    for name, state in rep.job_states.items():
        assert state in ("done", "running"), f"{name} ended {state}"
    assert rep.job_states[jobs[0].name] == "done", "departure lost under chaos"
    for handle in rt.jobs("running"):
        assert handle.epochs_run > 0, f"{handle.name} never trained"
    # >= 1 crash detected, and recovered through the checkpoint-restore
    # (Preemption) path: the victim was preempted and resumed to RUNNING.
    assert telemetry["detected"]["crash"] >= 1, "crash went undetected"
    crash_recoveries = [
        r for r in rt.recovery_log if r["action"] == "crash_recover"
    ]
    assert crash_recoveries, "crash never recovered"
    for r in crash_recoveries:
        for victim in r["jobs"]:
            h = rt.handles[victim]
            assert h.preemptions >= 1, f"{victim}: no preemption checkpoint"
            assert h.state in ("running", "done"), f"{victim} not resumed"
    # The straggler was quarantined and re-admitted.
    assert telemetry["recoveries"]["quarantine"] >= 1, "no quarantine"
    assert telemetry["recoveries"]["readmit"] >= 1, "no re-admission"
    # Goodput retention is reported (the bench gates its level).
    assert rep.goodput_retention is not None and rep.goodput_retention > 0
    print("  chaos invariants OK")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    # chaos-real targets the real backend (gradient poison / checkpoint
    # corruption); this sim-only smoke asserts crash recovery, so it takes
    # the timing-fault plans only — see examples_torch/preempt_resume.py for
    # the real-path chaos lane.
    ap.add_argument("--faults", default="none",
                    choices=[p for p in FAULT_PLANS if p != "chaos-real"],
                    help="seeded fault plan for an extra chaos replay")
    args = ap.parse_args()

    trace, jobs = synthetic_trace(3, N_NODES, seed=0)
    print(f"trace: {len(trace)} events over {N_NODES} nodes, "
          f"jobs={[j.name for j in jobs]}")
    reports = compare_policies(trace, N_NODES, epochs_per_event=2, steps=2)

    print("\n=== per-event reconcile log (cannikin) ===")
    for rec in reports["cannikin"].records:
        assigned = {k: len(v) for k, v in rec.allocation.assignment.items() if v}
        print(f"  t={rec.time:4.1f} {rec.label:<18} nodes/job={assigned} "
              f"agg_goodput={rec.aggregate_goodput:8.1f}")

    print("\n=== policy comparison (same trace) ===")
    print(format_summary(reports))
    counters = reports["cannikin"].runtime.counters()
    print(f"\ncannikin scheduler reuse: {counters}")

    # End-to-end invariants (CI smoke gate) --------------------------------
    for name, rep in reports.items():
        assert rep.aggregate_goodput > 0, f"{name}: no goodput produced"
        assert rep.job_states[jobs[0].name] == "done", f"{name}: departure lost"
        for handle in rep.runtime.jobs("running"):
            assert handle.epochs_run > 0, f"{name}: {handle.name} never trained"
            assert handle.last_plan is not None
        down = rep.runtime.down_nodes
        for ids in rep.runtime.allocation.assignment.values():
            assert not down & set(ids), f"{name}: assigned a down node"
    # Incremental scheduling really was incremental: rows were replayed from
    # cache and later rounds warm-started instead of re-solving cold.
    assert counters["cached_rows"] > 0 and counters["warm_rounds"] > 0
    print("\nall invariants OK")

    if args.faults != "none":
        run_chaos(args.faults)


if __name__ == "__main__":
    main()
