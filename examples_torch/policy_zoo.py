"""The batch-size-policy zoo: every registered adaptation law on one
heterogeneous trace.

    python examples_torch/policy_zoo.py

Cannikin's GNS-driven selection is one point in the batch-adaptation
design space; the :mod:`repro_torch.core.batch_policy` registry holds the
rest — the AdaBatch/adadamp damper family (loss-ratio, linear-ramp,
geometric schedule) and the fixed baseline.  This example stamps one
synthetic 3-job trace with each registered policy, replays them under the
same cannikin allocator, and prints one ranking on goodput = sample
throughput × statistical efficiency.

Because the dampers are schedule-driven (no gradient telemetry needed),
adaptive batch sizes are live even on the sim backend — watch geodamp's
mean total batch ramp while cannikin-gns, which needs real gradients,
collapses to the fixed baseline here.  Exits nonzero if any invariant
breaks, so CI runs it as an end-to-end smoke.
"""
import _common  # noqa: F401  (sys.path bootstrap)

from repro_torch.core.batch_policy import BATCH_POLICIES, policy_requirements
from repro_torch.runtime import (
    compare_policies,
    format_batch_policy_summary,
    rank_batch_policies,
    synthetic_trace,
)

N_JOBS, N_NODES, SEED = 3, 12, 0


def main() -> None:
    trace, jobs = synthetic_trace(N_JOBS, N_NODES, seed=SEED)
    print(f"# trace: {len(trace)} events, jobs={[j.name for j in jobs]}, "
          f"nodes={N_NODES}")
    print(f"# registry: "
          f"{ {n: sorted(policy_requirements(n)) for n in sorted(BATCH_POLICIES)} }")

    reports = compare_policies(
        trace, N_NODES, batch_policies=(), epochs_per_event=2, steps=2,
        noise=0.01, seed=SEED,
    )
    print(format_batch_policy_summary(reports))

    ranking = rank_batch_policies(reports)
    by_name = {row["batch_policy"]: row for row in ranking}

    # One report per registered policy, ranked strictly by goodput.
    assert len(ranking) == len(BATCH_POLICIES) >= 5
    goodputs = [row["policy_goodput"] for row in ranking]
    assert goodputs == sorted(goodputs, reverse=True)
    for row in ranking:
        assert 0.0 < row["statistical_efficiency"] <= 1.0, row
        assert row["sample_throughput"] > 0.0, row
        assert row["epochs"] > 0, row

    # GNS-driven selection has no gradients on the sim backend, so it runs
    # the fixed-batch mode — identical replay, identical numbers.
    assert by_name["cannikin-gns"]["policy_goodput"] == by_name["fixed"]["policy_goodput"]

    # The dampers DO adapt here: the geometric schedule ramped the batch.
    assert (
        by_name["geodamp"]["mean_total_batch"]
        > by_name["adadamp"]["mean_total_batch"]
    ), "geodamp never moved on the sim backend"

    best = ranking[0]
    print(f"# winner: {best['batch_policy']} "
          f"(goodput={best['policy_goodput']:.1f}, "
          f"eff={best['statistical_efficiency']:.3f}, "
          f"mean B={best['mean_total_batch']:.1f})")
    print("ok")


if __name__ == "__main__":
    main()
